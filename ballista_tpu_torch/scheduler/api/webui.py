"""Web cluster monitor served by the scheduler REST API.

Rebuild of the reference's web TUI (`ballista-cli` ratatui monitor + its
Trunk/wasm build, ballista-cli/src/tui/): live jobs / executors / metrics
tables over the same REST endpoints, per-job stage DAG and operator metric
percentiles, job cancel, and client-side search — one static page, zero
external assets (the wasm build's role here is plain JS polling the JSON
API, which is the TPU build's equivalent of the hexagonal ui/http_client
split).
"""

WEBUI_HTML = r"""<!doctype html>
<html lang="en">
<head>
<meta charset="utf-8">
<title>ballista-tpu cluster monitor</title>
<style>
:root {
  --bg: #11151a; --panel: #1a2027; --line: #2a323c; --fg: #d7dde4;
  --dim: #8a96a3; --acc: #5aa9e6; --ok: #69c98f; --warn: #e6c85a;
  --err: #e66a6a; --run: #5aa9e6;
}
* { box-sizing: border-box; }
body { margin: 0; background: var(--bg); color: var(--fg);
       font: 13px/1.45 ui-monospace, SFMono-Regular, Menlo, Consolas, monospace; }
header { display: flex; gap: 18px; align-items: baseline; padding: 10px 16px;
         border-bottom: 1px solid var(--line); background: var(--panel);
         position: sticky; top: 0; }
header h1 { font-size: 15px; margin: 0; color: var(--acc); }
header .kv { color: var(--dim); }
header .kv b { color: var(--fg); font-weight: 600; }
main { display: grid; grid-template-columns: minmax(420px, 1fr) 2fr;
       gap: 12px; padding: 12px 16px; }
section { background: var(--panel); border: 1px solid var(--line);
          border-radius: 6px; padding: 10px 12px; min-width: 0; }
section h2 { font-size: 12px; margin: 0 0 8px; color: var(--dim);
             text-transform: uppercase; letter-spacing: .08em; }
table { border-collapse: collapse; width: 100%; }
th, td { text-align: left; padding: 3px 8px; border-bottom: 1px solid var(--line);
         white-space: nowrap; overflow: hidden; text-overflow: ellipsis; }
th { color: var(--dim); font-weight: 600; }
tr.sel td { background: #233040; }
tbody tr:hover td { background: #202833; cursor: pointer; }
.st { padding: 0 6px; border-radius: 3px; font-size: 11px; }
.st.successful, .st.completed { color: var(--ok); }
.st.running { color: var(--run); }
.st.failed, .st.cancelled { color: var(--err); }
.st.queued, .st.resolved, .st.unresolved, .st.pending { color: var(--warn); }
input[type=text] { background: var(--bg); color: var(--fg); border: 1px solid var(--line);
        border-radius: 4px; padding: 3px 8px; width: 180px; }
button { background: #2a3340; color: var(--fg); border: 1px solid var(--line);
         border-radius: 4px; padding: 2px 10px; cursor: pointer; font: inherit; }
button:hover { border-color: var(--acc); }
button.danger:hover { border-color: var(--err); color: var(--err); }
#dag { width: 100%; min-height: 120px; }
#dag .node rect { fill: #202a36; stroke: var(--line); rx: 4; }
#dag .node.successful rect { stroke: var(--ok); }
#dag .node.running rect { stroke: var(--run); }
#dag .node.failed rect { stroke: var(--err); }
#dag .node.resolved rect, #dag .node.unresolved rect { stroke: var(--warn); }
#dag text { fill: var(--fg); font-size: 11px; }
#dag text.sub { fill: var(--dim); font-size: 10px; }
#dag line { stroke: var(--dim); stroke-width: 1.2; marker-end: url(#arr); }
.bar { background: #2a323c; height: 6px; border-radius: 3px; min-width: 60px; }
.bar i { display: block; height: 6px; border-radius: 3px; background: var(--acc); }
pre { white-space: pre-wrap; color: var(--dim); margin: 4px 0 0; font-size: 11px; }
.muted { color: var(--dim); }
#detail, #config { grid-column: 1 / -1; }
.spark { font-weight: 400; letter-spacing: -1px; color: var(--acc); }
.row { display: flex; gap: 10px; align-items: center; margin-bottom: 8px; }
</style>
</head>
<body>
<header>
  <h1>ballista-tpu</h1>
  <span class="kv">scheduler <b id="h-id">–</b></span>
  <span class="kv">version <b id="h-ver">–</b></span>
  <span class="kv">executors <b id="h-ex">–</b></span>
  <span class="kv">jobs <b id="h-jobs">–</b></span>
  <span class="kv">act <b id="spark-act" class="spark">–</b></span>
  <span class="kv">slots <b id="spark-slots" class="spark">–</b></span>
  <span class="kv"><button id="pause">pause</button></span>
  <span class="kv"><button id="cfg-btn">config</button></span>
  <span class="kv muted" id="h-upd"></span>
</header>
<main>
  <section>
    <div class="row"><h2 style="margin:0">Jobs</h2>
      <input type="text" id="q" placeholder="filter id / status / sql"></div>
    <table id="jobs"><thead><tr>
      <th>job</th><th>status</th><th>stages</th><th>progress</th><th>sec</th><th></th>
    </tr></thead><tbody></tbody></table>
  </section>
  <section>
    <h2>Executors</h2>
    <table id="execs"><thead><tr>
      <th>id</th><th>host</th><th>grpc</th><th>flight</th><th>slots</th><th>dev</th><th>seen</th>
    </tr></thead><tbody></tbody></table>
    <h2 style="margin-top:14px">Scheduler metrics</h2>
    <pre id="prom" class="muted"></pre>
  </section>
  <section id="config" hidden>
    <h2>Scheduler config</h2>
    <div class="muted" id="cfg-head"></div>
    <table id="cfg-table"><thead><tr>
      <th>session config key</th><th>type</th><th>default</th><th>description</th>
    </tr></thead><tbody></tbody></table>
  </section>
  <section id="detail" hidden>
    <div class="row"><h2 style="margin:0" id="d-title">Job</h2>
      <span class="st" id="d-status"></span></div>
    <svg id="dag"></svg>
    <table id="stages"><thead><tr>
      <th>stage</th><th>state</th><th>attempt</th><th>parts</th><th>done</th><th>top operators (p50 / p99 ms · rows)</th>
    </tr></thead><tbody></tbody></table>
  </section>
</main>
<script>
"use strict";
let paused = false, selected = null, cachedJobs = [];
const $ = (s) => document.querySelector(s);
const esc = (s) => String(s).replace(/[&<>"]/g, c => ({"&":"&amp;","<":"&lt;",">":"&gt;",'"':"&quot;"}[c]));
const J = (u) => fetch(u).then(r => { if (!r.ok) throw new Error(u + ": " + r.status); return r.json(); });

function stBadge(s) { return `<span class="st ${esc(s)}">${esc(s)}</span>`; }

// cluster-history sparklines (the ratatui Sparkline widget analog)
const SPARK = " ▁▂▃▄▅▆▇█", HWIN = 40, hist = { act: [], slots: [] };
function sparkline(vals) {
  const v = vals.slice(-HWIN), hi = Math.max(1, ...v);
  return v.map(x => SPARK[Math.min(8, 1 + Math.round(x / hi * 7))]).join("");
}
function sample(jobs, execs) {
  hist.act.push(jobs.filter(j => ["running", "queued"].includes(j.state)).length);
  hist.slots.push(execs.reduce((a, e) => a + (e.total_slots - e.free_slots), 0));
  for (const k in hist) if (hist[k].length > HWIN) hist[k].shift();
  $("#spark-act").textContent = sparkline(hist.act) || "–";
  $("#spark-slots").textContent = sparkline(hist.slots) || "–";
}

let cfgShown = false;
async function toggleConfig() {
  cfgShown = !cfgShown;
  const el = $("#config");
  el.hidden = !cfgShown;
  if (!cfgShown || el.dataset.loaded) return;
  el.dataset.loaded = "1";  // set BEFORE awaiting: no duplicate fetch/rows
  let c;
  try { c = await J("/api/config"); }  // static payload: fetched once
  catch (e) { delete el.dataset.loaded; $("#cfg-head").textContent = "config fetch failed: " + e.message; return; }
  $("#cfg-head").textContent =
    `task-distribution=${c.task_distribution} · executor-timeout=${c.executor_timeout_s}s · ` +
    `job-state=${c.job_state_backend}`;
  const tb = $("#cfg-table tbody");
  for (const e of c.session_config_entries || []) {
    const tr = document.createElement("tr");
    tr.innerHTML = `<td>${esc(e.name)}</td><td>${esc(e.type)}</td>` +
      `<td>${esc(String(e.default))}</td><td class="muted">${esc(e.description)}</td>`;
    tb.appendChild(tr);
  }
}

let busy = false;
async function refresh() {
  if (paused || busy) return;
  busy = true;
  try {
    const [state, jobs, execs] = await Promise.all([
      J("/api/state"), J("/api/jobs"), J("/api/executors")]);
    $("#h-id").textContent = state.scheduler_id || "–";
    $("#h-ver").textContent = state.version || "–";
    $("#h-ex").textContent = state.executors;
    $("#h-jobs").textContent = state.jobs;
    $("#h-upd").textContent = "updated " + new Date().toLocaleTimeString();
    cachedJobs = jobs;
    sample(jobs, execs);
    renderJobs(jobs);
    renderExecs(execs);
    await renderProm();
    if (selected) await renderDetail(selected);
  } catch (e) { $("#h-upd").textContent = "refresh failed: " + e.message; }
  finally { busy = false; }
}

function renderJobs(jobs) {
  const q = $("#q").value.trim().toLowerCase();
  const tb = $("#jobs tbody");
  tb.innerHTML = "";
  for (const j of jobs.slice().reverse()) {
    const hay = (j.job_id + " " + j.state + " " + (j.job_name || "")).toLowerCase();
    if (q && !hay.includes(q)) continue;
    const total = j.total_stages || 0;
    const done = j.completed_stages || 0;
    const pct = total ? Math.round(100 * done / total) : (j.state === "successful" ? 100 : 0);
    const sec = j.ended_at && j.queued_at ? (j.ended_at - j.queued_at).toFixed(2)
              : j.queued_at ? ((Date.now() / 1e3) - j.queued_at).toFixed(1) : "";
    const tr = document.createElement("tr");
    if (j.job_id === selected) tr.classList.add("sel");
    tr.innerHTML = `<td title="${esc(j.job_name || "")}">${esc(j.job_id)}</td>` +
      `<td>${stBadge(j.state)}</td><td>${done}/${total}</td>` +
      `<td><div class="bar"><i style="width:${pct}%"></i></div></td>` +
      `<td>${sec}</td>` +
      `<td>${["queued","running"].includes(j.state) ? '<button class="danger" data-cancel="' + esc(j.job_id) + '">cancel</button>' : ""}</td>`;
    tr.addEventListener("click", (ev) => {
      if (ev.target.dataset.cancel) return;
      selected = j.job_id;
      if (paused || busy) renderDetail(selected); else refresh();
    });
    tb.appendChild(tr);
  }
  tb.querySelectorAll("[data-cancel]").forEach(b => b.addEventListener("click", async () => {
    await fetch("/api/job/" + b.dataset.cancel + "/cancel", { method: "POST" });
    refresh();
  }));
}

function renderExecs(execs) {
  const tb = $("#execs tbody");
  tb.innerHTML = "";
  for (const e of execs) {
    const seen = e.last_seen ? Math.max(0, Date.now() / 1e3 - e.last_seen).toFixed(0) + "s ago" : "";
    const tr = document.createElement("tr");
    const dev = (e.device_ordinal == null || e.device_ordinal < 0) ? "–" : e.device_ordinal;
    tr.innerHTML = `<td>${esc(e.id)}</td><td>${esc(e.host)}</td><td>${e.grpc_port}</td>` +
      `<td>${e.flight_port}</td><td>${e.total_slots - e.free_slots}/${e.total_slots}</td>` +
      `<td>${dev}</td><td>${seen}</td>`;
    tb.appendChild(tr);
  }
}

async function renderProm() {
  const text = await fetch("/api/metrics").then(r => r.text());
  const keep = text.split("\n").filter(l => l && !l.startsWith("#")).slice(0, 12);
  $("#prom").textContent = keep.join("\n");
}

async function renderDetail(jobId) {
  // ONE lean request: /graph carries everything the detail pane shows
  // (the /stages endpoint with full plans + raw task metrics stays for
  // API tooling, but polling it per tab would re-ship hundreds of KB)
  let g;
  try { g = await J("/api/job/" + jobId + "/graph"); }
  catch { $("#detail").hidden = true; return; }
  $("#detail").hidden = false;
  $("#d-title").textContent = "Job " + jobId;
  $("#d-status").textContent = g.status;
  $("#d-status").className = "st " + g.status;
  drawDag(g);
  const tb = $("#stages tbody");
  tb.innerHTML = "";
  for (const s of g.stages) {
    const ops = (s.metric_percentiles || []).slice()
      .sort((a, b) => b.elapsed_ms_p50 - a.elapsed_ms_p50).slice(0, 3)
      .map(p => `${esc(p.name)} ${p.elapsed_ms_p50.toFixed(1)}/${p.elapsed_ms_p99.toFixed(1)}ms · ${p.output_rows_total} rows`)
      .join("  |  ");
    const tr = document.createElement("tr");
    tr.innerHTML = `<td>${s.stage_id}</td><td>${stBadge(s.state)}</td><td>${s.attempt}</td>` +
      `<td>${s.partitions}</td><td>${s.completed}</td>` +
      `<td title="${esc(s.summary)}">${ops || '<span class="muted">–</span>'}</td>`;
    tb.appendChild(tr);
  }
}

function drawDag(g) {
  // layer by longest path from sources (edges run upstream → downstream)
  const ids = g.stages.map(s => s.stage_id);
  const depth = Object.fromEntries(ids.map(i => [i, 0]));
  for (let pass = 0; pass < ids.length; pass++)
    for (const [a, b] of g.edges)
      if (depth[b] < depth[a] + 1) depth[b] = depth[a] + 1;
  const cols = {};
  for (const s of g.stages) (cols[depth[s.stage_id]] ||= []).push(s);
  const W = 170, H = 54, GX = 60, GY = 16;
  const maxRows = Math.max(1, ...Object.values(cols).map(c => c.length));
  const nCols = Object.keys(cols).length;
  const width = nCols * (W + GX), height = maxRows * (H + GY) + 20;
  const pos = {};
  let svg = `<defs><marker id="arr" markerWidth="7" markerHeight="7" refX="6" refY="3" orient="auto">` +
            `<path d="M0,0 L7,3 L0,6 z" fill="#8a96a3"/></marker></defs>`;
  Object.keys(cols).sort((a, b) => a - b).forEach((d, ci) => {
    cols[d].sort((a, b) => a.stage_id - b.stage_id).forEach((s, ri) => {
      const x = 10 + ci * (W + GX), y = 10 + ri * (H + GY);
      pos[s.stage_id] = [x, y];
      svg += `<g class="node ${esc(s.state)}"><rect x="${x}" y="${y}" width="${W}" height="${H}"/>` +
        `<text x="${x + 8}" y="${y + 18}">stage ${s.stage_id} · ${esc(s.state)}</text>` +
        `<text class="sub" x="${x + 8}" y="${y + 33}">${esc(String(s.summary).slice(0, 26))}</text>` +
        `<text class="sub" x="${x + 8}" y="${y + 47}">${s.completed}/${s.partitions} parts</text></g>`;
    });
  });
  let edges = "";
  for (const [a, b] of g.edges) {
    const [ax, ay] = pos[a], [bx, by] = pos[b];
    edges += `<line x1="${ax + W}" y1="${ay + H / 2}" x2="${bx - 4}" y2="${by + H / 2}"/>`;
  }
  const el = $("#dag");
  el.setAttribute("viewBox", `0 0 ${width} ${height}`);
  el.style.height = Math.min(300, height) + "px";
  el.innerHTML = svg + edges;
}

$("#pause").addEventListener("click", () => {
  paused = !paused;
  $("#pause").textContent = paused ? "resume" : "pause";
});
$("#cfg-btn").addEventListener("click", toggleConfig);
$("#q").addEventListener("input", () => renderJobs(cachedJobs));
refresh();
setInterval(refresh, 2000);
</script>
</body>
</html>
"""
