"""Scheduler-side Flight result proxy.

Rebuild of BallistaFlightProxyService (scheduler/src/flight_proxy_service.rs:42,114)
+ the client's FlightProxy::External mode (core/src/execution_plans/
distributed_query.rs:754-783): clients that cannot reach executors directly
(NAT, k8s cluster networking) fetch result partitions from the scheduler,
which relays from the owning executor over the raw-block path.

Tickets are the normal fetch tickets plus the executor's {host, flight_port}
so the proxy knows where to relay from. The relay is a streaming
pass-through: each upstream Result body is forwarded verbatim (zero
re-chunking, nothing buffered), which also preserves the
io_coalesced_transport header framing byte-for-byte — the proxy needs no
knowledge of the coalesced wire format to relay it. The same property
carries the shuffle-integrity checksum headers ({"nbytes", "crc"} on the
block path, "crc" in coalesced frames) end to end: external clients verify
against the EXECUTOR's stored checksum, so a corruption introduced by the
relay hop itself is also caught.
"""

from __future__ import annotations

import json
import threading

import pyarrow.flight as flight

from ballista_tpu_torch.config import _env_int

RELAY_ACTIONS = ("io_block_transport", "io_coalesced_transport")


class FlightResultProxy(flight.FlightServerBase):
    def __init__(self, host: str = "0.0.0.0", port: int = 0,
                 tls_cert: str | None = None, tls_key: str | None = None,
                 tls_client_ca: str | None = None):
        kwargs = {}
        scheme = "grpc"
        if tls_cert and tls_key:
            scheme = "grpc+tls"
            with open(tls_cert, "rb") as f:
                cert = f.read()
            with open(tls_key, "rb") as f:
                key = f.read()
            kwargs["tls_certificates"] = [(cert, key)]
            if tls_client_ca:
                with open(tls_client_ca, "rb") as f:
                    kwargs["root_certificates"] = f.read()
                kwargs["verify_client"] = True
        super().__init__(f"{scheme}://{host}:{port}", **kwargs)
        # executor-side dial credentials: (ca, cert, key)
        self.relay_tls = (tls_client_ca, tls_cert, tls_key) if (tls_client_ca and tls_cert) else None
        self.stats = {"relayed_actions": 0, "relayed_gets": 0, "relays_rejected": 0}
        # the proxy multiplexes EVERY external client over one scheduler
        # host, so it gets the same bounded-stream gate as the executors'
        # data plane (same env knobs; no session config here either)
        from ballista_tpu_torch.flight.server import _StreamGate

        self.gate = _StreamGate(
            _env_int("BALLISTA_FLIGHT_MAX_STREAMS", 64),
            _env_int("BALLISTA_FLIGHT_ACCEPT_QUEUE", 128),
        )

    def _gate_acquire(self) -> None:
        try:
            self.gate.acquire()
        except flight.FlightUnavailableError:
            self.stats["relays_rejected"] += 1
            raise

    def _upstream(self, ticket: dict) -> tuple[str, flight.FlightClient]:
        """Dial the owning executor. In a TLS cluster the proxy presents the
        scheduler's own credentials (the executors' data plane requires
        client certs)."""
        from ballista_tpu_torch.flight.client import POOL

        addr = f"{ticket['host']}:{ticket['flight_port']}"
        return addr, POOL.get(addr, tls=self.relay_tls)

    def do_get(self, context, ticket):
        from ballista_tpu_torch.flight.client import POOL

        t = json.loads(ticket.ticket.decode())
        self._gate_acquire()
        addr, client = self._upstream(t)
        try:
            reader = client.do_get(flight.Ticket(json.dumps(t).encode()))
            schema = reader.schema
        except Exception:
            self.gate.release()
            POOL.discard(addr)
            raise
        self.stats["relayed_gets"] += 1

        def gen():
            try:
                for chunk in reader:
                    yield chunk.data
            except Exception:
                POOL.discard(addr)
                raise
            finally:
                self.gate.release()

        return flight.GeneratorStream(schema, gen())

    def do_action(self, context, action):
        from ballista_tpu_torch.flight.client import POOL

        if action.type in RELAY_ACTIONS:
            t = json.loads(action.body.to_pybytes().decode())
            self._gate_acquire()
            try:
                addr, client = self._upstream(t)
                self.stats["relayed_actions"] += 1
                try:
                    # forward the body unchanged — the executor ignores the
                    # routing keys — and pass every Result through verbatim
                    up = flight.Action(action.type, json.dumps(t).encode())
                    for r in client.do_action(up):
                        yield flight.Result(r.body)
                except Exception:
                    POOL.discard(addr)
                    raise
            finally:
                self.gate.release()
            return
        raise flight.FlightServerError(f"unknown action {action.type}")

    def list_actions(self, context):
        return [("io_block_transport", "relay raw IPC blocks from an executor"),
                ("io_coalesced_transport", "relay a framed multi-location block stream")]


def start_flight_proxy(host: str = "0.0.0.0", port: int = 0,
                       tls_cert: str | None = None, tls_key: str | None = None,
                       tls_client_ca: str | None = None) -> tuple[FlightResultProxy, int]:
    server = FlightResultProxy(host, port, tls_cert=tls_cert, tls_key=tls_key,
                               tls_client_ca=tls_client_ca)
    bound = server.port
    t = threading.Thread(target=server.serve, daemon=True, name="flight-proxy")
    t.start()
    return server, bound
