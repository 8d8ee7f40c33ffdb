"""A minimal in-process S3-compatible HTTP server for integration tests.

The reference tests S3 scans with testcontainers + MinIO
(examples/tests/object_store.rs); this build environment has zero network
egress and no container runtime, so the equivalent is a tiny S3 protocol
shim serving a local directory: HEAD/GET (with Range) for objects and
ListObjectsV2 for discovery — exactly the calls pyarrow's S3FileSystem
(the AWS SDK) issues for dataset registration and parquet reads.
Signatures are not validated (the SDK signs; we accept)."""

from __future__ import annotations

import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, unquote, urlparse
from xml.sax.saxutils import escape


class _Handler(BaseHTTPRequestHandler):
    root: str = ""
    protocol_version = "HTTP/1.1"

    def log_message(self, *a):  # noqa: D102 — quiet
        return

    def _object_path(self) -> str:
        # /bucket/key... → {root}/bucket/key
        return os.path.join(self.root, unquote(urlparse(self.path).path.lstrip("/")))

    def do_HEAD(self):  # noqa: N802
        p = self._object_path()
        if os.path.isfile(p):
            self.send_response(200)
            self.send_header("Content-Length", str(os.path.getsize(p)))
            self.send_header("Accept-Ranges", "bytes")
            self.send_header("ETag", '"mini"')
            self.send_header("Last-Modified", "Thu, 01 Jan 2026 00:00:00 GMT")
            self.end_headers()
        else:
            self.send_response(404)
            self.send_header("Content-Length", "0")
            self.end_headers()

    def do_GET(self):  # noqa: N802
        url = urlparse(self.path)
        q = parse_qs(url.query)
        if "list-type" in q or "prefix" in q or url.path.count("/") == 1:
            return self._list(url, q)
        p = self._object_path()
        if not os.path.isfile(p):
            body = b"<Error><Code>NoSuchKey</Code></Error>"
            self.send_response(404)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        size = os.path.getsize(p)
        rng = self.headers.get("Range")
        start, end = 0, size - 1
        status = 200
        if rng and rng.startswith("bytes="):
            spec = rng[len("bytes="):]
            s, _, e = spec.partition("-")
            start = int(s) if s else max(0, size - int(e))
            end = int(e) if e and s else (size - 1 if s else size - 1)
            end = min(end, size - 1)
            status = 206
        length = end - start + 1
        self.send_response(status)
        self.send_header("Content-Length", str(length))
        self.send_header("Accept-Ranges", "bytes")
        if status == 206:
            self.send_header("Content-Range", f"bytes {start}-{end}/{size}")
        self.end_headers()
        with open(p, "rb") as f:
            f.seek(start)
            self.wfile.write(f.read(length))

    def _list(self, url, q):
        bucket = url.path.strip("/").split("/")[0]
        prefix = q.get("prefix", [""])[0]
        base = os.path.join(self.root, bucket)
        keys = []
        for root_dir, _dirs, files in os.walk(base):
            for f in files:
                full = os.path.join(root_dir, f)
                key = os.path.relpath(full, base).replace(os.sep, "/")
                if key.startswith(prefix):
                    keys.append((key, os.path.getsize(full)))
        keys.sort()
        parts = [
            "<?xml version=\"1.0\" encoding=\"UTF-8\"?>",
            "<ListBucketResult><IsTruncated>false</IsTruncated>",
            f"<Name>{escape(bucket)}</Name>",
            f"<Prefix>{escape(prefix)}</Prefix>",
            f"<KeyCount>{len(keys)}</KeyCount>",
        ]
        for key, size in keys:
            parts.append(
                f"<Contents><Key>{escape(key)}</Key><Size>{size}</Size>"
                "<LastModified>2026-01-01T00:00:00.000Z</LastModified>"
                "<ETag>\"mini\"</ETag><StorageClass>STANDARD</StorageClass></Contents>"
            )
        parts.append("</ListBucketResult>")
        body = "".join(parts).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/xml")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


def start_mini_s3(root: str, host: str = "127.0.0.1", port: int = 0):
    """Serve `root` as S3 buckets; returns (server, endpoint_url)."""
    handler = type("MiniS3Handler", (_Handler,), {"root": root})
    srv = ThreadingHTTPServer((host, port), handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True, name="mini-s3")
    t.start()
    return srv, f"http://{host}:{srv.server_address[1]}"
