"""gRPC channel/server construction with tuned options.

Rebuild of GrpcClientConfig / GrpcServerConfig +
create_grpc_client_endpoint / create_grpc_server
(core/src/utils.rs:59,133,308,344): message-size ceilings and keepalive
applied consistently everywhere a channel or server is built, driven by
the same `ballista.grpc.*` session keys the reference uses.
"""

from __future__ import annotations

import grpc

from ballista_tpu_torch.config import (
    GRPC_CLIENT_MAX_MESSAGE_SIZE,
    GRPC_SERVER_MAX_MESSAGE_SIZE,
    GRPC_TLS_CA,
    GRPC_TLS_CERT,
    GRPC_TLS_KEY,
    BallistaConfig,
)

KEEPALIVE_MS = 30_000
KEEPALIVE_TIMEOUT_MS = 10_000


def client_options(config: BallistaConfig | None = None) -> list[tuple]:
    n = int((config or BallistaConfig()).get(GRPC_CLIENT_MAX_MESSAGE_SIZE))
    return [
        ("grpc.max_send_message_length", n),
        ("grpc.max_receive_message_length", n),
        ("grpc.keepalive_time_ms", KEEPALIVE_MS),
        ("grpc.keepalive_timeout_ms", KEEPALIVE_TIMEOUT_MS),
        ("grpc.keepalive_permit_without_calls", 1),
    ]


def server_options(config: BallistaConfig | None = None) -> list[tuple]:
    n = int((config or BallistaConfig()).get(GRPC_SERVER_MAX_MESSAGE_SIZE))
    return [
        ("grpc.max_send_message_length", n),
        ("grpc.max_receive_message_length", n),
        ("grpc.keepalive_time_ms", KEEPALIVE_MS),
        ("grpc.keepalive_timeout_ms", KEEPALIVE_TIMEOUT_MS),
    ]


def _read(path: str | None) -> bytes | None:
    if not path:
        return None
    with open(path, "rb") as f:
        return f.read()


def create_channel(addr: str, config: BallistaConfig | None = None) -> grpc.Channel:
    """TLS when the session carries a CA (ballista.grpc.tls.ca.path);
    cert+key additionally enable mTLS client auth. Plaintext otherwise —
    the reference's GrpcClientConfig TLS switch (core/src/utils.rs:59)."""
    cfg = config or BallistaConfig()
    ca = _read(str(cfg.get(GRPC_TLS_CA) or ""))
    if ca:
        creds = grpc.ssl_channel_credentials(
            root_certificates=ca,
            private_key=_read(str(cfg.get(GRPC_TLS_KEY) or "")),
            certificate_chain=_read(str(cfg.get(GRPC_TLS_CERT) or "")),
        )
        return grpc.secure_channel(addr, creds, options=client_options(cfg))
    return grpc.insecure_channel(addr, options=client_options(cfg))


def bind_server_port(server: grpc.Server, bind: str,
                     tls_cert: str | None = None, tls_key: str | None = None,
                     tls_client_ca: str | None = None) -> int:
    """add_secure_port when a server cert is configured (client CA →
    REQUIRED client certs = mTLS); add_insecure_port otherwise."""
    if tls_cert and tls_key:
        creds = grpc.ssl_server_credentials(
            [(_read(tls_key), _read(tls_cert))],
            root_certificates=_read(tls_client_ca),
            require_client_auth=bool(tls_client_ca),
        )
        return server.add_secure_port(bind, creds)
    return server.add_insecure_port(bind)
