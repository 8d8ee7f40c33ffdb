"""CLI: `python -m ballista_tpu_torch.device_daemon --socket /path.sock`.

Runs the warm device-runtime daemon in the foreground (spawn-and-adopt
clients detach it themselves via start_new_session). Exit codes: 0 clean
shutdown (a `shutdown` request, SIGTERM, the parent's death or the idle
timeout; the socket is removed), 2 socket already owned by a live daemon,
3 an init phase failed or timed out (probe report, with a stack snapshot
on a timeout, at <socket>.probe.json; without a card this is phase
cuda_devices unless BALLISTA_TORCH_PLATFORM=cpu asks for the CPU forms),
4 execute watchdog killed a wedged request (post-mortem with the
offending request header and all thread stacks at <socket>.crash.json)."""

from __future__ import annotations

import argparse
import logging
import signal
import sys

from ballista_tpu_torch.device_daemon import protocol
from ballista_tpu_torch.device_daemon.server import DaemonServer, serve_flight


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ballista_tpu_torch.device_daemon")
    ap.add_argument("--socket", default=protocol.default_socket_path())
    ap.add_argument("--parent-pid", type=int, default=0,
                    help="exit when this pid dies (bench legs, tests); "
                         "0 = no parent watch")
    ap.add_argument("--device-ordinal", type=int, default=-1,
                    help="pin the daemon's card via bind_process_ordinal "
                         "before its first CUDA call; -1 = unpinned (card 0)")
    ap.add_argument("--idle-timeout-s", type=int, default=None,
                    help="override BALLISTA_TPU_DAEMON_IDLE_TIMEOUT_S")
    ap.add_argument("--flight-port", type=int, default=0,
                    help="also serve Flight do_exchange on this port "
                         "(0 = UDS only)")
    args = ap.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s daemon %(message)s")
    kw = {}
    if args.idle_timeout_s is not None:
        kw["idle_timeout_s"] = args.idle_timeout_s
    server = DaemonServer(args.socket, parent_pid=args.parent_pid,
                          device_ordinal=args.device_ordinal, **kw)
    # SIGTERM is a clean shutdown: the accept loop ends, the socket goes
    signal.signal(signal.SIGTERM, lambda *_: server.shutdown())
    try:
        if args.flight_port:
            serve_flight(server, args.flight_port)
        return server.serve_forever()
    except RuntimeError as e:
        print(f"device_daemon: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
