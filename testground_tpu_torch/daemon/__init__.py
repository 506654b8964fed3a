"""Daemon: HTTP server exposing the engine (counterpart of
``testground_tpu.daemon``; reference pkg/daemon/)."""

from .server import Daemon


def serve(home=None, listen=None, device="cuda", peers=None,
          advertise=None) -> int:
    """Serve the daemon on ``listen`` until SIGTERM or interrupt; its runs
    run on ``device`` (the card unless the caller asks for the CPU).
    ``peers`` make it the federation coordinator of those worker daemons
    (``advertise``: the endpoint they dial back)."""
    from ..device import resolve_device

    resolve_device(device)
    d = Daemon(home=home, listen=listen, device=device, peers=peers,
               advertise=advertise)
    if d.federation is not None:
        print(
            f"daemon listening on {d.endpoint} "
            f"(federation coordinator of {len(d.federation.peers)} "
            "peer(s))",
            flush=True,
        )
    else:
        print(f"daemon listening on {d.endpoint}", flush=True)
    return d.serve_forever()


__all__ = ["Daemon", "serve"]
