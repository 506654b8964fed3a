"""Daemon: HTTP server exposing the engine (counterpart of
``testground_tpu.daemon``; reference pkg/daemon/)."""

from .server import Daemon


def serve(home=None, listen=None, device="cuda") -> int:
    """Serve the daemon on ``listen`` until SIGTERM or interrupt; its runs
    run on ``device`` (the card unless the caller asks for the CPU)."""
    from ..device import resolve_device

    resolve_device(device)
    d = Daemon(home=home, listen=listen, device=device)
    print(f"daemon listening on {d.endpoint}", flush=True)
    return d.serve_forever()


__all__ = ["Daemon", "serve"]
