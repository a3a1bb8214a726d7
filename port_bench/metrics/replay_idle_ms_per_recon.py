"""Device-idle milliseconds per traced reconstruction under the program's
``loop.replay`` spans (``core/loop.py`` ``_replayed``: one chunk's graph
replays and the host read that ends it), as
``capture_idle_ms_per_recon`` reads its span. Moves ``recon_per_s``."""

SPAN = "loop.replay"


def read(run):
    return run.idle_ms_per_recon(SPAN)
