"""Device-idle milliseconds per traced reconstruction under the program's
``loop.capture`` spans (``core/loop.py`` ``_capture``: a step's CUDA graph
captured and instantiated): the union of those spans in each
reconstruction intersected with the device's idle intervals. Moves
``recon_per_s``. Nothing to read where no loop was captured."""

SPAN = "loop.capture"


def read(run):
    return run.idle_ms_per_recon(SPAN)
