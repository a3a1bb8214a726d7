"""Device-idle milliseconds per traced reconstruction under the program's
``mmgks.lambda`` spans (``solvers/mmgks.py``: lambda chosen on the host,
the projected solve, y back to the card), as ``capture_idle_ms_per_recon``
reads its span. Moves ``regularized_recon_per_s``."""

SPAN = "mmgks.lambda"


def read(run):
    return run.idle_ms_per_recon(SPAN)
