"""Device milliseconds per solver iteration in cuSOLVER's Householder QR
kernels (the panel QRs of MMGKS), from the traced sub-window. Moves
``recon_per_s``."""

PATTERNS = ("geqr2", "geqrf", "larft", "larfb", "orgqr", "org2r")


def read(run):
    us = [d for name, _, d in run.kernels
          if any(p in name for p in PATTERNS)]
    if not us:
        return None
    return sum(us) / 1e3 / (run.traced * run.params["n_iter"])
