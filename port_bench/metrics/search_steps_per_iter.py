"""Steps of Brent's lambda search (the ``brent`` loops of
``core.loop.TRACE``) per outer iteration of the solver, over the traced
reconstructions. Moves ``recon_per_s``."""

LOOP = "brent"


def read(run):
    steps = [s for rec in run.loops for name, _, s in rec if name == LOOP]
    if not steps:
        return None
    return sum(steps) / (run.traced * run.params["n_iter"])
