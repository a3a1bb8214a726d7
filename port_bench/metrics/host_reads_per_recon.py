"""Host reads of the program's device loops (``core.loop.TRACE``) per
reconstruction, over the traced ones. Moves ``recon_per_s``. Nothing to
read where no loop of ``core.loop`` ran."""


def read(run):
    if not any(run.loops):
        return None
    return sum(r for rec in run.loops for _, r, _ in rec) / len(run.loops)
