"""Seconds from the geometry to the packed operator on the device: the
program's matrix builder and pack (host clock around the harness's call,
synchronized). Moves ``setup_s``."""


def read(run):
    return run.spans.get("build")
