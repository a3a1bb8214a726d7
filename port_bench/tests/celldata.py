"""Each cell's test data, found by name as the harness finds a cell's run
files, so that a new cell brings its own as new files. No run reads them:

- ``configs/<config>.json``: ``tiny`` and ``small``, the configuration's
  overrides at the sizes of the result-line and fault tests and of the
  control test;
- ``traffic/<traffic>.json``: ``tiny``, the mix's parameters at the tiny
  size, and ``spans``, the program spans its traced sub-window holds;
- ``faults/<entry>.py``: ``faults()``, each fault the entry's timed path
  can have, as (name, module, attribute, replacement), planted where the
  path produces it.
"""
import importlib
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parents[1]
SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = {w["name"]: w for w in SPEC["workloads"]}


class MissingTestData(LookupError):
    pass


def _need(path, what):
    if not path.is_file():
        raise MissingTestData(f"no test data for {what}: add "
                              f"{path.relative_to(REPO).as_posix()}")
    return path


def config(name):
    return json.loads(_need(HERE / "configs" / f"{name}.json",
                            f"the configuration {name!r}").read_text())


def traffic(name):
    return json.loads(_need(HERE / "traffic" / f"{name}.json",
                            f"the traffic {name!r}").read_text())


def faults(entry):
    _need(HERE / "faults" / f"{entry}.py", f"the entry {entry!r}")
    return importlib.import_module(
        f"port_bench.tests.faults.{entry}").faults()
