"""Find a cell's files by name.

A cell ``<cell>`` is an entry of ``BENCHMARK.json``'s ``workloads`` at the
root of the checkout, which gives its configuration, chips and ``why``,
and ``workloads/<cell>.json``, which gives its traffic (``N``, ``B``),
the size of the check's sample and the limits of the compared numbers.
The configuration ``configs/<config>.json`` names the system under test,
``systems/<system>.py``, its traffic generator, ``traffic/<system>.py``,
and its plain reference, ``reference/<system>.py``, which also says what
is compared (``harness/check.py``).  A metric ``<metric>`` is read by
``metrics/<metric>.py``.  The metrics a cell reports are those of
``BENCHMARK.json`` that list the cell or list no cells.  Adding a cell,
a configuration or a metric is adding these files and entries.

What the harness takes of the modules: ``traffic.generate(model,
traffic, generator)`` returns ``{"ys": (T, B, ...)}``, the observations
with time first and trials second; ``systems.System(config, traffic,
device, probes)`` has ``warm_up(ys, steps)`` and ``run_pass(ys)``, whose
output holds the reference's ``ANSWERS`` and ``finite (B,)``, and may
hold ``rerun`` and ``rerun_idx`` (trials handed to a rescue) and a
``quadrature_site`` for the traced run's range (``harness/probes.py``).
"""
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BENCHMARK = ROOT.parent / "BENCHMARK.json"


def load_json(kind: str, name: str) -> dict:
    path = ROOT / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    return json.loads(path.read_text())


def load_module(kind: str, name: str):
    path = ROOT / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module named {name!r} ({path})")
    key = f"filterbench_{kind}_{name}_{abs(hash(str(path)))}".replace(".", "_")
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[key] = module
    spec.loader.exec_module(module)
    return module


class Cell:
    def __init__(self, name: str):
        self.name = name
        self.workload = load_json("workloads", name)
        spec = json.loads(BENCHMARK.read_text())
        entries = [w for w in spec["workloads"] if w["name"] == name]
        if not entries:
            raise KeyError(f"BENCHMARK.json has no cell named {name!r}")
        self.entry = entries[0]
        self.config = load_json("configs", self.entry["config"])
        self.system_name = self.config["system"]
        self.traffic = self.workload["traffic"]
        self.chips = int(self.entry["chips"])
        listed = lambda m: name in m.get("workloads", [name])
        self.end_to_end = [m for m in spec["end_to_end"] if listed(m)]
        self.per_layer = [m for m in spec["per_layer"] if listed(m)]

    def module(self, kind: str):
        return load_module(kind, self.system_name)
