"""The controls: the plain reference put in the program's place, computed
below the configuration's precision (``CONTROLS`` of each reference:
float32 for float64, and in the Beneš cell also float64 with the rule's
nodes and weights rounded to float32), fail the check at each cell's own
order, where the float64 reference passes.

Each cell at its own N and T, on a few hundred trials (64 at N=7); the
readings at the cells' own sizes come from ``tools/readings.py`` on the
card."""
import pytest
import torch

from harness import check
from harness.cell import Cell

CELLS = {"bb.n15.b524288": 256, "pp.n7.b8192": 64, "pp.n3.b262144": 256}
CONTROLS = [(name, control) for name in CELLS
            for control in Cell(name).module("reference").CONTROLS]


def readings(name, seed, **precision):
    cell = Cell(name)
    traffic = dict(cell.traffic, B=CELLS[name])
    gen = torch.Generator().manual_seed(seed)
    ys = cell.module("traffic").generate(cell.config["model"], traffic, gen)["ys"]
    ref = cell.module("reference")
    truth = ref.run(cell.config, traffic, ys, torch.float64)
    other = ref.run(cell.config, traffic, ys, **precision)
    return check.verdict(ref.numbers(other, truth), cell.workload["limits"])


@pytest.mark.parametrize("name,control", CONTROLS)
def test_the_control_fails(name, control):
    precision = Cell(name).module("reference").CONTROLS[control]
    correct, compared = readings(name, 2**31 + 21, **precision)
    assert not correct, compared


@pytest.mark.parametrize("name", CELLS)
def test_the_reference_in_its_own_place_passes(name):
    correct, compared = readings(name, 2**31 + 21, dtype=torch.float64)
    assert correct, compared
