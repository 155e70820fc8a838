"""The operation counts (core/opcount.py) against a count of every
arithmetic operation the plain reference's update runs, taken under a
dispatch mode at small grids."""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from core import opcount
from reference.plain import Reference, Scene

ELEMENTWISE = {"add", "sub", "mul", "div", "add_", "sub_", "mul_", "rsub"}


class Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func._schema.name.split("::")[-1]
        if name in ELEMENTWISE and args[0].dtype.is_floating_point:
            self.ops += out.numel()
        elif name == "sum":
            self.ops += args[0].numel() - 1
        return out


@pytest.mark.parametrize("maps,sar,dft,probes", [
    (False, False, (), ()),
    (True, True, (), ()),
    (False, False, (2.4e10, 2.45e10, 2.5e10, 2.55e10), ()),
    (True, True, (), ((1, 2, 3), (4, 4, 4), (6, 5, 2))),
    ("debye", True, (), ()),
    ("debye", False, (), ()),
])
@pytest.mark.parametrize("grid", [(8, 9, 10), (12, 12, 12)])
def test_counts_match_the_reference_update(maps, sar, dft, probes, grid):
    K, J, I = grid
    lmaps = pol = None
    if maps:
        eps = torch.ones(grid, dtype=torch.float64)
        eps[2:5, 2:6, 3:7] = 78.0
        lmaps = (eps.numpy(), (eps > 1).double().numpy() * 1.7)
    if maps == "debye":
        inside = (eps > 1).double().numpy()
        lmaps = (np.where(inside, 5.2, 1.0), inside * 0.27, inside * 74.9, inside * 9.36e-12)
        pol = {c: torch.rand(tuple(n + 1 for n in grid)).numpy() * 1e-9 for c in "xyz"}
    steps, every = 4, 2
    sc = Scene(grid, (I * 1e-3, J * 1e-3, K * 1e-3), 1e-3, 1e-12, 2.45e10, (0.005, 0.005), maps=lmaps, sar=sar,
               dft_hz=dft, probes=probes, output_every=every)
    ref = Reference(sc, "cpu")
    fields = {n: torch.rand(sc.padded).numpy() for n in ("ex", "ey", "ez", "hx", "hy", "hz")}
    with Count() as c:
        ref.follow(fields, steps, pol)
    lossy, ade = maps is True, maps == "debye"
    p = opcount.parts(grid, lossy, sar, len(dft), len(probes), ade)
    records = 1 + steps // every  # step 0 and every output_every steps
    want = steps * (p["h"] + p["e"] + p["sar"] + p["dft"] + p["probes"]) + records * p["energy_record"]
    assert c.ops == want
    assert opcount.per_step(grid, lossy, sar, len(dft), len(probes), every, ade) * steps + p["energy_record"] == want


def test_vacuum_cell_counts_thirty_a_cell():
    n = 256
    ops = opcount.per_step((n, n, n), False, False, 0, 0, 1000)
    assert 29.9 * n ** 3 < ops < 30.1 * n ** 3


def test_debye_sar_cell_counts_about_eighty_eight_a_cell():
    # H 15, the ADE E and P updates 12 and the work densities 7 an updated edge (2.98 a cell: the
    # wall edges are not updated), their cell means into the map 16, the log 0.03
    n = 256
    ops = opcount.per_step((n, n, n), False, True, 0, 0, 1000, ade=True)
    assert 87.5 * n ** 3 < ops < 87.8 * n ** 3


def test_bf16_storage_counts_the_work_of_its_fp32_scene():
    # the same operations in another storage: the roofline reads the same work
    from core.cell import Cell

    assert opcount.for_cell(Cell("oven_water_256_bf16.sar")) == opcount.for_cell(Cell("oven_water_256.sar"))
