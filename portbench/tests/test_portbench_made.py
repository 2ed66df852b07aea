"""The made state at a tiny grid, and the reference against it."""

import numpy as np
import pytest
import torch

from portbench import fields, made, reference as ref
from portbench.scene import COMPOSITE_SPHERES, make_scene

from .tiny import assert_agrees, tiny_cell


def test_slab_profiles_sum_to_three_amplitudes_inside_the_objects():
    occ = torch.zeros((8, 8, 8), dtype=torch.bool)
    occ[2:5, 3:6, 1:4] = True
    total = torch.zeros((8, 8, 8))
    vm = fields.load("TensorVMSplit", "MLP_Fea")
    for i in range(3):
        plane, line = vm.slab_profiles(occ, i, 2, 10.0)
        m0, m1 = vm.MAT_MODE[i]
        a = vm.VEC_MODE[i]
        x, y, z = torch.meshgrid(torch.arange(8), torch.arange(8), torch.arange(8), indexing="ij")
        idx = (x, y, z)
        total += (plane[idx[m1], idx[m0]] * line[idx[a]]).sum(-1)
    assert torch.all(total[occ] == 30.0)
    assert torch.all(total[~occ] <= 10.0)


def test_walk_schedule_shrinks_to_the_objects_and_reaches_the_last_grid():
    cell = tiny_cell("synth_full.train")
    from tensorf_tpu_torch.config import load_config
    cfg = load_config(None, dict(cell.config["train"]))
    scene = make_scene(cell.config["scene"], "cpu")
    full = np.array([[-1.5] * 3, [1.5] * 3], np.float32)
    seg = made.walk_schedule(cfg, full, scene, "last", "cpu")
    lo = np.min([np.array(c) - r for c, r, *_ in COMPOSITE_SPHERES], 0)
    hi = np.max([np.array(c) + r for c, r, *_ in COMPOSITE_SPHERES], 0)
    assert np.all(seg.aabb[0] <= lo) and np.all(seg.aabb[1] >= hi)
    assert np.all(seg.aabb[0] > -1.5) and np.all(seg.aabb[1] < 1.5)
    assert seg.iteration == 8 and seg.grid == made.n_to_reso(48 ** 3, seg.aabb)
    assert seg.mask is not None and seg.refilter is not None
    assert seg.l1_weight == cfg.L1_weight_rest
    first = made.walk_schedule(cfg, full, scene, "first", "cpu")
    assert first.iteration == 0 and first.mask is None


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12, -3.0])
    assert ref.tf32_round(x).tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -10, -3.0]


@pytest.mark.parametrize("name", ["synth_full.train", "flower.train",
                                  "synth_full.serve"])
def test_the_port_agrees_with_the_reference_on_the_made_state(name):
    assert_agrees(name, torch.device("cpu"))
