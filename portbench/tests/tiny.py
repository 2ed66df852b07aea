"""Cells cut to a CPU test's size: the same configuration files with a
32^3 -> 48^3 grid, every event within a few steps, 40x40 photos (a
forward capture of 10 views at 64x48) and a batch of 256."""

import copy

import torch

from portbench import run as R


def tiny_cell(name: str) -> R.Cell:
    c = R.load_cell(name)
    cfg = copy.deepcopy(c.config)
    t = cfg["train"]
    t.update(N_voxel_init=32 ** 3, N_voxel_final=48 ** 3, batch_size=256)
    if cfg["scene"]["kind"] == "composite":
        t.update(upsamp_list=[2, 3, 4, 5, 7], update_AlphaMask_list=[2, 4])
        cfg["scene"].update(wh=[40, 40])
    else:
        t.update(upsamp_list=[2, 3, 4, 5], update_AlphaMask_list=[3])
        cfg["scene"].update(wh=[64, 48], focal=52.0, n_views=10)
    traffic = dict(c.traffic)
    if traffic["kind"] == "serve":
        traffic.update(wh=[40, 40], max_views=6)
    return c._replace(config=cfg, traffic=traffic)


def run_tiny(name: str, seed: int = 2 ** 31 + 11, trace: bool = False) -> dict:
    return R.run(tiny_cell(name), seed, 1.0, trace, torch.device("cpu"))


def assert_agrees(name: str, device) -> None:
    """At this size the cell's limits (set from full-size readings) do not
    apply; the port's loss and first-gradient gaps must instead read at
    least ten times below the half-batch fault's at the same size and seed
    (a served cell: within its limit, whose control reads 60x above it)."""
    from portbench import readings
    cell = tiny_cell(name)
    if cell.traffic["kind"] == "serve":
        res = R.run(cell, 2 ** 31 + 11, 1.0, False, device)
        assert res["correct"] and res["failed"] == 0, res["checks"]
        return
    sound = readings.train_readings(cell, 2 ** 31 + 11, device, False, "")["program"]
    fault = readings.train_readings(cell, 2 ** 31 + 11, device, False, "half_batch")["program"]
    for k in ("loss_gap", "grad_gap"):
        assert sound[k] * 10 <= fault[k], (name, k, sound[k], fault[k])
