"""The comparison fails what it must: the control (the reference with its
matrix products in TF32, put in the port's place) and the faults a cell
can have, each planted under a run on the CPU at a tiny size."""

import numpy as np
import pytest

from portbench import readings

from .tiny import run_tiny, tiny_cell


def test_a_step_that_leaves_the_state_unchanged_fails(monkeypatch):
    from tensorf_tpu_torch.train.optim import TwoGroupAdam
    monkeypatch.setattr(TwoGroupAdam, "step", lambda self: None)
    res = run_tiny("synth_full.train")
    assert not res["correct"]
    assert res["checks"]["change_gap"]["value"] > 0.99


@pytest.mark.parametrize("name", ["synth_full.train", "flower.train"])
def test_half_the_batch_left_out_fails(monkeypatch, name):
    import tensorf_tpu_torch.train.step as step_mod
    monkeypatch.setattr(step_mod, "mse_loss", readings.half_batch_mse)
    res = run_tiny(name)
    assert not res["correct"]


def test_an_altered_store_row_fails(monkeypatch):
    from portbench import run as R
    inner = R.setup

    def altered(*a, **k):
        s = inner(*a, **k)
        readings.alter_rows(s.state)
        return s
    monkeypatch.setattr(R, "setup", altered)
    res = run_tiny("synth_full.train")
    assert not res["correct"]
    assert res["checks"]["store_gap"]["value"] > 0.5


def test_an_altered_served_answer_fails(monkeypatch):
    from tensorf_tpu_torch.eval.evaluation import RendererHandle
    inner = RendererHandle.render

    def altered(self, rays, *a, **k):
        rgb, depth, n = inner(self, rays, *a, **k)
        rgb = np.array(rgb)
        rgb[len(rgb) // 2] = 1.0 - rgb[len(rgb) // 2]
        return rgb, depth, n
    monkeypatch.setattr(RendererHandle, "render", altered)
    res = run_tiny("synth_full.serve")
    assert not res["correct"]


@pytest.mark.parametrize("name", ["synth_full.train", "flower.train"])
def test_the_tf32_control_reads_far_above_the_port(name):
    """At this size the control's gaps stand at least ten times the port's
    on some compared number; on the card, at the cell's size, they set the
    limits' upper readings (PERF.md)."""
    import torch
    cell = tiny_cell(name)
    res = readings.train_readings(cell, 7, torch.device("cpu"), True, "")
    limits = cell.workload["limits"]
    assert max(res["control"][k] / max(res["program"][k], 1e-12) for k in limits) >= 10.0
