"""The readers of the port's spans and counters (span_reads.py) on
hand-built traces and counters, and on a tiny traced run."""

import importlib.util

import pytest

from portbench import run as R
from portbench import span_reads as S
from portbench.trace import DeviceTrace

from .tiny import run_tiny

TRAIN = ("sample", "forward", "backward", "optim")


def trace(device, host):
    return DeviceTrace(sorted(device), {}, host, (0.0, 0.0))


def ctx(tr, units=1, plain_wall_s=None, kind="train"):
    return dict(kind=kind, trace=tr, units=units, plain_wall_s=plain_wall_s)


def reader(name):
    spec = importlib.util.spec_from_file_location(name, R.BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# a step from 0 to 100 us: sample 0-10, batch 10-20, forward 20-60 (a render
# 25-55 inside), backward 60-90, optim 90-95; device busy 5-15, 30-40, 62-88
STEP = [(0.0, 100.0, "tftorch.train.step"), (0.0, 10.0, "tftorch.train.sample"),
        (10.0, 20.0, "tftorch.train.batch"), (20.0, 60.0, "tftorch.train.forward"),
        (25.0, 55.0, "tftorch.train.render"), (60.0, 90.0, "tftorch.train.backward"),
        (90.0, 95.0, "tftorch.train.optim"), (31.0, 32.0, "aten::mul")]
BUSY = [(5.0, 15.0), (30.0, 40.0), (62.0, 88.0)]


def test_phases_and_the_rest_sum_to_the_idle_time_a_unit():
    tr = trace(BUSY, STEP)
    c = ctx(tr, units=1, plain_wall_s=200e-6)
    parts = S.idle_by_phase(c, "train")
    # idle: 0-5, 15-30, 40-62, 88-100 = 54 us of the region's 100
    per_unit_ms = 1e3 * (200e-6 - tr.busy_us / 1e6)
    assert sum(parts.values()) == pytest.approx(per_unit_ms)
    # sample+batch 0-5, 15-20; forward 20-30, 40-60; backward 60-62, 88-90;
    # optim 90-95; the rest 95-100
    want = {"sample": 10, "forward": 30, "backward": 4, "optim": 5, "unattributed": 5}
    for k, us in want.items():
        assert parts[k] == pytest.approx(per_unit_ms * us / 54), k
    idle_pct = reader("device_idle_pct.train")(c)
    assert sum(parts.values()) == pytest.approx(idle_pct / 100 * 200e-6 * 1e3)
    for phase in TRAIN:
        assert reader(f"{phase}_idle_ms.train")(c) == pytest.approx(parts[phase])


def test_a_gap_across_two_phases_is_split_between_them():
    host = [(0.0, 50.0, "tftorch.serve.count"), (50.0, 80.0, "tftorch.serve.bucket"),
            (80.0, 100.0, "tftorch.serve.fetch")]
    c = ctx(trace([(0.0, 40.0), (70.0, 100.0)], host), plain_wall_s=130e-6, kind="serve")
    # the one gap, 40-70: 10 us in the count, 20 in the bucket
    assert reader("count_idle_ms.serve")(c) == pytest.approx(0.06 * 10 / 30)
    assert reader("bucket_idle_ms.serve")(c) == pytest.approx(0.06 * 20 / 30)
    assert reader("fetch_idle_ms.serve")(c) == 0.0
    # the region starts at the earlier of the first span and the first
    # activity: idle before the first kernel counts in its phase
    c = ctx(trace([(20.0, 100.0)], host), plain_wall_s=100e-6, kind="serve")
    assert reader("count_idle_ms.serve")(c) == pytest.approx(0.02)


def test_no_port_span_reads_none():
    host = [(0.0, 100.0, "aten::mul"), (10.0, 20.0, "cudaLaunchKernel")]
    c = ctx(trace(BUSY, host), plain_wall_s=200e-6)
    assert S.idle_by_phase(c, "train") is None
    for phase in TRAIN:
        assert reader(f"{phase}_idle_ms.train")(c) is None
    # another kind of unit reads none either
    assert reader("count_idle_ms.serve")(ctx(trace(BUSY, STEP), plain_wall_s=1.0)) is None


def test_slot_use_from_counters():
    c = ctx(trace([], []))
    c["port_counts"] = {"render.alive": 300.0, "render.density_rows": 1200.0,
                        "render.shaded": 30.0, "render.shade_rows": 2400.0}
    assert reader("density_slot_use_pct.train_device_bound")(c) == pytest.approx(25.0)
    assert reader("shade_slot_use_pct.train_device_bound")(c) == pytest.approx(1.25)
    c["port_counts"] = {}
    assert reader("shade_slot_use_pct.train_device_bound")(c) is None
    assert reader("shade_slot_use_pct.train_device_bound")(dict(c, kind="serve")) is None


def test_tiny_traced_run_reports_the_new_metrics():
    res = run_tiny("flower.train", trace=True)
    for name in ("density_slot_use_pct.train_device_bound", "shade_slot_use_pct.train_device_bound"):
        assert 0 < res["metrics"][name]["value"] <= 100, name
