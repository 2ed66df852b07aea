"""TensoRF-CP-384 (``portbench/configs/cp384.json``) at the CPU tests' tiny
size (``portbench/tests/tiny.py``): the port's TensorCP step against the
benchmark's plain CP reference (``portbench/fields/TensorCP.py``), the
TF32 control, the made state, the line reads' counters and the field's
FLOP counts."""

import math

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import counts, fields, readings, run as R
from portbench.tests.tiny import tiny_cell
from tensorf_tpu_torch.models import tensorf
from tensorf_tpu_torch.utils import tracing

CELL = "cp384.train"
SEED = 2 ** 31 + 11
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def cell():
    return tiny_cell(CELL)


@pytest.fixture(scope="module")
def sound(cell):
    """The port's readings and the TF32 control's, one seed."""
    return readings.train_readings(cell, SEED, CPU, True, "")


@pytest.fixture(scope="module")
def half_batch(cell):
    return readings.train_readings(cell, SEED, CPU, False, "half_batch")["program"]


def test_the_configuration_selects_the_cp_field(cell):
    train = cell.config["train"]
    mod = fields.load(train["model_name"], train["shadingMode"])
    assert mod.__file__.endswith("fields/TensorCP.py") and not mod.HAS_ORTHO
    assert (train["n_lamb_sigma"], train["n_lamb_sh"]) == ([96], [288])
    assert "sample_budget" not in train and "shade_top_k" not in train


@pytest.mark.parametrize("gap", ["loss_gap", "grad_gap"])
def test_the_port_agrees_with_the_cp_reference(sound, half_batch, gap):
    """At this size the cell's limits (set from full-size readings) do not
    bind the port; it must read at least ten times below the half-batch
    fault at the same seed."""
    assert sound["program"][gap] * 10 <= half_batch[gap], (sound["program"], half_batch)


def test_the_tf32_control_reads_incorrect(sound):
    """The reference with its matrix products in TF32 fails the committed
    limits, and reads ten times the port's loss gap."""
    assert not sound["control"]["correct"]
    assert sound["control"]["loss_gap"] >= 10 * sound["program"]["loss_gap"]


def test_the_reference_density_is_the_ports(cell):
    """The reference's CP density and appearance features equal the port's
    TensorCP reading the same lines, masked by FreeNeRF's rank masks."""
    from tensorf_tpu_torch.config import load_config
    from tensorf_tpu_torch.config.schema import model_config_from
    cfg = load_config(None, dict(cell.config["train"], n_lamb_sigma=[8], n_lamb_sh=[12]))
    port = tensorf.TensorCP(model_config_from(cfg), (9, 7, 5), device="cpu",
                            generator=torch.Generator().manual_seed(3))
    P = {k: v.detach() for k, v in port.named_parameters()}
    mod = fields.load("TensorCP", "MLP_Fea")
    xyz = torch.rand((200, 3), generator=torch.Generator().manual_seed(4)) * 2.2 - 1.1
    den, app = [torch.linspace(1e-8, 1.0, 8)], [torch.linspace(0.5, 1.0, 12)]
    with torch.no_grad():
        torch.testing.assert_close(mod.density_feature(P, xyz, den),
                                   port.density_feature(xyz, den))
        torch.testing.assert_close(mod.app_features(P, xyz, app) @ P["basis"],
                                   port.app_feature(xyz, app))
        torch.testing.assert_close(mod.l1(P), port.density_l1())
        torch.testing.assert_close(mod.tv(P, "density"), port.tv_density())
        torch.testing.assert_close(mod.tv(P, "app"), port.tv_app())


@pytest.fixture(scope="module")
def made_setup(cell):
    """The tiny cell's set-up (scene, the port's state, the made segment)."""
    return R.setup(cell, SEED, CPU)


def test_the_profile_reaches_3a_inside_the_objects(cell, made_setup):
    """The slab profile alone is 3A at every occupied lattice point and 0
    outside the slabs' boxes; the made lines, the init draw added, stay
    near 3A there."""
    from portbench import made
    s = made_setup
    seg = s.made.segment
    occ = made.occupancy_grid(s.scene, seg.aabb, seg.grid, CPU)
    A = float(cell.config["density_amplitude"])
    k = made.visible_ranks(s.cfg, 96, seg.iteration)
    # the feature at lattice point (x, y, z): line i spans axis VEC_MODE[i] = 2, 1, 0
    vol = torch.einsum("zr,yr,xr->xyz", *s.field.slab_profiles(occ, k, A))
    torch.testing.assert_close(vol[occ], torch.full_like(vol[occ], 3 * A))
    assert float(vol.max()) == pytest.approx(3 * A, rel=1e-5) and float(vol.min()) == 0.0
    assert int((vol > 0).sum()) > int(occ.sum())  # boxes, not the objects
    full = torch.einsum("zr,yr,xr->xyz", *(s.p0[f"density_line.{i}"] for i in range(3)))
    assert 2.5 * A < float(full[occ].median()) < 3.5 * A


@pytest.fixture(scope="module")
def traced_step(made_setup):
    """One step of the tiny cell from its made state, under a profiler:
    (the port's counters, the line spans' names, the port's field)."""
    tr = R.Trainer(made_setup, SEED, CPU)
    tracing.take_counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.step()
    spans = [e.name for e in prof.events() if e.name == tensorf.LINE_SPAN]
    return tracing.take_counts(), spans, made_setup.state.field


def test_the_made_state_shades(traced_step):
    c, _, _ = traced_step
    assert c["render.shaded"] > 0 and c["render.alive"] > 0


def test_the_line_counter_records_each_read(traced_step):
    """Every render reads the three density lines by the one-hot (route 1)
    on its density rows and the three appearance lines by taps (route 0) on
    its shaded rows, each inside a ``tftorch.field.line`` span."""
    c, spans, field = traced_step
    lines = c["line"]
    assert len(spans) == len(lines) > 0
    den = [r for r in lines if r[3] == 1]
    app = [r for r in lines if r[3] == 0]
    shapes = {tuple(getattr(field, n)[i].shape) for n in ("density_line", "app_line")
              for i in range(3)}
    assert all(r[1:3] in shapes for r in lines)
    assert {r[2] for r in den} == {96} and {r[2] for r in app} == {288}
    assert sum(r[0] for r in den) == 3 * c["render.density_rows"]
    assert sum(r[0] for r in app) == 3 * c["render.shade_rows"]


def test_the_line_counter_records_the_footprint_route(traced_step, monkeypatch):
    """Above the one-hot's byte bound a line read takes the footprint
    gather, and records route 0."""
    monkeypatch.setattr(tensorf, "_ONE_HOT_MAX_BYTES", 0)
    field = traced_step[2]
    xyz = torch.rand((64, 3), generator=torch.Generator().manual_seed(5)) * 2 - 1
    tracing.take_counts()
    with profile(activities=[ProfilerActivity.CPU]):
        field.density_feature_fused(xyz, None)
    lines = tracing.take_counts()["line"]
    assert [(r[0], r[2], r[3]) for r in lines] == [(64, 96, 0)] * 3
    assert [r[1] for r in lines] == [field.density_line[i].shape[0] for i in range(3)]


def test_the_cp_flop_counts_match_hand_counts(cell):
    from tensorf_tpu_torch.config import load_config
    cfg = load_config(None, cell.config["train"])
    mod = fields.load(cfg.model_name, cfg.shadingMode)
    # a density read a rank: 3 lines x 2 taps x a multiply-add, 2 products, 1 add
    assert mod.density_flops(cfg) == (3 * 2 * 2 + 2 + 1) * 96 == 1440
    # an appearance read a rank: the same without the sum over ranks
    assert mod.app_read_flops(cfg) == (3 * 2 * 2 + 2) * 288 == 4032
    basis = 2 * 288 * 27
    d_in = 2 * 2 * 3 + 2 * 2 * 27 + 3 + 27
    mlp = 2 * (d_in * 128 + 128 * 128 + 128 * 3)
    assert counts.shade_flops(mod, cfg) == 4032 + basis + mlp
    assert counts.step_flops(mod, cfg, 10, 2) == 3 * (10 * 1440 + 2 * (4032 + basis + mlp))
    assert math.isclose(counts.forward_flops(mod, cfg, 1, 0), 1440)


@pytest.mark.cuda
def test_the_tiny_cp_cell_on_the_card():
    """The same cut on the card: the one-hot's GEMMs in cuBLAS and the
    taps' scatter-add kernel against the reference."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's CUDA kernels run only there")
    from portbench.tests.tiny import assert_agrees
    from tensorf_tpu_torch.utils.device import resolve_device
    assert_agrees(CELL, resolve_device("cuda"))


def _metric(name):
    import importlib.util
    path = R.BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_line_roofline_reader_counts_two_gemms_a_matmul_read():
    """(1000 x 500) @ (500 x 96) and its transpose: 9.6e7 FLOPs each, FLOP
    bound at 67 TFLOP/s; the taps' read (route 0) adds nothing; every
    GEMM-named kernel's time is the denominator."""
    from types import SimpleNamespace
    read = _metric("line_roofline_pct.train").read
    kernels = {"sm80_xmma_gemm_f32f32_nn": (10.0, 1), "cutlass_80_simt_sgemm_nt": (5.0, 1),
               "cublasLt::splitKreduce_kernel": (1.0, 1), "where_kernel": (100.0, 1)}
    ctx = dict(kind="train", trace=SimpleNamespace(kernels=kernels),
               port_counts={"line": [(1000, 500, 96, 1), (10, 500, 288, 0)]})
    want = 100.0 * 2 * (2 * 1000 * 500 * 96 / 67e12) / 16e-6
    assert read(ctx) == pytest.approx(want)
    ctx["port_counts"] = {"line": [(10, 500, 288, 0)]}
    assert read(ctx) is None
    ctx["port_counts"] = None  # a port without the counters
    assert read(ctx) is None
    assert read(dict(ctx, kind="serve")) is None


def test_the_density_slot_use_reader():
    read = _metric("density_slot_use_pct.train").read
    ctx = dict(kind="train", port_counts={"render.alive": 309.0, "render.density_rows": 431.0})
    assert read(ctx) == pytest.approx(100.0 * 309 / 431)
    assert read(dict(kind="train", port_counts=None)) is None
