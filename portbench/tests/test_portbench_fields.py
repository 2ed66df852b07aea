"""The field modules: the loader, and the TensorVMSplit module held bit for
bit to the readings that the harness gave before the field's layout moved
into it (``fields_golden.json``: the made factors, the reference's density,
radiance and regularizers with their gradients, a render, and the FLOP
counts, at the tiny size, one seed)."""

import hashlib
import json
import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import counts, fields, made, reference as ref, run as R

from .tiny import tiny_cell

HERE = Path(__file__).resolve().parent
SEED = 2 ** 31 + 11


@pytest.fixture
def one_thread():
    """One CPU thread, so that every reduction sums in one order."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("config", ["synth_full", "flower"])
def test_each_configuration_resolves_to_its_field_module(config):
    bench = json.loads((R.ROOT / "BENCHMARK.json").read_text())
    conf = {c["name"]: c for c in bench["configs"]}[config]
    train = json.loads((R.ROOT / conf["file"]).read_text())["train"]
    mod = fields.load(train["model_name"], train["shadingMode"])
    assert Path(mod.__file__) == fields.HERE / "TensorVMSplit.py"
    assert all(hasattr(mod, n) for n in fields.INTERFACE)


MADE_UP = '''
import torch

HAS_ORTHO = False


def make_factors(cfg, grid, occ, visible, amplitude, gen, device):
    return {"density_volume": torch.randn(tuple(grid) + (2,), generator=gen, device=device)}


def density_feature(P, xyz, masks):
    return 2.0 * xyz.sum(-1)


def app_features(P, xyz, masks):
    return torch.cat([xyz, xyz], -1)


def ortho(P, prec):
    raise AssertionError("HAS_ORTHO is False")


def l1(P):
    return torch.mean(torch.abs(P["density_volume"]))


def tv(P, kind):
    return torch.zeros(())


def density_flops(cfg):
    return 7


def app_read_flops(cfg):
    return 5
'''


def test_a_new_field_is_one_file(tmp_path):
    (tmp_path / "MadeUpField.py").write_text(MADE_UP)
    mod = fields.load("MadeUpField", "MLP_Fea", root=tmp_path)
    m = ref.Model(field=mod, density_ranks=(2,), app_ranks=(6,), relu=True, view_pe=0,
                  fea_pe=0, white_bg=True, ndc=False, near=0.0, far=1.0, shade_top_k=None,
                  free_reg=False, free_decomp=False, freq_ratio=0.8, n_iters=10)
    g = torch.Generator().manual_seed(3)
    P = {"density_volume": torch.randn((4, 4, 4, 2), generator=g),
         "basis": torch.randn((6, 27), generator=g),
         "render.l1.w": torch.randn((30, 8), generator=g), "render.l1.b": torch.zeros(8),
         "render.l2.w": torch.randn((8, 8), generator=g), "render.l2.b": torch.zeros(8),
         "render.l3.w": torch.randn((8, 3), generator=g), "render.l3.b": torch.zeros(3)}
    xyz = torch.rand((5, 3), generator=g) * 2 - 1
    assert torch.equal(ref.density(m, P, xyz, ref.Masks()), torch.relu(2.0 * xyz.sum(-1)))
    rgb = ref.radiance(m, P, ref.Precision(), xyz, torch.ones((5, 3)), ref.Masks())
    assert rgb.shape == (5, 3)
    lw = ref.Loss(ortho=0.0, l1=0.5, tv_density=0.0, tv_app=0.0, lr_factor=1.0)
    assert float(ref.regularizers(m, P, lw, 0, ref.Precision())) == pytest.approx(
        0.5 * float(torch.mean(torch.abs(P["density_volume"]))))
    cfg = SimpleNamespace(n_lamb_sh=(6,), data_dim_color=27, view_pe=0, fea_pe=0, featureC=8,
                          free_reg=False)
    shade = 5 + 2 * 6 * 27 + 2 * (30 * 8 + 8 * 8 + 8 * 3)
    assert counts.forward_flops(mod, cfg, 10, 2) == 10 * 7 + 2 * shade
    seg = made.Segment(0, np.array([[-1.0] * 3, [1.0] * 3], np.float32), (4, 4, 4), 8, None,
                       0.0, None)
    state = made.make(mod, cfg, {"density_amplitude": 1.0}, None, seg, 9, torch.device("cpu"))
    assert {k: tuple(v.shape) for k, v in state.params.items()} == {
        k: tuple(v.shape) for k, v in P.items()}


def test_a_field_without_a_module_fails_at_load_naming_the_file(tmp_path):
    with pytest.raises(FileNotFoundError, match=re.escape(str(tmp_path / "NoSuchField.py"))):
        fields.load("NoSuchField", "MLP_Fea", root=tmp_path)
    # in a run, before the scene or the port's state is built
    cell = tiny_cell("synth_full.train")
    cfg = dict(cell.config, train=dict(cell.config["train"], model_name="TensorCP"))
    with pytest.raises(FileNotFoundError, match=r"fields/TensorCP\.py"):
        R.setup(cell._replace(config=cfg), SEED, torch.device("cpu"))


@pytest.mark.parametrize("head", ["MLP", "MLP_PE", "SH", "RGB"])
def test_a_head_other_than_mlp_fea_fails_at_load_naming_the_head(head):
    with pytest.raises(ValueError, match=f"shadingMode '{head}'.*MLP_Fea"):
        fields.load("TensorVMSplit", head)
    cell = tiny_cell("flower.train")
    cfg = dict(cell.config, train=dict(cell.config["train"], shadingMode=head))
    with pytest.raises(ValueError, match=f"shadingMode '{head}'"):
        R.setup(cell._replace(config=cfg), SEED, torch.device("cpu"))


def test_a_module_missing_part_of_the_interface_fails_at_load(tmp_path):
    (tmp_path / "Partial.py").write_text("HAS_ORTHO = False\n")
    with pytest.raises(AttributeError, match=r"Partial\.py lacks make_factors"):
        fields.load("Partial", "MLP_Fea", root=tmp_path)


def digest(t):
    return hashlib.sha256(t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()[:24]


def readings(name):
    """What ``fields_golden.json`` holds, read through the field module."""
    dev = torch.device("cpu")
    s = R.setup(tiny_cell(name), SEED, dev)
    out = {"params": {k: digest(v) for k, v in sorted(s.p0.items())},
           "mask": None if s.made.mask is None else digest(s.made.mask)}
    model = R.ref_model(s.cfg, s.state, s.field)
    geom = R.ref_geometry(s.cfg, s.made, dev)
    lw = R.ref_loss(s.cfg, s.made, s.field)
    step = s.made.segment.iteration
    g = torch.Generator().manual_seed(5)
    xyz = torch.rand((257, 3), generator=g) * 2 - 1
    vd = torch.nn.functional.normalize(torch.rand((257, 3), generator=g) - 0.5, dim=-1)
    P = {k: v.clone().requires_grad_(True) for k, v in s.p0.items()}
    masks = ref.masks_at(model, step, P["basis"].shape[1], dev)
    for tag, prec in (("f32", ref.Precision()), ("tf32", ref.Precision(tf32=True))):
        sig = ref.density(model, P, xyz, masks)
        rgb = ref.radiance(model, P, prec, xyz, vd, masks)
        (sig.sum() + rgb.sum()).backward()
        out[f"density_{tag}"] = digest(sig)
        out[f"radiance_{tag}"] = digest(rgb)
        out[f"field_grads_{tag}"] = {k: digest(p.grad) for k, p in sorted(P.items())
                                     if p.grad is not None}
        for p in P.values():
            p.grad = None
        reg = ref.regularizers(model, P, lw, step, prec)
        reg.backward()
        out[f"regularizers_{tag}"] = float(reg.detach()).hex()
        out[f"regularizer_grads_{tag}"] = {k: digest(p.grad) for k, p in sorted(P.items())
                                           if p.grad is not None}
        for p in P.values():
            p.grad = None
    rays = s.state.rays[:96].clone()
    N = geom.n_samples
    with torch.no_grad():
        r = ref.render(model, P, geom, rays, masks,
                       u=None if model.ndc else torch.rand((96, 1), generator=g),
                       jitter=torch.rand((96, N), generator=g) if model.ndc else None)
    out["render"] = {k: digest(getattr(r, k)) for k in ("rgb", "depth", "alive", "shaded")}
    out["ortho"] = float(lw.ortho).hex()
    out["forward_flops"] = counts.forward_flops(s.field, s.cfg, 1000, 10)
    out["step_flops"] = counts.step_flops(s.field, s.cfg, 123457, 3211)
    return out


@pytest.mark.parametrize("name", ["synth_full.train", "flower.train"])
def test_the_field_module_reads_bit_for_bit_as_before(name, one_thread):
    golden = json.loads((HERE / "fields_golden.json").read_text())[name]
    assert readings(name) == golden
