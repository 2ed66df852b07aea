"""Parity of the port's shading heads (tensorf_tpu_torch/models/shading.py,
ops/sh.py) with tensorf_tpu's.

The SH bases of degrees 0-4 agree with the JAX package's; every shading
mode (MLP_Fea, MLP_PE, MLP, SH, RGB), with the FreeNeRF PE masks on and
off, gives the JAX forward within rtol/atol 1e-5 and the JAX gradients
(of the MLP weights and of every input) within 1e-4.  The port's shading
parameters have the JAX init's names and shapes: none for SH and RGB.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorf_tpu.models import ModelConfig
from tensorf_tpu.models.shading import apply_shading as j_apply
from tensorf_tpu.models.shading import init_shading as j_init
from tensorf_tpu.models.shading import mlp_in_dim as j_in_dim
from tensorf_tpu.ops.freq_mask import FreeMasks as JMasks
from tensorf_tpu.ops.sh import eval_sh as j_eval_sh
from tensorf_tpu.ops.sh import eval_sh_bases as j_sh
from tensorf_tpu.utils.ckpt import _flatten
from tensorf_tpu_torch.convert import params_from_jax
from tensorf_tpu_torch.models import ModelConfig as TConfig
from tensorf_tpu_torch.models.shading import MODES, apply_shading, init_shading, mlp_in_dim
from tensorf_tpu_torch.ops.freq_mask import FreeMasks as TMasks
from tensorf_tpu_torch.ops.sh import eval_sh, eval_sh_bases

FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)
# app_dim per mode: SH needs 3 x 9 features, RGB returns 3 as they are
APP_DIM = {"MLP_Fea": 6, "MLP_PE": 6, "MLP": 6, "SH": 27, "RGB": 3}


def t(a):
    return torch.from_numpy(np.array(a))


def _dirs(rng, n):
    d = rng.normal(size=(n, 3))
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_sh_bases_match_jax(rng, deg):
    dirs = _dirs(rng, 257)
    got = eval_sh_bases(deg, t(dirs))
    assert got.shape == (257, (deg + 1) ** 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(j_sh(deg, jnp.asarray(dirs))), **FWD)
    sh = rng.normal(size=(257, 3, (deg + 1) ** 2)).astype(np.float32)
    want = j_eval_sh(deg, jnp.asarray(sh), jnp.asarray(dirs))
    np.testing.assert_allclose(eval_sh(deg, t(sh), t(dirs)).numpy(), np.asarray(want), **FWD)


def _cfg(mode):
    return ModelConfig(shading_mode=mode, app_dim=APP_DIM[mode], pos_pe=2, view_pe=3, fea_pe=2,
                       feature_c=16)


def _both(mode, seed=0):
    cfg = _cfg(mode)
    params = j_init(jax.random.PRNGKey(seed), cfg)
    flat = {}
    _flatten("render", params, flat)
    mlp = init_shading(TConfig(**dataclasses.asdict(cfg)), torch.Generator().manual_seed(seed))
    mlp.load_state_dict({k[len("render."):]: v for k, v in params_from_jax(flat).items()})
    return cfg, params, mlp


@pytest.mark.parametrize("mode", MODES)
def test_init_has_the_jax_parameters(mode):
    cfg, params, _ = _both(mode)
    fresh = init_shading(TConfig(**dataclasses.asdict(cfg)), torch.Generator().manual_seed(0))
    flat = {}
    _flatten("", params, flat)
    got = {k.replace(".", "/"): tuple(v.shape) for k, v in fresh.state_dict().items()}
    assert got == {k: tuple(v.shape) for k, v in flat.items()}
    if mode in ("SH", "RGB"):
        assert got == {}
    else:
        assert mlp_in_dim(TConfig(**dataclasses.asdict(cfg))) == j_in_dim(cfg)
        assert not torch.any(fresh.l3.b)  # the last bias starts at zero


def _pe_masks(rng, cfg):
    lens = (2 * cfg.pos_pe * 3, 2 * cfg.view_pe * 3, 2 * cfg.fea_pe * cfg.app_dim)
    arrs = [rng.uniform(size=(n,)).astype(np.float32) for n in lens]
    return (JMasks(*(jnp.asarray(a) for a in arrs)), TMasks(*(t(a) for a in arrs)))


@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "pe_masks"])
@pytest.mark.parametrize("mode", MODES)
def test_apply_shading_matches_jax(rng, mode, masked):
    cfg, params, mlp = _both(mode, seed=1)
    n = 96
    pts = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    view = _dirs(rng, n)
    feat = rng.normal(scale=0.5, size=(n, cfg.app_dim)).astype(np.float32)
    jm, tm = _pe_masks(rng, cfg) if masked else (JMasks(), TMasks())
    cot = rng.normal(size=(n, 3)).astype(np.float32)

    def j_loss(p, a, b, c):
        return jnp.sum(j_apply(cfg, p, a, b, c, jm) * cot)

    want = j_apply(cfg, params, jnp.asarray(pts), jnp.asarray(view), jnp.asarray(feat), jm)
    j_grads = jax.grad(j_loss, argnums=(0, 1, 2, 3))(
        params, jnp.asarray(pts), jnp.asarray(view), jnp.asarray(feat))
    ins = [t(a).requires_grad_(True) for a in (pts, view, feat)]
    got = apply_shading(TConfig(**dataclasses.asdict(cfg)), mlp, *ins, tm)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FWD)
    torch.sum(got * t(cot)).backward()
    for name, x, g in zip(("pts", "viewdirs", "features"), ins, j_grads[1:]):
        if mode == "RGB" and name != "features" or mode in ("SH", "MLP_Fea") and name == "pts":
            assert x.grad is None or not torch.any(x.grad), name  # the mode does not read it
        else:
            np.testing.assert_allclose(x.grad.numpy(), np.asarray(g), err_msg=name, **GRAD)
    flat = {}
    _flatten("", j_grads[0], flat)
    for k, v in flat.items():
        np.testing.assert_allclose(mlp.get_parameter(k.replace("/", ".")).grad.numpy(),
                                   np.asarray(v), err_msg=k, **GRAD)


def test_refusals():
    with pytest.raises(ValueError, match="unrecognized"):
        init_shading(TConfig(shading_mode="MLP_X"), torch.Generator())
    with pytest.raises(ValueError, match="unknown dtype"):
        init_shading(TConfig(shading_mode="SH", app_dim=27, dtype="float16"), torch.Generator())
