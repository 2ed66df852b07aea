"""The port's remaining ray ops (tensorf_tpu_torch/ops/rays.py:
depth2dist, ndc2dist, sample_pdf, dda, ray_marcher) against
tensorf_tpu/ops/rays.py, with the same uniforms for the random draws:
within rtol/atol 1e-5 (float32), and the reference's behaviour that
tests/test_extras.py pins for JAX."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorf_tpu.ops import rays as jr
from tensorf_tpu_torch.ops import rays as tr

TOL = dict(rtol=1e-5, atol=1e-5)


def t(a):
    return torch.from_numpy(np.array(a))


def test_depth2dist_and_ndc2dist_match_jax(rng):
    z = np.sort(rng.uniform(2, 6, size=(9, 17)), axis=-1).astype(np.float32)
    cos = rng.uniform(0.5, 1, size=(9,)).astype(np.float32)
    np.testing.assert_allclose(tr.depth2dist(t(z), t(cos)).numpy(),
                               np.asarray(jr.depth2dist(jnp.asarray(z), jnp.asarray(cos))), **TOL)
    pts = rng.normal(size=(9, 17, 3)).astype(np.float32)
    np.testing.assert_allclose(tr.ndc2dist(t(pts), t(cos)).numpy(),
                               np.asarray(jr.ndc2dist(jnp.asarray(pts), jnp.asarray(cos))), **TOL)
    # the reference's values (tests/test_extras.py)
    d = tr.depth2dist(t([[1.0, 2.0, 4.0]]), t([2.0]))
    np.testing.assert_allclose(d.numpy()[0, :2], [2.0, 4.0])


@pytest.mark.parametrize("det", [True, False], ids=["det", "random"])
def test_sample_pdf_matches_jax(rng, det):
    bins = np.sort(rng.uniform(2, 6, size=(11, 33)), axis=-1).astype(np.float32)
    w = rng.uniform(size=(11, 32)).astype(np.float32)
    w[:3] = 0.0  # all-zero weights: the 1e-5 floor alone
    key = None if det else jax.random.PRNGKey(5)
    want = jr.sample_pdf(jnp.asarray(bins), jnp.asarray(w), 24, det=det, key=key)
    u = None if det else t(jax.random.uniform(key, (11, 24)))
    got = tr.sample_pdf(t(bins), t(w), 24, det=det, u=u)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # det overrides a generator; a generator draws in [bins_0, bins_-1]
    gen = torch.Generator().manual_seed(0)
    np.testing.assert_array_equal(tr.sample_pdf(t(bins), t(w), 24, det=True, generator=gen)
                                  .numpy(), tr.sample_pdf(t(bins), t(w), 24, det=True).numpy())
    drawn = tr.sample_pdf(t(bins), t(w), 24, generator=gen)
    assert bool(torch.all(drawn >= t(bins[:, :1]))) and bool(torch.all(drawn <= t(bins[:, -1:])))


def test_sample_pdf_concentrates_where_the_weight_is():
    bins = torch.linspace(0, 1, 9)[None].repeat(4, 1)
    w = torch.zeros((4, 8))
    w[:, -1] = 1.0
    s = tr.sample_pdf(bins, w, 16, det=True)
    assert float(s[:, 1:].min()) > 0.7


def test_dda_matches_jax(rng):
    o = rng.normal(scale=3.0, size=(64, 3)).astype(np.float32)
    d = rng.normal(size=(64, 3)).astype(np.float32)
    box = np.asarray([[-1.5, -1.2, -1.0], [1.5, 1.2, 1.0]], np.float32)
    for got, want in zip(tr.dda(t(o), t(d), t(box)),
                         jr.dda(jnp.asarray(o), jnp.asarray(d), jnp.asarray(box))):
        assert got.shape == (64, 1)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)
    t_min, t_max = tr.dda(t([[0.0, 0.0, -3.0]]), t([[0.0, 0.0, 1.0]]),
                          t([[-1.0] * 3, [1.0] * 3]))
    assert np.isclose(float(t_min), 2.0, atol=1e-3) and np.isclose(float(t_max), 4.0, atol=1e-3)


@pytest.mark.parametrize("lindisp,perturb,bbox", [
    (False, 0.0, False), (True, 0.0, False), (False, 1.0, False), (False, 0.5, True)],
    ids=["linear", "lindisp", "perturbed", "bbox_half_perturbed"])
def test_ray_marcher_matches_jax(rng, lindisp, perturb, bbox):
    o = rng.normal(scale=3.0, size=(16, 3)).astype(np.float32)
    d = rng.normal(size=(16, 3)).astype(np.float32)
    nf = np.stack([rng.uniform(1, 2, 16), rng.uniform(4, 6, 16)], -1).astype(np.float32)
    rays = np.concatenate([o, d, nf], -1)
    box = np.asarray([[-1.5] * 3, [1.5] * 3], np.float32) if bbox else None
    key = jax.random.PRNGKey(3) if perturb else None
    want = jr.ray_marcher(jnp.asarray(rays), n_samples=20, lindisp=lindisp, perturb=perturb,
                          bbox_3d=None if box is None else jnp.asarray(box), key=key)
    u = t(jax.random.uniform(key, (16, 20))) if perturb else None
    got = tr.ray_marcher(t(rays), n_samples=20, lindisp=lindisp, perturb=perturb,
                         bbox_3d=None if box is None else t(box), u=u)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-4)
    if not perturb and not bbox and not lindisp:
        np.testing.assert_allclose(got[3][:, 0].numpy(), nf[:, 0], rtol=1e-6)
        np.testing.assert_allclose(got[3][:, -1].numpy(), nf[:, 1], rtol=1e-6)
