"""Parity of the port's ops (tensorf_tpu_torch/ops) with tensorf_tpu's.

Inputs come from a seeded numpy generator and go through both packages;
forward values agree within rtol/atol 1e-5 and gradients within 1e-4
(float32, different summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorf_tpu.ops import encoding as jenc
from tensorf_tpu.ops import freq_mask as jfm
from tensorf_tpu.ops import grid_sample as jgs
from tensorf_tpu.ops import rays as jrays
from tensorf_tpu.ops import render_math as jrm
from tensorf_tpu_torch.ops import encoding as tenc
from tensorf_tpu_torch.ops import freq_mask as tfm
from tensorf_tpu_torch.ops import grid_sample as tgs
from tensorf_tpu_torch.ops import rays as trays
from tensorf_tpu_torch.ops import render_math as trm

FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, tol):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), **tol)


def _rays(rng, n):
    o = rng.normal(size=(n, 3))
    o = 4.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = -o / np.linalg.norm(o, axis=-1, keepdims=True) + 0.2 * rng.normal(size=(n, 3))
    return o.astype(np.float32), d.astype(np.float32)


# ---- (a) modules 1-4, elementwise ------------------------------------------


def test_raw2alpha_and_transmittance(rng):
    sigma = rng.uniform(0, 5, size=(7, 33)).astype(np.float32)
    sigma[:, 10] = 1e4  # an opaque sample: the 1e-10 placement matters after it
    dist = rng.uniform(0, 0.1, size=(7, 33)).astype(np.float32)
    for got, want in zip(trm.raw2alpha(t(sigma), t(dist)), jrm.raw2alpha(sigma, dist)):
        close(got, want, FWD)
    T, fin = trm.exclusive_transmittance(t(dist))
    jT, jfin = jrm.exclusive_transmittance(dist)
    close(T, jT, FWD)
    close(fin, jfin, FWD)


def test_ray_directions_and_rays_match():
    for fn in ("get_ray_directions", "get_ray_directions_blender"):
        got = getattr(trays, fn)(6, 8, [7.5, 7.5])
        want = getattr(jrays, fn)(6, 8, [7.5, 7.5])
        np.testing.assert_array_equal(got, want)
    c2w = np.eye(4)[:3]
    c2w[:, 3] = [0.1, -0.3, 4.0]
    d = jrays.get_ray_directions(6, 8, [7.5, 7.5])
    for got, want in zip(trays.get_rays(d, c2w), jrays.get_rays(d, c2w)):
        np.testing.assert_array_equal(got, want)


def test_aabb_entry_exit_and_sampling(rng):
    o, d = _rays(rng, 41)
    d[0, 1] = 0.0  # a zero direction component takes the 1e-6 branch
    aabb = np.asarray([[-1.5, -1.5, -1.5], [1.5, 1.5, 1.5]], np.float32)
    for got, want in zip(
        trays.aabb_entry_exit(t(o), t(d), t(aabb)), jrays.aabb_entry_exit(o, d, aabb)
    ):
        close(got, want, FWD)
    # key None is the eval lattice; with a key, JAX draws u (B, 1) from it,
    # which the port takes injected
    key = jax.random.PRNGKey(3)
    u = np.asarray(jax.random.uniform(key, (41, 1), dtype=jnp.float32))
    for jkey, u_t in ((None, None), (key, t(u))):
        want = jrays.sample_along_rays(o, d, aabb, 2.0, 6.0, 0.05, 97, jkey)
        got = trays.sample_along_rays(t(o), t(d), t(aabb), 2.0, 6.0, 0.05, 97, u_t)
        close(got[0], want[0], FWD)
        close(got[1], want[1], FWD)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_positional_encoding(rng):
    x = rng.uniform(-2, 2, size=(5, 7, 3)).astype(np.float32)
    for freqs in (1, 2, 6):
        close(tenc.positional_encoding(t(x), freqs), jenc.positional_encoding(x, freqs), FWD)


@pytest.mark.parametrize("step", [0, 1, 137, 999, 1000, 5000])
def test_freq_reg_mask(step):
    for length, ratio, max_vis in ((27, 1.0, None), (108, 0.8, None), (48, 0.64, None),
                                   (12, 1.0, 0.5)):
        got = tfm.freq_reg_mask(length, step, 1000, ratio, max_vis)
        want = jfm.freq_reg_mask(length, jnp.asarray(step), 1000, ratio, max_vis)
        close(got, want, FWD)


def test_free_masks_bundle():
    got = tfm.free_masks(12, 12, 108, (2, 3, 4), (4, 5, 6), 40, 100, 0.8, True)
    want = jfm.free_masks(12, 12, 108, (2, 3, 4), (4, 5, 6), jnp.asarray(40), 100, 0.8, True)
    for name in ("pos", "view", "fea"):
        close(getattr(got, name), getattr(want, name), FWD)
    for name in ("den", "app"):
        for a, b in zip(getattr(got, name), getattr(want, name)):
            close(a, b, FWD)
    off = tfm.free_masks(0, 12, 108, (2,), (4,), 40, 100, use_decomp_mask=False)
    assert off.pos is None and off.den is None and off.app is None


# ---- (c) grid sampling: forward and gradients against jax.vjp ----------------


def test_footprint_sample_2d_forward_and_vjp(rng):
    H, W, C, M = 9, 13, 5, 257
    plane = rng.normal(size=(H, W, C)).astype(np.float32)
    coords = rng.uniform(-1.0, 1.0, size=(M, 2)).astype(np.float32)
    coords[:6] = [[-1, -1], [1, 1], [-1, 1], [1, -1], [0, 1], [1, 0]]  # edges
    cot = rng.normal(size=(M, C)).astype(np.float32)

    def jf(p, c):
        return jgs.footprint_sample_2d(jgs.make_footprint_2d(p), H, W, c)

    want, vjp = jax.vjp(jf, plane, coords)
    g_plane, _ = vjp(cot)

    p_t = t(plane).requires_grad_()
    got = tgs.footprint_sample_2d(tgs.make_footprint_2d(p_t), H, W, t(coords))
    close(got, want, FWD)
    close(got, jgs.grid_sample_2d(plane, coords), FWD)  # fused == unfused in range
    got.backward(t(cot))
    close(p_t.grad, g_plane, GRAD)


def test_footprint_sample_2d_coord_grad_and_edge_clamp(rng):
    H, W, C, M = 7, 6, 3, 64
    plane = rng.normal(size=(H, W, C)).astype(np.float32)
    # interior coords for the coord gradient; out-of-range ones clamp to the edge
    coords = rng.uniform(-0.95, 0.95, size=(M, 2)).astype(np.float32)
    outside = np.asarray([[-1.4, 0.2], [1.3, -1.2], [0.3, 1.7]], np.float32)
    cot = rng.normal(size=(M, C)).astype(np.float32)
    fp = jgs.make_footprint_2d(plane)
    _, vjp = jax.vjp(lambda c: jgs.footprint_sample_2d(fp, H, W, c), coords)
    (g_coords,) = vjp(cot)
    c_t = t(coords).requires_grad_()
    out = tgs.footprint_sample_2d(tgs.make_footprint_2d(t(plane)), H, W, c_t)
    out.backward(t(cot))
    close(c_t.grad, g_coords, GRAD)
    close(
        tgs.footprint_sample_2d(tgs.make_footprint_2d(t(plane)), H, W, t(outside)),
        jgs.footprint_sample_2d(fp, H, W, outside),
        FWD,
    )


def test_line_sample_matmul_forward_and_vjp(rng):
    L, C, M = 23, 6, 311
    line = rng.normal(size=(L, C)).astype(np.float32)
    coord = rng.uniform(-1.2, 1.2, size=(M,)).astype(np.float32)
    cot = rng.normal(size=(M, C)).astype(np.float32)
    want, vjp = jax.vjp(lambda l: jgs.line_sample_matmul(l, coord), line)
    (g_line,) = vjp(cot)
    l_t = t(line).requires_grad_()
    c_t = t(coord).requires_grad_()
    got = tgs.line_sample_matmul(l_t, c_t)
    close(got, want, FWD)
    got.backward(t(cot))
    close(l_t.grad, g_line, GRAD)
    assert c_t.grad is None  # coords are detached, as in the reference


def test_grid_sample_2d_1d_zeros_padding_and_vjp(rng):
    H, W, C, M = 8, 11, 4, 199
    plane = rng.normal(size=(H, W, C)).astype(np.float32)
    line = rng.normal(size=(17, C)).astype(np.float32)
    coords = rng.uniform(-1.3, 1.3, size=(M, 2)).astype(np.float32)
    cot = rng.normal(size=(M, C)).astype(np.float32)
    want2, vjp2 = jax.vjp(lambda p: jgs.grid_sample_2d(p, coords), plane)
    want1, vjp1 = jax.vjp(lambda l: jgs.grid_sample_1d(l, coords[:, 0]), line)
    p_t = t(plane).requires_grad_()
    l_t = t(line).requires_grad_()
    got2 = tgs.grid_sample_2d(p_t, t(coords))
    got1 = tgs.grid_sample_1d(l_t, t(coords[:, 0]))
    close(got2, want2, FWD)
    close(got1, want1, FWD)
    (got2 * t(cot)).sum().backward()
    (got1 * t(cot)).sum().backward()
    close(p_t.grad, vjp2(cot)[0], GRAD)
    close(l_t.grad, vjp1(cot)[0], GRAD)


def test_tap_lerp_matches(rng):
    w = rng.uniform(size=(31, 4)).astype(np.float32)
    taps = rng.normal(size=(31, 4, 6)).astype(np.float32)
    close(tgs._tap_lerp(t(w), t(taps)), jgs._tap_lerp(w, taps), FWD)
