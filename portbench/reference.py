"""The plain reference: TensoRF's field, volume rendering, loss and Adam
in plain PyTorch, written from the model's equations.  It imports nothing
of the port and takes no weights the port made: the benchmark hands it the
same made tensors it hands the port.

The model as the configurations state it:
* the field's density feature and appearance features come from its
  module, ``fields/<model_name>.py`` (``Model.field``), which alone knows
  the factor layout; the appearance features times a bias-free basis;
* sigma = softplus(feature - 10) or relu(feature); samples on a lattice
  from the box entry, step ``step_size``, jittered by one uniform per ray
  (NDC: linspace(near, far) with one jitter per sample, distances scaled
  by the direction's norm); a sample lives inside the box and where the
  nearest voxel of the 3x3x3-dilated alpha mask is set.
* weights = alpha * exclusive transmittance (1e-10 inside the product);
  shading where the weight passes 1e-4, over the top ``shade_top_k``
  weights of each ray where the configuration sets it; MLP_Fea: [feat,
  viewdir, PE(feat), PE(viewdir)] -> 128 -> 128 -> 3, sigmoid.
* white background (or, in training on a dataset without one, a flip per
  stratum), rgb clamped to [0, 1]; depth = sum w z + (1 - acc) * rays[:, -1].
* loss = the strata-weighted MSE plus the field's Ortho, L1 and TV terms; Adam
  (0.9, 0.99, eps 1e-8) in two groups, the LR decaying by ``lr_factor`` a
  step.

``matmul`` is the only matrix product; the control swaps it for one that
rounds its inputs to TF32's 10-bit mantissa, the precision a later change
might be tempted to take.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits), to nearest, ties away."""
    bits = x.detach().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    """a @ b as a TF32 tensor core computes it, forward and backward: each
    product's inputs rounded to TF32, the sums in float32."""

    @staticmethod
    def forward(ctx, a, b):
        ra, rb = tf32_round(a), tf32_round(b)
        ctx.save_for_backward(ra, rb)
        return ra @ rb

    @staticmethod
    def backward(ctx, g):
        ra, rb = ctx.saved_tensors
        rg = tf32_round(g)
        return rg @ rb.T, ra.T @ rg


class Precision(NamedTuple):
    tf32: bool = False

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.tf32:
            return _TF32MatMul.apply(a, b)
        return a @ b


class Model(NamedTuple):
    """What the reference needs of a configuration; ``field`` is its field
    module (``fields.load``)."""
    field: object
    density_ranks: tuple
    app_ranks: tuple
    relu: bool
    view_pe: int
    fea_pe: int
    white_bg: bool
    ndc: bool
    near: float
    far: float
    shade_top_k: Optional[int]
    free_reg: bool
    free_decomp: bool
    freq_ratio: float
    n_iters: int
    density_shift: float = -10.0
    distance_scale: float = 25.0
    weight_thres: float = 1e-4


class Geometry(NamedTuple):
    aabb: torch.Tensor  # (2, 3)
    step_size: float
    n_samples: int
    mask_aabb: Optional[torch.Tensor]
    mask_dilated: Optional[torch.Tensor]  # (Z, Y, X)


def dilate(volume: torch.Tensor) -> torch.Tensor:
    return F.max_pool3d(volume[None, None], 3, stride=1, padding=1)[0, 0]


# ---- FreeNeRF masks ---------------------------------------------------------


def freq_mask(length: int, step: int, total: int, ratio: float, device) -> torch.Tensor:
    """FreeNeRF's linear curriculum over ``length`` channels in groups of 4."""
    if step >= total:
        return torch.ones(length, device=device)
    f32 = torch.float32
    eff = length * float(ratio)
    ptr = torch.minimum(eff / 4 * torch.full((), float(step), dtype=f32, device=device) / total
                        + 1.0, torch.full((), eff / 4, dtype=f32, device=device))
    ip = torch.floor(ptr)
    frac = ptr - ip
    idx = torch.arange(length, dtype=f32, device=device)
    m = torch.where(idx < ip * 4, torch.ones((), device=device),
                    torch.where(idx < ip * 4 + 4, frac, torch.zeros((), device=device)))
    return torch.clamp(m, 1e-8, 1.0 - 1e-8)


class Masks(NamedTuple):
    view: Optional[torch.Tensor] = None
    fea: Optional[torch.Tensor] = None
    den: Optional[List[torch.Tensor]] = None
    app: Optional[List[torch.Tensor]] = None


def masks_at(m: Model, step: int, app_dim: int, device) -> Masks:
    if not m.free_reg:
        return Masks()

    def mk(n):
        return freq_mask(n, step, m.n_iters, m.freq_ratio, device) if n > 0 else None
    den = [mk(r) for r in m.density_ranks] if m.free_decomp else None
    app = [mk(r) for r in m.app_ranks] if m.free_decomp else None
    return Masks(mk(2 * m.view_pe * 3), mk(2 * m.fea_pe * app_dim), den, app)


# ---- the field --------------------------------------------------------------


def _taps(coord: torch.Tensor, size: int):
    x = (coord + 1.0) * 0.5 * (size - 1)
    i0 = torch.floor(x)
    w1 = x - i0
    i0 = i0.long()
    i1 = i0 + 1
    ok0 = ((i0 >= 0) & (i0 < size)).to(coord.dtype)
    ok1 = ((i1 >= 0) & (i1 < size)).to(coord.dtype)
    return i0.clamp(0, size - 1), i1.clamp(0, size - 1), w1, ok0, ok1


def bilinear(plane: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """plane (H, W, C) at u (indexes W), v (indexes H) in [-1, 1] -> (M, C)."""
    H, W, _ = plane.shape
    x0, x1, wx, bx0, bx1 = _taps(u, W)
    y0, y1, wy, by0, by1 = _taps(v, H)
    return (((1 - wy) * (1 - wx) * by0 * bx0)[:, None] * plane[y0, x0]
            + ((1 - wy) * wx * by0 * bx1)[:, None] * plane[y0, x1]
            + (wy * (1 - wx) * by1 * bx0)[:, None] * plane[y1, x0]
            + (wy * wx * by1 * bx1)[:, None] * plane[y1, x1])


def linear(line: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    L, _ = line.shape
    i0, i1, w1, b0, b1 = _taps(w, L)
    return ((1 - w1) * b0)[:, None] * line[i0] + (w1 * b1)[:, None] * line[i1]


def tv2d(p: torch.Tensor) -> torch.Tensor:
    """Squared-difference TV of a plane (H, W, C), the counts over C too."""
    H, W, C = p.shape
    return 2.0 * (torch.sum(torch.square(p[1:] - p[:-1])) / ((H - 1) * W * C)
                  + torch.sum(torch.square(p[:, 1:] - p[:, :-1])) / (H * (W - 1) * C))


def density(m: Model, P, xyz: torch.Tensor, masks: Masks) -> torch.Tensor:
    feat = m.field.density_feature(P, xyz, masks.den)
    if m.relu:
        return torch.relu(feat)
    return F.softplus(feat + m.density_shift)


def pe(x: torch.Tensor, freqs: int) -> torch.Tensor:
    bands = 2.0 ** torch.arange(freqs, dtype=x.dtype, device=x.device)
    y = (x[..., None] * bands).reshape(*x.shape[:-1], x.shape[-1] * freqs)
    return torch.cat([torch.sin(y), torch.cos(y)], dim=-1)


def radiance(m: Model, P, prec: Precision, xyz, viewdirs, masks: Masks) -> torch.Tensor:
    feat = prec.matmul(m.field.app_features(P, xyz, masks.app), P["basis"])
    x = [feat, viewdirs]
    if m.fea_pe > 0:
        e = pe(feat, m.fea_pe)
        x.append(e if masks.fea is None else e * masks.fea)
    if m.view_pe > 0:
        e = pe(viewdirs, m.view_pe)
        x.append(e if masks.view is None else e * masks.view)
    h = torch.cat(x, dim=-1)
    h = torch.relu(prec.matmul(h, P["render.l1.w"]) + P["render.l1.b"])
    h = torch.relu(prec.matmul(h, P["render.l2.w"]) + P["render.l2.b"])
    return torch.sigmoid(prec.matmul(h, P["render.l3.w"]) + P["render.l3.b"])


# ---- rendering --------------------------------------------------------------


def box_entry(o: torch.Tensor, d: torch.Tensor, aabb: torch.Tensor) -> torch.Tensor:
    vec = torch.where(d == 0, torch.full_like(d, 1e-6), d)
    ra = (aabb[1] - o) / vec
    rb = (aabb[0] - o) / vec
    return torch.amax(torch.minimum(ra, rb), dim=-1)


def ndc_depths(near: float, far: float, n: int, device) -> torch.Tensor:
    """linspace(near, far, n) with the last point exactly ``far``."""
    if n == 1:
        return torch.full((1,), float(near), device=device)
    s = torch.arange(n - 1, dtype=torch.float32, device=device) * float(
        torch.tensor(1.0) / torch.tensor(float(n - 1)))
    near32 = float(torch.tensor(near, dtype=torch.float32))
    far32 = float(torch.tensor(far, dtype=torch.float32))
    return torch.cat([near32 * (1 - s) + far32 * s, torch.full((1,), far32, device=device)])


def mask_gate(g: Geometry, xyz: torch.Tensor) -> torch.Tensor:
    """The nearest voxel of the dilated mask, 0 outside the mask's box."""
    if g.mask_dilated is None:
        return torch.ones(xyz.shape[:-1], dtype=torch.bool, device=xyz.device)
    vol = g.mask_dilated
    D, H, W = vol.shape
    a = g.mask_aabb
    norm = torch.clamp((xyz - a[0]) * (2.0 / (a[1] - a[0])) - 1.0, -1.0, 1.0)
    half = (norm + 1.0) * 0.5
    ix = torch.round(half[..., 0] * float(W - 1)).long()
    iy = torch.round(half[..., 1] * float(H - 1)).long()
    iz = torch.round(half[..., 2] * float(D - 1)).long()
    out = torch.any((xyz < a[0]) | (xyz > a[1]), dim=-1)
    return (vol[iz, iy, ix] > 0) & ~out


class Render(NamedTuple):
    rgb: torch.Tensor
    depth: torch.Tensor
    alive: torch.Tensor  # (B,) samples the mask admits
    shaded: torch.Tensor  # (B,) samples shaded


def samples(m: Model, g: Geometry, rays: torch.Tensor, u=None, jitter=None):
    """(xyz (B, N, 3), z (B, N), dists (B, N), viewdirs (B, 3), alive (B, N))."""
    o, d = rays[:, :3], rays[:, 3:6]
    N = g.n_samples
    if m.ndc:
        z = ndc_depths(m.near, m.far, N, rays.device)[None, :]
        if jitter is not None:
            z = z + jitter * ((m.far - m.near) / N)
        z = z.expand(rays.shape[0], N)
    else:
        t0 = torch.clamp(box_entry(o, d, g.aabb), m.near, m.far)
        idx = torch.arange(N, dtype=rays.dtype, device=rays.device)[None, :]
        z = t0[:, None] + (idx if u is None else idx + u) * g.step_size
    xyz = o[:, None, :] + d[:, None, :] * z[..., None]
    inside = ~torch.any((xyz < g.aabb[0]) | (xyz > g.aabb[1]), dim=-1)
    dists = torch.cat([z[:, 1:] - z[:, :-1], torch.zeros_like(z[:, :1])], dim=-1)
    viewdirs = d
    if m.ndc:
        norm = torch.linalg.norm(d, dim=-1, keepdim=True)
        dists = dists * norm
        viewdirs = d / norm
    return xyz, z, dists, viewdirs, inside & mask_gate(g, xyz)


def render(m: Model, P, g: Geometry, rays: torch.Tensor, masks: Masks,
           prec: Precision = Precision(), u=None, jitter=None, flip=None,
           train: bool = False) -> Render:
    xyz, z, dists, viewdirs, alive = samples(m, g, rays, u, jitter)
    B, N = alive.shape
    xyz_n = (xyz - g.aabb[0]) * (2.0 / (g.aabb[1] - g.aabb[0])) - 1.0
    sig = density(m, P, xyz_n[alive], masks)
    sigma = torch.zeros((B, N), dtype=sig.dtype, device=rays.device).masked_scatter(alive, sig)
    alpha = 1.0 - torch.exp(-sigma * (dists * m.distance_scale))
    trans = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)
    trans = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], dim=-1)
    w = alpha * trans
    if m.shade_top_k is not None and m.shade_top_k < N:
        w_sel, idx = torch.topk(w, m.shade_top_k, dim=-1)
        pts = torch.take_along_dim(xyz_n, idx[..., None], dim=1)
    else:
        w_sel, pts = w, xyz_n
    gate = w_sel > m.weight_thres
    K = w_sel.shape[1]
    view = viewdirs[:, None, :].expand(B, K, 3)
    c = torch.zeros((B, K, 3), dtype=w.dtype, device=rays.device)
    if bool(gate.any()):
        c = c.masked_scatter(gate[..., None].expand(B, K, 3),
                             radiance(m, P, prec, pts[gate], view[gate], masks))
    rgb = torch.sum(w_sel[..., None] * c, dim=1)
    acc = torch.sum(w, dim=-1)
    if m.white_bg:
        rgb = rgb + (1.0 - acc[:, None])
    elif train and flip is not None:
        rgb = rgb + flip * (1.0 - acc[:, None])
    rgb = torch.clamp(rgb, 0.0, 1.0)
    with torch.no_grad():
        depth = torch.sum(w * z, dim=-1) + (1.0 - acc) * rays[:, -1]
    return Render(rgb, depth, alive.sum(-1), gate.sum(-1))


# ---- loss and Adam ----------------------------------------------------------


class Loss(NamedTuple):
    ortho: float
    l1: float
    tv_density: float
    tv_app: float
    lr_factor: float


def regularizers(m: Model, P, lw: Loss, step: int, prec: Precision) -> torch.Tensor:
    """The field's terms (``lw.ortho`` is 0 where the field has none)."""
    total = torch.zeros((), device=P["basis"].device)
    if lw.ortho > 0:
        total = total + lw.ortho * m.field.ortho(P, prec)
    if lw.l1 > 0:
        total = total + lw.l1 * m.field.l1(P)
    decay = float(torch.pow(torch.tensor(lw.lr_factor, dtype=torch.float32),
                            torch.tensor(step + 1.0, dtype=torch.float32)))
    for kind, wt in (("density", lw.tv_density), ("app", lw.tv_app)):
        if wt > 0:
            total = total + m.field.tv(P, kind) * wt * decay
    return total


def step_loss(m: Model, P, g: Geometry, lw: Loss, step: int, strata: Sequence[dict],
              prec: Precision, block: int) -> float:
    """Backward of one step's loss into P's .grad; returns the loss.
    ``strata``: per stratum {rays, rgbs, u | jitter, flip (a row each),
    weight}; the rays render in blocks of ``block``, each block's backward
    at once."""
    masks = masks_at(m, step, P["basis"].shape[1], P["basis"].device)
    total = 0.0
    for s in strata:
        n = s["rays"].shape[0]
        for a in range(0, n, block):
            sl = slice(a, min(a + block, n))
            out = render(m, P, g, s["rays"][sl], masks, prec,
                         u=None if s.get("u") is None else s["u"][sl],
                         jitter=None if s.get("jitter") is None else s["jitter"][sl],
                         flip=s["flip"][sl], train=True)
            part = s["weight"] * torch.sum(torch.square(out.rgb - s["rgbs"][sl])) / (n * 3)
            part.backward()
            total += float(part.detach())
    reg = regularizers(m, P, lw, step, prec)
    if reg.requires_grad:
        reg.backward()
    return total + float(reg.detach())


class Adam:
    """Adam with bias correction, betas (0.9, 0.99), eps 1e-8 outside the
    root, one LR per parameter decaying by ``factor`` each step."""

    def __init__(self, params: Dict[str, torch.Tensor], lrs: Dict[str, float], factor: float):
        self.p, self.lr0, self.factor = params, lrs, factor
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self):
        self.t += 1
        b1, b2 = 0.9, 0.99
        for k, p in self.p.items():
            gk = p.grad if p.grad is not None else torch.zeros_like(p)
            self.m[k].mul_(b1).add_(gk, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(gk, gk, value=1 - b2)
            lr = self.lr0[k] * self.factor ** (self.t - 1)
            mh = self.m[k] / (1 - b1 ** self.t)
            vh = self.v[k] / (1 - b2 ** self.t)
            p.sub_(lr * mh / (vh.sqrt() + 1e-8))
            p.grad = None


def group_lrs(names, lr_init: float, lr_basis: float) -> Dict[str, float]:
    return {k: (lr_init if ("plane" in k.split(".")[0] or "line" in k.split(".")[0]) else lr_basis)
            for k in names}
