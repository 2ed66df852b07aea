"""The train step: render + losses + backward + Adam (counterpart of
tensorf_tpu/train/step.py).

PyTorch runs it eagerly; there is no jit counterpart.  Where the JAX step
splits a key, this step draws the same noise from a torch.Generator on the
device: the per-ray lattice jitter ``u`` (B, 1) — for NDC rays the
per-sample jitter (B, n_samples) — and the background flip, and with strata
one of each per stratum and the noise-matched stratum shares.  ``loss_fn`` takes them explicitly so tests can feed JAX's own
draws.  The alpha mask rides along as an argument, as in the JAX step;
the per-segment statics (lattice, budgets, strata, top-K, L1 weight) come
from the training loop.

With ``strata_budgets`` set, the batch is one sub-batch per stratum of the
count-partitioned ray store, each rendered at its own candidate budget and
lattice; the per-stratum losses combine by the strata's shares of the
store (or, noise-matched, by a multinomial draw around them), so the
estimator stays the store-uniform one while each ray pays about its own
candidate count.

On several ranks (``group``, parallel/mesh.py) each rank renders its share
of the global batch: it draws the global batch's noise and takes its block,
normalises the data terms by the global counts (the MSE by the global
batch, the occlusion term by the occlusion mask's sum over every rank) and
takes 1/W of each parameter regularizer, so the ranks' losses sum to the
one-rank loss.  ``make_train_step`` then sums the gradients over the ranks
in one all-reduce between ``backward`` and the Adam step, and the step's
metrics ride in the same buffer, so every rank reads the global mse, psnr,
overflow and sample counts.

The step marks its phases for a profiler (utils/tracing.py):
``tftorch.train.step`` around ``tftorch.train.batch``, ``.optim`` (zero_grad
and the Adam step), ``.forward`` (one ``tftorch.train.render`` a render) and
``.backward`` (with the ranks' gradient sum).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..models.alpha_mask import AlphaGridMask
from ..models.config import ModelConfig
from ..ops.freq_mask import FreeMasks, free_masks
from ..parallel.mesh import RankGroup, allreduce_grads, shard_rows
from ..render.volume import render_rays
from ..utils import tracing
from .losses import LossWeights, mse_loss, occlusion_loss, occlusion_mask


class TrainStatics(NamedTuple):
    """Per-segment static configuration for the train step."""

    n_samples: int
    step_size: float
    white_bg: bool
    ndc_ray: bool
    total_steps: int
    lr_factor: float
    weights: LossWeights = LossWeights()
    free_reg: bool = False
    free_decomp: bool = False
    freq_reg_ratio: float = 1.0
    max_visible: Optional[float] = None
    shade_top_k: Optional[int] = None
    fused: bool = True
    # unstratified sample budget ("alive" mode); None = every sample
    sample_budget: Optional[int] = None
    # False when the coarse pre-gate is not a superset of the exact gate
    # (coarse_gate_valid): budgets then select with the exact gate
    use_coarse_gate: bool = True
    # per-stratum candidate budgets ("cand" mode; None entry = unbudgeted);
    # set, the step takes one id array per stratum
    strata_budgets: Optional[Tuple[Optional[int], ...]] = None
    # per-stratum exact-alive budgets of a second compaction (None entry =
    # one stage); same length as strata_budgets when set
    strata_alive_budgets: Optional[Tuple[Optional[int], ...]] = None
    # per-stratum lattice caps: samples start at the bbox entry, so a
    # stratum whose longest chord is C renders exactly on a C-sample lattice
    strata_n_samples: Optional[Tuple[int, ...]] = None
    # per-stratum loss weights, each stratum's share of the store (None =
    # its share of the drawn batch)
    strata_loss_weights: Optional[Tuple[float, ...]] = None
    # draw the per-step loss weights as m/B, m ~ Multinomial(B, weights):
    # the between-strata composition noise a uniform batch carries
    strata_noise_match: bool = False


def strata_loss_shares(statics: TrainStatics, sizes: Sequence[int]) -> List[float]:
    """The fixed per-stratum loss weights: the store shares, normalized, or
    without them each stratum's share of the batch."""
    if statics.strata_loss_weights is not None:
        assert len(statics.strata_loss_weights) == len(sizes)
        wsum = float(sum(statics.strata_loss_weights))
        return [float(x) / wsum for x in statics.strata_loss_weights]
    total = float(sum(sizes))
    return [s / total for s in sizes]


def _multinomial_shares(generator: torch.Generator, n: float, probs: Sequence[float],
                        device) -> torch.Tensor:
    """(S,) m/n with m ~ Multinomial(n, probs), as sequential binomials
    drawn on ``device`` (no host round trip: the constants are fills)."""
    remaining = torch.full((), float(n), dtype=torch.float32, device=device)
    rest = 1.0
    shares = []
    for p in probs[:-1]:
        cond = torch.full((), min(max(p / max(rest, 1e-12), 0.0), 1.0), dtype=torch.float32,
                          device=device)
        m = torch.binomial(remaining, cond, generator=generator)
        m = torch.minimum(torch.clamp(m, min=0.0), remaining)
        shares.append(m / n)
        remaining = remaining - m
        rest -= p
    shares.append(remaining / n)
    return torch.stack(shares)


def render_widths(statics: TrainStatics) -> List[int]:
    """Samples per ray at which each render of a step queries the field
    (render_rays' n_eff): one entry, or one per stratum.  A budget below
    its lattice compacts to the budget (to the alive budget where a second
    stage undercuts it); otherwise the lattice is the width."""
    if statics.strata_budgets is None:
        b = statics.sample_budget
        return [b if b is not None and b < statics.n_samples else statics.n_samples]
    S = len(statics.strata_budgets)
    lattices = statics.strata_n_samples or (statics.n_samples,) * S
    alive = statics.strata_alive_budgets or (None,) * S
    widths = []
    for b, a, n in zip(statics.strata_budgets, alive, lattices):
        if b is None or b >= n:
            widths.append(n)
        elif a is not None and a < b and statics.use_coarse_gate:
            widths.append(a)
        else:
            widths.append(b)
    return widths


def _build_masks(cfg: ModelConfig, statics: TrainStatics, step: int, device) -> FreeMasks:
    if not statics.free_reg:
        return FreeMasks()
    return free_masks(
        pos_len=cfg.pos_bit_length,
        view_len=cfg.view_bit_length,
        fea_len=cfg.fea_bit_length,
        den_ranks=cfg.density_n_comp,
        app_ranks=cfg.app_n_comp,
        step=step,
        total_steps=statics.total_steps,
        ratio=statics.freq_reg_ratio,
        use_decomp_mask=statics.free_decomp,
        max_visible=statics.max_visible,
        device=device,
    )


def _occlusion_denoms(sigmas, rgbs, lw: LossWeights, group: Optional[RankGroup]):
    """Each render's occlusion-mask sum over every rank: without the
    white/black prior the mask is the same window on every ray, so the
    global sum is W times the local one; with it the window follows each
    ray's ground truth, and the sums are all-reduced (they carry no
    gradient)."""
    import torch.distributed as dist

    local = torch.stack([
        torch.sum(occlusion_mask(sg, rg, lw.occ_range, lw.occ_wb_range, lw.occ_wb_prior))
        for sg, rg in zip(sigmas, rgbs)]).detach()
    if not (lw.occ_wb_prior and lw.occ_wb_range > 0):
        return list(local * group.world)
    flat = local.to(group.device) if group.backend == "nccl" else local
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    return list(flat.to(local.device))


def loss_fn(
    field,
    statics: TrainStatics,
    aabb: torch.Tensor,
    rays,
    rgbs,
    step: int,
    u,
    flip,
    alpha_mask: Optional[AlphaGridMask] = None,
    shares: Optional[torch.Tensor] = None,
    group: Optional[RankGroup] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total loss and its parts for one batch at iteration ``step``.

    With ``statics.strata_budgets`` set, ``rays``, ``rgbs``, ``u`` and
    ``flip`` are sequences with one entry per stratum, and ``shares`` (S,)
    are the per-step loss weights of a noise-matched step (None: the fixed
    ones of strata_loss_shares).  With ``statics.ndc_ray``, ``u`` is the
    per-sample jitter (B, n_samples); NDC rays are never stratified.  With
    ``group`` on W > 1 ranks, the rays are this rank's block of a global
    batch W times their number, and the loss is this rank's share of the
    global loss (the parameter regularizers' metrics keep their whole
    value)."""
    cfg = field.cfg
    lw = statics.weights
    occ_on = lw.occ > 0 and lw.occ_range > 0
    world = group.world if group is not None else 1

    def render(rays_b, u_b, flip_b, **budget):
        with tracing.span("tftorch.train.render"):
            return render_rays(
                field, rays_b, masks,
                aabb=aabb,
                step_size=statics.step_size,
                is_train=True,
                white_bg=statics.white_bg,
                ndc_ray=statics.ndc_ray,
                shade_top_k=statics.shade_top_k,
                fused=statics.fused,
                use_coarse_gate=statics.use_coarse_gate,
                alpha_mask=alpha_mask,
                u=None if statics.ndc_ray else u_b,
                jitter=u_b if statics.ndc_ray else None,
                flip=flip_b,
                **budget,
            )

    def mse_of(out, target):
        # a rank's share: its squared errors over the global batch's values
        return mse_loss(out.rgb, target, None if world == 1 else target.numel() * world)

    if statics.strata_budgets is not None:
        if statics.ndc_ray:
            raise ValueError("NDC rays are not stratified")
        masks = _build_masks(cfg, statics, step, aabb.device)
        S = len(statics.strata_budgets)
        assert len(rays) == len(rgbs) == len(u) == len(flip) == S
        alive_budgets = statics.strata_alive_budgets or (None,) * S
        lattices = statics.strata_n_samples or (statics.n_samples,) * S
        assert len(alive_budgets) == len(lattices) == S
        sizes = [int(r.shape[0]) for r in rays]
        loss_w = (shares if shares is not None
                  else strata_loss_shares(statics, [n * world for n in sizes]))
        outs = [render(rays[s], u[s], flip[s], n_samples=lattices[s],
                       sample_budget=statics.strata_budgets[s], budget_mode="cand",
                       alive_budget=alive_budgets[s]) for s in range(S)]
        denoms = (_occlusion_denoms([o.sigma for o in outs], rgbs, lw, group)
                  if occ_on and world > 1 else [None] * S)
        mse = occ = mean_alive = 0.0
        num_valid = 0
        overflow_each = []
        for s, out in enumerate(outs):
            w = loss_w[s]
            mse = mse + w * mse_of(out, rgbs[s])
            mean_alive = mean_alive + w * out.mean_alive_samples
            num_valid = num_valid + out.num_valid_samples
            overflow_each.append(out.budget_overflow_frac)
            if occ_on:
                occ = occ + w * occlusion_loss(out.sigma, rgbs[s], lw.occ_range,
                                               lw.occ_wb_range, lw.occ_wb_prior, denoms[s])
        batch = float(sum(sizes))
        metrics = {
            "mse": mse,
            "stratum_overflow": torch.stack(overflow_each),
            "budget_overflow_frac": sum(o * (n / batch) for o, n in zip(overflow_each, sizes)),
            "mean_alive_samples": mean_alive,
            "num_valid_samples": num_valid,
        }
    else:
        masks = _build_masks(cfg, statics, step, rays.device)
        out = render(rays, u, flip, n_samples=statics.n_samples,
                     sample_budget=statics.sample_budget, budget_mode="alive")
        mse = mse_of(out, rgbs)
        metrics = {
            "mse": mse,
            "num_valid_samples": out.num_valid_samples,
            "budget_overflow_frac": out.budget_overflow_frac,
            "mean_alive_samples": out.mean_alive_samples,
        }
        if occ_on:
            denom = (_occlusion_denoms([out.sigma], [rgbs], lw, group)[0] if world > 1
                     else None)
            occ = occlusion_loss(out.sigma, rgbs, lw.occ_range, lw.occ_wb_range, lw.occ_wb_prior,
                                 denom)
    total = mse
    if occ_on:
        total = total + lw.occ * occ
        metrics["reg_occ"] = occ

    # TV weights decay by lr_factor each step; step t uses w0 * factor^(t+1).
    # Each of W ranks adds 1/W of a parameter regularizer.
    tv_decay = float(torch.pow(torch.tensor(statics.lr_factor, dtype=torch.float32),
                               torch.tensor(step + 1.0, dtype=torch.float32)))
    if lw.ortho > 0 and getattr(field, "has_ortho", False):
        reg = field.ortho_reg()
        total = total + lw.ortho * reg / world
        metrics["reg_ortho"] = reg
    if lw.l1 > 0:
        reg = field.density_l1()
        total = total + lw.l1 * reg / world
        metrics["reg_l1"] = reg
    if lw.tv_density > 0:
        reg = field.tv_density() * lw.tv_density * tv_decay
        total = total + reg / world
        metrics["reg_tv_density"] = reg
    if lw.tv_app > 0:
        reg = field.tv_app() * lw.tv_app * tv_decay
        total = total + reg / world
        metrics["reg_tv_app"] = reg
    return total, metrics


def draw_noise(
    generator: torch.Generator, batch: int, device, width: int = 1
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(u (B, width) jitter, flip scalar 0/1) for one train step: width 1
    for the per-ray lattice jitter, n_samples for NDC rays' per-sample
    jitter."""
    u = torch.rand((batch, width), generator=generator, device=device)
    flip = (torch.rand((), generator=generator, device=device) < 0.5).to(torch.float32)
    return u, flip


def draw_strata_noise(
    generator: torch.Generator, statics: TrainStatics, sizes: Sequence[int], device
):
    """(u per stratum, flip per stratum, shares or None) for one stratified
    step: the shares are drawn when the step is noise-matched and has more
    than one stratum, as in the JAX step."""
    shares = None
    if statics.strata_noise_match and len(sizes) > 1:
        shares = _multinomial_shares(generator, float(sum(sizes)),
                                     strata_loss_shares(statics, sizes), device)
    u = torch.rand((sum(sizes), 1), generator=generator, device=device)
    flip = (torch.rand((len(sizes),), generator=generator, device=device) < 0.5).to(torch.float32)
    return torch.split(u, list(sizes)), tuple(flip), shares


# the step metrics that are sums over the ranks' rays (each rank holds its
# share) and those that are means over them (each rank holds its own)
_SUMMED = ("mse", "total_loss", "reg_occ", "num_valid_samples")
_AVERAGED = ("stratum_overflow", "budget_overflow_frac", "mean_alive_samples")


def _reduce_metrics(field, metrics: Dict[str, torch.Tensor], group: RankGroup):
    """All-reduce the gradients with the metrics riding in the same buffer;
    the summed metrics come back as global sums, the averaged ones as the
    mean over the ranks (every rank holds as many rays)."""
    keys = [k for k in _SUMMED + _AVERAGED if k in metrics]
    parts = [metrics[k].reshape(-1).to(torch.float32) for k in keys]
    reduced = allreduce_grads(list(field.parameters()), group, torch.cat(parts))
    offset = 0
    for k, part in zip(keys, parts):
        v = reduced[offset:offset + part.numel()].view_as(metrics[k]).to(metrics[k].dtype)
        metrics[k] = v / group.world if k in _AVERAGED else v
        offset += part.numel()
    return metrics


def make_train_step(field, statics: TrainStatics, optimizer, group: Optional[RankGroup] = None):
    """Returns ``step_fn(aabb, rays, rgbs, step, generator, alpha_mask=None,
    ids=None, noise=None) -> metrics``, which updates ``field`` in place through
    ``optimizer``.  With ``ids`` given, ``rays`` and ``rgbs`` are the
    device-resident store and the batch is gathered from it on the device:
    ``ids`` is one id tensor, or with strata a sequence of one per
    stratum.  With ``group`` on W > 1 ranks the ids (or rays) are this
    rank's block of the global batch, the gradients are summed over the
    ranks before the Adam step, and the metrics are the global ones.
    ``noise`` replaces the generator's draws with given ones, those of the
    whole (global) batch: ``(u, flip)``, or with strata ``(u per stratum,
    flip per stratum, shares or None)`` — the tests feed JAX's."""
    multi = group is not None
    world = group.world if multi else 1

    def step_fn(aabb, rays, rgbs, step: int, generator: Optional[torch.Generator],
                alpha_mask=None, ids=None, noise=None):
        with tracing.span("tftorch.train.step"):
            return _step(aabb, rays, rgbs, step, generator, alpha_mask, ids, noise)

    def _step(aabb, rays, rgbs, step, generator, alpha_mask, ids, noise):
        shares = None
        with tracing.span("tftorch.train.batch"):
            if statics.strata_budgets is not None:
                sizes = [int(i.shape[0]) for i in ids]
                idx = torch.cat(list(ids))
                rays, rgbs = torch.split(rays[idx], sizes), torch.split(rgbs[idx], sizes)
                # the global batch's draws, of which this rank takes its blocks
                u, flip, shares = noise or draw_strata_noise(
                    generator, statics, [n * world for n in sizes], aabb.device)
                if multi:
                    u = tuple(shard_rows(us, group.rank, world) for us in u)
            else:
                if ids is not None:
                    rays, rgbs = rays[ids], rgbs[ids]
                u, flip = noise or draw_noise(generator, rays.shape[0] * world, rays.device,
                                              statics.n_samples if statics.ndc_ray else 1)
                if multi:
                    u = shard_rows(u, group.rank, world)
        with tracing.span("tftorch.train.optim"):
            optimizer.zero_grad()
        with tracing.span("tftorch.train.forward"):
            total, metrics = loss_fn(field, statics, aabb, rays, rgbs, step, u, flip,
                                     alpha_mask, shares, group)
        with tracing.span("tftorch.train.backward"):
            total.backward()
            # detached, so a kept metric holds no graph (nor the parameters)
            metrics = {k: torch.as_tensor(v).detach() for k, v in metrics.items()}
            metrics["total_loss"] = total.detach()
            if multi:
                # the gradients summed over the ranks
                metrics = _reduce_metrics(field, metrics, group)
        with tracing.span("tftorch.train.optim"):
            optimizer.step()
        metrics["psnr"] = -10.0 * torch.log10(metrics["mse"])
        return metrics

    return step_fn
