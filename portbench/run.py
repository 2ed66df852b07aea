"""Runs one cell of the port's benchmark once and prints its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``portbench/configs/<config>.json``: the port's training configuration as
run, its scene and the made-state recipe) and a traffic mix
(``portbench/traffic/<traffic>.json``: which segment, training steps or
served views, how much is checked); ``portbench/workloads/<cell>.json``
holds the limits of the cell's compared numbers.  The run builds the
scene and the segment's state from ``--seed`` on the card, warms up, then
for ``--seconds`` trains back to back or serves views one after another.
With ``--trace 0`` it reports the cell's end-to-end metrics; with
``--trace 1`` it times an unprofiled stretch, profiles a short one and
reports the per-layer metrics that ``portbench/metrics/<name>.py`` read.
Either way it then frees the port's state and holds what the timed path
produced against the plain reference (``check.py``).  The last line of
standard output is one JSON object; the compared numbers and their limits
are the last lines of standard error.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, NamedTuple, Optional, Tuple  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BENCH = Path(__file__).resolve().parent
# the program's kernel caches, at fixed paths inside the checkout
CACHE = ROOT / ".cache" / "portbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "tensorf_tpu")


class Cell(NamedTuple):
    name: str
    config: dict
    traffic: dict
    workload: dict
    e2e: List[dict]
    per_layer: List[dict]


def load_cell(name: str) -> Cell:
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
    workload = dict(json.loads((BENCH / "workloads" / f"{name}.json").read_text()),
                    chips=int(w["chips"]))
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    per_layer = [m for m in bench["per_layer"] if name in m.get("workloads", [name])]
    return Cell(name, config, traffic, workload, e2e, per_layer)


def set_cache_dirs() -> None:
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        path = CACHE / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# ---- set-up -----------------------------------------------------------------


class Setup(NamedTuple):
    cfg: object
    scene: object
    state: object
    made: object
    p0: Dict[str, "torch.Tensor"]
    phases: Dict[str, float]


def sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def setup(cell: Cell, seed: int, device) -> Setup:
    """The scene, the port's state over it and the made segment."""
    import torch

    from tensorf_tpu_torch.config import load_config
    from tensorf_tpu_torch.train.loop import TrainState, restratify

    from . import made as made_mod
    from .scene import make_scene

    phases = {}
    t = time.perf_counter()

    def phase(name):
        nonlocal t
        sync(device)
        now = time.perf_counter()
        phases[name] = now - t
        t = now

    # the run's seed also seeds the port's ray sampler
    cfg = load_config(None, dict(cell.config["train"], seed=int(seed)))
    scene = make_scene(cell.config["scene"], device)
    phase("scene")
    state = TrainState(cfg, device, scene.loader_scene)
    phase("rays")
    seg = made_mod.walk_schedule(cfg, state.train_ds.scene_bbox, scene, cell.traffic["segment"],
                                 device)
    made = made_mod.make(cfg, cell.config, scene, seg, seed, device)
    made_mod.install(state, made)
    p0 = {k: v.detach().cpu() for k, v in made.params.items()}
    made = made._replace(params={})
    phase("state")
    restratify(state, seg.iteration, log=lambda s: None)
    phase("restratify")
    return Setup(cfg, scene, state, made, p0, phases)


# ---- training ---------------------------------------------------------------


def mix(seed: int, it: int) -> int:
    return (int(seed) * 1_000_003 + int(it)) % (2 ** 63)


def own_noise(gen, seed: int, it: int, statics, sizes, device):
    """A checked step's noise, drawn by the benchmark from (seed, iteration)
    in the layout the port's step takes: the per-ray lattice jitter (per
    sample for NDC rays) and the background flip (one per stratum).  A
    stratified step gets each stratum's share of the batch as its loss
    shares, so that its loss is the plain mean over the batch's rows and the
    reference needs nothing of the strata plan."""
    import torch
    gen.manual_seed(mix(seed, it))
    if statics.strata_budgets is None:
        width = statics.n_samples if statics.ndc_ray else 1
        u = torch.rand((sizes[0], width), generator=gen, device=device)
        flip = (torch.rand((), generator=gen, device=device) < 0.5).float()
        return u, flip
    batch = float(sum(sizes))
    u = torch.rand((sum(sizes), 1), generator=gen, device=device)
    flip = (torch.rand((len(sizes),), generator=gen, device=device) < 0.5).float()
    shares = torch.tensor([n / batch for n in sizes], dtype=torch.float32, device=device)
    return torch.split(u, list(sizes)), tuple(flip), shares


def id_sizes(ids) -> List[int]:
    return [int(i.shape[0]) for i in ids] if isinstance(ids, tuple) else [int(ids.shape[0])]


class Trainer:
    """Drives the port's train step as its training loop does: ids from
    the state's sampler, the step function on the resident store, a
    generator seeded from (seed, iteration) from which the step draws its
    own noise, the losses kept on the device and read at the end, the
    progress metrics read at the configuration's progress rate."""

    def __init__(self, s: Setup, seed: int, device):
        from tensorf_tpu_torch.train.loop import build_statics, step_seed
        from tensorf_tpu_torch.train.step import make_train_step
        import torch

        self.s, self.seed, self.device = s, seed, device
        st = s.state
        self.statics = build_statics(st)
        self.step_fn = make_train_step(st.field, self.statics, st.optimizer)
        self.step_seed = step_seed
        self.aabb = st.aabb
        self.it = s.made.segment.iteration
        self.gen = torch.Generator(device=device)
        self.last_ids = None

    def step(self, checked: Optional[list] = None):
        """One step; a checked step (``checked`` given) takes the
        benchmark's noise instead of drawing its own, and its rows and
        noise are kept there."""
        st = self.s.state
        ids = st.next_ids()
        noise = None
        if checked is not None:
            noise = own_noise(self.gen, self.seed, self.it, self.statics, id_sizes(ids),
                              self.device)
            checked.append(dict(iteration=self.it, ids=ids, noise=noise))
        else:
            self.gen.manual_seed(self.step_seed(self.seed, self.it))
        metrics = self.step_fn(self.aabb, st.rays, st.rgbs, self.it, self.gen, st.alpha_mask,
                               ids=ids, noise=noise)
        self.last_ids = ids
        self.it += 1
        return metrics

    def drawn_u(self, it: int, ids):
        """The jitter that the port's step drew at iteration ``it`` (drawn
        again from its generator's seed), one row per ray."""
        import torch

        from tensorf_tpu_torch.train.step import draw_noise, draw_strata_noise
        g = torch.Generator(device=self.device)
        g.manual_seed(self.step_seed(self.seed, it))
        sizes = id_sizes(ids)
        if self.statics.strata_budgets is None:
            width = self.statics.n_samples if self.statics.ndc_ray else 1
            return draw_noise(g, sizes[0], self.device, width)[0]
        return torch.cat(list(draw_strata_noise(g, self.statics, sizes, self.device)[0]))

    def progress(self, metrics) -> None:
        """The loop's host read at its progress rate: psnr, mse, overflow."""
        if self.it % max(int(self.s.cfg.progress_refresh_rate), 1) == 0:
            float(metrics["psnr"])
            float(metrics["mse"])
            (metrics["stratum_overflow"] if "stratum_overflow" in metrics
             else metrics["budget_overflow_frac"]).tolist()


def checked_steps(tr: Trainer, n: int):
    """The first ``n`` steps, with what the comparison needs of each: the
    batch rows and noise, the losses, the first gradient as Adam holds
    it, the parameters after the last."""
    import torch
    st = tr.s.state
    kept, losses = [], []
    grad1 = None
    for k in range(n):
        m = tr.step(kept)
        losses.append(float(m["total_loss"]))
        if k == 0:
            # Adam's first moment after one step is (1 - beta1) g; a
            # parameter it never stepped holds none
            adam = st.optimizer.adam.state
            grad1 = {name: float(torch.linalg.norm(adam[p]["exp_avg"] / (1.0 - 0.9)))
                     if "exp_avg" in adam.get(p, {}) else 0.0
                     for name, p in st.field.named_parameters()}
    p3 = {name: p.detach().cpu().clone() for name, p in st.field.named_parameters()}
    for rec in kept:
        ids = rec["ids"]
        flat = torch.cat(list(ids)) if isinstance(ids, tuple) else ids
        rec["flat_ids"] = flat.clone()
        rec["rays"] = st.rays[flat].clone()
        rec["rgbs"] = st.rgbs[flat].clone()
        rec["sizes"] = id_sizes(ids)
    return kept, losses, grad1, p3


def train_window(tr: Trainer, seconds: float):
    """Steps back to back for ``seconds``; (steps, wall s, failed, host):
    ``host`` is what the host's clock saw, for the record: the steps
    enqueued in each 5-second slice and the share of the window's wall time
    that the process spent on a CPU."""
    import torch
    totals, stamps = [], []
    sync(tr.device)
    c0 = time.process_time()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        m = tr.step()
        totals.append(m["total_loss"])
        tr.progress(m)
        stamps.append(time.perf_counter() - t0)
    sync(tr.device)
    wall = time.perf_counter() - t0
    cpu = time.process_time() - c0
    vals = torch.stack(totals).tolist()
    host = {"steps_per_5s": [sum(1 for t in stamps if a <= t < a + 5.0)
                             for a in range(0, int(math.ceil(wall)), 5)],
            "cpu_share": cpu / wall}
    return len(vals), wall, sum(1 for v in vals if not math.isfinite(v)), host


# ---- the reference side -----------------------------------------------------


def ref_model(cfg, state) -> "object":
    from . import reference as ref
    top = cfg.shade_top_k if (cfg.shade_top_k > 0 and state.alpha_mask is not None) else None
    if state.alpha_mask is None and cfg.prefilter_shade_top_k > 0:
        top = cfg.prefilter_shade_top_k
    return ref.Model(
        density_ranks=tuple(cfg.n_lamb_sigma), app_ranks=tuple(cfg.n_lamb_sh),
        relu=cfg.fea2denseAct == "relu", view_pe=cfg.view_pe, fea_pe=cfg.fea_pe,
        white_bg=bool(state.white_bg), ndc=bool(cfg.ndc_ray), near=float(state.near_far[0]),
        far=float(state.near_far[1]), shade_top_k=top, free_reg=bool(cfg.free_reg),
        free_decomp=bool(cfg.free_decomp), freq_ratio=float(cfg.freq_reg_ratio),
        n_iters=int(cfg.n_iters))


def ref_geometry(cfg, made, device):
    import torch

    from . import made as made_mod
    from . import reference as ref
    seg = made.segment
    mask_aabb = dil = None
    if made.mask is not None:
        mask_aabb = torch.as_tensor(seg.mask[0], device=device)
        dil = ref.dilate(made.mask.to(device))
    return ref.Geometry(torch.as_tensor(seg.aabb, device=device),
                        made_mod.step_size(seg.aabb, seg.grid, cfg.step_ratio), seg.n_samples,
                        mask_aabb, dil)


def ref_loss(cfg, made) -> "object":
    from . import reference as ref
    decay_iters = cfg.lr_decay_iters if cfg.lr_decay_iters > 0 else cfg.n_iters
    return ref.Loss(ortho=cfg.Ortho_weight if "VM" in cfg.model_name else 0.0,
                    l1=made.segment.l1_weight, tv_density=cfg.TV_weight_density,
                    tv_app=cfg.TV_weight_app,
                    lr_factor=cfg.lr_decay_target_ratio ** (1 / decay_iters))


def ref_steps(kept, model):
    """The reference's view of the checked steps: the rows the port drew
    (their rays as ``store_gap`` holds them to the benchmark's own, the
    benchmark's own targets), the benchmark's noise a row, every row
    weighted alike."""
    import torch
    steps = []
    for rec in kept:
        sizes, noise = rec["sizes"], rec["noise"]
        B = sum(sizes)
        if len(noise) == 3:
            u, flip, _ = noise
            u = torch.cat(list(u))
            flip = torch.cat([f.reshape(1).expand(n) for f, n in zip(flip, sizes)])
            part = dict(u=u, jitter=None)
        else:
            u, flip = noise
            part = dict(u=None if model.ndc else u, jitter=u if model.ndc else None)
            flip = flip.reshape(1).expand(B)
        steps.append(dict(iteration=rec["iteration"], strata=[dict(
            rays=rec["rays"], rgbs=rec["own_rgbs"], flip=flip[:, None], weight=1.0, **part)]))
    return steps


def store_rows(s: Setup, kept) -> float:
    """The checked rows of the port's store against the benchmark's own
    rays and photo pixels: the widest gap; each kept step gets the
    benchmark's own target of each row (``own_rgbs``) for the reference."""
    import torch

    from .check import composite_rows, forward_rows
    rays = torch.cat([r["rays"] for r in kept])
    rgbs = torch.cat([r["rgbs"] for r in kept])
    if s.scene.kind == "composite":
        gap, own = composite_rows(s.scene, rays, rgbs)
    else:
        gap, own = forward_rows(s.scene, torch.cat([r["flat_ids"] for r in kept]), rays, rgbs)
    for rec, part in zip(kept, torch.split(own, [r["rgbs"].shape[0] for r in kept])):
        rec["own_rgbs"] = part
    return gap


def free_program(s: Setup) -> Setup:
    """Drop the port's field, optimizer and ray store before the reference
    runs (the process's peak never falls again)."""
    import torch
    st = s.state
    st.field = st.optimizer = st.sampler = st.rays = st.rgbs = None
    st.train_ds = st.test_ds = None
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return s


class TrainCheck(NamedTuple):
    """What the reference needs to follow the checked steps, taken before
    the port is freed."""
    model: object
    geom: object
    loss: object
    steps: list
    lrs: dict
    p0: dict
    block: int


def train_check(cell: Cell, s: Setup, kept) -> Tuple[float, TrainCheck]:
    """(store_gap, the reference's inputs); frees the port's state."""
    from . import reference as ref
    model = ref_model(s.cfg, s.state)
    gap = store_rows(s, kept)
    chk = TrainCheck(model, ref_geometry(s.cfg, s.made, s.state.device), ref_loss(s.cfg, s.made),
                     ref_steps(kept, model), ref.group_lrs(list(s.p0), s.cfg.lr_init,
                                                           s.cfg.lr_basis),
                     s.p0, int(cell.traffic["reference_block"]))
    free_program(s)
    return gap, chk


def follow(chk: TrainCheck, device, prec=None) -> dict:
    """The reference's readings over the checked steps, computed in
    ``prec`` (by default its own float32)."""
    from . import reference as ref
    from .check import reference_readings
    return reference_readings(chk.model, chk.geom, chk.loss, chk.p0, chk.steps, chk.lrs,
                              prec or ref.Precision(), chk.block, device)


def run_train(cell: Cell, seed: int, seconds: float, trace: bool, device) -> dict:
    from .check import train_numbers

    s = setup(cell, seed, device)
    tr = Trainer(s, seed, device)
    t = time.perf_counter()
    kept, losses, grad1, p3 = checked_steps(tr, int(cell.traffic["checked_steps"]))
    for _ in range(int(cell.traffic["warmup_steps"])):
        tr.progress(tr.step())
    sync(device)
    s.phases["warmup"] = time.perf_counter() - t
    setup_s = time.perf_counter() - T_START
    out = dict(setup_s=setup_s, phases=s.phases)
    if trace:
        out.update(traced_train(cell, tr, s, device))
        attempted, failed = out.pop("attempted"), out.pop("failed")
    else:
        steps, wall, failed, out["host"] = train_window(tr, seconds)
        attempted = steps
        out["train_rays_per_s"] = steps * int(s.cfg.batch_size) / wall
    peak = peak_bytes(device)
    out["peak_gib"] = peak / 2 ** 30
    # the comparison, on the reference's own precision, after the window
    change = {k: float((p3[k] - s.p0[k]).norm()) for k in p3}
    prog = dict(losses=losses, grad1=grad1, change=change)
    tr = None
    gap, chk = train_check(cell, s, kept)
    numbers = dict(train_numbers(prog, follow(chk, device)), store_gap=gap)
    if trace:
        out["context"]["flops_per_unit"] = step_work(cell, s, out.pop("profiled"), device)
    out.update(attempted=attempted, failed=failed, numbers=numbers, peak=peak)
    return out


def traced_train(cell: Cell, tr: Trainer, s: Setup, device) -> dict:
    """An unprofiled stretch of steps, then a profiled one; what the
    per-layer readers need."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from .trace import read
    import tensorf_tpu_torch.ops.grid_sample as gs

    n = int(cell.traffic["traced_steps"])
    sync(device)
    t0 = time.perf_counter()
    for _ in range(n):
        tr.progress(tr.step())
    sync(device)
    plain = (time.perf_counter() - t0) / n
    calls = []
    inner = gs.scatter_add

    def recording(idx, g, n_rows):
        calls.append((int(idx.numel()), int(g.shape[1]), int(g.element_size()), int(n_rows)))
        return inner(idx, g, n_rows)

    stepped = []
    gs.scatter_add = recording
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                tr.progress(tr.step())
                stepped.append((tr.it - 1, tr.last_ids))
            sync(device)
    finally:
        gs.scatter_add = inner
    dtrace = read(prof)
    st = s.state
    rows = []
    for it, ids in stepped:
        flat = torch.cat(list(ids)) if isinstance(ids, tuple) else ids
        rows.append((it, st.rays[flat].clone(), tr.drawn_u(it, ids)))
    params = {k: v.detach().cpu() for k, v in st.field.named_parameters()}
    return dict(context=dict(kind="train", trace=dtrace, units=n, plain_wall_s=plain,
                             scatter_calls=calls),
                profiled=(rows, params), attempted=2 * n, failed=0)


def step_work(cell: Cell, s: Setup, profiled, device) -> float:
    """FLOPs a profiled step: the reference counts the samples the mask
    admits and those shaded along the steps' rays, with the noise and the
    parameters the steps saw."""
    import torch

    from . import reference as ref
    from .counts import step_flops
    rows, params = profiled
    model = ref_model(s.cfg, s.state)
    geom = ref_geometry(s.cfg, s.made, device)
    P = {k: v.to(device) for k, v in params.items()}
    block = int(cell.traffic["reference_block"])
    alive = shaded = 0
    with torch.no_grad():
        for it, rays, u in rows:
            masks = ref.masks_at(model, it, P["basis"].shape[1], device)
            for a in range(0, rays.shape[0], block):
                sl = slice(a, a + block)
                r = ref.render(model, P, geom, rays[sl], masks,
                               u=None if model.ndc else u[sl], jitter=u[sl] if model.ndc else None)
                alive += int(r.alive.sum())
                shaded += int(r.shaded.sum())
    return step_flops(s.cfg, alive, shaded) / len(rows)


# ---- serving ----------------------------------------------------------------


class Serving(NamedTuple):
    s: Setup
    handle: object
    rays_of: object  # view index -> its rays (M, 6) on the device
    n_views: int


def serving(cell: Cell, seed: int, device) -> Serving:
    """The served state's handle, the views' poses drawn from the seed, and
    the first view served as the warm-up."""
    from tensorf_tpu_torch.train.loop import make_handle

    from .scene import served_poses, view_rays

    s = setup(cell, seed, device)
    handle = make_handle(s.state)
    spec = cell.config["scene"]
    wh = tuple(cell.traffic["wh"])
    focal = 0.5 * wh[0] / math.tan(0.5 * spec["camera_angle_x"])
    poses = served_poses(seed, int(cell.traffic["max_views"]), spec["cam_radius"])

    def rays_of(k):
        return view_rays(poses[k], wh, focal, device)

    t = time.perf_counter()
    handle.render(rays_of(0))
    sync(device)
    s.phases["warmup"] = time.perf_counter() - t
    return Serving(s, handle, rays_of, len(poses))


def serve_view(sv: Serving, k: int):
    """View ``k`` served: (k, rgb, depth), host arrays."""
    rgb, depth, _ = sv.handle.render(sv.rays_of(k))
    return k, rgb, depth


class ServeCheck(NamedTuple):
    model: object
    P: dict
    geom: object
    views: list  # (rays, the port's rgb, the port's depth)
    block: int


def serve_check(cell: Cell, sv: Serving, served, checked, device) -> ServeCheck:
    """The reference's inputs for the ``checked`` entries of ``served``;
    frees the port's state."""
    s = sv.s
    model = ref_model(s.cfg, s.state)
    geom = ref_geometry(s.cfg, s.made, device)
    free_program(s)
    P = {k: v.to(device) for k, v in s.p0.items()}
    views = [(sv.rays_of(served[i][0]), served[i][1], served[i][2]) for i in checked]
    return ServeCheck(model, P, geom, views, int(cell.traffic["reference_block"]))


def run_serve(cell: Cell, seed: int, seconds: float, trace: bool, device) -> dict:
    import numpy as np
    import torch

    from . import reference as ref
    from .check import serve_numbers

    sv = serving(cell, seed, device)
    setup_s = time.perf_counter() - T_START
    out = dict(setup_s=setup_s, phases=sv.s.phases)
    served = []
    if trace:
        from torch.profiler import ProfilerActivity, profile

        from .trace import read
        t0 = time.perf_counter()
        served.append(serve_view(sv, 1))
        plain = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            served.append(serve_view(sv, 2))
        out["context"] = dict(kind="serve", trace=read(prof), units=1, plain_wall_s=plain)
        checked = [0, 1]
    else:
        k = 1
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds and k < sv.n_views:
            served.append(serve_view(sv, k))
            k += 1
        wall = time.perf_counter() - t0
        out["view_ms"] = wall * 1e3 / len(served)
        g = torch.Generator().manual_seed(mix(seed, 1))
        n_check = min(int(cell.traffic["checked_views"]), len(served))
        checked = sorted(torch.randperm(len(served), generator=g)[:n_check].tolist())
    failed = sum(1 for _, rgb, depth in served
                 if not (np.isfinite(rgb).all() and np.isfinite(depth).all()))
    peak = peak_bytes(device)
    out["peak_gib"] = peak / 2 ** 30
    sv = sv._replace(handle=None)
    chk = serve_check(cell, sv, served, checked, device)
    if trace:
        with torch.no_grad():
            alive = shaded = 0
            rays = chk.views[1][0]
            for a in range(0, rays.shape[0], chk.block):
                r = ref.render(chk.model, chk.P, chk.geom, rays[a:a + chk.block], ref.Masks())
                alive += int(r.alive.sum())
                shaded += int(r.shaded.sum())
        from .counts import forward_flops
        out["context"]["flops_per_unit"] = forward_flops(sv.s.cfg, alive, shaded)
    out.update(attempted=len(served), failed=failed, peak=peak,
               numbers=serve_numbers(chk.model, chk.P, chk.geom, chk.views, ref.Precision(),
                                     chk.block))
    return out


# ---- the runs ---------------------------------------------------------------


def device_info(device, peak: int) -> dict:
    import torch
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
                "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": int(peak)}


def peak_bytes(device) -> int:
    import torch
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def read_per_layer(cell: Cell, ctx: dict) -> Dict[str, dict]:
    """Each per-layer metric's reader, ``portbench/metrics/<name>.py``; a
    reader that finds nothing to read returns None and its metric is left
    out."""
    out = {}
    for m in cell.per_layer:
        spec = importlib.util.spec_from_file_location(
            f"portbench_metric_{m['name'].replace('.', '_')}", BENCH / "metrics" / f"{m['name']}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        value = mod.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run(cell: Cell, seed: int, seconds: float, trace: bool, device) -> dict:
    """One run of ``cell`` on ``device``; the result line as a dict."""
    from .check import verdict
    drive = {"train": run_train, "serve": run_serve}[cell.traffic["kind"]]
    out = drive(cell, seed, seconds, trace, device)
    numbers = out["numbers"]
    correct, checks = verdict(numbers, cell.workload["limits"])
    if trace:
        ctx = out["context"]
        metrics = read_per_layer(cell, ctx)
        dtrace = ctx["trace"]
        extra = {"busy_s": dtrace.busy_us / 1e6, "window_s": (dtrace.window_us[1]
                                                                 - dtrace.window_us[0]) / 1e6}
        breakdown = {"device_ops": [[k, v] for k, v in dtrace.top_kernels(10)],
                     "idle_gaps": [[k, v] for k, v in dtrace.idle_gaps(10)]}
    else:
        metrics = {m["name"]: {"value": float(out[m["name"].split(".")[0]]), "unit": m["unit"]}
                   for m in cell.e2e}
        extra, breakdown = {}, None
    dev = device_info(device, out["peak"])
    dev.update(extra)
    result = {"correct": bool(correct and out["failed"] == 0), "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    if "host" in out:
        result["host"] = out["host"]
    result["setup_phases_s"] = out["phases"]
    result["info"] = {k: v for k, v in numbers.items() if k not in checks}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    cell = load_cell(args.workload)
    set_cache_dirs()
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(
            cell.workload.get("chips", 1)):
        log("no CUDA device, or fewer than the cell asks for: nothing is measured")
        return 2
    from tensorf_tpu_torch.utils.device import resolve_device
    device = resolve_device("cuda")
    torch.cuda.reset_peak_memory_stats(device)
    result = run(cell, args.seed, args.seconds, bool(args.trace), device)
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
    if loaded:
        log(f"modules of JAX or the JAX package were loaded: {loaded}")
        return 3
    for name, value in result["info"].items():
        log(f"info {name} {value!r}")
    for name, row in result["checks"].items():
        log(f"check {name} {row['value']!r} limit {row['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
