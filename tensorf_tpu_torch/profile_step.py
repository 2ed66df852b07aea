"""The cut schedules and in-memory scenes that ``chip_smoke.py`` and
``chip_dev.py`` drive the port with on the card: each config's cut schedule
(CUT_SCHEDULE, LEGO_CUT, FLOWER_CUT) and scene (PATHS, path_scene), the
option sets that turn stratification off (UNSTRATIFIED) or every dtype to
bfloat16 (BF16), and the served test view (serving_view, SERVE_SCALE).

The device time of a step or a served view is measured by
``python3 -m portbench.run --workload <cell> --seed <n> --trace 1``, and
``python -m tensorf_tpu_torch ... --profile_dir DIR`` writes a run's
``torch.profiler`` trace.
"""

from __future__ import annotations

import numpy as np
import torch

from .data.synthetic import make_forward_facing_scene, make_synthetic_scene_arrays
from .ops.rays import get_ray_directions

CONFIG = "configs/synth_full.txt"
LEGO = "configs/lego.txt"
FLOWER = "configs/flower.txt"
OVERRIDES = dict(progress_refresh_rate=10**9)
# the port's drive before it had stratification and budgets
UNSTRATIFIED = dict(stratify=0, sample_budget=0, prefilter_budget=0)
# every dtype option at bfloat16: bf16 plane tables (their backward through
# the scatter-add's bf16 entry point), bf16 line one-hots, the bf16 MLP
BF16 = dict(grid_dtype="bfloat16", line_dtype="bfloat16", compute_dtype="bfloat16")
# synth_full's 30000-step schedule cut to 450 steps: the same events, 50
# steps apart.  The LR still decays over the config's 30000 steps: decayed
# over 450, it slows the field's escape from its initial plateau past the
# first alpha mask at 200, which then finds nothing occupied.  Progress
# (and the budget overflow read that may raise a budget) every 25 steps,
# twice a segment, where the config's 500 would read once in the run.
CUT_SCHEDULE = dict(n_iters=450, lr_decay_iters=30000, upsamp_list=[200, 250, 300, 350, 400],
                    update_AlphaMask_list=[200, 300], vis_every=200, save_ckpt_every=[],
                    progress_refresh_rate=25)
# configs/lego.txt's 3000-step schedule cut to 600 steps as CUT_SCHEDULE
# cuts synth_full's: its one event in reach (upsample and alpha mask at
# 2000) moves to the same fraction of the run, 400, the later ones alike,
# out of reach.  The LR decays over the config's 3000 steps.  The test set
# is scored at 400 (vis_every 2000, cut alike) and after the last step
# (render_test, which lego.txt leaves off).
LEGO_CUT = dict(n_iters=600, lr_decay_iters=3000, upsamp_list=[400, 600, 800, 1100, 1400],
                update_AlphaMask_list=[400, 800], vis_every=400, train_vis_every=400,
                render_test=1)
# configs/flower.txt's 25000-step schedule cut to 450 steps as
# CUT_SCHEDULE cuts synth_full's: the first segment keeps 200 steps (the
# loss bar reads its end), then every event 50 steps apart in the config's
# order — upsample, alpha mask (shrink), three upsamples — so the last 49
# steps run at n_to_reso(640^3).  The LR decays over the config's 25000
# steps; progress every 10 steps as written; no evaluation before the end
# (vis_every 1000 as written lies past it); the spiral render_path is left
# to the caller.
FLOWER_CUT = dict(n_iters=450, lr_decay_iters=25000, upsamp_list=[200, 300, 350, 400],
                  update_AlphaMask_list=[250], render_path=0)
# each config's in-memory scene and cut schedule; lego's scene has
# Blender's split sizes, so its train_idxs and test_idxs select as written;
# flower's is an LLFF capture (make_forward_facing_scene's arguments)
PATHS = {
    CONFIG: (dict(n_train=8, n_test=2, wh=(200, 200), scene="composite"), CUT_SCHEDULE),
    LEGO: (dict(n_train=100, n_test=200, wh=(800, 800), scene="composite"), LEGO_CUT),
    FLOWER: (dict(n_views=34, wh=(1008, 756)), FLOWER_CUT),
}
# the served view: a test camera at synth_full's (and Blender's) 800x800
# test resolution; synth_full's 200x200 scene scales its focal x4
SERVE_SCALE = 4


def path_scene(config: str, cfg):
    """``config``'s in-memory scene (PATHS), tracing only the views that
    ``cfg``'s train_idxs and test_idxs select, where it sets them."""
    scene, _ = PATHS[config]
    if cfg.dataset_name == "llff":
        return make_forward_facing_scene(**scene)
    views = {split: idxs for split, idxs in (("train", cfg.train_idxs), ("test", cfg.test_idxs))
             if idxs}
    return make_synthetic_scene_arrays(**scene, views=views or None)


def serving_view(test_ds, scale: int, device):
    """(directions (H*W, 3), pose (3|4, 4)) float32 on ``device``: test view
    0 at ``scale`` times the dataset's resolution, its focal scaled alike,
    directions normalized as the dataset's are.  rays_from_pose turns them
    into the frame's rays."""
    W, H = test_ds.img_wh
    focal = test_ds.focal * scale
    dirs = get_ray_directions(H * scale, W * scale, [focal, focal])
    dirs = (dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)).reshape(-1, 3)
    return (torch.as_tensor(dirs.astype(np.float32), device=device),
            torch.as_tensor(np.asarray(test_ds.poses[0], np.float32), device=device))
