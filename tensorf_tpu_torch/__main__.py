"""Entry point: run a config's whole schedule, a few first-segment steps,
render a checkpoint's test views, or export a checkpoint's mesh.

    python -m tensorf_tpu_torch --config configs/synth_sphere.txt \\
        --synthetic --synthetic_scene sphere --synthetic_wh 800 \\
        --synthetic_views 10,2 [--device cpu] [--flag value ...]
    python -m tensorf_tpu_torch --config ... --n_steps 30 ...      # first segment only
    python -m tensorf_tpu_torch --config ... --render_only 1 --render_test 1 --ckpt PATH
    python -m tensorf_tpu_torch --config ... --export_mesh 1 --ckpt PATH
    python -m tensorf_tpu_torch --config ... --resume 1            # continue a run
    python -m tensorf_tpu_torch --config ... --auto_resume 3       # relaunch on a wedge
    python -m tensorf_tpu_torch --config ... --n_devices 2         # two ranks, one per card
    torchrun --nproc_per_node 4 -m tensorf_tpu_torch --config ... --distributed 1

Any TrainConfig field is a ``--flag``, and the flags dispatch as
train.py's do: ``auto_resume`` supervises a child run, ``export_mesh``
with a checkpoint exports it and trains nothing, ``render_only`` renders
only together with a render flag (and trains otherwise), and
``export_mesh`` after training exports the final checkpoint.  Each result
is one JSON line.  Runs on the GPU unless ``--device cpu`` is given, and
fails when no GPU is present.  ``--synthetic`` builds a procedural scene in
memory (no files, no PIL) in place of reading ``datadir``: for an ``llff``
config a forward-facing capture in LLFF's layout (``--synthetic_views N``
views, every 8th held out for test, at ``--synthetic_wh`` x 3/4 of it
pixels), else the blender-layout scene, of which a training run traces only
the views the config's ``train_idxs`` and ``test_idxs`` select.  Every
config runs as written, with every option: ``--grid_dtype bfloat16``,
``--line_dtype bfloat16`` and ``--compute_dtype bfloat16`` run the plane
tables, the line one-hots and the shading MLP in bfloat16 (parameters and
checkpoints stay float32).  ``--ckpt`` takes the port's or the JAX
package's ``.npz`` or the reference's ``.th`` (utils/import_torch.py).
LPIPS reads its nets' weights from ``TENSORF_LPIPS_DIR``
(eval/lpips.py); without them mean.txt's LPIPS lines are NaN.

``--n_devices N`` trains data-parallel over N ranks, one per visible card
(0: every card; with ``--device cpu``, N ranks on the CPU over gloo), which
this process spawns; ``--distributed 1`` makes this process one rank of a
run started outside it (torchrun, or the TFTPU_* variables).  Rank 0 alone
writes the run's files; a rank that fails makes the launch exit non-zero.
Render-only and mesh export run on one device, on rank 0 of a distributed
run; ``--n_steps`` runs on one device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np

from .config import add_config_args, config_from_args
from .data.synthetic import make_forward_facing_scene, make_synthetic_scene_arrays
from .parallel.launch import RankFailed, env_rank
from .train.loop import export_mesh, reconstruction, render_test, train_steps
from .utils.watchdog import EXIT_WEDGED


def _supervise(argv, retries: int) -> int:
    """Run the CLI in a child process; on the watchdog's wedged exit (code
    17, utils/watchdog.py) relaunch it with ``--resume 1``, so the run
    continues from its newest periodic checkpoint — up to ``retries``
    relaunches (train.py:27-56).  The child spawns an ``n_devices``
    launch's ranks, so a relaunch restarts every rank."""
    base = [sys.executable, "-m", "tensorf_tpu_torch"]
    # the child must not supervise again
    child_argv = list(argv) + ["--auto_resume", "0"]
    rc = subprocess.call(base + child_argv)
    attempt = 0
    while rc == EXIT_WEDGED and attempt < retries:
        attempt += 1
        print(f"[supervisor] wedged exit (code {rc}) — relaunch {attempt}/{retries} "
              f"with --resume 1", flush=True)
        rc = subprocess.call(base + child_argv + ["--resume", "1"])
    if rc == EXIT_WEDGED:
        print(f"[supervisor] still wedged after {retries} relaunches — giving up (resume "
              f"later with --resume 1)", flush=True)
    return rc


def _print_mesh(result) -> None:
    print(json.dumps({"ply": result.ply, "verts": len(result.mesh.verts),
                      "faces": len(result.mesh.tris), "native": result.native,
                      "alpha_ms": result.alpha_ms, "march_ms": result.march_ms}))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    parser = argparse.ArgumentParser(description="tensorf_tpu_torch trainer")
    add_config_args(parser)
    parser.add_argument("--n_steps", type=int, default=None,
                        help="take this many first-segment steps and render one test view, "
                             "instead of the whole schedule")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; default cuda")
    parser.add_argument("--synthetic", action="store_true",
                        help="build a procedural scene in memory instead of reading datadir")
    parser.add_argument("--synthetic_scene", choices=("composite", "sphere"), default="composite",
                        help="which procedural scene --synthetic builds")
    parser.add_argument("--synthetic_views", type=str, default="8,2",
                        help="train,test view counts of the in-memory scene (llff: the views "
                             "of the capture, the first number)")
    parser.add_argument("--synthetic_wh", type=int, default=200,
                        help="width = height of the in-memory scene's images (llff: the "
                             "width, the height 3/4 of it)")
    parser.add_argument("--save_images", type=int, default=1,
                        help="write the evaluations' images, videos and mean.txt, the progress "
                             "figures and their GIF (needs imageio and matplotlib)")
    args = parser.parse_args(argv)
    cfg = config_from_args(args)

    if cfg.auto_resume and argv:
        return _supervise(argv, int(cfg.auto_resume))
    try:
        return _run(cfg, args)
    except RankFailed as exc:
        print(f"[launch] {exc}", file=sys.stderr, flush=True)
        return exc.exitcode


def _run(cfg, args) -> int:
    # on a distributed run every rank runs the CLI: render-only and mesh
    # export are rank 0's
    found = env_rank() if cfg.distributed else None
    single_writer = found is None or found[0] == 0
    if cfg.export_mesh and (cfg.ckpt or cfg.ckpt_path):
        if not single_writer:
            return 0
        _print_mesh(export_mesh(cfg, device=args.device))
        return 0

    render_only = cfg.render_only and (cfg.render_test or cfg.render_path or cfg.render_train)
    scene = None
    if args.synthetic and cfg.dataset_name == "llff":
        scene = make_forward_facing_scene(
            n_views=int(args.synthetic_views.split(",")[0]),
            wh=(args.synthetic_wh, args.synthetic_wh * 3 // 4))
    elif args.synthetic:
        n_train, n_test = (int(v) for v in args.synthetic_views.split(","))
        views = None
        if not (render_only or cfg.render_train):  # those read whole splits
            # and frame 26 of each split, the progress figures' view
            gift = [26] if args.save_images else []
            views = {split: [*idxs, *gift] for split, idxs in (("train", cfg.train_idxs),
                                                               ("test", cfg.test_idxs)) if idxs}
        scene = make_synthetic_scene_arrays(
            n_train=n_train, n_test=n_test, wh=(args.synthetic_wh, args.synthetic_wh),
            scene=args.synthetic_scene, views=views,
        )
    if render_only:
        if not single_writer:
            return 0
        psnrs = render_test(cfg, scene, args.device, save_images=bool(args.save_images))
        print(json.dumps({"test_psnr": float(np.mean(psnrs)) if psnrs else None}))
        return 0
    if args.n_steps is not None:
        result = train_steps(cfg, args.n_steps, device=args.device, scene=scene)
        print(json.dumps({
            "steps": args.n_steps,
            "first_loss": result.total_loss[0] if result.total_loss else None,
            "last_loss": result.total_loss[-1] if result.total_loss else None,
            # the means over the first and the last 5 steps, which chip_smoke.py's
            # loss checks compare
            "first5_loss": float(np.mean(result.total_loss[:5])) if result.total_loss else None,
            "last5_loss": float(np.mean(result.total_loss[-5:])) if result.total_loss else None,
            "step_ms": result.step_ms,
            "test_psnr": result.test_psnr,
        }))
        return 0
    result = reconstruction(cfg, scene, args.device, save_images=bool(args.save_images))
    print(json.dumps({
        "final_ckpt": result.final_path,
        "test_psnrs": result.test_psnrs,
        "final_test_psnr": float(np.mean(result.final_psnrs)) if result.final_psnrs else None,
        "segments": result.segments,
    }))
    if cfg.export_mesh and single_writer:
        _print_mesh(export_mesh(cfg, result.final_path, device=args.device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
