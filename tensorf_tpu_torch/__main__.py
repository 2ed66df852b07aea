"""Entry point: run a config's whole schedule, a few first-segment steps,
or render a checkpoint's test views.

    python -m tensorf_tpu_torch --config configs/synth_sphere.txt \\
        --synthetic --synthetic_scene sphere --synthetic_wh 800 \\
        --synthetic_views 10,2 [--device cpu] [--flag value ...]
    python -m tensorf_tpu_torch --config ... --n_steps 30 ...      # first segment only
    python -m tensorf_tpu_torch --config ... --render_only 1 --render_test 1 --ckpt PATH

Any TrainConfig field is a ``--flag``.  Runs on the GPU unless ``--device
cpu`` is given, and fails when no GPU is present.  ``--synthetic`` builds
a procedural scene in memory (no files, no PIL) in place of reading
``datadir``.  A config runs as written; only ``resume`` and ``ndc_ray``
are refused (not ported yet).
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from .config import add_config_args, config_from_args
from .data.synthetic import make_synthetic_scene_arrays
from .train.loop import reconstruction, render_test, train_steps


def main(argv=None) -> int:
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
                        help="train,test view counts of the in-memory scene")
    parser.add_argument("--synthetic_wh", type=int, default=200,
                        help="width = height of the in-memory scene's images")
    parser.add_argument("--save_images", type=int, default=1,
                        help="write the final evaluation's images, videos and mean.txt "
                             "(needs imageio)")
    args = parser.parse_args(argv)
    cfg = config_from_args(args)

    scene = None
    if args.synthetic:
        n_train, n_test = (int(v) for v in args.synthetic_views.split(","))
        scene = make_synthetic_scene_arrays(
            n_train=n_train, n_test=n_test, wh=(args.synthetic_wh, args.synthetic_wh),
            scene=args.synthetic_scene,
        )
    if cfg.render_only:
        psnrs = render_test(cfg, scene, args.device, save_images=bool(args.save_images))
        print(json.dumps({"test_psnr": float(np.mean(psnrs)) if psnrs else None}))
        return 0
    if args.n_steps is not None:
        result = train_steps(cfg, args.n_steps, device=args.device, scene=scene)
        print(json.dumps({
            "steps": args.n_steps,
            "first_loss": result.total_loss[0] if result.total_loss else None,
            "last_loss": result.total_loss[-1] if result.total_loss else None,
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
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
