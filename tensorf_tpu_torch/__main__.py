"""Entry point: train the first schedule segment, then render a test view.

    python -m tensorf_tpu_torch --config configs/synth_full.txt --n_steps 30 \\
        --stratify 0 --sample_budget 0 --prefilter_budget 0 --synthetic \\
        [--device cpu] [any TrainConfig field as --flag]

Runs on the GPU unless ``--device cpu`` is given, and fails when no GPU is
present.  ``--synthetic`` builds the procedural composite scene in memory
(no files, no PIL) in place of reading ``datadir``.  Stratification and
sample budgets are not ported yet: a config that sets them must be run
with them set to 0.
"""

from __future__ import annotations

import argparse
import json

from .config import add_config_args, config_from_args
from .data.synthetic import make_synthetic_scene_arrays
from .train.loop import train_steps


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="tensorf_tpu_torch trainer")
    add_config_args(parser)
    parser.add_argument("--n_steps", type=int, required=True,
                        help="train steps to take (within the first schedule segment)")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; default cuda")
    parser.add_argument("--synthetic", action="store_true",
                        help="build the procedural composite scene in memory instead of reading datadir")
    parser.add_argument("--synthetic_views", type=str, default="8,2",
                        help="train,test view counts of the in-memory scene")
    parser.add_argument("--synthetic_wh", type=int, default=200,
                        help="width = height of the in-memory scene's images")
    args = parser.parse_args(argv)
    cfg = config_from_args(args)

    scene = None
    if args.synthetic:
        n_train, n_test = (int(v) for v in args.synthetic_views.split(","))
        scene = make_synthetic_scene_arrays(
            n_train=n_train, n_test=n_test, wh=(args.synthetic_wh, args.synthetic_wh),
            scene="composite",
        )
    result = train_steps(cfg, args.n_steps, device=args.device, scene=scene)
    print(json.dumps({
        "steps": args.n_steps,
        "first_loss": result.total_loss[0] if result.total_loss else None,
        "last_loss": result.total_loss[-1] if result.total_loss else None,
        "step_ms": result.step_ms,
        "test_psnr": result.test_psnr,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
