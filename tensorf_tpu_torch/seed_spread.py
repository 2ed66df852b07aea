"""Final test PSNR of one config's whole CPU drive in both packages over
the same seeds, on the same scene directory.

    python -c "from tensorf_tpu_torch.data.synthetic import make_synthetic_blender_scene as m; \\
        m('./data/synth_sphere', n_train=10, n_test=2, wh=(800, 800))"
    python -m tensorf_tpu_torch.seed_spread --config configs/synth_sphere.txt \\
        --datadir ./data/synth_sphere --seeds 20211202,1,2,3,4 --out /tmp/spread.json

Each seed runs ``train.py --platform cpu`` and ``python -m
tensorf_tpu_torch --device cpu`` as subprocesses (this module imports
neither package's training code) with ``--seed``, ``--datadir`` and a
basedir of its own, and reads the ``test all psnr`` line each prints.
Prints one JSON object: the per-seed PSNRs, each package's mean, standard
deviation and range, and the mean difference over its standard error.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

_PSNR = re.compile(r"test all psnr: ([-+0-9.eE]+|nan)")
# the config's seed (TrainConfig.seed) and four more
SEEDS = (20211202, 1, 2, 3, 4)


def _run(cmd, env) -> tuple:
    t0 = time.time()
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True)
    found = _PSNR.findall(proc.stdout)
    if proc.returncode != 0 or not found:
        raise RuntimeError(f"{' '.join(cmd)} exited {proc.returncode}:\n{proc.stdout[-2000:]}"
                           f"\n{proc.stderr[-2000:]}")
    return float(found[-1]), time.time() - t0


def _stats(values):
    n = len(values)
    mean = sum(values) / n
    sd = math.sqrt(sum((v - mean) ** 2 for v in values) / (n - 1)) if n > 1 else 0.0
    return {"mean": mean, "sd": sd, "min": min(values), "max": max(values)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", required=True)
    p.add_argument("--datadir", required=True)
    p.add_argument("--seeds", default=",".join(str(s) for s in SEEDS))
    p.add_argument("--out", default=None, help="also write the JSON here")
    args, extra = p.parse_known_args(argv)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    seeds = [int(s) for s in args.seeds.split(",")]
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        for seed in seeds:
            row = {"seed": seed}
            common = ["--config", args.config, "--datadir", args.datadir, "--seed", str(seed),
                      *extra]
            for name, cmd in (
                ("jax", [sys.executable, "train.py", "--platform", "cpu"]),
                ("port", [sys.executable, "-m", "tensorf_tpu_torch", "--device", "cpu"]),
            ):
                row[name], row[f"{name}_s"] = _run(
                    cmd + common + ["--basedir", f"{tmp}/{name}_{seed}"], env)
            rows.append(row)
            print(json.dumps(row), flush=True)
    jax_s = _stats([r["jax"] for r in rows])
    port_s = _stats([r["port"] for r in rows])
    n = len(rows)
    se = math.sqrt((jax_s["sd"] ** 2 + port_s["sd"] ** 2) / n) if n > 1 else float("nan")
    result = {"config": args.config, "rows": rows, "jax": jax_s, "port": port_s,
              "diff_over_se": (port_s["mean"] - jax_s["mean"]) / se if se else float("nan")}
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
