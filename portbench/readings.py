"""The readings the limits of ``correct`` are set from, several seeds in one
process, with no measured window:

    python3 -m portbench.readings --workload <cell> --seeds 1,2,3 [--control N] [--fault <fault>]

For each seed it builds the cell's set-up as a run does and takes what a
run compares: the port's numbers against the plain reference (the lower
readings); on the first ``N`` seeds also those of the control, the
reference computed with its matrix products' inputs rounded to TF32 and
put in the port's place (the upper readings).  With ``--fault half_batch``
they are the port's numbers with its loss taking the mean over half of
each stratum's rows; with ``--fault altered_row``, those with every 64th
row of the loader's ray store given the opposite colour.  Each set of
numbers also goes through the verdict against the cell's committed
limits, as a run's would, and prints its ``correct``.  One JSON line per
seed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import reference as ref
from . import run as R
from .check import serve_numbers, train_numbers, verdict


def half_batch_mse(pred, target, count=None):
    n = pred.shape[0] // 2
    return torch.mean(torch.square(pred[:n] - target[:n]))


def alter_rows(state) -> None:
    """Every 64th row of the port's ray store gets the opposite colour."""
    state.rgbs[::64] = 1.0 - state.rgbs[::64]


def detail(prog: dict, refr: dict) -> dict:
    """Each step's relative loss gap and each leaf's first-gradient and
    change gaps."""
    from .check import leaf_gaps
    return dict(step_loss_gap=[abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                                   refr["losses"])],
                leaf_grad_gap=leaf_gaps(prog["grad1"], refr["grad1"], list(refr["grad1"])),
                leaf_change_gap=leaf_gaps(prog["change"], refr["change"], list(refr["change"])))


def judged(numbers: dict, cell) -> dict:
    """``numbers`` with the verdict on them against the cell's limits."""
    correct, _ = verdict(numbers, cell.workload["limits"])
    return dict(numbers, correct=correct)


def train_readings(cell, seed: int, device, control: bool, fault: str) -> dict:
    import tensorf_tpu_torch.train.step as step_mod
    inner = step_mod.mse_loss
    if fault == "half_batch":
        step_mod.mse_loss = half_batch_mse
    try:
        s = R.setup(cell, seed, device)
        if fault == "altered_row":
            alter_rows(s.state)
        tr = R.Trainer(s, seed, device)
        kept, losses, grad1, p3 = R.checked_steps(tr, int(cell.traffic["checked_steps"]))
    finally:
        step_mod.mse_loss = inner
    change = {k: float((p3[k] - s.p0[k]).norm()) for k in p3}
    prog = dict(losses=losses, grad1=grad1, change=change)
    tr = None
    gap, chk = R.train_check(cell, s, kept)
    refr = R.follow(chk, device)
    res = {"program": judged(dict(train_numbers(prog, refr), store_gap=gap), cell),
           "detail": detail(prog, refr)}
    if control:
        ctrl = R.follow(chk, device, ref.Precision(tf32=True))
        # the control reads the port's store rows as the port does
        res["control"] = judged(dict(train_numbers(ctrl, refr), store_gap=gap), cell)
        res["control_detail"] = detail(ctrl, refr)
    return res


def serve_readings(cell, seed: int, device, control: bool) -> dict:
    sv = R.serving(cell, seed, device)
    served = [R.serve_view(sv, k) for k in (1, 2)]
    sv = sv._replace(handle=None)
    chk = R.serve_check(cell, sv, served, [0, 1], device)
    res = {"program": judged(serve_numbers(chk.model, chk.P, chk.geom, chk.views,
                                           ref.Precision(), chk.block), cell)}
    if control:
        ctrl = []
        with torch.no_grad():
            for rays, _, _ in chk.views:
                outs = [ref.render(chk.model, chk.P, chk.geom, rays[a:a + chk.block],
                                   ref.Masks(), ref.Precision(tf32=True))
                        for a in range(0, rays.shape[0], chk.block)]
                ctrl.append((rays, torch.cat([o.rgb for o in outs]).cpu().numpy(),
                             torch.cat([o.depth for o in outs]).cpu().numpy()))
        res["control"] = judged(serve_numbers(chk.model, chk.P, chk.geom, ctrl,
                                              ref.Precision(), chk.block), cell)
    return res


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control", type=int, default=0,
                        help="run the control on the first N seeds")
    parser.add_argument("--fault", default="", choices=("", "half_batch", "altered_row"))
    args = parser.parse_args(argv)
    cell = R.load_cell(args.workload)
    R.set_cache_dirs()
    if not torch.cuda.is_available():
        R.log("no CUDA device")
        return 2
    from tensorf_tpu_torch.utils.device import resolve_device
    device = resolve_device("cuda")
    for n, seed in enumerate(int(x) for x in args.seeds.split(",")):
        t0 = time.perf_counter()
        control = n < args.control
        if cell.traffic["kind"] == "train":
            res = train_readings(cell, seed, device, control, args.fault)
        else:
            res = serve_readings(cell, seed, device, control)
        torch.cuda.empty_cache()
        print(json.dumps(dict(workload=args.workload, seed=seed, fault=args.fault,
                              seconds=time.perf_counter() - t0, **res)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
