"""The two readings each limit of a cell is set from, on the chip at the
cell's own size, in one process (set-up is long):

- the program's numbers over a dozen seeds or more (`--seeds`), each a run
  of the cell's driver with a short window (`--seconds`);
- the control's over three seeds or more (`--control-seeds`): the
  reference in the next precision below the configuration's
  (`reference.arith.CONTROL`: TF32 for float32, fp8 for the kernels' bf16
  operands) put in the program's place;
- for a training cell, the fault "half of the batch left out, the mean
  taken over the rest", planted in the reference put in the program's
  place, on the control's seeds ("a state left unchanged" reads 1 by the
  change measure and needs no run).

    python3 -m benchmark.calibrate --workload <cell> --seeds 1,2,... --control-seeds 7,8,9

Prints one JSON line: every reading, and per number the largest program
reading (the lower) and the smallest control or fault reading (the upper).
"""

import argparse
import json
import sys

import torch

from benchmark import core, run
from benchmark.reference.arith import CONTROL


def half_batch(cfg, weights, batches, seeds, device):
    from benchmark.drivers.train import reference_run
    half = [{k: v[:len(v) // 2] for k, v in b.items()} for b in batches]
    return reference_run(cfg, weights, half, seeds, device)[0]


def control_train(cfg, weights, batches, seeds, device):
    from benchmark.drivers.train import reference_run
    return reference_run(cfg, weights, batches, seeds, device, CONTROL)[0]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", required=True)
    p.add_argument("--seconds", type=float, default=3)
    args = p.parse_args(argv)
    cell, config, traffic, _ = core.find_cell(args.workload)
    if not torch.cuda.is_available():
        core.log("calibration runs on the chip")
        return 2
    device = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    driver = run.driver_of(traffic)
    train = traffic["driver"] == "train"

    def one(seed, mode):
        ns = argparse.Namespace(workload=args.workload, seed=seed, seconds=args.seconds, trace=0)
        ctx = run.make_context(ns, cell, config, traffic, device)
        if mode == "control":
            if train:
                ctx.stand_in = control_train
            else:
                ctx.arith = CONTROL
        elif mode == "half_batch":
            ctx.stand_in = half_batch
        out = driver.run(ctx)
        core.log(f"{mode} seed {seed}: " + json.dumps(out["checks"]))
        return out["checks"]

    readings = {"program": {s: one(int(s), "program") for s in args.seeds.split(",")}}
    control = [int(s) for s in args.control_seeds.split(",")]
    readings["control"] = {s: one(s, "control") for s in control}
    if train:
        readings["half_batch"] = {s: one(s, "half_batch") for s in control}
    names = list(next(iter(readings["program"].values())))
    summary = {}
    for n in names:
        lower = max(r[n] for r in readings["program"].values())
        uppers = {mode: min(r[n] for r in readings[mode].values())
                  for mode in readings if mode != "program"}
        summary[n] = {"lower": lower, **{f"upper_{m}": v for m, v in uppers.items()}}
    print(json.dumps({"workload": args.workload, "card": torch.cuda.get_device_name(0),
                      "summary": summary, "readings": readings}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
