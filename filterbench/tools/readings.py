"""The readings a cell's limits are set from, on the card, at the cell's
own size, in one process:

- the lower readings: for each seed, one pass of the program over the
  cell's observations, sampled as a run's check samples them, against the
  float64 reference;
- the upper readings: each of the reference's ``CONTROLS`` (the reference
  in a lower precision) put in the program's place, against the float64
  reference, for the first ``--control`` seeds.

    python3 filterbench/tools/readings.py --workload <cell> --seeds 1 2 ... [--control 3]

Prints one JSON line a seed and a summary line; writes nothing.
"""
import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE), str(HERE.parent)]

import torch  # noqa: E402

from harness import check  # noqa: E402
from harness.cell import Cell  # noqa: E402
from harness.probes import Probes  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3)
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = Cell(args.workload)
    model, traffic = cell.config["model"], cell.traffic
    dev = torch.device("cuda")
    ref = cell.module("reference")
    system = cell.module("systems").System(cell.config, traffic, dev, Probes())
    rows = []
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        ys = cell.module("traffic").generate(model, traffic,
                                             torch.Generator(device=dev).manual_seed(seed))["ys"]
        out = system.run_pass(ys)
        torch.cuda.synchronize()
        row = {"seed": seed, "pass_s": time.perf_counter() - t0,
               "finite": int(out["finite"].sum()), "rerun": out.get("rerun", 0)}
        which, trials = check.sample(seed, ys.shape[1], 1, int(cell.workload["check"]["sample"]),
                                     out.get("rerun_idx", ()))
        sub = ys[:, trials.to(dev)]
        program = check.gather([out], which, trials, ref.ANSWERS)
        del out
        inputs = {k: program[k] for k in getattr(ref, "INPUTS", ())}
        t1 = time.perf_counter()
        truth = {k: v.cpu() for k, v in
                 ref.run(cell.config, traffic, sub, torch.float64, **inputs).items()}
        row["reference_s"] = time.perf_counter() - t1
        row["program"] = ref.numbers(program, truth)
        if i < args.control:
            for name, kw in ref.CONTROLS.items():
                ctl = {k: v.cpu() for k, v in ref.run(cell.config, traffic, sub, **kw).items()}
                row[name] = ref.numbers(ctl, truth)
        rows.append(row)
        print(json.dumps(row), flush=True)
        del ys, sub
    summary = {"workload": args.workload,
               "lower": {k: max(r["program"][k] for r in rows) for k in ref.NUMBERS}}
    for name in ref.CONTROLS:
        summary[name] = {k: min(r[name][k] for r in rows if name in r) for k in ref.NUMBERS}
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
