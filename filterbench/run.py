"""Run one cell of the benchmark of ``mfs_tpu_torch`` once.

    python3 filterbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds the port (``mfs_tpu_torch``).
The cell's observations are sampled on the card from ``--seed``; set-up
builds the port's filter and warms up the cell's shapes; the window runs
whole study passes back to back until ``--seconds`` have passed
(``--trace 0``), or one pass after an untraced one under
``torch.profiler`` (``--trace 1``); then a sample of the answers is
recomputed by the plain reference and compared.  The last line of
standard output is the result as one JSON object; the numbers compared
and their limits are the last lines of standard error.  Exits non-zero,
printing no result, without enough CUDA devices, or if JAX or the JAX
package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

from harness import runner  # noqa: E402


def _plain(x):
    """JSON has no infinity: a non-finite number is written as a string."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_plain(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return repr(x)
    return x


def emit(result: dict, out=None, err=None) -> None:
    """The run's records on standard error, then each compared number
    beside its limit as the last lines there, and the result as the last
    line of standard output, its ``check`` key last."""
    out, err = out or sys.stdout, err or sys.stderr
    result = dict(result)
    records = result.pop("records")
    check = result.pop("check")
    result["check"] = check
    print(f"filterbench: records {json.dumps(_plain(records))}", file=err)
    for name, v in check.items():
        print(f"check {name}: {v['value']!r} limit {v['limit']!r}", file=err)
    err.flush()
    print(json.dumps(_plain(result)), file=out, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result = runner.run(args.workload, args.seed, args.seconds, bool(args.trace), T_START)
    except runner.NoDevice as e:
        print(f"filterbench: {e}", file=sys.stderr)
        return 2
    found = runner.forbidden_modules()
    if found:
        print(f"filterbench: loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
