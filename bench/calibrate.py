"""Readings that set a cell's limits: the program's widest served-token
gap and the control's, on many seeds, in one process.

    python3 bench/calibrate.py --workload <name> --seconds <s> --seeds 1 2 3

Each seed is one whole run of the cell (the window at the cell's own
load and length), after which the sample a run compares is read twice:
the served tokens against the float32 reference (the program's
readings, ``max_logit_gap`` and ``mean_logit_gap``) and the token the
float8 control puts first against the same reference (the control's).
For an MoE both follow the program's recorded routing; the control's
route numbers come from its own routing, and the gaps of each side
routing by itself are read too (``unforced``, ``control_unforced``).
Prints one JSON line a seed.  The benchmark's runs never run this.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path[:0] = [str(Path(__file__).resolve().parents[1] / p)
                for p in ("", "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bench/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import io
    import torch
    from bench.harness import cell as cell_run
    from bench.harness import check, spec
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = spec.resolve(args.workload)
    t = T_START
    for seed in args.seeds:
        log = io.StringIO()
        res = cell_run.run(cell, seed, args.seconds, False, "cuda", t,
                           log=log, control=True)
        info = json.loads(log.getvalue().splitlines()[0][5:])
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "program": {k: info[k] for k in check.NUMBERS
                        + check.ROUTE_NUMBERS if k in info},
            "control": info.get("control"),
            "metrics": {k: v["value"] for k, v in res["metrics"].items()},
            "memory_peak_bytes": res["device"]["memory_peak_bytes"],
            "info": info}), flush=True)
        del res
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
