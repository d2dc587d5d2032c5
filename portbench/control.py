"""Readings that set a cell's limits: the port's numbers over many seeds and
the control's (the reference one precision lower, in the port's place).

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 1,2] [--seconds 3]

Each seed is one full run of the cell (set-up, a short window at the
cell's own load, the check) in this one process; a seed listed in
--control-seeds also judges the control on the same sampled requests and
compares its numbers with the cell's limits as a run compares the port's
(`control_correct`, which has to come out false). One JSON line per seed:
the numbers compared, the control's beside the limits, the calibration's
choice and the end-to-end metrics. The benchmark's own runs (run.py) never
run the control.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

from run import environment


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    environment()
    import torch

    from pbcore import cell as pbcell

    if not torch.cuda.is_available():
        print("portbench control: no CUDA card", file=sys.stderr)
        return 2
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = pbcell.run_cell(args.workload, seed, args.seconds, False, torch.device("cuda"),
                              t0, control=seed in controls)
        row = {"workload": args.workload, "seed": seed, "correct": out.line["correct"],
               "numbers": {k: c["value"] for k, c in out.compare.items()},
               "control_correct": out.line.get("control_correct"),
               "control": out.line.get("control"), "calibration": out.line["calibration"],
               "metrics": {k: m["value"] for k, m in out.line["metrics"].items()},
               "seconds": time.perf_counter() - t0}
        print(json.dumps(row), flush=True)
        del out
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
