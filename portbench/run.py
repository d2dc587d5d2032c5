"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's configuration, traffic, driver, metrics and limits are found by
the names in BENCHMARK.json (pbcore/spec.py). The run needs a CUDA card:
without one, or with fewer cards than the cell asks for, it exits with
code 2 and prints no result. The last line of standard output is the
result: one JSON object with correct, attempted, failed, metrics, device
(with --trace 1 busy_s and window_s), breakdown (--trace 1), calibration
(the fusion's mode and weights as the reference worked them out) and,
last, compare (each number judged, with its limit); the judged numbers
are also the last lines of standard error. A run that loaded jax, jaxlib,
flax, optax or the JAX package (whole top-level names) exits with code 3
and prints no result.

Build and kernel caches stay inside the checkout (build/): the port builds
its kernels into build/kernels and its native code into build/native;
TORCH_EXTENSIONS_DIR and TRITON_CACHE_DIR point under build/ too.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent


def environment() -> None:
    """Caches under the checkout; the configuration is the cell's file
    alone (no RADIANT_<SECTION>_<FIELD> override); no library loads JAX."""
    build = CHECKOUT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    for key in [k for k in os.environ if k.startswith("RADIANT_")]:
        del os.environ[key]
    for p in (str(CHECKOUT), str(HERE)):
        if p not in sys.path:
            sys.path.insert(0, p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    environment()
    import torch

    from pbcore import cell as pbcell
    from pbcore import spec

    entry = spec.Cell(args.workload).entry
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(entry["chips"]):
        print(f"portbench: the cell needs {entry['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    out = pbcell.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                          torch.device("cuda"), T_START)
    bad = pbcell.forbidden_modules()
    if bad:
        print(f"portbench: loaded forbidden modules: {', '.join(bad)}", file=sys.stderr)
        return 3
    print(f"calibration {json.dumps(out.line['calibration'])}", file=sys.stderr)
    for name, c in out.compare.items():
        print(f"compare {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out.line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
