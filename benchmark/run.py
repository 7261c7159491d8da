"""Run one cell of BENCHMARK.json on one NVIDIA H100 and print one JSON line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (weights from the seed, written as the nodes' checkpoint caches
under TMPDIR; the kernels built or loaded from build/kernels/; two
warm-up clips), then a closed loop of one client calling the cell's
ComfyUI node clip after clip for --seconds, then the comparison of
sampled clips with the plain reference. With --trace 1 the window runs
with blocking stage timers and two more clips run under torch.profiler;
the line then carries the per-layer metrics. Without a CUDA device, or
with JAX loaded, the run prints no result and exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from benchmark.core import session

    try:
        result, checks = session.run(args)
    except session.NoResult as e:
        print(f"no result: {e}", file=sys.stderr)
        return 2
    print(last_line(result, checks), flush=True)
    return 0


def last_line(result: dict, checks: dict) -> str:
    """Print each compared number beside its limit as the last lines on
    standard error; return the result's JSON line, `checks` its last key."""
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    return json.dumps({**{k: v for k, v in result.items() if k != "checks"}, "checks": checks})


if __name__ == "__main__":
    sys.exit(main())
