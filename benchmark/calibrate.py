"""Readings that the comparison's limits are set from, on one card.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 --control-seeds 4,5,6 [--flops] [--out FILE]

For each seed of --seeds: the seed's weights, one clip of the cell's
traffic through the cell's node at its widgets (the timed path, warmed
up first), and the comparison's numbers against the plain reference.
For each seed of --control-seeds: the control, the reference in the
precision below the configuration's in the program's place
(`session.CONTROL`: float8 e4m3 for bf16, TF32 for float32), read the
same way against the float32 reference. With --flops, the conv, linear and
matmul FLOPs of the float32 reference on the first seed's clip
(`torch.utils.flop_counter`), the count `mfu_pct` reads from
`benchmark/counts/<cell>.json`. Prints one JSON line; --out writes it too.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--flops", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    from benchmark.core import session

    session.set_cache_dirs()
    import torch

    from benchmark.core import compare, traffic

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    spec = session.cell_spec(session.manifest(), args.workload)
    w = session.widgets(spec)
    kind = spec.mix["node"]
    control = session.CONTROL[spec.config["precision"]]
    nodes = importlib.import_module(session.PACKAGE + ".nodes")
    out = {"workload": args.workload, "card": torch.cuda.get_device_name(dev), "control_precision": control,
           "program": {}, "control": {}}

    def seeded(seed):
        session.clear_program_caches()
        folder = tempfile.mkdtemp(prefix="propainter-calib-")
        session.write_seed_weights(seed, dev, folder)
        return folder, traffic.inputs(spec.mix, w, seed, 0)

    for seed in [int(s) for s in args.seeds.split(",") if s]:
        folder, (image, mask) = seeded(seed)
        try:
            node = (nodes.ProPainterInpaint if kind == "inpaint" else nodes.ProPainterOutpaint)(device=dev)
            session.call_node(node, kind, image, mask, w)  # warm-up
            t0 = time.perf_counter()
            res = session.call_node(node, kind, image, mask, w)
            t1 = time.perf_counter()
            del node
            session.clear_program_caches()
            params = session.reference_params(folder, dev)
            ref = session.reference(kind, params, image, mask, w, dev)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            nums = compare.numbers(kind, res, ref, detail=True)
            nums.update(program_s=t1 - t0, reference_s=t2 - t1)
            if args.flops and "flops" not in out:
                from torch.utils.flop_counter import FlopCounterMode

                with FlopCounterMode(display=False) as fc:
                    session.reference(kind, params, image, mask, w, dev)
                out["flops"] = {"model_flops_per_clip": fc.get_total_flops(),
                                "by_op": {str(k): v for k, v in fc.get_flop_counts().get("Global", {}).items()}}
            out["program"][seed] = nums
            print(f"program seed {seed}: {nums}", file=sys.stderr, flush=True)
        finally:
            shutil.rmtree(folder, ignore_errors=True)
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        folder, (image, mask) = seeded(seed)
        try:
            params = session.reference_params(folder, dev)
            t0 = time.perf_counter()
            ref = session.reference(kind, params, image, mask, w, dev)
            ctl = session.reference(kind, params, image, mask, w, dev, precision=control)
            nums = compare.numbers(kind, ctl, ref, detail=True)
            nums.update(seconds=time.perf_counter() - t0)
            out["control"][seed] = nums
            print(f"control seed {seed}: {nums}", file=sys.stderr, flush=True)
        finally:
            shutil.rmtree(folder, ignore_errors=True)
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
