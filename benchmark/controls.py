"""Readings that set the limits of ``correct``: for each seed, one cell's
set-up and a short window, then the compared numbers of the program, of
the control (the plain reference in TF32 in the program's place) and, with
``--faults``, of the program with those faults planted, all in one
process so that each kernel builds once.

Usage: python3 benchmark/controls.py --workload <cell> --seeds 1,2,3
           [--seconds 10] [--faults answer,half] [--no-control]
           [--torch-seed-from-seed] [--out chiprun_out/controls.jsonl]

``--torch-seed-from-seed`` sets the configuration's ``torch_seed`` to each
seed: a cell that draws its weights and its program's draws from the
configuration (explore, whose closed loop follows one path) is then read
over as many weight sets and paths as seeds.

Each seed gives one JSON line (appended to ``--out``): its seed, faults,
the program's (or the faulty program's) numbers, the control's numbers,
and the window's end-to-end metrics. The benchmark's own runs never run
this. It needs a CUDA card."""

import argparse
import gc
import json
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=10.0)
    parser.add_argument("--faults", default="")
    parser.add_argument("--no-control", action="store_true")
    parser.add_argument("--torch-seed-from-seed", action="store_true")
    parser.add_argument("--out", default=os.path.join(
        ROOT, "chiprun_out", "controls.jsonl"))
    args = parser.parse_args(argv)
    os.environ["TRITON_CACHE_DIR"] = os.path.join(BENCH_DIR, "_cache",
                                                  "triton")
    sys.path[:] = [ROOT] + [p for p in sys.path
                            if os.path.abspath(p or ".") not in (ROOT,
                                                                 BENCH_DIR)]
    import torch

    from benchmark.harness import core

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    bench = core.load_benchmark()
    cell = core.cell_entry(bench, args.workload)
    faults = tuple(f for f in args.faults.split(",") if f)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        sizes = ({"config": {"torch_seed": seed}}
                 if args.torch_seed_from_seed else None)
        with core.drive(bench, cell, seed, args.seconds, False,
                        torch.device("cuda"), faults,
                        sizes) as (ctx, driver, state, out):
            program = {c["name"]: c["value"]
                       for c in driver.check(ctx, state, out)}
            control = ({} if args.no_control else
                       {c["name"]: c["value"]
                        for c in driver.check(ctx, state, out, True)})
        line = {"workload": cell["name"], "seed": seed, "faults": faults,
                "torch_seed": ctx.config.get("torch_seed"),
                "program": program, "control": control,
                "metrics": out["metrics"], "attempted": out["attempted"],
                "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(line) + "\n")
        del state, out
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
