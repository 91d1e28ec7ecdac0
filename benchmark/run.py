"""The benchmark of macarons_tpu_torch, the PyTorch and CUDA port: one run
of one cell on the card it is started on.

Usage: python3 benchmark/run.py --workload <cell> --seed <n>
           --seconds <s> --trace <0|1>

It makes its inputs and weights from the seed, warms up the cell's shapes,
measures for the given seconds, checks what the timed path produced
against the plain reference in benchmark/reference/, and prints one JSON
line. With ``--trace 1`` it reports the cell's per-layer metrics instead
of its end-to-end ones. Without a CUDA card it exits with code 2 and
prints no result. See benchmark/README.md."""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
CACHE_DIR = os.path.join(BENCH_DIR, "_cache")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    # Compile caches at fixed paths inside the checkout, so that only a
    # cell's first run there builds; transformers, if anything loads it,
    # keeps away from JAX.
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE_DIR, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE_DIR,
                                                      "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    sys.path[:] = [ROOT] + [p for p in sys.path
                            if os.path.abspath(p or ".") not in (ROOT,
                                                                 BENCH_DIR)]
    from benchmark.harness import core

    return core.run(args, T_PROCESS)


if __name__ == "__main__":
    sys.exit(main())
