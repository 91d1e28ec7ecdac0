"""One run of one cell: find the cell, its configuration, its traffic mix
and its metrics by name, drive the set-up, the window and the check, and
print the result line.

A cell is an entry of ``workloads`` in BENCHMARK.json. Its configuration is
the file that BENCHMARK.json names; its traffic mix is
``benchmark/traffic/<traffic>.json``, whose ``driver`` names the module of
``benchmark/drivers/`` that runs that kind of job; each per-layer metric is
read by ``benchmark/metrics/<metric>.py``. Adding a cell, a mix or a metric
adds files and entries and edits none."""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
from typing import Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)

# Modules that no run may hold once its window has closed, compared by
# whole top-level names (the program's own name begins with the last).
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "macarons_tpu")


@dataclasses.dataclass
class Context:
    """What a driver gets: the cell, its configuration and traffic, the
    run's arguments, the device and a work directory of its own."""

    name: str
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    work_dir: str
    # Planted faults (``benchmark/controls.py``, the tests); none in a run.
    faults: tuple = ()


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_entry(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")


def config_of(bench: dict, cell: dict, root: str = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == cell["config"]:
            with open(os.path.join(root, c["file"])) as f:
                return json.load(f)
    raise SystemExit(f"no configuration named {cell['config']!r}")


def traffic_of(cell: dict) -> dict:
    with open(os.path.join(BENCH_DIR, "traffic",
                           cell["traffic"] + ".json")) as f:
        return json.load(f)


def driver_of(traffic: dict):
    return importlib.import_module("benchmark.drivers." + traffic["driver"])


def metrics_of(bench: dict, name: str):
    """The cell's end-to-end metrics, and its per-layer metrics: those
    that list it, or that list no cell and move one of its end-to-end
    metrics."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if name in m.get("workloads", ())
             or ("workloads" not in m and m["moves"] in names)]
    return e2e, layer


def read_layer_metric(name: str, run: dict) -> Optional[float]:
    path = os.path.join(BENCH_DIR, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(run)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def disk_written() -> str:
    """What this process has written so far, from /proc/self/io: the bytes
    of its write calls (``wchar``) and those sent to storage
    (``write_bytes``)."""
    try:
        with open("/proc/self/io") as f:
            io = dict(line.split(":") for line in f if ":" in line)
    except OSError:
        return "unknown"
    return (f"{int(io.get('wchar', -1))} through write calls, "
            f"{int(io.get('write_bytes', -1))} to storage")


def device_info(torch, count: int, peak: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count, "memory_peak_bytes": int(peak)}


def run(args, t_process: float) -> int:
    import torch

    bench = load_benchmark()
    cell = cell_entry(bench, args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs only on the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{cell['name']} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    result = execute(bench, cell, int(args.seed), float(args.seconds),
                     bool(args.trace), torch.device("cuda"), t_process)
    if result is None:
        return 3
    print(f"disk: the run wrote {disk_written()}", file=sys.stderr)
    print(f"host: {torch.get_num_threads()} torch threads, "
          f"{os.cpu_count()} cores", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


def execute(bench, cell, seed, seconds, trace, device, t_process,
            faults=(), sizes=None) -> Optional[dict]:
    """Set-up, window and check of one cell on ``device``; returns the
    result line's object, or None when a forbidden module was loaded.
    The tests drive it on the CPU at a small size, past the look for a
    card, with ``sizes`` over the configuration's and the traffic's keys
    and faults planted in the program."""
    import torch

    e2e, layer = metrics_of(bench, cell["name"])
    cuda = device.type == "cuda"
    with drive(bench, cell, seed, seconds, trace, device, faults,
               sizes) as (ctx, driver, state, out):
        setup_s = out["setup_end"] - t_process
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        found = forbidden_modules()
        if found:
            print(f"the run loaded {', '.join(found)}", file=sys.stderr)
            return None
        checks = driver.check(ctx, state, out)
    info = (device_info(torch, cell["chips"], peak) if cuda else
            {"platform": "cpu", "kind": "cpu", "count": 0,
             "memory_peak_bytes": 0})
    for name, t in sorted(out["run"]["spans"].items()):
        print(f"span {name}: {sum(t):.4f} s over {len(t)}", file=sys.stderr)
    return result_line(e2e, layer, out, checks, setup_s, info, trace)


@contextlib.contextmanager
def drive(bench, cell, seed, seconds, trace, device, faults=(), sizes=None):
    """The cell's set-up and window in a work directory of its own, which
    goes when the block ends; yields (context, driver, state, window's
    output, with the set-up's end on the host clock as "setup_end")."""
    import torch

    sizes = sizes or {}
    traffic = dict(traffic_of(cell), **sizes.get("traffic", {}))
    driver = driver_of(traffic)
    cuda = device.type == "cuda"
    work = tempfile.mkdtemp(prefix="macarons_bench_")
    try:
        ctx = Context(name=cell["name"], cell=cell,
                      config=dict(config_of(bench, cell),
                                  **sizes.get("config", {})),
                      traffic=traffic,
                      seed=seed, seconds=seconds, trace=trace, device=device,
                      work_dir=work, faults=tuple(faults))
        state = driver.setup(ctx)
        if cuda:
            torch.cuda.synchronize()
        setup_end = time.perf_counter()
        out = driver.window(ctx, state)
        if cuda:
            torch.cuda.synchronize()
        out["setup_end"] = setup_end
        yield ctx, driver, state, out
    finally:
        shutil.rmtree(work, ignore_errors=True)


def result_line(e2e, layer, out, checks, setup_s, device, trace) -> dict:
    """The result line: with ``trace`` the per-layer metrics, else the
    end-to-end ones; the compared numbers beside their limits last."""
    values = dict(out["metrics"], setup_s=setup_s)
    metrics = {}
    if trace:
        for m in layer:
            v = read_layer_metric(m["name"], out["run"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        reading = out["run"].get("trace") or {}
        device = dict(device, busy_s=reading.get("busy_s", 0.0),
                      window_s=reading.get("window_s", 0.0))
    else:
        for m in e2e:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    correct = (out["failed"] == 0
               and all(c["value"] <= c["limit"] for c in checks))
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": device}
    if trace and out["run"].get("trace"):
        t = out["run"]["trace"]
        result["breakdown"] = {"device_ops": t["device_ops"],
                               "idle_gaps": t["idle_gaps"]}
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                        for c in checks}
    return result
