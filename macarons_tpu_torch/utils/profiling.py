"""Tracing and profiling (port of macarons_tpu/utils/profiling.py).

A flag-gated wall-clock timer (``TimeCheck``), per-phase durations that
wait for the card when given a tensor (``StepTimer``), a ``torch.profiler``
trace of CPU and CUDA activity written as a Chrome trace
(``profile_trace``), and per-parameter gradient norms
(``check_gradients``).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, List

import numpy as np
import torch


class TimeCheck:
    """Flag-gated wall-clock checkpoints: ``check`` prints and returns the
    seconds since the last checkpoint."""

    def __init__(self, on: bool = True):
        self.on = on
        self.t0 = time.perf_counter()

    def start(self):
        self.t0 = time.perf_counter()

    def check(self, label: str = ""):
        if self.on:
            dt = time.perf_counter() - self.t0
            print(f"[time] {label}: {dt:.4f}s")
            self.t0 = time.perf_counter()
            return dt
        return None


class StepTimer:
    """Accumulates per-phase durations. A phase given a CUDA tensor
    (``sync_array``) ends when its device has finished the work queued."""

    def __init__(self):
        self.times: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def phase(self, name: str, sync_array=None):
        t0 = time.perf_counter()
        yield
        if torch.is_tensor(sync_array) and sync_array.is_cuda:
            torch.cuda.synchronize(sync_array.device)
        self.times[name].append(time.perf_counter() - t0)

    def means(self) -> Dict[str, float]:
        return {k: sum(v) / len(v) for k, v in self.times.items() if v}

    def report(self):
        for k, m in self.means().items():
            print(f"[step-timer] {k}: {m * 1e3:.2f} ms (n={len(self.times[k])})")


@contextlib.contextmanager
def profile_trace(log_dir: str = "macarons_trace"):
    """A ``torch.profiler`` trace of the block's CPU activity and, where
    this PyTorch build can trace it, its CUDA activity, written as a Chrome
    trace ``trace_<pid>_<ns>.json`` into ``log_dir`` (open it in Perfetto
    or chrome://tracing). Yields ``log_dir``."""
    wanted = (torch.profiler.ProfilerActivity.CPU,
              torch.profiler.ProfilerActivity.CUDA)
    activities = [a for a in wanted
                  if a in torch.profiler.supported_activities()]
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def check_gradients(grads, verbose: bool = True) -> Dict[str, float]:
    """Per-parameter gradient norms: of a module's ``.grad``s, named as its
    parameters (those with a gradient), or of a dict of tensors. Prints
    the ten largest when ``verbose``."""
    if isinstance(grads, torch.nn.Module):
        grads = {n: p.grad for n, p in grads.named_parameters()
                 if p.grad is not None}
    out = {name: float(np.linalg.norm(g.detach().cpu().numpy()))
           for name, g in grads.items()}
    if verbose:
        worst = sorted(out.items(), key=lambda kv: -kv[1])[:10]
        for name, n in worst:
            print(f"[grad] {n:.3e} {name}")
    return out
