"""What every driver of the benchmark shares: random weights from the seed,
the window's clock and spans, the profiler's reading, and statistics.

Nothing here imports the measured program; the drivers do."""

from __future__ import annotations

import math
import time
from typing import Dict, List, Optional

import torch
import torch.nn as nn

# The generator streams a run draws from: one for the weights, one for the
# program's own draws, one for the check's sample. Each is seeded from the
# run's seed and its stream number, so the weights do not depend on what
# the program draws.
WEIGHTS_STREAM, PROGRAM_STREAM, CHECK_STREAM = 1, 2, 3


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit seed of its own for each stream of a run's seed."""
    return (int(seed) * 1_000_003 + stream * 7_919) % (2 ** 63 - 1)


def generator(device, seed: int, stream: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        stream_seed(seed, stream))


def _is_norm(module: nn.Module) -> bool:
    return "norm" in type(module).__name__.lower()


def fill_weights(module: nn.Module, gen: torch.Generator) -> nn.Module:
    """Random float32 weights for every parameter of ``module``, made on
    the generator's device in two draws: every weight of two or more
    dimensions from one normal draw, scaled to He's variance 2 / fan_in;
    every other parameter outside a normalisation layer from one uniform
    draw in +-1 / sqrt(fan_in) of the layer it belongs to. Normalisation
    layers keep their ones and zeros. Two modules with the same parameter
    names and shapes get the same weights from the same generator state."""
    weights, others = [], []
    for m in module.modules():
        if _is_norm(m):
            continue
        fan = None
        for name, p in m.named_parameters(recurse=False):
            if p.dim() >= 2:
                weights.append(p)
                fan = p[0].numel()
        for name, p in m.named_parameters(recurse=False):
            if p.dim() < 2:
                others.append((p, fan or p.numel()))
    dev = gen.device
    with torch.no_grad():
        z = torch.randn(sum(p.numel() for p in weights), generator=gen,
                        device=dev)
        at = 0
        for p in weights:
            n = p.numel()
            p.copy_(z[at:at + n].view_as(p) * math.sqrt(2.0 / p[0].numel()))
            at += n
        u = torch.rand(sum(p.numel() for p, _ in others), generator=gen,
                       device=dev)
        at = 0
        for p, fan in others:
            n = p.numel()
            p.copy_((2.0 * u[at:at + n] - 1.0).view_as(p) / math.sqrt(fan))
            at += n
    return module


def centre_occupancy(occ: nn.Module) -> nn.Module:
    """SconeOcc's output layer after ``fill_weights``: its weights scaled by
    a tenth and its bias 0.5, so that the random field reads occupancies
    around gelu(0.5) = 0.35 with a spread, above the samplers' 0.1, as a
    trained field does where it is unsure. Left as drawn, the field of
    one seed may read under 0.1 everywhere and the scorers then sample
    nothing, which would change the work from seed to seed."""
    with torch.no_grad():
        occ.Dense_2.weight.mul_(0.1)
        occ.Dense_2.bias.fill_(0.5)
    return occ


def network_weights(seed: int, device, occ, vis, depth=None):
    """Random weights for SconeOcc, SconeVis and, if given, ManyDepth, in
    that order from the weights' stream of ``seed``; the program's networks
    and the reference's frozen copies get the same. A driver passes the
    run's seed, or the configuration's ``torch_seed`` where the weights
    set the work (a closed loop's path)."""
    gen = generator(device, seed, WEIGHTS_STREAM)
    for net in (occ, vis, depth):
        if net is not None:
            fill_weights(net, gen)
    centre_occupancy(occ)


def quantile(values: List[float], q: float) -> float:
    """The q-quantile of ``values`` by linear interpolation (numpy's
    default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = q * (len(xs) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


class StopWindow(Exception):
    """Raised from a program's hook to end the measured window."""


class Clock:
    """The window's host clock and its spans. In a traced run every mark
    synchronises the card first, so a span holds the device work of its
    layer; in an untraced run nothing synchronises."""

    def __init__(self, sync: bool):
        self.sync = sync
        self.spans: Dict[str, List[float]] = {}

    def now(self) -> float:
        if self.sync and torch.cuda.is_available():
            torch.cuda.synchronize()
        return time.perf_counter()

    def span(self, name: str, seconds: float):
        self.spans.setdefault(name, []).append(seconds)


class Tracer:
    """``torch.profiler`` over a short steady stretch of the window: the
    driver opens it before a unit of work and closes it after the last
    unit it wants traced. ``mark`` labels host ranges ("bench.<layer>"),
    which name the device's idle gaps. Without tracing every call is a
    no-op."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None
        self.window_s = None
        self._t0 = None
        self.done = False
        # Seconds that stopping took: the profiler's processing of its
        # events, which is no work of the program.
        self.stop_s = 0.0

    def warm(self):
        """Start and stop the profiler once, in set-up: its first start
        takes seconds (CUPTI's), which would fall into the window."""
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def start(self):
        if not self.enabled or self.prof is not None or self.done:
            return
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self):
        if self.prof is None or self.done:
            return
        torch.cuda.synchronize()
        t = time.perf_counter()
        self.window_s = t - self._t0
        self.prof.__exit__(None, None, None)
        self.stop_s = time.perf_counter() - t
        self.done = True

    @property
    def active(self) -> bool:
        return self.prof is not None and not self.done

    def mark(self, name: Optional[str]):
        """Close the host range the last mark opened and open ``name``
        (None: open none)."""
        if getattr(self, "_range", None) is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        if name is not None and self.active:
            self._range = torch.profiler.record_function(name)
            self._range.__enter__()

    def reading(self, top: int = 10) -> Optional[dict]:
        """busy_s (the union of the device's operations, seconds), window_s,
        the operations that took most time and the longest idle gaps, each
        named by the innermost annotated host range over its start."""
        if not self.done:
            return None
        dev_iv, ops, host = [], {}, []
        for e in self.prof.profiler.kineto_results.events():
            kind = str(e.device_type())
            start = e.start_ns() / 1e9
            dur = e.duration_ns() / 1e9
            if kind.endswith("CUDA"):
                # Annotated host ranges (the benchmark's and the
                # program's) are mirrored on the device's timeline; they
                # are no operation.
                if (dur <= 0 or e.name().startswith("bench.")
                        or annotation(e)):
                    continue
                dev_iv.append((start, start + dur))
                ops[e.name()] = ops.get(e.name(), 0.0) + dur
            elif e.name().startswith("bench."):
                host.append((start, start + dur, e.name()[len("bench."):]))
        if not dev_iv:
            return {"busy_s": 0.0, "window_s": self.window_s,
                    "device_ops": [], "idle_gaps": []}
        dev_iv.sort()
        merged = [list(dev_iv[0])]
        for a, b in dev_iv[1:]:
            if a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        busy = sum(b - a for a, b in merged)
        gaps = []
        for (_, b0), (a1, _) in zip(merged, merged[1:]):
            inner = [h for h in host if h[0] <= b0 < h[1]]
            name = (min(inner, key=lambda h: h[1] - h[0])[2] if inner
                    else "host")
            gaps.append((name, a1 - b0))
        gaps.sort(key=lambda g: -g[1])
        return {
            "busy_s": busy, "window_s": self.window_s,
            "device_ops": [[k, v] for k, v in sorted(
                ops.items(), key=lambda kv: -kv[1])[:top]],
            "idle_gaps": [[n, s] for n, s in gaps[:top]],
            "device_time_by_op": ops,
        }


def annotation(event) -> bool:
    """Whether a profiler event is a user's annotation of a range."""
    fn = getattr(event, "is_user_annotation", None)
    return bool(fn()) if fn is not None else False


class Patches:
    """The benchmark's wrappers around the program's functions, set on
    their modules for one run and taken off before the check."""

    def __init__(self):
        self._undo = []

    def set(self, obj, name: str, value):
        self._undo.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def restore(self):
        for obj, name, old in reversed(self._undo):
            setattr(obj, name, old)
        self._undo.clear()
