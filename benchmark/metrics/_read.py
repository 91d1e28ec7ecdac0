"""What the per-layer metric readers share. A reader gets the run's record
(``run``: its spans in seconds by name, its units of work, the window's
length, the model FLOPs of its recorded calls, and the traced stretch's
reading) and returns its number, or None where the run holds nothing for
it to read. A share of a roofline or of a peak is never made up: without
device time there is no number."""

from __future__ import annotations

from benchmark import flops as F


def span_ms(run, name):
    """A span's mean over the window, in milliseconds."""
    spans = run["spans"].get(name)
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)


def device_s(run, kernels):
    """The traced stretch's device seconds in operations whose name holds
    one of ``kernels``."""
    t = run.get("trace")
    if not t:
        return None
    s = sum(v for k, v in t["device_time_by_op"].items()
            if any(name in k for name in kernels))
    return s or None


def roofline(run, bound_key, kernels):
    """The least time the traced launches of a kernel could take at the
    card's peaks, over the device time of ``kernels``, the launches'
    kernels, in percent."""
    t = run.get("trace")
    spent = device_s(run, kernels)
    if spent is None or not t.get(bound_key):
        return None
    return 100.0 * t[bound_key] / spent


def idle_share(run):
    """The share of the traced stretch in which no operation ran on the
    card, in percent."""
    t = run.get("trace")
    if not t or not t["window_s"] or not t["busy_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def mfu(run):
    """The window's model FLOPs over its length at the card's float32
    peak, in percent."""
    if not run.get("model_flops") or not run.get("window_s"):
        return None
    return 100.0 * run["model_flops"] / (run["window_s"] * F.PEAK_FP32_FLOPS)
