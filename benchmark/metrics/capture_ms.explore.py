"""The move's capture (B1 + B2), true coverage and the supervision frames'
depth and mapping: the span from "capture" to "done", a pose's mean."""

from benchmark.metrics._read import span_ms


def read(run):
    return span_ms(run, "capture")
