"""The window's model FLOPs (SconeOcc forward, SconeVis forward and backward,
B3 and its backward) over its length at the card's float32 peak."""

from benchmark.metrics._read import mfu


def read(run):
    return mfu(run)
