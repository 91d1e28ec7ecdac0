"""The window's model FLOPs (ManyDepth, SconeOcc, SconeVis, B3) over its
length at the card's float32 peak."""

from benchmark.metrics._read import mfu


def read(run):
    return mfu(run)
