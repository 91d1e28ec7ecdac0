"""The fused tile rasterizer's (B1 + B2) share of its roofline over the traced
poses: each traced launch's least time at the card's peaks, from the pairs
and big-face lanes it tests (benchmark/flops: B1's and B2's operations and
bytes), over the device time of the launches' kernels: the work-item
table, the kernel and its epilogue, which writes the outputs."""

from benchmark.metrics._read import roofline

KERNELS = ("raster_items_kernel", "raster_tiled_kernel",
           "raster_tiled_epilogue")


def read(run):
    return roofline(run, "raster_bound_s", KERNELS)
