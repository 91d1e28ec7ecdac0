"""B3's backward's share of its roofline over the traced steps, at (batch, 52,
seq_len)."""

from benchmark.metrics._read import roofline


def read(run):
    return roofline(run, "sh_backward_bound_s",
                    ("sh_visibility_backward_kernel",))
