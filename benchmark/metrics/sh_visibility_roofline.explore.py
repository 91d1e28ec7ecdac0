"""B3's share of its roofline over the traced poses, at the scorer's (C_pad,
1, seq_len) shapes."""

from benchmark.metrics._read import roofline


def read(run):
    return roofline(run, "sh_bound_s", ("sh_visibility_kernel",))
