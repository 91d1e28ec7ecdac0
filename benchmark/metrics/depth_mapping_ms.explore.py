"""ManyDepth's depth of the decision's frames and the mapping update: the
tester's span from its "decision" to its "field" boundary, a pose's mean."""

from benchmark.metrics._read import span_ms


def read(run):
    return span_ms(run, "depth_mapping")
