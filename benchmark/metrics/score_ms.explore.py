"""The NBV scorer (candidates, SconeVis, B3): the span from "score" to
"capture", a pose's mean."""

from benchmark.metrics._read import span_ms


def read(run):
    return span_ms(run, "score")
