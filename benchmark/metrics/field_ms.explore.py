"""The occupancy field (SconeOcc over the proxies' cells, kNN): the span from
"field" to "score", a pose's mean."""

from benchmark.metrics._read import span_ms


def read(run):
    return span_ms(run, "field")
