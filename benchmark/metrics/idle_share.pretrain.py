"""The card's idle share over the traced steps."""

from benchmark.metrics._read import idle_share


def read(run):
    return idle_share(run)
