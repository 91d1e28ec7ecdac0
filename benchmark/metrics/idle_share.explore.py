"""The card's idle share over the traced poses."""

from benchmark.metrics._read import idle_share


def read(run):
    return idle_share(run)
