"""The pretrainer's step on the card: vis_loss, optimizer_step and the loss's
value, a step's mean."""

from benchmark.metrics._read import span_ms


def read(run):
    return span_ms(run, "step")
