"""The pretrainer's batch on the host: assemble_vis_batch and batch_to_device,
a step's mean (host clock after a synchronise)."""

from benchmark.metrics._read import span_ms


def read(run):
    return span_ms(run, "batch")
