"""The trainer's learning-rate schedule (the JAX trainer's
``MacaronsRuntime._warmup_rate``), as a plain function of the step."""

from __future__ import annotations


def warmup_rate(max_lr: float, step: int, warmup: int) -> float:
    """WarmupConstantOpt: steps count from 1, lr = max_lr min(1, step /
    warmup)."""
    return max_lr * min(1.0, step / max(warmup, 1))
