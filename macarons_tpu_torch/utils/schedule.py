"""The trainer's learning-rate schedule (the JAX trainer's
``MacaronsRuntime._warmup_rate``), as a plain function of the step."""

from __future__ import annotations


def warmup_rate(max_lr: float, step: int, warmup: int) -> float:
    """WarmupConstantOpt: steps count from 1, lr = max_lr min(1, step /
    warmup)."""
    return max_lr * min(1.0, step / max(warmup, 1))


def warmup_constant_schedule(base_lr: float, warmup: int, lr_epochs=(),
                             lr_factor: float = 1.0, steps_per_epoch: int = 1):
    """The pretrainers' rate as a function of the optimizer steps taken
    before this one (optax counts from 0): base_lr min(1, (step + 1) /
    warmup), times lr_factor once for every listed epoch reached."""
    boundaries = sorted(int(e) * steps_per_epoch for e in lr_epochs)

    def schedule(step: int) -> float:
        lr = base_lr * min(1.0, (step + 1) / max(warmup, 1))
        for b in boundaries:
            if step >= b:
                lr = lr * lr_factor
        return lr

    return schedule
