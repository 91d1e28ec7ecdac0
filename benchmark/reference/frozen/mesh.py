"""One process's stand-ins for the collectives and row draws that the
frozen modules call: the reference always runs as a world of one."""

from __future__ import annotations

import torch


def world() -> int:
    return 1


def rank() -> int:
    return 0


def shard_batch(batch, n_global=None):
    return batch


def rand_rows(gen, shape, device=None) -> torch.Tensor:
    return torch.rand(tuple(shape), generator=gen, device=device)


def base_generator(gen):
    return gen


def all_reduce_(t):
    return t


def all_reduce_grads(params):
    return None
