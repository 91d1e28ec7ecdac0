"""Losses of the SCONE training objectives (port of
macarons_tpu/models/losses.py): the coverage-distribution losses and the
occupancy MSE."""

from __future__ import annotations

import torch

EPS = 1e-7


def uncentered_l1(x, y):
    """L1 between mean-normalised (uncentered) distributions: the coverage
    gain loss of MACARONS."""
    nx = x / (x.mean(dim=1, keepdim=True) + EPS)
    ny = y / (y.mean(dim=1, keepdim=True) + EPS)
    return torch.mean(torch.mean(torch.abs(nx - ny), dim=1))
