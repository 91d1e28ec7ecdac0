"""Losses of the SCONE training objectives (port of
macarons_tpu/models/losses.py): the coverage-distribution losses and the
occupancy MSE."""

from __future__ import annotations

import torch

EPS = 1e-7


def kl_div_ce(x, y):
    """KL divergence after a softmax over the camera axis. x, y (batch,
    n_camera, 1): predicted and target coverage distributions."""
    log_px = torch.log_softmax(x, dim=1)
    py = torch.softmax(y, dim=1)
    log_py = torch.log_softmax(y, dim=1)
    kl = torch.sum(py * (log_py - log_px), dim=1)
    return torch.mean(torch.sum(kl, dim=-1))


def l1_normalized(x, y):
    """L1 between mean/std-normalised coverage distributions."""
    nx = (x - x.mean(dim=1, keepdim=True)) / (x.std(dim=1, keepdim=True) + EPS)
    ny = (y - y.mean(dim=1, keepdim=True)) / (y.std(dim=1, keepdim=True) + EPS)
    return torch.mean(torch.mean(torch.abs(nx - ny), dim=1))


def uncentered_l1(x, y):
    """L1 between mean-normalised (uncentered) distributions: the coverage
    gain loss of MACARONS."""
    nx = x / (x.mean(dim=1, keepdim=True) + EPS)
    ny = y / (y.mean(dim=1, keepdim=True) + EPS)
    return torch.mean(torch.mean(torch.abs(nx - ny), dim=1))


def occupancy_mse(pred, target, mask=None):
    """MSE over query points; ``mask`` marks the points counted."""
    err = (pred - target) ** 2
    if mask is None:
        return torch.mean(err)
    m = mask[..., None] if mask.dim() == err.dim() - 1 else mask
    err = torch.where(m, err, 0.0)
    denom = torch.clamp(mask.sum(), min=1)
    return err.sum() / (denom * err.shape[-1])
