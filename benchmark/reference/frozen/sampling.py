"""Random sampling primitives (port of macarons_tpu/ops/sampling.py).

Every draw takes an explicit ``torch.Generator`` on the tensors' device.
"""

from __future__ import annotations

import torch


# A row no longer than this fits one tile of CUB's scan: its tunings
# (cub/device/dispatch/tuning/tuning_scan.cuh, CUDA 12.8) run 288 to 640
# threads a block, each with one item or more.
ONE_TILE = 256


def cumsum_rows(x):
    """Inclusive cumsum over the last dim of ``x``, the same bits in every
    run on the card.

    ``torch.cumsum`` scans a CUDA tensor that holds a single row (``x.numel()
    == x.shape[-1]``) with CUB's single-pass scan, whose look-back adds the
    partial sums of earlier tiles in an order that changes from run to run;
    a batch of rows takes PyTorch's row-scan kernel, whose order is fixed.
    So a single row longer than one tile (``ONE_TILE``) is scanned as the
    first of two copies of itself; a shorter one has no look-back and keeps
    torch.cumsum's bits. On the CPU every way gives the same bits."""
    if x.numel() != x.shape[-1] or x.shape[-1] <= ONE_TILE:
        return torch.cumsum(x, dim=-1)
    row = x.reshape(1, -1)
    return torch.cumsum(torch.cat([row, row]), dim=-1)[0].reshape(x.shape)
