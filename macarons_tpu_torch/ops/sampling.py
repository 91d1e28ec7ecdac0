"""Random sampling primitives (port of macarons_tpu/ops/sampling.py).

Every draw takes an explicit ``torch.Generator`` on the tensors' device.
"""

from __future__ import annotations

import torch

from .knn import smallest_k


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


def compute_mesh_face_area(verts, faces):
    fc = verts[faces]
    a = fc[:, 1] - fc[:, 0]
    b = fc[:, 2] - fc[:, 0]
    return 0.5 * torch.linalg.norm(torch.linalg.cross(a, b, dim=-1), dim=-1)


def sample_points_on_mesh_surface(gen, verts, faces, n_sample: int):
    """Area-weighted uniform surface sampling: inverse-CDF triangle choice,
    then barycentric points with fold-over reflection (o = vertex 2)."""
    areas = compute_mesh_face_area(verts, faces)
    cdf = cumsum_rows(areas)
    cdf = cdf / cdf[-1]
    u = torch.rand(n_sample, generator=gen, device=verts.device)
    idx = torch.clamp(torch.searchsorted(cdf, u), 0, faces.shape[0] - 1)
    fc = verts[faces[idx]]
    o = fc[:, 2]
    a = fc[:, 0] - o
    b = fc[:, 1] - o
    alpha = torch.rand(n_sample, 1, generator=gen, device=verts.device)
    beta = torch.rand(n_sample, 1, generator=gen, device=verts.device)
    flip = (alpha + beta) > 1.0
    alpha = torch.where(flip, 1.0 - alpha, alpha)
    beta = torch.where(flip, 1.0 - beta, beta)
    return o + alpha * a + beta * b


def random_subsample_mask(gen, mask, n_keep: int, big: float = 1e9):
    """n_keep random indices among the True entries of ``mask`` (fixed shape).

    Returns (idx (n_keep,), valid (n_keep,)); valid is False where fewer than
    n_keep entries were available."""
    n = mask.shape[0]
    scores = torch.rand(n, generator=gen, device=mask.device) \
        + torch.where(mask, 0.0, big)
    vals, idx = smallest_k(scores, n_keep)
    return idx, vals < big * 0.5
