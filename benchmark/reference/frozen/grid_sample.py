"""Bilinear grid sampling, NHWC (port of macarons_tpu/ops/grid_sample.py).

Semantics of torch's ``grid_sample(mode='bilinear', align_corners=False)``
with 'border' or 'zeros' padding, written as gathers so the layout and the
arithmetic order are the JAX package's.
"""

from __future__ import annotations

import torch


def _unnormalize(coord, size: int, align_corners: bool):
    if align_corners:
        return (coord + 1.0) / 2.0 * (size - 1)
    return ((coord + 1.0) * size - 1.0) / 2.0


def _gather2d(image, iy, ix):
    """image (N, H, W, C); iy/ix (N, ...) -> (N, ..., C)."""
    N, H, W, C = image.shape
    flat = image.reshape(N, H * W, C)
    lin = (iy * W + ix).reshape(N, -1)
    out = torch.gather(flat, 1, lin[..., None].expand(N, lin.shape[1], C))
    return out.reshape(*iy.shape, C)


def grid_sample(image, grid, padding_mode: str = "border",
                align_corners: bool = False):
    """Sample ``image`` (N, H, W, C) at ``grid`` (N, Hg, Wg, 2) -> (N, Hg, Wg, C)."""
    N, H, W, C = image.shape
    gx = _unnormalize(grid[..., 0], W, align_corners)
    gy = _unnormalize(grid[..., 1], H, align_corners)
    if padding_mode == "border":
        gx = torch.clamp(gx, 0.0, W - 1.0)
        gy = torch.clamp(gy, 0.0, H - 1.0)
    elif padding_mode != "zeros":
        raise ValueError(f"unsupported padding_mode {padding_mode!r}")

    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    wx1 = gx - x0
    wx0 = 1.0 - wx1
    wy1 = gy - y0
    wy0 = 1.0 - wy1

    def corner(yf, xf, wy, wx):
        ix = xf.to(torch.int64)
        iy = yf.to(torch.int64)
        w = wy * wx
        if padding_mode == "zeros":
            valid = (ix >= 0) & (ix <= W - 1) & (iy >= 0) & (iy <= H - 1)
            w = torch.where(valid, w, torch.zeros_like(w))
        return _gather2d(image, iy.clamp(0, H - 1), ix.clamp(0, W - 1)) \
            * w[..., None]

    return (corner(y0, x0, wy0, wx0) + corner(y0, x0 + 1.0, wy0, wx1)
            + corner(y0 + 1.0, x0, wy1, wx0)
            + corner(y0 + 1.0, x0 + 1.0, wy1, wx1))


def sample_points_bilinear(image, xy, padding_mode: str = "border",
                           align_corners: bool = False):
    """Sample ``image`` (N, H, W, C) at per-point coords xy (N, P, 2) -> (N, P, C)."""
    out = grid_sample(image, xy[:, :, None, :], padding_mode=padding_mode,
                      align_corners=align_corners)
    return out[:, :, 0, :]
