"""SH visibility, plain: the function that the program's kernel B3
(``sh_visibility_kernel``) computes, from its spherical harmonics summed
in PyTorch. Autograd differentiates it where the program launches B3's
backward. It stands in for the kernel in the reference."""

from __future__ import annotations

import torch

from .harmonics import sh_weighted_sum

MAX_HARMONIC_RANK = 8


def compute_visibilities_plain(pts, harmonics, X_cam, use_sigmoid: bool = True):
    """pts (B, L, >=3), harmonics (B, L, 64), X_cam (B, C, 3) -> (B, C, L)."""
    rays = X_cam[:, :, None, :] - pts[:, None, :, :3]
    z = sh_weighted_sum(rays, harmonics[:, None], degree=MAX_HARMONIC_RANK)
    return torch.sigmoid(z) if use_sigmoid else torch.relu(z)


def sh_visibility(pts, harmonics, X_cam, use_sigmoid: bool = True):
    """The plain SH visibility in place of the kernel: autograd
    differentiates it."""
    return compute_visibilities_plain(pts, harmonics, X_cam, use_sigmoid)
