"""The depth module's pose conversions and smoothness table (the inference
subset of macarons_tpu/models/depth_losses.py; the losses wait for the online
trainer). Images and disparities are NHWC."""

from __future__ import annotations

import torch

from ..ops.geometry import axis_angle_from_matrix, relative_pose


def get_relative_pose_matrices(R, T, alpha_R, alpha_T):
    """Relative poses target -> alpha. R (B, 3, 3), T (B, 3);
    alpha_R (B, A, 3, 3), alpha_T (B, A, 3)."""
    B, A = T.shape[0], alpha_T.shape[1]
    return relative_pose(R[:, None].expand(B, A, 3, 3),
                         T[:, None].expand(B, A, 3), alpha_R, alpha_T)


def convert_matrix_to_pose(R, T, alpha_R, alpha_T, pose_factor: float):
    """(B, A, 6): [T, axis-angle] of the relative poses, / pose_factor."""
    rel_R, rel_T = get_relative_pose_matrices(R, T, alpha_R, alpha_T)
    angle = axis_angle_from_matrix(rel_R) / pose_factor
    return torch.cat((rel_T / pose_factor, angle), dim=-1)


def regularity_tab(disp, img):
    """Per-pixel edge-aware smoothness, NHWC -> (B, H-2, W-2, 1)."""
    H, W = disp.shape[1], disp.shape[2]
    gdx = torch.abs(disp[:, :, :-1] - disp[:, :, 1:])
    gdy = torch.abs(disp[:, :-1] - disp[:, 1:])
    gix = torch.abs(img[:, :, :-1] - img[:, :, 1:]).mean(-1, keepdim=True)
    giy = torch.abs(img[:, :-1] - img[:, 1:]).mean(-1, keepdim=True)
    gdx = gdx * torch.exp(-gix)
    gdy = gdy * torch.exp(-giy)
    return gdx[:, :H - 2, :W - 2] + gdy[:, :H - 2, :W - 2]
