"""The depth module's losses and pose conversions (port of
macarons_tpu/models/depth_losses.py): the photometric reconstruction loss,
the edge-aware regularity, the pose loss and the direct-depth L1. Images,
depths and disparities are NHWC; cameras use the row-vector convention."""

from __future__ import annotations

import math

import torch

from .geometry import (
    FoVCamera,
    axis_angle_from_matrix,
    matrix_from_axis_angle,
    relative_pose,
)
from .grid_sample import grid_sample
from .projection import ndc_to_grid_coords, project_depth_back_to_3D
from .many_depth import ssim


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


def pose_loss(pred_pose, truth_pose, pose_factor: float,
              rotation_mode: str = "angle"):
    """MSE of the pose vectors [T, axis-angle] / pose_factor, the rotation
    compared as angles over pi ('angle') or as matrices ('matrix')."""
    pred_R = pose_factor * pred_pose[..., 3:]
    pred_T = pose_factor * pred_pose[..., :3]
    true_R = pose_factor * truth_pose[..., 3:]
    true_T = pose_factor * truth_pose[..., :3]
    if rotation_mode == "matrix":
        pred_R = matrix_from_axis_angle(pred_R).reshape(*pred_R.shape[:-1], 9)
        true_R = matrix_from_axis_angle(true_R).reshape(*true_R.shape[:-1], 9)
    elif rotation_mode == "angle":
        pred_R = pred_R / math.pi
        true_R = true_R / math.pi
    else:
        raise ValueError(rotation_mode)
    return torch.mean((pred_R - true_R) ** 2) + torch.mean((pred_T - true_T) ** 2)


def regularity_loss(disp, img):
    """Edge-aware disparity smoothness."""
    gdx = torch.abs(disp[:, :, :-1] - disp[:, :, 1:])
    gdy = torch.abs(disp[:, :-1] - disp[:, 1:])
    gix = torch.abs(img[:, :, :-1] - img[:, :, 1:]).mean(-1, keepdim=True)
    giy = torch.abs(img[:, :-1] - img[:, 1:]).mean(-1, keepdim=True)
    return torch.mean(gdx * torch.exp(-gix)) + torch.mean(gdy * torch.exp(-giy))


def warp_images_to_target(target_depth, target_camera: FoVCamera,
                          alpha_images, alpha_cameras: FoVCamera,
                          padding_mode: str = "border"):
    """Warp each alpha image into the target view through the target depth.
    target_depth (B, H, W, 1); alpha_images (B, A, H, W, 3); alpha_cameras
    batched (B * A,). Returns (B, A, H, W, 3)."""
    B, H, W, _ = target_depth.shape
    A = alpha_images.shape[1]
    world, _ = project_depth_back_to_3D(target_depth, target_camera)
    world = world[:, None].expand(B, A, H * W, 3).reshape(B * A, H * W, 3)
    ndc = alpha_cameras.transform_points(world)
    grid = ndc_to_grid_coords(ndc[..., :2], H, W).reshape(B * A, H, W, 2)
    warped = grid_sample(alpha_images.reshape(B * A, H, W, 3), grid,
                         padding_mode=padding_mode)
    return warped.reshape(B, A, H, W, 3)


def reconstruction_loss(images, alpha_images, mask, cameras: FoVCamera,
                        alpha_cameras: FoVCamera, predicted_depth,
                        ssim_factor: float = 0.85, use_mask: bool = True,
                        zfar: float = 750.0, padding_mode: str = "border"):
    """Photometric reprojection loss: the SSIM + L1 blend of each warped
    alpha image against the target, the minimum over the alphas per pixel,
    and its (masked) mean. images (B, H, W, 3); alpha_images
    (B, A, H, W, 3); mask (B, H, W, 1) bool; cameras (B,); alpha_cameras
    (B * A,)."""
    B, H, W, _ = images.shape
    A = alpha_images.shape[1]
    warp_depth = (torch.where(mask, predicted_depth, zfar) if use_mask
                  else predicted_depth)
    warped = warp_images_to_target(warp_depth, cameras, alpha_images,
                                   alpha_cameras, padding_mode=padding_mode)
    expanded = images[:, None].expand(B, A, H, W, 3)
    l1 = torch.abs(expanded - warped).mean(dim=-1, keepdim=True)
    if ssim_factor > 0:
        s = ssim(expanded.reshape(B * A, H, W, 3),
                 warped.reshape(B * A, H, W, 3))
        s = s.mean(dim=-1, keepdim=True).reshape(B, A, H, W, 1)
        loss = ssim_factor * s + (1 - ssim_factor) * l1
    else:
        loss = l1
    loss = loss.amin(dim=1)
    if use_mask:
        m = mask.to(loss.dtype)
        denom = m.sum(dim=(1, 2), keepdim=True) + 1e-7
        return torch.sum(loss * m / denom)
    return torch.mean(loss)
