"""Depth-map <-> 3D projection (port of macarons_tpu/ops/projection.py).

Fixed-shape and masked like the JAX package: backprojection returns every
pixel with a validity mask instead of filtering.
"""

from __future__ import annotations

import torch

from .geometry import FoVCamera, ndc_bounds, ndc_pixel_grid


def project_depth_back_to_3D(depth, cameras: FoVCamera):
    """depth (n_cam, H, W, 1) view-space z (empty < 0) ->
    (points (n_cam, H*W, 3), mask (n_cam, H*W))."""
    n_cam, H, W = depth.shape[0], depth.shape[1], depth.shape[2]
    ndc_x, ndc_y = ndc_pixel_grid(H, W, device=depth.device, dtype=depth.dtype)
    flat = depth.reshape(n_cam, H * W)
    ndc_points = torch.stack((ndc_x.reshape(1, -1).expand(n_cam, H * W),
                              ndc_y.reshape(1, -1).expand(n_cam, H * W),
                              flat), dim=-1)
    return cameras.unproject_ndc_depth(ndc_points), flat > -1


def points_in_fov_mask(pts, camera: FoVCamera, height: int, width: int,
                       fov_range=None):
    """Frustum mask for pts (..., N, 3): NDC inside the pixel-grid bounds,
    view z > 0, and (optionally) distance to the camera < fov_range."""
    min_x, max_x, min_y, max_y = ndc_bounds(height, width)
    view = camera.world_to_view(pts)
    ndc = camera.project_view(view)
    mask = ((ndc[..., 0] >= min_x) & (ndc[..., 0] <= max_x)
            & (ndc[..., 1] >= min_y) & (ndc[..., 1] <= max_y)
            & (view[..., 2] > 0.0))
    if fov_range is not None:
        center = camera.camera_center()
        d = torch.linalg.norm(pts - center[..., None, :], dim=-1)
        mask = mask & (d < fov_range)
    return mask


def ndc_to_grid_coords(ndc_xy, height: int, width: int):
    """PyTorch3D NDC xy -> grid_sample coords in [-1, 1] (sign flip)."""
    factor = -float(min(height, width))
    return torch.stack((factor / width * ndc_xy[..., 0],
                        factor / height * ndc_xy[..., 1]), dim=-1)


def depth_to_disparity(depth, znear, zfar):
    a = 1.0 / znear - 1.0 / zfar
    b = 1.0 / zfar
    return (1.0 / depth - b) / a


def disparity_to_depth(disp, znear, zfar):
    """disp in (0, 1) -> depth 1 / (a disp + b), a = 1/znear - 1/zfar,
    b = 1/zfar."""
    a = 1.0 / znear - 1.0 / zfar
    b = 1.0 / zfar
    return 1.0 / (a * disp + b)
