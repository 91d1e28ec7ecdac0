"""View-state histograms and their harmonic features (port of
macarons_tpu/ops/view_state.py).

The direction bins reproduce the JAX package bit for bit, including the
reference's rounding quirks: torch-1.7 truncating floor_divide, the
asymmetric clamps of compute_view_state and of the view-space permutation,
and the below-pole wrap.
"""

from __future__ import annotations

import numpy as np
import torch

from . import mesh
from .geometry import FoVCamera, get_cartesian_coords, get_spherical_coords
from .harmonics import real_spherical_harmonics_np
from .sampling import cumsum_rows


def _sphere_grid_np(n_elev: int, n_azim: int):
    elev = np.array([-np.pi / 2 + (i + 1) / (n_elev + 1) * np.pi
                     for i in range(n_elev) for _ in range(n_azim)], np.float64)
    azim = np.array([2 * np.pi * j / n_azim for _ in range(n_elev)
                     for j in range(n_azim)], np.float64)
    return elev, azim


def get_all_harmonics_under_degree(degree: int, n_elev: int, n_azim: int):
    """(base_harmonics (degree^2, n_elev*n_azim), h_polar, h_azim) as numpy
    float32 constant tables."""
    elev, h_azim = _sphere_grid_np(n_elev, n_azim)
    h_polar = -elev + np.pi / 2
    z = real_spherical_harmonics_np(h_polar, h_azim, degree=degree)
    return (z.T.astype(np.float32), h_polar.astype(np.float32),
            h_azim.astype(np.float32))


def normalize_points_in_prediction_box(points, center, diag):
    return (points - center) / diag


def _trunc_div(x, step):
    return torch.trunc(x / step)


def _bin_directions(ray_elev, ray_azim, n_elev: int, n_azim: int,
                    elev_upper_clamp: int):
    """Nearest-bin flat indices in [0, n_elev*n_azim) (see the JAX twin for
    the clamp and wrap semantics)."""
    elev_step = np.pi / (n_elev + 1)
    azim_step = 2 * np.pi / n_azim
    idx_elev = _trunc_div(ray_elev, elev_step)
    idx_azim = _trunc_div(ray_azim, azim_step)
    idx_elev = torch.where(torch.remainder(ray_elev, elev_step)
                           > elev_step / 2.0, idx_elev + 1, idx_elev)
    idx_azim = torch.where(torch.remainder(ray_azim, azim_step)
                           > azim_step / 2.0, idx_azim + 1, idx_azim)
    if elev_upper_clamp == n_elev - 1:
        idx_elev = torch.where(idx_elev >= n_elev,
                               torch.full_like(idx_elev, n_elev - 1), idx_elev)
        lower = -((n_elev + 1) // 2)
    else:
        idx_elev = torch.where(idx_elev > elev_upper_clamp,
                               torch.full_like(idx_elev, elev_upper_clamp),
                               idx_elev)
        lower = -(n_elev // 2)
    idx_elev = torch.where(idx_elev < lower, torch.full_like(idx_elev, lower),
                           idx_elev)
    idx_azim = torch.where(idx_azim > n_azim // 2,
                           torch.full_like(idx_azim, -(n_azim // 2)), idx_azim)
    idx_elev = idx_elev + n_elev // 2
    idx_azim = torch.where(idx_azim < 0, idx_azim + n_azim, idx_azim)
    indices = idx_elev.to(torch.int64) * n_azim + idx_azim.to(torch.int64)
    return torch.remainder(indices, n_elev * n_azim)


def compute_view_state(pts, X_view, n_elev: int, n_azim: int,
                       view_mask=None):
    """Binary histogram of view directions per point.

    pts (B, L, >=3); X_view (V, 3) cameras shared by every cloud, or
    (B, V, 3) per cloud; view_mask (V,) or (B, V) leaves padded views out.
    Returns (B, L, n_elev*n_azim) in the points' floating type."""
    if X_view.dim() == 2:
        X_view = X_view[None]
    rays = X_view[:, None, :, :] - pts[..., :3][:, :, None, :]
    _, ray_elev, ray_azim = get_spherical_coords(rays)
    indices = _bin_directions(ray_elev, ray_azim, n_elev, n_azim,
                              elev_upper_clamp=n_elev - 1)  # (B, L, V)
    out = torch.zeros(*indices.shape[:2], n_elev * n_azim,
                      dtype=pts.dtype, device=pts.device)
    if view_mask is None:
        return out.scatter_(-1, indices, 1.0)
    if view_mask.dim() == 1:
        view_mask = view_mask[None]
    seen = view_mask[:, None, :].to(pts.dtype).expand(indices.shape)
    return out.scatter_reduce_(-1, indices, seen, reduce="amax")


def get_cameras_on_sphere(n_elev: int, n_azim: int, camera_dist: float,
                          pole_cameras: bool = False, device=None):
    """Candidate camera positions on a sphere, elev-major, with a camera
    just off each pole first and last when ``pole_cameras``.
    Returns (X_cam (n_cam, 3), dist, elev_deg, azim_deg)."""
    elev = [-90.0 + (i + 1) / (n_elev + 1) * 180.0 for i in range(n_elev)
            for _ in range(n_azim)]
    azim = [360.0 * j / n_azim for _ in range(n_elev) for j in range(n_azim)]
    if pole_cameras:
        elev = [-89.9] + elev + [89.9]
        azim = [0.0] + azim + [0.0]
    elev = torch.tensor(elev, dtype=torch.float32, device=device)
    azim = torch.tensor(azim, dtype=torch.float32, device=device)
    dist = torch.full_like(elev, camera_dist)
    X_cam = get_cartesian_coords(dist, elev, azim, in_degrees=True)
    return X_cam, dist, elev, azim


def view_space_angles(camera: FoVCamera, n_elev: int, n_azim: int):
    """The world elevation and azimuth of each view-space bin's direction
    in ``camera``'s frame (camera batch of one): two (n_elev*n_azim,)."""
    elev_np, azim_np = _sphere_grid_np(n_elev, n_azim)
    dev = camera.R.device
    elev = torch.as_tensor(elev_np, dtype=torch.float32, device=dev)
    azim = torch.as_tensor(azim_np, dtype=torch.float32, device=dev)
    X_ref = get_cartesian_coords(torch.ones_like(elev), elev, azim)
    world = camera.view_to_world(X_ref[None])[0]
    dirs = (world - camera.camera_center()).reshape(-1, 3)
    _, ray_elev, ray_azim = get_spherical_coords(dirs)
    return ray_elev, ray_azim


def view_space_permutation(camera: FoVCamera, n_elev: int, n_azim: int):
    """Gather indices rotating a view state into ``camera``'s frame (camera
    batch of one): each view-space bin's direction binned in the world
    (``view_space_angles``). Returns (n_elev*n_azim,) int64."""
    return _bin_directions(*view_space_angles(camera, n_elev, n_azim),
                           n_elev, n_azim, elev_upper_clamp=n_elev // 2)


def filter_proxy_points_mask(view_cameras: FoVCamera, X, pc,
                             filter_tol: float = 0.01, pc_mask=None,
                             view_mask=None):
    """Mask of the points X (N, 3) whose projections lie within the
    projected box of the observed cloud pc (M, 3), widened by filter_tol,
    for every view camera (batch (n_view,)); padded cameras (view_mask
    False) constrain nothing."""
    n_view = view_cameras.R.shape[0]
    X_proj = view_cameras.transform_points(
        X[None].expand(n_view, *X.shape))[..., :2]
    pc_proj = view_cameras.transform_points(
        pc[None].expand(n_view, *pc.shape))[..., :2]
    if pc_mask is not None:
        m = pc_mask[None, :, None]
        max_proj = torch.where(m, pc_proj, -1e10).amax(dim=-2, keepdim=True)
        min_proj = torch.where(m, pc_proj, 1e10).amin(dim=-2, keepdim=True)
    else:
        max_proj = pc_proj.amax(dim=-2, keepdim=True)
        min_proj = pc_proj.amin(dim=-2, keepdim=True)
    ok = (X_proj < max_proj + filter_tol) & (X_proj > min_proj - filter_tol)
    if view_mask is not None:
        ok = ok | ~view_mask[:, None, None]
    return ok.all(dim=-1).all(dim=0)


def view_harmonics_weights(degree: int, n_elev: int, n_azim: int, device):
    """(H, n_values) weights of the spherical L2 inner product that projects
    a histogram onto the SH basis."""
    base, h_polar, _ = get_all_harmonics_under_degree(degree, n_elev, n_azim)
    polar_step = np.pi / (n_elev + 1)
    azim_step = 2 * np.pi / n_azim
    base_t = torch.as_tensor(base, device=device)
    sin_p = torch.sin(torch.as_tensor(h_polar, device=device))
    return base_t * sin_p[None, :] * polar_step * azim_step


def compute_view_harmonics(view_state, weights):
    """view_state (..., n_values) @ weights^T -> (..., H), in the view
    state's floating type (the weights are float32 tables)."""
    return torch.matmul(view_state,
                        weights.transpose(0, 1).to(view_state.dtype))


def sample_proxy_points(gen, X_world, preds, view_harmonics, n_sample: int,
                        min_occ: float, use_occ_to_sample: bool = True,
                        valid_mask=None, idx=None):
    """Occupancy-weighted Monte-Carlo sampling of proxy points with repeats,
    batched over leading dims of ``valid_mask`` (..., N).

    ``idx`` (..., n_sample) injects the sample indices instead of drawing
    them (parity tests feed the JAX package's draws).
    Returns (pts4 (..., n_sample, 4), harmonics (..., n_sample, H), idx, mask)."""
    occ = preds[..., 0]
    sel = occ > min_occ
    if valid_mask is not None:
        sel = sel & valid_mask
    lead = sel.shape[:-1]
    N = occ.shape[0]
    if use_occ_to_sample:
        probs = torch.where(sel, occ, torch.zeros_like(occ))
        total = torch.sum(probs, dim=-1, keepdim=True)
        if idx is None:
            safe = torch.where(total > 0, probs, torch.ones_like(probs))
            cdf = cumsum_rows(safe)
            cdf = cdf / cdf[..., -1:]
            u = mesh.rand_rows(gen, (*lead, n_sample), X_world.device)
            idx = torch.clamp(torch.searchsorted(cdf.contiguous(), u), 0,
                              N - 1)
        mask = (total > 0).expand(*lead, n_sample) & torch.gather(sel, -1, idx)
    else:
        if idx is None:
            order = torch.argsort((~sel).to(torch.int8), dim=-1, stable=True)
            idx = order[..., :n_sample]
        mask = torch.gather(sel, -1, idx)
    pts4 = torch.cat((X_world[idx], preds[idx]), dim=-1)
    return pts4, view_harmonics[idx], idx, mask
