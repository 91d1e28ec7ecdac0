"""Proxy-point field: occupancy, view states, carving counters (port of
macarons_tpu/scene/proxy.py)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.knn import pairwise_sqdist
from ..ops.view_state import compute_view_state


class ProxyState(NamedTuple):
    """All per-proxy-point state (N fixed)."""

    points: torch.Tensor  # (N, 3)
    proba: torch.Tensor  # (N, 1) predicted occupancy
    supervision_occ: torch.Tensor  # (N, 1) carving pseudo-GT
    view_states: torch.Tensor  # (N, n_elev*n_azim)
    out_of_field: torch.Tensor  # (N, 1) 1 = never seen
    n_inside_fov: torch.Tensor  # (N, 1)
    n_behind_depth: torch.Tensor  # (N, 1)


def initialize_proxy_points_np(seed: int, x_min, x_max, n_proxy_points: int,
                               n_view_state_cameras: int = 98,
                               default_proba: float = 0.5, device=None):
    """Uniform box sampling from numpy's ``default_rng(seed)`` (the same
    points as the JAX package for the same seed) and the default state.
    Returns (ProxyState, points_np)."""
    x_min = np.asarray(x_min, np.float32)
    x_max = np.asarray(x_max, np.float32)
    rs = np.random.default_rng(seed)
    pts_np = x_min + (x_max - x_min) * rs.random((n_proxy_points, 3),
                                                 np.float32)
    N = n_proxy_points

    def full(cols, v):
        return torch.full((N, cols), float(v), device=device)

    state = ProxyState(
        points=torch.as_tensor(pts_np, device=device), proba=full(1, default_proba),
        supervision_occ=full(1, 1.0), view_states=full(n_view_state_cameras, 0.0),
        out_of_field=full(1, 1.0), n_inside_fov=full(1, 0.0),
        n_behind_depth=full(1, 0.0))
    return state, pts_np


def distance_between_proxy_points(x_min, x_max, n_proxy_points: int) -> float:
    """Typical proxy spacing."""
    vol = float(np.prod(np.asarray(x_max) - np.asarray(x_min)))
    radius = (3 * (vol / n_proxy_points) / (4 * np.pi)) ** (1.0 / 3.0)
    return 2 * radius


def update_view_states(state: ProxyState, X_cam, fov_mask, n_elev: int,
                       n_azim: int, signed_distances=None,
                       distance_to_surface=None) -> ProxyState:
    """OR the camera direction bin into the view state of the points in
    fov_mask (closer than distance_to_surface to the depth map, if given)."""
    update = fov_mask
    if signed_distances is not None:
        update = update & (signed_distances[..., 0] < distance_to_surface)
    vs = compute_view_state(state.points[None], X_cam.reshape(-1, 3), n_elev,
                            n_azim)[0]
    new = torch.where(update[:, None], torch.maximum(state.view_states, vs),
                      state.view_states)
    return state._replace(view_states=new)


def update_out_of_field(state: ProxyState, fov_mask) -> ProxyState:
    """Mark points seen at least once."""
    return state._replace(out_of_field=torch.where(
        fov_mask[:, None], 0.0, state.out_of_field))


def update_supervision_occ(state: ProxyState, fov_mask, signed_distances,
                           score_threshold: float = 1.0,
                           tol: float = 0.0) -> ProxyState:
    """Score-based carving: occupied iff behind-depth hits / fov hits >=
    score_threshold."""
    inc_in = fov_mask[:, None].to(state.n_inside_fov.dtype)
    behind = (signed_distances >= -tol) & fov_mask[:, None]
    n_in = state.n_inside_fov + inc_in
    n_behind = state.n_behind_depth + behind.to(state.n_behind_depth.dtype)
    ratio = n_behind / torch.clamp(n_in, min=1)
    occ = torch.where(fov_mask[:, None],
                      (ratio >= score_threshold).to(state.supervision_occ.dtype),
                      state.supervision_occ)
    return state._replace(n_inside_fov=n_in, n_behind_depth=n_behind,
                          supervision_occ=occ)


def reset_supervision_occ(state: ProxyState) -> ProxyState:
    """Supervision field back to ones and the carving counters to zero."""
    return state._replace(
        supervision_occ=torch.ones_like(state.supervision_occ),
        n_inside_fov=torch.zeros_like(state.n_inside_fov),
        n_behind_depth=torch.zeros_like(state.n_behind_depth))


def camera_collides(state: ProxyState, x_min, x_max, X_current, X_target,
                    proxy_distance: float, n_interpolation_steps: int = 4,
                    oof_collides: bool = False,
                    collision_n_threshold: int = 12) -> bool:
    """Occupied proxies within proxy_distance of the interpolated camera
    path; colliding iff their count exceeds the threshold. Targets outside
    the box never collide."""
    dev = state.points.device
    mn = torch.as_tensor(np.asarray(x_min, np.float32), device=dev)
    mx = torch.as_tensor(np.asarray(x_max, np.float32), device=dev)
    if not bool(torch.all((X_target >= mn) & (X_target <= mx))):
        return False
    t = torch.linspace(0.0, 1.0, n_interpolation_steps, device=dev)[:, None]
    ray = X_current[None, :] + t * (X_target - X_current)[None, :]
    close = pairwise_sqdist(state.points, ray).amin(dim=-1) < proxy_distance ** 2
    carved = state.supervision_occ[:, 0] > 0.0
    oof = state.out_of_field[:, 0] > 0.0
    hit = ((oof | carved) if oof_collides else (carved & ~oof)) & close
    return bool(hit.sum() > collision_n_threshold)
