"""Fixed-shape masked voxel scene store (port of macarons_tpu/scene/grid.py).

The grid is one padded tensor ``(n_cells, capacity, 3)`` plus features and a
validity mask. ``fill_cells`` deduplicates incoming points against the points
already stored in their cell (min distance > resolution), then keeps a random
capacity-subset of old + new per cell; ``scene_coverage`` matches ground-truth
points only against recovered points of the same cell.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops.knn import pairwise_sqdist, smallest_k

_BIG = 1e9


class GridConfig(NamedTuple):
    """Static grid geometry."""

    x_min: Tuple[float, float, float]
    x_max: Tuple[float, float, float]
    grid_l: int
    grid_w: int
    grid_h: int
    capacity: int
    resolution: float
    feature_dim: int = 0

    @property
    def n_cells(self) -> int:
        return self.grid_l * self.grid_w * self.grid_h

    @property
    def cell_size(self):
        mn = np.array(self.x_min)
        mx = np.array(self.x_max)
        return (mx - mn) / np.array([self.grid_l, self.grid_w, self.grid_h])

    def cell_centers(self, device=None):
        mn = torch.as_tensor(np.asarray(self.x_min, np.float32), device=device)
        sz = torch.as_tensor(np.asarray(self.cell_size, np.float32),
                             device=device)
        ii = torch.stack(torch.meshgrid(
            torch.arange(self.grid_l, device=device),
            torch.arange(self.grid_w, device=device),
            torch.arange(self.grid_h, device=device), indexing="ij"),
            dim=-1).reshape(-1, 3)
        return mn + (ii + 0.5) * sz


def make_grid_config(x_min, x_max, grid_l, grid_w, grid_h,
                     capacity: Optional[int] = None,
                     resolution: Optional[float] = None,
                     feature_dim: int = 0) -> GridConfig:
    """Derive capacity <-> resolution with the reference's area heuristic."""
    mn = np.asarray(x_min, np.float64)
    mx = np.asarray(x_max, np.float64)
    l, w, h = (mx - mn) / np.array([grid_l, grid_w, grid_h])
    area = max(l * np.sqrt(w**2 + h**2), w * np.sqrt(h**2 + l**2),
               h * np.sqrt(l**2 + w**2))
    if resolution is None:
        if capacity is None:
            raise ValueError("need capacity or resolution")
        resolution = 2 * np.sqrt((area / capacity) / np.pi)
    elif capacity is None:
        capacity = int(area // (np.pi * (resolution / 2.0) ** 2))
    return GridConfig(tuple(np.asarray(x_min, float)),
                      tuple(np.asarray(x_max, float)), grid_l, grid_w, grid_h,
                      int(capacity), float(resolution), feature_dim)


class GridState(NamedTuple):
    """points (C, K, 3), features (C, K, F), valid (C, K)."""

    points: torch.Tensor
    features: torch.Tensor
    valid: torch.Tensor


def empty_grid(cfg: GridConfig, device=None) -> GridState:
    C, K, F = cfg.n_cells, cfg.capacity, max(cfg.feature_dim, 1)
    return GridState(torch.zeros((C, K, 3), device=device),
                     torch.zeros((C, K, F), device=device),
                     torch.zeros((C, K), dtype=torch.bool, device=device))


def _bounds(cfg: GridConfig, device):
    mn = torch.as_tensor(np.asarray(cfg.x_min, np.float32), device=device)
    mx = torch.as_tensor(np.asarray(cfg.x_max, np.float32), device=device)
    return mn, mx


def cell_index(cfg: GridConfig, pts):
    """Flat (clamped) cell id of each point."""
    mn, _ = _bounds(cfg, pts.device)
    sz = torch.as_tensor(np.asarray(cfg.cell_size, np.float32),
                         device=pts.device)
    idx = torch.floor((pts - mn) / sz).to(torch.int64)
    dims = torch.tensor([cfg.grid_l, cfg.grid_w, cfg.grid_h],
                        device=pts.device)
    idx = torch.minimum(torch.clamp(idx, min=0), dims - 1)
    return (idx[..., 0] * cfg.grid_w + idx[..., 1]) * cfg.grid_h + idx[..., 2]


def in_bounding_box(cfg: GridConfig, pts):
    mn, mx = _bounds(cfg, pts.device)
    return torch.all((pts >= mn) & (pts <= mx), dim=-1)


def _min_sqdist_in_cell(state: GridState, pts, cid, chunk: int = 16384):
    """Squared distance from each point to the nearest stored point of its
    own cell (``_BIG`` for an empty cell), in chunks of points."""
    out = []
    for s in range(0, pts.shape[0], chunk):
        c = cid[s:s + chunk]
        d2 = torch.sum((pts[s:s + chunk, None, :] - state.points[c]) ** 2,
                       dim=-1)
        d2 = torch.where(state.valid[c], d2, _BIG)
        out.append(d2.amin(dim=-1))
    return torch.cat(out) if out else pts.new_zeros((0,))


def fill_cells(cfg: GridConfig, state: GridState, gen: torch.Generator, pts,
               pts_mask=None, features=None, draws=None) -> GridState:
    """Insert points (P, 3): mask to the box, drop points within
    ``resolution`` of a stored point of their cell, rank the rest per cell in
    a random order, then keep a random capacity-subset of old + new.
    ``draws`` (the (P,) permutation, the (C, 2K) uniform scores) injects the
    two draws in place of ``gen``'s."""
    dev = pts.device
    P = pts.shape[0]
    C, K = cfg.n_cells, cfg.capacity
    F = state.features.shape[-1]
    if features is None:
        features = torch.zeros((P, F), dtype=state.features.dtype, device=dev)
    if pts_mask is None:
        pts_mask = torch.ones((P,), dtype=torch.bool, device=dev)

    ok = pts_mask & in_bounding_box(cfg, pts)
    cid = cell_index(cfg, pts)
    ok = ok & (_min_sqdist_in_cell(state, pts, cid) > cfg.resolution ** 2)

    perm = (torch.randperm(P, generator=gen, device=gen.device)
            if draws is None else draws[0]).to(dev)
    pts_s, feat_s, ok_s, cid_s = pts[perm], features[perm], ok[perm], cid[perm]
    cid_s = torch.where(ok_s, cid_s, C)

    order = torch.argsort(cid_s, stable=True)
    sorted_cid = cid_s[order]
    pos = torch.arange(P, device=dev)
    first = torch.zeros((P,), dtype=torch.int64, device=dev)
    if P > 1:
        first[1:] = torch.where(sorted_cid[1:] != sorted_cid[:-1], pos[1:], 0)
    run_start = torch.cummax(first, dim=0).values
    rank = torch.empty((P,), dtype=torch.int64, device=dev)
    rank[order] = pos - run_start

    keep = ok_s & (rank < K)
    cell = torch.where(keep, cid_s, C)
    slot = torch.where(keep, rank, 0)
    staging_pts = torch.zeros((C + 1, K, 3), device=dev)
    staging_feat = torch.zeros((C + 1, K, F), dtype=state.features.dtype,
                               device=dev)
    staging_valid = torch.zeros((C + 1, K), dtype=torch.bool, device=dev)
    staging_pts[cell[keep], slot[keep]] = pts_s[keep]
    staging_feat[cell[keep], slot[keep]] = feat_s[keep]
    staging_valid[cell[keep], slot[keep]] = True

    all_pts = torch.cat([state.points, staging_pts[:C]], dim=1)
    all_feat = torch.cat([state.features, staging_feat[:C]], dim=1)
    all_valid = torch.cat([state.valid, staging_valid[:C]], dim=1)
    scores = (torch.rand(all_valid.shape, generator=gen, device=gen.device)
              if draws is None else draws[1]).to(dev) + torch.where(
        all_valid, 0.0, _BIG)
    take = smallest_k(scores, K)[1]
    return GridState(
        torch.gather(all_pts, 1, take[..., None].expand(C, K, 3)),
        torch.gather(all_feat, 1, take[..., None].expand(C, K, F)),
        torch.gather(all_valid, 1, take))


def fill_cells_progressive(cfg: GridConfig, state: GridState,
                           gen: torch.Generator, pts, pts_mask=None,
                           chunk: int = 1000) -> GridState:
    """Shuffled re-fill in small batches, so the resolution dedup denoises."""
    P = pts.shape[0]
    if pts_mask is None:
        pts_mask = torch.ones((P,), dtype=torch.bool, device=pts.device)
    perm = torch.randperm(P, generator=gen, device=gen.device).to(pts.device)
    pts, pts_mask = pts[perm], pts_mask[perm]
    for s in range(0, P, chunk):
        state = fill_cells(cfg, state, gen, pts[s:s + chunk],
                           pts_mask[s:s + chunk])
    return state


def _covered_mask_cellwise(gt: GridState, rec: GridState, eps,
                           cell_batch: int = 64):
    """(C, K): each stored GT point is covered by a same-cell recovered point
    closer than eps."""
    out = []
    for s in range(0, gt.points.shape[0], cell_batch):
        g = gt.points[s:s + cell_batch]
        r = rec.points[s:s + cell_batch]
        d2 = torch.sum((g[:, :, None, :] - r[:, None, :, :]) ** 2, dim=-1)
        d2 = torch.where(rec.valid[s:s + cell_batch, None, :], d2, _BIG)
        out.append((torch.sqrt(d2.amin(dim=-1)) < eps)
                   & gt.valid[s:s + cell_batch])
    return torch.cat(out)


def scene_coverage(cfg: GridConfig, gt: GridState, rec: GridState,
                   surface_epsilon=None):
    """GT recall against the recovered scene, cell by cell.
    Returns (coverage, n_gt_pts) as tensors."""
    eps = 2.0 * cfg.resolution if surface_epsilon is None else surface_epsilon
    covered = _covered_mask_cellwise(gt, rec, eps)
    n_gt = gt.valid.sum()
    return covered.sum() / torch.clamp(n_gt, min=1), n_gt


def all_points(state: GridState):
    """Flattened (C * K, 3) points and their validity."""
    return state.points.reshape(-1, 3), state.valid.reshape(-1)


def min_dist_to_stored(cfg: GridConfig, state: GridState, queries,
                       chunk: int = 2048):
    """Distance from each query (Q, 3) to the nearest stored point of any
    cell, in chunks of queries."""
    pts, valid = all_points(state)
    out = []
    for s in range(0, queries.shape[0], chunk):
        d2 = pairwise_sqdist(queries[s:s + chunk], pts)
        out.append(torch.sqrt(torch.where(valid[None], d2, _BIG).amin(dim=-1)))
    return torch.cat(out) if out else queries.new_zeros((0,))


def _near_cloud(pts, pc, pm, eps, chunk: int = 4096):
    """(N,) bool: stored point within eps of a valid point of the cloud."""
    out = []
    for s in range(0, pts.shape[0], chunk):
        d2 = torch.where(pm[None], pairwise_sqdist(pts[s:s + chunk], pc), _BIG)
        out.append(torch.sqrt(d2.amin(dim=-1)) < eps)
    return torch.cat(out)


def camera_coverage_gain(cfg: GridConfig, state: GridState, part_pc,
                         part_mask, surface_epsilon=None):
    """Stored points newly covered by a captured partial cloud (feature 0
    holds the coveredness). Returns (gain, state with them marked 1)."""
    eps = cfg.resolution if surface_epsilon is None else surface_epsilon
    pts, valid = all_points(state)
    feat = state.features.reshape(pts.shape[0], -1)
    pm = part_mask & in_bounding_box(cfg, part_pc)
    newly = _near_cloud(pts, part_pc, pm, eps) & valid & ~(feat[:, 0] > 0.0)
    new_feat = feat.clone()
    new_feat[:, 0] = torch.where(newly, 1.0, feat[:, 0])
    return newly.float().sum(), state._replace(
        features=new_feat.reshape(state.features.shape))


def window_coverage_gains(cfg: GridConfig, state: GridState, part_pcs,
                          part_masks, surface_epsilon=None):
    """Per-frame supervision coverage gains of a capture window.

    The window's partial clouds are already in ``state``, with coveredness
    feature 0 except frame 0's points (covered). Frame f's gain counts the
    uncovered stored points within eps of its own cloud (no marking between
    frames); afterwards every stored point is covered.
    part_pcs (F, P, 3), part_masks (F, P). Returns (gains (F,), state)."""
    eps = cfg.resolution if surface_epsilon is None else surface_epsilon
    pts, valid = all_points(state)
    uncovered = valid & (state.features.reshape(pts.shape[0], -1)[:, 0] <= 0.0)
    gains = torch.stack([
        (_near_cloud(pts, pc, pm & in_bounding_box(cfg, pc), eps)
         & uncovered).float().sum()
        for pc, pm in zip(part_pcs, part_masks)])
    new_feat = state.features.clone()
    new_feat[..., 0] = 1.0
    return gains, state._replace(features=new_feat)
