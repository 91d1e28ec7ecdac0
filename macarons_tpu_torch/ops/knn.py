"""Exact brute-force kNN (port of macarons_tpu/ops/knn.py).

The JAX package's SconeOcc defaults to ``approx_min_k``, which is exact on
its CPU backend; the port is exact everywhere (distance matrix + top-k), so
it is held against a CPU run of the JAX package. Matmuls run in full float32.

Every top-k of the port whose ties reach a result takes ``smallest_k``:
``torch.topk`` leaves the order of equal values unspecified (it differs
between the CPU and the card), while ``jax.lax.top_k`` puts the lower index
first among them.
"""

from __future__ import annotations

import torch


def pairwise_sqdist(x, y):
    """||x||^2 + ||y||^2 - 2 x.y, clamped at 0: (..., N, D), (..., M, D) ->
    (..., N, M)."""
    x2 = torch.sum(x * x, dim=-1, keepdim=True)
    y2 = torch.sum(y * y, dim=-1, keepdim=True)
    xy = torch.matmul(x, y.transpose(-1, -2))
    return torch.clamp(x2 + y2.transpose(-1, -2) - 2.0 * xy, min=0.0)


def cdist(x, y):
    """Euclidean distance matrix (torch.cdist semantics, through
    pairwise_sqdist as the JAX package computes it)."""
    return torch.sqrt(pairwise_sqdist(x, y))


def knn_gather(pc, idx):
    """pc (..., M, D), idx (..., N, K) -> (..., N, K, D)."""
    batch = idx.shape[:-2]
    N, K = idx.shape[-2:]
    D = pc.shape[-1]
    flat = idx.reshape(*batch, N * K, 1).expand(*batch, N * K, D)
    return torch.gather(pc, -2, flat).reshape(*batch, N, K, D)


def _keys(values, index):
    """int64 keys bits(value) << 32 | index of non-negative float32 values:
    the bits of a non-negative float order like the float (-0.0 is taken as
    0.0), so the keys order by (value, index) and are unique."""
    keys = (values + 0.0).view(torch.int32).to(torch.int64)
    keys <<= 32
    keys |= index
    return keys


def smallest_k(values, k: int):
    """The k smallest entries of the last dim of ``values`` (non-negative),
    ascending, the lower index first among equal values: the indices that
    ``jax.lax.top_k(-values, k)`` gives. Returns (values, indices).

    float32 takes one ``torch.topk`` of the unique keys of ``_keys``; other
    types a stable sort."""
    if values.dtype != torch.float32:
        vals, idx = torch.sort(values, dim=-1, stable=True)
        return vals[..., :k], idx[..., :k]
    n = values.shape[-1]
    idx = torch.topk(_keys(values, torch.arange(n, device=values.device)), k,
                     dim=-1, largest=False, sorted=True).indices
    return torch.gather(values, -1, idx), idx


# Candidates that knn_points keeps beyond k before it orders them.
KNN_MARGIN = 16


def _candidates(values, k: int):
    """``smallest_k`` of a wide float32 matrix (kNN distances) at about the
    cost of one float32 ``torch.topk``: its k + KNN_MARGIN smallest entries
    are the candidates, ordered by (value, index). They hold every entry
    equal to the k-th value unless the last candidate equals it too.
    Returns (values, indices, short): ``short`` marks those rows (a tie
    wider than the margin), which ``_whole_rows`` takes again; None where
    every row was taken whole."""
    n = values.shape[-1]
    m = min(k + KNN_MARGIN, n)
    if m == n or values.dtype != torch.float32:
        return (*smallest_k(values, k), None)
    cand, cidx = torch.topk(values, m, dim=-1, largest=False, sorted=True)
    pick = torch.topk(_keys(cand, cidx), k, dim=-1, largest=False,
                      sorted=True).indices
    return (torch.gather(cand, -1, pick), torch.gather(cidx, -1, pick),
            cand[..., k - 1] == cand[..., m - 1])


def _whole_rows(picks, values, k: int):
    """Each ``_candidates`` result of ``picks`` with its short rows taken
    whole from the matching matrix of ``values``; one host sync for all of
    them, which costs more than the candidates' order (PERF.md §6)."""
    shorts = [s.any() for _, _, s in picks if s is not None]
    if not shorts or not bool(torch.stack(shorts).any()):
        return [(v, i) for v, i, _ in picks]
    out = []
    for (vals, idx, short), d2 in zip(picks, values):
        if short is not None:
            rows = short.nonzero(as_tuple=True)
            vals[rows], idx[rows] = smallest_k(d2[rows], k)
        out.append((vals, idx))
    return out


def _masked_sqdist(x, pc, pc_mask, big: float):
    """pairwise_sqdist with the invalid reference points (pc_mask False)
    ranked after every valid one, lower index first: given ``big`` and the
    floats just above it in index order, they leave no tie for a query with
    fewer than k valid points; knn_points_many returns ``big`` for them.

    Distances in a 2-byte type (bfloat16, computed in it as the JAX package
    does) are ranked as float32, which holds them exactly: its pads stay
    finite and distinct for clouds of up to 2**23 points, where the 2-byte
    type's would reach inf and NaN after some 12,000."""
    d2 = pairwise_sqdist(x, pc)
    if d2.element_size() < 4:
        d2 = d2.float()
    if pc_mask is None:
        return d2
    n = pc.shape[-2]
    bits = torch.int32 if d2.element_size() == 4 else torch.int64
    pads = (torch.full((n,), big, dtype=d2.dtype, device=d2.device)
            .view(bits) + torch.arange(n, dtype=bits, device=d2.device))
    return torch.where(pc_mask[..., None, :], d2, pads.view(d2.dtype))


def knn_points_many(queries, k: int, big: float = 1e10):
    """``knn_points`` of each (x, pc, pc_mask) of ``queries``, with one host
    sync for all of them (SconeOcc's scales)."""
    d2s = [_masked_sqdist(x, pc, mask, big) for x, pc, mask in queries]
    picks = _whole_rows([_candidates(d2, k) for d2 in d2s], d2s, k)
    out = []
    for (_, pc, mask), (vals, idx) in zip(queries, picks):
        if mask is not None:
            vals = torch.clamp(vals, max=big)
        vals = vals.to(pc.dtype)
        out.append((knn_gather(pc, idx),
                    torch.sqrt(torch.clamp(vals, min=0.0)), idx))
    return out


def knn_points(x, pc, k: int, pc_mask=None, big: float = 1e10):
    """k nearest points of pc to each query of x, nearest first, the lower
    index first among equal distances.

    Returns (gathered (..., N, k, D), dists (..., N, k), idx (..., N, k)).
    Invalid reference points (pc_mask False) get distance ``big``, and
    valid ones must lie nearer, as the JAX package's masked kNN assumes."""
    return knn_points_many([(x, pc, pc_mask)], k, big)[0]


def get_k_nearest_ray_points(X_camera, X, pc, k: int):
    """For each point of X, the k points of pc whose rays from the camera
    align best with its own (largest dot products of unit rays first, the
    lower index first among equal ones, as ``jax.lax.top_k``).
    X_camera (n_cam, 3); X (n_cam, S, 3); pc (n_cam, L, 3).
    Returns (gathered (n_cam, S, k, 3), dots (n_cam, S, k), idx)."""
    X_cam = X_camera[:, None, :]
    rays = pc - X_cam
    rays = rays / torch.clamp(torch.linalg.norm(rays, dim=-1, keepdim=True),
                              min=1e-12)
    x_rays = X - X_cam
    x_rays = x_rays / torch.clamp(torch.linalg.norm(x_rays, dim=-1,
                                                    keepdim=True), min=1e-12)
    dots = torch.matmul(x_rays, rays.transpose(-1, -2))
    top, idx = torch.sort(dots, dim=-1, descending=True, stable=True)
    return knn_gather(pc, idx[..., :k]), top[..., :k], idx[..., :k]
