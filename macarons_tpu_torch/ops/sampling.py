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


def _rand(gen, shape, device, normal: bool = False):
    """Uniform [0, 1) (or standard normal) draws from ``gen`` on the
    generator's own device, moved to ``device``: a CPU generator serves
    data on the card with the draws it gives the CPU."""
    draw = torch.randn if normal else torch.rand
    return draw(shape, generator=gen, device=gen.device).to(device)


def sample_categorical_cdf(gen, probs, n_sample: int, u=None):
    """n_sample indices ~ probs by inverse-CDF search; ``u`` (n_sample,)
    injects the uniform draws."""
    cdf = cumsum_rows(probs)
    cdf = cdf / cdf[-1]
    if u is None:
        u = _rand(gen, (n_sample,), probs.device)
    return torch.clamp(torch.searchsorted(cdf, u), 0, probs.shape[0] - 1)


def sample_mesh_triangle(gen, verts, faces, n_sample: int, face_mask=None,
                         u=None):
    """Area-weighted triangle indices (n_sample,); masked faces get no
    probability."""
    areas = compute_mesh_face_area(verts, faces)
    if face_mask is not None:
        areas = torch.where(face_mask, areas, 0.0)
    return sample_categorical_cdf(gen, areas, n_sample, u=u)


def sample_points_on_mesh_faces(gen, verts, faces, sample_face_indices,
                                vert_features=None, alpha=None, beta=None):
    """Uniform points on the selected triangles: alpha, beta ~ U[0, 1)
    (drawn in that order, each (S, 1), or injected), reflected where
    alpha + beta > 1; point = o + alpha a + beta b with o = vertex 2. With
    ``vert_features`` (V, C) also the interpolated features (S, C)."""
    n = sample_face_indices.shape[0]
    sf = faces[sample_face_indices]
    fc = verts[sf]
    o = fc[:, 2]
    a = fc[:, 0] - o
    b = fc[:, 1] - o
    if alpha is None:
        alpha = _rand(gen, (n, 1), verts.device)
    if beta is None:
        beta = _rand(gen, (n, 1), verts.device)
    flip = (alpha + beta) > 1.0
    alpha = torch.where(flip, 1.0 - alpha, alpha)
    beta = torch.where(flip, 1.0 - beta, beta)
    pts = o + alpha * a + beta * b
    if vert_features is None:
        return pts
    bary = torch.cat((alpha, beta, 1.0 - alpha - beta), dim=-1)
    return pts, torch.einsum("sk,skc->sc", bary, vert_features[sf])


def sample_points_on_mesh_surface(gen, verts, faces, n_sample: int,
                                  vert_features=None, face_mask=None):
    """Area-weighted uniform surface sampling: the triangle draws, then
    alpha and beta."""
    idx = sample_mesh_triangle(gen, verts, faces, n_sample,
                               face_mask=face_mask)
    return sample_points_on_mesh_faces(gen, verts, faces, idx,
                                       vert_features=vert_features)


def sample_X_in_box(gen, x_range, n_sample: int, u=None, device=None):
    """Uniform points in the centred box of side(s) ``x_range``; ``u``
    (n_sample, 3) injects the draws."""
    if u is None:
        u = _rand(gen, (n_sample, 3), device or gen.device)
    return -x_range / 2.0 + x_range * u


def sample_X_in_ball(gen, x_radius: float, n_sample: int, normal=None,
                     u=None, device=None):
    """Points in the centred ball of radius x_radius with the reference's
    radius law r = R sqrt(U) (not volume-uniform). Draws: directions
    ``normal`` (n_sample, 3), then ``u`` (n_sample, 1)."""
    if normal is None:
        normal = _rand(gen, (n_sample, 3), device or gen.device, normal=True)
    if u is None:
        u = _rand(gen, (n_sample, 1), normal.device)
    units = normal / torch.clamp(torch.linalg.norm(normal, dim=1,
                                                   keepdim=True), min=1e-12)
    return x_radius * torch.sqrt(u) * units


def random_permutation_take(gen, x, n_keep: int, perm=None):
    """x[randperm(len(x))[:n_keep]]; ``perm`` injects the permutation."""
    if perm is None:
        perm = torch.randperm(x.shape[0], generator=gen,
                              device=gen.device).to(x.device)
    return x[perm[:n_keep]]


def random_subsample_mask(gen, mask, n_keep: int, big: float = 1e9):
    """n_keep random indices among the True entries of ``mask`` (fixed shape).

    Returns (idx (n_keep,), valid (n_keep,)); valid is False where fewer than
    n_keep entries were available."""
    scores = _rand(gen, mask.shape, mask.device) \
        + torch.where(mask, 0.0, big)
    vals, idx = smallest_k(scores, n_keep)
    return idx, vals < big * 0.5
