"""SCONE networks and the batched coverage-gain evaluation (port of
macarons_tpu/models/scone.py).

SconeOcc predicts an occupancy probability per query point from a surface
cloud; SconeVis predicts per-point spherical-harmonic visibility
coefficients. Architectures, widths and submodule names are the JAX
package's. ``compute_visibilities`` is the NBV scorer's SH integral: on CUDA
tensors it runs the hand-written kernel (ops/cuda/sh_visibility.py).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from ..ops.cuda.sh_visibility import MAX_HARMONIC_RANK, sh_visibility
from ..ops.knn import knn_points_many, smallest_k
from ..parallel import mesh
from .attention import Dense, Embedding, Encoder, PCTransformer, _act, \
    gelu, layer_norm


class XEmbedding(nn.Module):
    """Query-point MLP embedding."""

    def __init__(self, x_dim: int = 3, x_embedding_dim: int = 512,
                 gelu: bool = True):
        super().__init__()
        d = x_embedding_dim
        self.act = _act(gelu)
        self.Dense_0 = Dense(x_dim, d // 4)
        self.Dense_1 = Dense(d // 4, d // 2)
        self.Dense_2 = Dense(d // 2, d)

    def forward(self, x):
        x = self.act(self.Dense_0(x))
        x = self.act(self.Dense_1(x))
        return self.act(self.Dense_2(x))


def _subsample(length: int, total: int, valid=None, gen=None):
    """Indices of a ``length``-subset of range(total), valid entries first.

    Without ``gen`` the choice is deterministic (the first valid entries in
    index order), as in the JAX package with ``key=None``."""
    device = None if valid is None else valid.device
    if valid is None:
        if gen is None or length >= total:
            return torch.arange(min(length, total))
        base = mesh.base_generator(gen)
        return torch.randperm(total, generator=base, device=base.device)[
            :length]
    if gen is None:
        noise = torch.arange(total, dtype=torch.float32, device=device) / total
        noise = noise.expand(valid.shape)
    else:
        noise = mesh.rand_rows(gen, valid.shape, device)
    scores = noise + torch.where(valid, 0.0, 2.0)
    return smallest_k(scores, min(length, total))[1]


def _take(x, idx):
    """x (B, L, D), idx (B, M) -> (B, M, D)."""
    return torch.gather(x, 1, idx[..., None].expand(*idx.shape, x.shape[-1]))


class SconeOcc(nn.Module):
    """Occupancy-probability field: (point cloud, query x, view harmonics) ->
    occupancy (B, S, output_dim)."""

    def __init__(self, seq_len: int = 2048, pts_dim: int = 3,
                 pts_embedding_dim: int = 128, concatenate_input: bool = True,
                 n_code: int = 2, n_heads: int = 4, FF: bool = True,
                 gelu: bool = True, global_feature_dim: int = 512,
                 n_scale: int = 3, local_feature_dim: int = 256,
                 k_for_knn: int = 16, x_dim: int = 3,
                 x_embedding_dim: int = 512, n_harmonics: int = 64,
                 output_dim: int = 1):
        super().__init__()
        self.seq_len = seq_len
        self.n_scale = n_scale
        self.k_for_knn = k_for_knn
        self.local_feature_dim = local_feature_dim
        self.act = _act(gelu)
        pct = dict(pts_dim=pts_dim, pts_embedding_dim=pts_embedding_dim,
                   concatenate_input=concatenate_input, n_code=n_code,
                   n_heads=n_heads, FF=FF, gelu=gelu)
        self.global_transformer = PCTransformer(feature_dim=global_feature_dim,
                                                **pct)
        for i in range(n_scale):
            setattr(self, f"local_transformers_{i}",
                    PCTransformer(feature_dim=local_feature_dim, **pct))
        self.x_embedding = XEmbedding(x_dim, x_embedding_dim, gelu)
        head_in = (global_feature_dim + n_scale * local_feature_dim
                   + x_embedding_dim + n_harmonics)
        self.Dense_0 = Dense(head_in, 512)
        self.Dense_1 = Dense(512, 256)
        self.Dense_2 = Dense(256, output_dim)

    def forward(self, pc, x, view_harmonics, pc_mask=None, generator=None):
        """pc (B, L, 3); x (B, S, 3); view_harmonics (B, S, H); pc_mask (B, L)
        marks valid cloud points; ``generator`` randomises the down-samples
        (None: deterministic)."""
        B, L = pc.shape[0], pc.shape[1]
        S = x.shape[1]

        def down(cloud, mask, length):
            if mask is None:
                idx = _subsample(length, cloud.shape[1], gen=generator)
                return cloud[:, idx.to(cloud.device)], None
            idx = _subsample(length, cloud.shape[1], mask, generator)
            return _take(cloud, idx), torch.gather(mask, 1, idx)

        global_pc, g_mask = down(pc, pc_mask, self.seq_len)
        global_features = self.global_transformer(global_pc, pts_mask=g_mask)

        if self.n_scale > 1:
            ds_factor = int(np.power(L / (self.k_for_knn * 8),
                                     1.0 / (self.n_scale - 1)))
            if ds_factor == 0:
                ds_factor = 2
        else:
            ds_factor = 1

        clouds = [(pc, pc_mask)][:self.n_scale]
        for _ in range(self.n_scale - 1):
            ds_len = max(clouds[-1][0].shape[1] // ds_factor, self.k_for_knn)
            clouds.append(down(*clouds[-1], ds_len))
        neighbours = knn_points_many([(x, c, m) for c, m in clouds],
                                     self.k_for_knn)
        local_feats = []
        for n_t, (local_pc, _, _) in enumerate(neighbours):
            local_pc = local_pc - x[:, :, None, :]
            feats = getattr(self, f"local_transformers_{n_t}")(
                local_pc.reshape(-1, self.k_for_knn, 3))
            local_feats.append(feats.reshape(B, S, self.local_feature_dim))

        x_features = self.x_embedding(x)
        g = global_features[:, None, :].expand(B, S, global_features.shape[-1])
        res = torch.cat([g] + local_feats + [x_features, view_harmonics], dim=-1)
        res = self.act(self.Dense_0(res))
        res = self.act(self.Dense_1(res))
        return self.act(self.Dense_2(res))


class SconeVis(nn.Module):
    """Visibility-gain transformer: (B, L, 4) points [xyz + occ] and view
    harmonics -> per-point SH coefficients (B, L, n_harmonics)."""

    def __init__(self, pts_dim: int = 4, pts_embedding_dim: int = 256,
                 n_heads: int = 4, n_code: int = 3, n_harmonics: int = 64,
                 FF: bool = True, gelu: bool = True,
                 use_view_state: bool = True, use_global_feature: bool = True,
                 view_state_mode: str = "end", concatenate_input: bool = True,
                 k_for_knn: int = 0):
        super().__init__()
        self.n_code = n_code
        self.view_state_start = use_view_state and view_state_mode == "start"
        self.view_state_end = use_view_state and view_state_mode == "end"
        self.embedding = Embedding(
            pts_dim, pts_embedding_dim, gelu=gelu,
            global_feature=use_global_feature,
            additional_feature_dim=n_harmonics if self.view_state_start else 0,
            concatenate_input=concatenate_input, k_for_knn=k_for_knn)
        for i in range(n_code):
            setattr(self, f"encoders_{i}", Encoder(
                pts_embedding_dim, pts_embedding_dim // 4, n_heads, gelu, FF))
        self.LayerNorm_0 = layer_norm(pts_embedding_dim)
        inner = (3 if self.view_state_end else 4) * n_harmonics
        self.fc1 = Dense(pts_embedding_dim, inner)
        self.fc2 = Dense(inner + (n_harmonics if self.view_state_end else 0),
                         2 * n_harmonics)
        self.fc3 = Dense(2 * n_harmonics, n_harmonics)

    def forward(self, pts, view_harmonics=None, mask=None, pts_mask=None):
        if mask is None and pts_mask is not None:
            mask = pts_mask[..., None, :]
        x = self.embedding(
            pts, additional_feature=view_harmonics if self.view_state_start
            else None, pts_mask=pts_mask)
        for i in range(self.n_code):
            x = getattr(self, f"encoders_{i}")(x, mask=mask)
        res = gelu(self.fc1(self.LayerNorm_0(x)))
        if self.view_state_end:
            res = torch.cat((res, view_harmonics), dim=-1)
        return self.fc3(gelu(self.fc2(res)))


def compute_visibilities(pts, harmonics, X_cam, max_harmonic_rank: int = 8,
                         use_sigmoid: bool = True):
    """Visibility of every point from every candidate camera, in one launch.

    pts (B, L, >=3); harmonics (B, L, 64); X_cam (B, C, 3) -> (B, C, L)."""
    if max_harmonic_rank != MAX_HARMONIC_RANK:
        raise ValueError(f"the SH visibility kernel is built for degree "
                         f"{MAX_HARMONIC_RANK}, got {max_harmonic_rank}")
    return sh_visibility(pts, harmonics, X_cam, use_sigmoid=use_sigmoid)


def compute_coverage_gain(pts, harmonics, X_cam, pts_mask=None,
                          max_harmonic_rank: int = 8, use_sigmoid: bool = True):
    """(B, C) mean per-point visibility (sum / seq_len; padded points zeroed
    by pts_mask, the denominator stays seq_len)."""
    vis = compute_visibilities(pts, harmonics, X_cam,
                               max_harmonic_rank=max_harmonic_rank,
                               use_sigmoid=use_sigmoid)
    if pts_mask is not None:
        vis = vis * pts_mask[:, None, :]
    return vis.sum(dim=-1) / pts.shape[1]


def compute_occupancy_probability(occ_model, pc, X, view_harmonics,
                                  pc_mask=None, generator=None,
                                  max_points_per_pass: int = 20000):
    """SconeOcc over many query points, max_points_per_pass // B queries
    of each cloud per pass, so the kNN distance matrices never hold every
    query at once. Every pass takes the same random down-samples (the
    generator's state is reset before each), as the JAX package applies
    one key to every chunk.

    pc (B, L, 3); X (B, S, 3); view_harmonics (B, S, H) -> (B, S, 1)."""
    B, S = X.shape[0], X.shape[1]
    chunk = max(min(max_points_per_pass // max(B, 1), S), 1)
    state = None if generator is None else generator.get_state()
    out = []
    for a in range(0, S, chunk):
        if state is not None:
            generator.set_state(state)
        out.append(occ_model(pc, X[:, a:a + chunk],
                             view_harmonics[:, a:a + chunk],
                             pc_mask=pc_mask, generator=generator))
    return torch.cat(out, dim=1)


def compute_coverage_gain_multiple(pts, harmonics, X_cam, n_cam: int,
                                   max_harmonic_rank: int = 8,
                                   use_sigmoid: bool = True):
    """Joint gain of every ordered n_cam-tuple of candidates: the mean over
    points of the best visibility among the tuple's cameras.

    Returns (gains (B, C**n_cam), idx (C**n_cam, n_cam)), tuples in
    row-major order of their camera indices."""
    if n_cam not in (2, 3):
        raise ValueError("n_cam must be 2 or 3")
    vis = compute_visibilities(pts, harmonics, X_cam,
                               max_harmonic_rank=max_harmonic_rank,
                               use_sigmoid=use_sigmoid)  # (B, C, L)
    C = X_cam.shape[1]
    grids = torch.meshgrid(*([torch.arange(C, device=vis.device)] * n_cam),
                           indexing="ij")
    idx = torch.stack([g.reshape(-1) for g in grids], dim=-1)
    gains = vis[:, idx].amax(dim=-2).sum(dim=-1) / pts.shape[1]
    return gains, idx
