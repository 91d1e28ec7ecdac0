"""Dataset walkers and GT artifact loaders, on the host in numpy (the
port's copy of macarons_tpu/data/datasets.py, without ``RGBDataset``).

ShapeNet split JSONs -> model paths; per-mesh GT tensors in
``<model_dir>/tensors/`` (this package's and the JAX package's ``.npz``, or
the reference's ``.pt``). Loaders return fixed-shape padded arrays with
masks. Every draw comes from a ``numpy.random.Generator`` in the JAX
package's order, so the same seed assembles the same batch bit for bit.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np


# ---------------------------------------------------------------------------
# Split walkers
# ---------------------------------------------------------------------------


class CustomDataset:
    """Legacy generic `.obj` walker with a file-size threshold filter
    (reference CustomDataset.py:23-95 — dead in the reference's training
    paths, kept for API completeness). Items are obj paths; meshes above
    `memory_threshold` bytes are skipped."""

    def __init__(self, data_path: str, memory_threshold: Optional[int] = None):
        self.data_path = data_path
        self.paths: List[str] = []
        for root, _dirs, files in os.walk(data_path):
            for f in sorted(files):
                if not f.endswith(".obj"):
                    continue
                p = os.path.join(root, f)
                if memory_threshold is not None \
                        and os.path.getsize(p) > memory_threshold:
                    continue
                self.paths.append(p)

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, i) -> str:
        return self.paths[i]


class ShapeNetDataset:
    """Model-path dataset over the reference split JSONs
    ({"models": ["<synset>/<id>/model.obj", ...]})."""

    def __init__(self, data_path: str, split_file: str):
        with open(os.path.join(data_path, split_file)) as f:
            models = json.load(f)["models"]
        self.data_path = data_path
        self.paths = [os.path.join(data_path, m) for m in models]

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, i) -> str:
        return self.paths[i]


def get_shapenet_datasets(data_path: str, test_novel: bool = False):
    """(train, val, test) datasets using the reference split files
    (scone_utils.py:101-219)."""
    train = ShapeNetDataset(data_path, "train_list.json")
    val = ShapeNetDataset(data_path, "val_list.json")
    test_file = "all_test_novel_list.json" if test_novel else "all_test_list.json"
    test = ShapeNetDataset(data_path, test_file)
    return train, val, test


def iterate_batches(paths: Sequence[str], batch_size: int, *, shuffle: bool,
                    seed: int = 0, epoch: int = 0, world_size: int = 1,
                    rank: int = 0, drop_last: bool = True):
    """Shard + batch path lists: a seeded shuffle per epoch, then every
    ``world_size``-th path from ``rank``."""
    idx = np.arange(len(paths))
    if shuffle:
        rs = np.random.default_rng(seed + epoch)
        rs.shuffle(idx)
    idx = idx[rank::world_size]
    n_full = len(idx) // batch_size
    for b in range(n_full):
        yield [paths[i] for i in idx[b * batch_size : (b + 1) * batch_size]]
    if not drop_last and len(idx) % batch_size:
        yield [paths[i] for i in idx[n_full * batch_size :]]


# ---------------------------------------------------------------------------
# GT artifact loaders (npz ours / pt reference)
# ---------------------------------------------------------------------------


def _tensors_dir(model_path: str) -> str:
    return os.path.join(os.path.dirname(model_path), "tensors")


def _load_artifact(model_path: str, stem: str) -> Dict[str, np.ndarray]:
    d = _tensors_dir(model_path)
    npz = os.path.join(d, stem + ".npz")
    if os.path.exists(npz):
        return dict(np.load(npz))
    pt = os.path.join(d, stem + ".pt")
    if os.path.exists(pt):
        import torch

        data = torch.load(pt, map_location="cpu")
        out = {}
        for k, v in data.items():
            if isinstance(v, list):
                v = torch.stack([t if t.ndim == 2 else t.reshape(-1, t.shape[-1])
                                 for t in v]) if all(
                    t.shape == v[0].shape for t in v) else v
            if hasattr(v, "numpy"):
                out[k] = v.numpy()
            else:
                out[k] = np.asarray(v)
        return out
    raise FileNotFoundError(f"no {stem} artifact under {d}")


def get_gt_partial_point_clouds(model_path: str, normalization_factor: float = 1.0):
    """(part_pc (C, L, 3), part_mask (C, L), coverage (C, S))
    — reference scone_utils.py:571-595. Reference .pt stores variable-length
    clouds; those are padded here."""
    d = _load_artifact(model_path, "partial_point_clouds")
    pc = d["partial_point_cloud"]
    if "partial_point_cloud_mask" in d:
        mask = d["partial_point_cloud_mask"].astype(bool)
        pc = np.asarray(pc, np.float32)
    else:
        # reference .pt: list of (Ni, 3) -> pad to max
        pcs = [np.asarray(p, np.float32) for p in pc]
        L = max(len(p) for p in pcs)
        out = np.zeros((len(pcs), L, 3), np.float32)
        mask = np.zeros((len(pcs), L), bool)
        for i, p in enumerate(pcs):
            out[i, : len(p)] = p
            mask[i, : len(p)] = True
        pc = out
    if normalization_factor != 1.0:
        pc = pc * normalization_factor
    cov = np.asarray(d["coverage"], np.float32)
    return pc, mask, cov


def get_gt_occupancy_field(model_path: str):
    """(X_world (N, 3), occs (N, 1)) — reference scone_utils.py:598-616."""
    d = _load_artifact(model_path, "occupancy_field")
    f = np.asarray(d["occupancy_field"], np.float32)
    return f[..., :3], f[..., 3:]


def get_gt_surface(model_path: str, surface_epsilon: Optional[float] = None,
                   normalization_factor: float = 1.0):
    """(gt_surface (S, 3), epsilon) — reference scone_utils.py:619-636."""
    d = _load_artifact(model_path, "surface_points")
    surf = np.asarray(d["surface_points"], np.float32)
    eps = float(d["epsilon"]) if surface_epsilon is None else surface_epsilon
    if normalization_factor != 1.0:
        surf = surf * normalization_factor
        eps = eps * normalization_factor
    return surf, eps


# ---------------------------------------------------------------------------
# Fixed-shape batch assembly for the SCONE pretrainers (host-side)
# ---------------------------------------------------------------------------


def assemble_occ_batch(rs: np.random.Generator, paths: Sequence[str],
                       X_cam_world: np.ndarray, n_view_min: int, n_view_max: int,
                       seq_len: int, n_sample: int,
                       n_views: Optional[Sequence[int]] = None,
                       prediction_in_random_camera_space: bool = False):
    """One fixed-shape SconeOcc pretraining batch.

    Per mesh: pick n_view in [min,max] random candidate views, pick the
    prediction camera (first view by default), stack + subsample the partial
    clouds to n_view_max*seq_len (padded, masked), subsample n_sample GT query
    points. The step normalises the space on the device.

    Returns a dict of numpy arrays:
      pc (B, n_view_max*seq_len, 3), pc_mask (B, n_view_max*seq_len),
      X (B, n_sample, 3), occs (B, n_sample, 1),
      view_idx (B, n_view_max) int, view_mask (B, n_view_max),
      pred_cam_idx (B,) int.
    """
    B = len(paths)
    n_cam = X_cam_world.shape[0]
    L = n_view_max * seq_len
    pc = np.zeros((B, L, 3), np.float32)
    pc_mask = np.zeros((B, L), bool)
    X = np.zeros((B, n_sample, 3), np.float32)
    occs = np.zeros((B, n_sample, 1), np.float32)
    view_idx = np.zeros((B, n_view_max), np.int32)
    view_mask = np.zeros((B, n_view_max), bool)
    pred_cam_idx = np.zeros((B,), np.int32)

    for i, path in enumerate(paths):
        part_pc, part_mask, _ = get_gt_partial_point_clouds(path)
        X_world, occ = get_gt_occupancy_field(path)

        n_view = (
            int(n_views[i]) if n_views is not None
            else int(rs.integers(n_view_min, n_view_max + 1))
        )
        vidx = rs.permutation(n_cam)[:n_view]
        view_idx[i, :n_view] = vidx
        view_mask[i, :n_view] = True
        pred_cam_idx[i] = (
            int(rs.integers(0, n_cam)) if prediction_in_random_camera_space
            else int(vidx[0])
        )

        pts = np.concatenate([part_pc[v][part_mask[v]] for v in vidx], axis=0)
        take = min(len(pts), n_view * seq_len)
        sel = rs.permutation(len(pts))[:take]
        pc[i, :take] = pts[sel]
        pc_mask[i, :take] = True

        xsel = rs.permutation(len(X_world))[:n_sample]
        X[i] = X_world[xsel]
        occs[i] = occ[xsel]

    return {
        "pc": pc, "pc_mask": pc_mask, "X": X, "occs": occs,
        "view_idx": view_idx, "view_mask": view_mask,
        "pred_cam_idx": pred_cam_idx,
    }


def get_validation_n_views_list(paths_count: int, n_view_min: int, n_view_max: int,
                                seed: int = 0):
    """Deterministic per-sample view counts for comparable validation
    (reference scone_utils.py:683-696)."""
    rs = np.random.default_rng(seed)
    return rs.integers(n_view_min, n_view_max + 1, paths_count)
