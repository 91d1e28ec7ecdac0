"""NBV scoring with the candidates split over data-parallel ranks (port of
macarons_tpu/parallel/nbv.py: ``make_sharded_coverage_gain_fn`` and
``pad_candidates``).

On one card the scorer evaluates every candidate in one launch of the
SH-visibility kernel. Across ranks the candidates are an embarrassingly
parallel axis: the scene field and SconeVis are every rank's, each rank
scores its contiguous share of the (padded) candidates, and the (C,)
gains are put together by an all-reduce of zero-padded rows, so the
argmax is the same on every rank.
"""

from __future__ import annotations

import torch

from ..ops.geometry import FoVCamera
from . import mesh

CAMERA_FIELDS = ("R", "T", "fov", "znear", "zfar", "aspect_ratio")


def pad_candidates(cand_cams: FoVCamera, cand_X, multiple: int):
    """Pad the candidate axis to a multiple of ``multiple`` by repeating the
    last candidate. Returns (cams, X, true count); callers slice the gains
    back to the true count."""
    C = cand_X.shape[0]
    pad = (-C) % multiple
    if pad == 0:
        return cand_cams, cand_X, C

    def pad_leaf(x):
        return torch.cat([x, x[-1:].expand(pad, *x.shape[1:])], dim=0)

    cams = FoVCamera(*(pad_leaf(getattr(cand_cams, f))
                       for f in CAMERA_FIELDS))
    return cams, pad_leaf(cand_X), C


def make_sharded_coverage_gain_fn(base_fn):
    """Wrap a per-candidate scorer (``scene.runtime.CoverageGain``'s call
    or ``gains``, bound to nothing: ``base_fn(vis_model, X_world,
    harmonics, occ, valid, cand_cams, cand_X, prediction_camera,
    box_diag, cell_resolution, sensor_range, generator=None,
    sample_idx=None) -> (C,)``) so that each data-parallel rank scores its
    share of the candidates and every rank returns all C gains.

    The candidates are padded to a multiple of the world (the last one
    repeated); a rank's Monte-Carlo draws are its rows of the draw at the
    unpadded (C, seq_len) shape (``mesh.RowDraws``), and injected sample
    indices are padded and sliced alike, so each candidate draws as in one
    process. The shared-sample scorer's one sample over the union of the
    candidates' fields of view does not split, and raises across ranks.
    At world 1 this is ``base_fn``."""

    def run(vis_model, X_world, harmonics, occ, valid, cand_cams, cand_X,
            prediction_camera, box_diag, cell_resolution, sensor_range,
            generator=None, sample_idx=None):
        W = mesh.world()
        if W == 1:
            return base_fn(vis_model, X_world, harmonics, occ, valid,
                           cand_cams, cand_X, prediction_camera, box_diag,
                           cell_resolution, sensor_range,
                           generator=generator, sample_idx=sample_idx)
        scorer = getattr(base_fn, "__self__", base_fn)
        if getattr(scorer, "shared_sample", False):
            raise ValueError("the shared-sample scorer does not split over "
                             "ranks; score per candidate")
        cams, X, C = pad_candidates(cand_cams, cand_X, W)
        rows = mesh.shard_rows(X.shape[0])
        gen = (None if generator is None
               else mesh.RowDraws(generator, C, rows.start))
        if sample_idx is not None:
            pad = X.shape[0] - C
            sample_idx = torch.cat([sample_idx, sample_idx[-1:].expand(
                pad, *sample_idx.shape[1:])])[rows]
        local = base_fn(
            vis_model, X_world, harmonics, occ, valid,
            FoVCamera(*(getattr(cams, f)[rows] for f in CAMERA_FIELDS)),
            X[rows], prediction_camera, box_diag, cell_resolution,
            sensor_range, generator=gen, sample_idx=sample_idx)
        full = torch.zeros(X.shape[0], dtype=local.dtype,
                           device=local.device)
        full[rows] = local
        return mesh.all_reduce_(full)[:C]

    return run
