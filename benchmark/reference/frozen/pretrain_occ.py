"""SconeOcc pretraining on ShapeNet GT occupancy fields (port of
macarons_tpu/trainers/pretrain_occ.py), on one card or data-parallel over
the ranks of ``parallel.distributed``.

Per step: a fixed-shape batch assembled on the host
(data.datasets.assemble_occ_batch), the clouds, queries and visited
cameras moved into each item's prediction-camera view space and
normalised into its prediction box, view harmonics of the queries,
SconeOcc, MSE against the GT occupancy, AdamW under the warm-up schedule.

Over W ranks, as the JAX package over a mesh of W devices, the global
batch is ``batch_size`` x W: every rank assembles the same global batch
from the same numpy generator and keeps its contiguous rows; SconeOcc's
down-sample draws are taken at the global batch's shape and sliced
(``parallel.mesh.RowDraws``); each rank back-propagates its share of the
global mean and the gradients are summed over the ranks before one AdamW
step on every rank. Rank 0 writes the checkpoints.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .geometry import look_at_view_transform
from .view_state import (
    compute_view_harmonics,
    compute_view_state,
    get_cameras_on_sphere,
    normalize_points_in_prediction_box,
    view_harmonics_weights,
)
from . import mesh
from .schedule import warmup_constant_schedule

# optax.adamw's default weight decay, which the JAX pretrainers take.
WEIGHT_DECAY = 1e-4


def candidate_camera_poses(params: Params, device=None):
    """World positions and (R, T) of the candidate cameras."""
    X_cam, _, _, _ = get_cameras_on_sphere(
        params.n_camera_elev, params.n_camera_azim, params.camera_dist,
        pole_cameras=params.pole_cameras, device=device)
    R, T = look_at_view_transform(X_cam, torch.zeros_like(X_cam))
    return X_cam, R, T


class StepConstants(NamedTuple):
    """What every step of a pretrainer reads: the candidate cameras, the
    view-harmonic weights and the prediction box's centre."""

    X_cam: torch.Tensor  # (n_cam, 3) world
    R: torch.Tensor  # (n_cam, 3, 3)
    T: torch.Tensor  # (n_cam, 3)
    harmonic_weights: torch.Tensor  # (H, n_elev * n_azim)
    box_center: torch.Tensor  # (3,)


def step_constants(params: Params, device) -> StepConstants:
    X_cam, R, T = candidate_camera_poses(params, device)
    w = view_harmonics_weights(params.harmonic_degree,
                               params.view_state_n_elev,
                               params.view_state_n_azim, device)
    center = torch.tensor([0.0, 0.0, params.camera_dist], device=device)
    return StepConstants(X_cam, R, T, w, center)


def to_prediction_box(params: Params, consts: StepConstants, pts,
                      pred_cam_idx):
    """World points (B, N, 3) -> the view space of each item's prediction
    camera, normalised into its prediction box."""
    R = consts.R[pred_cam_idx]
    T = consts.T[pred_cam_idx]
    view = torch.matmul(pts, R) + T[:, None, :]
    return normalize_points_in_prediction_box(view, consts.box_center,
                                              params.gt_max_diagonal)


def view_harmonics(params: Params, consts: StepConstants, X, X_view,
                   view_mask):
    """Harmonic features (B, S, H) of the queries X (B, S, 3) seen from the
    visited cameras X_view (B, V, 3) where view_mask (B, V)."""
    vs = compute_view_state(X, X_view, params.view_state_n_elev,
                            params.view_state_n_azim, view_mask=view_mask)
    return compute_view_harmonics(vs, consts.harmonic_weights)


def batch_to_device(batch, device):
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def make_optimizer(params: Params, model: torch.nn.Module,
                   steps_per_epoch: int):
    """AdamW as optax.adamw, and the learning rate as a function of the
    optimizer steps taken."""
    opt = torch.optim.AdamW(model.parameters(), lr=params.learning_rate,
                            weight_decay=WEIGHT_DECAY)
    schedule = warmup_constant_schedule(
        params.learning_rate, params.warmup,
        lr_epochs=(params.get("lr_epochs", [])
                   if params.get("schedule_learning_rate") else []),
        lr_factor=params.get("lr_factor", 1.0),
        steps_per_epoch=steps_per_epoch)
    return opt, schedule


def optimizer_step(opt, schedule, step: int, loss):
    """One AdamW step at the schedule's rate for ``step``; over several
    ranks, on the gradients summed over them."""
    for g in opt.param_groups:
        g["lr"] = schedule(step)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    mesh.all_reduce_grads(p for g in opt.param_groups for p in g["params"])
    opt.step()

