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

import os
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import Params
from ..data import datasets as D
from ..models.attention import init_weights
from ..models.scone import SconeOcc
from ..ops.geometry import look_at_view_transform
from ..ops.view_state import (
    compute_view_harmonics,
    compute_view_state,
    get_cameras_on_sphere,
    normalize_points_in_prediction_box,
    view_harmonics_weights,
)
from ..parallel import distributed, mesh
from ..utils.checkpoint import checkpoint_exists, load_checkpoint, \
    save_checkpoint
from ..utils.device import make_generator, resolve_device
from ..utils.schedule import warmup_constant_schedule

# optax.adamw's default weight decay, which the JAX pretrainers take.
WEIGHT_DECAY = 1e-4


def build_model(params: Params) -> SconeOcc:
    return SconeOcc(seq_len=params.seq_len,
                    n_scale=0 if params.get("no_local_features", False)
                    else 3)


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


def occ_loss(params: Params, model: SconeOcc, consts: StepConstants, batch,
             generator=None):
    """MSE of SconeOcc's occupancy on a device batch; ``generator``
    randomises SconeOcc's down-samples (None: deterministic). Over several
    ranks ``batch`` is this rank's rows and the loss is its share of the
    global batch's MSE (the rows' mean over the world); ``generator`` then
    draws at the global batch's shape."""
    B = batch["pc"].shape[0]
    idx = batch["pred_cam_idx"].long()
    pc = to_prediction_box(params, consts, batch["pc"], idx)
    X = to_prediction_box(params, consts, batch["X"], idx)
    X_cam_all = to_prediction_box(
        params, consts, consts.X_cam[None].expand(B, -1, -1), idx)
    X_view = X_cam_all.gather(
        1, batch["view_idx"].long()[..., None].expand(-1, -1, 3))
    vh = view_harmonics(params, consts, X, X_view, batch["view_mask"])
    if params.get("no_view_harmonics", False):
        vh = vh * 0.0
    pred = model(pc, X, vh, pc_mask=batch["pc_mask"],
                 generator=mesh.rank_rows(generator, B))
    return torch.mean((pred - batch["occs"]) ** 2) / mesh.world()


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


def run_training(params: Params, data_path: Optional[str] = None,
                 weights_dir: str = "weights/scone/occupancy",
                 max_batches_per_epoch: Optional[int] = None,
                 device="cuda", verbose: bool = True):
    """The pretraining loop on ``device`` ("cuda" unless the caller asks
    for the CPU): training batches, validation at the deterministic view
    counts, ``unvalidated_<name>`` (the resume point, with the optimizer)
    and ``best_unval_<name>`` checkpoints every epoch; with
    ``start_from_scratch`` false it resumes from ``unvalidated_<name>``.
    In a group of W ranks (``parallel.distributed``) the global batch is
    ``batch_size`` x W and the losses are the global batches'. Returns
    (model, train losses, validation losses)."""
    dev = resolve_device(device)
    data_path = data_path or params.data_path
    rs = np.random.default_rng(params.get("random_seed", 42))
    gen = make_generator(dev, params.get("torch_seed", 5))
    train_ds, val_ds, _ = D.get_shapenet_datasets(data_path)
    batch_size = params.batch_size * mesh.world()
    steps_per_epoch = max(len(train_ds) // batch_size, 1)
    verbose = verbose and distributed.is_master()

    model = init_weights(build_model(params).to(dev), gen)
    opt, schedule = make_optimizer(params, model, steps_per_epoch)
    name = params.get("scone_occ_model_name", "scone_occ")
    best_loss = float("inf")
    start_epoch, step = 0, 0
    train_losses, val_losses = [], []
    resume_path = os.path.join(weights_dir, f"unvalidated_{name}")
    if (not params.get("start_from_scratch", True)
            and checkpoint_exists(resume_path)):
        meta = load_checkpoint(resume_path, model, opt)
        start_epoch = int(meta.get("epoch", -1)) + 1
        step = int(meta["step"])
        best_loss = float(meta.get("best_loss", best_loss))
        train_losses = list(meta.get("train_losses", []))
        val_losses = list(meta.get("val_losses", []))
    mesh.broadcast_module(model)

    consts = step_constants(params, dev)
    X_cam_np = consts.X_cam.cpu().numpy()

    def make_batch(paths, n_views=None):
        """This rank's rows of the global batch of ``paths``."""
        return batch_to_device(mesh.shard_batch(D.assemble_occ_batch(
            rs, paths, X_cam_np, params.n_view_min, params.n_view_max,
            params.seq_len, params.n_sample, n_views=n_views,
            prediction_in_random_camera_space=params.get(
                "prediction_in_random_camera_space", False))), dev)

    for epoch in range(start_epoch, params.epochs):
        t0 = time.time()
        model.train()
        epoch_loss, n_steps = 0.0, 0
        for paths in D.iterate_batches(train_ds.paths, batch_size,
                                       shuffle=True,
                                       seed=params.get("random_seed", 42),
                                       epoch=epoch):
            if max_batches_per_epoch and n_steps >= max_batches_per_epoch:
                break
            loss = occ_loss(params, model, consts, make_batch(paths), gen)
            optimizer_step(opt, schedule, step, loss)
            step += 1
            epoch_loss += mesh.all_reduce_sum(loss).item()
            n_steps += 1
        train_loss = epoch_loss / max(n_steps, 1)
        train_losses.append(train_loss)

        model.eval()
        val_loss, n_val, vi = 0.0, 0, 0
        n_views_all = D.get_validation_n_views_list(
            len(val_ds), params.n_view_min, params.n_view_max)
        with torch.no_grad():
            for paths in D.iterate_batches(val_ds.paths, batch_size,
                                           shuffle=False):
                if max_batches_per_epoch and n_val >= max_batches_per_epoch:
                    break
                nv = n_views_all[vi:vi + len(paths)]
                vi += len(paths)
                val_loss += float(mesh.all_reduce_sum(occ_loss(
                    params, model, consts, make_batch(paths, nv), gen)))
                n_val += 1
        val_loss /= max(n_val, 1)
        val_losses.append(val_loss)

        meta = {"epoch": epoch, "loss": train_loss, "best_loss": best_loss,
                "train_losses": train_losses, "val_losses": val_losses}
        save_checkpoint(os.path.join(weights_dir, f"unvalidated_{name}"),
                        model, meta, opt=opt, step=step)
        if train_loss < best_loss:
            best_loss = meta["best_loss"] = train_loss
            save_checkpoint(os.path.join(weights_dir, f"best_unval_{name}"),
                            model, meta)
        if verbose:
            print(f"epoch {epoch}: train {train_loss:.6f} val {val_loss:.6f} "
                  f"({time.time() - t0:.1f}s)")
    return model, train_losses, val_losses
