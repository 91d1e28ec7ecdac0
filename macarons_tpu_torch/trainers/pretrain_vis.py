"""SconeVis (coverage-gain) pretraining on ShapeNet (port of
macarons_tpu/trainers/pretrain_vis.py), on one card.

Per item: proxy points drawn uniformly in the prediction box, kept where
they project inside the observed cloud's box from every visited camera;
their view harmonics; a frozen pretrained SconeOcc's occupancy (no grad);
seq_len occupancy-weighted Monte-Carlo samples; SconeVis's harmonics; the
coverage gain of all 52 candidates in one launch of the SH-visibility
kernel (B3) per batch, whose backward kernel carries the loss's gradient
to SconeVis. The loss is the uncentred L1 between predicted and GT gain
distributions, the GT from the precomputed coverage matrices.

Over W ranks (``parallel.distributed``) the global batch is ``batch_size``
x W, as the JAX package's over a mesh: every rank assembles the global
batch and keeps its rows, the proxy points are drawn at the global shape
and sliced, and each item's SconeOcc down-samples and Monte-Carlo sample
come from a generator of its own, seeded from a draw at the global batch's
shape, so an item draws the same on any rank and at any world. The
gradients of the ranks' shares of the loss are summed before the AdamW
step, and the NBV metric's sums are summed over the ranks.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from ..config import Params
from ..data import datasets as D
from ..models import losses as L
from ..models.attention import init_weights
from ..models.scone import (
    SconeOcc,
    SconeVis,
    compute_coverage_gain,
    compute_occupancy_probability,
)
from ..ops.geometry import FoVCamera, look_at_view_transform
from ..ops.view_state import filter_proxy_points_mask, sample_proxy_points
from ..parallel import distributed, mesh
from ..utils.checkpoint import checkpoint_exists, load_checkpoint, \
    save_checkpoint
from ..utils.device import make_generator, resolve_device
from .pretrain_occ import (
    StepConstants,
    batch_to_device,
    build_model as build_occ_model,
    make_optimizer,
    optimizer_step,
    step_constants,
    to_prediction_box,
    view_harmonics,
)


def build_vis_model(params: Params) -> SconeVis:
    return SconeVis()


def gt_coverage_gain(coverage, view_idx, view_mask):
    """GT gain of every candidate from the coverage matrices: the surface
    share covered with the candidate minus without it.
    coverage (B, C, S); view_idx (B, V); view_mask (B, V) -> (B, C)."""
    S = coverage.shape[-1]
    seen = coverage.gather(1, view_idx.long()[..., None].expand(-1, -1, S))
    prev = torch.sum(seen * view_mask[..., None].to(coverage.dtype), dim=1)
    prev_cov = torch.mean((prev > 0).to(coverage.dtype), dim=-1)
    total = torch.mean((prev[:, None, :] + coverage > 0).to(coverage.dtype),
                       dim=-1)
    return total - prev_cov[:, None]


def assemble_vis_batch(rs, paths, X_cam_world, params: Params, n_views=None,
                       view_sequences=None):
    """The occupancy batch's clouds and views (n_sample 1, its queries
    dropped), the coverage matrices, and for validation the views
    replaced by the optimal sequences' prefixes."""
    base = D.assemble_occ_batch(
        rs, paths, X_cam_world, params.n_view_min, params.n_view_max,
        params.seq_len, n_sample=1, n_views=n_views,
        prediction_in_random_camera_space=params.get(
            "prediction_in_random_camera_space", False))
    covs = []
    for i, p in enumerate(paths):
        _, _, cov = D.get_gt_partial_point_clouds(p)
        covs.append(cov)
        if view_sequences is not None:
            n_view = int(base["view_mask"][i].sum())
            seq = view_sequences[i][:n_view]
            base["view_idx"][i, :n_view] = seq
            base["pred_cam_idx"][i] = seq[0]
    base["coverage"] = np.stack(covs).astype(np.float32)
    del base["X"], base["occs"]
    return base


def proxy_points(params: Params, B: int, device, gen):
    """Uniform proxy points in the normalised prediction box
    (B, n_proxy_points, 3)."""
    u = torch.rand(B, params.n_proxy_points, 3, generator=gen,
                   device=gen.device).to(device)
    return u - 0.5


def vis_forward(params: Params, occ_model: SconeOcc, vis_model: SconeVis,
                consts: StepConstants, batch, gen=None, draws=None):
    """Predicted and GT gains (B, C) of a device batch.

    ``draws`` injects the proxy points (``"X"``, (B, N, 3)) and the
    Monte-Carlo sample indices (``"sample_idx"``, (B, seq_len)); without a
    ``gen``, SconeOcc subsamples deterministically. Over several ranks
    ``batch`` is this rank's rows; ``gen``'s draws are the global batch's
    (``item_generators``)."""
    draws = draws or {}
    B = batch["pc"].shape[0]
    dev = batch["pc"].device
    item_gens = item_generators(gen, B, dev)
    idx = batch["pred_cam_idx"].long()
    pc_n = to_prediction_box(params, consts, batch["pc"], idx)
    X_cam_n = to_prediction_box(
        params, consts, consts.X_cam[None].expand(B, -1, -1), idx)
    X_view = X_cam_n.gather(
        1, batch["view_idx"].long()[..., None].expand(-1, -1, 3))
    X = draws.get("X")
    if X is None:
        X = mesh.shard_batch(proxy_points(params, B * mesh.world(), dev, gen))
    vh = view_harmonics(params, consts, X, X_view, batch["view_mask"])
    occ_vh = vh * 0.0 if params.get("occ_no_view_harmonics", False) else vh
    vis_vh = vh * 0.0 if params.get("no_view_harmonics", False) else vh
    filter_tol = params.get("filter_tol", 0.01)
    max_pass = params.get("max_points_per_scone_occ_pass", 300000)
    pts4, harm, smask = [], [], []
    for b in range(B):
        R_v, T_v = look_at_view_transform(X_view[b],
                                          torch.zeros_like(X_view[b]))
        keep = filter_proxy_points_mask(
            FoVCamera.create(R_v, T_v, zfar=1000.0), X[b], pc_n[b],
            filter_tol=filter_tol, pc_mask=batch["pc_mask"][b])
        with torch.no_grad():
            occ = compute_occupancy_probability(
                occ_model, pc_n[b:b + 1], X[b:b + 1], occ_vh[b:b + 1],
                pc_mask=batch["pc_mask"][b:b + 1], generator=item_gens[b],
                max_points_per_pass=max_pass)[0]
        sidx = draws.get("sample_idx")
        p4, h, _, m = sample_proxy_points(
            item_gens[b], X[b], occ, vis_vh[b], params.seq_len,
            params.get("min_occ_for_proxy_points", 0.1),
            use_occ_to_sample=params.get("use_occ_to_sample_proxy_points",
                                         True),
            valid_mask=keep, idx=None if sidx is None else sidx[b])
        pts4.append(p4)
        harm.append(h)
        smask.append(m)
    pts4, harm, smask = (torch.stack(t) for t in (pts4, harm, smask))
    harmonics = vis_model(pts4, harm, pts_mask=smask)
    gains = compute_coverage_gain(pts4, harmonics, X_cam_n, pts_mask=smask,
                                  use_sigmoid=params.get("use_sigmoid", True))
    gt = gt_coverage_gain(batch["coverage"], batch["view_idx"],
                          batch["view_mask"])
    return gains, gt


def item_generators(gen, B: int, device):
    """One generator per item of this rank's ``B`` rows, each seeded from
    a draw of one seed per item of the global batch; Nones without
    ``gen``."""
    if gen is None:
        return [None] * B
    seeds = mesh.shard_batch(torch.randint(
        0, 2 ** 62, (B * mesh.world(),), generator=gen,
        device=gen.device)).tolist()
    return [torch.Generator(device=device).manual_seed(s) for s in seeds]


def vis_loss(params, occ_model, vis_model, consts, batch, gen=None,
             draws=None):
    """(uncentred L1 loss, predicted gains, GT gains): over several ranks
    the loss is this rank's share of the global batch's (its rows' mean
    over the world) and the gains are its rows'."""
    pred, truth = vis_forward(params, occ_model, vis_model, consts, batch,
                              gen, draws)
    loss = L.uncentered_l1(pred[..., None], truth[..., None]) / mesh.world()
    return loss, pred, truth


def greedy_optimal_sequences(coverage: np.ndarray, max_len: int) -> np.ndarray:
    """Greedy max-gain view sequence from a coverage matrix (C, S)."""
    seq = []
    covered = np.zeros(coverage.shape[1], bool)
    for _ in range(max_len):
        gains = ((coverage > 0) & ~covered[None, :]).mean(axis=1)
        if seq:
            gains[np.array(seq)] = -1.0
        j = int(np.argmax(gains))
        seq.append(j)
        covered |= coverage[j] > 0
    return np.array(seq, np.int32)


def nbv_metric(pred_gains: np.ndarray, coverage: np.ndarray,
               view_idx: np.ndarray, view_mask: np.ndarray) -> float:
    """True gain of the camera with the largest predicted gain."""
    best = int(np.argmax(pred_gains))
    vidx = view_idx[view_mask.astype(bool)]
    prev = coverage[vidx].sum(axis=0)
    prev_cov = (prev > 0).mean()
    new_cov = ((prev + coverage[best]) > 0).mean()
    return float(new_cov - prev_cov)


def load_occ_model(params: Params, occ_weights_path: Optional[str], dev,
                   gen) -> SconeOcc:
    """A frozen SconeOcc: the pretrained weights at ``occ_weights_path``
    (the port's ``.pt`` or a JAX ``.msgpack``) if there are any, else
    random ones."""
    occ = init_weights(build_occ_model(params).to(dev), gen)
    if occ_weights_path and checkpoint_exists(occ_weights_path):
        load_checkpoint(occ_weights_path, occ)
    for p in occ.parameters():
        p.requires_grad_(False)
    return occ.eval()


def run_training(params: Params, data_path: Optional[str] = None,
                 weights_dir: str = "weights/scone/coverage_gain",
                 occ_weights_path: Optional[str] = None,
                 max_batches_per_epoch: Optional[int] = None,
                 device="cuda", verbose: bool = True):
    """The coverage-gain pretraining loop on ``device`` ("cuda" unless
    the caller asks for the CPU), on a frozen SconeOcc: training batches,
    validation on the greedy-optimal view sequences with the NBV metric,
    ``unvalidated_<name>`` (the resume point) and ``best_unval_<name>``
    checkpoints. In a group of W ranks the global batch is ``batch_size``
    x W. Returns (model, train losses, validation losses, NBV metrics)."""
    dev = resolve_device(device)
    data_path = data_path or params.data_path
    rs = np.random.default_rng(params.get("random_seed", 42))
    gen = make_generator(dev, params.get("torch_seed", 5))
    train_ds, val_ds, _ = D.get_shapenet_datasets(data_path)
    batch_size = params.batch_size * mesh.world()
    verbose = verbose and distributed.is_master()
    steps_per_epoch = max(len(train_ds) // batch_size, 1)

    occ_model = load_occ_model(params, occ_weights_path, dev, gen)
    model = init_weights(build_vis_model(params).to(dev), gen)
    opt, schedule = make_optimizer(params, model, steps_per_epoch)
    name = params.get("scone_vis_model_name", "scone_vis")
    start_epoch, step, best_loss = 0, 0, float("inf")
    train_losses, val_losses, nbv_metrics = [], [], []
    resume_path = os.path.join(weights_dir, f"unvalidated_{name}")
    if (not params.get("start_from_scratch", True)
            and checkpoint_exists(resume_path)):
        meta = load_checkpoint(resume_path, model, opt)
        start_epoch = int(meta.get("epoch", -1)) + 1
        step = int(meta["step"])
        best_loss = float(meta.get("best_loss", best_loss))
        train_losses = list(meta.get("train_losses", []))
        val_losses = list(meta.get("val_losses", []))
        nbv_metrics = list(meta.get("nbv_metrics", []))
    mesh.broadcast_module(model)

    consts = step_constants(params, dev)
    X_np = consts.X_cam.cpu().numpy()
    for epoch in range(start_epoch, params.epochs):
        t0 = time.time()
        model.train()
        ep_loss, n_steps = 0.0, 0
        for paths in D.iterate_batches(train_ds.paths, batch_size,
                                       shuffle=True,
                                       seed=params.get("random_seed", 42),
                                       epoch=epoch):
            if max_batches_per_epoch and n_steps >= max_batches_per_epoch:
                break
            batch = batch_to_device(mesh.shard_batch(assemble_vis_batch(
                rs, paths, X_np, params)), dev)
            loss, _, _ = vis_loss(params, occ_model, model, consts, batch,
                                  gen)
            optimizer_step(opt, schedule, step, loss)
            step += 1
            ep_loss += mesh.all_reduce_sum(loss).item()
            n_steps += 1
        train_loss = ep_loss / max(n_steps, 1)
        train_losses.append(train_loss)

        model.eval()
        val_loss, n_val, vi = 0.0, 0, 0
        # The NBV metric's sum and count, over every rank's items.
        nbv_sum = torch.zeros(2, dtype=torch.float64, device=dev)
        n_views_all = D.get_validation_n_views_list(
            len(val_ds), params.n_view_min, params.n_view_max)
        for paths in D.iterate_batches(val_ds.paths, batch_size,
                                       shuffle=False):
            if max_batches_per_epoch and n_val >= max_batches_per_epoch:
                break
            nv = n_views_all[vi:vi + len(paths)]
            vi += len(paths)
            seqs = [greedy_optimal_sequences(
                D.get_gt_partial_point_clouds(p)[2], params.n_view_max)
                for p in paths]
            hb = mesh.shard_batch(assemble_vis_batch(
                rs, paths, X_np, params, n_views=nv, view_sequences=seqs))
            with torch.no_grad():
                loss, pred, _ = vis_loss(params, occ_model, model, consts,
                                         batch_to_device(hb, dev), gen)
            val_loss += float(mesh.all_reduce_sum(loss))
            pred = pred.cpu().numpy()
            vals = [nbv_metric(pred[i], hb["coverage"][i], hb["view_idx"][i],
                               hb["view_mask"][i]) for i in range(len(pred))]
            nbv_sum += torch.tensor([sum(vals), len(vals)],
                                    dtype=torch.float64, device=dev)
            n_val += 1
        val_loss /= max(n_val, 1)
        val_losses.append(val_loss)
        total, count = mesh.all_reduce_(nbv_sum).tolist()
        nbv_metrics.append(total / count if count else 0.0)

        meta = {"epoch": epoch, "loss": train_loss, "best_loss": best_loss,
                "train_losses": train_losses, "val_losses": val_losses,
                "nbv_metrics": nbv_metrics}
        save_checkpoint(os.path.join(weights_dir, f"unvalidated_{name}"),
                        model, meta, opt=opt, step=step)
        if train_loss < best_loss:
            best_loss = meta["best_loss"] = train_loss
            save_checkpoint(os.path.join(weights_dir, f"best_unval_{name}"),
                            model, meta)
        if verbose:
            print(f"epoch {epoch}: train {train_loss:.6f} val {val_loss:.6f} "
                  f"nbv {nbv_metrics[-1]:.4f} ({time.time() - t0:.1f}s)")
    return model, train_losses, val_losses, nbv_metrics
