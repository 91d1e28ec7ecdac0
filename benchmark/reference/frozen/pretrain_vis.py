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

import torch

from . import losses as L
from .scone import (
    SconeOcc,
    SconeVis,
    compute_coverage_gain,
    compute_occupancy_probability,
)
from .geometry import FoVCamera, look_at_view_transform
from .view_state import filter_proxy_points_mask, sample_proxy_points
from . import mesh
from .pretrain_occ import (
    StepConstants,
    to_prediction_box,
    view_harmonics,
)


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

