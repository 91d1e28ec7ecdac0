"""The plain reference of the SconeVis pretraining cell and its comparison.

The reference follows the program's first steps from the seed's weights:
the frozen SconeOcc and SconeVis (``frozen/``), filled from the run's seed
as the driver filled the program's, the frozen ``vis_loss`` with the plain
SH integral in place of B3 and autograd in place of B3', and a plain
AdamW written out below, in float32 with TF32 off. Each step takes the
batch that the program's step assembled and the generator state it
started from, so the proxy points, SconeOcc's down-samples and the
Monte-Carlo samples are the same draws; the batch's assembly from the GT
files is the program's and is not recomputed.

Compared, each beside its limit from the traffic mix:

- ``loss_rel``: the largest relative gap of a step's loss;
- ``gains_rel``: the first step's predicted gains, the largest gap over
  the largest gain;
- ``grad_gap``: the first gradient as AdamW got it (the program's from its
  first moment after one step, exp_avg / (1 - beta1)), by the worst leaf:
  the gap between the two norms of a leaf over the larger of the
  reference's norm of that leaf and of the median leaf;
- ``change_gap``: the parameters' change over the recorded steps, by the
  worst leaf, measured the same way.

Leaves whose reference gradient is under a thousandth of the median
leaf's move by round-off alone and are left out of both leaf numbers.

``compare(..., control=True)`` puts the reference computed with TF32 in
the program's place."""

from __future__ import annotations

import math

import torch

from ..harness.common import network_weights
from .explore import precision
from .frozen import pretrain_vis as pv
from .frozen.pretrain_occ import WEIGHT_DECAY, step_constants
from .frozen.schedule import warmup_constant_schedule
from .frozen.scone import SconeOcc, SconeVis

BETAS = (0.9, 0.999)
EPS = 1e-8
# Leaves whose reference gradient norm is under this share of the median
# leaf's are not compared.
QUIET_LEAF = 1e-3


class Params(dict):
    """Attribute access to a flat configuration, as the frozen steps read
    it."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None


def adamw(params, grads, state, lr: float, t: int):
    """One AdamW step (decoupled weight decay, bias-corrected moments)."""
    with torch.no_grad():
        for p, g, (m, v) in zip(params, grads, state):
            p.mul_(1.0 - lr * WEIGHT_DECAY)
            m.mul_(BETAS[0]).add_(g, alpha=1.0 - BETAS[0])
            v.mul_(BETAS[1]).addcmul_(g, g, value=1.0 - BETAS[1])
            m_hat = m / (1.0 - BETAS[0] ** t)
            v_hat = v / (1.0 - BETAS[1] ** t)
            p.sub_(lr * m_hat / (v_hat.sqrt() + EPS))


def follow(ctx, params: Params, program: dict, tf32: bool):
    """The reference's steps on the program's recorded batches and draws:
    (losses, first predicted gains, first gradients, parameters after,
    initial parameters)."""
    dev = ctx.device
    occ = SconeOcc(seq_len=params.seq_len,
                   n_scale=0 if params.get("no_local_features", False)
                   else 3).to(dev)
    vis = SconeVis().to(dev)
    network_weights(ctx.seed, dev, occ, vis)
    for p in occ.parameters():
        p.requires_grad_(False)
    occ.eval()
    vis.train()
    leaves = list(vis.parameters())
    start = [p.detach().clone() for p in leaves]
    state = [(torch.zeros_like(p), torch.zeros_like(p)) for p in leaves]
    schedule = warmup_constant_schedule(
        params.learning_rate, params.warmup,
        lr_epochs=(params.get("lr_epochs", [])
                   if params.get("schedule_learning_rate") else []),
        lr_factor=params.get("lr_factor", 1.0),
        steps_per_epoch=program["steps_per_epoch"])
    consts = step_constants(params, dev)
    losses, first_pred, first_grads = [], None, None
    with precision(tf32):
        for t, rec in enumerate(program["records"], start=1):
            gen = torch.Generator(device=dev)
            gen.set_state(rec["gen_state"])
            loss, pred, _ = pv.vis_loss(params, occ, vis, consts,
                                        rec["batch"], gen)
            grads = torch.autograd.grad(loss, leaves)
            adamw(leaves, grads, state, schedule(rec["step"]), t)
            losses.append(loss.item())
            if first_pred is None:
                first_pred = pred.detach()
                first_grads = [g.detach() for g in grads]
    return losses, first_pred, first_grads, [p.detach() for p in leaves], \
        start


def leaf_gap(got, ref, keep) -> float:
    """The worst kept leaf's gap of norms over the larger of its reference
    norm and the median kept leaf's."""
    g = [float(x.norm()) for x in got]
    r = [float(x.norm()) for x in ref]
    kept = [i for i in range(len(r)) if keep[i]]
    median = sorted(r[i] for i in kept)[len(kept) // 2]
    return max(abs(g[i] - r[i]) / max(r[i], median, 1e-30) for i in kept)


def compare(ctx, params: dict, program: dict, control: bool = False) -> list:
    params = Params(params)
    limits = ctx.traffic["limits"]
    losses, pred, grads, after, start = follow(ctx, params, program, False)
    if control:
        p_losses, p_pred, p_grads, p_after, _ = follow(ctx, params, program,
                                                       True)
    else:
        recs = program["records"]
        p_losses = [r["loss"] for r in recs]
        p_pred = recs[0]["pred"]
        p_grads = [m / (1.0 - BETAS[0]) for m in recs[0]["exp_avg"]]
        p_after = program["after"]
    norms = [float(g.norm()) for g in grads]
    median = sorted(norms)[len(norms) // 2]
    keep = [n >= QUIET_LEAF * median for n in norms]
    values = {
        "loss_rel": max(abs(a - b) / max(abs(b), 1e-30)
                        for a, b in zip(p_losses, losses)),
        "gains_rel": float((p_pred - pred).abs().max()
                           / pred.abs().max().clamp(min=1e-12)),
        "grad_gap": leaf_gap(p_grads, grads, keep),
        "change_gap": leaf_gap([a - s for a, s in zip(p_after, start)],
                               [a - s for a, s in zip(after, start)], keep),
    }
    for k, v in values.items():
        if not math.isfinite(v):
            values[k] = float("inf")
    return [{"name": k, "value": values[k], "limit": limits[k]}
            for k in limits]
