"""A scene group's SCONE step, on one card or over data-parallel ranks
(port of macarons_tpu/parallel/scene_dp.py:make_parallel_scone_step).

The reference trains one scene per GPU and averages the gradients with
DDP; the JAX package stacks the group's scenes, padded to common grid
shapes, shards the scene axis over its mesh and takes the gradient of the
mean of the per-scene losses in one program. Here each rank holds its
contiguous block of the group's S scenes and computes their losses one
after another, each scene's graph freed by its own backward of
``loss_s / S`` into the accumulated gradients; the gradients are summed
over the ranks and every rank takes one AdamW step: the mean's gradient
up to float32 summation order, at one scene's peak memory. So no grid is
padded or stacked, and nothing of the JAX module's padding has a
counterpart.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..ops.geometry import FoVCamera
from ..scene import grid as G
from ..scene import proxy as P
from ..scene import runtime as R
from . import mesh


@dataclass
class SceneSupervision:
    """One scene's inputs to the SCONE step: its grid and cell table (the
    supervision pass's cells), the pre-window proxy and surface states the
    predictions run on, the close-to-surface mask, the window's visited
    cameras and their centres, the pseudo-GT coverage gains, the post-carve
    occupancy target; and, from the decision, the prediction camera and
    the scene field."""
    cfg: G.GridConfig
    cell_table: R.CellIndexTable
    proxy: P.ProxyState
    surface: G.GridState
    close_mask: torch.Tensor
    visited_cams: FoVCamera
    visited_X: torch.Tensor
    supervision_gains: torch.Tensor
    sup_occ: torch.Tensor
    prediction_camera: Optional[FoVCamera] = None
    field: Optional[tuple] = None


def group_scone_step(rt, opt: torch.optim.Optimizer,
                     group: List[SceneSupervision], n_supervision: int,
                     n_cells_active: int, gen=None,
                     cell_noise: Optional[Sequence] = None,
                     sample_idx: Optional[Sequence] = None):
    """One AdamW step of SconeOcc and SconeVis on mean_s(occ_s + cov_s)
    over the group: ``group`` is this rank's scenes of it, and the group
    has S = len(group) x the data-parallel world. Scene by scene, the
    runtime ``rt`` is bound to the scene's cell table, its two losses are
    computed (``MacaronsRuntime.scone_losses``, drawing the cell ranking
    and the MC sample from ``gen``, or from ``gen[s]`` given one generator
    per scene, unless ``cell_noise[s]`` and ``sample_idx[s]`` are given)
    and ``(occ_s + cov_s) / S`` is back-propagated; the gradients are
    summed over the ranks. Returns the group's mean (loss, occ_loss,
    cov_loss), detached."""
    S = len(group) * mesh.world()
    gens = gen if isinstance(gen, (list, tuple)) else [gen] * len(group)
    opt.zero_grad(set_to_none=True)
    occ_sum = cov_sum = 0.0
    for s, x in enumerate(group):
        rt.bind_scene(x.cfg, x.cell_table)
        box_diag = float(np.linalg.norm(np.asarray(x.cfg.x_max)
                                        - np.asarray(x.cfg.x_min)))
        occ_loss, cov_loss = rt.scone_losses(
            x.proxy, x.surface, x.prediction_camera, x.close_mask,
            x.visited_cams, x.visited_X, x.supervision_gains, x.field,
            n_supervision, box_diag, x.cfg.resolution, n_cells_active,
            x.sup_occ, gens[s],
            None if cell_noise is None else cell_noise[s],
            None if sample_idx is None else sample_idx[s])
        ((occ_loss + cov_loss) / S).backward()
        occ_sum = occ_sum + occ_loss.detach()
        cov_sum = cov_sum + cov_loss.detach()
    if mesh.world() > 1:
        mesh.all_reduce_grads(p for g in opt.param_groups
                              for p in g["params"])
        occ_sum, cov_sum = mesh.all_reduce_(torch.stack([occ_sum, cov_sum]))
    opt.step()
    occ, cov = occ_sum / S, cov_sum / S
    return occ + cov, occ, cov
