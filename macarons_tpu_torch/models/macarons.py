"""The MACARONS bundle: SconeOcc, SconeVis and ManyDepth, their optimizers
and checkpoints (port of macarons_tpu/models/macarons.py).

A checkpoint ``<path>`` is ``<path>.pt`` (the networks' state dicts and,
for the rolling resume point, the optimizers') beside ``<path>.json``, the
JAX package's metadata. ``load_macarons`` also reads the JAX package's
``<path>.msgpack``, weights only.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, NamedTuple, Optional

import torch
import torch.nn as nn

from ..config import Params
from ..parallel import distributed
from ..utils.checkpoint import checkpoint_exists  # noqa: F401 (re-exported)
from ..utils.device import compute_dtype
from .attention import init_weights
from .many_depth import ManyDepth
from .scone import SconeOcc, SconeVis


class MacaronsModel(NamedTuple):
    occ: SconeOcc
    vis: SconeVis
    depth: Optional[ManyDepth] = None  # None under use_perfect_depth


def create_many_depth(params: Params, device=None) -> ManyDepth:
    """ManyDepth from the config, in eval mode on ``device``. Its
    convolutions compute in ``depth_compute_dtype``: None, "none" and
    "float32" mean float32, else the named torch type ("bfloat16")."""
    dtype = params.get("depth_compute_dtype")
    return ManyDepth(
        input_height=params.get("image_height", 256),
        input_width=params.get("image_width", 456),
        d_min=params.get("znear", 0.5), d_max=params.get("zfar", 750.0),
        n_depth=params.get("n_depth", 96),
        pose_factor=params.get("pose_factor", 100.0),
        learn_pose=params.get("learn_pose", False),
        dtype=compute_dtype(dtype)).to(device).eval()


def create_macarons_model(params: Params, device=None) -> MacaronsModel:
    """Build the networks from the config, in eval mode on ``device`` with
    empty weights (see ``init_macarons_weights`` and
    utils.convert.load_macarons_weights). ManyDepth is built unless the
    config reads perfect depth, which nothing then reads it for."""
    occ = SconeOcc(seq_len=params.get("seq_len", 2048),
                   n_scale=0 if params.get("no_local_features", False) else 3,
                   k_for_knn=params.get("k_for_knn", 16))
    vis = SconeVis()
    depth = (None if params.get("use_perfect_depth", False)
             else create_many_depth(params, device))
    return MacaronsModel(occ.to(device).eval(), vis.to(device).eval(), depth)


def init_depth_weights(module: nn.Module, gen: torch.Generator):
    """Flax's default init: LeCun-normal conv and dense kernels (a normal
    truncated at two standard deviations, of variance 1 / fan_in) and zero
    biases; BatchNorm weight 1, bias 0, running mean 0 and variance 1."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                std = math.sqrt(1.0 / fan_in) / .87962566103423978
                nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std,
                                      2.0 * std, generator=gen)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
    return module


def init_macarons_weights(model: MacaronsModel, gen: torch.Generator):
    """Random init of the networks from one generator: occ, vis, then
    ManyDepth (so a bundle without ManyDepth draws what it always drew)."""
    init_weights(model.occ, gen)
    init_weights(model.vis, gen)
    if model.depth is not None:
        init_depth_weights(model.depth, gen)
    return model


def create_optimizers(params: Params, model: MacaronsModel
                      ) -> Dict[str, torch.optim.AdamW]:
    """AdamW (weight decay 0.01, PyTorch's default and the JAX package's)
    for the depth network and one for SconeOcc + SconeVis together. The
    trainer writes the learning rate into ``param_groups`` every step."""
    depth_lr = params.get("depth_learning_rate",
                          params.get("learning_rate", 1e-4))
    scone_lr = params.get("scone_learning_rate",
                          params.get("learning_rate", 1e-4))
    opts = {"scone": torch.optim.AdamW(
        list(model.occ.parameters()) + list(model.vis.parameters()),
        lr=scone_lr, weight_decay=0.01)}
    if model.depth is not None:
        opts["depth"] = torch.optim.AdamW(model.depth.parameters(),
                                          lr=depth_lr, weight_decay=0.01)
    return opts


def save_macarons(path: str, model: MacaronsModel, metadata=None,
                  opt_states: Optional[Dict] = None):
    """``<path>.pt`` with the networks (and the optimizers, if given) and
    ``<path>.json`` with ``metadata``; across data-parallel ranks rank 0
    writes, and every rank waits for it."""
    if distributed.is_master():
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tree = {"occ": model.occ.state_dict(), "vis": model.vis.state_dict(),
                "depth": (model.depth.state_dict() if model.depth is not None
                          else None)}
        if opt_states is not None:
            tree.update({f"{k}_opt": v.state_dict()
                         for k, v in opt_states.items()})
        torch.save(tree, path + ".pt")
        if metadata is not None:
            with open(path + ".json", "w") as f:
                json.dump(metadata, f, indent=2, default=float)
    distributed.barrier()


def load_macarons(path: str, model: MacaronsModel,
                  opt_states: Optional[Dict] = None) -> Dict:
    """Load a checkpoint into ``model`` (and ``opt_states``, if given) and
    return its metadata. ``<path>.pt`` is the port's; a JAX checkpoint
    ``<path>.msgpack`` gives the weights only."""
    if os.path.exists(path + ".pt"):
        dev = next(model.occ.parameters()).device
        tree = torch.load(path + ".pt", map_location=dev, weights_only=True)
        model.occ.load_state_dict(tree["occ"])
        model.vis.load_state_dict(tree["vis"])
        if model.depth is not None and tree["depth"] is not None:
            model.depth.load_state_dict(tree["depth"])
        for k, opt in (opt_states or {}).items():
            opt.load_state_dict(tree[f"{k}_opt"])
    elif os.path.exists(path + ".msgpack"):
        from ..utils.convert import load_macarons_weights

        load_macarons_weights(model, path)
    else:
        raise FileNotFoundError(f"no checkpoint {path}.pt or {path}.msgpack")
    meta = {}
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            meta = json.load(f)
    return meta
