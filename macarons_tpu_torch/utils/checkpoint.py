"""Checkpoints of one network (the SCONE pretrainers'): ``<path>.pt``
holds the network's state dict and, for the rolling resume point, the
optimizer's and the step count; ``<path>.json`` the JAX package's
metadata. A JAX pretrainer checkpoint ``<path>.msgpack`` (a Flax
``TrainState``) gives the weights only, through utils.convert. Across
data-parallel ranks, rank 0 writes and every rank reads."""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import torch

from ..parallel import distributed


def checkpoint_exists(path: str) -> bool:
    return os.path.exists(path + ".pt") or os.path.exists(path + ".msgpack")


def save_checkpoint(path: str, module: torch.nn.Module, metadata=None,
                    opt: Optional[torch.optim.Optimizer] = None,
                    step: Optional[int] = None):
    """Rank 0 writes (every rank holds the same state), then every rank
    waits for it, so a read that follows finds the files."""
    if distributed.is_master():
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tree = {"model": module.state_dict()}
        if opt is not None:
            tree.update(opt=opt.state_dict(), step=step)
        torch.save(tree, path + ".pt")
        if metadata is not None:
            with open(path + ".json", "w") as f:
                json.dump(metadata, f, indent=2, default=float)
    distributed.barrier()


def load_checkpoint(path: str, module: torch.nn.Module,
                    opt: Optional[torch.optim.Optimizer] = None) -> Dict:
    """Load ``path`` into ``module`` (and ``opt``) and return its metadata,
    with the step count of a resume point under ``"step"``."""
    meta = {}
    if os.path.exists(path + ".pt"):
        dev = next(module.parameters()).device
        tree = torch.load(path + ".pt", map_location=dev, weights_only=True)
        module.load_state_dict(tree["model"])
        if opt is not None:
            opt.load_state_dict(tree["opt"])
            meta["step"] = tree["step"]
    elif os.path.exists(path + ".msgpack"):
        if opt is not None:
            raise ValueError(f"{path}.msgpack holds no optimizer state the "
                             "port can resume from")
        from .convert import load_module_weights

        load_module_weights(module, path)
    else:
        raise FileNotFoundError(f"no checkpoint {path}.pt or {path}.msgpack")
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            meta.update(json.load(f))
    return meta
