"""Self-supervised depth pretraining on saved frame trajectories (port of
macarons_tpu/trainers/pretrain_depth.py), on one card.

ManyDepth trains alone on frames captured into a scene memory (the online
trainer's ``frames/<n>.npz``, read through ``data.datasets.RGBDataset``):
per step a batch of frames with their alpha neighbours, the depth step's
photometric loss (scene.depth_runtime.depth_loss, ManyDepth in train mode),
AdamW. Every epoch writes ``unvalidated_<name>`` (the resume point, with
the optimizer) and, when the epoch's mean loss is the best yet,
``best_unval_<name>``, each as ``.pt`` + ``.json``. Like the JAX module it
has no CLI: call ``run_training``.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from ..config import Params
from ..data.datasets import RGBDataset
from ..models.macarons import init_depth_weights
from ..models.many_depth import ManyDepth
from ..scene.depth_runtime import DepthBatchConfig, depth_loss
from ..utils.checkpoint import checkpoint_exists, load_checkpoint, \
    save_checkpoint
from ..utils.device import make_generator, resolve_device

# optax.adamw(lr, weight_decay=0.01), as the JAX depth pretrainer builds it
# (the SCONE pretrainers take optax's default, 1e-4).
WEIGHT_DECAY = 0.01


def build_model(params: Params) -> ManyDepth:
    """ManyDepth at the config's widths, float32 (the JAX pretrainer reads
    no compute type)."""
    return ManyDepth(
        input_height=params.get("image_height", 256),
        input_width=params.get("image_width", 456),
        d_min=params.get("znear", 0.5), d_max=params.get("zfar", 750.0),
        n_depth=params.get("n_depth", 96),
        pose_factor=params.get("pose_factor", 100.0),
        learn_pose=params.get("learn_pose", False))


def init_model(params: Params, device, gen: torch.Generator) -> ManyDepth:
    """The model to train: ``build_model`` on ``device`` with Flax's default
    init drawn from ``gen``."""
    return init_depth_weights(build_model(params).to(device), gen)


def depth_cfg(params: Params) -> DepthBatchConfig:
    """The depth step's knobs; supervision sees the same alphas as the
    network."""
    return DepthBatchConfig(
        n_alpha=params.get("n_alpha", 2),
        n_alpha_for_supervision=params.get("n_alpha", 2),
        alphas=tuple(params.get("alphas", [-2, -1])),
        znear=params.get("znear", 0.5), zfar=params.get("zfar", 750.0),
        pose_factor=params.get("pose_factor", 100.0),
        rotation_mode=params.get("rotation_mode", "angle"),
        ssim_factor=params.get("ssim_factor", 0.85),
        regularity_factor=params.get("regularity_factor", 0.01),
        regularity_loss=params.get("regularity_loss", True),
        use_depth_mask=params.get("use_depth_mask", True),
        padding_mode=params.get("padding_mode", "border"),
        data_augmentation=params.get("data_augmentation", True),
        jitter_probability=params.get("jitter_probability", 0.5),
        symmetry_probability=params.get("symmetry_probability", 0.5))


def load_frame_batch(items: List[dict], n_alpha: int, device=None):
    """Stack RGBDataset items into the depth step's (batch, alpha) dicts of
    tensors on ``device``: images (B, H, W, 3), mask, R, T, zfar, and the
    alphas' (B, A, ...)."""
    def frame(path):
        with np.load(path) as f:
            return (f["rgb"][0], f["mask"][0], f["R"][0], f["T"][0],
                    float(f["zfar"]))

    def t(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    own = [frame(it["frame"]) for it in items]
    alphas = [[frame(p) for p in it["alpha_frames"]] for it in items]
    batch = {"images": t(np.stack([f[0] for f in own])),
             "mask": t(np.stack([f[1] for f in own])).bool(),
             "R": t(np.stack([f[2] for f in own])),
             "T": t(np.stack([f[3] for f in own])),
             "zfar": t([f[4] for f in own], torch.float32)}
    alpha = {k: t(np.stack([np.stack([f[i] for f in fs]) for fs in alphas]))
             for i, k in enumerate(("images", "mask", "R", "T"))}
    alpha["mask"] = alpha["mask"].bool()
    alpha["zfar"] = batch["zfar"][:, None].expand(len(items), n_alpha)
    return batch, alpha


def run_training(params: Params, frames_dirs: Optional[List[str]] = None,
                 weights_dir: str = "weights/depth", device="cuda",
                 verbose: bool = True):
    """Train ManyDepth alone on saved frames on ``device`` ("cuda" unless
    the caller asks for the CPU). ``frames_dirs`` defaults to the config's
    ``frames_dirs``.

    Batches follow numpy's ``default_rng(random_seed)`` permutation of the
    dataset, one per epoch, ``batch_size`` items per step (a last partial
    batch is dropped); the augmentation draws and the init come from a
    generator seeded with ``torch_seed``. With ``start_from_scratch`` false
    and an ``unvalidated_<name>`` checkpoint, the run resumes at its epoch
    with its weights, optimizer and loss history, and both seeds start
    afresh, as in the JAX package. Returns (model, per-epoch mean losses).
    """
    dev = resolve_device(device)
    frames_dirs = frames_dirs or list(params.get("frames_dirs", []))
    if not frames_dirs:
        raise ValueError("no frames_dirs given")
    rs = np.random.default_rng(params.get("random_seed", 42))
    gen = make_generator(dev, params.get("torch_seed", 5))
    cfg = depth_cfg(params)
    dataset = RGBDataset(frames_dirs, alphas=list(cfg.alphas))
    if len(dataset) == 0:
        raise ValueError("RGBDataset is empty")

    model = init_model(params, dev, gen)
    lr = params.get("depth_learning_rate", params.get("learning_rate", 1e-4))
    opt = torch.optim.AdamW(model.parameters(), lr=lr,
                            weight_decay=WEIGHT_DECAY)
    name = params.get("depth_model_name", "pretrained_depth")
    resume = os.path.join(weights_dir, f"unvalidated_{name}")
    start_epoch, step = 0, 0
    best_loss = float("inf")
    losses_per_epoch: List[float] = []
    if not params.get("start_from_scratch", True) and checkpoint_exists(resume):
        meta = load_checkpoint(resume, model, opt)
        start_epoch = int(meta.get("epoch", 0))
        step = int(meta.get("step", 0))
        best_loss = float(meta.get("best_loss", best_loss))
        losses_per_epoch = [float(x) for x in meta.get("losses", [])]

    B = params.get("batch_size", 4)
    for epoch in range(start_epoch, params.get("epochs", 1)):
        order = rs.permutation(len(dataset))
        losses = []
        model.train()
        for b0 in range(0, len(order) - B + 1, B):
            items = [dataset[int(i)] for i in order[b0:b0 + B]]
            batch, alpha = load_frame_batch(items, cfg.n_alpha, dev)
            loss = depth_loss(model, cfg, batch, alpha, gen=gen)[0]
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            step += 1
            losses.append(loss.detach())
        model.eval()
        mean = float(torch.stack(losses).mean()) if losses else 0.0
        losses_per_epoch.append(mean)
        meta = {"epoch": epoch + 1, "best_loss": best_loss,
                "losses": losses_per_epoch}
        save_checkpoint(resume, model, meta, opt, step)
        if mean < best_loss:
            best_loss = mean
            save_checkpoint(os.path.join(weights_dir, f"best_unval_{name}"),
                            model, dict(meta, best_loss=best_loss), opt, step)
        if verbose:
            print(f"epoch {epoch}: depth loss {mean:.5f}")
    return model, losses_per_epoch
