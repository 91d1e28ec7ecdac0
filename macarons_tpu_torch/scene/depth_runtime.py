"""Depth batches and the inference branches of the depth step (port of
macarons_tpu/scene/depth_runtime.py): ManyDepth, or perfect depth. The
losses and the augmentation wait for the online trainer."""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models import depth_losses as dl
from ..ops.projection import depth_to_disparity, disparity_to_depth


class DepthBatchConfig(NamedTuple):
    """The depth-batch knobs of the params the tester reads."""

    n_alpha: int = 2
    n_alpha_for_supervision: int = 2
    alphas: Tuple[int, ...] = (-2, -1)
    use_future_frame_for_supervision: bool = False
    znear: float = 0.5
    zfar: float = 750.0
    pose_factor: float = 100.0
    use_depth_mask: bool = True


def create_batch_for_depth_model(cfg: DepthBatchConfig, frames: Dict,
                                 mode: str = "inference", device=None):
    """Slice a loaded frame sequence (numpy, (n_total, H, W, C) etc.) into
    (batch, alpha) dicts of tensors on ``device``."""
    start = cfg.n_alpha
    end = frames["images"].shape[0]
    if mode == "supervision":
        n_alpha = cfg.n_alpha_for_supervision
        if cfg.use_future_frame_for_supervision:
            end -= 1
    else:
        n_alpha = cfg.n_alpha

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    keys = ("images", "mask", "R", "T") + (("zbuf",) if "zbuf" in frames
                                           else ())
    batch = {k: t(frames[k][start:end]) for k in keys + ("zfar",)}
    batch["mask"] = batch["mask"].bool()
    alpha = {k: torch.stack([t(frames[k][start + a:end + a])
                             for a in cfg.alphas[:n_alpha]], dim=1)
             for k in keys}
    alpha["mask"] = alpha["mask"].bool()
    alpha["zfar"] = batch["zfar"][:, None].expand(end - start, n_alpha)
    return batch, alpha


def _reflect_pad(x):
    """Reflect-pad NHWC by one pixel on H and W."""
    return F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1),
                 mode="reflect").permute(0, 2, 3, 1)


def error_table(cfg: DepthBatchConfig, disp, images, mask):
    """The regularity statistics of a full-resolution disparity: the
    per-pixel table of the mean-normalised (and masked) disparity, and its
    threshold mean + std per image. Returns (table (B, H, W, 1), threshold
    (B, 1, 1, 1))."""
    B = images.shape[0]
    norm = disp / (disp.mean(dim=(1, 2), keepdim=True) + 1e-7)
    if cfg.use_depth_mask:
        norm = norm * mask
    table = dl.regularity_tab(_reflect_pad(norm), _reflect_pad(images))
    flat = table.reshape(B, -1)
    return table, (flat.mean(-1) + flat.std(-1, correction=0)).reshape(
        B, 1, 1, 1)


def depth_masks(cfg: DepthBatchConfig, disp, images, mask):
    """The depth step's masks: the capture mask (all ones without
    use_depth_mask) and the error mask (pixels rougher than the threshold
    of ``error_table`` are dropped)."""
    table, thr = error_table(cfg, disp, images, mask)
    out_mask = mask if cfg.use_depth_mask else torch.ones_like(mask)
    return out_mask, table < thr


def perfect_depth_inference(cfg: DepthBatchConfig, batch):
    """Ground-truth depth in place of ManyDepth: depth = zbuf clipped to
    [znear, zfar]. Returns (depth (B, H, W, 1), mask, error_mask)."""
    zbuf = torch.clamp(batch["zbuf"], cfg.znear, cfg.zfar)
    disp = depth_to_disparity(zbuf, cfg.znear, cfg.zfar)
    return (zbuf, *depth_masks(cfg, disp, batch["images"], batch["mask"]))


def many_depth_inputs(cfg: DepthBatchConfig, batch, alpha):
    """ManyDepth's arguments for a depth batch, as the JAX package's depth
    step builds them without augmentation: the alpha poses relative to the
    target, whose pose becomes R = I, T = 0, as [T, axis-angle] /
    pose_factor; the first n_alpha alphas only.
    Returns (images, alpha images, R, T, gt_pose)."""
    R, T = batch["R"], batch["T"]
    B = R.shape[0]
    alpha_R, alpha_T = dl.get_relative_pose_matrices(R, T, alpha["R"],
                                                     alpha["T"])
    R = torch.eye(3, dtype=R.dtype, device=R.device).expand(B, 3, 3)
    T = torch.zeros_like(T)
    gt_pose = dl.convert_matrix_to_pose(R, T, alpha_R, alpha_T,
                                        cfg.pose_factor)
    n = cfg.n_alpha
    return batch["images"], alpha["images"][:, :n], R, T, gt_pose[:, :n]


@torch.no_grad()
def many_depth_inference(model, cfg: DepthBatchConfig, batch, alpha):
    """ManyDepth's depth for a depth batch (no loss, training or
    augmentation): depth from disp1, and the masks from disp1.
    Returns (depth (B, H, W, 1), mask, error_mask)."""
    _, disp1, *_ = model(*many_depth_inputs(cfg, batch, alpha))
    depth = disparity_to_depth(disp1, cfg.znear, cfg.zfar)
    return (depth, *depth_masks(cfg, disp1, batch["images"], batch["mask"]))
