"""Depth batches, augmentation and the depth step (port of
macarons_tpu/scene/depth_runtime.py): ManyDepth's inference, perfect depth,
and the training branch with its losses (``depth_loss``). Every random draw
comes from a ``torch.Generator`` or is injected."""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models import depth_losses as dl
from ..ops.geometry import FoVCamera
from ..ops.projection import depth_to_disparity, disparity_to_depth


class DepthBatchConfig(NamedTuple):
    """The depth step's knobs, as the params name them."""

    n_alpha: int = 2
    n_alpha_for_supervision: int = 2
    alphas: Tuple[int, ...] = (-2, -1)
    use_future_frame_for_supervision: bool = False
    znear: float = 0.5
    zfar: float = 750.0
    pose_factor: float = 100.0
    rotation_mode: str = "angle"
    ssim_factor: float = 0.85
    regularity_factor: float = 0.01
    regularity_loss: bool = True
    use_depth_mask: bool = True
    padding_mode: str = "border"
    data_augmentation: bool = True
    jitter_probability: float = 0.5
    symmetry_probability: float = 0.5
    brightness_jitter_range: float = 0.2
    contrast_jitter_range: float = 0.2
    saturation_jitter_range: float = 0.2
    hue_jitter_range: float = 0.05


# ---------------------------------------------------------------------------
# Frames on the device: the newest frames (ring) and a trajectory's (store)
# ---------------------------------------------------------------------------


class FrameRing(NamedTuple):
    """The newest L captured frames on the device, oldest first: the
    decision's and the supervision step's windows."""

    images: torch.Tensor  # (L, H, W, 3)
    zbuf: torch.Tensor  # (L, H, W, 1)
    mask: torch.Tensor  # (L, H, W, 1) bool
    R: torch.Tensor  # (L, 3, 3)
    T: torch.Tensor  # (L, 3)
    zfar: torch.Tensor  # (L,)


def init_frame_ring(length: int, height: int, width: int, zfar: float,
                    device=None) -> FrameRing:
    """A ring of placeholder frames: black images, zbuf -1, empty masks,
    R the identity, zfar ``zfar``."""
    return FrameRing(
        images=torch.zeros((length, height, width, 3), device=device),
        zbuf=torch.full((length, height, width, 1), -1.0, device=device),
        mask=torch.zeros((length, height, width, 1), dtype=torch.bool,
                         device=device),
        R=torch.eye(3, device=device).expand(length, 3, 3).clone(),
        T=torch.zeros((length, 3), device=device),
        zfar=torch.full((length,), float(zfar), device=device))


def ring_push(ring: FrameRing, images, zbuf, mask, R, T, zfar) -> FrameRing:
    """The ring with a capture batch appended, keeping the newest L frames
    (a new ring; ``ring`` is left as it was). ``zfar`` is a number."""
    L = ring.images.shape[0]
    K = images.shape[0]
    new = (images, zbuf, mask, R, T,
           torch.full((K,), float(zfar), device=ring.zfar.device))
    return FrameRing(*(torch.cat([a, b.to(a.dtype)])[-L:]
                       for a, b in zip(ring, new)))


def ring_frames(ring: FrameRing, n: int) -> Dict:
    """The newest n frames as a ``create_batch_for_depth_model`` frames
    dict."""
    return {k: getattr(ring, k)[-n:] for k in FrameRing._fields}


class FrameStore(NamedTuple):
    """Every captured frame of a trajectory on the device (the device
    memory's frames): tensors allocated once at capacity F, written in
    place at the head ``n``, a host count known at append time."""

    images: torch.Tensor  # (F, H, W, 3)
    zbuf: torch.Tensor  # (F, H, W, 1)
    mask: torch.Tensor  # (F, H, W, 1) bool
    R: torch.Tensor  # (F, 3, 3)
    T: torch.Tensor  # (F, 3)
    n: int  # frames appended


def init_frame_store(max_frames: int, height: int, width: int,
                     device=None) -> FrameStore:
    """An empty store: black images, zbuf -1, empty masks, R the identity."""
    ring = init_frame_ring(max_frames, height, width, 0.0, device)
    return FrameStore(ring.images, ring.zbuf, ring.mask, ring.R, ring.T, 0)


def _clamped_start(start: int, size: int, capacity: int) -> int:
    """A slice start as ``jax.lax.dynamic_slice`` and
    ``dynamic_update_slice`` take it: a negative start counts from the end,
    then the start is moved into [0, capacity - size]."""
    if start < 0:
        start += capacity
    return min(max(start, 0), capacity - size)


def store_append(store: FrameStore, images, zbuf, mask, R, T) -> FrameStore:
    """Write a capture batch of K frames at the head, in place; returns the
    store with ``n`` advanced by K. A batch that would pass the capacity
    is written at capacity - K (the last rows), as JAX writes it."""
    K = images.shape[0]
    at = _clamped_start(store.n, K, store.images.shape[0])
    for dst, src in zip(store[:5], (images, zbuf, mask, R, T)):
        dst[at:at + K] = src
    return store._replace(n=store.n + K)


def store_window(store: FrameStore, last: int, n: int, zfar: float,
                 device=None) -> Dict:
    """Frames [last - n + 1 .. last] as a ``create_batch_for_depth_model``
    frames dict (views of the store; from a store in host memory, its rows
    copied to a card ``device`` without waiting). A window that would
    start before frame 0 or end past the capacity is moved as JAX moves it
    (see ``_clamped_start``: one starting before frame 0 comes from the
    end)."""
    lo = _clamped_start(last - (n - 1), n, store.images.shape[0])
    out = {k: getattr(store, k)[lo:lo + n]
           for k in ("images", "zbuf", "mask", "R", "T")}
    if (device is not None and not store.images.is_cuda
            and torch.device(device).type != "cpu"):
        out = {k: v.to(device, non_blocking=True) for k, v in out.items()}
    out["zfar"] = torch.full((n,), float(zfar),
                             device=out["images"].device)
    return out


def create_batch_for_depth_model(cfg: DepthBatchConfig, frames: Dict,
                                 mode: str = "inference", device=None):
    """Slice a frame sequence ((n_total, H, W, C) etc., numpy arrays as
    Memory.load_frame_sequence returns them, or tensors) into (batch,
    alpha) dicts of tensors on ``device``."""
    start = cfg.n_alpha
    end = frames["images"].shape[0]
    if mode == "supervision":
        n_alpha = cfg.n_alpha_for_supervision
        if cfg.use_future_frame_for_supervision:
            end -= 1
    else:
        n_alpha = cfg.n_alpha

    def t(a):
        if not isinstance(a, torch.Tensor):
            a = np.ascontiguousarray(a)
        return torch.as_tensor(a, device=device)

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


# ---------------------------------------------------------------------------
# Augmentation: colour jitter and the horizontal flip with its pose
# ---------------------------------------------------------------------------


def _rgb_to_gray(x):
    return (0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2])[..., None]


def adjust_image(x, brightness, contrast, saturation, hue):
    """Brightness, contrast, saturation and hue jitter of NHWC images in
    [0, 1] (the hue as a rotation of the colour about the gray axis)."""
    x = torch.clamp(x * brightness, 0.0, 1.0)
    gray_mean = _rgb_to_gray(x).mean(dim=(-3, -2), keepdim=True)
    x = torch.clamp(gray_mean + contrast * (x - gray_mean), 0.0, 1.0)
    gray = _rgb_to_gray(x)
    x = torch.clamp(gray + saturation * (x - gray), 0.0, 1.0)
    theta = torch.as_tensor(hue * 2.0 * np.pi, dtype=x.dtype, device=x.device)
    u = x - gray
    rolled = torch.roll(u, 1, dims=-1)
    return torch.clamp(gray + u * torch.cos(theta) + rolled * torch.sin(theta),
                       0.0, 1.0)


def jitter_factors(cfg: DepthBatchConfig, u):
    """(brightness, contrast, saturation, hue) from four uniforms in [0, 1)."""
    return (max(0.0, 1 + cfg.brightness_jitter_range * (1 - 2 * float(u[0]))),
            max(0.0, 1 + cfg.contrast_jitter_range * (1 - 2 * float(u[1]))),
            max(0.0, 1 + cfg.saturation_jitter_range * (1 - 2 * float(u[2]))),
            cfg.hue_jitter_range * (1 - 2 * float(u[3])))


def sample_augmentation(cfg: DepthBatchConfig, gen: torch.Generator):
    """One batch's augmentation draws: {"jitter": bool, "symmetry": bool,
    "factors": (brightness, contrast, saturation, hue)}."""
    u = torch.rand(6, generator=gen, device=gen.device).cpu().tolist()
    return {"jitter": u[0] < cfg.jitter_probability,
            "symmetry": u[1] < cfg.symmetry_probability,
            "factors": jitter_factors(cfg, u[2:])}


def apply_symmetry(x, R, T, mask=None):
    """Horizontal flip of NHWC images (and masks) with the pose conjugated by
    F = diag(-1, 1, 1): R' = F R F, T' = T F."""
    flip = torch.tensor([-1.0, 1.0, 1.0], dtype=R.dtype, device=R.device)
    R2 = R * flip[:, None] * flip[None, :]
    return (torch.flip(x, dims=(-2,)), R2, T * flip,
            torch.flip(mask, dims=(-2,)) if mask is not None else None)


# ---------------------------------------------------------------------------
# The depth step's loss (the training branch)
# ---------------------------------------------------------------------------


def _upsample_nearest(d, H: int, W: int):
    return F.interpolate(d.permute(0, 3, 1, 2), size=(H, W),
                         mode="nearest-exact").permute(0, 2, 3, 1)


def depth_loss(model, cfg: DepthBatchConfig, batch, alpha,
               use_perfect_depth: bool = False, augment=None, draws=None,
               gen: Optional[torch.Generator] = None,
               row_share: float = 1.0):
    """The depth step with its loss: relative poses, augmentation, ManyDepth
    (in whatever mode ``model`` is in: train mode uses and updates the batch
    statistics), the error mask, and (pose + reconstruction + regularity)
    / 4 over the four scales.

    ``augment`` defaults to ``cfg.data_augmentation``; its draws come from
    ``gen`` unless injected as ``draws`` (see ``sample_augmentation``).
    ``row_share`` is this batch's share of the rows of a global batch that
    data-parallel ranks split: the terms that are means over the batch
    (the pose and regularity losses, the unmasked reconstruction loss) are
    scaled by it, so the ranks' losses add up to the global batch's; the
    masked reconstruction loss is a sum over the images and stays.
    Returns (loss, depth (B, H, W, 1), mask, error_mask, pose, gt_pose);
    depth and masks are in the frame's own orientation and carry no grad."""
    augment = cfg.data_augmentation if augment is None else augment
    images, mask = batch["images"], batch["mask"]
    R, T = batch["R"], batch["T"]
    alpha_images, alpha_mask = alpha["images"], alpha["mask"]
    B, H, W = images.shape[:3]

    alpha_R, alpha_T = dl.get_relative_pose_matrices(R, T, alpha["R"],
                                                     alpha["T"])
    R = torch.eye(3, dtype=R.dtype, device=R.device).expand(B, 3, 3)
    T = torch.zeros_like(T)

    flipped = False
    if augment:
        if draws is None:
            draws = sample_augmentation(cfg, gen)
        if draws["jitter"]:
            images = adjust_image(images, *draws["factors"])
            alpha_images = adjust_image(alpha_images, *draws["factors"])
        if draws["symmetry"]:
            images, R, T, mask = apply_symmetry(images, R, T, mask)
            alpha_images, alpha_R, alpha_T, alpha_mask = apply_symmetry(
                alpha_images, alpha_R, alpha_T, alpha_mask)
            flipped = True

    gt_pose = dl.convert_matrix_to_pose(R, T, alpha_R, alpha_T,
                                        cfg.pose_factor)
    n = cfg.n_alpha
    if use_perfect_depth:
        zbuf = torch.clamp(batch["zbuf"], cfg.znear, cfg.zfar)
        pose = gt_pose[:, :n]
        depths = [zbuf] * 4
        disp1 = depth_to_disparity(zbuf, cfg.znear, cfg.zfar)
    else:
        pose, *disps = model(images, alpha_images[:, :n], R, T, gt_pose[:, :n])
        disp1 = disps[0]
        depths = [disparity_to_depth(d, cfg.znear, cfg.zfar) for d in disps]
        depths = [depths[0]] + [_upsample_nearest(d, H, W)
                                for d in depths[1:]]

    out_mask, error_mask = depth_masks(cfg, disp1.detach(), images, mask)
    mask1 = mask if cfg.use_depth_mask else None

    p_loss = dl.pose_loss(pose, gt_pose[:, :n], cfg.pose_factor,
                          cfg.rotation_mode)
    reg_loss = 0.0
    if cfg.regularity_loss and cfg.regularity_factor > 0:
        for w, d in zip((1.0, 0.5, 0.25, 0.125), depths):
            disp = depth_to_disparity(d, cfg.znear, cfg.zfar)
            nd = disp / (disp.mean(dim=(1, 2), keepdim=True) + 1e-7)
            if mask1 is not None:
                nd = nd * mask1
            reg_loss = reg_loss + w * dl.regularity_loss(nd, images)
        reg_loss = cfg.regularity_factor * reg_loss
    cameras = FoVCamera.create(R, T, zfar=cfg.zfar)
    alpha_cams = FoVCamera.create(alpha_R.reshape(-1, 3, 3),
                                  alpha_T.reshape(-1, 3), zfar=cfg.zfar)
    rec_loss = 0.0
    for d in depths:
        rec_loss = rec_loss + dl.reconstruction_loss(
            images, alpha_images, mask, cameras, alpha_cams, d,
            ssim_factor=cfg.ssim_factor, use_mask=cfg.use_depth_mask,
            zfar=cfg.zfar, padding_mode=cfg.padding_mode)
    rec_share = 1.0 if cfg.use_depth_mask else row_share
    loss = (p_loss * row_share + rec_loss * rec_share
            + reg_loss * row_share) / 4.0

    depth = depths[0].detach()
    if flipped:
        depth, out_mask, error_mask = (torch.flip(t, dims=(-2,)) for t in
                                       (depth, out_mask, error_mask))
    return loss, depth, out_mask, error_mask, pose, gt_pose
