"""The benchmark's yardstick for work: the card's peaks, the operations and
bytes of the hand-written kernels, and the model FLOPs of the networks.

Model FLOPs count the multiply-adds of matrix products and convolutions,
two operations each, as ``torch.utils.flop_counter`` counts them: the
networks' dense layers, attention products, kNN distance products and
convolutions. A backward pass counts twice its forward. The shapes are
those the window ran, recorded at the networks' calls; nothing is read
from the program's own counters, so the same work counts the same
whatever implements it.

The kernels' operation and byte counts are frozen copies of the program's
arithmetic when the benchmark was defined (ops/cuda/sh_visibility.py,
ops/cuda/tile_raster.py): each input byte read once and each output byte
written once."""

from __future__ import annotations

import functools
import math

# NVIDIA H100 SXM peaks (NVIDIA's data sheet, dense, at 700 W): float32
# outside the tensor cores (the program turns TF32 off) and HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# --- B3, the SH-visibility kernel, and B3', its backward ------------------
N_HARMONICS = 64
# Operations per output (an FMA counts two), counted from the kernel body.
SH_FLOPS_PER_OUTPUT = 324
# Operations per (batch, camera, point) of the backward.
SH_BACKWARD_FLOPS_PER_PAIR = 351


def sh_visibility_flops(B: int, C: int, L: int) -> int:
    return SH_FLOPS_PER_OUTPUT * B * C * L


def sh_visibility_bytes(B: int, C: int, L: int, P: int = 3) -> int:
    """Points, harmonics and cameras read once, the output written once,
    float32."""
    return 4 * (B * L * P + B * L * N_HARMONICS + B * C * 3 + B * C * L)


def sh_visibility_backward_flops(B: int, C: int, L: int) -> int:
    return SH_BACKWARD_FLOPS_PER_PAIR * B * C * L


def sh_visibility_backward_bytes(B: int, C: int, L: int, P: int = 3) -> int:
    """Points, cameras, the output and its gradient read once, the
    harmonics' gradient written once, float32."""
    return 4 * (B * L * P + B * C * 3 + 2 * B * C * L + B * L * N_HARMONICS)


# --- B1 + B2, the fused tile rasterizer -----------------------------------
# Operations per (pixel, face) test, per face set-up and per pixel's
# epilogue, counted from the kernel body (ops/cuda/tile_raster.py).
RASTER_OPS_PER_PIXEL_FACE = 21
RASTER_OPS_PER_FACE = 10  # signed area, its test and 1/area
RASTER_OPS_PER_PIXEL = 6  # the pixel's NDC centre


def raster_flops(n_faces: int, rows: int, P: int = 256) -> int:
    """A launch testing ``n_faces`` (row, face) pairs in all, each against
    its row's P pixels."""
    return (RASTER_OPS_PER_PIXEL_FACE * P * n_faces
            + RASTER_OPS_PER_FACE * n_faces + RASTER_OPS_PER_PIXEL * rows * P)


def raster_bytes(n_faces: int, rows: int, P: int = 256) -> int:
    """Each face read once (9 float32 and a 4-byte id or flag), each row's
    start and count, the four (rows, P) outputs written once."""
    return 40 * n_faces + 8 * rows + 16 * rows * P


def tiled_flops(n_pairs: int, n_lanes: int, rows: int, P: int = 256) -> int:
    """The fused launch: B1 over the pairs and B2 over the big-face
    lanes."""
    return raster_flops(n_pairs, rows, P) + raster_flops(n_lanes, rows, P)


def tiled_bytes(n_pairs: int, n_lanes: int, rows: int, P: int = 256) -> int:
    return raster_bytes(n_pairs + n_lanes, rows, P)


def tiled_work(nfe: int, starts, counts, K_cap: int, lane_valid,
               lane_counts, k_chunk: int):
    """The (row, face) pairs and big-face lanes that one launch of the
    fused rasterizer tests, as its item table counts them: row r's first
    min(count, K_cap) pairs of its segment of the ``nfe``-pair array, and
    its valid lanes among its count rounded up to whole ``k_chunk``
    chunks. Returns two 0-d tensors on the arguments' device; reading them
    waits for it."""
    import torch

    pairs = torch.minimum(counts.clamp(max=K_cap), nfe - starts).clamp(
        min=0).sum()
    K = lane_valid.shape[1]
    kc = min(k_chunk, K)
    n = torch.clamp((lane_counts.clamp(min=0) + kc - 1) // kc * kc, max=K)
    tested = (lane_valid > 0) & (torch.arange(K, device=lane_valid.device)
                                 < n[:, None])
    return pairs, tested.sum()


def bound_seconds(flops: float, nbytes: float) -> float:
    """The least time the card can take: operations or bytes at peak."""
    return max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S)


# --- the networks -----------------------------------------------------------


def dense(rows: int, n_in: int, n_out: int) -> int:
    return 2 * rows * n_in * n_out


def encoder(n_seq: int, N: int, d: int, qk: int, heads: int) -> int:
    """A pre-norm transformer block over ``n_seq`` sequences of N tokens:
    q, k (d -> qk), v (d -> d), the output projection when heads > 1, the
    two attention products, the feed-forward d -> 2d -> d."""
    rows = n_seq * N
    proj = 2 * dense(rows, d, qk) + dense(rows, d, d)
    if heads > 1:
        proj += dense(rows, d, d)
    attn = 2 * n_seq * N * N * qk + 2 * n_seq * N * N * d
    ff = dense(rows, d, 2 * d) + dense(rows, 2 * d, d)
    return proj + attn + ff


def embedding(rows: int, n_in: int, out: int, global_feature: bool = False,
              additional: int = 0, concatenate_input: bool = True) -> int:
    feature = out
    inner = out // 2
    if additional > 0:
        feature -= additional
        inner = feature
    if concatenate_input:
        feature -= n_in
        inner = feature
    if global_feature:
        feature //= 2
        inner = feature
    return dense(rows, n_in, inner) + dense(rows, inner, feature)


def pc_transformer(n_seq: int, N: int, pts_dim: int = 3, emb: int = 128,
                   feature_dim: int = 512, n_code: int = 2,
                   heads: int = 4) -> int:
    rows = n_seq * N
    return (embedding(rows, pts_dim, emb)
            + n_code * encoder(n_seq, N, emb, emb // 4, heads)
            + dense(rows, emb, feature_dim // 2))


def scone_occ_scales(L: int, seq_len: int = 2048, k: int = 16,
                     n_scale: int = 3):
    """The global sample's length and the kNN clouds' lengths of SconeOcc
    for a cloud of L points."""
    if n_scale > 1:
        ds = int(math.pow(L / (k * 8), 1.0 / (n_scale - 1))) or 2
    else:
        ds = 1
    clouds = [L]
    for _ in range(n_scale - 1):
        clouds.append(min(max(clouds[-1] // ds, k), clouds[-1]))
    return min(seq_len, L), clouds[:n_scale]


def scone_occ_flops(B: int, S: int, L: int, seq_len: int = 2048,
                    k: int = 16, n_scale: int = 3, n_harmonics: int = 64,
                    x_embedding_dim: int = 512, global_dim: int = 512,
                    local_dim: int = 256) -> int:
    """SconeOcc's forward on B clouds of L points and S queries each."""
    n_global, clouds = scone_occ_scales(L, seq_len, k, n_scale)
    total = pc_transformer(B, n_global, feature_dim=global_dim)
    for Lc in clouds:
        total += 2 * B * S * Lc * 3  # the kNN distance product
        total += pc_transformer(B * S, k, feature_dim=local_dim)
    rows = B * S
    d = x_embedding_dim
    total += dense(rows, 3, d // 4) + dense(rows, d // 4, d // 2) \
        + dense(rows, d // 2, d)
    head_in = global_dim + n_scale * local_dim + d + n_harmonics
    total += dense(rows, head_in, 512) + dense(rows, 512, 256) \
        + dense(rows, 256, 1)
    return total


def scone_vis_flops(B: int, L: int, pts_dim: int = 4, emb: int = 256,
                    n_code: int = 3, heads: int = 4,
                    n_harmonics: int = 64) -> int:
    """SconeVis's forward on B sets of L points (view state at the end)."""
    rows = B * L
    inner = 3 * n_harmonics
    return (embedding(rows, pts_dim, emb, global_feature=True)
            + n_code * encoder(B, L, emb, emb // 4, heads)
            + dense(rows, emb, inner)
            + dense(rows, inner + n_harmonics, 2 * n_harmonics)
            + dense(rows, 2 * n_harmonics, n_harmonics))


@functools.lru_cache(maxsize=None)
def many_depth_flops(B: int, H: int, W: int, n_alpha: int, n_depth: int,
                     learn_pose: bool = False) -> int:
    """ManyDepth's forward at batch B, H x W frames and n_alpha source
    frames: the frozen architecture run on the meta device under
    ``torch.utils.flop_counter`` (no memory, no arithmetic), cached by
    shape."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from ..reference.frozen.many_depth import ManyDepth

    dev = torch.device("meta")
    net = ManyDepth(input_height=H, input_width=W, d_min=0.5, d_max=750.0,
                    n_depth=n_depth, pose_factor=100.0,
                    learn_pose=learn_pose).to(dev).eval()
    args = (torch.zeros(B, H, W, 3, device=dev),
            torch.zeros(B, n_alpha, H, W, 3, device=dev),
            torch.eye(3, device=dev).expand(B, 3, 3),
            torch.zeros(B, 3, device=dev),
            torch.zeros(B, n_alpha, 6, device=dev))
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        net(*args)
    return int(counter.get_total_flops())
