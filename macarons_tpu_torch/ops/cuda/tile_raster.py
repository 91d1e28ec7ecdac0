"""Tile rasterizer: the CUDA kernels' wrappers and their plain PyTorch twins.

Port of the two Pallas kernels of macarons_tpu/ops/pallas/tile_raster.py,
the per-tile stage of the binned capture path:

- ``rasterize_pairs`` (B1, ``pallas_rasterize_pairs``): each grid row tests
  the first ``min(count, K_cap)`` pairs of its segment of a tile-sorted
  (tile, face) pair array and returns the nearest face's id.
- ``rasterize_tiles`` (B2, ``pallas_rasterize_tiles``): each grid row tests
  its dense face list, up to its count rounded up to whole ``k_chunk``
  chunks, and returns the nearest face's lane (slot).

Row ``r`` is screen tile ``r % n_tiles`` of its camera; each tile holds
``tile * tile`` pixels in row-major order. Outputs are (R, tile * tile):
zbuf (-1 = empty), face id or slot (int32, -1 = empty), b0 and b1 (0 when
empty).

A CUDA tensor goes to the hand-written kernels (csrc/tile_raster.cu); a CPU
tensor goes to ``rasterize_pairs_plain`` / ``rasterize_tiles_plain``, which
repeat the kernels' arithmetic step by step with tensor ops (the kernels are
built with ``-fmad=false`` so that both round alike). A failed build or
launch raises. ``nearest_face`` is the twins' shared per-tile test; the
XLA-style binned path of ops.rasterizer uses it too.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .build import load_library

_BIG = 3.0e38
_LIB = ("macarons_tile_raster", "tile_raster.cu", ["-fmad=false"])
# Elements of one (rows, pixels, faces) block of the twins' tensor ops.
BLOCK_ELEMS = 1 << 21

# Float operations counted from the kernel body (csrc/tile_raster.cu): the
# edge functions and the inside test every (pixel, face) pair needs
# (test_chunk up to its first `continue`); the perspective correction and
# depth of covered pixels are left out, so the bound is a lower bound.
OPS_PER_PIXEL_FACE = 21
OPS_PER_FACE = 10  # stage_face: signed area, its test and 1/area
OPS_PER_PIXEL = 6  # the pixel's NDC centre


def f32(v: float) -> float:
    """``v`` rounded to float32, as the JAX kernels round Python constants."""
    return float(np.float32(v))


def ieee_div(x, d: float):
    """``x / d`` rounded as one IEEE division on every device: PyTorch's CUDA
    kernels multiply by the reciprocal of a Python scalar divisor, which can
    differ by an ulp, so the divisor goes in as a tensor on x's device."""
    return x / x.new_full((), d)


def pixel_ndc(tile_idx, tile: int, TW: int, H: int, W: int):
    """NDC centres of every pixel of the given tiles: (px, py, in_image),
    each (G, tile * tile), from tile indices (G,) within an image."""
    dev = tile_idx.device
    p = torch.arange(tile * tile, device=dev)
    row = ((tile_idx // TW) * tile)[:, None] + p // tile
    col = ((tile_idx % TW) * tile)[:, None] + p % tile
    rowf = row.to(torch.float32)
    colf = col.to(torch.float32)
    s = min(H, W)
    px = f32(W / s) - ieee_div(2.0 * colf, s - 1.0)
    py = f32(H / s) - ieee_div(2.0 * rowf, s - 1.0)
    return px, py, (row < H) & (col < W)


def nearest_face(fv, valid, px, py, pix_ok=None,
                 perspective_correct: bool = True, eps: float = 1e-8,
                 kernel_order: bool = True):
    """The nearest face of each row's list at each of its pixels.

    fv (G, 9, K) rows x0 y0 z0 x1 y1 z1 x2 y2 z2; valid (G, K) bool;
    px, py, pix_ok (G, P). ``kernel_order`` computes depth as the tile
    kernels do, z = b0 z0 + b1 z1 + (1 - b0 - b1) z2; otherwise as the XLA
    binned path does, with b2 = iw2 / denom. Returns (z (G, P), inf where no
    face covers the pixel; lane (G, P), the first nearest; b0, b1 and b2 at
    that lane, b2 None in kernel order)."""
    eps = f32(eps)
    x0, y0, z0, x1, y1, z1, x2, y2, z2 = (fv[:, c, None, :] for c in range(9))
    area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
    nondegen = area.abs() > eps
    inv_area = torch.where(nondegen, 1.0 / torch.where(nondegen, area, 1.0),
                           0.0)
    px = px[:, :, None]
    py = py[:, :, None]
    w0 = ((x1 - px) * (y2 - py) - (x2 - px) * (y1 - py)) * inv_area
    w1 = ((x2 - px) * (y0 - py) - (x0 - px) * (y2 - py)) * inv_area
    w2 = 1.0 - w0 - w1
    inside = ((w0 >= 0) & (w1 >= 0) & (w2 >= 0)
              & (valid[:, None, :] & nondegen))
    if pix_ok is not None:
        inside = inside & pix_ok[:, :, None]
    b2 = None
    if perspective_correct:
        iw0 = w0 / z0
        iw1 = w1 / z1
        iw2 = w2 / z2
        denom = iw0 + iw1 + iw2
        denom = torch.where(denom.abs() > eps, denom, eps)
        b0 = iw0 / denom
        b1 = iw1 / denom
        if kernel_order:
            z = b0 * z0 + b1 * z1 + (1.0 - b0 - b1) * z2
        else:
            b2 = iw2 / denom
            z = b0 * z0 + b1 * z1 + b2 * z2
    else:
        b0, b1 = w0, w1
        b2 = None if kernel_order else w2
        z = w0 * z0 + w1 * z1 + w2 * z2
    inside = inside & (z > eps)
    zm = torch.where(inside, z, float("inf"))
    lane = torch.argmin(zm, dim=-1, keepdim=True)

    def at(x):
        return None if x is None else x.gather(-1, lane)[..., 0]

    return at(zm), lane[..., 0], at(b0), at(b1), at(b2)


def _row_groups(lengths, P: int):
    """Rows with work, in groups of similar length: yields (rows, K) with
    rows sorted by ascending length and K the group's longest, such that a
    group's (rows, P, K) block stays near ``BLOCK_ELEMS`` elements."""
    lens, order = torch.sort(lengths.cpu())
    lens = lens.tolist()
    order = order.to(lengths.device)
    i = next((k for k, v in enumerate(lens) if v > 0), len(lens))
    while i < len(lens):
        j = i + 1
        while j < len(lens) and (j + 1 - i) * lens[j] * P <= BLOCK_ELEMS:
            j += 1
        yield order[i:j], lens[j - 1]
        i = j


def _empty_outputs(R: int, P: int, device):
    return (torch.full((R, P), -1.0, device=device),
            torch.full((R, P), -1, dtype=torch.int32, device=device),
            torch.zeros((R, P), device=device),
            torch.zeros((R, P), device=device))


def _raster_groups(lengths, gather, n_tiles, tile, TW, H, W,
                   perspective_correct, eps):
    """Shared body of the twins: ``gather(rows, K)`` gives (fv (G, 9, K),
    valid (G, K), ids (G, K)) for a group of rows."""
    R = lengths.shape[0]
    P = tile * tile
    zbuf, ids, b0, b1 = _empty_outputs(R, P, lengths.device)
    for rows, K in _row_groups(lengths, P):
        fv, valid, lane_ids = gather(rows, K)
        px, py, ok = pixel_ndc(rows % n_tiles, tile, TW, H, W)
        z, lane, bb0, bb1, _ = nearest_face(fv, valid, px, py, ok,
                                            perspective_correct, eps)
        hit = z < _BIG
        zbuf[rows] = torch.where(hit, z, -1.0)
        ids[rows] = torch.where(hit, lane_ids.gather(1, lane), -1).to(
            torch.int32)
        b0[rows] = torch.where(hit, bb0, 0.0)
        b1[rows] = torch.where(hit, bb1, 0.0)
    return zbuf, ids, b0, b1


def _pair_lengths(pfv, starts, counts, K_cap: int):
    n = torch.minimum(counts.clamp(max=K_cap), pfv.shape[0] - starts)
    return n.clamp(min=0)


def _tile_lengths(tile_counts, K: int, k_chunk: int):
    kc = min(k_chunk, K)
    return torch.clamp((tile_counts.clamp(min=0) + kc - 1) // kc * kc, max=K)


def rasterize_pairs_plain(pfv, pface, starts, counts, tile: int, TW: int,
                          H: int, W: int, n_tiles: int, K_cap: int = 1024,
                          perspective_correct: bool = True,
                          eps: float = 1e-8):
    """The plain twin of the B1 kernel (same arguments as rasterize_pairs)."""
    n = _pair_lengths(pfv, starts, counts, K_cap)

    def gather(rows, K):
        k = torch.arange(K, device=pfv.device)
        idx = (starts[rows, None] + k).clamp(0, pfv.shape[0] - 1)
        return (pfv[idx].permute(0, 2, 1), k < n[rows, None],
                pface[idx].long())

    return _raster_groups(n, gather, n_tiles, tile, TW, H, W,
                          perspective_correct, eps)


def rasterize_tiles_plain(tile_fv, tile_valid, tile_counts, tile: int,
                          TW: int, H: int, W: int, n_tiles: int,
                          k_chunk: int = 256,
                          perspective_correct: bool = True,
                          eps: float = 1e-8):
    """The plain twin of the B2 kernel (same arguments as rasterize_tiles)."""
    K = tile_fv.shape[2]
    n = _tile_lengths(tile_counts, K, k_chunk)

    def gather(rows, Kg):
        k = torch.arange(Kg, device=tile_fv.device)
        return (tile_fv[rows, :, :Kg], tile_valid[rows, :Kg] > 0,
                k.expand(len(rows), Kg))

    return _raster_groups(n, gather, n_tiles, tile, TW, H, W,
                          perspective_correct, eps)


def _library():
    lib = load_library(*_LIB)
    geom = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int,
            ctypes.c_float]
    outs = [ctypes.c_void_p] * 4 + [ctypes.c_void_p]
    lib.macarons_raster_pairs.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + geom + outs)
    lib.macarons_raster_tiles.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + geom + outs)
    lib.macarons_raster_pairs.restype = ctypes.c_int
    lib.macarons_raster_tiles.restype = ctypes.c_int
    return lib


def build(verbose: bool = False):
    """Compile the kernels now (``verbose`` prints the ptxas report)."""
    load_library(*_LIB, verbose=verbose)


def _check(tensors, dtypes, tile: int):
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    for t, dt in zip(tensors, dtypes):
        if t.device != dev or t.dtype != dt:
            raise ValueError(f"tile raster kernels take {dtypes} tensors on "
                             f"one device, got {t.dtype} on {t.device}")
    if not 1 <= tile * tile <= 1024:
        raise ValueError(f"tile {tile}: a block has at most 1024 pixels")


def _launch(fn, args, R: int, tile: int, TW: int, H: int, W: int,
            n_tiles: int, perspective_correct: bool, eps: float, device):
    s = min(H, W)
    zbuf = torch.empty((R, tile * tile), dtype=torch.float32, device=device)
    ids = torch.empty((R, tile * tile), dtype=torch.int32, device=device)
    b0 = torch.empty_like(zbuf)
    b1 = torch.empty_like(zbuf)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, n_tiles, tile, TW, H, W, f32(W / s), f32(H / s),
                 int(bool(perspective_correct)), f32(eps), zbuf.data_ptr(),
                 ids.data_ptr(), b0.data_ptr(), b1.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            f"tile raster kernel launch failed: CUDA error {err}")
    return zbuf, ids, b0, b1


def rasterize_pairs(pfv, pface, starts, counts, tile: int, TW: int, H: int,
                    W: int, n_tiles: int, K_cap: int = 1024,
                    perspective_correct: bool = True, eps: float = 1e-8):
    """Nearest face per pixel of each row's pair segment (kernel B1).

    pfv (NFE, 9) float32 rows x0 y0 z0 x1 y1 z1 x2 y2 z2, pface (NFE,) int32
    face ids (ascending within each segment), starts / counts (R,) int32.
    Returns (zbuf, face id, b0, b1), each (R, tile * tile). CPU tensors take
    the plain twin; CUDA tensors launch the kernel (counted in
    ``rasterize_pairs.launches``)."""
    if pfv.device.type == "cpu":
        return rasterize_pairs_plain(pfv, pface, starts, counts, tile, TW, H,
                                     W, n_tiles, K_cap, perspective_correct,
                                     eps)
    _check((pfv, pface, starts, counts),
           (torch.float32, torch.int32, torch.int32, torch.int32), tile)
    NFE, R = pfv.shape[0], starts.shape[0]
    if (pfv.shape != (NFE, 9) or pface.shape != (NFE,)
            or counts.shape != (R,) or starts.dim() != 1):
        raise ValueError(f"bad shapes pfv {tuple(pfv.shape)}, pface "
                         f"{tuple(pface.shape)}, starts "
                         f"{tuple(starts.shape)}, counts "
                         f"{tuple(counts.shape)}")
    if R == 0:
        return _empty_outputs(0, tile * tile, pfv.device)
    pfv, pface, starts, counts = (t.contiguous()
                                  for t in (pfv, pface, starts, counts))
    out = _launch(_library().macarons_raster_pairs,
                  (pfv.data_ptr(), pface.data_ptr(), starts.data_ptr(),
                   counts.data_ptr(), R, NFE, int(K_cap)),
                  R, tile, TW, H, W, n_tiles, perspective_correct, eps,
                  pfv.device)
    rasterize_pairs.launches += 1
    return out


rasterize_pairs.launches = 0


def rasterize_tiles(tile_fv, tile_valid, tile_counts, tile: int, TW: int,
                    H: int, W: int, n_tiles: int, k_chunk: int = 256,
                    perspective_correct: bool = True, eps: float = 1e-8):
    """Nearest face per pixel of each row's dense face list (kernel B2).

    tile_fv (R, 9, K) float32, tile_valid (R, K) float32 (> 0 = real face),
    tile_counts (R,) int32. Lanes up to the count rounded up to whole
    ``k_chunk`` chunks are tested. Returns (zbuf, slot, b0, b1), each
    (R, tile * tile). CPU tensors take the plain twin; CUDA tensors launch the
    kernel (counted in ``rasterize_tiles.launches``)."""
    if tile_fv.device.type == "cpu":
        return rasterize_tiles_plain(tile_fv, tile_valid, tile_counts, tile,
                                     TW, H, W, n_tiles, k_chunk,
                                     perspective_correct, eps)
    _check((tile_fv, tile_valid, tile_counts),
           (torch.float32, torch.float32, torch.int32), tile)
    R, _, K = tile_fv.shape
    if (tile_fv.shape != (R, 9, K) or tile_valid.shape != (R, K)
            or tile_counts.shape != (R,)):
        raise ValueError(f"bad shapes tile_fv {tuple(tile_fv.shape)}, "
                         f"tile_valid {tuple(tile_valid.shape)}, tile_counts "
                         f"{tuple(tile_counts.shape)}")
    if R == 0:
        return _empty_outputs(0, tile * tile, tile_fv.device)
    tile_fv, tile_valid, tile_counts = (
        t.contiguous() for t in (tile_fv, tile_valid, tile_counts))
    out = _launch(_library().macarons_raster_tiles,
                  (tile_fv.data_ptr(), tile_valid.data_ptr(),
                   tile_counts.data_ptr(), R, K, min(int(k_chunk), K)),
                  R, tile, TW, H, W, n_tiles, perspective_correct, eps,
                  tile_fv.device)
    rasterize_tiles.launches += 1
    return out


rasterize_tiles.launches = 0


def flops(n_faces: int, rows: int, P: int = 256) -> int:
    """Operations of a launch testing ``n_faces`` (row, face) pairs in all,
    each against the row's P pixels (see OPS_PER_PIXEL_FACE)."""
    return (OPS_PER_PIXEL_FACE * P * n_faces + OPS_PER_FACE * n_faces
            + OPS_PER_PIXEL * rows * P)


def bytes_moved(n_faces: int, rows: int, P: int = 256) -> int:
    """Each face read once (9 float32 and a 4-byte id or valid flag), each
    row's start and count, and the four (rows, P) outputs written once."""
    return 40 * n_faces + 8 * rows + 16 * rows * P
