"""Tile rasterizer: the CUDA kernel's wrappers and their plain PyTorch twins.

Port of the two Pallas kernels of macarons_tpu/ops/pallas/tile_raster.py,
the per-tile stage of the tiled capture path:

- ``rasterize_pairs`` (B1, ``pallas_rasterize_pairs``): each grid row tests
  the first ``min(count, K_cap)`` pairs of its segment of a tile-sorted
  (tile, face) pair array and returns the nearest face's id.
- ``rasterize_tiles`` (B2, ``pallas_rasterize_tiles``): each grid row tests
  its dense face list, up to its count rounded up to whole ``k_chunk``
  chunks, and returns the nearest face's lane (slot).
- ``rasterize_tiled``: both on the capture path's inputs, faces read by id
  from the projected faces, merged per pixel (the nearer face, on a z tie
  the smaller face id); one launch on the card.

Row ``r`` is screen tile ``r % n_tiles`` of camera ``r // n_tiles``; each
tile holds ``tile * tile`` pixels in row-major order. Outputs are
(R, tile * tile): zbuf (-1 = empty), face id or slot (int32, -1 = empty), b0
and b1 (0 when empty).

A CUDA tensor goes to the hand-written kernel (csrc/tile_raster.cu,
``raster_tiled_kernel``, which serves all three over a table of work items,
see ``item_table``); a CPU tensor goes to the plain versions, which repeat
the kernel's arithmetic step by step with tensor ops (the kernel is built
with ``-fmad=false`` so that both round alike). A failed build or launch
raises. The CUDA wrappers never wait on the device. ``nearest_face`` is the
twins' shared per-tile test; the XLA-style binned path of ops.rasterizer
uses it too.
"""

from __future__ import annotations

import ctypes
from collections import Counter

import numpy as np
import torch

from .build import load_library

_BIG = 3.0e38
_LIB = ("macarons_tile_raster", "tile_raster.cu", ["-fmad=false"])
# Elements of one (rows, pixels, faces) block of the twins' tensor ops.
BLOCK_ELEMS = 1 << 21
# Faces per work item of the kernel (1 to 128; 32 was the fastest of 16, 32,
# 64 and 128 at the scene-scale move, chip_smoke.py's item sweep).
ITEM = 32
_MODE_PAIRS, _MODE_LANES, _MODE_FUSED = 0, 1, 2

# Float operations counted from the kernel body (csrc/tile_raster.cu): the
# edge functions and the inside test every (pixel, face) pair needs
# (test_item up to the inside test); the perspective correction and depth of
# covered pixels are left out, so the bound is a lower bound.
OPS_PER_PIXEL_FACE = 21
OPS_PER_FACE = 10  # signed area, its test and 1/area
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


def _pair_lengths(nfe: int, starts, counts, K_cap: int):
    """Pairs each row tests: the first min(count, K_cap) of its segment,
    inside the pair array."""
    n = torch.minimum(counts.clamp(max=K_cap), nfe - starts)
    return n.clamp(min=0)


def _tile_lengths(tile_counts, K: int, k_chunk: int):
    kc = min(k_chunk, K)
    return torch.clamp((tile_counts.clamp(min=0) + kc - 1) // kc * kc, max=K)


def _pairs_plain(fv_at, pface, starts, counts, tile, TW, H, W, n_tiles,
                 K_cap, perspective_correct, eps):
    """The B1 twin over faces ``fv_at(rows, idx)`` (G, 9, K) at the pair
    indices idx (G, K) of a group of rows."""
    nfe = pface.shape[0]
    n = _pair_lengths(nfe, starts, counts, K_cap)

    def gather(rows, K):
        k = torch.arange(K, device=pface.device)
        idx = (starts[rows, None] + k).clamp(0, nfe - 1)
        return fv_at(rows, idx), k < n[rows, None], pface[idx].long()

    return _raster_groups(n, gather, n_tiles, tile, TW, H, W,
                          perspective_correct, eps)


def _tiles_plain(fv_at, tile_valid, tile_counts, tile, TW, H, W, n_tiles,
                 k_chunk, perspective_correct, eps):
    """The B2 twin over faces ``fv_at(rows, K)`` (G, 9, K), the first K
    lanes of a group of rows; each row tests its valid lanes below its own
    length (a valid lane past it is skipped, as the kernels skip it)."""
    n = _tile_lengths(tile_counts, tile_valid.shape[1], k_chunk)

    def gather(rows, K):
        k = torch.arange(K, device=tile_valid.device)
        return (fv_at(rows, K),
                (tile_valid[rows, :K] > 0) & (k < n[rows, None]),
                k.expand(len(rows), K))

    return _raster_groups(n, gather, n_tiles, tile, TW, H, W,
                          perspective_correct, eps)


def rasterize_pairs_plain(pfv, pface, starts, counts, tile: int, TW: int,
                          H: int, W: int, n_tiles: int, K_cap: int = 1024,
                          perspective_correct: bool = True,
                          eps: float = 1e-8):
    """The plain twin of B1 (same arguments as rasterize_pairs)."""
    return _pairs_plain(lambda rows, idx: pfv[idx].permute(0, 2, 1), pface,
                        starts, counts, tile, TW, H, W, n_tiles, K_cap,
                        perspective_correct, eps)


def rasterize_tiles_plain(tile_fv, tile_valid, tile_counts, tile: int,
                          TW: int, H: int, W: int, n_tiles: int,
                          k_chunk: int = 256,
                          perspective_correct: bool = True,
                          eps: float = 1e-8):
    """The plain twin of B2 (same arguments as rasterize_tiles)."""
    return _tiles_plain(lambda rows, K: tile_fv[rows, :, :K], tile_valid,
                        tile_counts, tile, TW, H, W, n_tiles, k_chunk,
                        perspective_correct, eps)


def merge_passes(pairs, lanes):
    """Per pixel, the nearer of the two passes' winners, on a z tie the
    smaller face id: each pass is (zbuf, face id (-1 = empty), b0, b1).
    Returns the same four, the face ids as int32."""
    zs, fids, b0s, b1s = pairs
    zb, fidb, b0b, b1b = lanes
    fids = fids.long()
    fidb = fidb.long()
    better = (fidb >= 0) & ((fids < 0) | (zb < zs)
                            | ((zb == zs) & (fidb < fids)))
    return (torch.where(better, zb, zs),
            torch.where(better, fidb, fids).to(torch.int32),
            torch.where(better, b0b, b0s), torch.where(better, b1b, b1s))


def rasterize_tiled_plain(f9, pface, starts, counts, lane_faces, lane_valid,
                          lane_counts, tile: int, TW: int, H: int, W: int,
                          n_tiles: int, K_cap: int = 1024, k_chunk: int = 256,
                          perspective_correct: bool = True,
                          eps: float = 1e-8):
    """The plain version of rasterize_tiled (same arguments): the B1 twin
    over the pair list and the B2 twin over the lanes, both reading faces
    by id from f9, then ``merge_passes``."""
    def by_id(rows, ids):
        return f9[(rows // n_tiles)[:, None], :, ids].permute(0, 2, 1)

    pairs = _pairs_plain(lambda rows, idx: by_id(rows, pface[idx].long()),
                         pface, starts, counts, tile, TW, H, W, n_tiles,
                         K_cap, perspective_correct, eps)
    z, slot, b0, b1 = _tiles_plain(
        lambda rows, K: by_id(rows, lane_faces[rows, :K].long()), lane_valid,
        lane_counts, tile, TW, H, W, n_tiles, k_chunk, perspective_correct,
        eps)
    fid = torch.where(slot >= 0,
                      lane_faces.gather(1, slot.clamp(min=0).long()), -1)
    return merge_passes(pairs, (z, fid, b0, b1))


def lane_lists(tile_valid, tile_counts, k_chunk: int = 256):
    """The lanes each row tests, compacted: the valid ones among its count
    rounded up to whole ``k_chunk`` chunks (those the B2 twin tests), in
    ascending order. Returns (lane_idx (R, K) int32, tested lanes first;
    n_lanes (R,) int32)."""
    R, K = tile_valid.shape
    n = _tile_lengths(tile_counts, K, k_chunk)
    ok = (tile_valid > 0) & (torch.arange(K, device=tile_valid.device)
                             < n[:, None])
    lane_idx = torch.argsort((~ok).to(torch.uint8), dim=1, stable=True)
    return lane_idx.to(torch.int32), ok.sum(1, dtype=torch.int32)


def item_table(starts=None, counts=None, nfe: int = 0, K_cap: int = 0,
               lane_valid=None, lane_counts=None, k_chunk: int = 256,
               item: int = ITEM, scratch=None):
    """The kernel's work items: row r's pairs (the first min(count, K_cap)
    of its segment of an ``nfe``-pair array), then its tested lanes
    compacted (``lane_lists``), cut into items of at most ``item`` faces.

    Either list may be None. Returns (n_pairs (R,) int32, lane_idx (R, K)
    int32, whose first n_lanes[r] entries in row r are its tested lanes in
    ascending order, n_lanes (R,) int32, the missing ones None; and cum
    (R + 1,) int32, the items before each row). CUDA tensors take one
    launch of raster_items_kernel, which also sets ``scratch`` (R, P) int64
    to empty (-1), and a cumsum, without waiting on the device; CPU tensors
    take the same steps as tensor ops."""
    ref = counts if counts is not None else lane_counts
    R = ref.shape[0]
    if ref.device.type == "cpu":
        n_pairs = lane_idx = n_lanes = None
        if counts is not None:
            n_pairs = _pair_lengths(nfe, starts, counts, K_cap)
        if lane_valid is not None:
            lane_idx, n_lanes = lane_lists(lane_valid, lane_counts, k_chunk)
        per_row = sum(-(-n // item) for n in (n_pairs, n_lanes)
                      if n is not None)
        if scratch is not None:
            scratch.fill_(-1)
        return n_pairs, lane_idx, n_lanes, torch.nn.functional.pad(
            torch.cumsum(per_row, 0, dtype=torch.int32), (1, 0))
    dev = ref.device

    def new(*shape):
        return torch.empty(shape, dtype=torch.int32, device=dev)

    n_pairs = None if counts is None else new(R)
    lane_idx = n_lanes = K = None
    if lane_valid is not None:
        K = lane_valid.shape[1]
        lane_idx, n_lanes = new(R, K), new(R)
        if lane_valid.dtype != torch.bool:
            lane_valid = lane_valid > 0
    per_row = new(R + 1)

    with torch.cuda.device(dev):
        err = _library().macarons_raster_items(
            _ptr(starts), _ptr(counts), nfe, int(K_cap), _ptr(lane_valid),
            _ptr(lane_counts), K or 0, int(k_chunk), R, item,
            0 if scratch is None else scratch.shape[1], _ptr(n_pairs),
            _ptr(lane_idx), _ptr(n_lanes), per_row.data_ptr(), _ptr(scratch),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tile raster item table failed: CUDA error {err}")
    return n_pairs, lane_idx, n_lanes, torch.cumsum(per_row, 0,
                                                    dtype=torch.int32)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _library():
    lib = load_library(*_LIB)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.macarons_raster_items.argtypes = (
        [p, p, i, i, p, p] + [i] * 5 + [p] * 6)
    lib.macarons_raster_tiled.argtypes = (
        [i] + [p] * 8 + [i, p, i, p, i, i] + [i] * 5 + [f, f, i, f]
        + [p] * 6)
    lib.macarons_raster_items.restype = ctypes.c_int
    lib.macarons_raster_tiled.restype = ctypes.c_int
    return lib


def build(verbose: bool = False):
    """Compile the kernel now (``verbose`` prints the ptxas report)."""
    load_library(*_LIB, verbose=verbose)


def _check(tensors, dtypes, tile: int):
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    for t, dt in zip(tensors, dtypes):
        if t.device != dev or (dt is not None and t.dtype != dt):
            raise ValueError(f"tile raster kernels take {dtypes} tensors on "
                             f"one device, got {t.dtype} on {t.device}")
    if not (1 <= tile * tile <= 1024 and tile % 2 == 0):
        raise ValueError(f"tile {tile}: the kernel takes even tiles of at "
                         f"most 1024 pixels")


def _launch(mode, R: int, tile: int, TW: int, H: int, W: int, n_tiles: int,
            perspective_correct: bool, eps: float, device, item: int = ITEM,
            pface=None, starts=None, counts=None, K_cap: int = 0,
            lane_valid=None, lane_counts=None, k_chunk: int = 256, pfv=None,
            tile_fv=None, lane_face=None, faces=None):
    """Build the item table and launch raster_tiled_kernel and its epilogue
    on the current stream. Temporaries freed on return go back to the
    caching allocator of this stream, so later work reusing them runs after
    the kernel."""
    if not 1 <= item <= 128:
        raise ValueError(f"item {item}: the kernel takes 1 to 128 faces")
    if not eps >= 0:
        raise ValueError(f"eps {eps}: the kernel's depth keys need eps >= 0")
    P = tile * tile
    scratch = torch.empty((R, P), dtype=torch.int64, device=device)
    nfe = 0 if pface is None else pface.shape[0]
    n_pairs, lane_idx, n_lanes, cum = item_table(
        starts, counts, nfe, K_cap, lane_valid, lane_counts, k_chunk, item,
        scratch)
    zbuf = torch.empty((R, P), dtype=torch.float32, device=device)
    ids = torch.empty((R, P), dtype=torch.int32, device=device)
    b0 = torch.empty_like(zbuf)
    b1 = torch.empty_like(zbuf)
    s = min(H, W)

    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _library().macarons_raster_tiled(
            mode, _ptr(pfv), _ptr(pface), _ptr(starts), _ptr(n_pairs),
            _ptr(tile_fv), _ptr(lane_idx), _ptr(lane_face), _ptr(n_lanes),
            0 if lane_idx is None else lane_idx.shape[1], _ptr(faces),
            0 if faces is None else faces.shape[1], cum.data_ptr(), R, item,
            n_tiles, tile, TW, H, W, f32(W / s), f32(H / s),
            int(bool(perspective_correct)), f32(eps), scratch.data_ptr(),
            zbuf.data_ptr(), ids.data_ptr(), b0.data_ptr(), b1.data_ptr(),
            stream)
    if err != 0:
        raise RuntimeError(
            f"tile raster kernel launch failed: CUDA error {err}")
    return zbuf, ids, b0, b1


def rasterize_pairs(pfv, pface, starts, counts, tile: int, TW: int, H: int,
                    W: int, n_tiles: int, K_cap: int = 1024,
                    perspective_correct: bool = True, eps: float = 1e-8):
    """Nearest face per pixel of each row's pair segment (kernel B1).

    pfv (NFE, 9) float32 rows x0 y0 z0 x1 y1 z1 x2 y2 z2, pface (NFE,) int32
    face ids, starts / counts (R,) int32. On a z tie the earlier pair wins.
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
    out = _launch(_MODE_PAIRS, R, tile, TW, H, W, n_tiles,
                  perspective_correct, eps, pfv.device, pface=pface,
                  starts=starts, counts=counts, K_cap=int(K_cap), pfv=pfv)
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
    out = _launch(_MODE_LANES, R, tile, TW, H, W, n_tiles,
                  perspective_correct, eps, tile_fv.device,
                  lane_valid=tile_valid.contiguous(),
                  lane_counts=tile_counts.contiguous(),
                  k_chunk=int(k_chunk), tile_fv=tile_fv.contiguous())
    rasterize_tiles.launches += 1
    return out


rasterize_tiles.launches = 0


def rasterize_tiled(f9, pface, starts, counts, lane_faces, lane_valid,
                    lane_counts, tile: int, TW: int, H: int, W: int,
                    n_tiles: int, K_cap: int = 1024, k_chunk: int = 256,
                    perspective_correct: bool = True, eps: float = 1e-8, *,
                    item: int = ITEM):
    """Nearest face per pixel of each row over its pair segment and its
    dense lanes together (kernels B1 and B2 and their merge, in one launch).

    f9 (N, 9, F) float32 projected faces (ops.rasterizer.project_fv_batch);
    the pair list as rasterize_pairs takes it, without pfv: pface (NFE,)
    int32 face ids, ascending within each segment, starts / counts (R,)
    int32, R = N * n_tiles; the lanes as rasterize_tiles takes them, by face
    id: lane_faces (R, K) int32, ascending over the valid lanes, lane_valid
    (R, K) (> 0 = real face), lane_counts (R,) int32. The winner of a pixel
    has the smallest z, then the smallest face id. Returns (zbuf, face id,
    b0, b1), each (R, tile * tile). CPU tensors take the plain version (the
    two twins and ``merge_passes``); CUDA tensors launch the kernel
    (counted in ``rasterize_tiled.launches``, and by (N, F) in
    ``rasterize_tiled.launches_at``), ``item`` faces per work item."""
    if f9.device.type == "cpu":
        return rasterize_tiled_plain(f9, pface, starts, counts, lane_faces,
                                     lane_valid, lane_counts, tile, TW, H, W,
                                     n_tiles, K_cap, k_chunk,
                                     perspective_correct, eps)
    _check((f9, pface, starts, counts, lane_faces, lane_valid, lane_counts),
           (torch.float32, torch.int32, torch.int32, torch.int32, torch.int32,
            None, torch.int32), tile)
    N, _, F = f9.shape
    R, K = lane_faces.shape
    if (f9.shape != (N, 9, F) or N * n_tiles != R or pface.dim() != 1
            or starts.shape != (R,) or counts.shape != (R,)
            or lane_valid.shape != (R, K) or lane_counts.shape != (R,)):
        raise ValueError(f"bad shapes f9 {tuple(f9.shape)} ({n_tiles} tiles "
                         f"per camera), pface {tuple(pface.shape)}, starts "
                         f"{tuple(starts.shape)}, counts "
                         f"{tuple(counts.shape)}, lanes "
                         f"{tuple(lane_faces.shape)}, "
                         f"{tuple(lane_valid.shape)}, "
                         f"{tuple(lane_counts.shape)}")
    if R == 0:
        return _empty_outputs(0, tile * tile, f9.device)
    pface, starts, counts, lane_faces, lane_valid, lane_counts = (
        t.contiguous() for t in (pface, starts, counts, lane_faces,
                                 lane_valid, lane_counts))
    out = _launch(_MODE_FUSED, R, tile, TW, H, W, n_tiles,
                  perspective_correct, eps, f9.device, item=item,
                  pface=pface, starts=starts, counts=counts,
                  K_cap=int(K_cap), lane_valid=lane_valid,
                  lane_counts=lane_counts, k_chunk=int(k_chunk),
                  lane_face=lane_faces, faces=f9.transpose(1, 2).contiguous())
    rasterize_tiled.launches += 1
    rasterize_tiled.launches_at[(N, F)] += 1
    return out


rasterize_tiled.launches = 0
rasterize_tiled.launches_at = Counter()


def flops(n_faces: int, rows: int, P: int = 256) -> int:
    """Operations of a launch testing ``n_faces`` (row, face) pairs in all,
    each against the row's P pixels (see OPS_PER_PIXEL_FACE)."""
    return (OPS_PER_PIXEL_FACE * P * n_faces + OPS_PER_FACE * n_faces
            + OPS_PER_PIXEL * rows * P)


def bytes_moved(n_faces: int, rows: int, P: int = 256) -> int:
    """Each face read once (9 float32 and a 4-byte id or valid flag), each
    row's start and count, and the four (rows, P) outputs written once."""
    return 40 * n_faces + 8 * rows + 16 * rows * P


def tiled_flops(n_pairs: int, n_lanes: int, rows: int, P: int = 256) -> int:
    """Operations of rasterize_tiled: those of B1 over the pairs and of B2
    over the lanes."""
    return flops(n_pairs, rows, P) + flops(n_lanes, rows, P)


def tiled_bytes(n_pairs: int, n_lanes: int, rows: int, P: int = 256) -> int:
    """Bytes of rasterize_tiled: every face read once, one set of
    outputs."""
    return bytes_moved(n_pairs + n_lanes, rows, P)
