"""Mesh rasterizer (port of macarons_tpu/ops/rasterizer.py): FoV and
orthographic cameras.

Three paths compute per-pixel nearest-face id, view-space zbuf (empty pixels
-1, the PyTorch3D convention) and barycentrics:

- ``"scan"``: per camera, faces are swept in fixed-size chunks against every
  pixel, keeping a running nearest face (the first on a z tie). Exact for
  any face count; the choice up to ``4 * max_faces_per_tile`` faces.
- ``"binned"``: per camera, faces are binned to the screen tiles their NDC
  box overlaps (the ``max_faces_per_tile`` smallest face ids per tile) and
  each tile tests its list with tensor ops (the JAX package's XLA binned
  path, which it runs on the CPU).
- ``"tiled"``: the JAX package's Pallas path. A tile-sorted (tile, face) pair
  list holds the faces spanning at most 2x2 tiles (B1 tests the first
  ``K_cap`` pairs of each tile); faces spanning more ("big": ground slabs,
  near walls) go through dense per-tile lists (B2), and the two passes merge
  with a face-id tie-break. On CUDA tensors the whole camera batch (e.g. the
  interpolation steps of a move) is one launch of ops.cuda.tile_raster's
  ``rasterize_tiled``, both passes and the merge; CPU tensors take its plain
  version (the B1 and B2 twins and the merge). ``binning="topk"`` uses dense
  lists for every face (``rasterize_tiles``).

``method="auto"`` takes ``"scan"`` up to ``4 * max_faces_per_tile`` faces,
above that ``"tiled"`` for CUDA tensors and ``"binned"`` for CPU tensors, as
the JAX package takes its Pallas path on the TPU and its binned path on the
CPU. Under per-tile overflow the binned and tiled paths truncate different
faces, by design.

A camera enters only through its projection (``project_verts_batch``,
``project_fv_batch``): x and y in NDC, z in view space. Every path tests
``z > eps`` and interpolates 1/z for perspective-correct barycentrics on
that view-space z, for an ``OrthoCamera`` as for a ``FoVCamera``, as the
JAX package does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .cuda.tile_raster import BLOCK_ELEMS, f32, ieee_div, nearest_face, \
    rasterize_tiled, rasterize_tiles
from .geometry import FoVCamera, OrthoCamera, ndc_pixel_grid


class Fragments(NamedTuple):
    """Rasterization output: (N, H, W[, 3]) tensors."""

    pix_to_face: torch.Tensor  # int64, -1 = empty
    zbuf: torch.Tensor  # view-space z, -1 = empty
    bary: torch.Tensor  # (N, H, W, 3)


# Semantic caps of the tiled path (macarons_tpu/ops/rasterizer.py:396-721).
SPAN_CAP = 2  # small faces span at most SPAN_CAP x SPAN_CAP tiles
MAX_BIG_FACES = 2048  # big faces kept per camera, smallest ids first
BIG_LANES = 128  # big faces per tile, smallest ids first


def k_cap(max_faces_per_tile: int, F: int) -> int:
    """Pairs each tile keeps on the tiled path (B1's K_cap): the cap, at most
    F, rounded up to whole 128-lane rows as the JAX package does."""
    return -(-min(max_faces_per_tile, F) // 128) * 128


def _rasterize_single(verts_proj, faces, image_size, chunk: int,
                      perspective_correct: bool, face_mask=None,
                      eps: float = 1e-8) -> Fragments:
    """One camera: verts_proj (V, 3) = (x_ndc, y_ndc, z_view)."""
    H, W = image_size
    dev = verts_proj.device
    ndc_x, ndc_y = ndc_pixel_grid(H, W, device=dev, dtype=verts_proj.dtype)
    px = ndc_x.reshape(-1)[:, None]
    py = ndc_y.reshape(-1)[:, None]
    fv = verts_proj[faces]  # (F, 3, 3)
    F = fv.shape[0]
    if face_mask is None:
        face_mask = torch.ones((F,), dtype=torch.bool, device=dev)

    n_pix = H * W
    best_z = torch.full((n_pix,), float("inf"), device=dev)
    best_f = torch.full((n_pix,), -1, dtype=torch.int64, device=dev)
    best_b = torch.zeros((n_pix, 3), device=dev)
    rows = torch.arange(n_pix, device=dev)
    for base in range(0, F, chunk):
        fvc = fv[base:base + chunk]
        x0, y0, z0 = fvc[:, 0, 0], fvc[:, 0, 1], fvc[:, 0, 2]
        x1, y1, z1 = fvc[:, 1, 0], fvc[:, 1, 1], fvc[:, 1, 2]
        x2, y2, z2 = fvc[:, 2, 0], fvc[:, 2, 1], fvc[:, 2, 2]
        area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
        nondegen = torch.abs(area) > eps
        valid_face = (face_mask[base:base + chunk] & nondegen & (z0 > eps)
                      & (z1 > eps) & (z2 > eps))
        inv_area = torch.where(nondegen, 1.0 / area, 0.0)
        w0 = ((x1 - px) * (y2 - py) - (x2 - px) * (y1 - py)) * inv_area
        w1 = ((x2 - px) * (y0 - py) - (x0 - px) * (y2 - py)) * inv_area
        w2 = 1.0 - w0 - w1
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & valid_face
        if perspective_correct:
            iw0, iw1, iw2 = w0 / z0, w1 / z1, w2 / z2
            denom = iw0 + iw1 + iw2
            denom = torch.where(torch.abs(denom) > eps, denom, eps)
            b0, b1, b2 = iw0 / denom, iw1 / denom, iw2 / denom
            z = b0 * z0 + b1 * z1 + b2 * z2
        else:
            b0, b1, b2 = w0, w1, w2
            z = w0 * z0 + w1 * z1 + w2 * z2
        inside = inside & (z > eps)
        z_masked = torch.where(inside, z, float("inf"))
        j = torch.argmin(z_masked, dim=-1)
        zc = z_masked[rows, j]
        better = zc < best_z
        best_z = torch.where(better, zc, best_z)
        best_f = torch.where(better, base + j, best_f)
        bc = torch.stack((b0[rows, j], b1[rows, j], b2[rows, j]), dim=-1)
        best_b = torch.where(better[:, None], bc, best_b)

    empty = ~torch.isfinite(best_z)
    return Fragments(torch.where(empty, -1, best_f).reshape(H, W),
                     torch.where(empty, -1.0, best_z).reshape(H, W),
                     best_b.reshape(H, W, 3))


def _tiles(H: int, W: int, tile: int):
    """(TH, TW): screen tiles per column and row, the last ones padded."""
    return -(-H // tile), -(-W // tile)


def _untile(x, N: int, H: int, W: int, tile: int):
    """(N * T, tile * tile[, C]) per-tile rows -> (N, H, W[, C])."""
    TH, TW = _tiles(H, W, tile)
    rest = x.shape[2:]
    x = x.reshape(N, TH, TW, tile, tile, *rest).transpose(2, 3)
    return x.reshape(N, TH * tile, TW * tile, *rest)[:, :H, :W]


def _bbox(f9):
    """Face NDC boxes (x_min, x_max, y_min, y_max) from (..., 9, F)."""
    x0, y0, x1, y1, x2, y2 = (f9[..., i, :] for i in (0, 1, 3, 4, 6, 7))
    return (torch.minimum(torch.minimum(x0, x1), x2),
            torch.maximum(torch.maximum(x0, x1), x2),
            torch.minimum(torch.minimum(y0, y1), y2),
            torch.maximum(torch.maximum(y0, y1), y2))


def _z_ok(f9, eps):
    """Faces with all three vertices in front of the camera, (..., F)."""
    z = f9[..., 2::3, :]
    return (z[..., 0, :] > eps) & (z[..., 1, :] > eps) & (z[..., 2, :] > eps)


def _first(mask, k: int):
    """Indices of the first ``k`` lanes of ``mask`` (..., L): the set lanes
    in ascending order, then the others in ascending order (lax.top_k over
    -lane scores, ties to the lower index)."""
    return torch.argsort((~mask).to(torch.uint8), dim=-1, stable=True)[..., :k]


def _tile_bounds(H: int, W: int, tile: int, device):
    """Per-tile NDC bounds (x_max, x_min, y_max, y_min), each (T,), from the
    pixel mapping (x decreases with the column)."""
    TH, TW = _tiles(H, W, tile)
    s = min(H, W)
    cols0 = torch.arange(TW, dtype=torch.float32, device=device) * tile
    rows0 = torch.arange(TH, dtype=torch.float32, device=device) * tile
    x_hi = f32(W / s) - ieee_div(2.0 * cols0, s - 1)
    x_lo = f32(W / s) - ieee_div(2.0 * (cols0 + tile - 1), s - 1)
    y_hi = f32(H / s) - ieee_div(2.0 * rows0, s - 1)
    y_lo = f32(H / s) - ieee_div(2.0 * (rows0 + tile - 1), s - 1)
    return (x_hi.repeat(TH), x_lo.repeat(TH), y_hi.repeat_interleave(TW),
            y_lo.repeat_interleave(TW))


def _overlaps(box, bounds, slack):
    """(..., T, L) overlap of face boxes (..., L) with tile bounds (T,)."""
    fxm, fxM, fym, fyM = (b[..., None, :] for b in box)
    x_max, x_min, y_max, y_min = (b[:, None] for b in bounds)
    return ((fxm <= x_max + slack) & (fxM >= x_min - slack)
            & (fym <= y_max + slack) & (fyM >= y_min - slack))


def _rasterize_single_binned(verts_proj, faces, image_size, tile: int,
                             max_faces_per_tile: int,
                             perspective_correct: bool, face_mask=None,
                             eps: float = 1e-8) -> Fragments:
    """One camera, binned: each tile tests its ``max_faces_per_tile``
    smallest overlapping face ids (overflow is dropped)."""
    H, W = image_size
    dev = verts_proj.device
    F = faces.shape[0]
    TH, TW = _tiles(H, W, tile)
    T, P = TH * TW, tile * tile
    big_pad = 1e6
    ndc_x, ndc_y = ndc_pixel_grid(H, W, device=dev, dtype=verts_proj.dtype)
    pads = (0, TW * tile - W, 0, TH * tile - H)
    ndc_x = torch.nn.functional.pad(ndc_x, pads, value=-big_pad)
    ndc_y = torch.nn.functional.pad(ndc_y, pads, value=-big_pad)
    px_t = ndc_x.reshape(TH, tile, TW, tile).transpose(1, 2).reshape(T, P)
    py_t = ndc_y.reshape(TH, tile, TW, tile).transpose(1, 2).reshape(T, P)

    flat = verts_proj[faces].reshape(F, 9)  # rows x0 y0 z0 x1 .. z2
    f9 = flat.T
    ok = _z_ok(f9, eps)
    if face_mask is not None:
        ok = ok & face_mask
    pad_x = torch.where(px_t <= -big_pad / 2, big_pad, px_t)
    pad_y = torch.where(py_t <= -big_pad / 2, big_pad, py_t)
    bounds = (px_t.max(dim=-1).values, pad_x.min(dim=-1).values,
              py_t.max(dim=-1).values, pad_y.min(dim=-1).values)
    overlap = _overlaps(_bbox(f9), bounds, f32(2.0 / (min(H, W) - 1))) & ok
    K = min(max_faces_per_tile, F)
    tile_faces = _first(overlap, K)  # (T, K) ascending face ids
    tile_valid = overlap.gather(1, tile_faces)

    zbuf = torch.empty((T, P), device=dev)
    fid = torch.empty((T, P), dtype=torch.int64, device=dev)
    bary = torch.empty((T, P, 3), device=dev)
    G = max(1, BLOCK_ELEMS // (P * max(K, 1)))
    for a in range(0, T, G):
        tf = tile_faces[a:a + G]
        z, lane, b0, b1, b2 = nearest_face(
            flat[tf].transpose(1, 2), tile_valid[a:a + G],
            px_t[a:a + G], py_t[a:a + G], None, perspective_correct, eps,
            kernel_order=False)
        empty = ~torch.isfinite(z)
        zbuf[a:a + G] = torch.where(empty, -1.0, z)
        fid[a:a + G] = torch.where(empty, -1, tf.gather(1, lane))
        bary[a:a + G] = torch.where(empty[..., None], 0.0,
                                    torch.stack((b0, b1, b2), dim=-1))
    return Fragments(*(_untile(x, 1, H, W, tile)[0]
                       for x in (fid, zbuf, bary)))


def _pairlist_pairs(f9, image_size, tile: int, span_cap: int = SPAN_CAP,
                    eps: float = 1e-8, face_mask=None):
    """Tile-sorted (tile, face) pairs of the small faces of every camera.

    f9 (N, 9, F). Each face whose box spans at most span_cap x span_cap tiles
    enumerates the tiles it overlaps; one sort of the keys tile * F + face
    groups them per tile in ascending face order. Returns (pface (N * E * F,)
    int32 face ids, starts and counts (N * T,) int32 of each (camera, tile)
    segment, big (N, F) bool: the faces spanning more tiles, which are not in
    the pair list)."""
    H, W = image_size
    N, _, F = f9.shape
    dev = f9.device
    TH, TW = _tiles(H, W, tile)
    T = TH * TW
    s = min(H, W)
    slack = f32(2.0 / (s - 1))
    ok = _z_ok(f9, eps)
    if face_mask is not None:
        ok = ok & face_mask
    fxm, fxM, fym, fyM = _bbox(f9)

    def tile_range(lo_v, hi_v, extent, n_tiles):
        # Widened by 1e-3 tiles so that rounding never drops a tile the exact
        # test below keeps.
        c_max = torch.floor(ieee_div((f32(extent / s) - lo_v + slack)
                                     * (s - 1) / 2.0, tile) + f32(1e-3))
        c_min = torch.ceil(ieee_div((f32(extent / s) - hi_v - slack)
                                    * (s - 1) / 2.0 + 1.0, tile)
                           - 1.0 - f32(1e-3))
        return (c_min.clamp(0, n_tiles - 1).long(),
                c_max.clamp(0, n_tiles - 1).long())

    cmin, cmax = tile_range(fxm, fxM, float(W), TW)
    rmin, rmax = tile_range(fym, fyM, float(H), TH)
    span_w = cmax - cmin + 1
    span_h = rmax - rmin + 1
    onscreen = ok & (span_w >= 1) & (span_h >= 1)
    small = onscreen & (span_w <= span_cap) & (span_h <= span_cap)
    big = onscreen & ~small

    E = span_cap * span_cap
    e = torch.arange(E, device=dev)
    dy = (e // span_cap)[:, None]  # (E, 1)
    dx = (e % span_cap)[:, None]
    r_c = (rmin[:, None] + dy).clamp(0, TH - 1)  # (N, E, F)
    c_c = (cmin[:, None] + dx).clamp(0, TW - 1)
    in_span = ((dy < span_h[:, None]) & (dx < span_w[:, None])
               & small[:, None])
    cf = c_c.to(torch.float32)
    rf = r_c.to(torch.float32)
    x_hi = f32(W / s) - ieee_div(2.0 * (cf * tile), s - 1)
    x_lo = f32(W / s) - ieee_div(2.0 * (cf * tile + tile - 1), s - 1)
    y_hi = f32(H / s) - ieee_div(2.0 * (rf * tile), s - 1)
    y_lo = f32(H / s) - ieee_div(2.0 * (rf * tile + tile - 1), s - 1)
    hit = ((fxm[:, None] <= x_hi + slack) & (fxM[:, None] >= x_lo - slack)
           & (fym[:, None] <= y_hi + slack) & (fyM[:, None] >= y_lo - slack)
           & in_span)
    face_id = torch.arange(F, device=dev)
    keys = torch.where(hit, (r_c * TW + c_c) * F + face_id, T * F)
    sorted_keys = torch.sort(keys.reshape(N, E * F), dim=-1).values
    sorted_faces = sorted_keys % F  # sentinels map to face 0, never read
    bounds = (torch.arange(T + 1, device=dev) * F).expand(N, T + 1)
    edges = torch.searchsorted(sorted_keys, bounds.contiguous())
    starts = edges[:, :-1] + (torch.arange(N, device=dev) * (E * F))[:, None]
    counts = edges[:, 1:] - edges[:, :-1]
    return (sorted_faces.reshape(-1).int(), starts.reshape(-1).int(),
            counts.reshape(-1).int(), big)


def _big_face_lists(f9, big, H: int, W: int, tile: int):
    """Dense per-tile lists of each camera's big faces: the first
    MAX_BIG_FACES big faces by id, then per tile the first BIG_LANES that
    overlap it. Returns (valid (N * T, BIG_LANES) bool, face ids (N * T,
    BIG_LANES), ascending over the valid lanes)."""
    N, _, F = f9.shape
    B = min(MAX_BIG_FACES, F)
    big_ids = _first(big, B)  # (N, B) ascending big face ids first
    box = tuple(b.gather(1, big_ids) for b in _bbox(f9))
    bhit = _overlaps(box, _tile_bounds(H, W, tile, f9.device),
                     f32(2.0 / (min(H, W) - 1)))
    bhit = bhit & big.gather(1, big_ids)[:, None, :]  # (N, T, B)
    if B < BIG_LANES:  # tiny meshes: pad the lanes
        bhit = torch.nn.functional.pad(bhit, (0, BIG_LANES - B))
    lidx = _first(bhit, BIG_LANES)
    valid = bhit.gather(-1, lidx)
    T = lidx.shape[1]
    faces = big_ids.gather(1, lidx.clamp(max=B - 1).reshape(N, -1))
    return valid.reshape(N * T, BIG_LANES), faces.reshape(N * T, BIG_LANES)


def _tile_pass(tile_fv, valid, faces, H, W, tile, perspective_correct, eps):
    """Kernel B2 over dense lists -> (zbuf, face id (-1 = empty), b0, b1)."""
    TH, TW = _tiles(H, W, tile)
    z, slot, b0, b1 = rasterize_tiles(
        tile_fv.contiguous(), valid.to(torch.float32),
        valid.sum(dim=-1).int(), tile, TW, H, W, n_tiles=TH * TW,
        perspective_correct=perspective_correct, eps=eps)
    fid = faces.gather(1, slot.clamp(min=0).long())
    return z, torch.where(slot >= 0, fid, -1), b0, b1


def _rasterize_tiled(f9, image_size, tile: int, max_faces_per_tile: int,
                     perspective_correct: bool, face_mask=None,
                     binning: str = "pairlist", eps: float = 1e-8):
    """The tile path over a camera batch: f9 (N, 9, F) from
    project_fv_batch."""
    H, W = image_size
    N, _, F = f9.shape
    TH, TW = _tiles(H, W, tile)
    T = TH * TW
    K = k_cap(max_faces_per_tile, F)
    if binning not in ("pairlist", "topk"):
        raise ValueError(f"unknown binning {binning!r}")
    if binning == "pairlist" and T * (F + 1) < 2**31 - 1:
        pface, starts, counts, big = _pairlist_pairs(
            f9, image_size, tile, eps=eps, face_mask=face_mask)
        valid, faces = _big_face_lists(f9, big, H, W, tile)
        # The big-face lanes go in even when no face is big: rows without
        # work write the empty sentinel, and the host never waits on the
        # device to decide.
        zbuf, fid, b0, b1 = rasterize_tiled(
            f9, pface, starts, counts, faces.int(), valid,
            valid.sum(dim=-1, dtype=torch.int32), tile, TW, H, W, n_tiles=T,
            K_cap=K, perspective_correct=perspective_correct, eps=eps)
        fid = fid.long()
    else:
        ok = _z_ok(f9, eps)
        if face_mask is not None:
            ok = ok & face_mask
        overlap = _overlaps(_bbox(f9), _tile_bounds(H, W, tile, f9.device),
                            f32(2.0 / (min(H, W) - 1))) & ok[:, None, :]
        faces = _first(overlap, min(K, F))  # (N, T, min(K, F))
        valid = overlap.gather(-1, faces)
        if K > F:
            faces = torch.nn.functional.pad(faces, (0, K - F))
            valid = torch.nn.functional.pad(valid, (0, K - F))
        fv = f9.transpose(1, 2).gather(
            1, faces.reshape(N, T * K, 1).expand(-1, -1, 9))
        zbuf, fid, b0, b1 = _tile_pass(
            fv.reshape(N * T, K, 9).transpose(1, 2), valid.reshape(N * T, K),
            faces.reshape(N * T, K), H, W, tile, perspective_correct, eps)
    hit = fid >= 0
    b0 = torch.where(hit, b0, 0.0)
    b1 = torch.where(hit, b1, 0.0)
    bary = torch.stack((b0, b1, torch.where(hit, 1.0 - b0 - b1, 0.0)), dim=-1)
    return Fragments(_untile(fid, N, H, W, tile),
                     _untile(zbuf, N, H, W, tile),
                     _untile(bary, N, H, W, tile))


def project_verts_batch(verts, camera):
    """World verts (V, 3) -> per-camera (N, V, 3) of (x_ndc, y_ndc, z_view)."""
    n_cam = camera.R.shape[0]
    view = camera.world_to_view(verts[None].expand(n_cam, *verts.shape))
    ndc = camera.project_view(view)
    return torch.cat((ndc[..., :2], view[..., 2:]), dim=-1)


def project_fv_batch(verts, faces, camera):
    """World verts + faces -> per-camera face data (N, 9, F), rows
    x0 y0 z0 x1 y1 z1 x2 y2 z2 (x/y NDC, z view), gathered once in world
    space and projected per camera."""
    n_cam = camera.R.shape[0]
    F = faces.shape[0]
    pts = verts[faces].reshape(F * 3, 3)[None].expand(n_cam, F * 3, 3)
    view = camera.world_to_view(pts)
    ndc = camera.project_view(view)
    out = torch.cat((ndc[..., :2], view[..., 2:]), dim=-1)
    return out.reshape(n_cam, F, 9).transpose(1, 2)


def rasterize(verts, faces, camera, image_size, chunk: int = 256,
              perspective_correct: bool = True, face_mask=None,
              method: str = "auto", tile: int = 16,
              max_faces_per_tile: int = 1024,
              binning: str = "pairlist") -> Fragments:
    """Rasterize a mesh under a batched FoV or orthographic camera ->
    (N, H, W[, 3]).

    method: "scan", "binned", "tiled" or "auto" (see the module docstring);
    binning ("pairlist" or "topk") selects the tiled path's lists."""
    if not isinstance(camera, (FoVCamera, OrthoCamera)):
        raise TypeError(type(camera))
    F = faces.shape[0]
    image_size = tuple(image_size)
    if method == "auto":
        if F > 4 * max_faces_per_tile:
            method = "tiled" if verts.device.type == "cuda" else "binned"
        else:
            method = "scan"
    if method == "tiled":
        return _rasterize_tiled(project_fv_batch(verts, faces, camera),
                                image_size, tile, max_faces_per_tile,
                                perspective_correct, face_mask, binning)
    vp = project_verts_batch(verts, camera)
    if method == "binned":
        frags = [_rasterize_single_binned(v, faces, image_size, tile,
                                          max_faces_per_tile,
                                          perspective_correct, face_mask)
                 for v in vp]
    elif method == "scan":
        frags = [_rasterize_single(v, faces, image_size, chunk,
                                   perspective_correct, face_mask)
                 for v in vp]
    else:
        raise ValueError(f"unknown rasterization method {method!r}")
    return Fragments(*(torch.stack(t) for t in zip(*frags)))


class PointLights(NamedTuple):
    """PyTorch3D-style point lights: location (L, 3), colours (L, 3)."""

    location: torch.Tensor
    ambient_color: torch.Tensor
    diffuse_color: torch.Tensor
    specular_color: torch.Tensor

    @classmethod
    def create(cls, location, ambient=0.5, diffuse=0.3, specular=0.2):
        location = torch.atleast_2d(torch.as_tensor(location,
                                                    dtype=torch.float32))
        L = location.shape[0]

        def col(v):
            return torch.as_tensor(v, dtype=torch.float32,
                                   device=location.device).expand(L, 3)

        return cls(location, col(ambient), col(diffuse), col(specular))


def face_normals(verts, faces):
    fv = verts[faces]
    n = torch.linalg.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0], dim=-1)
    return n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True),
                           min=1e-12)


def interpolate_face_attributes(fragments: Fragments, face_attrs):
    """face_attrs (F, 3, C) -> (N, H, W, C) at the winning faces."""
    f = torch.clamp(fragments.pix_to_face, min=0)
    out = torch.einsum("...k,...kc->...c", fragments.bary, face_attrs[f])
    return torch.where(fragments.pix_to_face[..., None] >= 0, out, 0.0)


def sample_texture_atlas(fragments: Fragments, atlas, mode: str = "nearest"):
    """Sample a per-face texture atlas (F, R, R, 3) at the winning faces'
    barycentrics (PyTorch3D TexturesAtlas: grid coordinates from (w0, w1),
    align_corners). Returns (N, H, W, 3)."""
    R = atlas.shape[1]
    f = torch.clamp(fragments.pix_to_face, min=0)
    gy = torch.clamp(fragments.bary[..., 0], 0.0, 1.0) * (R - 1)
    gx = torch.clamp(fragments.bary[..., 1], 0.0, 1.0) * (R - 1)
    if mode == "nearest":
        tex = atlas[f, torch.round(gy).long(), torch.round(gx).long()]
    else:
        y0 = torch.floor(gy).long()
        x0 = torch.floor(gx).long()
        y1 = torch.clamp(y0 + 1, max=R - 1)
        x1 = torch.clamp(x0 + 1, max=R - 1)
        wy = (gy - y0)[..., None]
        wx = (gx - x0)[..., None]
        tex = (atlas[f, y0, x0] * (1 - wy) * (1 - wx)
               + atlas[f, y0, x1] * (1 - wy) * wx
               + atlas[f, y1, x0] * wy * (1 - wx)
               + atlas[f, y1, x1] * wy * wx)
    return torch.where(fragments.pix_to_face[..., None] >= 0, tex, 0.0)


def flat_shading(fragments: Fragments, verts, faces, texels,
                 lights: PointLights, camera_center, shininess: float = 64.0):
    """Per-face-normal Phong lighting: texels * (ambient + diffuse) +
    specular."""
    pix_normals = face_normals(verts, faces)[torch.clamp(fragments.pix_to_face,
                                                         min=0)]
    pix_pos = interpolate_face_attributes(fragments, verts[faces])
    amb = lights.ambient_color.sum(dim=0)

    def unit(v):
        return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                               min=1e-12)

    light_dir = unit(lights.location[None, None, None] - pix_pos[..., None, :])
    n = pix_normals[..., None, :]
    ndotl = (n * light_dir).sum(dim=-1)
    diffuse = (torch.clamp(ndotl, min=0.0)[..., None]
               * lights.diffuse_color).sum(dim=-2)
    view_dir = unit(camera_center[:, None, None, None, :]
                    - pix_pos[..., None, :])
    reflect = 2.0 * ndotl[..., None] * n - light_dir
    spec_cos = torch.clamp((reflect * view_dir).sum(dim=-1), min=0.0)
    specular = ((spec_cos ** shininess)[..., None]
                * lights.specular_color).sum(dim=-2)
    return texels * (amb + diffuse) + specular


def render_mesh(verts, faces, camera: FoVCamera, image_size,
                lights: PointLights, vert_colors=None, face_colors=None,
                texture_atlas=None, background=1.0, chunk: int = 256,
                perspective_correct: bool = False, face_mask=None):
    """Rasterize + flat-shade + hard blend over a background.
    Returns (images (N, H, W, 3), Fragments). Albedo: the per-face texture
    atlas (F, R, R, 3), else interpolated vertex colours, else per-face
    colours, else 1."""
    frags = rasterize(verts, faces, camera, image_size, chunk=chunk,
                      perspective_correct=perspective_correct,
                      face_mask=face_mask)
    if texture_atlas is not None:
        texels = sample_texture_atlas(frags, texture_atlas)
    elif vert_colors is not None:
        texels = interpolate_face_attributes(frags, vert_colors[faces])
    elif face_colors is not None:
        texels = face_colors[torch.clamp(frags.pix_to_face, min=0)]
    else:
        texels = torch.ones((*frags.zbuf.shape, 3), device=verts.device)
    colors = flat_shading(frags, verts, faces, texels, lights,
                          camera.camera_center())
    images = torch.where((frags.pix_to_face >= 0)[..., None], colors,
                         float(background))
    return images, frags
