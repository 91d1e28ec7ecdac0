"""Per-cell occupancy inference and batched NBV scoring (port of
macarons_tpu/scene/runtime.py).

1. Occupancy field: proxy points are grouped by grid cell in a static index
   table; SconeOcc runs on each selected cell's proxies against the surface
   points of its 3x3x3 neighbourhood, in the prediction camera's view frame,
   and the results scatter back into the flat proxy field. The full field
   walks the cells in chunks, most eligible first, and stops at the first
   chunk with no eligible proxy.
2. Coverage gains: every candidate camera is scored in ONE batched call:
   per-candidate FoV + occupancy filtering, occupancy-weighted MC sampling
   with repeats, SconeVis on (C_pad, seq_len) point sets, the SH visibility
   integral (the CUDA kernel on the card), distance factor and gain.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..models.scone import compute_visibilities
from ..ops.geometry import FoVCamera
from ..ops.projection import points_in_fov_mask
from ..ops.view_state import (
    compute_view_harmonics,
    normalize_points_in_prediction_box,
    sample_proxy_points,
    view_harmonics_weights,
    view_space_permutation,
)
from ..utils.device import compute_dtype as dtype_named
from .grid import GridConfig, GridState
from .proxy import ProxyState


class CellIndexTable(NamedTuple):
    """Proxy membership per grid cell and 3x3x3 neighbour ids (host numpy)."""

    proxy_slots: np.ndarray  # (n_cells, K_cell) int32 proxy indices
    proxy_slot_mask: np.ndarray  # (n_cells, K_cell) bool
    neighbor_ids: np.ndarray  # (n_cells, 27) int32 cell ids (clamped)


def build_cell_index_table(cfg: GridConfig, proxy_points: np.ndarray,
                           k_cell: Optional[int] = None,
                           k_cell_bucket: int = 64) -> CellIndexTable:
    """Group the fixed proxy points by cell (K_cell rounded up to a multiple
    of ``k_cell_bucket``) and list each cell's clamped 3x3x3 neighbours."""
    proxy_points = np.asarray(proxy_points)
    mn = np.asarray(cfg.x_min, np.float32)
    sz = np.asarray(cfg.cell_size, np.float32)
    dims = np.array([cfg.grid_l, cfg.grid_w, cfg.grid_h])
    idx3 = np.clip(np.floor((proxy_points - mn) / sz).astype(np.int64), 0,
                   dims - 1)
    cid = (idx3[:, 0] * cfg.grid_w + idx3[:, 1]) * cfg.grid_h + idx3[:, 2]
    C = cfg.n_cells
    counts = np.bincount(cid, minlength=C)
    if k_cell is None:
        k_cell = int(counts.max())
        if k_cell_bucket > 1:
            k_cell = -(-k_cell // k_cell_bucket) * k_cell_bucket
    order = np.argsort(cid, kind="stable").astype(np.int64)
    sorted_cid = cid[order]
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(len(cid)) - np.repeat(starts, counts)
    keep = rank < k_cell
    slots = np.zeros((C, k_cell), np.int32)
    mask = np.zeros((C, k_cell), bool)
    slots[sorted_cid[keep], rank[keep]] = order[keep]
    mask[sorted_cid[keep], rank[keep]] = True

    ijk = np.stack(np.unravel_index(np.arange(C), dims), axis=-1)
    shifts = np.stack(np.meshgrid(*([np.arange(-1, 2)] * 3), indexing="ij"),
                      axis=-1).reshape(-1, 3)
    nb = np.clip(ijk[:, None, :] + shifts[None], 0, dims - 1)
    neighbor_ids = ((nb[..., 0] * dims[1] + nb[..., 1]) * dims[2]
                    + nb[..., 2]).astype(np.int32)
    return CellIndexTable(slots, mask, neighbor_ids)


class CellTables(NamedTuple):
    """Device copies of a scene's cell tables."""

    slots: torch.Tensor  # (C, K_cell) int64
    slot_mask: torch.Tensor  # (C, K_cell) bool
    neighbor_ids: torch.Tensor  # (C, 27) int64
    centers: torch.Tensor  # (C, 3) cell centres
    pred_diag: float  # neighbourhood size * cell diagonal


def device_cell_tables(cfg: GridConfig, table: CellIndexTable,
                       prediction_neighborhood_size: float = 3.0,
                       device=None) -> CellTables:
    return CellTables(
        torch.as_tensor(table.proxy_slots, dtype=torch.int64, device=device),
        torch.as_tensor(table.proxy_slot_mask, device=device),
        torch.as_tensor(table.neighbor_ids, dtype=torch.int64, device=device),
        cfg.cell_centers(device),
        prediction_neighborhood_size * float(np.linalg.norm(cfg.cell_size)))


class OccupancyField:
    """SconeOcc over grid cells -> (proba (N, 1), prediction_mask (N,),
    harmonics (N, H)) for one prediction camera.

    ``full_field`` covers every cell with an eligible proxy, in chunks of
    ``full_field_chunk`` (default ``max_cells``) cells; otherwise only the
    ``max_cells`` cells with most eligible proxies. Within a chunk, SconeOcc
    runs on ``cell_batch`` cells per call. Calling the field runs without
    grad (inference); ``supervise`` is the training pass.

    ``compute_dtype`` (None, "none" or "float32": float32; else a floating
    type's name, "bfloat16") runs SconeOcc on copies of its floating
    parameters cast to that type, with its inputs cast too and its output
    cast back to float32, as the JAX package's ``occupancy_field_impl``
    does; the gradient reaches the float32 parameters through the casts.
    The view harmonics returned stay float32."""

    def __init__(self, occ_model, n_elev: int = 7, n_azim: int = 14,
                 degree: int = 8, k_for_knn: int = 16, max_cells: int = 32,
                 cell_batch: int = 4, full_field_chunk: Optional[int] = None,
                 compute_dtype=None):
        self.occ_model = occ_model
        self.compute_dtype = dtype_named(compute_dtype)
        self.n_elev, self.n_azim = n_elev, n_azim
        self.n_harmonics = degree * degree
        self.degree = degree
        self.k_for_knn = k_for_knn
        self.max_cells = max_cells
        self.cell_batch = cell_batch
        self.full_field_chunk = full_field_chunk
        self._weights = {}

    def _vh_weights(self, device):
        key = str(device)
        if key not in self._weights:
            self._weights[key] = view_harmonics_weights(
                self.degree, self.n_elev, self.n_azim, device)
        return self._weights[key]

    def _cells(self, proxy, surface, tables, prediction_camera, elig_per_slot,
               perm, cells, cell_ok):
        """SconeOcc on the proxies of ``cells`` (M,) against the surface
        points of their neighbourhoods. Returns the flat (slot ids,
        occupancy, view harmonics, mask) of the M * K_cell proxy slots."""
        c_slots = tables.slots[cells]
        masks_in = elig_per_slot[cells]
        M = cells.shape[0]
        nb = tables.neighbor_ids[cells]
        pc_world = surface.points[nb].reshape(M, -1, 3)
        pc_mask = surface.valid[nb].reshape(M, -1)
        centers_v = prediction_camera.world_to_view(
            tables.centers[cells][None])[0]
        diag = tables.pred_diag
        Xn = normalize_points_in_prediction_box(
            prediction_camera.world_to_view(proxy.points[c_slots]),
            centers_v[:, None, :], diag)
        pcn = normalize_points_in_prediction_box(
            prediction_camera.world_to_view(pc_world),
            centers_v[:, None, :], diag)
        vhs = compute_view_harmonics(proxy.view_states[c_slots][..., perm],
                                     self._vh_weights(proxy.points.device))
        enough = pc_mask.sum(dim=-1) > 4 * self.k_for_knn
        model, vh_in = self.occ_model, vhs
        dt = self.compute_dtype
        if dt is not None:
            weights = {name: p.to(dt) if p.is_floating_point() else p
                       for name, p in model.named_parameters()}
            pcn, Xn, vh_in = pcn.to(dt), Xn.to(dt), vhs.to(dt)

            def model(*args, **kw):
                return torch.func.functional_call(
                    self.occ_model, weights, args, kw).float()

        def run(pcn_b, Xn_b, vhs_b, m_b):
            return model(pcn_b, Xn_b, vhs_b, pc_mask=m_b)[..., 0]

        outs = []
        for s in range(0, M, self.cell_batch):
            args = (pcn[s:s + self.cell_batch], Xn[s:s + self.cell_batch],
                    vh_in[s:s + self.cell_batch],
                    pc_mask[s:s + self.cell_batch])
            if torch.is_grad_enabled():
                outs.append(checkpoint(run, *args, use_reentrant=False))
            else:
                outs.append(run(*args))
        occs = torch.where(enough[:, None], torch.cat(outs), 0.0)
        m = (masks_in & enough[:, None] & cell_ok[:, None]).reshape(-1)
        return (c_slots.reshape(-1), occs.reshape(-1),
                vhs.reshape(-1, self.n_harmonics), m)

    def _eligible(self, proxy, tables, use_supervision_occ_mask,
                  eligible_override=None):
        fov_mask = proxy.out_of_field[:, 0] < 1.0
        if eligible_override is not None:
            eligible = eligible_override
        elif use_supervision_occ_mask:
            eligible = (proxy.supervision_occ[:, 0] > 0.0) & fov_mask
        else:
            eligible = fov_mask
        elig_per_slot = eligible[tables.slots] & tables.slot_mask
        return elig_per_slot, elig_per_slot.sum(dim=-1)

    @torch.no_grad()
    def __call__(self, proxy: ProxyState, surface: GridState,
                 tables: CellTables, prediction_camera: FoVCamera,
                 use_supervision_occ_mask: bool = True,
                 full_field: bool = False):
        N = proxy.points.shape[0]
        C = tables.slots.shape[0]
        dev = proxy.points.device
        elig_per_slot, counts = self._eligible(proxy, tables,
                                               use_supervision_occ_mask)
        perm = view_space_permutation(prediction_camera, self.n_elev,
                                      self.n_azim)

        proba = torch.zeros((N + 1,), device=dev)
        harmonics = torch.zeros((N + 1, self.n_harmonics), device=dev)
        pred_mask = torch.zeros((N + 1,), dtype=torch.bool, device=dev)

        def process(cells, cell_ok):
            slots, occs, vhs, m = self._cells(
                proxy, surface, tables, prediction_camera, elig_per_slot,
                perm, cells, cell_ok)
            idx = slots[m]
            proba[idx] = occs[m]
            harmonics[idx] = vhs[m]
            pred_mask[idx] = True

        if full_field:
            chunk = min(self.full_field_chunk or self.max_cells, C)
            order = torch.argsort(-counts, stable=True)
            n_chunks = -(-C // chunk)
            pad = n_chunks * chunk - C
            pad_order = torch.cat([order, order.new_zeros(pad)])
            pad_counts = torch.cat([counts[order], counts.new_zeros(pad)])
            chunk_elig = pad_counts.view(n_chunks, chunk).sum(dim=1).cpu()
            n_run = int(torch.cumprod((chunk_elig > 0).long(), 0).sum())
            for i in range(n_run):
                sl = slice(i * chunk, (i + 1) * chunk)
                process(pad_order[sl], pad_counts[sl] > 0)
        else:
            top_cells = torch.argsort(-counts, stable=True)[:self.max_cells]
            process(top_cells, counts[top_cells] > 0)
        return proba[:N, None], pred_mask[:N], harmonics[:N]

    def supervise(self, proxy: ProxyState, surface: GridState,
                  tables: CellTables, prediction_camera: FoVCamera,
                  eligible_override=None, n_cells_active: Optional[int] = None,
                  generator: Optional[torch.Generator] = None, noise=None):
        """The supervision pass, differentiable in SconeOcc's weights:
        ``max_cells`` cells drawn at random among those with an eligible
        proxy (a uniform noise per cell ranks them; ``noise`` (C,) injects
        it, else it is drawn from ``generator``), the first
        ``n_cells_active`` of them kept (the curriculum). Eligible proxies
        are ``eligible_override`` (N,) if given, else those with supervision
        occupancy inside the field. SconeOcc's calls are recomputed in the
        backward instead of keeping their activations.
        Returns (proba (N, 1), prediction_mask (N,), harmonics (N, H))."""
        N = proxy.points.shape[0]
        C = tables.slots.shape[0]
        dev = proxy.points.device
        elig_per_slot, counts = self._eligible(proxy, tables, True,
                                               eligible_override)
        perm = view_space_permutation(prediction_camera, self.n_elev,
                                      self.n_azim)
        if noise is None:
            noise = torch.rand((C,), generator=generator,
                               device=generator.device)
        rank_score = torch.where(counts > 0, noise.to(dev), -1.0)
        top_cells = torch.argsort(-rank_score, stable=True)[:self.max_cells]
        cell_ok = counts[top_cells] > 0
        if n_cells_active is not None:
            cell_ok = cell_ok & (torch.arange(top_cells.shape[0], device=dev)
                                 < n_cells_active)
        slots, occs, vhs, m = self._cells(
            proxy, surface, tables, prediction_camera, elig_per_slot, perm,
            top_cells, cell_ok)
        idx = torch.where(m, slots, N)
        proba = torch.zeros((N + 1,), device=dev).index_put(
            (idx,), torch.where(m, occs, 0.0))
        harmonics = torch.zeros((N + 1, self.n_harmonics), device=dev)
        harmonics[idx] = vhs
        pred_mask = torch.zeros((N + 1,), dtype=torch.bool, device=dev)
        pred_mask[idx] = m
        return proba[:N, None], pred_mask[:N], harmonics[:N]


def assemble_scene_field(proxy: ProxyState, proba, pred_mask, harmonics):
    """Scene field for NBV scoring: predicted proxies take the new proba,
    out-of-field proxies keep their stored proba with zero harmonics.
    Returns (X_world (N, 3), harmonics (N, H), occ (N, 1), valid (N,))."""
    oof = proxy.out_of_field[:, 0] > 0.0
    occ = torch.where(pred_mask[:, None], proba, proxy.proba)
    harmonics = torch.where(pred_mask[:, None], harmonics, 0.0)
    return proxy.points, harmonics, occ, pred_mask | oof


def distance_factor(pts, X_cam, fov_deg, image_height: int, image_width: int,
                    cell_resolution: float, mode=None,
                    distance_th: Optional[float] = None):
    """Per-point 1/d^2 attenuation beyond a focal threshold.

    pts (..., S, 3); X_cam (..., 3); fov_deg (...) or a float."""
    dists = torch.linalg.norm(pts - X_cam[..., None, :], dim=-1)
    if distance_th is not None and mode is None:
        th = distance_th
        return torch.where(dists > th, th ** 2 / dists ** 2, 1.0)
    fov = torch.as_tensor(fov_deg, dtype=pts.dtype, device=pts.device)
    focal = (1.0 / torch.tan(torch.deg2rad(fov) / 2.0))[..., None]
    pixel = 2.0 / min(image_height, image_width)
    eps = np.sqrt(np.pi) / 2.0 * cell_resolution
    th = focal * eps / pixel
    if mode == "smooth":
        return 1.0 / (1.0 + (dists / th) ** 2)
    return torch.where(dists > th, (eps * focal / pixel / dists) ** 2, 1.0)


def _normalize_sample(prediction_camera, pts_world, smask, box_diag):
    """View-frame points of a sample, centred on the sample's box (per
    leading index). Returns (normalised points, centre in view frame)."""
    big = 1e9
    mx = torch.where(smask[..., None], pts_world, -big).amax(dim=-2)
    mn = torch.where(smask[..., None], pts_world, big).amin(dim=-2)
    center = prediction_camera.world_to_view(((mx + mn) / 2.0)[None])[0]
    ptsv = prediction_camera.world_to_view(pts_world)
    return normalize_points_in_prediction_box(ptsv, center[..., None, :],
                                              box_diag), center


class CoverageGain:
    """All-candidates NBV scorer.

    ``__call__(vis_model, X_world (N, 3), harmonics (N, H), occ (N, 1),
    valid (N,), cand_cameras (C,), cand_X_world (C, 3), prediction_camera,
    box_diag, cell_resolution, sensor_range, generator, sample_idx=None)
    -> gains (C,)``.

    Calling the scorer runs without grad; ``gains`` is the same function
    under the caller's grad mode. Per candidate (default): a fresh
    occupancy-weighted MC sample of seq_len
    proxies inside each candidate's FoV, all candidates through SconeVis and
    the SH integral as one (C, 1, seq_len) batch. ``shared_sample``: one
    sample from the union of candidate FoVs, one SconeVis forward, a
    (1, C, seq_len) SH integral. ``sample_idx`` ((C, seq_len), or
    (seq_len,) shared) injects the MC draws."""

    def __init__(self, n_harmonics: int = 64, seq_len: int = 2048,
                 image_height: int = 256, image_width: int = 456,
                 min_occ: float = 0.1, use_occ_to_sample: bool = True,
                 max_harmonic_rank: int = 8, use_sigmoid: bool = True,
                 dist_factor_mode=None, distance_th: Optional[float] = None,
                 shared_sample: bool = False):
        self.seq_len = seq_len
        self.H, self.W = image_height, image_width
        self.min_occ = min_occ
        self.use_occ_to_sample = use_occ_to_sample
        self.max_harmonic_rank = max_harmonic_rank
        self.use_sigmoid = use_sigmoid
        self.dist_factor_mode = dist_factor_mode
        self.distance_th = distance_th
        self.shared_sample = shared_sample

    def _distance_factor(self, pts_world, cand_X, fov, cell_resolution):
        return distance_factor(pts_world, cand_X, fov, self.H, self.W,
                               cell_resolution, mode=self.dist_factor_mode,
                               distance_th=self.distance_th)

    @torch.no_grad()
    def __call__(self, *args, **kw):
        """The scorer for a decision: ``gains`` without grad."""
        return self.gains(*args, **kw)

    def gains(self, vis_model, X_world, harmonics, occ, valid,
              cand_cameras: FoVCamera, cand_X_world,
              prediction_camera: FoVCamera, box_diag: float,
              cell_resolution: float, sensor_range: float,
              generator: Optional[torch.Generator] = None, sample_idx=None):
        """Gains (C,), differentiable in SconeVis's weights when grad is
        enabled (the SCONE step's coverage loss)."""
        C = cand_X_world.shape[0]
        cams = FoVCamera(cand_cameras.R, cand_cameras.T, cand_cameras.fov,
                         torch.full_like(cand_cameras.zfar, 0.01),
                         cand_cameras.zfar, torch.ones_like(cand_cameras.fov))
        # The scorer's cameras take znear 0.01 and aspect 1, as in the JAX
        # package; only R, T and fov shape the FoV test.
        fov_masks = points_in_fov_mask(
            X_world[None].expand(C, *X_world.shape), cams, self.H, self.W,
            fov_range=sensor_range) & valid[None]
        occ_sel = fov_masks & (occ[None, :, 0] > self.min_occ)  # (C, N)
        fov_volumes = torch.where(occ_sel, occ[None, :, 0], 0.0).sum(dim=-1)
        run = self._shared if self.shared_sample else self._per_candidate
        return run(vis_model, X_world, harmonics, occ, occ_sel, fov_volumes,
                   cand_cameras, cand_X_world, prediction_camera, box_diag,
                   cell_resolution, generator, sample_idx)

    def _per_candidate(self, vis_model, X_world, harmonics, occ, occ_sel,
                       fov_volumes, cand_cameras, cand_X_world,
                       prediction_camera, box_diag, cell_resolution,
                       generator, sample_idx):
        pts4, harm, _, smask = sample_proxy_points(
            generator, X_world, occ, harmonics, self.seq_len, self.min_occ,
            use_occ_to_sample=self.use_occ_to_sample, valid_mask=occ_sel,
            idx=sample_idx)
        pts_world = pts4[..., :3]
        ptsn, center = _normalize_sample(prediction_camera, pts_world, smask,
                                         box_diag)
        pts4n = torch.cat((ptsn, pts4[..., 3:]), dim=-1)  # (C, S, 4)
        X_cam_n = normalize_points_in_prediction_box(
            prediction_camera.world_to_view(cand_X_world[None])[0], center,
            box_diag)
        sh = vis_model(pts4n, harm, pts_mask=smask)
        vis = compute_visibilities(pts4n, sh, X_cam_n[:, None, :],
                                   max_harmonic_rank=self.max_harmonic_rank,
                                   use_sigmoid=self.use_sigmoid)[:, 0]
        df = self._distance_factor(pts_world, cand_X_world, cand_cameras.fov,
                                   cell_resolution)
        vis = vis * df * smask
        denom = torch.clamp(smask.sum(dim=-1), min=1)
        gains = vis.sum(dim=-1) / denom * fov_volumes
        return torch.where(smask.any(dim=-1), gains, 0.0)

    def _shared(self, vis_model, X_world, harmonics, occ, occ_sel,
                fov_volumes, cand_cameras, cand_X_world, prediction_camera,
                box_diag, cell_resolution, generator, sample_idx):
        pts4, harm, idx, smask = sample_proxy_points(
            generator, X_world, occ, harmonics, self.seq_len, self.min_occ,
            use_occ_to_sample=self.use_occ_to_sample,
            valid_mask=occ_sel.any(dim=0), idx=sample_idx)
        pts4, harm, smask = pts4[None], harm[None], smask[None]
        pts_world = pts4[..., :3]
        ptsn, center = _normalize_sample(prediction_camera, pts_world, smask,
                                         box_diag)
        pts4n = torch.cat((ptsn, pts4[..., 3:]), dim=-1)  # (1, S, 4)
        X_cam_n = normalize_points_in_prediction_box(
            prediction_camera.world_to_view(cand_X_world[None])[0], center,
            box_diag)
        sh = vis_model(pts4n, harm, pts_mask=smask)
        vis = compute_visibilities(pts4n, sh, X_cam_n[None],
                                   max_harmonic_rank=self.max_harmonic_rank,
                                   use_sigmoid=self.use_sigmoid)[0]  # (C, S)
        samp_in_fov = occ_sel[:, idx] & smask
        dfs = self._distance_factor(pts_world, cand_X_world,
                                    cand_cameras.fov, cell_resolution)
        w = vis * dfs * samp_in_fov
        denom = torch.clamp(samp_in_fov.sum(dim=-1), min=1)
        gains = w.sum(dim=-1) / denom * fov_volumes
        return torch.where(samp_in_fov.any(dim=-1), gains, 0.0)


def curriculum_sampling_distances(n_poses: int, proxy_distance: float,
                                  cell_size) -> np.ndarray:
    """Arctan ramp of the occupancy-supervision distance over a trajectory:
    from 3x the proxy spacing up to 2x the surface-cell diagonal."""
    min_d = 3.0 * proxy_distance
    max_d = 2.0 * float(np.linalg.norm(np.asarray(cell_size)))
    x = np.arctan(10.0 * (np.linspace(0.0, 1.0, n_poses) - 0.5))
    x -= x.min()
    x /= x.max()
    return (min_d + x * (max_d - min_d)).astype(np.float32)


def curriculum_sampling_cell_number(n_poses: int, min_cells: int = 5,
                                    max_cells: int = 20) -> np.ndarray:
    """Linear ramp of the number of supervised cells over a trajectory."""
    n = min_cells + np.linspace(0.0, 1.0, n_poses) * (max_cells - min_cells)
    return np.floor(n).astype(np.int32)
