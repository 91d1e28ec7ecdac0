"""Camera agent on a 5-D pose lattice: neighbours, validity, interpolated
moves, capture (port of macarons_tpu/scene/camera.py).

The host ``Camera`` keeps its bookkeeping in numpy; validity tests and
capture run on the camera's device. The episode functions
(``DeviceEpisode`` and ``episode_*``) keep a trajectory's state on the card
instead, for the trainer's device memory: the pose, the visited set and the
histories are tensors, and a move is chosen, interpolated and committed
without a transfer to the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops.geometry import FoVCamera, get_cartesian_coords, \
    look_at_view_transform
from ..ops.projection import points_in_fov_mask
from ..ops.rasterizer import PointLights, render_mesh
from .depth_runtime import FrameRing, _clamped_start, ring_push


def get_camera_RT(X_cam, V_cam):
    """(R, T) from centres X_cam (n, 3) and (elev, azim) degrees V_cam (n, 2)."""
    X_cam = X_cam.reshape(-1, 3)
    V_cam = V_cam.reshape(-1, 2)
    rays = -get_cartesian_coords(torch.ones_like(V_cam[:, 0:1]),
                                 -1.0 * V_cam[:, 0:1], 180.0 + V_cam[:, 1:2],
                                 in_degrees=True).reshape(-1, 3)
    return look_at_view_transform(X_cam, X_cam + rays)


def capture(verts, faces, vert_colors, R, T, height: int, width: int,
            zfar: float, contrast_factor: float, ambient: float,
            texture_atlas=None):
    """Render a camera batch under ambient light: (images (N, H, W, 3),
    depth (N, H, W, 1) view z with -1 = empty, mask (N, H, W, 1)). The
    albedo is the texture atlas if given, else the vertex colours."""
    cam = FoVCamera.create(R, T, zfar=zfar)
    lights = PointLights.create(torch.zeros((1, 3), device=verts.device),
                                ambient=ambient, diffuse=0.0, specular=0.0)
    images, frags = render_mesh(verts, faces, cam, (height, width), lights,
                                vert_colors=vert_colors,
                                texture_atlas=texture_atlas, background=1.0,
                                perspective_correct=True)
    if contrast_factor != 1.0:
        mean = images.mean(dim=(1, 2, 3), keepdim=True)
        images = torch.clamp(mean + contrast_factor * (images - mean), 0, 1)
    depth = frags.zbuf[..., None]
    return images, depth, depth > -1


def build_pose_shifts() -> np.ndarray:
    """Moves of exactly one translation unit and at most one rotation unit.
    Shape (30, 5)."""
    grid = np.stack(np.meshgrid(*([np.arange(-1, 2)] * 5), indexing="ij"),
                    axis=-1).reshape(-1, 5)
    t_ok = np.abs(grid[:, :3]).sum(axis=1) == 1
    r_ok = np.abs(grid[:, 3:]).sum(axis=1) <= 1
    return grid[t_ok & r_ok].astype(np.int32)


POSE_SHIFTS = build_pose_shifts()


@dataclass
class PoseSpace:
    """5-D camera pose lattice (x, y, z, elev, azim)."""

    x_min: np.ndarray
    x_max: np.ndarray
    pose_l: int
    pose_w: int
    pose_h: int
    pose_n_elev: int
    pose_n_azim: int

    def __post_init__(self):
        self.x_min = np.asarray(self.x_min, np.float32)
        self.x_max = np.asarray(self.x_max, np.float32)
        self.steps = (self.x_max - self.x_min) / np.array(
            [self.pose_l, self.pose_w, self.pose_h], np.float32)
        self.dims = np.array([self.pose_l, self.pose_w, self.pose_h,
                              self.pose_n_elev, self.pose_n_azim], np.int64)
        self.n_poses = int(np.prod(self.dims))

    def pose_from_idx(self, idx) -> np.ndarray:
        """[x, y, z, elev_deg, azim_deg] (float32) for idx (..., 5)."""
        idx = np.asarray(idx, np.float32)
        pos = self.x_min + (idx[..., :3] + 0.5) * self.steps
        elev = -90.0 + 180.0 * (1 + idx[..., 3]) / (self.pose_n_elev + 1)
        azim = 360.0 * idx[..., 4] / self.pose_n_azim
        return np.concatenate((pos, elev[..., None], azim[..., None]),
                              axis=-1).astype(np.float32)

    def flat_index(self, idx):
        idx = np.asarray(idx)
        f = 0
        for k in range(5):
            f = f * self.dims[k] + idx[..., k]
        return f

    def neighbors(self, idx) -> np.ndarray:
        """Neighbour indices, clamped/wrapped, translating, deduplicated."""
        idx = np.asarray(idx)
        res = idx[None, :] + POSE_SHIFTS
        res[:, 0] = np.clip(res[:, 0], 0, self.pose_l - 1)
        res[:, 1] = np.clip(res[:, 1], 0, self.pose_w - 1)
        res[:, 2] = np.clip(res[:, 2], 0, self.pose_h - 1)
        res[:, 3] = np.clip(res[:, 3], 0, self.pose_n_elev - 1)
        res[:, 4] = res[:, 4] % self.pose_n_azim
        res = res[np.abs(res[:, :3] - idx[None, :3]).sum(axis=1) > 0]
        return np.unique(res, axis=0)


@dataclass
class Camera:
    """Camera agent over a PoseSpace: trajectory, pose history, capture."""

    pose_space: PoseSpace
    zfar: float
    image_height: int
    image_width: int
    device: torch.device
    n_interpolation_steps: int = 1
    contrast_factor: float = 1.0
    gathering_factor: float = 0.05
    occupied_poses: Optional[np.ndarray] = None  # (L, W, H) bool

    def __post_init__(self):
        self.cam_idx: Optional[np.ndarray] = None
        self.X_cam = None
        self.V_cam = None
        self.fov_camera: Optional[FoVCamera] = None
        self.fov_camera_0: Optional[FoVCamera] = None
        self.cam_idx_history = []
        self.X_cam_history = []
        self.V_cam_history = []
        self.pose_history = np.zeros(self.pose_space.n_poses, bool)
        self.n_frames_captured = 0

    def _fov_cameras(self, X, V) -> FoVCamera:
        X = torch.as_tensor(np.asarray(X, np.float32), device=self.device)
        V = torch.as_tensor(np.asarray(V, np.float32), device=self.device)
        R, T = get_camera_RT(X, V)
        return FoVCamera.create(R, T, zfar=self.zfar)

    def initialize(self, start_cam_idx):
        self.update_camera(np.asarray(start_cam_idx))
        self.fov_camera_0 = self.fov_camera

    def update_camera(self, new_cam_idx, interpolation_step: Optional[int] = None):
        """Move to ``new_cam_idx`` (interpolated, with the azimuth wrap)."""
        ps = self.pose_space
        n_steps = self.n_interpolation_steps
        if interpolation_step is None:
            interpolation_step = n_steps
        final = interpolation_step == n_steps
        new_cam_idx = np.asarray(new_cam_idx)
        old_idx = new_cam_idx if self.cam_idx is None else self.cam_idx
        old_pose = ps.pose_from_idx(old_idx)
        new_pose = ps.pose_from_idx(new_cam_idx)
        offset_azim = 0.0
        if not final:
            if old_idx[4] == 0 and new_cam_idx[4] == ps.pose_n_azim - 1:
                offset_azim = -360.0
            elif old_idx[4] == ps.pose_n_azim - 1 and new_cam_idx[4] == 0:
                offset_azim = 360.0
        a = interpolation_step / n_steps
        X = old_pose[:3] + (new_pose[:3] - old_pose[:3]) * a
        V = (old_pose[3:] + (new_pose[3:] - old_pose[3:]) * a).copy()
        V[1] += offset_azim * a
        if final:
            self.cam_idx = new_cam_idx
            self.cam_idx_history.append(new_cam_idx)
            self.pose_history[ps.flat_index(new_cam_idx)] = True
        self.X_cam = np.asarray(X, np.float32).reshape(1, 3)
        self.V_cam = np.asarray(V, np.float32).reshape(1, 2)
        self.X_cam_history.append(self.X_cam)
        self.V_cam_history.append(self.V_cam)
        self.fov_camera = self._fov_cameras(self.X_cam, self.V_cam)

    def get_neighboring_poses(self, pose_idx=None):
        return self.pose_space.neighbors(self.cam_idx if pose_idx is None
                                         else pose_idx)

    def _batch_validity(self, pose_indices, verts, proxy_points=None):
        """Unoccupied poses whose FoV holds a mesh vertex (and a proxy point,
        if given), within 5 * zfar."""
        idx = np.asarray(pose_indices).reshape(-1, 5)
        poses = torch.as_tensor(self.pose_space.pose_from_idx(idx),
                                device=self.device)
        ok = fov_holds_points(poses, verts, self.image_height,
                              self.image_width, self.zfar)
        if proxy_points is not None:
            ok = ok & fov_holds_points(poses, proxy_points, self.image_height,
                                       self.image_width, self.zfar)
        ok = ok.cpu().numpy()
        if self.occupied_poses is not None:
            ok = ok & ~self.occupied_poses[idx[:, 0], idx[:, 1], idx[:, 2]]
        return ok

    def get_valid_neighbors(self, neighbor_indices, verts):
        """Valid unvisited neighbours; else the visited ones."""
        idx = np.asarray(neighbor_indices).reshape(-1, 5)
        visited = self.pose_history[self.pose_space.flat_index(idx)]
        unvisited = idx[~visited]
        new_valid = (unvisited[self._batch_validity(unvisited, verts)]
                     if len(unvisited) else unvisited)
        chosen = new_valid if len(new_valid) else idx[visited]
        return np.array(chosen).reshape(-1, 5)

    def get_random_valid_pose(self, rs: np.random.Generator, verts,
                              proxy_points=None, max_tries: int = 1000,
                              batch: int = 64):
        """Rejection-sample a valid start pose, ``batch`` candidates a test."""
        for _ in range(max(1, max_tries // batch)):
            idx = np.stack([rs.integers(0, d, size=batch)
                            for d in self.pose_space.dims], axis=-1)
            hits = np.flatnonzero(self._batch_validity(
                idx, verts, proxy_points=proxy_points))
            if hits.size:
                return idx[hits[0]]
        raise RuntimeError("no valid pose found")

    def capture_image(self, verts, faces, vert_colors=None, fov_camera=None,
                      ambient_light_intensity: float = 1.0,
                      texture_atlas=None):
        """Render RGB + zbuf from the current (or given) camera batch."""
        cam = fov_camera if fov_camera is not None else self.fov_camera
        images, depth, mask = capture(
            verts, faces, vert_colors, cam.R, cam.T, self.image_height,
            self.image_width, self.zfar, float(self.contrast_factor),
            float(ambient_light_intensity), texture_atlas=texture_atlas)
        self.n_frames_captured += int(cam.R.shape[0])
        return images, depth, mask


def capture_ring(camera: Camera, verts, faces, X, V, ring: FrameRing,
                 vert_colors=None, texture_atlas=None, ambient: float = 1.0):
    """Capture the poses (X (K, 3), V (K, 2), tensors) with ``camera``'s
    image size, zfar and contrast, and push the frames onto ``ring``.
    Returns (images, depth, mask, R, T, ring)."""
    R, T = get_camera_RT(X, V)
    images, depth, mask = capture(
        verts, faces, vert_colors, R, T, camera.image_height,
        camera.image_width, camera.zfar, float(camera.contrast_factor),
        float(ambient), texture_atlas=texture_atlas)
    ring = ring_push(ring, images, depth, mask, R, T, camera.zfar)
    return images, depth, mask, R, T, ring


# ---------------------------------------------------------------------------
# Episode state on the card (the trainer's device-memory path)
# ---------------------------------------------------------------------------


class PoseSpaceTables(NamedTuple):
    """A pose lattice's tables on the card."""

    x_min: torch.Tensor  # (3,)
    steps: torch.Tensor  # (3,)
    shifts: torch.Tensor  # (30, 5) int64, the neighbour moves
    occupied: torch.Tensor  # (L * W * H,) bool, flat


def pose_space_tables(ps: PoseSpace, occupied: Optional[np.ndarray] = None,
                      device=None) -> PoseSpaceTables:
    occ = (np.zeros((ps.pose_l, ps.pose_w, ps.pose_h), bool)
           if occupied is None else np.asarray(occupied, bool))
    return PoseSpaceTables(
        x_min=torch.as_tensor(ps.x_min, dtype=torch.float32, device=device),
        steps=torch.as_tensor(ps.steps, dtype=torch.float32, device=device),
        shifts=torch.as_tensor(POSE_SHIFTS, dtype=torch.int64, device=device),
        occupied=torch.as_tensor(occ.reshape(-1), device=device))


class DeviceEpisode(NamedTuple):
    """A trajectory's state: the current pose, the visited set, the
    histories (capacity-sized, filled up to the host counts)."""

    cam_idx: torch.Tensor  # (5,) int64
    visited: torch.Tensor  # (n_poses,) bool, by flat index
    X: torch.Tensor  # (1, 3)
    V: torch.Tensor  # (1, 2) elev, azim in degrees
    R: torch.Tensor  # (1, 3, 3)
    T: torch.Tensor  # (1, 3)
    idx_history: torch.Tensor  # (max_moves, 5) int64
    X_history: torch.Tensor  # (max_frames, 3), every captured pose
    V_history: torch.Tensor  # (max_frames, 2)
    n_moves: int
    n_frames: int


def episode_pose_from_idx(idx, tables: PoseSpaceTables, n_elev: int,
                          n_azim: int):
    """(..., 5) lattice indices -> (..., 5) poses [x, y, z, elev, azim]."""
    pos = tables.x_min + (idx[..., :3].float() + 0.5) * tables.steps
    elev = -90.0 + 180.0 * (1 + idx[..., 3].float()) / (n_elev + 1)
    azim = 360.0 * idx[..., 4].float() / n_azim
    return torch.cat((pos, elev[..., None], azim[..., None]), dim=-1)


def episode_flat_index(idx, dims: Tuple[int, ...]):
    f = torch.zeros_like(idx[..., 0])
    for k in range(5):
        f = f * int(dims[k]) + idx[..., k]
    return f


def _occupied_at(tables: PoseSpaceTables, idx, dims):
    L, W, H = (int(d) for d in dims[:3])
    cell = (idx[..., 0] * W + idx[..., 1]) * H + idx[..., 2]
    return tables.occupied[cell]


def episode_neighbors(ep: DeviceEpisode, tables: PoseSpaceTables,
                      dims: Tuple[int, ...]):
    """Every neighbour move of the current pose, clamped to the lattice
    (the azimuth wraps). Returns (idx (30, 5), new_ok (30,), visited_ok
    (30,)): a move is ok if it translates and is the first occurrence of its
    pose after clamping; new_ok also asks it unvisited and unoccupied,
    visited_ok visited."""
    L, W, H, NE, NA = (int(d) for d in dims)
    res = ep.cam_idx[None, :] + tables.shifts
    res = torch.stack((res[:, 0].clamp(0, L - 1), res[:, 1].clamp(0, W - 1),
                       res[:, 2].clamp(0, H - 1), res[:, 3].clamp(0, NE - 1),
                       res[:, 4] % NA), dim=-1)
    translating = (res[:, :3] - ep.cam_idx[None, :3]).abs().sum(dim=1) > 0
    same = (res[:, None, :] == res[None, :, :]).all(dim=-1)
    first = (torch.argmax(same.to(torch.uint8), dim=1)
             == torch.arange(res.shape[0], device=res.device))
    ok = translating & first
    visited = ep.visited[episode_flat_index(res, dims)]
    new_ok = ok & ~visited & ~_occupied_at(tables, res, dims)
    return res, new_ok, ok & visited


def episode_interpolations(ep: DeviceEpisode, new_idx,
                           tables: PoseSpaceTables, n_elev: int, n_azim: int,
                           n_steps: int):
    """The n_steps interpolated poses of a move to new_idx (X (K, 3), V
    (K, 2)): across the azimuth's wrap the intermediate steps turn the
    short way, the last lands on the lattice value."""
    old = episode_pose_from_idx(ep.cam_idx, tables, n_elev, n_azim)
    new = episode_pose_from_idx(new_idx, tables, n_elev, n_azim)
    o4, n4 = ep.cam_idx[4], new_idx[4]
    zero = torch.zeros((), device=old.device)
    offset = torch.where((o4 == 0) & (n4 == n_azim - 1), zero - 360.0,
                         torch.where((o4 == n_azim - 1) & (n4 == 0),
                                     zero + 360.0, zero))
    steps = torch.arange(1, n_steps + 1, device=old.device)
    a = (steps.float() / n_steps)[:, None]
    X = old[None, :3] + (new[None, :3] - old[None, :3]) * a
    V = old[None, 3:] + (new[None, 3:] - old[None, 3:]) * a
    wrap = torch.where(steps[:, None] == n_steps, zero, offset * a)
    return X, torch.cat((V[:, :1], V[:, 1:] + wrap), dim=1)


def _write_rows(x, at: int, rows):
    """x with rows [at, at + len(rows)) replaced (a copy); the start is
    moved inside x as JAX's dynamic_update_slice moves it."""
    at = _clamped_start(at, rows.shape[0], x.shape[0])
    x = x.clone()
    x[at:at + rows.shape[0]] = rows
    return x


def episode_commit(ep: DeviceEpisode, new_idx, X, V, R, T,
                   dims: Tuple[int, ...]) -> DeviceEpisode:
    """The episode after a move of K frames to new_idx: the new pose, its
    visited flag, the histories."""
    flat = episode_flat_index(new_idx, dims).reshape(1)
    return ep._replace(
        cam_idx=new_idx, visited=ep.visited.index_fill(0, flat, True),
        X=X[-1:], V=V[-1:], R=R[-1:], T=T[-1:],
        idx_history=_write_rows(ep.idx_history, ep.n_moves, new_idx[None]),
        X_history=_write_rows(ep.X_history, ep.n_frames, X),
        V_history=_write_rows(ep.V_history, ep.n_frames, V),
        n_moves=ep.n_moves + 1, n_frames=ep.n_frames + X.shape[0])


def init_device_episode(start_idx, tables: PoseSpaceTables, dims,
                        n_elev: int, n_azim: int, max_moves: int,
                        max_frames: int) -> DeviceEpisode:
    """The episode at a start pose ((5,) int tensor): visited, one history
    entry."""
    start_idx = start_idx.to(torch.int64)
    dev = start_idx.device
    pose = episode_pose_from_idx(start_idx, tables, n_elev, n_azim)
    X, V = pose[None, :3], pose[None, 3:]
    R, T = get_camera_RT(X, V)
    n_flat = int(np.prod([int(d) for d in dims]))
    flat = episode_flat_index(start_idx, dims).reshape(1)
    return DeviceEpisode(
        cam_idx=start_idx,
        visited=torch.zeros((n_flat,), dtype=torch.bool,
                            device=dev).index_fill(0, flat, True),
        X=X, V=V, R=R, T=T,
        idx_history=_write_rows(torch.zeros((max_moves, 5), dtype=torch.int64,
                                            device=dev), 0, start_idx[None]),
        X_history=_write_rows(torch.zeros((max_frames, 3), device=dev), 0, X),
        V_history=_write_rows(torch.zeros((max_frames, 2), device=dev), 0, V),
        n_moves=1, n_frames=1)


def fov_holds_points(poses, points, H: int, W: int, zfar: float,
                     chunk: int = 128):
    """Per pose (B, 5): whether any of points (N, 3) lies in its field of
    view within 5 zfar; cameras ``chunk`` at a time."""
    out = []
    for s in range(0, poses.shape[0], chunk):
        p = poses[s:s + chunk]
        R, T = get_camera_RT(p[:, :3], p[:, 3:])
        cams = FoVCamera.create(R, T, zfar=zfar)
        out.append(points_in_fov_mask(points[None].expand(p.shape[0],
                                                          *points.shape),
                                      cams, H, W,
                                      fov_range=5 * zfar).any(dim=-1))
    return torch.cat(out)


def episode_random_start(gen: torch.Generator, tables: PoseSpaceTables,
                         dims, n_elev: int, n_azim: int, verts, proxy_points,
                         H: int, W: int, zfar: float, batch: int = 1024,
                         max_attempts: int = 8, index_batches=None):
    """A random start pose: batches of ``batch`` lattice indices drawn from
    ``gen`` (or the given ``index_batches``), up to ``max_attempts``; the
    first unoccupied pose whose field of view holds a mesh vertex and a
    proxy point, in the first batch that has one. Failing that, the first
    unoccupied pose of the first batch that has one, else the first pose
    drawn. One transfer to the host per batch drawn (in a scene with a
    valid pose in the first batch, one per start).
    Returns ((5,) int64 index, whether it is valid)."""
    dev = tables.x_min.device
    sel, fallback = None, False
    for i in range(max_attempts):
        if index_batches is not None:
            if i == len(index_batches):
                break
            idx = torch.as_tensor(index_batches[i], dtype=torch.int64,
                                  device=dev)
        else:
            idx = torch.stack([torch.randint(0, int(d), (batch,),
                                             generator=gen, device=dev)
                               for d in dims], dim=-1)
        poses = episode_pose_from_idx(idx, tables, n_elev, n_azim)
        unocc = ~_occupied_at(tables, idx, dims)
        ok = unocc & fov_holds_points(poses, verts, H, W, zfar)
        if proxy_points is not None:
            ok = ok & fov_holds_points(poses, proxy_points, H, W, zfar)
        hit, hit_unocc = torch.stack((ok.any(), unocc.any())).tolist()
        if hit:
            return idx[torch.argmax(ok.to(torch.uint8))], True
        if hit_unocc and not fallback:
            sel, fallback = idx[torch.argmax(unocc.to(torch.uint8))], True
        if sel is None:
            sel = idx[0]
    return sel, False
