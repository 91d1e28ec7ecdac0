"""Camera agent on a 5-D pose lattice: neighbours, validity, interpolated
moves, capture (port of the host Camera of macarons_tpu/scene/camera.py).

Pose math that is only bookkeeping stays in host numpy; validity tests and
capture run on the camera's device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..ops.geometry import FoVCamera, get_cartesian_coords, \
    look_at_view_transform
from ..ops.projection import points_in_fov_mask
from ..ops.rasterizer import PointLights, render_mesh


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
        poses = self.pose_space.pose_from_idx(idx)
        cams = self._fov_cameras(poses[:, :3], poses[:, 3:])
        B = idx.shape[0]
        ok = points_in_fov_mask(verts[None].expand(B, *verts.shape), cams,
                                self.image_height, self.image_width,
                                fov_range=5 * self.zfar).any(dim=-1)
        if proxy_points is not None:
            ok = ok & points_in_fov_mask(
                proxy_points[None].expand(B, *proxy_points.shape), cams,
                self.image_height, self.image_width,
                fov_range=5 * self.zfar).any(dim=-1)
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
