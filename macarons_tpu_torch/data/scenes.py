"""Scene dataset and settings, and the scene-data generator (port of
macarons_tpu/data/scenes.py).

Per-scene directory: ``<scene>/<name>.obj`` + ``settings.json`` (box, grid
dims, camera pose lattice, start poses, contrast) + optionally
``occupied_pose.npz``. ``compute_scene_settings`` sizes the settings from
the mesh's box; ``compute_occupied_poses`` marks the lattice positions
inside geometry by rendering each twice, plainly and with backface
culling, on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..ops.geometry import FoVCamera
from ..ops.projection import points_in_fov_mask
from ..ops.rasterizer import PointLights, front_face_mask, render_mesh
from ..scene.camera import get_camera_RT
from ..utils.device import resolve_device
from .mesh_io import Mesh


@dataclass
class SceneSettings:
    """Parsed settings.json."""

    scene_x_min: np.ndarray
    scene_x_max: np.ndarray
    grid_l: int
    grid_w: int
    grid_h: int
    pose_x_min: np.ndarray
    pose_x_max: np.ndarray
    pose_l: int
    pose_w: int
    pose_h: int
    pose_n_elev: int
    pose_n_azim: int
    start_positions: List
    contrast_factor: float = 1.0

    @classmethod
    def from_json(cls, path: str) -> "SceneSettings":
        with open(path) as f:
            d = json.load(f)
        scene, camera = d["scene"], d["camera"]
        return cls(
            scene_x_min=np.asarray(scene["x_min"], np.float32),
            scene_x_max=np.asarray(scene["x_max"], np.float32),
            grid_l=scene["grid_l"], grid_w=scene["grid_w"],
            grid_h=scene["grid_h"],
            pose_x_min=np.asarray(camera["x_min"], np.float32),
            pose_x_max=np.asarray(camera["x_max"], np.float32),
            pose_l=camera["pose_l"], pose_w=camera["pose_w"],
            pose_h=camera["pose_h"], pose_n_elev=camera["pose_n_elev"],
            pose_n_azim=camera["pose_n_azim"],
            start_positions=camera.get("start_positions", []),
            contrast_factor=d.get("contrast_factor", 1.0),
        )


class SceneDataset:
    """Scene directories under ``data_path`` that hold a settings.json."""

    def __init__(self, data_path: str, scene_names: Optional[List[str]] = None):
        self.data_path = data_path
        if scene_names is None:
            scene_names = sorted(
                d for d in os.listdir(data_path)
                if os.path.isdir(os.path.join(data_path, d))
                and os.path.exists(os.path.join(data_path, d, "settings.json")))
        self.scene_names = scene_names

    def __len__(self):
        return len(self.scene_names)

    def __getitem__(self, i):
        name = self.scene_names[i]
        d = os.path.join(self.data_path, name)
        objs = [f for f in os.listdir(d) if f.endswith(".obj")]
        npz = os.path.join(d, "occupied_pose.npz")
        return {
            "scene_name": name,
            "obj_path": os.path.join(d, objs[0]) if objs else None,
            "settings": SceneSettings.from_json(os.path.join(d, "settings.json")),
            "occupied_pose": dict(np.load(npz)) if os.path.exists(npz) else None,
        }


def occupied_pose_grid(occupied_pose: dict, pose_l: int, pose_w: int,
                       pose_h: int) -> np.ndarray:
    """(L, W, H) bool grid from {'X_idx': (N, 3), 'occupied': (N,)}."""
    grid = np.zeros((pose_l, pose_w, pose_h), bool)
    X_idx = np.asarray(occupied_pose["X_idx"]).astype(int)
    occ = np.asarray(occupied_pose["occupied"]).astype(bool).reshape(-1)
    for (x, y, z), o in zip(X_idx, occ):
        if 0 <= x < pose_l and 0 <= y < pose_w and 0 <= z < pose_h:
            grid[x, y, z] = o
    return grid


def compute_scene_settings(verts: np.ndarray, cell_size: float = 1.0,
                           pose_step: float = 1.0, n_elev: int = 5,
                           n_azim: int = 8) -> dict:
    """settings.json for a mesh: its box widened by 1 % (of each bound),
    grid dims of ``cell_size`` cells (at least 1) and pose-lattice dims of
    ``pose_step`` steps (at least 2) over it, no start positions."""
    mn = verts.min(0) * 1.01
    mx = verts.max(0) * 1.01
    extent = mx - mn
    grid_dims = np.maximum(np.ceil(extent / cell_size).astype(int), 1)
    pose_dims = np.maximum(np.ceil(extent / pose_step).astype(int), 2)
    return {
        "scene": {"x_min": mn.tolist(), "x_max": mx.tolist(),
                  "grid_l": int(grid_dims[0]), "grid_w": int(grid_dims[1]),
                  "grid_h": int(grid_dims[2])},
        "camera": {"x_min": mn.tolist(), "x_max": mx.tolist(),
                   "pose_l": int(pose_dims[0]), "pose_w": int(pose_dims[1]),
                   "pose_h": int(pose_dims[2]), "pose_n_elev": n_elev,
                   "pose_n_azim": n_azim, "start_positions": []},
        "contrast_factor": 1.0,
    }


def pose_camera(pose, zfar: float = 100.0, device=None) -> FoVCamera:
    """The FoV camera at a lattice pose [x, y, z, elev_deg, azim_deg]."""
    p = torch.as_tensor(np.asarray(pose, np.float32), device=device)
    return FoVCamera.create(*get_camera_RT(p[:3], p[3:]), zfar=zfar)


def compute_occupied_poses(mesh: Mesh, pose_space, image_size=(64, 64),
                           threshold: float = 1e-3, zfar: float = 100.0,
                           rs: Optional[np.random.Generator] = None,
                           device="cuda") -> dict:
    """Mark the lattice positions inside geometry, on ``device`` ("cuda"
    unless the caller asks for the CPU).

    Each position (i, j, k) looks along the lattice's first direction; if
    no vertex lies in its view, the direction is drawn again from ``rs``
    (at most 32 times). The view is rendered with ambient light over a
    black background twice, plainly and with backface culling
    (``front_face_mask``): a camera inside a closed mesh sees only back
    faces, so culling changes its image everywhere, and the position is
    occupied when the mean absolute difference exceeds ``threshold``.
    Returns {"X_idx": (N, 3) int64, "occupied": (N,) bool} in (i, j, k)
    order, and each position's pose "poses" (N, 5) float32 and difference
    "diff" (N,)."""
    dev = resolve_device(device)
    rs = rs or np.random.default_rng(0)
    verts = torch.as_tensor(mesh.verts, dtype=torch.float32, device=dev)
    faces = torch.as_tensor(np.asarray(mesh.faces, np.int64), device=dev)
    colors = (None if mesh.vert_colors is None else torch.as_tensor(
        mesh.vert_colors, dtype=torch.float32, device=dev))
    lights = PointLights.create(torch.zeros((1, 3), device=dev), ambient=1.0,
                                diffuse=0.0, specular=0.0)
    H, W = image_size
    dims = pose_space.dims
    X_idx, occupied, poses, diffs = [], [], [], []
    for i in range(dims[0]):
        for j in range(dims[1]):
            for k in range(dims[2]):
                pose = pose_space.pose_from_idx(np.array([i, j, k, 0, 0]))
                cam = pose_camera(pose, zfar, dev)
                for _ in range(32):
                    if bool(points_in_fov_mask(verts[None], cam, H, W,
                                               fov_range=5 * zfar).any()):
                        break
                    pose[3] = -90.0 + 180.0 * (
                        1 + rs.integers(0, dims[3])) / (dims[3] + 1)
                    pose[4] = 360.0 * rs.integers(0, dims[4]) / dims[4]
                    cam = pose_camera(pose, zfar, dev)
                normal, _ = render_mesh(verts, faces, cam, image_size, lights,
                                        vert_colors=colors, background=0.0)
                culled, _ = render_mesh(
                    verts, faces, cam, image_size, lights, vert_colors=colors,
                    background=0.0,
                    face_mask=front_face_mask(verts, faces, cam))
                diff = float(torch.mean(torch.abs(normal - culled)))
                X_idx.append([i, j, k])
                occupied.append(diff > threshold)
                poses.append(pose)
                diffs.append(diff)
    return {"X_idx": np.asarray(X_idx, np.int64),
            "occupied": np.asarray(occupied, bool),
            "poses": np.stack(poses), "diff": np.asarray(diffs)}
