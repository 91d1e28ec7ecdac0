"""Scene setup, inference runtime and per-pose mapping (port of the tester
subset of macarons_tpu/trainers/train_macarons.py; the online trainer is not
ported yet).

A pose step captures frames, reads depth (ManyDepth, or perfect depth),
backprojects it into the surface grid and carves the proxy field; the
decision phase runs the occupancy field and the NBV scorer from
scene.runtime.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch

from ..config import Params
from ..data.mesh_io import Mesh, load_obj
from ..data.scenes import SceneSettings, occupied_pose_grid
from ..models.macarons import MacaronsModel
from ..ops.geometry import FoVCamera
from ..ops.projection import (
    points_in_fov_mask,
    project_depth_back_to_3D,
    signed_distance_to_depth_maps,
)
from ..ops.sampling import random_subsample_mask, sample_points_on_mesh_surface
from ..scene import grid as G
from ..scene import proxy as P
from ..scene import runtime as R
from ..scene.camera import Camera, PoseSpace
from ..scene.depth_runtime import (
    DepthBatchConfig,
    many_depth_inference,
    perfect_depth_inference,
)
from ..scene.memory import Memory


@dataclass
class SceneState:
    name: str
    mesh: Mesh
    settings: SceneSettings
    cfg: G.GridConfig
    gt_scene: G.GridState
    surface_scene: G.GridState
    proxy: P.ProxyState
    cell_table: R.CellIndexTable
    camera: Camera
    proxy_distance: float
    device: torch.device
    coverages: List[float] = field(default_factory=list)

    def __post_init__(self):
        dev = self.device
        self.verts_dev = torch.as_tensor(self.mesh.verts, device=dev)
        self.faces_dev = torch.as_tensor(self.mesh.faces, dtype=torch.int64,
                                         device=dev)
        self.colors_dev = (torch.as_tensor(self.mesh.vert_colors, device=dev)
                           if self.mesh.vert_colors is not None else None)
        self.atlas_dev = (torch.as_tensor(self.mesh.texture_atlas, device=dev)
                          if self.mesh.texture_atlas is not None else None)


def depth_cfg_from_params(params: Params) -> DepthBatchConfig:
    return DepthBatchConfig(
        n_alpha=params.get("n_alpha", 2),
        n_alpha_for_supervision=params.get("n_alpha_for_supervision", 2),
        alphas=tuple(params.get("alphas", [-2, -1])),
        use_future_frame_for_supervision=params.get(
            "use_future_frame_for_supervision", False),
        znear=params.get("znear", 0.5), zfar=params.get("zfar", 750.0),
        pose_factor=params.get("pose_factor", 100.0),
        use_depth_mask=params.get("use_depth_mask", True),
    )


def setup_scene(params: Params, scene_item: Dict, gen: torch.Generator,
                device) -> SceneState:
    """Load the mesh (with its baked texture atlas, if the OBJ has one) and
    settings; build the GT and surface grids, the proxy
    field (numpy-seeded by the scene name, as in the JAX package) and the
    camera."""
    mesh = load_obj(scene_item["obj_path"],
                    create_texture_atlas=params.get("load_obj_textures", True),
                    texture_atlas_size=params.get("texture_atlas_size", 4))
    mesh = Mesh(mesh.verts * params.get("scene_scale_factor", 1.0),
                mesh.faces, mesh.vert_colors, mesh.texture_atlas)
    s = scene_item["settings"]
    x_min = np.asarray(s.scene_x_min, np.float32)
    x_max = np.asarray(s.scene_x_max, np.float32)
    cfg = G.make_grid_config(
        tuple(x_min), tuple(x_max), s.grid_l, s.grid_w, s.grid_h,
        resolution=params.get("surface_cell_resolution",
                              params.get("test_resolution", 0.05)
                              * params.get("scene_scale_factor", 1.0)),
        capacity=params.get("surface_cell_capacity"), feature_dim=1)

    gt_pts = sample_points_on_mesh_surface(
        gen, torch.as_tensor(mesh.verts, device=device),
        torch.as_tensor(mesh.faces, dtype=torch.int64, device=device),
        params.get("n_gt_surface_points", 16384))
    gt_scene = G.fill_cells_progressive(cfg, G.empty_grid(cfg, device), gen,
                                        gt_pts)
    n_proxy = params.get("n_proxy_points", 100000)
    prox, pts_np = P.initialize_proxy_points_np(
        zlib.crc32(scene_item["scene_name"].encode("utf-8")) % (2**31),
        x_min, x_max, n_proxy, device=device)
    occupied = None
    if scene_item.get("occupied_pose") is not None:
        occupied = occupied_pose_grid(scene_item["occupied_pose"], s.pose_l,
                                      s.pose_w, s.pose_h)
    camera = Camera(
        pose_space=PoseSpace(s.pose_x_min, s.pose_x_max, s.pose_l, s.pose_w,
                             s.pose_h, s.pose_n_elev, s.pose_n_azim),
        zfar=params.get("zfar", 750.0),
        image_height=params.get("image_height", 256),
        image_width=params.get("image_width", 456), device=device,
        n_interpolation_steps=params.get("n_interpolation_steps", 4),
        contrast_factor=s.contrast_factor,
        gathering_factor=params.get("gathering_factor", 0.05),
        occupied_poses=occupied)
    return SceneState(
        name=scene_item["scene_name"], mesh=mesh, settings=s, cfg=cfg,
        gt_scene=gt_scene, surface_scene=G.empty_grid(cfg, device),
        proxy=prox, cell_table=R.build_cell_index_table(cfg, pts_np),
        camera=camera,
        proxy_distance=P.distance_between_proxy_points(x_min, x_max, n_proxy),
        device=torch.device(device))


class MacaronsRuntime:
    """Inference pieces shared across scenes: depth, occupancy field, NBV
    scorer, with the config's widths."""

    def __init__(self, params: Params, model: MacaronsModel,
                 cfg: G.GridConfig, table: R.CellIndexTable, device):
        self.params = params
        self.model = model
        self.device = torch.device(device)
        self.dcfg = depth_cfg_from_params(params)
        self.H = params.get("image_height", 256)
        self.W = params.get("image_width", 456)
        self.sensor_range = params.get("sensor_range",
                                       1.2 * params.get("zfar", 750.0))
        self.seq_len = params.get("seq_len", 2048)
        self.n_interpolation_steps = params.get("n_interpolation_steps", 4)
        ff_chunk = params.get("occ_full_field_chunk", None)
        self._occ_field = R.OccupancyField(
            model.occ, n_elev=params.get("view_state_n_elev", 7),
            n_azim=params.get("view_state_n_azim", 14),
            degree=params.get("harmonic_degree", 8),
            k_for_knn=params.get("k_for_knn", 16),
            max_cells=params.get("n_cell_per_occ_forward_pass", 12),
            cell_batch=params.get(
                "occ_cell_batch",
                max(params.get("n_cell_per_occ_forward_pass", 12),
                    ff_chunk or 0)),
            full_field_chunk=ff_chunk)
        self.bind_scene(cfg, table)
        self.coverage_gain = R.CoverageGain(
            seq_len=self.seq_len, image_height=self.H, image_width=self.W,
            min_occ=params.get("min_occ_for_proxy_points", 0.1),
            use_occ_to_sample=params.get("use_occ_to_sample_proxy_points",
                                         True),
            use_sigmoid=params.get("use_sigmoid", True),
            dist_factor_mode=params.get("distance_factor_th"),
            shared_sample=params.get("shared_sample_scoring", False))

    def bind_scene(self, cfg: G.GridConfig, table: R.CellIndexTable):
        self._tables = R.device_cell_tables(
            cfg, table, self.params.get("prediction_neighborhood_size", 3.0),
            self.device)

    def apply_depth_inference(self, batch, alpha):
        """(depth, mask, error_mask) for a depth batch and its alphas: the
        ground truth under use_perfect_depth, else ManyDepth's."""
        if self.params.get("use_perfect_depth", False):
            return perfect_depth_inference(self.dcfg, batch)
        return many_depth_inference(self.model.depth, self.dcfg, batch, alpha)

    def occupancy_field(self, proxy, surface, prediction_camera, **kw):
        kw.setdefault("full_field",
                      self.params.get("full_occupancy_field", True))
        return self._occ_field(proxy, surface, self._tables,
                               prediction_camera, **kw)

    def coverage_gains(self, *args, **kw):
        return self.coverage_gain(self.model.vis, *args, **kw)


def capture_and_save(scene: SceneState, memory: Memory, memory_path: str,
                     lights_intensity: float = 1.0):
    cam = scene.camera
    images, depth, mask = cam.capture_image(
        scene.verts_dev, scene.faces_dev, vert_colors=scene.colors_dev,
        ambient_light_intensity=lights_intensity,
        texture_atlas=scene.atlas_dev)
    memory.save_frame(memory_path, cam.n_frames_captured - 1, images, depth,
                      mask, cam.fov_camera.R, cam.fov_camera.T, cam.zfar)
    return images, depth, mask


def move_and_capture(scene: SceneState, memory: Memory, memory_path: str,
                     next_idx):
    """Interpolated move to next_idx; all n_interpolation_steps frames are
    rendered as one camera batch and saved one file each."""
    cam = scene.camera
    Rs, Ts = [], []
    for step in range(1, cam.n_interpolation_steps + 1):
        cam.update_camera(next_idx, interpolation_step=step)
        Rs.append(cam.fov_camera.R)
        Ts.append(cam.fov_camera.T)
    batch_cam = FoVCamera.create(torch.cat(Rs), torch.cat(Ts), zfar=cam.zfar)
    base = cam.n_frames_captured
    images, depth, mask = cam.capture_image(
        scene.verts_dev, scene.faces_dev, vert_colors=scene.colors_dev,
        fov_camera=batch_cam, texture_atlas=scene.atlas_dev)
    for i in range(images.shape[0]):
        memory.save_frame(memory_path, base + i, images[i:i + 1],
                          depth[i:i + 1], mask[i:i + 1], batch_cam.R[i:i + 1],
                          batch_cam.T[i:i + 1], cam.zfar)
    return images, depth, mask, batch_cam


def mapping_update(rt: MacaronsRuntime, scene: SceneState, depth, mask,
                   err_mask, R_b, T_b, gen: torch.Generator,
                   carving_tolerance: float = 0.0,
                   score_threshold: float = 1.0):
    """Per frame: backproject the depth, insert a random subset of its valid
    pixels into the surface grid, then update the proxies' view states,
    carving counters and out-of-field flags."""
    params = rt.params
    n_keep = max(int(rt.H * rt.W * scene.camera.gathering_factor), 16)
    n_elev = params.get("view_state_n_elev", 7)
    n_azim = params.get("view_state_n_azim", 14)
    surface_distance = 3.0 * scene.proxy_distance
    zfar = rt.dcfg.zfar
    surface, proxy = scene.surface_scene, scene.proxy
    for d, m, e, R1, T1 in zip(depth, mask.bool(), err_mask.bool(), R_b, T_b):
        cam = FoVCamera.create(R1[None], T1[None], zfar=zfar)
        pts, pmask = project_depth_back_to_3D(d[None], cam)
        good = pmask[0] & m.reshape(-1) & e.reshape(-1)
        idx, valid = random_subsample_mask(gen, good, n_keep)
        feats = torch.ones((n_keep, surface.features.shape[-1]),
                           device=depth.device)
        surface = G.fill_cells(scene.cfg, surface, gen, pts[0][idx], valid,
                               features=feats)
        fov = points_in_fov_mask(proxy.points[None], cam, rt.H, rt.W,
                                 fov_range=rt.sensor_range)[0]
        sd = signed_distance_to_depth_maps(proxy.points, d[None], m[None],
                                           cam, zfar)[0]
        proxy = P.update_view_states(proxy, cam.camera_center(), fov, n_elev,
                                     n_azim, signed_distances=sd,
                                     distance_to_surface=surface_distance)
        proxy = P.update_supervision_occ(proxy, fov, sd,
                                         score_threshold=score_threshold,
                                         tol=carving_tolerance)
        proxy = P.update_out_of_field(proxy, fov)
    scene.surface_scene = surface
    scene.proxy = proxy
