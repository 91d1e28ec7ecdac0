"""MACARONS online self-supervised training (port of
macarons_tpu/trainers/train_macarons.py: one scene at a time, or scene
groups on one device).

Each trajectory alternates, per pose:
  1. the decision: depth inference on the newest frames, mapping and
     carving, the occupancy field, and the NBV scorer over the valid
     neighbours (argmax);
  2. the interpolated move and its capture;
  3. one depth optimizer step on the supervision window;
  4. the SCONE supervision: the close-to-surface mask, the window's
     mapping, the pseudo-GT coverage gains, and one SCONE optimizer step
     with the predictions on the pre-window state and the occupancy target
     from the post-carve field;
then depth replay and SCONE replay from the memory and, at one pose, a
remap. A scene group (``n_parallel_scenes`` > 1, ``run_trajectories_parallel``)
takes each scene's decision and capture in turn, one depth step over the
group's windows and one SCONE step on the mean of the scenes' losses.
``run_training`` adds the epochs: resume, the freeze and unfreeze
transition, per-epoch random generators, validation, the four checkpoint
flavours and the loss-peak rollback.

The replay memory is the device-resident ``DeviceMemory`` unless the config
sets ``device_memory`` false (then the disk ``Memory``). With it, each
trajectory's frames and depths stay on the card, the episode (pose, visited
set, histories, the argmax and the move) is a ``DeviceEpisode``, and
neither the pose loop nor the memory asks the card for a number until the
epoch ends: the memory is then written to disk once and the losses are
read. Over data-parallel ranks every rank keeps a whole ``DeviceMemory``
and the ranks exchange the slots they captured at each epoch's end
(``exchange_device_memory``). Where every slot does not fit on the card
beside training, each scene's slots but the one it captures live in
page-locked host memory and replay copies its rows to the card
(``device_memory_plan``). The same trajectory function and step serve
both memories: each
memory comes with an episode adapter (``HOST_EPISODES`` for the disk memory,
the host ``Camera``'s; ``DEVICE_EPISODES`` for the device one), which
``run_training`` picks once and the pose loop asks for the start, the
decision, the move and the saved poses.

The tester (testers/scene.py) uses the inference pieces: ``setup_scene``,
``MacaronsRuntime``, ``capture_and_save``, ``move_and_capture`` and
``mapping_update``.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import time
import zlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..config import Params
from ..data.mesh_io import Mesh, load_obj, mirror_mesh
from ..data.scenes import SceneDataset, SceneSettings, occupied_pose_grid
from ..models import losses as L
from ..models.macarons import (
    MacaronsModel,
    checkpoint_exists,
    create_macarons_model,
    create_optimizers,
    init_macarons_weights,
    load_macarons,
    save_macarons,
)
from ..ops.geometry import FoVCamera
from ..ops.projection import (
    points_in_fov_mask,
    project_depth_back_to_3D,
    signed_distance_to_depth_maps,
)
from ..ops.sampling import random_subsample_mask, sample_points_on_mesh_surface
from ..parallel import distributed, mesh
from ..parallel.nbv import pad_candidates
from ..parallel.scene_dp import SceneSupervision, group_scone_step
from ..scene import grid as G
from ..scene import proxy as P
from ..scene import runtime as R
from ..scene.camera import (
    Camera,
    DeviceEpisode,
    PoseSpace,
    PoseSpaceTables,
    capture_ring,
    episode_commit,
    episode_interpolations,
    episode_neighbors,
    episode_pose_from_idx,
    episode_random_start,
    fov_holds_points,
    get_camera_RT,
    init_device_episode,
    pose_space_tables,
)
from ..scene.depth_runtime import (
    DepthBatchConfig,
    FrameRing,
    create_batch_for_depth_model,
    depth_loss,
    init_frame_ring,
    many_depth_inference,
    perfect_depth_inference,
    ring_frames,
    ring_push,
    store_append,
)
from ..scene.memory import DeviceMemory, Memory
from ..utils.convert import load_module_weights
from ..utils.device import resolve_device
from ..utils.schedule import warmup_rate

REPO_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

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
    coverages: List = field(default_factory=list)
    # The newest captured frames on the device: the decision's and the
    # supervision step's windows.
    ring: Optional[FrameRing] = None
    # The trajectory on the card (device memory) and its lattice's tables.
    episode: Optional[DeviceEpisode] = None
    pose_tables: Optional[PoseSpaceTables] = None
    # The scene's own random streams for its trajectory (``run_training``
    # derives them from the run's seeds, the epoch and the scene's index);
    # without them the trajectory draws from the caller's.
    gen: Optional[torch.Generator] = None
    rs: Optional[np.random.Generator] = None

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
        rotation_mode=params.get("rotation_mode", "angle"),
        ssim_factor=params.get("ssim_factor", 0.85),
        regularity_factor=params.get("regularity_factor", 0.01),
        regularity_loss=params.get("regularity_loss", True),
        use_depth_mask=params.get("use_depth_mask", True),
        padding_mode=params.get("padding_mode", "border"),
        data_augmentation=params.get("data_augmentation", True),
        jitter_probability=params.get("jitter_probability", 0.5),
        symmetry_probability=params.get("symmetry_probability", 0.5),
    )


def setup_scene(params: Params, scene_item: Dict, gen: torch.Generator,
                device, mirrored_axes: Optional[List[int]] = None
                ) -> SceneState:
    """Load the mesh (with its baked texture atlas, if the OBJ has one) and
    settings, mirrored along ``mirrored_axes`` if given (the box and the
    occupied poses with it); build the GT and surface grids, the proxy
    field (numpy-seeded by the scene name, as in the JAX package) and the
    camera."""
    mesh = load_obj(scene_item["obj_path"],
                    create_texture_atlas=params.get("load_obj_textures", True),
                    texture_atlas_size=params.get("texture_atlas_size", 4))
    mesh = Mesh(mesh.verts * params.get("scene_scale_factor", 1.0),
                mesh.faces, mesh.vert_colors, mesh.texture_atlas)
    if mirrored_axes:
        mesh = mirror_mesh(mesh, mirrored_axes)
    s = scene_item["settings"]
    x_min = np.asarray(s.scene_x_min, np.float32).copy()
    x_max = np.asarray(s.scene_x_max, np.float32).copy()
    for a in mirrored_axes or ():
        x_min[a], x_max[a] = -x_max[a], -x_min[a]
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
        for a in mirrored_axes or ():
            occupied = np.flip(occupied, axis=a).copy()
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
    """The pieces shared across scenes, at the config's widths: depth,
    the occupancy field (inference and supervision), the NBV scorer, the
    optimizer steps and the learning-rate schedule."""

    def __init__(self, params: Params, model: MacaronsModel,
                 cfg: Optional[G.GridConfig] = None,
                 table: Optional[R.CellIndexTable] = None, device="cuda"):
        self.params = params
        self.model = model
        self.device = resolve_device(device)
        self.dcfg = depth_cfg_from_params(params)
        self.H = params.get("image_height", 256)
        self.W = params.get("image_width", 456)
        self.sensor_range = params.get("sensor_range",
                                       1.2 * params.get("zfar", 750.0))
        self.seq_len = params.get("seq_len", 2048)
        self.n_interpolation_steps = params.get("n_interpolation_steps", 4)
        ff_chunk = params.get("occ_full_field_chunk", None)
        occ_kw = dict(n_elev=params.get("view_state_n_elev", 7),
                      n_azim=params.get("view_state_n_azim", 14),
                      degree=params.get("harmonic_degree", 8),
                      k_for_knn=params.get("k_for_knn", 16))
        self._occ_field = R.OccupancyField(
            model.occ, max_cells=params.get("n_cell_per_occ_forward_pass", 12),
            cell_batch=params.get(
                "occ_cell_batch",
                max(params.get("n_cell_per_occ_forward_pass", 12),
                    ff_chunk or 0)),
            full_field_chunk=ff_chunk,
            compute_dtype=params.get("occ_compute_dtype"), **occ_kw)
        # The supervision pass ranks up to occ_curriculum_max_cells random
        # cells; the curriculum keeps the first n_cells_active of them.
        self.occ_curriculum_min_cells = params.get("occ_curriculum_min_cells",
                                                   5)
        self.occ_curriculum_max_cells = params.get(
            "occ_curriculum_max_cells",
            max(20, params.get("n_cell_per_occ_forward_pass", 12)))
        self._occ_field_sup = R.OccupancyField(
            model.occ, max_cells=self.occ_curriculum_max_cells,
            cell_batch=params.get("occ_supervision_cell_batch",
                                  self.occ_curriculum_max_cells),
            compute_dtype=params.get("occ_supervision_compute_dtype"),
            **occ_kw)
        self._tables = None
        self._bound = None
        if cfg is not None and table is not None:
            self.bind_scene(cfg, table)
        self.coverage_gain = R.CoverageGain(
            seq_len=self.seq_len, image_height=self.H, image_width=self.W,
            min_occ=params.get("min_occ_for_proxy_points", 0.1),
            use_occ_to_sample=params.get("use_occ_to_sample_proxy_points",
                                         True),
            use_sigmoid=params.get("use_sigmoid", True),
            dist_factor_mode=params.get("distance_factor_th"),
            shared_sample=params.get("shared_sample_scoring", False))

        # Warm-up to the max lr over the first steps of each optimizer, with
        # the max lr dropped by lr_factor at each listed epoch.
        self.schedule_lr = params.get("schedule_learning_rate", False)
        self.lr_factor = params.get("lr_factor", 0.1)
        self.depth_base_lr = self.depth_max_lr = params.get(
            "depth_learning_rate", params.get("learning_rate", 1e-4))
        self.scone_base_lr = self.scone_max_lr = params.get(
            "scone_learning_rate", params.get("learning_rate", 1e-4))
        self.depth_warmup = params.get("depth_warmup", params.get("warmup", 1))
        self.scone_warmup = params.get("scone_warmup", params.get("warmup", 1))
        self.depth_lr_epochs = list(params.get("depth_lr_epochs") or [])
        self.scone_lr_epochs = list(params.get("scone_lr_epochs") or [])
        self.depth_opt_steps = 0
        self.scone_opt_steps = 0
        # The rank whose SCONE replay steps the others follow (None: each
        # step is this rank's alone, or its group's).
        self.scone_owner: Optional[int] = None

    def ring_length(self) -> int:
        """Frames the ring keeps: the supervision window's and the
        decision's, whichever is longer."""
        return max(self.n_interpolation_steps
                   + self.dcfg.n_alpha_for_supervision, 1 + self.dcfg.n_alpha)

    def bind_scene(self, cfg: G.GridConfig, table: R.CellIndexTable):
        """Point the occupancy fields at one scene's cell tables; a no-op
        when that scene's table is bound already."""
        if table is self._bound:
            return
        self._bound = table
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

    # -- learning-rate schedule ---------------------------------------------
    def update_learning_rates(self, epoch: int):
        """The max lr after the epoch drops listed up to ``epoch``."""
        if not self.schedule_lr:
            return
        self.depth_max_lr = self.depth_base_lr * self.lr_factor ** sum(
            1 for e in self.depth_lr_epochs if epoch >= e)
        self.scone_max_lr = self.scone_base_lr * self.lr_factor ** sum(
            1 for e in self.scone_lr_epochs if epoch >= e)

    @staticmethod
    def _set_lr(opt: torch.optim.Optimizer, lr: float):
        for group in opt.param_groups:
            group["lr"] = lr

    def _next_depth_lr(self, opt):
        if self.schedule_lr:
            self.depth_opt_steps += 1
            self._set_lr(opt, warmup_rate(
                self.depth_max_lr, self.depth_opt_steps, self.depth_warmup))

    def _next_scone_lr(self, opt):
        if self.schedule_lr:
            self.scone_opt_steps += 1
            self._set_lr(opt, warmup_rate(
                self.scone_max_lr, self.scone_opt_steps, self.scone_warmup))

    # -- depth optimizer step ------------------------------------------------
    def depth_train_step(self, opt, batch, alpha, gen=None, draws=None,
                         online: bool = True):
        """One depth optimizer step on a depth batch: ManyDepth in train mode
        (batch statistics, the running ones updated), the depth loss with
        augmentation (draws from ``gen`` or injected), backward, AdamW.
        ``online=False`` computes the loss only and leaves the network as it
        was. Returns (loss, depth, mask, error_mask) with depth and masks
        detached.

        Over data-parallel ranks ``batch`` is this rank's rows of the
        global batch: BatchNorm takes the global batch's statistics, each
        rank back-propagates its share of the global loss
        (``depth_loss``'s ``row_share``), the gradients are summed over
        the ranks before AdamW, the augmentation draw (one per batch) is
        every rank's, and the loss returned is the global batch's."""
        depth_model = self.model.depth
        use_perfect = self.params.get("use_perfect_depth", False)
        share = 1.0 / mesh.world()
        if use_perfect or depth_model is None:
            with torch.no_grad():
                loss, depth, mask, err, _, _ = depth_loss(
                    None, self.dcfg, batch, alpha, use_perfect_depth=True,
                    draws=draws, gen=gen, row_share=share)
            return mesh.all_reduce_sum(loss), depth, mask, err
        if online:
            self._next_depth_lr(opt)
            depth_model.train()
            try:
                loss, depth, mask, err, _, _ = depth_loss(
                    depth_model, self.dcfg, batch, alpha, draws=draws, gen=gen,
                    row_share=share)
            finally:
                depth_model.eval()
            opt.zero_grad(set_to_none=True)
            loss.backward()
            mesh.all_reduce_grads(depth_model.parameters())
            opt.step()
            return mesh.all_reduce_sum(loss), depth, mask, err
        # Loss only: batch statistics as in training, running ones kept.
        stats = {k: v.clone() for k, v in depth_model.named_buffers()}
        depth_model.train()
        try:
            with torch.no_grad():
                loss, depth, mask, err, _, _ = depth_loss(
                    depth_model, self.dcfg, batch, alpha, draws=draws,
                    gen=gen, row_share=share)
        finally:
            depth_model.eval()
            depth_model.load_state_dict(stats, strict=False)
        return mesh.all_reduce_sum(loss), depth, mask, err

    # -- scone optimizer step ------------------------------------------------
    def scone_losses(self, proxy, surface, prediction_camera, close_mask,
                     visited_cams, visited_X, supervision_gains, field,
                     n_supervision: int, box_diag: float,
                     cell_resolution: float, n_cells_active: int, sup_occ,
                     gen=None, cell_noise=None, sample_idx=None):
        """SCONE's two losses under grad: the occupancy MSE of the supervision
        pass on ``proxy``/``surface`` against ``sup_occ`` (summed over the
        predicted proxies, over n_supervision), and the uncentered L1 of the
        visited cameras' predicted coverage gains against
        ``supervision_gains``. ``cell_noise`` and ``sample_idx`` inject the
        cell ranking and the MC sample. Returns (occ_loss, cov_loss)."""
        proba, pred_mask, _ = self._occ_field_sup.supervise(
            proxy, surface, self._tables, prediction_camera,
            eligible_override=close_mask, n_cells_active=n_cells_active,
            generator=gen, noise=cell_noise)
        err = torch.where(pred_mask[:, None], (proba - sup_occ) ** 2, 0.0)
        n_pred = pred_mask.sum()
        occ_loss = err.sum() / torch.clamp(n_pred, min=1) * n_pred \
            / n_supervision
        gains = self.coverage_gain.gains(
            self.model.vis, *field, visited_cams, visited_X,
            prediction_camera, box_diag, cell_resolution, self.sensor_range,
            generator=gen, sample_idx=sample_idx)
        cov_loss = L.uncentered_l1(gains.reshape(1, -1, 1),
                                   supervision_gains.reshape(1, -1, 1))
        return occ_loss, cov_loss

    def scone_train_step(self, opt, proxy, surface, prediction_camera,
                         close_mask, visited_cams, visited_X,
                         supervision_gains, field, n_supervision: int,
                         box_diag: float, cell_resolution: float,
                         n_cells_active: Optional[int] = None, sup_occ=None,
                         gen=None, cell_noise=None, sample_idx=None):
        """One SCONE optimizer step (SconeOcc and SconeVis, one AdamW).
        ``proxy``/``surface`` are the states the predictions run on;
        ``sup_occ`` (N, 1) is the occupancy target (default the proxies'
        own supervision field). Returns (loss, occ_loss, cov_loss)."""
        self._next_scone_lr(opt)
        if n_cells_active is None:
            n_cells_active = self.occ_curriculum_max_cells
        if sup_occ is None:
            sup_occ = proxy.supervision_occ
        occ_loss, cov_loss = self.scone_losses(
            proxy, surface, prediction_camera, close_mask, visited_cams,
            visited_X, supervision_gains, field, n_supervision, box_diag,
            cell_resolution, n_cells_active, sup_occ, gen, cell_noise,
            sample_idx)
        loss = occ_loss + cov_loss
        opt.zero_grad(set_to_none=True)
        loss.backward()
        if self.scone_owner is not None:
            # A replay step that the other ranks follow.
            mesh.broadcast_(torch.ones(1, device=distributed.device()),
                            self.scone_owner)
            mesh.broadcast_grads(self._scone_params(opt), self.scone_owner)
        opt.step()
        return loss.detach(), occ_loss.detach(), cov_loss.detach()

    @staticmethod
    def _scone_params(opt):
        return [p for g in opt.param_groups for p in g["params"]]

    def follow_scone_steps(self, opt, owner: int) -> int:
        """Take the SCONE replay steps of rank ``owner`` (each announced,
        then its gradients broadcast) until it ends its replay
        (``end_scone_replay``). Returns the number of steps."""
        n = 0
        while True:
            flag = mesh.broadcast_(torch.zeros(1, device=distributed.device()),
                                   owner)
            if float(flag) == 0.0:
                return n
            self._next_scone_lr(opt)
            opt.zero_grad(set_to_none=True)
            mesh.broadcast_grads(self._scone_params(opt), owner)
            opt.step()
            n += 1

    def end_scone_replay(self):
        """Tell the ranks following this one's SCONE replay that it ended."""
        mesh.broadcast_(torch.zeros(1, device=distributed.device()),
                        mesh.rank())

    def parallel_scone_train_step(self, opt, group: List[SceneSupervision],
                                  n_cells_active: Optional[int] = None,
                                  gen=None, cell_noise=None,
                                  sample_idx=None):
        """One SCONE optimizer step on the mean of a scene group's losses
        (``parallel.scene_dp.group_scone_step``; over data-parallel ranks
        ``group`` is this rank's scenes of the group), counted as one step
        of the warm-up schedule. ``gen`` is a generator or one per scene.
        Returns (loss, occ_loss, cov_loss), each the group's mean."""
        self._next_scone_lr(opt)
        if n_cells_active is None:
            n_cells_active = self.occ_curriculum_max_cells
        return group_scone_step(
            self, opt, group, self.params.get(
                "n_proxy_point_for_occupancy_supervision", 6000),
            n_cells_active, gen=gen, cell_noise=cell_noise,
            sample_idx=sample_idx)


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
    rendered as one camera batch and saved one file each (one copy to the
    host per array)."""
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
    memory.save_frame_batch(memory_path, base, images, depth, mask,
                            batch_cam.R, batch_cam.T, cam.zfar)
    return images, depth, mask, batch_cam


def mapping_update(rt: MacaronsRuntime, scene: SceneState, depth, mask,
                   err_mask, R_b, T_b, gen: torch.Generator,
                   carving_tolerance: float = 0.0,
                   score_threshold: float = 1.0, fill_feats=None,
                   surface_distance: Optional[float] = None):
    """Per frame: backproject the depth, insert a random subset of its valid
    pixels into the surface grid (with coveredness feature ``fill_feats``
    (F,), default 1), then update the proxies' view states (surface test at
    ``surface_distance``, default 3 proxy spacings), carving counters and
    out-of-field flags. Returns the inserted clouds and their masks
    ((F, n_keep, 3), (F, n_keep))."""
    params = rt.params
    n_keep = max(int(rt.H * rt.W * scene.camera.gathering_factor), 16)
    n_elev = params.get("view_state_n_elev", 7)
    n_azim = params.get("view_state_n_azim", 14)
    if surface_distance is None:
        surface_distance = 3.0 * scene.proxy_distance
    if fill_feats is None:
        fill_feats = torch.ones((depth.shape[0],), device=depth.device)
    zfar = rt.dcfg.zfar
    surface, proxy = scene.surface_scene, scene.proxy
    pcs, valids = [], []
    for d, m, e, R1, T1, fv in zip(depth, mask.bool(), err_mask.bool(), R_b,
                                   T_b, fill_feats):
        cam = FoVCamera.create(R1[None], T1[None], zfar=zfar)
        pts, pmask = project_depth_back_to_3D(d[None], cam)
        good = pmask[0] & m.reshape(-1) & e.reshape(-1)
        idx, valid = random_subsample_mask(gen, good, n_keep)
        feats = fv.expand(n_keep, surface.features.shape[-1])
        surface = G.fill_cells(scene.cfg, surface, gen, pts[0][idx], valid,
                               features=feats)
        pcs.append(pts[0][idx])
        valids.append(valid)
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
    return torch.stack(pcs), torch.stack(valids)


def close_mask(rt: MacaronsRuntime, points, depth, mask, R_b, T_b,
               surface_distance: float):
    """Proxies within ``surface_distance`` of a frame's depth surface, frame
    by frame; a point in the FoV of several frames takes the last one's
    answer."""
    close = torch.zeros((points.shape[0],), dtype=torch.bool,
                        device=points.device)
    for d, m, R1, T1 in zip(depth, mask.bool(), R_b, T_b):
        cam = FoVCamera.create(R1[None], T1[None], zfar=rt.dcfg.zfar)
        fov = points_in_fov_mask(points[None], cam, rt.H, rt.W,
                                 fov_range=rt.sensor_range)[0]
        sd = signed_distance_to_depth_maps(points, d[None], m[None], cam,
                                           rt.dcfg.zfar)[0]
        close = torch.where(fov, torch.abs(sd[:, 0]) < surface_distance,
                            close)
    return close


def supervision_signal(rt: MacaronsRuntime, scene: SceneState, depth, mask,
                       err_mask, batch_R, batch_T, gen: torch.Generator,
                       surface_distance: float,
                       vs_distance: Optional[float] = None,
                       carving_tolerance: float = 0.0,
                       score_threshold: float = 1.0) -> SceneSupervision:
    """A supervision window's signal for the SCONE step: the
    close-to-surface mask (``surface_distance``) on the pre-window state,
    the window's mapping and carving (its frame 0 arrives covered; the
    view-state surface test at ``vs_distance``, default
    ``surface_distance``), and the pseudo-GT coverage gains of the window.
    Updates ``scene``; returns the step's inputs (the pre-window proxy and
    surface, the post-carve occupancy target) without the prediction
    camera and the scene field."""
    if vs_distance is None:
        vs_distance = surface_distance
    pre_proxy, pre_surface = scene.proxy, scene.surface_scene
    pre_oof = pre_proxy.out_of_field[:, 0] < 1.0
    close = close_mask(rt, pre_proxy.points, depth, mask, batch_R, batch_T,
                       surface_distance)
    fill = torch.zeros((depth.shape[0],), device=depth.device)
    fill[0] = 1.0
    pcs, valids = mapping_update(
        rt, scene, depth, mask, err_mask, batch_R, batch_T, gen,
        carving_tolerance=carving_tolerance, score_threshold=score_threshold,
        fill_feats=fill, surface_distance=vs_distance)
    sup_gains, scene.surface_scene = G.window_coverage_gains(
        scene.cfg, scene.surface_scene, pcs, valids,
        surface_epsilon=rt.params.get("surface_epsilon"))
    cams = FoVCamera.create(batch_R, batch_T, zfar=rt.dcfg.zfar)
    return SceneSupervision(
        cfg=scene.cfg, cell_table=scene.cell_table, proxy=pre_proxy,
        surface=pre_surface, close_mask=close & pre_oof, visited_cams=cams,
        visited_X=cams.camera_center(), supervision_gains=sup_gains,
        sup_occ=scene.proxy.supervision_occ)


# ---------------------------------------------------------------------------
# The pose loop
# ---------------------------------------------------------------------------


def push_frames(rt: MacaronsRuntime, scene: SceneState, images, depth, mask,
                R, T):
    """Append captured frames to the scene's ring (a fresh one if it has
    none), which keeps the newest ``rt.ring_length()``."""
    if scene.ring is None:
        scene.ring = init_frame_ring(rt.ring_length(), rt.H, rt.W,
                                     rt.dcfg.zfar, images.device)
    scene.ring = ring_push(scene.ring, images, depth, mask, R, T,
                           rt.dcfg.zfar)


def window_frames(rt: MacaronsRuntime, scene: SceneState, n: int) -> Dict:
    """The newest ``n`` frames of the ring, stacked as
    Memory.load_frame_sequence stacks them."""
    return ring_frames(scene.ring, n)


def start_trajectory(rt: MacaronsRuntime, scene: SceneState, memory: Memory,
                     memory_path: str, rs: np.random.Generator,
                     start_idx=None):
    """A random valid start pose (unless given) and its 1 + n_alpha
    captures, saved to the memory and pushed onto a fresh ring."""
    cam = scene.camera
    if start_idx is None:
        start_idx = cam.get_random_valid_pose(rs, scene.verts_dev,
                                              proxy_points=scene.proxy.points)
    cam.initialize(np.asarray(start_idx))
    scene.ring = None
    for _ in range(1 + rt.dcfg.n_alpha):
        images, depth, mask = capture_and_save(scene, memory, memory_path)
        push_frames(rt, scene, images, depth, mask, cam.fov_camera.R,
                    cam.fov_camera.T)


def _lattice(scene: SceneState):
    """(tables on the card, dims, n_elev, n_azim) of the scene's lattice."""
    cam = scene.camera
    ps = cam.pose_space
    if scene.pose_tables is None:
        scene.pose_tables = pose_space_tables(ps, cam.occupied_poses,
                                              scene.device)
    return (scene.pose_tables, tuple(int(d) for d in ps.dims),
            ps.pose_n_elev, ps.pose_n_azim)


def start_trajectory_device(rt: MacaronsRuntime, scene: SceneState,
                            memory: DeviceMemory, memory_path: str,
                            gen: torch.Generator, max_moves: int):
    """The device memory's start: fresh stores for the slot, a random valid
    start pose drawn from ``gen`` (``episode_random_start``), the episode
    there, and its 1 + n_alpha captures on a fresh ring and in the store."""
    store = memory.begin_trajectory(memory_path)
    tables, dims, n_elev, n_azim = _lattice(scene)
    start, _ = episode_random_start(
        gen, tables, dims, n_elev, n_azim, scene.verts_dev,
        scene.proxy.points, rt.H, rt.W, rt.dcfg.zfar)
    ep = init_device_episode(start, tables, dims, n_elev, n_azim, max_moves,
                             memory.max_frames)
    K = 1 + rt.dcfg.n_alpha
    scene.ring = init_frame_ring(rt.ring_length(), rt.H, rt.W, rt.dcfg.zfar,
                                 scene.device)
    images, depth, mask, R_b, T_b, scene.ring = capture_ring(
        scene.camera, scene.verts_dev, scene.faces_dev, ep.X.expand(K, 3),
        ep.V.expand(K, 2), scene.ring, vert_colors=scene.colors_dev,
        texture_atlas=scene.atlas_dev)
    memory.update_store(memory_path, store_append(store, images, depth, mask,
                                                  R_b, T_b))
    scene.episode = ep


def _phase(on_phase, pose_i, name):
    if on_phase is not None:
        on_phase(pose_i, name)


def scene_field(rt: MacaronsRuntime, scene: SceneState,
                use_supervision_occ: bool = False,
                prediction_camera: Optional[FoVCamera] = None):
    """The occupancy field at the prediction camera (default the camera's
    ``fov_camera_0``; the carving pseudo-GT in its place with
    ``use_supervision_occ``), written into the proxies' proba. Returns the
    scene field for the scorer."""
    if prediction_camera is None:
        prediction_camera = scene.camera.fov_camera_0
    proba, pred_mask, harmonics = rt.occupancy_field(
        scene.proxy, scene.surface_scene, prediction_camera)
    if use_supervision_occ:
        proba = scene.proxy.supervision_occ
        pred_mask = scene.proxy.out_of_field[:, 0] < 1.0
    scene.proxy = scene.proxy._replace(proba=torch.where(
        pred_mask[:, None], proba, scene.proxy.proba))
    return R.assemble_scene_field(scene.proxy, proba, pred_mask, harmonics)


def backtrack_pose(cam: Camera) -> np.ndarray:
    """A lattice dead end: the previous pose, or the current one."""
    hist = cam.cam_idx_history
    return np.asarray(hist[-2] if len(hist) >= 2 else cam.cam_idx)


def box_diagonal(scene: SceneState) -> float:
    return float(np.linalg.norm(np.asarray(scene.cfg.x_max)
                                - np.asarray(scene.cfg.x_min)))


def candidate_cameras(rt: MacaronsRuntime, cam: Camera, valid_nbrs):
    """The cameras of the valid neighbour poses, padded to the bucket.
    Returns (cameras, centres, number of real candidates)."""
    poses = torch.as_tensor(cam.pose_space.pose_from_idx(valid_nbrs),
                            device=rt.device)
    R_c, T_c = get_camera_RT(poses[:, :3], poses[:, 3:])
    return pad_candidates(FoVCamera.create(R_c, T_c, zfar=rt.dcfg.zfar),
                          poses[:, :3],
                          rt.params.get("nbv_candidate_bucket", 8))


def nbv_choice(rt: MacaronsRuntime, scene: SceneState, fld, valid_nbrs,
               gen: torch.Generator) -> np.ndarray:
    """The valid neighbour with the largest SconeVis coverage gain."""
    cam = scene.camera
    cand_cams, X_cand, n_cand = candidate_cameras(rt, cam, valid_nbrs)
    gains = rt.coverage_gains(*fld, cand_cams, X_cand, cam.fov_camera_0,
                              box_diagonal(scene), scene.cfg.resolution,
                              rt.sensor_range, generator=gen)[:n_cand]
    return valid_nbrs[int(torch.argmax(gains))]


def decision_field(rt: MacaronsRuntime, scene: SceneState,
                   gen: torch.Generator, warmup_phase: bool = False,
                   prediction_camera: Optional[FoVCamera] = None):
    """The decision's world update: depth inference on the newest 1 +
    n_alpha frames, mapping and carving, and the occupancy field at the
    prediction camera (the carving pseudo-GT in the warm-up phase).
    Returns the scene field."""
    params = rt.params
    batch, alpha = create_batch_for_depth_model(
        rt.dcfg, window_frames(rt, scene, 1 + rt.dcfg.n_alpha), "inference",
        device=rt.device)
    depth, mask, err_mask = rt.apply_depth_inference(batch, alpha)
    mapping_update(rt, scene, depth, mask, err_mask, batch["R"], batch["T"],
                   gen, carving_tolerance=params.get("carving_tolerance", 0.0),
                   score_threshold=params.get("score_threshold", 1.0))
    return scene_field(rt, scene, use_supervision_occ=warmup_phase,
                       prediction_camera=prediction_camera)


def decide(rt: MacaronsRuntime, scene: SceneState, gen: torch.Generator,
           warmup_phase: bool = False):
    """The disk memory's decision: ``decision_field``, then the NBV scorer
    over the valid neighbours (the host camera's). Returns (next pose
    index, scene field)."""
    cam = scene.camera
    fld = decision_field(rt, scene, gen, warmup_phase)
    valid_nbrs = cam.get_valid_neighbors(cam.get_neighboring_poses(),
                                         scene.verts_dev)
    if len(valid_nbrs) == 0:
        return backtrack_pose(cam), fld
    return nbv_choice(rt, scene, fld, valid_nbrs, gen), fld


def select_move(cand, gains, new_ok, visited_ok):
    """The candidate with the largest gain among the new valid ones, or
    among the visited ones if no new one is valid (slot 0 if none is).
    Stays on the card."""
    sel = torch.where(new_ok.any(), new_ok, visited_ok)
    slot = torch.argmax(torch.where(sel, gains, float("-inf")))
    return cand.index_select(0, slot.reshape(1))[0]


def episode_camera(rt: MacaronsRuntime, ep: DeviceEpisode) -> FoVCamera:
    return FoVCamera.create(ep.R, ep.T, zfar=rt.dcfg.zfar)


def episode_choice(rt: MacaronsRuntime, scene: SceneState, fld,
                   gen: torch.Generator):
    """The device memory's choice: every neighbour move of the episode's
    pose scored (per candidate, as the scorer samples), those whose field
    of view holds a mesh vertex kept, ``select_move``. Returns the next
    pose index, on the card."""
    ep = scene.episode
    tables, dims, n_elev, n_azim = _lattice(scene)
    cand, new_ok, visited_ok = episode_neighbors(ep, tables, dims)
    poses = episode_pose_from_idx(cand, tables, n_elev, n_azim)
    fov_ok = fov_holds_points(poses, scene.verts_dev, rt.H, rt.W,
                              rt.dcfg.zfar)
    R_c, T_c = get_camera_RT(poses[:, :3], poses[:, 3:])
    gains = rt.coverage_gains(
        *fld, FoVCamera.create(R_c, T_c, zfar=rt.dcfg.zfar), poses[:, :3],
        episode_camera(rt, ep), box_diagonal(scene), scene.cfg.resolution,
        rt.sensor_range, generator=gen)
    return select_move(cand, gains, new_ok & fov_ok, visited_ok)


def episode_move(rt: MacaronsRuntime, scene: SceneState,
                 memory: DeviceMemory, memory_path: str, next_idx):
    """The device memory's move: the interpolated poses to ``next_idx``,
    their capture onto the ring and into the store, the episode's commit."""
    tables, dims, n_elev, n_azim = _lattice(scene)
    ep = scene.episode
    X, V = episode_interpolations(ep, next_idx, tables, n_elev, n_azim,
                                  rt.n_interpolation_steps)
    images, depth, mask, R_m, T_m, scene.ring = capture_ring(
        scene.camera, scene.verts_dev, scene.faces_dev, X, V, scene.ring,
        vert_colors=scene.colors_dev, texture_atlas=scene.atlas_dev)
    memory.update_store(memory_path, store_append(
        memory.store(memory_path), images, depth, mask, R_m, T_m))
    scene.episode = episode_commit(ep, next_idx, X, V, R_m, T_m, dims)


def group_supervision_batch(rt: MacaronsRuntime, scenes: List[SceneState]):
    """The supervision windows of a scene group as one depth batch: each
    scene's window is built from its own frames, so alpha frames never
    cross scenes, and the windows are concatenated in scene order.
    Returns (batch, alpha)."""
    n_sup = rt.n_interpolation_steps + rt.dcfg.n_alpha_for_supervision
    per = [create_batch_for_depth_model(
        rt.dcfg, window_frames(rt, scene, n_sup), "supervision",
        device=rt.device) for scene in scenes]
    return ({k: torch.cat([b[k] for b, _ in per]) for k in per[0][0]},
            {k: torch.cat([a[k] for _, a in per]) for k in per[0][1]})


class HostEpisodes:
    """The disk ``Memory``'s episodes: the pose, its history and the
    decision on each scene's host ``Camera``, every capture saved to the
    memory as it is taken, losses and coverages read per pose."""

    read_per_pose = True

    @staticmethod
    def read(value):
        return float(value)

    def start(self, rt, scenes, memory, memory_paths, gen, rs, n_poses):
        """Every scene's start drawn (from its own ``rs``, else the
        caller's) before any is primed."""
        starts = [s.camera.get_random_valid_pose(
            own_rs(s, rs), s.verts_dev,
            proxy_points=s.proxy.points) for s in scenes]
        for scene, mp, start in zip(scenes, memory_paths, starts):
            start_trajectory(rt, scene, memory, mp, rs, start_idx=start)

    def decide(self, rt, scene, gen, warmup_phase):
        """(next pose index, scene field, prediction camera)."""
        cam = scene.camera
        cam.fov_camera_0 = cam.fov_camera
        pred = FoVCamera.create(cam.fov_camera_0.R, cam.fov_camera_0.T,
                                zfar=rt.dcfg.zfar)
        next_idx, fld = decide(rt, scene, gen, warmup_phase)
        return next_idx, fld, pred

    def move(self, rt, scene, memory, memory_path, next_idx):
        images, depth, mask, batch_cam = move_and_capture(
            scene, memory, memory_path, next_idx)
        push_frames(rt, scene, images, depth, mask, batch_cam.R, batch_cam.T)

    def save_poses(self, scene, memory, memory_path):
        cam = scene.camera
        memory.save_poses(memory_path, memory.current_epoch,
                          np.concatenate(cam.X_cam_history, 0),
                          np.concatenate(cam.V_cam_history, 0),
                          np.stack(cam.cam_idx_history, 0))


class DeviceEpisodes:
    """The ``DeviceMemory``'s episodes: each scene's ``DeviceEpisode`` of
    tensors, its captures appended to the memory's stores, losses and
    coverages left on the card until the epoch's end."""

    read_per_pose = False

    @staticmethod
    def read(value):
        return value

    def start(self, rt, scenes, memory, memory_paths, gen, rs, n_poses):
        """Scene by scene, each start drawn (from the scene's own
        generator, else ``gen``) and primed on the card."""
        for scene, mp in zip(scenes, memory_paths):
            start_trajectory_device(rt, scene, memory, mp,
                                    own_gen(scene, gen), n_poses + 1)

    def decide(self, rt, scene, gen, warmup_phase):
        """(next pose index on the card, scene field, prediction camera)."""
        pred = episode_camera(rt, scene.episode)
        fld = decision_field(rt, scene, gen, warmup_phase, pred)
        return episode_choice(rt, scene, fld, gen), fld, pred

    def move(self, rt, scene, memory, memory_path, next_idx):
        episode_move(rt, scene, memory, memory_path, next_idx)

    def save_poses(self, scene, memory, memory_path):
        ep = scene.episode
        memory.save_poses(memory_path, memory.current_epoch, ep.X_history,
                          ep.V_history, ep.idx_history, n_moves=ep.n_moves,
                          n_frames=ep.n_frames)


HOST_EPISODES = HostEpisodes()
DEVICE_EPISODES = DeviceEpisodes()


def own_gen(scene, gen: torch.Generator) -> torch.Generator:
    """The torch generator of a scene's own draws: its own if
    ``run_training`` gave it one, else the caller's ``gen``."""
    return getattr(scene, "gen", None) or gen


def own_rs(scene, rs: np.random.Generator) -> np.random.Generator:
    """The numpy generator of a scene's own draws, as ``own_gen``."""
    return getattr(scene, "rs", None) or rs


def nbv_parallel_step(rt: MacaronsRuntime, scenes: List[SceneState],
                      memory: Memory, memory_paths: List[str], opts: Dict,
                      gen: torch.Generator, freeze_scone: bool = False,
                      warmup_phase: bool = False,
                      online_learning: bool = True,
                      surface_distances: Optional[List[float]] = None,
                      n_cells_active: Optional[int] = None,
                      on_phase: Optional[Callable] = None, pose_i: int = 0,
                      episodes=None):
    """One NBV iteration of a scene group (a single scene is a group of
    one): for each scene in turn the decision, the move and its capture,
    as ``episodes`` (default ``HOST_EPISODES``) runs them;
    one depth step over the group's supervision windows, each built from
    its own scene's frames and concatenated in scene order (BatchNorm takes
    its statistics over the whole batch); each scene's supervision signal
    on its slice; and one SCONE step on the mean of the scenes' losses.
    A scene's decision, capture and supervision draw from its own streams
    (``own_gen``); the depth step's augmentation from ``gen``. Over
    data-parallel ranks ``scenes`` are this rank's block of the group:
    the depth and SCONE steps are the group's, and so are the losses.
    ``on_phase(pose_i, name)`` is called before "decision/<s>" and
    "capture/<s>" of scene s, "depth_step", "supervision" and
    "scone_step"; a group of one calls them "decision", "capture",
    "depth_step" and "scone_step", its supervision counted to its SCONE
    step. Returns the losses {"depth", "occ", "cov"} as tensors, occ and
    cov the group's means."""
    params = rt.params
    S = len(scenes)

    def tag(name, s):
        return name if S == 1 else f"{name}/{s}"

    episodes = episodes or HOST_EPISODES
    fields, pred_cams = [], []
    for s, (scene, mp) in enumerate(zip(scenes, memory_paths)):
        rt.bind_scene(scene.cfg, scene.cell_table)
        _phase(on_phase, pose_i, tag("decision", s))
        next_idx, fld, pred_cam = episodes.decide(
            rt, scene, own_gen(scene, gen), warmup_phase)
        fields.append(fld)
        pred_cams.append(pred_cam)
        _phase(on_phase, pose_i, tag("capture", s))
        episodes.move(rt, scene, memory, mp, next_idx)

    _phase(on_phase, pose_i, "depth_step")
    batch, alpha = group_supervision_batch(rt, scenes)
    depth_loss_v, depth, mask, err_mask = rt.depth_train_step(
        opts.get("depth"), batch, alpha, gen=gen, online=online_learning)
    F = depth.shape[0] // S

    _phase(on_phase, pose_i, "supervision" if S > 1 else "scone_step")
    group = []
    for s, scene in enumerate(scenes):
        sl = slice(s * F, (s + 1) * F)
        sup = supervision_signal(
            rt, scene, depth[sl], mask[sl], err_mask[sl], batch["R"][sl],
            batch["T"][sl], own_gen(scene, gen),
            surface_distances[s] if surface_distances
            else 3.0 * scene.proxy_distance,
            vs_distance=3.0 * scene.proxy_distance,
            carving_tolerance=params.get("carving_tolerance", 0.0),
            score_threshold=params.get("score_threshold", 1.0))
        sup.prediction_camera, sup.field = pred_cams[s], fields[s]
        group.append(sup)

    if S > 1:
        _phase(on_phase, pose_i, "scone_step")
    zero = torch.zeros((), device=rt.device)
    occ_loss = cov_loss = zero
    if online_learning and not freeze_scone:
        _, occ_loss, cov_loss = rt.parallel_scone_train_step(
            opts["scone"], group, n_cells_active=n_cells_active,
            gen=[own_gen(s, gen) for s in scenes])
    return {"depth": depth_loss_v, "occ": occ_loss, "cov": cov_loss}


def memory_depth_loop(rt: MacaronsRuntime, memory: Memory, opts: Dict,
                      gen: torch.Generator, rs: np.random.Generator,
                      scale: int = 1):
    """Depth replay: n_memory_samples frames drawn independently over every
    scene memory and every past trajectory, each with its alpha context,
    trained as one batch in one step. A group of ``scale`` scenes draws
    ``scale`` times the frames, as the reference's one replay batch per
    rank. Over data-parallel ranks every rank draws the same frames from
    ``rs`` and reads and trains its contiguous share of them, in one depth
    step of the whole batch. Returns the loss, or None when nothing is
    replayable."""
    n_samples = rt.params.get("n_memory_samples", 4) * max(scale, 1)
    n_context = rt.dcfg.n_alpha + 1 + (
        1 if rt.dcfg.use_future_frame_for_supervision else 0)
    got = memory.sample_depth_replay(
        rs, n_samples, n_context, exclude_traj=memory.current_trajectory())
    if got is None:
        return None
    got = mesh.shard_batch(list(got))
    bs, als = [], []
    for path, traj, last in got:
        b, a = create_batch_for_depth_model(
            rt.dcfg, memory.load_frame_sequence(path, last, n_context, traj),
            "supervision", device=rt.device)
        bs.append(b)
        als.append(a)
    batch = {k: torch.cat([b[k] for b in bs]) for k in bs[0]}
    alpha = {k: torch.cat([a[k] for a in als]) for k in als[0]}
    return rt.depth_train_step(opts.get("depth"), batch, alpha, gen=gen)[0]


def memory_scone_loop(rt: MacaronsRuntime, scene: SceneState, memory: Memory,
                      memory_path: str, opts: Dict, gen: torch.Generator,
                      rs: np.random.Generator, n_loops: int = 1,
                      n_replay_frames: int = 4):
    """SCONE replay on a saved trajectory of this scene: its occupancy
    snapshot gives the pseudo-GT and the carving counters to continue from;
    a random run of saved depths rebuilds a partial world; then ``n_loops``
    windows of n_poses_in_memory_scene_loops depths each take one SCONE
    step, the world growing between windows and the prediction camera
    moving to each window's first view. Returns the last loss, or None."""
    params = rt.params
    n_sup = params.get("n_poses_in_memory_scene_loops", n_replay_frames)
    got = memory.get_random_scene_for_scone(
        rs, memory_path, n_sup, n_loops=n_loops,
        max_build=params.get("n_max_memory_depths_for_partial_pc", 30),
        exclude_traj=memory.current_trajectory(),
        n_proxy_points=scene.proxy.points.shape[0])
    if got is None:
        return None
    traj, build_nbs, info = got
    n_d = info["n_depths"]
    dev = rt.device
    pseudo_gt = torch.as_tensor(info["pseudo_gt"], device=dev)

    n_poses = params.get("n_poses_in_trajectory", 100)
    curr_dists = R.curriculum_sampling_distances(
        max(n_poses, 2), scene.proxy_distance, scene.cfg.cell_size)
    curr_cells = R.curriculum_sampling_cell_number(
        max(n_poses, 2), rt.occ_curriculum_min_cells,
        rt.occ_curriculum_max_cells)
    max_ci = params.get("memory_max_curriculum_index", -1)
    hi_ci = len(curr_dists) if max_ci == -1 else min(max_ci, len(curr_dists))

    replay = copy.copy(scene)
    replay.surface_scene = G.empty_grid(scene.cfg, dev)
    replay.proxy = scene.proxy._replace(
        supervision_occ=torch.ones_like(scene.proxy.supervision_occ),
        view_states=torch.zeros_like(scene.proxy.view_states),
        out_of_field=torch.ones_like(scene.proxy.out_of_field),
        n_inside_fov=torch.as_tensor(info["n_inside_fov"], device=dev),
        n_behind_depth=torch.as_tensor(info["n_behind_depth"], device=dev))

    def load_stack(nbs):
        d = memory.depth_stack(memory_path, traj, nbs)
        return tuple(torch.as_tensor(d[k], device=dev)
                     for k in ("depth", "mask", "error_mask", "R", "T"))

    carving = dict(carving_tolerance=params.get("carving_tolerance", 0.0),
                   score_threshold=params.get("score_threshold", 1.0))
    mapping_update(rt, replay, *load_stack(build_nbs), gen, **carving)

    used = set(build_nbs)
    last_nb = build_nbs[-1]
    box_diag = box_diagonal(scene)
    loss = None
    for i_loop in range(n_loops):
        if params.get("random_poses_in_memory_scene_loops", False):
            pool = [i for i in range(n_d) if i not in used]
            if len(pool) < n_sup - 1:
                break
            picks = rs.choice(len(pool), size=n_sup - 1, replace=False)
            window = [last_nb] + [pool[int(i)] for i in picks]
        else:
            cur = build_nbs[-1] + i_loop * (n_sup - 1)
            window = [last_nb] + [min(cur + j, n_d - 1)
                                  for j in range(1, n_sup)]
        used.update(window)
        depth, mask, err, R_b, T_b = load_stack(window)
        ci = int(rs.integers(0, max(hi_ci, 1)))

        prediction_camera = FoVCamera.create(R_b[0:1], T_b[0:1],
                                             zfar=rt.dcfg.zfar)
        proba, pmask, harmonics = rt.occupancy_field(
            replay.proxy, replay.surface_scene, prediction_camera)
        fld = R.assemble_scene_field(replay.proxy, proba, pmask, harmonics)
        sup = supervision_signal(
            rt, replay, depth, mask, err, R_b, T_b, gen,
            float(curr_dists[ci]), vs_distance=3.0 * scene.proxy_distance,
            **carving)
        if not params.get("memory_supervise_with_online_field", False):
            sup.sup_occ = pseudo_gt
        loss = rt.scone_train_step(
            opts["scone"], sup.proxy, sup.surface, prediction_camera,
            sup.close_mask, sup.visited_cams, sup.visited_X,
            sup.supervision_gains, fld, n_supervision=params.get(
                "n_proxy_point_for_occupancy_supervision", 6000),
            box_diag=box_diag, cell_resolution=scene.cfg.resolution,
            n_cells_active=int(curr_cells[ci]), sup_occ=sup.sup_occ,
            gen=gen)[0]
        last_nb = window[-1]
    return loss


def recompute_mapping(rt: MacaronsRuntime, scene: SceneState, memory: Memory,
                      memory_path: str, gen: torch.Generator):
    """Remap: re-predict the depth of every frame of the trajectory with the
    current network and rebuild the surface grid and the proxy field from
    them; every save_depth_every_n_frame-th depth is saved (numbered in
    order) for SCONE replay."""
    params = rt.params
    dev = rt.device
    scene.surface_scene = G.empty_grid(scene.cfg, dev)
    scene.proxy = P.reset_supervision_occ(scene.proxy)._replace(
        view_states=torch.zeros_like(scene.proxy.view_states),
        out_of_field=torch.ones_like(scene.proxy.out_of_field))
    n_alpha = rt.dcfg.n_alpha
    every = params.get("save_depth_every_n_frame", 1)
    n_saved = 0
    for last in range(n_alpha, memory.n_frames(memory_path)):
        batch, alpha = create_batch_for_depth_model(
            rt.dcfg, memory.load_frame_sequence(memory_path, last,
                                                1 + n_alpha),
            "inference", device=dev)
        depth, mask, err_mask = rt.apply_depth_inference(batch, alpha)
        mapping_update(rt, scene, depth, mask, err_mask, batch["R"],
                       batch["T"], gen,
                       carving_tolerance=params.get("carving_tolerance", 0.0),
                       score_threshold=params.get("score_threshold", 1.0))
        if (last - n_alpha) % every == 0:
            memory.save_depth(memory_path, n_saved, depth, mask, err_mask,
                              batch["R"], batch["T"])
            n_saved += 1


# ---------------------------------------------------------------------------
# Trajectory and epoch loops
# ---------------------------------------------------------------------------


def run_trajectories_parallel(rt: MacaronsRuntime, scenes: List[SceneState],
                              memory: Memory, memory_paths: List[str],
                              opts: Dict, gen: torch.Generator,
                              rs: np.random.Generator, n_poses: int,
                              freeze_scone: bool = False,
                              warmup_phase: bool = False,
                              online_learning: bool = True,
                              n_memory_loops: int = 0,
                              remap_at: Optional[int] = None,
                              verbose: bool = False,
                              on_phase: Optional[Callable] = None,
                              episodes=None):
    """One trajectory in each scene of a group (``run_trajectory`` runs a
    group of one), in lockstep, on one device: the starts as ``episodes``
    (default ``HOST_EPISODES``) draws and primes them, then per
    pose each scene's surface refill every recompute_surface_every_n_loop
    poses, ``nbv_parallel_step``, n_memory_loops depth replays of the
    group's size, SCONE replay scene by scene, and the remap of each scene
    at pose ``remap_at``; at the end each scene's snapshots and poses go to
    the memory. ``on_phase(pose_i, name)`` is called at the group pose's
    phase boundaries (``nbv_parallel_step``'s, then "depth_replay",
    "scone_replay", "remap", "done"). Returns the per-pose losses (one
    entry per group pose); each ``scene.coverages`` gets its pose's
    coverage. Unless ``episodes.read_per_pose`` these stay tensors on the
    card (the epoch reads them after its flush) and ``verbose`` prints
    nothing per pose; else they are floats.

    Over data-parallel ranks ``scenes`` are this rank's contiguous block
    of the group (each rank the same number): each rank decides, moves,
    captures, remaps and writes the memory of its own scenes; the depth
    and SCONE steps are the group's; depth replay draws the group's
    frames from ``rs`` on every rank and trains each rank's share; SCONE
    replay goes scene by scene in group order, the owner's gradient
    broadcast and every rank stepping (``replay_scone_group``). The ranks
    meet before the group's first replay, each rank's queued writes to a
    disk memory landed (a ``DeviceMemory`` holds every rank's past slots
    already: replay never reads the current one)."""
    params = rt.params
    S = len(scenes)
    episodes = episodes or HOST_EPISODES
    if mesh.world() > 1 and n_memory_loops > 0:
        if isinstance(memory, Memory):
            memory.flush()
        distributed.barrier()
    episodes.start(rt, scenes, memory, memory_paths, gen, rs, n_poses)
    curr_dists = [R.curriculum_sampling_distances(
        max(n_poses, 2), s.proxy_distance, s.cfg.cell_size) for s in scenes]
    curr_cells = R.curriculum_sampling_cell_number(
        max(n_poses, 2), rt.occ_curriculum_min_cells,
        rt.occ_curriculum_max_cells)
    every = params.get("recompute_surface_every_n_loop", 20)

    losses = {"depth": [], "occ": [], "cov": []}
    for pose_i in range(n_poses):
        if every > 0 and pose_i > 0 and pose_i % every == 0:
            for scene in scenes:
                pts, valid = G.all_points(scene.surface_scene)
                scene.surface_scene = G.fill_cells_progressive(
                    scene.cfg, G.empty_grid(scene.cfg, rt.device),
                    own_gen(scene, gen), pts, valid)
        step = nbv_parallel_step(
            rt, scenes, memory, memory_paths, opts, gen,
            freeze_scone=freeze_scone, warmup_phase=warmup_phase,
            online_learning=online_learning,
            surface_distances=[float(d[pose_i]) for d in curr_dists],
            n_cells_active=int(curr_cells[pose_i]), on_phase=on_phase,
            pose_i=pose_i, episodes=episodes)
        for k in losses:
            losses[k].append(step[k])

        _phase(on_phase, pose_i, "depth_replay")
        for _ in range(n_memory_loops):
            memory_depth_loop(rt, memory, opts, gen, rs,
                              scale=S * mesh.world())
        _phase(on_phase, pose_i, "scone_replay")
        if online_learning and not freeze_scone \
                and params.get("n_memory_scene_loops", 0) > 0:
            replay_scone_group(rt, scenes, memory, memory_paths, opts, gen,
                               rs)
        _phase(on_phase, pose_i, "remap")
        if remap_at is not None and pose_i == remap_at:
            for scene, mp in zip(scenes, memory_paths):
                recompute_mapping(rt, scene, memory, mp, own_gen(scene, gen))
        for scene in scenes:
            cov, _ = G.scene_coverage(scene.cfg, scene.gt_scene,
                                      scene.surface_scene)
            scene.coverages.append(episodes.read(cov))
        _phase(on_phase, pose_i, "done")
        if verbose and episodes.read_per_pose:
            shown = {k: float(v[-1]) for k, v in losses.items()}
            covs = [f"{s.coverages[-1]:.4f}" for s in scenes]
            print(f"  pose {pose_i}: losses {shown} coverages {covs}")

    for scene, mp in zip(scenes, memory_paths):
        memory.save_surface_scene(mp, scene.surface_scene)
        memory.save_occupancy_field(mp, scene.proxy)
        episodes.save_poses(scene, memory, mp)
    return {k: [episodes.read(v) for v in vs] for k, vs in losses.items()}


def replay_scone_group(rt: MacaronsRuntime, scenes: List[SceneState],
                       memory: Memory, memory_paths: List[str], opts: Dict,
                       gen: torch.Generator, rs: np.random.Generator):
    """SCONE replay scene by scene in group order (``memory_scone_loop``,
    each scene drawing from its own streams). Over data-parallel ranks the
    group's scenes go rank by rank: the owner of a scene computes each
    step's gradient and broadcasts it, and every rank takes the step, so
    the weights stay equal."""
    params = rt.params
    kw = dict(n_loops=params.get("n_memory_scene_loops", 0),
              n_replay_frames=rt.n_interpolation_steps)
    for owner in range(mesh.world()):
        if owner != mesh.rank():
            for _ in scenes:
                rt.follow_scone_steps(opts["scone"], owner)
            continue
        for scene, mp in zip(scenes, memory_paths):
            rt.bind_scene(scene.cfg, scene.cell_table)
            rt.scone_owner = owner if mesh.world() > 1 else None
            try:
                memory_scone_loop(rt, scene, memory, mp, opts,
                                  own_gen(scene, gen), own_rs(scene, rs),
                                  **kw)
            finally:
                rt.scone_owner = None
            if mesh.world() > 1:
                rt.end_scone_replay()


def run_trajectory(rt: MacaronsRuntime, scene: SceneState, memory: Memory,
                   memory_path: str, opts: Dict, gen: torch.Generator,
                   rs: np.random.Generator, n_poses: int, **kw):
    """One trajectory of n_poses NBV steps in one scene: the
    ``run_trajectories_parallel`` of a group of one, its phases named
    "decision", "capture", "depth_step", "scone_step", "depth_replay",
    "scone_replay", "remap" and "done". Returns the per-pose losses
    {"depth", "occ", "cov"} (tensors with ``DEVICE_EPISODES``, else
    floats); ``scene.coverages`` gets each pose's coverage."""
    return run_trajectories_parallel(rt, [scene], memory, [memory_path],
                                     opts, gen, rs, n_poses, **kw)


def seeded_generator(device, *seeds) -> torch.Generator:
    """A generator on ``device`` seeded from a tuple of integers."""
    seed = int(np.random.SeedSequence([int(s) for s in seeds])
               .generate_state(1, np.uint64)[0] >> 1)
    return torch.Generator(device=device).manual_seed(seed)


def scene_group_size(params: Params) -> int:
    """``n_parallel_scenes``, the number of scenes trained at once. A
    pinned ``n_devices`` that does not divide the group raises, as in the
    JAX package."""
    group = params.get("n_parallel_scenes", 1) or 1
    pinned = params.get("n_devices")
    if group > 1 and pinned and group % pinned != 0:
        raise ValueError(
            f"n_parallel_scenes={group} does not divide over the "
            f"pinned n_devices={pinned}; the scene axis must shard "
            f"evenly")
    return group


def group_ranks(params: Params, n_cards: int) -> int:
    """The ranks (one per card) a run's scene groups spread over, as the
    JAX package sizes its mesh: the pinned ``n_devices``, else the largest
    divisor of the group within ``n_cards``; 1 for one scene at a time."""
    group = scene_group_size(params)
    if group == 1:
        return 1
    pinned = params.get("n_devices")
    if pinned:
        return int(pinned)
    return max(d for d in range(1, min(group, n_cards) + 1)
               if group % d == 0)


def check_group_ranks(params: Params, world: int, n_scenes: int):
    """Raise unless an epoch's scene groups (``n_scenes`` scenes) divide
    over ``world`` data-parallel ranks (a pinned ``n_devices`` must be the
    world). A trailing group of one scene runs on rank 0 alone; a larger
    one must split over the ranks too, as the JAX package's mesh must
    shard it."""
    if world == 1:
        return
    group = scene_group_size(params)
    pinned = params.get("n_devices")
    if group % world != 0:
        raise ValueError(
            f"n_parallel_scenes={group} does not divide over the {world} "
            f"ranks; launch group_ranks(params, cards) ranks")
    trailing = n_scenes % group
    if trailing > 1 and trailing % world != 0:
        raise ValueError(
            f"an epoch of {n_scenes} scenes ends in a group of {trailing}, "
            f"which does not divide over the {world} ranks; train a number "
            f"of scenes (max_scenes_per_epoch) whose last group has one "
            f"scene or a multiple of {world}")
    if pinned and pinned != world:
        raise ValueError(f"n_devices={pinned} is pinned but {world} ranks "
                         f"run")


def group_owners(n_members: int, world: int) -> List[int]:
    """The rank that trains each of a scene group's ``n_members`` scenes:
    contiguous blocks of n_members / world, or rank 0 for all of a
    trailing group that does not split (``check_group_ranks``)."""
    if n_members % world != 0:
        return [0] * n_members
    return [i // (n_members // world) for i in range(n_members)]


def exchange_device_memory(memory: DeviceMemory, owners: Dict[str, int],
                           verbose: bool = False) -> Dict:
    """The device memory's epoch end: each rank (or the one process)
    writes the (scene, current slot) keys that it captured this epoch
    (``owners``: scene memory path -> rank; the memory's other keys are on
    disk since their own epoch or the resume), the ranks meet, and each
    loads the keys of the others from those files, so every rank holds
    what one process's memory holds. With a host tier the captured keys
    first move to their host slots where their scenes have room, and are
    written from there (one copy from the card serves both); the loaded
    keys land in the host tier likewise. Returns the exchange's seconds,
    the bytes this rank moved to the host, wrote and read, and the keys
    it loaded."""
    t0 = time.perf_counter()
    me, slot = mesh.rank(), memory.current_trajectory()
    mine = [(p, slot) for p, r in owners.items() if r == me]
    theirs = [(p, slot) for p, r in owners.items() if r != me]
    moved = memory.move_to_host(mine)
    written = memory.flush_to_disk(mine)
    # Every rank's files are written before any rank reads them.
    distributed.barrier()
    read = memory.load_from_disk(theirs)
    out = {"seconds": time.perf_counter() - t0, "moved": moved,
           "written": written, "read": read, "loaded": theirs}
    if verbose:
        print(f"epoch {memory.current_epoch}, rank {me}: device memory "
              f"exchange {out['seconds']:.2f} s, {moved / 1e9:.3f} GB "
              f"moved to the host, {written / 1e9:.3f} GB written, "
              f"{read / 1e9:.3f} GB read ({len(theirs)} slots)")
    return out


def sync_training_state(rt: "MacaronsRuntime", opts: Dict, src: int,
                        extra=None):
    """Rank ``src``'s networks, optimizer states, step counters and
    ``extra`` (any picklable value) on every rank; returns ``extra``."""
    model = rt.model
    state = None
    if mesh.rank() == src:
        state = {"nets": {k: getattr(model, k).state_dict()
                          for k in ("depth", "occ", "vis")
                          if getattr(model, k) is not None},
                 "opts": {k: v.state_dict() for k, v in opts.items()
                          if v is not None},
                 "steps": (rt.depth_opt_steps, rt.scone_opt_steps),
                 "extra": extra}
    state = mesh.broadcast_object(state, src)
    if mesh.rank() != src:
        for k, sd in state["nets"].items():
            getattr(model, k).load_state_dict(sd)
        for k, sd in state["opts"].items():
            opts[k].load_state_dict(sd)
        rt.depth_opt_steps, rt.scone_opt_steps = state["steps"]
    return state["extra"]


# The card's bytes a training pose takes beside the models and the device
# memory's stores: the default training config's pose peaked at 34-37 GiB
# on an H100 (PERF.md, section 5), models and the smoke's small stores
# included; a scene group of 2 at 33.68 GiB.
DEVICE_MEMORY_HEADROOM_GIB = 36.0


def host_memory_available() -> int:
    """The bytes this host can still give (``MemAvailable`` of
    /proc/meminfo)."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("/proc/meminfo has no MemAvailable")


def device_memory_plan(memory: DeviceMemory,
                       headroom_gib: float = DEVICE_MEMORY_HEADROOM_GIB
                       ) -> Dict:
    """Where ``memory``'s stores can live beside training, decided before
    anything is stored, with the figures it was decided on. "card": every
    (scene, slot) on the card, when the stores plus ``headroom_gib`` GiB
    for training, times the ranks that share this card
    (``mesh.ranks_on_device``: each holds a whole memory), fit what the
    card has free now (its free bytes and this rank's allocator's cached
    ones). Else "host tier": one slot a
    scene on the card and the others in host slots, when that fits the
    card so and the host slots of every rank on this host
    (``mesh.ranks_on_host``) fit its available memory. Else None. Off the
    card nothing is asked: "card"."""
    dev = memory.device
    if dev.type != "cuda":
        return {"placement": "card"}
    sharing, host_ranks = mesh.ranks_on_device(), mesh.ranks_on_host()
    free, _ = torch.cuda.mem_get_info(dev)
    free += torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev)
    headroom = int(headroom_gib * 2 ** 30)
    scenes, slot = len(memory.scene_memory_paths), memory.slot_nbytes()
    plan = {"sharing": sharing, "host_ranks": host_ranks, "card_free": free,
            "headroom": headroom, "stores": memory.full_nbytes(),
            "card_stores": scenes * slot,
            "host_stores": scenes * (memory.n_trajectories - 1) * slot,
            "host_free": host_memory_available()}
    plan["all_card"] = sharing * (plan["stores"] + headroom)
    plan["tiered_card"] = sharing * (plan["card_stores"] + headroom)
    plan["tiered_host"] = host_ranks * plan["host_stores"]
    if plan["all_card"] <= free:
        plan["placement"] = "card"
    elif (memory.n_trajectories > 1 and plan["tiered_card"] <= free
          and plan["tiered_host"] <= plan["host_free"]):
        plan["placement"] = "host tier"
    else:
        plan["placement"] = None
    return plan


def check_device_memory_fits(memory: DeviceMemory,
                             headroom_gib: float = DEVICE_MEMORY_HEADROOM_GIB
                             ) -> str:
    """``device_memory_plan``'s placement ("card" or "host tier"); raises
    if neither fits, naming the figures. The stores are allocated a slot
    at a time as trajectories begin, so without this a run that does not
    fit fails epochs in."""
    plan = device_memory_plan(memory, headroom_gib)
    if plan["placement"] is not None:
        return plan["placement"]
    gib = 2 ** 30
    sharing = plan["sharing"]
    on_card = f" for each of the {sharing} ranks on the card" \
        if sharing > 1 else ""
    on_host = f" for each of the {plan['host_ranks']} ranks on this host" \
        if plan["host_ranks"] > 1 else ""
    tiered = (
        f"; with one slot a scene on the card it needs "
        f"{plan['card_stores'] / gib:.2f} GiB there{on_card} and "
        f"{plan['host_stores'] / gib:.2f} GiB of host memory{on_host}, "
        f"and the host has {plan['host_free'] / gib:.2f} GiB available"
        if memory.n_trajectories > 1 else "")
    raise RuntimeError(
        f"the device memory needs {plan['stores'] / gib:.2f} GiB for "
        f"{len(memory.scene_memory_paths)} scenes x "
        f"{memory.n_trajectories} trajectory slots of "
        f"{memory.max_frames} frames, and training about "
        f"{plan['headroom'] / gib:.1f} GiB more{on_card}, but "
        f"the card has {plan['card_free'] / gib:.2f} GiB free{tiered}: set "
        f'"device_memory": false to keep the replay memory on disk, or '
        f"train fewer scenes, slots or poses")


def run_training(params: Params, data_path: Optional[str] = None,
                 weights_dir: str = "weights/macarons",
                 memory_root: Optional[str] = None,
                 max_scenes_per_epoch: Optional[int] = None,
                 device="cuda", verbose: bool = True,
                 on_phase: Optional[Callable] = None):
    """The online trainer on ``device`` ("cuda" unless the caller
    asks for the CPU). Epoch e draws from numpy's default_rng([random_seed,
    e]) and a torch generator seeded from (torch_seed, e), so a run resumed
    at epoch e draws what one process reaching e draws; with
    ``max_epochs_per_process`` it stops after that many epochs, its resume
    checkpoint written (the CLI's --restart-per-epoch). The replay memory
    is a ``DeviceMemory`` sized for a trajectory (1 + n_alpha + poses x
    interpolation steps frames, as many depths), hydrated from the memory
    directories on resume and written to them at the end of every epoch,
    unless ``device_memory`` is false: then a disk ``Memory`` per epoch.
    Where every slot's stores would not fit on the card beside training,
    each scene's older slots go to a host tier (``device_memory_plan``);
    where even that does not fit, the run raises at once
    (``check_device_memory_fits``). Validation always uses a
    disk ``Memory``. ``on_phase``, if given, is
    handed to every training trajectory (see run_trajectory) as
    ``on_phase(epoch, pose_i, name)``. Each scene of an epoch draws its
    set-up and trajectory from streams of its own, seeded by (torch_seed,
    epoch, index) and (random_seed, epoch, index).

    In a group of W data-parallel ranks (``parallel.distributed``; the
    ``train`` CLI starts them) each scene group splits into W contiguous
    blocks, one per rank (``check_group_ranks``): every rank draws the
    epoch's order and mirroring, sets up and trains its own block, and
    the steps are the group's (``run_trajectories_parallel``); a trailing
    group of one scene runs on rank 0 alone and its state goes to every
    rank. With the device memory every rank holds every scene's slots: at
    the epoch's end each writes the slots it captured and loads the
    others' (``exchange_device_memory``). Rank 0 validates and writes the
    checkpoints, and every rank reads them. While rank 0 works alone, the
    others wait in ``distributed.await_lone_work``, which the group's
    timeout does not bound. Returns (model, per-epoch mean losses)."""
    dev = resolve_device(device)
    data_path = data_path or params.data_path
    group = scene_group_size(params)
    world = mesh.world()
    dataset = SceneDataset(data_path)
    check_group_ranks(params, world, min(len(dataset), max_scenes_per_epoch
                                         or len(dataset)))
    per_rank = verbose
    verbose = verbose and distributed.is_master()
    seed = params.get("random_seed", 42)
    torch_seed = params.get("torch_seed", 5)
    model = create_macarons_model(params, dev)
    init_macarons_weights(model, seeded_generator(dev, torch_seed))
    if params.get("vis_init_path"):
        # SconeVis's starting weights, a SconeVis variables msgpack; a
        # relative path is the repo's.
        load_module_weights(model.vis, os.path.join(REPO_DIR,
                                                    params.vis_init_path))
    opts = create_optimizers(params, model)

    name = params.get("macarons_model_name", "macarons")
    start_epoch = 0
    best_loss = float("inf")
    depth_losses_per_epoch: List[float] = []
    all_train_losses: List[Dict] = []
    n_freeze = params.get("n_freeze_epochs", 0)
    warmup_epochs = params.get("warmup_phase",
                               params.get("warmup_phase_epochs", 0))

    def resolve(p: str) -> str:
        if p.endswith(".pth") or p.endswith(".msgpack") or p.endswith(".pt"):
            p = p.rsplit(".", 1)[0]
        if not os.path.isabs(p) and not checkpoint_exists(p):
            q = os.path.join(weights_dir, p)
            if checkpoint_exists(q):
                return q
        return p

    pretrained_path = params.get("pretrained_model_path")
    pretrained_path = resolve(pretrained_path) if pretrained_path else None

    def load_pretrained():
        if (params.get("pretrained", False) and pretrained_path
                and checkpoint_exists(pretrained_path)):
            load_macarons(pretrained_path, model)
            if verbose:
                print(f"loaded pretrained weights from {pretrained_path}")

    rt = MacaronsRuntime(params, model, device=dev)
    resume_path = os.path.join(weights_dir, f"unvalidated_{name}")
    if params.get("start_from_scratch", True):
        load_pretrained()
    elif checkpoint_exists(resume_path):
        meta = load_macarons(resume_path, model, opts)
        start_epoch = int(meta.get("epoch", 0))
        best_loss = float(meta.get("best_loss", best_loss))
        all_train_losses = list(meta.get("train_losses", []))
        depth_losses_per_epoch = [float(x)
                                  for x in meta.get("depth_losses", [])]
        rt.depth_opt_steps = int(meta.get("depth_opt_steps", 0))
        rt.scone_opt_steps = int(meta.get("scone_opt_steps", 0))
        if verbose:
            print(f"resumed from {resume_path} at epoch {start_epoch}")
    else:
        raise FileNotFoundError(
            f"start_from_scratch is false but no checkpoint at {resume_path}")
    for net in (model.depth, model.occ, model.vis):
        if net is not None:
            mesh.broadcast_module(net)
    best_val_coverage = -1.0
    if start_epoch > 0:
        # A resumed run goes on as one process would have (the train CLI's
        # --restart-per-epoch): its resume point was written before that
        # epoch's depth loss could become the best (as in the JAX
        # package), the best validation coverage is coverage_validated_'s,
        # and a run resumed at n_freeze_epochs unfreezes there.
        if depth_losses_per_epoch:
            best_loss = min(best_loss, depth_losses_per_epoch[-1])
        validated = os.path.join(weights_dir,
                                 f"coverage_validated_{name}.json")
        if os.path.exists(validated):
            with open(validated) as f:
                best_val_coverage = float(json.load(f)["val_coverage"])
    begin_frozen = n_freeze > 0 and start_epoch <= n_freeze

    mem_root = memory_root or data_path
    mem_dir = params.get("memory_dir_name", "macarons_memory")
    all_paths = [os.path.join(mem_root, dataset[i]["scene_name"], mem_dir)
                 for i in range(len(dataset))]
    n_poses = params.get("n_poses_in_trajectory", 100)
    dmem = None
    episodes = HOST_EPISODES
    if params.get("device_memory", True):
        traj_frames = (1 + params.get("n_alpha", 2)
                       + n_poses * params.get("n_interpolation_steps", 4))
        dmem = DeviceMemory(
            all_paths, current_epoch=start_epoch,
            n_trajectories=params.get("n_memory_trajectories", 1),
            max_frames=traj_frames, max_depths=max(traj_frames, 1),
            height=params.get("image_height", 256),
            width=params.get("image_width", 456),
            zfar=params.get("zfar", 750.0), device=dev)
        placement = check_device_memory_fits(dmem)
        if placement == "host tier":
            dmem.enable_host_tier()
        if verbose:
            print(f"device memory: {dmem.full_nbytes() / 2 ** 30:.2f} GiB of "
                  f"stores, placed: {placement}")
        episodes = DEVICE_EPISODES
        if not params.get("start_from_scratch", True):
            dmem.hydrate_from_disk()
    common = dict(online_learning=params.get("online_learning", True),
                  n_memory_loops=params.get("n_memory_loops", 0),
                  remap_at=params.get("remap_every_n_poses",
                                      params.get("remap_at_pose")),
                  verbose=verbose, episodes=episodes)

    # max_epochs_per_process caps the epochs this process trains (the train
    # CLI's --restart-per-epoch runs each epoch in a process of its own).
    end_epoch = params.get("epochs", 1)
    if params.get("max_epochs_per_process"):
        end_epoch = min(end_epoch,
                        start_epoch + int(params.max_epochs_per_process))
    for epoch in range(start_epoch, end_epoch):
        t0 = time.time()
        rs = np.random.default_rng([seed, epoch])
        gen = seeded_generator(dev, torch_seed, epoch)
        epoch_losses = {"depth": [], "occ": [], "cov": []}
        freeze_scone = epoch < n_freeze
        warmup = epoch < warmup_epochs

        if begin_frozen and not freeze_scone:
            # Unfreeze: pretrained weights again, fresh optimizers.
            if verbose:
                print(f"epoch {epoch}: unfreezing all weights")
            load_pretrained()
            opts = create_optimizers(params, model)
            rt.depth_opt_steps = rt.scone_opt_steps = 0
            best_loss = float("inf")
            begin_frozen = False

        rt.update_learning_rates(epoch)
        scene_indices = rs.permutation(len(dataset))
        if max_scenes_per_epoch:
            scene_indices = scene_indices[:max_scenes_per_epoch]
        if dmem is not None:
            dmem.current_epoch = epoch
            memory = dmem
        else:
            memory = Memory(all_paths, current_epoch=epoch,
                            n_trajectories=params.get("n_memory_trajectories",
                                                      1))
        hook = (None if on_phase is None else
                lambda pose_i, phase, e=epoch: on_phase(e, pose_i, phase))

        def mirroring():
            sym_p = params.get("symmetry_probability", 0.5)
            return ([a for a in params.get("axis_to_mirror", [0, 1])
                     if rs.random() < sym_p]
                    if params.get("random_mirror_scenes", True) else None)

        owners = {}  # scene memory path -> the rank training it

        def make_scene(si, mirrored):
            item = dataset[int(si)]
            scene_gen = seeded_generator(dev, torch_seed, epoch, si)
            scene = setup_scene(params, item, scene_gen, dev,
                                mirrored_axes=mirrored)
            # The trajectory continues the set-up's generator.
            scene.gen = scene_gen
            scene.rs = np.random.default_rng([seed, epoch, int(si)])
            return scene, os.path.join(mem_root, item["scene_name"], mem_dir)

        for g0 in range(0, len(scene_indices), group):
            # Every scene of a group has its mirroring drawn from rs, on
            # every rank, before any is set up; a rank sets up its own
            # block of the group, and a trailing group of one scene runs
            # on rank 0 alone (check_group_ranks).
            members = [(si, mirroring()) for si in
                       scene_indices[g0:g0 + group]]
            alone = world > 1 and len(members) % world != 0
            ranks = group_owners(len(members), world)
            owners.update({all_paths[int(si)]: r
                           for (si, _), r in zip(members, ranks)})
            mine = [m for m, r in zip(members, ranks) if r == mesh.rank()]
            kw = dict(freeze_scone=freeze_scone, warmup_phase=warmup,
                      on_phase=hook, **common)
            traj = None
            if mine:
                scenes, mps = zip(*[make_scene(si, m) for si, m in mine])
                with (distributed.local() if alone
                      else contextlib.nullcontext()):
                    if len(members) > 1:
                        traj = run_trajectories_parallel(
                            rt, list(scenes), memory, list(mps), opts, gen,
                            rs, n_poses, **kw)
                    else:
                        traj = run_trajectory(rt, scenes[0], memory, mps[0],
                                              opts, gen, rs, n_poses=n_poses,
                                              **kw)
                    if alone:
                        # The other ranks wait for these losses as floats.
                        if dmem is None:
                            memory.flush()
                        traj = {k: [float(v) for v in vs]
                                for k, vs in traj.items()}
            if alone:
                distributed.await_lone_work()
                traj, rs_state, gen_state = sync_training_state(
                    rt, opts, 0, (traj, rs.bit_generator.state,
                                  gen.get_state().cpu()))
                rs.bit_generator.state = rs_state
                gen.set_state(gen_state)
            for k in epoch_losses:
                epoch_losses[k] += traj[k]
            if verbose and mine and episodes.read_per_pose:
                covs = ", ".join(f"{s.name} {s.coverages[-1]:.4f}"
                                 for s in scenes)
                print(f"epoch {epoch}: final coverage {covs}")
            elif verbose and mine:
                print(f"epoch {epoch}: {[s.name for s in scenes]} done (the "
                      f"losses are read at the end of the epoch)")

        # The epoch's end: the device memory goes to disk and takes in the
        # other ranks' slots (the disk memory's queued writes land), then
        # the losses come to the host.
        if dmem is not None:
            exchange_device_memory(dmem, owners, per_rank)
        else:
            memory.flush()
            # Every rank's files are written before any rank reads them.
            distributed.barrier()
        epoch_losses = {k: [float(v) for v in vs]
                        for k, vs in epoch_losses.items()}
        mean_depth = (float(np.mean(epoch_losses["depth"]))
                      if epoch_losses["depth"] else 0.0)
        all_train_losses.append({k: float(np.mean(v)) if v else 0.0
                                 for k, v in epoch_losses.items()})
        depth_losses_per_epoch.append(mean_depth)

        def validate(names):
            """Rank 0's validation run (no collectives): the mean of each
            validation scene's final coverage, or None."""
            covs = []
            with distributed.local():
                for vname in names:
                    if vname not in dataset.scene_names:
                        continue
                    item = dataset[dataset.scene_names.index(vname)]
                    vscene = setup_scene(params, item, gen, dev)
                    vpath = os.path.join(mem_root, vname,
                                         "macarons_memory_val")
                    run_trajectory(rt, vscene,
                                   Memory([vpath], current_epoch=epoch),
                                   vpath, opts, gen, rs,
                                   n_poses=params.get("n_val_poses", 10),
                                   online_learning=False)
                    covs.append(vscene.coverages[-1])
            return float(np.mean(covs)) if covs else None

        val_coverage = None
        val_scenes = params.get("val_scenes")
        if (val_scenes and params.get("validate_every_n_epochs", 0) > 0
                and (epoch + 1) % params["validate_every_n_epochs"] == 0):
            val_coverage = validate(val_scenes) if distributed.is_master() \
                else None
            distributed.await_lone_work()
            val_coverage = mesh.broadcast_object(val_coverage, 0)
            if val_coverage is not None and verbose:
                print(f"epoch {epoch}: val coverage {val_coverage:.4f}")

        meta = {"epoch": epoch + 1, "depth_losses": depth_losses_per_epoch,
                "train_losses": all_train_losses, "best_loss": best_loss,
                "val_coverage": val_coverage,
                "depth_opt_steps": rt.depth_opt_steps,
                "scone_opt_steps": rt.scone_opt_steps}
        if distributed.is_master():
            os.makedirs(weights_dir, exist_ok=True)
            with open(os.path.join(weights_dir, f"losses_data_{name}.json"),
                      "w") as f:
                json.dump({"train_losses": all_train_losses,
                           "depth_losses": depth_losses_per_epoch}, f,
                          indent=2)
        # The rolling resume point keeps the optimizers; the other flavours
        # are weights only.
        save_macarons(os.path.join(weights_dir, f"unvalidated_{name}"),
                      model, meta, opt_states=opts)
        if mean_depth < best_loss:
            best_loss = meta["best_loss"] = mean_depth
            save_macarons(os.path.join(weights_dir, f"best_unval_{name}"),
                          model, meta)
        if val_coverage is not None and val_coverage > best_val_coverage:
            best_val_coverage = val_coverage
            save_macarons(os.path.join(weights_dir,
                                       f"coverage_validated_{name}"),
                          model, meta)
        if (epoch + 1) % params.get("save_model_every_n_epoch", 1) == 0 \
                or epoch + 1 == params.get("epochs", 1):
            save_macarons(os.path.join(weights_dir, f"epoch_{epoch}_{name}"),
                          model, meta)

        # Loss peak: the depth network goes back to the newest periodic
        # checkpoint before this epoch; SCONE keeps its weights.
        thr = params.get("loss_peak_threshold", 0.015)
        if (len(depth_losses_per_epoch) >= 2 and model.depth is not None
                and depth_losses_per_epoch[-1]
                > depth_losses_per_epoch[-2] + thr):
            for prev_epoch in range(epoch - 1, -1, -1):
                prev = os.path.join(weights_dir, f"epoch_{prev_epoch}_{name}")
                if checkpoint_exists(prev):
                    load_macarons_depth(prev, model)
                    if verbose:
                        print(f"loss peak at epoch {epoch}: depth network "
                              f"rolled back to epoch {prev_epoch}")
                    break
        if verbose:
            print(f"epoch {epoch} done in {time.time() - t0:.1f}s: "
                  f"{all_train_losses[-1]}")
    return model, all_train_losses


def load_macarons_depth(path: str, model: MacaronsModel):
    """The depth network of checkpoint ``path``, SCONE untouched."""
    keep = (copy.deepcopy(model.occ.state_dict()),
            copy.deepcopy(model.vis.state_dict()))
    load_macarons(path, model)
    model.occ.load_state_dict(keep[0])
    model.vis.load_state_dict(keep[1])
