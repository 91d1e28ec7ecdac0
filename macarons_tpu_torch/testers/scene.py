"""Scene exploration evaluation: frozen-weights NBV trajectories with true
coverage (port of macarons_tpu/testers/scene.py).

At every pose the ground-truth zbuf is backprojected into a ``covered_scene``
grid and scored against the GT surface grid. The results JSON has the JAX
tester's layout: ``{scene: {start: {coverage, X_cam, V_cam, cam_idx}}}``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import Params
from ..data.scenes import SceneDataset
from ..models.macarons import create_macarons_model, \
    init_macarons_weights, load_macarons
from ..ops.geometry import FoVCamera
from ..ops.projection import points_in_fov_mask, project_depth_back_to_3D
from ..scene import grid as G
from ..scene import proxy as P
from ..scene import runtime as R
from ..scene.depth_runtime import create_batch_for_depth_model
from ..scene.memory import Memory
from ..trainers.train_macarons import (
    MacaronsRuntime,
    SceneState,
    backtrack_pose,
    candidate_cameras,
    capture_and_save,
    mapping_update,
    move_and_capture,
    nbv_choice,
    scene_field,
    setup_scene,
)
from ..utils.checkpoint import checkpoint_exists
from ..utils.convert import load_module_weights
from ..utils.device import make_generator, resolve_device
from ..utils.export import export_point_cloud_ply, export_trajectory_blender


def true_coverage_update(scene: SceneState, covered_scene: G.GridState,
                         gt_depth, R_b, T_b, gen: torch.Generator, zfar,
                         surface_epsilon):
    """Backproject the GT zbuf into covered_scene, then GT recall."""
    cam = FoVCamera.create(R_b, T_b, zfar=zfar)
    pts, pmask = project_depth_back_to_3D(gt_depth, cam)
    for i in range(gt_depth.shape[0]):
        good = pmask[i] & (gt_depth[i].reshape(-1) > 0)
        covered_scene = G.fill_cells(scene.cfg, covered_scene, gen, pts[i],
                                     good)
    cov, _ = G.scene_coverage(scene.cfg, scene.gt_scene, covered_scene,
                              surface_epsilon=surface_epsilon)
    return float(cov), covered_scene


def _depth_step(rt: MacaronsRuntime, scene: SceneState, memory: Memory,
                memory_path: str, n_frames: int, mode: str,
                gen: torch.Generator):
    """Load the newest frames, read their depth and map them."""
    cam = scene.camera
    frames = memory.load_frame_sequence(memory_path, cam.n_frames_captured - 1,
                                        n_frames)
    batch, alpha = create_batch_for_depth_model(rt.dcfg, frames, mode,
                                                device=rt.device)
    depth, mask, err_mask = rt.apply_depth_inference(batch, alpha)
    params = rt.params
    mapping_update(rt, scene, depth, mask, err_mask, batch["R"], batch["T"],
                   gen, carving_tolerance=params.get("carving_tolerance", 0.0),
                   score_threshold=params.get("score_threshold", 1.0))


def compute_trajectory(rt: MacaronsRuntime, scene: SceneState, memory: Memory,
                       memory_path: str, gen: torch.Generator, rs, n_poses: int,
                       surface_epsilon: float, use_collision: bool = False,
                       start_idx: Optional[np.ndarray] = None,
                       policy: str = "nbv", verbose: bool = False,
                       on_pose=None):
    """One frozen-weights exploration trajectory.

    ``policy``: "nbv" (occupancy field + SconeVis coverage gains), "random"
    (uniform valid neighbour, drawn from the numpy ``rs``) or "carving"
    (summed carving occupancy of never-observed proxies in each candidate's
    FoV). A lattice dead end backtracks to the previous pose. ``on_pose``,
    if given, is called as ``on_pose(pose_i, phase)`` at each step's phase
    boundaries: "decision" (depth + mapping), "field" (occupancy field),
    "score" (candidates and their gains), "capture" (move, capture, true
    coverage and mapping) and "done".
    Returns the results dict of the trajectory."""
    params = rt.params
    dev = rt.device
    cam = scene.camera
    if start_idx is None:
        start_idx = cam.get_random_valid_pose(rs, scene.verts_dev,
                                              proxy_points=scene.proxy.points)
    cam.initialize(np.asarray(start_idx))

    covered_scene = G.empty_grid(scene.cfg, dev)
    coverages: List[float] = []
    gt_depths = []
    for _ in range(1 + rt.dcfg.n_alpha):
        _, depth, _ = capture_and_save(scene, memory, memory_path)
        gt_depths.append((depth, cam.fov_camera.R, cam.fov_camera.T))
    for depth, R_b, T_b in gt_depths:
        cov, covered_scene = true_coverage_update(
            scene, covered_scene, depth, R_b, T_b, gen, rt.dcfg.zfar,
            surface_epsilon)
    coverages.append(cov)

    for pose_i in range(n_poses):
        if on_pose is not None:
            on_pose(pose_i, "decision")
        cam.fov_camera_0 = cam.fov_camera
        _depth_step(rt, scene, memory, memory_path, 1 + rt.dcfg.n_alpha,
                    "inference", gen)

        if on_pose is not None:
            on_pose(pose_i, "field")
        if policy == "nbv":
            # Decoupling fixture: use_supervision_occ puts the carving
            # pseudo-GT in place of the predicted field.
            field = scene_field(rt, scene,
                                params.get("use_supervision_occ", False))

        if on_pose is not None:
            on_pose(pose_i, "score")
        valid_nbrs = cam.get_valid_neighbors(cam.get_neighboring_poses(),
                                             scene.verts_dev)
        if use_collision and len(valid_nbrs) > 1:
            X_now = torch.as_tensor(cam.X_cam[0], device=dev)
            keep = [idx for idx in valid_nbrs if not P.camera_collides(
                scene.proxy, scene.cfg.x_min, scene.cfg.x_max, X_now,
                torch.as_tensor(cam.pose_space.pose_from_idx(idx)[:3],
                                device=dev),
                scene.proxy_distance,
                n_interpolation_steps=max(cam.n_interpolation_steps, 2))]
            if keep:
                valid_nbrs = np.stack(keep)

        if len(valid_nbrs) == 0:
            next_idx = backtrack_pose(cam)
        elif policy == "random":
            next_idx = valid_nbrs[int(rs.integers(len(valid_nbrs)))]
        elif policy == "carving":
            cand_cams, X_cand, n_cand = candidate_cameras(rt, cam, valid_nbrs)
            in_fov = points_in_fov_mask(
                scene.proxy.points[None].expand(X_cand.shape[0],
                                                *scene.proxy.points.shape),
                cand_cams, rt.H, rt.W, fov_range=rt.sensor_range)
            unseen = scene.proxy.view_states.sum(dim=-1) == 0
            gains = torch.where(in_fov & unseen[None],
                                scene.proxy.supervision_occ[None, :, 0],
                                0.0).sum(dim=-1)[:n_cand]
            next_idx = valid_nbrs[int(torch.argmax(gains))]
        else:
            next_idx = nbv_choice(rt, scene, field, valid_nbrs, gen)

        if on_pose is not None:
            on_pose(pose_i, "capture")
        _, gt_depth, _, batch_cam = move_and_capture(scene, memory,
                                                     memory_path, next_idx)
        cov, covered_scene = true_coverage_update(
            scene, covered_scene, gt_depth, batch_cam.R, batch_cam.T, gen,
            rt.dcfg.zfar, surface_epsilon)
        coverages.append(cov)

        _depth_step(rt, scene, memory, memory_path,
                    rt.n_interpolation_steps + rt.dcfg.n_alpha_for_supervision,
                    "supervision", gen)
        if on_pose is not None:
            on_pose(pose_i, "done")
        if verbose:
            print(f"  pose {pose_i}: true coverage {cov:.4f}")

    return {
        "coverage": coverages,
        "X_cam": np.concatenate(cam.X_cam_history, 0).tolist(),
        "V_cam": np.concatenate(cam.V_cam_history, 0).tolist(),
        "cam_idx": np.stack(cam.cam_idx_history, 0).tolist(),
    }


def export_trajectory(scene: SceneState, params: Params, export_dir: str,
                      prefix: str = "", jump_poses: int = 1):
    """The trajectory's Blender camera curves (``<prefix>cameras.json``:
    every ``jump_poses``-th frame's pose from the n_interpolation_steps-th
    frame on) and its reconstructed surface (``<prefix>surface.ply``, the
    surface grid's valid points) under ``export_dir``. Returns the two
    paths."""
    cam = scene.camera
    pts, valid = G.all_points(scene.surface_scene)
    return (export_trajectory_blender(
                os.path.join(export_dir, f"{prefix}cameras.json"),
                np.concatenate(cam.X_cam_history, 0),
                np.concatenate(cam.V_cam_history, 0),
                cam.n_interpolation_steps,
                params.get("scene_scale_factor", 1.0),
                jump_poses=jump_poses),
            export_point_cloud_ply(
                os.path.join(export_dir, f"{prefix}surface.ply"), pts,
                valid=valid))


def run_test(params: Params, data_path: Optional[str] = None,
             results_dir: str = "results/scene_exploration",
             results_name: str = "test_results.json",
             n_start_poses: int = 5, n_poses: Optional[int] = None,
             memory_root: Optional[str] = None,
             max_scenes: Optional[int] = None,
             test_scenes: Optional[list] = None, load_json: bool = False,
             policy: str = "nbv", device="cuda", weights_path=None,
             vis_weights_path=None, verbose: bool = True):
    """Evaluation over scenes x start poses; writes the results JSON after
    every trajectory. Runs on ``device`` ("cuda" unless the caller asks for
    the CPU). Weights come from ``weights_path`` (a MACARONS checkpoint: the
    port's ``.pt`` or a JAX ``.msgpack``) if it exists, else from a random
    init seeded by ``torch_seed``; ``vis_weights_path`` (a SconeVis
    variables msgpack) then replaces SconeVis's. With ``export_results``,
    each trajectory's camera curves and surface go under
    ``results_dir/exports/<scene>/start_<i>_{cameras.json,surface.ply}``."""
    dev = resolve_device(device)
    data_path = data_path or params.get("dataset_path") or params.data_path
    rs = np.random.default_rng(params.get("random_seed", 42))
    gen = make_generator(dev, params.get("torch_seed", 5))

    dataset = SceneDataset(data_path)
    test_scenes = test_scenes or params.get("test_scenes")
    if test_scenes:
        available = set(dataset.scene_names)
        missing = [n for n in test_scenes if n not in available]
        if missing and verbose:
            print(f"warning: test scenes not found under {data_path}: "
                  f"{missing}")
        dataset = SceneDataset(data_path, scene_names=[
            n for n in test_scenes if n in available])
    model = create_macarons_model(params, dev)
    if weights_path and checkpoint_exists(weights_path):
        load_macarons(weights_path, model)
    else:
        if weights_path and verbose:
            print(f"no checkpoint {weights_path}: random weights "
                  "(as the JAX tester does)")
        init_macarons_weights(model, gen)
    if vis_weights_path:
        load_module_weights(model.vis, vis_weights_path)

    surface_epsilon = (2.0 * params.get("test_resolution", 0.05)
                       * params.get("scene_scale_factor", 1.0))
    out_path = os.path.join(results_dir, results_name)
    prior: Dict[str, Dict] = {}
    if load_json and os.path.isfile(out_path):
        with open(out_path) as f:
            prior = json.load(f)
    results: Dict[str, Dict] = {}
    rt = None
    t0 = time.time()
    names = dataset.scene_names[:max_scenes] if max_scenes else dataset.scene_names
    for name in names:
        item = dataset[dataset.scene_names.index(name)]
        results[name] = {}
        for start_i in range(n_start_poses):
            scene = setup_scene(params, item, gen, dev)
            if rt is None:
                rt = MacaronsRuntime(params, model, scene.cfg,
                                     scene.cell_table, dev)
            else:
                rt.bind_scene(scene.cfg, scene.cell_table)
            mem_root = memory_root or os.path.join(
                results_dir, params.get("memory_dir_name", "_test_memory"))
            memory_path = os.path.join(mem_root, name, f"start_{start_i}")
            memory = Memory([memory_path])
            sp = item["settings"].start_positions
            start_idx = (np.asarray(sp[start_i % len(sp)], np.int64)
                         if sp else None)
            traj = compute_trajectory(
                rt, scene, memory, memory_path, gen, rs,
                n_poses=n_poses or params.get("n_poses_in_trajectory", 100),
                surface_epsilon=surface_epsilon,
                use_collision=params.get("use_collision", False),
                start_idx=start_idx, policy=policy, verbose=verbose)
            results[name][str(start_i)] = traj
            os.makedirs(results_dir, exist_ok=True)
            with open(out_path, "w") as f:
                json.dump({**prior, **results}, f)
            if params.get("export_results", False):
                export_trajectory(scene, params, os.path.join(
                    results_dir, "exports", name), f"start_{start_i}_")
            if verbose:
                print(f"{name} start {start_i}: final coverage "
                      f"{traj['coverage'][-1]:.4f}")
    if verbose:
        print(f"done in {(time.time() - t0) / 60:.1f} min")
    return {**prior, **results}
