"""SCONE NBV evaluation on ShapeNet (port of
macarons_tpu/testers/shapenet.py): greedy coverage-gain trajectories over
the 52 candidate cameras of each test mesh.

Each step: the union of the visited cameras' partial clouds, subsampled to
n_view_max * pc_size points; proxy points filtered by the visited cameras;
their view harmonics; SconeOcc's occupancy; Monte-Carlo samples; SconeVis;
the gain of every candidate in one launch of the SH-visibility kernel
(B3); the argmax is the next view. The results JSON is the JAX package's.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np
import torch

from ..config import Params
from ..data import datasets as D
from ..models.attention import init_weights
from ..models.scone import SconeOcc, SconeVis, compute_coverage_gain, \
    compute_occupancy_probability
from ..ops.geometry import FoVCamera, look_at_view_transform
from ..ops.knn import smallest_k
from ..ops.view_state import filter_proxy_points_mask, sample_proxy_points
from ..trainers.pretrain_occ import StepConstants, step_constants, \
    to_prediction_box, view_harmonics
from ..trainers.pretrain_vis import build_vis_model, load_occ_model, \
    proxy_points
from ..utils.checkpoint import checkpoint_exists, load_checkpoint
from ..utils.device import make_generator, resolve_device


def surface_coverage_from_cam_idx(coverage, view_idx, view_mask):
    """Share of the GT surface covered by the selected cameras.
    coverage (C, S); view_idx (V,); view_mask (V,)."""
    sel = coverage[view_idx] * view_mask[:, None].to(coverage.dtype)
    return torch.mean((sel.sum(dim=0) > 0).to(coverage.dtype))


def nbv_trajectory(params: Params, occ_model: SconeOcc, vis_model: SconeVis,
                   consts: StepConstants, part_pc, part_mask, coverage,
                   init_view: int, gen=None, draws=None):
    """A greedy NBV trajectory of n_view_max views from ``init_view``.

    ``draws`` injects the proxy points (``"X"`` (n_proxy, 3)) and per step
    j = 1 .. n_view_max - 1 the cloud-union noise (``"noise"``[j - 1],
    (n_view_max * L,)) and the Monte-Carlo sample indices
    (``"sample_idx"``[j - 1], (seq_len,)); without a ``gen``, SconeOcc
    subsamples deterministically.
    Returns (coverages (n_view_max,), view_idx (n_view_max,))."""
    draws = draws or {}
    dev = part_pc.device
    n_view_max = params.n_view_max
    max_pc = n_view_max * params.get("pc_size", 1024)
    n_cam, L = part_pc.shape[0], part_pc.shape[1]
    pred = torch.tensor([init_view], device=dev)
    X_cam_n = to_prediction_box(params, consts, consts.X_cam[None], pred)[0]
    pc_all = to_prediction_box(params, consts, part_pc.reshape(1, -1, 3),
                               pred)[0].reshape(n_cam, L, 3)
    X_proxy = draws.get("X")
    if X_proxy is None:
        X_proxy = proxy_points(params, 1, dev, gen)[0]
    view_idx = torch.zeros(n_view_max, dtype=torch.int64, device=dev)
    view_idx[0] = init_view
    view_mask = torch.zeros(n_view_max, dtype=torch.bool, device=dev)
    view_mask[0] = True
    coverages = torch.zeros(n_view_max, device=dev)
    coverages[0] = surface_coverage_from_cam_idx(coverage, view_idx,
                                                 view_mask)
    for j in range(1, n_view_max):
        flat_pc = pc_all[view_idx].reshape(-1, 3)
        flat_mask = (part_mask[view_idx] & view_mask[:, None]).reshape(-1)
        noise = (draws["noise"][j - 1] if "noise" in draws else
                 torch.rand(flat_mask.shape[0], generator=gen,
                            device=gen.device).to(dev))
        _, take = smallest_k(noise + torch.where(flat_mask, 0.0, 1e9),
                             max_pc)
        pc, pc_mask = flat_pc[take], flat_mask[take]
        X_view = X_cam_n[view_idx]
        R_v, T_v = look_at_view_transform(X_view, torch.zeros_like(X_view))
        keep = filter_proxy_points_mask(
            FoVCamera.create(R_v, T_v, zfar=1000.0), X_proxy, pc,
            filter_tol=params.get("filter_tol", 0.01), pc_mask=pc_mask,
            view_mask=view_mask)
        vh = view_harmonics(params, consts, X_proxy[None], X_view[None],
                            view_mask[None])
        occ_vh = vh * 0.0 if params.get("occ_no_view_harmonics", False) \
            else vh
        vis_vh = vh * 0.0 if params.get("no_view_harmonics", False) else vh
        occ = compute_occupancy_probability(
            occ_model, pc[None], X_proxy[None], occ_vh, pc_mask=pc_mask[None],
            generator=gen, max_points_per_pass=params.get(
                "max_points_per_scone_occ_pass", 300000))[0]
        sidx = draws["sample_idx"][j - 1] if "sample_idx" in draws else None
        pts4, harm, _, smask = sample_proxy_points(
            gen, X_proxy, occ, vis_vh[0], params.seq_len,
            params.get("min_occ_for_proxy_points", 0.1),
            use_occ_to_sample=params.get("use_occ_to_sample_proxy_points",
                                         True),
            valid_mask=keep, idx=sidx)
        harmonics = vis_model(pts4[None], harm[None], pts_mask=smask[None])
        gains = compute_coverage_gain(
            pts4[None], harmonics, X_cam_n[None], pts_mask=smask[None],
            use_sigmoid=params.get("use_sigmoid", True))[0]
        view_idx[j] = torch.argmax(gains)
        view_mask[j] = True
        coverages[j] = surface_coverage_from_cam_idx(coverage, view_idx,
                                                     view_mask)
    return coverages, view_idx


def load_models(params: Params, occ_weights_path, vis_weights_path, dev,
                gen):
    """Frozen SconeOcc and SconeVis: the checkpoints' weights (the port's
    ``.pt`` or a JAX ``.msgpack``) where they exist, else random ones."""
    occ = load_occ_model(params, occ_weights_path, dev, gen)
    vis = init_weights(build_vis_model(params).to(dev), gen)
    if vis_weights_path and checkpoint_exists(vis_weights_path):
        load_checkpoint(vis_weights_path, vis)
    return occ, vis.eval()


def run_test(params: Params, data_path: Optional[str] = None,
             occ_weights_path: Optional[str] = None,
             vis_weights_path: Optional[str] = None,
             test_novel: bool = False,
             results_dir: str = "results/shapenet_reconstruction",
             max_meshes: Optional[int] = None,
             results_name: Optional[str] = None,
             seed: int = 42, device="cuda", verbose: bool = True):
    """NBV trajectories over the test split on ``device`` ("cuda" unless
    the caller asks for the CPU); writes and returns the results dict."""
    dev = resolve_device(device)
    data_path = data_path or params.data_path
    gen = make_generator(dev, seed)
    rs = np.random.default_rng(seed)
    occ, vis = load_models(params, occ_weights_path, vis_weights_path, dev,
                           gen)
    consts = step_constants(params, dev)
    _, _, test_ds = D.get_shapenet_datasets(data_path, test_novel=test_novel)
    paths = test_ds.paths[:max_meshes] if max_meshes else test_ds.paths

    coverage_dict = {}
    sum_cov = np.zeros(params.n_view_max)
    computation_time = 0.0
    for i, p in enumerate(paths):
        part_pc, part_mask, coverage = (
            torch.as_tensor(a, device=dev)
            for a in D.get_gt_partial_point_clouds(p))
        init_view = int(rs.integers(0, coverage.shape[0]))
        t0 = time.time()
        with torch.no_grad():
            coverages, _ = nbv_trajectory(params, occ, vis, consts, part_pc,
                                          part_mask, coverage, init_view, gen)
        cov = coverages.cpu().numpy()
        computation_time += time.time() - t0
        coverage_dict[p] = cov.tolist()
        sum_cov += cov
        if verbose and i % 10 == 0:
            print(f"mesh {i + 1}/{len(paths)}: coverages {np.round(cov, 4)}")

    n = max(len(paths), 1)
    results = {"coverages": coverage_dict,
               "mean_coverages": (sum_cov / n).tolist(),
               "computation_time": computation_time,
               "avg_computation_time": computation_time / n}
    os.makedirs(results_dir, exist_ok=True)
    results_name = results_name or \
        f"results_{'novel' if test_novel else 'seen'}.json"
    with open(os.path.join(results_dir, results_name), "w") as f:
        json.dump(results, f, indent=2)
    if verbose:
        print("Avg coverages:", np.round(sum_cov / n, 4))
        print("Avg NBV computation time per mesh:",
              results["avg_computation_time"])
    return results
