"""SCONE object demo: depth-sensor NBV on one mesh, with a figure (port of
demos/scone_demo.py).

A headless CLI: given a mesh with its GT artifacts (generated on the fly
into ``<mesh dir>/tensors`` for a raw .obj), it runs the greedy NBV
trajectory of the ShapeNet tester with SconeOcc and SconeVis, writes
``trajectory.json`` (the views and the coverage after each) and plots the
accumulated partial clouds and the coverage per view. ``run`` does the
device work and ``draw`` the figure (matplotlib).

Usage:
  python -m macarons_tpu_torch.demos.scone_demo --mesh model.obj
      [--occ ckpt --vis ckpt] [--n_views 6] [--out scone_demo_out]
      [--gt_image_size 128] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import numpy as np
import torch

from ..config import Params
from ..data import datasets as D
from ..data import shapenet as sng
from ..data.mesh_io import load_obj
from ..models.attention import init_weights
from ..testers.shapenet import nbv_trajectory
from ..trainers.pretrain_occ import build_model as build_occ
from ..trainers.pretrain_occ import step_constants
from ..trainers.pretrain_vis import build_vis_model
from ..utils.checkpoint import checkpoint_exists, load_checkpoint
from ..utils.device import make_generator, resolve_device
from .macarons_demo import require

SMALL = dict(
    seq_len=512, n_proxy_points=4096, n_view_min=1, n_view_max=6, pc_size=512,
    view_state_n_elev=7, view_state_n_azim=14, harmonic_degree=8,
    camera_dist=1.5, pole_cameras=True, n_camera_elev=5, n_camera_azim=10,
    n_camera=52, gt_max_diagonal=1.0, min_occ_for_proxy_points=0.05,
    use_occ_to_sample_proxy_points=True, use_sigmoid=True, filter_tol=0.01,
    no_view_harmonics=False, occ_no_view_harmonics=False,
)


def run(mesh: str, occ: Optional[str] = None, vis: Optional[str] = None,
        n_views: int = 6, out: str = "scone_demo_out",
        gt_image_size: int = 128, device="cuda", verbose: bool = True):
    """The demo's device work: the mesh's GT (generated at
    ``gt_image_size`` if its ``tensors/partial_point_clouds.npz`` is
    missing, its draws from a CPU generator seeded 0, as the GT CLI's),
    SconeOcc and SconeVis (random weights from seed 1, replaced
    by the checkpoints ``occ`` and ``vis`` where they exist), and a greedy
    trajectory of ``n_views`` views from view 0. Writes
    ``out/trajectory.json``. Returns (coverages (n_views,), view indices
    (n_views,), the partial clouds (C, L, 3) and their masks (C, L)), on
    the host."""
    dev = resolve_device(device)
    os.makedirs(out, exist_ok=True)
    params = Params(dict(SMALL, n_view_max=n_views))
    tensors = os.path.join(os.path.dirname(mesh), "tensors")
    if not os.path.exists(os.path.join(tensors, "partial_point_clouds.npz")):
        if verbose:
            print("generating GT artifacts ...")
        m = load_obj(mesh)
        verts = sng.adjust_mesh_diagonally(
            torch.as_tensor(m.verts, device=dev), 1.0)
        cfg = sng.ShapeNetGTConfig(
            n_points_surface=2048, part_pc_length=1024,
            n_samples_for_occupancy=4000, n_max_samples=8000,
            image_size=gt_image_size)
        sng.save_mesh_gt(sng.generate_mesh_gt(
            torch.Generator().manual_seed(0), verts,
            torch.as_tensor(m.faces, dtype=torch.int64, device=dev), cfg),
            tensors)
    part_pc, part_mask, coverage = D.get_gt_partial_point_clouds(mesh)

    gen = make_generator(dev, 1)
    occ_model = init_weights(build_occ(params).to(dev), gen)
    vis_model = init_weights(build_vis_model(params).to(dev), gen)
    if occ and checkpoint_exists(occ):
        load_checkpoint(occ, occ_model)
    if vis and checkpoint_exists(vis):
        load_checkpoint(vis, vis_model)
    with torch.no_grad():
        coverages, view_idx = nbv_trajectory(
            params, occ_model.eval(), vis_model.eval(),
            step_constants(params, dev), torch.as_tensor(part_pc, device=dev),
            torch.as_tensor(part_mask, device=dev),
            torch.as_tensor(coverage, device=dev), 0, gen)
    coverages = coverages.cpu().numpy()
    view_idx = view_idx.cpu().numpy()
    if verbose:
        print("view sequence:", view_idx.tolist())
        print("coverage evolution:", np.round(coverages, 4).tolist())
    with open(os.path.join(out, "trajectory.json"), "w") as f:
        json.dump({"coverage": coverages.tolist(),
                   "view_idx": view_idx.tolist()}, f)
    return coverages, view_idx, part_pc, part_mask


def draw(out: str, coverages, view_idx, part_pc, part_mask):
    """``out/nbv_trajectory.png``: the visited views' partial clouds and
    the coverage after each view. Returns its path."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(10, 4))
    ax = fig.add_subplot(121, projection="3d")
    for n, v in enumerate(view_idx):
        pc = part_pc[v][part_mask[v]]
        ax.scatter(pc[:, 0], pc[:, 2], pc[:, 1], s=0.6, label=f"view {n}")
    ax.set_title("accumulated partial clouds")
    ax.legend(markerscale=8, fontsize=7)
    ax2 = fig.add_subplot(122)
    ax2.plot(coverages, "o-")
    ax2.set_xlabel("views")
    ax2.set_ylabel("GT surface coverage")
    ax2.set_ylim(0, 1)
    fig.tight_layout()
    path = os.path.join(out, "nbv_trajectory.png")
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--mesh", required=True)
    parser.add_argument("--occ", default=None)
    parser.add_argument("--vis", default=None)
    parser.add_argument("--n_views", type=int, default=6)
    parser.add_argument("--out", default="scone_demo_out")
    parser.add_argument("--gt_image_size", type=int, default=128)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    require("matplotlib")
    result = run(args.mesh, args.occ, args.vis, args.n_views, args.out,
                 args.gt_image_size, args.device)
    print("wrote", draw(args.out, *result))


if __name__ == "__main__":
    main()
