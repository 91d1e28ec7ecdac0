"""CLI: settings.json and occupied_pose.npz for every scene of a data path
(port of data_tools/generate_scene_data.py).

Usage: python -m macarons_tpu_torch.data.generate_scene_data
       [--data_path data/scenes] [--scene NAME] [--cell_size 1.0]
       [--pose_step 1.0] [--recompute] [--device cuda|cpu]

A scene is a directory holding an ``.obj``. Its settings.json is written
by data.scenes.compute_scene_settings and its occupied_pose.npz
(``X_idx``, ``occupied``) by compute_occupied_poses at 64 x 64, each
skipped where the file exists, unless --recompute.
"""

import argparse
import json
import os

import numpy as np

from ..scene.camera import PoseSpace
from .mesh_io import load_obj
from .scenes import compute_occupied_poses, compute_scene_settings

REPO_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def generate(data_path: str, scene=None, cell_size: float = 1.0,
             pose_step: float = 1.0, recompute: bool = False, device="cuda"):
    """Write each scene's missing files (all of them with ``recompute``).
    Returns {scene: compute_occupied_poses(...)} for the scenes whose
    occupied poses were computed."""
    names = ([scene] if scene else sorted(
        d for d in os.listdir(data_path)
        if os.path.isdir(os.path.join(data_path, d))))
    out = {}
    for name in names:
        d = os.path.join(data_path, name)
        objs = [f for f in os.listdir(d) if f.endswith(".obj")]
        if not objs:
            continue
        settings_path = os.path.join(d, "settings.json")
        if not os.path.exists(settings_path) or recompute:
            mesh = load_obj(os.path.join(d, objs[0]))
            settings = compute_scene_settings(
                mesh.verts, cell_size=cell_size, pose_step=pose_step)
            with open(settings_path, "w") as f:
                json.dump(settings, f, indent=2)
            print(f"{name}: wrote settings.json")
        occupied_path = os.path.join(d, "occupied_pose.npz")
        if not os.path.exists(occupied_path) or recompute:
            mesh = load_obj(os.path.join(d, objs[0]))
            with open(settings_path) as f:
                s = json.load(f)["camera"]
            ps = PoseSpace(np.asarray(s["x_min"]), np.asarray(s["x_max"]),
                           s["pose_l"], s["pose_w"], s["pose_h"],
                           s["pose_n_elev"], s["pose_n_azim"])
            occ = compute_occupied_poses(mesh, ps, device=device)
            np.savez(occupied_path, X_idx=occ["X_idx"],
                     occupied=occ["occupied"])
            print(f"{name}: wrote occupied_pose.npz "
                  f"({occ['occupied'].sum()} occupied)")
            out[name] = occ
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Generate per-scene settings.json and "
        "occupied_pose.npz.")
    parser.add_argument("--data_path",
                        default=os.path.join(REPO_DIR, "data/scenes"))
    parser.add_argument("--scene", default=None)
    parser.add_argument("--cell_size", type=float, default=1.0)
    parser.add_argument("--pose_step", type=float, default=1.0)
    parser.add_argument("--recompute", action="store_true")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    return generate(args.data_path, args.scene, args.cell_size,
                    args.pose_step, args.recompute, args.device)


if __name__ == "__main__":
    main()
