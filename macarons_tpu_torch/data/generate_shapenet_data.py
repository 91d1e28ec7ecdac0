"""CLI: ShapeNet GT artifacts for every mesh of a ShapeNet-format root.

Usage: python -m macarons_tpu_torch.data.generate_shapenet_data
       [-c <generate_shapenet_data_config.json>] [--data-path DIR]
       [--recompute] [--image-size N] [--device cuda|cpu]

Walks the split files under the data path ({"models": ["<synset>/<id>/
model.obj", ...]}: train_list.json, val_list.json, all_test_list.json,
all_test_novel_list.json), loads each model.obj, normalises it to a box
diagonal of 1 and writes surface_points.npz, partial_point_clouds.npz and
occupancy_field.npz into the model's ``tensors/`` (skipped where all three
exist, unless --recompute). The config's keys named like
data.shapenet.ShapeNetGTConfig's fields override its defaults. Draws come
from one CPU generator seeded 42, so the card and the CPU take the same.
"""

import argparse
import json
import os
import time

import torch

from ..config import load_params
from ..utils.device import resolve_device
from . import shapenet as sng
from .mesh_io import load_obj

REPO_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SPLITS = ("train_list.json", "val_list.json", "all_test_list.json",
          "all_test_novel_list.json")


def split_models(data_path: str):
    """Every model path of the split files, once, in their order."""
    models = []
    for s in SPLITS:
        path = os.path.join(data_path, s)
        if os.path.exists(path):
            with open(path) as f:
                models += json.load(f)["models"]
    return list(dict.fromkeys(models))


def generate(data_path: str, cfg: sng.ShapeNetGTConfig, device="cuda",
             recompute: bool = False, seed: int = 42, verbose: bool = True):
    """Write the GT artifacts of every split mesh under ``data_path`` on
    ``device``; returns the model paths processed."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    models = split_models(data_path)
    if verbose:
        print(f"{len(models)} meshes to process")
    done_paths, t0 = [], time.time()
    for i, m in enumerate(models):
        obj_path = os.path.join(data_path, m)
        out_dir = os.path.join(os.path.dirname(obj_path), "tensors")
        done = all(os.path.exists(os.path.join(out_dir, f + ".npz"))
                   for f in ("surface_points", "partial_point_clouds",
                             "occupancy_field"))
        if done and not recompute:
            continue
        mesh = load_obj(obj_path)
        verts = sng.adjust_mesh_diagonally(
            torch.as_tensor(mesh.verts, device=dev), 1.0)
        faces = torch.as_tensor(mesh.faces, device=dev).long()
        sng.save_mesh_gt(sng.generate_mesh_gt(gen, verts, faces, cfg),
                         out_dir)
        done_paths.append(m)
        if verbose and i % 20 == 0:
            print(f"{i + 1}/{len(models)} done "
                  f"({(time.time() - t0) / 60:.1f} min)")
    return done_paths


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Generate ShapeNet GT artifacts.")
    parser.add_argument("-c", "--config", default=None)
    parser.add_argument("--data-path", default=None,
                        help="ShapeNet root (default: the config's, else "
                        "data/ShapeNetCore.v1)")
    parser.add_argument("--recompute", action="store_true")
    parser.add_argument("--image-size", type=int, default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    cfg = sng.ShapeNetGTConfig()
    data_path = os.path.join(REPO_DIR, "data/ShapeNetCore.v1")
    recompute = args.recompute
    if args.config:
        p = load_params(args.config)
        data_path = p.get("data_path", data_path)
        recompute = p.get("recompute", recompute)
        cfg = sng.ShapeNetGTConfig(
            **{k: p[k] for k in sng.ShapeNetGTConfig._fields if k in p})
    if args.image_size:
        cfg = cfg._replace(image_size=args.image_size)
    generate(args.data_path or data_path, cfg, device=args.device,
             recompute=recompute)


if __name__ == "__main__":
    main()
