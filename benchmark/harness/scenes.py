"""The cells' inputs on disk: the synthetic suite's scene at scene scale
and its meshes in ShapeNet's layout, written from the suite's fixed mesh
seeds (copies of chip_smoke.py's makers, frozen with the benchmark)."""

from __future__ import annotations

import json
import os

import numpy as np


def subdivide(mesh, levels: int):
    """Midpoint subdivision: each level splits every face into four at its
    edge midpoints (shared between the two faces of an edge), keeping the
    winding; vertex colours are interpolated."""
    from macarons_tpu_torch.data.mesh_io import Mesh

    verts, faces, colors = mesh.verts, mesh.faces, mesh.vert_colors
    for _ in range(levels):
        F = len(faces)
        edges = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                                faces[:, [2, 0]]])
        uniq, inv = np.unique(np.sort(edges, axis=1), axis=0,
                              return_inverse=True)
        ab, bc, ca = len(verts) + inv.reshape(3, F)
        verts = np.concatenate([verts, (verts[uniq[:, 0]]
                                        + verts[uniq[:, 1]]) / 2])
        if colors is not None:
            colors = np.concatenate([colors, (colors[uniq[:, 0]]
                                              + colors[uniq[:, 1]]) / 2])
        a, b, c = faces.T
        faces = np.stack([np.stack(f, axis=1) for f in
                          ((a, ab, ca), (ab, b, bc), (ca, bc, c),
                           (ab, bc, ca))], axis=1).reshape(-1, 3)
    return Mesh(verts.astype(np.float32), faces.astype(np.int32),
                None if colors is None else colors.astype(np.float32))


def scene_scale_suite(root: str, levels: int) -> str:
    """The synthetic suite's synth_00 under ``root`` with its mesh
    subdivided ``levels`` times (232 faces times 4 ** levels)."""
    from macarons_tpu_torch.data.mesh_io import load_obj, save_obj
    from macarons_tpu_torch.data.synthetic_suite import generate_suite

    root = generate_suite(root, n_scenes=1)
    path = os.path.join(root, "synth_00", "mesh.obj")
    save_obj(path, subdivide(load_obj(path), levels))
    return root


def shapenet_mesh(root: str, i: int, levels: int) -> str:
    """Mesh i of the synthetic suite in ShapeNet's layout,
    ``02000000/synth_<i>/model.obj``, normalised to a box diagonal of 1 and
    subdivided ``levels`` times. Returns its path under ``root``."""
    from macarons_tpu_torch.data.mesh_io import Mesh, save_obj
    from macarons_tpu_torch.data.synthetic_suite import build_scene_mesh

    mesh = subdivide(build_scene_mesh(1000 + i), levels)
    v = mesh.verts - (mesh.verts.max(0) + mesh.verts.min(0)) / 2
    v = v / np.linalg.norm(mesh.verts.max(0) - mesh.verts.min(0))
    name = f"02000000/synth_{i:02d}/model.obj"
    os.makedirs(os.path.dirname(os.path.join(root, name)), exist_ok=True)
    save_obj(os.path.join(root, name),
             Mesh(v.astype(np.float32), mesh.faces, mesh.vert_colors))
    return name


def shapenet_root(root: str, levels) -> list:
    """A ShapeNet-format root of the suite's meshes 0 .. len(levels) - 1,
    mesh i subdivided levels[i] times, all in the train split. Returns the
    model paths."""
    models = [shapenet_mesh(root, i, n) for i, n in enumerate(levels)]
    with open(os.path.join(root, "train_list.json"), "w") as f:
        json.dump({"models": models}, f)
    return models
