"""ShapeNet GT generation (port of macarons_tpu/data/shapenet.py): surface
points, partial point clouds, coverage matrices and space-carved occupancy
fields per mesh, in the same ``.npz`` layout, so files interchange between
the two packages.

- GT surface: area-weighted sampling on the mesh;
- per-candidate partial clouds: the 52 FoV candidates rasterized at once,
  the zbuf back-projected, each camera's valid pixels subsampled to
  ``part_pc_length`` (padded, with masks);
- coverage: a GT surface point is covered by a camera if its cloud has a
  point within the surface epsilon;
- occupancy: uniform and near-surface samples carved by 6 orthographic
  views, balanced occupied-first, topped up with the surface at occ 1.

Every draw comes from one ``torch.Generator`` and is made on that
generator's device, then moved to the mesh's: a CPU generator gives the
card and the CPU the same draws. Meshes above 4096 faces rasterize on the
tiled path on the card (``rasterize_tiled``, B1 + B2 in one launch per
camera batch) and the binned path on the CPU, unless ``method`` says.
"""

from __future__ import annotations

import os
from typing import Dict, NamedTuple

import numpy as np
import torch

from ..ops.geometry import (
    FoVCamera,
    OrthoCamera,
    get_cartesian_coords,
    look_at_view_transform,
)
from ..ops.grid_sample import sample_points_bilinear
from ..ops.knn import pairwise_sqdist
from ..ops.projection import project_depth_back_to_3D
from ..ops.rasterizer import rasterize
from ..ops.sampling import (
    _rand,
    random_subsample_mask,
    sample_points_on_mesh_surface,
    sample_X_in_box,
)
from ..ops.view_state import get_cameras_on_sphere


def adjust_mesh_diagonally(verts, diag_range: float = 1.0):
    """Centre and scale verts so that the box diagonal is diag_range."""
    min_c = verts.amin(dim=0)
    max_c = verts.amax(dim=0)
    diag = torch.linalg.norm(max_c - min_c)
    center = (min_c + max_c) / 2.0
    return (verts - center) * diag_range / diag


def compute_surface_epsilon(X_surf, quantile: float = 0.9, chunk: int = 2048):
    """The ``quantile`` of the points' nearest-neighbour distances (a point
    at distance 0, itself, is skipped), ``chunk`` queries at a time."""
    mins = []
    for a in range(0, X_surf.shape[0], chunk):
        d2 = pairwise_sqdist(X_surf[a:a + chunk], X_surf)
        d2 = torch.where(d2 <= 0.0, 1e6, d2)
        mins.append(torch.sqrt(d2.amin(dim=-1)))
    return torch.quantile(torch.cat(mins), quantile)


def min_dist_to_cloud(queries, cloud, cloud_mask=None, chunk: int = 2048,
                      big: float = 1e6):
    """Least Euclidean distance from each query to the (masked) cloud,
    ``chunk`` queries at a time."""
    out = []
    for a in range(0, queries.shape[0], chunk):
        d2 = pairwise_sqdist(queries[a:a + chunk], cloud)
        if cloud_mask is not None:
            d2 = torch.where(cloud_mask[None, :], d2, big)
        out.append(torch.sqrt(d2.amin(dim=-1)))
    return torch.cat(out)


class ShapeNetGTConfig(NamedTuple):
    """The knobs of generate_shapenet_data_config.json (the JAX package's
    defaults)."""

    surface_resolution: float = 1.5
    n_points_surface: int = 16384
    part_pc_length: int = 2048
    surface_epsilon_is_constant: bool = True
    surface_epsilon: float = 0.00707
    epsilon_quantile: float = 0.9
    sampling_diagonal_range: float = 1.0
    sampling_ratio: float = 0.5
    sampling_noise_std: float = 0.036736797628535885
    n_samples_for_occupancy: int = 300000
    n_max_samples: int = 600000
    image_size: int = 512
    n_ortho_camera: int = 6
    ortho_camera_dist: float = 1.5
    camera_dist: float = 1.5
    pole_cameras: bool = True
    n_camera_elev: int = 5
    n_camera_azim: int = 10
    raster_chunk: int = 256


def candidate_cameras(cfg: ShapeNetGTConfig, device=None):
    """The 52 candidate FoV cameras on the sphere, looking at the origin.
    Returns (X_cam (52, 3), FoVCamera)."""
    X_cam, _, _, _ = get_cameras_on_sphere(
        cfg.n_camera_elev, cfg.n_camera_azim, cfg.camera_dist,
        pole_cameras=cfg.pole_cameras, device=device)
    R, T = look_at_view_transform(X_cam, torch.zeros_like(X_cam))
    return X_cam, FoVCamera.create(R, T, fov=60.0, znear=0.01, zfar=10.0)


def ortho_cameras(cfg: ShapeNetGTConfig, device=None):
    """The 6 axis-aligned orthographic carving cameras."""
    elev = torch.tensor([0.0, 0.0, 0.0, 0.0, 90.0, -90.0], device=device)
    azim = torch.tensor([0.0, 90.0, 180.0, 270.0, 0.0, 0.0], device=device)
    dist = torch.full_like(elev, cfg.ortho_camera_dist)
    eye = get_cartesian_coords(dist, elev, azim, in_degrees=True)
    R, T = look_at_view_transform(eye, torch.zeros_like(eye))
    return OrthoCamera.create(R, T, znear=0.01, zfar=10.0)


def _image_size(cfg, image_size):
    return (cfg.image_size, cfg.image_size) if image_size is None \
        else tuple(image_size)


def backproject_partial_clouds(verts, faces, cameras: FoVCamera,
                               cfg: ShapeNetGTConfig, image_size=None,
                               method: str = "auto"):
    """Every pixel of every camera back-projected from the zbuf of the mesh
    rasterized at ``surface_resolution`` scale, mapped back to the diag-1
    scale. verts must be diag-1 normalised.
    Returns (points (C, H*W, 3), mask (C, H*W))."""
    surf_verts = adjust_mesh_diagonally(verts, cfg.surface_resolution)
    frags = rasterize(surf_verts, faces, cameras,
                      _image_size(cfg, image_size), chunk=cfg.raster_chunk,
                      perspective_correct=True, method=method)
    pts, mask = project_depth_back_to_3D(frags.zbuf[..., None], cameras)
    return pts / cfg.surface_resolution, mask


def compute_partial_point_clouds(gen, verts, faces, cameras: FoVCamera,
                                 cfg: ShapeNetGTConfig, image_size=None,
                                 method: str = "auto"):
    """Per-camera partial clouds, ``part_pc_length`` random valid pixels of
    each (one uniform draw per pixel of every camera).
    Returns (part_pc (C, L, 3), part_mask (C, L))."""
    pts, mask = backproject_partial_clouds(verts, faces, cameras, cfg,
                                           image_size, method)
    idx, valid = random_subsample_mask(gen, mask, cfg.part_pc_length)
    return pts.gather(1, idx[..., None].expand(-1, -1, 3)), valid


def compute_coverage_matrix(gt_surface, part_pc, part_mask,
                            cfg: ShapeNetGTConfig):
    """(C, n_points_surface) 0/1: surface points within the surface epsilon
    of each camera's cloud."""
    eps = (cfg.surface_epsilon if cfg.surface_epsilon_is_constant
           else compute_surface_epsilon(gt_surface, cfg.epsilon_quantile))
    rows = [(eps - min_dist_to_cloud(gt_surface, part_pc[c],
                                     cloud_mask=part_mask[c]) > 0)
            .to(torch.float32) for c in range(part_pc.shape[0])]
    return torch.stack(rows)


def carve_occupancy(verts, faces, X_world, cfg: ShapeNetGTConfig,
                    image_size=None, method: str = "auto"):
    """Occupancy (N,) of X_world (N, 3) by 6-view orthographic carving: 1
    where the point lies behind the surface in every view (empty pixels
    read far depth)."""
    r = cfg.sampling_diagonal_range
    cams = ortho_cameras(cfg, verts.device)
    surf_verts = adjust_mesh_diagonally(verts, cfg.surface_resolution)
    frags = rasterize(surf_verts, faces, cams, _image_size(cfg, image_size),
                      chunk=cfg.raster_chunk, perspective_correct=True,
                      method=method)
    depth = frags.zbuf[..., None]
    depth = torch.where(depth > -1, depth, 100 * r * cfg.surface_resolution)
    Xs = (X_world * cfg.surface_resolution)[None].expand(6, *X_world.shape)
    X_zbuf = cams.world_to_view(Xs)[..., 2]
    ndc = cams.transform_points(Xs)
    # A square image: the grid is -NDC.
    ortho_z = sample_points_bilinear(depth, -ndc[..., :2],
                                     padding_mode="border")[..., 0]
    return torch.prod((X_zbuf - ortho_z > 0).to(torch.float32), dim=0)


def compute_occupancy_field(gen, verts, faces, gt_surface,
                            cfg: ShapeNetGTConfig, image_size=None,
                            method: str = "auto"):
    """Carved occupancy of uniform box samples and noisy surface samples:
    the occupied ones first, n_samples_for_occupancy of them kept in a
    random order, then the surface at occ 1. Draws in order: the box
    samples, the surface picks, their noise, the shuffle, the final order.
    Returns (n_samples_for_occupancy + n_points_surface, 4) [xyz, occ]."""
    dev = verts.device
    n_uniform = int(cfg.n_max_samples * cfg.sampling_ratio)
    n_surface = cfg.n_max_samples - n_uniform
    r = cfg.sampling_diagonal_range
    X_uni = sample_X_in_box(gen, r, n_uniform, device=dev)
    pick = torch.randint(0, gt_surface.shape[0], (n_surface,), generator=gen,
                         device=gen.device).to(dev)
    noise = _rand(gen, (n_surface, 3), dev, normal=True)
    X_surf = torch.clamp(gt_surface[pick] + cfg.sampling_noise_std * noise,
                         -r / 2, r / 2)
    X_world = torch.cat((X_uni, X_surf), dim=0)
    X_world = X_world[torch.randperm(X_world.shape[0], generator=gen,
                                     device=gen.device).to(dev)]
    occ = carve_occupancy(verts, faces, X_world, cfg, image_size, method)

    n_keep = cfg.n_samples_for_occupancy
    order = torch.argsort(-occ, stable=True)[:n_keep]
    perm = torch.randperm(n_keep, generator=gen, device=gen.device).to(dev)
    X_world, occ = X_world[order][perm], occ[order][perm]
    X_world = torch.cat((X_world, gt_surface), dim=0)
    occ = torch.cat((occ, torch.ones(gt_surface.shape[0], device=dev)))
    return torch.cat((X_world, occ[:, None]), dim=-1)


def generate_mesh_gt(gen, verts, faces,
                     cfg: ShapeNetGTConfig = ShapeNetGTConfig(),
                     image_size=None, method: str = "auto"
                     ) -> Dict[str, np.ndarray]:
    """Every GT artifact of one diag-1 normalised mesh, in the JAX
    package's dict layout (numpy arrays)."""
    gt_surface = sample_points_on_mesh_surface(gen, verts, faces,
                                               cfg.n_points_surface)
    epsilon = compute_surface_epsilon(gt_surface, cfg.epsilon_quantile)
    _, cams = candidate_cameras(cfg, verts.device)
    part_pc, part_mask = compute_partial_point_clouds(
        gen, verts, faces, cams, cfg, image_size, method)
    coverage = compute_coverage_matrix(gt_surface, part_pc, part_mask, cfg)
    occupancy = compute_occupancy_field(gen, verts, faces, gt_surface, cfg,
                                        image_size, method)
    return {
        "surface_points": gt_surface.cpu().numpy(),
        "epsilon": np.asarray(epsilon.cpu().numpy(), np.float32),
        "quantile": np.float32(cfg.epsilon_quantile),
        "resolution": np.float32(cfg.surface_resolution),
        "partial_point_cloud": part_pc.cpu().numpy(),
        "partial_point_cloud_mask": part_mask.cpu().numpy(),
        "coverage": coverage.cpu().numpy(),
        "occupancy_field": occupancy.cpu().numpy(),
    }


def save_mesh_gt(gt: Dict[str, np.ndarray], save_dir: str):
    """The three artifact files, as the JAX package writes them."""
    os.makedirs(save_dir, exist_ok=True)
    np.savez(os.path.join(save_dir, "surface_points.npz"),
             surface_points=gt["surface_points"], epsilon=gt["epsilon"],
             quantile=gt["quantile"], resolution=gt["resolution"])
    np.savez(os.path.join(save_dir, "partial_point_clouds.npz"),
             partial_point_cloud=gt["partial_point_cloud"],
             partial_point_cloud_mask=gt["partial_point_cloud_mask"],
             coverage=gt["coverage"])
    np.savez(os.path.join(save_dir, "occupancy_field.npz"),
             occupancy_field=gt["occupancy_field"])
