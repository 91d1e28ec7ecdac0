"""OBJ mesh IO on the host, with numpy (port of
macarons_tpu/data/mesh_io.py).

Reads v/vt/f lines, per-vertex colours (``v x y z r g b``), fan-triangulates
polygons, and bakes OBJ + MTL textures into a per-face texture atlas
(F, R, R, 3) in PyTorch3D's ``TexturesAtlas`` layout
(``load_obj(create_texture_atlas=True)``). ``mirror_mesh`` is the
trainer's random mirroring.
"""

from __future__ import annotations

import os
from typing import Dict, NamedTuple, Optional

import numpy as np


class Mesh(NamedTuple):
    verts: np.ndarray  # (V, 3) float32
    faces: np.ndarray  # (F, 3) int32
    vert_colors: Optional[np.ndarray] = None  # (V, 3) float32 or None
    texture_atlas: Optional[np.ndarray] = None  # (F, R, R, 3) float32 or None


def parse_mtl(path: str) -> Dict[str, dict]:
    """Parse a .mtl file: {material_name: {"Kd": (3,), "map_Kd": abspath}}."""
    materials: Dict[str, dict] = {}
    cur = None
    base = os.path.dirname(path)
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "newmtl":
                cur = parts[1]
                materials[cur] = {"Kd": np.array([0.5, 0.5, 0.5], np.float32)}
            elif cur is not None and parts[0] == "Kd":
                materials[cur]["Kd"] = np.array(
                    [float(x) for x in parts[1:4]], np.float32)
            elif cur is not None and parts[0] == "map_Kd":
                # The texture path is the rest of the line (spaces allowed).
                materials[cur]["map_Kd"] = os.path.join(
                    base, line.split(None, 1)[1].strip())
    return materials


def _load_texture_image(path: str) -> Optional[np.ndarray]:
    """(H, W, 3) float32 in [0, 1] read with PIL, or None if PIL is missing
    or the file is unreadable."""
    try:
        from PIL import Image

        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"), np.float32) / 255.0
    except Exception:
        return None


def _sample_texture_bilinear(image: np.ndarray, uv: np.ndarray) -> np.ndarray:
    """Sample (H, W, 3) at OBJ uv coordinates (..., 2), origin bottom-left."""
    H, W = image.shape[:2]
    u = np.clip(uv[..., 0], 0.0, 1.0)
    v = np.clip(uv[..., 1], 0.0, 1.0)
    x = u * (W - 1)
    y = (1.0 - v) * (H - 1)  # v = 0 is the bottom image row
    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    x1 = np.minimum(x0 + 1, W - 1)
    y1 = np.minimum(y0 + 1, H - 1)
    wx = (x - x0)[..., None]
    wy = (y - y0)[..., None]
    return (image[y0, x0] * (1 - wy) * (1 - wx)
            + image[y0, x1] * (1 - wy) * wx
            + image[y1, x0] * wy * (1 - wx)
            + image[y1, x1] * wy * wx).astype(np.float32)


def bake_texture_atlas(face_uvs: np.ndarray, face_images,
                       resolution: int = 4) -> np.ndarray:
    """Per-face (F, R, R, 3) texture atlas.

    face_uvs (F, 3, 2): uv coordinates of each face's vertices; face_images:
    per face an (H, W, 3) image, a (3,) constant colour or None (grey).
    Texel (iy, ix) holds barycentrics w0 = iy / (R - 1), w1 = ix / (R - 1),
    w2 = 1 - w0 - w1, clipped onto the simplex: the grid that
    ops.rasterizer.sample_texture_atlas reads back."""
    F = face_uvs.shape[0]
    R = resolution
    g = np.linspace(0.0, 1.0, R, dtype=np.float32)
    w0 = np.repeat(g[:, None], R, axis=1)  # rows: w0
    w1 = np.repeat(g[None, :], R, axis=0)  # columns: w1
    total = w0 + w1
    scale = np.where(total > 1.0, 1.0 / np.maximum(total, 1e-8), 1.0)
    w0c = w0 * scale
    w1c = w1 * scale
    w2c = np.clip(1.0 - w0c - w1c, 0.0, 1.0)

    atlas = np.zeros((F, R, R, 3), np.float32)
    for i in range(F):
        img = face_images[i]
        if img is None:
            atlas[i] = 0.5
        elif np.ndim(img) == 1:  # constant Kd colour
            atlas[i] = np.asarray(img, np.float32)
        else:
            uv = (w0c[..., None] * face_uvs[i, 0]
                  + w1c[..., None] * face_uvs[i, 1]
                  + w2c[..., None] * face_uvs[i, 2])  # (R, R, 2)
            atlas[i] = _sample_texture_bilinear(img, uv)
    return atlas


def load_obj(path: str, create_texture_atlas: bool = False,
             texture_atlas_size: int = 4) -> Mesh:
    """Load an OBJ. With ``create_texture_atlas``, read its mtllib/usemtl
    materials and bake a per-face atlas from their map_Kd textures (Kd
    colours where a texture is missing or unreadable), if the file has
    materials or uv coordinates."""
    verts, colors, faces = [], [], []
    uvs = []
    face_uv_idx = []  # per triangle: (3,) vt indices, or None
    face_mtl = []  # per triangle: material name, or None
    has_colors = False
    materials: Dict[str, dict] = {}
    cur_mtl = None
    base = os.path.dirname(path)
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(x) for x in parts[1:4]])
                if len(parts) >= 7:
                    has_colors = True
                    colors.append([float(x) for x in parts[4:7]])
                else:
                    colors.append([0.5, 0.5, 0.5])
            elif line.startswith("vt "):
                parts = line.split()
                uvs.append([float(parts[1]), float(parts[2])])
            elif line.startswith("mtllib ") and create_texture_atlas:
                mtl_path = os.path.join(base, line.split(None, 1)[1].strip())
                if os.path.exists(mtl_path):
                    materials.update(parse_mtl(mtl_path))
            elif line.startswith("usemtl "):
                cur_mtl = line.split(None, 1)[1].strip()
            elif line.startswith("f "):
                comps = [p.split("/") for p in line.split()[1:]]
                idx = [int(c[0]) - 1 for c in comps]
                t_idx = [int(c[1]) - 1 if len(c) > 1 and c[1] else None
                         for c in comps]
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
                    tri_t = (t_idx[0], t_idx[k], t_idx[k + 1])
                    face_uv_idx.append(
                        tri_t if all(t is not None for t in tri_t) else None)
                    face_mtl.append(cur_mtl)
    if not verts or not faces:
        raise ValueError(f"{path}: no vertices/faces found (empty or non-OBJ file)")

    atlas = None
    # An atlas of defaults would shadow the vertex colours in render_mesh, so
    # bake only when the file carries texture information.
    if create_texture_atlas and (materials or uvs):
        uvs_np = np.asarray(uvs, np.float32).reshape(-1, 2)
        tex_cache: Dict[str, Optional[np.ndarray]] = {}

        def material_image(name):
            m = materials.get(name)
            if m is None:
                return None
            tex_path = m.get("map_Kd")
            if tex_path:
                if tex_path not in tex_cache:
                    tex_cache[tex_path] = _load_texture_image(tex_path)
                if tex_cache[tex_path] is not None:
                    return tex_cache[tex_path]
            return m["Kd"]

        face_uvs = np.zeros((len(faces), 3, 2), np.float32)
        face_images = []
        for i, (t, name) in enumerate(zip(face_uv_idx, face_mtl)):
            img = material_image(name)
            if t is not None and len(uvs_np):
                face_uvs[i] = uvs_np[list(t)]
            elif img is not None and np.ndim(img) > 1:
                img = img.mean(axis=(0, 1))  # no uvs: mean texture colour
            face_images.append(img)
        atlas = bake_texture_atlas(face_uvs, face_images,
                                   resolution=texture_atlas_size)

    return Mesh(np.asarray(verts, np.float32), np.asarray(faces, np.int32),
                np.asarray(colors, np.float32) if has_colors else None, atlas)


def save_obj(path: str, mesh: Mesh):
    with open(path, "w") as f:
        for i, v in enumerate(mesh.verts):
            if mesh.vert_colors is not None:
                c = mesh.vert_colors[i]
                f.write(f"v {v[0]} {v[1]} {v[2]} {c[0]} {c[1]} {c[2]}\n")
            else:
                f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for face in mesh.faces:
            f.write(f"f {face[0] + 1} {face[1] + 1} {face[2] + 1}\n")


def adjust_mesh(verts: np.ndarray, x_range: float = 1.0,
                center: bool = True) -> np.ndarray:
    """Scale so the largest extent is ``x_range``, optionally centred."""
    mn, mx = verts.min(0), verts.max(0)
    out = verts * (x_range / max(mx - mn))
    if center:
        out = out - (out.min(0) + out.max(0)) / 2
    return out


def _remap_atlas_winding_flip(atlas: np.ndarray) -> np.ndarray:
    """Resample a (F, R, R, 3) per-face atlas for faces whose vertex order
    was reversed, (v0, v1, v2) -> (v2, v1, v0): the barycentric roles of w0
    and w2 swap. Texel (iy, ix) holds the colour at (w0 = iy / (R - 1),
    w1 = ix / (R - 1)) after the simplex clip of ``bake_texture_atlas``; the
    flipped face's texel takes the old colour at (w0 = w2, w1 = w1),
    bilinearly."""
    R = atlas.shape[1]
    g = np.linspace(0.0, 1.0, R, dtype=np.float32)
    w0 = np.repeat(g[:, None], R, axis=1)
    w1 = np.repeat(g[None, :], R, axis=0)
    total = w0 + w1
    scale = np.where(total > 1.0, 1.0 / np.maximum(total, 1e-8), 1.0)
    w0c = w0 * scale
    w1c = w1 * scale
    w2c = np.clip(1.0 - w0c - w1c, 0.0, 1.0)
    gy = w2c * (R - 1)
    gx = w1c * (R - 1)
    y0 = np.floor(gy).astype(np.int64)
    x0 = np.floor(gx).astype(np.int64)
    y1 = np.minimum(y0 + 1, R - 1)
    x1 = np.minimum(x0 + 1, R - 1)
    wy = (gy - y0)[..., None]
    wx = (gx - x0)[..., None]
    out = (atlas[:, y0, x0] * (1 - wy) * (1 - wx)
           + atlas[:, y0, x1] * (1 - wy) * wx
           + atlas[:, y1, x0] * wy * (1 - wx)
           + atlas[:, y1, x1] * wy * wx)
    return out.astype(atlas.dtype)


def mirror_mesh(mesh: Mesh, axes) -> Mesh:
    """Mirror the vertices along ``axes``; an odd number of mirrors reverses
    the winding, so the faces are flipped and the texture atlas remapped to
    keep each face's colours."""
    verts = mesh.verts.copy()
    for a in axes:
        verts[:, a] = -verts[:, a]
    faces = mesh.faces.copy()
    atlas = mesh.texture_atlas
    if len(axes) % 2 == 1:
        faces = faces[:, ::-1].copy()
        if atlas is not None:
            atlas = _remap_atlas_winding_flip(atlas)
    return Mesh(verts, faces, mesh.vert_colors, atlas)
