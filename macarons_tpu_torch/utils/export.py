"""Trajectory and point-cloud export for offline visualization (port of
macarons_tpu/utils/export.py).

The reference testers' Blender-export branch and its render_utils plots:
look-at points, Blender axes, camera curves as JSON, an ASCII PLY of a
point cloud, and plotly figures. Host-side numpy: tensors (on any device)
are copied to the host first, so the files are byte for byte the JAX
package's for the same arrays. The plotly wrappers return None without
plotly.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch


def _host(x):
    """``x`` as the JAX package would read it: a tensor's values on the
    host, anything else as it is."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else x


def create_points_to_look_at(X_cam, V_cam, camera_size: float):
    """The point ``camera_size`` ahead of each pose along its view ray.

    X_cam (N, 3); V_cam (N, 2) (elev, azim) in degrees. Returns (N, 3)."""
    X_cam = np.asarray(_host(X_cam), np.float32).reshape(-1, 3)
    V_cam = np.asarray(_host(V_cam), np.float32).reshape(-1, 2)
    elev = np.deg2rad(-V_cam[:, 0])
    azim = np.deg2rad(180.0 + V_cam[:, 1])
    rays = -np.stack((np.cos(elev) * np.sin(azim), np.sin(elev),
                      np.cos(elev) * np.cos(azim)), axis=-1)
    return X_cam + camera_size * rays


def convert_vector_to_blender(vec):
    """World axes -> Blender axes: (x, y, z) -> (x, -z, y)."""
    v = np.array(_host(vec), np.float32)
    out = v.copy()
    out[..., 1] = -v[..., 2]
    out[..., 2] = v[..., 1]
    return out


def convert_blender_to_vector(vec):
    """The inverse of convert_vector_to_blender."""
    v = np.array(_host(vec), np.float32)
    out = v.copy()
    out[..., 1] = v[..., 2]
    out[..., 2] = -v[..., 1]
    return out


def create_blender_curves(X_cam_history, V_cam_history,
                          n_interpolation_steps: int,
                          scene_scale_factor: float = 1.0,
                          cam_size: float = 10.0, jump_poses: int = 1,
                          mirrored_axes=None):
    """Camera-position and look-at curves in Blender coordinates, one point
    per real pose (every ``jump_poses``-th, from index
    ``n_interpolation_steps`` of the frame history).

    Returns (camera_X, camera_look) as nested lists (JSON-ready)."""
    X = np.asarray(_host(X_cam_history), np.float32).reshape(-1, 3)
    V = np.asarray(_host(V_cam_history), np.float32).reshape(-1, 2)
    X = X[n_interpolation_steps::jump_poses]
    V = V[n_interpolation_steps::jump_poses]
    look = create_points_to_look_at(X, V, cam_size * scene_scale_factor)
    camera_X = convert_vector_to_blender(X)
    camera_look = convert_vector_to_blender(look)
    if mirrored_axes:
        for a in mirrored_axes:
            camera_X[..., a] *= -1.0
            camera_look[..., a] *= -1.0
    camera_X = camera_X / scene_scale_factor
    camera_look = camera_look / scene_scale_factor
    return camera_X.tolist(), camera_look.tolist()


def export_trajectory_blender(path: str, X_cam_history, V_cam_history,
                              n_interpolation_steps: int,
                              scene_scale_factor: float = 1.0,
                              cam_size: float = 10.0, jump_poses: int = 1,
                              mirrored_axes=None):
    """Write the Blender camera curves as JSON ``{"camera_X",
    "camera_look"}``. Returns ``path``."""
    cx, cl = create_blender_curves(
        X_cam_history, V_cam_history, n_interpolation_steps,
        scene_scale_factor, cam_size, jump_poses, mirrored_axes)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump({"camera_X": cx, "camera_look": cl}, f)
    return path


def export_point_cloud_ply(path: str, points, colors=None, valid=None):
    """ASCII PLY of the points (those where ``valid``, if given), with
    uchar RGB from ``colors`` in [0, 1] if given. Returns ``path``."""
    pts = np.asarray(_host(points), np.float32).reshape(-1, 3)
    colors = _host(colors)
    if valid is not None:
        v = np.asarray(_host(valid)).reshape(-1).astype(bool)
        pts = pts[v]
        if colors is not None:
            colors = np.asarray(colors).reshape(-1, np.shape(colors)[-1])[v]
    n = len(pts)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
        f.write("end_header\n")
        if colors is not None:
            c = np.clip(np.asarray(colors, np.float32)[:, :3], 0, 1)
            c = (c * 255).astype(np.uint8)
            for p, ci in zip(pts, c):
                f.write(f"{p[0]} {p[1]} {p[2]} {ci[0]} {ci[1]} {ci[2]}\n")
        else:
            for p in pts:
                f.write(f"{p[0]} {p[1]} {p[2]}\n")
    return path


def plot_point_cloud(points, features=None, name: str = "", point_size: int = 2,
                     max_points: int = 20000, cmap: str = "rgb"):
    """Plotly 3-D scatter of a point cloud, at most ``max_points`` of them
    (a seeded subsample). Returns a plotly Figure, or None without
    plotly."""
    try:
        import plotly.graph_objs as go
    except ImportError:
        return None
    pts = np.asarray(_host(points), np.float32).reshape(-1, 3)
    features = _host(features)
    if len(pts) > max_points:
        idx = np.random.default_rng(0).choice(len(pts), max_points,
                                              replace=False)
        pts = pts[idx]
        if features is not None:
            features = np.asarray(features).reshape(
                len(np.asarray(features)), -1)[idx]
    color = None
    if features is not None:
        feat = np.asarray(features, np.float32)
        if cmap == "gray":
            feat = np.repeat(feat.reshape(-1, 1), 3, axis=-1)
        elif cmap == "rainbow":
            feat = (pts - pts.min()) / max(pts.max() - pts.min(), 1e-8)
        color = ["rgb({},{},{})".format(*(np.clip(c, 0, 1) * 255).astype(int))
                 for c in feat.reshape(-1, feat.shape[-1])[:, :3]]
    return go.Figure(data=[go.Scatter3d(
        x=pts[:, 0], y=pts[:, 1], z=pts[:, 2], mode="markers",
        marker=dict(size=point_size, color=color), name=name)])


def plot_graph(x, y, x_label: str = "X-axis", y_label: str = "Y-axis",
               title: Optional[str] = None, names=None):
    """Plotly line-and-marker curves, one per entry of ``y`` if it is a
    list. Returns a plotly Figure, or None without plotly."""
    try:
        import plotly.graph_objs as go
    except ImportError:
        return None
    ys = y if isinstance(y, list) else [y]
    data = []
    for i, yi in enumerate(ys):
        kw = {"name": names[i]} if names else {}
        data.append(go.Scatter(x=_host(x), y=_host(yi), mode="lines+markers",
                               **kw))
    return go.Figure(data=data, layout=go.Layout(
        title=title, xaxis=dict(title=x_label), yaxis=dict(title=y_label)))
