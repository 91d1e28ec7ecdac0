"""Visualization helpers (port of macarons_tpu/utils/viz.py): an image
grid, a point-cloud scatter and line plots, drawn with matplotlib, which
each function imports when it is called. Tensors are read on the host."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


def _host(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def image_grid(images, rows: Optional[int] = None, cols: Optional[int] = None,
               fill: bool = True, show_axes: bool = False, rgb: bool = True,
               save_path: Optional[str] = None):
    """Grid of images (N, H, W, 3) or (N, H, W). Returns ``save_path`` once
    saved there, else the figure."""
    plt = _pyplot()
    images = _host(images)
    n = len(images)
    if rows is None:
        cols = cols or int(np.ceil(np.sqrt(n)))
        rows = int(np.ceil(n / cols))
    fig, axarr = plt.subplots(rows, cols, figsize=(2.5 * cols, 2.5 * rows),
                              squeeze=False)
    for i in range(rows * cols):
        ax = axarr[i // cols][i % cols]
        if i < n:
            ax.imshow(np.clip(images[i], 0, 1) if rgb else images[i])
        if not show_axes:
            ax.set_axis_off()
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=110)
        plt.close(fig)
        return save_path
    return fig


def plot_point_cloud(points, colors=None, s: float = 0.5,
                     save_path: Optional[str] = None, title: str = ""):
    """3-D scatter of a point cloud (y up), coloured by ``colors`` or by
    height. Returns ``save_path`` once saved there, else the figure."""
    plt = _pyplot()
    p = _host(points)
    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(111, projection="3d")
    c = _host(colors) if colors is not None else p[:, 1]
    ax.scatter(p[:, 0], p[:, 2], p[:, 1], s=s, c=c)
    ax.set_title(title)
    if save_path:
        fig.savefig(save_path, dpi=110)
        plt.close(fig)
        return save_path
    return fig


def plot_curves(curves: Sequence, labels: Optional[Sequence[str]] = None,
                xlabel: str = "", ylabel: str = "",
                save_path: Optional[str] = None):
    """Line plots, one per curve. Returns ``save_path`` once saved there,
    else the figure."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 4))
    for i, c in enumerate(curves):
        ax.plot(_host(c), label=labels[i] if labels else None)
    if labels:
        ax.legend()
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    if save_path:
        fig.savefig(save_path, dpi=110)
        plt.close(fig)
        return save_path
    return fig
