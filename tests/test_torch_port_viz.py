"""The port's utils/viz.py against the JAX package's
(macarons_tpu.utils.viz), on the CPU: the same arrays (tensors on the
port's side) drawn by both give equal images, read back with
matplotlib.image.imread."""

import matplotlib.image as mpimg
import numpy as np
import pytest
import torch

from macarons_tpu.utils import viz as JV
from macarons_tpu_torch.utils import viz as V


def draw_both(tmp_path, fn, *args, **kw):
    """Both packages' ``fn`` saved to PNGs; the images read back."""
    port_args = [torch.as_tensor(a) if isinstance(a, np.ndarray) else a
                 for a in args]
    a = getattr(JV, fn)(*args, save_path=str(tmp_path / "jax.png"), **kw)
    b = getattr(V, fn)(*port_args, save_path=str(tmp_path / "port.png"),
                       **kw)
    return mpimg.imread(a), mpimg.imread(b)


@pytest.mark.parametrize("shape, rgb", [((5, 12, 16, 3), True),
                                        ((3, 12, 16), False)])
def test_image_grid(tmp_path, shape, rgb):
    images = np.random.default_rng(0).uniform(-0.1, 1.1, shape).astype(
        np.float32)
    a, b = draw_both(tmp_path, "image_grid", images, rgb=rgb)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("colored", [False, True])
def test_plot_point_cloud(tmp_path, colored):
    rs = np.random.default_rng(1)
    pts = rs.normal(size=(200, 3)).astype(np.float32)
    colors = rs.uniform(size=(200, 3)).astype(np.float32) if colored \
        else None
    a, b = draw_both(tmp_path, "plot_point_cloud", pts, colors, title="pc")
    np.testing.assert_array_equal(a, b)


def test_plot_curves(tmp_path):
    curves = [np.linspace(0.0, 1.0, 11), np.linspace(0.0, 1.0, 11) ** 2]
    a = JV.plot_curves(curves, labels=["a", "b"], xlabel="pose",
                       ylabel="coverage", save_path=str(tmp_path / "j.png"))
    b = V.plot_curves([torch.as_tensor(c) for c in curves],
                      labels=["a", "b"], xlabel="pose", ylabel="coverage",
                      save_path=str(tmp_path / "p.png"))
    np.testing.assert_array_equal(mpimg.imread(a), mpimg.imread(b))
