"""The port's utils/export.py and the tester's export_results branch
against the JAX package's writers (macarons_tpu.utils.export), on the CPU:
equal arrays, byte-identical JSON and PLY files."""

import filecmp

import numpy as np
import pytest
import torch

from macarons_tpu.utils import export as JE
from macarons_tpu_torch.config import Params
from macarons_tpu_torch.ops.geometry import FoVCamera
from macarons_tpu_torch.scene.camera import get_camera_RT
from macarons_tpu_torch.testers import scene as tester
from macarons_tpu_torch.utils import export as E
from torch_port_helpers import TINY, make_scene_root, \
    torch_one_thread  # noqa: F401


def history(seed, n=12):
    rs = np.random.default_rng(seed)
    return (rs.normal(size=(n, 3)).astype(np.float32),
            rs.uniform(-60, 60, size=(n, 2)).astype(np.float32))


def test_vectors_and_look_at_points():
    """Blender axes both ways and the look-at points equal JAX's exactly,
    from numpy arrays and from tensors."""
    X, V = history(0)
    for fn in ("convert_vector_to_blender", "convert_blender_to_vector"):
        want = getattr(JE, fn)(X)
        np.testing.assert_array_equal(getattr(E, fn)(X), want)
        np.testing.assert_array_equal(getattr(E, fn)(torch.as_tensor(X)),
                                      want)
    want = JE.create_points_to_look_at(X, V, 2.5)
    np.testing.assert_array_equal(E.create_points_to_look_at(X, V, 2.5), want)
    np.testing.assert_array_equal(E.create_points_to_look_at(
        torch.as_tensor(X), torch.as_tensor(V), 2.5), want)


@pytest.mark.parametrize("n_interp, scale, jump, mirrored",
                         [(4, 2.0, 2, None), (2, 1.0, 1, [0, 2]),
                          (0, 10.0, 3, [1])])
def test_blender_curves_and_json(tmp_path, n_interp, scale, jump, mirrored):
    """The camera curves equal JAX's, and the JSON files are byte-identical
    (numpy inputs to JAX's writer, tensors to the port's)."""
    X, V = history(1)
    args = (n_interp, scale, 10.0, jump, mirrored)
    assert E.create_blender_curves(X, V, *args) == \
        JE.create_blender_curves(X, V, *args)
    a = JE.export_trajectory_blender(str(tmp_path / "jax.json"), X, V, *args)
    b = E.export_trajectory_blender(str(tmp_path / "sub" / "port.json"),
                                    torch.as_tensor(X), torch.as_tensor(V),
                                    *args)
    assert filecmp.cmp(a, b, shallow=False)


@pytest.mark.parametrize("with_colors", [False, True])
@pytest.mark.parametrize("with_valid", [False, True])
def test_ply_files(tmp_path, with_colors, with_valid):
    """ASCII PLYs byte-identical to JAX's, with and without colours and a
    validity mask."""
    rs = np.random.default_rng(2)
    pts = rs.normal(size=(50, 3)).astype(np.float32)
    colors = (rs.uniform(-0.2, 1.2, size=(50, 3)).astype(np.float32)
              if with_colors else None)
    valid = (rs.uniform(size=50) < 0.6) if with_valid else None
    a = JE.export_point_cloud_ply(str(tmp_path / "jax.ply"), pts, colors,
                                  valid)
    b = E.export_point_cloud_ply(
        str(tmp_path / "port.ply"), torch.as_tensor(pts),
        None if colors is None else torch.as_tensor(colors),
        None if valid is None else torch.as_tensor(valid))
    assert filecmp.cmp(a, b, shallow=False)
    lines = open(b).read().splitlines()
    n = int(valid.sum()) if with_valid else 50
    assert lines[2] == f"element vertex {n}"
    assert len(lines) == lines.index("end_header") + 1 + n


def test_plotly_wrappers():
    """Both packages' plotly figures: None without plotly, as JAX's."""
    pts = np.random.default_rng(3).normal(size=(30, 3)).astype(np.float32)
    have = JE.plot_point_cloud(pts) is not None
    assert (E.plot_point_cloud(torch.as_tensor(pts)) is not None) == have
    assert (E.plot_graph([0, 1, 2], [[1, 2, 3]], names=["a"]) is not None) \
        == (JE.plot_graph([0, 1, 2], [[1, 2, 3]], names=["a"]) is not None)


def test_look_at_points_match_camera_rays():
    """The look-at point lies camera_size ahead along the view ray of the
    port's get_camera_RT camera (tests/test_export.py's check, through the
    port's FoVCamera)."""
    X = np.array([[1.0, 2.0, 3.0]], np.float32)
    V = np.array([[25.0, 140.0]], np.float32)
    look = E.create_points_to_look_at(X, V, camera_size=2.0)
    R, T = get_camera_RT(torch.as_tensor(X), torch.as_tensor(V))
    cam = FoVCamera.create(R, T, zfar=10.0)
    lv = cam.world_to_view(torch.as_tensor(look)[None])[0, 0].numpy()
    np.testing.assert_allclose(lv[:2], 0.0, atol=1e-4)
    np.testing.assert_allclose(lv[2], 2.0, atol=1e-4)


def test_tester_exports_match_jax_writers(tmp_path_factory, monkeypatch):
    """run_test with export_results: each trajectory's files are
    byte-identical to JAX's writers fed the port's own camera history and
    surface grid."""
    root = make_scene_root(tmp_path_factory)
    out = tmp_path_factory.mktemp("results")
    seen = []
    own = tester.export_trajectory

    def recording(scene, params, export_dir, prefix="", jump_poses=1):
        pts, valid = scene.surface_scene.points, scene.surface_scene.valid
        seen.append((np.concatenate(scene.camera.X_cam_history, 0),
                     np.concatenate(scene.camera.V_cam_history, 0),
                     scene.camera.n_interpolation_steps,
                     pts.reshape(-1, 3).numpy().copy(),
                     valid.reshape(-1).numpy().copy(), export_dir, prefix))
        return own(scene, params, export_dir, prefix, jump_poses)

    monkeypatch.setattr(tester, "export_trajectory", recording)
    params = Params(dict(TINY, data_path=root, export_results=True,
                         scene_scale_factor=1.0))
    tester.run_test(params, results_dir=str(out), n_start_poses=2,
                    n_poses=2, device="cpu", verbose=False)
    assert [s[-1] for s in seen] == ["start_0_", "start_1_"]
    ref = tmp_path_factory.mktemp("jax_writers")
    for X, V, n_interp, pts, valid, edir, prefix in seen:
        a = JE.export_trajectory_blender(str(ref / f"{prefix}cameras.json"),
                                         X, V, n_interp, 1.0)
        assert filecmp.cmp(a, f"{edir}/{prefix}cameras.json", shallow=False)
        a = JE.export_point_cloud_ply(str(ref / f"{prefix}surface.ply"),
                                      pts, valid=valid)
        assert filecmp.cmp(a, f"{edir}/{prefix}surface.ply", shallow=False)
        assert valid.sum() > 0
