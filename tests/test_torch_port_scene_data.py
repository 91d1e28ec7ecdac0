"""Scene-data generation: the port against the JAX package on the CPU.

``compute_scene_settings``; ``front_face_mask`` on random meshes and
cameras; ``compute_occupied_poses`` on the JAX package's own test (the
cube of tests/test_scene_data_gen.py, 27 lattice positions at 32 x 32, the
scan path) and on that cube subdivided to 12,288 faces (above 4096: the
binned path on both sides), the JAX side's poses and renders read through
its ``get_camera_RT`` and ``render_mesh``; and both CLIs on one scene
directory. The JAX function returns no poses or differences: the test
records the pose of each position's renders and their mean absolute
difference as the JAX function computes it.
"""

import json
import os
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import closed_cube as cube, subdivide
from macarons_tpu.data.mesh_io import Mesh as JMesh
from macarons_tpu.data.scenes import compute_occupied_poses as jcompute
from macarons_tpu.data.scenes import compute_scene_settings as jsettings
from macarons_tpu.ops import geometry as jgeo
from macarons_tpu.ops import rasterizer as jras
from macarons_tpu.scene import camera as jcamera
from macarons_tpu.scene.camera import PoseSpace as JPoseSpace
from macarons_tpu_torch.data import generate_scene_data as GSD
from macarons_tpu_torch.data.mesh_io import save_obj
from macarons_tpu_torch.data.scenes import compute_occupied_poses, \
    compute_scene_settings, pose_camera
from macarons_tpu_torch.ops import geometry as geo
from macarons_tpu_torch.ops import rasterizer as ras
from macarons_tpu_torch.scene.camera import PoseSpace
from torch_port_helpers import torch_one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIFF_ATOL = 1e-6


@pytest.mark.parametrize("cell_size,pose_step", [(1.0, 1.0), (0.3, 2.0),
                                                 (5.0, 0.7)])
def test_compute_scene_settings(cell_size, pose_step):
    rs = np.random.default_rng(0)
    for verts in (cube(2.0).verts, (rs.normal(size=(50, 3)) * [4, 1, 3]
                                    + [1, 2, -1]).astype(np.float32)):
        ours = compute_scene_settings(verts, cell_size, pose_step)
        ref = jsettings(verts, cell_size, pose_step)
        assert json.dumps(ours) == json.dumps(ref)


def test_front_face_mask():
    """Identical masks on random meshes, cameras outside and inside them."""
    rs = np.random.default_rng(1)
    for trial in range(6):
        verts = rs.normal(size=(40, 3)).astype(np.float32) * 2
        faces = rs.integers(0, 40, size=(200, 3)).astype(np.int32)
        faces = faces[(faces[:, 0] != faces[:, 1])
                      & (faces[:, 1] != faces[:, 2])
                      & (faces[:, 0] != faces[:, 2])]
        eye = rs.normal(size=(1, 3)).astype(np.float32) * (
            0.5 if trial % 2 else 6.0)
        at = rs.normal(size=(1, 3)).astype(np.float32)
        R, T = geo.look_at_view_transform(torch.as_tensor(eye),
                                          torch.as_tensor(at))
        ours = ras.front_face_mask(
            torch.as_tensor(verts), torch.as_tensor(faces).long(),
            geo.FoVCamera.create(R, T))
        ref = jras.front_face_mask(
            jnp.asarray(verts), jnp.asarray(faces),
            jgeo.FoVCamera.create(jnp.asarray(R.numpy()),
                                  jnp.asarray(T.numpy())))
        assert 0 < int(ours.sum()) < len(faces)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def jax_occupied_poses(monkeypatch, mesh, ps, **kw):
    """The JAX function's result, the pose (X, elev, azim) each position's
    renders took, its difference, and the number of directions drawn."""
    log = {"pose": [], "used": [], "images": []}
    get_rt, render = jcamera.get_camera_RT, jras.render_mesh

    def rt(X, V):
        log["pose"].append(np.concatenate([np.asarray(X).reshape(3),
                                           np.asarray(V).reshape(2)]))
        return get_rt(X, V)

    def rendering(*a, **k):
        out = render(*a, **k)
        if len(log["images"]) % 2 == 0:
            log["used"].append(log["pose"][-1])
        log["images"].append(out[0])
        return out

    with monkeypatch.context() as mp:
        mp.setattr(jcamera, "get_camera_RT", rt)
        mp.setattr(jras, "render_mesh", rendering)
        out = jcompute(JMesh(mesh.verts, mesh.faces, mesh.vert_colors), ps,
                       **kw)
    normal, culled = log["images"][0::2], log["images"][1::2]
    diff = [float(jnp.mean(jnp.abs(a - b))) for a, b in zip(normal, culled)]
    assert len(diff) == len(out["X_idx"]) == len(log["used"])
    return out, diff, np.stack(log["used"]), len(log["pose"]) - len(diff)


def near_plane(mesh, pose):
    """Whether the view at ``pose`` projects a vertex in front of the
    camera to beyond 1e4 in NDC (one within ~1e-4 of the camera plane):
    the edge functions of its faces then take products near 1e13, whose
    float32 rounding (XLA's order against PyTorch's) decides pixels."""
    vp = ras.project_verts_batch(torch.as_tensor(mesh.verts),
                                 pose_camera(pose))[0]
    front = vp[:, 2] > 1e-8
    return bool(vp[front, :2].abs().max() > 1e4)


def assert_same_poses(ours, ref, mesh):
    """The same positions, flags and poses; the differences within
    DIFF_ATOL except at views with a vertex at the camera plane
    (``near_plane``), where only the flag is held."""
    out, diff, poses, _ = ref
    np.testing.assert_array_equal(ours["X_idx"], out["X_idx"])
    np.testing.assert_array_equal(ours["occupied"], out["occupied"])
    np.testing.assert_allclose(ours["poses"], poses, rtol=0, atol=1e-6)
    ill = np.array([near_plane(mesh, p) for p in ours["poses"]])
    assert ill.sum() < len(ill) / 2
    np.testing.assert_allclose(ours["diff"][~ill], np.asarray(diff)[~ill],
                               rtol=0, atol=DIFF_ATOL)


def test_occupied_poses_cube(monkeypatch):
    """The JAX package's test: centre occupied, corners free; the port
    takes the same resampled directions and differences."""
    mesh = cube(1.0)
    ps_args = (np.array([-3.0, -3, -3]), np.array([3.0, 3, 3]), 3, 3, 3, 3,
               8)
    ref = jax_occupied_poses(monkeypatch, mesh, JPoseSpace(*ps_args),
                             image_size=(32, 32))
    ours = compute_occupied_poses(mesh, PoseSpace(*ps_args),
                                  image_size=(32, 32), device="cpu")
    assert ref[3] > 0  # some corners looked away from the cube at first
    assert_same_poses(ours, ref, mesh)
    grid = {tuple(x): bool(o) for x, o in zip(ours["X_idx"],
                                                ours["occupied"])}
    assert grid[(1, 1, 1)]
    assert not any(grid[(i, j, k)] for i in (0, 2) for j in (0, 2)
                   for k in (0, 2))


def test_occupied_poses_binned(monkeypatch):
    """The cube subdivided to 12,288 faces: both packages' binned CPU path
    at 32 x 32, with the face mask in the tile lists."""
    mesh = subdivide(cube(1.0), 5)
    assert len(mesh.faces) == 12288
    ps_args = (np.array([-3.0, -3, -3]), np.array([3.0, 3, 3]), 3, 3, 3, 3,
               8)
    ref = jax_occupied_poses(monkeypatch, mesh, JPoseSpace(*ps_args),
                             image_size=(32, 32))
    ours = compute_occupied_poses(mesh, PoseSpace(*ps_args),
                                  image_size=(32, 32), device="cpu")
    assert_same_poses(ours, ref, mesh)
    assert ours["occupied"][13]  # the centre


def test_generate_scene_data_cli(tmp_path):
    """Both CLIs on copies of one scene directory: the same settings.json
    and occupied_pose.npz; the port's defaults to the card."""
    scene = tmp_path / "port" / "box"
    os.makedirs(scene)
    save_obj(str(scene / "mesh.obj"), cube(1.0))
    shutil.copytree(tmp_path / "port", tmp_path / "jax")
    out = GSD.main(["--data_path", str(tmp_path / "port"), "--device",
                    "cpu"])
    assert list(out) == ["box"] and len(out["box"]["X_idx"]) == 27
    env = dict(os.environ, MACARONS_PLATFORM="cpu", JAX_PLATFORMS="cpu",
               MACARONS_CACHE_DIR=str(tmp_path / "cache"))
    subprocess.run([sys.executable, os.path.join(
        REPO, "data_tools", "generate_scene_data.py"), "--data_path",
        str(tmp_path / "jax")], check=True, env=env, capture_output=True)
    for side in ("port", "jax"):
        assert sorted(os.listdir(tmp_path / side / "box")) == [
            "mesh.obj", "occupied_pose.npz", "settings.json"]
    ours, ref = (tmp_path / s / "box" for s in ("port", "jax"))
    assert json.loads((ours / "settings.json").read_text()) == \
        json.loads((ref / "settings.json").read_text())
    with np.load(ours / "occupied_pose.npz") as a, \
            np.load(ref / "occupied_pose.npz") as b:
        assert set(a) == set(b) == {"X_idx", "occupied"}
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
        assert a["occupied"].sum() > 13  # the lattice spans the box
    # Files that exist are kept unless --recompute.
    stamp = os.path.getmtime(ours / "occupied_pose.npz")
    assert GSD.main(["--data_path", str(tmp_path / "port"),
                     "--device", "cpu"]) == {}
    assert os.path.getmtime(ours / "occupied_pose.npz") == stamp
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            GSD.main(["--data_path", str(tmp_path / "port"), "--recompute"])
