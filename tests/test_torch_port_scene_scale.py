"""The scene-scale capture slice against the JAX package on the CPU.

synth_00 subdivided 3 times (chip_smoke.subdivide) has 14,848 faces, above
4 * max_faces_per_tile, so both packages' "auto" capture takes the binned
path here.

- The random-policy trajectory (3 poses), with the JAX package's GT surface
  grid injected as in test_torch_port_trajectory.py: identical cam_idx,
  coverage within 1e-3.
- One interpolated move captured by the port with the tiled path forced
  (kernels B1/B2 through their plain twins), against the JAX package's
  Pallas path (interpret mode) on the same cameras: identical face ids,
  depth within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import scene_scale_suite
from macarons_tpu.config import Params as JParams
from macarons_tpu.data.scenes import SceneDataset as JSceneDataset
from macarons_tpu.models.macarons import MacaronsVariables, \
    create_macarons_model as jcreate
from macarons_tpu.ops import rasterizer as jrast
from macarons_tpu.ops.geometry import FoVCamera as JFoVCamera
from macarons_tpu.scene.memory import Memory as JMemory
from macarons_tpu.testers import scene as jtester
from macarons_tpu.trainers import train_macarons as JTM
from macarons_tpu_torch.config import Params
from macarons_tpu_torch.data.scenes import SceneDataset
from macarons_tpu_torch.models.macarons import create_macarons_model, \
    init_macarons_weights
from macarons_tpu_torch.ops import rasterizer as rast
from macarons_tpu_torch.scene.memory import Memory
from macarons_tpu_torch.testers import scene as tester
from macarons_tpu_torch.trainers import train_macarons as TM
from torch_port_helpers import TINY, camera_to_torch, grid_to_torch, \
    torch_one_thread  # noqa: F401

N_POSES = 3


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return scene_scale_suite(str(tmp_path_factory.mktemp("scenes")), 3)


@pytest.fixture(scope="module")
def jax_random(root, tmp_path_factory):
    params = JParams(dict(TINY, data_path=root))
    item = JSceneDataset(root)[0]
    key = jax.random.PRNGKey(5)
    scene = JTM.setup_scene(params, item, key)
    assert scene.mesh.faces.shape[0] == 14848
    rt = JTM.MacaronsRuntime(params, jcreate(params), scene.cfg,
                             scene.cell_table)
    mem = str(tmp_path_factory.mktemp("jax_memory"))
    traj, _ = jtester.compute_trajectory(
        rt, scene, JMemory([mem]), mem, MacaronsVariables({}, None, None),
        key, np.random.default_rng(42), n_poses=N_POSES, surface_epsilon=0.15,
        start_idx=np.asarray(item["settings"].start_positions[0]),
        policy="random")
    return traj, scene.gt_scene


@pytest.fixture(scope="module")
def port_random(root, jax_random, tmp_path_factory):
    params = Params(dict(TINY, data_path=root))
    item = SceneDataset(root)[0]
    gen = torch.Generator().manual_seed(5)
    scene = TM.setup_scene(params, item, gen, "cpu")
    scene.gt_scene = grid_to_torch(jax_random[1])
    model = init_macarons_weights(create_macarons_model(params, "cpu"), gen)
    rt = TM.MacaronsRuntime(params, model, scene.cfg, scene.cell_table, "cpu")
    mem = str(tmp_path_factory.mktemp("port_memory"))
    traj = tester.compute_trajectory(
        rt, scene, Memory([mem]), mem, gen, np.random.default_rng(42),
        n_poses=N_POSES, surface_epsilon=0.15,
        start_idx=np.asarray(item["settings"].start_positions[0]),
        policy="random")
    return traj, scene


def test_random_trajectory_matches_jax(jax_random, port_random):
    jtraj, _ = jax_random
    traj, scene = port_random
    assert scene.faces_dev.shape[0] == 14848
    assert traj["cam_idx"] == jtraj["cam_idx"]
    np.testing.assert_allclose(traj["coverage"], jtraj["coverage"], atol=1e-3)
    assert jtraj["coverage"][-1] > jtraj["coverage"][0]


def test_tiled_move_capture_matches_jax_pallas(port_random, tmp_path,
                                               monkeypatch):
    _, scene = port_random
    cam = scene.camera
    rasterize = rast.rasterize
    calls = []

    def tiled(*args, **kw):
        calls.append(args[1].shape[0])
        return rasterize(*args, **dict(kw, method="tiled"))

    monkeypatch.setattr(rast, "rasterize", tiled)
    next_idx = cam.get_valid_neighbors(cam.get_neighboring_poses(),
                                       scene.verts_dev)[0]
    _, depth, mask, batch_cam = TM.move_and_capture(
        scene, Memory([str(tmp_path)]), str(tmp_path), next_idx)
    assert calls == [14848]
    jc = JFoVCamera.create(jnp.asarray(batch_cam.R.numpy()),
                           jnp.asarray(batch_cam.T.numpy()), zfar=cam.zfar)
    size = (cam.image_height, cam.image_width)
    ref = jrast.rasterize(jnp.asarray(scene.mesh.verts),
                          jnp.asarray(scene.mesh.faces), jc, size,
                          method="pallas", binning="pairlist",
                          perspective_correct=True)
    zbuf = np.asarray(ref.zbuf)
    assert depth.shape[0] == cam.n_interpolation_steps == 2
    np.testing.assert_allclose(depth[..., 0].numpy(), zbuf, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(mask[..., 0].numpy(), zbuf > -1)
    frags = rasterize(scene.verts_dev, scene.faces_dev, camera_to_torch(jc),
                      size, method="tiled")
    np.testing.assert_array_equal(frags.pix_to_face.numpy(),
                                  np.asarray(ref.pix_to_face))
    assert 0.2 < (zbuf > 0).mean() < 1.0
