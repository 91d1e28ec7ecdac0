"""The slice against the JAX package on synth_00 at a tiny size (CPU).

Decision phase: the port's occupancy field and NBV scorer on a scene state
built by the JAX package (2 random-policy poses), converted to torch.
SconeOcc/SconeVis run at narrow widths with the same (converted) weights; the
scorer's Monte-Carlo sample indices are drawn by the JAX package's
sample_proxy_points with the scorer's own key split and injected into the
port.

Whole trajectory: the port's compute_trajectory against the JAX tester. The
ground-truth surface grid is sampled with jax.random in the JAX package and
with a torch.Generator in the port, so the port's scene takes the JAX
package's GT grid (injected draws). The other draws of the random policy
(fill_cells' shuffle and eviction order) change which points a grid cell
keeps only when the cell overflows its capacity, which this tiny scene does
not reach; the neighbour choice comes from the same numpy rs.

Both JAX trajectories share one JAX runtime, so its programs compile once.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from macarons_tpu.config import Params as JParams
from macarons_tpu.data.scenes import SceneDataset as JSceneDataset
from macarons_tpu.models.macarons import MacaronsVariables, \
    create_macarons_model as jcreate
from macarons_tpu.models.scone import SconeOcc as JSconeOcc
from macarons_tpu.models.scone import SconeVis as JSconeVis
from macarons_tpu.ops.geometry import FoVCamera as JFoVCamera
from macarons_tpu.ops.projection import points_in_fov_mask as jfov_mask
from macarons_tpu.ops.view_state import sample_proxy_points as jsample
from macarons_tpu.parallel.nbv import pad_candidates as jpad
from macarons_tpu.scene import runtime as jR
from macarons_tpu.scene.camera import get_camera_RT as jget_RT
from macarons_tpu.scene.memory import Memory as JMemory
from macarons_tpu.testers import scene as jtester
from macarons_tpu.trainers import train_macarons as JTM
from macarons_tpu_torch.config import Params
from macarons_tpu_torch.data.scenes import SceneDataset
from macarons_tpu_torch.models.macarons import MacaronsModel, \
    create_macarons_model, init_macarons_weights
from macarons_tpu_torch.models.scone import SconeOcc, SconeVis
from macarons_tpu_torch.scene import runtime as R
from macarons_tpu_torch.scene.grid import GridConfig
from macarons_tpu_torch.scene.memory import Memory
from macarons_tpu_torch.testers import scene as tester
from macarons_tpu_torch.trainers import train_macarons as TM
from macarons_tpu_torch.utils.convert import flax_to_torch
from torch_port_helpers import OCC_KW, TINY, VIS_KW, camera_to_torch, \
    grid_to_torch, make_scene_root, proxy_to_torch, random_flax_variables, \
    to_torch, torch_one_thread  # noqa: F401

N_POSES = 5


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_scene_root(tmp_path_factory)


@pytest.fixture(scope="module")
def jax_runtime(root):
    params = JParams(dict(TINY, data_path=root))
    item = JSceneDataset(root)[0]
    scene = JTM.setup_scene(params, item, jax.random.PRNGKey(5))
    rt = JTM.MacaronsRuntime(params, jcreate(params), scene.cfg,
                             scene.cell_table)
    return params, item, rt


def jax_random_trajectory(jax_runtime, n_poses, mem):
    """The JAX tester's random policy from start 0: (results, scene)."""
    params, item, rt = jax_runtime
    key = jax.random.PRNGKey(5)
    scene = JTM.setup_scene(params, item, key)
    traj, _ = jtester.compute_trajectory(
        rt, scene, JMemory([mem]), mem, MacaronsVariables({}, None, None),
        key, np.random.default_rng(42), n_poses=n_poses, surface_epsilon=0.15,
        start_idx=np.asarray(item["settings"].start_positions[0]),
        policy="random")
    return traj, scene


@pytest.fixture(scope="module")
def decision(jax_runtime, tmp_path_factory):
    params = jax_runtime[0]
    _, scene = jax_random_trajectory(
        jax_runtime, 2, str(tmp_path_factory.mktemp("jax_memory_2")))
    jocc, jvis = JSconeOcc(**OCC_KW), JSconeVis(**VIS_KW)
    occ_vars = random_flax_variables(jocc, 1, jnp.zeros((1, 300, 3)),
                                     jnp.zeros((1, 8, 3)),
                                     jnp.zeros((1, 8, 64)))
    vis_vars = random_flax_variables(jvis, 2, jnp.zeros((1, 64, 4)),
                                     jnp.zeros((1, 64, 64)))
    occ = SconeOcc(**OCC_KW).eval()
    occ.load_state_dict(flax_to_torch(occ_vars))
    vis = SconeVis(**VIS_KW).eval()
    vis.load_state_dict(flax_to_torch(vis_vars))
    return params, scene, jocc, occ_vars, occ, jvis, vis_vars, vis


def occupancy_args(params):
    return dict(n_elev=7, n_azim=14, degree=8, k_for_knn=params.k_for_knn,
                max_cells=params.n_cell_per_occ_forward_pass,
                cell_batch=params.occ_cell_batch)


@pytest.fixture(scope="module")
def fields(decision):
    params, scene, jocc, occ_vars, occ, *_ = decision
    pred_cam = scene.camera.fov_camera
    impl = jR.occupancy_field_impl(jocc, **occupancy_args(params))
    ref = impl(occ_vars, scene.proxy, scene.surface_scene,
               jR.device_cell_tables(scene.cfg, scene.cell_table, 3.0),
               pred_cam, jax.random.PRNGKey(0), full_field=True)
    field = R.OccupancyField(occ, **occupancy_args(params))
    ours = field(proxy_to_torch(scene.proxy),
                 grid_to_torch(scene.surface_scene),
                 R.device_cell_tables(GridConfig(*scene.cfg), scene.cell_table,
                                      3.0),
                 camera_to_torch(pred_cam), full_field=True)
    return ref, ours


def test_occupancy_field(fields):
    (jproba, jmask, jharm), (proba, mask, harm) = fields
    assert int(np.asarray(jmask).sum()) > 50
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_allclose(harm.numpy(), np.asarray(jharm), atol=1e-5)
    np.testing.assert_allclose(proba.numpy(), np.asarray(jproba), atol=1e-4)


def test_capped_field_tied_counts(decision):
    """The capped field (full_field=False) on the decision state with at
    most 2 eligible proxies per cell, so that more cells tie at 2 than the
    field takes: the same cells scored as the JAX package's top_k (the lower
    cell index first among ties) and the same outputs."""
    params, scene, jocc, occ_vars, occ, *_ = decision
    table = scene.cell_table
    slots, smask = table.proxy_slots, table.proxy_slot_mask
    proxy = scene.proxy
    sup = np.array(proxy.supervision_occ)
    elig = (sup[:, 0] > 0) & (np.asarray(proxy.out_of_field)[:, 0] < 1.0)
    counts = np.zeros(slots.shape[0], int)
    for c in range(slots.shape[0]):
        s = slots[c][smask[c]]
        s = s[elig[s]]
        sup[s[2:], 0] = 0.0
        counts[c] = min(len(s), 2)
    k = params.n_cell_per_occ_forward_pass
    assert (counts == 2).sum() > k and (counts > 2).sum() == 0
    proxy = proxy._replace(supervision_occ=jnp.asarray(sup))
    pred_cam = scene.camera.fov_camera
    jproba, jmask, jharm = jR.occupancy_field_impl(
        jocc, **occupancy_args(params))(
        occ_vars, proxy, scene.surface_scene,
        jR.device_cell_tables(scene.cfg, table, 3.0), pred_cam,
        jax.random.PRNGKey(0), full_field=False)
    proba, mask, harm = R.OccupancyField(occ, **occupancy_args(params))(
        proxy_to_torch(proxy), grid_to_torch(scene.surface_scene),
        R.device_cell_tables(GridConfig(*scene.cfg), table, 3.0),
        camera_to_torch(pred_cam), full_field=False)
    assert int(np.asarray(jmask).sum()) == 2 * k
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_allclose(harm.numpy(), np.asarray(jharm), atol=1e-5)
    np.testing.assert_allclose(proba.numpy(), np.asarray(jproba), atol=1e-4)


@pytest.fixture(scope="module")
def scoring_inputs(decision, fields):
    """The tester's field (carving fixture) and padded candidates."""
    params, scene, *_ = decision
    (_, _, jharm), _ = fields
    proxy = scene.proxy
    pred_mask = proxy.out_of_field[:, 0] < 1.0
    proba = proxy.supervision_occ
    proxy = proxy._replace(proba=jnp.where(pred_mask[:, None], proba,
                                           proxy.proba))
    field = jR.assemble_scene_field(proxy, proba, pred_mask, jharm)
    cam = scene.camera
    nbrs = cam.get_valid_neighbors(cam.get_neighboring_poses(),
                                   scene.verts_dev)
    poses = cam.pose_space.pose_from_idx(jnp.asarray(nbrs))
    R_c, T_c = jget_RT(poses[:, :3], poses[:, 3:])
    cams, X_cand, n = jpad(JFoVCamera.create(R_c, T_c, zfar=params.zfar),
                           poses[:, :3], 8)
    box_diag = float(np.linalg.norm(np.asarray(scene.cfg.x_max)
                                    - np.asarray(scene.cfg.x_min)))
    args = (cams, X_cand, cam.fov_camera, box_diag, scene.cfg.resolution,
            params.sensor_range)
    return field, args, n


def jax_draws(params, field, cams, key):
    """The scorer's per-candidate FoV selections and MC sample indices, as
    make_coverage_gain_fn's per-candidate path draws them (runtime.py:476-487,
    keys from jax.random.split(key, C)), and the shared path's one draw."""
    X_world, harm, occ, valid = field
    S, min_occ = params.seq_len, params.min_occ_for_proxy_points

    def one(R, T, fov, zfar, k):
        cam = JFoVCamera(R[None], T[None], fov[None], zfar[None] * 0 + 0.01,
                         zfar[None], jnp.ones_like(fov)[None])
        sel = jfov_mask(X_world[None], cam, params.image_height,
                        params.image_width,
                        fov_range=params.sensor_range)[0] & valid
        sel = sel & (occ[:, 0] > min_occ)
        return sel, jsample(k, X_world, occ, harm, S, min_occ,
                            valid_mask=sel)[2]

    @jax.jit
    def draws(key):
        keys = jax.random.split(key, cams.R.shape[0])
        sels, idx = jax.vmap(one)(cams.R, cams.T, cams.fov, cams.zfar, keys)
        shared = jsample(key, X_world, occ, harm, S, min_occ,
                         valid_mask=jnp.any(sels, axis=0))[2]
        return idx, shared

    return draws(key)


def torch_args(field, args):
    cams, X_cand, pred_cam, box_diag, res, sensor = args
    return ([to_torch(a) for a in field]
            + [camera_to_torch(cams), to_torch(X_cand),
               camera_to_torch(pred_cam), box_diag, res, sensor])


@pytest.mark.parametrize("shared", [False, True])
def test_coverage_gains(decision, scoring_inputs, shared):
    params, scene, _, _, _, jvis, vis_vars, vis = decision
    field, args, n = scoring_inputs
    k_cov = jax.random.PRNGKey(7)
    kw = dict(seq_len=params.seq_len, image_height=params.image_height,
              image_width=params.image_width,
              min_occ=params.min_occ_for_proxy_points)
    ref = jR.make_coverage_gain_fn(jvis, shared_sample=shared, **kw)(
        vis_vars, *field, *args, k_cov)
    per_candidate, one_draw = jax_draws(params, field, args[0], k_cov)
    idx = one_draw if shared else per_candidate
    ours = R.CoverageGain(shared_sample=shared, **kw)(
        vis, *torch_args(field, args), sample_idx=to_torch(idx))
    ref = np.asarray(ref)[:n]
    ours = ours.numpy()[:n]
    assert n >= 3 and np.count_nonzero(ref) >= 3
    np.testing.assert_allclose(ours, ref, rtol=1e-3, atol=1e-7)
    assert int(np.argmax(ours)) == int(np.argmax(ref))


@pytest.fixture(scope="module")
def jax_random(jax_runtime, tmp_path_factory):
    traj, scene = jax_random_trajectory(
        jax_runtime, N_POSES, str(tmp_path_factory.mktemp("jax_memory_5")))
    return traj, scene.gt_scene


def port_run(root, tmp_path, policy, n_poses, gt_scene=None):
    params = Params(dict(TINY, data_path=root))
    item = SceneDataset(root)[0]
    gen = torch.Generator().manual_seed(5)
    scene = TM.setup_scene(params, item, gen, "cpu")
    if gt_scene is not None:
        scene.gt_scene = grid_to_torch(gt_scene)
    # The default widths for the random policy (which runs no network), the
    # tests' narrow widths for nbv.
    model = (create_macarons_model(params, "cpu") if policy == "random" else
             MacaronsModel(SconeOcc(**OCC_KW).eval(), SconeVis(**VIS_KW).eval()))
    model = init_macarons_weights(model, gen)
    rt = TM.MacaronsRuntime(params, model, scene.cfg, scene.cell_table, "cpu")
    mem = str(tmp_path / policy)
    traj = tester.compute_trajectory(
        rt, scene, Memory([mem]), mem, gen, np.random.default_rng(42),
        n_poses=n_poses, surface_epsilon=0.15,
        start_idx=np.asarray(item["settings"].start_positions[0]),
        policy=policy)
    return traj, scene


def test_random_policy_matches_jax(root, jax_random, tmp_path):
    jtraj, jgt = jax_random
    traj, _ = port_run(root, tmp_path, "random", N_POSES, gt_scene=jgt)
    assert traj["cam_idx"] == jtraj["cam_idx"]
    np.testing.assert_allclose(traj["coverage"], jtraj["coverage"], atol=1e-3)
    np.testing.assert_allclose(traj["X_cam"], jtraj["X_cam"], atol=1e-5)
    np.testing.assert_allclose(traj["V_cam"], jtraj["V_cam"], atol=1e-4)
    assert jtraj["coverage"][-1] > jtraj["coverage"][0]


def test_nbv_policy_results_layout(root, jax_random, tmp_path):
    jtraj, _ = jax_random
    traj, scene = port_run(root, tmp_path, "nbv", 3)
    assert set(traj) == set(jtraj)
    steps = scene.camera.n_interpolation_steps
    for k, v in traj.items():
        ref = np.asarray(jtraj[k])
        rows = {"coverage": 4, "cam_idx": 4}.get(k, 1 + 3 * steps)
        assert np.asarray(v).shape == (rows,) + ref.shape[1:], k
        assert len(ref) == {"coverage": 6, "cam_idx": 6}.get(
            k, 1 + N_POSES * steps)
    cov = np.asarray(traj["coverage"])
    assert np.all(np.diff(cov) >= -1e-6) and cov[-1] > cov[0]
    json.dumps(traj)


def test_run_test_cpu_and_cuda_default(root, tmp_path):
    params = Params(dict(TINY, data_path=root))
    res = tester.run_test(params, results_dir=str(tmp_path),
                          results_name="res.json", n_start_poses=1, n_poses=1,
                          memory_root=str(tmp_path / "mem"), policy="carving",
                          device="cpu", verbose=False)
    with open(tmp_path / "res.json") as f:
        assert json.load(f) == json.loads(json.dumps(res))
    assert list(res) == ["synth_00"] and len(res["synth_00"]["0"]["coverage"]) == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tester.run_test(params, results_dir=str(tmp_path), n_poses=1,
                            verbose=False)
