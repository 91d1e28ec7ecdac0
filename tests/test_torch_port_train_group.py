"""Scene-group training (``n_parallel_scenes`` > 1) on one device: the port
against the JAX package on the CPU.

Two scenes with different grids (a 3x3x3 and a 3x3x2 cube scene, as the
JAX package's tests/test_train_parallel.py builds them), at tiny widths:

- the group depth step: each scene's supervision window built from its own
  frames and concatenated, one depth step, against the JAX trainer's
  ``depth_train_step`` on the batch that ``_ring_scene_batches`` makes of
  the two scenes' stacked frame rings (called eagerly; the JAX side in
  float64 as in test_torch_port_train_steps.py, the augmentation's
  factors injected): the loss, the BatchNorm statistics over both scenes'
  frames, every gradient, the parameters after AdamW, and each scene's
  slices of depth, masks and cameras;
- the group SCONE step against ``make_parallel_scone_step`` on the
  stacked, padded inputs, each scene's cell noise and MC sample drawn from
  its own split key and injected (the noise over the group's padded cell
  count, scene i taking its first C_i entries; a padded cell has no
  eligible proxy, so it ranks below every real one): the mean losses,
  every SconeOcc and SconeVis gradient, the parameters after AdamW;
- ``memory_depth_loop``'s sample count at scales 1 and 4;
- ``run_training``'s group loop with its trajectories and scene set-up
  scripted on both sides (group membership, the mirroring draws' order,
  the trailing group of one, the epoch losses), and the pinned
  ``n_devices`` checks;
- a 1-epoch, 2-pose ``run_training`` at group 2 on the CPU: its own
  invariants.
"""

import copy
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from macarons_tpu.config import Params as JParams
from macarons_tpu.models.macarons import MacaronsModel as JMacaronsModel
from macarons_tpu.models.macarons import create_macarons_model as jcreate
from macarons_tpu.models.scone import SconeOcc as JSconeOcc
from macarons_tpu.models.scone import SconeVis as JSconeVis
from macarons_tpu.ops.geometry import FoVCamera as JFoVCamera
from macarons_tpu.parallel import scene_dp as JSDP
from macarons_tpu.scene import depth_runtime as jdr
from macarons_tpu.scene import grid as jG
from macarons_tpu.scene import proxy as jP
from macarons_tpu.scene import runtime as jR
from macarons_tpu.trainers import train_macarons as JTM
from macarons_tpu_torch.config import Params
from macarons_tpu_torch.data.mesh_io import Mesh, save_obj
from macarons_tpu_torch.data.scenes import SceneDataset
from macarons_tpu_torch.models.macarons import MacaronsModel, \
    create_optimizers
from macarons_tpu_torch.models.scone import SconeOcc, SconeVis
from macarons_tpu_torch.ops.geometry import FoVCamera
from macarons_tpu_torch.parallel.scene_dp import SceneSupervision
from macarons_tpu_torch.scene import runtime as R
from macarons_tpu_torch.scene.camera import get_camera_RT
from macarons_tpu_torch.scene.memory import Memory
from macarons_tpu_torch.testers import scene as tester
from macarons_tpu_torch.trainers import train_macarons as TM
from macarons_tpu_torch.utils.convert import flax_to_torch
from test_torch_port_train_epochs import random_variables
from test_torch_port_train_scone import check_network, jax_draws, with_grads
from test_torch_port_train_steps import DEPTH, assert_adam_step, \
    assert_grads, assert_stats, f64, frames_for, many_depth_pair
from torch_port_helpers import OCC_KW, TINY, VIS_KW, random_flax_variables, \
    torch_one_thread  # noqa: F401

SCONE = dict(occ_curriculum_max_cells=4,
             n_proxy_point_for_occupancy_supervision=200)
N_ACTIVE = 3
N_SUP = SCONE["n_proxy_point_for_occupancy_supervision"]
# One surface capacity for both scenes of the SCONE group test: the JAX
# group step pads each scene's grid to the group's largest capacity, which
# changes its own result (test_group_capacity_padding).
CAPACITY = 90
SCENES = ("cube_a", "cube_b", "cube_c")


def cube(scale):
    corners = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                        for z in (-1, 1)], np.float32) * scale
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6),
             (0, 2, 6, 4), (1, 5, 7, 3)]
    faces = np.array([f for a, b, c, d in quads
                      for f in ((a, b, c), (a, c, d))], np.int64)
    return corners, faces


@pytest.fixture(scope="module")
def cube_root(tmp_path_factory):
    """Three cube scenes; cube_a's grid is 3x3x3, the others' 3x3x2."""
    root = tmp_path_factory.mktemp("cube_scenes")
    for name, scale in zip(SCENES, (1.0, 0.8, 0.9)):
        d = root / name
        d.mkdir()
        verts, faces = cube(scale)
        save_obj(str(d / "mesh.obj"), Mesh(verts, faces, (
            verts / (2 * scale) + 0.5).astype(np.float32)))
        (d / "settings.json").write_text(json.dumps({
            "scene": {"x_min": [-1.3] * 3, "x_max": [1.3] * 3,
                      "grid_l": 3, "grid_w": 3,
                      "grid_h": 3 if name == "cube_a" else 2},
            "camera": {"x_min": [-4] * 3, "x_max": [4] * 3, "pose_l": 4,
                       "pose_w": 4, "pose_h": 4, "pose_n_elev": 3,
                       "pose_n_azim": 8, "start_positions": []},
            "contrast_factor": 1.0}))
    return str(root)


# ---------------------------------------------------------------------------
# The group depth step
# ---------------------------------------------------------------------------


def test_group_depth_step():
    """Two scenes' supervision windows, one depth step, against JAX
    depth_train_step on _ring_scene_batches of the stacked rings."""
    params = Params(dict(TINY, **DEPTH, data_augmentation=True,
                         jitter_probability=1.0, symmetry_probability=1.0))
    jparams = JParams(params.to_dict())
    jrt = JTM.MacaronsRuntime(jparams, jcreate(jparams))
    _, v, m = many_depth_pair(3, 1, 2)
    L = jrt.ring_length()
    frames = [frames_for(np.random.default_rng(20 + s), L) for s in (0, 1)]

    rings = []
    for fr in frames:
        ring = jdr.init_frame_ring(L, TINY["image_height"],
                                   TINY["image_width"], TINY["zfar"])
        rings.append(jdr.ring_push(ring, fr["images"], fr["zbuf"],
                                   fr["mask"], fr["R"], fr["T"],
                                   TINY["zfar"]))
    jbatch, jalpha = jrt._ring_scene_batches(JSDP.stack_scene_group(rings))
    key = jax.random.PRNGKey(4)
    jrt.depth_tx = with_grads(jrt.depth_tx)
    with jax.enable_x64(True):
        # The factors as the step draws them, under x64.
        _, _, k_j, _ = jax.random.split(key, 4)
        draws = {"jitter": True, "symmetry": True, "factors": tuple(
            float(f) for f in jdr.sample_jitter_factors(k_j, jrt.dcfg))}
        v64 = f64(v)
        new_vars, (_, jgrads), jloss, jdepth, jmask, jerr = \
            jrt.depth_train_step(v64, jrt.depth_tx.init(v64["params"]),
                                 f64(jbatch), f64(jalpha), key)

    model = MacaronsModel(SconeOcc(**OCC_KW), SconeVis(**VIS_KW), m)
    rt = TM.MacaronsRuntime(params, model, device="cpu")
    opts = create_optimizers(params, model)
    scenes = []
    for fr in frames:
        scene = types.SimpleNamespace(ring=None)
        TM.push_frames(rt, scene, *(torch.as_tensor(fr[k]) for k in (
            "images", "zbuf", "mask", "R", "T")))
        scenes.append(scene)
    batch, alpha = TM.group_supervision_batch(rt, scenes)
    F = TINY["n_interpolation_steps"]
    assert batch["images"].shape[0] == 2 * F
    for k in ("images", "R", "T"):
        np.testing.assert_array_equal(batch[k].numpy(), np.asarray(jbatch[k]),
                                      err_msg=k)
    np.testing.assert_array_equal(alpha["images"].numpy(),
                                  np.asarray(jalpha["images"]))
    loss, depth, mask, err = rt.depth_train_step(opts["depth"], batch, alpha,
                                                 draws=draws)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    named = list(rt.model.depth.named_parameters())
    assert_grads(named, jgrads)
    assert_adam_step(named, new_vars["params"], jgrads)
    stats = flax_to_torch({"params": new_vars["params"],
                           "batch_stats": new_vars["batch_stats"]})
    state = rt.model.depth.state_dict()
    for k, a in stats.items():
        if "running" in k:
            assert_stats(state[k], a, k)
    # Each scene's slice of the step's outputs, in scene order.
    for s in (0, 1):
        sl = slice(s * F, (s + 1) * F)
        np.testing.assert_allclose(depth[sl].numpy(),
                                   np.asarray(jdepth)[sl], rtol=1e-4)
        np.testing.assert_array_equal(mask[sl].numpy(), np.asarray(jmask)[sl])
        np.testing.assert_array_equal(err[sl].numpy(), np.asarray(jerr)[sl])
        # The scene's slice of the batch is its own window's batch.
        own, own_alpha = TM.create_batch_for_depth_model(
            rt.dcfg, TM.window_frames(rt, scenes[s], rt.ring_length()),
            "supervision")
        for k in ("images", "R", "T", "mask"):
            torch.testing.assert_close(batch[k][sl], own[k], rtol=0, atol=0)
        torch.testing.assert_close(alpha["images"][sl], own_alpha["images"],
                                   rtol=0, atol=0)


# ---------------------------------------------------------------------------
# The group SCONE step
# ---------------------------------------------------------------------------


def nudged(cam):
    """``cam`` turned by 1e-3 rad about a generic axis. A lattice pose of
    the cube scenes looks along exact multiples of 45 degrees, which puts
    some of the view-state directions exactly on bin boundaries
    (test_view_bins_at_lattice_cameras); there rounding decides the bin,
    and the JAX package's own single-scene and group programs disagree."""
    axis = torch.tensor([0.3, 0.5, 0.8]) / np.linalg.norm([0.3, 0.5, 0.8])
    K = torch.tensor([[0.0, -axis[2], axis[1]], [axis[2], 0.0, -axis[0]],
                      [-axis[1], axis[0], 0.0]])
    rot = torch.linalg.matrix_exp(1e-3 * K)
    return FoVCamera.create(cam.R @ rot, cam.T, zfar=TINY["zfar"])


@pytest.fixture(scope="module")
def group_inputs(cube_root, tmp_path_factory):
    """SCONE weights for both packages and, for cube_a and cube_b, the
    port's scene after two random-policy poses and the step's other inputs
    made from a seed. Both grids hold CAPACITY points a cell."""
    params = Params(dict(TINY, data_path=cube_root,
                         surface_cell_capacity=CAPACITY, **SCONE))
    occ_vars = random_flax_variables(JSconeOcc(**OCC_KW), 1,
                                     jnp.zeros((1, 300, 3)),
                                     jnp.zeros((1, 8, 3)),
                                     jnp.zeros((1, 8, 64)))
    vis_vars = random_flax_variables(JSconeVis(**VIS_KW), 2,
                                     jnp.zeros((1, 64, 4)),
                                     jnp.zeros((1, 64, 64)))
    occ, vis = SconeOcc(**OCC_KW), SconeVis(**VIS_KW)
    occ.load_state_dict(flax_to_torch(occ_vars))
    vis.load_state_dict(flax_to_torch(vis_vars))
    model = MacaronsModel(occ.eval(), vis.eval(), None)
    rt = TM.MacaronsRuntime(params, model, device="cpu")
    dataset = SceneDataset(cube_root)
    scenes, group = [], []
    for i, name in enumerate(SCENES[:2]):
        item = dataset[dataset.scene_names.index(name)]
        gen = torch.Generator().manual_seed(5 + i)
        scene = TM.setup_scene(params, item, gen, "cpu")
        rt.bind_scene(scene.cfg, scene.cell_table)
        rs = np.random.default_rng(42 + i)
        start = scene.camera.get_random_valid_pose(
            rs, scene.verts_dev, proxy_points=scene.proxy.points)
        mem = str(tmp_path_factory.mktemp("memory"))
        tester.compute_trajectory(rt, scene, Memory([mem]), mem, gen, rs,
                                  n_poses=2, surface_epsilon=0.15,
                                  start_idx=start, policy="random")
        rs = np.random.default_rng(11 + i)
        proxy = scene.proxy
        N = proxy.points.shape[0]
        in_field = proxy.out_of_field[:, 0] < 1.0
        cam = scene.camera
        nbrs = cam.get_valid_neighbors(cam.get_neighboring_poses(),
                                       scene.verts_dev)[:3]
        poses = torch.as_tensor(cam.pose_space.pose_from_idx(nbrs))
        R_v, T_v = get_camera_RT(poses[:, :3], poses[:, 3:])
        harm = torch.as_tensor(rs.normal(size=(N, 64)).astype(np.float32)
                               * 0.3)
        group.append(SceneSupervision(
            cfg=scene.cfg, cell_table=scene.cell_table, proxy=proxy,
            surface=scene.surface_scene,
            close_mask=in_field & torch.as_tensor(rs.uniform(size=N) < 0.7),
            visited_cams=FoVCamera.create(R_v, T_v, zfar=params.zfar),
            visited_X=poses[:, :3],
            supervision_gains=torch.as_tensor(
                rs.uniform(1.0, 10.0, size=len(nbrs)).astype(np.float32)),
            sup_occ=torch.as_tensor(
                (rs.uniform(size=(N, 1)) < 0.5).astype(np.float32)),
            prediction_camera=nudged(cam.fov_camera),
            field=R.assemble_scene_field(proxy, proxy.supervision_occ,
                                         in_field, harm)))
        scenes.append(scene)
        assert int(group[-1].close_mask.sum()) > 50 and len(nbrs) == 3
    assert (scenes[0].cell_table.proxy_slots.shape[0]
            > scenes[1].cell_table.proxy_slots.shape[0])
    assert {s.surface_scene.valid.shape[1] for s in scenes} == {CAPACITY}
    return params, cube_root, rt, occ_vars, vis_vars, group


def arrays(state):
    return [np.asarray(a) for a in state]


@pytest.fixture(scope="module")
def group_draws(group_inputs):
    """The JAX group step's draws from PRNGKey(3) split over the scenes:
    each scene's cell noise over the group's padded cell count and its MC
    sample; and the port's, scene i's noise its first C_i entries."""
    _, root, _, _, _, group = group_inputs
    jparams = JParams(dict(TINY, data_path=root, **SCONE))
    key = jax.random.PRNGKey(3)
    Cp = max(x.cfg.n_cells for x in group)
    noises, idxs = [], []
    for x, k in zip(group, jax.random.split(key, len(group))):
        cams = JFoVCamera.create(x.visited_cams.R.numpy(),
                                 x.visited_cams.T.numpy(), zfar=jparams.zfar)
        noise, idx = jax_draws(
            jparams, tuple(jnp.asarray(t.numpy()) for t in x.field), cams, k,
            Cp)
        noises.append(torch.as_tensor(noise[:x.cfg.n_cells]))
        idxs.append(torch.as_tensor(idx))
    return key, noises, idxs


def test_group_scone_step(group_inputs, group_draws):
    """One SCONE step on the mean of two scenes' losses against JAX
    make_parallel_scone_step on the stacked, padded group."""
    params, root, rt, occ_vars, vis_vars, group = group_inputs
    key, noises, idxs = group_draws
    jparams = JParams(dict(TINY, data_path=root, **SCONE))
    jmodel = JMacaronsModel(None, JSconeOcc(**OCC_KW), JSconeVis(**VIS_KW))
    jrt = JTM.MacaronsRuntime(jparams, jmodel)
    jrt.scone_tx = with_grads(jrt.scone_tx)
    Cp = max(x.cfg.n_cells for x in group)
    Kp = max(x.surface.valid.shape[1] for x in group)
    KCp = max(x.cell_table.proxy_slots.shape[1] for x in group)
    assert [x.cfg.n_cells for x in group] == [27, 18]
    per_scene = []
    for x in group:
        jcfg = jG.GridConfig(*x.cfg)
        tables = jR.device_cell_tables(jcfg, jR.CellIndexTable(*x.cell_table),
                                       3.0)
        cams = JFoVCamera.create(x.visited_cams.R.numpy(),
                                 x.visited_cams.T.numpy(), zfar=jparams.zfar)
        jfield = tuple(jnp.asarray(t.numpy()) for t in x.field)
        box_diag = float(np.linalg.norm(np.asarray(x.cfg.x_max)
                                        - np.asarray(x.cfg.x_min)))
        per_scene.append({
            "proxy": jP.ProxyState(*arrays(x.proxy)),
            "sup_occ": x.sup_occ.numpy(),
            "surface": JSDP.pad_grid_state(jG.GridState(*arrays(x.surface)),
                                           Cp, Kp),
            "tables": JSDP.pad_cell_tables(tables, Cp, KCp),
            "pred_R": x.prediction_camera.R.numpy(),
            "pred_T": x.prediction_camera.T.numpy(),
            "close_mask": x.close_mask.numpy(),
            "visited_R": cams.R, "visited_T": cams.T,
            "visited_X": x.visited_X.numpy(),
            "sup_gains": x.supervision_gains.numpy(),
            "X_world": jfield[0], "harmonics": jfield[1], "occ": jfield[2],
            "valid": jfield[3], "box_diag": jnp.asarray(box_diag),
            "cell_resolution": jnp.asarray(x.cfg.resolution),
            "n_cells_active": jnp.asarray(N_ACTIVE, jnp.int32)})
    step = JSDP.make_parallel_scone_step(jrt, n_supervision=N_SUP)
    ps = {"occ": occ_vars["params"], "vis": vis_vars["params"]}
    new_occ, new_vis, (_, jgrads), jloss, jocc, jcov = step(
        occ_vars, vis_vars, jrt.scone_tx.init(ps),
        JSDP.stack_scene_group(per_scene), key)

    opts = create_optimizers(params, rt.model)
    steps = rt.scone_opt_steps
    loss, occ_loss, cov_loss = rt.parallel_scone_train_step(
        opts["scone"], group, n_cells_active=N_ACTIVE, cell_noise=noises,
        sample_idx=idxs)
    assert rt.scone_opt_steps == steps + (1 if rt.schedule_lr else 0)
    assert float(jocc) > 0 and float(jcov) > 0
    np.testing.assert_allclose(float(occ_loss), float(jocc), rtol=1e-4)
    np.testing.assert_allclose(float(cov_loss), float(jcov), rtol=1e-4)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    check_network(rt.model.occ, jgrads["occ"], new_occ["params"])
    check_network(rt.model.vis, jgrads["vis"], new_vis["params"])


def test_group_scone_step_is_the_mean(group_inputs, group_draws):
    """The group step's gradient is the mean of the scenes' own steps'
    gradients (float32 summation order apart), and it counts one step of
    the warm-up schedule."""
    params, _, rt, _, _, group = group_inputs
    _, noise, idx = group_draws
    params = Params(dict(params.to_dict(), schedule_learning_rate=True,
                         scone_warmup=10))
    grads = []
    for members in ([0], [1], [0, 1]):
        model = MacaronsModel(copy.deepcopy(rt.model.occ),
                              copy.deepcopy(rt.model.vis), None)
        r = TM.MacaronsRuntime(params, model, device="cpu")
        opts = create_optimizers(params, model)
        r.parallel_scone_train_step(
            opts["scone"], [group[i] for i in members], N_ACTIVE,
            cell_noise=[noise[i] for i in members],
            sample_idx=[idx[i] for i in members])
        assert r.scone_opt_steps == 1
        grads.append({f"{net}.{n}": p.grad.clone()
                      for net in ("occ", "vis")
                      for n, p in getattr(model, net).named_parameters()
                      if p.grad is not None})
    scale = max(float(g.abs().max()) for g in grads[2].values())
    assert scale > 0
    for n, g in grads[2].items():
        mean = (grads[0][n] + grads[1][n]) / 2
        torch.testing.assert_close(g, mean, rtol=0, atol=1e-6 * scale,
                                   msg=n)


# ---------------------------------------------------------------------------
# Replay volume and the epoch loop
# ---------------------------------------------------------------------------


def test_memory_depth_loop_scale():
    """A group of S scenes draws S x n_memory_samples replay frames per
    step: the JAX package's counts [4, 16]."""
    def counts(module, args):
        calls = []

        class FakeMemory:
            def current_trajectory(self):
                return 0

            def sample_depth_replay(self, rs, n_samples, n_context,
                                    exclude_traj=None):
                calls.append(n_samples)
                return None

        rt = types.SimpleNamespace(
            params=Params(dict(n_memory_samples=4)),
            dcfg=types.SimpleNamespace(n_alpha=2,
                                       use_future_frame_for_supervision=False))
        rs = np.random.default_rng(0)
        fn = module.memory_depth_loop
        fn(rt, FakeMemory(), *args(rs))
        fn(rt, FakeMemory(), *args(rs), scale=4)
        return calls

    jcalls = counts(JTM, lambda rs: ("p", None, {}, jax.random.PRNGKey(0),
                                     rs))
    calls = counts(TM, lambda rs: ({}, None, rs))
    assert calls == jcalls == [4, 16]


GROUP_RUN = dict(TINY, use_perfect_depth=False, n_depth=4,
                 n_parallel_scenes=2, epochs=2, n_poses_in_trajectory=2,
                 device_memory=False, random_mirror_scenes=True,
                 axis_to_mirror=[0, 1, 2], symmetry_probability=0.5,
                 macarons_model_name="grp")


def scripted_setup(log):
    """setup_scene, scripted: a stand-in scene naming its item and its
    mirrored axes."""
    def setup(params, item, *args, mirrored_axes=None):
        log.append(("setup", item["scene_name"], list(mirrored_axes or [])))
        return types.SimpleNamespace(name=item["scene_name"], cfg=None,
                                     cell_table=None, coverages=[])
    return setup


def scripted_losses(names, epoch, n_poses):
    base = 0.1 * (epoch + 1) + 0.01 * len(names)
    return {"depth": [base + 0.001 * i for i in range(n_poses)],
            "occ": [0.2 * base] * n_poses, "cov": [0.5] * n_poses}


def scripted_group(log, jax_side):
    """run_trajectories_parallel and run_trajectory, scripted: each records
    its scenes, the epoch, the random generator's state and its options,
    draws from the generator, and returns scripted losses."""
    def record(kind, scenes, memory, rs, n_poses, kw):
        names = [s.name for s in scenes]
        log.append((kind, names, memory.current_epoch,
                    rs.bit_generator.state["state"]["state"], n_poses,
                    kw.get("freeze_scone"), kw.get("online_learning")))
        rs.integers(0, 100, size=len(scenes))
        for s in scenes:
            s.coverages = [0.3]
        return scripted_losses(names, memory.current_epoch, n_poses)

    if jax_side:
        def group(rt, scenes, memories, memory_paths, variables, opt_states,
                  key, rs, n_poses, mesh=None, **kw):
            assert len(mesh.devices) == len(scenes)
            return (variables, opt_states,
                    record("group", scenes, memories[0], rs, n_poses, kw),
                    key)

        def single(rt, scene, memory, memory_path, variables, opt_states,
                   key, rs, n_poses, **kw):
            return (variables, opt_states,
                    record("single", [scene], memory, rs, n_poses, kw), key)
    else:
        def group(rt, scenes, memory, memory_paths, opts, gen, rs, n_poses,
                  **kw):
            return record("group", scenes, memory, rs, n_poses, kw)

        def single(rt, scene, memory, memory_path, opts, gen, rs, n_poses,
                   **kw):
            return record("single", [scene], memory, rs, n_poses, kw)
    return group, single


def test_group_epoch_loop(cube_root, tmp_path):
    """Two epochs over three scenes in groups of two: a group and a
    trailing scene alone in each epoch, every scene of a group set up (its
    mirroring drawn) before its trajectories, the same draws in the same
    order, one loss entry per group pose, the same epoch losses."""
    logs = {}
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(JTM, "init_macarons_variables",
                   lambda params, model, key: random_variables(params, 2))
        mp.setattr(JTM.MacaronsRuntime, "bind_scene", lambda *a: None)
        mp.setattr(TM.MacaronsRuntime, "bind_scene", lambda *a: None)
        for name, module, jax_side in (("jax", JTM, True),
                                       ("port", TM, False)):
            log = logs[name] = []
            group, single = scripted_group(log, jax_side)
            mp.setattr(module, "setup_scene", scripted_setup(log))
            mp.setattr(module, "run_trajectories_parallel", group)
            mp.setattr(module, "run_trajectory", single)
        cfg = dict(GROUP_RUN, data_path=cube_root)
        _, jlosses = JTM.run_training(
            JParams(cfg), weights_dir=str(tmp_path / "jw"),
            memory_root=str(tmp_path / "jmem"), verbose=False)
        _, losses = TM.run_training(
            Params(cfg), weights_dir=str(tmp_path / "w"),
            memory_root=str(tmp_path / "mem"), device="cpu", verbose=False)
    finally:
        mp.undo()
    assert logs["port"] == logs["jax"]
    assert losses == jlosses
    kinds = [(r[0], r[1] if r[0] == "setup" else len(r[1]))
             for r in logs["port"]]
    # Per epoch: two set-ups, the group, one set-up, the trailing scene.
    assert [k for k, _ in kinds] == ["setup", "setup", "group", "setup",
                                     "single"] * 2
    mirrored = [r[2] for r in logs["port"] if r[0] == "setup"]
    assert any(mirrored) and not all(mirrored)
    for e, row in enumerate(losses):
        two = scripted_losses([0, 1], e, 2)
        one = scripted_losses([0], e, 2)
        assert row["depth"] == pytest.approx(np.mean(two["depth"]
                                                     + one["depth"]))


def test_n_devices(cube_root, tmp_path):
    """A pinned n_devices that does not divide the group raises the JAX
    package's ValueError before any scene is set up; one that divides it
    runs, over as many ranks (``group_ranks``: the pinned count, else the
    largest divisor of the group within the cards, as the JAX package
    sizes its mesh); a group over several ranks, and an epoch's trailing
    group of more than one scene, must split over them, with either
    replay memory (``check_group_ranks``)."""
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(JTM, "init_macarons_variables",
                   lambda params, model, key: random_variables(params, 2))
        cfg = dict(GROUP_RUN, data_path=cube_root, n_devices=3)
        with pytest.raises(ValueError) as jerr:
            JTM.run_training(JParams(cfg), weights_dir=str(tmp_path / "jw"),
                             memory_root=str(tmp_path / "jm"),
                             verbose=False)
    finally:
        mp.undo()
    with pytest.raises(ValueError) as err:
        TM.run_training(Params(cfg), weights_dir=str(tmp_path / "w"),
                        memory_root=str(tmp_path / "m"), device="cpu",
                        verbose=False)
    assert str(err.value) == str(jerr.value)
    assert "n_parallel_scenes" in str(err.value)
    pinned = Params(dict(GROUP_RUN, n_devices=2))
    assert TM.scene_group_size(pinned) == 2
    assert TM.group_ranks(pinned, 1) == TM.group_ranks(pinned, 8) == 2
    TM.check_group_ranks(pinned, 2, 4)
    with pytest.raises(ValueError, match="n_devices=1 is pinned but 2 ranks"):
        TM.check_group_ranks(Params(dict(GROUP_RUN, n_devices=1)), 2, 4)
    with pytest.raises(ValueError, match="does not divide over the 3"):
        TM.check_group_ranks(Params(dict(GROUP_RUN, n_devices=None)), 3, 4)
    TM.check_group_ranks(Params(dict(pinned.to_dict(), device_memory=True)),
                         2, 4)
    four = Params(dict(GROUP_RUN, n_parallel_scenes=4, n_devices=None))
    # An epoch's trailing group: one scene runs on rank 0 alone, a larger
    # one must split over the ranks (the JAX package's mesh cannot shard a
    # trailing group of 3 over 2 devices either).
    for n_scenes in (4, 5, 6, 8, 9, 10):
        TM.check_group_ranks(four, 2, n_scenes)
    for world, n_scenes in ((2, 3), (2, 7), (4, 6), (4, 7)):
        with pytest.raises(ValueError, match="ends in a group of"):
            TM.check_group_ranks(four, world, n_scenes)
    assert [TM.group_ranks(four, n) for n in (1, 2, 3, 4, 8)] == [
        1, 2, 2, 4, 4]
    assert TM.group_ranks(Params(dict(TINY)), 8) == 1
    assert TM.scene_group_size(Params(dict(GROUP_RUN, n_devices=1))) == 2
    assert TM.scene_group_size(Params(dict(GROUP_RUN, n_devices=None))) == 2
    assert TM.scene_group_size(Params(dict(TINY, n_devices=3))) == 1


def test_group_training_run(cube_root, tmp_path):
    """A 1-epoch, 2-pose run_training at group 2 over cube_a and cube_b on
    the CPU: finite losses, a positive depth loss, each scene's frames
    and snapshot in the memory, the group's phases in order, and the
    checkpoint reloads."""
    root = tmp_path / "scenes"
    root.mkdir()
    for name in SCENES[:2]:
        os.symlink(os.path.join(cube_root, name), root / name)
    params = Params(dict(TINY, data_path=str(root), n_parallel_scenes=2,
                         n_poses_in_trajectory=2, n_memory_loops=0,
                         random_mirror_scenes=False,
                         macarons_model_name="par_mac", **SCONE))
    seen = []
    model, losses = TM.run_training(
        params, weights_dir=str(tmp_path / "w"),
        memory_root=str(tmp_path / "mem"), device="cpu", verbose=False,
        on_phase=lambda e, i, name: seen.append((i, name)))
    assert len(losses) == 1
    row = losses[0]
    assert np.isfinite(row["depth"]) and row["depth"] > 0
    assert np.isfinite(row["occ"]) and np.isfinite(row["cov"])
    for name in SCENES[:2]:
        fdir = tmp_path / "mem" / name / "macarons_memory" / "training" / "0"
        assert len(list((fdir / "frames").glob("*.npz"))) == 3 + 2 * 2
        assert (fdir / "surface" / "scene.npz").exists()
    assert [n for i, n in seen if i == 0] == [
        "decision/0", "capture/0", "decision/1", "capture/1", "depth_step",
        "supervision", "scone_step", "depth_replay", "scone_replay",
        "remap", "done"]
    with open(tmp_path / "w" / "unvalidated_par_mac.json") as f:
        meta = json.load(f)
    assert meta["epoch"] == 1 and meta["train_losses"] == losses
    again = TM.create_macarons_model(params, "cpu")
    TM.load_macarons(str(tmp_path / "w" / "unvalidated_par_mac"), again)
    for net in ("occ", "vis"):
        for k, t in getattr(model, net).state_dict().items():
            torch.testing.assert_close(getattr(again, net).state_dict()[k],
                                       t, rtol=0, atol=0)


def test_view_bins_at_lattice_cameras():
    """At the cube scenes' lattice poses (orientations in steps of 45
    degrees) some view-state directions fall exactly on a bin boundary
    (half a bin, or a whole one at a sign change) or a pole, where float32
    rounding picks the bin: the port's view-space permutation differs
    from the JAX package's only at directions within 1e-5 rad of a
    boundary, 2e-3 rad of a pole or 1e-3 rad of an azimuth of 0 or pi,
    also at cameras turned by 1e-3 rad (``nudged``). A known divergence:
    the group SCONE step above takes turned cameras."""
    from macarons_tpu.ops import view_state as jvs
    from macarons_tpu_torch.ops import view_state as vs
    from macarons_tpu_torch.ops.geometry import get_cartesian_coords, \
        get_spherical_coords
    from macarons_tpu_torch.scene.camera import PoseSpace

    n_elev, n_azim = 7, 14
    elev_np, azim_np = vs._sphere_grid_np(n_elev, n_azim)
    X_ref = get_cartesian_coords(
        torch.ones(len(elev_np)),
        torch.as_tensor(elev_np, dtype=torch.float32),
        torch.as_tensor(azim_np, dtype=torch.float32))
    steps = (np.pi / (n_elev + 1), 2 * np.pi / n_azim)
    idx = np.array([[a, b, c, e, z] for a, b, c in ((0, 1, 3), (2, 2, 0))
                    for e in range(3) for z in range(8)])
    poses = torch.as_tensor(PoseSpace((-4.0,) * 3, (4.0,) * 3, 4, 4, 4, 3,
                                      8).pose_from_idx(idx))
    R_all, T_all = get_camera_RT(poses[:, :3], poses[:, 3:])

    def apart(cam):
        ours = vs.view_space_permutation(cam, n_elev, n_azim).numpy()
        ref = np.asarray(jvs.view_space_permutation(JFoVCamera(*(
            np.asarray(getattr(cam, f)) for f in JFoVCamera._fields)),
            n_elev, n_azim))
        return np.nonzero(ours != ref)[0]

    def check(cam):
        """The entries apart, each on a boundary or near a pole."""
        where = apart(cam)
        world = cam.view_to_world(X_ref[None])[0]
        _, el, az = get_spherical_coords(
            (world - cam.camera_center()).reshape(-1, 3))
        el, az = (a.numpy()[where].astype(np.float64) for a in (el, az))
        # The distance to the nearest multiple of half a bin: the rule
        # (the JAX package's) rounds at half bins and, truncating but
        # taking a floored remainder, jumps at whole ones below 0.
        off = [np.abs(np.remainder(a + st / 4, st / 2) - st / 4)
               for a, st in zip((el, az), steps)]
        # Or near a pole, or at an azimuth of 0 or pi, where the azimuth
        # (acos of a ratio near +-1, the JAX package's formula) carries
        # up to sqrt(2 ulp) ~ 3.5e-4 rad of float32 rounding.
        near = ((np.minimum(*off) < 1e-5) | (np.pi / 2 - np.abs(el) < 2e-3)
                | (np.minimum(np.abs(az), np.pi - np.abs(az)) < 1e-3))
        assert near.all(), (where, off, el)
        return len(where)

    n_apart = 0
    for R1, T1 in zip(R_all, T_all):
        cam = FoVCamera.create(R1[None], T1[None], zfar=TINY["zfar"])
        n_apart += check(cam) > 0
        check(nudged(cam))
    assert n_apart > 0


def test_group_capacity_padding(group_inputs):
    """A known divergence of the JAX group step, which the port does not
    take: the JAX package pads each scene's surface grid to the group's
    largest capacity, and the padded slots change SconeOcc's deterministic
    subsample of a cell's surface context, so a padded scene's
    supervision pass differs from its own unpadded one. The port computes
    each scene unpadded, as the JAX single-scene step does. Padding the
    cell count and the cell table's slots (phantom cells, which have no
    eligible proxy and so rank below every real cell) changes nothing."""
    params, root, _, occ_vars, _, group = group_inputs
    jparams = JParams(dict(TINY, data_path=root, **SCONE))
    jrt = JTM.MacaronsRuntime(jparams, JMacaronsModel(
        None, JSconeOcc(**OCC_KW), JSconeVis(**VIS_KW)))
    occ = SconeOcc(**OCC_KW)
    occ.load_state_dict(flax_to_torch(occ_vars))
    rt = TM.MacaronsRuntime(params, MacaronsModel(occ.eval(), SconeVis(
        **VIS_KW), None), device="cpu")
    x = group[0]
    C, K = x.cfg.n_cells, x.surface.valid.shape[1]
    KC = x.cell_table.proxy_slots.shape[1]
    tables = jR.device_cell_tables(jG.GridConfig(*x.cfg),
                                   jR.CellIndexTable(*x.cell_table), 3.0)
    cam = JFoVCamera(*(np.asarray(getattr(x.prediction_camera, f))
                       for f in JFoVCamera._fields))
    key = jax.random.PRNGKey(8)
    rt.bind_scene(x.cfg, x.cell_table)
    gaps = {}
    for label, (c, k, kc) in (("none", (C, K, KC)),
                              ("cells", (C + 9, K, KC + 64)),
                              ("capacity", (C, K + 30, KC))):
        proba, jmask, _ = jrt._occ_impl_sup(
            occ_vars, jP.ProxyState(*arrays(x.proxy)),
            JSDP.pad_grid_state(jG.GridState(*arrays(x.surface)), c, k),
            JSDP.pad_cell_tables(tables, c, kc), cam, key,
            supervision=True, eligible_override=x.close_mask.numpy(),
            n_cells_active=N_ACTIVE)
        # The draw over the padded cell count; the real cells take its
        # first C entries.
        noise = torch.as_tensor(np.array(jax.random.uniform(key, (c,))))[:C]
        with torch.no_grad():
            ours, mask, _ = rt._occ_field_sup.supervise(
                x.proxy, x.surface, rt._tables, x.prediction_camera,
                eligible_override=x.close_mask, n_cells_active=N_ACTIVE,
                noise=noise)
        mask = mask.numpy()
        np.testing.assert_array_equal(np.asarray(jmask), mask)
        gaps[label] = float(np.abs(np.asarray(proba)[:, 0]
                                   - ours.numpy()[:, 0])[mask].max())
    assert gaps["none"] < 1e-5 and gaps["cells"] < 1e-5, gaps
    assert gaps["capacity"] > 1e-3, gaps
