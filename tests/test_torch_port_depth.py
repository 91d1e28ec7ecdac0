"""ManyDepth inference: the port against the JAX package on the CPU.

The same numpy inputs go through the JAX functions and the port's, the
networks at Flax weights converted by utils.convert.flax_to_torch (random,
with random BatchNorm statistics). Pieces: the rotation algebra, the feature
extractor, the cost volume and the expansion resize at a non-integer ratio,
ManyDepth as a whole, the depth step against make_apply_depth_fn, and the
slice: the port's compute_trajectory against the JAX tester with ManyDepth
depth (random policy, the JAX package's GT grid injected as in
test_torch_port_trajectory.py), and the port's run_test on it.

The error mask compares the regularity table of the disparity against its
mean + std; where the two sides' tables differ in their last bits, a pixel
within 1e-5 (relative) of the threshold may fall on either side. Those
pixels are left out of the comparison.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from macarons_tpu.config import Params as JParams
from macarons_tpu.data.scenes import SceneDataset as JSceneDataset
from macarons_tpu.models import depth_losses as jdl
from macarons_tpu.models import many_depth as jmd
from macarons_tpu.models import resnet as jresnet
from macarons_tpu.models.macarons import MacaronsVariables, \
    create_macarons_model as jcreate
from macarons_tpu.ops import geometry as jgeo
from macarons_tpu.scene import depth_runtime as jdr
from macarons_tpu.scene.memory import Memory as JMemory
from macarons_tpu.testers import scene as jtester
from macarons_tpu.trainers import train_macarons as JTM
from macarons_tpu.utils.checkpoint import save_checkpoint
from macarons_tpu.models.scone import SconeOcc as JSconeOcc
from macarons_tpu.models.scone import SconeVis as JSconeVis
from macarons_tpu_torch.config import Params
from macarons_tpu_torch.data.scenes import SceneDataset
from macarons_tpu_torch.models import many_depth as md
from macarons_tpu_torch.models import resnet
from macarons_tpu_torch.models.macarons import MacaronsModel, \
    create_macarons_model, init_macarons_weights
from macarons_tpu_torch.models.scone import SconeOcc, SconeVis
from macarons_tpu_torch.ops import geometry as geo
from macarons_tpu_torch.scene import depth_runtime as dr
from macarons_tpu_torch.scene.memory import Memory
from macarons_tpu_torch.testers import scene as tester
from macarons_tpu_torch.trainers import train_macarons as TM
from macarons_tpu_torch.utils.convert import flax_to_torch, \
    load_macarons_weights
from torch_port_helpers import OCC_KW, TINY, VIS_KW, grid_to_torch, \
    make_scene_root, random_flax_variables, torch_one_thread  # noqa: F401

H, W = TINY["image_height"], TINY["image_width"]  # 32 x 48: 48 / 16 = 3,
# and layer 4 is 2 wide, so the first expansion resizes by 1.5
N_DEPTH = 12
N_POSES = 3
# The default training config's alphas: the supervision batch gathers three,
# ManyDepth sees the first two.
DEPTH = dict(use_perfect_depth=False, n_depth=N_DEPTH, alphas=[-1, -2, 1],
             n_alpha=2, n_alpha_for_supervision=3,
             use_future_frame_for_supervision=True)
ERR_REL = 1e-5


def rotations(rs, n, angles):
    """Rotation matrices (n, 3, 3) of random axes and the given angles."""
    axis = rs.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    K = np.zeros((n, 3, 3))
    K[:, 0, 1], K[:, 0, 2], K[:, 1, 2] = -axis[:, 2], axis[:, 1], -axis[:, 0]
    K -= K.transpose(0, 2, 1)
    a = np.asarray(angles, np.float64)[:, None, None]
    return (np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * K @ K).astype(
        np.float32)


@pytest.mark.parametrize("kind", ["random", "tiny", "near_pi"])
def test_rotation_algebra(kind):
    rs = np.random.default_rng({"random": 0, "tiny": 1, "near_pi": 2}[kind])
    n = 64
    angles = {"random": rs.uniform(0.0, np.pi, n),
              "tiny": rs.uniform(0.0, 1e-6, n),
              "near_pi": np.pi - rs.uniform(0.0, 1e-3, n)}[kind]
    R = rotations(rs, n, angles)
    aa = (rs.normal(size=(n, 3)) * angles[:, None]
          / np.sqrt(3)).astype(np.float32)
    q = rs.normal(size=(n, 4)).astype(np.float32)
    R2, T, T2 = rotations(rs, n, rs.uniform(0, np.pi, n)), *rs.normal(
        size=(2, n, 3)).astype(np.float32)
    cases = [(jgeo.quaternion_from_matrix, geo.quaternion_from_matrix, (R,)),
             (jgeo.matrix_from_quaternion, geo.matrix_from_quaternion, (q,)),
             (jgeo.axis_angle_from_matrix, geo.axis_angle_from_matrix, (R,)),
             (jgeo.matrix_from_axis_angle, geo.matrix_from_axis_angle, (aa,)),
             (jgeo.relative_pose, geo.relative_pose, (R, T, R2, T2)),
             (jgeo.compose_pose, geo.compose_pose, (R, T, R2, T2))]
    for jfn, fn, args in cases:
        ref = jax.jit(jfn)(*args)
        ours = fn(*(torch.as_tensor(a) for a in args))
        for a, b in zip(jax.tree_util.tree_leaves(ref),
                        ours if isinstance(ours, tuple) else (ours,)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6,
                                       err_msg=fn.__name__)
    if kind == "tiny":  # the first-order branch, seen at a relative scale
        np.testing.assert_allclose(
            geo.axis_angle_from_matrix(torch.as_tensor(R)).numpy(),
            np.asarray(jax.jit(jgeo.axis_angle_from_matrix)(R)), rtol=1e-4,
            atol=1e-12)
    # The round trip through the axis-angle keeps the rotation.
    back = geo.matrix_from_axis_angle(geo.axis_angle_from_matrix(
        torch.as_tensor(R)))
    np.testing.assert_allclose(back.numpy(), R, atol=1e-5)


def images(rs, *shape):
    return rs.uniform(size=(*shape, 3)).astype(np.float32)


def relative_cameras(rs, B, A, angle=0.05, shift=0.3):
    """Reference pose R = I, T = 0 and alpha poses a small rotation and
    shift away, as the depth step hands them to ManyDepth."""
    R = np.broadcast_to(np.eye(3, dtype=np.float32), (B, 3, 3)).copy()
    T = np.zeros((B, 3), np.float32)
    R_a = rotations(rs, B * A, rs.uniform(0, angle, B * A)).reshape(
        B, A, 3, 3)
    T_a = (rs.normal(size=(B, A, 3)) * shift).astype(np.float32)
    return R, T, R_a, T_a


def torch_module(module, variables):
    module.load_state_dict(flax_to_torch(variables))
    return module.eval()


def nchw(a):
    return torch.as_tensor(a).permute(0, 3, 1, 2).contiguous()


def test_feature_extractor():
    rs = np.random.default_rng(3)
    x = images(rs, 3, H, W)
    jfe = jresnet.FeatureExtractor()
    v = random_flax_variables(jfe, 4, x)
    ref = jax.jit(lambda v, x: jfe.apply(v, x, return_conv1=True))(v, x)
    with torch.no_grad():
        ours = torch_module(resnet.FeatureExtractor(), v)(
            nchw(x), return_conv1=True)
    assert np.asarray(v["batch_stats"]["stem"]["bn1"]["var"]).min() > 1.0
    for a, b in zip(ref, ours):
        np.testing.assert_allclose(b.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(a), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n_depth", [12, 40])  # one chunk, and three
def test_cost_volume(n_depth):
    rs = np.random.default_rng(5)
    B, A, fh, fw, C = 2, 2, H // 4, W // 4, 64
    feat = rs.normal(size=(B, fh, fw, C)).astype(np.float32)
    feat_a = rs.normal(size=(B, A, fh, fw, C)).astype(np.float32)
    cams = relative_cameras(rs, B, A)
    jcv = jmd.CostVolumeBuilder(H, W, 0.5, 40.0, n_depth)
    args = (feat, *cams[:2], feat_a, *cams[2:])
    v = random_flax_variables(jcv, 6, *args)
    res, cost = jax.jit(lambda v, *a: jcv.apply(
        v, *a, return_cost_volume=True))(v, *args)
    cv = torch_module(md.CostVolumeBuilder(0.5, 40.0, n_depth), v)
    with torch.no_grad():
        ours_res, ours_cost = cv(
            nchw(feat), *map(torch.as_tensor, cams[:2]),
            torch.as_tensor(feat_a).permute(0, 1, 4, 2, 3),
            *map(torch.as_tensor, cams[2:]), return_cost_volume=True)
    assert float(np.asarray(cost).std()) > 0.05
    np.testing.assert_allclose(ours_cost.permute(0, 2, 3, 1).numpy(),
                               np.asarray(cost), atol=1e-5)
    np.testing.assert_allclose(ours_res.permute(0, 2, 3, 1).numpy(),
                               np.asarray(res), atol=1e-4)


@pytest.mark.parametrize("size_in,size_out", [((8, 15), (16, 29)),
                                              ((1, 2), (2, 3))])
def test_expansion_layer(size_in, size_out):
    """Layer 4 -> size(16) at 256 x 456, and at 32 x 48."""
    rs = np.random.default_rng(7)
    x = rs.normal(size=(2, *size_in, 24)).astype(np.float32)
    skip = rs.normal(size=(2, *size_out, 8)).astype(np.float32)
    jexp = jmd.ExpansionLayer(16, 12, size_out)
    v = random_flax_variables(jexp, 8, x, skip)
    ref = jax.jit(jexp.apply)(v, x, skip)
    exp = torch_module(md.ExpansionLayer(24, 16, 12, size_out, 8), v)
    with torch.no_grad():
        ours = exp(nchw(x), nchw(skip))
    np.testing.assert_allclose(ours.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), rtol=1e-4, atol=1e-5)


def many_depth_pair(seed, n_depth, B, A):
    jm = jmd.ManyDepth(H, W, 0.5, TINY["zfar"], n_depth)
    v = random_flax_variables(
        jm, seed, np.zeros((B, H, W, 3), np.float32),
        np.zeros((B, A, H, W, 3), np.float32), np.eye(3)[None],
        np.zeros((1, 3), np.float32), np.zeros((B, A, 6), np.float32))
    return jm, v, torch_module(md.ManyDepth(H, W, 0.5, TINY["zfar"], n_depth),
                               v)


def test_many_depth():
    rs = np.random.default_rng(9)
    B, A = 2, 2
    jm, v, m = many_depth_pair(10, N_DEPTH, B, A)
    R, T, R_a, T_a = relative_cameras(rs, B, A)
    pose = np.array(jax.jit(lambda *a: jdl.convert_matrix_to_pose(
        *a, 100.0))(R, T, R_a, T_a))
    args = (images(rs, B, H, W), images(rs, B, A, H, W), R, T, pose)
    ref = jax.jit(jm.apply)(v, *args)
    with torch.no_grad():
        ours = m(*map(torch.as_tensor, args))
    for i, (a, b) in enumerate(zip(ref[1:], ours[1:])):
        assert b.shape == a.shape
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=2e-5,
                                   err_msg=f"disp{i + 1}")


def test_model_bundle():
    params = Params(dict(TINY, **DEPTH))
    gen = torch.Generator().manual_seed(0)
    model = init_macarons_weights(create_macarons_model(params, "cpu"), gen)
    cvb = model.depth.depth_decoder.cost_volume_builder
    assert cvb.conv_reduce.in_channels == 64 + N_DEPTH
    bn = model.depth.depth_decoder.feature_extractor.stem.state_dict()
    conv = cvb.conv_reduce.state_dict()
    assert float(bn["bn1.running_var"].min()) == 1.0
    assert float(bn["bn1.weight"].min()) == 1.0
    assert float(conv["bias"].abs().max()) == 0.0
    assert float(conv["weight"].abs().max()) <= 2 * (9 * (64 + N_DEPTH)) \
        ** -0.5 / .87962566103423978
    # Without ManyDepth the bundle draws the weights it always drew.
    fixture = create_macarons_model(Params(TINY), "cpu")
    assert fixture.depth is None
    init_macarons_weights(fixture, torch.Generator().manual_seed(0))
    torch.testing.assert_close(fixture.vis.state_dict(),
                               model.vis.state_dict(), rtol=0, atol=0)
    for bad in (dict(depth_compute_dtype="bfloat16"), dict(learn_pose=True)):
        with pytest.raises(NotImplementedError):
            create_macarons_model(Params(dict(TINY, **DEPTH, **bad)), "cpu")


def test_checkpoint_loads_depth(tmp_path):
    jm, v, m = many_depth_pair(11, N_DEPTH, 1, 2)
    occ_vars = random_flax_variables(JSconeOcc(**OCC_KW), 0,
                                     jnp.zeros((1, 300, 3)),
                                     jnp.zeros((1, 8, 3)),
                                     jnp.zeros((1, 8, 64)))
    vis_vars = random_flax_variables(JSconeVis(**VIS_KW), 1,
                                     jnp.zeros((1, 64, 4)),
                                     jnp.zeros((1, 64, 64)))
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, {"depth": v, "occ": occ_vars, "vis": vis_vars})
    model = MacaronsModel(SconeOcc(**OCC_KW), SconeVis(**VIS_KW),
                          md.ManyDepth(H, W, 0.5, TINY["zfar"], N_DEPTH))
    load_macarons_weights(model, path)
    torch.testing.assert_close(model.depth.state_dict(), m.state_dict(),
                               rtol=0, atol=0)


# ---------------------------------------------------------------------------
# The depth step and the slice, against the JAX tester's runtime
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_scene_root(tmp_path_factory)


@pytest.fixture(scope="module")
def jax_runtime(root):
    """The JAX tester's runtime with ManyDepth, and the depth weights of
    both sides. Its jitted depth step serves every test below, so each batch
    shape compiles once."""
    params = JParams(dict(TINY, **DEPTH, data_path=root))
    item = JSceneDataset(root)[0]
    scene = JTM.setup_scene(params, item, jax.random.PRNGKey(5))
    rt = JTM.MacaronsRuntime(params, jcreate(params), scene.cfg,
                             scene.cell_table)
    _, v, m = many_depth_pair(12, N_DEPTH, 1, 2)
    return params, item, rt, v, m


def record_disp(model, log):
    """Keep disp1 of every forward of the port's ManyDepth in ``log``."""
    return model.register_forward_hook(
        lambda mod, args, out: log.append(out[1]))


def assert_depth_step(ref, ours, disp, batch, cfg):
    """depth within rtol 1e-4, the mask identical, the error mask identical
    off the pixels within ERR_REL of the threshold."""
    depth, mask, err = (np.asarray(a) for a in ref[1:4])
    np.testing.assert_allclose(ours[0].numpy(), depth, rtol=1e-4)
    np.testing.assert_array_equal(ours[1].numpy(), mask)
    table, thr = dr.error_table(cfg, disp, batch["images"], batch["mask"])
    near = (torch.abs(table - thr) <= ERR_REL * torch.abs(thr)).numpy()
    differ = ours[2].numpy() != err
    assert not np.any(differ & ~near), int((differ & ~near).sum())
    assert 0.2 < err.mean() < 0.98 and 0.01 < depth.std()


def frames_for(rs, n):
    """A frame sequence as Memory.load_frame_sequence returns it: cameras on
    a short arc around a look-at target."""
    t = np.linspace(0.0, 0.4, n)
    eye = np.stack((3 * np.sin(t), 0.2 + 0.1 * t, 3 * np.cos(t)), -1)
    R, T = geo.look_at_view_transform(
        torch.as_tensor(eye, dtype=torch.float32), torch.zeros(n, 3))
    zbuf = rs.uniform(1.0, 5.0, size=(n, H, W, 1)).astype(np.float32)
    return {"images": images(rs, n, H, W), "zbuf": zbuf,
            "mask": rs.uniform(size=(n, H, W, 1)) > 0.1,
            "R": R.numpy(), "T": T.numpy(),
            "zfar": np.full((n,), TINY["zfar"], np.float32)}


@pytest.mark.parametrize("mode", ["inference", "supervision"])
def test_depth_step(jax_runtime, mode):
    params, _, jrt, v, m = jax_runtime
    rs = np.random.default_rng(13)
    n = 3 if mode == "inference" else TINY["n_interpolation_steps"] + 3
    frames = frames_for(rs, n)
    jbatch, jalpha = jdr.create_batch_for_depth_model(jrt.dcfg, frames, mode)
    ref = jrt.apply_depth_inference(v, jbatch, jalpha, jax.random.PRNGKey(0))
    cfg = TM.depth_cfg_from_params(Params(dict(TINY, **DEPTH)))
    batch, alpha = dr.create_batch_for_depth_model(cfg, frames, mode)
    assert alpha["R"].shape[1] == (2 if mode == "inference" else 3)
    log = []
    hook = record_disp(m, log)
    ours = dr.many_depth_inference(m, cfg, batch, alpha)
    hook.remove()
    assert ours[0].shape == (1 if mode == "inference" else 2, H, W, 1)
    assert_depth_step(ref, ours, log[0], batch, cfg)


@pytest.fixture(scope="module")
def slice_runs(root, jax_runtime, tmp_path_factory):
    """The JAX tester's and the port's random-policy trajectories with
    ManyDepth depth, and every depth step of both."""
    params, item, jrt, v, m = jax_runtime
    key = jax.random.PRNGKey(5)
    jscene = JTM.setup_scene(params, item, key)
    jsteps, apply = [], jrt.apply_depth_inference

    def jrecord(*args):
        out = apply(*args)
        jsteps.append(out)
        return out

    jrt.apply_depth_inference = jrecord
    mem = str(tmp_path_factory.mktemp("jax_memory"))
    try:
        jtraj, _ = jtester.compute_trajectory(
            jrt, jscene, JMemory([mem]), mem,
            MacaronsVariables(v, None, None), key, np.random.default_rng(42),
            n_poses=N_POSES, surface_epsilon=0.15,
            start_idx=np.asarray(item["settings"].start_positions[0]),
            policy="random")
    finally:
        jrt.apply_depth_inference = apply

    tparams = Params(dict(TINY, **DEPTH, data_path=root))
    gen = torch.Generator().manual_seed(5)
    scene = TM.setup_scene(tparams, SceneDataset(root)[0], gen, "cpu")
    scene.gt_scene = grid_to_torch(jscene.gt_scene)
    model = create_macarons_model(tparams, "cpu")._replace(depth=m)
    rt = TM.MacaronsRuntime(tparams, model, scene.cfg, scene.cell_table,
                            "cpu")
    steps, disps, port_apply = [], [], rt.apply_depth_inference

    def record(batch, alpha):
        out = port_apply(batch, alpha)
        steps.append((batch, out))
        return out

    rt.apply_depth_inference = record
    hook = record_disp(m, disps)
    mem = str(tmp_path_factory.mktemp("port_memory"))
    try:
        traj = tester.compute_trajectory(
            rt, scene, Memory([mem]), mem, gen, np.random.default_rng(42),
            n_poses=N_POSES, surface_epsilon=0.15,
            start_idx=np.asarray(item["settings"].start_positions[0]),
            policy="random")
    finally:
        hook.remove()
    return jtraj, jsteps, traj, steps, disps, rt.dcfg


def test_trajectory_matches_jax(slice_runs):
    jtraj, jsteps, traj, steps, disps, cfg = slice_runs
    assert traj["cam_idx"] == jtraj["cam_idx"]
    assert len({tuple(c) for c in traj["cam_idx"]}) > 1
    np.testing.assert_allclose(traj["coverage"], jtraj["coverage"], atol=1e-3)
    assert len(steps) == len(jsteps) == len(disps) == 2 * N_POSES
    for ref, (batch, ours), disp in zip(jsteps, steps, disps):
        assert_depth_step(ref, ours, disp, batch, cfg)


def test_run_test_with_many_depth(root, slice_runs, tmp_path):
    params = Params(dict(TINY, **DEPTH, data_path=root))
    res = tester.run_test(params, results_dir=str(tmp_path),
                          results_name="res.json", n_start_poses=1, n_poses=1,
                          memory_root=str(tmp_path / "mem"), policy="nbv",
                          device="cpu", verbose=False)
    with open(tmp_path / "res.json") as f:
        written = json.load(f)
    assert written == json.loads(json.dumps(res))
    traj = written["synth_00"]["0"]
    assert set(traj) == set(slice_runs[0])
    assert len(traj["coverage"]) == 2 and np.all(np.isfinite(traj["coverage"]))
