"""The online trainer's epoch paths and the tester's collision filter: the
port against the JAX package on the CPU.

``run_training``'s epoch loop around the trajectories: the unfreeze after
``n_freeze_epochs`` (pretrained weights reloaded, fresh optimizers, the
step counts and the best loss reset), validation every
``validate_every_n_epochs`` with the ``coverage_validated_`` checkpoint,
the periodic ``epoch_<e>_`` checkpoints, and the loss-peak rollback (the
depth network restored from the newest earlier ``epoch_`` file, SCONE
kept), forced every epoch by a negative ``loss_peak_threshold``. Both
packages start from one JAX checkpoint (``pretrained``), and each
trajectory is replaced by the same scripted one (the injected draws): it
records what it is handed, adds a per-epoch constant to the weights it
trains, advances the step counts, and returns scripted losses and
coverages. The two runs must hand the trajectories the same arguments and
weights, and write the same checkpoints (weights bit for bit, metadata
equal).

The collision filter: ``camera_collides`` on random proxy states, and the
tester's random-policy trajectory with ``use_collision`` against the JAX
tester's, pose for pose (the JAX package's GT grid injected, as in
test_torch_port_trajectory.py).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from macarons_tpu.config import Params as JParams
from macarons_tpu.data.scenes import SceneDataset as JSceneDataset
from macarons_tpu.models.macarons import MacaronsVariables, \
    create_macarons_model as jcreate
from macarons_tpu.models.macarons import save_macarons as jsave
from macarons_tpu.scene import proxy as JP
from macarons_tpu.scene.memory import Memory as JMemory
from macarons_tpu.testers import scene as jtester
from macarons_tpu.trainers import train_macarons as JTM
from macarons_tpu_torch.config import Params
from macarons_tpu_torch.data.scenes import SceneDataset
from macarons_tpu_torch.models.macarons import create_macarons_model, \
    init_macarons_weights
from macarons_tpu_torch.scene import proxy as P
from macarons_tpu_torch.scene.memory import Memory
from macarons_tpu_torch.testers import scene as tester
from macarons_tpu_torch.trainers import train_macarons as TM
from macarons_tpu_torch.utils.convert import flax_to_torch, read_msgpack
from torch_port_helpers import TINY, grid_to_torch, make_scene_root, \
    random_flax_variables, torch_one_thread  # noqa: F401

EPOCHS = 4
EPOCH_RUN = dict(
    TINY, use_perfect_depth=False, n_depth=4, epochs=EPOCHS,
    n_poses_in_trajectory=2, macarons_model_name="ep", device_memory=False,
    random_mirror_scenes=False, n_freeze_epochs=2, pretrained=True,
    pretrained_model_path="pretrained_ep", validate_every_n_epochs=2,
    n_val_poses=3, save_model_every_n_epoch=2, loss_peak_threshold=-1.0,
    seq_len=256, k_for_knn=8)
# Scripted per epoch: the weight increment, the depth loss, the training
# and validation coverages. Validation (epochs 1 and 3) improves once.
DELTA = (1e-3, 2e-3, -3e-3, 5e-4)
DEPTH_LOSS = (0.5, 0.42, 0.47, 0.4)
VAL_COV = (None, 0.3, None, 0.55)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_scene_root(tmp_path_factory)


def scripted(e, n_poses, online):
    """The scripted trajectory's losses and final coverage."""
    if not online:
        return {"depth": [], "occ": [], "cov": []}, VAL_COV[e]
    return ({"depth": [DEPTH_LOSS[e]] * n_poses, "occ": [0.1 * e] * n_poses,
             "cov": [0.2] * n_poses}, 0.25)


def jax_trajectory(log):
    """The JAX trainer's run_trajectory, scripted."""
    def run(rt, scene, memory, memory_path, variables, opt_states, key, rs,
            n_poses, freeze_scone=False, warmup_phase=False,
            online_learning=True, n_memory_loops=0, remap_at=None,
            verbose=False):
        e = memory.current_epoch
        log.append({"epoch": e, "online": online_learning,
                    "freeze": freeze_scone, "warmup": warmup_phase,
                    "n_poses": n_poses, "opt": opt_states["depth"],
                    "steps": (rt.depth_opt_steps, rt.scone_opt_steps),
                    "weights": {k: flax_to_torch(v) for k, v in
                                variables._asdict().items()}})
        losses, cov = scripted(e, n_poses, online_learning)
        scene.coverages = [0.1, cov]
        if online_learning:
            add = (lambda t: jax.tree_util.tree_map(
                lambda p: p + np.float32(DELTA[e]), t))
            depth = dict(variables.depth, params=add(
                variables.depth["params"]))
            occ, vis = variables.occ, variables.vis
            if not freeze_scone:
                occ, vis = ({"params": add(occ["params"])},
                            {"params": add(vis["params"])})
                rt.scone_opt_steps += n_poses
            rt.depth_opt_steps += n_poses
            variables = MacaronsVariables(depth, occ, vis)
        return variables, opt_states, losses, key
    return run


def port_trajectory(log):
    """The port trainer's run_trajectory, scripted."""
    def run(rt, scene, memory, memory_path, opts, gen, rs, n_poses,
            freeze_scone=False, warmup_phase=False, online_learning=True,
            n_memory_loops=0, remap_at=None, verbose=False, on_phase=None,
            episodes=None):
        e = memory.current_epoch
        model = rt.model
        log.append({"epoch": e, "online": online_learning,
                    "freeze": freeze_scone, "warmup": warmup_phase,
                    "n_poses": n_poses, "opt": opts["depth"],
                    "steps": (rt.depth_opt_steps, rt.scone_opt_steps),
                    "weights": {k: {n: t.clone() for n, t in
                                    getattr(model, k).state_dict().items()}
                                for k in ("depth", "occ", "vis")}})
        losses, cov = scripted(e, n_poses, online_learning)
        scene.coverages = [0.1, cov]
        if online_learning:
            nets = [model.depth] + ([] if freeze_scone
                                    else [model.occ, model.vis])
            with torch.no_grad():
                for net in nets:
                    for p in net.parameters():
                        p.add_(np.float32(DELTA[e]))
            rt.depth_opt_steps += n_poses
            if not freeze_scone:
                rt.scone_opt_steps += n_poses
        return losses
    return run


def assert_same_weights(ours, ref, nets=("depth", "occ", "vis")):
    for k in nets:
        for name, t in ref[k].items():
            if "num_batches" not in name:
                torch.testing.assert_close(ours[k][name], t, rtol=0, atol=0,
                                           msg=f"{k}.{name}")


def random_variables(jparams, seed):
    """A JAX MACARONS variables bundle of seeded random float32 weights."""
    model = jcreate(jparams)
    H, W = jparams.image_height, jparams.image_width
    variables = MacaronsVariables(
        random_flax_variables(
            model.depth, seed, jnp.zeros((1, H, W, 3)),
            jnp.zeros((1, 2, H, W, 3)), jnp.eye(3)[None], jnp.zeros((1, 3)),
            jnp.zeros((1, 2, 6))),
        random_flax_variables(model.occ, seed + 1, jnp.zeros((1, 128, 3)),
                              jnp.zeros((1, 8, 3)), jnp.zeros((1, 8, 64))),
        random_flax_variables(model.vis, seed + 2, jnp.zeros((1, 128, 4)),
                              jnp.zeros((1, 128, 64))))
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  variables)


@pytest.fixture(scope="module")
def epoch_runs(root, tmp_path_factory):
    """One run_training of each package over EPOCHS scripted epochs."""
    out = tmp_path_factory.mktemp("epochs")
    jparams = JParams(dict(EPOCH_RUN, data_path=root, val_scenes=["synth_00"]))
    params = Params(dict(EPOCH_RUN, data_path=root, val_scenes=["synth_00"]))
    jdir, pdir = str(out / "jax"), str(out / "port")
    pre = random_variables(jparams, 1)
    for d in (jdir, pdir):
        jsave(os.path.join(d, "pretrained_ep"), pre, {"epoch": 9})
    jlog, log = [], []
    mp = pytest.MonkeyPatch()
    try:
        # The JAX trainer's own init (replaced by the pretrained weights
        # before the first epoch) from eval_shape, not an eager init.
        mp.setattr(JTM, "init_macarons_variables",
                   lambda params, model, key: random_variables(params, 2))
        mp.setattr(JTM, "run_trajectory", jax_trajectory(jlog))
        mp.setattr(TM, "run_trajectory", port_trajectory(log))
        jvars, jlosses = JTM.run_training(
            jparams, weights_dir=jdir, memory_root=str(out / "jmem"),
            verbose=False)
        model, losses = TM.run_training(
            params, weights_dir=pdir, memory_root=str(out / "mem"),
            device="cpu", verbose=False)
    finally:
        mp.undo()
    pre = {k: flax_to_torch(v) for k, v in pre._asdict().items()}
    return jdir, pdir, pre, (jlog, jvars, jlosses), (log, model, losses)


def test_epoch_trajectories(epoch_runs):
    """The trajectories each epoch hands out: training (frozen SCONE in
    epochs 0-1) and validation (epochs 1 and 3); at the unfreeze (epoch 2)
    the pretrained weights, fresh optimizers and step counts at 0; the
    depth network after each rollback."""
    _, _, pre, (jlog, _, jlosses), (log, _, losses) = epoch_runs
    assert losses == jlosses
    assert [(r["epoch"], r["online"], r["freeze"], r["warmup"],
             r["n_poses"], r["steps"]) for r in log] == \
        [(r["epoch"], r["online"], r["freeze"], r["warmup"], r["n_poses"],
          r["steps"]) for r in jlog]
    assert [(r["epoch"], r["online"], r["freeze"]) for r in log] == [
        (0, True, True), (1, True, True), (1, False, False),
        (2, True, False), (3, True, False), (3, False, False)]
    for ours, ref in zip(log, jlog):
        assert_same_weights(ours["weights"], ref["weights"])
    # The optimizers are replaced at the unfreeze only.
    new = [i for i in range(1, len(log)) if log[i]["opt"] is not
           log[i - 1]["opt"]]
    jnew = [i for i in range(1, len(jlog)) if jlog[i]["opt"] is not
            jlog[i - 1]["opt"]]
    assert new == jnew == [3]
    assert len(log[3]["opt"].state) == 0
    assert log[3]["steps"] == (0, 0) and log[2]["steps"] == (4, 0)
    # Unfrozen at epoch 2 from the pretrained weights.
    assert_same_weights(log[3]["weights"], pre)
    # Epoch 3 starts from epoch 1's depth network (rolled back at the end
    # of epoch 2, epoch_2 being unsaved) and epoch 2's SCONE.
    ep1 = torch.load(os.path.join(epoch_runs[1], "epoch_1_ep.pt"))
    assert_same_weights(log[4]["weights"], ep1, ("depth",))
    first = next(iter(pre["occ"]))
    assert not torch.equal(log[4]["weights"]["occ"][first], ep1["occ"][first])


def test_epoch_checkpoints(epoch_runs):
    """The same checkpoint files, their weights bit for bit and their
    metadata equal; the final model is the JAX package's."""
    jdir, pdir, _, (_, jvars, _), (_, model, _) = epoch_runs
    ours = sorted(f[:-3] for f in os.listdir(pdir) if f.endswith(".pt"))
    ref = sorted(f[:-8] for f in os.listdir(jdir) if f.endswith(".msgpack")
                 and f != "pretrained_ep.msgpack")
    assert ours == ref == ["best_unval_ep", "coverage_validated_ep",
                           "epoch_1_ep", "epoch_3_ep", "unvalidated_ep"]
    for name in ours:
        tree = torch.load(os.path.join(pdir, name + ".pt"))
        jtree = read_msgpack(os.path.join(jdir, name))
        assert_same_weights(tree, {k: flax_to_torch(jtree[k])
                                   for k in ("depth", "occ", "vis")})
        with open(os.path.join(pdir, name + ".json")) as f, \
                open(os.path.join(jdir, name + ".json")) as g:
            meta, jmeta = json.load(f), json.load(g)
        assert meta == jmeta, name
    with open(os.path.join(pdir, "coverage_validated_ep.json")) as f:
        meta = json.load(f)
    assert meta["epoch"] == 4 and meta["val_coverage"] == VAL_COV[3]
    assert 0.0 <= meta["val_coverage"] <= 1.0
    assert_same_weights({k: getattr(model, k).state_dict()
                         for k in ("depth", "occ", "vis")},
                        {k: flax_to_torch(v)
                         for k, v in jvars._asdict().items()})


# ---------------------------------------------------------------------------
# The tester's collision filter
# ---------------------------------------------------------------------------


def test_camera_collides():
    """Random proxy states and camera paths: the same decisions, both of
    them taken, and targets outside the box never colliding."""
    rs = np.random.default_rng(3)
    n, seen = 2000, set()
    for trial in range(40):
        pts = rs.uniform(-1, 1, size=(n, 3)).astype(np.float32)
        sup = (rs.uniform(size=(n, 1)) < 0.6).astype(np.float32)
        oof = (rs.uniform(size=(n, 1)) < 0.3).astype(np.float32)
        X0 = rs.uniform(-1, 1, size=3).astype(np.float32)
        X1 = rs.uniform(-1.2, 1.2, size=3).astype(np.float32)
        dist = float(rs.uniform(0.02, 0.3))
        steps = int(rs.integers(2, 6))
        oof_collides = bool(trial % 3 == 0)
        zeros = np.zeros((n, 1), np.float32)
        jstate = JP.ProxyState(jnp.asarray(pts), jnp.asarray(zeros),
                               jnp.asarray(sup), jnp.zeros((n, 98)),
                               jnp.asarray(oof), jnp.asarray(zeros),
                               jnp.asarray(zeros))
        ref = bool(JP.camera_collides(
            jstate, np.array([-1.0] * 3), np.array([1.0] * 3),
            jnp.asarray(X0), jnp.asarray(X1), dist,
            n_interpolation_steps=steps, oof_collides=oof_collides))
        state = P.ProxyState(*(torch.as_tensor(np.array(a))
                               for a in jstate))
        ours = P.camera_collides(
            state, np.array([-1.0] * 3), np.array([1.0] * 3),
            torch.as_tensor(X0), torch.as_tensor(X1), dist,
            n_interpolation_steps=steps, oof_collides=oof_collides)
        assert ours == ref, trial
        seen.add((ref, bool(np.all(np.abs(X1) <= 1))))
    assert {(True, True), (False, True), (False, False)} <= seen


def scripted_collisions(module, log):
    """Wrap ``module.camera_collides``: record each call's path, proxy
    distance, step count and real decision, and return a scripted one
    instead (a move towards +x collides), so that the filter drops some
    neighbours of every pose."""
    real = module.camera_collides

    def collides(state, x_min, x_max, X_current, X_target, proxy_distance,
                 n_interpolation_steps=4, **kw):
        hit = bool(real(state, x_min, x_max, X_current, X_target,
                        proxy_distance,
                        n_interpolation_steps=n_interpolation_steps, **kw))
        a, b = np.asarray(X_current), np.asarray(X_target)
        log.append((a, b, proxy_distance, n_interpolation_steps, hit))
        return bool(b[0] > a[0] + 1e-4)
    return collides


@pytest.fixture(scope="module")
def collision_runs(root, tmp_path_factory):
    """The random policy with use_collision, 5 poses from start 0, in both
    packages, under the scripted collisions."""
    params = JParams(dict(TINY, data_path=root))
    item = JSceneDataset(root)[0]
    key = jax.random.PRNGKey(5)
    jscene = JTM.setup_scene(params, item, key)
    rt = JTM.MacaronsRuntime(params, jcreate(params), jscene.cfg,
                             jscene.cell_table)
    mem = str(tmp_path_factory.mktemp("jax_collision"))
    start = np.asarray(item["settings"].start_positions[0])
    jcalls, calls = [], []
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(JP, "camera_collides", scripted_collisions(JP, jcalls))
        jtraj, _ = jtester.compute_trajectory(
            rt, jscene, JMemory([mem]), mem,
            MacaronsVariables({}, None, None), key,
            np.random.default_rng(42), n_poses=5, surface_epsilon=0.15,
            use_collision=True, start_idx=start, policy="random")

        pparams = Params(dict(TINY, data_path=root))
        pitem = SceneDataset(root)[0]
        gen = torch.Generator().manual_seed(5)
        scene = TM.setup_scene(pparams, pitem, gen, "cpu")
        scene.gt_scene = grid_to_torch(jscene.gt_scene)
        model = init_macarons_weights(create_macarons_model(pparams, "cpu"),
                                      gen)
        prt = TM.MacaronsRuntime(pparams, model, scene.cfg, scene.cell_table,
                                 "cpu")
        pmem = str(tmp_path_factory.mktemp("port_collision"))
        mp.setattr(P, "camera_collides", scripted_collisions(P, calls))
        traj = tester.compute_trajectory(
            prt, scene, Memory([pmem]), pmem, gen, np.random.default_rng(42),
            n_poses=5, surface_epsilon=0.15, use_collision=True,
            start_idx=np.asarray(pitem["settings"].start_positions[0]),
            policy="random")
    finally:
        mp.undo()
    return jtraj, traj, jcalls, calls


def test_use_collision_trajectory(collision_runs):
    """The same calls (paths, proxy distance, steps, the real decisions),
    the same neighbours dropped, and the same trajectory."""
    jtraj, traj, jcalls, calls = collision_runs
    assert len(calls) == len(jcalls) > 20
    for (a, b, d, n, hit), (ja, jb, jd, jn, jhit) in zip(calls, jcalls):
        np.testing.assert_allclose(a, ja, atol=1e-5)
        np.testing.assert_allclose(b, jb, atol=1e-5)
        assert (n, hit) == (jn, jhit)
        np.testing.assert_allclose(d, jd, rtol=1e-6)
    moves = np.diff(np.asarray(traj["X_cam"])[::2, 0])
    assert traj["cam_idx"] == jtraj["cam_idx"]
    np.testing.assert_allclose(traj["coverage"], jtraj["coverage"], atol=1e-3)
    np.testing.assert_allclose(traj["X_cam"], jtraj["X_cam"], atol=1e-5)
    assert np.all(moves <= 1e-4)  # no scripted collision was taken
