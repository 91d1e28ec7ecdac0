"""The port's synthetic-suite evaluation against the JAX package's (CPU).

``eval_params`` is the JAX package's dict; ``summarize`` gives the
committed ``RESULTS_synthetic.json`` its ``_all_summaries`` and ``_lift``
from the file's own raw trajectories; ``run_suite_eval`` on 1 scene x 1
start x 2 poses gives the JAX package's trajectories. The ground-truth
surface grid and the scorer's Monte-Carlo sample are draws that
``jax.random`` and a ``torch.Generator`` cannot share, so the JAX run's are
recorded and injected into the port (as tests/test_torch_port_trajectory.py
does); the random walk draws from the same numpy generator in both.
"""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from macarons_tpu.config import Params as JParams
from macarons_tpu.scene import grid as jG
from macarons_tpu.scene import runtime as jR
from macarons_tpu.testers import scene as jtester
from macarons_tpu_torch.config import Params
from macarons_tpu_torch.data import synthetic_suite as S
from macarons_tpu_torch.data.scenes import SceneDataset
from macarons_tpu_torch.models.macarons import MacaronsModel, \
    create_macarons_model
from macarons_tpu_torch.models.attention import init_weights
from macarons_tpu_torch.scene import grid as G
from macarons_tpu_torch.scene.memory import Memory
from macarons_tpu_torch.testers import scene as tester
from macarons_tpu_torch.trainers import train_macarons as TM
from macarons_tpu_torch.utils.convert import load_module_weights, \
    read_msgpack, write_msgpack
from test_torch_port_trajectory import jax_draws
from torch_port_helpers import grid_to_torch, torch_one_thread  # noqa: F401
from torch_port_helpers import write_suite_vis_init

REPO = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, os.path.join(REPO, "data_tools"))
import synthetic_suite as JS  # noqa: E402

N_POSES = 2
POLICIES = ("nbv", "random")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return S.generate_suite(str(tmp_path_factory.mktemp("suite")), n_scenes=1)


def test_eval_params_match_jax():
    for args in (("data/x",), ("/tmp/y", 3000)):
        assert S.eval_params(*args) == JS.eval_params(*args)


def test_summarize_reproduces_committed_results():
    """The committed file's 8 summary rows, its 5 lifts and its
    ``_summary`` (the trained row's valid starts), from its trajectories."""
    with open(os.path.join(REPO, "RESULTS_synthetic.json")) as f:
        data = json.load(f)
    per_policy = {"nbv_trained": {k: v for k, v in data.items()
                                  if not k.startswith("_")},
                  **data["_baselines"]}
    summaries, lift = S.summarize(per_policy)
    assert len(summaries) == 8 and summaries == data["_all_summaries"]
    assert lift == data["_lift"]
    assert data["_summary"] == summaries["nbv_trained_valid_starts"]


class Recorder:
    """Wraps the JAX tester to record each scene's GT grid, each
    decision's MC sample and the draws of each fill of the true-coverage
    grid, and the port's tester to inject them in the same order."""

    def __init__(self):
        self.gt, self.draws, self.fills = [], [], []
        self.filling = False

    def jax_setup_scene(self, setup):
        def run(*args, **kw):
            scene = setup(*args, **kw)
            self.gt.append(scene.gt_scene)
            return scene
        return run

    def jax_coverage_fn(self, make, params):
        def build(*args, **kw):
            fn = make(*args, **kw)

            def call(vis_vars, *a):
                field, cams, key = a[:4], a[4], a[-1]
                self.draws.append(np.array(jax_draws(params, field, cams,
                                                       key)[0]))
                return fn(vis_vars, *a)
            return call
        return build

    def coverage_update(self, update):
        """The tester's true-coverage update, flagged while it runs."""
        def run(*args, **kw):
            self.filling = True
            try:
                return update(*args, **kw)
            finally:
                self.filling = False
        return run

    def jax_fill_cells(self, fill):
        """Records fill_cells' permutation and eviction scores, drawn from
        its key as it draws them (macarons_tpu/scene/grid.py)."""
        def run(cfg, state, key, pts, *args, **kw):
            if self.filling:
                k_shuffle, k_evict = jax.random.split(key)
                self.fills.append((
                    np.array(jax.random.permutation(k_shuffle, pts.shape[0])),
                    np.array(jax.random.uniform(
                        k_evict, (cfg.n_cells, 2 * cfg.capacity)))))
            return fill(cfg, state, key, pts, *args, **kw)
        return run

    def port_fill_cells(self, fill, fills):
        fills = list(fills)

        def run(*args, **kw):
            if self.filling:
                kw["draws"] = tuple(torch.as_tensor(a) for a in fills.pop(0))
            return fill(*args, **kw)
        return run

    def port_setup_scene(self, setup, gt):
        gt = list(gt)

        def run(*args, **kw):
            scene = setup(*args, **kw)
            scene.gt_scene = grid_to_torch(gt.pop(0))
            return scene
        return run

    def port_coverage(self, coverage_gains, draws):
        draws = list(draws)

        def call(rt, *args, generator=None, **kw):
            kw["sample_idx"] = torch.as_tensor(draws.pop(0))
            return coverage_gains(rt, *args, **kw)
        return call


@pytest.fixture(scope="module")
def suite_runs(root, tmp_path_factory):
    """(JAX results, port results) of ``run_suite_eval`` on 1 scene x 1
    start x ``N_POSES`` poses for nbv and random, the port's with the JAX
    run's draws and the committed SconeVis weights."""
    rec = Recorder()
    jout = str(tmp_path_factory.mktemp("jax") / "res.json")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtester, "setup_scene",
                   rec.jax_setup_scene(jtester.setup_scene))
        mp.setattr(jtester, "true_coverage_update",
                   rec.coverage_update(jtester.true_coverage_update))
        mp.setattr(jG, "fill_cells", rec.jax_fill_cells(jG.fill_cells))
        mp.setattr(jR, "make_coverage_gain_fn", rec.jax_coverage_fn(
            jR.make_coverage_gain_fn, JParams(JS.eval_params(root))))
        JS.run_suite_eval(root, out_json=jout, n_poses=N_POSES,
                          n_start_poses=1, policies=POLICIES, verbose=False)
    assert len(rec.gt) == 2 and len(rec.draws) == N_POSES
    assert len(rec.fills) == 2 * (3 + 2 * N_POSES)
    pout = str(tmp_path_factory.mktemp("port") / "res.json")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tester, "setup_scene",
                   rec.port_setup_scene(tester.setup_scene, rec.gt))
        mp.setattr(tester, "true_coverage_update",
                   rec.coverage_update(tester.true_coverage_update))
        mp.setattr(G, "fill_cells", rec.port_fill_cells(G.fill_cells,
                                                        rec.fills))
        mp.setattr(TM.MacaronsRuntime, "coverage_gains", rec.port_coverage(
            TM.MacaronsRuntime.coverage_gains, rec.draws))
        data = S.run_suite_eval(root, pout, n_poses=N_POSES, n_start_poses=1,
                                policies=POLICIES, device="cpu",
                                vis_weights_path=S.SUITE_VIS_INIT + ".msgpack",
                                verbose=False)
    with open(jout) as f, open(pout) as g:
        return json.load(f), json.load(g), data


def assert_same_trajectory(ours, ref):
    assert set(ours) == set(ref)
    assert ours["cam_idx"] == ref["cam_idx"]
    np.testing.assert_allclose(ours["coverage"], ref["coverage"], atol=1e-4)
    np.testing.assert_allclose(ours["X_cam"], ref["X_cam"], atol=1e-5)
    np.testing.assert_allclose(ours["V_cam"], ref["V_cam"], atol=1e-4)


@pytest.mark.parametrize("policy", POLICIES)
def test_run_suite_eval_matches_jax(suite_runs, policy):
    jdata, pdata, returned = suite_runs
    assert pdata == json.loads(json.dumps(returned))
    ref = jdata if policy == "nbv" else jdata["_baselines"][policy]
    ours = pdata if policy == "nbv" else pdata["_baselines"][policy]
    assert_same_trajectory(ours["synth_00"]["0"], ref["synth_00"]["0"])
    assert len(ours["synth_00"]["0"]["coverage"]) == N_POSES + 1


def test_run_suite_eval_layout(suite_runs):
    """The committed file's layout: its top-level keys, the primary's
    scenes and starts, the baselines, the summaries of every policy."""
    jdata, pdata, _ = suite_runs
    with open(os.path.join(REPO, "RESULTS_synthetic.json")) as f:
        committed = json.load(f)
    keys = {k for k in committed if k.startswith("_")}
    assert {k for k in pdata if k.startswith("_")} == keys
    assert ({k for k in pdata if not k.startswith("_")}
            == {k for k in jdata if not k.startswith("_")} == {"synth_00"})
    assert set(pdata["_baselines"]) == set(jdata["_baselines"]) == {"random"}
    assert set(pdata["_all_summaries"]) == {
        "nbv", "nbv_valid_starts", "random", "random_valid_starts"}
    assert set(pdata["_lift"]) == {"nbv_vs_random"}
    assert pdata["_summary"] == pdata["_all_summaries"]["nbv_valid_starts"]
    proto = pdata["_protocol"]
    assert (proto["n_poses"], proto["n_start_poses"], proto["policies"]) == (
        N_POSES, 1, list(POLICIES))
    assert set(proto["seconds_per_pose"]) == set(POLICIES)


def occ_init_trajectory(root, tmp_path, occ_seed):
    """An nbv trajectory under eval_params (with a quarter of its proxy
    points, which SconeOcc's field would score) on the CPU with the
    committed SconeVis and SconeOcc drawn from ``occ_seed``; every other
    draw from one generator seeded 5."""
    params = Params(S.eval_params(root, n_proxy=5000))
    item = SceneDataset(root)[0]
    gen = torch.Generator().manual_seed(5)
    scene = TM.setup_scene(params, item, gen, "cpu")
    model = create_macarons_model(params, "cpu")
    init_weights(model.occ, torch.Generator().manual_seed(occ_seed))
    load_module_weights(model.vis, S.SUITE_VIS_INIT)
    rt = TM.MacaronsRuntime(params, model, scene.cfg, scene.cell_table, "cpu")
    mem = str(tmp_path / f"occ_{occ_seed}")
    traj = tester.compute_trajectory(
        rt, scene, Memory([mem]), mem, gen, np.random.default_rng(42),
        n_poses=2, surface_epsilon=0.15,
        start_idx=np.asarray(item["settings"].start_positions[0]))
    return traj, model


def test_sconeocc_init_does_not_reach_nbv(root, tmp_path):
    """Under eval_params the carving field replaces SconeOcc's: two
    SconeOcc inits give the same nbv trajectory, bit for bit (the ground
    for committing SconeVis's weights only)."""
    traj_a, model_a = occ_init_trajectory(root, tmp_path, 1)
    traj_b, model_b = occ_init_trajectory(root, tmp_path, 2)
    assert isinstance(model_a, MacaronsModel)
    assert any(not torch.equal(v, model_b.occ.state_dict()[k])
               for k, v in model_a.occ.state_dict().items())
    assert traj_a == traj_b
    assert traj_a["coverage"][-1] > traj_a["coverage"][0]


def test_write_suite_vis_init_regenerates_committed_file(tmp_path):
    path = str(tmp_path / "vis")
    write_suite_vis_init(path)
    ours, committed = read_msgpack(path), read_msgpack(S.SUITE_VIS_INIT)
    flat = jax.tree_util.tree_leaves_with_path
    assert ([p for p, _ in flat(ours)] == [p for p, _ in flat(committed)])
    for (p, a), (_, b) in zip(flat(ours), flat(committed)):
        assert a.dtype == b.dtype and np.array_equal(a, b), p
    assert sum(a.size for a in jax.tree_util.tree_leaves(committed)) \
        == 1_392_888


def test_cli_defaults_to_cuda(root, tmp_path):
    """``eval`` and ``eval-all`` run on the card unless ``--device`` says
    otherwise, and raise without one; ``train-config`` writes the suite's
    training config."""
    import inspect

    assert inspect.signature(S.run_suite_eval).parameters[
        "device"].default == "cuda"
    if not torch.cuda.is_available():
        for cmd in ("eval", "eval-all"):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                S.main([cmd, root, "--poses", "1", "--starts", "1",
                        "--out", str(tmp_path / "res.json")])
        assert not os.path.exists(tmp_path / "res.json")
    cfg = tmp_path / "train.json"
    S.main(["train-config", root, "--out", str(cfg)])
    with open(cfg) as f:
        params = json.load(f)
    assert params == S.suite_training_params(root).to_dict()
    for k, v in S.eval_params(root).items():
        if k not in ("random_seed", "torch_seed", "learning_rate"):
            assert params[k] == v, k
    assert (params["epochs"], params["n_poses_in_trajectory"]) == (3, 100)
    # Relative to the repo's root, so the config serves any checkout.
    assert params["vis_init_path"] == os.path.join(
        "macarons_tpu_torch", "data", "weights", "suite_vis_init")
    assert os.path.samefile(os.path.join(S.REPO_DIR, params[
        "vis_init_path"]) + ".msgpack", S.SUITE_VIS_INIT + ".msgpack")


def test_suite_rows_commands(tmp_path):
    """Each row's runs at the committed protocol: 100 poses x 5 starts,
    nbv on scenes 0-4 with the committed SconeVis, random as two runs
    over scenes 0-4 and 5-9, carving on every scene, the trained row on
    scenes 0-4 with the SconeVis msgpack of the training run's newest
    epoch."""
    from macarons_tpu_torch.data import suite_rows as R

    def arg(cmd, flag):
        return cmd[cmd.index(flag) + 1] if flag in cmd else None

    (tmp_path / "weights").mkdir()
    for e in (2, 10, 9):
        (tmp_path / "weights" / f"epoch_{e}_vis.msgpack").write_bytes(b"")
    cmds = {name: R.eval_cmd(name, policy, scenes, 6, str(tmp_path))
            for runs in R.ROWS.values() for name, policy, scenes in runs}
    for name, cmd in cmds.items():
        assert cmd[2:5] == ["macarons_tpu_torch.data.synthetic_suite",
                            "eval", R.SUITE]
        assert (arg(cmd, "--poses"), arg(cmd, "--starts"),
                arg(cmd, "--torch-seed")) == ("100", "5", "6")
        assert arg(cmd, "--out") == str(tmp_path / f"{name}_6.json")
        assert "--device" not in cmd
    scenes = {n: arg(c, "--test-scenes") for n, c in cmds.items()}
    first = ",".join(f"synth_{i:02d}" for i in range(5))
    second = ",".join(f"synth_{i:02d}" for i in range(5, 10))
    assert scenes == {"nbv": first, "random": first, "random_b": second,
                      "carving": None, "trained": first}
    assert [arg(c, "--policies") for c in cmds.values()] == [
        "nbv", "random", "random", "carving", "nbv"]
    assert arg(cmds["nbv"], "--vis-weights") == S.SUITE_VIS_INIT + ".msgpack"
    assert arg(cmds["trained"], "--vis-weights") == str(
        tmp_path / "weights" / "epoch_10_vis.msgpack")
    assert "--weights" not in cmds["trained"]
    assert R.SEEDS == (5, 6, 7)


def test_suite_rows_summary(tmp_path):
    """``suite_rows.summarize`` on three seeds' random rows made of the
    committed walks. ``random_<seed>.json`` is one run over the 10 scenes
    whose walks of scenes 5-9 depart from the committed ones (shifted by
    one pose), ``random_b_<seed>.json`` the second run over scenes 5-9;
    seed 6 has a pose of synth_03 changed. The row takes scenes 0-4 of the
    first and 5-9 of the second: its means and spreads, the hold, the
    walks on the committed poses with the first that differs, and each
    run's own."""
    import copy

    from macarons_tpu_torch.data import suite_rows

    with open(os.path.join(REPO, "RESULTS_synthetic.json")) as f:
        committed = json.load(f)
    walk = committed["_baselines"]["random"]
    shifted = walk["synth_05"]["0"]["cam_idx"][1:]
    first_apart = next(i for i, (a, b) in enumerate(
        zip(shifted, walk["synth_05"]["0"]["cam_idx"])) if a != b)
    per_seed = []
    for seed in (5, 6, 7):
        res = copy.deepcopy(walk)
        if seed == 6:
            res["synth_03"]["2"]["cam_idx"][7] = [9, 9, 9, 9, 9]
            res["synth_03"]["2"]["coverage"][-1] += 0.03
        summaries, _ = S.summarize({"random": res})
        per_seed.append(
            summaries["random_valid_starts"]["mean_final_coverage"])
        one_run = copy.deepcopy(res)
        for scene in suite_rows.SECOND_RUN:
            for traj in one_run[scene].values():
                traj["cam_idx"] = traj["cam_idx"][1:] + traj["cam_idx"][:1]
                traj["coverage"] = [c * 0.5 for c in traj["coverage"]]
        with open(tmp_path / f"random_{seed}.json", "w") as f:
            json.dump(dict(one_run, _protocol={
                "seconds_per_pose": {"random": seed / 20}}), f)
        second = {k: v for k, v in res.items()
                  if k in suite_rows.SECOND_RUN}
        with open(tmp_path / f"random_b_{seed}.json", "w") as f:
            json.dump(dict(second, _protocol={
                "seconds_per_pose": {"random": 0.1}}), f)
    rows = suite_rows.summarize(str(tmp_path))
    walks = rows["pose_matches"]["random"]
    assert walks[5] == walks[7] == {"matching": 50, "of": 50,
                                    "first_mismatch": None}
    assert walks[6]["matching"] == 49
    assert walks[6]["first_mismatch"] == (
        "synth_03", "2", 7, [9, 9, 9, 9, 9],
        walk["synth_03"]["2"]["cam_idx"][7])
    # Start 4's isolated pose takes no draw: its walk stays put.
    still = sum(t["cam_idx"] == t["cam_idx"][1:] + t["cam_idx"][:1]
                for scene in suite_rows.SECOND_RUN
                for t in walk[scene].values())
    assert still == 5
    assert rows["pose_matches"]["random_5.json"] == {
        "matching": 25 + still, "of": 50,
        "first_mismatch": rows["pose_matches"]["random_5.json"][
            "first_mismatch"]}
    assert rows["pose_matches"]["random_5.json"]["first_mismatch"][:3] == (
        "synth_05", "0", first_apart)
    assert rows["pose_matches"]["random_b_6.json"] == {
        "matching": 25, "of": 25, "first_mismatch": None}
    final = rows["rows"]["random_valid_starts"]["mean_final_coverage"]
    ref = committed["_all_summaries"]["random_valid_starts"]
    assert per_seed[0] == per_seed[2] == ref["mean_final_coverage"]
    assert per_seed[1] > per_seed[0]
    assert final["per_seed"] == per_seed
    assert final["sd"] == pytest.approx(np.std(per_seed, ddof=1))
    assert final["half_width"] == 0.005 and final["held"]
    assert rows["rows"]["random"]["mean_auc"]["held"]
    assert rows["rows"]["random"]["n_traj"] == [50]
    assert rows["seconds_per_pose"]["random"] == pytest.approx(
        {5: 0.175, 6: 0.2, 7: 0.225})
    assert set(rows["rows"]) == {"random", "random_valid_starts"}
    with open(tmp_path / "rows.json") as f:
        assert json.load(f)["rows"] == json.loads(json.dumps(rows["rows"]))
    # A trained SconeVis msgpack with one weight moved by 0.5.
    tree = read_msgpack(S.SUITE_VIS_INIT)
    node, key = tree, "params"
    while isinstance(node[key], dict):
        node, key = node[key], next(iter(node[key]))
    node[key] = node[key].copy()
    node[key].reshape(-1)[0] += 0.5
    (tmp_path / "weights").mkdir()
    write_msgpack(str(tmp_path / "weights" / "epoch_2_vis"), tree)
    change = suite_rows.summarize(str(tmp_path))["vis_change"]
    assert change["checkpoint"] == "epoch_2_vis.msgpack"
    assert change["max_abs"] == pytest.approx(0.5)
    assert 0 < change["relative_norm"] < 1e-2
