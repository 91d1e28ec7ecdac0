"""The online trainer's loop on the CPU: the replay memory shared with the
JAX package, and a tiny ``run_training`` with its resume.

Memory: files written by one package are read by the other, key for key,
and the same ``np.random.Generator`` picks the same replay frames and
scenes in both. Training: synth_00 at tiny widths with ManyDepth, the
default training config's alphas, augmentation and mirroring, two
rotating memory trajectories, a remap at pose 2, the disk memory; one
epoch, then a resumed run to two epochs in the same process, with depth
replay and SCONE replay in the second (the device memory's run is in
test_torch_port_device_memory.py). The checkpoints and memory files sit
where the JAX package's trainer puts them (tests/test_train_macarons.py).
"""

import json
import os

import numpy as np
import pytest
import torch

from macarons_tpu.models.losses import uncentered_l1 as juncentered_l1
from macarons_tpu.scene.memory import Memory as JMemory
from macarons_tpu_torch.config import Params
from macarons_tpu_torch.models import losses as L
from macarons_tpu_torch.scene.grid import GridState
from macarons_tpu_torch.scene.memory import Memory
from macarons_tpu_torch.scene.proxy import ProxyState
from macarons_tpu_torch.trainers import train_macarons as TM
from torch_port_helpers import make_scene_root, torch_one_thread  # noqa: F401

TRAIN = dict(
    image_height=32, image_width=48, znear=0.5, zfar=40.0, n_depth=8,
    n_alpha=2, n_alpha_for_supervision=3, alphas=[-1, -2, 1],
    use_future_frame_for_supervision=True, n_interpolation_steps=2,
    n_proxy_points=1500, seq_len=64, n_gt_surface_points=1024,
    surface_cell_resolution=0.15, test_resolution=0.075,
    view_state_n_elev=7, view_state_n_azim=14, harmonic_degree=8,
    k_for_knn=8, n_cell_per_occ_forward_pass=4, occ_cell_batch=2,
    min_occ_for_proxy_points=0.01, use_occ_to_sample_proxy_points=True,
    use_sigmoid=True, sensor_range=48.0, gathering_factor=0.1,
    learning_rate=1e-4, epochs=1, n_poses_in_trajectory=3,
    online_learning=True, data_augmentation=True, jitter_probability=1.0,
    random_seed=42, torch_seed=5, scene_scale_factor=1.0,
    macarons_model_name="test_mac", n_memory_loops=1, n_memory_samples=2,
    recompute_surface_every_n_loop=0,
    n_proxy_point_for_occupancy_supervision=200,
    occ_curriculum_min_cells=2, occ_curriculum_max_cells=4,
    n_memory_trajectories=2, n_memory_scene_loops=1,
    n_poses_in_memory_scene_loops=2, n_max_memory_depths_for_partial_pc=3,
    remap_at_pose=2, load_obj_textures=False, axis_to_mirror=[0],
    device_memory=False,
)
N_FRAMES = 1 + TRAIN["n_alpha"] + (TRAIN["n_poses_in_trajectory"]
                                   * TRAIN["n_interpolation_steps"])


def fill_memory(mem, path, rs):
    """Two trajectories of frames, depths and snapshots, as the trainer
    writes them."""
    H, W, N = 8, 12, 50
    for traj in range(2):
        mem.save_frame_batch(
            path, 0, rs.uniform(size=(7, H, W, 3)).astype(np.float32),
            rs.uniform(1, 5, size=(7, H, W, 1)).astype(np.float32),
            rs.uniform(size=(7, H, W, 1)) > 0.5,
            rs.normal(size=(7, 3, 3)).astype(np.float32),
            rs.normal(size=(7, 3)).astype(np.float32), 40.0, traj=traj)
        for i in range(5):
            mem.save_depth(
                path, i, rs.uniform(1, 5, size=(1, H, W, 1)).astype(np.float32),
                rs.uniform(size=(1, H, W, 1)) > 0.5,
                rs.uniform(size=(1, H, W, 1)) > 0.5,
                rs.normal(size=(1, 3, 3)).astype(np.float32),
                rs.normal(size=(1, 3)).astype(np.float32), traj=traj)
        grid = GridState(rs.normal(size=(8, 4, 3)).astype(np.float32),
                         rs.uniform(size=(8, 4, 1)).astype(np.float32),
                         rs.uniform(size=(8, 4)) > 0.5)
        mem.save_surface_scene(path, grid, traj=traj)
        proxy = ProxyState(*(
            rs.uniform(size=(N,) + shape).astype(np.float32)
            for shape in ((3,), (98,), (1,), (1,), (1,), (1,), (1,))))
        mem.save_occupancy_field(path, proxy, traj=traj)
        mem.save_poses(path, 0, rs.normal(size=(4, 3)),
                       rs.normal(size=(4, 2)), rs.integers(0, 5, size=(4, 5)),
                       traj=traj)


def sampler_draws(mem, path, seed):
    rs = np.random.default_rng(seed)
    return (mem.get_random_frames_for_depth(rs, path, 3),
            mem.sample_depth_replay(rs, 4, 3),
            mem.get_random_scene_for_scone(rs, path, 2, n_loops=2,
                                           max_build=4, n_proxy_points=50))


def tree_equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            tree_equal(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            tree_equal(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_memory_shared_with_jax(tmp_path, writer):
    path = str(tmp_path / "scene" / "macarons_memory")
    write_cls, read_cls = ((Memory, JMemory) if writer == "port"
                           else (JMemory, Memory))
    w = write_cls([path], n_trajectories=2)
    fill_memory(w, path, np.random.default_rng(0))
    w.flush()  # both packages queue their writes
    r = read_cls([path], n_trajectories=2)
    for traj in range(2):
        assert r.n_frames(path, traj) == w.n_frames(path, traj) == 7
        assert r.n_depths(path, traj) == w.n_depths(path, traj) == 5
        tree_equal(r.load_frame(path, 3, traj), w.load_frame(path, 3, traj))
        tree_equal(r.load_frame_sequence(path, 6, 3, traj),
                   w.load_frame_sequence(path, 6, 3, traj))
        tree_equal(r.load_depth(path, 4, traj), w.load_depth(path, 4, traj))
        tree_equal(r.load_surface_scene(path, traj),
                   w.load_surface_scene(path, traj))
        tree_equal(r.load_occupancy_field(path, traj),
                   w.load_occupancy_field(path, traj))
        with np.load(os.path.join(path, "training", str(traj), "poses",
                                  "epoch_0.npz")) as f:
            assert set(f) == {"X_cam", "V_cam", "cam_idx"}
    for seed in range(5):
        ours, ref = sampler_draws(r, path, seed), sampler_draws(w, path, seed)
        assert ours[2] is not None
        tree_equal(ours, ref)


def test_run_training_and_resume(tmp_path_factory, monkeypatch):
    root = make_scene_root(tmp_path_factory)
    out = tmp_path_factory.mktemp("train")
    wdir, mroot = str(out / "w"), str(out / "mem")
    phases = []
    windows = []
    uncentered_l1 = L.uncentered_l1

    def recording_l1(pred, truth):
        """The coverage loss, with each window's gains kept."""
        loss = uncentered_l1(pred, truth)
        windows.append((pred.detach().numpy().copy(), truth.numpy().copy(),
                        float(loss.detach())))
        return loss

    monkeypatch.setattr(L, "uncentered_l1", recording_l1)
    model, losses = TM.run_training(
        Params(dict(TRAIN, data_path=root)), weights_dir=wdir,
        memory_root=mroot, device="cpu", verbose=False)
    assert len(losses) == 1
    for k in ("depth", "occ", "cov"):
        assert np.isfinite(losses[0][k])
    assert losses[0]["depth"] > 0
    # Each online SCONE step's coverage loss is the JAX package's uncentered
    # L1 of the window's predicted and supervision gains, and the epoch's is
    # their mean. It is 0 exactly where the two mean-normalised gain vectors
    # agree: a window's first frame arrives covered (gain 0, predicted 0),
    # so in a two-frame window any positive prediction for the second frame
    # is exact. It is positive wherever they differ.
    assert len(windows) == TRAIN["n_poses_in_trajectory"]
    differ = []
    for pred, truth, loss in windows:
        assert truth.sum() > 0 and pred.sum() > 0
        ref = float(juncentered_l1(pred, truth))
        np.testing.assert_allclose(loss, ref, rtol=1e-5, atol=1e-7)
        differ.append(ref > 1e-6)
    np.testing.assert_allclose(losses[0]["cov"],
                               np.mean([w[2] for w in windows]), rtol=1e-6)
    assert (losses[0]["cov"] > 0) == any(differ)
    for f in ("unvalidated_test_mac.pt", "unvalidated_test_mac.json",
              "epoch_0_test_mac.pt", "best_unval_test_mac.pt",
              "losses_data_test_mac.json"):
        assert os.path.exists(os.path.join(wdir, f)), f
    mem = os.path.join(mroot, "synth_00", "macarons_memory", "training")
    t0 = os.path.join(mem, "0")
    assert len(os.listdir(os.path.join(t0, "frames"))) == N_FRAMES
    # The remap at pose 2 saved the depth of every frame after the alphas.
    assert (len(os.listdir(os.path.join(t0, "depths")))
            == N_FRAMES - TRAIN["n_alpha"])
    for f in ("surface/scene.npz", "occupancy/field.npz", "poses/epoch_0.npz"):
        assert os.path.exists(os.path.join(t0, f)), f

    before = {k: v.clone() for k, v in model.vis.state_dict().items()}
    model2, losses2 = TM.run_training(
        Params(dict(TRAIN, data_path=root, epochs=2, start_from_scratch=False,
                    schedule_learning_rate=True, depth_warmup=2,
                    scone_warmup=2)),
        weights_dir=wdir, memory_root=mroot, device="cpu", verbose=False,
        on_phase=lambda e, pose, name: phases.append((e, pose, name)))
    assert len(losses2) == 2 and losses2[0] == losses[0]
    assert np.isfinite(losses2[1]["depth"]) and losses2[1]["depth"] > 0
    meta = json.loads(open(os.path.join(wdir, "unvalidated_test_mac.json"))
                      .read())
    assert meta["epoch"] == 2 and meta["train_losses"] == losses2
    # Epoch 1 (trajectory slot 1): per pose one online step of each network
    # and one replay step of each, from slot 0.
    n = TRAIN["n_poses_in_trajectory"]
    assert meta["depth_opt_steps"] == 2 * n
    assert meta["scone_opt_steps"] == 2 * n
    assert len(os.listdir(os.path.join(mem, "1", "frames"))) == N_FRAMES
    assert [p for p in phases if p[1] == 0] == [
        (1, 0, name) for name in ("decision", "capture", "depth_step",
                                  "scone_step", "depth_replay",
                                  "scone_replay", "remap", "done")]
    assert any(not torch.equal(v, model2.vis.state_dict()[k])
               for k, v in before.items())
    with open(os.path.join(wdir, "losses_data_test_mac.json")) as f:
        assert json.load(f)["train_losses"] == losses2


def test_load_macarons_reads_jax_checkpoint(tmp_path):
    """``load_macarons`` takes a JAX checkpoint (``<path>.msgpack`` and its
    ``.json``): the weights, converted, and the metadata."""
    import jax.numpy as jnp

    from macarons_tpu.models.macarons import MacaronsVariables
    from macarons_tpu.models.macarons import save_macarons as jsave
    from macarons_tpu.models.scone import SconeOcc as JSconeOcc
    from macarons_tpu.models.scone import SconeVis as JSconeVis
    from macarons_tpu_torch.models.macarons import MacaronsModel, \
        load_macarons
    from macarons_tpu_torch.models.scone import SconeOcc, SconeVis
    from macarons_tpu_torch.utils.convert import flax_to_torch
    from torch_port_helpers import OCC_KW, VIS_KW, random_flax_variables

    occ_vars = random_flax_variables(JSconeOcc(**OCC_KW), 1,
                                     jnp.zeros((1, 300, 3)),
                                     jnp.zeros((1, 8, 3)),
                                     jnp.zeros((1, 8, 64)))
    vis_vars = random_flax_variables(JSconeVis(**VIS_KW), 2,
                                     jnp.zeros((1, 64, 4)),
                                     jnp.zeros((1, 64, 64)))
    path = str(tmp_path / "unvalidated_jax")
    jsave(path, MacaronsVariables({}, occ_vars, vis_vars),
          {"epoch": 3, "best_loss": 0.25})
    model = MacaronsModel(SconeOcc(**OCC_KW), SconeVis(**VIS_KW), None)
    meta = load_macarons(path, model)
    assert meta["epoch"] == 3 and meta["best_loss"] == 0.25
    for net, tree in ((model.occ, occ_vars), (model.vis, vis_vars)):
        for k, v in flax_to_torch(tree).items():
            assert torch.equal(net.state_dict()[k], v), k


def test_train_cli_defaults_to_cuda(tmp_path):
    """``python -m macarons_tpu_torch.train`` trains on the card unless
    ``--device`` says otherwise, and raises without one."""
    from macarons_tpu_torch import train

    cfg = tmp_path / "config.json"
    cfg.write_text(json.dumps(dict(TRAIN, data_path=str(tmp_path / "none"))))
    args = ["-c", str(cfg), "--weights-dir", str(tmp_path / "w"),
            "--memory-root", str(tmp_path / "m")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train.main(args)
    with pytest.raises(FileNotFoundError):
        train.main(args + ["--device", "cpu"])
