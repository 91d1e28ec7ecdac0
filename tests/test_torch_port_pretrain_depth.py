"""The depth pretrainer and the initial depth model: the port against the
JAX package on the CPU.

``RGBDataset`` over frame directories with a trajectory boundary and a
blacklisted frame; ``load_frame_batch``; ``pretrain_depth.run_training``
at 32 x 48 with 4 planes, augmentation off, batch 2, from the JAX
package's init (its ``model.init`` under the JAX trainer's key split,
converted and injected through ``init_model``), for 2 epochs and then
resumed to a third: the batches in the same order (the resume re-seeds
numpy's generator, as the JAX package's does), the first step's loss
within 1e-5 relative and every later step's and epoch's within 1e-3, the
checkpoints and their metadata; the JAX run's msgpack loading into the
port; and ``utils.generate_depth_model`` (``graft_resnet``) against
weights_tools/generate_depth_model.py on a synthetic torchvision-keyed
resnet18 state dict, its output and a pretrainer checkpoint grafted by
``utils.generate_macarons_model -d``.

Each JAX ``run_training`` compiles its step once (~30 s on an 8-core
CPU); the JAX step's losses are read through ``jax.debug.callback``.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from macarons_tpu.config import Params as JParams
from macarons_tpu.data.datasets import RGBDataset as JRGBDataset
from macarons_tpu.trainers import pretrain_depth as JPD
from macarons_tpu_torch.config import Params
from macarons_tpu_torch.data.datasets import RGBDataset
from macarons_tpu_torch.models.macarons import create_macarons_model
from macarons_tpu_torch.trainers import pretrain_depth as PD
from macarons_tpu_torch.utils import generate_depth_model as GDM
from macarons_tpu_torch.utils.checkpoint import load_checkpoint
from macarons_tpu_torch.utils.convert import flax_to_torch, read_msgpack
from macarons_tpu_torch.utils.generate_macarons_model import assemble
from torch_port_helpers import resnet18_state_dict, \
    torch_one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 32, 48
PRETRAIN = {"image_height": H, "image_width": W, "znear": 0.5, "zfar": 20.0,
            "n_depth": 4, "n_alpha": 2, "alphas": [-2, -1], "batch_size": 2,
            "epochs": 2, "learning_rate": 1e-4, "data_augmentation": False,
            "depth_model_name": "test_depth", "random_seed": 3,
            "torch_seed": 5}


def write_frames(d, nums, seed):
    """Frames as the online trainer's Memory writes them: a camera moving
    along x past a textured plane, with its depth."""
    rs = np.random.default_rng(seed)
    os.makedirs(d, exist_ok=True)
    for n in nums:
        np.savez(os.path.join(d, f"{n}.npz"),
                 rgb=rs.random((1, H, W, 3)).astype(np.float32),
                 zbuf=np.full((1, H, W, 1), 2.0, np.float32),
                 mask=rs.random((1, H, W, 1)) > 0.05,
                 R=np.eye(3, dtype=np.float32)[None],
                 T=np.array([[0.1 * n, 0.02 * n, 3.0]], np.float32),
                 zfar=np.float32(20.0))
    return str(d)


@pytest.mark.parametrize("alphas", [[-2, -1], [-1, -2, 1]])
def test_rgb_dataset(tmp_path, alphas):
    """The same items in the same order, around a gap in a trajectory
    (frame 5 missing), a blacklisted frame, and a second directory."""
    a = write_frames(tmp_path / "a" / "frames", [0, 1, 2, 3, 4, 6, 7, 8, 9],
                     0)
    b = write_frames(tmp_path / "b" / "frames", range(4), 1)
    removed = [os.path.join(a, "3.npz"), os.path.join(b, "0.npz")]
    ours = RGBDataset([b, a], alphas, removed)
    ref = JRGBDataset([b, a], alphas, removed)
    items = [ours[i] for i in range(len(ours))]
    assert len(items) == len(ref) >= 3
    assert items == [ref[i] for i in range(len(ref))]
    # Frame 3 is no item, but another item takes it as a neighbour.
    third = os.path.join(a, "3.npz")
    assert third not in [it["frame"] for it in items]
    assert any(third in it["alpha_frames"] for it in items)


def test_load_frame_batch(tmp_path):
    d = write_frames(tmp_path / "frames", range(6), 2)
    items = [RGBDataset([d])[i] for i in (3, 0)]
    ours = PD.load_frame_batch(items, 2, "cpu")
    ref = JPD.load_frame_batch(items, 2)
    for o, r in zip(ours, ref):
        assert set(o) == set(r)
        for k in r:
            assert o[k].dtype == {"mask": torch.bool}.get(k, torch.float32)
            np.testing.assert_array_equal(o[k].numpy(), np.asarray(r[k]),
                                          err_msg=k)


def jax_init(params):
    """The JAX pretrainer's initial variables: its key split and init."""
    key = jax.random.PRNGKey(params.get("torch_seed", 5))
    _, k_init = jax.random.split(key)
    n_alpha = params.get("n_alpha", 2)
    return JPD.build_model(params).init(
        k_init, jnp.zeros((1, H, W, 3)), jnp.zeros((1, n_alpha, H, W, 3)),
        jnp.eye(3)[None], jnp.zeros((1, 3)),
        gt_pose=jnp.zeros((1, n_alpha, 6)))


def record_jax(monkeypatch, log):
    """Record the JAX step's losses and the frames of its batches."""
    make_fn, load = JPD.make_apply_depth_fn, JPD.load_frame_batch

    def make(*a, **kw):
        fn = make_fn(*a, **kw)

        def run(*args):
            out = fn(*args)
            jax.debug.callback(lambda x: log["loss"].append(float(x)), out[0])
            return out
        return run

    def loading(items, n_alpha):
        log["frames"].append([it["frame"] for it in items])
        return load(items, n_alpha)

    monkeypatch.setattr(JPD, "make_apply_depth_fn", make)
    monkeypatch.setattr(JPD, "load_frame_batch", loading)


def record_port(monkeypatch, log, variables):
    """Start the port from ``variables``; record its losses and batches."""
    loss_fn, load = PD.depth_loss, PD.load_frame_batch

    def init(params, device, gen):
        m = PD.build_model(params)
        m.load_state_dict(flax_to_torch(variables))
        return m.to(device)

    def losses(*a, **kw):
        out = loss_fn(*a, **kw)
        log["loss"].append(float(out[0].detach()))
        return out

    def loading(items, n_alpha, device=None):
        log["frames"].append([it["frame"] for it in items])
        return load(items, n_alpha, device)

    monkeypatch.setattr(PD, "init_model", init)
    monkeypatch.setattr(PD, "depth_loss", losses)
    monkeypatch.setattr(PD, "load_frame_batch", loading)


def run_both(monkeypatch, tmp, params, variables):
    """One run_training of each package on the same frames: (port log, JAX
    log), each with the returned per-epoch losses under "epochs"."""
    frames = [write_frames(tmp / "mem" / "0" / "frames", range(7), 4)]
    jlog, log = {"loss": [], "frames": []}, {"loss": [], "frames": []}
    with monkeypatch.context() as mp:
        record_jax(mp, jlog)
        jvars, jlog["epochs"] = JPD.run_training(
            JParams(dict(params)), frames, str(tmp / "jax"), verbose=False)
    with monkeypatch.context() as mp:
        record_port(mp, log, variables)
        model, log["epochs"] = PD.run_training(
            Params(dict(params)), frames, str(tmp / "port"), device="cpu",
            verbose=False)
    return log, jlog, model, jvars


def assert_same_run(log, jlog, first_rel):
    assert log["frames"] == jlog["frames"]
    np.testing.assert_allclose(log["loss"][0], jlog["loss"][0],
                               rtol=first_rel)
    np.testing.assert_allclose(log["loss"], jlog["loss"], rtol=1e-3)
    np.testing.assert_allclose(log["epochs"], jlog["epochs"], rtol=1e-3)


@pytest.fixture(scope="module")
def variables():
    """The JAX pretrainer's initial variables (an eager Flax init: ~25 s
    on an 8-core CPU the first time, its ops cached for the JAX runs
    below)."""
    return jax_init(JParams(PRETRAIN))


def test_init_model(variables):
    """The port's pretrainer model has the JAX one's parameters and
    statistics, by name and shape, and Flax's default init."""
    m = PD.init_model(Params(PRETRAIN), "cpu",
                      torch.Generator().manual_seed(0))
    ref = flax_to_torch(variables)
    state = m.state_dict()
    assert {k: tuple(v.shape) for k, v in state.items()} == \
        {k: tuple(v.shape) for k, v in ref.items()}
    for k, v in state.items():
        if k.endswith(("running_var", "bn1.weight")):
            assert torch.equal(v, torch.ones_like(v)), k
        elif k.endswith(("running_mean", ".bias")):
            assert torch.equal(v, torch.zeros_like(v)), k
    assert not m.learn_pose


@pytest.fixture(scope="module")
def pretrained(tmp_path_factory, variables):
    """Two epochs of each package from the JAX init (5 items, 2 steps of 2
    per epoch)."""
    mp = pytest.MonkeyPatch()
    tmp = tmp_path_factory.mktemp("pretrain")
    try:
        out = run_both(mp, tmp, PRETRAIN, variables)
    finally:
        mp.undo()
    return tmp, variables, out


def test_run_training(pretrained):
    tmp, variables, (log, jlog, model, jvars) = pretrained
    assert len(log["frames"]) == 4 and len(log["epochs"]) == 2
    assert_same_run(log, jlog, 1e-5)
    # Epoch e's order is the generator's permutation e.
    rs = np.random.default_rng(PRETRAIN["random_seed"])
    ds = RGBDataset([str(tmp / "mem" / "0" / "frames")])
    for e in range(2):
        order = rs.permutation(len(ds))
        assert log["frames"][2 * e] == [ds[int(i)]["frame"]
                                        for i in order[:2]]
    for name in ("unvalidated_test_depth", "best_unval_test_depth"):
        for ext in (".pt", ".json"):
            assert os.path.exists(tmp / "port" / (name + ext)), name + ext
        meta = json.loads((tmp / "port" / f"{name}.json").read_text())
        jmeta = json.loads((tmp / "jax" / f"{name}.json").read_text())
        assert set(meta) == set(jmeta) and meta["epoch"] == jmeta["epoch"]
        np.testing.assert_allclose(meta["losses"], jmeta["losses"], rtol=1e-3)
    # The JAX run's weights load into the port from its msgpack.
    m = PD.build_model(Params(PRETRAIN))
    load_checkpoint(str(tmp / "jax" / "unvalidated_test_depth"), m)
    torch.testing.assert_close(m.state_dict(), flax_to_torch(jvars),
                               rtol=0, atol=0)
    # The trained weights moved away from the init.
    key = "depth_decoder.resnet_layer_4.block1.conv2.weight"
    assert not torch.equal(model.state_dict()[key],
                           flax_to_torch(variables)[key])


def test_resume(pretrained, monkeypatch):
    """A third epoch resumed from each package's own checkpoint: the same
    batches as the first epoch (the generators start afresh), the loss
    history carried on."""
    tmp, variables, (first, *_) = pretrained
    params = dict(PRETRAIN, start_from_scratch=False, epochs=3)
    log, jlog, model, _ = run_both(monkeypatch, tmp, params, variables)
    assert len(log["epochs"]) == len(jlog["epochs"]) == 3
    np.testing.assert_allclose(log["epochs"][:2], first["epochs"], rtol=0)
    assert log["frames"] == first["frames"][:2]
    assert_same_run(log, jlog, 1e-3)
    meta = json.loads((tmp / "port" / "unvalidated_test_depth.json")
                      .read_text())
    assert meta["epoch"] == 3 and len(meta["losses"]) == 3
    m = PD.build_model(Params(PRETRAIN))
    assert load_checkpoint(str(tmp / "port" / "unvalidated_test_depth"), m,
                           torch.optim.AdamW(m.parameters()))["step"] == 6


GRAFTED = ("depth_decoder.feature_extractor.", "depth_decoder.resnet_layer_")


def test_generate_depth_model(tmp_path):
    """Both CLIs on one synthetic state dict: the grafted layers (stem,
    layer 1, contraction layers 2-4: every shape agrees) identical, the
    metadata the same; the port's file grafts into a MACARONS checkpoint."""
    pth = str(tmp_path / "resnet18.pth")
    torch.save(resnet18_state_dict(14), pth)
    out, jout = str(tmp_path / "port_depth"), str(tmp_path / "jax_depth")
    GDM.main(["-r", pth, "-o", out, "--height", str(H), "--width", str(W),
              "--device", "cpu"])
    env = dict(os.environ, MACARONS_PLATFORM="cpu",
               MACARONS_CACHE_DIR=str(tmp_path / "cache"),
               JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, os.path.join(
        REPO, "weights_tools", "generate_depth_model.py"), "-r", pth,
        "-o", jout, "--height", str(H), "--width", str(W)], check=True,
        env=env, capture_output=True)
    ours = torch.load(out + ".pt")["model"]
    ref = flax_to_torch(read_msgpack(jout))
    assert set(ours) == set(ref)
    grafted = [k for k in ref if k.startswith(GRAFTED)]
    assert len(grafted) == 120  # stem, layer 1 and layers 2-4, all of them
    for k in grafted:
        if "num_batches" not in k:
            torch.testing.assert_close(ours[k], ref[k], rtol=0, atol=0,
                                       msg=k)
    assert not torch.equal(ours["depth_decoder.disp1.conv.weight"],
                           ref["depth_decoder.disp1.conv.weight"])
    with open(out + ".json") as f, open(jout + ".json") as g:
        assert json.load(f) == json.load(g) == {"source": pth}

    # Both CLIs build ManyDepth at its default 96 planes.
    params = Params(dict(PRETRAIN, use_perfect_depth=False, seq_len=256,
                         k_for_knn=8, n_depth=96))
    for path in (out, jout):
        model = assemble(params, depth_ckpt=path, device="cpu")
        torch.testing.assert_close(
            model.depth.state_dict(),
            ours if path == out else ref, rtol=0, atol=0)
    depth = create_macarons_model(params, "cpu").depth
    load_checkpoint(out, depth)
    torch.testing.assert_close(depth.state_dict(), ours, rtol=0, atol=0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            GDM.main(["-o", out])


def test_pretrain_checkpoint_grafts(pretrained):
    """A pretrainer checkpoint (``.pt``, the port's) through
    ``generate_macarons_model -d``: the trained depth network."""
    tmp = pretrained[0]
    path = str(tmp / "port" / "best_unval_test_depth")
    params = Params(dict(PRETRAIN, use_perfect_depth=False, seq_len=256,
                         k_for_knn=8))
    model = assemble(params, depth_ckpt=path, device="cpu")
    torch.testing.assert_close(model.depth.state_dict(),
                               torch.load(path + ".pt")["model"], rtol=0,
                               atol=0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            PD.run_training(Params(PRETRAIN), [str(tmp)], str(tmp / "x"))
