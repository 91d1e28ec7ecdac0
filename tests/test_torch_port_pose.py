"""ManyDepth's pose network and compute options: the port against the JAX
package on the CPU.

PoseDecoder and ManyDepth(learn_pose=True) in eval and train mode (the
BatchNorm running statistics too), at Flax weights converted by
utils.convert.flax_to_torch; the batched feature-extractor call
(``batched_stem``); bfloat16 convolutions (``dtype``); the depth step's
loss with the predicted pose and its gradient reaching the PoseDecoder;
the torchvision resnet18 converter; and a JAX depth checkpoint with a
pose decoder loading into the port's bundle.

bfloat16 is held by its gap from float32, not bit for bit: cuDNN, the CPU
and XLA sum a bfloat16 convolution in different orders. At 32 x 48 with 4
planes the gap of either package's bfloat16 disparities and poses from its
own float32 ones measured 4.0e-04 to 1.95e-03 over four seeds (either
side), and the port's bfloat16 from the JAX package's bfloat16 up to
2.08e-03; BF16_GAP is twice the largest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from macarons_tpu.config import Params as JParams
from macarons_tpu.models import many_depth as jmd
from macarons_tpu.models import resnet as jresnet
from macarons_tpu.models.macarons import create_macarons_model as jcreate
from macarons_tpu.models.scone import SconeOcc as JSconeOcc
from macarons_tpu.models.scone import SconeVis as JSconeVis
from macarons_tpu.scene import depth_runtime as jdr
from macarons_tpu.trainers import train_macarons as JTM
from macarons_tpu.utils.checkpoint import save_checkpoint
from macarons_tpu_torch.config import Params
from macarons_tpu_torch.models import many_depth as md
from macarons_tpu_torch.models import resnet
from macarons_tpu_torch.models.macarons import MacaronsModel, \
    create_macarons_model, init_macarons_weights, load_macarons
from macarons_tpu_torch.models.scone import SconeOcc, SconeVis
from macarons_tpu_torch.scene import depth_runtime as dr
from macarons_tpu_torch.trainers import train_macarons as TM
from macarons_tpu_torch.utils.convert import flax_to_torch
from test_torch_port_train_steps import assert_grads, f64, frames_for
from torch_port_helpers import OCC_KW, TINY, VIS_KW, random_flax_variables, \
    resnet18_state_dict, torch_one_thread  # noqa: F401

H, W = TINY["image_height"], TINY["image_width"]
N_DEPTH = 4
B, A = 2, 2
BF16_GAP = 4e-3
DEPTH = dict(use_perfect_depth=False, n_depth=N_DEPTH, alphas=[-2, -1],
             n_alpha=2, n_alpha_for_supervision=2, learn_pose=True,
             data_augmentation=False)


def inputs(seed):
    """Frames, the target pose R = I, T = 0 and a small given pose."""
    rs = np.random.default_rng(seed)
    x = rs.uniform(size=(B, H, W, 3)).astype(np.float32)
    xa = rs.uniform(size=(B, A, H, W, 3)).astype(np.float32)
    R = np.broadcast_to(np.eye(3, dtype=np.float32), (B, 3, 3)).copy()
    T = np.zeros((B, 3), np.float32)
    pose = (rs.normal(size=(B, A, 6)) * 0.003).astype(np.float32)
    return x, xa, R, T, pose


def pair(seed, jdtype=None, **kw):
    """A JAX ManyDepth with random weights and the port's at them."""
    jm = jmd.ManyDepth(H, W, 0.5, TINY["zfar"], N_DEPTH, dtype=jdtype, **kw)
    v = random_flax_variables(jm, seed, *inputs(0))
    m = md.ManyDepth(H, W, 0.5, TINY["zfar"], N_DEPTH, dtype=(
        None if jdtype is None else torch.bfloat16), **kw)
    m.load_state_dict(flax_to_torch(v))
    return jm, v, m.eval()


def running_stats(m, v, upd):
    """(port, JAX) running statistics after a train-mode forward."""
    ref = flax_to_torch({"params": v["params"],
                         "batch_stats": upd["batch_stats"]})
    state = m.state_dict()
    return [(k, state[k], a) for k, a in ref.items() if "running" in k]


def assert_close_stats(stats):
    for k, ours, ref in stats:
        np.testing.assert_allclose(ours.numpy(), ref.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("train", [False, True])
def test_pose_decoder(train):
    x, xa = inputs(1)[:2]
    jpd = jmd.PoseDecoder(H, W)
    v = random_flax_variables(jpd, 2, x, xa)
    pd = md.PoseDecoder(H, W)
    pd.load_state_dict(flax_to_torch(v))
    assert pd.fc.in_features == 6 * 1 * 2  # 32 x 48 halved five times
    if train:
        ref, upd = jax.jit(lambda v, x, xa: jpd.apply(
            v, x, xa, train=True, mutable=["batch_stats"]))(v, x, xa)
    else:
        ref = jax.jit(jpd.apply)(v, x, xa)
    pd.train(train)
    with torch.no_grad():
        ours = pd(torch.as_tensor(x), torch.as_tensor(xa))
    assert ours.shape == (B, A, 6) and float(np.abs(ref).max()) > 0.1
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)
    if train:
        stats = running_stats(pd, v, upd)
        assert len(stats) == 2 * 20  # bn1 and the four layers' BatchNorms
        assert_close_stats(stats)


@pytest.mark.parametrize("train", [False, True])
def test_many_depth_learn_pose(train):
    jm, v, m = pair(3, learn_pose=True)
    args = inputs(4)[:4]
    if train:
        ref, upd = jax.jit(lambda v, *a: jm.apply(
            v, *a, train=True, mutable=["batch_stats"]))(v, *args)
    else:
        ref = jax.jit(jm.apply)(v, *args)
    m.train(train)
    with torch.no_grad():
        ours = m(*(torch.as_tensor(a) for a in args))
    names = ("pose", "disp1", "disp2", "disp3", "disp4")
    for name, a, b in zip(names, ref, ours):
        assert b.shape == a.shape, name
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    if train:
        stats = running_stats(m, v, upd)
        assert len(stats) == 2 * (20 + 20)
        assert_close_stats(stats)
    # Without the pose network the given pose is required, as in JAX.
    with pytest.raises(ValueError, match="requires gt_pose"):
        md.ManyDepth(H, W, 0.5, TINY["zfar"], N_DEPTH)(
            *(torch.as_tensor(a) for a in args))


def test_batched_stem():
    """One feature-extractor call over the 1 + A frames in eval mode: the
    split calls' function, within 1e-6, and the JAX package's batched
    call's; in train mode the calls stay apart."""
    jm, v, split = pair(5, batched_stem=True)
    batched = md.ManyDepth(H, W, 0.5, TINY["zfar"], N_DEPTH,
                           batched_stem=True)
    batched.load_state_dict(split.state_dict())
    batched.eval()
    args = inputs(6)
    calls = []
    batched.depth_decoder.feature_extractor.register_forward_hook(
        lambda mod, a, out: calls.append(a[0].shape[0]))
    with torch.no_grad():
        ours = batched(*(torch.as_tensor(a) for a in args))
        alone = split(*(torch.as_tensor(a) for a in args))
    ref = jax.jit(jm.apply)(v, *args)
    assert calls == [B * (1 + A)]
    for a, b, r in zip(alone[1:], ours[1:], ref[1:]):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(b.numpy(), np.asarray(r), atol=2e-5)
    calls.clear()
    batched.train()
    with torch.no_grad():
        batched(*(torch.as_tensor(a) for a in args))
    assert calls == [B, B * A]


@pytest.mark.parametrize("learn_pose", [False, True])
def test_bfloat16_gap(learn_pose):
    """bfloat16 convolutions: every output float32, within BF16_GAP of the
    package's own float32 on both sides and of the JAX package's
    bfloat16, and not equal to float32 (the convs did run in bfloat16)."""
    args = inputs(7)
    outs = {}
    for jdtype in (None, jnp.bfloat16):
        jm, v, m = pair(8, jdtype, learn_pose=learn_pose)
        with torch.no_grad():
            ours = m(*(torch.as_tensor(a) for a in args))
        outs[jdtype is None] = ([np.asarray(a) for a in
                                 jax.jit(jm.apply)(v, *args)],
                                [b.numpy() for b in ours])
        assert all(b.dtype == torch.float32 for b in ours)
    for side in (0, 1):
        for a, b in zip(outs[True][side], outs[False][side]):
            assert np.abs(a - b).max() < BF16_GAP
    for j, t in zip(*outs[False]):
        assert np.abs(j - t).max() < BF16_GAP
    gaps = [np.abs(a - b).max() for a, b in zip(outs[True][1][1:],
                                                outs[False][1][1:])]
    assert min(gaps) > 1e-4
    m = pair(8, jnp.bfloat16, learn_pose=learn_pose)[2]
    assert all(p.dtype == torch.float32 for p in m.parameters())
    convs = [mod for mod in m.modules() if isinstance(mod, resnet.Conv2d)]
    f32 = {mod for mod in convs if mod.compute_dtype is None}
    heads = [m.depth_decoder.__getattr__(f"disp{i}").conv for i in range(1, 5)]
    assert f32 == set(heads + ([m.pose_decoder.pconv3] if learn_pose else []))


def test_model_bundle_options(tmp_path):
    """create_macarons_model builds the pose network and bfloat16 convs from
    the config, and a JAX depth checkpoint with a pose decoder loads."""
    params = Params(dict(TINY, **DEPTH, depth_compute_dtype="bfloat16"))
    model = create_macarons_model(params, "cpu")
    init_macarons_weights(model, torch.Generator().manual_seed(0))
    assert model.depth.learn_pose
    assert model.depth.pose_decoder.biconv1.compute_dtype == torch.bfloat16
    assert float(model.depth.pose_decoder.fc.bias.detach().abs().max()) == 0
    for name in ("none", "float32", None):
        m = create_macarons_model(Params(dict(TINY, **DEPTH,
                                              depth_compute_dtype=name)))
        assert m.depth.depth_decoder.resnet_layer_2.block0.conv1 \
            .compute_dtype is None
    jmodel = jcreate(JParams(dict(TINY, **DEPTH)))
    v = random_flax_variables(jmodel.depth, 9, *inputs(0))
    assert "pose_decoder" in v["params"]
    occ_vars = random_flax_variables(JSconeOcc(**OCC_KW), 0,
                                     jnp.zeros((1, 300, 3)),
                                     jnp.zeros((1, 8, 3)),
                                     jnp.zeros((1, 8, 64)))
    vis_vars = random_flax_variables(JSconeVis(**VIS_KW), 1,
                                     jnp.zeros((1, 64, 4)),
                                     jnp.zeros((1, 64, 64)))
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, {"depth": v, "occ": occ_vars, "vis": vis_vars})
    bundle = MacaronsModel(SconeOcc(**OCC_KW), SconeVis(**VIS_KW),
                           model.depth)
    load_macarons(path, bundle)
    torch.testing.assert_close(model.depth.state_dict(), flax_to_torch(v),
                               rtol=0, atol=0)


def test_depth_loss_learn_pose():
    """The depth step's loss with the predicted pose, against the JAX
    package's make_apply_depth_fn in train mode (the JAX side in float64,
    as in test_torch_port_train_steps.py): the loss, the pose, and the
    gradient, which reaches every PoseDecoder parameter."""
    jparams = JParams(dict(TINY, **DEPTH))
    jcfg = JTM.depth_cfg_from_params(jparams)
    jm = jcreate(jparams).depth
    v = random_flax_variables(jm, 10, *inputs(0))
    japply = jdr.make_apply_depth_fn(jm, jcfg, compute_loss=True, train=True)
    frames = frames_for(np.random.default_rng(11), 4)
    with jax.enable_x64(True):
        jbatch, jalpha = f64(jdr.create_batch_for_depth_model(
            jcfg, frames, "supervision"))

        def loss_fn(p):
            out = japply({"params": p, "batch_stats": f64(v["batch_stats"])},
                         jbatch, jalpha, jax.random.PRNGKey(0))
            return out[0], out[4]

        (jloss, jpose), jgrads = jax.value_and_grad(
            loss_fn, has_aux=True)(f64(v["params"]))

    params = Params(dict(TINY, **DEPTH))
    m = create_macarons_model(params, "cpu").depth
    m.load_state_dict(flax_to_torch(v))
    cfg = TM.depth_cfg_from_params(params)
    batch, alpha = dr.create_batch_for_depth_model(cfg, frames, "supervision")
    m.train()
    loss, *_, pose, gt_pose = dr.depth_loss(m, cfg, batch, alpha)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    np.testing.assert_allclose(pose.detach().numpy(), np.asarray(jpose),
                               rtol=1e-4, atol=1e-6)
    assert not torch.allclose(pose, gt_pose)
    named = list(m.named_parameters())
    assert_grads(named, jgrads)
    for name, p in m.pose_decoder.named_parameters():
        assert float(p.grad.abs().max()) > 0, name


def test_convert_torch_resnet18():
    """A torchvision-keyed resnet18 state dict (random, seeded): the port's
    stem and layers 1-4 at the converted weights compute what the JAX
    package's do at its converted trees."""
    sd = resnet18_state_dict(12)
    chans = [64, 64, 128, 256, 512]
    ours = resnet.convert_torch_resnet18(sd)
    ref = jresnet.convert_torch_resnet18(sd)
    x = np.random.default_rng(13).uniform(size=(2, H, W, 3)).astype(
        np.float32)

    stem = resnet.ResNet18Stem()
    stem.load_state_dict(ours["stem"])
    jstem = jresnet.ResNet18Stem()
    y_ref = jstem.apply({"params": ref["stem"][0],
                         "batch_stats": ref["stem"][1]}, x)
    with torch.no_grad():
        y = stem.eval()(torch.as_tensor(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(y.permute(0, 2, 3, 1).numpy(),
                               np.asarray(y_ref), rtol=1e-4, atol=1e-5)
    y, y_ref = resnet.maxpool_3x3_s2(y), jresnet.maxpool_3x3_s2(y_ref)
    for li in range(1, 5):
        layer = resnet.ResNetLayer(chans[li - 1], chans[li], 1 + (li > 1))
        layer.load_state_dict(ours[f"layer{li}"])
        jlayer = jresnet.ResNetLayer(chans[li], strides=1 + (li > 1))
        y_ref = jlayer.apply({"params": ref[f"layer{li}"][0],
                              "batch_stats": ref[f"layer{li}"][1]}, y_ref)
        with torch.no_grad():
            y = layer.eval()(y)
        np.testing.assert_allclose(y.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(y_ref), rtol=1e-4, atol=1e-4,
                                   err_msg=f"layer{li}")
