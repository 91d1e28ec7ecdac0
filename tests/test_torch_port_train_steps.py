"""The trainer's depth side: the port against the JAX package on the CPU.

ManyDepth in train mode (batch statistics, and the running statistics it
leaves, against Flax's ``mutable=["batch_stats"]``), one depth optimizer
step against the JAX trainer's ``depth_train_step`` with augmentation off
(the loss, every gradient, and the parameters after AdamW), and the depth
loss with augmentation on, the JAX package's draws injected.

The networks run at converted random Flax weights with random BatchNorm
statistics (tests/torch_port_helpers.py); depth batches come from a short
camera arc made from a seed.

The JAX side of the gradient tests runs in float64 (``jax.enable_x64``):
the depth step's float32 gradients are ill-conditioned (BatchNorm in train
mode over a small batch), so two float32 computations that agree on the
loss differ in their gradients far more than either differs from float64.
The port's float32 step is held to the float64 one within 1e-3 x max|g|,
and its float64 step, the same function, within 3e-5 (the JAX disparity
heads stay float32).
"""

import jax
import numpy as np
import optax
import pytest
import torch

from macarons_tpu.config import Params as JParams
from macarons_tpu.models import many_depth as jmd
from macarons_tpu.models.macarons import create_macarons_model as jcreate
from macarons_tpu.scene import depth_runtime as jdr
from macarons_tpu.trainers import train_macarons as JTM
from macarons_tpu_torch.config import Params
from macarons_tpu_torch.models import many_depth as md
from macarons_tpu_torch.models.macarons import MacaronsModel, \
    create_optimizers
from macarons_tpu_torch.models.scone import SconeOcc, SconeVis
from macarons_tpu_torch.ops import geometry as geo
from macarons_tpu_torch.scene import depth_runtime as dr
from macarons_tpu_torch.trainers import train_macarons as TM
from macarons_tpu_torch.utils.convert import flax_to_torch
from torch_port_helpers import OCC_KW, TINY, VIS_KW, random_flax_variables, \
    torch_one_thread  # noqa: F401

H, W = TINY["image_height"], TINY["image_width"]
N_DEPTH = 12
# The default training config's depth knobs at a tiny size.
DEPTH = dict(use_perfect_depth=False, n_depth=N_DEPTH, alphas=[-1, -2, 1],
             n_alpha=2, n_alpha_for_supervision=3,
             use_future_frame_for_supervision=True, regularity_factor=0.001,
             learning_rate=1e-4)
GRAD_REL = 1e-3


def frames_for(rs, n):
    """A frame sequence as Memory.load_frame_sequence returns it: cameras on
    a short arc around a look-at target, random images and depth."""
    t = np.linspace(0.0, 0.4, n)
    eye = np.stack((3 * np.sin(t), 0.2 + 0.1 * t, 3 * np.cos(t)), -1)
    R, T = geo.look_at_view_transform(
        torch.as_tensor(eye, dtype=torch.float32), torch.zeros(n, 3))
    return {"images": rs.uniform(size=(n, H, W, 3)).astype(np.float32),
            "zbuf": rs.uniform(1.0, 5.0, size=(n, H, W, 1)).astype(np.float32),
            "mask": rs.uniform(size=(n, H, W, 1)) > 0.1,
            "R": R.numpy(), "T": T.numpy(),
            "zfar": np.full((n,), TINY["zfar"], np.float32)}


def many_depth_pair(seed, B, A):
    jm = jmd.ManyDepth(H, W, 0.5, TINY["zfar"], N_DEPTH)
    v = random_flax_variables(
        jm, seed, np.zeros((B, H, W, 3), np.float32),
        np.zeros((B, A, H, W, 3), np.float32), np.eye(3)[None],
        np.zeros((1, 3), np.float32), np.zeros((B, A, 6), np.float32))
    m = md.ManyDepth(H, W, 0.5, TINY["zfar"], N_DEPTH)
    m.load_state_dict(flax_to_torch(v))
    return jm, v, m.eval()


def f64(tree):
    """The tree's float32 leaves as float64."""
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a, np.float64)
                   if np.asarray(a).dtype == np.float32 else a), tree)


def grad_scale(ref):
    """max|g| over the whole network's gradient. A small tensor's own
    largest gradient is no scale: a bias's gradient sums hundreds of pixels'
    terms that cancel to a hundredth of each."""
    return max(float(np.abs(g.numpy()).max()) for g in ref.values())


def assert_grads(named_params, jgrads, rel=GRAD_REL):
    """Every parameter's gradient within rel x max|g| of the JAX package's
    (a Flax gradient tree, converted by name)."""
    ref = flax_to_torch({"params": jgrads})
    names = [n for n, _ in named_params]
    assert set(names) == {k for k in ref if "running" not in k
                          and "num_batches" not in k}
    atol = rel * grad_scale(ref)
    for name, p in named_params:
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(), rtol=0,
                                   atol=atol, err_msg=name)


def assert_adam_step(named_params, jnew, jgrads, rel=GRAD_REL):
    """Parameters after the step match where |g| > rel max|g|: Adam's first
    step moves each by about lr sign(g)."""
    ref_p = flax_to_torch({"params": jnew})
    ref_g = flax_to_torch({"params": jgrads})
    floor = rel * grad_scale(ref_g)
    n_checked = 0
    for name, p in named_params:
        g = ref_g[name].numpy()
        sel = np.abs(g) > floor
        np.testing.assert_allclose(p.detach().numpy()[sel],
                                   ref_p[name].numpy()[sel], rtol=0,
                                   atol=1e-6, err_msg=name)
        n_checked += int(sel.sum())
    assert n_checked > 1000


def assert_stats(ours, ref, name):
    """Running statistics within 1e-5 of the tensor's largest magnitude."""
    ref = ref.numpy()
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max(), err_msg=name)


def test_many_depth_train_mode():
    """Batch statistics in the forward, Flax's running-statistic update."""
    rs = np.random.default_rng(1)
    B, A = 2, 2
    jm, v, m = many_depth_pair(2, B, A)
    x = rs.uniform(size=(B, H, W, 3)).astype(np.float32)
    xa = rs.uniform(size=(B, A, H, W, 3)).astype(np.float32)
    R = np.broadcast_to(np.eye(3, dtype=np.float32), (B, 3, 3)).copy()
    T = np.zeros((B, 3), np.float32)
    pose = (rs.normal(size=(B, A, 6)) * 0.003).astype(np.float32)
    args = (x, xa, R, T, pose)
    ref, upd = jax.jit(lambda v, *a: jm.apply(
        v, *a, train=True, mutable=["batch_stats"]))(v, *args)
    m.train()
    with torch.no_grad():
        ours = m(*(torch.as_tensor(a) for a in args))
    m.eval()
    for i, (a, b) in enumerate(zip(ref[1:], ours[1:])):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=2e-5,
                                   err_msg=f"disp{i + 1}")
    stats = flax_to_torch({"params": v["params"],
                           "batch_stats": upd["batch_stats"]})
    state = m.state_dict()
    n = 0
    for k, a in stats.items():
        if "running" in k:
            assert_stats(state[k], a, k)
            n += 1
    assert n == 40  # ResNet-18's 20 BatchNorms, mean and variance each
    # The update moved the statistics (Flax's momentum 0.9, biased variance).
    before = flax_to_torch(v)
    assert not torch.allclose(before["depth_decoder.feature_extractor.stem."
                                     "bn1.running_var"],
                              state["depth_decoder.feature_extractor.stem."
                                    "bn1.running_var"])


@pytest.fixture(scope="module")
def depth_runtime():
    """The JAX trainer's runtime with ManyDepth (augmentation off), the port's
    runtime, and one set of depth weights for both."""
    jparams = JParams(dict(TINY, **DEPTH, data_augmentation=False))
    jrt = JTM.MacaronsRuntime(jparams, jcreate(jparams))
    _, v, _ = many_depth_pair(3, 1, 2)
    params = Params(dict(TINY, **DEPTH, data_augmentation=False))
    return jparams, jrt, v, params


def port_runtime(params, v):
    m = md.ManyDepth(H, W, 0.5, TINY["zfar"], N_DEPTH)
    m.load_state_dict(flax_to_torch(v))
    model = MacaronsModel(SconeOcc(**OCC_KW), SconeVis(**VIS_KW), m.eval())
    return (TM.MacaronsRuntime(params, model, device="cpu"),
            create_optimizers(params, model))


def test_depth_train_step(depth_runtime):
    """One depth step on a supervision batch of 2 against the JAX trainer's
    depth_train_step: loss, gradients, parameters after AdamW, and the
    running statistics."""
    jparams, jrt, v, params = depth_runtime
    rs = np.random.default_rng(4)
    frames = frames_for(rs, TINY["n_interpolation_steps"] + 3)
    key = jax.random.PRNGKey(0)
    # The JAX step's AdamW, passing its gradient out through the state.
    adamw = jrt.depth_tx
    jrt.depth_tx = optax.GradientTransformation(
        lambda p: (adamw.init(p), p),
        lambda g, s, p: (adamw.update(g, s[0], p)[0], (s[0], g)))
    with jax.enable_x64(True):
        jbatch, jalpha = f64(jdr.create_batch_for_depth_model(
            jrt.dcfg, frames, "supervision"))
        v64 = f64(v)
        new_vars, (_, jgrads), jloss, jdepth, jmask, jerr = \
            jrt.depth_train_step(v64, jrt.depth_tx.init(v64["params"]),
                                 jbatch, jalpha, key)

    rt, opts = port_runtime(params, v)
    batch, alpha = dr.create_batch_for_depth_model(rt.dcfg, frames,
                                                   "supervision")
    assert batch["images"].shape[0] == 2
    loss, depth, mask, err = rt.depth_train_step(opts["depth"], batch, alpha)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    np.testing.assert_allclose(depth.numpy(), np.asarray(jdepth), rtol=1e-4)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    named = list(rt.model.depth.named_parameters())
    assert_grads(named, jgrads)
    assert_adam_step(named, new_vars["params"], jgrads)
    stats = flax_to_torch({"params": new_vars["params"],
                           "batch_stats": new_vars["batch_stats"]})
    state = rt.model.depth.state_dict()
    for k, a in stats.items():
        if "running" in k:
            assert_stats(state[k], a, k)
    assert not rt.model.depth.training

    # The same step in float64 is the same function. The JAX disparity
    # heads stay float32 under x64, which bounds the agreement.
    torch.set_default_dtype(torch.float64)
    try:
        rt64, opts64 = port_runtime(params, v)
        rt64.model.depth.double()
        to64 = [{k: t.double() if t.is_floating_point() else t
                 for k, t in d.items()} for d in (batch, alpha)]
        loss64 = rt64.depth_train_step(opts64["depth"], *to64)[0]
    finally:
        torch.set_default_dtype(torch.float32)
    np.testing.assert_allclose(float(loss64), float(jloss), rtol=1e-7)
    assert_grads(list(rt64.model.depth.named_parameters()), jgrads, rel=3e-5)


def test_depth_loss_with_augmentation(depth_runtime):
    """Jitter and flip on (probability 1), the JAX package's factors
    injected: the loss, its gradient, and the depth and masks returned in
    the frame's own orientation."""
    jparams, _, v, params = depth_runtime
    jparams = JParams(dict(jparams.to_dict(), data_augmentation=True,
                           jitter_probability=1.0, symmetry_probability=1.0))
    jcfg = JTM.depth_cfg_from_params(jparams)
    japply = jdr.make_apply_depth_fn(jcreate(jparams).depth, jcfg,
                                     compute_loss=True, train=False)
    rs = np.random.default_rng(5)
    frames = frames_for(rs, TINY["n_interpolation_steps"] + 3)
    key = jax.random.PRNGKey(7)
    with jax.enable_x64(True):
        jbatch, jalpha = f64(jdr.create_batch_for_depth_model(
            jcfg, frames, "supervision"))
        v64 = f64(v)
        _, _, k_j, _ = jax.random.split(key, 4)
        draws = {"jitter": True, "symmetry": True,
                 "factors": tuple(float(f) for f in
                                  jdr.sample_jitter_factors(k_j, jcfg))}

        def loss_fn(p):
            return japply({"params": p, "batch_stats": v64["batch_stats"]},
                          jbatch, jalpha, key)

        (_, ref), jgrads = jax.jit(jax.value_and_grad(
            lambda p: (loss_fn(p)[0], loss_fn(p)), has_aux=True))(
                v64["params"])

    cfg = TM.depth_cfg_from_params(Params(dict(
        params.to_dict(), data_augmentation=True, jitter_probability=1.0,
        symmetry_probability=1.0)))
    _, _, m = many_depth_pair(3, 1, 2)
    m.load_state_dict(flax_to_torch(v))
    batch, alpha = dr.create_batch_for_depth_model(cfg, frames, "supervision")
    loss, depth, mask, err, pose, gt_pose = dr.depth_loss(m, cfg, batch,
                                                          alpha, draws=draws)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref[0]), rtol=1e-4)
    np.testing.assert_allclose(depth.numpy(), np.asarray(ref[1]), rtol=1e-4)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref[2]))
    np.testing.assert_allclose(gt_pose.numpy(), np.asarray(ref[5]),
                               atol=1e-6)
    # The flip is visible: the depth comes back in the frame's orientation.
    assert not torch.equal(mask, torch.flip(mask, dims=(-2,)))
    assert_grads(list(m.named_parameters()), jgrads)
