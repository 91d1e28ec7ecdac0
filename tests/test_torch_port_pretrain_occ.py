"""PyTorch port vs JAX package: SconeOcc pretraining (CPU, tiny widths).

One occupancy step of the port (``trainers.pretrain_occ.occ_loss``, then
AdamW at the warm-up schedule's first rate) against the JAX step rebuilt
from the JAX package's public functions (its ``make_train_step`` body,
compiled here at tiny widths), at converted weights, on a batch assembled
from one numpy seed, with SconeOcc's down-samples deterministic in both (no key, no
generator). Held: the loss (rtol 1e-4), every gradient (within 1e-3 of max
|g|), the parameters after AdamW where |g| > 1e-3 max |g|. Also chunked
``compute_occupancy_probability`` against the JAX package's (1e-5), a JAX
SconeOcc ``TrainState`` checkpoint loaded into the port (same outputs),
``run_training`` with its checkpoints and resume, and the CLI on the CPU.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from macarons_tpu.config import Params as JParams
from macarons_tpu.models.scone import SconeOcc as JSconeOcc
from macarons_tpu.models.scone import \
    compute_occupancy_probability as jcompute_occ
from macarons_tpu.ops import view_state as jvs
from macarons_tpu.trainers import pretrain_occ as jpo
from macarons_tpu.utils.checkpoint import save_checkpoint as jsave
from macarons_tpu.utils.schedule import warmup_constant_schedule as jsched
from macarons_tpu_torch import initialize_occ
from macarons_tpu_torch.config import Params
from macarons_tpu_torch.data import datasets as D
from macarons_tpu_torch.models.scone import SconeOcc, \
    compute_occupancy_probability
from macarons_tpu_torch.trainers import pretrain_occ as po
from macarons_tpu_torch.utils.checkpoint import load_checkpoint
from macarons_tpu_torch.utils.convert import flax_to_torch
from macarons_tpu_torch.utils.schedule import warmup_constant_schedule
from torch_port_helpers import OCC_KW, make_shapenet_root, \
    random_flax_variables, torch_one_thread  # noqa: F401

SMALL = dict(
    seq_len=128, n_sample=24, n_view_min=1, n_view_max=2,
    view_state_n_elev=7, view_state_n_azim=14, harmonic_degree=8,
    camera_dist=1.5, pole_cameras=True, n_camera_elev=5, n_camera_azim=10,
    n_camera=52, gt_max_diagonal=1.0, prediction_in_random_camera_space=False,
    batch_size=2, epochs=2, learning_rate=1e-3, warmup=5,
    schedule_learning_rate=True, lr_epochs=[1], lr_factor=0.1,
    start_from_scratch=True, random_seed=42, torch_seed=5,
    scone_occ_model_name="test_occ", no_view_harmonics=False,
    no_local_features=False)
GRAD_REL = 1e-3


@pytest.fixture(scope="module")
def shapenet_root(tmp_path_factory):
    return make_shapenet_root(tmp_path_factory)


@pytest.fixture(scope="module")
def occ_nets():
    jvars = random_flax_variables(JSconeOcc(**OCC_KW), 1,
                                  jnp.zeros((1, 300, 3)),
                                  jnp.zeros((1, 8, 3)),
                                  jnp.zeros((1, 8, 64)))
    net = SconeOcc(**OCC_KW)
    net.load_state_dict(flax_to_torch(jvars))
    return jvars, net


def jax_loss_fn(jparams, jmodel, batch):
    """The body of the JAX package's make_train_step (pretrain_occ.py:
    forward_loss) from its public functions, SconeOcc without a key."""
    X_cam, cand_R, cand_T = jpo.candidate_camera_poses(jparams)
    base, h_polar, _ = jvs.get_all_harmonics_under_degree(8, 7, 14)
    center = jnp.array([0.0, 0.0, jparams.camera_dist])

    def loss(params):
        R = cand_R[batch["pred_cam_idx"]]
        T = cand_T[batch["pred_cam_idx"]]

        def norm(p):
            return jvs.normalize_points_in_prediction_box(
                jnp.einsum("bnj,bji->bni", p, R) + T[:, None, :], center,
                jparams.gt_max_diagonal)

        B = batch["pc"].shape[0]
        pc, X = norm(batch["pc"]), norm(batch["X"])
        X_all = norm(jnp.broadcast_to(X_cam[None], (B, *X_cam.shape)))
        X_view = jnp.take_along_axis(X_all, batch["view_idx"][..., None],
                                     axis=1)
        vs = jvs.compute_view_state(X, X_view, 7, 14,
                                    view_mask=batch["view_mask"])
        vh = jvs.compute_view_harmonics(vs, base, h_polar, 7, 14)
        pred = jmodel.apply({"params": params}, pc, X, vh, key=None,
                            pc_mask=batch["pc_mask"])
        return jnp.mean((pred - batch["occs"]) ** 2)

    return loss


def test_occ_step_matches_jax(shapenet_root, occ_nets):
    jvars, net = occ_nets
    params = Params(dict(SMALL, data_path=shapenet_root))
    jparams = JParams(dict(SMALL, data_path=shapenet_root))
    consts = po.step_constants(params, "cpu")
    train = D.get_shapenet_datasets(shapenet_root)[0]
    batch = D.assemble_occ_batch(np.random.default_rng(5), train.paths[:2],
                                 consts.X_cam.numpy(), 1, 2, params.seq_len,
                                 params.n_sample, n_views=[1, 2])
    assert not batch["view_mask"].all()  # a padded view in the batch

    jloss, jgrads = jax.jit(jax.value_and_grad(jax_loss_fn(
        jparams, JSconeOcc(**OCC_KW),
        {k: jnp.asarray(v) for k, v in batch.items()})))(jvars["params"])
    tx = optax.adamw(jsched(1e-3, 5))
    upd, _ = tx.update(jgrads, tx.init(jvars["params"]), jvars["params"])
    jnew = optax.apply_updates(jvars["params"], upd)

    net = SconeOcc(**OCC_KW)
    net.load_state_dict(flax_to_torch(jvars))
    opt, schedule = po.make_optimizer(params, net, steps_per_epoch=4)
    loss = po.occ_loss(params, net, consts, po.batch_to_device(batch, "cpu"))
    po.optimizer_step(opt, schedule, 0, loss)
    assert float(jloss) > 0
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)

    ref_g = flax_to_torch({"params": jgrads})
    ref_p = flax_to_torch({"params": jnew})
    scale = max(float(g.abs().max()) for g in ref_g.values())
    n_checked = 0
    for name, p in net.named_parameters():
        g = ref_g[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=0,
                                   atol=GRAD_REL * scale, err_msg=name)
        sel = np.abs(g) > GRAD_REL * scale
        np.testing.assert_allclose(p.detach().numpy()[sel],
                                   ref_p[name].numpy()[sel], atol=1e-6,
                                   rtol=0, err_msg=name)
        n_checked += int(sel.sum())
    assert n_checked > 100


def test_schedule_matches_jax():
    for kw in (dict(lr_epochs=[]), dict(lr_epochs=[1, 3], lr_factor=0.1)):
        ours = warmup_constant_schedule(1e-3, 4, steps_per_epoch=3, **kw)
        ref = jsched(1e-3, 4, steps_per_epoch=3, **kw)
        np.testing.assert_allclose([ours(s) for s in range(12)],
                                   [float(ref(s)) for s in range(12)],
                                   rtol=1e-6)


def test_chunked_occupancy_matches_jax(occ_nets):
    """Chunks of 30 queries per cloud (max_points_per_pass 60, B 2) against
    the JAX package's padded lax.map over the same chunking."""
    jvars, net = occ_nets
    rs = np.random.default_rng(3)
    pc = rs.normal(size=(2, 150, 3)).astype(np.float32) * 0.3
    pc_mask = rs.uniform(size=(2, 150)) < 0.8
    X = rs.uniform(-0.5, 0.5, (2, 100, 3)).astype(np.float32)
    vh = rs.normal(size=(2, 100, 64)).astype(np.float32) * 0.3
    ref = jcompute_occ(JSconeOcc(**OCC_KW), jvars, jnp.asarray(pc),
                       jnp.asarray(X), jnp.asarray(vh), key=None,
                       pc_mask=jnp.asarray(pc_mask), max_points_per_pass=60)
    with torch.no_grad():
        ours = compute_occupancy_probability(
            net, torch.as_tensor(pc), torch.as_tensor(X),
            torch.as_tensor(vh), pc_mask=torch.as_tensor(pc_mask),
            max_points_per_pass=60)
        whole = net(torch.as_tensor(pc), torch.as_tensor(X),
                    torch.as_tensor(vh), pc_mask=torch.as_tensor(pc_mask))
    assert ours.shape == (2, 100, 1)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(ours.numpy(), whole.numpy(), rtol=1e-5,
                               atol=1e-6)
    # One generator state for every chunk: the same down-samples as one
    # pass over all the queries.
    g1, g2 = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    with torch.no_grad():
        a = compute_occupancy_probability(
            net, torch.as_tensor(pc), torch.as_tensor(X),
            torch.as_tensor(vh), pc_mask=torch.as_tensor(pc_mask),
            generator=g1, max_points_per_pass=60)
        b = net(torch.as_tensor(pc), torch.as_tensor(X), torch.as_tensor(vh),
                pc_mask=torch.as_tensor(pc_mask), generator=g2)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)


def test_jax_checkpoint_loads(occ_nets, tmp_path):
    """A JAX pretrainer checkpoint (a Flax TrainState with AdamW state) of
    SconeOcc loads into the port: the weights of the converted variables,
    whose outputs test_chunked_occupancy_matches_jax holds to the JAX
    package's, and the same occupancies."""
    jvars, conv = occ_nets
    state = jpo.TrainState.create(apply_fn=None, params=jvars["params"],
                                  tx=optax.adamw(1e-3))
    jsave(str(tmp_path / "occ"), state, {"epoch": 3})
    net = SconeOcc(**OCC_KW)
    meta = load_checkpoint(str(tmp_path / "occ"), net)
    assert meta["epoch"] == 3
    rs = np.random.default_rng(4)
    pc = rs.normal(size=(1, 120, 3)).astype(np.float32) * 0.3
    X = rs.uniform(-0.5, 0.5, (1, 40, 3)).astype(np.float32)
    vh = rs.normal(size=(1, 40, 64)).astype(np.float32) * 0.3
    for k, v in conv.state_dict().items():
        assert torch.equal(net.state_dict()[k], v), k
    with torch.no_grad():
        ours, ref = (m(torch.as_tensor(pc), torch.as_tensor(X),
                       torch.as_tensor(vh)) for m in (net, conv))
    assert torch.equal(ours, ref)
    with pytest.raises(ValueError):
        load_checkpoint(str(tmp_path / "occ"), net,
                        torch.optim.AdamW(net.parameters()))


def test_run_training_resume_and_cli(shapenet_root, tmp_path, monkeypatch):
    """Two epochs from scratch (full-width SconeOcc at a tiny batch), the
    checkpoints, a resumed third epoch that keeps the first two's losses
    and continues the optimizer's step count, and the CLI on the CPU; the
    CLI's default device raises without a card."""
    w = str(tmp_path / "w")
    params = Params(dict(SMALL, data_path=shapenet_root, seq_len=32))
    model, tl, vl = po.run_training(params, weights_dir=w,
                                    max_batches_per_epoch=2, device="cpu",
                                    verbose=False)
    assert len(tl) == len(vl) == 2 and np.isfinite(tl + vl).all()
    for f in ("unvalidated_test_occ", "best_unval_test_occ"):
        assert os.path.exists(os.path.join(w, f + ".pt"))
    params3 = Params(dict(params.to_dict(), epochs=3,
                          start_from_scratch=False))
    model3, tl3, _ = po.run_training(params3, weights_dir=w,
                                     max_batches_per_epoch=2, device="cpu",
                                     verbose=False)
    assert tl3[:2] == tl and len(tl3) == 3
    meta = json.load(open(os.path.join(w, "unvalidated_test_occ.json")))
    assert meta["epoch"] == 2
    assert torch.load(os.path.join(w, "unvalidated_test_occ.pt"))["step"] == 6
    reloaded = po.build_model(params)
    load_checkpoint(os.path.join(w, "unvalidated_test_occ"), reloaded)
    for k, v in model3.state_dict().items():
        assert torch.equal(v, reloaded.state_dict()[k])

    conf = tmp_path / "occ.json"
    conf.write_text(json.dumps(dict(SMALL, seq_len=32, epochs=1,
                                    batch_size=4)))
    initialize_occ.main(["-c", str(conf), "--data-path", shapenet_root,
                         "--weights-dir", str(tmp_path / "cli"),
                         "--device", "cpu"])
    assert os.path.exists(tmp_path / "cli" / "unvalidated_test_occ.pt")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        initialize_occ.main(["-c", str(conf), "--data-path", shapenet_root,
                             "--weights-dir", str(tmp_path / "cli")])
