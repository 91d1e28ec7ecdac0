"""PyTorch port vs JAX package: SconeVis pretraining and the ShapeNet NBV
tester (CPU, tiny widths).

One coverage-gain step of the port (``trainers.pretrain_vis.vis_loss``,
then AdamW) against the JAX per-item step rebuilt from the JAX package's
public functions (pretrain_vis.py's ``per_item``, looped over the batch),
at converted weights, with the JAX draws injected into the port: the
proxy points, and each item's Monte-Carlo sample from the JAX package's
``sample_proxy_points``; SconeOcc without a key in both, in chunks smaller
than the proxies. Held: the loss (rtol 1e-4), the predicted gains (1e-5),
SconeVis's gradients (within 1e-3 of max |g|, through the plain version of
B3's backward), the parameters after AdamW. ``gt_coverage_gain``,
``greedy_optimal_sequences``, ``nbv_metric`` and
``compute_coverage_gain_multiple`` against the JAX package's. The
tester's NBV trajectory with the JAX draws injected: the same cameras,
coverages within 1e-6. A JAX SconeVis checkpoint loads into the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from macarons_tpu.config import Params as JParams
from macarons_tpu.models import losses as JL
from macarons_tpu.models.scone import SconeOcc as JSconeOcc
from macarons_tpu.models.scone import SconeVis as JSconeVis
from macarons_tpu.models.scone import compute_coverage_gain as jgain
from macarons_tpu.models.scone import \
    compute_coverage_gain_multiple as jgain_multiple
from macarons_tpu.models.scone import \
    compute_occupancy_probability as jcompute_occ
from macarons_tpu.ops import geometry as jgeo
from macarons_tpu.ops import view_state as jvs
from macarons_tpu.testers import shapenet as jts
from macarons_tpu.trainers import pretrain_occ as jpo
from macarons_tpu.trainers import pretrain_vis as jpv
from macarons_tpu.utils.checkpoint import save_checkpoint as jsave
from macarons_tpu_torch.config import Params
from macarons_tpu_torch.data import datasets as D
from macarons_tpu_torch.models.scone import SconeOcc, SconeVis, \
    compute_coverage_gain_multiple
from macarons_tpu_torch.testers import shapenet as ts
from macarons_tpu_torch.trainers import pretrain_occ as po
from macarons_tpu_torch.trainers import pretrain_vis as pv
from macarons_tpu_torch.utils.checkpoint import load_checkpoint
from macarons_tpu_torch.utils.convert import flax_to_torch
from test_torch_port_pretrain_occ import SMALL
from torch_port_helpers import OCC_KW, VIS_KW, make_shapenet_root, \
    random_flax_variables, torch_one_thread  # noqa: F401

VIS_SMALL = dict(
    SMALL, seq_len=32, n_proxy_points=256, min_occ_for_proxy_points=0.0,
    use_occ_to_sample_proxy_points=True, filter_tol=0.01,
    occ_no_view_harmonics=False, use_sigmoid=True,
    max_points_per_scone_occ_pass=100, pc_size=32,
    scone_vis_model_name="test_vis")
GRAD_REL = 1e-3


@pytest.fixture(scope="module")
def shapenet_root(tmp_path_factory):
    return make_shapenet_root(tmp_path_factory)


@pytest.fixture(scope="module")
def nets():
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
    return occ_vars, vis_vars, occ.eval(), vis


class JaxLane:
    """The JAX package's pretrain_vis per-item step and tester trajectory
    step, rebuilt from its public functions; SconeOcc without a key."""

    def __init__(self, jparams, occ_vars):
        self.p = jparams
        self.occ_vars = occ_vars
        self.X_cam, self.R, self.T = jpo.candidate_camera_poses(jparams)
        self.base, self.h_polar, _ = jvs.get_all_harmonics_under_degree(
            8, 7, 14)
        self.center = jnp.array([0.0, 0.0, jparams.camera_dist])
        # One compile per shape, for every item and step.
        self.gains = jax.jit(self._gains, static_argnames=("tester",))

    def norm(self, pts, cam):
        return jvs.normalize_points_in_prediction_box(
            jnp.einsum("nj,ji->ni", pts, self.R[cam]) + self.T[cam][None],
            self.center, self.p.gt_max_diagonal)

    def _gains(self, vis_params, pc_n, pc_mask, X_view, view_mask, X,
              X_cam_n, key, tester=False):
        """(gains (C,), sample indices) of one item or trajectory step."""
        p = self.p
        R_v, T_v = jgeo.look_at_view_transform(eye=X_view,
                                               at=jnp.zeros_like(X_view))
        keep = jvs.filter_proxy_points_mask(
            jgeo.FoVCamera.create(R_v, T_v, zfar=1000.0), X, pc_n,
            filter_tol=p.filter_tol, pc_mask=pc_mask,
            view_mask=view_mask if tester else None)
        vs = jvs.compute_view_state(X[None], X_view[None], 7, 14,
                                    view_mask=view_mask[None])
        vh = jvs.compute_view_harmonics(vs, self.base, self.h_polar, 7, 14)
        occ = jax.lax.stop_gradient(jcompute_occ(
            JSconeOcc(**OCC_KW), self.occ_vars, pc_n[None], X[None], vh,
            key=None, pc_mask=pc_mask[None],
            max_points_per_pass=p.max_points_per_scone_occ_pass)[0])
        pts4, harm, idx, smask = jvs.sample_proxy_points(
            key, X, occ, vh[0], p.seq_len, p.min_occ_for_proxy_points,
            valid_mask=keep)
        harmonics = JSconeVis(**VIS_KW).apply(
            {"params": vis_params}, pts4[None], harm[None],
            pts_mask=smask[None])
        return jgain(pts4[None], harmonics, X_cam_n[None],
                     pts_mask=smask[None])[0], idx


def test_vis_step_matches_jax(shapenet_root, nets):
    occ_vars, vis_vars, occ, _ = nets
    params = Params(dict(VIS_SMALL, data_path=shapenet_root))
    jparams = JParams(dict(VIS_SMALL, data_path=shapenet_root))
    lane = JaxLane(jparams, occ_vars)
    consts = po.step_constants(params, "cpu")
    train = D.get_shapenet_datasets(shapenet_root)[0]
    batch = pv.assemble_vis_batch(np.random.default_rng(6), train.paths[:2],
                                  consts.X_cam.numpy(), params,
                                  n_views=[1, 2])
    X = np.random.default_rng(7).uniform(
        -0.5, 0.5, (2, params.n_proxy_points, 3)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(8), 2)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def forward(vis_params):
        preds, truths, idxs = [], [], []
        for b in range(2):
            cam = jb["pred_cam_idx"][b]
            X_cam_n = lane.norm(lane.X_cam, cam)
            g, idx = lane.gains(
                vis_params, lane.norm(jb["pc"][b], cam), jb["pc_mask"][b],
                X_cam_n[jb["view_idx"][b]], jb["view_mask"][b],
                jnp.asarray(X[b]), X_cam_n, keys[b])
            preds.append(g)
            idxs.append(idx)
            truths.append(jpv.gt_coverage_gain(jb["coverage"][b],
                                               jb["view_idx"][b],
                                               jb["view_mask"][b]))
        pred, truth = jnp.stack(preds), jnp.stack(truths)
        loss = JL.uncentered_l1(pred[..., None], truth[..., None])
        return loss, (pred, truth, jnp.stack(idxs))

    (jloss, (jpred, jtruth, jidx)), jgrads = jax.value_and_grad(
        forward, has_aux=True)(vis_vars["params"])
    tx = optax.adamw(lambda s: 1e-3 * jnp.minimum(1.0, (s + 1) / 5))
    upd, _ = tx.update(jgrads, tx.init(vis_vars["params"]),
                       vis_vars["params"])
    jnew = optax.apply_updates(vis_vars["params"], upd)

    vis = SconeVis(**VIS_KW)
    vis.load_state_dict(flax_to_torch(vis_vars))
    opt, schedule = po.make_optimizer(params, vis, steps_per_epoch=4)
    loss, pred, truth = pv.vis_loss(
        params, occ, vis, consts, po.batch_to_device(batch, "cpu"),
        draws={"X": torch.as_tensor(X),
               "sample_idx": torch.as_tensor(np.array(jidx))})
    po.optimizer_step(opt, schedule, 0, loss)
    np.testing.assert_array_equal(truth.numpy(), np.asarray(jtruth))
    np.testing.assert_allclose(pred.detach().numpy(), np.asarray(jpred),
                               rtol=1e-5, atol=1e-7)
    assert float(jloss) > 0
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    ref_g = flax_to_torch({"params": jgrads})
    ref_p = flax_to_torch({"params": jnew})
    scale = max(float(g.abs().max()) for g in ref_g.values())
    n_checked = 0
    for name, p in vis.named_parameters():
        g = ref_g[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=0,
                                   atol=GRAD_REL * scale, err_msg=name)
        sel = np.abs(g) > GRAD_REL * scale
        np.testing.assert_allclose(p.detach().numpy()[sel],
                                   ref_p[name].numpy()[sel], atol=1e-6,
                                   rtol=0, err_msg=name)
        n_checked += int(sel.sum())
    assert n_checked > 100


def test_gains_sequences_and_metric(rng):
    cov = rng.integers(0, 2, (3, 10, 64)).astype(np.float32)
    view_idx = np.array([[2, 0], [1, 4], [7, 7]], np.int32)
    view_mask = np.array([[True, False], [True, True], [True, True]])
    ref = np.stack([np.asarray(jpv.gt_coverage_gain(
        jnp.asarray(cov[b]), jnp.asarray(view_idx[b]),
        jnp.asarray(view_mask[b]))) for b in range(3)])
    ours = pv.gt_coverage_gain(torch.as_tensor(cov),
                               torch.as_tensor(view_idx),
                               torch.as_tensor(view_mask)).numpy()
    np.testing.assert_array_equal(ours, ref)
    for b in range(3):
        np.testing.assert_array_equal(
            pv.greedy_optimal_sequences(cov[b], 4),
            jpv.greedy_optimal_sequences(cov[b], 4))
        pred = rng.normal(size=10)
        assert pv.nbv_metric(pred, cov[b], view_idx[b], view_mask[b]) \
            == jpv.nbv_metric(pred, cov[b], view_idx[b], view_mask[b])


@pytest.mark.parametrize("n_cam", [2, 3])
def test_coverage_gain_multiple(rng, n_cam):
    pts = rng.normal(size=(2, 64, 4)).astype(np.float32) * 0.4
    harm = rng.normal(size=(2, 64, 64)).astype(np.float32) * 0.3
    X_cam = rng.normal(size=(2, 5, 3)).astype(np.float32) * 2
    ref, ridx = jgain_multiple(jnp.asarray(pts), jnp.asarray(harm),
                               jnp.asarray(X_cam), n_cam)
    ours, idx = compute_coverage_gain_multiple(
        torch.as_tensor(pts), torch.as_tensor(harm), torch.as_tensor(X_cam),
        n_cam)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
    with pytest.raises(ValueError):
        compute_coverage_gain_multiple(torch.as_tensor(pts),
                                       torch.as_tensor(harm),
                                       torch.as_tensor(X_cam), 4)


def test_nbv_trajectory_matches_jax(shapenet_root, nets):
    """The tester's greedy trajectory (4 views from view 7 of one mesh)
    with the JAX draws injected: the proxy points, each step's cloud-union
    noise and Monte-Carlo sample; the same cameras, coverages within
    1e-6, never decreasing."""
    occ_vars, vis_vars, occ, vis = nets
    tp = dict(VIS_SMALL, n_view_max=4, n_proxy_points=200)
    params = Params(dict(tp, data_path=shapenet_root))
    lane = JaxLane(JParams(dict(tp, data_path=shapenet_root)), occ_vars)
    path = D.get_shapenet_datasets(shapenet_root)[2].paths[3]
    part_pc, part_mask, coverage = D.get_gt_partial_point_clouds(path)
    rs = np.random.default_rng(9)
    X = rs.uniform(-0.5, 0.5, (200, 3)).astype(np.float32)
    n_view, L, init = 4, part_pc.shape[1], 7
    max_pc = n_view * tp["pc_size"]
    X_cam_n = lane.norm(lane.X_cam, init)
    pc_all = lane.norm(jnp.asarray(part_pc.reshape(-1, 3)), init).reshape(
        52, L, 3)
    view_idx = np.zeros(n_view, np.int32)
    view_idx[0] = init
    view_mask = np.zeros(n_view, bool)
    view_mask[0] = True
    jcov = [float(jts.surface_coverage_from_cam_idx(
        jnp.asarray(coverage), jnp.asarray(view_idx),
        jnp.asarray(view_mask)))]
    noises, sidx = [], []
    for j in range(1, n_view):
        noise = rs.uniform(size=n_view * L).astype(np.float32)
        flat_mask = (part_mask[view_idx] & view_mask[:, None]).reshape(-1)
        _, take = jax.lax.top_k(-(jnp.asarray(noise)
                                  + jnp.where(flat_mask, 0.0, 1e9)), max_pc)
        gains, idx = lane.gains(
            vis_vars["params"], pc_all[view_idx].reshape(-1, 3)[take],
            jnp.asarray(flat_mask)[take], X_cam_n[view_idx],
            jnp.asarray(view_mask), jnp.asarray(X), X_cam_n,
            jax.random.PRNGKey(20 + j), tester=True)
        noises.append(torch.as_tensor(noise))
        sidx.append(torch.as_tensor(np.asarray(idx)))
        view_idx[j] = int(jnp.argmax(gains))
        view_mask[j] = True
        jcov.append(float(jts.surface_coverage_from_cam_idx(
            jnp.asarray(coverage), jnp.asarray(view_idx),
            jnp.asarray(view_mask))))
    with torch.no_grad():
        cov, vidx = ts.nbv_trajectory(
            params, occ, vis, po.step_constants(params, "cpu"),
            torch.as_tensor(part_pc), torch.as_tensor(part_mask),
            torch.as_tensor(coverage), init,
            draws={"X": torch.as_tensor(X), "noise": noises,
                   "sample_idx": sidx})
    np.testing.assert_array_equal(vidx.numpy(), view_idx)
    np.testing.assert_allclose(cov.numpy(), jcov, atol=1e-6, rtol=0)
    assert np.all(np.diff(cov.numpy()) >= 0)
    assert len(set(view_idx.tolist())) > 1


def test_jax_vis_checkpoint_loads(nets, tmp_path):
    _, vis_vars, _, vis = nets
    state = jpv.TrainState.create(apply_fn=None, params=vis_vars["params"],
                                  tx=optax.adamw(1e-3))
    jsave(str(tmp_path / "vis"), state, {"epoch": 1})
    net = SconeVis(**VIS_KW)
    assert load_checkpoint(str(tmp_path / "vis"), net)["epoch"] == 1
    pts = torch.randn(1, 50, 4, generator=torch.Generator().manual_seed(1))
    vh = torch.randn(1, 50, 64, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        assert torch.equal(net(pts, vh), vis(pts, vh))
