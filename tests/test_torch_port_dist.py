"""Data parallelism over several ranks on the CPU (gloo): the port's
``parallel/`` modules against the JAX package's on ``make_mesh(n)``.

One module fixture starts every spawn (``parallel.distributed.spawn``, a
120 s timeout and deadline each, 300 s for the group training runs) as
soon as its inputs exist, and computes the JAX references meanwhile (the
group steps' in a process of their own).
World 2 runs every case of ``torch_dist_ranks``, world 4 the group steps
and the scorer (BatchNorm over four ranks, one scene a rank, the scorer's
padding); each rank returns the group's losses, its gradients and
parameters after the step, and ``replicas_agree``. Every rank must hold
the same values bit for bit, and they are held against the JAX package's
step with its inputs laid over ``make_mesh(n)`` (``P('dp')``), at tiny
widths:

- one occupancy pretraining step at a global batch of 2 x 3 (the JAX step
  rebuilt from its public functions, as test_torch_port_pretrain_occ.py
  does): the loss at rtol 1e-4, gradients within 1e-3 of max |g|, the
  parameters after AdamW where |g| > 1e-3 max |g| (atol 1e-6); and with
  SconeOcc's down-samples drawn from a generator, against the port's own
  world-1 step on the whole batch (the draws at the global shape, sliced):
  the loss at rtol 1e-5, gradients within 1e-5 of max |g|;
- one coverage-gain pretraining step at 2 x 3, the JAX draws injected, as
  test_torch_port_pretrain_vis.py holds it; with the draws made (per-item
  generators seeded at the global shape) against world 1 as above;
- one group depth step in train mode over 4 scenes' windows against JAX
  ``depth_train_step`` on ``_ring_scene_batches``, both in float64 (as
  test_torch_port_train_steps.py's float64 check; ``DEPTH_GRAD_REL``):
  the loss (rtol 1e-4), gradients within 3e-5 of max |g|, BatchNorm's
  running statistics over the whole batch (1e-5 of their largest
  magnitude), each rank's depths (rtol 1e-4) and masks;
- one group SCONE step over 4 scenes (cube_a, cube_b, cube_a, cube_b with
  their own draws) against ``make_parallel_scone_step`` on the stacked
  group sharded by ``shard_scene_axis``: losses rtol 1e-4, gradients
  within 1e-3 of max |g|, parameters after AdamW;
- the sharded scorer over 5 candidates (padded to the world) against JAX
  ``make_sharded_coverage_gain_fn``: gains rtol 1e-3 (atol 1e-7), as
  test_torch_port_trajectory.py holds the scorer, and the same argmax;
  with the MC sample drawn, equal to the port's world-1 scorer within
  1e-6;
- a 2-epoch ``run_training`` at ``n_parallel_scenes`` 2 on two ranks over
  three scenes (a group split over the ranks and a trailing scene on
  rank 0 each epoch) with the disk memory, depth and SCONE replay and a
  resume, with perfect depth: the weights and the SCONE losses equal to
  one process's run bit for bit, the reported depth loss at rtol 1e-6,
  both ranks equal bit for bit; at group 4 the three scenes are a
  trailing group that does not split over two ranks, and the run raises;
- the same group run with the device memory: epochs 0 and 1 in one run,
  then a resume (2 slots), over two ranks and in one process. The
  weights and SCONE losses bit for bit, the depth loss at rtol 1e-6;
  each rank's memory after every epoch's exchange and after the resume's
  hydration equal to one process's, key for key; the slots each rank
  loaded are the ones the other captured (owners from the seeds); the
  ranks' flushed files equal one process's, file for file; and a SCONE
  replay in epoch 1 reads a slot that the other rank captured;
- work that rank 0 does alone outlasts the group's timeout while the
  other waits in ``await_lone_work``; a rank that raises ends the run at
  once, and ``spawn`` reports it even when the rank it failed first
  failed too (the launcher saw the later failure first); a run past its
  deadline is ended; ``initialize`` reads torchrun's, the JAX package's
  and SLURM's launch variables in that order.
"""

import copy
import multiprocessing
import os
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from macarons_tpu.config import Params as JParams
from macarons_tpu.models import losses as JL
from macarons_tpu.models.macarons import MacaronsModel as JMacaronsModel
from macarons_tpu.models.macarons import create_macarons_model as jcreate
from macarons_tpu.models.scone import SconeOcc as JSconeOcc
from macarons_tpu.models.scone import SconeVis as JSconeVis
from macarons_tpu.ops.geometry import FoVCamera as JFoVCamera
from macarons_tpu.parallel import scene_dp as JSDP
from macarons_tpu.parallel.mesh import make_mesh, shard_batch as jshard
from macarons_tpu.parallel.nbv import \
    make_sharded_coverage_gain_fn as jsharded_fn
from macarons_tpu.parallel.nbv import pad_candidates as jpad
from macarons_tpu.scene import depth_runtime as jdr
from macarons_tpu.scene import grid as jG
from macarons_tpu.scene import proxy as jP
from macarons_tpu.scene import runtime as jR
from macarons_tpu.trainers import pretrain_vis as jpv
from macarons_tpu.trainers import train_macarons as JTM
from macarons_tpu_torch.config import Params
from macarons_tpu_torch.data import datasets as D
from macarons_tpu_torch.ops.geometry import FoVCamera
from macarons_tpu_torch.parallel import distributed
from macarons_tpu_torch.trainers import pretrain_occ as po
from macarons_tpu_torch.trainers import pretrain_vis as pv
from macarons_tpu_torch.trainers import train_macarons as TM
from macarons_tpu_torch.utils.convert import flax_to_torch
import torch_dist_ranks as ranks
from test_torch_port_pretrain_occ import SMALL, jax_loss_fn
from test_torch_port_pretrain_vis import VIS_SMALL, JaxLane
from test_torch_port_train_group import SCENES, SCONE, arrays, cube_root, \
    group_inputs  # noqa: F401
from test_torch_port_train_loop import TRAIN
from test_torch_port_train_scone import jax_draws as scone_draws, with_grads
from test_torch_port_train_steps import DEPTH, H, N_DEPTH, W, f64, \
    frames_for, many_depth_pair
from test_torch_port_trajectory import jax_draws as scorer_draws
from torch_port_helpers import OCC_KW, TINY, VIS_KW, make_shapenet_root, \
    random_flax_variables, torch_one_thread  # noqa: F401

WORLDS = (2, 4)
SPAWN_TIMEOUT = 120.0
# The group training runs take 60-75 s each alone, beside the module's
# other spawns; under a loaded test run, more than twice that.
TRAINING_TIMEOUT = 300.0
GRAD_REL = 1e-3
# The group depth step runs in float64 on the ranks and in the JAX
# package (whose disparity heads stay float32 under x64), as
# test_torch_port_train_steps.py's float64 check: at 4 scenes the float32
# step's own rounding reaches 1.5e-3 of max |g| at world 1 already.
DEPTH_GRAD_REL = 3e-5
N_GROUP = 4  # the group steps' scenes: one or two a rank
N_ACTIVE = 3
N_CAND = 5


def spawn(fn, world, *args, limit=SPAWN_TIMEOUT):
    """``fn(*args)`` over ``world`` ranks, the group's timeout and the
    run's deadline ``limit`` seconds. The arguments are copied first:
    starting the ranks moves the tensors that they are given into shared
    memory, under any view that the caller holds of them."""
    return distributed.spawn(fn, world, copy.deepcopy(args), device="cpu",
                             timeout=limit, deadline=limit)


def same_on_every_rank(results, key, fields=("loss", "grads", "params")):
    """Check that every rank's ``fields`` of its ``key`` results are rank
    0's, bit for bit."""
    ref = results[0][key]
    for r in results[1:]:
        for f in fields:
            if isinstance(ref[f], dict):
                for k, v in ref[f].items():
                    torch.testing.assert_close(r[key][f][k], v, rtol=0,
                                               atol=0, msg=f"{f} {k}")
            else:
                assert r[key][f] == ref[f], f


def check_grads(ours, jgrads, rel=GRAD_REL, prefix="0."):
    ref = flax_to_torch({"params": jgrads})
    scale = max(float(g.abs().max()) for g in ref.values())
    assert scale > 0
    for name, g in ref.items():
        np.testing.assert_allclose(ours[prefix + name].numpy(), g.numpy(),
                                   rtol=0, atol=rel * scale, err_msg=name)
    return ref, scale


def check_adamw(ours, jnew, ref_g, scale, prefix="0.", rel=GRAD_REL):
    ref_p = flax_to_torch({"params": jnew})
    n = 0
    for name, p in ref_p.items():
        sel = np.abs(ref_g[name].numpy()) > rel * scale
        np.testing.assert_allclose(ours[prefix + name].numpy()[sel],
                                   p.numpy()[sel], rtol=0, atol=1e-6,
                                   err_msg=name)
        n += int(sel.sum())
    assert n > 100


def check_close(ours, ref, rel):
    """Each tensor within ``rel`` of the largest magnitude of all."""
    scale = max(float(v.abs().max()) for v in ref.values())
    for k, v in ref.items():
        torch.testing.assert_close(ours[k], v, rtol=0, atol=rel * scale,
                                   msg=k)


# ---------------------------------------------------------------------------
# Inputs, the spawned ranks and the JAX package's references
# ---------------------------------------------------------------------------


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
    return occ_vars, vis_vars


def pretrain_batches(shapenet_root, n):
    """The occupancy and coverage-gain global batches of n x 3 items."""
    train = D.get_shapenet_datasets(shapenet_root)[0]
    B = 3 * n
    paths = [train.paths[i % len(train.paths)] for i in range(B)]
    params = Params(dict(SMALL, data_path=shapenet_root))
    consts = po.step_constants(params, "cpu")
    views = [1 + i % 2 for i in range(B)]
    occ = D.assemble_occ_batch(np.random.default_rng(5), paths,
                               consts.X_cam.numpy(), 1, 2, params.seq_len,
                               params.n_sample, n_views=views)
    vparams = Params(dict(VIS_SMALL, data_path=shapenet_root))
    vis = pv.assemble_vis_batch(np.random.default_rng(6), paths,
                                consts.X_cam.numpy(), vparams, n_views=views)
    X = np.random.default_rng(7).uniform(
        -0.5, 0.5, (B, vparams.n_proxy_points, 3)).astype(np.float32)
    return occ, vis, X


@pytest.fixture(scope="module")
def vis_lane(shapenet_root, nets):
    """The JAX per-item coverage-gain step, compiled once for both
    worlds."""
    return JaxLane(JParams(dict(VIS_SMALL, data_path=shapenet_root)),
                   nets[0])


def vis_reference(lane, nets, batch, X, n):
    """The JAX per-item coverage-gain step over the batch laid on
    make_mesh(n): (loss, predictions, gradients, parameters after AdamW,
    the MC sample indices)."""
    _, vis_vars = nets
    B = len(X)
    keys = jax.random.split(jax.random.PRNGKey(8), B)
    jb = jshard({k: jnp.asarray(v) for k, v in batch.items()}, make_mesh(n))
    jX = jshard(jnp.asarray(X), make_mesh(n))

    def forward(vis_params):
        preds, truths, idxs = [], [], []
        for b in range(B):
            cam = jb["pred_cam_idx"][b]
            X_cam_n = lane.norm(lane.X_cam, cam)
            g, idx = lane.gains(
                vis_params, lane.norm(jb["pc"][b], cam), jb["pc_mask"][b],
                X_cam_n[jb["view_idx"][b]], jb["view_mask"][b], jX[b],
                X_cam_n, keys[b])
            preds.append(g)
            idxs.append(idx)
            truths.append(jpv.gt_coverage_gain(jb["coverage"][b],
                                               jb["view_idx"][b],
                                               jb["view_mask"][b]))
        pred, truth = jnp.stack(preds), jnp.stack(truths)
        loss = JL.uncentered_l1(pred[..., None], truth[..., None])
        return loss, (pred, jnp.stack(idxs))

    (jloss, (jpred, jidx)), jgrads = jax.value_and_grad(
        forward, has_aux=True)(vis_vars["params"])
    tx = optax.adamw(lambda s: 1e-3 * jnp.minimum(1.0, (s + 1) / 5))
    upd, _ = tx.update(jgrads, tx.init(vis_vars["params"]),
                       vis_vars["params"])
    return (float(jloss), np.asarray(jpred), jgrads,
            optax.apply_updates(vis_vars["params"], upd), np.array(jidx))


def group_depth_inputs():
    """4 scenes' frame sequences, ManyDepth's weights and the augmentation
    draws (jitter and flip on, the JAX step's factors)."""
    params = dict(TINY, **DEPTH, data_augmentation=True,
                  jitter_probability=1.0, symmetry_probability=1.0)
    jrt = JTM.MacaronsRuntime(JParams(params), jcreate(JParams(params)))
    _, v, m = many_depth_pair(3, 1, 2)
    L = jrt.ring_length()
    frames = [frames_for(np.random.default_rng(20 + s), L)
              for s in range(N_GROUP)]
    key = jax.random.PRNGKey(4)
    with jax.enable_x64(True):
        _, _, k_j, _ = jax.random.split(key, 4)
        draws = {"jitter": True, "symmetry": True, "factors": tuple(
            float(f) for f in jdr.sample_jitter_factors(k_j, jrt.dcfg))}
    return params, jrt, v, m, frames, key, draws


def depth_reference(inputs, n):
    """JAX depth_train_step (float64) on the 4 stacked rings' batch laid
    on make_mesh(n)."""
    params, jrt, v, _, frames, key, _ = inputs
    rings = []
    for fr in frames:
        ring = jdr.init_frame_ring(jrt.ring_length(), H, W, TINY["zfar"])
        rings.append(jdr.ring_push(ring, fr["images"], fr["zbuf"],
                                   fr["mask"], fr["R"], fr["T"],
                                   TINY["zfar"]))
    jbatch, jalpha = jrt._ring_scene_batches(JSDP.stack_scene_group(rings))
    jrt.depth_tx = with_grads(jrt.depth_tx)
    mesh = make_mesh(n)
    with jax.enable_x64(True):
        v64 = f64(v)
        new_vars, (_, jgrads), jloss, jdepth, jmask, _ = \
            jrt.depth_train_step(v64, jrt.depth_tx.init(v64["params"]),
                                 jshard(f64(jbatch), mesh),
                                 jshard(f64(jalpha), mesh), key)
    return new_vars, jgrads, float(jloss), np.asarray(jdepth), \
        np.asarray(jmask)


def scone_group(group_inputs):  # noqa: F811
    """The SCONE group of N_GROUP scenes (cube_a, cube_b twice) and each
    position's draws from its own split key, over the group's padded cell
    count (scene i's noise its first C_i entries)."""
    params, root, _, occ_vars, vis_vars, two = group_inputs
    group = [two[i % 2] for i in range(N_GROUP)]
    jparams = JParams(dict(TINY, data_path=root, **SCONE))
    key = jax.random.PRNGKey(3)
    Cp = max(x.cfg.n_cells for x in group)
    noises, idxs = [], []
    for x, k in zip(group, jax.random.split(key, N_GROUP)):
        cams = JFoVCamera.create(x.visited_cams.R.numpy(),
                                 x.visited_cams.T.numpy(), zfar=jparams.zfar)
        noise, idx = scone_draws(
            jparams, tuple(jnp.asarray(t.numpy()) for t in x.field), cams, k,
            Cp)
        noises.append(torch.as_tensor(noise[:x.cfg.n_cells]))
        idxs.append(torch.as_tensor(idx))
    return params, root, occ_vars, vis_vars, group, key, noises, idxs


def scone_reference(sg, n):
    """make_parallel_scone_step on the stacked, padded group, its scene
    axis sharded over make_mesh(n)."""
    params, root, occ_vars, vis_vars, group, key, _, _ = sg
    jparams = JParams(dict(TINY, data_path=root, **SCONE))
    jrt = JTM.MacaronsRuntime(jparams, JMacaronsModel(
        None, JSconeOcc(**OCC_KW), JSconeVis(**VIS_KW)))
    jrt.scone_tx = with_grads(jrt.scone_tx)
    Cp = max(x.cfg.n_cells for x in group)
    Kp = max(x.surface.valid.shape[1] for x in group)
    KCp = max(x.cell_table.proxy_slots.shape[1] for x in group)
    per_scene = []
    for x in group:
        tables = jR.device_cell_tables(jG.GridConfig(*x.cfg),
                                       jR.CellIndexTable(*x.cell_table), 3.0)
        cams = JFoVCamera.create(x.visited_cams.R.numpy(),
                                 x.visited_cams.T.numpy(), zfar=jparams.zfar)
        jfield = tuple(jnp.asarray(t.numpy()) for t in x.field)
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
            "valid": jfield[3],
            "box_diag": jnp.asarray(float(np.linalg.norm(
                np.asarray(x.cfg.x_max) - np.asarray(x.cfg.x_min)))),
            "cell_resolution": jnp.asarray(x.cfg.resolution),
            "n_cells_active": jnp.asarray(N_ACTIVE, jnp.int32)})
    sb = JSDP.shard_scene_axis(JSDP.stack_scene_group(per_scene),
                               make_mesh(n))
    step = JSDP.make_parallel_scone_step(
        jrt, n_supervision=SCONE["n_proxy_point_for_occupancy_supervision"])
    ps = {"occ": occ_vars["params"], "vis": vis_vars["params"]}
    new_occ, new_vis, (_, jgrads), jloss, jocc, jcov = step(
        occ_vars, vis_vars, jrt.scone_tx.init(ps), sb, key)
    return (new_occ["params"], new_vis["params"], jgrads,
            [float(jloss), float(jocc), float(jcov)])


def scorer_inputs(sg):
    """A scene field and N_CAND candidate cameras (cube_a's and cube_b's
    visited ones) for the scorer."""
    params, _, _, vis_vars, group, _, _, _ = sg
    x = group[0]
    cams = [group[0].visited_cams, group[1].visited_cams]
    cam = FoVCamera(*(torch.cat([getattr(c, f) for c in cams])[:N_CAND]
                      for f in ("R", "T", "fov", "znear", "zfar",
                                "aspect_ratio")))
    X = torch.cat([group[0].visited_X, group[1].visited_X])[:N_CAND]
    box_diag = float(np.linalg.norm(np.asarray(x.cfg.x_max)
                                    - np.asarray(x.cfg.x_min)))
    return dict(field=x.field, cams=cam, X=X, pred_cam=x.prediction_camera,
                box_diag=box_diag, cell_resolution=x.cfg.resolution,
                sensor_range=params.sensor_range,
                kw=dict(seq_len=params.seq_len,
                        image_height=params.image_height,
                        image_width=params.image_width,
                        min_occ=params.min_occ_for_proxy_points),
                vis_kw=VIS_KW, vis_state=flax_to_torch(vis_vars))


def scorer_reference(sx, vis_vars, params, n):
    """JAX make_sharded_coverage_gain_fn over make_mesh(n), the candidates
    padded to the mesh; the per-candidate MC sample of its keys."""
    jfield = tuple(jnp.asarray(t.numpy()) for t in sx["field"])
    cams = JFoVCamera(*(jnp.asarray(getattr(sx["cams"], f).numpy())
                        for f in JFoVCamera._fields))
    cams, X, C = jpad(cams, jnp.asarray(sx["X"].numpy()), n)
    pred = JFoVCamera(*(jnp.asarray(getattr(sx["pred_cam"], f).numpy())
                        for f in JFoVCamera._fields))
    key = jax.random.PRNGKey(7)
    fn = jsharded_fn(jR.make_coverage_gain_fn(JSconeVis(**VIS_KW),
                                              **sx["kw"]), make_mesh(n))
    gains = fn(vis_vars, *jfield, cams, X, pred, sx["box_diag"],
               sx["cell_resolution"], sx["sensor_range"], key)
    idx, _ = scorer_draws(params, jfield, cams, key)
    return np.asarray(gains)[:C], torch.as_tensor(np.array(idx)[:C])


def world_inputs(n, shapenet_root, nets, vis_lane, depth_inputs, sg,
                 batches):
    """World n's cases for its ranks, and the JAX references that supply
    their draws: every case at world 2 (``batches``, its pretraining
    batches); the group steps and the scorer at world 4."""
    occ_vars, vis_vars = nets
    dparams, _, _, m, frames, _, draws = depth_inputs
    sparams = sg[0]
    sx = scorer_inputs(sg)
    sref = scorer_reference(sx, vis_vars, JParams(sparams.to_dict()), n)
    sx["idx"] = sref[1]
    inputs = {
        "depth": dict(params=dparams, occ_kw=OCC_KW, vis_kw=VIS_KW,
                      many_depth=(H, W, 0.5, TINY["zfar"], N_DEPTH),
                      state=m.state_dict(), frames=frames, draws=draws,
                      dtype=torch.float64),
        "scone": dict(params=sparams.to_dict(), occ_kw=OCC_KW,
                      vis_kw=VIS_KW, occ_state=flax_to_torch(occ_vars),
                      vis_state=flax_to_torch(vis_vars), group=sg[4],
                      n_active=N_ACTIVE, noise=sg[6], idx=sg[7]),
        "scorer": sx,
    }
    refs = {"scorer": sref[0]}
    if n == 2:
        occ_batch, vis_batch, X = batches
        refs["vis"] = vis_reference(vis_lane, nets, vis_batch, X, n)
        inputs["occ"] = dict(params=dict(SMALL, data_path=shapenet_root),
                             occ_kw=OCC_KW, state=flax_to_torch(occ_vars),
                             batch=occ_batch)
        inputs["vis"] = dict(params=dict(VIS_SMALL, data_path=shapenet_root),
                             occ_kw=OCC_KW, vis_kw=VIS_KW,
                             occ_state=flax_to_torch(occ_vars),
                             vis_state=flax_to_torch(vis_vars),
                             batch=vis_batch, X=X, idx=refs["vis"][4])
    return inputs, refs


@pytest.fixture(scope="module")
def runs(shapenet_root, nets, vis_lane, group_inputs,  # noqa: F811
         cube_root, tmp_path_factory):  # noqa: F811
    """The module's spawns, each started as soon as its inputs exist and
    run while the JAX package's references are computed here: the group
    training over two ranks and in one process, the failing runs, then
    the world-2 and world-4 ranks. The group depth and SCONE references
    are taken on make_mesh(4), the largest world, in a process of their
    own, and both worlds are held to them (their inputs do not depend on
    the world). Returns {world:
    (inputs, results, references)}, "training" and "device_memory": (one
    process's, the two ranks', the run's directory) of the disk and the
    device memory, "failing": the failing runs' (error, seconds), and
    "both_fail": the run whose two ranks fail."""
    occ_vars, _ = nets
    out = {}
    with ThreadPoolExecutor(9) as pool, ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as jax_pool:
        training = training_jobs(pool, cube_root,
                                 tmp_path_factory.mktemp("training"))
        device_training = training_jobs(
            pool, cube_root, tmp_path_factory.mktemp("device_memory"),
            device_memory=True)
        past = tmp_path_factory.mktemp("failing") / "past"
        markers = tmp_path_factory.mktemp("both_fail")
        failing = [pool.submit(attempt, spawn, ranks.failing_rank, 2,
                               str(past)),
                   pool.submit(attempt, distributed.spawn,
                               ranks.sleeping_rank, 2, (60,), device="cpu",
                               timeout=SPAWN_TIMEOUT, deadline=5.0)]
        both_fail = pool.submit(attempt, spawn, ranks.both_ranks_fail, 2,
                                str(markers))
        depth_inputs = group_depth_inputs()
        sg = scone_group(group_inputs)
        # A copy: sending tensors to a process moves their storage into
        # shared memory, under the views that JAX made of them here.
        group_job = jax_pool.submit(group_references, copy.deepcopy(sg))
        batches = pretrain_batches(shapenet_root, 2)
        jobs = {}
        for n in WORLDS:
            inputs, refs = world_inputs(n, shapenet_root, nets, vis_lane,
                                        depth_inputs, sg, batches)
            jobs[n] = pool.submit(spawn, ranks.all_cases, n, inputs)
            out[n] = (inputs, refs)
        shared = {"occ": occ_reference(batches[0], occ_vars, 2,
                                       shapenet_root)}
        shared["depth"], shared["scone"] = group_job.result()
        for n, job in jobs.items():
            inputs, refs = out[n]
            out[n] = (inputs, job.result(), dict(shared, **refs))
        out["training"] = (training[1].result()[0], training[0].result(),
                           training[2])
        out["device_memory"] = (device_training[1].result()[0],
                                device_training[0].result(),
                                device_training[2])
        out["failing"] = [job.result() for job in failing] + [past]
        out["both_fail"] = both_fail.result()
    return out


def group_references(sg):
    """The JAX package's group depth and SCONE steps on make_mesh(4), the
    largest world, as numpy trees. Runs in a process of its own beside
    this one's JAX references (the depth step's inputs are made again
    there, from their seeds)."""
    jax.config.update("jax_platforms", "cpu")
    assert jax.device_count() >= max(WORLDS)
    return tuple(jax.tree.map(np.asarray, ref) for ref in (
        depth_reference(group_depth_inputs(), max(WORLDS)),
        scone_reference(sg, max(WORLDS))))


def attempt(fn, *args, **kw):
    """(the error that ``fn(*args, **kw)`` raised or None, its seconds)."""
    t0 = time.perf_counter()
    try:
        fn(*args, **kw)
    except Exception as e:  # noqa: BLE001 - the test reads it
        return e, time.perf_counter() - t0
    return None, time.perf_counter() - t0


def occ_reference(batch, occ_vars, n, shapenet_root):
    """The JAX occupancy step on the global batch laid on make_mesh(n):
    (loss, gradients, parameters after AdamW)."""
    jparams = JParams(dict(SMALL, data_path=shapenet_root))
    jb = jshard({k: jnp.asarray(v) for k, v in batch.items()},
                make_mesh(n))
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jax_loss_fn(jparams, JSconeOcc(**OCC_KW), b)(p)))(
        occ_vars["params"], jb)
    tx = optax.adamw(lambda s: 1e-3 * jnp.minimum(1.0, (s + 1) / 5))
    upd, _ = tx.update(jgrads, tx.init(occ_vars["params"]),
                       occ_vars["params"])
    return (float(jloss), jgrads,
            optax.apply_updates(occ_vars["params"], upd))


# ---------------------------------------------------------------------------
# The cases
# ---------------------------------------------------------------------------


def test_occ_step(runs):
    n = 2
    inputs, results, refs = runs[n]
    x = inputs["occ"]
    for label in ("plain", "drawn"):
        assert all(r["occ"][label]["agree"] for r in results)
        same_on_every_rank([r["occ"] for r in results], label)
    ours = results[0]["occ"]["plain"]
    jloss, jgrads, jnew = refs["occ"]
    assert len(x["batch"]["pc"]) == 3 * n and jloss > 0
    np.testing.assert_allclose(ours["loss"], jloss, rtol=1e-4)
    ref_g, scale = check_grads(ours["grads"], jgrads)
    check_adamw(ours["params"], jnew, ref_g, scale)
    # The drawn down-samples: world n equals one process's step.
    one = ranks.occ_case(x)["drawn"]
    drawn = results[0]["occ"]["drawn"]
    np.testing.assert_allclose(drawn["loss"], one["loss"], rtol=1e-5)
    check_close(drawn["grads"], one["grads"], 1e-5)
    assert drawn["loss"] != ours["loss"]


def test_vis_step(runs):
    inputs, results, refs = runs[2]
    jloss, jpred, jgrads, jnew, _ = refs["vis"]
    for label in ("plain", "drawn"):
        assert all(r["vis"][label]["agree"] for r in results)
        same_on_every_rank([r["vis"] for r in results], label)
    ours = results[0]["vis"]["plain"]
    assert jloss > 0
    np.testing.assert_allclose(ours["loss"], jloss, rtol=1e-4)
    for r in results:
        rows = r["vis"]["plain"]["rows"]
        np.testing.assert_allclose(r["vis"]["plain"]["pred"].numpy(),
                                   jpred[rows], rtol=1e-5, atol=1e-7)
    ref_g, scale = check_grads(ours["grads"], jgrads)
    check_adamw(ours["params"], jnew, ref_g, scale)
    one = ranks.vis_case(inputs["vis"])["drawn"]
    drawn = results[0]["vis"]["drawn"]
    np.testing.assert_allclose(drawn["loss"], one["loss"], rtol=1e-5)
    check_close(drawn["grads"], one["grads"], 1e-5)
    for r in results:
        rows = r["vis"]["drawn"]["rows"]
        torch.testing.assert_close(r["vis"]["drawn"]["pred"],
                                   one["pred"][rows], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("n", WORLDS, ids=lambda n: f"world{n}")
def test_group_depth_step(runs, n):
    _, results, refs = runs[n]
    new_vars, jgrads, jloss, jdepth, jmask = refs["depth"]
    assert all(r["depth"]["agree"] for r in results)
    same_on_every_rank(results, "depth", ("loss", "grads", "params",
                                          "stats"))
    ours = results[0]["depth"]
    np.testing.assert_allclose(ours["loss"], jloss, rtol=1e-4)
    ref_g, scale = check_grads(ours["grads"], jgrads, rel=DEPTH_GRAD_REL)
    stats = flax_to_torch({"params": new_vars["params"],
                           "batch_stats": new_vars["batch_stats"]})
    n_stats = 0
    for k, a in stats.items():
        if "running" in k:
            np.testing.assert_allclose(
                ours["stats"][k].numpy(), a.numpy(), rtol=0,
                atol=1e-5 * np.abs(a.numpy()).max(), err_msg=k)
            n_stats += 1
    assert n_stats == 40
    # Each rank's depths and masks are its rows of the group's.
    F = len(jdepth) // N_GROUP
    per = N_GROUP // n
    for r, res in enumerate(results):
        rows = slice(r * per * F, (r + 1) * per * F)
        np.testing.assert_allclose(res["depth"]["depth"].numpy(),
                                   jdepth[rows], rtol=1e-4)
        np.testing.assert_array_equal(res["depth"]["mask"].numpy(),
                                      jmask[rows])
    check_adamw(ours["params"], new_vars["params"], ref_g, scale)


@pytest.mark.parametrize("n", WORLDS, ids=lambda n: f"world{n}")
def test_group_scone_step(runs, n):
    _, results, refs = runs[n]
    jocc, jvis, jgrads, jlosses = refs["scone"]
    assert all(r["scone"]["agree"] for r in results)
    same_on_every_rank(results, "scone", ("losses", "grads", "params"))
    ours = results[0]["scone"]
    assert min(jlosses[1:]) > 0
    np.testing.assert_allclose(ours["losses"], jlosses, rtol=1e-4)
    for prefix, net in (("0.", "occ"), ("1.", "vis")):
        ref_g, scale = check_grads(ours["grads"], jgrads[net],
                                   prefix=prefix)
        check_adamw(ours["params"], {"occ": jocc, "vis": jvis}[net], ref_g,
                    scale, prefix=prefix)


@pytest.mark.parametrize("n", WORLDS, ids=lambda n: f"world{n}")
def test_sharded_scorer(runs, n):
    inputs, results, refs = runs[n]
    jgains = refs["scorer"]
    for r in results:
        torch.testing.assert_close(r["scorer"]["plain"],
                                   results[0]["scorer"]["plain"], rtol=0,
                                   atol=0)
        torch.testing.assert_close(r["scorer"]["drawn"],
                                   results[0]["scorer"]["drawn"], rtol=0,
                                   atol=0)
    ours = results[0]["scorer"]
    assert len(jgains) == N_CAND and np.count_nonzero(jgains) >= 3
    np.testing.assert_allclose(ours["plain"].numpy(), jgains, rtol=1e-3,
                               atol=1e-7)
    assert all(r["scorer"]["argmax"] == int(np.argmax(jgains))
               for r in results)
    one = ranks.scorer_case(inputs["scorer"])
    torch.testing.assert_close(ours["drawn"], one["drawn"], rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("n", WORLDS, ids=lambda n: f"world{n}")
def test_ranks_on_device(runs, n):
    """Every rank of a world on this host's CPU counts the world's ranks
    on its device (as gloo ranks sharing a card count each other)."""
    _, results, _ = runs[n]
    assert [r["on_device"] for r in results] == [n] * n


# ---------------------------------------------------------------------------
# Training over two ranks, and failures
# ---------------------------------------------------------------------------


def training_jobs(pool, cube_root, tmp,  # noqa: F811
                  device_memory=False):
    """Start run_training at group 2 on three scenes over two ranks and in
    one process (its own spawned process, so that both run beside the
    module's other work), with the disk memory (``training_case``) or the
    device memory (``device_memory_training_case``): (two ranks' future,
    one process's future, the run's directory)."""
    root = tmp / "scenes"
    root.mkdir()
    for name in SCENES:
        os.symlink(os.path.join(cube_root, name), root / name)
    params = dict(TRAIN, data_path=str(root), n_parallel_scenes=2,
                  use_perfect_depth=True, macarons_model_name="dp_mac",
                  device_memory=device_memory)
    case = ranks.device_memory_training_case if device_memory else \
        ranks.training_case

    def run_dirs(tag):
        return dict(params=params, weights_dir=str(tmp / tag / "w"),
                    memory_root=str(tmp / tag / "mem"))

    return (pool.submit(spawn, case, 2, run_dirs("two"),
                        limit=TRAINING_TIMEOUT),
            pool.submit(spawn, case, 1, run_dirs("one"),
                        limit=TRAINING_TIMEOUT), tmp)


def test_group_training_two_ranks(runs):
    """run_training at group 2 over two ranks against one process, with
    perfect depth, on three scenes: each epoch a group split over the
    ranks and a trailing scene alone on rank 0, its state then sent to
    rank 1. In the group each rank's SCONE step back-propagates its scene
    and the two gradients are added, in one process the second
    accumulates onto the first, one float32 addition either way, so the
    weights are equal bit for bit (the depth network's data-parallel
    step, whose batch statistics and sums do round differently, is held
    by test_group_depth_step). At group 4 the three scenes are one
    trailing group that does not split over two ranks: the run raises
    before it sets anything up, on both ranks."""
    one, two, tmp = runs["training"]
    assert all(r["agree"] for r in two)
    assert set(one["state"]) == {"occ", "vis"}
    for net, state in one["state"].items():
        for r in two:
            for k, v in state.items():
                torch.testing.assert_close(r["state"][net][k], v, rtol=0,
                                           atol=0, msg=f"{net}.{k}")
    assert two[0]["losses"] == two[1]["losses"]
    for ours, ref in zip(two[0]["losses"], one["losses"]):
        assert ours["occ"] == ref["occ"] and ours["cov"] == ref["cov"]
        # The depth loss is only reported (perfect depth): each rank's
        # share, added up.
        np.testing.assert_allclose(ours["depth"], ref["depth"], rtol=1e-6)
    assert len(one["losses"]) == 2
    assert all(row["occ"] > 0 and row["cov"] > 0 for row in one["losses"])
    # Every scene's memory, each written by the rank that trained it.
    for name in SCENES:
        for slot in ("0", "1"):
            frames = (tmp / "two" / "mem" / name / "macarons_memory"
                      / "training" / slot / "frames")
            assert len(list(frames.glob("*.npz"))) == 1 + 2 + 3 * 2
    assert one["trailing"] is None
    for r in two:
        assert "3 scenes ends in a group of 3, which does not divide " \
            "over the 2 ranks" in r["trailing"]


def memory_files(root):
    """Every file under a memory root: relative path -> its arrays."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            with np.load(os.path.join(d, f)) as z:
                out[os.path.relpath(os.path.join(d, f), root)] = dict(z)
    return out


def test_device_memory_training_two_ranks(runs):
    """run_training at group 2 with the device memory over two ranks against
    one process, with perfect depth, on three scenes and 2 slots: epochs
    0 and 1 in one run, then a resume that hydrates the memory (no epoch
    is left; test_group_training_two_ranks resumes training). The
    weights and SCONE losses are equal bit for bit (as with the disk
    memory), and so is every rank's memory after each epoch's exchange
    and after the resume's hydration: every key's frames, depths and
    snapshots. At each epoch's end a rank loads the slots the other rank
    captured, whose owners follow from the epoch's permutation of the
    seed; the files the ranks wrote are one process's. From the seeds, a
    scene trained by rank 0 in epoch 0 is trained by rank 1 in epoch 1,
    and rank 1's SCONE replay reads that slot."""
    one, two, tmp = runs["device_memory"]
    assert all(r["agree"] for r in two)
    assert set(one["state"]) == {"occ", "vis"}
    for net, state in one["state"].items():
        for r in two:
            for k, v in state.items():
                torch.testing.assert_close(r["state"][net][k], v, rtol=0,
                                           atol=0, msg=f"{net}.{k}")
    assert two[0]["losses"] == two[1]["losses"]
    assert len(one["losses"]) == 2
    for ours, ref in zip(two[0]["losses"], one["losses"]):
        assert ours["occ"] == ref["occ"] and ours["cov"] == ref["cov"]
        np.testing.assert_allclose(ours["depth"], ref["depth"], rtol=1e-6)
        assert ref["occ"] > 0 and ref["cov"] > 0
    assert set(one["memories"]) == {0, 1, "hydrated"}
    for when, ref in one["memories"].items():
        assert len(ref) == len(SCENES) * (1 if when == 0 else 2)
        for r in two:
            assert set(r["memories"][when]) == set(ref), when
            for key, state in ref.items():
                assert set(r["memories"][when][key]) == set(state)
                assert state["frames.images"].shape[0] == 1 + 2 + 3 * 2
                assert state["depths.depth"].shape[0] > 0
                for k, v in state.items():
                    torch.testing.assert_close(
                        r["memories"][when][key][k], v, rtol=0, atol=0,
                        msg=f"{when} {key} {k}")
    # The owners of each epoch's slots, from the seeds.
    owners = {}
    for epoch in range(2):
        order = np.random.default_rng([TRAIN["random_seed"],
                                       epoch]).permutation(len(SCENES))
        for g0 in range(0, len(order), 2):
            group = order[g0:g0 + 2]
            for si, r in zip(group, TM.group_owners(len(group), 2)):
                owners[(epoch, SCENES[si])] = r
        for r in (0, 1):
            got = two[r]["exchanges"][epoch]
            assert sorted(got["loaded"]) == sorted(
                (name, epoch % 2) for name in SCENES
                if owners[(epoch, name)] != r)
            assert got["written"] > 0 and got["read"] > 0
        assert one["exchanges"][epoch]["loaded"] == []
    moved = [name for name in SCENES
             if owners[(0, name)] == 0 and owners[(1, name)] == 1]
    assert moved
    assert any((1, name, 0) in two[1]["replays"] for name in moved)
    ours, ref = memory_files(tmp / "two" / "mem"), \
        memory_files(tmp / "one" / "mem")
    assert set(ours) == set(ref) and len(ref) > 100
    for f, arrays in ref.items():
        assert set(ours[f]) == set(arrays), f
        for k, v in arrays.items():
            np.testing.assert_array_equal(ours[f][k], v, err_msg=f"{f} {k}")


def test_lone_work_outlasts_the_group_timeout(tmp_path):
    """Rank 0 works alone for 2 s, past the group's 1 s timeout, while
    rank 1 waits in ``await_lone_work``; then a collective. A rank that
    waits for such work in a collective of the group times out."""
    out = spawn(ranks.lone_rank, 2, 2.0, 1.0,
                "file://" + str(tmp_path / "store"))
    assert [r["after"] for r in out] == [2.0, 2.0]
    assert out[0]["timed_out"] is None
    assert "Timed out" in out[1]["timed_out"]


def test_failing_rank_ends_the_run(runs):
    """A rank that raises ends the others (one waits in a collective) and
    the run raises within seconds; a run past its deadline is ended."""
    (error, seconds), (late, late_seconds), past = runs["failing"]
    assert "Process 1 terminated" in str(error) and seconds < 60
    assert not past.exists()
    assert isinstance(late, TimeoutError) and late_seconds < 30


def test_spawn_reports_the_first_failure(runs):
    """Both ranks raise, rank 0 a second after rank 1, and rank 0's
    process ends first, so the launcher sees its failure first: spawn
    raises rank 1's error, as ProcessRaisedException."""
    error, seconds = runs["both_fail"]
    assert isinstance(error, torch.multiprocessing.ProcessRaisedException)
    assert error.error_index == 1 and seconds < 60
    assert "-- Process 1 terminated" in str(error)
    assert "rank 1 fails first" in str(error)
    assert "rank 0 fails" not in str(error)


def test_launchers_from_the_environment(monkeypatch):
    """``initialize``'s sources, in order: torchrun's variables, then the
    JAX package's MACARONS_*, then SLURM's; none is a world of one, which
    starts no group; NCCL asks for CUDA ranks."""
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MACARONS_COORDINATOR",
                 "MACARONS_NUM_PROCESSES", "MACARONS_PROCESS_ID",
                 "SLURM_NTASKS", "SLURM_PROCID", "SLURM_LOCALID",
                 "SLURM_JOB_NODELIST"):
        monkeypatch.delenv(name, raising=False)
    assert distributed._from_environment() is None
    assert distributed.initialize(device="cpu") is False
    assert (distributed.rank(), distributed.world()) == (0, 1)
    assert distributed.is_master() and not distributed.active()
    distributed.shutdown()
    monkeypatch.setenv("SLURM_NTASKS", "8")
    monkeypatch.setenv("SLURM_PROCID", "5")
    monkeypatch.setenv("SLURM_LOCALID", "1")
    monkeypatch.setenv("SLURM_JOB_NODELIST", "node[3-4],node9")
    assert distributed._from_environment() == ("tcp://node:12355", 8, 5, 1)
    monkeypatch.setenv("MACARONS_NUM_PROCESSES", "2")
    monkeypatch.setenv("MACARONS_PROCESS_ID", "1")
    monkeypatch.setenv("MACARONS_COORDINATOR", "host:1234")
    assert distributed._from_environment() == ("tcp://host:1234", 2, 1, 1)
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "2")
    monkeypatch.setenv("LOCAL_RANK", "0")
    assert distributed._from_environment() == ("env://", 4, 2, 0)
    with pytest.raises(ValueError, match="NCCL needs CUDA"):
        distributed.initialize(backend="nccl", device="cpu")
