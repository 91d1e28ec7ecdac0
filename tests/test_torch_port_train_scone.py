"""The trainer's SCONE step: the port against the JAX package on the CPU.

A scene state from two random-policy poses of the port's tester on
synth_00 (tiny widths), handed to both packages: one SCONE optimizer step
of the port's ``MacaronsRuntime.scone_train_step`` against the JAX trainer's
``scone_train_step`` at converted weights, with the JAX step's draws
injected into the port (the supervision pass's cell-ranking noise and the
coverage scorer's Monte-Carlo sample indices, from the JAX step's own key
split). Held: the occupancy and coverage losses (rtol 1e-4), every
gradient of SconeOcc and SconeVis (within 1e-3 x max|g| of each network),
and the parameters after AdamW where |g| > 1e-3 x max|g|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from macarons_tpu.config import Params as JParams
from macarons_tpu.models.macarons import MacaronsModel as JMacaronsModel
from macarons_tpu.models.scone import SconeOcc as JSconeOcc
from macarons_tpu.models.scone import SconeVis as JSconeVis
from macarons_tpu.ops.geometry import FoVCamera as JFoVCamera
from macarons_tpu.ops.projection import points_in_fov_mask as jfov_mask
from macarons_tpu.ops.view_state import sample_proxy_points as jsample
from macarons_tpu.scene import grid as jG
from macarons_tpu.scene import proxy as jP
from macarons_tpu.scene import runtime as jR
from macarons_tpu.trainers import train_macarons as JTM
from macarons_tpu_torch.config import Params
from macarons_tpu_torch.data.scenes import SceneDataset
from macarons_tpu_torch.models.macarons import MacaronsModel, \
    create_optimizers
from macarons_tpu_torch.models.scone import SconeOcc, SconeVis
from macarons_tpu_torch.ops.geometry import FoVCamera
from macarons_tpu_torch.scene import runtime as R
from macarons_tpu_torch.scene.camera import get_camera_RT
from macarons_tpu_torch.scene.memory import Memory
from macarons_tpu_torch.testers import scene as tester
from macarons_tpu_torch.trainers import train_macarons as TM
from macarons_tpu_torch.utils.convert import flax_to_torch
from torch_port_helpers import OCC_KW, TINY, VIS_KW, make_scene_root, \
    random_flax_variables, torch_one_thread  # noqa: F401

SCONE = dict(occ_curriculum_max_cells=4,
             n_proxy_point_for_occupancy_supervision=200)
N_ACTIVE = 3
N_SUP = SCONE["n_proxy_point_for_occupancy_supervision"]
GRAD_REL = 1e-3


def arrays(state):
    return [np.asarray(a) for a in state]


@pytest.fixture(scope="module")
def scone_inputs(tmp_path_factory):
    """The port's scene after two random poses, SCONE weights for both
    packages, and the step's other inputs made from a seed."""
    root = make_scene_root(tmp_path_factory)
    params = Params(dict(TINY, data_path=root, **SCONE))
    item = SceneDataset(root)[0]
    gen = torch.Generator().manual_seed(5)
    scene = TM.setup_scene(params, item, gen, "cpu")
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
    model = MacaronsModel(occ.eval(), vis.eval(), None)
    rt = TM.MacaronsRuntime(params, model, scene.cfg, scene.cell_table, "cpu")
    mem = str(tmp_path_factory.mktemp("memory"))
    tester.compute_trajectory(
        rt, scene, Memory([mem]), mem, gen, np.random.default_rng(42),
        n_poses=2, surface_epsilon=0.15,
        start_idx=np.asarray(item["settings"].start_positions[0]),
        policy="random")

    rs = np.random.default_rng(11)
    proxy = scene.proxy
    N = proxy.points.shape[0]
    in_field = proxy.out_of_field[:, 0] < 1.0
    cam = scene.camera
    nbrs = cam.get_valid_neighbors(cam.get_neighboring_poses(),
                                   scene.verts_dev)[:4]
    poses = torch.as_tensor(cam.pose_space.pose_from_idx(nbrs))
    R_v, T_v = get_camera_RT(poses[:, :3], poses[:, 3:])
    harm = torch.as_tensor(rs.normal(size=(N, 64)).astype(np.float32) * 0.3)
    inputs = dict(
        proxy=proxy, surface=scene.surface_scene,
        prediction_camera=cam.fov_camera,
        close_mask=in_field & torch.as_tensor(rs.uniform(size=N) < 0.7),
        visited_R=R_v, visited_T=T_v, visited_X=poses[:, :3],
        supervision_gains=torch.as_tensor(
            rs.uniform(1.0, 10.0, size=4).astype(np.float32)),
        field=R.assemble_scene_field(proxy, proxy.supervision_occ, in_field,
                                     harm),
        sup_occ=torch.as_tensor(
            (rs.uniform(size=(N, 1)) < 0.5).astype(np.float32)),
        box_diag=float(np.linalg.norm(np.asarray(scene.cfg.x_max)
                                      - np.asarray(scene.cfg.x_min))),
        cell_resolution=scene.cfg.resolution)
    assert int(inputs["close_mask"].sum()) > 100 and len(nbrs) == 4
    return params, root, scene, rt, occ_vars, vis_vars, inputs


def jax_draws(jparams, field, cams, key, n_cells):
    """The draws of the JAX step (runtime.py:344, 476-487): the cell ranking
    noise from k_occ and each visited camera's MC sample from k_cov."""
    k_occ, k_cov = jax.random.split(key)
    X_world, harm, occ, valid = field
    S, min_occ = jparams.seq_len, jparams.min_occ_for_proxy_points

    def one(R, T, fov, zfar, k):
        cam = JFoVCamera(R[None], T[None], fov[None], zfar[None] * 0 + 0.01,
                         zfar[None], jnp.ones_like(fov)[None])
        sel = jfov_mask(X_world[None], cam, jparams.image_height,
                        jparams.image_width,
                        fov_range=jparams.sensor_range)[0] & valid
        sel = sel & (occ[:, 0] > min_occ)
        return jsample(k, X_world, occ, harm, S, min_occ, valid_mask=sel)[2]

    keys = jax.random.split(k_cov, cams.R.shape[0])
    idx = jax.vmap(one)(cams.R, cams.T, cams.fov, cams.zfar, keys)
    return np.array(jax.random.uniform(k_occ, (n_cells,))), np.array(idx)


def with_grads(tx):
    """``tx`` passing each step's gradient out through its state."""
    return optax.GradientTransformation(
        lambda p: (tx.init(p), p),
        lambda g, s, p: (tx.update(g, s[0], p)[0], (s[0], g)))


def check_network(module, jgrads, jnew, rel=GRAD_REL):
    """Gradients within rel x max|g| of the network; parameters after
    AdamW where |g| > rel x max|g| (Adam's first step is ~lr sign(g))."""
    ref_g = flax_to_torch({"params": jgrads})
    ref_p = flax_to_torch({"params": jnew})
    named = dict(module.named_parameters())
    assert set(named) == set(ref_g)
    scale = max(float(np.abs(g.numpy()).max()) for g in ref_g.values())
    assert scale > 0
    n_checked = 0
    for name, p in named.items():
        g = ref_g[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=0,
                                   atol=rel * scale, err_msg=name)
        sel = np.abs(g) > rel * scale
        np.testing.assert_allclose(p.detach().numpy()[sel],
                                   ref_p[name].numpy()[sel], rtol=0,
                                   atol=1e-6, err_msg=name)
        n_checked += int(sel.sum())
    assert n_checked > 100


def test_scone_train_step(scone_inputs):
    params, root, scene, rt, occ_vars, vis_vars, x = scone_inputs
    jparams = JParams(dict(TINY, data_path=root, **SCONE))
    jcfg = jG.GridConfig(*scene.cfg)
    jmodel = JMacaronsModel(None, JSconeOcc(**OCC_KW), JSconeVis(**VIS_KW))
    jrt = JTM.MacaronsRuntime(jparams, jmodel, jcfg,
                              jR.CellIndexTable(*scene.cell_table))
    jrt.scone_tx = with_grads(jrt.scone_tx)
    jcams = JFoVCamera.create(x["visited_R"].numpy(), x["visited_T"].numpy(),
                              zfar=jparams.zfar)
    jfield = tuple(jnp.asarray(t.numpy()) for t in x["field"])
    key = jax.random.PRNGKey(3)
    n_cells = scene.cell_table.proxy_slots.shape[0]
    noise, idx = jax_draws(jparams, jfield, jcams, key, n_cells)

    ps = {"occ": occ_vars["params"], "vis": vis_vars["params"]}
    new_occ, new_vis, (_, jgrads), jloss, jocc_loss, jcov_loss = \
        jrt.scone_train_step(
            occ_vars, vis_vars, jrt.scone_tx.init(ps),
            jP.ProxyState(*arrays(x["proxy"])),
            jG.GridState(*arrays(x["surface"])),
            JFoVCamera(*(np.asarray(getattr(x["prediction_camera"], f))
                         for f in JFoVCamera._fields)),
            x["close_mask"].numpy(), jcams, x["visited_X"].numpy(),
            x["supervision_gains"].numpy(), jfield, key, n_supervision=N_SUP,
            box_diag=x["box_diag"], cell_resolution=x["cell_resolution"],
            n_cells_active=N_ACTIVE, sup_occ=x["sup_occ"].numpy())

    opts = create_optimizers(params, rt.model)
    loss, occ_loss, cov_loss = rt.scone_train_step(
        opts["scone"], x["proxy"], x["surface"], x["prediction_camera"],
        x["close_mask"],
        FoVCamera.create(x["visited_R"], x["visited_T"], zfar=params.zfar),
        x["visited_X"], x["supervision_gains"], x["field"], N_SUP,
        x["box_diag"], x["cell_resolution"], n_cells_active=N_ACTIVE,
        sup_occ=x["sup_occ"], cell_noise=torch.as_tensor(noise),
        sample_idx=torch.as_tensor(idx))
    assert float(jocc_loss) > 0 and float(jcov_loss) > 0
    np.testing.assert_allclose(float(occ_loss), float(jocc_loss), rtol=1e-4)
    np.testing.assert_allclose(float(cov_loss), float(jcov_loss), rtol=1e-4)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    check_network(rt.model.occ, jgrads["occ"], new_occ["params"])
    check_network(rt.model.vis, jgrads["vis"], new_vis["params"])


def test_supervision_pass_curriculum(scone_inputs):
    """The supervision pass keeps the first n_cells_active of the randomly
    ranked non-empty cells, and only eligible proxies of them."""
    _, _, scene, rt, _, _, x = scone_inputs
    n_cells = scene.cell_table.proxy_slots.shape[0]
    noise = torch.as_tensor(np.random.default_rng(2).uniform(size=n_cells),
                            dtype=torch.float32)
    field = rt._occ_field_sup
    masks = []
    for n_active in (1, 2, 4):
        with torch.no_grad():
            _, mask, _ = field.supervise(
                x["proxy"], x["surface"], rt._tables, x["prediction_camera"],
                eligible_override=x["close_mask"], n_cells_active=n_active,
                noise=noise)
        masks.append(mask)
        assert not (mask & ~x["close_mask"]).any()
    assert 0 < int(masks[0].sum()) < int(masks[1].sum()) < int(masks[2].sum())
    assert not (masks[0] & ~masks[1]).any()
