"""SconeOcc in bfloat16 (``occ_compute_dtype``,
``occ_supervision_compute_dtype``): the port's occupancy field against the
JAX package's ``occupancy_field_impl(..., compute_dtype="bfloat16")`` on
the CPU, at the same (converted) weights, at tiny widths, seeds 0-2.

The state: synth_00 after two random-policy poses of the port's tester
(the surface grid, the proxies, the prediction camera), handed to both
packages. Held, per seed: (a) the inference field, the top cells
(``full_field=False``) and the full field; (b) the supervision pass with
the JAX program's cell-ranking noise injected, its occupancy loss (the
trainer's) and the loss's gradient in SconeOcc's parameters.

The rule. Let e(A) be A's error from JAX float32: for outputs the max and
the mean |A - JAX float32| over the predicted proxies; for gradients max
and mean |A - JAX float32| over every parameter, over max |JAX float32|.
  1. e(port bfloat16) <= 2 e(JAX bfloat16) + 1e-3, max and mean.
  2. The port's mean gap to JAX bfloat16 is below half of e(JAX
     bfloat16)'s mean: the port computes what JAX computes in bfloat16,
     not float32 (whose gap to JAX bfloat16 is e(JAX bfloat16) itself).
  3. A forward hook on every ``Dense`` of SconeOcc sees bfloat16 weights,
     and inputs of the type JAX's Dense at the same path takes (traced,
     ``nn.intercept_methods``): bfloat16 in the point embeddings, the
     attention's q/k/v and the query embedding. JAX divides the attention
     scores by a NumPy float64 scalar, which it does not type weakly, so
     from there on its stream is float32 (the value product, the residual
     stream, the pools, the head), and so is the port's.
Checks 2 and 3 keep a float32 path from passing as bfloat16.

JAX bfloat16 is held as its program is written: every bfloat16 op rounds
(compiled with ``xla_allow_excess_precision`` off; XLA's CPU default may
keep float32 where the program rounds, which moves the field by as much as
bfloat16 does), and SconeOcc's kNN takes ``jax.lax.top_k``
(``approx_knn=False``): ``approx_min_k`` falls back on the CPU to an
unstable sort, whose order among equal bfloat16 distances is unspecified;
the port takes the lower index first, as ``top_k`` does. The JAX field as
it ships (both defaults) is held by the mean of rule 1.

(c) ``MacaronsRuntime`` with the keys absent, None and "float32": the
fields compute bit for bit what a field without ``compute_dtype`` does,
on SconeOcc's own parameters (no copy, no cast). The kNN case: bfloat16
clouds with planted ties, masked past the 12,000-odd points where
bfloat16 pads would overflow, against JAX's masked kNN.
"""

import contextlib
import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from macarons_tpu.models import attention as jattention
from macarons_tpu.models.scone import SconeOcc as JSconeOcc
from macarons_tpu.ops import knn as jknn
from macarons_tpu.scene import runtime as jR
from macarons_tpu.scene.grid import GridState as JGridState
from macarons_tpu.scene.proxy import ProxyState as JProxyState
from macarons_tpu.ops.geometry import FoVCamera as JFoVCamera
from macarons_tpu_torch.config import Params
from macarons_tpu_torch.data.scenes import SceneDataset
from macarons_tpu_torch.models.attention import Dense
from macarons_tpu_torch.models.macarons import MacaronsModel
from macarons_tpu_torch.models.scone import SconeOcc, SconeVis
from macarons_tpu_torch.ops import knn
from macarons_tpu_torch.scene import runtime as R
from macarons_tpu_torch.scene.memory import Memory
from macarons_tpu_torch.testers import scene as tester
from macarons_tpu_torch.trainers import train_macarons as TM
from macarons_tpu_torch.utils.convert import flax_to_torch
from torch_port_helpers import OCC_KW, TINY, VIS_KW, make_scene_root, \
    random_flax_variables, torch_one_thread  # noqa: F401

SEEDS = (0, 1, 2)
# Surface cells of 48 points: neighbourhoods of 1,296 (27 x 48). Each
# pass is one batched SconeOcc call (cell_batch covers the cells of a pass):
# the 8 top cells of 48, every eligible cell in one chunk of 32, the
# supervision pass's 4 cells, 3 of them kept.
STATE = dict(TINY, surface_cell_capacity=48)
FIELDS = {
    False: dict(max_cells=8, cell_batch=8),
    True: dict(max_cells=8, full_field_chunk=32, cell_batch=32),
    "supervision": dict(max_cells=4, cell_batch=4)}
# The same fields as MacaronsRuntime builds them from a config.
RUNTIME_FIELDS = dict(n_cell_per_occ_forward_pass=8, occ_full_field_chunk=32,
                      occ_cell_batch=32, occ_curriculum_max_cells=4,
                      occ_supervision_cell_batch=4)
SUP_CELLS, N_ACTIVE, N_SUP = 4, 3, 200
NO_EXCESS = {"xla_allow_excess_precision": False}


def field_kw(kind):
    return dict(FIELDS[kind], n_elev=7, n_azim=14, degree=8,
                k_for_knn=TINY["k_for_knn"])


@functools.lru_cache(maxsize=None)
def weights(seed):
    return random_flax_variables(JSconeOcc(**OCC_KW), seed,
                                 jnp.zeros((1, 300, 3)), jnp.zeros((1, 8, 3)),
                                 jnp.zeros((1, 8, 64)))


def port_occ(variables):
    occ = SconeOcc(**OCC_KW).eval()
    occ.load_state_dict(flax_to_torch(variables))
    return occ


@pytest.fixture(scope="module")
def state(tmp_path_factory):
    """The port's scene after two random poses, in both packages' types."""
    root = make_scene_root(tmp_path_factory)
    params = Params(dict(STATE, data_path=root))
    item = SceneDataset(root)[0]
    gen = torch.Generator().manual_seed(5)
    scene = TM.setup_scene(params, item, gen, "cpu")
    model = MacaronsModel(port_occ(weights(0)), SconeVis(**VIS_KW).eval(),
                          None)
    rt = TM.MacaronsRuntime(params, model, scene.cfg, scene.cell_table, "cpu")
    mem = str(tmp_path_factory.mktemp("memory"))
    tester.compute_trajectory(
        rt, scene, Memory([mem]), mem, gen, np.random.default_rng(42),
        n_poses=2, surface_epsilon=0.15,
        start_idx=np.asarray(item["settings"].start_positions[0]),
        policy="random")
    proxy, surface = scene.proxy, scene.surface_scene
    cam = scene.camera.fov_camera_0
    close = (proxy.out_of_field[:, 0] < 1.0) & torch.as_tensor(
        np.random.default_rng(11).uniform(size=proxy.points.shape[0]) < 0.7)
    sup_occ = torch.as_tensor((np.random.default_rng(12).uniform(
        size=(proxy.points.shape[0], 1)) < 0.5).astype(np.float32))
    ours = (proxy, surface, rt._tables, cam)
    theirs = (JProxyState(*(np.asarray(a) for a in proxy)),
              JGridState(*(np.asarray(a) for a in surface)),
              jR.device_cell_tables(scene.cfg, scene.cell_table, 3.0),
              JFoVCamera(*(np.asarray(getattr(cam, f))
                           for f in JFoVCamera._fields)))
    return dict(ours=ours, theirs=theirs, close=close, sup_occ=sup_occ)


def jax_impl(dtype, exact=True, full=True, supervision=False):
    """The JAX package's field program: SconeOcc with top_k (exact) or
    approx_min_k, at the supervision pass's widths with remat."""
    return jR.occupancy_field_impl(JSconeOcc(**OCC_KW, approx_knn=not exact),
                                   compute_dtype=dtype, remat=supervision,
                                   **field_kw(supervision or full))


def occ_loss(proba, mask, sup_occ, xp):
    """The trainer's occupancy loss (MacaronsRuntime.scone_losses)."""
    err = xp.where(mask[:, None], (proba - sup_occ) ** 2, 0.0)
    n = mask.sum()
    return err.sum() / (n + (n == 0)) * n / N_SUP


@pytest.fixture(scope="module")
def jax_refs(state):
    """The JAX programs' results, by (seed, program): the fields (proba,
    mask, harmonics) in float32 ("f32"), in bfloat16 as written ("bf16")
    and as it ships ("shipped", full field only), each at full_field False
    and True; the supervision pass's (loss, mask, SconeOcc gradient) in
    float32 and bfloat16 ("sup_f32", "sup_bf16"). Also its cell-ranking
    noise ("noise") and the input type of every Dense of SconeOcc in the
    bfloat16 full field, by path ("dense", recorded while it is traced).
    Each program compiles while the next one is traced; they run side by
    side."""
    close, sup_occ = state["close"].numpy(), state["sup_occ"].numpy()
    key = jax.random.PRNGKey(7)
    n_cells = state["theirs"][2].slots.shape[0]
    field_args = (weights(0), *state["theirs"], jax.random.PRNGKey(0))
    dense = {}

    def record(next_fun, args, kwargs, context):
        if (isinstance(context.module, jattention.Dense)
                and context.method_name == "__call__"):
            dense.setdefault(".".join(context.module.path), set()).add(
                torch.bfloat16 if args[0].dtype == jnp.bfloat16
                else torch.float32)
        return next_fun(*args, **kwargs)

    def loss_of(impl):
        def loss(params):
            proba, mask, _ = impl({"params": params}, *state["theirs"], key,
                                  supervision=True, eligible_override=close,
                                  n_cells_active=N_ACTIVE)
            return occ_loss(proba, mask, sup_occ, jnp), mask
        return loss

    def run(job):
        program, seed = job
        prog = compiled[program].result()
        if isinstance(program, tuple):
            return [np.asarray(a) for a in prog(
                weights(seed), *state["theirs"], jax.random.PRNGKey(0))]
        (value, mask), grads = prog(weights(seed)["params"])
        return (float(value), np.asarray(mask),
                flax_to_torch({"params": grads}))

    compiled = {}
    with ThreadPoolExecutor(8) as pool:
        for name, dtype, exact in (("bf16", "bfloat16", True),
                                   ("f32", None, True),
                                   ("shipped", "bfloat16", False)):
            for full in (True, False) if exact else (True,):
                traced = (name, full) == ("bf16", True)
                with (fnn.intercept_methods(record) if traced
                      else contextlib.nullcontext()):
                    lowered = jax_impl(dtype, exact, full).lower(
                        *field_args, full_field=full)
                compiled[name, full] = pool.submit(
                    lowered.compile, NO_EXCESS if exact else None)
        for name, dtype in (("sup_f32", None), ("sup_bf16", "bfloat16")):
            loss = loss_of(jax_impl(dtype, supervision="supervision"))
            compiled[name] = pool.submit(jax.jit(jax.value_and_grad(
                loss, has_aux=True)).lower(weights(0)["params"]).compile,
                NO_EXCESS)
        jobs = [(k, seed) for k in compiled for seed in SEEDS]
        out = dict(zip([(seed, k) for k, seed in jobs], pool.map(run, jobs)))
    out["noise"] = np.array(jax.random.uniform(key, (n_cells,)))
    out["dense"] = dense
    return out


def errors(a, ref):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(ref, np.float64))
    return float(d.max()), float(d.mean())


def hold_rule(ours, jax16, jax32, shipped=None):
    """Rules 1 and 2 on arrays of one output; returns the errors."""
    e_port, e_jax = errors(ours, jax32), errors(jax16, jax32)
    gap = errors(ours, jax16)[1]
    assert e_jax[1] > 0, "JAX's bfloat16 equals its float32"
    for mine, theirs in zip(e_port, e_jax):
        assert mine <= 2 * theirs + 1e-3, (e_port, e_jax)
    assert gap < 0.5 * e_jax[1], (gap, e_jax)
    if shipped is not None:
        assert e_port[1] <= 2 * errors(shipped, jax32)[1] + 1e-3
    return e_port, e_jax, gap


class dense_dtypes:
    """The (input, weight) types every Dense of ``net`` sees while the
    block runs, by path."""

    def __init__(self, net):
        self.seen = {}
        self.hooks = [m.register_forward_hook(
            lambda mod, args, out, name=name: self.seen.setdefault(
                name, set()).add((args[0].dtype, mod.weight.dtype)))
            for name, m in net.named_modules() if isinstance(m, Dense)]

    def __enter__(self):
        return self.seen

    def __exit__(self, *exc):
        for h in self.hooks:
            h.remove()


@pytest.mark.parametrize("full", [False, True], ids=["top_cells", "full"])
@pytest.mark.parametrize("seed", SEEDS)
def test_inference_field_bf16(state, jax_refs, seed, full):
    occ = port_occ(weights(seed))
    field = R.OccupancyField(occ, compute_dtype="bfloat16", **field_kw(full))
    with dense_dtypes(occ) as seen:
        proba, mask, harm = field(*state["ours"], full_field=full)
    ref32, ref16 = jax_refs[seed, ("f32", full)], jax_refs[seed, ("bf16",
                                                                 full)]
    shipped = jax_refs.get((seed, ("shipped", full)))
    np.testing.assert_array_equal(mask.numpy(), ref32[1])
    np.testing.assert_array_equal(mask.numpy(), ref16[1])
    m = ref32[1]
    assert m.sum() > 50 and proba.dtype == torch.float32
    hold_rule(proba.numpy()[m], ref16[0][m], ref32[0][m],
              None if shipped is None else shipped[0][m])
    # The view harmonics stay float32: the float32 field's, bit for bit.
    _, _, harm32 = R.OccupancyField(occ, **field_kw(full))(*state["ours"],
                                                           full_field=full)
    assert harm.dtype == torch.float32 and torch.equal(harm, harm32)
    np.testing.assert_allclose(harm.numpy(), ref16[2], atol=1e-5)
    # Rule 3.
    jax_dense_inputs = jax_refs["dense"]
    assert set(seen) == set(jax_dense_inputs)
    for name, kinds in seen.items():
        assert {w for _, w in kinds} == {torch.bfloat16}, name
        assert {x for x, _ in kinds} == jax_dense_inputs[name], name
    assert sum(torch.bfloat16 in v for v in jax_dense_inputs.values()) >= 10


@pytest.mark.parametrize("seed", SEEDS)
def test_supervision_bf16(state, jax_refs, seed):
    occ = port_occ(weights(seed))
    field = R.OccupancyField(occ, compute_dtype="bfloat16",
                             **field_kw("supervision"))
    with dense_dtypes(occ) as seen:
        proba, mask, _ = field.supervise(
            *state["ours"], eligible_override=state["close"],
            n_cells_active=N_ACTIVE,
            noise=torch.as_tensor(jax_refs["noise"]))
    loss = occ_loss(proba, mask, state["sup_occ"], torch)
    loss.backward()
    (l32, m32, g32), (l16, _, g16) = (jax_refs[seed, n]
                                      for n in ("sup_f32", "sup_bf16"))
    np.testing.assert_array_equal(mask.numpy(), m32)
    assert int(mask.sum()) > 20
    hold_rule(np.array([float(loss.detach())]), np.array([l16]),
              np.array([l32]))
    names = sorted(g32)
    scale = max(float(g32[n].abs().max()) for n in names)
    flat = {k: np.concatenate([v[n].numpy().ravel() / scale for n in names])
            for k, v in (("32", g32), ("16", g16))}
    ours = np.concatenate([dict(occ.named_parameters())[n].grad.numpy()
                           .ravel() / scale for n in names])
    assert all(p.grad.dtype == torch.float32 for p in occ.parameters())
    hold_rule(ours, flat["16"], flat["32"])
    assert {w for kinds in seen.values() for _, w in kinds} == \
        {torch.bfloat16}


@pytest.mark.parametrize("value", ["absent", None, "float32", "none"])
def test_runtime_float32_unchanged(state, value):
    """The keys absent, None, "float32" or "none": both fields run the
    float32 path on SconeOcc's own parameters and give what a field built
    without compute_dtype gives, bit for bit."""
    keys = {} if value == "absent" else {
        "occ_compute_dtype": value, "occ_supervision_compute_dtype": value}
    occ = port_occ(weights(1))
    rt = TM.MacaronsRuntime(Params(dict(TINY, **RUNTIME_FIELDS, **keys)),
                            MacaronsModel(occ, SconeVis(**VIS_KW), None),
                            device="cpu")
    assert rt._occ_field.compute_dtype is None
    assert rt._occ_field_sup.compute_dtype is None
    proxy, surface, tables, cam = state["ours"]
    params = dict(occ.named_parameters())
    own = []

    def check_own(mod, args, out):
        own.append(mod.weight is params[names[mod] + ".weight"]
                   and mod.bias is params[names[mod] + ".bias"])

    names = {m: n for n, m in occ.named_modules() if isinstance(m, Dense)}
    hooks = [m.register_forward_hook(check_own) for m in names]
    try:
        got = rt._occ_field(proxy, surface, tables, cam, full_field=True)
        noise = torch.as_tensor(np.random.default_rng(3).uniform(
            size=tables.slots.shape[0]).astype(np.float32))
        sup = rt._occ_field_sup.supervise(
            proxy, surface, tables, cam, eligible_override=state["close"],
            n_cells_active=N_ACTIVE, noise=noise)
    finally:
        for h in hooks:
            h.remove()
    assert own and all(own)
    want = R.OccupancyField(occ, **field_kw(True))(proxy, surface, tables,
                                                   cam, full_field=True)
    want_sup = R.OccupancyField(occ, **field_kw("supervision")).supervise(
        proxy, surface, tables, cam, eligible_override=state["close"],
        n_cells_active=N_ACTIVE, noise=noise)
    for a, b in zip(got + sup, want + want_sup):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_compute_dtype_names():
    """bfloat16 by name on both fields; a name torch does not know as a
    floating type raises at construction."""
    rt = TM.MacaronsRuntime(
        Params(dict(TINY, **RUNTIME_FIELDS, occ_compute_dtype="bfloat16",
                    occ_supervision_compute_dtype="bfloat16")),
        MacaronsModel(SconeOcc(**OCC_KW), SconeVis(**VIS_KW), None),
        device="cpu")
    assert rt._occ_field.compute_dtype == torch.bfloat16
    assert rt._occ_field_sup.compute_dtype == torch.bfloat16
    for name in ("bfloat61", "int32", "Tensor"):
        with pytest.raises(TypeError):
            R.OccupancyField(None, compute_dtype=name)


def knn_cases(rng):
    """bfloat16 (x, pc, mask, k): duplicated points and a lattice (ties at
    the k-th distance), and a masked cloud of 13,000 points with fewer than
    k valid ones for some queries (the pads reach the result)."""
    p = rng.normal(size=(2, 60, 3))
    dup = np.concatenate([p, p, p], axis=1)[:, rng.permutation(180)]
    g = np.arange(-2, 3)
    lat = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(1, -1, 3)
    q_lat = np.concatenate([lat[:, ::7], lat[:, 3:40:9] + 0.5], axis=1)
    big = rng.uniform(-1, 1, size=(2, 13000, 3))
    mask = np.zeros((2, 13000), bool)
    mask[0, rng.choice(13000, 5, replace=False)] = True
    mask[1, ::97] = True
    return {
        "duplicates": (rng.normal(size=(2, 40, 3)), dup,
                       np.ones((2, 180), bool), 8),
        "lattice": (q_lat * 0.25, lat * 0.25, np.ones((1, 125), bool), 10),
        "masked 13,000": (rng.uniform(-1, 1, size=(2, 30, 3)), big, mask, 8),
    }


@pytest.mark.parametrize("case", ["duplicates", "lattice", "masked 13,000"])
def test_knn_bf16(case):
    """The port's bfloat16 kNN against JAX's masked kNN (top_k, eager:
    every bfloat16 op rounds): the same indices, lower index first at
    ties, the same neighbours and distances; pads get JAX's bfloat16
    1e10."""
    x, pc, mask, k = knn_cases(np.random.default_rng(4))[case]
    xb, pcb = (jnp.asarray(a, jnp.bfloat16) for a in (x, pc))
    jg, jd, ji, _ = jknn.knn_points_masked(xb, pcb, k, pc_mask=mask,
                                           approx=False)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32)).bfloat16()

    g, d, i = knn.knn_points(t(xb), t(pcb), k, pc_mask=torch.as_tensor(mask))
    d2 = knn.pairwise_sqdist(t(xb), t(pcb)).float()
    d2 = torch.where(torch.as_tensor(mask)[..., None, :], d2, np.inf)
    kth = torch.sort(d2, dim=-1).values[..., k - 1:k + 1]
    assert bool((kth[..., 0] == kth[..., 1]).any()) or case.startswith("m")
    assert d.dtype == g.dtype == torch.bfloat16
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(g.float().numpy(),
                                  np.asarray(jg, np.float32))
    np.testing.assert_array_equal(d.float().numpy(),
                                  np.asarray(jd, np.float32))
    if case.startswith("m"):
        pads = ~np.take_along_axis(mask[:, None, :], i.numpy(), -1)
        assert pads.any()
        assert (d.float().numpy()[pads]
                == float(jnp.sqrt(jnp.asarray(1e10, jnp.bfloat16)))).all()
