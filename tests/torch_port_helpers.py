"""Shared inputs for the PyTorch-port parity tests (tests/test_torch_port_*.py).

A tiny synthetic scene and tester config, and converters that carry the JAX
package's state into the port as numpy arrays.
"""

import numpy as np
import pytest
import torch

TINY = dict(
    image_height=32, image_width=48, znear=0.5, zfar=40.0, n_alpha=2,
    n_alpha_for_supervision=2, alphas=[-2, -1], n_interpolation_steps=2,
    n_proxy_points=2000, seq_len=256, n_gt_surface_points=4096,
    surface_cell_resolution=0.15, test_resolution=0.075,
    view_state_n_elev=7, view_state_n_azim=14, harmonic_degree=8,
    k_for_knn=8, n_cell_per_occ_forward_pass=8, occ_cell_batch=2,
    min_occ_for_proxy_points=0.1, use_occ_to_sample_proxy_points=True,
    use_sigmoid=True, sensor_range=48.0, gathering_factor=0.1,
    scene_scale_factor=1.0, random_seed=42, torch_seed=5,
    use_perfect_depth=True, use_supervision_occ=True,
    data_augmentation=False, load_obj_textures=False,
)


@pytest.fixture(scope="module", autouse=True)
def torch_one_thread():
    """Run the port's tiny CPU ops on one thread: the suite runs in several
    worker processes at once, and torch's per-op thread pools oversubscribe
    the cores at these sizes. Import it into a test module to apply it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# Narrow SCONE widths shared by the JAX and the port's networks in the tests.
OCC_KW = dict(seq_len=256, pts_embedding_dim=32, n_code=1, n_heads=2,
              global_feature_dim=64, n_scale=3, local_feature_dim=32,
              k_for_knn=8, x_embedding_dim=64)
VIS_KW = dict(pts_embedding_dim=64, n_heads=2, n_code=2)


def random_flax_variables(module, seed, *init_args):
    """A Flax variables dict for ``module`` with seeded numpy weights.

    The tree's layout comes from ``jax.eval_shape`` of ``module.init`` (no
    compile); kernels are N(0, 1/fan_in) (a conv kernel (kh, kw, in, out)
    has fan-in kh kw in), biases N(0, 0.1^2), LayerNorm and BatchNorm
    scales 1 + N(0, 0.1^2); BatchNorm statistics have means N(0, 0.1^2) and
    variances 1 + 0.1 |N(0, 1)|."""
    import jax

    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *init_args)
    rs = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        z = rs.normal(size=leaf.shape).astype(np.float32)
        if name == "kernel":
            return z / np.sqrt(np.prod(leaf.shape[:-1]) if len(leaf.shape) == 4
                               else leaf.shape[0])
        if name == "var":
            return 1.0 + 0.1 * np.abs(z)
        return 1.0 + 0.1 * z if name == "scale" else 0.1 * z

    return jax.tree_util.tree_map_with_path(draw, shapes)


def make_scene_root(tmp_path_factory):
    from macarons_tpu_torch.data.synthetic_suite import generate_suite

    return generate_suite(str(tmp_path_factory.mktemp("scenes")), n_scenes=1)


def to_torch(x, dtype=None):
    t = torch.as_tensor(np.array(x))
    return t if dtype is None else t.to(dtype)


def proxy_to_torch(proxy):
    from macarons_tpu_torch.scene.proxy import ProxyState

    return ProxyState(*(to_torch(a) for a in proxy))


def grid_to_torch(state):
    from macarons_tpu_torch.scene.grid import GridState

    return GridState(*(to_torch(a) for a in state))


def camera_to_torch(cam):
    from macarons_tpu_torch.ops.geometry import FoVCamera

    return FoVCamera(*(to_torch(a) for a in cam))


def make_shapenet_root(tmp_path_factory, n_meshes=8):
    """A ShapeNet-format root of ``n_meshes`` boxes with the port's GT, at
    the conftest ``shapenet_root``'s sizes and split layout (that fixture
    builds its GT with the JAX package, ~100 s on an 8-core sandbox)."""
    import json

    from macarons_tpu_torch.data import shapenet as sng

    root = tmp_path_factory.mktemp("shapenet_port")
    cfg = sng.ShapeNetGTConfig(
        n_points_surface=256, part_pc_length=128, n_samples_for_occupancy=400,
        n_max_samples=800, image_size=48, surface_epsilon=0.1)
    corners = torch.tensor([[x, y, z] for x in (-1.0, 1.0)
                            for y in (-1.0, 1.0) for z in (-1.0, 1.0)])
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6),
             (0, 2, 6, 4), (1, 5, 7, 3)]
    faces = torch.tensor([f for a, b, c, d in quads
                          for f in ((a, b, c), (a, c, d))])
    gen = torch.Generator().manual_seed(7)
    models = []
    for i in range(n_meshes):
        verts = sng.adjust_mesh_diagonally(
            corners * torch.tensor([1.0, 0.6 + 0.1 * i, 0.8]), 1.0)
        mdir = root / "02000000" / f"model_{i}"
        mdir.mkdir(parents=True)
        (mdir / "model.obj").write_text("# placeholder\n")
        sng.save_mesh_gt(sng.generate_mesh_gt(gen, verts, faces, cfg),
                         str(mdir / "tensors"))
        models.append(f"02000000/model_{i}/model.obj")
    for split in ("train_list.json", "val_list.json", "all_test_list.json"):
        (root / split).write_text(json.dumps({"models": models}))
    return str(root)


def resnet18_state_dict(seed):
    """A torchvision-keyed resnet18 state dict of seeded random tensors
    (conv weights of variance ~1 / fan_in, BatchNorms near identity, the
    classifier too), as ``torchvision.models.resnet18().state_dict()``
    names them."""
    rs = np.random.default_rng(seed)
    sd = {}

    def conv(name, o, i, k):
        sd[name] = rs.normal(size=(o, i, k, k)) / np.sqrt(i * k * k)

    def bn(name, c):
        sd.update({f"{name}.weight": 1 + 0.1 * rs.normal(size=c),
                   f"{name}.bias": 0.1 * rs.normal(size=c),
                   f"{name}.running_mean": 0.1 * rs.normal(size=c),
                   f"{name}.running_var": 1 + 0.1 * rs.uniform(size=c)})
        sd[f"{name}.num_batches_tracked"] = torch.tensor(7)

    conv("conv1.weight", 64, 3, 7)
    bn("bn1", 64)
    chans = [64, 64, 128, 256, 512]
    for li in range(1, 5):
        for b in range(2):
            cin = chans[li - 1] if b == 0 else chans[li]
            p = f"layer{li}.{b}"
            conv(f"{p}.conv1.weight", chans[li], cin, 3)
            bn(f"{p}.bn1", chans[li])
            conv(f"{p}.conv2.weight", chans[li], chans[li], 3)
            bn(f"{p}.bn2", chans[li])
            if b == 0 and li > 1:
                conv(f"{p}.downsample.0.weight", chans[li], cin, 1)
                bn(f"{p}.downsample.1", chans[li])
    sd["fc.weight"] = rs.normal(size=(1000, 512)) / np.sqrt(512)
    sd["fc.bias"] = 0.01 * rs.normal(size=1000)
    return {k: v if isinstance(v, torch.Tensor)
            else torch.as_tensor(np.asarray(v, np.float32))
            for k, v in sd.items()}


def write_suite_vis_init(path):
    """Write ``<path>.msgpack``: the SconeVis variables of the JAX scene
    tester's fixed-seed init under the synthetic suite's ``eval_params``
    (``init_macarons_variables`` under ``jax.random.split(PRNGKey(
    torch_seed))``, macarons_tpu/testers/scene.py), the weights of the
    committed ``nbv`` row. Runs the JAX package on the CPU (~50 s, mostly
    the depth network's init); the port reads the file with
    ``utils.convert.load_module_weights``."""
    import os
    import sys

    import jax
    from flax import serialization

    from macarons_tpu.config import Params as JParams
    from macarons_tpu.models.macarons import create_macarons_model as jcreate
    from macarons_tpu.models.macarons import init_macarons_variables

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "data_tools"))
    import synthetic_suite

    params = JParams(synthetic_suite.eval_params(""))
    _, k_init = jax.random.split(jax.random.PRNGKey(params.torch_seed))
    variables = init_macarons_variables(params, jcreate(params), k_init)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path + ".msgpack", "wb") as f:
        f.write(serialization.to_bytes(variables.vis))


def depth_step_fp32_errors(learn_pose=True, seed=10, replicas=0,
                           bn64=False):
    """The depth step's float32 gradient error at the smoke's widths
    (256x456, 96 planes, B 1, augmentation off, random Flax weights from
    ``seed``): the JAX package's depth loss in float32 and under
    ``jax.enable_x64`` (which keeps its disparity heads in float32), the
    port's in float32 and float64, on the same frames and weights; "jax32
    vs port64" holds JAX's float32 run to the one run that is float64
    throughout. ``replicas`` more float32 runs of each package take the
    frames with 1 % of their image entries moved by one ulp (positions and
    signs from numpy's default_rng(seed + 100 r)), each held to port64:
    the spread of each package's own float32 error. ``bn64`` adds a port
    float32 run whose PoseDecoder BatchNorms compute in float64. Returns
    {"a vs b":
    (loss relative difference, max |g_a - g_b| / max |g_b|)}. On the CPU,
    ~2 min and a few GiB, ~30 s a replica:
    python -c "import sys; sys.path.insert(0, 'tests'); import conftest,
    torch_port_helpers as h; print(h.depth_step_fp32_errors())" """
    import jax

    from macarons_tpu.config import Params as JParams
    from macarons_tpu.models.macarons import create_macarons_model as jcreate
    from macarons_tpu.scene import depth_runtime as jdr
    from macarons_tpu.trainers import train_macarons as JTM
    from macarons_tpu_torch.config import Params
    from macarons_tpu_torch.models.macarons import create_macarons_model
    from macarons_tpu_torch.ops import geometry as geo
    from macarons_tpu_torch.scene import depth_runtime as dr
    from macarons_tpu_torch.trainers import train_macarons as TM
    from macarons_tpu_torch.utils.convert import flax_to_torch

    H, W = 256, 456
    cfg = dict(TINY, image_height=H, image_width=W, zfar=750.0,
               use_perfect_depth=False, n_depth=96, alphas=[-2, -1],
               n_alpha=2, n_alpha_for_supervision=2, learn_pose=learn_pose,
               data_augmentation=False)
    jparams = JParams(cfg)
    jcfg = JTM.depth_cfg_from_params(jparams)
    jm = jcreate(jparams).depth
    v = random_flax_variables(
        jm, seed, np.zeros((1, H, W, 3), np.float32),
        np.zeros((1, 2, H, W, 3), np.float32),
        np.eye(3, dtype=np.float32)[None], np.zeros((1, 3), np.float32),
        np.zeros((1, 2, 6), np.float32))
    rs = np.random.default_rng(seed + 1)
    t = np.linspace(0.0, 0.4, 3)
    eye = np.stack((30 * np.sin(t), 2 + t, 30 * np.cos(t)), -1)
    R, T = geo.look_at_view_transform(
        torch.as_tensor(eye, dtype=torch.float32), torch.zeros(3, 3))
    frames = {"images": rs.uniform(size=(3, H, W, 3)).astype(np.float32),
              "zbuf": rs.uniform(10.0, 50.0, size=(3, H, W, 1)).astype(
                  np.float32),
              "mask": rs.uniform(size=(3, H, W, 1)) > 0.1,
              "R": R.numpy(), "T": T.numpy(),
              "zfar": np.full((3,), 750.0, np.float32)}

    def nudged(r):
        """The frames with 1 % of the image entries one ulp up or down."""
        rr = np.random.default_rng(seed + 100 * r)
        flat = frames["images"].reshape(-1).copy()
        pos = rr.choice(flat.size, flat.size // 100, replace=False)
        flat[pos] = np.nextafter(flat[pos], rr.choice(
            [-np.inf, np.inf], len(pos)).astype(np.float32))
        return dict(frames, images=flat.reshape(frames["images"].shape))

    def as64(tree):
        return jax.tree_util.tree_map(
            lambda a: (np.asarray(a, np.float64)
                       if np.asarray(a).dtype == np.float32 else a), tree)

    japply = jdr.make_apply_depth_fn(jm, jcfg, compute_loss=True, train=True)
    runs = {}

    def run_jax(name, x64, fr):
        with jax.enable_x64(x64):
            jb, ja = jdr.create_batch_for_depth_model(jcfg, fr, "supervision")
            vv = as64(v) if x64 else v
            jb, ja = (as64(jb), as64(ja)) if x64 else (jb, ja)
            loss, g = jax.jit(jax.value_and_grad(lambda p: japply(
                {"params": p, "batch_stats": vv["batch_stats"]}, jb, ja,
                jax.random.PRNGKey(0))[0]))(vv["params"])
            grads = flax_to_torch({"params": g})
            runs[name] = (float(loss),
                          {k: t.double() for k, t in grads.items()})

    params = Params(cfg)
    dcfg = TM.depth_cfg_from_params(params)

    def bn_in_float64(bn):
        """Flax's train-mode BatchNorm arithmetic in float64, cast back."""
        def forward(x):
            x = x.double()
            mean = x.mean(dim=(0, 2, 3))
            var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean,
                              min=0.0)
            mul = torch.rsqrt(var + bn.eps) * bn.weight.double()
            return ((x - mean[None, :, None, None]) * mul[None, :, None, None]
                    + bn.bias.double()[None, :, None, None]).float()
        bn.forward = forward

    def run_port(name, dt, fr, pose_bn64=False):
        m = create_macarons_model(params, "cpu").depth
        m.load_state_dict(flax_to_torch(v))
        m = m.to(dt).train()
        if pose_bn64:
            for mod in m.pose_decoder.modules():
                if isinstance(mod, torch.nn.BatchNorm2d):
                    bn_in_float64(mod)
        batch, alpha = (
            {k: x.to(dt) if x.is_floating_point() else x for k, x in d.items()}
            for d in dr.create_batch_for_depth_model(dcfg, fr, "supervision"))
        saved = torch.get_default_dtype()
        torch.set_default_dtype(dt)
        try:
            loss = dr.depth_loss(m, dcfg, batch, alpha)[0]
            loss.backward()
        finally:
            torch.set_default_dtype(saved)
        runs[name] = (float(loss.detach()), {
            n: p.grad.double() for n, p in m.named_parameters()})

    run_jax("jax32", False, frames)
    run_jax("jax64", True, frames)
    run_port("port32", torch.float32, frames)
    run_port("port64", torch.float64, frames)
    pairs = [("jax32", "jax64"), ("port32", "port64"), ("port64", "jax64"),
             ("port32", "jax64"), ("jax32", "port64")]
    if bn64:
        run_port("port32bn64", torch.float32, frames, pose_bn64=True)
        pairs.append(("port32bn64", "port64"))
    for r in range(1, replicas + 1):
        fr = nudged(r)
        run_jax(f"jax32~{r}", False, fr)
        run_port(f"port32~{r}", torch.float32, fr)
        pairs += [(f"jax32~{r}", "port64"), (f"port32~{r}", "port64")]

    def err(a, b):
        (la, ga), (lb, gb) = runs[a], runs[b]
        scale = max(float(g.abs().max()) for g in gb.values())
        return (abs(la - lb) / abs(lb),
                max(float((ga[k] - g).abs().max()) for k, g in gb.items())
                / scale)

    return {f"{a} vs {b}": err(a, b) for a, b in pairs}
