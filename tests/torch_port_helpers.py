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
