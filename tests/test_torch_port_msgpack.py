"""The port's writer of JAX-format weights: ``utils.convert.torch_to_flax``
(the inverse of ``flax_to_torch``) and ``write_msgpack`` (the inverse of
``read_msgpack``), held on the CPU against the JAX package's Flax trees and
``flax.serialization``.

SconeVis random variables go flax -> torch -> flax bit for bit, the file
the port writes is read by ``flax.serialization.from_bytes`` into a
SconeVis template and by the port's ``load_module_weights``; a module the
writer does not map raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import serialization

from macarons_tpu.models.scone import SconeVis as JSconeVis
from macarons_tpu_torch.models.scone import SconeVis
from macarons_tpu_torch.utils.convert import flax_to_torch, \
    load_module_weights, read_msgpack, torch_to_flax, write_msgpack
from torch_port_helpers import VIS_KW, random_flax_variables, \
    torch_one_thread  # noqa: F401


def assert_same_tree(ours, ref, path=""):
    """Equal nesting and keys, every leaf equal bit for bit in float32."""
    assert set(ours) == set(ref), path
    for k, v in ref.items():
        if isinstance(v, dict):
            assert_same_tree(ours[k], v, f"{path}/{k}")
        else:
            a, b = np.asarray(ours[k]), np.asarray(v, np.float32)
            assert a.dtype == np.float32 and a.shape == b.shape, f"{path}/{k}"
            np.testing.assert_array_equal(a, b, err_msg=f"{path}/{k}")


@pytest.fixture(scope="module")
def vis_vars():
    return random_flax_variables(JSconeVis(**VIS_KW), 3,
                                 jnp.zeros((1, 64, 4)),
                                 jnp.zeros((1, 64, 64)))


def test_scone_vis_round_trip(vis_vars):
    """flax -> torch -> flax, bit for bit."""
    vis = SconeVis(**VIS_KW)
    vis.load_state_dict(flax_to_torch(vis_vars))
    back = torch_to_flax(vis)
    assert set(back) == {"params"}
    assert_same_tree(back, jax.tree_util.tree_map(np.asarray, vis_vars))


def test_scone_vis_msgpack_read_by_jax(vis_vars, tmp_path):
    """The port's file: flax.serialization.from_bytes restores it into a
    SconeVis template, and the port's reader and load_module_weights give
    back the module's weights."""
    vis = SconeVis(**VIS_KW)
    vis.load_state_dict(flax_to_torch(vis_vars))
    path = str(tmp_path / "epoch_0_vis")
    assert write_msgpack(path, torch_to_flax(vis)) == path + ".msgpack"
    with open(path + ".msgpack", "rb") as f:
        raw = f.read()
    template = jax.tree_util.tree_map(np.zeros_like, vis_vars)
    restored = serialization.from_bytes(template, raw)
    assert_same_tree(jax.tree_util.tree_map(np.asarray, restored),
                     jax.tree_util.tree_map(np.asarray, vis_vars))
    assert_same_tree(read_msgpack(path), jax.tree_util.tree_map(
        np.asarray, vis_vars))
    other = load_module_weights(SconeVis(**VIS_KW), path)
    for k, t in vis.state_dict().items():
        np.testing.assert_array_equal(other.state_dict()[k].numpy(),
                                      t.numpy(), err_msg=k)


def test_torch_to_flax_unmapped_module():
    """A module with parameters the writer does not map (a convolution)
    raises KeyError instead of being left out of the file."""
    import torch

    net = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Conv2d(4, 2, 1))
    with pytest.raises(KeyError, match="Conv2d"):
        torch_to_flax(net)


def test_suite_training_epoch_vis(tmp_path):
    """``suite_rows.write_epoch_vis``: the SconeVis of a training run's
    ``epoch_<e>`` checkpoint, at the suite training config's widths, as a
    msgpack that loads back into the port's SconeVis."""
    import torch

    from macarons_tpu_torch.config import Params
    from macarons_tpu_torch.data import suite_rows
    from macarons_tpu_torch.data.synthetic_suite import suite_training_params
    from macarons_tpu_torch.models.macarons import create_macarons_model, \
        init_macarons_weights, save_macarons

    config = suite_training_params(str(tmp_path / "scenes")).to_dict()
    model = create_macarons_model(Params(config), "cpu")
    init_macarons_weights(model, torch.Generator().manual_seed(3))
    save_macarons(str(tmp_path / "weights" / "epoch_1_synth"), model,
                  {"epoch": 2})
    path = suite_rows.write_epoch_vis(config, str(tmp_path), 1)
    assert path == str(tmp_path / "weights" / "epoch_1_vis.msgpack")
    assert suite_rows.trained_vis(str(tmp_path)) == path
    vis = load_module_weights(create_macarons_model(
        Params(config), "cpu").vis, path[:-len(".msgpack")])
    for k, t in model.vis.state_dict().items():
        np.testing.assert_array_equal(vis.state_dict()[k].numpy(), t.numpy(),
                                      err_msg=k)
