"""Flax parameter trees -> PyTorch state dicts, and a reader for the JAX
package's msgpack checkpoints (macarons_tpu/utils/checkpoint.py).

The port's modules carry the submodule names Flax gives their counterparts,
so a parameter maps by path. Every Dense of the SCONE networks wraps an
inner ``nn.Dense`` named ``Dense_0``: its ``kernel`` (in, out) becomes
``<wrapper>.weight`` (out, in) and its ``bias`` ``<wrapper>.bias``; a Dense
under its own name (the PoseDecoder's ``fc``) becomes ``<name>.weight`` and
``<name>.bias``. A
``nn.Conv`` is told apart by the rank of its kernel: (kh, kw, in, out)
becomes ``<conv>.weight`` (out, in, kh, kw), its ``bias`` ``<conv>.bias``. A
LayerNorm's or BatchNorm's ``scale`` and ``bias`` become ``weight`` and
``bias``; a BatchNorm's ``batch_stats`` ``mean`` and ``var`` become
``running_mean`` and ``running_var``.
"""

from __future__ import annotations

import struct
from typing import Dict, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def flax_to_torch(params_tree: Mapping) -> Dict[str, torch.Tensor]:
    """Nested dict of numpy arrays (a Flax ``params`` collection, or a
    variables dict holding one and perhaps ``batch_stats``) -> state dict."""
    stats = {}
    if "params" in params_tree:
        stats = params_tree.get("batch_stats", {})
        params_tree = params_tree["params"]
    leaves = dict(_flatten(params_tree))
    out = {}
    for path, value in leaves.items():
        parent, leaf = path[:-1], path[-1]
        arr = torch.tensor(np.asarray(value, np.float32))
        kernel = leaves.get(parent + ("kernel",))
        if kernel is not None and np.ndim(kernel) == 4:  # nn.Conv
            name = ".".join(parent)
            if leaf == "kernel":
                out[name + ".weight"] = arr.permute(3, 2, 0, 1).contiguous()
            elif leaf == "bias":
                out[name + ".bias"] = arr
            else:
                raise KeyError(".".join(path))
        elif kernel is not None:  # nn.Dense, perhaps inside a wrapper
            name = ".".join(parent[:-1] if parent[-1].startswith("Dense_")
                            else parent)
            if leaf == "kernel":
                out[name + ".weight"] = arr.T.contiguous()
            elif leaf == "bias":
                out[name + ".bias"] = arr
            else:
                raise KeyError(".".join(path))
        elif leaf in ("scale", "bias"):  # LayerNorm, BatchNorm
            out[".".join(parent) + (".weight" if leaf == "scale" else ".bias")] = arr
        else:
            raise KeyError(f"unmapped Flax parameter {'.'.join(path)}")
    running = {"mean": ".running_mean", "var": ".running_var"}
    for path, value in _flatten(stats):
        name = ".".join(path[:-1])
        if path[-1] not in running:
            raise KeyError(f"unmapped Flax batch statistic {'.'.join(path)}")
        out[name + running[path[-1]]] = torch.tensor(
            np.asarray(value, np.float32))
        out[name + ".num_batches_tracked"] = torch.tensor(0)
    return out


_FIXED = {0xc0: None, 0xc2: False, 0xc3: True}
# type byte -> (kind, struct format of its length)
_SIZED = {0xc4: ("bin", ">B"), 0xc5: ("bin", ">H"), 0xc6: ("bin", ">I"),
          0xc7: ("ext", ">B"), 0xc8: ("ext", ">H"), 0xc9: ("ext", ">I"),
          0xd9: ("str", ">B"), 0xda: ("str", ">H"), 0xdb: ("str", ">I"),
          0xdc: ("array", ">H"), 0xdd: ("array", ">I"),
          0xde: ("map", ">H"), 0xdf: ("map", ">I")}
_NUMBERS = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I",
            0xcf: ">Q", 0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


def _unpack(buf: bytes, pos: int, ext):
    """Decode one msgpack object at ``pos`` -> (object, next position).
    ``ext(code, data)`` decodes extension types."""
    t = buf[pos]
    pos += 1
    if t <= 0x7f:
        return t, pos
    if t >= 0xe0:
        return t - 0x100, pos
    if t in _FIXED:
        return _FIXED[t], pos
    if t in _NUMBERS:
        fmt = _NUMBERS[t]
        return struct.unpack_from(fmt, buf, pos)[0], pos + struct.calcsize(fmt)
    if 0x80 <= t <= 0x8f:
        kind, n = "map", t & 0x0f
    elif 0x90 <= t <= 0x9f:
        kind, n = "array", t & 0x0f
    elif 0xa0 <= t <= 0xbf:
        kind, n = "str", t & 0x1f
    elif t in _FIXEXT:
        kind, n = "ext", _FIXEXT[t]
    elif t in _SIZED:
        kind, fmt = _SIZED[t]
        n = struct.unpack_from(fmt, buf, pos)[0]
        pos += struct.calcsize(fmt)
    else:
        raise ValueError(f"unsupported msgpack type byte {t:#x}")
    if kind == "bin":
        return bytes(buf[pos:pos + n]), pos + n
    if kind == "str":
        return bytes(buf[pos:pos + n]).decode("utf-8"), pos + n
    if kind == "ext":
        code = struct.unpack_from(">b", buf, pos)[0]
        return ext(code, bytes(buf[pos + 1:pos + 1 + n])), pos + 1 + n
    items = []
    for _ in range(n * (2 if kind == "map" else 1)):
        item, pos = _unpack(buf, pos, ext)
        items.append(item)
    if kind == "array":
        return items, pos
    return dict(zip(items[::2], items[1::2])), pos


def _flax_ext(code: int, data: bytes):
    """Flax's extension types: 1 ndarray, 3 numpy scalar, each packed as
    (shape, dtype name, C-order bytes)."""
    if code not in (1, 3):
        raise ValueError(f"unsupported msgpack ext type {code}")
    (shape, dtype, raw), _ = _unpack(data, 0, _flax_ext)
    name = dtype.decode() if isinstance(dtype, bytes) else dtype
    arr = np.frombuffer(raw, dtype=np.dtype(name)).reshape(shape)
    return arr if code == 1 else arr[()]


def read_msgpack(path: str):
    """Load ``<path>.msgpack`` written by flax.serialization.to_bytes (the
    JAX package's utils/checkpoint.py) into nested dicts of numpy arrays."""
    with open(path + ".msgpack", "rb") as f:
        buf = f.read()
    tree, end = _unpack(buf, 0, _flax_ext)
    if end != len(buf):
        raise ValueError(f"{path}.msgpack: {len(buf) - end} trailing bytes")
    return tree


def load_macarons_weights(model, path: str):
    """Load the networks of a JAX MACARONS checkpoint: occ and vis, and the
    depth network's params and batch statistics when the model has one."""
    tree = read_msgpack(path)
    model.occ.load_state_dict(flax_to_torch(tree["occ"]))
    model.vis.load_state_dict(flax_to_torch(tree["vis"]))
    if model.depth is not None:
        model.depth.load_state_dict(flax_to_torch(tree["depth"]))
    return model


def load_module_weights(module, path: str):
    """Load the ``params`` (and ``batch_stats``) of a JAX checkpoint into
    ``module``: a pretrainer's Flax ``TrainState``, a variables dict, or the
    depth pretrainer's ``{"variables", "opt_state"}``."""
    tree = read_msgpack(path)
    tree = tree.get("variables", tree)
    state = flax_to_torch({"params": tree["params"],
                           "batch_stats": tree.get("batch_stats", {})})
    dev = next(module.parameters()).device
    module.load_state_dict({k: v.to(dev) for k, v in state.items()})
    return module
