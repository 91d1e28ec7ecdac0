"""Data-parallel helpers over the ranks of ``parallel.distributed`` (port
of macarons_tpu/parallel/mesh.py).

The JAX package lays a global batch over a 1-D mesh (``P('dp')``: each
device its contiguous rows) and lets XLA insert the gradient psum. Here
each rank is a process holding its rows (``shard_rows``, ``shard_batch``),
computes its share of the global loss, and the gradients are summed over
the ranks in one flat buffer (``all_reduce_grads``). Parameters start
equal (``broadcast_module``) and stay equal, since every rank takes the
same optimizer step on the same summed gradient; ``replicas_agree`` checks
that bit for bit.

Random draws that every rank must agree on come from a generator every
rank advances the same way. A draw with a row per batch item is taken at
the global batch's shape and sliced to the rank's rows (``RowDraws``), so
a row draws what it would in one process holding the whole batch.

Every collective is an ``all_reduce``, a ``broadcast`` or a ``barrier``:
the ones gloo runs on CUDA tensors too, so two ranks sharing a card (gloo)
and one rank per card (NCCL) run the same code. Outside a group of
several processes, or inside ``distributed.local()``, each helper is the
identity.
"""

from __future__ import annotations

import hashlib
import io
import socket
from typing import Dict, Iterable, List, Optional, Sequence

import torch
import torch.distributed as dist

from . import distributed


def world() -> int:
    """The data-parallel world: the group's size, or 1 when collectives
    are off."""
    return distributed.world() if distributed.active() else 1


def rank() -> int:
    return distributed.rank() if distributed.active() else 0


def shard_rows(n_global: int) -> slice:
    """This rank's contiguous rows of a global batch of ``n_global`` rows,
    as ``P('dp')`` lays them out; a batch that does not split evenly
    raises, as the JAX package's sharding does."""
    w = world()
    if n_global % w:
        raise ValueError(f"a global batch of {n_global} rows does not split "
                         f"evenly over {w} ranks")
    n = n_global // w
    return slice(rank() * n, (rank() + 1) * n)


def shard_batch(batch, n_global: Optional[int] = None):
    """This rank's rows of every array or tensor in a dict (or of one)."""
    if isinstance(batch, dict):
        if n_global is None:
            n_global = len(next(iter(batch.values())))
        rows = shard_rows(n_global)
        return {k: v[rows] for k, v in batch.items()}
    return batch[shard_rows(len(batch) if n_global is None else n_global)]


class RowDraws:
    """A generator standing for one rank's rows [start, start + n) of a
    global batch of ``total`` rows: ``rand_rows`` draws at the global shape
    from ``gen`` and returns these rows (rows past ``total``, a padded
    batch's, repeat the last one), so every rank advances ``gen`` alike
    and each row draws as in one process. Anything else drawn through it
    (``base_generator``) comes from ``gen`` unsliced."""

    def __init__(self, gen: torch.Generator, total: int, start: int):
        self.gen = gen
        self.total = int(total)
        self.start = int(start)

    def rand(self, shape, device=None):
        shape = tuple(shape)
        full = torch.rand((self.total,) + shape[1:], generator=self.gen,
                          device=device or self.gen.device)
        rows = full[self.start:self.start + shape[0]]
        if rows.shape[0] < shape[0]:
            pad = shape[0] - rows.shape[0]
            rows = torch.cat([rows, full[-1:].expand(pad, *shape[1:])])
        return rows


def rank_rows(gen: Optional[torch.Generator], n_local: int):
    """``gen`` as a ``RowDraws`` for this rank's ``n_local`` rows of a
    global batch of ``n_local * world()``; ``gen`` itself at world 1."""
    if gen is None or world() == 1:
        return gen
    return RowDraws(gen, n_local * world(), rank() * n_local)


def rand_rows(gen, shape, device=None) -> torch.Tensor:
    """``torch.rand(shape)`` from ``gen``, a ``RowDraws`` drawing its rows
    of the global shape."""
    if isinstance(gen, RowDraws):
        return gen.rand(shape, device)
    return torch.rand(tuple(shape), generator=gen, device=device)


def base_generator(gen):
    """The ``torch.Generator`` under a ``RowDraws``."""
    return gen.gen if isinstance(gen, RowDraws) else gen


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


def _comm(t: torch.Tensor):
    """(the tensor a collective runs on, whether it is a copy): NCCL needs
    the rank's card, gloo takes the tensor where it is."""
    if distributed.backend() == "nccl" and t.device != distributed.device():
        return t.to(distributed.device()), True
    return t, False


def all_reduce_(t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Reduce ``t`` over the ranks in place (SUM by default); returns it."""
    if world() > 1:
        c, copied = _comm(t)
        dist.all_reduce(c, op=op)
        if copied:
            t.copy_(c)
    return t


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks, as a new tensor."""
    return all_reduce_(t.detach().clone())


def broadcast_(t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``t`` on every rank, in place; returns it."""
    if world() > 1:
        c, copied = _comm(t)
        dist.broadcast(c, src=src)
        if copied:
            t.copy_(c)
    return t


def _flat_by_dtype(tensors: Sequence[torch.Tensor]):
    groups: Dict = {}
    for i, t in enumerate(tensors):
        groups.setdefault((t.dtype, t.device), []).append(i)
    return groups


def all_reduce_grads(params: Iterable[torch.nn.Parameter]):
    """Sum every parameter's gradient over the ranks, one flat buffer per
    dtype: the gradient of the global loss when each rank back-propagated
    its share. A parameter without a gradient counts as zero where others
    have one; it keeps none only if no rank gave it one (the optimizer then
    skips it everywhere alike)."""
    params = [p for p in params if p.requires_grad]
    if world() == 1 or not params:
        return
    for (dtype, dev), idx in _flat_by_dtype(params).items():
        group = [params[i] for i in idx]
        flat = torch.cat(
            [(p.grad if p.grad is not None else torch.zeros_like(p))
             .reshape(-1) for p in group]
            + [torch.tensor([0.0 if p.grad is None else 1.0 for p in group],
                            dtype=dtype, device=dev)])
        all_reduce_(flat)
        has = flat[-len(group):].tolist()
        a = 0
        for p, h in zip(group, has):
            n = p.numel()
            if h > 0:
                g = flat[a:a + n].view_as(p)
                if p.grad is None:
                    p.grad = g.clone()
                else:
                    p.grad.copy_(g)
            a += n


def broadcast_tensors(tensors: Sequence[torch.Tensor], src: int = 0):
    """Rank ``src``'s tensors on every rank, in place, one flat buffer per
    dtype."""
    if world() == 1:
        return
    tensors = list(tensors)
    for (dtype, _), idx in _flat_by_dtype(tensors).items():
        group = [tensors[i] for i in idx]
        flat = broadcast_(torch.cat([t.reshape(-1) for t in group]), src)
        a = 0
        for t in group:
            t.copy_(flat[a:a + t.numel()].view_as(t))
            a += t.numel()


def broadcast_object(obj, src: int = 0):
    """Rank ``src``'s ``obj`` (anything ``torch.save`` takes) on every
    rank, as bytes in a tensor; tensors in it land on this rank's device."""
    if world() == 1:
        return obj
    dev = distributed.device()
    n = torch.zeros(1, dtype=torch.int64, device=dev)
    data = None
    if rank() == src:
        buf = io.BytesIO()
        torch.save(obj, buf)
        data = torch.frombuffer(bytearray(buf.getvalue()),
                                dtype=torch.uint8).to(dev)
        n[0] = data.numel()
    broadcast_(n, src)
    if rank() != src:
        data = torch.empty(int(n.item()), dtype=torch.uint8, device=dev)
    broadcast_(data, src)
    if rank() == src:
        return obj
    return torch.load(io.BytesIO(data.cpu().numpy().tobytes()),
                      map_location=dev, weights_only=False)


def broadcast_module(module: torch.nn.Module, src: int = 0):
    """Rank ``src``'s parameters and buffers in ``module`` on every rank."""
    with torch.no_grad():
        broadcast_tensors(list(module.state_dict().values()), src)


def broadcast_grads(params: Iterable[torch.nn.Parameter], src: int):
    """Rank ``src``'s gradients on every rank (``None`` where it has
    none)."""
    params = [p for p in params if p.requires_grad]
    if world() == 1 or not params:
        return
    dtype, dev = params[0].dtype, params[0].device
    has = torch.tensor([0.0 if p.grad is None else 1.0 for p in params],
                       dtype=dtype, device=dev)
    broadcast_(has, src)
    present = [p for p, h in zip(params, has.tolist()) if h > 0]
    for p, h in zip(params, has.tolist()):
        if h == 0:
            p.grad = None
        elif p.grad is None:
            p.grad = torch.zeros_like(p)
    broadcast_tensors([p.grad for p in present], src)


def _ranks_alike(me: int) -> int:
    """How many ranks of the group give the same ``me`` as this one (1
    outside a group), in one all-reduce."""
    if world() == 1:
        return 1
    ids = torch.zeros(world(), dtype=torch.int64, device=distributed.device())
    ids[rank()] = me
    return int((all_reduce_(ids) == me).sum())


def _host_id() -> int:
    return int.from_bytes(hashlib.sha1(
        socket.gethostname().encode()).digest()[:5], "little")


def ranks_on_device() -> int:
    """How many ranks of the group run on this rank's device: more than
    one where gloo ranks share a card (1 outside a group). Each rank's
    (host, device) goes to every rank in one all-reduce."""
    if world() == 1:
        return 1
    dev = distributed.device()
    return _ranks_alike(_host_id() * 1024
                        + (dev.index if dev.index is not None else 1023))


def ranks_on_host() -> int:
    """How many ranks of the group run on this rank's host (1 outside a
    group)."""
    return _ranks_alike(_host_id())


def _state_tensors(modules: Sequence[torch.nn.Module],
                   optimizers: Sequence[torch.optim.Optimizer]):
    out: List[torch.Tensor] = []
    for m in modules:
        if m is not None:
            out += list(m.state_dict().values())
    for opt in optimizers:
        if opt is None:
            continue
        for group in opt.param_groups:
            for p in group["params"]:
                for v in opt.state.get(p, {}).values():
                    out.append(v if isinstance(v, torch.Tensor)
                               else torch.tensor(float(v)))
    return out


def checksum(t: torch.Tensor) -> int:
    """An exact checksum of a tensor's bits: its words as integers, each
    times a weight from its position, summed in int64 (wrapping, so the
    order of the sum does not matter)."""
    t = t.detach().contiguous().reshape(-1)
    if t.dtype in (torch.float32, torch.int32):
        v = t.view(torch.int32).long()
    elif t.dtype in (torch.float64, torch.int64):
        v = t.view(torch.int64)
    elif t.dtype == torch.bool:
        v = t.long()
    else:
        v = t.view(torch.int16).long() if t.element_size() == 2 else \
            t.view(torch.uint8).long()
    w = torch.arange(v.numel(), device=v.device) % 65521 + 1
    return int((v * w).sum())


def replicas_agree(*modules: torch.nn.Module,
                   optimizers: Sequence[torch.optim.Optimizer] = ()) -> bool:
    """Whether every rank holds the same parameters, buffers and optimizer
    state as rank 0, bit for bit (``checksum`` of each tensor, rank 0's
    broadcast and compared on every rank, the verdict reduced over the
    ranks). True at world 1."""
    if world() == 1:
        return True
    sums = torch.tensor([checksum(t) for t in _state_tensors(modules,
                                                             optimizers)],
                        dtype=torch.int64, device=distributed.device())
    ref = broadcast_(sums.clone(), 0)
    ok = torch.tensor([int(torch.equal(sums, ref))], dtype=torch.int64,
                      device=distributed.device())
    all_reduce_(ok, op=dist.ReduceOp.MIN)
    return bool(ok.item())

