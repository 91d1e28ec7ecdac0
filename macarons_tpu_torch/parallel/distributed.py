"""Process groups for data parallelism over several cards (port of
macarons_tpu/parallel/distributed.py).

The JAX package is single-controller: one ``jax.distributed.initialize()``
per host, and a mesh over every device. PyTorch's idiom, and the
reference's DDP layout, is one process per card. ``initialize`` joins this
process to its group from explicit arguments or from the environment, in
this order: ``torchrun``'s ``RANK``/``WORLD_SIZE``/``LOCAL_RANK`` (with
``MASTER_ADDR``/``MASTER_PORT``), the JAX package's
``MACARONS_COORDINATOR``/``MACARONS_NUM_PROCESSES``/``MACARONS_PROCESS_ID``,
or SLURM's ``SLURM_NTASKS``/``SLURM_PROCID``/``SLURM_LOCALID``. A world of
one process starts no group.

The backend is explicit: NCCL by default on CUDA, one card per rank (two
ranks on one card raise); ``gloo`` on the CPU, and on CUDA when the caller
names it, then also with several ranks on one card. Every group has a
finite timeout. ``spawn`` starts one process per rank on this host: a rank
that raises ends the others, and so does an optional deadline.

``local()`` switches the collectives of ``parallel.mesh`` off for work that
one rank does alone (the trainer's validation on rank 0). The other ranks
wait for that work in ``await_lone_work``, whose timeout
(``LONE_WORK_TIMEOUT_S``) is not the group's: the work may take longer than
a collective may wait.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import tempfile
import time
import traceback
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 900.0
# How long ranks wait for work that one rank does alone (a day). A rank
# that fails ends the run through its launcher (``spawn`` or torchrun)
# before that.
LONE_WORK_TIMEOUT_S = 86400.0

_state = {"device": None, "local": 0, "backend": None, "lone": None}


def _int_env(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def _from_environment():
    """(init_method, world, rank, local_rank) from the environment, or
    None when no launcher set one."""
    if _int_env("WORLD_SIZE") is not None and _int_env("RANK") is not None:
        rank = _int_env("RANK")
        return ("env://", _int_env("WORLD_SIZE"), rank,
                _int_env("LOCAL_RANK") or 0)
    n = _int_env("MACARONS_NUM_PROCESSES")
    if n is not None:
        coord = os.environ.get("MACARONS_COORDINATOR", "localhost:12355")
        rank = _int_env("MACARONS_PROCESS_ID") or 0
        return (f"tcp://{coord}", n, rank,
                _int_env("MACARONS_LOCAL_RANK") or rank)
    if "SLURM_NTASKS" in os.environ:
        n = int(os.environ["SLURM_NTASKS"])
        rank = _int_env("SLURM_PROCID") or 0
        head = os.environ.get("SLURM_JOB_NODELIST", "localhost")
        head = head.split(",")[0].split("[")[0]
        return (f"tcp://{head}:12355", n, rank,
                _int_env("SLURM_LOCALID") or 0)
    return None


def initialize(backend: Optional[str] = None,
               timeout: float = DEFAULT_TIMEOUT_S,
               init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None,
               local_rank: Optional[int] = None, device="cuda") -> bool:
    """Join this process to its group and pick its device; returns whether
    a group of more than one process was started.

    Explicit arguments come first, then the environment (module doc).
    ``device`` "cuda" gives the rank ``cuda:<local_rank>`` under NCCL (a
    local rank beyond the visible cards raises: two ranks never share a
    card under NCCL) and ``cuda:<local_rank mod cards>`` under gloo;
    "cpu" keeps it on the CPU (gloo only). Raises if the group cannot form
    within ``timeout`` seconds."""
    if init_method is None or world_size is None:
        env = _from_environment()
        if env is not None:
            init_method = init_method or env[0]
            world_size = world_size if world_size is not None else env[1]
            rank = rank if rank is not None else env[2]
            local_rank = local_rank if local_rank is not None else env[3]
    world_size = world_size or 1
    rank = rank or 0
    local_rank = rank if local_rank is None else local_rank
    dev = torch.device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA rank was asked for, but CUDA is not "
                               "available; pass device='cpu'")
        n_cards = torch.cuda.device_count()
        if backend == "nccl" and local_rank >= n_cards:
            raise RuntimeError(
                f"local rank {local_rank} under NCCL needs card "
                f"{local_rank}, but {n_cards} are visible: NCCL takes one "
                f"card per rank (name backend='gloo' to share a card)")
        dev = torch.device("cuda", local_rank % n_cards)
        torch.cuda.set_device(dev)
    elif backend == "nccl":
        raise ValueError("NCCL needs CUDA ranks; the CPU takes gloo")
    _state.update(device=dev, backend=backend)
    if world_size <= 1:
        return False
    if dist.is_initialized():
        raise RuntimeError("this process is in a process group already")
    dist.init_process_group(
        backend=backend, init_method=init_method, world_size=world_size,
        rank=rank, timeout=datetime.timedelta(seconds=float(timeout)))
    _state["lone"] = dist.new_group(
        backend="gloo",
        timeout=datetime.timedelta(seconds=LONE_WORK_TIMEOUT_S))
    return True


def shutdown():
    """Leave the process group (a no-op outside one)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _state.update(device=None, local=0, backend=None, lone=None)


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_master() -> bool:
    return rank() == 0


def backend() -> Optional[str]:
    return _state["backend"]


def device(default="cuda") -> torch.device:
    """This rank's device: the one ``initialize`` picked, else
    ``default``."""
    return _state["device"] or torch.device(default)


def active() -> bool:
    """Whether collectives run: a group of several processes, outside
    ``local()``."""
    return dist.is_initialized() and world() > 1 and _state["local"] == 0


@contextlib.contextmanager
def local():
    """Work that this rank does alone: collectives are off inside."""
    _state["local"] += 1
    try:
        yield
    finally:
        _state["local"] -= 1


def barrier():
    if active():
        if backend() == "nccl":
            dist.barrier(device_ids=[device().index])
        else:
            dist.barrier()


def await_lone_work():
    """A barrier for every rank, after one of them has worked alone
    (inside ``local()``): the others wait here, for up to
    ``LONE_WORK_TIMEOUT_S`` seconds rather than the group's timeout."""
    if active():
        dist.barrier(group=_state["lone"])


# ---------------------------------------------------------------------------
# Starting the ranks on this host
# ---------------------------------------------------------------------------


def _rank_main(index: int, fn: Callable, args: Sequence, world_size: int,
               backend_name: str, init_method: str, device_type: str,
               timeout: float, out_dir: str, threads: int):
    torch.set_num_threads(threads)
    try:
        initialize(backend=backend_name, timeout=timeout,
                   init_method=init_method, world_size=world_size,
                   rank=index, local_rank=index, device=device_type)
        out = fn(*args)
        torch.save(out, os.path.join(out_dir, f"rank_{index}.pt"))
    except Exception:
        # The stamp is taken before this rank leaves its group: a peer
        # whose collective then loses it fails later.
        _record_error(out_dir, index, time.time_ns(), traceback.format_exc())
        raise
    finally:
        shutdown()


def _record_error(out_dir: str, index: int, stamp: int, trace: str):
    path = os.path.join(out_dir, f"error_{index}.pt")
    torch.save({"stamp": stamp, "trace": trace, "pid": os.getpid()},
               path + ".part")
    os.replace(path + ".part", path)


def _first_error(out_dir: str, world_size: int):
    """(rank, record) of the earliest error that a rank recorded, or
    None."""
    found = []
    for i in range(world_size):
        path = os.path.join(out_dir, f"error_{i}.pt")
        if os.path.exists(path):
            rec = torch.load(path, weights_only=False)
            found.append((rec["stamp"], i, rec))
    if not found:
        return None
    _, i, rec = min(found)
    return i, rec


def spawn(fn: Callable, world_size: int, args: Sequence = (),
          backend: Optional[str] = None, device: str = "cuda",
          timeout: float = DEFAULT_TIMEOUT_S, threads: int = 1,
          deadline: Optional[float] = None) -> List:
    """Run ``fn(*args)`` in ``world_size`` new processes, one per rank,
    joined by ``initialize`` over a file store in a fresh temporary
    directory; returns each rank's return value (saved with
    ``torch.save``), in rank order.

    ``fn`` must be importable by name (a module-level function). Each rank
    runs ``torch.set_num_threads(threads)``. A rank that raises ends every
    other and this call raises its error: each failing rank records its
    traceback with the time it raised, and the error raised here is the
    earliest one's (``ProcessRaisedException``, "-- Process <i>
    terminated ..."), not that of a rank whose collective then lost its
    peer. The group's collectives time out after ``timeout`` seconds, and
    the whole run, if ``deadline`` is given, after ``deadline`` seconds
    (``TimeoutError``)."""
    import torch.multiprocessing as mp

    device_type = torch.device(device).type
    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    with tempfile.TemporaryDirectory(prefix="macarons_ranks_") as out_dir:
        init = "file://" + os.path.join(out_dir, "store")
        ctx = mp.start_processes(
            _rank_main, args=(fn, tuple(args), world_size, backend, init,
                              device_type, timeout, out_dir, threads),
            nprocs=world_size, join=False, start_method="spawn")
        end = None if deadline is None else time.monotonic() + deadline
        try:
            while not ctx.join(timeout=1.0):
                if end is not None and time.monotonic() > end:
                    raise TimeoutError(
                        f"{world_size} ranks of {fn.__name__} did not end "
                        f"within {deadline:.0f} s")
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            first = _first_error(out_dir, world_size)
            if first is None or first[0] == e.error_index:
                raise
            i, rec = first
            raise mp.ProcessRaisedException(
                f"\n\n-- Process {i:d} terminated with the following "
                f"error:\n{rec['trace']}", i, rec["pid"]) from e
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(5)
        return [torch.load(os.path.join(out_dir, f"rank_{i}.pt"),
                           weights_only=False)
                for i in range(world_size)]


def launch(fn: Callable, args: Sequence = (), device: str = "cuda",
           n_ranks: Optional[int] = None):
    """Run an entry point's ``fn(*args)`` as its CLI does. Under a launcher
    (``torchrun``, the ``MACARONS_*`` variables or SLURM) this process
    joins its group first. Otherwise, on CUDA, ``n_ranks`` ranks (default
    every visible card, as the JAX package's mesh takes every device) are
    spawned, one per card under NCCL, when there are several; on one card
    or the CPU it runs here, in one process."""
    if _from_environment() is not None:
        initialize(device=device)
        try:
            return fn(*args)
        finally:
            shutdown()
    cuda = torch.device(device).type == "cuda" and torch.cuda.is_available()
    n = (torch.cuda.device_count() if cuda else 1) if n_ranks is None \
        else n_ranks
    if n > 1:
        spawn(fn, n, args, device=device,
              threads=max(torch.get_num_threads() // n, 1))
        return None
    return fn(*args)
