"""The replay memory (port of macarons_tpu/scene/memory.py): the disk
``Memory`` and the device-resident ``DeviceMemory``.

Per scene directory, ``<scene>/training/<traj>/`` holds the captured frames
(``frames/<n>.npz``: rgb, zbuf, mask, R, T, zfar), the predicted depths of a
remap (``depths/<n>.npz``: depth, mask, error_mask, R, T), the
end-of-trajectory snapshots (``surface/scene.npz``, ``occupancy/field.npz``)
and the poses (``poses/epoch_<e>.npz``), with the JAX package's keys, so
the two packages read each other's memories.

``Memory`` queues its writes: a CUDA tensor is copied into pinned host
memory without blocking, and a writer thread saves the file once the copy's
event has completed; a read or rewrite of a file waits for its queued write,
and a directory listing for all of them. Frame sequences are read through
the native loader (``utils/native_loader.py``), all files at once.

Across the processes of a data-parallel run (``parallel.distributed``)
each rank holds its own ``Memory`` of every scene directory: only a
scene's owner (the rank training it) writes that scene's files, and the
registry of queued writes is each process's own, so a rank drains its
writes (``flush``) and the ranks meet at a barrier before any replay that
can read another rank's scene (``trainers.train_macarons`` does so before
each scene group's trajectories and at every epoch's end).

``DeviceMemory`` keeps a training run's memory on the card: each (scene,
trajectory slot) has a ``FrameStore`` of its frames and a ``DepthStore`` of
its remap's depths, the snapshots and poses are kept as tensors, and the
counts are host integers, so no read or write of it synchronises with the
card. ``flush_to_disk`` writes (scene, slot) keys in the disk layout (the
trainer: at each epoch's end the slots captured in it) and
``hydrate_from_disk`` loads a run's files back (on resume). Over
data-parallel ranks every rank keeps a whole ``DeviceMemory``: at an
epoch's end each writes the keys it captured and, after a barrier, loads
the ones the other ranks captured (``load_from_disk(keys)``;
``trainers.train_macarons.exchange_device_memory``).

Where every slot's stores do not fit on the card beside training, a
``DeviceMemory`` with a host tier (``enable_host_tier``) keeps one slot a
scene on the card, the one it captures, and the slots that replay only
reads in host memory (page-locked when the device is CUDA): a pool of
scenes x (slots - 1) host slots, allocated once and reused as slots
rotate. A key moves to the host at its epoch's end while its scene has a
free host slot (``move_to_host``; the flush then writes from that copy),
else when its scene begins its next trajectory. Replay's reads copy the
rows they need to the card without waiting for the copy; the stores,
dtypes, capacities, draws and results are the card's, bit for bit.
"""

from __future__ import annotations

import os
import threading
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np
import torch

from .depth_runtime import (
    FrameStore,
    _clamped_start,
    init_frame_store,
    store_append,
    store_window,
)
from .grid import GridState
from .proxy import ProxyState


def _snapshot(v):
    """A value to save later: a CUDA tensor as a pinned host copy started
    now (its event marks the end of the copy), a CPU tensor cloned, else a
    numpy array. Returns (value, whether it waits on an event, its host
    bytes)."""
    if isinstance(v, torch.Tensor):
        v = v.detach()
        if v.is_cuda:
            host = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            host.copy_(v, non_blocking=True)
            return host, True, host.nbytes
        return v.clone(), False, v.nbytes
    v = np.asarray(v)
    return v, False, v.nbytes


def _numpy(v):
    return v.numpy() if isinstance(v, torch.Tensor) else v


class Memory:
    """Replay store over one or more scene directories; trajectory slots
    rotate with the epoch (``current_epoch % n_trajectories``)."""

    # Queued writes (file path -> Future), shared by every Memory of the
    # process, so that any Memory's read of a file waits for its write.
    _inflight: Dict[str, object] = {}
    _writer_pool: Optional[ThreadPoolExecutor] = None
    _loader = None
    # Host bytes held by queued writes' copies, now and at most since the
    # last reset_queued_peak().
    _held = {"now": 0, "peak": 0}
    _held_lock = threading.Lock()

    def __init__(self, scene_memory_paths: List[str], current_epoch: int = 0,
                 n_trajectories: int = 1):
        self.scene_memory_paths = list(scene_memory_paths)
        self.n_trajectories = n_trajectories
        self.current_epoch = current_epoch
        for path in self.scene_memory_paths:
            for traj in range(n_trajectories):
                for sub in ("frames", "depths", "surface", "occupancy", "poses"):
                    os.makedirs(os.path.join(path, "training", str(traj), sub),
                                exist_ok=True)

    def current_trajectory(self) -> int:
        return self.current_epoch % self.n_trajectories

    def _dir(self, scene_path: str, sub: str, traj: Optional[int]) -> str:
        t = self.current_trajectory() if traj is None else traj
        return os.path.join(scene_path, "training", str(t), sub)

    # -- queued writes --------------------------------------------------------
    @classmethod
    def _writer(cls) -> ThreadPoolExecutor:
        if cls._writer_pool is None:
            cls._writer_pool = ThreadPoolExecutor(
                max_workers=2, thread_name_prefix="memory-writer")
        return cls._writer_pool

    def _queue(self, fpaths: List[str], arrays: Dict, write):
        """Start the arrays' copies to the host, then queue ``write(host
        arrays)`` on a writer thread, after any queued write of the same
        files and after the copies' event."""
        host, on_card, held = {}, False, 0
        for k, v in arrays.items():
            host[k], waits, nbytes = _snapshot(v)
            on_card |= waits
            held += nbytes
        self._hold(held)
        event = None
        if on_card:
            event = torch.cuda.Event()
            event.record()
        for f in fpaths:
            self._wait_for(f)

        def run():
            try:
                if event is not None:
                    event.synchronize()
                write({k: _numpy(v) for k, v in host.items()})
            finally:
                host.clear()
                self._hold(-held)

        fut = self._writer().submit(run)
        for f in fpaths:
            self._inflight[f] = fut

    def _save(self, fpath: str, **arrays):
        self._queue([fpath], arrays, lambda host: np.savez(fpath, **host))

    def _wait_for(self, fpath: str):
        fut = self._inflight.pop(fpath, None)
        if fut is not None:
            fut.result()

    def flush(self):
        """Wait for every queued write (before a directory listing)."""
        for fpath in list(self._inflight):
            self._wait_for(fpath)

    @classmethod
    def _hold(cls, nbytes: int):
        with cls._held_lock:
            cls._held["now"] += nbytes
            cls._held["peak"] = max(cls._held["peak"], cls._held["now"])

    @classmethod
    def queued_peak(cls) -> int:
        """The most host bytes that queued writes' copies held at once
        since the last ``reset_queued_peak``."""
        return cls._held["peak"]

    @classmethod
    def reset_queued_peak(cls):
        with cls._held_lock:
            cls._held["peak"] = cls._held["now"]

    def _load(self, fpath: str) -> Dict[str, np.ndarray]:
        self._wait_for(fpath)
        with np.load(fpath) as f:
            return dict(f)

    # -- frames -------------------------------------------------------------
    def frames_dir(self, scene_path: str, traj: Optional[int] = None) -> str:
        return self._dir(scene_path, "frames", traj)

    def save_frame(self, scene_path: str, frame_nb: int, rgb, zbuf, mask, R,
                   T, zfar, traj: Optional[int] = None):
        self._save(os.path.join(self.frames_dir(scene_path, traj),
                                f"{frame_nb}.npz"),
                   rgb=rgb, zbuf=zbuf, mask=mask, R=R, T=T,
                   zfar=np.float32(zfar))

    def save_frame_batch(self, scene_path: str, first_frame_nb: int, rgb,
                         zbuf, mask, R, T, zfar, traj: Optional[int] = None):
        """A capture batch of K frames as K per-frame files: one copy to the
        host per array, the slicing on the writer thread."""
        d = self.frames_dir(scene_path, traj)
        fpaths = [os.path.join(d, f"{first_frame_nb + i}.npz")
                  for i in range(rgb.shape[0])]

        def write(host):
            for i, f in enumerate(fpaths):
                np.savez(f, **{k: v[i:i + 1] for k, v in host.items()},
                         zfar=np.float32(zfar))

        self._queue(fpaths, dict(rgb=rgb, zbuf=zbuf, mask=mask, R=R, T=T),
                    write)

    def load_frame(self, scene_path: str, frame_nb: int,
                   traj: Optional[int] = None) -> Dict[str, np.ndarray]:
        return self._load(os.path.join(self.frames_dir(scene_path, traj),
                                       f"{frame_nb}.npz"))

    def n_frames(self, scene_path: str, traj: Optional[int] = None) -> int:
        self.flush()
        d = self.frames_dir(scene_path, traj)
        return len([f for f in os.listdir(d) if f.endswith(".npz")])

    @classmethod
    def _async_loader(cls):
        if cls._loader is None:
            from ..utils.native_loader import AsyncLoader

            cls._loader = AsyncLoader(n_threads=4)
        return cls._loader

    def load_frame_sequence(self, scene_path: str, last_frame_nb: int, n: int,
                            traj: Optional[int] = None) -> Dict[str, np.ndarray]:
        """Frames [last - n + 1 .. last], stacked; the n files are read at
        once through the native loader."""
        from ..utils.native_loader import prefetch_npz, take_npz

        loader = self._async_loader()
        d = self.frames_dir(scene_path, traj)
        paths = [os.path.join(d, f"{last_frame_nb - n + 1 + i}.npz")
                 for i in range(n)]
        for p in paths:
            self._wait_for(p)
        frames = [take_npz(loader, j) for j in prefetch_npz(loader, paths)]
        out = {k: np.concatenate([f[k] for f in frames], axis=0)
               for k in ("rgb", "zbuf", "mask", "R", "T")}
        out["images"] = out.pop("rgb")
        out["zfar"] = np.full((n,), float(frames[0]["zfar"]), np.float32)
        return out

    # -- depths (predicted, for SCONE replay) --------------------------------
    def save_depth(self, scene_path: str, frame_nb: int, depth, mask,
                   error_mask, R, T, traj: Optional[int] = None):
        self._save(os.path.join(self._dir(scene_path, "depths", traj),
                                f"{frame_nb}.npz"),
                   depth=depth, mask=mask, error_mask=error_mask, R=R, T=T)

    def load_depth(self, scene_path: str, frame_nb: int,
                   traj: Optional[int] = None):
        return self._load(os.path.join(self._dir(scene_path, "depths", traj),
                                       f"{frame_nb}.npz"))

    def depth_stack(self, scene_path: str, traj: Optional[int], indices):
        """Depths ``indices`` stacked, as ``DeviceMemory.depth_stack``
        gives them (numpy arrays here)."""
        got = [self.load_depth(scene_path, int(i), traj) for i in indices]
        return {k: np.concatenate([d[k] for d in got])
                for k in DepthStore.FIELDS}

    def n_depths(self, scene_path: str, traj: Optional[int] = None) -> int:
        self.flush()
        d = self._dir(scene_path, "depths", traj)
        return len([f for f in os.listdir(d) if f.endswith(".npz")])

    # -- scene snapshots ------------------------------------------------------
    def save_surface_scene(self, scene_path: str, state: GridState,
                           traj: Optional[int] = None, **scene_params):
        self._save(os.path.join(self._dir(scene_path, "surface", traj),
                                "scene.npz"),
                   points=state.points, features=state.features,
                   valid=state.valid, **scene_params)

    def load_surface_scene(self, scene_path: str, traj: Optional[int] = None):
        """(GridState of numpy arrays, the other saved arrays)."""
        d = self._load(os.path.join(self._dir(scene_path, "surface", traj),
                                    "scene.npz"))
        return GridState(d.pop("points"), d.pop("features"), d.pop("valid")), d

    def save_occupancy_field(self, scene_path: str, state: ProxyState,
                             traj: Optional[int] = None, **scene_params):
        self._save(os.path.join(self._dir(scene_path, "occupancy", traj),
                                "field.npz"),
                   **state._asdict(), **scene_params)

    def load_occupancy_field(self, scene_path: str,
                             traj: Optional[int] = None):
        """(ProxyState of numpy arrays, the other saved arrays)."""
        d = self._load(os.path.join(self._dir(scene_path, "occupancy", traj),
                                    "field.npz"))
        fields = {k: d.pop(k) for k in ProxyState._fields}
        return ProxyState(**fields), d

    def save_poses(self, scene_path: str, epoch: int, X_history, V_history,
                   idx_history, traj: Optional[int] = None):
        self._save(os.path.join(self._dir(scene_path, "poses", traj),
                                f"epoch_{epoch}.npz"),
                   X_cam=X_history, V_cam=V_history, cam_idx=idx_history)

    # -- replay sampling ------------------------------------------------------
    def get_random_frames_for_depth(self, rs: np.random.Generator,
                                    scene_path: str, n_needed: int,
                                    exclude_traj: Optional[int] = None):
        """A random past frame burst of any trajectory but ``exclude_traj``:
        (traj, last_frame_nb), or None if nothing is replayable."""
        return _random_frames(self, rs, scene_path, n_needed, exclude_traj)

    def sample_depth_replay(self, rs: np.random.Generator, n_samples: int,
                            n_context: int,
                            exclude_traj: Optional[int] = None):
        """n_samples independent (scene_path, traj, last_frame) draws over
        every scene memory and every trajectory but ``exclude_traj``, each a
        supervision frame with its n_context - 1 frames of context; None if
        no trajectory is replayable."""
        return _depth_replay(self, rs, n_samples, n_context, exclude_traj)

    def _has_snapshots(self, scene_path: str, t: int) -> bool:
        return (os.path.exists(os.path.join(
            self._dir(scene_path, "surface", t), "scene.npz"))
            and os.path.exists(os.path.join(
                self._dir(scene_path, "occupancy", t), "field.npz")))

    def get_random_scene_for_scone(self, rs: np.random.Generator,
                                   scene_path: str, n_supervise: int,
                                   n_loops: int = 1, max_build: int = 30,
                                   exclude_traj: Optional[int] = None,
                                   n_proxy_points: Optional[int] = None):
        """A replay trajectory with its saved snapshots: a random consecutive
        BUILD run of 1 .. max_build - 1 depths rebuilds the partial world,
        then ``n_loops`` windows of ``n_supervise`` depths follow it (each
        window starting at the previous one's last depth).

        The occupancy snapshot gives the occupancy pseudo-GT
        ``(supervision_occ > 0) & (out_of_field < 1)`` of the whole
        trajectory and the carving counters the replay continues from; a
        snapshot of another proxy count is skipped.
        Returns (traj, build depth numbers, info) or None; info holds
        'pseudo_gt', 'n_inside_fov', 'n_behind_depth' ((N, 1) float32) and
        'n_depths'."""
        self.flush()
        return _scone_replay(self, rs, scene_path, n_supervise, n_loops,
                             max_build, exclude_traj, n_proxy_points)


# ---------------------------------------------------------------------------
# The samplers both memories share: host logic over host counts
# ---------------------------------------------------------------------------


def _random_frames(mem, rs, scene_path, n_needed, exclude_traj):
    candidates = []
    for t in range(mem.n_trajectories):
        if exclude_traj is not None and t == exclude_traj:
            continue
        n = mem.n_frames(scene_path, t)
        if n >= n_needed:
            candidates.append((t, n))
    if not candidates:
        return None
    t, n = candidates[rs.integers(0, len(candidates))]
    return t, int(rs.integers(n_needed - 1, n))


def _depth_replay(mem, rs, n_samples, n_context, exclude_traj):
    pools = []
    for path in mem.scene_memory_paths:
        for t in range(mem.n_trajectories):
            if exclude_traj is not None and t == exclude_traj:
                continue
            n = mem.n_frames(path, t)
            if n >= n_context:
                pools.append((path, t, n))
    if not pools:
        return None
    out = []
    for _ in range(n_samples):
        path, t, n = pools[rs.integers(0, len(pools))]
        out.append((path, t, int(rs.integers(n_context - 1, n))))
    return out


def _scone_replay(mem, rs, scene_path, n_supervise, n_loops, max_build,
                  exclude_traj, n_proxy_points):
    need_extra = n_loops * max(n_supervise - 1, 0)
    candidates = []
    for t in range(mem.n_trajectories):
        if exclude_traj is not None and t == exclude_traj:
            continue
        n_d = mem.n_depths(scene_path, t)
        if mem._has_snapshots(scene_path, t) and n_d >= 1 + need_extra:
            candidates.append((t, n_d))
    if not candidates:
        return None
    t, n_d = candidates[rs.integers(0, len(candidates))]
    state, _ = mem.load_occupancy_field(scene_path, t)
    if n_proxy_points is not None and state.points.shape[0] != n_proxy_points:
        return None
    pseudo_gt = (state.supervision_occ > 0.0) & (state.out_of_field < 1.0)
    if isinstance(state.points, torch.Tensor):
        info = {"pseudo_gt": pseudo_gt.float(),
                "n_inside_fov": state.n_inside_fov.float(),
                "n_behind_depth": state.n_behind_depth.float()}
    else:
        info = {"pseudo_gt": pseudo_gt.astype(np.float32),
                "n_inside_fov": np.asarray(state.n_inside_fov, np.float32),
                "n_behind_depth": np.asarray(state.n_behind_depth,
                                             np.float32)}
    info["n_depths"] = n_d
    hi_build = max(min(max_build - 1, n_d - need_extra), 1)
    n_build = int(rs.integers(1, hi_build + 1))
    start = int(rs.integers(0, n_d - n_build - need_extra + 1))
    return t, list(range(start, start + n_build)), info


# ---------------------------------------------------------------------------
# Device-resident memory
# ---------------------------------------------------------------------------


def _rows(x, indices: List[int]):
    """Rows ``indices`` of x: a view for consecutive ones, else a gather
    whose index tensor reaches the card from pinned memory, without
    waiting for it."""
    if all(b == a + 1 for a, b in zip(indices, indices[1:])):
        return x[indices[0]:indices[0] + len(indices)]
    idx = torch.as_tensor(indices, dtype=torch.int64)
    if x.is_cuda:
        idx = idx.pin_memory().to(x.device, non_blocking=True)
    return x.index_select(0, idx)


def _runs(indices: List[int]):
    """``indices`` as (first, length) runs of consecutive values."""
    runs = []
    for i in indices:
        if runs and i == runs[-1][0] + runs[-1][1]:
            runs[-1][1] += 1
        else:
            runs.append([i, 1])
    return runs


def _rows_to(x, indices: List[int], device):
    """Rows ``indices`` of a host tensor x on ``device``: one copy a run of
    consecutive rows, each a slice of x (page-locked where x is), so that
    no copy waits for the card and none goes through pageable memory."""
    runs = _runs(indices)
    if len(runs) == 1:
        a, k = runs[0]
        return x[a:a + k].to(device, non_blocking=True)
    out = torch.empty((len(indices),) + x.shape[1:], dtype=x.dtype,
                      device=device)
    at = 0
    for a, k in runs:
        out[at:at + k].copy_(x[a:a + k], non_blocking=True)
        at += k
    return out


class DepthStore:
    """A trajectory's predicted depths on the card (for SCONE replay),
    allocated at capacity, appended in order at a host count."""

    FIELDS = ("depth", "mask", "error_mask", "R", "T")

    def __init__(self, max_depths: int, height: int, width: int,
                 device=None):
        shape = (max_depths, height, width, 1)
        self.depth = torch.zeros(shape, device=device)
        self.mask = torch.zeros(shape, dtype=torch.bool, device=device)
        self.error_mask = torch.zeros(shape, dtype=torch.bool, device=device)
        self.R = torch.eye(3, device=device).expand(max_depths, 3,
                                                    3).clone()
        self.T = torch.zeros((max_depths, 3), device=device)
        self.n = 0

    def append(self, depth, mask, error_mask, R, T):
        """Entries [n, n + k) in place; past the capacity the batch lands
        on the last k rows, as JAX writes it. The frame number a caller
        saves under is not used: entries are in append order."""
        k = depth.shape[0]
        at = _clamped_start(self.n, k, self.depth.shape[0])
        for name, v in zip(self.FIELDS, (depth, mask, error_mask, R, T)):
            getattr(self, name)[at:at + k] = v
        self.n += k

    @classmethod
    def over(cls, tensors) -> "DepthStore":
        """A store over ``tensors`` (its fields, allocated by the caller),
        empty."""
        ds = cls.__new__(cls)
        for name, v in zip(cls.FIELDS, tensors):
            setattr(ds, name, v)
        ds.n = 0
        return ds

    def gather(self, indices, device=None) -> Dict[str, torch.Tensor]:
        """Entries ``indices``, stacked: views or a gather where the store
        lives, or from a host store copied to the card ``device``."""
        indices = [int(i) for i in indices]
        if device is None or self.depth.is_cuda \
                or torch.device(device).type == "cpu":
            return {k: _rows(getattr(self, k), indices) for k in self.FIELDS}
        return {k: _rows_to(getattr(self, k), indices, device)
                for k in self.FIELDS}

    def nbytes(self) -> int:
        return sum(getattr(self, k).nbytes for k in self.FIELDS)


def _slot_fields(max_frames: int, max_depths: int, height: int, width: int,
                 device):
    """One (scene, slot)'s store tensors, as the card's stores start: a
    ``FrameStore``'s five and a ``DepthStore``'s five."""
    frames = init_frame_store(max_frames, height, width, device)
    depths = DepthStore(max_depths, height, width, device)
    return list(frames[:5]) + [getattr(depths, k) for k in DepthStore.FIELDS]


def _pin(buffer: torch.Tensor):
    """Page-lock ``buffer``'s memory in place (``cudaHostRegister``), so
    that copies between it and the card neither wait nor stage; raises if
    the card cannot."""
    err = int(torch.cuda.cudart().cudaHostRegister(buffer.data_ptr(),
                                                   buffer.nbytes, 0))
    if err != 0 or not buffer.is_pinned():
        raise RuntimeError(
            f"cannot page-lock {buffer.nbytes / 2 ** 30:.2f} GiB of host "
            f"memory for the device memory's host tier (cudaError {err})")


def _unpin(buffers):
    for b in buffers:
        torch.cuda.cudart().cudaHostUnregister(b.data_ptr())


class HostSlot:
    """One (scene, slot)'s ``FrameStore`` and ``DepthStore`` in host memory,
    carved from one buffer (page-locked by the memory on CUDA). Rows the
    memory has not written hold the values a fresh store starts with, as
    on the card: ``reset`` puts back those of rows a previous key wrote."""

    def __init__(self, max_frames: int, max_depths: int, height: int,
                 width: int):
        shapes = _slot_fields(max_frames, max_depths, height, width,
                              torch.device("meta"))
        offsets, total = [], 0
        for t in shapes:
            offsets.append(total)
            total += -(-t.nbytes // 64) * 64
        self.buffer = torch.empty(total, dtype=torch.uint8)
        views = [self.buffer[o:o + t.nbytes].view(t.dtype).view(t.shape)
                 for o, t in zip(offsets, shapes)]
        # Each field's fresh value: a number to fill, or a row (R's identity).
        self.start = [row.flatten()[0] if bool((row == row.flatten()[0]).all())
                      else row for row in _slot_fields(
                          1, 1, height, width, torch.device("cpu"))]
        self.frames = FrameStore(*views[:5], 0)
        self.depths = DepthStore.over(views[5:])
        # Rows at or past these hold a fresh store's values.
        self.written = [max_frames, max_depths]
        self.reset(0, 0)

    def reset(self, n_frames: int, n_depths: int):
        """Rows from ``n_frames`` / ``n_depths`` on back to a fresh store's
        values (the caller writes the rows below); returns the store."""
        for i, (fields, n) in enumerate((
                (zip(self.frames[:5], self.start[:5]), n_frames),
                (zip((getattr(self.depths, k) for k in DepthStore.FIELDS),
                     self.start[5:]), n_depths))):
            for dst, start in fields:
                if n >= self.written[i]:
                    continue
                rows = dst[n:self.written[i]]
                if start.dim():
                    rows.copy_(start.expand_as(rows))
                else:
                    rows.fill_(start)  # (a broadcast copy is slow)
            self.written[i] = n
        self.depths.n = 0
        return self


class DeviceMemory:
    """``Memory``'s interface over the card: frames in a ``FrameStore`` and
    remap depths in a ``DepthStore`` per (scene, trajectory slot), both
    allocated when a trajectory begins in that slot; snapshots and poses
    kept as tensors; host counts. Slots rotate with the epoch, as the disk
    memory's directories do. With a host tier (``enable_host_tier``) a
    scene's slots but one live in host slots (see the module's doc)."""

    def __init__(self, scene_memory_paths: List[str], current_epoch: int = 0,
                 n_trajectories: int = 1, max_frames: int = 512,
                 max_depths: int = 128, height: int = 256, width: int = 456,
                 zfar: float = 750.0, device=None):
        self.scene_memory_paths = list(scene_memory_paths)
        self.n_trajectories = n_trajectories
        self.current_epoch = current_epoch
        self.max_frames = max_frames
        self.max_depths = max_depths
        self.height, self.width = height, width
        self.zfar = float(zfar)
        self.device = torch.device("cpu" if device is None else device)
        self._frames: Dict = {}  # (path, traj) -> FrameStore
        self._depths: Dict = {}  # (path, traj) -> DepthStore
        self._surface: Dict = {}  # (path, traj) -> (GridState, params)
        self._occupancy: Dict = {}  # (path, traj) -> (ProxyState, params)
        self._poses: Dict = {}  # (path, traj) -> {epoch: (X, V, idx, n_m, n_f)}
        self._host: Dict = {}  # (path, traj) -> HostSlot of a host-tier key
        self._host_free: List[HostSlot] = []
        self._host_slots = 0  # host slots allocated (0: no host tier)
        # Bytes replay's reads copied from the host tier to the card.
        self.host_read_bytes = 0

    # -- placement -------------------------------------------------------------
    def enable_host_tier(self):
        """Keep each scene's slots but one in host memory: allocate the pool
        of scenes x (slots - 1) host slots now (page-locked when the device
        is CUDA; raises if it cannot be), before any store."""
        if self._frames or self._host_slots:
            raise RuntimeError("enable_host_tier before any store")
        n = len(self.scene_memory_paths) * (self.n_trajectories - 1)
        self._host_free = [HostSlot(self.max_frames, self.max_depths,
                                    self.height, self.width)
                           for _ in range(n)]
        self._host_slots = n
        if self.device.type == "cuda" and n:
            # Unpinned when the memory goes, the buffers pinned so far too
            # if pinning one raises.
            pinned = []
            weakref.finalize(self, _unpin, pinned)
            for h in self._host_free:
                _pin(h.buffer)
                pinned.append(h.buffer)

    @property
    def host_tier(self) -> bool:
        return self._host_slots > 0

    def on_host(self, key) -> bool:
        """Whether (scene path, slot) ``key`` lives in the host tier."""
        return key in self._host

    def _host_room(self, scene_path: str) -> bool:
        """Whether the scene may take one more host slot (each takes at
        most slots - 1, so the pool never runs out)."""
        return self.host_tier and sum(
            p == scene_path for p, _ in self._host) < self.n_trajectories - 1

    def _sync(self):
        """Wait for the card's work (before the host writes a host slot that
        replay's copies may still read, and before the host reads what the
        card copied into one)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _drop_stores(self, key):
        self._frames.pop(key, None)
        self._depths.pop(key, None)
        slot = self._host.pop(key, None)
        if slot is not None:
            self._host_free.append(slot)

    def move_to_host(self, keys) -> int:
        """Move each card key of ``keys`` whose scene has room in the host
        tier to a host slot: its filled rows copied, its card stores freed.
        Returns the bytes copied."""
        nbytes, synced = 0, False
        for key in keys:
            if key not in self._frames or key in self._host \
                    or not self._host_room(key[0]):
                continue
            if not synced:
                self._sync()
                synced = True
            st, ds = self._frames[key], self._depths[key]
            nf, nd = min(st.n, self.max_frames), min(ds.n, self.max_depths)
            slot = self._host_free.pop().reset(nf, nd)
            for dst, src in zip(slot.frames[:5], st[:5]):
                dst[:nf].copy_(src[:nf], non_blocking=True)
                nbytes += dst[:nf].nbytes
            for k in DepthStore.FIELDS:
                dst = getattr(slot.depths, k)[:nd]
                dst.copy_(getattr(ds, k)[:nd], non_blocking=True)
                nbytes += dst.nbytes
            slot.depths.n = ds.n
            self._frames[key] = slot.frames._replace(n=st.n)
            self._depths[key] = slot.depths
            self._host[key] = slot
        if synced:
            self._sync()
        return nbytes

    def current_trajectory(self) -> int:
        return self.current_epoch % self.n_trajectories

    def _key(self, scene_path: str, traj: Optional[int]):
        return (scene_path,
                self.current_trajectory() if traj is None else traj)

    # -- frames ---------------------------------------------------------------
    def _new_stores(self, key, host_rows=None):
        """Empty frame and depth stores for ``key``: on the card, or with
        ``host_rows`` (the frame and depth rows the caller will write) in a
        free host slot (the old ones are released first, so the allocator
        can reuse their memory)."""
        self._drop_stores(key)
        if host_rows is not None:
            self._sync()
            slot = self._host[key] = self._host_free.pop().reset(*host_rows)
            self._frames[key], self._depths[key] = slot.frames, slot.depths
            return
        self._frames[key] = init_frame_store(self.max_frames, self.height,
                                             self.width, self.device)
        self._depths[key] = DepthStore(self.max_depths, self.height,
                                       self.width, self.device)

    def begin_trajectory(self, scene_path: str) -> FrameStore:
        """Fresh stores on the card for the current slot (its earlier
        trajectory and snapshots are dropped, as its directory is
        overwritten on disk). With a host tier, the scene's slot still on
        the card goes to the host slot this frees."""
        key = self._key(scene_path, None)
        self._drop_stores(key)
        self._surface.pop(key, None)
        self._occupancy.pop(key, None)
        if self.host_tier:
            self.move_to_host([k for k in self._frames
                               if k[0] == scene_path and k not in self._host])
        self._new_stores(key)
        return self._frames[key]

    def store(self, scene_path: str, traj: Optional[int] = None) -> FrameStore:
        return self._frames[self._key(scene_path, traj)]

    def update_store(self, scene_path: str, store: FrameStore):
        """Adopt ``store`` (as ``store_append`` returned it, its count
        advanced) for the current slot."""
        self._frames[self._key(scene_path, None)] = store

    def n_frames(self, scene_path: str, traj: Optional[int] = None) -> int:
        st = self._frames.get(self._key(scene_path, traj))
        return 0 if st is None else st.n

    def load_frame_sequence(self, scene_path: str, last_frame_nb: int, n: int,
                            traj: Optional[int] = None) -> Dict:
        """``Memory.load_frame_sequence`` as views of the store (keys
        images, zbuf, mask, R, T, zfar), or from a host slot its rows
        copied to the card."""
        key = self._key(scene_path, traj)
        out = store_window(self._frames[key], last_frame_nb, n, self.zfar,
                           self.device)
        if key in self._host:
            self.host_read_bytes += sum(v.nbytes for k, v in out.items()
                                        if k != "zfar")
        return out

    # -- depths (predicted, for SCONE replay) ---------------------------------
    def save_depth(self, scene_path: str, frame_nb: int, depth, mask,
                   error_mask, R, T, traj: Optional[int] = None):
        self._depths[self._key(scene_path, traj)].append(depth, mask,
                                                         error_mask, R, T)

    def n_depths(self, scene_path: str, traj: Optional[int] = None) -> int:
        ds = self._depths.get(self._key(scene_path, traj))
        return 0 if ds is None else ds.n

    def load_depth(self, scene_path: str, frame_nb: int,
                   traj: Optional[int] = None) -> Dict:
        """Entry ``frame_nb`` as (1, ...) views."""
        return self.depth_stack(scene_path, traj, [frame_nb])

    def depth_stack(self, scene_path: str, traj: Optional[int], indices):
        key = self._key(scene_path, traj)
        out = self._depths[key].gather(indices, self.device)
        if key in self._host:
            self.host_read_bytes += sum(v.nbytes for v in out.values())
        return out

    # -- scene snapshots -------------------------------------------------------
    def save_surface_scene(self, scene_path: str, state: GridState,
                           traj: Optional[int] = None, **scene_params):
        self._surface[self._key(scene_path, traj)] = (state,
                                                      dict(scene_params))

    def load_surface_scene(self, scene_path: str, traj: Optional[int] = None):
        return self._surface[self._key(scene_path, traj)]

    def save_occupancy_field(self, scene_path: str, state: ProxyState,
                             traj: Optional[int] = None, **scene_params):
        self._occupancy[self._key(scene_path, traj)] = (state,
                                                        dict(scene_params))

    def load_occupancy_field(self, scene_path: str,
                             traj: Optional[int] = None):
        return self._occupancy[self._key(scene_path, traj)]

    def save_poses(self, scene_path: str, epoch: int, X_history, V_history,
                   idx_history, n_moves: Optional[int] = None,
                   n_frames: Optional[int] = None,
                   traj: Optional[int] = None):
        """Pose histories as tensors; ``n_moves`` and ``n_frames`` are the
        filled rows of the capacity-sized histories."""
        self._poses.setdefault(self._key(scene_path, traj), {})[epoch] = (
            X_history, V_history, idx_history, n_moves, n_frames)

    # -- replay sampling (host logic over host counts) -------------------------
    def get_random_frames_for_depth(self, rs: np.random.Generator,
                                    scene_path: str, n_needed: int,
                                    exclude_traj: Optional[int] = None):
        return _random_frames(self, rs, scene_path, n_needed, exclude_traj)

    def sample_depth_replay(self, rs: np.random.Generator, n_samples: int,
                            n_context: int,
                            exclude_traj: Optional[int] = None):
        return _depth_replay(self, rs, n_samples, n_context, exclude_traj)

    def _has_snapshots(self, scene_path: str, t: int) -> bool:
        return ((scene_path, t) in self._surface
                and (scene_path, t) in self._occupancy)

    def get_random_scene_for_scone(self, rs: np.random.Generator,
                                   scene_path: str, n_supervise: int,
                                   n_loops: int = 1, max_build: int = 30,
                                   exclude_traj: Optional[int] = None,
                                   n_proxy_points: Optional[int] = None):
        """``Memory.get_random_scene_for_scone`` with the pseudo-GT and the
        carving counters as tensors on the card."""
        return _scone_replay(self, rs, scene_path, n_supervise, n_loops,
                             max_build, exclude_traj, n_proxy_points)

    # -- persistence -----------------------------------------------------------
    def nbytes(self, tier: Optional[str] = None) -> int:
        """Bytes allocated now: of the frame and depth stores on the card
        (``tier`` "card"), of the host tier's slots, free ones included
        ("host"), or both (None)."""
        card = (sum(sum(t.nbytes for t in st[:5])
                    for key, st in self._frames.items()
                    if key not in self._host)
                + sum(ds.nbytes() for key, ds in self._depths.items()
                      if key not in self._host))
        host = self._host_slots * self.slot_nbytes()
        return {"card": card, "host": host, None: card + host}[tier]

    def slot_nbytes(self) -> int:
        """Bytes of one (scene, slot)'s frame and depth stores (built on
        the meta device: nothing allocated)."""
        return sum(t.nbytes for t in _slot_fields(
            self.max_frames, self.max_depths, self.height, self.width,
            torch.device("meta")))

    def full_nbytes(self) -> int:
        """Bytes of the frame and depth stores once every (scene, slot) has
        begun a trajectory, whichever tier holds them."""
        return (len(self.scene_memory_paths) * self.n_trajectories
                * self.slot_nbytes())

    def hydrate_from_disk(self):
        """Load a run's memory files into the stores (resume): every
        (scene, slot) key, as ``load_from_disk`` loads it, each scene's
        current slot last (with a host tier it is the one left on the
        card)."""
        now = self.current_trajectory()
        self.load_from_disk([(path, t) for path in self.scene_memory_paths
                             for t in sorted(range(self.n_trajectories),
                                             key=lambda t: t == now)])

    def load_from_disk(self, keys) -> int:
        """Load each (scene path, slot) key of ``keys`` from its files (those
        that ``flush_to_disk`` writes): its frames and depths up to the
        capacities, and its snapshots. A key's stores and snapshots are
        replaced, never appended to; a key without files is left empty.
        With a host tier a key lands in a host slot while its scene has
        room there, else on the card. Returns the bytes of the arrays
        read."""
        mem = Memory(self.scene_memory_paths, self.current_epoch,
                     self.n_trajectories)
        return sum(self._load_key(mem, path, t) for path, t in keys)

    def _load_key(self, mem: Memory, path: str, t: int) -> int:
        key, nbytes = (path, t), 0

        def tensors(arrays, dev):
            nonlocal nbytes
            nbytes += sum(np.asarray(a).nbytes for a in arrays)
            return (torch.as_tensor(a, device=dev) for a in arrays)

        self._drop_stores(key)
        for held in (self._surface, self._occupancy):
            held.pop(key, None)
        n = min(mem.n_frames(path, t), self.max_frames)
        n_d = min(mem.n_depths(path, t), self.max_depths)
        if n or n_d:
            self._new_stores(key, (n, n_d) if self._host_room(path)
                             else None)
        dev = self._frames[key].images.device if n or n_d else None
        if n:
            fr = mem.load_frame_sequence(path, n - 1, n, t)
            self._frames[key] = store_append(self._frames[key], *tensors(
                [fr[k] for k in ("images", "zbuf", "mask", "R", "T")], dev))
        for i in range(n_d):
            d = mem.load_depth(path, i, t)
            self._depths[key].append(*tensors(
                [d[k] for k in DepthStore.FIELDS], dev))
        if mem._has_snapshots(path, t):
            state, extra = mem.load_surface_scene(path, t)
            self._surface[key] = (GridState(*tensors(state, self.device)),
                                  extra)
            state, extra = mem.load_occupancy_field(path, t)
            self._occupancy[key] = (ProxyState(*tensors(state, self.device)),
                                    extra)
        return nbytes

    def keys(self) -> List:
        """The (scene path, slot) keys that hold frames or depths."""
        return sorted(set(self._frames) | set(self._depths))

    def key_state(self, key) -> Dict[str, torch.Tensor]:
        """What replay can read of ``key``: its filled frame and depth rows
        (in the tier the key lives in) and its snapshots' states, by name
        (the counts are the rows)."""
        out = {}
        n = self.n_frames(*key)
        if n:
            st = self._frames[key]
            out.update({f"frames.{k}": getattr(st, k)[:n]
                        for k in ("images", "zbuf", "mask", "R", "T")})
        ds = self._depths.get(key)
        if ds is not None and ds.n:
            out.update({f"depths.{k}": getattr(ds, k)[:ds.n]
                        for k in DepthStore.FIELDS})
        for kind, held in (("surface", self._surface),
                           ("occupancy", self._occupancy)):
            if key in held:
                state, _ = held[key]
                out.update({f"{kind}.{k}": v for k, v in
                            state._asdict().items()})
        return out

    def flush_to_disk(self, keys=None) -> int:
        """Write the (scene path, slot) keys ``keys`` (default every scene's
        every slot) through a disk ``Memory`` in its layout:
        frames/<n>.npz, depths/<n>.npz, surface/scene.npz,
        occupancy/field.npz, poses/epoch_<e>.npz; returns once the files
        are written, with the bytes of the arrays written. A key's frame
        and depth files past its counts, and snapshot files it does not
        hold, are removed, so that its files hold what the memory holds
        (``load_from_disk`` gives it back). Each key's writes are waited
        for before the next one's are queued, so the host holds at most
        one slot's copies at a time. A host-tier key is written from its
        host slot, without another copy."""
        mem = Memory(self.scene_memory_paths, self.current_epoch,
                     self.n_trajectories)
        if keys is None:
            keys = [(path, t) for path in self.scene_memory_paths
                    for t in range(self.n_trajectories)]
        nbytes = 0
        for path, t in keys:
            key = (path, t)
            held = key in self._frames or key in self._depths
            # A host slot's rows go to the writers as they are (numpy views):
            # each key's writes land before the next key's are queued.
            rows = ((lambda x: x.numpy()) if key in self._host
                    else (lambda x: x))
            n = self.n_frames(path, t)
            if n:
                st = self._frames[key]
                frames = [rows(x[:n]) for x in st[:5]]
                nbytes += sum(x.nbytes for x in frames)
                mem.save_frame_batch(path, 0, *frames, self.zfar, traj=t)
            ds = self._depths.get(key)
            n_d = 0 if ds is None else ds.n
            for i in range(n_d):
                depth = [rows(getattr(ds, k)[i:i + 1])
                         for k in DepthStore.FIELDS]
                nbytes += sum(x.nbytes for x in depth)
                mem.save_depth(path, i, *depth, traj=t)
            if key in self._surface:
                state, params = self._surface[key]
                nbytes += sum(x.nbytes for x in state)
                mem.save_surface_scene(path, state, traj=t, **params)
            if key in self._occupancy:
                state, params = self._occupancy[key]
                nbytes += sum(x.nbytes for x in state)
                mem.save_occupancy_field(path, state, traj=t, **params)
            for epoch, (X, V, idx, n_m, n_f) in self._poses.get(
                    key, {}).items():
                poses = (X[:n_f] if n_f else X, V[:n_f] if n_f else V,
                         idx[:n_m] if n_m else idx)
                nbytes += sum(x.nbytes for x in poses)
                mem.save_poses(path, epoch, *poses, traj=t)
            mem.flush()
            if held:
                _remove_past(mem.frames_dir(path, t), n)
                _remove_past(mem._dir(path, "depths", t), n_d)
                for kind, name, snaps in (
                        ("surface", "scene.npz", self._surface),
                        ("occupancy", "field.npz", self._occupancy)):
                    f = os.path.join(mem._dir(path, kind, t), name)
                    if key not in snaps and os.path.exists(f):
                        os.remove(f)
        return nbytes


def _remove_past(directory: str, n: int):
    """Remove ``directory``'s numbered files <i>.npz from i = n on (those
    of a longer trajectory that an earlier epoch left in the slot)."""
    for f in os.listdir(directory):
        stem, ext = os.path.splitext(f)
        if ext == ".npz" and stem.isdigit() and int(stem) >= n:
            os.remove(os.path.join(directory, f))
