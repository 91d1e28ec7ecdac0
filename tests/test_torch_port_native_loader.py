"""The port's native file loader and the disk memory's queued writes, on the
CPU.

``utils/native_loader.py``: the bytes of files read on the C++ threads, a
missing file raising ``IOError``, ``take_npz`` against the JAX package's
``take_npz`` on the same files (the JAX loader is not built: its parser is
given the file's bytes), the build landing in the port's build directory
(the JAX package's tracked library untouched) and a failed build raising
with the compiler's message. ``scene/memory.py:Memory``: a frame sequence
read while its writes are still queued waits for them, the listings count
them, and files each package writes are read by the other, array for
array.
"""

import os
import threading

import numpy as np
import pytest
import torch

from macarons_tpu.scene.memory import Memory as JMemory
from macarons_tpu.utils import native_loader as jnl
from macarons_tpu_torch.scene.memory import Memory
from macarons_tpu_torch.utils import native_loader as nl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_LIBRARY = os.path.join(REPO, "native", "libasync_loader.so")


def write_npz_files(tmp_path, n, seed):
    rs = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        p = str(tmp_path / f"{i}.npz")
        np.savez(p, a=rs.normal(size=(3, i + 1)).astype(np.float32),
                 b=rs.integers(0, 9, size=(i + 2,)), c=np.float32(i))
        paths.append(p)
    return paths


class BytesLoader:
    """What JAX take_npz asks of a loader, reading the file itself."""

    def take(self, path):
        with open(path, "rb") as f:
            return f.read()


def test_loader_reads_bytes_and_npz(tmp_path):
    before = (open(JAX_LIBRARY, "rb").read(), os.stat(JAX_LIBRARY).st_mtime)
    loader = nl.AsyncLoader(n_threads=3)
    blobs = [os.urandom(n) for n in (0, 1, 4096, 100_003)]
    paths = []
    for i, b in enumerate(blobs):
        paths.append(str(tmp_path / f"blob{i}"))
        with open(paths[-1], "wb") as f:
            f.write(b)
    jobs = [loader.submit(p) for p in paths]
    assert [loader.take(j) for j in reversed(jobs)] == blobs[::-1]

    npz = write_npz_files(tmp_path, 5, 0)
    got = [nl.take_npz(loader, j) for j in nl.prefetch_npz(loader, npz)]
    for p, ours in zip(npz, got):
        ref = jnl.take_npz(BytesLoader(), p)
        assert set(ours) == set(ref)
        for k in ref:
            assert ours[k].dtype == ref[k].dtype
            np.testing.assert_array_equal(ours[k], ref[k])

    missing = loader.submit(str(tmp_path / "absent.npz"))
    with pytest.raises(IOError):
        loader.take(missing)
    # The loader goes on after a failed read.
    assert loader.take(loader.submit(paths[2])) == blobs[2]
    loader.close()
    assert os.path.dirname(nl.LIBRARY) == os.path.join(
        REPO, "macarons_tpu_torch", "_build", "async_loader")
    assert os.path.exists(nl.LIBRARY)
    assert (open(JAX_LIBRARY, "rb").read(),
            os.stat(JAX_LIBRARY).st_mtime) == before


def test_loader_build(tmp_path, monkeypatch):
    """A build into a fresh directory, and a broken source raising the
    compiler's message (no fallback)."""
    before = (open(JAX_LIBRARY, "rb").read(), os.stat(JAX_LIBRARY).st_mtime)
    monkeypatch.setattr(nl, "LIBRARY", str(tmp_path / "a" / "lib.so"))
    assert nl.build() == nl.LIBRARY and os.path.getsize(nl.LIBRARY) > 0
    mtime = os.stat(nl.LIBRARY).st_mtime_ns
    assert nl.build() == nl.LIBRARY  # up to date: not built again
    assert os.stat(nl.LIBRARY).st_mtime_ns == mtime
    broken = tmp_path / "broken.cpp"
    broken.write_text("int f( { return 0; }\n")
    monkeypatch.setattr(nl, "SOURCE", str(broken))
    monkeypatch.setattr(nl, "LIBRARY", str(tmp_path / "b" / "lib.so"))
    with pytest.raises(RuntimeError, match="broken.cpp"):
        nl.build()
    assert not os.path.exists(nl.LIBRARY)
    assert (open(JAX_LIBRARY, "rb").read(),
            os.stat(JAX_LIBRARY).st_mtime) == before


def frames(seed, K=5, H=6, W=8):
    rs = np.random.default_rng(seed)
    return dict(rgb=rs.uniform(size=(K, H, W, 3)).astype(np.float32),
                zbuf=rs.uniform(1, 5, size=(K, H, W, 1)).astype(np.float32),
                mask=rs.uniform(size=(K, H, W, 1)) > 0.5,
                R=rs.normal(size=(K, 3, 3)).astype(np.float32),
                T=rs.normal(size=(K, 3)).astype(np.float32))


def test_queued_writes_and_reads(tmp_path):
    """Writes held behind a closed gate on both writer threads: the files
    are not there, the read of the sequence waits for them and returns
    the frames; the directory listing flushes; the JAX Memory reads the
    port's files and the port the JAX Memory's, array for array."""
    path = str(tmp_path / "mem")
    mem = Memory([path], n_trajectories=1)
    gate = threading.Event()
    blockers = [Memory._writer().submit(gate.wait) for _ in range(2)]
    fr = frames(1)
    # Torch tensors, changed after the call: the queued write keeps the
    # values it was given.
    tensors = {k: torch.tensor(v) for k, v in fr.items()}
    mem.save_frame_batch(path, 0, *(tensors[k] for k in
                                    ("rgb", "zbuf", "mask", "R", "T")), 40.0)
    tensors["rgb"].zero_()
    first = os.path.join(mem.frames_dir(path), "0.npz")
    assert not os.path.exists(first)
    opener = threading.Timer(0.2, gate.set)
    opener.start()
    seq = mem.load_frame_sequence(path, 3, 3)
    for b in blockers:
        b.result()
    for k, key in (("rgb", "images"), ("zbuf", "zbuf"), ("mask", "mask"),
                   ("R", "R"), ("T", "T")):
        np.testing.assert_array_equal(seq[key], fr[k][1:4])
    np.testing.assert_array_equal(seq["zfar"], np.full(3, 40.0, np.float32))
    assert mem.n_frames(path) == 5

    jpath = str(tmp_path / "jmem")
    jmem = JMemory([jpath], n_trajectories=1)
    jfr = frames(2)
    jmem.save_frame_batch(jpath, 0, *(jfr[k] for k in
                                      ("rgb", "zbuf", "mask", "R", "T")), 40.0)
    jmem.flush()
    for reader, writer, p in ((JMemory([path]), mem, path),
                              (Memory([jpath]), jmem, jpath)):
        for last, n in ((2, 3), (4, 5), (4, 1)):
            a = reader.load_frame_sequence(p, last, n)
            b = writer.load_frame_sequence(p, last, n)
            assert set(a) == set(b)
            for k in a:
                assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
                np.testing.assert_array_equal(a[k], b[k])
    # A rewrite of a file waits for its queued write, then replaces it.
    mem.save_frame_batch(path, 0, *(jfr[k][:1] for k in
                                    ("rgb", "zbuf", "mask", "R", "T")), 40.0)
    np.testing.assert_array_equal(mem.load_frame(path, 0)["rgb"],
                                  jfr["rgb"][:1])
    mem.flush()
    assert not Memory._inflight
