"""The native async file loader of the replay memory, through ctypes (port
of macarons_tpu/utils/native_loader.py).

``csrc/async_loader.cpp`` is compiled with ``g++ -O2 -shared -fPIC
-pthread`` at first use into ``macarons_tpu_torch/_build/async_loader/``
(again when the source is newer than the library). There is no Python
fallback: a failed build raises with the compiler's message, so a run
never goes without the loader unnoticed. ``AsyncLoader`` reads whole files
on a pool of C++ threads; ``prefetch_npz`` and ``take_npz`` serve
``scene.memory.Memory.load_frame_sequence``.
"""

from __future__ import annotations

import ctypes
import io
import os
import subprocess
import threading
from typing import Dict, List, Optional

import numpy as np

from ..ops.cuda.build import BUILD_DIR, CSRC_DIR

SOURCE = os.path.join(CSRC_DIR, "async_loader.cpp")
LIBRARY = os.path.join(BUILD_DIR, "async_loader", "libasync_loader.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def build() -> str:
    """Compile the loader unless an up-to-date library is there; returns
    its path. The library is written under a temporary name and moved into
    place, so processes building at once never load a half-written file."""
    if (os.path.exists(LIBRARY)
            and os.path.getmtime(LIBRARY) >= os.path.getmtime(SOURCE)):
        return LIBRARY
    os.makedirs(os.path.dirname(LIBRARY), exist_ok=True)
    tmp = f"{LIBRARY}.{os.getpid()}.{threading.get_ident()}.tmp"
    res = subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-pthread",
                          "-o", tmp, SOURCE], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"building {SOURCE} failed:\n{res.stderr}")
    os.replace(tmp, LIBRARY)
    return LIBRARY


def load_library() -> ctypes.CDLL:
    """The loader's library, built and opened once per process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.al_create.restype = ctypes.c_void_p
            lib.al_create.argtypes = [ctypes.c_int]
            lib.al_destroy.argtypes = [ctypes.c_void_p]
            lib.al_submit.restype = ctypes.c_int64
            lib.al_submit.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
            lib.al_wait.restype = ctypes.c_int
            lib.al_wait.argtypes = [ctypes.c_void_p, ctypes.c_int64]
            lib.al_data.restype = ctypes.c_int
            lib.al_data.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                    ctypes.POINTER(ctypes.c_void_p),
                                    ctypes.POINTER(ctypes.c_int64)]
            lib.al_release.argtypes = [ctypes.c_void_p, ctypes.c_int64]
            _lib = lib
        return _lib


class AsyncLoader:
    """Whole files read on ``n_threads`` C++ threads: ``submit(path)``
    queues a read and returns its job id, ``take(job)`` waits for it and
    returns the bytes (``IOError`` if the file could not be read)."""

    def __init__(self, n_threads: int = 4):
        self._lib = load_library()
        self._handle = self._lib.al_create(n_threads)

    def submit(self, path: str) -> int:
        return int(self._lib.al_submit(self._handle, os.fsencode(path)))

    def take(self, job_id: int) -> bytes:
        """The job's bytes, copied once out of the loader's buffer."""
        try:
            data, size = ctypes.c_void_p(), ctypes.c_int64()
            if (self._lib.al_wait(self._handle, job_id) != 1
                    or self._lib.al_data(self._handle, job_id,
                                         ctypes.byref(data),
                                         ctypes.byref(size)) != 1):
                raise IOError(
                    f"the native loader could not read job {job_id}")
            return (ctypes.string_at(data.value, size.value) if size.value
                    else b"")
        finally:
            self._lib.al_release(self._handle, job_id)

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.al_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def prefetch_npz(loader: AsyncLoader, paths: List[str]) -> List[int]:
    """Queue a batch of ``.npz`` files; pair with ``take_npz``."""
    return [loader.submit(p) for p in paths]


def take_npz(loader: AsyncLoader, job_id: int) -> Dict[str, np.ndarray]:
    with np.load(io.BytesIO(loader.take(job_id))) as z:
        return {k: z[k] for k in z.files}
