"""Build and load the port's CUDA kernels at first use.

Each kernel source under ``macarons_tpu_torch/csrc/`` has a plain C
interface (no PyTorch headers, so ``nvcc`` takes seconds). It is compiled for
Hopper (``sm_90a``) by ``torch.utils.cpp_extension.load`` into
``macarons_tpu_torch/_build/<name>/`` and opened with ``ctypes``; a source
may add its own ``nvcc`` flags. Nothing is built when a module is imported:
the CPU path never needs a compiler. Different sources build in parallel
when their first uses come from different threads; processes (the ranks of
a data-parallel run) take a file lock per source, so one builds and the
others then load its library.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import threading

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(CSRC_DIR), "_build")
CUDA_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a"]

_libs: dict = {}
_locks: dict = {}
_lock = threading.Lock()


def load_library(name: str, source: str, extra_flags=(),
                 verbose: bool = False) -> ctypes.CDLL:
    """Compile ``csrc/<source>`` once per process and return it as a CDLL.

    ``extra_flags`` are added to ``nvcc``'s for this source. ``verbose``
    prints the build log, including ``ptxas`` register and shared-memory
    usage. A failed build raises; there is no fallback."""
    with _lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        from torch.utils.cpp_extension import load

        build_dir = os.path.join(BUILD_DIR, name)
        os.makedirs(build_dir, exist_ok=True)
        flags = (CUDA_FLAGS + list(extra_flags)
                 + (["-Xptxas=-v"] if verbose else []))
        with open(os.path.join(BUILD_DIR, f"{name}.lock"), "w") as held:
            fcntl.flock(held, fcntl.LOCK_EX)
            path = load(name=name, sources=[os.path.join(CSRC_DIR, source)],
                        extra_cuda_cflags=flags, build_directory=build_dir,
                        is_python_module=False, verbose=verbose)
        lib = ctypes.CDLL(path)
        _libs[name] = lib
        return lib
