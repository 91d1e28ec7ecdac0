"""Device selection for the port's entry points.

Entry points default to CUDA and never fall back to the CPU on their own: a
caller that wants the CPU (the tests) passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional

import torch


def resolve_device(device="cuda") -> torch.device:
    """Return ``torch.device(device)``; raise if it is CUDA and CUDA is absent.

    On CUDA, TF32 is switched off for matmuls and convolutions: the geometry
    and kNN code are parity-critical (the JAX package forces
    ``precision=HIGHEST`` there) and the networks are held to float32.
    bfloat16 matmuls (``occ_compute_dtype``) keep float32 accumulation:
    cuBLAS may not reduce their split sums in a reduced type, as the CPU
    does not."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
    return dev


def compute_dtype(name) -> Optional[torch.dtype]:
    """The type a ``*_compute_dtype`` config key names: None for None,
    "none" and "float32" (the float32 path), else the named floating torch
    type ("bfloat16"). Any other name raises, as ``jnp.dtype`` does."""
    if name in (None, "none", "float32"):
        return None
    dtype = getattr(torch, str(name), None)
    if not (isinstance(dtype, torch.dtype) and dtype.is_floating_point):
        raise TypeError(f"not a floating type: {name!r}")
    return dtype


def make_generator(device: torch.device, seed: int) -> torch.Generator:
    """A seeded generator on ``device`` (every random draw takes one)."""
    return torch.Generator(device=device).manual_seed(int(seed))
