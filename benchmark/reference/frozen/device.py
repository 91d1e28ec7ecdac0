"""The floating type that a ``*_compute_dtype`` config key names."""

from __future__ import annotations

from typing import Optional

import torch


def compute_dtype(name) -> Optional[torch.dtype]:
    """None for None, "none" and "float32" (the float32 path), else the
    named floating torch type."""
    if name in (None, "none", "float32"):
        return None
    dtype = getattr(torch, str(name), None)
    if not (isinstance(dtype, torch.dtype) and dtype.is_floating_point):
        raise TypeError(f"not a floating type: {name!r}")
    return dtype
