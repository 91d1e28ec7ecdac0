"""Real (tesseral) spherical harmonics (port of macarons_tpu/ops/harmonics.py).

Same conventions and packing as the JAX package: Condon-Shortley phase in
P_l^m, l-major packing with m from -l to l, degree**2 coefficients (64 for
degree 8), theta = pi/2 - elev, phi = azim.

``sh_weighted_sum`` is the plain PyTorch twin of the CUDA SH-visibility
kernel (ops/cuda/sh_visibility.py): the same algebraic angles, Legendre and
Chebyshev recurrences and clamps (the kernel folds the normalisations into
its Legendre recurrences, so the two differ in rounding only).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _double_factorial(n: int) -> float:
    out = 1.0
    while n > 1:
        out *= n
        n -= 2
    return out


def sh_norms(degree: int = 8):
    """[(l, m, N_lm)] in packing order; N_lm includes sqrt(2 (l-|m|)!/(l+|m|)!)
    for m != 0."""
    out = []
    for l in range(degree):
        N = math.sqrt((2 * l + 1) / (4 * math.pi))
        for m in range(-l, l + 1):
            if m == 0:
                out.append((l, m, N))
            else:
                a = abs(m)
                out.append((l, m, N * math.sqrt(
                    2.0 * math.factorial(l - a) / math.factorial(l + a))))
    return out


def _assoc_legendre_all(ct, st, max_l: int, ones_like):
    """{(l, m): P_l^m(cos theta)} for 0 <= m <= l < max_l."""
    P = {(0, 0): ones_like(ct)}
    for m in range(1, max_l):
        P[(m, m)] = ((-1.0) ** m) * _double_factorial(2 * m - 1) * (st ** m)
    for m in range(0, max_l - 1):
        P[(m + 1, m)] = (2 * m + 1) * ct * P[(m, m)]
    for m in range(0, max_l):
        for l in range(m + 2, max_l):
            P[(l, m)] = ((2 * l - 1) * ct * P[(l - 1, m)]
                         - (l + m - 1) * P[(l - 2, m)]) / (l - m)
    return P


def _sh_stack(ct, st, cos_m, sin_m, degree, ones_like, stack):
    P = _assoc_legendre_all(ct, st, degree, ones_like)
    outs = []
    for l, m, norm in sh_norms(degree):
        if m == 0:
            outs.append(norm * P[(l, 0)])
        else:
            ang = cos_m[abs(m)] if m > 0 else sin_m[abs(m)]
            outs.append(norm * ang * P[(l, abs(m))])
    return stack(outs)


def real_spherical_harmonics(theta, phi, degree: int = 8):
    """All real SH with l < degree at (theta, phi) -> (..., degree**2)."""
    ct, st = torch.cos(theta), torch.sin(theta)
    cos_m = {m: torch.cos(m * phi) for m in range(1, degree)}
    sin_m = {m: torch.sin(m * phi) for m in range(1, degree)}
    return _sh_stack(ct, st, cos_m, sin_m, degree, torch.ones_like,
                     lambda xs: torch.stack(xs, dim=-1))


def real_spherical_harmonics_np(theta, phi, degree: int = 8):
    """Host numpy twin (float64 math, float32 result) for constant tables."""
    theta = np.asarray(theta, np.float64)
    phi = np.asarray(phi, np.float64)
    cos_m = {m: np.cos(m * phi) for m in range(1, degree)}
    sin_m = {m: np.sin(m * phi) for m in range(1, degree)}
    out = _sh_stack(np.cos(theta), np.sin(theta), cos_m, sin_m, degree,
                    np.ones_like, lambda xs: np.stack(xs, axis=-1))
    return out.astype(np.float32)


def harmonics_from_directions(rays, degree: int = 8):
    """Real SH of the directions of ``rays`` (..., 3)."""
    from .geometry import get_spherical_coords

    _, elev, azim = get_spherical_coords(rays)
    return real_spherical_harmonics(math.pi / 2.0 - elev, azim, degree=degree)


def _basis_terms(rays, degree: int):
    """The basis terms Y_k of the directions of ``rays`` (..., 3), in
    packing order, with the kernel's algebraic angles and clamps."""
    x, y, z = rays[..., 0], rays[..., 1], rays[..., 2]
    r2 = x * x + y * y + z * z
    inv_r = torch.rsqrt(torch.clamp(r2, min=1e-20))
    ct = torch.clamp(y * inv_r, -1.0, 1.0)
    st = torch.sqrt(torch.clamp(1.0 - ct * ct, min=0.0))
    inv_rst = inv_r / torch.clamp(st, min=1e-10)
    cphi = torch.clamp(z * inv_rst, -1.0, 1.0)
    sphi = torch.clamp(x * inv_rst, -1.0, 1.0)

    P = _assoc_legendre_all(ct, st, degree, torch.ones_like)
    cos_m = {0: torch.ones_like(cphi), 1: cphi}
    sin_m = {0: torch.zeros_like(sphi), 1: sphi}
    for m in range(2, degree):
        cos_m[m] = cphi * cos_m[m - 1] - sphi * sin_m[m - 1]
        sin_m[m] = sphi * cos_m[m - 1] + cphi * sin_m[m - 1]

    for l, m, norm in sh_norms(degree):
        if m == 0:
            yield norm * P[(l, 0)]
        else:
            ang = cos_m[abs(m)] if m > 0 else sin_m[abs(m)]
            yield norm * ang * P[(l, abs(m))]


def sh_weighted_sum(rays, coeffs, degree: int = 8):
    """sum_k coeffs[..., k] * Y_k(dir(rays)) without materialising the basis.

    rays (..., 3); coeffs broadcastable to rays[..., 0].shape + (degree**2,)."""
    acc = torch.zeros_like(rays[..., 0])
    for k, Y in enumerate(_basis_terms(rays, degree)):
        acc = acc + coeffs[..., k] * Y
    return acc


def sh_basis(rays, degree: int = 8):
    """The basis of ``sh_weighted_sum`` materialised: (..., degree**2)."""
    return torch.stack(list(_basis_terms(rays, degree)), dim=-1)
