"""SH visibility: the CUDA kernel's wrapper and its plain PyTorch twin.

Port of macarons_tpu/ops/pallas/sh_visibility.py (``pallas_compute_visibilities``),
batched to serve ``models.scone.compute_visibilities`` in both scorer modes:
per candidate ``(C_pad, 1, L)`` and shared sample ``(1, C, L)``.

A CUDA tensor goes to the hand-written kernel (csrc/sh_visibility.cu), launched
as ``forward_plan`` says; a CPU tensor goes to ``compute_visibilities_plain``,
which computes the same function with the JAX package's arithmetic (the
kernel folds the normalisations into its Legendre recurrences and sums order
by order, so the two differ in rounding only). A failed build or launch
raises.

The visibility is differentiable in the coefficients only: the points and
camera centres are proxy positions and camera centres, which no loss
differentiates, and the wrapper raises if either requires grad. On CUDA
tensors an autograd Function saves the output and its backward launches
``sh_visibility_backward_kernel`` (the same source); on CPU tensors autograd
differentiates the plain forward. ``sh_visibility_backward_plain`` is the
backward kernel's plain twin.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from fractions import Fraction
from typing import NamedTuple

import torch

from ..harmonics import sh_basis, sh_weighted_sum
from .build import load_library

N_HARMONICS = 64
MAX_HARMONIC_RANK = 8

# Float operations per output, counted from the kernel body (an FMA counts
# two): ray, norm and algebraic angles 17; order 0's Legendre recurrence 26
# and its 8 terms 16; orders 1-7: the Chebyshev and sin^m chains 42,
# Pbar_m^m 7, the Legendre recurrences 72, the 56 terms 112, the two
# products with cos and sin per order 28; sigmoid 4.
FLOPS_PER_OUTPUT = 324
# Float operations per (batch, camera, point) of the backward: the same
# angles and recurrences 164, the 56 products with cos and sin of the terms
# of orders 1-7, the 64 terms times the scaled gradient and their sums 128,
# the activation's derivative 3.
BACKWARD_FLOPS_PER_PAIR = 351


def compute_visibilities_plain(pts, harmonics, X_cam, use_sigmoid: bool = True):
    """pts (B, L, >=3), harmonics (B, L, 64), X_cam (B, C, 3) -> (B, C, L)."""
    rays = X_cam[:, :, None, :] - pts[:, None, :, :3]
    z = sh_weighted_sum(rays, harmonics[:, None], degree=MAX_HARMONIC_RANK)
    return torch.sigmoid(z) if use_sigmoid else torch.relu(z)


def sh_visibility_backward_plain(pts, X_cam, out, grad_out,
                                 use_sigmoid: bool = True):
    """The backward kernel's plain twin: grad_harmonics (B, L, 64) =
    sum_c grad_out act'(out) Y(X_cam - pts), with act' = out (1 - out) for
    sigmoid and (out > 0) for relu."""
    rays = X_cam[:, :, None, :] - pts[:, None, :, :3]
    dact = out * (1.0 - out) if use_sigmoid else (out > 0).to(out.dtype)
    basis = sh_basis(rays, degree=MAX_HARMONIC_RANK)  # (B, C, L, 64)
    return torch.einsum("bcl,bclk->blk", grad_out * dact, basis)


_ARGTYPES = {
    # pts, pts_stride, harm, cam, out, B, C, L, points, slices, chunk,
    # use_sigmoid, stream
    "macarons_sh_visibility": [ctypes.c_void_p, ctypes.c_int]
    + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    # pts, pts_stride, cam, out, grad_out, grad_harm, B, C, L, use_sigmoid,
    # stream
    "macarons_sh_visibility_backward": [ctypes.c_void_p, ctypes.c_int]
    + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
}


def _function(symbol: str):
    fn = getattr(load_library("macarons_sh_visibility", "sh_visibility.cu"),
                 symbol)
    fn.argtypes = _ARGTYPES[symbol]
    fn.restype = ctypes.c_int
    return fn


def build(verbose: bool = False):
    """Compile both kernels now (``verbose`` prints the ptxas report)."""
    load_library("macarons_sh_visibility", "sh_visibility.cu", verbose=verbose)


# The forward's launch geometry (csrc/sh_visibility.cu, sh_visibility_kernel).
MAX_FORWARD_THREADS = 256  # threads per block, the kernel's launch bound
BLOCK_THREADS = 128  # threads per block the plan aims at
N_SMS = 132  # the H100's streaming multiprocessors
FILL_THREADS = N_SMS * 1024  # (point, slice) threads that fill the SMs once
# A thread copies its point's coefficients to registers once for all its
# cameras: at least two each, where there are two.
MIN_CAMERAS_PER_SLICE = 2
MAX_CHUNK = 1024  # camera centres staged at a time (12 KB)
MAX_GRID = 2**31 - 1  # CUDA's limit on gridDim.x
MAX_SMEM_BYTES = 48 * 1024  # the kernel's shared memory, at most
ROW_FLOATS = N_HARMONICS + 4  # a staged coefficient row


class ForwardPlan(NamedTuple):
    """Block b * tiles + i covers points [i * points, (i + 1) * points) of
    batch b with points * slices threads; thread t takes point t % points
    and the cameras c = t // points + k * slices. The camera centres are
    staged chunk (a multiple of slices) at a time."""

    points: int
    slices: int
    chunk: int
    tiles: int
    blocks: int

    @property
    def threads(self) -> int:
        return self.points * self.slices

    @property
    def smem_bytes(self) -> int:
        return 4 * (self.points * ROW_FLOATS + 3 * self.chunk)


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def forward_plan(B: int, C: int, L: int) -> ForwardPlan:
    """The forward kernel's launch geometry for (B, C, L).

    A point's cameras are dealt to ``slices`` threads so that the B * L
    points' threads fill the card about once (FILL_THREADS), each slice
    taking the same count of cameras, ceil(C / slices), and at least
    MIN_CAMERAS_PER_SLICE where C allows; at C = 1 it is one thread per
    output. A block holds ``points`` points' slices: the fewest idle lanes
    in its last warp, then the nearest to BLOCK_THREADS threads, or to
    half as many (down to 32) while the grid has fewer blocks than the
    card has SMs. Raises if the grid exceeds CUDA's limit."""
    if min(B, C, L) < 1:
        raise ValueError(f"empty shape {(B, C, L)}")
    slices = max(1, min(_ceil_div(C, MIN_CAMERAS_PER_SLICE),
                        MAX_FORWARD_THREADS, _ceil_div(FILL_THREADS, B * L)))
    per_slice = _ceil_div(C, slices)
    slices = _ceil_div(C, per_slice)
    chunk = slices * min(per_slice, max(1, MAX_CHUNK // slices))
    # The block's lanes in use, then its closeness to the target, within
    # the 48 KB of shared memory a block takes without opting in; the target
    # halves while the grid would leave SMs without a block.
    most = min(MAX_FORWARD_THREADS // slices,
               (MAX_SMEM_BYTES // 4 - 3 * chunk) // ROW_FLOATS)
    target = BLOCK_THREADS
    while True:
        points = max(range(1, most + 1),
                     key=lambda p: (Fraction(p * slices,
                                             32 * _ceil_div(p * slices, 32)),
                                    -abs(p * slices - target)))
        tiles = _ceil_div(L, points)
        if target <= 32 or B * tiles >= N_SMS:
            break
        target //= 2
    if B * tiles > MAX_GRID:
        raise ValueError(f"grid too large: {B * tiles} blocks for "
                         f"(B, C, L) = {(B, C, L)}")
    return ForwardPlan(points, slices, chunk, tiles, B * tiles)


def _check(pts, harmonics, X_cam):
    B, L, P = pts.shape
    C = X_cam.shape[1]
    if ((harmonics is not None and harmonics.shape != (B, L, N_HARMONICS))
            or X_cam.shape != (B, C, 3) or P < 3):
        raise ValueError(f"bad shapes pts {tuple(pts.shape)}, harmonics "
                         f"{None if harmonics is None else tuple(harmonics.shape)}"
                         f", X_cam {tuple(X_cam.shape)}")
    for t in (pts, harmonics, X_cam):
        if t is not None and (t.dtype != torch.float32
                              or t.device != pts.device):
            raise ValueError("sh_visibility takes float32 tensors on one device")


def _launch(symbol: str, device, *args):
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _function(symbol)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{symbol} kernel launch failed: CUDA error {err}")


def _forward_kernel(pts, harmonics, X_cam, use_sigmoid: bool):
    B, L, P = pts.shape
    C = X_cam.shape[1]
    out = torch.empty((B, C, L), dtype=torch.float32, device=pts.device)
    if out.numel() == 0:
        return out
    plan = forward_plan(B, C, L)
    pts, harmonics, X_cam = (pts.contiguous(), harmonics.contiguous(),
                             X_cam.contiguous())
    if harmonics.data_ptr() % 16:  # the kernel loads rows 16 bytes a lane
        harmonics = harmonics.clone()
    _launch("macarons_sh_visibility", pts.device, pts.data_ptr(), P,
            harmonics.data_ptr(), X_cam.data_ptr(), out.data_ptr(), B, C, L,
            plan.points, plan.slices, plan.chunk, int(bool(use_sigmoid)))
    sh_visibility.launches += 1
    sh_visibility.launches_at[(B, C, L)] += 1
    return out


def sh_visibility_backward(pts, X_cam, out, grad_out, use_sigmoid: bool = True):
    """Gradient of the coefficients: pts (B, L, P>=3), X_cam (B, C, 3), the
    forward's output and its gradient (B, C, L) -> (B, L, 64). CPU tensors
    take the plain twin; CUDA tensors launch the backward kernel (counted in
    ``sh_visibility_backward.launches``, and by (B, C, L) in
    ``sh_visibility_backward.launches_at``)."""
    if pts.device.type == "cpu":
        return sh_visibility_backward_plain(pts, X_cam, out, grad_out,
                                            use_sigmoid)
    if pts.device.type != "cuda":
        raise ValueError(f"unsupported device {pts.device}")
    _check(pts, None, X_cam)
    B, L, P = pts.shape
    C = X_cam.shape[1]
    if out.shape != (B, C, L) or grad_out.shape != (B, C, L):
        raise ValueError(f"bad shapes out {tuple(out.shape)}, grad "
                         f"{tuple(grad_out.shape)} for (B, C, L) = "
                         f"{(B, C, L)}")
    pts, X_cam = pts.contiguous(), X_cam.contiguous()
    out, grad_out = out.contiguous(), grad_out.float().contiguous()
    grad = torch.empty((B, L, N_HARMONICS), dtype=torch.float32,
                       device=pts.device)
    _launch("macarons_sh_visibility_backward", pts.device, pts.data_ptr(), P,
            X_cam.data_ptr(), out.data_ptr(), grad_out.data_ptr(),
            grad.data_ptr(), B, C, L, int(bool(use_sigmoid)))
    sh_visibility_backward.launches += 1
    sh_visibility_backward.launches_at[(B, C, L)] += 1
    return grad


sh_visibility_backward.launches = 0
sh_visibility_backward.launches_at = Counter()


class _SHVisibility(torch.autograd.Function):
    """The forward kernel, differentiated by the backward kernel."""

    @staticmethod
    def forward(ctx, pts, harmonics, X_cam, use_sigmoid):
        out = _forward_kernel(pts, harmonics, X_cam, use_sigmoid)
        ctx.save_for_backward(pts, X_cam, out)
        ctx.use_sigmoid = use_sigmoid
        return out

    @staticmethod
    def backward(ctx, grad_out):
        pts, X_cam, out = ctx.saved_tensors
        return (None, sh_visibility_backward(pts, X_cam, out, grad_out,
                                             ctx.use_sigmoid), None, None)


def sh_visibility(pts, harmonics, X_cam, use_sigmoid: bool = True):
    """Visibility of every point from every camera, batched.

    pts (B, L, P>=3) float32, harmonics (B, L, 64) float32, X_cam (B, C, 3)
    float32 -> (B, C, L): act(sum_k harmonics[b, l, k] Y_k(X_cam[b, c] -
    pts[b, l])) with act = sigmoid or relu. CPU tensors take the plain twin;
    CUDA tensors launch the kernel (counted in ``sh_visibility.launches``,
    and by (B, C, L) in ``sh_visibility.launches_at``), differentiable in
    ``harmonics``. Raises if ``pts`` or ``X_cam`` requires grad."""
    if torch.is_grad_enabled() and (pts.requires_grad or X_cam.requires_grad):
        raise ValueError("sh_visibility differentiates the coefficients "
                         "only: pts and X_cam must not require grad")
    if pts.device.type == "cpu":
        return compute_visibilities_plain(pts, harmonics, X_cam, use_sigmoid)
    if pts.device.type != "cuda":
        raise ValueError(f"unsupported device {pts.device}")
    _check(pts, harmonics, X_cam)
    return _SHVisibility.apply(pts, harmonics, X_cam, bool(use_sigmoid))


sh_visibility.launches = 0
sh_visibility.launches_at = Counter()


def flops(B: int, C: int, L: int) -> int:
    return FLOPS_PER_OUTPUT * B * C * L


def bytes_moved(B: int, C: int, L: int, P: int = 3) -> int:
    """Each input read once and the output written once, float32."""
    return 4 * (B * L * P + B * L * N_HARMONICS + B * C * 3 + B * C * L)


def backward_flops(B: int, C: int, L: int) -> int:
    return BACKWARD_FLOPS_PER_PAIR * B * C * L


def backward_bytes_moved(B: int, C: int, L: int, P: int = 3) -> int:
    """pts, X_cam, the output and its gradient read once, grad_harmonics
    written once, float32."""
    return 4 * (B * L * P + B * C * 3 + 2 * B * C * L + B * L * N_HARMONICS)
