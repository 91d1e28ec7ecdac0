"""ResNet-18 pieces of the depth network (port of
macarons_tpu/models/resnet.py).

NCHW, PyTorch's layout; the submodules carry the names Flax gives their
counterparts, so a Flax variables tree maps onto a ``state_dict`` by path
(utils.convert.flax_to_torch). BatchNorm is Flax's (``FlaxBatchNorm2d``):
eps 1e-5; in eval mode it normalises with the running statistics, in train
mode with the batch's, and updates the running ones as Flax does; over
data-parallel ranks the batch is the union of every rank's.

``dtype`` (None or ``torch.bfloat16``) is the convolutions' compute type,
as Flax's ``nn.Conv(dtype=...)``: a conv casts its input, weight and bias
to it, and the parameters stay float32. BatchNorm always computes in its
parameters' type, so a block's output is float32 whatever its convs ran in.
``convert_torch_resnet18`` maps a torchvision resnet18 state dict onto these
modules.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel import mesh


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in ``compute_dtype`` if one is given, else in
    its weight's type; its input is cast either way (a Flax conv without a
    dtype promotes a bfloat16 input to its float32 kernel)."""

    def __init__(self, *args, compute_dtype: Optional[torch.dtype] = None,
                 **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype or self.weight.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm with Flax's training arithmetic.

    Train mode normalises with the batch mean and the biased batch variance
    E[x^2] - E[x]^2 (clipped at 0), as ``flax.linen.BatchNorm`` computes
    them, and updates running = 0.9 running + 0.1 batch with that same
    biased variance. ``nn.BatchNorm2d`` would update the running variance
    with the unbiased one, so a converted checkpoint would train to other
    statistics. Eval mode is ``nn.BatchNorm2d``'s. The input is cast to the
    parameters' type first: BatchNorm stays float32 under bfloat16 convs, as
    in the JAX package."""

    def forward(self, x):
        x = x.to(self.weight.dtype)
        if not self.training:
            return super().forward(x)
        y, mean, var = _RankBatchNorm.apply(x, self.weight, self.bias,
                                            self.eps)
        with torch.no_grad():
            self.running_mean.mul_(1.0 - self.momentum).add_(
                self.momentum * mean)
            self.running_var.mul_(1.0 - self.momentum).add_(
                self.momentum * var)
            self.num_batches_tracked += 1
        return y


class _RankBatchNorm(torch.autograd.Function):
    """Flax's train-mode BatchNorm over the union of every rank's batch
    (one process's batch outside a data-parallel group).

    Forward: (sum x, sum x^2, count) per channel summed over the ranks,
    mean = E[x], var = max(E[x^2] - E[x]^2, 0). Backward: with
    xh = (x - mean) / sqrt(var + eps) and g = dy * weight, the global
    sums (sum g, sum g xh) give dx = (g - E[g] - xh E[g xh]) / sqrt(var +
    eps); the weight's and bias's gradients are this rank's sums, which the
    gradient all-reduce adds up."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        C = x.shape[1]
        stats = torch.cat([x.sum(dim=(0, 2, 3)), (x * x).sum(dim=(0, 2, 3)),
                           x.new_full((1,), x.numel() / C)])
        mesh.all_reduce_(stats)
        n = stats[-1]
        mean = stats[:C] / n
        var = torch.clamp(stats[C:2 * C] / n - mean * mean, min=0.0)
        inv = torch.rsqrt(var + eps)
        xh = (x - mean[None, :, None, None]) * inv[None, :, None, None]
        ctx.save_for_backward(xh, inv, weight, n)
        return (xh * weight[None, :, None, None] + bias[None, :, None, None],
                mean, var)

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        xh, inv, weight, n = ctx.saved_tensors
        C = xh.shape[1]
        sums = torch.cat([dy.sum(dim=(0, 2, 3)),
                          (dy * xh).sum(dim=(0, 2, 3))])
        d_bias, d_weight = sums[:C].clone(), sums[C:].clone()
        mesh.all_reduce_(sums)
        mean_g = (sums[:C] * weight / n)[None, :, None, None]
        mean_gxh = (sums[C:] * weight / n)[None, :, None, None]
        g = dy * weight[None, :, None, None]
        dx = (g - mean_g - xh * mean_gxh) * inv[None, :, None, None]
        return dx, d_weight, d_bias, None


def batch_norm(features: int) -> FlaxBatchNorm2d:
    """Flax's BatchNorm(momentum=0.9, epsilon=1e-5): PyTorch's momentum is
    the weight of the batch, 0.1."""
    return FlaxBatchNorm2d(features, eps=1e-5, momentum=0.1)


def conv3x3(in_features: int, features: int, strides: int = 1,
            bias: bool = True, dtype: Optional[torch.dtype] = None) -> Conv2d:
    """3x3 conv with zero padding 1 (Flax ``padding=1``)."""
    return Conv2d(in_features, features, 3, stride=strides, padding=1,
                  bias=bias, compute_dtype=dtype)


class BasicBlock(nn.Module):
    """conv-bn-relu-conv-bn plus the shortcut; the shortcut is a strided 1x1
    conv (no padding, as Flax's ``SAME`` gives for a 1x1 kernel) and a BN
    wherever the block changes the shape."""

    def __init__(self, in_features: int, features: int, strides: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = conv3x3(in_features, features, strides, bias=False,
                             dtype=dtype)
        self.bn1 = batch_norm(features)
        self.conv2 = conv3x3(features, features, bias=False, dtype=dtype)
        self.bn2 = batch_norm(features)
        if strides != 1 or in_features != features:
            self.downsample_conv = Conv2d(in_features, features, 1,
                                          stride=strides, bias=False,
                                          compute_dtype=dtype)
            self.downsample_bn = batch_norm(features)
        else:
            self.downsample_conv = None

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.downsample_conv is not None:
            x = self.downsample_bn(self.downsample_conv(x))
        return F.relu(y + x)


class ResNetLayer(nn.Module):
    """A torchvision ``layerN``: two BasicBlocks, the first may downsample."""

    def __init__(self, in_features: int, features: int, strides: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.block0 = BasicBlock(in_features, features, strides, dtype)
        self.block1 = BasicBlock(features, features, dtype=dtype)

    def forward(self, x):
        return self.block1(self.block0(x))


class ResNet18Stem(nn.Module):
    """conv1 (7x7, stride 2) + bn1 + relu, before the max pool."""

    def __init__(self, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False,
                            compute_dtype=dtype)
        self.bn1 = batch_norm(64)

    def forward(self, x):
        return F.relu(self.bn1(self.conv1(x)))


def maxpool_3x3_s2(x):
    return F.max_pool2d(x, 3, stride=2, padding=1)


class FeatureExtractor(nn.Module):
    """conv1 .. layer1 of ResNet18: image (N, 3, H, W) -> 64 channels at a
    quarter of the resolution (and the stem's output at a half)."""

    def __init__(self, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.stem = ResNet18Stem(dtype)
        self.layer1 = ResNetLayer(64, 64, dtype=dtype)

    def forward(self, x, return_conv1: bool = False):
        conv1 = self.stem(x)
        y = self.layer1(maxpool_3x3_s2(conv1))
        return (y, conv1) if return_conv1 else y


# ---------------------------------------------------------------------------
# torchvision weights
# ---------------------------------------------------------------------------

_BN = ("weight", "bias", "running_mean", "running_var")


def convert_torch_resnet18(state_dict: Mapping[str, torch.Tensor]
                           ) -> Dict[str, Dict[str, torch.Tensor]]:
    """A torchvision resnet18 state dict (tensors or numpy arrays) -> the
    state dicts of ``ResNet18Stem`` (``"stem"``) and of the four
    ``ResNetLayer`` s (``"layer1"`` .. ``"layer4"``), each ready for
    ``load_state_dict``. Convolutions keep their OIHW layout; a BatchNorm
    takes the weight, bias and running statistics, with its batch count at
    0 as the JAX package's converter leaves Flax's."""
    sd = {k: torch.as_tensor(v, dtype=torch.float32)
          for k, v in state_dict.items()}

    def bn(dst, src):
        out = {f"{dst}.{k}": sd[f"{src}.{k}"] for k in _BN}
        out[f"{dst}.num_batches_tracked"] = torch.tensor(0)
        return out

    def block(dst, src, has_down):
        out = {f"{dst}.conv1.weight": sd[f"{src}.conv1.weight"],
               f"{dst}.conv2.weight": sd[f"{src}.conv2.weight"],
               **bn(f"{dst}.bn1", f"{src}.bn1"),
               **bn(f"{dst}.bn2", f"{src}.bn2")}
        if has_down:
            out[f"{dst}.downsample_conv.weight"] = \
                sd[f"{src}.downsample.0.weight"]
            out.update(bn(f"{dst}.downsample_bn", f"{src}.downsample.1"))
        return out

    out = {"stem": {"conv1.weight": sd["conv1.weight"], **bn("bn1", "bn1")}}
    for i in range(1, 5):
        out[f"layer{i}"] = {**block("block0", f"layer{i}.0", i > 1),
                            **block("block1", f"layer{i}.1", False)}
    return out
