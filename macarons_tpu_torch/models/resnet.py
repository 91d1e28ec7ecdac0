"""ResNet-18 pieces of the depth network (port of
macarons_tpu/models/resnet.py).

NCHW, PyTorch's layout; the submodules carry the names Flax gives their
counterparts, so a Flax variables tree maps onto a ``state_dict`` by path
(utils.convert.flax_to_torch). BatchNorm is Flax's (``FlaxBatchNorm2d``):
eps 1e-5; in eval mode it normalises with the running statistics, in train
mode with the batch's, and updates the running ones as Flax does. Converting
a torchvision resnet18 checkpoint waits for the depth pretrainer.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm with Flax's training arithmetic.

    Train mode normalises with the batch mean and the biased batch variance
    E[x^2] - E[x]^2 (clipped at 0), as ``flax.linen.BatchNorm`` computes
    them, and updates running = 0.9 running + 0.1 batch with that same
    biased variance. ``nn.BatchNorm2d`` would update the running variance
    with the unbiased one, so a converted checkpoint would train to other
    statistics. Eval mode is ``nn.BatchNorm2d``'s."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        mean = x.mean(dim=(0, 2, 3))
        var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
        with torch.no_grad():
            self.running_mean.mul_(1.0 - self.momentum).add_(
                self.momentum * mean)
            self.running_var.mul_(1.0 - self.momentum).add_(
                self.momentum * var)
            self.num_batches_tracked += 1
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean[None, :, None, None]) * mul[None, :, None, None]
                + self.bias[None, :, None, None])


def batch_norm(features: int) -> FlaxBatchNorm2d:
    """Flax's BatchNorm(momentum=0.9, epsilon=1e-5): PyTorch's momentum is
    the weight of the batch, 0.1."""
    return FlaxBatchNorm2d(features, eps=1e-5, momentum=0.1)


def conv3x3(in_features: int, features: int, strides: int = 1,
            bias: bool = True) -> nn.Conv2d:
    """3x3 conv with zero padding 1 (Flax ``padding=1``)."""
    return nn.Conv2d(in_features, features, 3, stride=strides, padding=1,
                     bias=bias)


class BasicBlock(nn.Module):
    """conv-bn-relu-conv-bn plus the shortcut; the shortcut is a strided 1x1
    conv (no padding, as Flax's ``SAME`` gives for a 1x1 kernel) and a BN
    wherever the block changes the shape."""

    def __init__(self, in_features: int, features: int, strides: int = 1):
        super().__init__()
        self.conv1 = conv3x3(in_features, features, strides, bias=False)
        self.bn1 = batch_norm(features)
        self.conv2 = conv3x3(features, features, bias=False)
        self.bn2 = batch_norm(features)
        if strides != 1 or in_features != features:
            self.downsample_conv = nn.Conv2d(in_features, features, 1,
                                             stride=strides, bias=False)
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

    def __init__(self, in_features: int, features: int, strides: int = 1):
        super().__init__()
        self.block0 = BasicBlock(in_features, features, strides)
        self.block1 = BasicBlock(features, features)

    def forward(self, x):
        return self.block1(self.block0(x))


class ResNet18Stem(nn.Module):
    """conv1 (7x7, stride 2) + bn1 + relu, before the max pool."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = batch_norm(64)

    def forward(self, x):
        return F.relu(self.bn1(self.conv1(x)))


def maxpool_3x3_s2(x):
    return F.max_pool2d(x, 3, stride=2, padding=1)


class FeatureExtractor(nn.Module):
    """conv1 .. layer1 of ResNet18: image (N, 3, H, W) -> 64 channels at a
    quarter of the resolution (and the stem's output at a half)."""

    def __init__(self):
        super().__init__()
        self.stem = ResNet18Stem()
        self.layer1 = ResNetLayer(64, 64)

    def forward(self, x, return_conv1: bool = False):
        conv1 = self.stem(x)
        y = self.layer1(maxpool_3x3_s2(conv1))
        return (y, conv1) if return_conv1 else y
