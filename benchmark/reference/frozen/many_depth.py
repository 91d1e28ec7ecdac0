"""ManyDepth, multi-frame monocular depth (port of
macarons_tpu/models/many_depth.py).

A ResNet18 stem extracts features of the target and the alpha frames at a
quarter of the resolution; a plane-sweep cost volume warps the alpha
features into the target view at ``n_depth`` planes; ResNet18 layers 2-4
contract, five expansion layers with skip connections expand, and four
sigmoid heads give disparities at four scales. With ``learn_pose`` a
PoseDecoder (a ResNet18 over the stacked frame pairs) predicts the relative
poses that place the alpha cameras; without it they come from the frames'
known poses.

The submodules run NCHW, PyTorch's layout, and carry the names Flax gives
their counterparts (utils.convert.flax_to_torch maps the variables by path).
``ManyDepth`` and ``DepthDecoder`` take and return NHWC, as the JAX package
does. The network holds no Pallas kernel: its convolutions and the cost
volume's gather were XLA ops there and are PyTorch ops here.

``dtype`` ``torch.bfloat16`` runs every convolution in bfloat16 (resnet.py's
``Conv2d``), as the JAX package's ``dtype``; the parameters, BatchNorm,
the cost volume's geometry and warp grids, the disparity heads and the
pose head's last conv and ``fc`` stay float32. ``None`` is float32
throughout.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .geometry import compose_pose, matrix_from_axis_angle, ndc_pixel_grid
from .grid_sample import grid_sample
from .resnet import Conv2d, FeatureExtractor, ResNetLayer, batch_norm, \
    conv3x3, maxpool_3x3_s2

INPUT_HEIGHT = 256
INPUT_WIDTH = 456
D_MIN = 0.5
D_MAX = 750.0
N_DEPTH = 96
POSE_FACTOR = 100.0
# Depth planes warped at a time by the cost volume. One warped plane of the
# supervision batch (B 4, 2 alphas, 64 x 114 features, 64 channels) holds
# 15 MB, and the bilinear gather makes four of them: each chunk is reduced
# to its (B, planes, pixels) costs before the next. The planes are
# independent, so the chunking does not change the function.
PLANE_CHUNK = 16


def reflect_conv(in_features: int, features: int,
                 dtype: Optional[torch.dtype] = None) -> Conv2d:
    """3x3 conv over a one-pixel reflect padding."""
    return Conv2d(in_features, features, 3, padding=1, padding_mode="reflect",
                  compute_dtype=dtype)


class CostVolumeBuilder(nn.Module):
    """Plane-sweep cost volume and its reduction conv.

    Cameras are FoV cameras (60 degrees, aspect 1) in the row-vector
    convention. For each plane depth and feature pixel of the target view,
    the point is carried into each alpha view, its alpha features sampled
    bilinearly (zeros outside), averaged over the alphas, and the mean
    absolute difference to the target features over the channels is the
    cost."""

    def __init__(self, d_min: float = D_MIN, d_max: float = D_MAX,
                 n_depth: int = N_DEPTH, in_features: int = 64,
                 output_channels: int = 64, fov: float = 60.0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.d_min, self.d_max, self.n_depth = d_min, d_max, n_depth
        self.tan_half = math.tan(math.radians(fov) / 2.0)
        self.conv_reduce = conv3x3(in_features + n_depth, output_channels,
                                   dtype=dtype)

    def forward(self, feat, R, T, feat_alpha, R_alpha, T_alpha,
                return_cost_volume: bool = False):
        """feat (B, C, fh, fw); R (B, 3, 3); T (B, 3);
        feat_alpha (B, A, C, fh, fw); R_alpha (B, A, 3, 3); T_alpha (B, A, 3).
        Returns the reduced features (B, 64, fh, fw) and, if asked, the cost
        volume (B, n_depth, fh, fw)."""
        B, C, fh, fw = feat.shape
        A = feat_alpha.shape[1]
        P = fh * fw
        th = self.tan_half
        s = min(fh, fw)
        ndc_x, ndc_y = ndc_pixel_grid(fh, fw, device=feat.device,
                                      dtype=feat.dtype)
        px, py = ndc_x.reshape(-1), ndc_y.reshape(-1)
        depths = torch.linspace(self.d_min, self.d_max, self.n_depth,
                                device=feat.device)
        T_world = torch.einsum("bj,bij->bi", T, R)[:, None, None, :]
        src = feat_alpha.permute(0, 1, 3, 4, 2).reshape(B * A, fh, fw, C)
        target = feat.permute(0, 2, 3, 1).reshape(B, 1, P, C)
        costs = []
        for d in depths.split(PLANE_CHUNK):
            n = d.shape[0]
            pv = torch.stack((px[None] * d[:, None] * th,
                              py[None] * d[:, None] * th,
                              d[:, None].expand(n, P)), dim=-1)
            world = torch.einsum("dpj,bij->bdpi", pv, R) - T_world
            view = (torch.einsum("bdpj,baji->badpi", world, R_alpha)
                    + T_alpha[:, :, None, None, :])
            z = view[..., 2]
            safe_z = torch.where(torch.abs(z) < 1e-8, 1e-8, z)
            grid = torch.stack((-(s / fw) * (view[..., 0] / (safe_z * th)),
                                -(s / fh) * (view[..., 1] / (safe_z * th))),
                               dim=-1)
            warped = grid_sample(src, grid.reshape(B * A, n * P, 1, 2),
                                 padding_mode="zeros")
            warped = warped.reshape(B, A, n, P, C).mean(dim=1)
            costs.append(torch.abs(warped - target).mean(dim=-1))
        cost = torch.cat(costs, dim=1).reshape(B, self.n_depth, fh, fw)
        res = F.relu(self.conv_reduce(torch.cat((feat, cost.to(feat.dtype)),
                                                dim=1)))
        return (res, cost) if return_cost_volume else res


class ExpansionLayer(nn.Module):
    """Upconv, nearest resize to ``output_size``, skip concat, reflect conv.

    The resize is ``nearest-exact`` (half-pixel centres), which is what
    ``jax.image.resize(..., "nearest")`` computes; plain ``nearest`` picks
    other source pixels at non-integer ratios."""

    def __init__(self, in_features: int, inner_channels: int,
                 output_channels: int, output_size: Tuple[int, int],
                 skip_features: int = 0, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.output_size = tuple(output_size)
        self.upconv = conv3x3(in_features, inner_channels, dtype=dtype)
        self.iconv = reflect_conv(inner_channels + skip_features,
                                  output_channels, dtype)

    def forward(self, x, x_add=None):
        y = F.elu(self.upconv(x))
        y = F.interpolate(y, size=self.output_size, mode="nearest-exact")
        if x_add is not None:
            y = torch.cat((y, x_add.to(y.dtype)), dim=1)
        return F.elu(self.iconv(y))


class DisparityLayer(nn.Module):
    """Reflect conv -> sigmoid disparity in (0, 1), in float32 whatever the
    network's compute type (the conv casts its input)."""

    def __init__(self, in_features: int):
        super().__init__()
        self.conv = reflect_conv(in_features, 1)

    def forward(self, x):
        return torch.sigmoid(self.conv(x))


def _nchw(x):
    return x.permute(0, 3, 1, 2).contiguous()


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class DepthDecoder(nn.Module):
    """The depth network: features, cost volume, contraction, expansion and
    four disparity heads.

    ``batched_stem`` runs the target and alpha frames through the feature
    extractor as one batch of B (1 + A) frames in eval mode (BatchNorm on
    its running statistics, so the function is the same); in train mode the
    two calls stay apart, so each normalises over its own batch."""

    def __init__(self, input_height: int = INPUT_HEIGHT,
                 input_width: int = INPUT_WIDTH, d_min: float = D_MIN,
                 d_max: float = D_MAX, n_depth: int = N_DEPTH,
                 use_input_image_in_skip_connection: bool = True,
                 batched_stem: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        H, W = input_height, input_width
        self.use_input_image_in_skip_connection = \
            use_input_image_in_skip_connection
        self.batched_stem = batched_stem

        def size(div):
            return (H // div, W // div + (W % div > 0))

        self.feature_extractor = FeatureExtractor(dtype)
        self.cost_volume_builder = CostVolumeBuilder(d_min, d_max, n_depth,
                                                     dtype=dtype)
        self.resnet_layer_2 = ResNetLayer(64, 128, 2, dtype)
        self.resnet_layer_3 = ResNetLayer(128, 256, 2, dtype)
        self.resnet_layer_4 = ResNetLayer(256, 512, 2, dtype)
        self.expansion5 = ExpansionLayer(512, 256, 256, size(16), 256, dtype)
        self.expansion4 = ExpansionLayer(256, 128, 128, size(8), 128, dtype)
        self.disp4 = DisparityLayer(128)
        self.expansion3 = ExpansionLayer(128, 64, 64, size(4), 64, dtype)
        self.disp3 = DisparityLayer(64)
        self.expansion2 = ExpansionLayer(64, 32, 32, size(2), 64, dtype)
        self.disp2 = DisparityLayer(32)
        self.expansion1 = ExpansionLayer(
            32, 16, 16, (H, W), 3 if use_input_image_in_skip_connection else 0,
            dtype)
        self.disp1 = DisparityLayer(16)

    def forward(self, x, R, T, x_alpha, R_alpha, T_alpha):
        """x (B, H, W, 3); x_alpha (B, A, H, W, 3). Returns disp1..disp4,
        NHWC, at 1, 1/2, 1/4 and 1/8 of the resolution."""
        B, H, W, _ = x.shape
        A = x_alpha.shape[1]
        x = _nchw(x)
        frames = _nchw(x_alpha.reshape(B * A, H, W, 3))
        if self.batched_stem and not self.training:
            feats, convs1 = self.feature_extractor(torch.cat((x, frames)),
                                                   return_conv1=True)
            layer1, conv1, layer1_alpha = feats[:B], convs1[:B], feats[B:]
        else:
            layer1, conv1 = self.feature_extractor(x, return_conv1=True)
            layer1_alpha = self.feature_extractor(frames)
        layer1_alpha = layer1_alpha.reshape(B, A, *layer1_alpha.shape[1:])
        conv_reduce = self.cost_volume_builder(layer1, R, T, layer1_alpha,
                                               R_alpha, T_alpha)
        layer2 = self.resnet_layer_2(conv_reduce)
        layer3 = self.resnet_layer_3(layer2)
        layer4 = self.resnet_layer_4(layer3)
        iconv5 = self.expansion5(layer4, layer3)
        iconv4 = self.expansion4(iconv5, layer2)
        disp4 = self.disp4(iconv4)
        iconv3 = self.expansion3(iconv4, layer1)
        disp3 = self.disp3(iconv3)
        iconv2 = self.expansion2(iconv3, conv1)
        disp2 = self.disp2(iconv2)
        iconv1 = self.expansion1(
            iconv2, x if self.use_input_image_in_skip_connection else None)
        disp1 = self.disp1(iconv1)
        return tuple(_nhwc(d) for d in (disp1, disp2, disp3, disp4))


def _halved(n: int, times: int) -> int:
    """A side after ``times`` stride-2 steps of padding (k - 1) / 2."""
    for _ in range(times):
        n = (n + 1) // 2
    return n


class PoseDecoder(nn.Module):
    """Relative 6-DoF poses of the alpha frames from (target, alpha) pairs:
    a 7x7 stride-2 conv over the 6-channel pair, BatchNorm, max pool,
    ResNet18 layers 1-4, the pose convs ``pconv0``-``pconv3`` and ``fc`` over
    the flattened (h, w, 6) map. Returns (B, A, 6) [T, axis-angle] /
    pose_factor, float32."""

    def __init__(self, input_height: int = INPUT_HEIGHT,
                 input_width: int = INPUT_WIDTH,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.biconv1 = Conv2d(6, 64, 7, stride=2, padding=3, bias=False,
                              compute_dtype=dtype)
        self.bn1 = batch_norm(64)
        self.resnet_layer_1 = ResNetLayer(64, 64, dtype=dtype)
        self.resnet_layer_2 = ResNetLayer(64, 128, 2, dtype)
        self.resnet_layer_3 = ResNetLayer(128, 256, 2, dtype)
        self.resnet_layer_4 = ResNetLayer(256, 512, 2, dtype)
        self.pconv0 = Conv2d(512, 256, 1, compute_dtype=dtype)
        self.pconv1 = conv3x3(256, 256, dtype=dtype)
        self.pconv2 = conv3x3(256, 256, dtype=dtype)
        self.pconv3 = Conv2d(256, 6, 1)
        # conv1, the pool and layers 2-4 halve each side.
        self.fc = nn.Linear(6 * _halved(input_height, 5)
                            * _halved(input_width, 5), 6)

    def forward(self, x, x_alpha):
        """x (B, H, W, 3); x_alpha (B, A, H, W, 3), NHWC."""
        B, H, W, _ = x.shape
        A = x_alpha.shape[1]
        pair = torch.cat((x[:, None].expand(B, A, H, W, 3), x_alpha), dim=-1)
        y = self.biconv1(_nchw(pair.reshape(B * A, H, W, 6)))
        y = maxpool_3x3_s2(F.relu(self.bn1(y)))
        y = self.resnet_layer_1(y)
        y = self.resnet_layer_2(y)
        y = self.resnet_layer_3(y)
        y = self.resnet_layer_4(y)
        y = F.relu(self.pconv0(y))
        y = F.relu(self.pconv1(y))
        y = F.relu(self.pconv2(y))
        y = _nhwc(self.pconv3(y)).reshape(B, A, -1)
        return self.fc(y)


class ManyDepth(nn.Module):
    """Relative poses -> alpha cameras -> depth network.

    The poses are predicted by the PoseDecoder with ``learn_pose``, else
    given (``gt_pose``). The alpha cameras are recomputed from the pose
    vector: the axis-angle times ``pose_factor`` back to a matrix, composed
    with the target pose. ``batched_stem`` and ``dtype``: see DepthDecoder
    and the module docstring."""

    def __init__(self, input_height: int = INPUT_HEIGHT,
                 input_width: int = INPUT_WIDTH, d_min: float = D_MIN,
                 d_max: float = D_MAX, n_depth: int = N_DEPTH,
                 pose_factor: float = POSE_FACTOR, learn_pose: bool = False,
                 batched_stem: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.pose_factor = pose_factor
        self.learn_pose = learn_pose
        if learn_pose:
            self.pose_decoder = PoseDecoder(input_height, input_width, dtype)
        self.depth_decoder = DepthDecoder(
            input_height, input_width, d_min, d_max, n_depth,
            batched_stem=batched_stem, dtype=dtype)

    def forward(self, x, x_alpha, R, T, gt_pose=None):
        """x (B, H, W, 3); x_alpha (B, A, H, W, 3); R (B, 3, 3), T (B, 3) the
        target's world-to-view pose; gt_pose (B, A, 6) [T, axis-angle] /
        pose_factor, read without ``learn_pose``. Returns (pose, disp1,
        disp2, disp3, disp4)."""
        B, A = x.shape[0], x_alpha.shape[1]
        if self.learn_pose:
            pose = self.pose_decoder(x, x_alpha)
        elif gt_pose is None:
            raise ValueError("learn_pose=False requires gt_pose")
        else:
            pose = gt_pose
        relative_R = matrix_from_axis_angle(self.pose_factor * pose[..., 3:])
        relative_T = self.pose_factor * pose[..., :3]
        R_alpha, T_alpha = compose_pose(R[:, None].expand(B, A, 3, 3),
                                        T[:, None].expand(B, A, 3),
                                        relative_R, relative_T)
        disps = self.depth_decoder(x, R, T, x_alpha, R_alpha, T_alpha)
        return (pose, *disps)


def ssim(x, y):
    """SSIM distance map over reflect-padded 3x3 means, NHWC:
    clamp((1 - SSIM) / 2, 0, 1)."""
    C1 = 0.01 ** 2
    C2 = 0.03 ** 2

    def pool(v):
        v = F.pad(_nchw(v), (1, 1, 1, 1), mode="reflect")
        return _nhwc(F.avg_pool2d(v, 3, stride=1))

    mu_x = pool(x)
    mu_y = pool(y)
    sigma_x = pool(x ** 2) - mu_x ** 2
    sigma_y = pool(y ** 2) - mu_y ** 2
    sigma_xy = pool(x * y) - mu_x * mu_y
    n = (2 * mu_x * mu_y + C1) * (2 * sigma_xy + C2)
    d = (mu_x ** 2 + mu_y ** 2 + C1) * (sigma_x + sigma_y + C2)
    return torch.clamp((1 - n / d) / 2, 0.0, 1.0)
