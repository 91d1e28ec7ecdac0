"""Point-cloud transformer primitives (port of macarons_tpu/models/attention.py).

The submodules carry the names Flax gives their counterparts (``Dense_0``,
``LayerNorm_0``, ``Encoder_1``, ...), so a Flax parameter tree maps onto a
``state_dict`` by path (utils.convert.flax_to_torch). Flax's conventions are
kept: tanh-approximated GELU, LayerNorm eps 1e-6, attention masks that set
excluded scores to -1e3 before the 1/sqrt(d) scaling.

Weights are created empty; ``init_weights`` draws them from an explicit
``torch.Generator`` with the JAX package's scheme (Kaiming-normal kernels,
Xavier-normal q/k/v, torch-default uniform biases).

The layers also take reduced-precision weights and inputs (SconeOcc's
``occ_compute_dtype``) and compute as the JAX package's modules do on such
arrays: each op in the common type of its operands, rounding where XLA
rounds. The float32 path is untouched by this.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from .knn import knn_points


# Types that XLA rounds to after every op (the float32 path keeps torch's
# kernels).
REDUCED = (torch.bfloat16, torch.float16)


@functools.lru_cache(maxsize=None)
def _gelu_constants(dtype):
    return tuple(float(torch.tensor(c, dtype=dtype))
                 for c in (math.sqrt(2.0 / math.pi), 0.044715))


def gelu(x):
    """tanh-approximated GELU. In a reduced type every step rounds, its
    constants rounded to the type first, as ``jax.nn.gelu`` computes there
    (torch's kernel would round once)."""
    if x.dtype not in REDUCED:
        return F.gelu(x, approximate="tanh")
    c, k = _gelu_constants(x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x)))))


def _act(use_gelu: bool):
    return gelu if use_gelu else F.relu


class Dense(nn.Module):
    """Linear layer ``x @ weight.T + bias``; ``xavier`` selects the Xavier init."""

    def __init__(self, in_features: int, out_features: int,
                 xavier: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features))
        self.xavier = xavier

    def init_(self, gen: torch.Generator):
        if self.xavier:
            nn.init.xavier_normal_(self.weight, generator=gen)
        else:
            nn.init.kaiming_normal_(self.weight, nonlinearity="relu",
                                    generator=gen)
        bound = 1.0 / math.sqrt(self.weight.shape[1])
        nn.init.uniform_(self.bias, -bound, bound, generator=gen)

    def forward(self, x):
        w, b = self.weight, self.bias
        if w.dtype != x.dtype:
            # Flax promotes the input and the kernel to their common type.
            dt = torch.promote_types(x.dtype, w.dtype)
            x, w, b = x.to(dt), w.to(dt), b.to(dt)
        if x.dtype in REDUCED:
            # XLA rounds the product, then its sum with the bias.
            return torch.matmul(x, w.t()) + b
        return F.linear(x, w, b)


def init_weights(module: nn.Module, gen: torch.Generator):
    """Draw every Dense weight of ``module`` from ``gen`` (LayerNorms keep
    ones/zeros)."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, Dense):
                m.init_(gen)
    return module


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` over inputs and parameters of any floating types:
    Flax normalises in float32 (at least), so the parameters' gradients
    are summed over the rows in float32 too, and returns their common
    type."""

    def forward(self, x):
        if x.dtype == self.weight.dtype and x.dtype not in REDUCED:
            return super().forward(x)
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        ct = torch.promote_types(dt, torch.float32)
        return F.layer_norm(x.to(ct), self.normalized_shape,
                            self.weight.to(ct), self.bias.to(ct),
                            self.eps).to(dt)


def layer_norm(dim: int) -> LayerNorm:
    return LayerNorm(dim, eps=1e-6)


def attention(q, k, v, mask=None):
    """scores = q k^T; masked -> -1e3; / sqrt(d); softmax; @ v.

    The JAX package divides by a NumPy float64 scalar, which JAX does not
    type weakly: reduced-precision scores become float32 there, and so does
    everything after them (the value product, the residual stream)."""
    scores = torch.matmul(q, k.transpose(-1, -2))
    if mask is not None:
        scores = scores.masked_fill(mask == 0, -1e3)
    scores = scores.to(torch.promote_types(scores.dtype, torch.float32)) \
        / math.sqrt(q.shape[-1])
    p = torch.softmax(scores, dim=-1)
    return torch.matmul(p, v.to(p.dtype))


class Embedding(nn.Module):
    """Per-point embedding; the output always totals ``output_dim`` features:
    learned + optional global max-pool + optional additional + optional raw
    input."""

    def __init__(self, input_dim: int, output_dim: int, gelu: bool = True,
                 global_feature: bool = False, additional_feature_dim: int = 0,
                 concatenate_input: bool = True, k_for_knn: int = 0):
        super().__init__()
        feature_dim = output_dim
        inner_dim = output_dim // 2
        if additional_feature_dim > 0:
            feature_dim -= additional_feature_dim
            inner_dim = feature_dim
        if concatenate_input:
            feature_dim -= input_dim
            inner_dim = feature_dim
        if global_feature:
            feature_dim = feature_dim // 2
            inner_dim = feature_dim
        self.act = _act(gelu)
        self.global_feature = global_feature
        self.additional_feature_dim = additional_feature_dim
        self.concatenate_input = concatenate_input
        self.k_for_knn = k_for_knn
        self.Dense_0 = Dense(input_dim, inner_dim)
        self.Dense_1 = Dense(inner_dim, feature_dim)

    def forward(self, x, additional_feature=None, pts_mask=None):
        res = self.Dense_1(self.act(self.Dense_0(x)))
        if self.k_for_knn > 0:
            _, _, idx = knn_points(x[..., :3], x[..., :3], self.k_for_knn)
            N, K = idx.shape[-2:]
            flat = idx.reshape(*idx.shape[:-2], N * K, 1).expand(
                *idx.shape[:-2], N * K, res.shape[-1])
            res = torch.gather(res, -2, flat).reshape(
                *idx.shape[:-2], N, K, res.shape[-1]).amax(dim=-2)
        if self.global_feature:
            masked = res if pts_mask is None else res.masked_fill(
                ~pts_mask[..., None], -math.inf)
            g = masked.amax(dim=-2, keepdim=True)
            g = torch.where(torch.isfinite(g), g, torch.zeros_like(g))
            res = torch.cat((res, g.expand_as(res)), dim=-1)
        if self.additional_feature_dim > 0:
            res = torch.cat((res, additional_feature), dim=-1)
        if self.concatenate_input:
            res = torch.cat((res, x), dim=-1)
        return res


class MultiHeadSelfAttention(nn.Module):
    """Separate q/k and v widths; an output projection iff more than one head."""

    def __init__(self, n_heads: int, in_dim: int, qk_dim: int):
        super().__init__()
        self.n_heads = n_heads
        self.in_dim = in_dim
        self.qk_dim = qk_dim
        self.Dense_0 = Dense(in_dim, qk_dim, xavier=True)
        self.Dense_1 = Dense(in_dim, qk_dim, xavier=True)
        self.Dense_2 = Dense(in_dim, in_dim, xavier=True)
        if n_heads > 1:
            self.Dense_3 = Dense(in_dim, in_dim)

    def forward(self, x, mask=None):
        *B, N, _ = x.shape
        h = self.n_heads

        def heads(t):
            return t.reshape(*B, N, h, t.shape[-1] // h).transpose(-2, -3)

        q, k, v = heads(self.Dense_0(x)), heads(self.Dense_1(x)), \
            heads(self.Dense_2(x))
        if mask is not None and mask.ndim == len(B) + 2:
            mask = mask[..., None, :, :]
        out = attention(q, k, v, mask=mask).transpose(-2, -3).reshape(
            *B, N, self.in_dim)
        return self.Dense_3(out) if self.n_heads > 1 else out


class FeedForward(nn.Module):
    """input -> inner -> input. Flax names the outer call's layer first, so
    ``Dense_0`` is the output projection and ``Dense_1`` the input one."""

    def __init__(self, input_dim: int, inner_dim: int, gelu: bool = True):
        super().__init__()
        self.act = _act(gelu)
        self.Dense_0 = Dense(inner_dim, input_dim)
        self.Dense_1 = Dense(input_dim, inner_dim)

    def forward(self, x):
        return self.Dense_0(self.act(self.Dense_1(x)))


class Encoder(nn.Module):
    """Pre-norm residual transformer block."""

    def __init__(self, embedding_dim: int, qk_dim: int, n_heads: int = 1,
                 gelu: bool = True, FF: bool = True):
        super().__init__()
        self.FF = FF
        self.LayerNorm_0 = layer_norm(embedding_dim)
        self.MultiHeadSelfAttention_0 = MultiHeadSelfAttention(
            n_heads, embedding_dim, qk_dim)
        if FF:
            self.LayerNorm_1 = layer_norm(embedding_dim)
            self.FeedForward_0 = FeedForward(embedding_dim, 2 * embedding_dim,
                                             gelu)

    def forward(self, x, mask=None):
        x = x + self.MultiHeadSelfAttention_0(self.LayerNorm_0(x), mask=mask)
        if self.FF:
            x = x + self.FeedForward_0(self.LayerNorm_1(x))
        return x


class PCTransformer(nn.Module):
    """Embedding -> encoders -> LayerNorm -> Dense(feature_dim // 2) ->
    concat(max-pool, mean-pool) over the points -> (B, feature_dim).
    ``pts_mask`` (B, N) excludes padded points from attention and pools."""

    def __init__(self, pts_dim: int = 3, pts_embedding_dim: int = 256,
                 feature_dim: int = 512, concatenate_input: bool = True,
                 n_code: int = 2, n_heads: int = 4, FF: bool = True,
                 gelu: bool = True):
        super().__init__()
        self.n_code = n_code
        self.Embedding_0 = Embedding(pts_dim, pts_embedding_dim, gelu=gelu,
                                     concatenate_input=concatenate_input)
        for i in range(n_code):
            setattr(self, f"Encoder_{i}", Encoder(
                pts_embedding_dim, pts_embedding_dim // 4, n_heads, gelu, FF))
        self.LayerNorm_0 = layer_norm(pts_embedding_dim)
        self.Dense_0 = Dense(pts_embedding_dim, feature_dim // 2)

    def forward(self, pc, mask=None, pts_mask=None):
        if mask is None and pts_mask is not None:
            mask = pts_mask[..., None, :]
        x = self.Embedding_0(pc, pts_mask=pts_mask)
        for i in range(self.n_code):
            x = getattr(self, f"Encoder_{i}")(x, mask=mask)
        x = self.Dense_0(self.LayerNorm_0(x))
        if pts_mask is not None:
            m = pts_mask[..., None]
            mx = x.masked_fill(~m, -math.inf).amax(dim=-2)
            mx = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
            denom = torch.clamp(pts_mask.sum(dim=-1, keepdim=True), min=1)
            av = x.masked_fill(~m, 0.0).sum(dim=-2) / denom
        else:
            mx = x.amax(dim=-2)
            av = x.mean(dim=-2)
        return torch.cat((mx, av), dim=-1)
