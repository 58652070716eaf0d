"""Neural-net primitives of the PP-OCR models, in PyTorch (NCHW).

Counterpart of ``ppocr_tpu/models/layers.py``. The JAX package keeps
activations NHWC and weights HWIO; here activations are NCHW and weights
are stored in PyTorch's layouts (conv OIHW, depthwise [C, 1, k, k], linear
[out, in]). ``models.jax_params`` transposes the JAX pytrees into these
modules once, at load time.

Numerics follow the JAX functions: convolutions and matmuls accumulate in
f32 (cuDNN and cuBLAS do so for bf16 inputs) and the result is cast back
to the activation dtype; BN folds to one scale and shift; layer norm and
the attention softmax run in f32.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn


def conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    stride: Tuple[int, int] = (1, 1),
    padding: Tuple[int, int] = (0, 0),
    groups: int = 1,
    bias: torch.Tensor | None = None,
) -> torch.Tensor:
    """NCHW conv with explicit symmetric (ph, pw) zero padding."""
    return F.conv2d(x, w, bias, stride=stride, padding=padding, groups=groups)


def conv_transpose2x2(
    x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None
) -> torch.Tensor:
    """Stride-2 2×2 transposed conv as ONE matmul + pixel shuffle.

    The windows do not overlap, so ``y[n, o, 2h+a, 2w+b] = Σc x[n,c,h,w] ·
    W[c,a,b,o]``. ``w`` is the JAX (C_in, 2, 2, C_out) kernel pre-arranged
    as a [C_out·4, C_in, 1, 1] 1×1 conv whose output channel (o, a, b)
    ``pixel_shuffle`` places at (2h+a, 2w+b)."""
    y = F.pixel_shuffle(F.conv2d(x, w), 2)
    if bias is not None:
        y = y + bias.view(1, -1, 1, 1)
    return y


def hard_swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.clamp(x + 3.0, 0.0, 6.0) * (1.0 / 6.0)


def hard_sigmoid(
    x: torch.Tensor, slope: float = 1.0 / 6.0, offset: float = 0.5
) -> torch.Tensor:
    return torch.clamp(slope * x + offset, 0.0, 1.0)


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def _param(shape) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape), requires_grad=False)


class Conv(nn.Module):
    """Conv2d with explicit stride/padding/groups and an optional bias."""

    def __init__(self, cin, cout, k, stride=(1, 1), padding=None, groups=1, bias=True):
        super().__init__()
        kh, kw = (k, k) if isinstance(k, int) else k
        self.stride = stride if isinstance(stride, tuple) else (stride, stride)
        self.padding = padding if padding is not None else (kh // 2, kw // 2)
        self.groups = groups
        self.weight = _param((cout, cin // groups, kh, kw))
        self.bias = _param((cout,)) if bias else None

    def forward(self, x):
        return conv2d(x, self.weight, self.stride, self.padding, self.groups, self.bias)


class ConvTranspose2x2(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.weight = _param((cout * 4, cin, 1, 1))
        self.bias = _param((cout,))

    def forward(self, x):
        return conv_transpose2x2(x, self.weight, self.bias)


class BatchNorm(nn.Module):
    """Inference BN over channels (dim 1), eps 1e-5: ``x·inv + (b − m·inv)``
    with ``inv = scale·rsqrt(var + eps)``."""

    def __init__(self, c, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale, self.bias = _param((c,)), _param((c,))
        self.mean, self.var = _param((c,)), _param((c,))

    def forward(self, x):
        inv = self.scale * torch.rsqrt(self.var + self.eps)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return x * inv.view(shape) + (self.bias - self.mean * inv).view(shape)


class LayerNorm(nn.Module):
    """Layer norm over the last axis, computed in f32."""

    def __init__(self, c, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale, self.bias = _param((c,)), _param((c,))

    def forward(self, x):
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + self.eps)
        return (y * self.scale.float() + self.bias.float()).to(x.dtype)


class Lab(nn.Module):
    """PP-LCNetV3 learnable affine block: scalar ``x·s + b``."""

    def __init__(self):
        super().__init__()
        self.s, self.b = _param((1,)), _param((1,))

    def forward(self, x):
        return x * self.s + self.b


class SE(nn.Module):
    """Squeeze-excite: mean pool → 1×1 conv + relu → 1×1 conv + hard
    sigmoid → channel scale. ``slope`` is 0.2 (det FPN) or 1/6 (det/rec
    backbones)."""

    def __init__(self, c, mid, slope: float = 0.2):
        super().__init__()
        self.slope = slope
        self.conv1 = Conv(c, mid, 1)
        self.conv2 = Conv(mid, c, 1)

    def forward(self, x):
        s = x.mean(dim=(2, 3), keepdim=True)
        s = F.relu(self.conv1(s))
        return x * hard_sigmoid(self.conv2(s), slope=self.slope)


class Linear(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.weight = _param((cout, cin))
        self.bias = _param((cout,))

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)
