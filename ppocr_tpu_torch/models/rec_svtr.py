"""PP-OCRv4 mobile recognizer (PP-LCNetV3 + SVTR + CTC head), PyTorch.

Counterpart of ``ppocr_tpu/models/rec_svtr.py``: mixed (h, w) strides that
take the height to 3 (48 px crops) or 2 (28 px crops) while keeping W/4
columns, a full-height mean pool to 1×(W/8) timesteps, two SVTR blocks of
8 heads × 15 written as explicit matmuls with an f32 softmax, and a CTC
projection whose width comes from the weights (6,625 for the reference
dict, 5,008 for the jumbo bundle).

``rec_forward(model, x[N, H, W, 3]) -> [N, W//8, V]`` f32 probabilities;
``rec_forward_logits`` returns the pre-softmax logits.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn

from .layers import SE, BatchNorm, Conv, LayerNorm, Lab, Linear, hard_swish, swish

# (c_in, c_out, dw_kernel, stride(h,w), has_se)
REC_BLOCKS: List[Tuple[int, int, int, Tuple[int, int], bool]] = [
    (16, 32, 3, (1, 1), False),
    (32, 64, 3, (1, 1), False),
    (64, 64, 3, (1, 1), False),
    (64, 128, 3, (2, 1), False),
    (128, 128, 3, (1, 1), False),
    (128, 240, 3, (1, 2), False),
    (240, 240, 5, (1, 1), False),
    (240, 240, 5, (1, 1), False),
    (240, 240, 5, (1, 1), False),
    (240, 240, 5, (1, 1), False),
    (240, 480, 5, (2, 1), True),
    (480, 480, 5, (1, 1), True),
    (480, 480, 5, (2, 1), False),
    (480, 480, 5, (1, 1), False),
]
REC_DIM = 120  # SVTR embedding dim
REC_HEADS = 8
REC_MLP_RATIO = 2
REC_FEAT = 480


def rec_timesteps(width: int) -> int:
    """CTC timesteps of a crop ``width`` px wide (stride 4, then pool 2)."""
    return width // 8


class LCNetConv(nn.Module):
    """conv + bias + LAB + hard_swish + LAB (every rec backbone conv,
    strided depthwise ones included, carries the activation)."""

    def __init__(self, cin, cout, k, stride, groups):
        super().__init__()
        self.conv = Conv(cin, cout, k, stride, groups=groups)
        self.lab1 = Lab()
        self.lab2 = Lab()

    def forward(self, x):
        return self.lab2(hard_swish(self.lab1(self.conv(x))))


class RecBlock(nn.Module):
    def __init__(self, cin, cout, k, s, has_se):
        super().__init__()
        self.dw = LCNetConv(cin, cin, k, s, groups=cin)
        self.se = SE(cin, cin // 4, slope=1.0 / 6.0) if has_se else None
        self.pw = LCNetConv(cin, cout, 1, (1, 1), groups=1)

    def forward(self, x):
        x = self.dw(x)
        if self.se is not None:
            x = self.se(x)
        return self.pw(x)


class ConvBNSwish(nn.Module):
    """1×kw conv (no bias) + BN + swish — the SVTR encoder's conv units."""

    def __init__(self, cin, cout, kw):
        super().__init__()
        self.conv = Conv(cin, cout, (1, kw), padding=(0, kw // 2), bias=False)
        self.bn = BatchNorm(cout)

    def forward(self, x):
        return swish(self.bn(self.conv(x)))


class SVTRBlock(nn.Module):
    """Pre-norm global-mix block: x += attn(LN(x)); x += mlp(LN(x))."""

    def __init__(self, d=REC_DIM, heads=REC_HEADS):
        super().__init__()
        self.heads = heads
        self.norm1 = LayerNorm(d)
        self.qkv = Linear(d, 3 * d)
        self.proj = Linear(d, d)
        self.norm2 = LayerNorm(d)
        self.fc1 = Linear(d, REC_MLP_RATIO * d)
        self.fc2 = Linear(REC_MLP_RATIO * d, d)

    def forward(self, x):
        n, t, d = x.shape
        h = self.heads
        hd = d // h
        qkv = self.qkv(self.norm1(x)).reshape(n, t, 3, h, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * (hd**-0.5), qkv[1], qkv[2]
        # scores and softmax in f32, then back to the activation dtype
        attn = torch.matmul(q.float(), k.float().transpose(2, 3))
        attn = torch.softmax(attn, dim=-1).to(x.dtype)
        y = torch.matmul(attn.float(), v.float()).to(x.dtype)
        y = y.transpose(1, 2).reshape(n, t, d)
        x = x + self.proj(y)
        y = self.fc2(swish(self.fc1(self.norm2(x))))
        return x + y


class RecSVTR(nn.Module):
    def __init__(self, num_classes: int):
        super().__init__()
        self.stem = Conv(3, 16, 3, 2, bias=False)
        self.stem_bn = BatchNorm(16)
        self.blocks = nn.ModuleList(RecBlock(*cfg) for cfg in REC_BLOCKS)
        d = REC_DIM
        self.conv1 = ConvBNSwish(REC_FEAT, 60, 3)
        self.conv2 = ConvBNSwish(60, d, 1)
        self.svtr = nn.ModuleList(SVTRBlock() for _ in range(2))
        self.norm = LayerNorm(d, eps=1e-6)
        self.conv3 = ConvBNSwish(d, REC_FEAT, 1)
        self.conv4 = ConvBNSwish(2 * REC_FEAT, 60, 3)
        self.conv1x1 = ConvBNSwish(60, d, 1)
        self.fc = Linear(d, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[N, 3, H, W] normalized → [N, W//8, V] f32 logits."""
        x = self.stem_bn(self.stem(x))
        for blk in self.blocks:
            x = blk(x)
        n, c, hh, ww = x.shape  # [N, 480, ≤3, W/4]
        # avg pool k=(3,2) s=(3,2) with Paddle's clipped (exclusive) window
        # equals a full-height mean for feature height ≤ 3
        if hh > 3:
            raise ValueError(f"unexpected rec feature height {hh}")
        pooled = x.reshape(n, c, hh, ww // 2, 2).mean(dim=(2, 4)).unsqueeze(2)
        y = self.conv2(self.conv1(pooled))  # [N, 120, 1, T]
        t = y.shape[3]
        y = y.reshape(n, REC_DIM, t).transpose(1, 2)  # [N, T, 120]
        for blk in self.svtr:
            y = blk(y)
        y = self.norm(y)
        y = self.conv3(y.transpose(1, 2).reshape(n, REC_DIM, 1, t))
        z = torch.cat([pooled, y], dim=1)  # [N, 960, 1, T] (pooled first)
        z = self.conv1x1(self.conv4(z))
        z = z.reshape(n, REC_DIM, t).transpose(1, 2)
        return self.fc(z).float()


def rec_forward_logits(model: RecSVTR, x: torch.Tensor) -> torch.Tensor:
    """[N, H, W, 3] normalized → [N, W//8, V] f32 logits."""
    return model(x.permute(0, 3, 1, 2).contiguous())


def rec_forward(model: RecSVTR, x: torch.Tensor) -> torch.Tensor:
    """[N, H, W, 3] normalized → [N, W//8, V] f32 probabilities."""
    return torch.softmax(rec_forward_logits(model, x), dim=-1)
