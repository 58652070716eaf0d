"""PP-OCRv4 mobile text detector (PP-LCNetV3 + RSE-FPN + DB head), PyTorch.

Counterpart of ``ppocr_tpu/models/det_db.py`` with the same architecture
constants: the depthwise activation runs only at stride 1, the FPN
reduction widths are the exported graph's pruned ones, nearest ×2 is a
repeat, and the DB head ends in an f32 sigmoid.

``det_forward(model, x[N, H, W, 3]) -> [N, H, W]`` keeps the JAX layout at
the public boundary; the module itself is NCHW.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import SE, BatchNorm, Conv, ConvTranspose2x2, Lab, hard_swish

# (c_in, c_out, dw_kernel, stride, has_se); dw activation only when stride==1
DET_BLOCKS: List[Tuple[int, int, int, int, bool]] = [
    (16, 32, 3, 1, False),
    (32, 48, 3, 2, False),
    (48, 48, 3, 1, False),  # → FPN tap c2 (/4, 48ch)
    (48, 96, 3, 2, False),
    (96, 96, 3, 1, False),  # → FPN tap c3 (/8, 96ch)
    (96, 192, 3, 2, False),
    (192, 192, 5, 1, False),
    (192, 192, 5, 1, False),
    (192, 192, 5, 1, False),
    (192, 192, 5, 1, False),  # → FPN tap c4 (/16, 192ch)
    (192, 384, 5, 2, True),
    (384, 384, 5, 1, True),
    (384, 384, 5, 1, False),
    (384, 384, 5, 1, False),  # → FPN tap c5 (/32, 384ch)
]
DET_TAPS = (2, 4, 9, 13)
FPN_IN_CHANNELS = (48, 96, 192, 384)
FPN_REDUCED = (12, 18, 42, 360)  # channel-pruned reduction widths
FPN_CH = 96
FPN_OUT_CH = 24
SE_REDUCTION = 4


class LCNetConv(nn.Module):
    """conv + bias + LAB, optionally hard_swish + LAB."""

    def __init__(self, cin, cout, k, stride, groups, act: bool):
        super().__init__()
        self.conv = Conv(cin, cout, k, stride, groups=groups)
        self.lab1 = Lab()
        self.lab2 = Lab() if act else None

    def forward(self, x):
        x = self.lab1(self.conv(x))
        if self.lab2 is not None:
            x = self.lab2(hard_swish(x))
        return x


class DetBlock(nn.Module):
    def __init__(self, cin, cout, k, s, has_se):
        super().__init__()
        self.dw = LCNetConv(cin, cin, k, s, groups=cin, act=(s == 1))
        # backbone SEs use hard_sigmoid slope 1/6 (FPN ones use 0.2)
        self.se = SE(cin, cin // SE_REDUCTION, slope=1.0 / 6.0) if has_se else None
        self.pw = LCNetConv(cin, cout, 1, 1, groups=1, act=True)

    def forward(self, x):
        x = self.dw(x)
        if self.se is not None:
            x = self.se(x)
        return self.pw(x)


class RSE(nn.Module):
    """conv (no bias) → SE residual."""

    def __init__(self, cin, cout, k):
        super().__init__()
        self.conv = Conv(cin, cout, k, bias=False)
        self.se = SE(cout, cout // SE_REDUCTION, slope=0.2)

    def forward(self, x):
        y = self.conv(x)
        return self.se(y) + y


def _up(x: torch.Tensor, f: int) -> torch.Tensor:
    """Nearest ×f upsampling as a repeat."""
    return x.repeat_interleave(f, dim=2).repeat_interleave(f, dim=3)


class DetDB(nn.Module):
    def __init__(self):
        super().__init__()
        self.stem = Conv(3, 16, 3, 2, bias=False)
        self.stem_bn = BatchNorm(16)
        self.blocks = nn.ModuleList(DetBlock(*cfg) for cfg in DET_BLOCKS)
        self.reduce = nn.ModuleList(
            Conv(c, r, 1) for c, r in zip(FPN_IN_CHANNELS, FPN_REDUCED)
        )
        self.rse_in = nn.ModuleList(RSE(r, FPN_CH, 1) for r in FPN_REDUCED)
        self.rse_out = nn.ModuleList(RSE(FPN_CH, FPN_OUT_CH, 3) for _ in range(4))
        self.head_conv = Conv(96, 24, 3, bias=False)
        self.head_bn = BatchNorm(24)
        self.up1 = ConvTranspose2x2(24, 24)
        self.up1_bn = BatchNorm(24)
        self.up2 = ConvTranspose2x2(24, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[N, 3, H, W] normalized → [N, H, W] f32 probability map."""
        x = self.stem_bn(self.stem(x))
        taps = []
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i in DET_TAPS:
                taps.append(x)
        feats = [rse(red(t)) for t, red, rse in zip(taps, self.reduce, self.rse_in)]
        # top-down pathway (deepest /32 → /4)
        feats[2] = feats[2] + _up(feats[3], 2)
        feats[1] = feats[1] + _up(feats[2], 2)
        feats[0] = feats[0] + _up(feats[1], 2)
        outs = [rse(f) for f, rse in zip(feats, self.rse_out)]
        x = torch.cat([_up(outs[i], 2**i) for i in range(3, 0, -1)] + [outs[0]], 1)
        x = F.relu(self.head_bn(self.head_conv(x)))
        x = F.relu(self.up1_bn(self.up1(x)))
        x = self.up2(x)
        return torch.sigmoid(x.float())[:, 0]


def det_forward(model: DetDB, x: torch.Tensor) -> torch.Tensor:
    """[N, H, W, 3] normalized → [N, H, W] f32 probability map."""
    return model(x.permute(0, 3, 1, 2).contiguous())
