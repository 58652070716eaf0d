"""Text-orientation classifier: MobileNetV3-small ×0.35 + 2-class head.

Counterpart of ``ppocr_tpu/models/cls_mv3.py`` (ch_ppocr_mobile_v2.0_cls).
The block table is the exported graph's; note the (2, 1) strides that
downsample height only and keep the text line's width.

``cls_forward(model, x[N, 48, 192, 3]) -> [N, 2]`` f32 softmax over
{0°, 180°} keeps the JAX layout at the public boundary; the module is NCHW.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import SE, BatchNorm, Conv, Linear, hard_swish

# (c_in, c_exp, c_out, dw_k, stride(h, w), se, act)  act: "relu" | "hswish"
CLS_BLOCKS: List[Tuple[int, int, int, int, Tuple[int, int], bool, str]] = [
    (8, 8, 8, 3, (2, 1), True, "relu"),
    (8, 24, 8, 3, (2, 1), False, "relu"),
    (8, 32, 8, 3, (1, 1), False, "relu"),
    (8, 32, 16, 5, (2, 1), True, "hswish"),
    (16, 88, 16, 5, (1, 1), True, "hswish"),
    (16, 88, 16, 5, (1, 1), True, "hswish"),
    (16, 40, 16, 5, (1, 1), True, "hswish"),
    (16, 48, 16, 5, (1, 1), True, "hswish"),
    (16, 104, 32, 5, (2, 1), True, "hswish"),
    (32, 200, 32, 5, (1, 1), True, "hswish"),
    (32, 200, 32, 5, (1, 1), True, "hswish"),
]
CLS_LAST_CH = 200
CLS_NUM_CLASSES = 2


class ConvBN(nn.Module):
    """conv (no bias) → BN → optional relu / hard_swish."""

    def __init__(self, cin, cout, k=1, stride=(1, 1), groups=1, act=None):
        super().__init__()
        self.conv = Conv(cin, cout, k, stride, groups=groups, bias=False)
        self.bn = BatchNorm(cout)
        self.act = act

    def forward(self, x):
        x = self.bn(self.conv(x))
        if self.act == "relu":
            return F.relu(x)
        return hard_swish(x) if self.act == "hswish" else x


class ClsBlock(nn.Module):
    """Inverted residual: expand 1×1 → depthwise k×k → (SE) → project 1×1,
    with the skip when shape and stride allow it."""

    def __init__(self, cin, cexp, cout, k, stride, has_se, act):
        super().__init__()
        self.expand = ConvBN(cin, cexp, 1, act=act)
        self.dw = ConvBN(cexp, cexp, k, stride, groups=cexp, act=act)
        self.se = SE(cexp, cexp // 4, slope=0.2) if has_se else None
        self.project = ConvBN(cexp, cout, 1)
        self.skip = cin == cout and stride == (1, 1)

    def forward(self, x):
        y = self.dw(self.expand(x))
        if self.se is not None:
            y = self.se(y)
        y = self.project(y)
        return x + y if self.skip else y


class ClsMV3(nn.Module):
    def __init__(self):
        super().__init__()
        self.stem = ConvBN(3, 8, 3, (2, 2), act="hswish")
        self.blocks = nn.ModuleList(ClsBlock(*cfg) for cfg in CLS_BLOCKS)
        self.last_conv = ConvBN(32, CLS_LAST_CH, 1, act="hswish")
        self.fc = Linear(CLS_LAST_CH, CLS_NUM_CLASSES)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[N, 3, 48, 192] normalized → [N, 2] f32 probabilities."""
        x = self.stem(x)
        for blk in self.blocks:
            x = blk(x)
        x = self.last_conv(x)
        # head: 2×2 max pool → global mean → FC → softmax
        x = F.max_pool2d(x, 2).mean(dim=(2, 3))
        return torch.softmax(self.fc(x).float(), dim=-1)


def cls_forward(model: ClsMV3, x: torch.Tensor) -> torch.Tensor:
    """[N, 48, 192, 3] normalized → [N, 2] f32 probabilities."""
    return model(x.permute(0, 3, 1, 2).contiguous())


def init_cls_params(seed: int = 0) -> Dict:
    """Random parameter tree with the exported graph's shapes, in the JAX
    package's layout (HWIO convs, [in, out] linear): numpy only, so the
    same seed gives the same tree wherever it runs. For tests and checks;
    an untrained classifier's two probabilities sit near 0.5."""
    rng = np.random.default_rng(seed)

    def conv(k, cin, cout, groups=1):
        fan = k * k * (cin // groups)
        return {
            "w": rng.normal(0, (2.0 / fan) ** 0.5, (k, k, cin // groups, cout)).astype(
                np.float32
            ),
            "bn": {
                "scale": np.ones((cout,), np.float32),
                "bias": np.zeros((cout,), np.float32),
                "mean": np.zeros((cout,), np.float32),
                "var": np.ones((cout,), np.float32),
            },
        }

    def se(c):
        mid = c // 4
        return {
            "conv1": {
                "w": rng.normal(0, 0.1, (1, 1, c, mid)).astype(np.float32),
                "b": np.zeros((mid,), np.float32),
            },
            "conv2": {
                "w": rng.normal(0, 0.1, (1, 1, mid, c)).astype(np.float32),
                "b": np.zeros((c,), np.float32),
            },
        }

    blocks = []
    for cin, cexp, cout, k, s, has_se, act in CLS_BLOCKS:
        blk = {
            "expand": conv(1, cin, cexp),
            "dw": conv(k, cexp, cexp, groups=cexp),
            "project": conv(1, cexp, cout),
        }
        if has_se:
            blk["se"] = se(cexp)
        blocks.append(blk)
    return {
        "stem": conv(3, 3, 8),
        "blocks": blocks,
        "last_conv": conv(1, 32, CLS_LAST_CH),
        "fc": {
            "w": rng.normal(0, 0.05, (CLS_LAST_CH, CLS_NUM_CLASSES)).astype(np.float32),
            "b": np.zeros((CLS_NUM_CLASSES,), np.float32),
        },
    }
