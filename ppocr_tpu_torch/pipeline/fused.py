"""Fused det → boxes → crops → rec request, in PyTorch on one device.

Counterpart of ``ppocr_tpu/pipeline/fused.py`` with every option of the
single-device fused path: greedy or beam decode, axis-aligned boxes or
min-area rotated quads (``fused_rotated_boxes``), in-graph orientation
classification (``enable_cls``), the 2×2 dilation (``det.use_dilation``),
crops sampled from the det canvas or from an m×-resolution source
(``fused_crop_src_mult``), width × batch-count tiers, and the blob-stats
kernel behind ``fused_blob_kernel``. The request runs as::

    uint8 canvas ─▶ DBNet ─▶ uint8 threshold (─▶ dilate) ─▶ connected
    components ─▶ top-K blob stats (─▶ angle sweep) ─▶ unclip/validity ─▶
    tier compaction (─▶ cls crops ─▶ cls) ─▶ bilinear crops (two matmuls) ─▶
    SVTR on the tier's slice ─▶ CTC top-k kernel | beam top-k ─▶ host
    collapse | prefix beam search + JSON words

Where the JAX step vmaps over the request batch, every function here
carries the batch as a leading dimension. ``lax.switch`` on the rec tier
becomes one ``.tolist()`` on the host, and the connected-components
``while_loop`` a Python loop with one ``any()`` sync per iteration.

On an engine with a mesh, the JAX step is one GSPMD program over the
batch sharded on "data"; here a step splits the batch over the mesh's data
rows and runs in three phases: ``prep`` of each shard on its device (a
long-lived host thread per distinct device), the batch's rec tier merged on the host
from the shards' own (:func:`merge_tiers`), then ``rec`` of each shard at
that tier. So every shard's recognizer runs at the width and slot count
the whole batch needs, as in the JAX step, whose SVTR mixes over every
column of that width.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from ..models.cls_mv3 import cls_forward
from ..models.det_db import det_forward
from ..models.rec_svtr import rec_forward, rec_timesteps
from ..ops.ctc import (
    ctc_beam_search,
    ctc_beam_topk_device,
    ctc_greedy_collapse,
    ctc_topk_device,
)
from ..ops.db_postprocess import order_points_clockwise
from ..ops.kernels import BIG, blob_stats, blob_stats_plain
from ..ops.normalize import HALF_MEAN, HALF_SCALE, IMAGENET_MEAN, IMAGENET_SCALE
from ..ops.resize import (
    det_cap_shape,
    det_fit_cap,
    det_resize,
    det_target_shape,
    resize_bilinear_u8,
)
from ..parallel.mesh import DeviceThreads
from .config import pick_bucket

N_COARSE = 48  # angle sweep: coarse angles over [0°, 90°)
N_FINE = 33  # fine angles over ±1 coarse step around each blob's best


class FusedOutputs(NamedTuple):
    # every field has a leading batch axis B; index as field[b, i]
    boxes: torch.Tensor  # [B, K, 4] int32 (x0, y0, x1, y1) det-image coords
    valid: torch.Tensor  # [B, K] bool
    scores: torch.Tensor  # [B, K] f32 blob-mean det score
    ctc_idx: torch.Tensor  # [B, K, T] int32 (greedy) | [B, K, T, C] (beam)
    ctc_prob: torch.Tensor  # [B, K, T] f32 | [B, K, T, C]
    roots: torch.Tensor  # [B, K] int32 raster index of the blob's first pixel
    ctc_blank: Optional[torch.Tensor] = None  # [B, K, T] f32 blank prob (beam only)
    quads: Optional[torch.Tensor] = None  # [B, K, 4, 2] int32 corner quads (TL,
    # TR, BR, BL before the host's reordering): rotated rects in rotated-box
    # mode, the axis box's corners otherwise


def _dilate2x2(fg: torch.Tensor) -> torch.Tensor:
    """cv2.dilate with a 2×2 MORPH_RECT kernel on [B, H, W] bool: the even
    kernel anchors so that dst(y, x) = max src[y-1..y, x-1..x], i.e. ink
    spreads down and to the right. The other direction is a silent 1 px
    box shift."""
    fgp = F.pad(fg, (1, 0, 1, 0))
    return fgp[:, 1:, 1:] | fgp[:, 1:, :-1] | fgp[:, :-1, 1:] | fgp[:, :-1, :-1]


def _connected_components(fg: torch.Tensor, max_iters: int | None = None) -> torch.Tensor:
    """8-connected min-label propagation. fg: [B, H, W] bool → [B, H, W]
    int32 labels (= min flat index of the blob; background = H·W).

    Each iteration takes the 3×3 neighbourhood min, then segmented min
    scans along rows and columns that resolve whole runs at once. The scan
    packs the barrier flag into bit 30 of the label and runs as
    Hillis-Steele doubling. The loop stops at convergence or after
    ``h + w + 8`` iterations, as in the JAX function."""
    b, h, w = fg.shape
    if h * w >= (1 << 30):
        raise ValueError(
            f"det canvas {h}x{w} has h*w >= 2^30; the packed segmented "
            "scan cannot label it"
        )
    if max_iters is None:
        max_iters = h + w + 8
    big = h * w
    flag = 1 << 30
    vmask = flag - 1  # also the combine identity: ≥ any label, no barrier
    iota = torch.arange(h * w, dtype=torch.int32, device=fg.device).reshape(h, w)
    init = torch.where(fg, iota, big)
    flag_in = torch.where(fg, 0, flag).to(torch.int32)

    def seg_comb(a, c):
        # c's span holds a barrier → a cannot reach past it; flags OR
        cv = c & vmask
        v = torch.where((c & flag) != 0, cv, torch.minimum(a & vmask, cv))
        return v | ((a | c) & flag)

    def scan(p, dim, reverse):
        n = p.shape[dim]
        d = 1
        while d < n:
            if dim == 2:
                pad = (0, d) if reverse else (d, 0)
            else:
                pad = (0, 0, 0, d) if reverse else (0, 0, d, 0)
            body = p.narrow(dim, d, n - d) if reverse else p.narrow(dim, 0, n - d)
            p = seg_comb(F.pad(body, pad, value=vmask), p)
            d *= 2
        return p

    def run_min(labels, dim):
        p = labels | flag_in  # labels == big on background, so OR packs
        fwd = scan(p, dim, False) & vmask
        bwd = scan(p, dim, True) & vmask
        return torch.where(fg, torch.minimum(fwd, bwd), big)

    def propagate(labels):
        padded = F.pad(labels, (1, 1, 1, 1), value=big)
        neigh = labels
        for dy in range(3):
            for dx in range(3):
                neigh = torch.minimum(neigh, padded[:, dy : dy + h, dx : dx + w])
        labels = torch.where(fg, neigh, big)
        return run_min(run_min(labels, 2), 1)

    labels = run_min(run_min(init, 2), 1)
    for _ in range(max_iters):
        with record_function("fused.cc_iter"):
            new = propagate(labels)
        changed = bool((new != labels).any())
        labels = new
        if not changed:
            break
    return labels


def _select_roots(labels: torch.Tensor, max_boxes: int):
    """The ``max_boxes`` largest blobs of each label map [B, H, W]:
    (area [B, K] f32, root [B, K] int32).

    Selection as in the JAX ``_blob_stats``: the first ``8·max_boxes``
    roots in raster order (a root is a pixel whose label is its own
    index), their exact areas, then a stable descending sort by area so
    equal areas go to the raster-earlier root (``lax.top_k``'s tie rule).
    Missing roots are -1 with area 0."""
    b, h, w = labels.shape
    n = h * w
    flat = labels.reshape(b, n)
    n_cand = min(8 * max_boxes, n)
    iota = torch.arange(n, dtype=torch.int32, device=labels.device)
    rootness = torch.where(flat == iota, n - iota, 0)  # > 0 iff p is a root
    root_val, root_pos = torch.topk(rootness, n_cand, dim=1)  # distinct > 0
    root_cand = torch.where(root_val > 0, root_pos, -1)
    # exact areas of the candidates from one histogram of the labels
    # (background label n included), gathered at each candidate root
    offs = torch.arange(b, device=labels.device).unsqueeze(1) * (n + 1)
    counts = torch.bincount((flat.long() + offs).reshape(-1), minlength=b * (n + 1))
    counts = counts.reshape(b, n + 1)
    area_cand = torch.where(
        root_cand >= 0, counts.gather(1, root_cand.clamp(min=0)), 0
    ).float()
    top_area, sel = torch.sort(area_cand, dim=1, descending=True, stable=True)
    top_area, sel = top_area[:, :max_boxes], sel[:, :max_boxes]
    return top_area, root_cand.gather(1, sel).to(torch.int32)


def _first_argmin(x: torch.Tensor) -> torch.Tensor:
    """Index of the first minimum along dim 0 (``jnp.argmin``'s rule;
    ``torch.argmin`` does not promise which of several equal minima it
    returns). x: [A, ...] → [...] int64."""
    a = x.shape[0]
    idx = torch.arange(a, device=x.device).reshape((a,) + (1,) * (x.dim() - 1))
    return torch.where(x == x.amin(dim=0, keepdim=True), idx, a).amin(dim=0)


def _min_area_rects(labels: torch.Tensor, roots: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Min-area oriented rect of each selected blob by a two-stage angle
    sweep (rotating calipers): (theta, u0, u1, v0, v1), each [B, K], where
    (u, v) are coordinates in the rotated frame, u = x·cosθ + y·sinθ,
    v = −x·sinθ + y·cosθ.

    The hull of a blob is the hull of its per-row extreme points, so the
    min/max projections over these ≤ 2H points equal the blob's for every
    angle. Coarse sweep: ``N_COARSE`` angles over [0°, 90°); fine sweep:
    ``N_FINE`` angles over ±1 coarse step around each blob's best
    (resolution 0.117°). As cv2.minAreaRect, the rect spans pixel-centre
    extents with no half-pixel support. Equal areas go to the first angle
    of the sweep."""
    b, h, w = labels.shape
    k = roots.shape[1]
    dev = labels.device
    member = labels.unsqueeze(1) == roots.to(labels.dtype)[:, :, None, None]  # [B,K,H,W]
    rowp = member.any(dim=3)  # [B, K, H]
    ix = torch.arange(w, dtype=torch.float32, device=dev)
    rminx = torch.where(member, ix, BIG).amin(dim=3)  # [B, K, H]
    rmaxx = torch.where(member, ix, -BIG).amax(dim=3)
    ypts = torch.arange(h, dtype=torch.float32, device=dev).expand(b, k, h)
    px = torch.cat([rminx, rmaxx], dim=2)  # [B, K, 2H]
    py = torch.cat([ypts, ypts], dim=2)
    pv = torch.cat([rowp, rowp], dim=2)  # point validity

    def sweep(angles):
        """angles [A] (shared) or [A, B, K] (per blob) → each blob's best
        (theta, u0, u1, v0, v1) by bounding-rect area."""
        c, s = torch.cos(angles), torch.sin(angles)
        if angles.dim() == 1:
            c, s = c[:, None, None], s[:, None, None]
            ang = angles[:, None, None].expand(angles.shape[0], b, k)
        else:
            ang = angles
        u = px * c.unsqueeze(-1) + py * s.unsqueeze(-1)  # [A, B, K, 2H]
        v = -px * s.unsqueeze(-1) + py * c.unsqueeze(-1)
        u0 = torch.where(pv, u, BIG).amin(dim=3)  # [A, B, K]
        u1 = torch.where(pv, u, -BIG).amax(dim=3)
        v0 = torch.where(pv, v, BIG).amin(dim=3)
        v1 = torch.where(pv, v, -BIG).amax(dim=3)
        best = _first_argmin((u1 - u0) * (v1 - v0)).unsqueeze(0)  # [1, B, K]
        return tuple(t.gather(0, best)[0] for t in (ang, u0, u1, v0, v1))

    coarse_step = np.float32(np.pi / 2 / N_COARSE)
    coarse = torch.arange(N_COARSE, dtype=torch.float32, device=dev) * coarse_step
    theta = sweep(coarse)[0]
    offs = (
        torch.arange(N_FINE, dtype=torch.float32, device=dev) / (N_FINE - 1) * 2.0 - 1.0
    ) * coarse_step
    theta, u0, u1, v0, v1 = sweep(theta.unsqueeze(0) + offs[:, None, None])
    return {"theta": theta, "u0": u0, "u1": u1, "v0": v0, "v1": v1}


def _blob_stats(
    labels: torch.Tensor,
    prob: torch.Tensor,
    max_boxes: int,
    rotated: bool = False,
    use_kernel: bool = False,
) -> Dict[str, torch.Tensor]:
    """Per-blob area/bbox/score of the top ``max_boxes`` blobs by area
    (:func:`_select_roots`). The bbox and prob mass come from
    ``ops.kernels.blob_stats`` (``use_kernel`` and not ``rotated``) or its
    plain masked-reduction version; ``rotated`` adds each blob's min-area
    oriented rect (:func:`_min_area_rects`). labels/prob: [B, H, W]."""
    top_area, top_idx = _select_roots(labels, max_boxes)
    stats_fn = blob_stats if use_kernel and not rotated else blob_stats_plain
    _area, psum, x0, x1, y0, y1 = stats_fn(labels, prob, top_idx)
    stats = {
        "area": top_area,
        "score": psum / torch.clamp(top_area, min=1.0),
        "x0": x0,
        "x1": x1,
        "y0": y0,
        "y1": y1,
        "root": top_idx,
    }
    if rotated:
        stats.update(_min_area_rects(labels, top_idx))
    return stats


def _crop_resize_bilinear(
    img_f32, x0, y0, x1, y1, content_w, out_h, out_w, rot180=None, scale=1.0
):
    """Sample each box of each image to [out_h, out_w, 3]; columns ≥
    content_w are black (rec pads before normalizing).

    img_f32: [B, H, W, 3]; x0..content_w: [B, K] → [B, K, out_h, out_w, 3].
    ``rot180`` ([B, K] bool) mirrors a crop's sampling grid, which equals
    rotating the crop by 180° before resizing (the cls label == 1 action).
    ``scale`` (≥ 1) reads the pixels from an ``img_f32`` that renders the
    det canvas at ``scale``× the resolution: the grid is computed in
    det-map coords (where x0..y1 live) and mapped with pixel-centre
    alignment, ``p_src = (p_det + 0.5)·scale − 0.5``.

    Bilinear resampling as two interpolation-matrix matmuls (rows, then
    columns) in f32: ``Ry[o, j] = clamp(1 − |ry[o] − j|, 0, 1)`` holds
    exactly the two bilinear taps of each output row."""
    dev = img_f32.device
    bh = y1 - y0 + 1.0
    bw = x1 - x0 + 1.0
    oy = torch.arange(out_h, dtype=torch.float32, device=dev) + 0.5
    ox = torch.arange(out_w, dtype=torch.float32, device=dev) + 0.5
    rows = oy * bh.unsqueeze(-1) / out_h - 0.5 + y0.unsqueeze(-1)  # [B, K, oh]
    cols = (
        ox * bw.unsqueeze(-1) / torch.clamp(content_w, min=1.0).unsqueeze(-1)
        - 0.5
        + x0.unsqueeze(-1)
    )  # [B, K, ow]
    if rot180 is not None:
        rot = rot180.unsqueeze(-1)
        rows = torch.where(rot, (y0 + y1).unsqueeze(-1) - rows, rows)
        cols = torch.where(rot, (x0 + x1).unsqueeze(-1) - cols, cols)
    if scale != 1.0:
        rows = (rows + 0.5) * scale - 0.5
        cols = (cols + 0.5) * scale - 0.5
    _, h, w, _ = img_f32.shape
    ry = torch.clamp(rows, 0.0, h - 1.0)
    rx = torch.clamp(cols, 0.0, w - 1.0)
    iy = torch.arange(h, dtype=torch.float32, device=dev)
    ix = torch.arange(w, dtype=torch.float32, device=dev)
    row_w = torch.clamp(1.0 - torch.abs(ry.unsqueeze(-1) - iy), 0.0, 1.0)  # [B,K,oh,H]
    col_w = torch.clamp(
        1.0 - torch.abs(ix.unsqueeze(-1) - rx.unsqueeze(-2)), 0.0, 1.0
    )  # [B, K, W, ow]
    tmp = torch.einsum("bkoh,bhwc->bkowc", row_w, img_f32)
    out = torch.einsum("bkowc,bkwx->bkoxc", tmp, col_w)
    col_mask = torch.arange(out_w, device=dev) < content_w.unsqueeze(-1)  # [B,K,ow]
    return out * col_mask[:, :, None, :, None]


def build_fused_parts(
    det_thresh: float,
    box_thresh: float,
    unclip_ratio: float,
    rec_img_h: int,
    rec_img_w: int,
    max_boxes: int,
    dtype=torch.bfloat16,
    cls_shape=None,
    decode: str = "greedy",
    beam_candidates: int = 5,
    rotated: bool = False,
    n_width_tiers: int = 2,
    blob_kernel: bool = False,
    use_dilation: bool = False,
    crop_src_mult: int = 1,
    n_batch_tiers: int = 1,
):
    """The fused pipeline's two halves, as in the JAX function.

    ``prep(det_model, cls_model, img_u8, content_hw, src_u8=None)`` → (crops_n
    [B·K, h, w, 3] normalized, boxes, quads, valid, score, roots, tier): det
    forward, blob geometry, the optional in-graph cls (``cls_shape=(h, w)``)
    and the rec crops. With ``crop_src_mult = m > 1`` it needs ``src_u8
    [B, m·H, m·W, 3]``, the source image resized to m× the det content
    extent, and samples the rec and cls crops from it instead of the det
    canvas.

    ``rec(rec_model, crops_n, tier)`` → (ctc idx, ctc prob, blank prob or
    None): recognizer + CTC top-k (greedy: the kernel) or the beam top-k
    lattice. ``tier = width_tier · n_batch_tiers + batch_tier`` is a Python
    int here (the host reads it once per step)."""
    if n_batch_tiers < 1 or (max_boxes >> (n_batch_tiers - 1)) < 1:
        raise ValueError(
            f"n_batch_tiers={n_batch_tiers} needs 1 <= n and "
            f"max_boxes >> (n-1) >= 1 (max_boxes={max_boxes})"
        )
    thresh_u8 = int(det_thresh * 255)
    consts = {}  # device → normalization constants, uploaded once per device
    consts_lock = threading.Lock()  # steps of several requests run in threads

    def norm_consts(dev):
        with consts_lock:
            if dev not in consts:
                consts[dev] = tuple(
                    torch.tensor(c, dtype=torch.float32, device=dev)
                    for c in (IMAGENET_MEAN, IMAGENET_SCALE, HALF_MEAN, HALF_SCALE)
                )
            return consts[dev]

    def geometry(prob, content_hw):
        """prob [B, H, W] → top-K blob boxes + validity (all [B, K])."""
        _, h, w = prob.shape
        dev = prob.device
        rh = content_hw[:, 0].to(torch.int32)
        rw = content_hw[:, 1].to(torch.int32)
        # uint8 threshold: (prob·255) truncated to uint8, then compared
        fg = (prob * 255.0).to(torch.uint8) > thresh_u8
        in_content = (
            torch.arange(h, dtype=torch.int32, device=dev)[None, :, None] < rh[:, None, None]
        ) & (torch.arange(w, dtype=torch.int32, device=dev)[None, None, :] < rw[:, None, None])
        fg = fg & in_content
        if use_dilation:
            # re-mask: the dilation must not bleed past the content edge
            fg = _dilate2x2(fg) & in_content
        with record_function("fused.cc"):
            labels = _connected_components(fg)
        with record_function("fused.blob_stats"):
            stats = _blob_stats(
                labels, prob, max_boxes, rotated=rotated, use_kernel=blob_kernel
            )

        if rotated:
            # pixel-centre extents in the rotated (u, v) frame: no +1
            bw = stats["u1"] - stats["u0"]
            bh = stats["v1"] - stats["v0"]
        else:
            bw = stats["x1"] - stats["x0"] + 1.0
            bh = stats["y1"] - stats["y0"] + 1.0
        ssid = torch.maximum(bw, bh)
        # unclip: expand by d = area_box·ratio / perimeter of the box
        d = (bw * bh) * unclip_ratio / torch.clamp(2.0 * (bw + bh), min=1.0)
        ebw, ebh = bw + 2.0 * d, bh + 2.0 * d
        valid = (
            (stats["area"] > 2)
            & (ssid >= 3)
            & (torch.maximum(ebw, ebh) >= 5)
            & (stats["score"] >= box_thresh)
        )
        rwf = (rw.float() - 1.0).unsqueeze(1)
        rhf = (rh.float() - 1.0).unsqueeze(1)
        zero = torch.zeros((), device=dev)
        # clamp to the content extent, not the padded canvas
        if rotated:
            u0, u1 = stats["u0"] - d, stats["u1"] + d
            v0, v1 = stats["v0"] - d, stats["v1"] + d
            c = torch.cos(stats["theta"]).unsqueeze(-1)
            s = torch.sin(stats["theta"]).unsqueeze(-1)
            us = torch.stack([u0, u1, u1, u0], dim=2)  # [B, K, 4]
            vs = torch.stack([v0, v0, v1, v1], dim=2)
            qx = torch.clamp(us * c - vs * s, min=zero, max=rwf.unsqueeze(-1))
            qy = torch.clamp(us * s + vs * c, min=zero, max=rhf.unsqueeze(-1))
            quad = torch.stack([qx, qy], dim=3)  # [B, K, 4, 2]
            # crop bounds: the axis-aligned bbox of the clamped quad
            cx0, cx1 = qx.amin(dim=2), qx.amax(dim=2)
            cy0, cy1 = qy.amin(dim=2), qy.amax(dim=2)
        else:
            cx0 = torch.clamp(stats["x0"] - d, min=zero, max=rwf)
            cx1 = torch.clamp(stats["x1"] + d, min=zero, max=rwf)
            cy0 = torch.clamp(stats["y0"] - d, min=zero, max=rhf)
            cy1 = torch.clamp(stats["y1"] + d, min=zero, max=rhf)
            quad = torch.stack(
                [
                    torch.stack([cx0, cy0], -1),
                    torch.stack([cx1, cy0], -1),
                    torch.stack([cx1, cy1], -1),
                    torch.stack([cx0, cy1], -1),
                ],
                dim=2,
            )  # [B, K, 4, 2]
        return quad, cx0, cy0, cx1, cy1, valid, stats["score"], stats["root"]

    def prep(det_model, cls_model, img_u8, content_hw, src_u8=None):
        """img_u8: [B, H, W, 3] uint8; content_hw: [B, 2] int32 (rh, rw)
        resized extents inside the padded canvas; src_u8 (iff crop_src_mult
        > 1): [B, m·H, m·W, 3] uint8. All on one device."""
        if (src_u8 is None) == (crop_src_mult > 1):
            raise ValueError(
                f"crop_src_mult={crop_src_mult} requires src_u8 "
                f"{'present' if crop_src_mult > 1 else 'absent'}"
            )
        imgs = img_u8.float()
        crop_src = src_u8.float() if src_u8 is not None else imgs
        scale = float(crop_src_mult)
        nb = imgs.shape[0]
        mean, scale_c, half_mean, half_scale = norm_consts(imgs.device)
        x = (imgs / 255.0 - mean) * scale_c
        with record_function("fused.det"):
            prob = det_forward(det_model, x.to(dtype)).float()

        quads, cx0, cy0, cx1, cy1, valid, score, roots = geometry(prob, content_hw)

        if n_batch_tiers > 1:
            # compact valid crops to the front of each image's K slots
            # (stable, so the area order holds among valid slots)
            perm = torch.argsort((~valid).to(torch.int32), dim=1, stable=True)

            def gather(a):
                idx = perm.reshape(perm.shape + (1,) * (a.dim() - 2))
                return torch.gather(a, 1, idx.expand_as(a))

            quads, cx0, cy0, cx1, cy1, valid, score, roots = (
                gather(a) for a in (quads, cx0, cy0, cx1, cy1, valid, score, roots)
            )

        ar = (cx1 - cx0 + 1.0) / torch.clamp(cy1 - cy0 + 1.0, min=1.0)
        content_w = torch.clamp(torch.ceil(rec_img_h * ar), max=float(rec_img_w))

        rot180 = None
        if cls_shape is not None:
            ch, cw_max = cls_shape
            cls_content = torch.clamp(torch.ceil(ch * ar), max=float(cw_max))
            with record_function("fused.cls"):
                cls_crops = _crop_resize_bilinear(
                    crop_src, cx0, cy0, cx1, cy1, cls_content, ch, cw_max, scale=scale
                )
                cls_n = (
                    cls_crops.reshape(nb * max_boxes, ch, cw_max, 3) / 255.0 - half_mean
                ) * half_scale
                # cls pads after normalizing, with 0 (rec pads before: a
                # padded rec column is −1)
                col_ok = (
                    torch.arange(cw_max, device=imgs.device)[None, None, :, None]
                    < cls_content.reshape(-1)[:, None, None, None]
                )
                cls_probs = cls_forward(cls_model, (cls_n * col_ok).to(dtype))
            # label 1 on a strictly larger p1 (argmax's first index on a
            # tie); the cls threshold is never consulted, as in the reference
            rot180 = (cls_probs[:, 1] > cls_probs[:, 0]).reshape(nb, max_boxes)

        with record_function("fused.crops"):
            crops = _crop_resize_bilinear(
                crop_src, cx0, cy0, cx1, cy1, content_w, rec_img_h, rec_img_w,
                rot180=rot180, scale=scale,
            )
        crops_n = (
            crops.reshape(nb * max_boxes, rec_img_h, rec_img_w, 3) / 255.0 - half_mean
        ) * half_scale
        boxes = torch.stack(
            [torch.round(cx0), torch.round(cy0), torch.round(cx1), torch.round(cy1)],
            dim=2,
        ).to(torch.int32)
        quads_i = torch.round(quads).to(torch.int32)
        # width tier: the narrowest power-of-two slice of the crop canvas
        # that holds every valid crop's content; batch tier: the narrowest
        # slot slice that holds the fullest image's compacted valid crops
        max_content = torch.where(valid, content_w, 0.0).max()
        max_valid = valid.sum(dim=1).max().float()
        max_content, max_valid = torch.stack([max_content, max_valid]).tolist()
        tier = sum(max_content <= float(rec_img_w >> k) for k in range(1, n_width_tiers))
        if n_batch_tiers > 1:
            btier = sum(max_valid <= (max_boxes >> k) for k in range(1, n_batch_tiers))
            tier = tier * n_batch_tiers + btier
        return crops_n.to(dtype), boxes, quads_i, valid, score, roots, int(tier)

    t_full = rec_timesteps(rec_img_w)

    def decode_outputs(probs):
        """probs [N, T, V] → CTC decode operands, tail-padded to t_full with
        pure-blank timesteps (greedy collapse drops blank id 0; beam search
        multiplies by blank mass 1.0: both no-ops downstream)."""
        pad_t = t_full - probs.shape[1]
        if decode == "beam":
            with record_function("fused.beam_topk"):
                idx, val, blank = ctc_beam_topk_device(probs, beam_candidates)
            idx = F.pad(idx, (0, 0, 0, pad_t), value=0)
            val = F.pad(val, (0, 0, 0, pad_t), value=0.0)
            return idx, val, F.pad(blank, (0, pad_t), value=1.0)
        with record_function("fused.ctc_topk"):
            idx, val = ctc_topk_device(probs)
        return F.pad(idx, (0, pad_t), value=0), F.pad(val, (0, pad_t), value=1.0), None

    def rec(rec_model, crops_n, tier: int):
        """Recognizer + CTC decode operands on the tier's slice; narrower
        slices' outputs are padded with pure-blank timesteps and slots
        (blank id 0, prob 1.0), so the host decode is unchanged."""
        kw, kb = divmod(tier, n_batch_tiers)
        nb = crops_n.shape[0] // max_boxes
        kslots = max_boxes >> kb
        width = rec_img_w >> kw
        c = crops_n.reshape(nb, max_boxes, rec_img_h, rec_img_w, 3)[:, :kslots, :, :width]
        c = c.reshape(nb * kslots, rec_img_h, width, 3)
        with record_function("fused.rec"):
            probs = rec_forward(rec_model, c)

        def pad_slots(x, value):
            """[B·kslots, …] → [B·K, …] with pure-blank filler rows."""
            if kslots == max_boxes:
                return x
            x = x.reshape((nb, kslots) + x.shape[1:])
            pad = (0, 0) * (x.dim() - 2) + (0, max_boxes - kslots)
            return F.pad(x, pad, value=value).reshape((nb * max_boxes,) + x.shape[2:])

        idx, val, blank = decode_outputs(probs)
        return (
            pad_slots(idx, 0),
            pad_slots(val, 1.0),
            pad_slots(blank, 1.0) if blank is not None else None,
        )

    return prep, rec


def merge_tiers(tiers, n_batch_tiers: int) -> int:
    """The rec tier of a batch split into shards, from each shard's own
    ``tier = width_tier · n_batch_tiers + batch_tier``. Each tier counts
    the halvings that still hold the shard's widest valid crop (fullest
    image), so the batch's is the minimum of the width tiers and, apart,
    the minimum of the batch tiers; the minimum of the combined numbers
    would mix them (with 2 batch tiers, (1, 0) = 2 and (0, 1) = 1 merge to
    (0, 0) = 0, not 1). An all-pad shard has no valid crop and so the
    widest tiers: it never narrows the result."""
    kws, kbs = zip(*(divmod(int(t), n_batch_tiers) for t in tiers))
    return min(kws) * n_batch_tiers + min(kbs)


def _outputs(nb, max_boxes, boxes, quads, valid, score, roots, idx, val, blank):
    """The step's outputs as a batch-leading FusedOutputs."""
    return FusedOutputs(
        boxes,
        valid,
        score,
        idx.reshape((nb, max_boxes) + idx.shape[1:]),
        val.reshape((nb, max_boxes) + val.shape[1:]),
        roots,
        blank.reshape(nb, max_boxes, -1) if blank is not None else None,
        quads,
    )


def compose_step(prep, rec, max_boxes: int):
    """``step(det_model, rec_model, cls_model, img_u8[B, H, W, 3],
    content_hw[B, 2], src_u8=None) -> FusedOutputs``: ``prep`` then ``rec``
    of :func:`build_fused_parts` on one device, run under
    ``torch.inference_mode`` (which is per thread, so it sits here and not
    around a service). With ``cls_shape`` the step classifies each crop's
    orientation and mirrors the rec sampling grid on label 1; with
    ``decode="beam"`` it returns the device-pruned top-k lattice and the
    blank probs instead of the greedy argmax."""

    @torch.inference_mode()
    def step(det_model, rec_model, cls_model, img_u8, content_hw, src_u8=None):
        crops_n, boxes, quads, valid, score, roots, tier = prep(
            det_model, cls_model, img_u8, content_hw, src_u8
        )
        idx, val, blank = rec(rec_model, crops_n, tier)
        return _outputs(
            img_u8.shape[0], max_boxes, boxes, quads, valid, score, roots, idx, val, blank
        )

    return step


def fused_part_kwargs(engine, max_boxes: int) -> dict:
    """Config → :func:`build_fused_parts` kwargs."""
    cfg = engine.config
    mult = int(cfg.fused_width_mult)
    if mult < 1 or (mult & (mult - 1)):
        raise ValueError(f"fused_width_mult must be a power of two: {mult}")
    src_mult = int(cfg.fused_crop_src_mult)
    if src_mult < 1:
        raise ValueError(f"fused_crop_src_mult must be >= 1: {src_mult}")
    rotated = bool(cfg.fused_rotated_boxes)
    with_cls = bool(cfg.enable_cls and engine.cls_model is not None)
    return {
        "det_thresh": cfg.det.thresh,
        "box_thresh": cfg.det.box_thresh,
        "unclip_ratio": cfg.det.unclip_ratio,
        "rec_img_h": cfg.rec.img_h,
        "rec_img_w": mult * cfg.rec.img_w,
        "max_boxes": max_boxes,
        "dtype": engine.dtype,
        "cls_shape": tuple(cfg.cls.image_shape[1:]) if with_cls else None,
        "decode": cfg.rec.decode,
        "beam_candidates": cfg.rec.beam_candidates,
        "rotated": rotated,
        "n_width_tiers": mult.bit_length(),
        # the kernel computes axis boxes only
        "blob_kernel": bool(cfg.fused_blob_kernel) and not rotated,
        "use_dilation": bool(cfg.det.use_dilation),
        "crop_src_mult": src_mult,
        "n_batch_tiers": int(cfg.fused_batch_tiers),
    }


class FusedOCR:
    """Single-dispatch serving wrapper sharing an OCREngine's modules."""

    def __init__(self, engine, max_boxes: int = 32):
        self.engine = engine
        self.max_boxes = max_boxes
        kw = fused_part_kwargs(engine, max_boxes)
        self.with_cls = kw["cls_shape"] is not None
        self.decode = kw["decode"]
        self.beam_size = engine.config.rec.beam_size
        self.rotated = kw["rotated"]
        self.crop_src_mult = kw["crop_src_mult"]
        self.n_batch_tiers = kw["n_batch_tiers"]
        # step shapes (nb, bh, bw) that have run once: warmup() and
        # compile_variant() fill it, and so does every process_batch
        # dispatch. Nothing is compiled for a shape on CUDA, but its first
        # call pays cuDNN's algorithm search (and the very first one the
        # kernel build), so the serving dispatchers run missing shapes once
        # on the event loop before a worker thread meets them.
        self._compiled: set = set()
        self.steps_run = 0  # fused steps dispatched by process_batch
        self.batched_steps = 0  # ... of which held more than one request
        self._count_lock = threading.Lock()  # process_batch runs in threads
        self._prep, self._rec = build_fused_parts(**kw)
        self._step = compose_step(self._prep, self._rec, max_boxes)
        self._threads = DeviceThreads()  # on a mesh: a host thread per device

    def _n_data(self) -> int:
        """Data-parallel width: batches split over the engine mesh's "data"
        axis."""
        mesh = self.engine.mesh
        return int(mesh.shape["data"]) if mesh is not None else 1

    def _pad_bucket(self, nb: int) -> int:
        """A batch bucket rounded up to a multiple of the data-axis width,
        so that the batch splits evenly."""
        n = self._n_data()
        return -(-nb // n) * n

    def _words_from_outputs(self, out, b, ratio_h, ratio_w, src_w, src_h):
        """Host decode of image ``b`` of numpy ``out`` into response words,
        in descending blob-root order (cv2.findContours emission order)."""
        if self.decode == "beam":
            kept, conf = ctc_beam_search(
                out.ctc_idx[b], out.ctc_prob[b], out.ctc_blank[b], beam_size=self.beam_size
            )
        else:
            kept, conf = ctc_greedy_collapse(out.ctc_idx[b], out.ctc_prob[b])
        words = []
        order = sorted(range(self.max_boxes), key=lambda i: -int(out.roots[b, i]))
        for i in order:
            if not out.valid[b, i] or np.isnan(conf[i]):
                continue
            if self.rotated:
                # rescale each corner of the rotated quad (truncating like
                # FilterTagDetRes) and canonicalize the corner order
                q = out.quads[b, i].astype(np.int64)
                sx = np.clip((q[:, 0] / ratio_w).astype(np.int64), 0, src_w - 1)
                sy = np.clip((q[:, 1] / ratio_h).astype(np.int64), 0, src_h - 1)
                box = order_points_clockwise(np.stack([sx, sy], axis=1)).tolist()
                # the reference's ≤4 px side filter, in source coords, on
                # the rescaled quad's Euclidean side lengths
                p = np.array(box, np.float64)
                rect_w = float(np.linalg.norm(p[0] - p[1]))
                rect_h = float(np.linalg.norm(p[0] - p[3]))
                if rect_w <= 4 or rect_h <= 4:
                    continue
            else:
                x0, y0, x1, y1 = out.boxes[b, i]
                # rescale det-image coords → source coords, truncating like
                # FilterTagDetRes
                sx0 = int(np.clip(int(x0 / ratio_w), 0, src_w - 1))
                sx1 = int(np.clip(int(x1 / ratio_w), 0, src_w - 1))
                sy0 = int(np.clip(int(y0 / ratio_h), 0, src_h - 1))
                sy1 = int(np.clip(int(y1 / ratio_h), 0, src_h - 1))
                # the reference's ≤4 px side filter, in source coords
                if sx1 - sx0 <= 4 or sy1 - sy0 <= 4:
                    continue
                box = [[sx0, sy0], [sx1, sy0], [sx1, sy1], [sx0, sy1]]
            words.append(
                {
                    "text": "".join(self.engine.charset[k] for k in kept[i]),
                    "confidence": float(conf[i]),
                    "box": [[int(x), int(y)] for x, y in box],
                }
            )
        return words

    def _dispatch(self, batch: np.ndarray, content_hw: np.ndarray, src=None) -> FusedOutputs:
        """Upload and run one fused step; the outputs stay on the device
        (on a mesh, on its first device)."""
        eng = self.engine
        if eng.mesh is not None:
            return self._dispatch_sharded(batch, content_hw, src)
        dev = eng.device
        return self._step(
            eng.det_model,
            eng.rec_model,
            eng.cls_model if self.with_cls else None,
            torch.from_numpy(batch).to(dev),
            torch.from_numpy(content_hw).to(dev),
            torch.from_numpy(src).to(dev) if src is not None else None,
        )

    def _dispatch_sharded(self, batch, content_hw, src=None) -> FusedOutputs:
        """One step of a batch split over the mesh's data rows: ``prep`` of
        each shard on its device, the batch's tier from the shards'
        (:func:`merge_tiers`), ``rec`` of each shard at that tier, the
        outputs gathered on the first device in shard order. Shards on one
        device run in order on that device's thread."""
        eng = self.engine
        devs = eng.mesh.data_devices
        n = len(devs)
        if batch.shape[0] % n:
            raise ValueError(f"a batch of {batch.shape[0]} does not split over data={n}")
        per = batch.shape[0] // n

        def prep_job(i, dev):
            det_model, _, cls_model = eng.models_on(dev)
            part = slice(i * per, (i + 1) * per)

            def job():
                up = lambda a: torch.from_numpy(a[part]).to(dev)  # noqa: E731
                return self._prep(
                    det_model,
                    cls_model if self.with_cls else None,
                    up(batch),
                    up(content_hw),
                    up(src) if src is not None else None,
                )

            return dev, job

        preps = self._threads.run([prep_job(i, dev) for i, dev in enumerate(devs)])
        tier = merge_tiers([p[6] for p in preps], self.n_batch_tiers)

        def rec_job(crops_n, dev):
            rec_model = eng.models_on(dev)[1]
            return dev, lambda: self._rec(rec_model, crops_n, tier)

        recs = self._threads.run([rec_job(p[0], dev) for p, dev in zip(preps, devs)])
        first = devs[0]
        with torch.inference_mode():

            def cat(parts):
                return torch.cat([t.to(first) for t in parts])

            boxes, quads, valid, score, roots = (
                cat([p[k] for p in preps]) for k in range(1, 6)
            )
            idx, val = cat([r[0] for r in recs]), cat([r[1] for r in recs])
            blank = cat([r[2] for r in recs]) if recs[0][2] is not None else None
            return _outputs(
                batch.shape[0], self.max_boxes, boxes, quads, valid, score, roots,
                idx, val, blank,
            )

    @staticmethod
    def _fetch(out: FusedOutputs) -> FusedOutputs:
        return FusedOutputs(*(t.cpu().numpy() if t is not None else None for t in out))

    def run_step(self, batch: np.ndarray, content_hw: np.ndarray, src=None) -> FusedOutputs:
        """One fused step on the engine's device; numpy in, numpy out."""
        return self._fetch(self._dispatch(batch, content_hw, src))

    def process_batch(
        self,
        images,
        request_ids,
        worker_id: int = 0,
        batch_buckets=None,
        arrival_times=None,
    ):
        """Cross-request batching: same-bucket images go through one fused
        step, padded to a ``batch_buckets`` size. ``processing_time_ms`` is
        per request, from its ``arrival_times`` entry (perf_counter
        seconds; default: batch entry) to the end of its group.

        Every group is dispatched before any is fetched, as in the JAX
        package. On CUDA a step is not one asynchronous dispatch: the
        connected-components loop and the tier read wait for the device, so
        by the time a step returns only its rec forward and CTC top-k are
        still queued. Those run on the device while the host queues the
        next group's det forward, and every group's device work is done
        before the host decodes the first; the per-group copies to the
        host and the host decode overlap nothing."""
        cfg = self.engine.config
        if batch_buckets is None:
            batch_buckets = cfg.request_batch_buckets
        start = time.perf_counter()
        if arrival_times is None:
            arrival_times = [start] * len(request_ids)
        elif len(arrival_times) != len(request_ids):
            raise ValueError(
                f"arrival_times has {len(arrival_times)} entries for "
                f"{len(request_ids)} requests"
            )
        arrival = dict(zip(request_ids, arrival_times))
        mult = self.crop_src_mult
        groups: Dict[tuple, list] = {}
        for image, rid in zip(images, request_ids):
            with record_function("fused.host_resize"):
                resized, ratio_h, ratio_w = det_resize(
                    image, cfg.det.limit_type, cfg.det.limit_side_len
                )
                resized, ratio_h, ratio_w = det_fit_cap(
                    resized, ratio_h, ratio_w, cfg.det.shape_buckets[-1]
                )
                rh, rw = resized.shape[:2]
                # the m× crop source comes from the original image, not
                # from upsampling the det-resized canvas
                src = resize_bilinear_u8(image, rw * mult, rh * mult) if mult > 1 else None
            bh = pick_bucket(cfg.det.shape_buckets, rh)
            bw = pick_bucket(cfg.det.shape_buckets, rw)
            canvas = np.zeros((bh, bw, 3), np.uint8)
            canvas[:rh, :rw] = resized
            groups.setdefault((bh, bw), []).append(
                (canvas, src, (rh, rw), (ratio_h, ratio_w), (rid, image.shape))
            )

        inflight = []  # (chunk, the step's outputs on the device)
        for (bh, bw), items in groups.items():
            stride = self._pad_bucket(pick_bucket(batch_buckets, len(items)))
            for beg in range(0, len(items), stride):
                chunk = items[beg : beg + stride]
                # a trailing partial chunk picks its own batch bucket
                nb = self._pad_bucket(pick_bucket(batch_buckets, len(chunk)))
                batch = np.zeros((nb, bh, bw, 3), np.uint8)
                content_hw = np.zeros((nb, 2), np.int32)  # pad slots: (0, 0)
                src_batch = (
                    np.zeros((nb, bh * mult, bw * mult, 3), np.uint8) if mult > 1 else None
                )
                for j, (canvas, src, (rh, rw), _, _) in enumerate(chunk):
                    batch[j] = canvas
                    content_hw[j] = (rh, rw)
                    if src_batch is not None:
                        src_batch[j, : rh * mult, : rw * mult] = src
                inflight.append((chunk, self._dispatch(batch, content_hw, src_batch)))
                with self._count_lock:
                    self._compiled.add((nb, bh, bw))
                    self.steps_run += 1
                    self.batched_steps += len(chunk) > 1

        results = {}
        for chunk, pending in inflight:
            out = self._fetch(pending)
            group_done = time.perf_counter()
            for j, (_, _, _, (ratio_h, ratio_w), (rid, shape)) in enumerate(chunk):
                with record_function("fused.host_decode"):
                    words = self._words_from_outputs(
                        out, j, ratio_h, ratio_w, shape[1], shape[0]
                    )
                results[rid] = {
                    "request_id": int(rid),
                    "width": int(shape[1]),
                    "height": int(shape[0]),
                    "success": True,
                    "processing_time_ms": (group_done - arrival[rid]) * 1e3,
                    "worker_id": worker_id,
                    "words": words,
                }
        return [results[rid] for rid in request_ids]

    def process(self, image_bgr: np.ndarray, request_id: int = 0, worker_id: int = 0) -> Dict:
        return self.process_batch([image_bgr], [request_id], worker_id)[0]

    def variant_keys(self, batch_buckets=None):
        """The closed set of step shapes (nb, bh, bw) this config can
        dispatch, in warmup priority: smallest batch bucket first (single
        requests land there), then ascending det bucket area."""
        if batch_buckets is None:
            batch_buckets = self.engine.config.request_batch_buckets
        buckets = self.engine.config.det.shape_buckets
        return [
            (nb, h, w)
            for nb in sorted({self._pad_bucket(b) for b in batch_buckets})
            for h, w in sorted(
                ((h, w) for h in buckets for w in buckets),
                key=lambda hw: (hw[0] * hw[1], hw),
            )
        ]

    def compile_variant(self, key) -> bool:
        """Run one blank step of shape ``key = (nb, bh, bw)`` and record it,
        so that cuDNN's algorithm search for the shape (and, the first
        time, the kernel build) happen here and not under a request. On a
        mesh the step's shards run on every device of its data rows: the
        search is per device. Returns True when a step actually ran
        (False: already recorded)."""
        if key in self._compiled:
            return False
        nb, h, w = key
        mult = self.crop_src_mult
        content = np.tile(np.array([[h, w]], np.int32), (nb, 1))
        src = np.zeros((nb, h * mult, w * mult, 3), np.uint8) if mult > 1 else None
        self.run_step(np.zeros((nb, h, w, 3), np.uint8), content, src)
        self._compiled.add(key)
        return True

    def required_variants(self, images, batch_buckets=None):
        """The (nb, bh, bw) keys a ``process_batch(images)`` call will
        dispatch that have not run yet: the serving dispatchers'
        warm-before-dispatch guard. Shape math only, mirroring
        process_batch's det_resize → det_fit_cap → bucket → chunk steps
        (the tests hold the two equal)."""
        cfg = self.engine.config
        if batch_buckets is None:
            batch_buckets = cfg.request_batch_buckets
        groups: Dict[tuple, int] = {}
        for image in images:
            rh, rw = det_target_shape(
                image.shape[0], image.shape[1], cfg.det.limit_type, cfg.det.limit_side_len
            )
            rh, rw = det_cap_shape(rh, rw, cfg.det.shape_buckets[-1])
            key = (
                pick_bucket(cfg.det.shape_buckets, rh),
                pick_bucket(cfg.det.shape_buckets, rw),
            )
            groups[key] = groups.get(key, 0) + 1
        need = []
        for (bh, bw), count in groups.items():
            stride = self._pad_bucket(pick_bucket(batch_buckets, count))
            for beg in range(0, count, stride):
                nb = self._pad_bucket(pick_bucket(batch_buckets, min(stride, count - beg)))
                k = (nb, bh, bw)
                if k not in self._compiled and k not in need:
                    need.append(k)
        return need

    def warmup(self, batch_buckets=None) -> float:
        """Run one blank step of every shape in :meth:`variant_keys`.
        Returns seconds."""
        t0 = time.perf_counter()
        for key in self.variant_keys(batch_buckets):
            self.compile_variant(key)
        return time.perf_counter() - t0
