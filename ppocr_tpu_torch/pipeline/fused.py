"""Fused det → boxes → crops → rec request, in PyTorch on one device.

Counterpart of ``ppocr_tpu/pipeline/fused.py`` for the serving profile's
slice: greedy decode, axis-aligned boxes, no cls, crops sampled from the
det canvas (``fused_crop_src_mult=1``), width × batch-count tiers, and the
blob-stats kernel behind ``fused_blob_kernel``. The request runs as::

    uint8 canvas ─▶ DBNet ─▶ uint8 threshold ─▶ connected components ─▶
    top-K blob stats ─▶ unclip/validity ─▶ tier compaction ─▶ bilinear crops
    (two matmuls) ─▶ SVTR on the tier's slice ─▶ CTC top-k kernel ─▶ host
    collapse + JSON words

Where the JAX step vmaps over the request batch, every function here
carries the batch as a leading dimension. ``lax.switch`` on the rec tier
becomes one ``.item()`` on the host, and the connected-components
``while_loop`` a Python loop with one ``any()`` sync per iteration.
"""

from __future__ import annotations

import time
from typing import Dict, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from ..models.det_db import det_forward
from ..models.rec_svtr import rec_forward, rec_timesteps
from ..ops.ctc import ctc_greedy_collapse, ctc_topk_device
from ..ops.kernels import blob_stats, blob_stats_plain
from ..ops.normalize import HALF_MEAN, HALF_SCALE, IMAGENET_MEAN, IMAGENET_SCALE
from ..ops.resize import det_fit_cap, det_resize
from .config import pick_bucket


class FusedOutputs(NamedTuple):
    # every field has a leading batch axis B; index as field[b, i]
    boxes: torch.Tensor  # [B, K, 4] int32 (x0, y0, x1, y1) det-image coords
    valid: torch.Tensor  # [B, K] bool
    scores: torch.Tensor  # [B, K] f32 blob-mean det score
    ctc_idx: torch.Tensor  # [B, K, T] int32
    ctc_prob: torch.Tensor  # [B, K, T] f32
    roots: torch.Tensor  # [B, K] int32 raster index of the blob's first pixel
    quads: torch.Tensor  # [B, K, 4, 2] int32 axis-box corners (TL, TR, BR, BL)


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


def _blob_stats(
    labels: torch.Tensor, prob: torch.Tensor, max_boxes: int, use_kernel: bool = False
) -> Dict[str, torch.Tensor]:
    """Per-blob area/bbox/score of the top ``max_boxes`` blobs by area
    (:func:`_select_roots`). The bbox and prob mass come from
    ``ops.kernels.blob_stats`` (``use_kernel``) or its plain
    masked-reduction version. labels/prob: [B, H, W]."""
    top_area, top_idx = _select_roots(labels, max_boxes)
    stats_fn = blob_stats if use_kernel else blob_stats_plain
    _area, psum, x0, x1, y0, y1 = stats_fn(labels, prob, top_idx)
    return {
        "area": top_area,
        "score": psum / torch.clamp(top_area, min=1.0),
        "x0": x0,
        "x1": x1,
        "y0": y0,
        "y1": y1,
        "root": top_idx,
    }


def _crop_resize_bilinear(img_f32, x0, y0, x1, y1, content_w, out_h, out_w):
    """Sample each box of each image to [out_h, out_w, 3]; columns ≥
    content_w are black (rec pads before normalizing).

    img_f32: [B, H, W, 3]; x0..content_w: [B, K] → [B, K, out_h, out_w, 3].
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
    n_width_tiers: int = 2,
    blob_kernel: bool = False,
    n_batch_tiers: int = 1,
):
    """``prep(det_model, img_u8, content_hw)`` → (crops_n [B·K, h, w, 3]
    normalized, boxes, quads, valid, score, roots, tier) and ``rec(
    rec_model, crops_n, tier)`` → (ctc idx, ctc prob), as the JAX
    function's halves for the ported slice (greedy decode, axis-aligned
    boxes, no cls, no dilation, crops from the det canvas). ``tier =
    width_tier · n_batch_tiers + batch_tier`` is a Python int here (the
    host reads it once per request)."""
    if n_batch_tiers < 1 or (max_boxes >> (n_batch_tiers - 1)) < 1:
        raise ValueError(
            f"n_batch_tiers={n_batch_tiers} needs 1 <= n and "
            f"max_boxes >> (n-1) >= 1 (max_boxes={max_boxes})"
        )
    thresh_u8 = int(det_thresh * 255)
    consts = {}  # device → normalization constants, uploaded once per device

    def norm_consts(dev):
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
        with record_function("fused.cc"):
            labels = _connected_components(fg)
        with record_function("fused.blob_stats"):
            stats = _blob_stats(labels, prob, max_boxes, use_kernel=blob_kernel)

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

    def prep(det_model, img_u8, content_hw):
        """img_u8: [B, H, W, 3] uint8; content_hw: [B, 2] int32 (rh, rw)
        resized extents inside the padded canvas (both on one device)."""
        imgs = img_u8.float()
        nb = imgs.shape[0]
        mean, scale, half_mean, half_scale = norm_consts(imgs.device)
        x = (imgs / 255.0 - mean) * scale
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
        with record_function("fused.crops"):
            crops = _crop_resize_bilinear(
                imgs, cx0, cy0, cx1, cy1, content_w, rec_img_h, rec_img_w
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

    def rec(rec_model, crops_n, tier: int):
        """Recognizer + CTC top-k on the tier's slice; narrower slices'
        outputs are padded with pure-blank timesteps and slots (blank id
        0, prob 1.0), so the host decode is unchanged."""
        kw, kb = divmod(tier, n_batch_tiers)
        nb = crops_n.shape[0] // max_boxes
        kslots = max_boxes >> kb
        width = rec_img_w >> kw
        c = crops_n.reshape(nb, max_boxes, rec_img_h, rec_img_w, 3)[:, :kslots, :, :width]
        c = c.reshape(nb * kslots, rec_img_h, width, 3)
        with record_function("fused.rec"):
            probs = rec_forward(rec_model, c)
        with record_function("fused.ctc_topk"):
            idx, val = ctc_topk_device(probs)
        t = idx.shape[1]
        idx = F.pad(idx, (0, t_full - t), value=0)
        val = F.pad(val, (0, t_full - t), value=1.0)
        if kslots != max_boxes:
            idx = F.pad(idx.reshape(nb, kslots, t_full), (0, 0, 0, max_boxes - kslots), value=0)
            val = F.pad(val.reshape(nb, kslots, t_full), (0, 0, 0, max_boxes - kslots), value=1.0)
        return idx.reshape(nb * max_boxes, t_full), val.reshape(nb * max_boxes, t_full)

    return prep, rec


def build_fused_step(**kwargs):
    """``step(det_model, rec_model, img_u8[B, H, W, 3], content_hw[B, 2])
    -> FusedOutputs`` — the composition of :func:`build_fused_parts` (same
    keyword arguments), run under ``torch.inference_mode``."""
    prep, rec = build_fused_parts(**kwargs)
    max_boxes = kwargs["max_boxes"]

    @torch.inference_mode()
    def step(det_model, rec_model, img_u8, content_hw):
        crops_n, boxes, quads, valid, score, roots, tier = prep(
            det_model, img_u8, content_hw
        )
        idx, val = rec(rec_model, crops_n, tier)
        nb = img_u8.shape[0]
        return FusedOutputs(
            boxes,
            valid,
            score,
            idx.reshape(nb, max_boxes, -1),
            val.reshape(nb, max_boxes, -1),
            roots,
            quads,
        )

    return step


def fused_part_kwargs(engine, max_boxes: int) -> dict:
    """Config → :func:`build_fused_parts` kwargs (``engine.check_slice``
    has already refused every option outside the ported slice)."""
    cfg = engine.config
    mult = int(cfg.fused_width_mult)
    if mult < 1 or (mult & (mult - 1)):
        raise ValueError(f"fused_width_mult must be a power of two: {mult}")
    return {
        "det_thresh": cfg.det.thresh,
        "box_thresh": cfg.det.box_thresh,
        "unclip_ratio": cfg.det.unclip_ratio,
        "rec_img_h": cfg.rec.img_h,
        "rec_img_w": mult * cfg.rec.img_w,
        "max_boxes": max_boxes,
        "dtype": engine.dtype,
        "n_width_tiers": mult.bit_length(),
        "blob_kernel": bool(cfg.fused_blob_kernel),
        "n_batch_tiers": int(cfg.fused_batch_tiers),
    }


class FusedOCR:
    """Single-dispatch serving wrapper sharing an OCREngine's modules."""

    def __init__(self, engine, max_boxes: int = 32):
        self.engine = engine
        self.max_boxes = max_boxes
        self._step = build_fused_step(**fused_part_kwargs(engine, max_boxes))

    def _words_from_outputs(self, out, b, ratio_h, ratio_w, src_w, src_h):
        """Host decode of image ``b`` of numpy ``out`` into response words,
        in descending blob-root order (cv2.findContours emission order)."""
        kept, conf = ctc_greedy_collapse(out.ctc_idx[b], out.ctc_prob[b])
        words = []
        order = sorted(range(self.max_boxes), key=lambda i: -int(out.roots[b, i]))
        for i in order:
            if not out.valid[b, i] or np.isnan(conf[i]):
                continue
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
                    "box": box,
                }
            )
        return words

    def run_step(self, batch: np.ndarray, content_hw: np.ndarray) -> FusedOutputs:
        """One fused step on the engine's device; numpy in, numpy out."""
        dev = self.engine.device
        out = self._step(
            self.engine.det_model,
            self.engine.rec_model,
            torch.from_numpy(batch).to(dev),
            torch.from_numpy(content_hw).to(dev),
        )
        return FusedOutputs(*(t.cpu().numpy() for t in out))

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
        seconds; default: batch entry) to the end of its group."""
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
            bh = pick_bucket(cfg.det.shape_buckets, rh)
            bw = pick_bucket(cfg.det.shape_buckets, rw)
            canvas = np.zeros((bh, bw, 3), np.uint8)
            canvas[:rh, :rw] = resized
            groups.setdefault((bh, bw), []).append(
                (canvas, (rh, rw), (ratio_h, ratio_w), (rid, image.shape))
            )

        results = {}
        for (bh, bw), items in groups.items():
            stride = pick_bucket(batch_buckets, len(items))
            for beg in range(0, len(items), stride):
                chunk = items[beg : beg + stride]
                nb = pick_bucket(batch_buckets, len(chunk))
                batch = np.zeros((nb, bh, bw, 3), np.uint8)
                content_hw = np.zeros((nb, 2), np.int32)  # pad slots: (0, 0)
                for j, (canvas, (rh, rw), _, _) in enumerate(chunk):
                    batch[j] = canvas
                    content_hw[j] = (rh, rw)
                out = self.run_step(batch, content_hw)
                group_done = time.perf_counter()
                for j, (_, _, (ratio_h, ratio_w), (rid, shape)) in enumerate(chunk):
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

    def warmup(self, batch_buckets=None) -> float:
        """Run one blank request of every step shape (batch bucket × det
        bucket pair), so that cuDNN's algorithm choice and the kernel build
        happen before the first real request. Returns seconds."""
        cfg = self.engine.config
        if batch_buckets is None:
            batch_buckets = cfg.request_batch_buckets
        buckets = cfg.det.shape_buckets
        t0 = time.perf_counter()
        shapes = [(nb, h, w) for nb in sorted(set(batch_buckets)) for h in buckets for w in buckets]
        for nb, h, w in shapes:
            content = np.tile(np.array([[h, w]], np.int32), (nb, 1))
            self.run_step(np.zeros((nb, h, w, 3), np.uint8), content)
        return time.perf_counter() - t0
