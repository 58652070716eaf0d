"""Drive the PyTorch port's fused and staged OCR requests, its IPC service
(single- and multi-process; PNG, JPEG and BMP payloads), its client's
``--visualize``, its trace, boot and soak tools, its host utilities and
its training path, on one device and over a mesh, on one NVIDIA card and
check them.

    python3 chip_smoke.py
    python3 chip_smoke.py --only="synthetic train"   # some phases alone, no result lines

Phases (any failure exits non-zero without the final ``ok`` line):

1. the card (``nvidia-smi`` name and power limit), the kernel build
   (``nvcc`` for sm_90a from ``ppocr_tpu_torch/csrc``) and the build of
   the host postprocess library (``csrc/dbpost.cpp``, host compiler) and
   of the host warps (``csrc/warp.cpp``);
2. each hand-written kernel against its plain PyTorch version on the card
   (``ctc_topk``: index and value exact; ``blob_stats``: count and bbox
   exact, prob mass rtol 1e-5) at the serving shapes and at the edges of
   each design (rows and base pointers that are not 16-byte aligned, tiny
   V, ties and NaN in a row's peeled head and tail; W = 500, H·W % 4 != 0,
   K = 1 and 40, B = 4, all background, one blob over the whole map, the
   same call twice), and device times (CUDA events, median of 25 runs, L2
   flushed before each, host launch overhead excluded): ``floor_ms`` an
   empty kernel of one thread (what a launch alone costs), ``ms`` the
   bare kernel, ``wrapper_ms`` the wrapper with its output allocation,
   ``plain_ms`` the plain version, ``library_ms`` one PyTorch call
   computing the same (``torch.max`` for ``ctc_topk``; none for
   ``blob_stats``), and ``warm_ms``, the bare kernel without the L2 flush
   (on the path each kernel reads what the launch before it just wrote).
   ``ctc_topk`` is also held exact and timed at the staged path's tiers
   (rec batch bucket × width bucket / 8 timesteps);
3. f32 parity, TF32 off, against the JAX package's committed goldens
   (``ppocr_tpu_torch/assets``): the 96 px "small" config and
   "serving-jumbo" (``PipelineConfig.serving()`` with rec 48×256);
4. serving-jumbo in bf16 through ``OCRWorker.process`` (8 requests) and
   one 4-image ``process_batch`` with buckets (1, 4), then again with
   ``fused_blob_kernel=True`` (same words required). The kernels' launch
   counters are zeroed just before this phase and must be > 0 after it;
5. devices (the fused path over several devices, on one card): an engine
   over ``make_mesh(devices=["cuda:0", "cuda:0"])`` (two data shards on
   card 0), serving-jumbo in bf16 with ``fused_blob_kernel``, runs phase
   4's 8 single requests and its 4-image ``process_batch`` with buckets
   (1, 4): the words equal phase 4's (texts exact, boxes <= 2 px,
   confidence <= 2e-3). Then the same engine's ``cross_chip_ocr()``, both
   stages on card 0: ``process_stream`` of the 8 requests gives phase 4's
   words. The launch counters are zeroed just before these requests and
   must then read 2 per data-parallel step (one per shard) plus 1 per
   cross-chip request, for ``ctc_topk`` and for ``blob_stats`` alike.
   Then, f32 with TF32 off, both paths on the serving scenes against the
   JAX goldens as in phase 3, and ``sharded_rec_infer`` over the two
   shards against one rec step at [32, 48, 256] (index and value exact).
   Prints the request p50 of the single-device, data-parallel and
   cross-chip paths, in turns; two cards were not measured;
6. the fused path's options, one engine per config: the "small" config
   plus one of ``enable_cls`` (an untrained classifier from a seed,
   written to ``cls/weights.npz``), ``det.use_dilation``,
   ``fused_rotated_boxes``, ``fused_crop_src_mult=2``,
   ``rec.decode="beam"``, f32 with TF32 off, words held against the JAX
   goldens of that config as in phase 3. ``ctc_topk``'s launch counter is
   zeroed before each config and must rise in every greedy one and stay
   at 0 in the beam one (the JAX package uses ``lax.top_k`` there). Then
   each option at full width (serving-jumbo, bf16, 768×1024 requests):
   its request p50 beside the base config's, three rounds in turns, as
   wall time of the call (host decode included) and as the response's
   ``processing_time_ms`` (which ends before the host decode);
7. the service: ``python3 -m ppocr_tpu_torch.cli.service_main`` as a
   subprocess on the jumbo bundle, serving profile in bf16 (det 512,
   K = 32, rec 48×256), ``--batch-requests 4 --warmup full``, driven
   through ``OCRIPCClient``: ``recognize`` by ``image_path`` and by
   ``image_data`` (PNGs written by ``encode_png``), 8 concurrent requests
   from threads (the batcher must coalesce: ``batched_steps`` ≥ 1 in
   ``status``), a malformed JSON line, a corrupt JPEG payload (error response),
   ``status`` (total = successful + failed; the kernels' launch counts
   rise over the requests), phase 4's eight single requests twice over
   for the service's request p50 (client wall time, PNG decode and IPC
   included) in turns with the same requests in process, ``shutdown``
   (exit code 0). Single requests must give the words
   phase 4 got in process for the same scene (texts exact, boxes ≤ 2 px,
   confidence ≤ 2e-3); a request served in a batch of another size may
   round differently in bf16, so the coalesced ones are held to the same
   word count, boxes ≤ 2 px and ≥ 0.9 of the texts. Then a second service
   with ``--cpu-workers 2 --warmup incremental`` and the blob-stats
   kernel on: 8 concurrent requests through two worker threads that share
   the stream, the modules and the kernel's scratch. Before the first
   service shuts down: ``ocr-client scene0.png --visualize
   out.png`` exits 0, launches ``ctc_topk`` ("visualize" launches), reads
   phase 4's words, and out.png decodes to ``visualize_boxes`` of the
   decoded scene and those words (the scene's pixels outside the drawn
   quads); the golden words of scene0 drawn by ``visualize_boxes`` equal
   cv2's drawing of them (``assets/visualize_mask.npz``); host ms of the
   drawing and of the PNG write (median of 7).

8. staged parity: f32, TF32 off, ``fast_path`` off, against the JAX
   package's staged goldens (made with its cv2 postprocess; the port has
   the C++ core only): "small-staged", "small-staged+cls" and
   "serving-staged". Per scene at most one word without a partner, every
   partner's corners within 2 px, partners' texts identical, confidences
   within 2e-3 where the boxes are equal and 0.05 where they differ;
9. staged serving in bf16 at full width on the 768×1024 scenes, through
   ``OCRWorker.process``: ``PipelineConfig.serving()`` staged and
   ``PipelineConfig.defaults()`` (det limit 960), both with the jumbo
   bundle's rec geometry (48×256), every staged step shape warmed first.
   ``ctc_topk``'s launch counter is zeroed before the requests and must
   be > 0 after; prints request p50/p90, the median of each stage's
   [preprocess, inference, postprocess] ms, the rec step shapes met (a
   shape at which phase 2 did not hold ``ctc_topk`` against its plain
   version fails the phase) and the share of the golden texts read;
10. processes: ``service_main --processes 2 --staged`` as a subprocess:
   concurrent requests through the public socket are answered by both
   workers (the merged ``status`` shows both), one worker is killed and
   replaced while the other serves, ``shutdown`` fans out, the supervisor
   exits 0 and no child process is left. The workers count their launches
   from their start, warmup included, so the path's launches are the
   difference of the merged ``status`` before and after 12 sequential
   requests: at least one ``ctc_topk`` each, no ``blob_stats``. Prints
   boot seconds and the request p50 beside a single-process staged
   service's;
11. jpeg vs cv2: the image decoders (``csrc/jpeg.cpp`` built with the
    host compiler, ``utils/imcodec.py``) on every committed case
    (``assets/jpeg_cases.npz``: the serving scenes, one also progressive,
    golden-word crops, every sampling, grey, 1×1, a restart interval,
    EXIF orientations 1–8, progressive, CMYK / YCCK and arithmetic-coded
    JPEGs, Adam7 PNGs, cut and garbled JPEGs), each equal to the cv2
    decode stored beside it, or ``None`` where cv2 gave ``None``; the
    host ms to decode the 768×1024 4:2:0 q95 scene, baseline and
    progressive, in turns (median of 25 each);
12. jpeg service: the two serving scenes as JPEG payloads, the first also
    progressive, and a CMYK crop of it through the service (a subprocess
    as in phase 6) answer the words phase 4's in-process worker gives on
    the port's decode of the same bytes (texts exact, boxes ≤ 2 px), and
    the service's ``status`` shows ``ctc_topk`` launched by those four
    requests; the client wall p50 of JPEG and PNG requests of the same
    scenes, taken in turns;
13. image formats vs cv2: every committed case of ``assets/image_cases.npz``
    (BMPs of every depth, compression and header kind, PPM/PGM/PBM/PAM, Sun
    raster, damaged-zlib PNGs, rows over 32 KiB under a small zlib window,
    PFM, Radiance HDR, GIF, TIFF and BigTIFF of every kind the port
    decodes, CCITT fax and JPEG ones included, and WebP, lossless (simple,
    extended and animated files, written VP8L streams) and lossy (cv2's,
    PIL's and written VP8 frames, with ALPH chunks and as animations'
    first frames), garbled, cut and mutated files, damaged TIFF strips and
    JPEG headers among them) decoded with ``decode_image``
    (``csrc/bmp_rle.cpp``, ``csrc/hdr_rgbe.cpp``, ``csrc/gif_lzw.cpp``,
    ``csrc/tiff.cpp`` with ``csrc/jpeg.cpp`` and ``csrc/webp.cpp`` with
    ``csrc/vp8.cpp`` built with the host compiler), each equal to the cv2
    decode stored beside it (a grey PFM's is [H, W]), or ``None`` where cv2
    gave ``None``; the case counts by format, the TIFF count, the fax
    count, the JPEG TIFF count and the lossless and lossy WebP counts
    (``webp_vs_cv2``, ``webp_lossy_vs_cv2``); the host ms to
    decode the first 768×1024 serving scene as a 24-bit BMP, an RLE8 BMP of its grey, a
    binary PPM, a standard Sun raster, a byte-encoded one (which cv2 5.0
    refuses: the time of the refusal), a PFM, a run-length HDR, a GIF and
    cv2's own TIFFs (uncompressed, LZW with the predictor, PackBits,
    deflate), the scene thresholded to 1 bit as G4, G3 1D, G3 2D, CCITT RLE
    and RLEW TIFFs and a 1728×2304 fax page of it as G4, and the scene as
    YCbCr JPEG TIFFs (q95 4:2:0 under JPEGTables, in 64-row strips and in
    256×256 tiles, and phase 11's scene0 JPEG as one strip) beside that
    bare JPEG, and the scene as cv2's default (lossless) WebP and its grey
    in 16 levels as one (colour indexing, two pixels a byte), and as cv2's
    q90 lossy WebP, without and with an alpha channel (a lossless ALPH
    chunk), in turns, median of 25 after one untimed; then the same
    24-bit and RLE8 BMPs, the LZW TIFF (as data) and the uncompressed TIFF
    (by path) through the service (a subprocess as in phase 7) answer the
    words of the PNG of the same pixels (texts exact, boxes ≤ 2 px), the
    service's ``status`` shows ``ctc_topk`` launched by the TIFF requests,
    the G4 fax TIFF (as data) answers the words of the PNG of cv2's decode
    of it and launches ``ctc_topk`` ("fax service"), the HDR and
    the GIF answer the words phase 4's in-process worker gives on the
    port's decode of the same bytes, and the service's ``status`` shows
    ``ctc_topk`` launched by the BMP requests and by the HDR and GIF ones,
    the one-strip JPEG TIFF (as data) answers the words phase 4's worker
    gives on its decode and those of the bare JPEG request, and launches
    ``ctc_topk`` ("jpeg tiff service"), the lossless WebP (as data)
    answers the words of the PNG of the same pixels and launches
    ``ctc_topk`` ("webp service"), and so does the q90 lossy one, with
    one ``ctc_topk`` launch ("lossy webp service"), and the JPEG
    2000 cases (JP2 and raw codestreams decoded by ``csrc/jpeg2000.cpp``,
    the ``jpeg2000_vs_cv2`` count), the host ms of the scene as cv2's
    default (lossless) ``.jp2`` and as an irreversible (9/7) J2K beside the
    bare JPEG, and the scene as an irreversible JP2 (as data) against the
    PNG of the same pixels with one ``ctc_topk`` launch ("jpeg2000
    service"), and the AVIF cases (8-bit stills decoded by
    ``csrc/av1.cpp``, lossless and lossy, deblocked and CDEF-filtered,
    4:4:4, 4:2:2, 4:2:0 or monochrome, converted by ``csrc/avif_yuv.cpp``
    as libavif converts them: the ``avif_vs_cv2``, ``avif_lossy_vs_cv2``,
    ``avif_chroma_vs_cv2`` and ``avif_filtered_vs_cv2`` counts), the host
    ms of the scene as cv2's lossless AVIF, as a lossy 4:4:4 one (q90,
    filters off), as cv2's quality-95 file (4:2:0, BT.601) and as cv2's
    default (quality 50, deblocked and CDEF-filtered) and at speed 4 (the
    same with Wiener loop restoration on luma, the ``avif_restored_vs_cv2``
    count) and as Pillow's 4:2:0 q60 file with libaom's film-grain test
    vector 4 (the ``avif_grain_vs_cv2`` and ``avif_superres_vs_cv2``
    counts), and each file (as data) against the PNG of cv2's pixels: the
    same words exactly, with one ``ctc_topk`` launch each ("avif service",
    "lossy avif service", "subsampled avif service", "default avif
    service", "restored avif service", "grain avif service"); a
    grey PFM sent as data gets the in-process worker's error response (the
    JAX service's answer, held on the CPU by
    ``tests/test_torch_image_formats.py``), and sent by path the "Failed to
    load image" response;
14. train parity: f32, TF32 off, from the same JAX-layout weights and
    numpy batches, 3 rec CTC steps (the jumbo recognizer, 8 crops at
    48×320, labels with a repeat and padding) and 3 det steps (the trained
    detector, 2 × 256×256) on the card against the same steps on the CPU:
    losses to rtol 1e-4, parameters as ``adam_close`` states. The det
    steps start from trained weights: ``init_det_params`` saturates the
    sigmoid, the clipped BCE then has gradients at few pixels, and Adam
    turns the rest's rounding noise into ±lr steps, so two devices (or
    the two packages on the CPU) part by 0.5 % in three steps. Then the
    CTC loss alone, card against CPU, on [8, 40, 5008] logits with a row
    of 44 labels that cannot be aligned (optax's finite value): values to
    rtol 1e-5, gradients to rtol 1e-4 (2^-5 on that row: its forward
    variables sit near −1e5, where f32 values are 2^-7 apart);
15. finetune: ``finetune_rec`` on the card from the jumbo weights with the
    jumbo charset (head kept) at 48×320, batch 32, on PNG crops of the
    serving scenes' golden words plus the committed JPEG crops: step ms
    (CUDA events between step ends, median after 10 warm steps), crops/s,
    peak memory, the loss at the first and last step (it must fall). The
    exported bundle is then served as the fused serving profile (bf16,
    rec 48×256) with it as ``rec/``: ``ctc_topk``'s counter is zeroed
    before and must rise, and the share of the scenes' golden texts read
    is printed beside the jumbo bundle's under the same config;
16. det train: ``make_det_train_step`` from ``init_det_params`` at batch
    8 × 512×512, shrink masks filled from the golden boxes in numpy, 20
    steps: step ms, peak memory, the losses (finite; from this saturated
    init they wander instead of falling, in the JAX package too);
17. train devices (training over several devices, on one card whose
    devices repeat, as in phase 5): ``dryrun_multichip(8, ["cuda:0"] * 8)``
    in f32 with TF32 off gives the JAX package's mesh ``{'data': 4,
    'model': 2}``, ctc loss within rtol 1e-4 of 65.0417 and det BCE within
    1e-4 of 0.6932 (``MULTICHIP_r05.json``); the jumbo recognizer at 32 ×
    48×320 over data 2 (``make_mesh(devices=["cuda:0"] * 2)``) and over
    data 1 × model 2, and the trained detector at 8 × 512×512 over data 2:
    3 steps in f32 with TF32 off against the one-device step (losses rtol
    1e-5, parameters as ``adam_close`` states, the rows' copies bit-equal),
    then 3 untimed steps of each and of the one-device step and two rounds
    of 20 timed steps of each in turns (cuDNN's default TF32): step ms
    (CUDA events between step ends), peak memory, kernel launches per step
    (``torch.profiler``, two steps); then
    ``sharded_rec_infer`` over data 2 × model 2 on the golden-word crops at
    48×256 against one rec step: the index equal wherever the top two
    probabilities differ by more than 1e-4, the value rtol 2e-4, and the
    launch counters zeroed just before it read 2 ``ctc_topk`` launches.
    Two or four cards are not measured;
18. trace: one fused bf16 request of scene0 on phase 4's engine
    inside ``engine.profile_trace(dir)``: the request reads phase 4's
    words, the Chrome trace written holds the ``fused.ctc_topk`` span and
    CUDA events of the ``ctc_topk`` kernel (the counters zeroed just
    before it show its launch); prints the trace's size and its kernel
    events;
19. boot and soak: ``scripts/measure_boot_torch.py --mode
    incremental`` (the jumbo bundle's serving profile: seconds to the
    socket, the first OK, every fused step shape run), then
    ``scripts/soak_torch.py --duration 10 --concurrency 4`` with 30
    control requests against ``service_main --batch-requests 4 --warmup
    full``: both JSON summaries printed, 0 errors, the service's request
    count equal to the client's, ``ctc_topk`` launched;
20. host utilities: ``ops.structure``'s table and PicoDet decode,
    ``table_resize`` / ``table_pad``, ``normalize_imagenet_np``,
    ``get_mini_boxes``, ``unclip_rect`` and ``boxes_from_bitmap`` (with
    ``min_size``) on the small inputs of ``assets/host_cases.npz``,
    against the JAX package's answers stored beside them (tolerances in
    ``Smoke.host_utilities``): none of them reaches for cv2, which the
    card's machine does not have;
21. synthetic train (the jumbo recipe's data, made on the card's host
    from the committed glyph atlas, with no PIL, cv2 or fontTools): 16
    scenes of ``text_scene_dataset("jumbo", seed)`` (4 seeds × 4) equal
    ``assets/synthetic_digest.json`` (texts, boxes and the sha256 of the
    pixels the JAX package renders), and 2 rotated ``SceneCropRecDataset``
    batches (seed 7, 48×256, ±8°, batch 48) equal its ``rotated_batches``
    hashes (``csrc/warp.cpp``'s warpAffine against cv2's pixels); then the
    recipe of
    ``scripts/train_jumbo_torch.sh`` at full width: ``SceneCropRecDataset``
    (48×256, ±8° rotation) on ``text_scene_dataset("jumbo", seed=7)``,
    batch 48, the recognizer warm-started from ``weights/rec_scene_full.npz``
    with its head re-sized to the 5,008 jumbo classes, under the recipe's
    cosine schedule, through the recipes' own loop
    (``train.trainer.run_steps``: the batches made on its
    ``BatchPrefetcher`` thread while the card steps): 8 steps on batches
    rendered beforehand, 20 on batches it renders, then 9 more under
    ``torch.profiler`` (the last 6 traced); every loss finite and the mean
    of the last 5 below the first. Then the same for
    ``make_det_train_step`` on ``text_scene_dataset("jumbo").det_batch(8)``
    (8 prefetched steps; losses finite). Prints the host ms per rendered
    batch (alone before training, and on the prefetch thread while it
    runs), the step ms (CUDA events from the batch in hand to the step's
    return, median after 3 warm steps), the step period (between step
    ends), the period's stretch when the thread renders
    (1 − period on batches made beforehand / period on rendered ones),
    the card's idle share and device busy ms a step read from the trace
    (the union of kernels, copies and sets over the traced window, which
    the profiler's own host work stretches) and that busy time against
    the untraced periods (``card_idle_share_est``), the
    host's wait in the prefetcher, peak memory, the threads and float32
    settings the phase starts with, and the kernels' launches in the path
    (neither hand-written kernel is on it). Last, both scripts,
    ``scripts/train_synthetic_rec_torch.py`` (the jumbo recipe's flags,
    batch 48) and ``scripts/train_synthetic_det_torch.py``, run 2 steps
    each on the card by default, with their evals: the rec npz holds a
    5,008-class head. No fallback: a failure fails the phase;
22. jumbo gate: the trained-jumbo accuracy gate of
    ``ppocr_tpu_torch.train.eval_jumbo`` on the card, f32 with TF32 off,
    over the committed bundle: 34 held-out scenes of each of seeds 90210,
    777 and 31337 through the staged and the fused gate configs, the wide
    banner of ``assets/jumbo_banner.npz`` (Pillow's drawing, committed)
    through the staged width buckets and the fused path's widest tier,
    and the staged head indices of 8 scenes of seed 777. Every bar of the
    gate must hold (≥ 200 words; det recall; staged ≥ 0.90 normalized and
    ≥ 0.62 raw; fused ≥ 0.90 and within 2 words of staged; banner
    similarity ≥ 0.75 on both paths; head indices above 4,000, more than
    60 distinct). Prints each path's exact, normalized, total, det found
    and ms per scene (the first scene's warm-up included) beside the CPU
    figures of ``tests/test_torch_e2e_jumbo.py``; the kernels' launches
    over the whole phase are its path "jumbo gate";
23. cv2 digits: the digit datasets, which the JAX package draws with
    cv2's Hershey fonts (cv2 5.0: its embedded Rubik face), drawn on the
    card's host by ``train/cv2_text.py`` (``csrc/cv2_text.cpp``, built
    here with the host compiler): 16 ``SyntheticSceneDataset`` scenes,
    2 ``SyntheticRecDataset`` batches and 2 digit ``SceneCropRecDataset``
    batches (±8°) equal the "cv2" section of
    ``assets/synthetic_digest.json`` (the JAX package's renders); the
    host ms of a 48-line rec batch, a digit scene and one ``put_text``
    (``scripts/time_cv2_text_torch.py``'s workloads); the rec step on
    digit lines (48×192, batch 32, a 6,625-class head) and the det step
    on digit scenes (batch 16) timed with CUDA events (median of 10 after
    3 warm steps); ``--alphabet digits`` of both training scripts (rec
    lines and scene crops, det) for 3 steps each on the card; then the
    digits gate's 12 scenes (``train.eval_digits``, seed 424) served from
    ``weights/det_synthetic_digits.npz`` + ``rec_scene_digits.npz`` with a
    placeholder keys file, staged and fused, f32 with TF32 off, every
    scene's words held to the JAX package's (``assets/digits_words.json``;
    texts exact, boxes <= 2 px, confidence <= 2e-3). No accuracy bar: the
    gate's bars need the reference charset. The kernels' launches over the
    served scenes are its path "cv2 digits".

It then prints the ``kernels`` JSON line, the card line, and
``{"ok": true, "device": {...}}`` last. Weights are the repo's jumbo bundle
(``weights/``); nothing is fetched.
"""

from __future__ import annotations

import base64
import contextlib
import glob
import importlib.util
import io
import json
import logging
import math
import os
import pathlib
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import traceback

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_OPS_PER_S = 67e12  # H100 SXM non-tensor f32 peak (also used for int32 compares)
BOX_TOL = 2  # px; det conv summation order can flip a threshold pixel
CONF_TOL = 2e-3
MOVED_BOX_CONF_TOL = 0.05  # staged: a word whose box differs reads another crop
# ctc_topk on the staged path: [rec batch bucket, width bucket / 8, V]. The
# serving profile batches 16 crops (buckets 1, 2, 4, 8, 16), the defaults
# profile 6 (1, 2, 4, 6); widths from 192 (T = 24) to 1280 (T = 160). The
# committed 768x1024 scenes give the first three (with (16, 32, 5008), the
# fused request's tier, which the serving profile's staged rec step shares);
# "staged serving" fails on a rec step whose shape was not held against the
# plain version. The others are further buckets of the two profiles.
STAGED_TIERS = ((6, 40, 5008), (4, 40, 5008), (16, 40, 5008), (16, 24, 5008), (1, 40, 5008),
                (6, 160, 5008))
# ctc_topk in "train devices": one data row of sharded_rec_infer over data 2
# x model 2 on the six golden-word crops at 48x256
SHARDED_TIER = (3, 32, 5008)
PSUM_RTOL = 1e-5
REPO = pathlib.Path(__file__).resolve().parent


class f32_exact:
    """TF32 off inside the block (cuDNN convs default to TF32 on Hopper)."""

    def __enter__(self):
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = False


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=30,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def cuda_ms(fn, flush, reps: int = 25) -> float:
    """Median device ms of ``fn()`` over ``reps`` runs, L2 flushed before
    each (not flushed when ``flush`` is None). The card first sleeps while
    the host queues every run, so the events time the device work and not
    the host's launch overhead."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)  # ~50 ms of device time
    pairs = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def service_launches(client) -> dict:
    """The kernels' launch counts of a service, from its ``status``."""
    return json.loads(client.get_service_status()["status"])["kernel_launches"]


def launches_since(client, before: dict, what: str) -> dict:
    """The service's launches since ``before``; raises unless ``ctc_topk``,
    which every recognize request of the fused path runs, rose."""
    delta = {k: n - before[k] for k, n in service_launches(client).items()}
    if delta["ctc_topk"] < 1:
        raise AssertionError(f"the {what} requests never launched ctc_topk: {delta}")
    return delta


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    same = (torch.isnan(a) & torch.isnan(b)) | (a == b)  # equal infinities too
    d = torch.where(same, 0.0, (a.double() - b.double()).abs())
    return float(d.max())


class Smoke:
    # the training phases: finetune_rec steps (the first FT_WARM untimed),
    # batch and crop width; det steps, batch and image side
    FT_STEPS, FT_WARM, FT_BATCH, FT_WIDTH = 120, 10, 32, 320
    DET_STEPS, DET_BATCH, DET_SIZE = 20, 8, 512
    # the synthetic-data phase: rec and det steps, the warm steps its
    # timings leave out, and the steps traced after them
    REC_SYNTH_STEPS, DET_SYNTH_STEPS, SYNTH_WARM, SYNTH_TRACED = 20, 8, 3, 6

    def __init__(self):
        self.failures = []
        self.kernels = {}
        self.floor_ms = None
        self.dev = torch.device("cuda")
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device=self.dev)
        from ppocr_tpu_torch import assets

        self.assets = assets
        self.scenes = assets.load_scenes()
        self.goldens = assets.load_goldens()
        self.tmp = tempfile.TemporaryDirectory()
        self.model_dir = str(assets.make_jumbo_model_dir(self.tmp.name + "/jumbo"))
        self.cls_model_dir = str(
            assets.make_jumbo_model_dir(self.tmp.name + "/jumbo_cls", cls_seed=assets.CLS_SEED)
        )
        self.launches = {}  # main path → launch counts of that run
        self.served = {}  # scene key → words phase 4 served in process
        self.serving_worker = None  # phase 4's worker, flag off
        self.serving_words = None  # phase 4's words: 8 singles, then the batch of 4
        self.serving_engines = {}  # phase 4's engines by fused_blob_kernel

    def phase(self, name, fn):
        t0 = time.perf_counter()
        try:
            fn()
            print(f"[phase] {name}: ok ({time.perf_counter() - t0:.1f} s)", flush=True)
        except Exception:
            traceback.print_exc()
            self.failures.append(name)
            print(f"[phase] {name}: FAILED", flush=True)

    # -- 1 ---------------------------------------------------------------
    def build(self):
        from ppocr_tpu_torch.ops import kernels as K

        t0 = time.perf_counter()
        K.load_library()
        print(f"kernel build: {time.perf_counter() - t0:.2f} s")
        for line in K.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip())
        from ppocr_tpu_torch.ops import native

        t0 = time.perf_counter()
        native.load_library()
        lib = native.build()
        if lib.parent != K.BUILD_DIR or not lib.exists():
            raise AssertionError(f"the host library is not under the build dir: {lib}")
        print(f"host postprocess library build: {time.perf_counter() - t0:.2f} s ({lib.name})")
        t0 = time.perf_counter()
        native.load_warp_library()
        print(f"host warp library build: {time.perf_counter() - t0:.2f} s "
              f"({native.build(native.WARP_SOURCE).name})")

    # -- 2 ---------------------------------------------------------------
    def floor(self):
        from ppocr_tpu_torch.ops import kernels as K

        lib = K.load_library()
        noop = lambda: K._launch_noop(lib)  # noqa: E731
        cuda_ms(noop, self.flush)  # untimed: the card's clocks come up from idle
        self.floor_ms = cuda_ms(noop, self.flush)
        print(json.dumps({
            "floor_ms": self.floor_ms, "what": "an empty kernel of one thread, L2 flushed "
            "before it, timed as every kernel here",
            "floor_warm_ms": cuda_ms(noop, None),  # no flush before it
            "floor_pair_ms": cuda_ms(lambda: (noop(), noop()), self.flush),  # two in a row
            "card": card_line()}), flush=True)

    def unaligned(self, cpu: torch.Tensor) -> torch.Tensor:
        """``cpu`` on the card as a contiguous view whose first element is
        4 bytes past a 16-byte boundary."""
        store = torch.empty(cpu.numel() + 1, dtype=cpu.dtype, device=self.dev)
        view = store[1:].view(cpu.shape)
        view.copy_(cpu)
        if view.data_ptr() % 16 != 4 or not view.is_contiguous():
            raise AssertionError("the offset view is not what the case wants")
        return view

    def check_ctc_topk(self):
        from ppocr_tpu_torch.ops import kernels as K

        def compare(p, where):
            idx, val = K.ctc_topk(p)
            torch.cuda.synchronize()
            pidx, pval = K.ctc_topk_plain(p)
            if not torch.equal(idx, pidx):
                raise AssertionError(f"ctc_topk idx differs at {where}")
            err = max_err(val, pval)
            if err != 0.0 or not torch.equal(torch.isnan(val), torch.isnan(pval)):
                raise AssertionError(f"ctc_topk val differs at {where}: {err}")
            return idx, err

        g = torch.Generator(device="cpu").manual_seed(0)
        probs, worst = {}, 0.0
        # (16, 32, 5008): a 768×1024 serving request's rec tier; (32, 64,
        # 5008): the full tier (K = 32 slots, T = 64); 6625: the reference
        # dict; 6625, 5007 and 333 rows are not 16-byte aligned; 31 and 4
        # are less than one vector per thread; then single rows
        for shape in ((16, 32, 5008), (32, 64, 5008), (32, 48, 6625), (3, 7, 333),
                      (8, 16, 5007), (3, 7, 31), (3, 7, 4), (1, 1, 5008), (1, 1, 6625),
                      *STAGED_TIERS, SHARDED_TIER):
            p = torch.rand(shape, generator=g)
            v = shape[2]
            p[0, 0, :] = 0.25  # whole-row tie
            nan_n = min(1, shape[0] - 1)  # the NaN row's batch index
            if shape[1] > 2:
                p[0, 1, min(3, v - 2)] = p[0, 1, v - 2] = 2.0  # two-way tie
                p[nan_n, 2, v // 2] = float("nan")  # NaN row
            p = p.to(self.dev)
            idx, err = compare(p, shape)
            if int(idx[0, 0]) != 0 or (shape[1] > 2 and (
                    int(idx[nan_n, 2]) != v - 1 or int(idx[0, 1]) != min(3, v - 2))):
                raise AssertionError(f"ctc_topk tie/NaN rule broken at {shape}")
            print(f"ctc_topk {shape}: exact")
            probs[shape] = p
            worst = max(worst, err)
        self.ctc_shapes_checked = set(probs)
        # a base pointer that is only 4-byte aligned, odd V: every row has
        # another head and tail; served in place, without a copy
        for shape in ((8, 7, 6625), (2, 3, 31)):
            p = self.unaligned(torch.rand(shape, generator=g))
            if p.float().contiguous().data_ptr() != p.data_ptr():
                raise AssertionError("the wrapper would copy the offset view")
            compare(p, f"{shape} at base % 16 == 4")
            print(f"ctc_topk {shape} at base % 16 == 4: exact")
        # ties and NaN by position, each on four consecutive rows of odd V
        # so that every head length 0..3 meets it. With 128 threads a row
        # and float4 loads, vector i belongs to thread i % 128.
        v = 6625
        spots = {
            "tie, neighbouring threads": (8, 12), "tie, other warp": (8, 8 + 4 * 40),
            "tie, same thread's next load": (8, 8 + 4 * 256), "tie, head and body": (0, 3000),
            "tie, body and tail": (3000, v - 1), "tie, head and tail": (0, v - 1),
            "tie, last two": (v - 2, v - 1), "NaN, head": (0,), "NaN, tail": (v - 1,),
            "NaN, body": (3001,), "all -inf": None,
        }
        edge_rows = torch.rand((4 * len(spots), 1, v), generator=g)
        want = []
        for i, cols in enumerate(spots.values()):
            for r in range(4 * i, 4 * i + 4):
                if cols is None:
                    edge_rows[r] = float("-inf")
                    want.append(0)
                elif len(cols) == 1:
                    edge_rows[r, 0, cols[0]] = float("nan")
                    want.append(v - 1)
                else:
                    edge_rows[r, 0, list(cols)] = 2.0
                    want.append(min(cols))
        idx, _ = compare(self.unaligned(edge_rows), "the tie and NaN rows")
        if idx.flatten().tolist() != want:
            raise AssertionError(f"ctc_topk tie/NaN rows: {idx.flatten().tolist()} vs {want}")
        print(f"ctc_topk ties and NaN by position ({len(spots)} patterns × 4 alignments): exact")

        lib = K.load_library()
        tiers = []
        # the staged tiers first; the last one (a fused request's tier, also
        # the staged serving profile's full batch at width 256) is reported
        # in the kernels line
        for shape in (*STAGED_TIERS, SHARDED_TIER, (32, 48, 6625), (32, 64, 5008), (16, 32, 5008)):
            p = probs[shape]
            rows, v = shape[0] * shape[1], shape[2]
            idx = torch.empty(shape[:2], dtype=torch.int32, device=self.dev)
            val = torch.empty(shape[:2], dtype=torch.float32, device=self.dev)
            ms = cuda_ms(lambda: K._launch_ctc_topk(lib, p, idx, val), self.flush)
            warm_ms = cuda_ms(lambda: K._launch_ctc_topk(lib, p, idx, val), None)
            wrapper_ms = cuda_ms(lambda: K.ctc_topk(p), self.flush)
            plain_ms = cuda_ms(lambda: K.ctc_topk_plain(p), self.flush)
            lib_ms = cuda_ms(lambda: torch.max(p, dim=-1), self.flush)
            b_ms, b_by = bound_ms(rows * v * 4 + rows * 8, rows * v)
            self.kernels["ctc_topk"] = dict(
                name="ctc_topk", route="cuda", source="ppocr_tpu_torch/csrc/ctc_topk.cu",
                replaces="ppocr_tpu/ops/pallas_kernels.py:47", shape=list(shape),
                max_abs_err=worst, ms=ms, warm_ms=warm_ms, wrapper_ms=wrapper_ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                floor_ms=self.floor_ms,
            )
            print(json.dumps({"timing": self.kernels["ctc_topk"]}), flush=True)
            tiers.append({k: self.kernels["ctc_topk"][k] for k in (
                "shape", "ms", "warm_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
        self.kernels["ctc_topk"]["tiers"] = tiers

    def serving_labels(self):
        """CC label maps and top-32 roots of the committed serving scenes at
        det size, from the f32 det forward."""
        from ppocr_tpu_torch.models import det_forward
        from ppocr_tpu_torch.ops.normalize import IMAGENET_MEAN, IMAGENET_SCALE
        from ppocr_tpu_torch.ops.resize import det_resize
        from ppocr_tpu_torch.pipeline import OCREngine, PipelineConfig
        from ppocr_tpu_torch.pipeline import fused as TF
        from ppocr_tpu_torch.pipeline.config import pick_bucket

        cfg = PipelineConfig.from_dict(self.goldens["configs"]["serving"])
        eng = OCREngine(self.model_dir, cfg, dtype=torch.float32)
        batch = []
        for s in self.scenes["serving"]:
            r, _, _ = det_resize(s, cfg.det.limit_type, cfg.det.limit_side_len)
            bh = pick_bucket(cfg.det.shape_buckets, r.shape[0])
            bw = pick_bucket(cfg.det.shape_buckets, r.shape[1])
            c = torch.zeros((bh, bw, 3), dtype=torch.uint8)
            c[: r.shape[0], : r.shape[1]] = torch.from_numpy(r)
            batch.append(c)
        x = torch.stack(batch).to(eng.device).float()
        mean = torch.tensor(IMAGENET_MEAN, device=eng.device)
        scale = torch.tensor(IMAGENET_SCALE, device=eng.device)
        with torch.inference_mode():
            prob = det_forward(eng.det_model, (x / 255.0 - mean) * scale)
            fg = (prob * 255.0).to(torch.uint8) > int(cfg.det.thresh * 255)
            labels = TF._connected_components(fg)
            _, roots = TF._select_roots(labels, cfg.fused_max_boxes)
        return labels, prob, roots

    def blob_case(self, b, h, w, k, kind, seed):
        """Label maps in the connected components' form (a blob's label is
        its first pixel's flat index, background H·W) with their roots:
        ``blobs`` rectangles, ``background`` none, ``one_blob`` the whole
        map. Slot 0's root is repeated in the last slot and the slot
        before it is -1 where K allows."""
        g = torch.Generator(device="cpu").manual_seed(seed)
        labels = torch.full((b, h, w), h * w, dtype=torch.int32)
        roots = torch.full((b, k), -1, dtype=torch.int32)
        if kind == "one_blob":
            labels[:] = 0
            roots[:] = 0
        elif kind == "blobs":
            for i in range(b):
                for j in range(min(k, 24)):
                    y0 = int(torch.randint(0, h - 8, (1,), generator=g))
                    x0 = int(torch.randint(0, w - 40, (1,), generator=g))
                    bh = int(torch.randint(1, 8, (1,), generator=g))
                    bw = int(torch.randint(1, 40, (1,), generator=g))
                    labels[i, y0 : y0 + bh, x0 : x0 + bw] = y0 * w + x0
                    roots[i, j] = y0 * w + x0
            if k > 2:
                roots[:, -1] = roots[:, 0]
            if k > 3:
                roots[:, -2] = -1
        prob = torch.rand((b, h, w), generator=g)
        return labels, prob, roots

    def check_blob_stats(self):
        from ppocr_tpu_torch.ops import kernels as K

        labels, prob, roots = self.serving_labels()
        roots = roots.clone()
        roots[:, -1] = -1  # an empty slot
        roots[:, -2] = roots[:, 0]  # a duplicate root
        g = torch.Generator(device="cpu").manual_seed(1)
        rnd_labels = torch.randint(0, 300, (4, 512, 512), generator=g, dtype=torch.int32)
        rnd_roots = torch.randint(-1, 320, (4, 32), generator=g, dtype=torch.int32)
        rnd_roots[:, 5] = rnd_roots[:, 6]
        rnd_prob = torch.rand((4, 512, 512), generator=g)
        on_card = lambda case: tuple(t.to(self.dev) for t in case)  # noqa: E731
        cases = [
            ("scene CC maps", labels, prob, roots),
            ("random maps", *on_card((rnd_labels, rnd_prob, rnd_roots))),
            # a warp's 32 pixels straddle image rows; 16-byte loads
            ("W = 500", *on_card(self.blob_case(1, 36, 500, 32, "blobs", 2))),
            # H·W % 4 != 0: the scalar loads, and images 2.. of the batch
            # start off a 16-byte boundary
            ("H·W % 4 != 0, B = 4", *on_card(self.blob_case(4, 37, 501, 32, "blobs", 3))),
            ("K = 1", *on_card(self.blob_case(1, 128, 128, 1, "blobs", 4))),
            ("K = 40, B = 4", *on_card(self.blob_case(4, 512, 512, 40, "blobs", 5))),
            ("all background", *on_card(self.blob_case(2, 384, 512, 32, "background", 6))),
            ("one blob over the whole map", *on_card(self.blob_case(1, 384, 512, 32, "one_blob", 7))),
        ]
        lab_cpu, pr_cpu, rt_cpu = self.blob_case(1, 64, 64, 8, "blobs", 8)
        rt_cpu[:, 1] = 64 * 64  # this slot counts the background pixels
        cases.append(("background label among the roots", *on_card((lab_cpu, pr_cpu, rt_cpu))))
        lab_cpu, pr_cpu, rt_cpu = self.blob_case(2, 64, 128, 32, "blobs", 9)
        cases.append(("base pointers % 16 == 4", self.unaligned(lab_cpu),
                      self.unaligned(pr_cpu), rt_cpu.to(self.dev)))
        worst = 0.0
        for name, lab, pr, rt in cases:
            want = K.blob_stats_plain(lab, pr, rt)
            # twice in a row: the second call finds the scratch as clean
            # as the first did
            for call in ("first", "second"):
                got = K.blob_stats(lab, pr, rt)
                torch.cuda.synchronize()
                for i, (a, b) in enumerate(zip(got, want)):
                    if i == 1:
                        torch.testing.assert_close(a, b, rtol=PSUM_RTOL, atol=1e-6)
                    elif not torch.equal(a, b):
                        raise AssertionError(f"blob_stats output {i} differs on {name}, {call} call")
                    worst = max(worst, max_err(a, b))
            print(f"blob_stats {name} {tuple(lab.shape)} K={rt.shape[1]}: twice, "
                  f"exact except psum (max abs err {max_err(got[1], want[1]):.3g})")
        lib = K.load_library()
        timed = {
            "one blob": next(c[1:] for c in cases if c[0].startswith("one blob")),
            "scene": (labels[:1].contiguous(), prob[:1].contiguous(), roots[:1].contiguous()),
        }
        for what, (lab, pr, rt) in timed.items():  # the last one is reported
            b_, h, w = lab.shape
            k = rt.shape[1]
            scratch = torch.zeros(1 + K.BLOB_ACC_WORDS * b_ * k, dtype=torch.int32, device=self.dev)
            out = torch.empty((6, b_, k), dtype=torch.float32, device=self.dev)
            ms = cuda_ms(lambda: K._launch_blob_stats(lib, lab, pr, rt, scratch, out), self.flush)
            warm_ms = cuda_ms(lambda: K._launch_blob_stats(lib, lab, pr, rt, scratch, out), None)
            wrapper_ms = cuda_ms(lambda: K.blob_stats(lab, pr, rt), self.flush)
            plain_ms = cuda_ms(lambda: K.blob_stats_plain(lab, pr, rt), self.flush)
            b_ms, b_by = bound_ms(b_ * h * w * 8 + b_ * k * 4 + b_ * k * 6 * 4, b_ * h * w * k)
            self.kernels["blob_stats"] = dict(
                name="blob_stats", route="cuda", source="ppocr_tpu_torch/csrc/blob_stats.cu",
                replaces="ppocr_tpu/ops/pallas_kernels.py:142", shape=[b_, h, w, k], map=what,
                max_abs_err=worst, ms=ms, warm_ms=warm_ms, wrapper_ms=wrapper_ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                floor_ms=self.floor_ms,
            )
            print(json.dumps({"timing": self.kernels["blob_stats"]}), flush=True)

    # -- 3 ---------------------------------------------------------------
    def parity(self):
        from ppocr_tpu_torch.pipeline import OCREngine, OCRWorker, PipelineConfig

        with f32_exact():
            for name, scenes in (("small", "parity"), ("serving", "serving")):
                cfg = PipelineConfig.from_dict(self.goldens["configs"][name])
                worker = OCRWorker(OCREngine(self.model_dir, cfg), 0)
                n_words = 0
                for i, (scene, want) in enumerate(
                    zip(self.scenes[scenes], self.goldens["words"][name])
                ):
                    resp = worker.process(scene, i)
                    if not resp["success"]:
                        raise AssertionError(f"{name} scene {i}: {resp.get('error')}")
                    check_words(resp["words"], want, f"{name} scene {i}")
                    n_words += len(want)
                print(f"parity f32 (TF32 off) {name}: {n_words} words match the JAX goldens "
                      f"(texts exact, boxes <= {BOX_TOL} px, conf <= {CONF_TOL})")

    # -- 4 ---------------------------------------------------------------
    def serving(self):
        from ppocr_tpu_torch.ops import kernels as K
        from ppocr_tpu_torch.pipeline import OCREngine, OCRWorker, PipelineConfig

        singles = [*self.scenes["serving"], *self.scenes["parity"]]
        singles = (singles * 2)[:8]
        batch = list(self.scenes["parity"])
        engines = {}
        for blob_kernel in (False, True):
            cfg = PipelineConfig.from_dict(self.goldens["configs"]["serving"])
            cfg.dtype = "bfloat16"
            cfg.request_batch_buckets = (1, 4)
            cfg.fused_blob_kernel = blob_kernel
            eng = OCREngine(self.model_dir, cfg)
            engines[blob_kernel] = (eng, eng.warmup())
        torch.cuda.synchronize()
        K.reset_launch_counts()  # the main path's run starts here
        runs = {}
        for blob_kernel, (eng, warm) in engines.items():
            worker = OCRWorker(eng, 0)
            resp = [worker.process(s, i) for i, s in enumerate(singles)]
            resp += eng.fused_ocr().process_batch(batch, list(range(100, 104)))
            bad = [r for r in resp if not r["success"]]
            if bad:
                raise AssertionError(f"failed requests: {bad[:2]}")
            ms = sorted(r["processing_time_ms"] for r in resp[:8])
            runs[blob_kernel] = [r["words"] for r in resp]
            if not blob_kernel:
                self.serving_worker = worker
            print(json.dumps({
                "serving": "serving-jumbo bf16", "fused_blob_kernel": blob_kernel,
                "warmup_s": round(warm, 3), "requests": len(singles),
                "p50_ms": statistics.median(ms), "p90_ms": ms[int(0.9 * (len(ms) - 1))],
                "batch4_ms": resp[8]["processing_time_ms"], "card": card_line(),
            }), flush=True)
        counts = K.launch_counts()
        self.launches["bf16 serving"] = counts
        self.serving_engines = {flag: eng for flag, (eng, _) in engines.items()}
        self.serving_words = runs[False]
        print(f"launches on the main path: {counts}")
        if min(counts.values()) <= 0:
            raise AssertionError(f"a kernel of the path never launched: {counts}")
        if runs[True] != runs[False]:
            raise AssertionError("fused_blob_kernel=True changed the served words")
        # what the service phase must serve for the same scenes
        for i in range(len(self.scenes["serving"])):
            self.served[f"serving{i}"] = runs[False][i]
        for i in range(len(self.scenes["parity"])):
            self.served[f"parity{i}"] = runs[False][len(self.scenes["serving"]) + i]
        n_words = sum(len(w) for w in runs[False])
        golden = [w["text"] for ws in self.goldens["words"]["serving"] for w in ws]
        served = [w["text"] for ws in runs[False][:2] for w in ws]
        agree = len(set(golden) & set(served)) / max(len(golden), 1)
        print(f"bf16 served {n_words} words; serving scenes: {agree:.3f} of the f32 "
              f"golden texts read identically")
        if n_words == 0 or agree < 0.5:
            raise AssertionError("bf16 serving output disagrees with the f32 goldens")

    # -- 5 ---------------------------------------------------------------
    def devices(self):
        from ppocr_tpu_torch.models import rec_forward
        from ppocr_tpu_torch.ops import kernels as K
        from ppocr_tpu_torch.parallel import make_mesh, sharded_rec_infer
        from ppocr_tpu_torch.pipeline import OCREngine, OCRWorker, PipelineConfig

        if self.serving_words is None:
            raise AssertionError("needs the bf16 serving phase's words")
        singles = ((list(self.scenes["serving"]) + list(self.scenes["parity"])) * 2)[:8]
        batch = list(self.scenes["parity"])
        cfg = PipelineConfig.from_dict(self.goldens["configs"]["serving"])
        cfg.dtype = "bfloat16"
        cfg.request_batch_buckets = (1, 4)
        cfg.fused_blob_kernel = True
        mesh = make_mesh(devices=["cuda:0", "cuda:0"])  # two data shards on card 0
        eng = OCREngine(self.model_dir, cfg, mesh=mesh)
        dp = OCRWorker(eng, 0)
        cc = eng.cross_chip_ocr()  # the mesh's first two devices: card 0 twice
        warm = {"data_parallel_s": eng.warmup(), "cross_chip_s": cc.warmup()}
        fused = eng.fused_ocr()
        torch.cuda.synchronize()
        K.reset_launch_counts()  # the devices main path's run starts here
        steps0 = fused.steps_run
        resp = [dp.process(s, i) for i, s in enumerate(singles)]
        resp += fused.process_batch(batch, list(range(100, 104)))
        streamed = cc.process_stream(singles, list(range(200, 208)))
        torch.cuda.synchronize()
        counts = K.launch_counts()
        self.launches["devices"] = counts
        dp_steps = fused.steps_run - steps0
        want = {k: 2 * dp_steps + len(streamed) for k in counts}
        if dp_steps != len(singles) + 1 or counts != want:
            raise AssertionError(f"devices: {dp_steps} data-parallel steps and "
                                 f"{len(streamed)} cross-chip requests launched {counts}, "
                                 f"want {want}")
        for i, (r, w) in enumerate(zip(resp, self.serving_words)):
            if not r["success"]:
                raise AssertionError(f"data-parallel request {i}: {r.get('error')}")
            check_words(r["words"], w, f"data-parallel request {i} vs one device")
        for i, (r, w) in enumerate(zip(streamed, self.serving_words)):
            if not r["success"] or r["request_id"] != 200 + i:
                raise AssertionError(f"cross-chip request {i}: {str(r)[:200]}")
            check_words(r["words"], w, f"cross-chip request {i} vs one device")
        print(f"devices: {len(resp)} data-parallel and {len(streamed)} cross-chip requests give "
              f"phase 4's words; launches {counts} ({dp_steps} data-parallel steps)")

        # request p50 of the three paths, in turns (host wall of the call)
        paths = {"single": OCRWorker(self.serving_engines[True], 0), "data_parallel": dp,
                 "cross_chip": cc}
        walls = {name: [] for name in paths}
        for name in ("single", "data_parallel", "cross_chip", "cross_chip", "data_parallel",
                     "single"):
            for i, s in enumerate(singles):
                t0 = time.perf_counter()
                r = paths[name].process(s, i)
                walls[name].append((time.perf_counter() - t0) * 1e3)
                if not r["success"]:
                    raise AssertionError(f"{name}: {r.get('error')}")
        t0 = time.perf_counter()
        cc.process_stream(singles, list(range(8)))
        stream_ms = (time.perf_counter() - t0) * 1e3 / len(singles)
        print(json.dumps({
            "devices": "serving-jumbo bf16, fused_blob_kernel, 768x1024 and 192x192 requests, "
            "16 per path in turns; data_parallel = make_mesh(devices=['cuda:0', 'cuda:0']), "
            "two shards on ONE card; cross_chip = both stages on the same card; two cards "
            "were not measured",
            "request_p50_ms": {k: statistics.median(v) for k, v in walls.items()},
            "cross_chip_stream_ms_per_request": stream_ms, "warmup_s": warm,
            "launches": counts, "card": card_line()}), flush=True)

        # f32, TF32 off: both paths against the JAX goldens, and the
        # data-parallel rec step against one rec step
        with f32_exact():
            fcfg = PipelineConfig.from_dict(self.goldens["configs"]["serving"])
            feng = OCREngine(self.model_dir, fcfg, mesh=mesh)
            fworker = OCRWorker(feng, 0)
            scenes, golden = self.scenes["serving"], self.goldens["words"]["serving"]
            for i, (scene, w) in enumerate(zip(scenes, golden)):
                check_words(fworker.process(scene, i)["words"], w, f"data-parallel f32 scene {i}")
            for i, r in enumerate(feng.cross_chip_ocr().process_stream(list(scenes), [0, 1])):
                check_words(r["words"], golden[i], f"cross-chip f32 scene {i}")
            g = torch.Generator(device="cpu").manual_seed(3)
            x = torch.randn((32, 48, 256, 3), generator=g).to(self.dev)
            idx, val = sharded_rec_infer(mesh)(feng.rec_model, x)
            with torch.inference_mode():
                one_idx, one_val = K.ctc_topk(rec_forward(feng.rec_model, x))
            torch.cuda.synchronize()
            if not torch.equal(idx, one_idx) or max_err(val, one_val) != 0.0:
                raise AssertionError(
                    f"sharded_rec_infer over 2 shards vs one step: index mismatches "
                    f"{int((idx != one_idx).sum())}, value max err {max_err(val, one_val)}")
        print(f"devices f32 (TF32 off): data-parallel and cross-chip words match the JAX "
              f"serving goldens; sharded_rec_infer over 2 shards equals one rec step at "
              f"{list(x.shape[:3])} exactly")

    # -- 6 ---------------------------------------------------------------
    def serving_config(self):
        from ppocr_tpu_torch.pipeline import PipelineConfig

        cfg = PipelineConfig.from_dict(self.goldens["configs"]["serving"])
        cfg.dtype = "bfloat16"
        return cfg

    def options(self):
        from ppocr_tpu_torch.ops import kernels as K
        from ppocr_tpu_torch.pipeline import OCREngine, OCRWorker, PipelineConfig

        totals = {"ctc_topk": 0, "blob_stats": 0}
        with f32_exact():
            for opt in self.assets.OPTIONS:
                name = f"small+{opt}"
                cfg = PipelineConfig.from_dict(self.goldens["configs"][name])
                md = self.cls_model_dir if cfg.enable_cls else self.model_dir
                worker = OCRWorker(OCREngine(md, cfg), 0)
                torch.cuda.synchronize()
                K.reset_launch_counts()  # this config's run starts here
                n_words = 0
                for i, (scene, want) in enumerate(
                    zip(self.scenes["parity"], self.goldens["words"][name])
                ):
                    resp = worker.process(scene, i)
                    if not resp["success"]:
                        raise AssertionError(f"{name} scene {i}: {resp.get('error')}")
                    check_words(resp["words"], want, f"{name} scene {i}")
                    n_words += len(want)
                counts = K.launch_counts()
                for k, n in counts.items():
                    totals[k] += n
                greedy = opt != "beam"
                if (counts["ctc_topk"] > 0) != greedy:
                    raise AssertionError(f"{name}: ctc_topk launched {counts['ctc_topk']} times")
                print(f"options f32 (TF32 off) {name}: {n_words} words match the JAX goldens; "
                      f"launches {counts}")
        self.launches["fused options"] = totals
        # each option's cost at full width beside the base config: every
        # engine is built and warmed first, then the configs take turns,
        # three rounds of 8 requests each (host times: ±20 % between runs)
        scenes = list(self.scenes["serving"])
        workers = {}
        for opt in (None, *self.assets.OPTIONS):
            cfg = self.serving_config()
            if opt is not None:
                self.assets.apply_option(cfg, opt)
            md = self.cls_model_dir if cfg.enable_cls else self.model_dir
            workers[opt or "base"] = OCRWorker(OCREngine(md, cfg), 0)
            for s in scenes * 2:  # untimed: the shapes' first calls
                workers[opt or "base"].process(s, 0)
        # wall: around the whole call, host decode included (the beam
        # search runs there); processing: the response's own stamp, which
        # ends when the step's outputs reach the host, as in the JAX package
        p50 = {name: {"wall": [], "processing": []} for name in workers}
        for _ in range(3):
            for name, worker in workers.items():
                walls, resp = [], []
                for i in range(8):
                    t0 = time.perf_counter()
                    resp.append(worker.process(scenes[i % 2], i))
                    walls.append((time.perf_counter() - t0) * 1e3)
                if not all(r["success"] and r["words"] for r in resp):
                    raise AssertionError(f"serving + {name}: a request failed or read nothing")
                p50[name]["wall"].append(statistics.median(walls))
                p50[name]["processing"].append(
                    statistics.median(r["processing_time_ms"] for r in resp))
        print(json.dumps({
            "option_cost": "serving-jumbo bf16, 768x1024 requests; p50 of 8 requests, three "
            "rounds in turns after 4 warm requests", "p50_ms": p50, "card": card_line()}), flush=True)

    # -- 7 ---------------------------------------------------------------
    def start_service(self, sock, extra, ready="listening", own_group=False):
        """The service as a user starts it; returns (process, its output
        lines so far) once it prints its ``ready`` line. A flag whose value
        is None is passed bare."""
        cfg_path = os.path.join(self.tmp.name, "service.json")
        with open(cfg_path, "w") as f:
            json.dump({"rec": {"img_h": 48, "img_w": 256}, **extra.pop("config", {})}, f)
        argv = [sys.executable, "-m", "ppocr_tpu_torch.cli.service_main",
                "--model-dir", self.model_dir, "--socket", sock, "--config", cfg_path,
                "--status-interval", "600"]
        for k, v in extra.items():
            argv += [k] if v is None else [k, str(v)]
        proc = subprocess.Popen(argv, cwd=REPO, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True,
                                process_group=0 if own_group else None)
        lines, listening = [], threading.Event()

        def pump():
            for line in proc.stdout:
                lines.append(line.rstrip())
                if ready in line:
                    listening.set()
            listening.set()  # the process ended

        threading.Thread(target=pump, daemon=True).start()
        if not listening.wait(timeout=300) or proc.poll() is not None:
            if own_group:  # a supervisor: its workers go with its group
                os.killpg(proc.pid, signal.SIGKILL)
            else:
                proc.kill()
            raise AssertionError("the service did not come up:\n" + "\n".join(lines[-30:]))
        return proc, lines

    def concurrent(self, client_cls, sock, payloads):
        """One ``recognize`` per payload, each from a thread of its own."""
        out = {}

        def one(i, req):
            with client_cls(sock, timeout_ms=120000) as c:
                out[i] = c.send_request(req)

        threads = [threading.Thread(target=one, args=(i, r)) for i, r in enumerate(payloads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
        if len(out) != len(payloads):
            raise AssertionError(f"{len(payloads) - len(out)} concurrent requests got no answer")
        return [out[i] for i in range(len(payloads))]

    def check_coalesced(self, resp, key):
        """A request that may have been served in a batch of another size
        than phase 4's: bf16 may round differently there."""
        want = self.served[key]
        if not resp.get("success") or len(resp["words"]) != len(want):
            raise AssertionError(f"concurrent {key}: {str(resp)[:300]}")
        same = 0
        for g, w in zip(resp["words"], want):
            d = max(abs(a - b) for p, q in zip(g["box"], w["box"]) for a, b in zip(p, q))
            if d > BOX_TOL:
                raise AssertionError(f"concurrent {key}: box {g['box']} vs {w['box']}")
            same += g["text"] == w["text"]
        return same, len(want)

    def service(self):
        from ppocr_tpu_torch.serve import OCRIPCClient
        from ppocr_tpu_torch.utils.imcodec import encode_png

        keys = [f"serving{i}" for i in range(len(self.scenes["serving"]))]
        keys += [f"parity{i}" for i in range(len(self.scenes["parity"]))]
        images = [*self.scenes["serving"], *self.scenes["parity"]]
        pngs = {k: encode_png(img) for k, img in zip(keys, images)}
        paths = {}
        for k, data in pngs.items():
            paths[k] = os.path.join(self.tmp.name, f"{k}.png")
            pathlib.Path(paths[k]).write_bytes(data)
        by_data = {k: {"command": "recognize",
                       "image_data": base64.b64encode(d).decode()} for k, d in pngs.items()}
        eight = (keys * 2)[:8]

        def status(c):
            st = json.loads(c.get_service_status()["status"])
            if st["total_requests"] != st["successful_requests"] + st["failed_requests"]:
                raise AssertionError(f"status counters do not add up: {st}")
            return st

        def shutdown(c, proc, lines):
            if c.send_shutdown_command().get("success") is not True:
                raise AssertionError("shutdown was not acknowledged")
            c.disconnect()
            rc = proc.wait(timeout=20)
            if rc != 0:
                raise AssertionError(f"the service exited with {rc}:\n" + "\n".join(lines[-20:]))

        # -- the batching service
        sock = os.path.join(self.tmp.name, "svc.sock")
        t0 = time.perf_counter()
        proc, lines = self.start_service(sock, {"--batch-requests": 4, "--warmup": "full"})
        try:
            boot_s = time.perf_counter() - t0
            warm = [ln for ln in lines if ln.startswith("Warmup")]
            c = OCRIPCClient(sock, timeout_ms=120000)
            if not c.connect():
                raise AssertionError("cannot connect to the service")
            before = status(c)
            r = c.send_request({"command": "recognize", "image_path": paths["serving0"]})
            check_words(r.get("words"), self.served["serving0"], "service image_path")
            r = c.send_request(by_data["serving1"])
            check_words(r.get("words"), self.served["serving1"], "service image_data")
            if (r["width"], r["height"]) != (1024, 768) or r["request_id"] != 1:
                raise AssertionError(f"service response header: {str(r)[:200]}")
            answers = self.concurrent(OCRIPCClient, sock, [by_data[k] for k in eight])
            agree = [self.check_coalesced(r, k) for r, k in zip(answers, eight)]
            c._sock.sendall(b"this is not json\n")
            bad = json.loads(c._file.readline())
            if bad.get("success") is not False or not bad["error"].startswith("Invalid JSON"):
                raise AssertionError(f"malformed JSON answered with {bad}")
            jpeg = base64.b64encode(b"\xff\xd8\xff\xe0\x00\x10JFIF\x00" + bytes(64)).decode()
            bad = c.send_request({"command": "recognize", "image_data": jpeg})
            if bad != {"success": False, "error": "Failed to decode base64 image data"}:
                raise AssertionError(f"a corrupt JPEG payload answered with {bad}")
            # phase 4's sequence of single requests through the service and
            # in process, in turns: service, in process, in process, service
            by_key = dict(zip(keys, images))
            walls, inner, direct, direct_walls = [], [], [], []

            def through_service():
                for k in eight:
                    t1 = time.perf_counter()
                    r = c.send_request(by_data[k])
                    walls.append((time.perf_counter() - t1) * 1e3)
                    inner.append(r["processing_time_ms"])
                    check_words(r.get("words"), self.served[k], "service sequential")

            def in_process():
                for i, k in enumerate(eight):
                    t1 = time.perf_counter()
                    r = self.serving_worker.process(by_key[k], i)
                    direct_walls.append((time.perf_counter() - t1) * 1e3)
                    direct.append(r["processing_time_ms"])

            for turn in (through_service, in_process, in_process, through_service):
                turn()
            after = status(c)
            n_req = after["total_requests"] - before["total_requests"]
            stats = after["workers"][0]
            delta = {k: after["kernel_launches"][k] - before["kernel_launches"][k]
                     for k in after["kernel_launches"]}
            self.launches["service"] = delta
            if n_req != 2 + 8 + 16 or after["failed_requests"] != 0:
                raise AssertionError(f"service counters: {after}")
            if stats["batched_steps"] < 1:
                raise AssertionError(f"8 concurrent requests were never coalesced: {stats}")
            if delta["ctc_topk"] < 1:
                raise AssertionError(f"the service's requests never launched ctc_topk: {delta}")
            self.visualize_request(c, sock, paths["serving0"])
            shutdown(c, proc, lines)
            print(json.dumps({
                "service": "serving-jumbo bf16, --batch-requests 4 --warmup full",
                "boot_s": round(boot_s, 2), "warmup": warm[-1] if warm else None,
                "request_p50_ms": statistics.median(walls),
                "request_p90_ms": sorted(walls)[int(0.9 * (len(walls) - 1))],
                "processing_p50_ms": statistics.median(inner),
                "in_process_p50_ms": statistics.median(direct),
                "in_process_wall_p50_ms": statistics.median(direct_walls),
                "coalesced": {"steps": stats["steps"], "batched_steps": stats["batched_steps"]},
                "concurrent_texts_same": f"{sum(a for a, _ in agree)}/{sum(n for _, n in agree)}",
                "launches": delta, "card": card_line()}), flush=True)
            if sum(a for a, _ in agree) < 0.9 * sum(n for _, n in agree):
                raise AssertionError(f"coalesced requests read other texts: {agree}")
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)

        # -- two worker threads, no batching, the blob-stats kernel on
        sock = os.path.join(self.tmp.name, "svc2.sock")
        proc, lines = self.start_service(sock, {
            "--cpu-workers": 2, "--warmup": "incremental", "config": {"fused_blob_kernel": True}})
        try:
            c = OCRIPCClient(sock, timeout_ms=120000)
            if not c.connect():
                raise AssertionError("cannot connect to the second service")
            launched = status(c)["kernel_launches"]
            for round_ in range(2):  # the first round meets cold shapes during the warmup
                answers = self.concurrent(OCRIPCClient, sock, [by_data[k] for k in eight])
                for r, k in zip(answers, eight):
                    check_words(r.get("words"), self.served[k], f"two workers, round {round_}, {k}")
            st = status(c)
            workers = {w["worker_id"]: w["requests"] for w in st["workers"]}
            if st["total_requests"] != 16 or st["failed_requests"] or min(workers.values()) < 1:
                raise AssertionError(f"second service counters: {st}")
            delta = {k: n - launched[k] for k, n in st["kernel_launches"].items()}
            self.launches["service, two workers"] = delta
            if min(delta.values()) < 16:
                raise AssertionError(f"second service launches: {delta}")
            shutdown(c, proc, lines)
            print(f"service with --cpu-workers 2 --warmup incremental, fused_blob_kernel: 16 requests "
                  f"over workers {workers}, words as in process; launches {delta}; "
                  f"warmup_progress {st['warmup_progress']}")
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)

    def visualize_request(self, c, sock, path):
        """``ocr-client IMAGE --visualize OUT.png`` against the running
        service: exit 0, and OUT.png decodes to ``visualize_boxes`` of the
        decoded image and the response's words (the scene's pixels outside
        the drawn ones); then the golden words of the scene drawn as cv2
        draws them (``assets/visualize_mask.npz``); host ms of the drawing
        and of the PNG write."""
        import numpy as np

        from ppocr_tpu_torch.cli.client_main import main as client_main
        from ppocr_tpu_torch.utils.draw import polylines
        from ppocr_tpu_torch.utils.imcodec import encode_png, read_image
        from ppocr_tpu_torch.utils.visualize import visualize_boxes

        out = os.path.join(self.tmp.name, "visualized.png")
        before = service_launches(c)
        stdout, stderr = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(stdout), contextlib.redirect_stderr(stderr):
            rc = client_main([path, "--socket", sock, "--timeout", "120000", "--visualize", out])
        if rc != 0 or "visualization written to" not in stderr.getvalue():
            raise AssertionError(f"--visualize exited {rc}: {stderr.getvalue()[-500:]}")
        self.launches["visualize"] = launches_since(c, before, "--visualize")
        words = json.loads(stdout.getvalue())["words"]
        check_words(words, self.served["serving0"], "--visualize request")
        scene, written = read_image(path), read_image(out)
        if written is None or not np.array_equal(written, visualize_boxes(scene, words)):
            raise AssertionError("the --visualize PNG is not visualize_boxes of its words")
        quads = [np.asarray(w["box"], np.int32).reshape(-1, 1, 2) for w in words]
        drawn = polylines(np.zeros(scene.shape[:2], np.uint8), quads, 1, 2) > 0
        if not (np.array_equal(written[~drawn], scene[~drawn]) and (written[drawn] == (0, 255, 0)).all()):
            raise AssertionError("the --visualize PNG changed pixels outside the quads")
        golden = self.goldens["words"]["serving"][0]
        mask = self.assets.load_visualize_mask()
        want = self.scenes["serving"][0].copy()
        want[mask] = (0, 255, 0)
        if not np.array_equal(visualize_boxes(self.scenes["serving"][0], golden), want):
            raise AssertionError("the golden words are not drawn as cv2 draws them")
        draw_ms, write_ms = [], []
        for _ in range(7):
            t0 = time.perf_counter()
            canvas = visualize_boxes(scene, words)
            t1 = time.perf_counter()
            pathlib.Path(out).write_bytes(encode_png(canvas))
            t2 = time.perf_counter()
            draw_ms.append((t1 - t0) * 1e3)
            write_ms.append((t2 - t1) * 1e3)
        print(json.dumps({
            "visualize": "ocr-client scene0.png --visualize out.png, serving-jumbo bf16",
            "words": len(words), "drawn_px": int(drawn.sum()), "golden_words": len(golden),
            "golden_px_as_cv2": int(mask.sum()), "visualize_boxes_ms_p50": statistics.median(draw_ms),
            "png_write_ms_p50": statistics.median(write_ms), "png_bytes": os.path.getsize(out),
            "launches": self.launches["visualize"], "card": card_line()}), flush=True)

    # -- 8 ---------------------------------------------------------------
    def staged_parity(self):
        from ppocr_tpu_torch.ops import kernels as K
        from ppocr_tpu_torch.pipeline import OCREngine, OCRWorker, PipelineConfig

        totals = {}
        with f32_exact():
            for name in ("small-staged", "small-staged+cls", "serving-staged"):
                cfg = PipelineConfig.from_dict(self.goldens["configs"][name])
                if cfg.fast_path:
                    raise AssertionError(f"{name} is not a staged config")
                md = self.cls_model_dir if cfg.enable_cls else self.model_dir
                worker = OCRWorker(OCREngine(md, cfg), 0)
                scenes = self.scenes["serving" if name.startswith("serving") else "parity"]
                torch.cuda.synchronize()
                K.reset_launch_counts()  # this config's run starts here
                n_pairs = n_loose = 0
                for i, (scene, want) in enumerate(zip(scenes, self.goldens["words"][name])):
                    resp = worker.process(scene, i)
                    if not resp["success"]:
                        raise AssertionError(f"{name} scene {i}: {resp.get('error')}")
                    if ("cls_ms" in resp["stage_times"]) != cfg.enable_cls:
                        raise AssertionError(f"{name}: stage_times {list(resp['stage_times'])}")
                    pairs, loose = check_staged_words(resp["words"], want, f"{name} scene {i}")
                    n_pairs += pairs
                    n_loose += loose
                counts = K.launch_counts()
                totals = {k: totals.get(k, 0) + n for k, n in counts.items()}
                if counts["ctc_topk"] < len(scenes) or counts["blob_stats"] != 0:
                    raise AssertionError(f"{name}: launches {counts}")
                print(f"staged parity f32 (TF32 off) {name}: {n_pairs} words match the JAX "
                      f"staged goldens (texts exact, boxes <= {BOX_TOL} px), {n_loose} without a "
                      f"partner; launches {counts}")
        self.launches["staged parity"] = totals

    # -- 9 ---------------------------------------------------------------
    def staged_config(self, profile):
        """``profile`` ("serving" | "defaults") staged in bf16 with the
        jumbo bundle's rec geometry."""
        from ppocr_tpu_torch.pipeline import PipelineConfig

        cfg = getattr(PipelineConfig, profile)()
        cfg.fast_path = False
        cfg.rec.img_h, cfg.rec.img_w = 48, 256
        cfg.dtype = "bfloat16"
        return cfg

    def staged_serving(self):
        from ppocr_tpu_torch.ops import kernels as K
        from ppocr_tpu_torch.pipeline import OCREngine, OCRWorker

        scenes = list(self.scenes["serving"])
        golden = [w["text"] for ws in self.goldens["words"]["serving-staged"] for w in ws]
        workers, warm = {}, {}
        for profile in ("serving", "defaults"):
            eng = OCREngine(self.model_dir, self.staged_config(profile))
            warm[profile] = eng.warmup()
            workers[profile] = OCRWorker(eng, 0)
            for s in scenes:  # untimed: the request's own first pass
                workers[profile].process(s, 0)
        torch.cuda.synchronize()
        K.reset_launch_counts()  # the staged main path's run starts here
        for profile, worker in workers.items():
            eng = worker.engine
            shapes = {}
            rec_step = eng._rec_step

            def counted(batch, rec_step=rec_step, shapes=shapes,
                        v=eng.rec_model.fc.bias.shape[0]):
                idx, prob = rec_step(batch)
                if (*idx.shape, v) not in self.ctc_shapes_checked:
                    raise AssertionError(
                        f"rec step {tuple(batch.shape)}: ctc_topk was not held against its "
                        f"plain version at {[*idx.shape, v]}")
                key = f"{idx.shape[0]}x{idx.shape[1]}"
                shapes[key] = shapes.get(key, 0) + 1
                return idx, prob

            eng._rec_step = counted
            walls, resp = [], []
            for i in range(8):
                t0 = time.perf_counter()
                resp.append(worker.process(scenes[i % len(scenes)], i))
                walls.append((time.perf_counter() - t0) * 1e3)
            del eng._rec_step
            bad = [r for r in resp if not r["success"]]
            if bad:
                raise AssertionError(f"staged {profile}: failed requests: {bad[:2]}")
            stages = {
                stage: [statistics.median(r["stage_times"][stage][j] for r in resp) for j in range(3)]
                for stage in resp[0]["stage_times"]
            }
            served = [w["text"] for r in resp[: len(scenes)] for w in r["words"]]
            agree = len(set(golden) & set(served)) / max(len(golden), 1)
            if profile == "serving":
                self.staged_served = [r["words"] for r in resp[: len(scenes)]]
            print(json.dumps({
                "staged_serving": f"PipelineConfig.{profile}() staged, bf16, rec 48x256, "
                "768x1024 requests", "warmup_s": round(warm[profile], 3), "requests": len(resp),
                "p50_ms": statistics.median(walls),
                "p90_ms": sorted(walls)[int(0.9 * (len(walls) - 1))],
                "stage_ms_median [pre, infer, post]": stages,
                "words_per_request": statistics.median(len(r["words"]) for r in resp),
                "rec_steps [batch x T]: count": shapes,
                "golden_texts_read": round(agree, 3), "card": card_line()}), flush=True)
            # the serving profile is the goldens' own config; the defaults
            # profile (other thresholds, det at 960) is only required to read
            if not served or (profile == "serving" and agree < 0.5):
                raise AssertionError(f"staged {profile} bf16 disagrees with the f32 goldens")
        counts = K.launch_counts()
        self.launches["staged serving"] = counts
        print(f"launches on the staged main path: {counts}")
        if counts["ctc_topk"] <= 0:
            raise AssertionError(f"the staged path never launched ctc_topk: {counts}")

    # -- 11 --------------------------------------------------------------
    def jpeg_vs_cv2(self):
        from ppocr_tpu_torch.ops import native
        from ppocr_tpu_torch.utils.imcodec import decode_image

        t0 = time.perf_counter()
        lib = native.build(native.JPEG_SOURCE)
        print(f"jpeg decoder build: {time.perf_counter() - t0:.2f} s ({lib.name})")
        cases, texts = self.assets.load_jpeg_cases()
        refused = 0
        for name, (data, want) in cases.items():
            got = decode_image(data)
            if want is None:
                if got is not None:
                    raise AssertionError(f"case {name}: decoded where cv2 gives None")
                refused += 1
            elif got is None or got.shape != want.shape or not (got == want).all():
                raise AssertionError(f"case {name}: the decode differs from cv2's")
        ms = {"scene0": [], "progressive_scene0": []}
        for _ in range(26):
            for name in ms:  # in turns
                t1 = time.perf_counter()
                decode_image(cases[name][0])
                ms[name].append((time.perf_counter() - t1) * 1e3)
        print(json.dumps({
            "jpeg_vs_cv2": f"{len(cases)} committed cases equal cv2's answer, {refused} of them None",
            "decode_ms_768x1024_420_q95": statistics.median(ms["scene0"][1:]),
            "decode_ms_768x1024_420_q95_progressive": statistics.median(ms["progressive_scene0"][1:]),
            "bytes": len(cases["scene0"][0]), "bytes_progressive": len(cases["progressive_scene0"][0]),
            "what": "host wall ms, median of 25 after one untimed, baseline and progressive in turns",
            "card": card_line()}), flush=True)

    # -- 12 --------------------------------------------------------------
    def jpeg_service(self):
        from ppocr_tpu_torch.serve import OCRIPCClient
        from ppocr_tpu_torch.utils.imcodec import decode_image, encode_png

        if self.serving_worker is None:
            raise AssertionError("needs the bf16 serving phase's worker")
        cases, _ = self.assets.load_jpeg_cases()
        jpegs = [cases["scene0"][0], cases["scene1"][0]]
        want = [self.serving_worker.process(decode_image(j), i)["words"] for i, j in enumerate(jpegs)]
        # the progressive scene0 and a CMYK crop of it, held the same way
        others = {n: cases[n][0] for n in ("progressive_scene0", "cmyk_scene0_crop")}
        want_others = {n: self.serving_worker.process(decode_image(j), 0)["words"] for n, j in others.items()}
        if not want_others["progressive_scene0"] or not want_others["cmyk_scene0_crop"]:
            raise AssertionError(f"no words in process: {want_others}")
        pngs = [encode_png(s) for s in self.scenes["serving"]]
        req = lambda data: {"command": "recognize",  # noqa: E731
                            "image_data": base64.b64encode(data).decode()}
        sock = os.path.join(self.tmp.name, "jpeg.sock")
        proc, lines = self.start_service(sock, {"--warmup": "full"})
        try:
            walls = {"jpeg": [], "png": []}
            with OCRIPCClient(sock, timeout_ms=120000) as c:
                before = service_launches(c)
                for i, data in enumerate(jpegs):
                    check_words(c.send_request(req(data)).get("words"), want[i], f"jpeg scene {i}")
                for name, data in others.items():
                    check_words(c.send_request(req(data)).get("words"), want_others[name], name)
                self.launches["jpeg service"] = launched = launches_since(c, before, "JPEG")

                def timed(kind):
                    for i in range(8):
                        data = (jpegs if kind == "jpeg" else pngs)[i % 2]
                        t0 = time.perf_counter()
                        r = c.send_request(req(data))
                        walls[kind].append((time.perf_counter() - t0) * 1e3)
                        if not r.get("success"):
                            raise AssertionError(f"{kind} request: {str(r)[:200]}")
                        if kind == "jpeg":
                            check_words(r["words"], want[i % 2], "jpeg, timed")

                for kind in ("jpeg", "png", "png", "jpeg"):
                    timed(kind)
                if c.send_shutdown_command().get("success") is not True:
                    raise AssertionError("shutdown was not acknowledged")
            if proc.wait(timeout=30) != 0:
                raise AssertionError("the service exited with an error:\n" + "\n".join(lines[-20:]))
            print(json.dumps({
                "jpeg_service": "serving-jumbo bf16, 768x1024 scenes as JPEG (q95 4:2:0, q90 "
                "4:2:2) and as PNG, 16 requests each in turns; the progressive scene0 and a "
                "CMYK crop of it answered as in process",
                "words_progressive_cmyk": [len(w) for w in want_others.values()],
                "launches_of_4_jpeg_requests": launched,
                "jpeg_bytes": [len(j) for j in jpegs], "png_bytes": [len(p) for p in pngs],
                "jpeg_request_p50_ms": statistics.median(walls["jpeg"]),
                "png_request_p50_ms": statistics.median(walls["png"]), "card": card_line()}),
                flush=True)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)

    # -- 13 --------------------------------------------------------------
    def image_formats(self):
        import numpy as np

        from ppocr_tpu_torch.ops import native
        from ppocr_tpu_torch.serve import OCRIPCClient
        from ppocr_tpu_torch.utils import imcodec
        from ppocr_tpu_torch.utils.imcodec import decode_image, encode_png, read_image, sniff_format

        if self.serving_worker is None:
            raise AssertionError("needs the bf16 serving phase's worker")
        t0 = time.perf_counter()
        libs = [native.build(src) for src in (native.BMP_RLE_SOURCE, native.HDR_SOURCE, native.GIF_SOURCE,
                                              native.TIFF_SOURCE, native.WEBP_SOURCE, native.JPEG2000_SOURCE,
                                              native.AV1_SOURCE)]
        print(f"bmp rle, hdr, gif, tiff (with jpeg), webp (with vp8), jpeg2000 and av1 decoder builds: "
              f"{time.perf_counter() - t0:.2f} s "
              f"({', '.join(lib.name for lib in libs)})")
        cases = self.assets.load_image_cases()
        counts = {}  # format → [cases, of them None]
        fax_timed = ("scene0_tiff_g4", "scene0_tiff_g3", "scene0_tiff_g3_2d", "scene0_tiff_rle", "scene0_tiff_rlew",
                     "page_tiff_g4")
        jpeg_timed = ("scene0_tiff_jpeg", "scene0_tiff_jpeg_tiles", "scene0_tiff_jpeg_onestrip")
        lossy_timed = ("scene0_webp_q90", "scene0_webp_q90_alpha")
        j2k_timed = ("scene0_jp2", "scene0_j2k_lossy")
        timed = ("scene0_bmp24", "scene0_grey_rle8", "scene0_ppm", "scene0_ras", "scene0_ras_rle", "scene0_pfm",
                 "scene0_hdr_rle", "scene0_gif", "scene0_tiff_none", "scene0_tiff_lzw", "scene0_tiff_packbits",
                 "scene0_tiff_deflate") + fax_timed + jpeg_timed + ("scene0_webp", "scene0_webp_palette") + lossy_timed \
            + j2k_timed + ("scene0_avif", "scene0_avif_lossy", "scene0_avif_q95", "scene0_avif_default",
                           "scene0_avif_restored", "scene0_avif_grain")
        bare_jpeg = self.assets.load_jpeg_cases()[0]["scene0"][0]  # phase 11's q95 4:2:0 scene0
        payloads = {**{n: cases[n][0] for n in timed}, "scene0_jpeg": bare_jpeg}
        fax = [0, 0]  # CCITT fax TIFF cases, of them None
        jpeg_tiff = [0, 0]  # JPEG TIFF cases, of them None
        lossy = [0, 0]  # lossy WebP cases, of them None
        lossless = [0, 0]  # the other WebP cases, of them None
        j2k = [0, 0]  # JPEG 2000 cases (JP2 and raw codestreams), of them None
        avif = [0, 0]  # AVIF cases, of them None
        avif_lossy = [0, 0]  # of them lossy (4:4:4 or monochrome, the in-loop filters off), of them None
        avif_chroma = [0, 0]  # of them 4:2:0 or 4:2:2 (Pillow's and cv2's), of them None
        avif_filtered = [0, 0]  # of them deblocked and CDEF-filtered (cv2's, Pillow's, written), of them None
        avif_restored = [0, 0]  # of them loop-restored (cv2's, Pillow's, written), of them None
        avif_grain = [0, 0]  # of them with film grain (Pillow's test vectors, regrained streams), of them None
        avif_superres = [0, 0]  # of them upscaled by superres (written frames), of them None
        ms = {n: [] for n in payloads}
        logging.disable(logging.WARNING)  # each refusal logs a line
        try:
            for name, (data, want) in cases.items():
                got = decode_image(data)
                count = counts.setdefault(sniff_format(data), [0, 0])
                count[0] += 1
                is_fax = name.startswith("tiff_fax_") or name in fax_timed
                is_jpeg = name.startswith("tiff_jpeg_") or name in jpeg_timed
                is_lossy = name.startswith("webp_lossy_") or name in lossy_timed
                is_lossless = sniff_format(data) == "webp" and not is_lossy
                is_j2k = sniff_format(data) == "jpeg2000"
                is_avif = sniff_format(data) == "avif"
                is_avif_lossy = name.startswith("avif_lossy_") or name == "scene0_avif_lossy"
                is_avif_chroma = name.startswith("avif_chroma") or name == "scene0_avif_q95"
                is_avif_filtered = name.startswith("avif_filtered_") or name in ("scene0_avif_default",
                                                                                "scene0_avif_pillow")
                is_avif_restored = name.startswith("avif_restored_") or name == "scene0_avif_restored"
                is_avif_grain = name.startswith("avif_grain_") or name == "scene0_avif_grain"
                is_avif_superres = name.startswith("avif_superres_")
                j2k[0] += is_j2k
                avif[0] += is_avif
                avif_lossy[0] += is_avif_lossy
                avif_chroma[0] += is_avif_chroma
                avif_filtered[0] += is_avif_filtered
                avif_restored[0] += is_avif_restored
                avif_grain[0] += is_avif_grain
                avif_superres[0] += is_avif_superres
                fax[0] += is_fax
                jpeg_tiff[0] += is_jpeg
                lossy[0] += is_lossy
                lossless[0] += is_lossless
                if want is None:
                    if got is not None:
                        raise AssertionError(f"case {name}: decoded where cv2 gives None")
                    count[1] += 1
                    fax[1] += is_fax
                    jpeg_tiff[1] += is_jpeg
                    lossy[1] += is_lossy
                    lossless[1] += is_lossless
                    j2k[1] += is_j2k
                    avif[1] += is_avif
                    avif_lossy[1] += is_avif_lossy
                    avif_chroma[1] += is_avif_chroma
                    avif_filtered[1] += is_avif_filtered
                    avif_restored[1] += is_avif_restored
                    avif_grain[1] += is_avif_grain
                    avif_superres[1] += is_avif_superres
                elif got is None or got.shape != want.shape or not (got == want).all():
                    raise AssertionError(f"case {name}: the decode differs from cv2's")
            for _ in range(26):
                for name, data in payloads.items():  # in turns
                    t1 = time.perf_counter()
                    decode_image(data)
                    ms[name].append((time.perf_counter() - t1) * 1e3)
        finally:
            logging.disable(logging.NOTSET)
        # through the service: the scene as a 24-bit BMP and as an
        # uncompressed TIFF (by path: 2.4 MB is over the 1 MB message limit),
        # its grey as an RLE8 BMP and the scene as cv2's LZW TIFF (as data),
        # each beside the PNG of the same pixels
        pairs = {n: (cases[n][0], encode_png(decode_image(cases[n][0]))) for n in timed[:2]}
        tiff_pairs = {n: (cases[n][0], encode_png(decode_image(cases[n][0])))
                      for n in ("scene0_tiff_lzw", "scene0_tiff_none")}
        # the scene's G4 fax TIFF as data, beside the PNG of cv2's decode of it
        fax_png = encode_png(cases["scene0_tiff_g4"][1])
        # phase 11's scene0 JPEG as the one strip of a YCbCr TIFF: the bare
        # JPEG's pixels, held to the in-process worker and to the bare request
        jpeg_tiff_data = cases["scene0_tiff_jpeg_onestrip"][0]
        if bare_jpeg not in jpeg_tiff_data or not (decode_image(jpeg_tiff_data) == decode_image(bare_jpeg)).all():
            raise AssertionError("the one-strip JPEG TIFF does not hold the scene0 JPEG's pixels")
        want_jpeg_tiff = self.serving_worker.process(decode_image(jpeg_tiff_data), 0)["words"]
        # the scene as cv2's default (lossless) WebP, beside the PNG of the same pixels
        webp_data = cases["scene0_webp"][0]
        if webp_data[12:16] != b"VP8L":
            raise AssertionError("scene0_webp is not a lossless (VP8L) WebP")
        webp_png = encode_png(decode_image(webp_data))
        # the scene as cv2's q90 lossy WebP, beside the PNG of the same pixels
        lossy_data = cases["scene0_webp_q90"][0]
        if lossy_data[12:16] != b"VP8 ":
            raise AssertionError("scene0_webp_q90 is not a lossy (VP8) WebP")
        lossy_png = encode_png(decode_image(lossy_data))
        # the scene as Pillow's irreversible (9/7) JP2, beside the PNG of the same pixels
        j2k_data = cases["scene0_jp2_lossy"][0]
        if sniff_format(j2k_data) != "jpeg2000" or j2k_data[:4] == b"\xff\x4f\xff\x51":
            raise AssertionError("scene0_jp2_lossy is not a JP2 file")
        j2k_png = encode_png(decode_image(j2k_data))
        # the scene as cv2's lossless AVIF, beside the PNG of the same pixels
        avif_data = cases["scene0_avif"][0]
        if sniff_format(avif_data) != "avif" or not (decode_image(avif_data) == cases["scene0_avif"][1]).all():
            raise AssertionError("scene0_avif is not an AVIF that decodes to cv2's pixels")
        avif_png = encode_png(decode_image(avif_data))
        # the scene as a lossy 4:4:4 AVIF with the in-loop filters off,
        # beside the PNG of cv2's pixels of that file
        avif_lossy_data = cases["scene0_avif_lossy"][0]
        if sniff_format(avif_lossy_data) != "avif" or not (decode_image(avif_lossy_data)
                                                          == cases["scene0_avif_lossy"][1]).all():
            raise AssertionError("scene0_avif_lossy is not an AVIF that decodes to cv2's pixels")
        avif_lossy_png = encode_png(cases["scene0_avif_lossy"][1])
        # the scene as cv2's quality-95 AVIF (4:2:0, BT.601, the in-loop
        # filters off), beside the PNG of cv2's pixels of that file
        avif_q95_data = cases["scene0_avif_q95"][0]
        if sniff_format(avif_q95_data) != "avif" or not (decode_image(avif_q95_data)
                                                        == cases["scene0_avif_q95"][1]).all():
            raise AssertionError("scene0_avif_q95 is not an AVIF that decodes to cv2's pixels")
        avif_q95_png = encode_png(cases["scene0_avif_q95"][1])
        # the scene as cv2's default AVIF (quality 50: 4:2:0, BT.601, the
        # frame deblocked and CDEF-filtered), beside the PNG of cv2's pixels
        avif_default_data = cases["scene0_avif_default"][0]
        if sniff_format(avif_default_data) != "avif" or not (decode_image(avif_default_data)
                                                            == cases["scene0_avif_default"][1]).all():
            raise AssertionError("scene0_avif_default is not an AVIF that decodes to cv2's pixels")
        avif_default_png = encode_png(cases["scene0_avif_default"][1])
        # the scene as cv2's speed-4 AVIF at its default quality 50 (Wiener
        # loop restoration on luma beside deblocking and CDEF)
        avif_restored_data = cases["scene0_avif_restored"][0]
        if sniff_format(avif_restored_data) != "avif" or not (decode_image(avif_restored_data)
                                                             == cases["scene0_avif_restored"][1]).all():
            raise AssertionError("scene0_avif_restored is not an AVIF that decodes to cv2's pixels")
        restored_stats = np.zeros(native.AV1_STATS_SIZE, np.int32)
        restored_meta = imcodec._avif_parse(avif_restored_data)[0]
        restored_stream = imcodec._avif_item_data(restored_meta, restored_meta.items[restored_meta.primary],
                                                  avif_restored_data)
        status, _, why = native.av1_decode(restored_stream, native.av1_info(restored_stream)[1], restored_stats)
        lr_units = restored_stats[native.AV1_STATS["lr_units"][0]:native.AV1_STATS["lr_units"][1]].reshape(3, 3)
        if status or lr_units[:, 1:].sum() == 0:
            raise AssertionError(f"scene0_avif_restored restores no unit: {status} {why} {lr_units.tolist()}")
        avif_restored_png = encode_png(cases["scene0_avif_restored"][1])
        # the scene as Pillow's 4:2:0 q60 AVIF with film grain (libaom's test
        # vector 4: luma and chroma points, overlap), beside the PNG of cv2's pixels
        avif_grain_data = cases["scene0_avif_grain"][0]
        if sniff_format(avif_grain_data) != "avif" or not (decode_image(avif_grain_data)
                                                          == cases["scene0_avif_grain"][1]).all():
            raise AssertionError("scene0_avif_grain is not an AVIF that decodes to cv2's pixels")
        grain_stats = np.zeros(native.AV1_STATS_SIZE, np.int32)
        grain_meta = imcodec._avif_parse(avif_grain_data)[0]
        grain_stream = imcodec._avif_item_data(grain_meta, grain_meta.items[grain_meta.primary], avif_grain_data)
        status, _, why = native.av1_decode(grain_stream, native.av1_info(grain_stream)[1], grain_stats)
        grain_planes = grain_stats[native.AV1_STATS["grain"][0]:native.AV1_STATS["grain"][1]]
        if status or not grain_planes.all() or not grain_stats[native.AV1_STATS["grain_overlap"]]:
            raise AssertionError(f"scene0_avif_grain adds no grain to some plane or without overlap: {status} {why} "
                                 f"{grain_planes.tolist()}")
        avif_grain_png = encode_png(cases["scene0_avif_grain"][1])
        if not want_jpeg_tiff:
            raise AssertionError("the one-strip JPEG TIFF: no words in process")
        by_path = {}
        for name, ext in (("scene0_bmp24", "bmp"), ("scene0_tiff_none", "tif")):
            by_path[id(cases[name][0])] = os.path.join(self.tmp.name, f"scene0.{ext}")
            with open(by_path[id(cases[name][0])], "wb") as f:
                f.write(cases[name][0])
        if read_image(by_path[id(cases["scene0_tiff_none"][0])]) is None:
            raise AssertionError("read_image refuses the uncompressed scene TIFF")

        def req(data):
            if id(data) in by_path:
                return {"command": "recognize", "image_path": by_path[id(data)]}
            return {"command": "recognize", "image_data": base64.b64encode(data).decode()}

        # the HDR and GIF scenes, held to the in-process worker on the
        # port's decode; a grey PFM (a crop as data, the whole scene by path)
        others = {n: cases[n][0] for n in ("scene0_hdr_rle", "scene0_gif")}
        grey = decode_image(cases["scene0_bmp24"][0]).mean(axis=2, dtype=np.float32)
        grey_pfm = {"data": b"Pf\n320 256\n-1\n" + np.ascontiguousarray(grey[:256, :320][::-1]).astype("<f4").tobytes()}
        pfm_path = os.path.join(self.tmp.name, "grey.pfm")
        with open(pfm_path, "wb") as f:
            f.write(b"Pf\n1024 768\n-1\n" + np.ascontiguousarray(grey[::-1]).astype("<f4").tobytes())
        if decode_image(grey_pfm["data"]).shape != (256, 320) or read_image(pfm_path) is not None:
            raise AssertionError("a grey PFM must decode to [H, W] and be refused by read_image")
        want_grey = self.serving_worker.process(decode_image(grey_pfm["data"]), 0)

        sock = os.path.join(self.tmp.name, "formats.sock")
        proc, lines = self.start_service(sock, {"--warmup": "full"})
        words = {}
        try:
            with OCRIPCClient(sock, timeout_ms=120000) as c:
                before = service_launches(c)
                got = {name: c.send_request(req(bmp)) for name, (bmp, _) in pairs.items()}
                self.launches["bmp service"] = launched = launches_since(c, before, "BMP")
                for name, (_, png) in pairs.items():
                    want = c.send_request(req(png))
                    if not got[name].get("success") or not want.get("words"):
                        raise AssertionError(f"{name}: {str(got[name])[:200]} / {str(want)[:200]}")
                    check_words(got[name]["words"], want["words"], f"{name} as BMP vs PNG")
                    words[name] = len(got[name]["words"])
                before = service_launches(c)
                got = {name: c.send_request(req(tiff)) for name, (tiff, _) in tiff_pairs.items()}
                self.launches["tiff service"] = launched_tiff = launches_since(c, before, "TIFF")
                for name, (_, png) in tiff_pairs.items():
                    want = c.send_request(req(png))
                    if not got[name].get("success") or not want.get("words"):
                        raise AssertionError(f"{name}: {str(got[name])[:200]} / {str(want)[:200]}")
                    check_words(got[name]["words"], want["words"], f"{name} as TIFF vs PNG")
                    words[name] = len(got[name]["words"])
                before = service_launches(c)
                got_fax = c.send_request(req(cases["scene0_tiff_g4"][0]))
                self.launches["fax service"] = launched_fax = launches_since(c, before, "G4 fax TIFF")
                want = c.send_request(req(fax_png))
                if not got_fax.get("success") or not want.get("words"):
                    raise AssertionError(f"G4 fax TIFF: {str(got_fax)[:200]} / {str(want)[:200]}")
                check_words(got_fax["words"], want["words"], "the G4 fax TIFF vs the PNG of cv2's decode")
                words["scene0_tiff_g4"] = len(got_fax["words"])
                before = service_launches(c)
                got_jpeg_tiff = c.send_request(req(jpeg_tiff_data))
                self.launches["jpeg tiff service"] = launched_jpeg_tiff = launches_since(c, before, "JPEG TIFF")
                if not got_jpeg_tiff.get("success"):
                    raise AssertionError(f"the one-strip JPEG TIFF: {str(got_jpeg_tiff)[:200]}")
                check_words(got_jpeg_tiff["words"], want_jpeg_tiff, "the one-strip JPEG TIFF in the service vs in "
                            "process")
                check_words(got_jpeg_tiff["words"], c.send_request(req(bare_jpeg)).get("words"),
                            "the one-strip JPEG TIFF vs the bare JPEG request")
                words["scene0_tiff_jpeg_onestrip"] = len(got_jpeg_tiff["words"])
                before = service_launches(c)
                got_webp = c.send_request(req(webp_data))
                self.launches["webp service"] = launched_webp = launches_since(c, before, "WebP")
                want = c.send_request(req(webp_png))
                if not got_webp.get("success") or not want.get("words"):
                    raise AssertionError(f"lossless WebP: {str(got_webp)[:200]} / {str(want)[:200]}")
                check_words(got_webp["words"], want["words"], "the lossless WebP vs the PNG of the same pixels")
                words["scene0_webp"] = len(got_webp["words"])
                before = service_launches(c)
                got_lossy = c.send_request(req(lossy_data))
                self.launches["lossy webp service"] = launched_lossy = launches_since(c, before, "lossy WebP")
                if launched_lossy["ctc_topk"] != 1:
                    raise AssertionError(f"the lossy WebP request: {launched_lossy}, not 1 ctc_topk launch")
                want = c.send_request(req(lossy_png))
                if not got_lossy.get("success") or not want.get("words"):
                    raise AssertionError(f"lossy WebP: {str(got_lossy)[:200]} / {str(want)[:200]}")
                check_words(got_lossy["words"], want["words"], "the lossy WebP vs the PNG of the same pixels")
                words["scene0_webp_q90"] = len(got_lossy["words"])
                before = service_launches(c)
                got_j2k = c.send_request(req(j2k_data))
                self.launches["jpeg2000 service"] = launched_j2k = launches_since(c, before, "JPEG 2000")
                if launched_j2k["ctc_topk"] != 1:
                    raise AssertionError(f"the JPEG 2000 request: {launched_j2k}, not 1 ctc_topk launch")
                want = c.send_request(req(j2k_png))
                if not got_j2k.get("success") or not want.get("words"):
                    raise AssertionError(f"JPEG 2000: {str(got_j2k)[:200]} / {str(want)[:200]}")
                check_words(got_j2k["words"], want["words"], "the lossy JP2 vs the PNG of the same pixels")
                words["scene0_jp2_lossy"] = len(got_j2k["words"])
                before = service_launches(c)
                got_avif = c.send_request(req(avif_data))
                self.launches["avif service"] = launched_avif = launches_since(c, before, "AVIF")
                if launched_avif["ctc_topk"] != 1:
                    raise AssertionError(f"the AVIF request: {launched_avif}, not 1 ctc_topk launch")
                want = c.send_request(req(avif_png))
                if not got_avif.get("success") or not want.get("words"):
                    raise AssertionError(f"AVIF: {str(got_avif)[:200]} / {str(want)[:200]}")
                check_words(got_avif["words"], want["words"], "the lossless AVIF vs the PNG of the same pixels")
                if [(w["text"], w["box"]) for w in got_avif["words"]] != [(w["text"], w["box"]) for w in want["words"]]:
                    raise AssertionError("the lossless AVIF's words are not the PNG's: the texts and boxes must be equal")
                words["scene0_avif"] = len(got_avif["words"])
                before = service_launches(c)
                got_avif_lossy = c.send_request(req(avif_lossy_data))
                self.launches["lossy avif service"] = launched_avif_lossy = launches_since(c, before, "lossy AVIF")
                if launched_avif_lossy["ctc_topk"] != 1:
                    raise AssertionError(f"the lossy AVIF request: {launched_avif_lossy}, not 1 ctc_topk launch")
                want = c.send_request(req(avif_lossy_png))
                if not got_avif_lossy.get("success") or not want.get("words"):
                    raise AssertionError(f"lossy AVIF: {str(got_avif_lossy)[:200]} / {str(want)[:200]}")
                check_words(got_avif_lossy["words"], want["words"], "the lossy AVIF vs the PNG of cv2's pixels")
                if ([(w["text"], w["box"]) for w in got_avif_lossy["words"]]
                        != [(w["text"], w["box"]) for w in want["words"]]):
                    raise AssertionError("the lossy AVIF's words are not the PNG's: the texts and boxes must be equal")
                words["scene0_avif_lossy"] = len(got_avif_lossy["words"])
                before = service_launches(c)
                got_avif_q95 = c.send_request(req(avif_q95_data))
                self.launches["subsampled avif service"] = launched_avif_q95 = launches_since(
                    c, before, "subsampled AVIF")
                if launched_avif_q95["ctc_topk"] != 1:
                    raise AssertionError(f"the subsampled AVIF request: {launched_avif_q95}, not 1 ctc_topk launch")
                want = c.send_request(req(avif_q95_png))
                if not got_avif_q95.get("success") or not want.get("words"):
                    raise AssertionError(f"subsampled AVIF: {str(got_avif_q95)[:200]} / {str(want)[:200]}")
                check_words(got_avif_q95["words"], want["words"], "cv2's q95 AVIF vs the PNG of cv2's pixels")
                if ([(w["text"], w["box"]) for w in got_avif_q95["words"]]
                        != [(w["text"], w["box"]) for w in want["words"]]):
                    raise AssertionError("the subsampled AVIF's words are not the PNG's: the texts and boxes must be "
                                         "equal")
                words["scene0_avif_q95"] = len(got_avif_q95["words"])
                before = service_launches(c)
                got_avif_default = c.send_request(req(avif_default_data))
                self.launches["default avif service"] = launched_avif_default = launches_since(
                    c, before, "default AVIF")
                if launched_avif_default["ctc_topk"] != 1:
                    raise AssertionError(f"the default AVIF request: {launched_avif_default}, not 1 ctc_topk launch")
                want = c.send_request(req(avif_default_png))
                if not got_avif_default.get("success") or not want.get("words"):
                    raise AssertionError(f"default AVIF: {str(got_avif_default)[:200]} / {str(want)[:200]}")
                check_words(got_avif_default["words"], want["words"], "cv2's default AVIF vs the PNG of cv2's pixels")
                if ([(w["text"], w["box"]) for w in got_avif_default["words"]]
                        != [(w["text"], w["box"]) for w in want["words"]]):
                    raise AssertionError("the default AVIF's words are not the PNG's: the texts and boxes must be "
                                         "equal")
                words["scene0_avif_default"] = len(got_avif_default["words"])
                before = service_launches(c)
                got_avif_restored = c.send_request(req(avif_restored_data))
                self.launches["restored avif service"] = launched_avif_restored = launches_since(
                    c, before, "restored AVIF")
                if launched_avif_restored["ctc_topk"] != 1:
                    raise AssertionError(f"the restored AVIF request: {launched_avif_restored}, not 1 ctc_topk launch")
                want = c.send_request(req(avif_restored_png))
                if not got_avif_restored.get("success") or not want.get("words"):
                    raise AssertionError(f"restored AVIF: {str(got_avif_restored)[:200]} / {str(want)[:200]}")
                check_words(got_avif_restored["words"], want["words"], "cv2's speed-4 AVIF vs the PNG of cv2's pixels")
                if ([(w["text"], w["box"]) for w in got_avif_restored["words"]]
                        != [(w["text"], w["box"]) for w in want["words"]]):
                    raise AssertionError("the restored AVIF's words are not the PNG's: the texts and boxes must be "
                                         "equal")
                words["scene0_avif_restored"] = len(got_avif_restored["words"])
                before = service_launches(c)
                got_avif_grain = c.send_request(req(avif_grain_data))
                self.launches["grain avif service"] = launched_avif_grain = launches_since(c, before, "grain AVIF")
                if launched_avif_grain["ctc_topk"] != 1:
                    raise AssertionError(f"the grain AVIF request: {launched_avif_grain}, not 1 ctc_topk launch")
                want = c.send_request(req(avif_grain_png))
                if not got_avif_grain.get("success") or not want.get("words"):
                    raise AssertionError(f"grain AVIF: {str(got_avif_grain)[:200]} / {str(want)[:200]}")
                check_words(got_avif_grain["words"], want["words"], "Pillow's film-grain AVIF vs the PNG of cv2's "
                            "pixels")
                if ([(w["text"], w["box"]) for w in got_avif_grain["words"]]
                        != [(w["text"], w["box"]) for w in want["words"]]):
                    raise AssertionError("the grain AVIF's words are not the PNG's: the texts and boxes must be "
                                         "equal")
                words["scene0_avif_grain"] = len(got_avif_grain["words"])
                before = service_launches(c)
                got = {name: c.send_request(req(data)) for name, data in others.items()}
                self.launches["hdr gif service"] = launched_hdr_gif = launches_since(c, before, "HDR and GIF")
                for name, data in others.items():
                    want = self.serving_worker.process(decode_image(data), 0)["words"]
                    if not got[name].get("success") or not want:
                        raise AssertionError(f"{name}: {str(got[name])[:200]} / {str(want)[:200]}")
                    check_words(got[name]["words"], want, f"{name} in the service vs in process")
                    words[name] = len(got[name]["words"])
                grey_pfm["path"] = c.send_request({"command": "recognize", "image_path": pfm_path})
                grey_pfm["data"] = c.send_request(req(grey_pfm["data"]))
                keys = ("success", "error", "width", "height")
                if ({k: grey_pfm["data"].get(k) for k in keys} != {k: want_grey.get(k) for k in keys}
                        or want_grey["success"] or "could not broadcast" not in want_grey["error"]):
                    raise AssertionError(f"grey PFM as data: {grey_pfm['data']} vs in process {want_grey}")
                if grey_pfm["path"] != {"success": False, "error": f"Failed to load image from path: {pfm_path}"}:
                    raise AssertionError(f"grey PFM by path: {grey_pfm['path']}")
                if c.send_shutdown_command().get("success") is not True:
                    raise AssertionError("shutdown was not acknowledged")
            if proc.wait(timeout=30) != 0:
                raise AssertionError("the service exited with an error:\n" + "\n".join(lines[-20:]))
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
        print(json.dumps({
            "image_formats_vs_cv2": f"{len(cases)} committed cases equal cv2's answer, "
            f"{sum(c[1] for c in counts.values())} of them None",
            "tiff_vs_cv2": f"{counts.get('tiff', [0, 0])[0]} TIFF and BigTIFF cases equal cv2's answer, "
            f"{counts.get('tiff', [0, 0])[1]} of them None",
            "fax_vs_cv2": f"{fax[0]} CCITT fax TIFF cases (RLE, RLEW, G3 1D and 2D, G4) equal cv2's answer, "
            f"{fax[1]} of them None",
            "tiff_jpeg_vs_cv2": f"{jpeg_tiff[0]} JPEG TIFF cases equal cv2's answer, {jpeg_tiff[1]} of them None",
            "webp_vs_cv2": f"{lossless[0]} lossless WebP cases equal cv2's answer, {lossless[1]} of them None",
            "webp_lossy_vs_cv2": f"{lossy[0]} lossy WebP cases (VP8, with ALPH, animations' first frames) equal "
            f"cv2's answer, {lossy[1]} of them None",
            "jpeg2000_vs_cv2": f"{j2k[0]} JPEG 2000 cases (JP2 and raw codestreams, cv2's, Pillow's and "
            f"libopenjp2's files, written boxes and markers, damaged files) equal cv2's answer, {j2k[1]} of them None",
            "avif_vs_cv2": f"{avif[0]} AVIF cases (cv2's lossless files, the intra tool corpus, written boxes and "
            f"items, lossy streams of every subsampling, deblocked and CDEF-filtered ones, damaged files) equal cv2's "
            f"answer, {avif[1]} of them None",
            "avif_lossy_vs_cv2": f"{avif_lossy[0]} of them lossy (Pillow's 4:4:4 streams at speeds 0-9, q30-95, "
            f"with quantiser matrices, delta q, IntraBC, tiles; cv2's monochrome; alpha; damaged), "
            f"{avif_lossy[1]} of them None",
            "avif_chroma_vs_cv2": f"{avif_chroma[0]} of them 4:2:0 or 4:2:2 (Pillow's streams lossless and lossy, "
            f"odd sizes, screen content with IntraBC, encoder options; cv2's q95 scene; damaged), "
            f"{avif_chroma[1]} of them None",
            "avif_filtered_vs_cv2": f"{avif_filtered[0]} of them deblocked and CDEF-filtered (cv2's files of "
            f"q20-90, Pillow's defaults and CDEF files, sharpness, monochrome, odd sizes, written frames with "
            f"delta lf, segment features and CDEF indices; the scene as cv2's and Pillow's defaults; damaged), "
            f"{avif_filtered[1]} of them None",
            "avif_restored_vs_cv2": f"{avif_restored[0]} of them loop-restored (Wiener, self-guided and switchable "
            f"units: cv2's files at speeds 0-4, Pillow's with restoration on in 4:4:4, 4:2:2 and 4:2:0, written "
            f"frames of every parameter set, unit size and lr_uv_shift; the scene as cv2's speed-4 file; damaged), "
            f"{avif_restored[1]} of them None",
            "avif_grain_vs_cv2": f"{avif_grain[0]} of them with film grain (Pillow's files of libaom's 16 test "
            f"vectors, streams regrained in 4:2:0, 4:2:2, 4:4:4 and monochrome with chroma from luma, every AR lag "
            f"and the clip; the scene as Pillow's vector-4 file; damaged), {avif_grain[1]} of them None",
            "avif_superres_vs_cv2": f"{avif_superres[0]} of them upscaled by superres (written frames of each "
            f"denominator 9-16 in 4:4:4 and 4:2:0, two tile columns, CDEF, loop restoration, coded lossless; "
            f"damaged), {avif_superres[1]} of them None",
            "scene0_avif_restored_lr_units [plane][none, wiener, sgrproj]": lr_units.tolist(),
            "scene0_avif_grain_planes [y, cb, cr]": grain_planes.tolist(),
            "cases_by_format": {k: {"cases": v[0], "none": v[1]} for k, v in sorted(counts.items())},
            **{f"decode_ms_768x1024_{n[len('scene0_'):]}": statistics.median(ms[n][1:]) for n in payloads
               if n.startswith("scene0_")},
            "decode_ms_1728x2304_tiff_g4": statistics.median(ms["page_tiff_g4"][1:]),
            "bytes": {n[len("scene0_"):] if n.startswith("scene0_") else n: len(cases[n][0]) for n in timed},
            "service_words": words, "launches_of_2_bmp_requests": launched,
            "launches_of_hdr_and_gif_requests": launched_hdr_gif,
            "launches_of_2_tiff_requests": launched_tiff, "launches_of_the_g4_fax_request": launched_fax,
            "launches_of_the_jpeg_tiff_request": launched_jpeg_tiff, "launches_of_the_webp_request": launched_webp,
            "launches_of_the_lossy_webp_request": launched_lossy,
            "launches_of_the_jpeg2000_request": launched_j2k, "launches_of_the_avif_request": launched_avif,
            "launches_of_the_lossy_avif_request": launched_avif_lossy,
            "launches_of_the_subsampled_avif_request": launched_avif_q95,
            "launches_of_the_default_avif_request": launched_avif_default,
            "launches_of_the_restored_avif_request": launched_avif_restored,
            "launches_of_the_grain_avif_request": launched_avif_grain,
            "grey_pfm_answers": {k: v.get("error") for k, v in grey_pfm.items()},
            "what": "host wall ms, median of 25 after one untimed, the thirty-four payloads in turns; "
            "ras_rle is byte-encoded, which cv2 5.0 refuses: its time is the refusal's; jpeg is phase 11's "
            "bare scene0 JPEG, tiff_jpeg_onestrip the same stream as a TIFF's one strip",
            "card": card_line()}), flush=True)

    # -- 14 --------------------------------------------------------------
    def train_batches(self):
        """Numpy rec batches (8 crops of the golden words at 48×320, T = 40)
        and det batches (2 × 256×256 scene cuts with box masks)."""
        import numpy as np

        from ppocr_tpu_torch.ops.resize import crnn_resize
        from ppocr_tpu_torch.utils.imcodec import decode_image

        cases, texts = self.assets.load_jpeg_cases()
        crops = [decode_image(cases[f"crop{i}"][0]) for i in range(len(texts))]
        x = np.stack([crnn_resize(crops[i % len(crops)], 320 / 48, (3, 48, 320)) for i in range(8)])
        x = (x.astype(np.float32) / 255.0 - 0.5) * 2.0
        rec = []
        for seed in range(3):
            rng = np.random.default_rng(seed)
            labels = rng.integers(1, 5008, (8, 44)).astype(np.int32)
            lens = np.array([5, 9, 3, 12, 1, 7, 20, 30])
            labels[0, 1] = labels[0, 2]
            pads = (np.arange(44)[None, :] >= lens[:, None]).astype(np.float32)
            rec.append({"images": x, "labels": np.where(pads > 0, 0, labels).astype(np.int32),
                        "label_paddings": pads})
        det = []
        for seed in range(3):
            imgs, masks = self.det_images(2, 256, seed)
            det.append({"images": imgs, "masks": masks})
        return rec, det

    def det_images(self, n, size, seed):
        """``n`` normalized ``size``×``size`` cuts of the serving scenes
        (det-normalized, as the serving det step normalizes) and masks
        that are 1 inside the golden boxes."""
        import numpy as np

        rng = np.random.default_rng(seed)
        mean = np.array([0.485, 0.456, 0.406], np.float32)
        std = np.array([0.229, 0.224, 0.225], np.float32)
        imgs, masks = [], []
        for i in range(n):
            k = i % len(self.scenes["serving"])
            scene = self.scenes["serving"][k]
            y0 = int(rng.integers(0, scene.shape[0] - size + 1))
            x0 = int(rng.integers(0, scene.shape[1] - size + 1))
            cut = scene[y0 : y0 + size, x0 : x0 + size]
            m = np.zeros(scene.shape[:2], np.float32)
            for w in self.goldens["words"]["serving"][k]:
                b = np.asarray(w["box"])
                m[b[:, 1].min() : b[:, 1].max() + 1, b[:, 0].min() : b[:, 0].max() + 1] = 1.0
            imgs.append((cut.astype(np.float32) / 255.0 - mean) / std)
            masks.append(m[y0 : y0 + size, x0 : x0 + size])
        return np.stack(imgs).astype(np.float32), np.stack(masks)

    def train_parity(self):
        from ppocr_tpu_torch.models import det_to_jax, rec_to_jax
        from ppocr_tpu_torch.train import trainer as TT
        from ppocr_tpu_torch.utils.checkpoint import load_params_npz

        rec_batches, det_batches = self.train_batches()
        jumbo = load_params_npz(str(self.assets.WEIGHTS / "rec_scene_jumbo.npz"))
        det = load_params_npz(str(self.assets.WEIGHTS / "det_synthetic_text.npz"))
        runs = (("rec", TT.make_train_step, jumbo, rec_batches, rec_to_jax, 1e-4),
                ("det", TT.make_det_train_step, det, det_batches, det_to_jax, 1e-3))
        with f32_exact():
            for name, make, params, batches, to_jax, lr in runs:
                trees, losses = {}, {}
                for dev in ("cuda", "cpu"):
                    _, init_fn, step_fn = make(dev, learning_rate=lr)
                    state = init_fn(params)
                    losses[dev] = []
                    for b in batches:
                        state, loss = step_fn(state, b)
                        losses[dev].append(float(loss))
                    trees[dev] = to_jax(state.model)
                for a, b in zip(losses["cuda"], losses["cpu"]):
                    if not abs(a - b) <= 1e-4 * abs(b):
                        raise AssertionError(f"{name} train losses: card {losses['cuda']} vs cpu "
                                             f"{losses['cpu']}")
                worst, off, n = adam_close(trees["cuda"], trees["cpu"], 3 * lr)
                print(json.dumps({
                    "train_parity": f"{name}, 3 steps, f32 TF32 off, card vs CPU",
                    "losses_card": losses["cuda"], "losses_cpu": losses["cpu"],
                    "params_max_abs_diff": worst, "params_off_tight": f"{off}/{n}"}), flush=True)
            self.ctc_parity()

    def ctc_parity(self):
        """``ctc_loss`` on the card against the CPU, both routes: rows
        that align (``F.ctc_loss``) and one that cannot (optax's
        recursion)."""
        import numpy as np

        from ppocr_tpu_torch.train.trainer import ctc_loss

        rng = np.random.default_rng(5)
        logits = torch.from_numpy(rng.normal(size=(8, 40, 5008)).astype(np.float32) * 3)
        lens = np.array([5, 9, 3, 12, 1, 7, 40, 44])  # 44 labels: no alignment in 40 frames
        labels = rng.integers(1, 5008, (8, 44)).astype(np.int32)
        labels[0, 1] = labels[0, 2]
        pads = (np.arange(44)[None, :] >= lens[:, None]).astype(np.float32)
        labels = np.where(pads > 0, 0, labels).astype(np.int32)
        out = []
        for dev in (self.dev, "cpu"):
            x = logits.to(dev).requires_grad_(True)
            per_seq = ctc_loss(x, labels, pads)
            per_seq.mean().backward()
            out.append((per_seq.detach().cpu(), x.grad.cpu()))
        (v, g), (vc, gc) = out
        torch.testing.assert_close(v, vc, rtol=1e-5, atol=0)
        if not 9e4 < float(vc[-1]) < float("inf"):
            raise AssertionError(f"the row without an alignment: {float(vc[-1])}")
        torch.testing.assert_close(g[:-1], gc[:-1], rtol=1e-4, atol=1e-6)
        torch.testing.assert_close(g[-1], gc[-1], rtol=2.0**-5, atol=1e-6)
        print(json.dumps({"ctc_parity": "ctc_loss [8, 40, 5008], card vs CPU",
                          "per_seq_card": v.tolist(),
                          "grad_max_abs_diff": float((g - gc).abs().max())}), flush=True)

    # -- 15 --------------------------------------------------------------
    def finetune(self):
        import numpy as np

        from ppocr_tpu_torch.ops import kernels as K
        from ppocr_tpu_torch.pipeline import OCREngine, OCRWorker
        from ppocr_tpu_torch.train.finetune import finetune_rec
        from ppocr_tpu_torch.utils.imcodec import encode_png

        root = pathlib.Path(self.tmp.name) / "ft_data"
        root.mkdir()
        lines = []
        for k, (scene, words) in enumerate(zip(self.scenes["serving"],
                                               self.goldens["words"]["serving"])):
            for j, w in enumerate(words):
                b = np.asarray(w["box"])
                x0, y0 = np.maximum(b.min(axis=0), 0)
                x1, y1 = b.max(axis=0)
                (root / f"s{k}_{j}.png").write_bytes(encode_png(scene[y0 : y1 + 1, x0 : x1 + 1]))
                lines.append(f"s{k}_{j}.png\t{w['text']}")
        cases, texts = self.assets.load_jpeg_cases()
        for i, text in enumerate(texts):
            (root / f"crop{i}.jpg").write_bytes(cases[f"crop{i}"][0])
            lines.append(f"crop{i}.jpg\t{text}")
        (root / "rec_gt.txt").write_text("\n".join(lines) + "\n", encoding="utf-8")

        steps, warm, batch = self.FT_STEPS, self.FT_WARM, self.FT_BATCH
        ends, losses = [], []

        def on_step(step, loss):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            ends.append(ev)
            losses.append(loss)

        out = pathlib.Path(self.tmp.name) / "ft_out"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        weights = finetune_rec(str(root / "rec_gt.txt"), str(out),
                               init_weights=str(self.assets.WEIGHTS / "rec_scene_jumbo.npz"),
                               charset_file=str(self.assets.WEIGHTS / "jumbo_keys.txt"),
                               steps=steps, batch_size=batch, img_h=48, img_w=self.FT_WIDTH,
                               log_every=40, on_step=on_step)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        step_ms = statistics.median(a.elapsed_time(b) for a, b in zip(ends[warm:], ends[warm + 1:]))
        losses = [float(x) for x in losses]
        k = max(1, steps // 10)  # one batch's loss is noisy: compare the first and last tenths
        head, tail = statistics.mean(losses[:k]), statistics.mean(losses[-k:])
        if not tail < head:
            raise AssertionError(f"finetune loss did not fall: {head} -> {tail}")

        # the exported bundle served as rec/, beside the jumbo bundle
        tuned_dir = self.assets.make_jumbo_model_dir(pathlib.Path(self.tmp.name) / "tuned")
        for name in ("weights.npz", "ppocr_keys_v1.txt"):
            (tuned_dir / "rec" / name).write_bytes((out / name).read_bytes())
        golden = [w["text"] for ws in self.goldens["words"]["serving"] for w in ws]
        read, counts = {}, None
        for label, md in (("jumbo", self.model_dir), ("fine-tuned", str(tuned_dir))):
            worker = OCRWorker(OCREngine(md, self.serving_config()), 0)
            for s in self.scenes["serving"]:  # untimed: the shapes' first calls
                worker.process(s, 0)
            torch.cuda.synchronize()
            K.reset_launch_counts()  # this bundle's served run starts here
            served = [w["text"] for i, s in enumerate(self.scenes["serving"])
                      for w in worker.process(s, i)["words"]]
            read[label] = len(set(golden) & set(served)) / max(len(golden), 1)
            if label == "fine-tuned":
                counts = K.launch_counts()
        self.launches["finetuned bundle serving"] = counts
        if counts["ctc_topk"] <= 0:
            raise AssertionError(f"serving the fine-tuned bundle never launched ctc_topk: {counts}")
        print(json.dumps({
            "finetune": f"finetune_rec, jumbo init, {len(lines)} crops, 48x{self.FT_WIDTH}, batch "
            f"{batch}, {steps} steps, f32 (cuDNN TF32 on, the default)",
            "weights": pathlib.Path(weights).name, "step_ms": step_ms,
            "crops_per_s": batch / step_ms * 1e3, "wall_s": round(wall_s, 2),
            "max_memory_allocated_bytes": peak, "loss_first_step": losses[0], "loss_last_step": losses[-1],
            "loss_mean_first_tenth": head, "loss_mean_last_tenth": tail,
            "golden_texts_read": read, "launches_serving_tuned": counts, "card": card_line()}),
            flush=True)

    # -- 16 --------------------------------------------------------------
    def det_train(self):
        from ppocr_tpu_torch.models import init_det_params
        from ppocr_tpu_torch.train import make_det_train_step

        _, init_fn, step_fn = make_det_train_step(learning_rate=1e-3)
        state = init_fn(init_det_params(0))
        n, size = self.DET_BATCH, self.DET_SIZE
        batches = [dict(zip(("images", "masks"), self.det_images(n, size, seed))) for seed in range(4)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ends, losses = [], []
        for i in range(self.DET_STEPS):
            state, loss = step_fn(state, batches[i % len(batches)])
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            ends.append(ev)
            losses.append(loss)
        torch.cuda.synchronize()
        losses = [float(x) for x in losses]
        step_ms = statistics.median(a.elapsed_time(b) for a, b in zip(ends[4:], ends[5:]))
        # the balanced BCE is two clipped means, the positive and the
        # negative pixels', each at most −log(1e-6) ≈ 13.8
        if not all(0 < x < 2 * -math.log(1e-6) for x in losses):
            raise AssertionError(f"det train losses: {losses}")
        print(json.dumps({
            "det_train": f"make_det_train_step, init_det_params(0), batch {n} x {size}x{size}, "
            f"{self.DET_STEPS} steps, f32 (cuDNN TF32 on, the default)", "step_ms": step_ms,
            "images_per_s": n / step_ms * 1e3,
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "losses": losses, "card": card_line()}), flush=True)

    # -- 17 --------------------------------------------------------------
    def jumbo_rec_batch(self, n, seed):
        """``n`` crops of the golden words at 48×320 (T = 40), f32
        normalized, with labels of 1–30 classes from a seed."""
        import numpy as np

        from ppocr_tpu_torch.ops.resize import crnn_resize
        from ppocr_tpu_torch.utils.imcodec import decode_image

        cases, texts = self.assets.load_jpeg_cases()
        crops = [decode_image(cases[f"crop{i}"][0]) for i in range(len(texts))]
        x = np.stack([crnn_resize(crops[i % len(crops)], 320 / 48, (3, 48, 320)) for i in range(n)])
        rng = np.random.default_rng(seed)
        lens = rng.integers(1, 31, n)
        labels = rng.integers(1, 5008, (n, 30)).astype(np.int32)
        pads = (np.arange(30)[None, :] >= lens[:, None]).astype(np.float32)
        return {"images": (x.astype(np.float32) / 255.0 - 0.5) * 2.0,
                "labels": np.where(pads > 0, 0, labels).astype(np.int32), "label_paddings": pads}

    def train_devices(self):
        import numpy as np
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        from ppocr_tpu_torch.models import det_to_jax, rec_forward, rec_from_jax, rec_to_jax
        from ppocr_tpu_torch.ops import kernels as K
        from ppocr_tpu_torch.ops.resize import crnn_resize
        from ppocr_tpu_torch.parallel import (dryrun_multichip, make_mesh, shard_rec_params,
                                              sharded_rec_infer)
        from ppocr_tpu_torch.train import trainer as TT
        from ppocr_tpu_torch.utils.checkpoint import load_params_npz
        from ppocr_tpu_torch.utils.imcodec import decode_image

        card = str(self.dev)
        with f32_exact():
            dry = dryrun_multichip(8, [card] * 8)
        if (dry["mesh"] != {"data": 4, "model": 2} or not abs(dry["ctc_loss"] - 65.0417) <= 1e-4 * 65.0417
                or not abs(dry["det_bce_loss"] - 0.6932) <= 1e-4):
            raise AssertionError(f"dry run: {dry}, the JAX package's: mesh {{'data': 4, 'model': 2}}, "
                                 f"ctc loss 65.0417, det bce loss 0.6932")

        meshes = {"one_device": None, "data2": make_mesh(devices=[card] * 2),
                  "data1_model2": make_mesh(devices=[card] * 2, model=2)}
        runs = (("rec", TT.make_train_step, load_params_npz(str(self.assets.WEIGHTS / "rec_scene_jumbo.npz")),
                 self.jumbo_rec_batch(self.FT_BATCH, 0), rec_to_jax, 1e-4,
                 ("one_device", "data2", "data1_model2")),
                ("det", TT.make_det_train_step,
                 load_params_npz(str(self.assets.WEIGHTS / "det_synthetic_text.npz")),
                 dict(zip(("images", "masks"), self.det_images(self.DET_BATCH, self.DET_SIZE, 0))),
                 det_to_jax, 1e-3, ("one_device", "data2")))

        def start(make, lr, m, params):
            kw = {"device": card} if meshes[m] is None else {"mesh": meshes[m]}
            _, init_fn, step_fn = make(learning_rate=lr, **kw)
            return init_fn(params), step_fn

        out = {}
        for name, make, params, batch, to_jax, lr, which in runs:
            # three steps in f32 with TF32 off, each mesh against one device
            trees, losses = {}, {}
            with f32_exact():
                for m in which:
                    state, step_fn = start(make, lr, m, params)
                    losses[m] = []
                    for _ in range(3):
                        state, loss = step_fn(state, batch)
                        losses[m].append(float(loss))
                    trees[m] = to_jax(state.model)
                    if m != "one_device":
                        rows = state.model.rows
                        if not all(torch.equal(a, b) for r in rows[1:]
                                   for a, b in zip(rows[0].parameters(), r.parameters())):
                            raise AssertionError(f"{name} {m}: the rows' copies differ")
            parity = {}
            for m in which[1:]:
                for a, b in zip(losses[m], losses["one_device"]):
                    if not abs(a - b) <= 1e-5 * abs(b):
                        raise AssertionError(f"{name} {m} losses {losses[m]} vs one device "
                                             f"{losses['one_device']}")
                worst, off, n = adam_close(trees[m], trees["one_device"], 3 * lr)
                parity[m] = {"losses": losses[m], "params_max_abs_diff": worst,
                             "params_off_tight": f"{off}/{n}"}
            # timing, cuDNN's default TF32: each state after 3 untimed steps,
            # then 20 steps between step ends, the configurations in turns
            # (one device, meshes, meshes reversed, one device)
            states = {}
            for m in which:
                state, step_fn = start(make, lr, m, params)
                for _ in range(3):
                    state, _ = step_fn(state, batch)
                states[m] = [state, step_fn]
            rounds, peaks = {m: [] for m in which}, {m: 0 for m in which}
            for m in which + which[::-1]:
                state, step_fn = states[m]
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                ends = []
                for _ in range(21):
                    state, loss = step_fn(state, batch)
                    ev = torch.cuda.Event(enable_timing=True)
                    ev.record()
                    ends.append(ev)
                torch.cuda.synchronize()
                rounds[m].append([a.elapsed_time(b) for a, b in zip(ends, ends[1:])])
                peaks[m] = max(peaks[m], torch.cuda.max_memory_allocated())
                states[m][0] = state
            timed = {}
            for m in which:
                state, step_fn = states[m]
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    for _ in range(2):
                        state, loss = step_fn(state, batch)
                    torch.cuda.synchronize()
                kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                           and not e.is_user_annotation and not e.key.startswith("Optimizer.")]
                timed[m] = {"step_ms": statistics.median(rounds[m][0] + rounds[m][1]),
                            "step_ms_by_round": [statistics.median(r) for r in rounds[m]],
                            "max_memory_allocated_gb": peaks[m] / 1e9,
                            "launches_per_step": sum(e.count for e in kernels) / 2,
                            "loss_last": float(loss)}
            del states, state
            base = timed["one_device"]
            for m in which[1:]:
                timed[m]["step_ms_ratio"] = timed[m]["step_ms"] / base["step_ms"]
                timed[m]["launches_ratio"] = (timed[m]["launches_per_step"] / base["launches_per_step"]
                                              if base["launches_per_step"] else None)
            out[name] = {"parity_f32_tf32_off_vs_one_device": parity, "timed": timed,
                         "losses_one_device": losses["one_device"]}

        # sharded_rec_infer over data 2 x model 2 on the golden-word crops
        cases, texts = self.assets.load_jpeg_cases()
        crops = [decode_image(cases[f"crop{i}"][0]) for i in range(len(texts))]
        n = len(crops) - len(crops) % 2
        x = np.stack([crnn_resize(c, 256 / 48, (3, 48, 256)) for c in crops[:n]])
        x = torch.from_numpy((x.astype(np.float32) / 255.0 - 0.5) * 2.0).to(card)
        model = rec_from_jax(load_params_npz(str(self.assets.WEIGHTS / "rec_scene_jumbo.npz"))).to(card)
        mesh = make_mesh(devices=[card] * 4, model=2)
        with f32_exact():
            with torch.inference_mode():
                probs = rec_forward(model, x)
                one_idx, one_val = K.ctc_topk(probs)
                top2 = probs.topk(2, dim=-1).values
            infer, split = sharded_rec_infer(mesh), shard_rec_params(mesh, model)
            infer(split, x)  # untimed: the split copies' first call
            torch.cuda.synchronize()
            K.reset_launch_counts()  # the train devices main path's run starts here
            idx, val = infer(split, x)
            torch.cuda.synchronize()
            counts = K.launch_counts()
        self.launches["train devices"] = counts
        if (n // 2, x.shape[2] // 8, probs.shape[2]) != SHARDED_TIER:
            raise AssertionError(f"sharded_rec_infer's row shape {(n // 2, x.shape[2] // 8)} was "
                                 f"not held against the plain version ({SHARDED_TIER})")
        clear = (top2[..., 0] - top2[..., 1]) > 1e-4
        if not torch.equal(idx[clear], one_idx[clear]) or counts["ctc_topk"] != 2:
            raise AssertionError(f"sharded_rec_infer over data 2 x model 2: "
                                 f"{int((idx != one_idx)[clear].sum())} index mismatches where the "
                                 f"top two differ by > 1e-4; launches {counts}")
        torch.testing.assert_close(val, one_val, rtol=2e-4, atol=0)
        print(json.dumps({
            "train_devices": "one card for several devices: dryrun_multichip(8, ['cuda:0'] * 8) "
            "f32 TF32 off; rec = the jumbo recognizer at 32 x 48x320, det = the trained detector "
            "at 8 x 512x512; meshes data2 = make_mesh(devices=['cuda:0'] * 2), data1_model2 = the "
            "same with model=2; 3 steps f32 TF32 off against one device, then 3 untimed steps of "
            "each and 20 timed steps of each in turns, twice, with cuDNN TF32 (the default; "
            "peak memory with every configuration's state held); two or four cards were not "
            "measured",
            "dryrun": dry, **out,
            "sharded_rec_infer": {"mesh": mesh.shape, "crops": list(x.shape[:3]),
                                  "clear_share": float(clear.float().mean()),
                                  "val_max_rel_err": float(((val - one_val).abs() / one_val).max()),
                                  "launches": counts},
            "card": card_line()}), flush=True)

    # -- 10 --------------------------------------------------------------
    def processes(self):
        from ppocr_tpu_torch.serve import OCRIPCClient
        from ppocr_tpu_torch.utils.imcodec import encode_png

        scenes = list(self.scenes["serving"])
        payloads = [{"command": "recognize",
                     "image_data": base64.b64encode(encode_png(s)).decode()} for s in scenes]
        want = getattr(self, "staged_served", None)
        if want is None:
            raise AssertionError("needs the staged serving phase's words")

        def status(c):
            return json.loads(c.get_service_status()["status"])

        def timed(c, n=8):
            walls = []
            for i in range(n):
                t0 = time.perf_counter()
                r = c.send_request(payloads[i % len(payloads)])
                walls.append((time.perf_counter() - t0) * 1e3)
                check_staged_words(r.get("words") or [], want[i % len(payloads)], "processes")
            return walls

        def launches(st):
            """Per kernel, summed over the worker processes (counted since
            each one's start, its warmup included)."""
            return {k: sum(p["kernel_launches"][k] for p in st["processes"])
                    for k in st["processes"][0]["kernel_launches"]}

        # a single-process staged service first, for the request p50 beside
        sock1 = os.path.join(self.tmp.name, "one.sock")
        proc1, lines1 = self.start_service(sock1, {"--staged": None, "--warmup": "full"})
        try:
            with OCRIPCClient(sock1, timeout_ms=120000) as c:
                timed(c, 4)
                single = timed(c)
                c.send_shutdown_command()
            proc1.wait(timeout=30)
        finally:
            if proc1.poll() is None:
                proc1.kill()
                proc1.wait(timeout=10)

        sock = os.path.join(self.tmp.name, "pub.sock")
        t0 = time.perf_counter()
        proc, lines = self.start_service(
            sock, {"--staged": None, "--warmup": "full", "--processes": 2, "--boot-timeout": 300},
            ready="OCR balancer listening", own_group=True)
        pids = []
        try:
            boot_s = time.perf_counter() - t0
            ready = [ln for ln in lines if "ready in" in ln]
            with OCRIPCClient(sock, timeout_ms=120000) as c:
                answers = self.concurrent(OCRIPCClient, sock, [payloads[i % 2] for i in range(8)])
                for i, r in enumerate(answers):
                    check_staged_words(r.get("words") or [], want[i % 2], "processes, concurrent")
                st = status(c)
                per = st["processes"]
                if len(per) != 2 or any("error" in p for p in per):
                    raise AssertionError(f"merged status: {st}")
                pids = [p["pid"] for p in per]
                if st["total_requests"] != 8 or st["failed_requests"] != 0 or min(
                        p["total_requests"] for p in per) < 1 or len(set(pids)) != 2:
                    raise AssertionError(f"both workers must have served: {st}")
                before = launches(status(c))  # the workers' warmup and the requests so far
                timed(c, 4)
                walls = timed(c)
                after = launches(status(c))
                delta = {k: after[k] - before[k] for k in after}
                self.launches["processes"] = delta
                # a staged request runs at least one rec step, never blob_stats
                if delta["ctc_topk"] < 4 + len(walls) or delta["blob_stats"] != 0:
                    raise AssertionError(f"{4 + len(walls)} requests through the balancer "
                                         f"launched {delta}")
                os.kill(pids[0], signal.SIGKILL)
                timed(c, 4)  # the other worker serves meanwhile
                deadline = time.monotonic() + 120
                new_pids = []
                while time.monotonic() < deadline:
                    new_pids = [p.get("pid") for p in status(c)["processes"]]
                    if None not in new_pids and pids[0] not in new_pids:
                        break
                    time.sleep(0.5)
                if None in new_pids or pids[0] in new_pids or pids[1] not in new_pids:
                    raise AssertionError(f"the killed worker was not replaced: {pids} -> {new_pids}")
                replaced_s = time.monotonic() - (deadline - 120)
                self.concurrent(OCRIPCClient, sock, [payloads[i % 2] for i in range(4)])
                pids = sorted(set(pids + new_pids))
                if c.send_shutdown_command().get("success") is not True:
                    raise AssertionError("shutdown was not acknowledged")
            rc = proc.wait(timeout=60)
            if rc != 0:
                raise AssertionError(f"the supervisor exited with {rc}:\n" + "\n".join(lines[-20:]))
            time.sleep(0.5)
            left = [pid for pid in pids if pid_alive(pid)]
            if left:
                raise AssertionError(f"worker processes outlived the supervisor: {left}")
            print(json.dumps({
                "processes": "service_main --processes 2 --staged --warmup full, serving-jumbo "
                "bf16, 768x1024 requests", "boot_s": round(boot_s, 2), "workers_ready": ready,
                "replaced_after_kill_s": round(replaced_s, 2),
                "request_p50_ms": statistics.median(walls),
                "request_p90_ms": sorted(walls)[int(0.9 * (len(walls) - 1))],
                "single_process_request_p50_ms": statistics.median(single),
                "launches_of_12_requests": delta, "launches_since_boot": after,
                "card": card_line()}), flush=True)
        finally:
            # the supervisor leads a process group of its own: whatever is
            # left of it and of its workers goes with the group
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            if proc.poll() is None:
                proc.wait(timeout=10)

    # -- 18 --------------------------------------------------------------
    def trace(self):
        """One fused bf16 request of scene0 inside ``engine.profile_trace``:
        the trace holds the ``fused.ctc_topk`` span and the hand-written
        ``ctc_topk`` kernel's CUDA events."""
        from ppocr_tpu_torch.ops import kernels as K
        from ppocr_tpu_torch.pipeline import OCRWorker

        if not self.serving_engines:
            raise AssertionError("needs the bf16 serving phase's engine")
        engine = self.serving_engines[False]
        worker = OCRWorker(engine, 0)
        scene = self.scenes["serving"][0]
        worker.process(scene, 0)  # untraced: the profiler's own start-up is not the request's
        logdir = os.path.join(self.tmp.name, "trace")
        torch.cuda.synchronize()
        K.reset_launch_counts()  # the traced request's run starts here
        t0 = time.perf_counter()
        with engine.profile_trace(logdir):
            resp = worker.process(scene, 1)
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        self.launches["trace"] = K.launch_counts()
        check_words(resp["words"], self.served["serving0"], "traced request")
        files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
        if len(files) != 1:
            raise AssertionError(f"profile_trace wrote {files}")
        events = json.loads(pathlib.Path(files[0]).read_text())["traceEvents"]
        spans = {e.get("name") for e in events if e.get("cat") == "user_annotation"}
        kernels = [e for e in events if e.get("cat") == "kernel"]
        ctc = [e for e in kernels if "ctc_topk_kernel" in e.get("name", "")]
        if "fused.ctc_topk" not in spans or not ctc or self.launches["trace"]["ctc_topk"] < 1:
            raise AssertionError(f"the trace lacks ctc_topk: spans {sorted(spans)[:20]}, "
                                 f"{len(kernels)} kernel events, launches {self.launches['trace']}")
        print(json.dumps({
            "trace": "one fused bf16 request of scene0 under engine.profile_trace",
            "file": os.path.basename(files[0]), "bytes": os.path.getsize(files[0]),
            "events": len(events), "kernel_events": len(kernels), "ctc_topk_kernel_events": len(ctc),
            "ctc_topk_kernel_us": [e.get("dur") for e in ctc], "fused_spans": sorted(
                n for n in spans if n and n.startswith("fused.")),
            "request_ms_traced": wall_ms, "processing_time_ms": resp["processing_time_ms"],
            "launches": self.launches["trace"], "card": card_line()}), flush=True)

    # -- 19 --------------------------------------------------------------
    def boot_and_soak(self):
        """``scripts/measure_boot_torch.py --mode incremental`` (the jumbo
        bundle's serving profile booted from nothing), then
        ``scripts/soak_torch.py --duration 10 --concurrency 4`` with 30
        control requests against a ``--batch-requests 4 --warmup full``
        service: both summaries printed, 0 errors."""
        from ppocr_tpu_torch.serve import OCRIPCClient

        def script(argv, timeout):
            out = subprocess.run([sys.executable, *argv], cwd=REPO, capture_output=True,
                                 text=True, timeout=timeout)
            lines = out.stdout.strip().splitlines()
            if out.returncode != 0 or not lines:
                raise AssertionError(f"{argv[0]} exited {out.returncode}:\n{out.stdout[-1500:]}"
                                     f"\n{out.stderr[-1500:]}")
            return json.loads(lines[-1])

        boot = script(["scripts/measure_boot_torch.py", "--mode", "incremental", "--timeout", "400"], 500)
        if "error" in boot or not 0 < boot["t_socket_s"] <= boot["t_first_ok_s"] <= boot["t_all_ready_s"]:
            raise AssertionError(f"boot: {boot}")
        self.launches["boot"] = boot["kernel_launches"]
        print(json.dumps({"boot": boot, "card": card_line()}), flush=True)

        sock = os.path.join(self.tmp.name, "soak.sock")
        proc, lines = self.start_service(sock, {"--batch-requests": 4, "--warmup": "full"})
        try:
            c = OCRIPCClient(sock, timeout_ms=120000)
            if not c.connect():
                raise AssertionError("cannot connect to the soak service")
            before = service_launches(c)
            soak = script(["scripts/soak_torch.py", "--socket", sock, "--duration", "10",
                           "--concurrency", "4", "--control-requests", "30", "--pid", str(proc.pid),
                           "--track-workers"], 300)
            self.launches["soak"] = launches_since(c, before, "soak")
            status = json.loads(c.get_service_status()["status"])
            if c.send_shutdown_command().get("success") is not True:
                raise AssertionError("soak service: shutdown was not acknowledged")
            c.disconnect()
            if proc.wait(timeout=20) != 0:
                raise AssertionError("soak service: " + "\n".join(lines[-20:]))
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
        served = soak["requests_ok"] + 30
        if soak["errors"] or soak["requests_ok"] < 1 or status["failed_requests"]:
            raise AssertionError(f"soak: {soak}")
        if status["total_requests"] != served:
            raise AssertionError(f"soak: the service counted {status['total_requests']}, "
                                 f"the client {served}")
        print(json.dumps({"soak": soak, "service_steps": status["workers"][0]["steps"],
                          "batched_steps": status["workers"][0]["batched_steps"],
                          "launches": self.launches["soak"], "card": card_line()}), flush=True)

    # -- 20 --------------------------------------------------------------
    def host_utilities(self):
        """The host utilities on ``assets/host_cases.npz`` against the JAX
        package's answers stored beside the inputs (written where cv2 and
        JAX run, ``tests/test_torch_structure.py --write``): table and
        PicoDet decode exact, the table resize within one grey level with
        the same shape and ratio, the pad's shape, the normalizer within
        1e-6, ``get_mini_boxes`` exact, ``unclip_rect`` within 1e-4 on
        ≥ 99 % of the quads and 2 px on all, ``boxes_from_bitmap`` for
        ``min_size`` 1, 3 and 6 within the staged tolerances (counts within
        one, ≥ 90 % of the boxes within 2 px)."""
        import numpy as np

        from ppocr_tpu_torch.ops import boxes_from_bitmap, get_mini_boxes, normalize_imagenet_np, unclip_rect
        from ppocr_tpu_torch.ops.resize import table_pad, table_resize
        from ppocr_tpu_torch.ops.structure import picodet_decode, table_decode

        c = self.assets.load_host_cases()
        ans = json.loads(str(c["answers"]))
        got = table_decode(c["table_probs"], c["table_loc"], ans["labels"], ans["widths"], ans["heights"])
        if list(map(list, got)) != ans["table"]:
            raise AssertionError(f"table_decode: {got} vs {ans['table']}")
        boxes = picodet_decode([c[f"picodet_cls{i}"] for i in range(4)],
                               [c[f"picodet_reg{i}"] for i in range(4)], ans["layout_labels"],
                               ori_shape=(96, 128), resize_shape=(64, 64), score_threshold=0.3)
        if [[b.box, b.type, b.confidence] for b in boxes] != ans["picodet"]:
            raise AssertionError("picodet_decode differs from the JAX answer")
        resized, ratio = table_resize(c["table_img"], 64)
        if (ratio != ans["table_ratio"] or resized.shape != c["table_resized"].shape
                or np.abs(resized.astype(int) - c["table_resized"]).max() > 1
                or table_pad(resized, 64).shape != c["table_padded"].shape):
            raise AssertionError("table_resize / table_pad differ from the JAX answer")
        norm_err = float(np.abs(normalize_imagenet_np(c["norm_img"]) - c["norm_out"]).max())
        if norm_err > 1e-6:
            raise AssertionError(f"normalize_imagenet_np: {norm_err}")
        for r, want, ssid in zip(c["rects"], c["mini_boxes"], ans["mini_ssid"]):
            box, got_ssid = get_mini_boxes(((r[0], r[1]), (r[2], r[3]), r[4]))
            if not np.array_equal(box, want) or got_ssid != ssid:
                raise AssertionError(f"get_mini_boxes of {r.tolist()}: {box.tolist()} vs {want.tolist()}")
        close = n = 0
        for q, want, none in zip(c["quads"], c["unclipped"], c["unclip_none"]):
            rect = unclip_rect(q, 1.8)
            if (rect is None) != bool(none):
                raise AssertionError(f"unclip_rect of {q.tolist()}: None-ness differs")
            if rect is not None:
                err = float(np.abs(get_mini_boxes(rect)[0] - want).max())
                if err > 2:
                    raise AssertionError(f"unclip_rect of {q.tolist()}: corners {err} px apart")
                close, n = close + (err <= 1e-4), n + 1
        if close < 0.99 * n:
            raise AssertionError(f"unclip_rect: {close} of {n} within 1e-4")
        counts = {}
        for min_size, want in ans["boxes"].items():
            got = boxes_from_bitmap(c["db_prob"], c["db_bitmap"], 0.4, 1.8, "fast", min_size=int(min_size))
            near = sum(any(np.abs(np.sort(g, 0) - np.sort(np.array(w), 0)).max() <= BOX_TOL for g in got)
                       for w in want)
            if abs(len(got) - len(want)) > 1 or near < 0.9 * len(want):
                raise AssertionError(f"boxes_from_bitmap min_size {min_size}: {got} vs {want}")
            counts[min_size] = [len(got), len(want)]
        print(json.dumps({
            "host_utilities": "the port's answers on assets/host_cases.npz against the JAX package's",
            "table_tags": [len(t) for t in ans["table"][0]], "picodet_boxes": len(boxes),
            "table_resized": list(resized.shape), "normalize_max_err": norm_err,
            "mini_boxes_exact": len(c["rects"]), "unclip_within_1e-4": f"{close}/{n}",
            "boxes_port_vs_jax": counts}), flush=True)

    # -- 21 --------------------------------------------------------------
    def synthetic_train(self):
        import hashlib

        import numpy as np

        from ppocr_tpu_torch.models import init_det_params
        from ppocr_tpu_torch.ops import kernels as K
        from ppocr_tpu_torch.train import make_det_train_step, make_train_step
        from ppocr_tpu_torch.train import synthetic as S
        from ppocr_tpu_torch.train.finetune import charset_classes, reinit_ctc_head
        from ppocr_tpu_torch.train.text_render import load_atlas
        from ppocr_tpu_torch.train.trainer import cosine_decay_schedule, run_steps
        from ppocr_tpu_torch.utils.checkpoint import load_params_npz

        digest = self.assets.load_synthetic_digest()
        load_atlas()  # read once (~0.3 s), outside the per-scene time
        t0 = time.perf_counter()
        got_scenes = []
        for seed in digest["seeds"]:
            scenes = S.text_scene_dataset("jumbo", seed=seed)
            for index in range(4):
                img, placed = scenes.sample_scene()
                got_scenes.append({
                    "seed": seed, "index": index, "placed": [[t, list(b)] for t, b in placed],
                    "sha256": hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()})
        scene_ms = (time.perf_counter() - t0) / len(got_scenes) * 1e3
        for g, w in zip(got_scenes, digest["scenes"]):
            if g != w:
                raise AssertionError(f"scene {w['seed']}/{w['index']} differs from the digest: {g} vs {w}")
        if len(got_scenes) != len(digest["scenes"]):
            raise AssertionError(f"{len(got_scenes)} scenes against {len(digest['scenes'])} in the digest")
        # the rotated rec batches: cv2 5.0's warpAffine replayed by csrc/warp.cpp
        rotated = digest["rotated_batches"]
        rotated_ds = S.SceneCropRecDataset(
            charset_classes(list(S.jumbo_alphabet())),
            S.text_scene_dataset("jumbo", seed=rotated["seed"]), img_h=rotated["img_h"],
            img_w=rotated["img_w"], aug_rotate_deg=rotated["aug_rotate_deg"])
        got_batches = [self.assets.rec_batch_sha256(*rotated_ds.batch(rotated["batch"]))
                       for _ in range(rotated["batches"])]
        if got_batches != rotated["sha256"]:
            raise AssertionError(f"rotated batches differ from the digest: {got_batches} vs "
                                 f"{rotated['sha256']}")

        def timed(make, into):
            def run():
                t = time.perf_counter()
                batch = make()
                into.append((time.perf_counter() - t) * 1e3)
                return batch
            return run

        def steps(step_fn, state, make_batch, n, losses):
            """``n`` steps of the recipes' loop (``run_steps``) on batches
            ``make_batch()`` makes on its prefetch thread: (state, busy ms,
            period ms, host wait ms), the timings of the steps after the
            warm ones."""
            starts, ends, waits, mark = [], [], [], [time.perf_counter()]

            def on_batch(step):
                waits.append((time.perf_counter() - mark[0]) * 1e3)
                starts.append(torch.cuda.Event(enable_timing=True))
                starts[-1].record()

            def on_step(step, state, loss):
                ends.append(torch.cuda.Event(enable_timing=True))
                ends[-1].record()
                losses.append(loss)
                mark[0] = time.perf_counter()

            state = run_steps(step_fn, state, make_batch, n, on_batch=on_batch, on_step=on_step)
            torch.cuda.synchronize()
            w = self.SYNTH_WARM
            busy = [a.elapsed_time(b) for a, b in zip(starts[w + 1:], ends[w + 1:])]
            period = [a.elapsed_time(b) for a, b in zip(ends[w:], ends[w + 1:])]
            return state, busy, period, waits[w + 1:]

        def traced(step_fn, state, make_batch, losses):
            """``SYNTH_TRACED`` prefetched steps under ``torch.profiler``
            (CPU and CUDA activity), after ``SYNTH_WARM`` untraced ones:
            (state, the card's idle share of the traced window, its device
            busy ms a step, the period ms a step under the profiler). The
            window runs from the first device event of the traced steps to
            the last; busy is the union of its kernels, copies and sets."""
            from torch.profiler import ProfilerActivity, profile, schedule

            n = self.SYNTH_WARM + self.SYNTH_TRACED
            path = os.path.join(self.tmp.name, "synthetic_train.pt.trace.json")
            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                           schedule=schedule(wait=0, warmup=self.SYNTH_WARM,
                                             active=self.SYNTH_TRACED),
                           on_trace_ready=lambda p: p.export_chrome_trace(path))
            marks = []

            def on_step(step, state, loss):
                losses.append(loss)
                if step == self.SYNTH_WARM:
                    torch.cuda.synchronize()
                    marks.append(time.perf_counter())
                if step == n:
                    torch.cuda.synchronize()
                    marks.append(time.perf_counter())
                prof.step()

            with prof:
                state = run_steps(step_fn, state, make_batch, n, on_step=on_step)
            events = json.loads(pathlib.Path(path).read_text())["traceEvents"]
            spans = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
            if not spans:
                raise AssertionError(f"the synthetic-train trace holds no device events "
                                     f"({len(events)} events)")
            busy, end = 0.0, spans[0][0]
            for a, b in spans:
                busy += max(0.0, b - max(a, end))
                end = max(end, b)
            window = end - spans[0][0]
            return (state, 1.0 - busy / window, busy / 1e3 / self.SYNTH_TRACED,
                    (marks[1] - marks[0]) * 1e3 / self.SYNTH_TRACED)

        def run(init_fn, step_fn, params, make, n_steps):
            """The step first on batches rendered beforehand (the prefetch
            thread only hands them over), then ``n_steps`` on batches it
            renders, then traced steps: the timings of all and every loss."""
            alone, host, losses = [], [], []
            pre = [timed(make, alone)() for _ in range(self.SYNTH_WARM + 5)]
            state = init_fn(params)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            K.reset_launch_counts()
            it = iter(pre)
            state, busy0, period0, _ = steps(step_fn, state, lambda: next(it), len(pre), losses)
            state, busy, period, waits = steps(step_fn, state, timed(make, host), n_steps, losses)
            launches = K.launch_counts()
            state, idle, device_ms, traced_period = traced(step_fn, state, make, losses)
            losses = [float(x) for x in losses]
            return losses, {
                "host_ms_per_batch_alone": statistics.median(alone),
                "host_ms_per_batch_on_thread": statistics.median(host),
                "step_ms_prerendered": statistics.median(busy0),
                "period_ms_prerendered": statistics.median(period0),
                "step_ms": statistics.median(busy), "period_ms": statistics.median(period),
                # how much of the prefetched period the rendering adds: the
                # period's stretch, read on the host's side of the events
                "period_stretch_share": 1.0 - statistics.median(period0) / statistics.median(period),
                # the card's own idle share, from the device trace (its window
                # is stretched by the profiler's host work), and the traced
                # device busy ms against the untraced periods
                "card_idle_share_traced": idle, "device_busy_ms_per_step_traced": device_ms,
                "period_ms_traced": traced_period,
                "card_idle_share_est": 1.0 - device_ms / statistics.median(period),
                "card_idle_share_prerendered_est": 1.0 - device_ms / statistics.median(period0),
                "host_wait_ms_median": statistics.median(waits),
                "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
                "launches": launches}

        host_state = {
            "threads": sorted(t.name for t in threading.enumerate()),
            "torch_threads": torch.get_num_threads(),
            "float32_matmul_precision": torch.get_float32_matmul_precision(),
            "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
            "cudnn_benchmark": torch.backends.cudnn.benchmark,
            "memory_allocated_bytes_before": torch.cuda.memory_allocated()}

        # the recognizer: the jumbo recipe at full width
        charset = charset_classes(list(S.jumbo_alphabet()))
        rec_ds = S.SceneCropRecDataset(charset, S.text_scene_dataset("jumbo", seed=7), img_h=48,
                                       img_w=256, aug_rotate_deg=8)
        params = load_params_npz(str(self.assets.WEIGHTS / "rec_scene_full.npz"))
        params = reinit_ctc_head(params, len(charset), seed=0)
        _, init_fn, step_fn = make_train_step(
            learning_rate=cosine_decay_schedule(1e-3, 14000, alpha=0.02))
        losses, timings = run(init_fn, step_fn, params, lambda: rec_ds.batch(48)[0],
                              self.REC_SYNTH_STEPS)
        if not all(np.isfinite(losses)):
            raise AssertionError(f"jumbo rec losses: {losses}")
        if not statistics.mean(losses[-5:]) < losses[0]:
            raise AssertionError(f"jumbo rec loss did not fall: {losses[0]} -> {losses[-5:]}")
        rec = {"what": "SceneCropRecDataset 48x256 rot 8 on text_scene_dataset('jumbo', seed=7), "
               "batch 48, rec_scene_full.npz with a 5,008-class head, "
               f"{self.SYNTH_WARM + 5} steps on batches rendered beforehand, then "
               f"{self.REC_SYNTH_STEPS} through the recipes' run_steps, then "
               f"{self.SYNTH_WARM + self.SYNTH_TRACED} traced, f32 (cuDNN TF32 on, the default)",
               **timings, "loss_first_step": losses[0], "loss_mean_last_5": statistics.mean(losses[-5:]),
               "losses": losses}

        # the detector on the same scenes' det batches
        det_ds = S.text_scene_dataset("jumbo")
        _, init_fn, step_fn = make_det_train_step(learning_rate=1e-3)
        losses, timings = run(init_fn, step_fn, init_det_params(0), lambda: det_ds.det_batch(8)[0],
                              self.DET_SYNTH_STEPS)
        if not all(0 < x < 2 * -math.log(1e-6) for x in losses):  # as in det_train
            raise AssertionError(f"jumbo det losses: {losses}")
        det = {"what": "text_scene_dataset('jumbo').det_batch(8), 192x192 scenes at 96x96, "
               f"init_det_params(0), {self.SYNTH_WARM + 5} steps on batches rendered beforehand, "
               f"then {self.DET_SYNTH_STEPS} through run_steps, then "
               f"{self.SYNTH_WARM + self.SYNTH_TRACED} traced", **timings, "losses": losses}

        # the two scripts themselves, on the card by default: 2 steps each,
        # the rec script's numpy greedy eval, both npz written in the JAX layout
        scripts = {}
        for name, argv in (
            ("train_synthetic_rec_torch", ["--scene-crops", "--alphabet", "jumbo", "--img-w", "256",
                                           "--aug-rotate", "8", "--batch", "48", "--steps", "2",
                                           "--init-weights",
                                           str(self.assets.WEIGHTS / "rec_scene_full.npz")]),
            ("train_synthetic_det_torch", ["--alphabet", "jumbo", "--batch", "8", "--steps", "2",
                                           "--eval-scenes", "4"]),
        ):
            out = os.path.join(self.tmp.name, f"{name}.npz")
            spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            buf = io.StringIO()
            t = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = module.main([*argv, "--out", out])
            wall = time.perf_counter() - t
            printed = buf.getvalue().splitlines()
            got = load_params_npz(out)
            if rc != 0 or not any(x.startswith(("eval: ", "eval over ")) for x in printed):
                raise AssertionError(f"{name} exited {rc}: {printed[-10:]}")
            scripts[name] = {"wall_s": wall, "printed": [x for x in printed if x.startswith(
                ("step", "eval", "saved"))], "npz_bytes": os.path.getsize(out), "trees": sorted(got)}
        classes = np.asarray(load_params_npz(
            os.path.join(self.tmp.name, "train_synthetic_rec_torch.npz"))["head"]["fc"]["b"]).shape[0]
        if classes != len(charset):
            raise AssertionError(f"the rec script wrote a {classes}-class head, not {len(charset)}")

        print(json.dumps({"synthetic_train": {"digest_scenes": len(got_scenes),
                                              "digest_rotated_batches": len(got_batches),
                                              "host_ms_per_scene": scene_ms, "host_state": host_state,
                                              "rec": rec, "det": det, "scripts": scripts},
                          "card": card_line()}), flush=True)


    # -- 22 --------------------------------------------------------------
    # the port's words on the CPU (tests/test_torch_e2e_jumbo.py, and
    # scripts/eval_jumbo_torch.py --device cpu): what the card's are read beside
    JUMBO_GATE_CPU = {"staged": {"exact": 135, "norm_exact": 195, "total": 211, "det_found": 211},
                      "fused": {"exact": 144, "norm_exact": 195, "total": 211, "det_found": 211}}

    def jumbo_gate(self):
        from ppocr_tpu_torch.ops import kernels as K
        from ppocr_tpu_torch.pipeline import OCREngine, OCRWorker
        from ppocr_tpu_torch.train import eval_jumbo as G

        banner = self.assets.load_jumbo_banner()
        with f32_exact():
            staged_eng = OCREngine(self.model_dir, G.gate_config())
            fused_eng = OCREngine(self.model_dir, G.fused_config())
            banner_workers = {fused: OCRWorker(OCREngine(self.model_dir, G.banner_config(fused)), 0)
                              for fused in (False, True)}
            torch.cuda.synchronize()
            K.reset_launch_counts()  # the gate's run starts here
            staged = G.score(OCRWorker(staged_eng, 0))
            fused = G.score(OCRWorker(fused_eng, 0))
            banner_words = {fused: w.process(banner, 1 + fused)["words"]
                            for fused, w in banner_workers.items()}
            torch.cuda.synchronize()
            counts = K.launch_counts()
        self.launches["jumbo gate"] = counts
        seen = G.head_indices(staged, staged_eng.charset)
        sims = {("fused" if f else "staged"): G.banner_similarity(w) for f, w in banner_words.items()}
        failed = G.bar_failures(staged, fused) + G.head_failures(seen)
        failed += [f"banner {path}: similarity {v:.3f} below {G.MIN_BANNER_SIMILARITY}"
                   for path, v in sims.items() if v < G.MIN_BANNER_SIMILARITY]
        if counts.get("ctc_topk", 0) < 1:
            failed.append(f"ctc_topk was not launched: {counts}")
        for path, sc in (("staged", staged), ("fused", fused)):
            print(f"jumbo gate {path} (card, f32, TF32 off): {sc.norm_exact}/{sc.total} normalized "
                  f"({sc.normalized:.4f}), {sc.exact} raw ({sc.raw:.4f}), det found "
                  f"{sc.det_found}/{sc.det_gt}, {sc.summary()['ms_per_scene']:.2f} ms per scene; "
                  f"CPU: {self.JUMBO_GATE_CPU[path]}", flush=True)
        print(json.dumps({"jumbo_gate": {
            "staged": staged.summary(), "fused": fused.summary(), "cpu": self.JUMBO_GATE_CPU,
            "banner_similarity": sims, "banner_words": {
                ("fused" if f else "staged"): [x["text"] for x in w] for f, w in banner_words.items()},
            "head_indices": {"max": max(seen, default=0), "distinct": len(seen)},
            "misses": {"staged": len(staged.misses), "fused": len(fused.misses)},
            "launches": counts, "bars_missed": failed}, "card": card_line()},
            ensure_ascii=False), flush=True)
        if failed:
            raise AssertionError(f"the jumbo gate's bars: {failed}")


    # -- 23 --------------------------------------------------------------
    # digit-line steps timed a phase (the first CV2_DIGITS_WARM untimed)
    CV2_DIGITS_STEPS, CV2_DIGITS_WARM = 13, 3

    def cv2_digits(self):
        import hashlib

        import numpy as np

        from ppocr_tpu_torch.models import init_det_params, init_rec_params
        from ppocr_tpu_torch.ops import kernels as K
        from ppocr_tpu_torch.ops import native
        from ppocr_tpu_torch.pipeline import OCREngine, OCRWorker
        from ppocr_tpu_torch.train import eval_digits as G
        from ppocr_tpu_torch.train import make_det_train_step, make_train_step
        from ppocr_tpu_torch.train import synthetic as S
        from ppocr_tpu_torch.train.finetune import charset_classes
        from ppocr_tpu_torch.utils.checkpoint import load_params_npz

        t0 = time.perf_counter()
        lib = native.build(native.CV2_TEXT_SOURCE)
        native.load_cv2_text_library()
        build_s = time.perf_counter() - t0
        if lib.parent != K.BUILD_DIR or not lib.exists():
            raise AssertionError(f"the text library is not under the build dir: {lib}")
        print(f"host text library build: {build_s:.2f} s ({lib.name})", flush=True)

        # the card's host draws what the JAX package drew with cv2
        digest = self.assets.load_synthetic_digest()
        want = digest["cv2"]
        digits = charset_classes(list("0123456789"))
        got_scenes = []
        for seed in digest["seeds"]:
            scenes = S.SyntheticSceneDataset(seed=seed)
            for index in range(4):
                img, placed = scenes.sample_scene()
                got_scenes.append({"seed": seed, "index": index, "placed": [[t, list(b)] for t, b in placed],
                                   "sha256": hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()})
        if got_scenes != want["scenes"]:
            bad = [w for g, w in zip(got_scenes, want["scenes"]) if g != w]
            raise AssertionError(f"{len(bad)} digit scenes differ from the digest, first {bad[:1]}")
        spec = want["rec_batches"]
        rec_ds = S.SyntheticRecDataset(digits, img_h=spec["img_h"], img_w=spec["img_w"], seed=spec["seed"])
        got = [self.assets.rec_batch_sha256(*rec_ds.batch(spec["batch"])) for _ in range(spec["batches"])]
        if got != spec["sha256"]:
            raise AssertionError(f"SyntheticRecDataset batches differ from the digest: {got}")
        spec = want["crop_batches"]
        crop_ds = S.SceneCropRecDataset(digits, S.SyntheticSceneDataset(seed=spec["seed"]), img_h=spec["img_h"],
                                        img_w=spec["img_w"], aug_rotate_deg=spec["aug_rotate_deg"])
        got = [self.assets.rec_batch_sha256(*crop_ds.batch(spec["batch"])) for _ in range(spec["batches"])]
        if got != spec["sha256"]:
            raise AssertionError(f"digit SceneCropRecDataset batches differ from the digest: {got}")

        # host time of the drawing (scripts/time_cv2_text_torch.py's workloads)
        spec_t = importlib.util.spec_from_file_location("time_cv2_text_torch",
                                                        REPO / "scripts" / "time_cv2_text_torch.py")
        timer = importlib.util.module_from_spec(spec_t)
        spec_t.loader.exec_module(timer)
        host_ms = {f"{name}_ms": timer._median_ms(fn, 20)
                   for name, fn in timer.workloads(S, S.put_text).items()}

        def step_times(init_fn, step_fn, params, make):
            """Per-step device ms (CUDA events from the batch in hand to the
            step's return) after CV2_DIGITS_WARM untimed steps, and losses."""
            state = init_fn(params)
            pairs, losses = [], []
            for i in range(self.CV2_DIGITS_STEPS):
                batch = make()
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                state, loss = step_fn(state, batch)
                end.record()
                losses.append(loss)
                if i >= self.CV2_DIGITS_WARM:
                    pairs.append((start, end))
            torch.cuda.synchronize()
            losses = [float(x) for x in losses]
            if not all(np.isfinite(losses)):
                raise AssertionError(f"losses: {losses}")
            return statistics.median(a.elapsed_time(b) for a, b in pairs), losses

        # the reference head's 6,625 classes, the digits where a charset has them
        charset = ["blank"] + list("0123456789") + G.placeholder_keys()[10:] + [" "]
        lines = S.SyntheticRecDataset(charset, img_h=48, img_w=192, seed=0)
        _, init_fn, step_fn = make_train_step(learning_rate=1e-3)
        rec_ms, rec_losses = step_times(init_fn, step_fn, init_rec_params(seed=0), lambda: lines.batch(32)[0])
        scenes = S.SyntheticSceneDataset(seed=0)
        _, init_fn, step_fn = make_det_train_step(learning_rate=1e-3)
        det_ms, det_losses = step_times(init_fn, step_fn, init_det_params(0), lambda: scenes.det_batch(16)[0])

        # the scripts' digit modes, on the card by default
        keys = os.path.join(self.tmp.name, "digit_keys.txt")
        with open(keys, "w", encoding="utf-8") as f:
            f.write("\n".join(charset[1:-1]) + "\n")
        scripts = {}
        for name, script, argv in (
            ("rec_lines", "train_synthetic_rec_torch", ["--alphabet", "digits", "--charset-file", keys]),
            ("rec_scene_crops", "train_synthetic_rec_torch", ["--alphabet", "digits", "--scene-crops",
                                                              "--img-w", "160", "--charset-file", keys]),
            ("det", "train_synthetic_det_torch", ["--alphabet", "digits", "--eval-scenes", "4"]),
        ):
            out = os.path.join(self.tmp.name, f"digits_{name}.npz")
            spec_s = importlib.util.spec_from_file_location(script, REPO / "scripts" / f"{script}.py")
            module = importlib.util.module_from_spec(spec_s)
            spec_s.loader.exec_module(module)
            buf = io.StringIO()
            t = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = module.main([*argv, "--steps", "3", "--out", out])
            printed = buf.getvalue().splitlines()
            load_params_npz(out)
            if rc != 0 or not any(x.startswith(("eval: ", "eval over ")) for x in printed):
                raise AssertionError(f"{script} {name} exited {rc}: {printed[-10:]}")
            scripts[name] = {"wall_s": time.perf_counter() - t,
                             "printed": [x for x in printed if x.startswith(("step", "eval"))]}

        # the digits gate's scenes through both paths, f32, TF32 off
        model_dir = str(self.assets.make_digits_model_dir(self.tmp.name + "/digits"))
        committed = self.assets.load_digits_words()
        with f32_exact():
            workers = {path: OCRWorker(OCREngine(model_dir, G.gate_config() if path == "staged"
                                                 else G.fused_config()), 0) for path in ("staged", "fused")}
            torch.cuda.synchronize()
            K.reset_launch_counts()  # the digits path's run starts here
            served = {path: G.serve(w) for path, w in workers.items()}
            torch.cuda.synchronize()
            counts = K.launch_counts()
        self.launches["cv2 digits"] = counts
        if counts.get("ctc_topk", 0) < 1:
            raise AssertionError(f"the digit scenes never launched ctc_topk: {counts}")
        for path, (scenes_served, _) in served.items():
            for i, (g, w) in enumerate(zip(scenes_served, committed[path])):
                if g["placed"] != w["placed"]:
                    raise AssertionError(f"{path} scene {i}: placed {g['placed']} vs {w['placed']}")
                check_words(g["words"], w["words"], f"cv2 digits {path} scene {i}")
        print(json.dumps({"cv2_digits": {
            "build_s": build_s, "digest": {"scenes": len(got_scenes), "rec_batches": 2, "crop_batches": 2},
            "host_ms": host_ms, "rec_step_ms": rec_ms, "det_step_ms": det_ms,
            "rec_step": "SyntheticRecDataset digit lines 48x192, batch 32, 6,625-class head, f32",
            "det_step": "SyntheticSceneDataset(seed=0).det_batch(16), 96x96, f32",
            "rec_losses": rec_losses, "det_losses": det_losses, "scripts": scripts,
            "served": {path: {"scenes": len(sc), "words": sum(len(x["words"]) for x in sc),
                              "ms_per_scene": sec * 1e3 / len(sc)} for path, (sc, sec) in served.items()},
            "launches": counts}, "card": card_line()}, ensure_ascii=False), flush=True)


def adam_close(got, want, lr_sum):
    """Two parameter trees after AdamW updates whose rates sum to
    ``lr_sum``, made on two devices. Adam divides each gradient element
    by its own running magnitude, so an element whose gradient is rounding
    noise moves by up to the rate per update in either direction on each
    device: every element must be within 2·``lr_sum``, and all but 1 in
    10^3 within 2e-6 + 1e-4·|w|. Returns (max abs diff, elements off the
    tight bound, elements)."""
    import numpy as np

    def flat(tree, out):
        if isinstance(tree, dict):
            for k in sorted(tree):
                flat(tree[k], out)
        elif isinstance(tree, (list, tuple)):
            for v in tree:
                flat(v, out)
        else:
            out.append(np.asarray(tree, np.float32).ravel())
        return out

    g, w = np.concatenate(flat(got, [])), np.concatenate(flat(want, []))
    d = np.abs(g - w)
    off = int((d > 2e-6 + 1e-4 * np.abs(w)).sum())
    if d.max() > 2 * lr_sum or off > 1e-3 * d.size:
        raise AssertionError(f"parameters differ: max {d.max()}, {off} of {d.size} off")
    return float(d.max()), off, int(d.size)


def pid_alive(pid: int) -> bool:
    """A process that runs (a zombie waiting for its parent does not count)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except (FileNotFoundError, ProcessLookupError):
        return False


def check_staged_words(got, want, where):
    """Staged words against a reference made with another contour backend
    (or in another dtype): at most one word without a partner, partners'
    texts identical. Returns (pairs, words without a partner)."""
    from ppocr_tpu_torch.assets import match_staged_words

    pairs, extra, missing = match_staged_words(got, want, BOX_TOL)
    loose = len(extra) + len(missing)
    if loose > 1 or len(pairs) < 2:
        raise AssertionError(f"{where}: {len(pairs)} words paired, without a partner: "
                             f"{extra} / {missing}")
    for g, w in pairs:
        if g["text"] != w["text"]:
            raise AssertionError(f"{where}: text {g['text']!r} vs {w['text']!r} at {g['box']}")
        tol = CONF_TOL if g["box"] == w["box"] else MOVED_BOX_CONF_TOL
        if abs(g["confidence"] - w["confidence"]) > tol:
            raise AssertionError(f"{where}: conf {g['confidence']} vs {w['confidence']}")
    return len(pairs), loose


def check_words(got, want, where):
    if got is None:
        raise AssertionError(f"{where}: no words in the response")
    if len(got) != len(want):
        raise AssertionError(f"{where}: {len(got)} words, golden has {len(want)}")
    for g, w in zip(got, want):
        if g["text"] != w["text"]:
            raise AssertionError(f"{where}: text {g['text']!r} vs golden {w['text']!r}")
        d = max(abs(a - b) for p, q in zip(g["box"], w["box"]) for a, b in zip(p, q))
        if d > BOX_TOL:
            raise AssertionError(f"{where}: box {g['box']} vs golden {w['box']}")
        if abs(g["confidence"] - w["confidence"]) > CONF_TOL:
            raise AssertionError(f"{where}: conf {g['confidence']} vs {w['confidence']}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; card: {card_line()}", flush=True)
    smoke = Smoke()
    phases = [
        ("build", smoke.build),
        ("launch floor", smoke.floor),
        ("ctc_topk vs plain", smoke.check_ctc_topk),
        ("blob_stats vs plain", smoke.check_blob_stats),
        ("f32 parity", smoke.parity),
        ("bf16 serving", smoke.serving),
        ("devices", smoke.devices),
        ("fused options", smoke.options),
        ("service", smoke.service),
        ("staged parity", smoke.staged_parity),
        ("staged serving", smoke.staged_serving),
        ("processes", smoke.processes),
        ("jpeg vs cv2", smoke.jpeg_vs_cv2),
        ("jpeg service", smoke.jpeg_service),
        ("image formats vs cv2", smoke.image_formats),
        ("train parity", smoke.train_parity),
        ("finetune", smoke.finetune),
        ("det train", smoke.det_train),
        ("train devices", smoke.train_devices),
        ("trace", smoke.trace),
        ("boot and soak", smoke.boot_and_soak),
        ("host utilities", smoke.host_utilities),
        ("synthetic train", smoke.synthetic_train),
        ("jumbo gate", smoke.jumbo_gate),
        ("cv2 digits", smoke.cv2_digits),
    ]
    only = [a.split("=", 1)[1] for a in sys.argv[1:] if a.startswith("--only=")]
    for name, fn in phases:
        if not only or name in only:
            smoke.phase(name, fn)
    smoke.tmp.cleanup()
    print(f"total {time.perf_counter() - t0:.1f} s")
    if smoke.failures:
        print(f"chip_smoke: failed phases: {smoke.failures}", file=sys.stderr)
        return 1
    if only:  # some phases alone: no result lines
        return 0
    # launches: the sum over the main paths' runs, each counted from 0
    for name, kern in smoke.kernels.items():
        kern["launches_by_path"] = {path: c.get(name, 0) for path, c in smoke.launches.items()}
        kern["launches"] = sum(kern["launches_by_path"].values())
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "floor_ms", "wrapper_ms",
            "warm_ms", "shape", "launches_by_path", "tiers")
    print(json.dumps({"kernels": [{k: kern.get(k) for k in keys} for kern in smoke.kernels.values()]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
