"""Drive the PyTorch port's fused OCR request on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero without the final ``ok`` line):

1. the card (``nvidia-smi`` name and power limit) and the kernel build
   (``nvcc`` for sm_90a from ``ppocr_tpu_torch/csrc``);
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
   (on the path each kernel reads what the launch before it just wrote);
3. f32 parity, TF32 off, against the JAX package's committed goldens
   (``ppocr_tpu_torch/assets``): the 96 px "small" config and
   "serving-jumbo" (``PipelineConfig.serving()`` with rec 48×256);
4. serving-jumbo in bf16 through ``OCRWorker.process`` (8 requests) and
   one 4-image ``process_batch`` with buckets (1, 4), then again with
   ``fused_blob_kernel=True`` (same words required). The kernels' launch
   counters are zeroed just before this phase and must be > 0 after it.

It then prints the ``kernels`` JSON line, the card line, and
``{"ok": true, "device": {...}}`` last. Weights are the repo's jumbo bundle
(``weights/``); nothing is fetched.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_OPS_PER_S = 67e12  # H100 SXM non-tensor f32 peak (also used for int32 compares)
BOX_TOL = 2  # px; det conv summation order can flip a threshold pixel
CONF_TOL = 2e-3
PSUM_RTOL = 1e-5


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


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    same = (torch.isnan(a) & torch.isnan(b)) | (a == b)  # equal infinities too
    d = torch.where(same, 0.0, (a.double() - b.double()).abs())
    return float(d.max())


class Smoke:
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
        self.model_dir = str(assets.make_jumbo_model_dir(self.tmp.name))

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
                      (8, 16, 5007), (3, 7, 31), (3, 7, 4), (1, 1, 5008), (1, 1, 6625)):
            p = torch.rand(shape, generator=g)
            v = shape[2]
            p[0, 0, :] = 0.25  # whole-row tie
            if shape[1] > 2:
                p[0, 1, min(3, v - 2)] = p[0, 1, v - 2] = 2.0  # two-way tie
                p[1, 2, v // 2] = float("nan")  # NaN row
            p = p.to(self.dev)
            idx, err = compare(p, shape)
            if int(idx[0, 0]) != 0 or (shape[1] > 2 and (
                    int(idx[1, 2]) != v - 1 or int(idx[0, 1]) != min(3, v - 2))):
                raise AssertionError(f"ctc_topk tie/NaN rule broken at {shape}")
            print(f"ctc_topk {shape}: exact")
            probs[shape] = p
            worst = max(worst, err)
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
        # the last one is reported in the kernels line
        for shape in ((32, 48, 6625), (32, 64, 5008), (16, 32, 5008)):
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

        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
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
        finally:
            torch.backends.cudnn.allow_tf32 = True
            torch.backends.cuda.matmul.allow_tf32 = False

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
            print(json.dumps({
                "serving": "serving-jumbo bf16", "fused_blob_kernel": blob_kernel,
                "warmup_s": round(warm, 3), "requests": len(singles),
                "p50_ms": statistics.median(ms), "p90_ms": ms[int(0.9 * (len(ms) - 1))],
                "batch4_ms": resp[8]["processing_time_ms"], "card": card_line(),
            }), flush=True)
        counts = K.launch_counts()
        for name, n in counts.items():
            self.kernels.setdefault(name, {"name": name})["launches"] = n
        print(f"launches on the main path: {counts}")
        if min(counts.values()) <= 0:
            raise AssertionError(f"a kernel of the path never launched: {counts}")
        if runs[True] != runs[False]:
            raise AssertionError("fused_blob_kernel=True changed the served words")
        n_words = sum(len(w) for w in runs[False])
        golden = [w["text"] for ws in self.goldens["words"]["serving"] for w in ws]
        served = [w["text"] for ws in runs[False][:2] for w in ws]
        agree = len(set(golden) & set(served)) / max(len(golden), 1)
        print(f"bf16 served {n_words} words; serving scenes: {agree:.3f} of the f32 "
              f"golden texts read identically")
        if n_words == 0 or agree < 0.5:
            raise AssertionError("bf16 serving output disagrees with the f32 goldens")


def check_words(got, want, where):
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
    smoke.phase("build", smoke.build)
    smoke.phase("launch floor", smoke.floor)
    smoke.phase("ctc_topk vs plain", smoke.check_ctc_topk)
    smoke.phase("blob_stats vs plain", smoke.check_blob_stats)
    smoke.phase("f32 parity", smoke.parity)
    smoke.phase("bf16 serving", smoke.serving)
    smoke.tmp.cleanup()
    print(f"total {time.perf_counter() - t0:.1f} s")
    if smoke.failures:
        print(f"chip_smoke: failed phases: {smoke.failures}", file=sys.stderr)
        return 1
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "floor_ms", "wrapper_ms",
            "warm_ms", "shape")
    print(json.dumps({"kernels": [{k: kern.get(k) for k in keys} for kern in smoke.kernels.values()]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
