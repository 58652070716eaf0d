"""The port's hand-written CUDA kernels, their plain PyTorch versions and
their build.

==========  ===================================  ==========================
kernel      replaces (TPU, Pallas)               source
==========  ===================================  ==========================
ctc_topk    ppocr_tpu/ops/pallas_kernels.py      csrc/ctc_topk.cu
            ``ctc_topk_pallas``
blob_stats  ppocr_tpu/ops/pallas_kernels.py      csrc/blob_stats.cu
            ``blob_stats_pallas``
==========  ===================================  ==========================

Both are bound by bytes on an H100, and at the serving shapes by the cost
of a launch (``csrc/noop.cu`` measures that floor; the path never calls
it). Each source note gives the numbers and the design:

* ``ctc_topk``: the first design, one warp per row, filled under half the
  card at a request's 512 rows (0.41 TB/s). Now one 128-thread block per
  row with four 16-byte loads in flight per thread, a scalar head and
  tail per row, so any V and any 4-byte aligned base pointer are served
  without a copy.
* ``blob_stats``: the first design voted once per slot for every 32
  pixels and needed about fourteen PyTorch launches around it to
  initialise and convert. Now one launch: a pass per distinct label of a
  warp's pixels, background warps skipped, and the last block to finish
  writes the six f32 outputs and re-zeroes the scratch, so the wrapper
  queues nothing but ``torch.empty``.

The sources are compiled with ``nvcc`` for ``sm_90a`` at first use, one
process per source started together, into one shared library with a plain
C interface under ``_build/`` (listed in ``.gitignore``) and loaded with
``ctypes``. Each launch function returns ``cudaGetLastError()`` and the
wrapper raises on a non-zero code.

A wrapper sends CPU tensors to the plain version and launches the kernel
for CUDA tensors; there is no fallback from one to the other. Each
wrapper counts its kernel launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("ctc_topk.cu", "blob_stats.cu", "noop.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
BIG = 1e9  # empty-root sentinel of blob_stats (x0/y0 = +BIG, x1/y1 = -BIG)
BLOB_ACC_WORDS = 6  # scratch words per slot (count, mass, x0, x1, y0, y1)

_lib = None
build_log = ""  # nvcc's output of the last build (registers, smem, spills)


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def build() -> Path:
    """Compile the kernel sources into ``_build/libppocr_kernels-<hash>.so``
    (skipped when that file exists) and return its path."""
    global build_log
    digest = hashlib.sha1()
    for name in SOURCES:
        digest.update((CSRC / name).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    lib = BUILD_DIR / f"libppocr_kernels-{digest.hexdigest()[:12]}.so"
    if lib.exists():
        return lib
    nvcc = _nvcc()
    BUILD_DIR.mkdir(exist_ok=True)
    objs = [BUILD_DIR / f"{name}.{os.getpid()}.o" for name in SOURCES]
    procs = [
        subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for name, obj in zip(SOURCES, objs)
    ]
    logs = [p.communicate()[0] for p in procs]
    build_log = "".join(logs)
    if any(p.returncode for p in procs):
        raise RuntimeError(f"nvcc failed:\n{build_log}")
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,
        text=True,
    )
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link.returncode:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib)
    return lib


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernels; returns the ctypes handle."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ctc_topk_launch.argtypes = [p, i, i, p, p, p]
        lib.ctc_topk_launch.restype = i
        lib.blob_stats_launch.argtypes = [p, p, p, i, i, i, i, i, p, p, p]
        lib.blob_stats_launch.restype = i
        lib.noop_launch.argtypes = [p]
        lib.noop_launch.restype = i
        _lib = lib
    return _lib


def _check(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _launch_noop(lib):
    """An empty kernel of one thread: the cost of a launch on the card."""
    _check(lib.noop_launch(_stream()), "noop")


# ---------------------------------------------------------------------------
# K1: CTC top-k


def ctc_topk_plain(probs: torch.Tensor):
    """[N, T, V] → ([N, T] int32 first argmax, [N, T] f32 max); a row with
    a NaN gives (V − 1, NaN), as the Pallas kernel does."""
    x = probs.float()
    v = x.shape[-1]
    val = x.amax(dim=-1)  # NaN if the row holds one
    col = torch.arange(v, device=x.device, dtype=torch.int32)
    hit = torch.where(x == val.unsqueeze(-1), col, v)
    idx = torch.clamp(hit.amin(dim=-1), max=v - 1).to(torch.int32)
    return idx, val


def _launch_ctc_topk(lib, x, idx, val):
    """The bare kernel launch on a contiguous f32 [N, T, V] tensor."""
    n, t, v = x.shape
    _check(
        lib.ctc_topk_launch(x.data_ptr(), n * t, v, idx.data_ptr(), val.data_ptr(), _stream()),
        "ctc_topk",
    )


def ctc_topk(probs: torch.Tensor):
    """CTC top-k of [N, T, V] probabilities: the kernel for a CUDA tensor,
    :func:`ctc_topk_plain` for a CPU tensor."""
    if probs.dim() != 3:
        raise ValueError(f"ctc_topk wants [N, T, V], got {tuple(probs.shape)}")
    if probs.device.type == "cpu":
        return ctc_topk_plain(probs)
    if probs.device.type != "cuda":
        raise ValueError(f"ctc_topk: unsupported device {probs.device}")
    lib = load_library()
    n, t, v = probs.shape
    x = probs.float().contiguous()
    idx = torch.empty((n, t), dtype=torch.int32, device=x.device)
    val = torch.empty((n, t), dtype=torch.float32, device=x.device)
    _launch_ctc_topk(lib, x, idx, val)
    ctc_topk.launches += 1
    return idx, val


ctc_topk.launches = 0


# ---------------------------------------------------------------------------
# K2: blob stats


def blob_stats_plain(labels: torch.Tensor, prob: torch.Tensor, roots: torch.Tensor):
    """labels [B, H, W] int, prob [B, H, W] f32, roots [B, K] int → (area,
    psum, x0, x1, y0, y1), each [B, K] f32, by masked reductions over the
    [B, K, H, W] membership mask (the formulation of
    ``ppocr_tpu.pipeline.fused._blob_stats``). Roots with no pixels get
    x0/y0 = +1e9 and x1/y1 = −1e9."""
    b, h, w = labels.shape
    member = labels.unsqueeze(1) == roots.to(labels.dtype)[:, :, None, None]
    area = member.sum(dim=(2, 3)).float()
    psum = torch.einsum(
        "bkp,bp->bk", member.reshape(b, -1, h * w).float(), prob.reshape(b, h * w).float()
    )
    rowp = member.any(dim=3)  # [B, K, H]
    colp = member.any(dim=2)  # [B, K, W]
    iy = torch.arange(h, device=labels.device, dtype=torch.float32)
    ix = torch.arange(w, device=labels.device, dtype=torch.float32)
    y0 = torch.where(rowp, iy, BIG).amin(-1)
    y1 = torch.where(rowp, iy, -BIG).amax(-1)
    x0 = torch.where(colp, ix, BIG).amin(-1)
    x1 = torch.where(colp, ix, -BIG).amax(-1)
    return area, psum, x0, x1, y0, y1


_blob_scratch = {}  # (device index, stream) → zeroed int32 scratch


def _scratch_for(device: torch.device, stream: int, words: int) -> torch.Tensor:
    """The kernel's global accumulators: zeroed once here, left zeroed by
    every launch, one per stream so that two streams never share it."""
    key = (device.index, stream)
    buf = _blob_scratch.get(key)
    if buf is None or buf.numel() < words:
        buf = torch.zeros(max(words, 1024), dtype=torch.int32, device=device)
        _blob_scratch[key] = buf
    return buf


def _launch_blob_stats(lib, lab, pr, rt, scratch, out):
    """The bare kernel launch on int32/f32 contiguous tensors, a zeroed
    scratch of 1 + 6·B·K int32 words and an f32 [6, B, K] output. The
    background label is H·W, as the connected components leave it."""
    b, h, w = lab.shape
    _check(
        lib.blob_stats_launch(
            lab.data_ptr(), pr.data_ptr(), rt.data_ptr(), b, h, w, rt.shape[1],
            h * w, scratch.data_ptr(), out.data_ptr(), _stream(),
        ),
        "blob_stats",
    )


def blob_stats(labels: torch.Tensor, prob: torch.Tensor, roots: torch.Tensor):
    """Blob stats of a batch of label maps: the kernel for CUDA tensors,
    :func:`blob_stats_plain` for CPU tensors. Same outputs as the plain
    version (views of one [6, B, K] allocation); psum agrees to rtol 1e-5
    (float atomics sum in any order). For int32/f32 contiguous inputs the
    kernel is the only work queued on the device."""
    if labels.dim() != 3 or prob.shape != labels.shape or roots.dim() != 2:
        raise ValueError(
            f"blob_stats wants labels/prob [B, H, W] and roots [B, K], got "
            f"{tuple(labels.shape)}, {tuple(prob.shape)}, {tuple(roots.shape)}"
        )
    if roots.shape[0] != labels.shape[0]:
        raise ValueError("blob_stats: labels and roots differ in batch size")
    devices = {labels.device.type, prob.device.type, roots.device.type}
    if devices == {"cpu"}:
        return blob_stats_plain(labels, prob, roots)
    if devices != {"cuda"}:
        raise ValueError(f"blob_stats: tensors on {sorted(devices)}")
    lib = load_library()
    b, k = roots.shape
    lab = labels.to(torch.int32).contiguous()
    pr = prob.float().contiguous()
    rt = roots.to(torch.int32).contiguous()
    out = torch.empty((6, b, k), dtype=torch.float32, device=lab.device)
    if b * k > 0:
        scratch = _scratch_for(lab.device, _stream(), 1 + BLOB_ACC_WORDS * b * k)
        _launch_blob_stats(lib, lab, pr, rt, scratch, out)
        blob_stats.launches += 1
    return tuple(out.unbind(0))


blob_stats.launches = 0


def reset_launch_counts():
    ctc_topk.launches = 0
    blob_stats.launches = 0


def launch_counts() -> dict:
    return {"ctc_topk": ctc_topk.launches, "blob_stats": blob_stats.launches}
