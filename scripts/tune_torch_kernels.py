"""Time variants of the ``ctc_topk`` CUDA kernel against each other on one card.

    python3 scripts/tune_torch_kernels.py [--threads 128 256 512] [--unroll 4 8]
                                          [--load __ldg __ldcs]

Builds ``ppocr_tpu_torch/csrc/ctc_topk.cu`` once per (threads per row,
16-byte loads in flight per thread, load instruction) triple, with
``-DCTC_THREADS``, ``-DCTC_UNROLL`` and ``-DCTC_LOAD``, checks each build against the plain version, and times it
at the serving shapes with ``chip_smoke.cuda_ms`` (CUDA events, median of
25, L2 flushed for ``cold_ms`` and not for ``warm_ms``). The variants are
timed in turns, forwards then backwards, and both readings are printed, so
that drift of the card shows. One JSON line per variant and shape, with the
card's name and power limit. Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from chip_smoke import bound_ms, card_line, cuda_ms  # noqa: E402
from ppocr_tpu_torch.ops import kernels as K  # noqa: E402

SHAPES = ((16, 32, 5008), (32, 64, 5008), (32, 48, 6625))


def build_variant(out_dir: str, threads: int, unroll: int, load: str) -> ctypes.CDLL:
    lib = pathlib.Path(out_dir) / f"ctc_topk_{threads}_{unroll}_{load}.so"
    cmd = [K._nvcc(), *K.NVCC_FLAGS, f"-DCTC_THREADS={threads}", f"-DCTC_UNROLL={unroll}",
           f"-DCTC_LOAD={load}", "-shared", "-o", str(lib), str(K.CSRC / "ctc_topk.cu")]
    done = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if done.returncode:
        raise RuntimeError(f"nvcc failed:\n{done.stdout}")
    for line in done.stdout.splitlines():
        if "registers" in line:
            print(f"  ptxas {threads}x{unroll} {load}:", line.strip())
    handle = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    handle.ctc_topk_launch.argtypes = [p, i, i, p, p, p]
    handle.ctc_topk_launch.restype = i
    return handle


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--threads", type=int, nargs="+", default=[128, 256, 512])
    ap.add_argument("--unroll", type=int, nargs="+", default=[4, 8])
    ap.add_argument("--load", nargs="+", default=["__ldg"], choices=["__ldg", "__ldcs", "__ldcg"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tune_torch_kernels: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device="cpu").manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        variants = {(t, u, ld): build_variant(tmp, t, u, ld)
                    for t in args.threads for u in args.unroll for ld in args.load}
        for shape in SHAPES:
            p = torch.rand(shape, generator=gen).to(dev)
            want_idx, want_val = K.ctc_topk_plain(p)
            idx, val = torch.empty_like(want_idx), torch.empty_like(want_val)
            order = list(variants) + list(variants)[::-1]
            cold, warm = {}, {}
            for key in order:
                lib = variants[key]
                idx.fill_(-1)
                K._launch_ctc_topk(lib, p, idx, val)
                torch.cuda.synchronize()
                if not (torch.equal(idx, want_idx) and torch.equal(val, want_val)):
                    raise AssertionError(f"variant {key} differs from the plain version at {shape}")
                cold.setdefault(key, []).append(cuda_ms(lambda: K._launch_ctc_topk(lib, p, idx, val), flush))
                warm.setdefault(key, []).append(cuda_ms(lambda: K._launch_ctc_topk(lib, p, idx, val), None))
            rows, v = shape[0] * shape[1], shape[2]
            for key in variants:
                print(json.dumps({
                    "kernel": "ctc_topk", "threads": key[0], "unroll": key[1], "load": key[2], "shape": list(shape),
                    "cold_ms": cold[key], "warm_ms": warm[key],
                    "bound_ms": bound_ms(rows * v * 4 + rows * 8, rows * v)[0], "card": card_line(),
                }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
