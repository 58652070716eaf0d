"""Device meshes, batch sharding and the data-parallel rec step.

Counterpart of ``ppocr_tpu/parallel/mesh.py``. A JAX mesh is a grid of
devices that one GSPMD program runs over; here a :class:`DeviceMesh` is the
same ``("data", "model")`` grid of ``torch.device``\\ s, and a sharded step
is a batch split over its data rows, each shard run on its device, one host
thread per distinct device (:class:`DeviceThreads`). A device may repeat in
the grid: ``make_mesh(devices=["cpu"] * 8)`` is the counterpart of the
test suite's 8 virtual CPU devices, and ``["cuda:0", "cuda:0"]`` two shards
on one card.
"""

from __future__ import annotations

import contextlib
import copy
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.rec_svtr import rec_forward
from ..ops.ctc import ctc_topk_device
from .tensor_parallel import split_rec


def as_device(d) -> torch.device:
    """``d`` as a ``torch.device``; a CUDA device without an index is card 0."""
    dev = torch.device(d)
    return torch.device("cuda", 0) if dev.type == "cuda" and dev.index is None else dev


@dataclass(frozen=True)
class DeviceMesh:
    """A ``[data, model]`` grid of devices."""

    grid: Tuple[Tuple[torch.device, ...], ...]
    axis_names: Tuple[str, str] = ("data", "model")

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": len(self.grid), "model": len(self.grid[0])}

    @property
    def devices(self) -> List[torch.device]:
        """Every device of the grid, flat in grid order (repeats kept)."""
        return [d for row in self.grid for d in row]

    @property
    def data_devices(self) -> List[torch.device]:
        """The device of each data shard: the first of its grid row."""
        return [row[0] for row in self.grid]

    @property
    def distinct_devices(self) -> List[torch.device]:
        return list(dict.fromkeys(self.devices))


def make_mesh(
    n_devices: Optional[int] = None,
    data: Optional[int] = None,
    model: int = 1,
    devices: Optional[Sequence] = None,
) -> DeviceMesh:
    """A ``("data", "model")`` mesh over the first ``n_devices`` of
    ``devices`` (default: every visible CUDA device; raises when there is
    none, so that a mesh never lands on the CPU by itself). ``data``
    defaults to n // model; an explicit smaller ``data`` takes the first
    data·model devices."""
    if devices is None:
        n_cuda = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n_cuda == 0:
            raise RuntimeError(
                "no CUDA device is visible for a mesh; pass devices=['cpu'] * n "
                "for a mesh on the CPU"
            )
        devs = [torch.device("cuda", i) for i in range(n_cuda)]
    else:
        devs = [as_device(d) for d in devices]
    if n_devices is not None:
        devs = devs[:n_devices]
    n = len(devs)
    if data is None:
        if n % model != 0:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    elif data * model > n:
        raise ValueError(
            f"data={data} × model={model} needs {data * model} devices, have {n}"
        )
    if data < 1:
        raise ValueError(f"a mesh needs at least one device, have {n}")
    grid = tuple(tuple(devs[i * model : (i + 1) * model]) for i in range(data))
    return DeviceMesh(grid)


def device_scope(device: torch.device):
    """``device`` as the calling thread's current CUDA device (a no-op for
    the CPU). The current device and stream are per thread."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _run_jobs(dev: torch.device, items, grad: bool) -> list:
    """``items`` [(i, fn)] in order, with ``dev`` current and under
    ``torch.inference_mode``, or with autograd on where ``grad`` (all three
    are per thread; a tensor made under inference mode cannot enter a
    backward pass)."""
    with device_scope(dev), (torch.enable_grad() if grad else torch.inference_mode()):
        return [(i, fn()) for i, fn in items]


class DeviceThreads:
    """One long-lived host thread per device, for steps that run on several
    devices at once. A step on one device waits for that device several
    times (the connected-components loop, the tier read), so one host
    thread looping over the devices would serialise them. PyTorch keeps
    state per thread (the current device and stream, inference mode, the
    cuDNN and cuBLAS handles and their caches of execution plans), so a
    thread started per step would build that state again at every step:
    these threads live as long as their owner."""

    def __init__(self):
        self._pools: Dict[torch.device, ThreadPoolExecutor] = {}
        self._lock = threading.Lock()

    def _pool(self, dev: torch.device) -> ThreadPoolExecutor:
        with self._lock:
            if dev not in self._pools:
                self._pools[dev] = ThreadPoolExecutor(1, thread_name_prefix=f"ocr-{dev}")
            return self._pools[dev]

    def run(self, jobs: Sequence[Tuple[torch.device, Callable]], grad: bool = False) -> list:
        """Run each ``(device, fn)`` job and return the results in job
        order: the jobs of one device in order on that device's thread.
        With a single distinct device they run on the calling thread. The
        jobs run under inference mode, or with autograd on where ``grad``
        (a train step's forwards). The first error is raised after every
        device's jobs have ended."""
        by_dev: Dict[torch.device, list] = {}
        for i, (dev, fn) in enumerate(jobs):
            by_dev.setdefault(dev, []).append((i, fn))
        if len(by_dev) == 1:
            done = [_run_jobs(*next(iter(by_dev.items())), grad)]
        else:
            futures = [self._pool(dev).submit(_run_jobs, dev, items, grad)
                       for dev, items in by_dev.items()]
            done, errors = [], []
            for f in futures:  # read every future: each holds its device's error
                try:
                    done.append(f.result())
                except Exception as e:
                    errors.append(e)
            if errors:
                raise errors[0]
        results: list = [None] * len(jobs)
        for part in done:
            for i, r in part:
                results[i] = r
        return results


def split_rows(mesh: DeviceMesh, batch) -> list:
    """A batch (numpy or tensor) split along its leading axis into one
    equal chunk per data row, where it stays; ``ValueError`` when it does
    not split."""
    n = mesh.shape["data"]
    if batch.shape[0] % n:
        raise ValueError(f"a batch of {batch.shape[0]} does not split over data={n}")
    step = batch.shape[0] // n
    return [batch[i * step : (i + 1) * step] for i in range(n)]


def shard_batch(mesh: DeviceMesh, batch) -> List[torch.Tensor]:
    """A host (numpy) or device batch split along its leading axis over
    "data": one chunk per data shard, each on its shard's device."""
    x = torch.as_tensor(batch) if isinstance(batch, np.ndarray) else batch
    return [c.to(d) for c, d in zip(split_rows(mesh, x), mesh.data_devices)]


def replicate(module: torch.nn.Module, device: torch.device) -> torch.nn.Module:
    """``module`` itself when its parameters are on ``device``, else a copy
    there (``Module.to`` moves in place, so it copies first)."""
    if next(module.parameters()).device == device:
        return module
    return copy.deepcopy(module).to(device)


def shard_rec_params(mesh: DeviceMesh, model: torch.nn.Module) -> dict:
    """The recognizer placed on the mesh. With a "model" axis of 1, one
    replica per distinct device, keyed by device. Wider, one recognizer
    per distinct grid row whose SVTR blocks are split over that row's
    devices (``tensor_parallel.split_rec``; the JAX package's
    ``param_shardings`` layout), keyed by the row."""
    if mesh.shape["model"] > 1:
        return {row: split_rec(model, row) for row in dict.fromkeys(mesh.grid)}
    return {dev: replicate(model, dev) for dev in mesh.distinct_devices}


def sharded_rec_infer(mesh: DeviceMesh):
    """The data-parallel rec step: ``run(model, x)`` splits the normalized
    [N, H, W, 3] float input ``x`` over "data", runs ``rec_forward`` and the
    CTC top-k (the ``ctc_topk`` kernel on a card) on each shard on its
    row's first device, and returns (idx [N, T] int32, val [N, T] f32)
    concatenated on the mesh's first device. ``model`` is the recognizer,
    or what :func:`shard_rec_params` made of it; with a "model" axis wider
    than 1 each shard's SVTR blocks run split over its row's devices."""

    threads = DeviceThreads()
    split = mesh.shape["model"] > 1

    def run(model, x):
        replicas = model if isinstance(model, dict) else shard_rec_params(mesh, model)
        shards = shard_batch(mesh, x)

        def one(row, xs):
            rec = replicas[row if split else row[0]]
            return lambda: ctc_topk_device(rec_forward(rec, xs))

        outs = threads.run([(row[0], one(row, xs)) for row, xs in zip(mesh.grid, shards)])
        first = mesh.devices[0]
        idx = torch.cat([o[0].to(first) for o in outs])
        val = torch.cat([o[1].to(first) for o in outs])
        return idx, val

    return run
