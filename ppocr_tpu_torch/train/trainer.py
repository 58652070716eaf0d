"""Train steps of the recognizer (CTC) and the detector (balanced BCE).

Counterpart of ``ppocr_tpu/train/trainer.py`` on one device. Both steps
are plain PyTorch: the forward of the port's module, the loss, autograd,
then ``torch.optim.AdamW`` with the settings of the JAX package's
``optax.adamw(learning_rate)``:

* b1 0.9, b2 0.999, eps 1e-8, weight decay **1e-4** (torch's default is
  0.01) on every parameter, BN's mean and var and ``Lab``'s scalars
  included, as optax decays every leaf of the pytree (``set_trainable``);
* a ``learning_rate`` that is a float or a function of the 0-based count
  of updates already made, called before each update as optax calls its
  schedule (a ``torch.optim.lr_scheduler`` would step after it).

The CTC loss is optax's: the batch mean of per-sequence negative log
likelihoods over all T frames (``F.ctc_loss(reduction="mean")`` would
divide each by its label length first). Where a label cannot be aligned
in T frames (more labels plus blanks between repeats than frames) optax
stays finite through its ``log_epsilon = -1e5`` and torch's loss is
``inf``; such rows go through a copy of optax's log-semiring forward
recursion, the others through ``F.ctc_loss``, so the value and gradient
are optax's on every row.

A step takes the numpy batch, moves it to the device from pinned memory
without a sync, and returns the loss as a device tensor: the host waits
for the card only where it reads the loss.

Over a mesh (``mesh=``, a ``parallel.DeviceMesh``) one process drives
every device, as the JAX package's single controller does. The global
batch is split over the data rows, the labels on the host; each row runs
its forward on its own copy of the model (``parallel.MeshReplicas``: for
the recognizer, SVTR blocks split over the row's devices as the JAX
package's ``param_shardings`` lays them out; the detector whole, its
model axis unused as in JAX). The global loss is formed on the mesh's
first device from the rows' partial sums (the per-sequence CTC sum over
the global N; the detector's four sums, so that each side of the
balanced BCE is normalised over the whole batch as in JAX, and not per
row), one backward pass follows the copies across devices, each
parameter's gradient is summed over the rows and handed to every copy,
and every copy makes the same AdamW update.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.det_db import DetDB, det_forward
from ..models.jax_params import det_from_jax, rec_from_jax
from ..models.layers import set_trainable
from ..models.rec_svtr import RecSVTR, rec_forward_logits
from ..parallel.mesh import DeviceThreads, split_rows
from ..parallel.tensor_parallel import MeshReplicas
from ..pipeline.engine import resolve_device

LOG_EPSILON = -1e5  # optax.ctc_loss's stand-in for log(0)
ADAMW = dict(betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)  # optax.adamw's defaults

Schedule = Union[float, Callable[[int], float]]


class TrainState(NamedTuple):
    """The module (its parameters are the trained leaves; on a mesh the
    :class:`MeshReplicas`), its optimizer, and the number of updates made
    (the schedule's count)."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Callable[[int], float]:
    """``optax.cosine_decay_schedule`` (exponent 1) in float64: the rate
    after ``count`` updates decays from ``init_value`` to ``alpha ·
    init_value`` over ``decay_steps`` and stays there."""
    if not decay_steps > 0:
        raise ValueError(f"cosine_decay_schedule needs decay_steps > 0, got {decay_steps}")

    def schedule(count: int) -> float:
        c = min(float(count), float(decay_steps))
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / decay_steps))
        return init_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


def _upload(x, device: torch.device) -> torch.Tensor:
    """numpy or CPU tensor → ``device``; to the card through pinned memory
    and without waiting for it."""
    t = torch.as_tensor(x)
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def normalize_rec_images(images: torch.Tensor) -> torch.Tensor:
    """uint8 HWC crops → the rec normalization ``(x/255 − 0.5)·2`` in f32,
    on the device; f32 input passes through (callers that normalized on
    the host). A uint8 batch moves a quarter of the bytes."""
    if images.dtype == torch.uint8:
        return (images.float() / 255.0 - 0.5) * 2.0
    return images


def _min_frames(labels: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """The fewest frames a CTC alignment of each label needs: one per
    label plus one blank between equal neighbours."""
    n = labels.shape[1]
    same = labels[:, 1:] == labels[:, :-1]
    inside = np.arange(1, n)[None, :] < lens[:, None]
    return lens + (same & inside).sum(axis=1)


def _ctc_log_semiring(logp: torch.Tensor, labels: torch.Tensor, repeat: torch.Tensor,
                      lens: torch.Tensor) -> torch.Tensor:
    """optax's ``ctc_loss_with_forward_probs`` with no frame padding: the
    forward recursion over blank (``phi``) and label (``emit``) states in
    log space, ``LOG_EPSILON`` for impossible transitions. ``logp`` [B, T,
    V] log-softmaxed, ``labels`` [B, N] int64, ``repeat`` [B, N] 1.0 where
    label n equals label n+1, ``lens`` [B] int64. Returns [B]."""
    b, t, _ = logp.shape
    n = labels.shape[1]
    emit_lp = torch.gather(logp, 2, labels[:, None, :].expand(b, t, n)).transpose(0, 1)
    phi_lp = logp[:, :, :1].transpose(0, 1)  # [T, B, 1]
    phi = torch.full((b, n + 1), LOG_EPSILON, dtype=logp.dtype, device=logp.device)
    phi[:, 0] = 0.0
    emit = torch.full((b, n), LOG_EPSILON, dtype=logp.dtype, device=logp.device)

    def add_phi(p, score):  # p[:, 1:] ⊕= score in log space
        return torch.cat([p[:, :1], torch.logaddexp(p[:, 1:], score)], dim=1)

    for step in range(t):
        prev_phi = add_phi(phi, emit + LOG_EPSILON * repeat)
        next_emit = torch.logaddexp(prev_phi[:, :-1] + emit_lp[step], emit + emit_lp[step])
        next_phi = add_phi(prev_phi + phi_lp[step],
                           emit + phi_lp[step] + LOG_EPSILON * (1.0 - repeat))
        phi, emit = next_phi, next_emit
    last = add_phi(phi, emit)
    return -last.gather(1, lens[:, None])[:, 0]


def ctc_loss(logits: torch.Tensor, labels, label_paddings) -> torch.Tensor:
    """Per-sequence CTC loss as ``optax.ctc_loss`` gives it (every frame
    valid, blank 0): [B, T, V] logits, ``labels`` [B, N] int and
    ``label_paddings`` [B, N] (1.0 = padding, right-padded) on the host.
    Returns [B] on the logits' device."""
    labels = np.asarray(labels).astype(np.int64)
    pads = np.asarray(label_paddings)
    b, t, _ = logits.shape
    n = labels.shape[1]
    dev = logits.device
    lens = (n - pads.sum(axis=1)).astype(np.int64)
    feasible = _min_frames(labels, lens) <= t
    logp = torch.log_softmax(logits.float(), dim=-1)
    parts, order = [], []
    rows = np.flatnonzero(feasible)
    if rows.size:
        sub = logp if rows.size == b else logp[_upload(rows, dev)]
        parts.append(F.ctc_loss(
            sub.transpose(0, 1), _upload(labels[rows], dev), [t] * rows.size,
            lens[rows].tolist(), blank=0, reduction="none", zero_infinity=False))
        order.append(rows)
    rows = np.flatnonzero(~feasible)
    if rows.size:
        repeat = np.zeros((rows.size, n), np.float32)
        repeat[:, :-1] = labels[rows, :-1] == labels[rows, 1:]
        parts.append(_ctc_log_semiring(
            logp[_upload(rows, dev)], _upload(labels[rows], dev), _upload(repeat, dev),
            _upload(lens[rows], dev)))
        order.append(rows)
    if len(parts) == 1:
        return parts[0]
    inverse = np.argsort(np.concatenate(order))
    return torch.cat(parts)[_upload(inverse, dev)]


def _ctc_per_seq(model: RecSVTR, batch: Dict) -> torch.Tensor:
    logits = rec_forward_logits(model, normalize_rec_images(batch["images"]))
    return ctc_loss(logits, batch["labels"], batch["label_paddings"])


def ctc_train_loss(model: RecSVTR, batch: Dict) -> torch.Tensor:
    """Mean CTC loss of a batch {images [N, H, W, 3] (uint8, or f32
    normalized) on the model's device, labels and label_paddings on the
    host}."""
    return _ctc_per_seq(model, batch).mean()


def _det_sums(model: DetDB, batch: Dict) -> torch.Tensor:
    """[Σ m·log p, Σ m, Σ (1−m)·log(1−p), Σ (1−m)] of a batch: what the
    balanced BCE needs, summable over shards of the batch."""
    prob = det_forward(model, batch["images"]).float()
    m = batch["masks"]
    eps = 1e-6
    p = prob.clamp(eps, 1.0 - eps)
    return torch.stack([(m * torch.log(p)).sum(), m.sum(),
                        ((1.0 - m) * torch.log(1.0 - p)).sum(), (1.0 - m).sum()])


def _det_bce(sums: torch.Tensor) -> torch.Tensor:
    pos = -sums[0] / torch.clamp(sums[1], min=1.0)
    neg = -sums[2] / torch.clamp(sums[3], min=1.0)
    return pos + neg


def det_train_loss(model: DetDB, batch: Dict) -> torch.Tensor:
    """Balanced BCE on the DB shrink mask, {images [N, H, W, 3]
    normalized, masks [N, H, W] in {0, 1}}: the positive and the negative
    pixels' mean BCE, each over its own count, summed."""
    return _det_bce(_det_sums(model, batch))


class MeshAdamW:
    """The optimizers of a mesh's copies of the model, one AdamW per data
    row, driven as one. ``state_dict`` and ``load_state_dict`` speak the
    layout of one AdamW over the whole model, as a one-device run saves
    it."""

    def __init__(self, replicas: MeshReplicas, make: Callable[[nn.Module], torch.optim.Optimizer]):
        self.replicas = replicas
        self.optimizers = [make(row) for row in replicas.rows]

    @property
    def param_groups(self) -> list:
        return [g for opt in self.optimizers for g in opt.param_groups]

    def zero_grad(self, set_to_none: bool = True) -> None:
        for opt in self.optimizers:
            opt.zero_grad(set_to_none=set_to_none)

    def step(self) -> None:
        for opt in self.optimizers:
            opt.step()

    def state_dict(self) -> Dict:
        return self.replicas.optimizer_state(self.optimizers)

    def load_state_dict(self, state_dict: Dict) -> None:
        self.replicas.load_optimizer_state(self.optimizers, state_dict)


def _make_step(device, learning_rate: Schedule, mesh, from_jax, loss_fn, on_device, mesh_loss):
    lr = learning_rate if callable(learning_rate) else (lambda count: learning_rate)
    if mesh is not None:
        if device is not None:
            raise ValueError("pass a device or a mesh, not both")
        return _make_mesh_step(mesh, lr, from_jax, on_device, *mesh_loss)
    dev = resolve_device(device)

    def make_optimizer(model: nn.Module) -> torch.optim.AdamW:
        return torch.optim.AdamW(model.parameters(), lr=lr(0), **ADAMW)

    def init_fn(params) -> TrainState:
        """A JAX-layout tree or a module → a state on the device, every
        parameter trainable."""
        model = params if isinstance(params, nn.Module) else from_jax(params)
        model = set_trainable(model.to(dev), True)
        return TrainState(model, make_optimizer(model), 0)

    def step_fn(state: TrainState, batch: Dict) -> Tuple[TrainState, torch.Tensor]:
        batch = {k: _upload(v, dev) if k in on_device else v for k, v in batch.items()}
        for group in state.optimizer.param_groups:
            group["lr"] = lr(state.step)
        state.optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(state.model, batch)
        loss.backward()
        state.optimizer.step()
        return TrainState(state.model, state.optimizer, state.step + 1), loss.detach()

    return make_optimizer, init_fn, step_fn


def _make_mesh_step(mesh, lr, from_jax, on_device, row_sums, finish, split):
    """The step over a mesh: ``row_sums(model, batch)`` is what each data
    row sums, ``finish(sums, n)`` the loss of the global batch of n from the
    rows' summed sums, ``split`` whether the copies split the SVTR blocks
    over the "model" axis."""
    threads = DeviceThreads()
    first = mesh.devices[0]

    def make_optimizer(replicas: MeshReplicas) -> MeshAdamW:
        return MeshAdamW(replicas, lambda row: torch.optim.AdamW(row.parameters(), lr=lr(0),
                                                                 **ADAMW))

    def init_fn(params) -> TrainState:
        """A JAX-layout tree or a module → one copy per data row of the
        mesh, every parameter trainable."""
        model = params if isinstance(params, nn.Module) else from_jax(params)
        replicas = MeshReplicas(model, mesh, split)
        for row in replicas.rows:
            set_trainable(row, True)
        return TrainState(replicas, make_optimizer(replicas), 0)

    def step_fn(state: TrainState, batch: Dict) -> Tuple[TrainState, torch.Tensor]:
        parts = {k: split_rows(mesh, v) for k, v in batch.items()}
        n = len(batch["images"])

        def job(r, row):
            def run():
                b = {k: _upload(v[r], row[0]) if k in on_device else v[r] for k, v in parts.items()}
                return row_sums(state.model.rows[r], b)
            return row[0], run

        sums = threads.run([job(r, row) for r, row in enumerate(mesh.grid)], grad=True)
        total = sums[0].to(first)
        for s in sums[1:]:
            total = total + s.to(first)
        loss = finish(total, n)
        for group in state.optimizer.param_groups:
            group["lr"] = lr(state.step)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.model.reduce_grads()
        state.optimizer.step()
        return TrainState(state.model, state.optimizer, state.step + 1), loss.detach()

    return make_optimizer, init_fn, step_fn


def make_train_step(device=None, learning_rate: Schedule = 1e-4, mesh=None):
    """Recognizer trainer: returns ``(make_optimizer, init_fn, step_fn)``.

    ``init_fn(params)`` puts a rec tree (JAX layout) or a ``RecSVTR`` on
    the device (default: the card; without one it raises) with its AdamW;
    ``step_fn(state, batch)`` makes one update from a numpy batch
    {images, labels, label_paddings} and returns (state, loss). With
    ``mesh`` (and no ``device``) the step is data parallel over its rows
    and tensor parallel over its "model" axis (module docstring)."""
    return _make_step(device, learning_rate, mesh, rec_from_jax, ctc_train_loss, ("images",),
                      (lambda model, b: _ctc_per_seq(model, b).sum(), lambda s, n: s / n, True))


def make_det_train_step(device=None, learning_rate: Schedule = 1e-3, mesh=None):
    """Detector trainer with :func:`make_train_step`'s contract; batches
    are {images [N, H, W, 3] normalized, masks [N, H, W]}. Over a mesh it
    is data parallel; the "model" axis carries nothing."""
    return _make_step(device, learning_rate, mesh, det_from_jax, det_train_loss,
                      ("images", "masks"), (_det_sums, lambda s, n: _det_bce(s), False))


class BatchPrefetcher:
    """Host-side batch producer thread: overlaps making the next numpy
    batch with the device step. Pure CPU work on the thread; device calls
    stay on the caller's thread."""

    def __init__(self, make_batch, depth: int = 4):
        import queue
        import threading

        self._q = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def produce():
            while not self._stop.is_set():
                try:
                    item = make_batch()
                except Exception as e:  # surface in next()
                    item = e
                self._q.put(item)
                if isinstance(item, Exception):
                    return

        self._t = threading.Thread(target=produce, daemon=True)
        self._t.start()

    def next(self):
        item = self._q.get()
        if isinstance(item, Exception):
            raise item
        return item

    def close(self):
        self._stop.set()
        # drain (unblocks a producer stuck in put) and join: callers touch
        # the shared dataset right after close(), so the producer must have
        # exited, not merely been signalled, before close() returns
        while self._t.is_alive():
            try:
                self._q.get_nowait()
            except Exception:
                pass
            self._t.join(timeout=0.05)


def run_steps(step_fn, state, make_batch, steps: int, *, on_batch=None, on_step=None):
    """``steps`` updates of ``step_fn`` on the batches ``make_batch()``
    makes on a :class:`BatchPrefetcher` thread while the device steps: the
    loop of the synthetic-data recipes. ``on_batch(step)`` runs once the
    step's batch is in hand, before the step is launched;
    ``on_step(step, state, loss)`` runs after ``step_fn`` returns (the loss
    still on the device). Returns the last state."""
    prefetch = BatchPrefetcher(make_batch)
    try:
        for step in range(1, steps + 1):
            batch = prefetch.next()
            if on_batch is not None:
                on_batch(step)
            state, loss = step_fn(state, batch)
            if on_step is not None:
                on_step(step, state, loss)
    finally:
        prefetch.close()
    return state
