"""Recognizer fine-tuning recipe, on one device or over a device mesh.

Counterpart of ``ppocr_tpu/train/finetune.py``: adapt the recognizer to a
custom font or charset from a directory of labeled crops.

* **data** — PaddleOCR ``rec_gt``-style label files
  (``relative/path.png\\ttext`` per line), crops read with
  ``utils.imcodec.read_image`` (PNG, BMP, JPEG, PPM/PGM/PBM/PAM, Sun
  raster, PFM, Radiance HDR and GIF with ``cv2.imread``'s answers, a grey
  PFM refused as imread refuses it; no cv2) and the
  serving-exact ``crnn_resize``; the same skip rules and the same numpy
  draws as the JAX package's dataset, so both make the same batches;
* **charset tools** — build/write charset files in the
  ``ppocr_keys_v1.txt`` convention (blank ``#`` at 0 and a trailing space
  are added by the loader);
* **head surgery** — a fresh 120→V CTC projection when the charset's
  width differs from the checkpoint's (the same draws as the JAX one);
* **train loop** — CTC with optax's cosine decay (alpha 0.02), train
  checkpoints under ``ckpts/step_N`` with rotation, and a serving bundle
  (``weights.npz`` in the JAX layout + ``ppocr_keys_v1.txt``) that either
  package's ``OCREngine`` loads as ``<model_dir>/rec/``.
"""

from __future__ import annotations

import os
import shutil
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..ops.resize import crnn_resize
from ..utils.imcodec import read_image


# -- charset tools ----------------------------------------------------------


def read_label_file(path: str) -> List[Tuple[str, str]]:
    """Parse a PaddleOCR-style rec label file: ``img_path<TAB>text``."""
    out = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            # strip \r too: a CRLF-authored file would otherwise leave a
            # trailing \r on every text
            line = line.rstrip("\r\n")
            if not line:
                continue
            img, _, text = line.partition("\t")
            if not _:
                raise ValueError(f"label line without TAB: {line!r}")
            out.append((img, text))
    return out


def build_charset(texts: Sequence[str]) -> List[str]:
    """Sorted unique characters of the corpus (excluding space, which the
    loader appends as the final class)."""
    chars = set()
    for t in texts:
        chars.update(t)
    chars.discard(" ")
    return sorted(chars)


def write_charset(path: str, chars: Sequence[str]) -> None:
    """Write a charset file in the ppocr_keys_v1.txt convention."""
    with open(path, "w", encoding="utf-8") as f:
        for c in chars:
            f.write(c + "\n")


def charset_classes(chars: Sequence[str]) -> List[str]:
    """Decode classes for a charset file body: blank + chars + space
    (mirrors ``pipeline.charset.load_charset``)."""
    return ["#"] + list(chars) + [" "]


def reinit_ctc_head(params: Dict, n_classes: int, seed: int = 0) -> Dict:
    """Replace the final 120→V CTC projection (head.fc) for a new charset;
    every other weight is kept (the transferable representation)."""
    import copy

    rng = np.random.default_rng(seed)
    params = copy.copy(params)
    params["head"] = copy.copy(params["head"])
    d = params["head"]["fc"]["w"].shape[0]
    params["head"]["fc"] = {
        "w": (rng.normal(0, d**-0.5, (d, n_classes))).astype(np.float32),
        "b": np.zeros((n_classes,), np.float32),
    }
    return params


# -- data -------------------------------------------------------------------


class FinetuneDataset:
    """In-memory labeled-crop dataset with serving-exact preprocessing."""

    def __init__(
        self,
        label_file: str,
        image_root: Optional[str] = None,
        classes: Optional[Sequence[str]] = None,
        img_h: int = 48,
        img_w: int = 320,
        max_len: Optional[int] = None,
        seed: int = 0,
    ):
        root = image_root or os.path.dirname(os.path.abspath(label_file))
        entries = read_label_file(label_file)
        if classes is None:
            classes = charset_classes(build_charset([t for _, t in entries]))
        self.classes = list(classes)
        self.char_to_idx = {c: i for i, c in enumerate(self.classes)}
        self.img_h, self.img_w = img_h, img_w
        self.max_len = max_len or max((len(t) for _, t in entries), default=1)
        self.rng = np.random.default_rng(seed)

        self.images: List[np.ndarray] = []
        self.texts: List[str] = []
        skipped = 0
        for rel, text in entries:
            # skip checks before the image is read: a skipped sample must
            # not abort the load on its missing image, and "#" is the blank
            # class at index 0 — a label holding it would encode as CTC
            # blank, so it is OOV unless the charset file itself defines a
            # '#' line (then the earliest match, a non-zero index, wins)
            oov = any(
                c not in self.char_to_idx or self.char_to_idx[c] == 0
                for c in text
            )
            if oov or len(text) > self.max_len:
                skipped += 1  # OOV chars / blank literal / over-long label
                continue
            p = rel if os.path.isabs(rel) else os.path.join(root, rel)
            img = read_image(p)
            if img is None:
                raise FileNotFoundError(f"cannot read crop {p}")
            self.images.append(crnn_resize(img, img_w / img_h, (3, img_h, img_w)))
            self.texts.append(text)
        self.skipped = skipped
        if not self.images:
            raise ValueError(f"no usable samples in {label_file}")

    def __len__(self) -> int:
        return len(self.images)

    def batch(self, batch_size: int) -> Dict[str, np.ndarray]:
        idx = self.rng.integers(0, len(self.images), size=batch_size)
        images = np.stack([self.images[i] for i in idx])
        x = (images.astype(np.float32) / 255.0 - 0.5) * 2.0
        labels = np.zeros((batch_size, self.max_len), np.int32)
        pad = np.ones((batch_size, self.max_len), np.float32)
        for row, i in enumerate(idx):
            for j, ch in enumerate(self.texts[i]):
                labels[row, j] = self.char_to_idx[ch]
                pad[row, j] = 0.0
        return {"images": x, "labels": labels, "label_paddings": pad}


# -- train loop -------------------------------------------------------------


def _rotate_checkpoints(ckpt_dir: str, keep: int) -> None:
    steps = []
    for d in os.listdir(ckpt_dir):
        if not d.startswith("step_"):
            continue
        suffix = d.split("_", 1)[1]
        if suffix.isdigit():
            steps.append(int(suffix))
        else:
            # temp dirs (step_N.tmp-PID) left by a killed run: remove them
            # instead of crashing every later rotation on int()
            shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)
    steps.sort()
    drop = steps if keep <= 0 else steps[:-keep]
    for s in drop:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"))


def finetune_rec(
    label_file: str,
    out_dir: str,
    image_root: Optional[str] = None,
    init_weights: Optional[str] = None,
    charset_file: Optional[str] = None,
    steps: int = 1000,
    batch_size: int = 32,
    learning_rate: float = 5e-4,
    img_h: int = 48,
    img_w: int = 320,
    mesh=None,
    ckpt_every: int = 0,
    ckpt_keep: int = 2,
    log_every: int = 100,
    seed: int = 0,
    device=None,
    on_step=None,
) -> str:
    """Fine-tune the recognizer on a labeled-crop directory; exports a
    serving bundle (weights.npz + ppocr_keys_v1.txt) under ``out_dir`` that
    drops into ``<model_dir>/rec/``. Returns the weights path.

    ``device``: default the card (raises without one). ``mesh``: a
    ``parallel.DeviceMesh`` to train over instead of one device (data
    parallel, tensor parallel over its "model" axis; ``batch_size`` must
    split over its data rows); the exported weights are the gathered whole
    model. ``on_step(step, loss)``, when given, is called after each
    update with the loss as a device tensor (for timing; reading it waits
    for the card)."""
    from ..models.jax_params import rec_to_jax
    from ..models.rec_svtr import init_rec_params
    from ..pipeline.charset import load_charset
    from ..utils.checkpoint import load_params_npz, save_params_npz, save_train_state
    from .trainer import cosine_decay_schedule, make_train_step

    # the recognizer's hard shape constraints (the neck pools to feature
    # height ≤ 3 and halves the width axis): fail before any work
    if img_h > 48:
        raise ValueError(
            f"img_h={img_h}: the recognizer supports heights ≤ 48 "
            "(feature height after the /16 backbone stride must be ≤ 3)"
        )
    if img_w % 8 != 0:
        raise ValueError(
            f"img_w={img_w}: must be a multiple of 8 (the neck halves the "
            "/4-strided width axis)"
        )

    if charset_file:
        classes = load_charset(charset_file)
        chars = classes[1:-1]
    else:
        classes = None
        chars = None

    ds = FinetuneDataset(
        label_file,
        image_root=image_root,
        classes=classes,
        img_h=img_h,
        img_w=img_w,
        seed=seed,
    )
    if chars is None:
        chars = ds.classes[1:-1]
    n_classes = len(ds.classes)
    if ds.skipped:
        # a restrictive charset can drop most of the corpus with training
        # still "succeeding": say so
        print(
            f"finetune: skipped {ds.skipped} of "
            f"{ds.skipped + len(ds)} samples (OOV/over-long labels); "
            f"training on {len(ds)}",
            flush=True,
        )

    params = load_params_npz(init_weights) if init_weights else init_rec_params(seed=seed)
    v_have = np.asarray(params["head"]["fc"]["b"]).shape[0]
    if v_have != n_classes:
        params = reinit_ctc_head(params, n_classes, seed=seed)

    schedule = cosine_decay_schedule(learning_rate, steps, alpha=0.02)
    _, init_fn, step_fn = make_train_step(device, learning_rate=schedule, mesh=mesh)
    state = init_fn(params)

    os.makedirs(out_dir, exist_ok=True)
    ckpt_dir = os.path.join(out_dir, "ckpts")
    for step in range(1, steps + 1):
        state, loss = step_fn(state, ds.batch(batch_size))
        if on_step is not None:
            on_step(step, loss)
        if log_every and (step % log_every == 0 or step == 1):
            print(f"finetune step {step:5d}  loss {float(loss):8.3f}", flush=True)
        if ckpt_every and step % ckpt_every == 0:
            os.makedirs(ckpt_dir, exist_ok=True)
            save_train_state(ckpt_dir, state, step=step)
            _rotate_checkpoints(ckpt_dir, ckpt_keep)

    weights_path = os.path.join(out_dir, "weights.npz")
    save_params_npz(weights_path, rec_to_jax(state.model))
    write_charset(os.path.join(out_dir, "ppocr_keys_v1.txt"), chars)
    return weights_path
