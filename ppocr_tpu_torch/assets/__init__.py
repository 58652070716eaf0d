"""Committed inputs and goldens of the port's parity checks.

``scenes.npz`` holds text scenes rendered by the JAX package's
``text_scene_dataset("jumbo", ...)`` (``parity``: 192×192 scenes,
``serving``: 768×1024 scenes), so no renderer is needed where the port
runs. ``goldens.json`` holds the configs they are served with and the
JAX package's f32 fused responses (words: text, confidence, box) for
each: the base configs, ``small`` with each of ``OPTIONS`` changed, and
the staged configs (``small-staged``, ``small-staged+cls``,
``serving-staged``: ``fast_path`` off, the JAX package's cv2 postprocess).
``tests/test_torch_goldens.py --write`` regenerates both.

``jpeg_cases.npz`` holds image payloads beside cv2's own decode of each,
or a flag where cv2 returns ``None``, for the places that have no cv2 to
make or decode them: JPEGs written by cv2 (the two serving scenes, one
of them also progressive, crops of their golden words with the golden
texts, and the sampling, restart, size and EXIF-orientation cases),
progressive, CMYK / YCCK and arithmetic-coded JPEGs, Adam7 PNGs, and
cut and garbled JPEGs. ``tests/test_torch_jpeg.py --write`` regenerates
it.

``image_cases.npz`` holds, in the same layout, the BMP (every depth,
compression and header kind, garbled and cut files), PPM/PGM/PBM/PAM,
Sun raster and damaged-zlib PNG payloads, and the first serving scene as
a 24-bit BMP, an RLE8 BMP of its grey, a binary PPM and a standard and a
byte-encoded Sun raster (the smoke run's timing inputs).
``tests/test_torch_image_formats.py --write`` regenerates it.

``visualize_mask.npz`` holds the pixels ``cv2.polylines`` draws for the
golden words of the first serving scene (one bit a pixel), rewritten by
``tests/test_torch_visualize.py --write``; ``host_cases.npz`` holds small
inputs of the host utilities (table and PicoDet decode, table resize and
pad, the normalizers, the DB helpers) beside the JAX package's answers,
rewritten by ``tests/test_torch_structure.py --write``.

``glyph_atlas.npz`` holds what Pillow reads from the six DejaVu faces to
draw the synthetic training text (glyph masks, control boxes, advances,
cmaps and the HarfBuzz lookups that act on the jumbo characters), made
where Pillow, fontTools and the fonts are by ``python
scripts/make_glyph_atlas_torch.py``; ``synthetic_digest.json`` holds the
texts, boxes and pixel hashes of scenes the JAX package renders and the
hashes of rotated rec batches it makes (and of its cv2-font digit
datasets), rewritten by ``python tests/test_torch_synthetic.py --write``; ``jumbo_banner.npz`` holds the
jumbo gate's wide banner as Pillow draws it, rewritten by ``python
tests/test_torch_e2e_jumbo.py --write``.

``cv2_text.npz`` holds what cv2 5.0's ``putText`` draws its upright
Hershey fonts from: the cmap of the upright face cv2 embeds, "Rubik for
OpenCV Light" (Rubik, SIL Open Font License 1.1, as cv2 5.0 carries it
in its library), and at each weight those fonts select (400, 600, 800)
every glyph's outline with TrueType variations applied as cv2 applies
them (stb_truetype's vertex list), its box and its advance. It is made
where cv2 is by ``python scripts/make_cv2_text_assets_torch.py``, which
holds the port's drawing to cv2 before it writes.

``digits_words.json`` holds the words the JAX package's ``OCRWorker``
reads from the digits gate's 12 scenes (``train.eval_digits``) on the
staged and the fused path, from the "digits bundle"
(``make_digits_model_dir``: ``weights/det_synthetic_digits.npz``,
``weights/rec_scene_digits.npz`` and a placeholder keys file), rewritten
by ``python tests/test_torch_e2e_digits.py --write``.

The "jumbo bundle" is the repo's self-contained trained model set:
``weights/det_synthetic_text.npz``, ``weights/rec_scene_jumbo.npz`` (a
5,008-way head) and ``weights/jumbo_keys.txt``. It has no orientation
classifier; the checks that need one use ``init_cls_params(CLS_SEED)``, an
untrained net. Such a net's two probabilities sit near 0.5 on most seeds;
seed 4 was picked because they are at least 0.2 apart on every crop of the
committed parity scenes. It calls every crop rotated (label 1), so every
crop takes the mirrored sampling grid.
"""

from __future__ import annotations

import hashlib
import json
import shutil
from pathlib import Path

import numpy as np

from ..models.cls_mv3 import init_cls_params
from ..utils.checkpoint import save_params_npz

ASSETS = Path(__file__).resolve().parent
SCENES = ASSETS / "scenes.npz"
GOLDENS = ASSETS / "goldens.json"
JPEG_CASES = ASSETS / "jpeg_cases.npz"
IMAGE_CASES = ASSETS / "image_cases.npz"
VISUALIZE_MASK = ASSETS / "visualize_mask.npz"
HOST_CASES = ASSETS / "host_cases.npz"
GLYPH_ATLAS = ASSETS / "glyph_atlas.npz"
SYNTHETIC_DIGEST = ASSETS / "synthetic_digest.json"
JUMBO_BANNER = ASSETS / "jumbo_banner.npz"
CV2_TEXT = ASSETS / "cv2_text.npz"
DIGITS_WORDS = ASSETS / "digits_words.json"
WEIGHTS = ASSETS.parent.parent / "weights"
JUMBO_BUNDLE = {
    "det/weights.npz": WEIGHTS / "det_synthetic_text.npz",
    "rec/weights.npz": WEIGHTS / "rec_scene_jumbo.npz",
    "rec/ppocr_keys_v1.txt": WEIGHTS / "jumbo_keys.txt",
}
DIGITS_BUNDLE = {
    "det/weights.npz": WEIGHTS / "det_synthetic_digits.npz",
    "rec/weights.npz": WEIGHTS / "rec_scene_digits.npz",
}
CLS_SEED = 4  # seed of the stand-in classifier of the ``enable_cls`` checks
# the fused path's options; goldens.json holds a config "small+<option>" each
OPTIONS = ("cls", "dilation", "rotated", "srcx2", "beam")


def apply_option(cfg, name: str):
    """``cfg`` (a ``PipelineConfig`` of this package or of the JAX one: the
    fields are the same) with the one option ``name`` changed."""
    if name == "cls":
        cfg.enable_cls = True
    elif name == "dilation":
        cfg.det.use_dilation = True
    elif name == "rotated":
        cfg.fused_rotated_boxes = True
    elif name == "srcx2":
        cfg.fused_crop_src_mult = 2
    elif name == "beam":
        cfg.rec.decode = "beam"
    else:
        raise ValueError(f"unknown option {name!r}; one of {OPTIONS}")
    return cfg


def make_jumbo_model_dir(dst, cls_seed=None) -> Path:
    """Lay the jumbo bundle out as a model dir under ``dst``; with
    ``cls_seed`` also ``cls/weights.npz`` from ``init_cls_params(cls_seed)``."""
    dst = Path(dst)
    for rel, src in JUMBO_BUNDLE.items():
        (dst / rel).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(src, dst / rel)
    if cls_seed is not None:
        save_params_npz(str(dst / "cls" / "weights.npz"), init_cls_params(cls_seed))
    return dst


def make_digits_model_dir(dst) -> Path:
    """Lay the digits bundle out as a model dir under ``dst``, its keys
    file ``train.eval_digits.placeholder_keys()`` (the reference charset's
    line count, not its characters)."""
    from ..train.eval_digits import placeholder_keys

    dst = Path(dst)
    for rel, src in DIGITS_BUNDLE.items():
        (dst / rel).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(src, dst / rel)
    (dst / "rec" / "ppocr_keys_v1.txt").write_text("\n".join(placeholder_keys()) + "\n", encoding="utf-8")
    return dst


def load_digits_words() -> dict:
    """``digits_words.json``: {"staged": [...], "fused": [...]}, a scene's
    placed lines and the JAX package's words each, and the gate's seed and
    scene count."""
    return json.loads(DIGITS_WORDS.read_text(encoding="utf-8"))


def load_scenes() -> dict:
    """{"parity": [N, 192, 192, 3] uint8, "serving": [M, 768, 1024, 3]
    uint8, plus their seeds}."""
    with np.load(SCENES) as data:
        return {k: data[k] for k in data.files}


def load_goldens() -> dict:
    return json.loads(GOLDENS.read_text(encoding="utf-8"))


def load_jpeg_cases():
    """({case name: (payload bytes, cv2's [H, W, 3] BGR decode, or None
    where cv2 returns None)}, the golden texts of the crops ``crop0``,
    ``crop1``, ... in order)."""
    with np.load(JPEG_CASES) as data:
        def decode_of(n):  # a case may share another's decode ("same_as")
            if f"{n}/none" in data.files:
                return None
            return data[f"{data[f'{n}/same_as']}/cv2" if f"{n}/same_as" in data.files else f"{n}/cv2"]

        names = sorted({k.rsplit("/", 1)[0] for k in data.files if k.endswith("/bytes")})
        cases = {n: (data[f"{n}/bytes"].tobytes(), decode_of(n)) for n in names}
        texts = [str(t) for t in data["crop_texts"]]
    return cases, texts


def load_image_cases() -> dict:
    """{case name: (payload bytes, cv2's [H, W, 3] BGR decode ([H, W] for
    a grey PFM), or None where cv2 returns None)} of ``image_cases.npz``."""
    with np.load(IMAGE_CASES) as data:
        def decode_of(n):  # a case may share another's decode ("same_as")
            if f"{n}/none" in data.files:
                return None
            return data[f"{data[f'{n}/same_as']}/cv2" if f"{n}/same_as" in data.files else f"{n}/cv2"]

        names = sorted({k.rsplit("/", 1)[0] for k in data.files if k.endswith("/bytes")})
        return {n: (data[f"{n}/bytes"].tobytes(), decode_of(n)) for n in names}


def load_visualize_mask() -> np.ndarray:
    """[H, W] bool: where ``cv2.polylines`` draws the first serving scene's
    golden words (``visualize_boxes``' colour and thickness)."""
    with np.load(VISUALIZE_MASK) as data:
        h, w = (int(v) for v in data["shape"])
        return np.unpackbits(data["bits"], count=h * w).reshape(h, w).astype(bool)


def load_host_cases() -> dict:
    """{name: array} of ``host_cases.npz``; ``"answers"`` is the JAX
    package's answers as a JSON string."""
    with np.load(HOST_CASES) as data:
        return {k: data[k] for k in data.files}


def load_glyph_atlas():
    """(meta dict, {name: array}) of ``glyph_atlas.npz``: the DejaVu glyph
    masks and layout tables ``train.text_render`` draws from."""
    with np.load(GLYPH_ATLAS) as data:
        meta = json.loads(data["meta"].tobytes().decode("utf-8"))
        return meta, {k: data[k] for k in data.files if k != "meta"}


def load_synthetic_digest() -> dict:
    """``synthetic_digest.json``: the 16 jumbo scenes (each one's seed,
    index, placed (text, box) list and the sha256 of its pixels as the JAX
    package renders them) under "scenes", under "rotated_batches" the
    ``rec_batch_sha256`` of the first rotated ``SceneCropRecDataset``
    batches it makes (the dataset's arguments beside them), and under
    "cv2" the same for the cv2 Hershey-font datasets: 16 digit
    ``SyntheticSceneDataset`` scenes, 2 ``SyntheticRecDataset`` batches
    and 2 digit ``SceneCropRecDataset`` batches."""
    return json.loads(SYNTHETIC_DIGEST.read_text(encoding="utf-8"))


def load_jumbo_banner() -> np.ndarray:
    """The jumbo gate's wide banner (``train.eval_jumbo.BANNER_TEXT`` at
    56 px, as Pillow draws it): [H, W, 3] uint8."""
    with np.load(JUMBO_BANNER) as data:
        return data["banner"]


def load_cv2_text():
    """(meta dict, {name: array}) of ``cv2_text.npz``: upright Rubik's cmap
    and per-weight glyph tables ``train.cv2_text`` draws from."""
    with np.load(CV2_TEXT) as data:
        meta = json.loads(data["meta"].tobytes().decode("utf-8"))
        return meta, {k: data[k] for k in data.files if k != "meta"}


def rec_batch_sha256(batch: dict, texts) -> str:
    """sha256 of a rec training batch: its uint8 images, int32 labels,
    f32 label paddings and its texts, in that order."""
    h = hashlib.sha256()
    for key, dtype in (("images", np.uint8), ("labels", np.int32), ("label_paddings", np.float32)):
        h.update(np.ascontiguousarray(batch[key], dtype).tobytes())
    h.update("\n".join(texts).encode("utf-8"))
    return h.hexdigest()


def match_staged_words(got, want, box_tol: int = 2):
    """Pair the words of two staged responses by their boxes.

    The staged path's contours come from the C++ core here and from cv2 in
    the JAX package, so a box whose score sits on ``box_thresh`` may be in
    one response and not in the other, and corners may differ by a pixel
    or two. Each ``want`` word takes the first unused ``got`` word whose
    every corner coordinate is within ``box_tol`` px. Returns (pairs of
    (got word, want word), unmatched got words, unmatched want words)."""
    free = list(got)
    pairs, missing = [], []
    for w in want:
        wbox = np.asarray(w["box"])
        hit = next(
            (g for g in free if np.abs(np.asarray(g["box"]) - wbox).max() <= box_tol), None
        )
        if hit is None:
            missing.append(w)
        else:
            free.remove(hit)
            pairs.append((hit, w))
    return pairs, free, missing
