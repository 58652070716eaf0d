"""Synthetic text data for recognizer and detector training, drawn as the
JAX package draws it.

Counterpart of ``ppocr_tpu/train/synthetic.py``. The JAX package renders
with two backends, and the port has both: Pillow + TrueType (DejaVu) for
the ``ascii``, ``full`` and ``jumbo`` scene datasets, through
:class:`AtlasTextRenderer` (``train/text_render.py``: Pillow's boxes and
pixels from the committed glyph atlas), and cv2's Hershey fonts for
``render_line``, :class:`SyntheticRecDataset` and the digit scenes (a
:class:`SyntheticSceneDataset` without a renderer), through
``train/cv2_text.py``: cv2 5.0 draws those fonts as TrueType outlines of
the upright Rubik face it embeds, and the port replays that from the
committed ``assets/cv2_text.npz``. The same seeds give the same texts,
boxes, shrink masks and pixels on a machine without PIL, cv2 or
fontTools. A character upright Rubik does not map (the ``full``
alphabet's Greek, say) raises :class:`CV2FallbackFaceNotPorted`
(ROADMAP A17) before any draw from the seed.

Every random draw happens in the JAX package's order, from the same
``numpy.random.Generator`` calls, so a seeded stream is the JAX stream.
"""

from __future__ import annotations

import functools
import hashlib
import os
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..ops.geometry import get_rotation_matrix_2d, warp_affine
from ..ops.resize import crnn_resize, resize_bilinear_u8
from .cv2_text import (  # noqa: F401  (CV2FontsNotPorted: the refusals' base class)
    FONT_HERSHEY_COMPLEX,
    FONT_HERSHEY_DUPLEX,
    FONT_HERSHEY_SIMPLEX,
    LINE_AA,
    CV2FallbackFaceNotPorted,
    CV2FontsNotPorted,
    get_text_size,
    put_text,
    rubik_covers,
)
from .text_render import (  # noqa: F401  (PILTextRenderer: the JAX package's name)
    DEJAVU_DIR,
    DEJAVU_FONTS,
    AtlasTextRenderer,
    PILTextRenderer,
    draw_text,
    load_atlas,
)


# printable ASCII letters/digits/punctuation — every one of these is a
# class in the reference charset (ppocr_keys_v1.txt; space is appended as
# the final class by the dict loader, ocr_rec.h:82-84)
ASCII_ALPHABET = (
    "0123456789"
    "abcdefghijklmnopqrstuvwxyz"
    "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
    "!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~"
)


_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class ReferenceCharsetMissing(FileNotFoundError):
    """The ``ascii`` and ``full`` alphabets read the reference models'
    charset, which the caller names: the port has no fixed path for it."""

    def __init__(self, what: str):
        super().__init__(
            f"{what} reads the reference models' charset (ppocr_keys_v1.txt): pass its "
            "path (charset_file=..., or --charset-file in the training scripts)"
        )


@functools.lru_cache(maxsize=None)
def _font_charset(path: str) -> frozenset:
    """Codepoints a DejaVu face maps (its best cmap), from the atlas."""
    return frozenset(load_atlas().faces[os.path.basename(path)].cmap)


def dejavu_alphabet(
    charset_file: Optional[str] = None,
    ascii_only: bool = False,
) -> str:
    """Trainable alphabet = reference charset ∩ DejaVuSans coverage.

    ASCII (94 chars) plus — unless ``ascii_only`` — the non-ASCII charset
    entries DejaVuSans can draw (Greek, Cyrillic, Latin-1 accents, math and
    box symbols; ~124 chars), giving ~218 trainable classes scattered
    across the full 6,625-way head. ``charset_file`` is the reference
    charset's path; without it :class:`ReferenceCharsetMissing` is raised."""
    if not charset_file:
        raise ReferenceCharsetMissing("dejavu_alphabet")
    chars = [
        line.rstrip("\n")
        for line in open(charset_file, encoding="utf-8")
        if line.rstrip("\n")
    ]
    alphabet = [c for c in ASCII_ALPHABET if c in set(chars)]
    if not ascii_only:
        cov = _font_charset(os.path.join(DEJAVU_DIR, "DejaVuSans.ttf"))
        alphabet += [
            c
            for c in chars
            if len(c) == 1 and ord(c) > 127 and ord(c) in cov
        ]
    return "".join(alphabet)


# -- jumbo charset: reference-SCALE class counts from DejaVu coverage ------
#
# Every character the DejaVu faces can draw unambiguously: ~5,000 classes,
# served through the custom-charset bundle path (weights.npz + its own
# keys file).

# categories that render as nothing, reorder, or compose with neighbours
_JUMBO_SKIP_CATEGORIES = frozenset(
    {"Cc", "Cf", "Cs", "Co", "Cn", "Zl", "Zp", "Zs", "Mn", "Mc", "Me"}
)

JUMBO_KEYS_FILE = os.path.join(_REPO_ROOT, "weights", "jumbo_keys.txt")
JUMBO_HOMOGLYPHS_FILE = os.path.join(_REPO_ROOT, "weights", "jumbo_homoglyphs.txt")
JUMBO_HARD_CHARS_FILE = os.path.join(_REPO_ROOT, "weights", "jumbo_hard_chars.txt")


def _tight_render_hash(ch: str, font) -> Optional[bytes]:
    """Hash of the ink bitmap of ``ch`` drawn alone at a fixed origin, or
    None if it draws no ink. The bitmap is cropped to its ink bbox but the
    bbox's VERTICAL offset is part of the hash: placement relative to the
    baseline is visible in a rendered line, so '-' vs '_' or '.' vs '·'
    are distinguishable and must NOT hash equal."""
    if ord(ch) in font.face.noink:  # no glyph in the atlas: it inks nothing
        return None
    a = np.full((90, 120), 255, np.uint8)
    draw_text(a, (30, 25), ch, font, 0)
    ys, xs = np.nonzero(a < 128)
    if ys.size == 0:
        return None
    t = a[ys.min(): ys.max() + 1, xs.min(): xs.max() + 1]
    return hashlib.md5(
        t.tobytes() + str((t.shape, int(ys.min()))).encode("ascii")
    ).digest()


@functools.lru_cache(maxsize=None)
def build_jumbo_alphabet() -> str:
    """Compute the jumbo alphabet from the fonts: DejaVuSans cmap,
    category/bidi-filtered, ink-checked. Prefer :func:`jumbo_alphabet`,
    which loads the pinned ``weights/jumbo_keys.txt`` artifact."""
    path = os.path.join(DEJAVU_DIR, "DejaVuSans.ttf")
    cov = sorted(_font_charset(path))
    font = load_atlas().font(path, 32)
    out = []
    for cp in cov:
        ch = chr(cp)
        if cp < 0x21:
            continue
        if unicodedata.category(ch) in _JUMBO_SKIP_CATEGORIES:
            continue
        # RTL scripts: the layout bidi-reorders them at draw time, so the
        # drawn glyph order would not match the label string order
        if unicodedata.bidirectional(ch) in ("R", "AL", "AN"):
            continue
        if _tight_render_hash(ch, font) is None:
            continue
        out.append(ch)
    return "".join(out)


@functools.lru_cache(maxsize=None)
def jumbo_alphabet(keys_file: str = JUMBO_KEYS_FILE) -> str:
    """The pinned jumbo charset body (~5,000 chars; one char per line in
    the ppocr_keys_v1.txt convention — read with load_charset's line
    semantics, \\r included). Falls back to computing from the atlas when
    the artifact is absent."""
    if os.path.exists(keys_file):
        return "".join(
            line.rstrip("\r\n")
            for line in open(keys_file, encoding="utf-8")
            if line.rstrip("\r\n")
        )
    return build_jumbo_alphabet()


def render_glyph_families(alphabet: str) -> List[str]:
    """Group ``alphabet`` into families of characters whose renders (ink
    bitmap + baseline placement) are pixel-identical in at least one
    DejaVu face at 32 px; the curated near-identical pairs (HOMOGLYPHS) are
    merged in on top. Merging is per-face and transitive (union-find
    across all six faces plus the curated pairs).

    Returns only multi-member families, each as a string of members with
    the representative (lowest codepoint) first."""
    parent = {c: c for c in alphabet}

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def union(a, b):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)

    atlas = load_atlas()
    for face in DEJAVU_FONTS:
        path = os.path.join(DEJAVU_DIR, face)
        covered = _font_charset(path)
        font = atlas.font(path, 32)
        first: Dict[bytes, str] = {}
        for ch in alphabet:
            if ord(ch) not in covered:
                continue
            h = _tight_render_hash(ch, font)
            if h is None:
                continue
            if h in first:
                union(ch, first[h])
            else:
                first[h] = ch
    for fam in HOMOGLYPHS:
        members = [c for c in fam if c in parent]
        for c in members[1:]:
            union(members[0], c)
    groups: Dict[str, List[str]] = {}
    for c in alphabet:
        groups.setdefault(find(c), []).append(c)
    return sorted(
        "".join(sorted(set(v), key=ord)) for v in groups.values() if len(set(v)) > 1
    )


@functools.lru_cache(maxsize=None)
def jumbo_hard_chars(hard_file: str = JUMBO_HARD_CHARS_FILE) -> str:
    """The jumbo-scale hard-pair training set (near-confusable chars plus
    the exact-render family members), from the pinned
    ``weights/jumbo_hard_chars.txt``; the family members alone when the
    artifact is absent."""
    if os.path.exists(hard_file):
        return open(hard_file, encoding="utf-8").read().rstrip("\n")
    return "".join(sorted(jumbo_homoglyph_map().keys()))


@functools.lru_cache(maxsize=None)
def jumbo_homoglyph_map(
    families_file: str = JUMBO_HOMOGLYPHS_FILE,
) -> Dict[str, str]:
    """char → family representative, from the pinned families artifact
    (computed from the atlas if absent). Includes the curated HOMOGLYPHS."""
    if os.path.exists(families_file):
        fams = [
            line.rstrip("\n")
            for line in open(families_file, encoding="utf-8")
            if line.rstrip("\n")
        ]
    else:
        fams = render_glyph_families(jumbo_alphabet())
    return {c: fam[0] for fam in fams for c in fam}


# Character families that are visually identical or near-identical in the
# DejaVu faces (Sans draws 'l' and 'I' as the same bare bar; O/0/Greek
# omicron coincide at small sizes).
HOMOGLYPHS = [
    "lI|∣│▏▕",
    "O0Ο○",
    "3З",  # Cyrillic Ze — drawn as '3' in the DejaVu faces
    "′´`ˋ‘’",
    "─—–-−",
    '"”“',
]
_HOMO_MAP = {c: fam[0] for fam in HOMOGLYPHS for c in fam}


def homoglyph_normalize(text: str, mapping: Optional[Dict[str, str]] = None) -> str:
    """Collapse each DejaVu homoglyph family to one representative.

    With no ``mapping`` this uses the curated families (HOMOGLYPHS); pass
    :func:`jumbo_homoglyph_map` for the jumbo charset's computed families."""
    m = _HOMO_MAP if mapping is None else mapping
    return "".join(m.get(c, c) for c in text)


def text_scene_dataset(mode: str, seed: int = 0, charset_file: Optional[str] = None,
                       **kw) -> "SyntheticSceneDataset":
    """The canonical DejaVu scene dataset of the training scripts and the
    gates. ``mode``: "ascii" (94 classes), "full" (~218 classes; both read
    the reference charset at ``charset_file``), or "jumbo" (~5,000
    classes)."""
    if mode not in ("ascii", "full", "jumbo"):
        raise ValueError(f"unknown scene-dataset mode {mode!r}")
    if mode == "jumbo":
        alpha = jumbo_alphabet()
    else:
        alpha = dejavu_alphabet(charset_file, ascii_only=mode == "ascii")
    kw.setdefault("max_len", 6)
    kw.setdefault("core_alphabet", "".join(c for c in alpha if c.isalnum()))
    return SyntheticSceneDataset(
        alphabet=alpha, renderer=AtlasTextRenderer(), seed=seed, **kw
    )


def render_line(
    text: str,
    img_h: int = 48,
    img_w: int = 320,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """Render one line, black-on-white with slight jitter, HWC uint8."""
    rng = rng or np.random.default_rng(0)
    img = np.full((img_h, img_w, 3), 255, np.uint8)
    scale = img_h / 40.0
    x = int(rng.integers(2, 8))
    y = int(img_h - rng.integers(8, 14))
    put_text(img, text, (x, y), FONT_HERSHEY_SIMPLEX, scale, (0, 0, 0), 2, LINE_AA)
    return img


def _check_rubik(what: str, *alphabets: Optional[str]) -> None:
    """Refuse, before any draw, an alphabet cv2 would draw from another face."""
    for alphabet in alphabets:
        if alphabet and not rubik_covers(alphabet):
            missing = "".join(sorted({c for c in alphabet if not rubik_covers(c)}))
            raise CV2FallbackFaceNotPorted(f"{what} over characters {missing!r}")


class SyntheticSceneDataset:
    """Scenes of several rendered text lines + DB shrink-mask supervision.

    Scenes are rendered at a source resolution, downscaled to the det
    input geometry like the serving resize, and supervised with the DB
    shrink mask — each text rect inset by ``d = area·(1−r²)/perimeter``
    (r = 0.4), which the serving unclip re-expands. Without a
    ``renderer`` the lines are cv2 Hershey text (``fonts``, scale
    uniform in [0.9, 1.3], thickness 2), as the digit datasets draw."""

    FONTS = (
        FONT_HERSHEY_SIMPLEX,
        FONT_HERSHEY_DUPLEX,
        FONT_HERSHEY_COMPLEX,
    )

    def __init__(
        self,
        alphabet: str = "0123456789",
        src_hw: Tuple[int, int] = (192, 192),
        det_hw: Tuple[int, int] = (96, 96),
        max_lines: int = 3,
        min_len: int = 2,
        max_len: int = 5,
        shrink_ratio: float = 0.4,
        fonts: Sequence[int] | None = None,
        renderer: Optional[AtlasTextRenderer] = None,
        core_alphabet: Optional[str] = None,
        core_frac: float = 0.75,
        hard_chars: str = "",
        hard_frac: float = 0.0,
        seed: int = 0,
    ):
        if renderer is None:  # before any draw from the seed's stream
            _check_rubik("SyntheticSceneDataset", alphabet, core_alphabet)
        self.alphabet = alphabet
        self.src_hw = src_hw
        self.det_hw = det_hw
        self.max_lines = max_lines
        self.min_len = min_len
        self.max_len = max_len
        self.shrink_ratio = shrink_ratio
        self.fonts = tuple(fonts) if fonts is not None else self.FONTS
        self.renderer = renderer  # None: the cv2 Hershey fonts
        # most positions draw from the "core" (alphanumerics)
        self.core_alphabet = core_alphabet
        self.core_frac = core_frac
        self.rng = np.random.default_rng(seed)
        # choice on a pre-built array draws the same stream as on a list
        self._alpha_arr = np.array(list(alphabet))
        self._core_arr = (
            np.array(list(core_alphabet)) if core_alphabet else None
        )
        # training-only hard-pair oversampling: with probability hard_frac
        # one position is overwritten by a near-homoglyph char
        self.hard_frac = hard_frac
        hard = [c for c in hard_chars if c in set(alphabet)]
        self._hard_arr = np.array(hard) if hard and hard_frac > 0 else None

    def sample_text(self) -> str:
        n = int(self.rng.integers(self.min_len, self.max_len + 1))
        if not self.core_alphabet:
            text = "".join(self.rng.choice(self._alpha_arr, size=n))
        else:
            core = self.rng.random(n) < self.core_frac
            core[int(self.rng.integers(n))] = True  # ≥1 solid anchor char
            text = "".join(
                str(self.rng.choice(self._core_arr if c else self._alpha_arr))
                for c in core
            )
        if self._hard_arr is not None and self.rng.random() < self.hard_frac:
            pos = int(self.rng.integers(n))
            text = (
                text[:pos] + str(self.rng.choice(self._hard_arr))
                + text[pos + 1:]
            )
        return text

    def _measure(self, text: str):
        """(draw_ctx, tight (tw, th)) of one line under either backend."""
        if self.renderer is not None:
            font = self.renderer.pick_font(text, self.rng)
            dx0, dy0, dx1, dy1 = self.renderer.measure(text, font)
            return ("pil", font, dx0, dy0), (dx1 - dx0, dy1 - dy0)
        scale = float(self.rng.uniform(0.9, 1.3))
        thickness = 2
        font = int(self.fonts[int(self.rng.integers(len(self.fonts)))])
        (tw, th), _base = get_text_size(text, font, scale, thickness)
        return ("cv2", font, scale, thickness), (tw, th)

    def sample_scene(
        self,
    ) -> Tuple[np.ndarray, List[Tuple[str, Tuple[int, int, int, int]]]]:
        """One source-resolution scene → (HWC uint8, [(text, (x0,y0,x1,y1))]).

        Lines are placed without overlap (including a margin so the det
        blobs stay separable); boxes are tight text-extent rects
        (``getTextSize`` / ``textbbox``)."""
        h, w = self.src_hw
        img = np.full((h, w, 3), 255, np.uint8)
        placed: List[Tuple[str, Tuple[int, int, int, int]]] = []
        n_lines = int(self.rng.integers(1, self.max_lines + 1))
        for _ in range(n_lines):
            text = self.sample_text()
            ctx, (tw, th) = self._measure(text)
            if tw + 8 >= w or th + 8 >= h:
                continue
            for _attempt in range(12):
                x0 = int(self.rng.integers(3, w - tw - 4))
                y0 = int(self.rng.integers(3, h - th - 4))
                box = (x0, y0, x0 + tw, y0 + th)
                margin = 10
                clash = any(
                    not (
                        box[2] + margin < b[0]
                        or b[2] + margin < box[0]
                        or box[3] + margin < b[1]
                        or b[3] + margin < box[1]
                    )
                    for _, b in placed
                )
                if not clash:
                    if ctx[0] == "pil":
                        _, font, dx0, dy0 = ctx
                        # place the tight bbox at (x0, y0): offset the draw
                        # origin by the bbox's own origin offsets
                        self.renderer.draw(img, (x0 - dx0, y0 - dy0), text, font, (0, 0, 0))
                    else:
                        _, font, scale, thickness = ctx
                        put_text(img, text, (x0, y0 + th), font, scale, (0, 0, 0), thickness, LINE_AA)
                    placed.append((text, box))
                    break
        return img, placed

    def shrink_mask(
        self, boxes: List[Tuple[int, int, int, int]]
    ) -> np.ndarray:
        """DB shrink mask at det resolution: each source-coords rect scaled
        to det coords and inset by d = area·(1−r²)/perimeter."""
        dh, dw = self.det_hw
        sh, sw = self.src_hw
        ry, rx = dh / sh, dw / sw
        mask = np.zeros((dh, dw), np.float32)
        r2 = 1.0 - self.shrink_ratio**2
        for x0, y0, x1, y1 in boxes:
            bx0, by0 = x0 * rx, y0 * ry
            bx1, by1 = x1 * rx, y1 * ry
            bw, bh = bx1 - bx0, by1 - by0
            if bw < 2 or bh < 2:
                continue
            d = (bw * bh) * r2 / max(2.0 * (bw + bh), 1.0)
            sx0 = int(round(bx0 + d))
            sy0 = int(round(by0 + d))
            sx1 = int(round(bx1 - d))
            sy1 = int(round(by1 - d))
            if sx1 <= sx0:  # keep at least a 1px-wide core
                sx0 = sx1 = int(round((bx0 + bx1) / 2))
                sx1 += 1
            if sy1 <= sy0:
                sy0 = sy1 = int(round((by0 + by1) / 2))
                sy1 += 1
            mask[sy0: sy1 + 1, sx0: sx1 + 1] = 1.0
        return mask

    def det_batch(
        self, batch_size: int
    ) -> Tuple[Dict[str, np.ndarray], List]:
        """Batch for the det trainer: ImageNet-normalized det-res images +
        shrink masks (the serving det step normalizes identically)."""
        dh, dw = self.det_hw
        imgs = np.zeros((batch_size, dh, dw, 3), np.float32)
        masks = np.zeros((batch_size, dh, dw), np.float32)
        scenes = []
        mean = np.array([0.485, 0.456, 0.406], np.float32)
        scale = np.array([1 / 0.229, 1 / 0.224, 1 / 0.225], np.float32)
        for i in range(batch_size):
            scene, placed = self.sample_scene()
            small = resize_bilinear_u8(scene, dw, dh)
            imgs[i] = (small.astype(np.float32) / 255.0 - mean) * scale
            masks[i] = self.shrink_mask([b for _, b in placed])
            scenes.append((scene, placed))
        return {"images": imgs, "masks": masks}, scenes

    def crop_with_margin(
        self, scene: np.ndarray, box: Tuple[int, int, int, int], jitter=True
    ) -> np.ndarray:
        """Crop a gt rect the way the serving pipeline would: the rect plus
        a margin of 10-45% of the text height per side (randomized when
        training), 20% of crops with the loose, correlated margins a
        coarse-scale detector's unclip gives (30-90% ± 25%)."""
        x0, y0, x1, y1 = box
        h = y1 - y0
        if jitter:
            if self.rng.random() < 0.20:
                base = float(self.rng.uniform(0.30, 0.90))
                m = [base * float(self.rng.uniform(0.75, 1.25)) * h for _ in range(4)]
            else:
                m = [float(self.rng.uniform(0.10, 0.45) * h) for _ in range(4)]
        else:
            m = [0.25 * h] * 4
        sh, sw = scene.shape[:2]
        cx0 = max(0, int(round(x0 - m[0])))
        cy0 = max(0, int(round(y0 - m[1])))
        cx1 = min(sw, int(round(x1 + m[2])))
        cy1 = min(sh, int(round(y1 + m[3])))
        return scene[cy0:cy1, cx0:cx1]


class SyntheticRecDataset:
    """Batches of (raw uint8 images, padded labels, label paddings) of
    lines drawn by :func:`render_line`."""

    def __init__(
        self,
        charset: Sequence[str],
        alphabet: str = "0123456789",
        img_h: int = 48,
        img_w: int = 320,
        min_len: int = 1,
        max_len: int = 8,
        seed: int = 0,
    ):
        self.char_to_idx = {c: i for i, c in enumerate(charset)}
        missing = [c for c in alphabet if c not in self.char_to_idx]
        if missing:
            raise ValueError(f"alphabet chars not in charset: {missing}")
        _check_rubik("SyntheticRecDataset", alphabet)  # before any draw from the seed
        self.alphabet = alphabet
        self.img_h = img_h
        self.img_w = img_w
        self.min_len = min_len
        self.max_len = max_len
        self.rng = np.random.default_rng(seed)

    def sample_text(self) -> str:
        n = int(self.rng.integers(self.min_len, self.max_len + 1))
        return "".join(self.rng.choice(list(self.alphabet), size=n))

    def batch(self, batch_size: int) -> Tuple[Dict[str, np.ndarray], List[str]]:
        texts = [self.sample_text() for _ in range(batch_size)]
        # raw uint8; normalization happens on device
        # (trainer.normalize_rec_images)
        x = np.stack(
            [render_line(t, self.img_h, self.img_w, self.rng) for t in texts]
        )
        labels = np.zeros((batch_size, self.max_len), np.int32)
        pad = np.ones((batch_size, self.max_len), np.float32)
        for i, t in enumerate(texts):
            for j, ch in enumerate(t):
                labels[i, j] = self.char_to_idx[ch]
                pad[i, j] = 0.0
        return {"images": x, "labels": labels, "label_paddings": pad}, texts


class SceneCropRecDataset:
    """Recognizer batches drawn from detector scenes.

    Crops lines out of ``SyntheticSceneDataset`` scenes with the serving
    pipeline's crop semantics (unclip margin + axis-aligned bounding crop
    + ``crnn_resize``), optionally rotated by a uniform ±``aug_rotate_deg``
    (white border)."""

    def __init__(
        self,
        charset: Sequence[str],
        scenes: SyntheticSceneDataset,
        img_h: int = 48,
        img_w: int = 160,
        aug_rotate_deg: float = 0.0,
        seed: int = 1,
    ):
        self.char_to_idx = {c: i for i, c in enumerate(charset)}
        self.scenes = scenes
        self.img_h = img_h
        self.img_w = img_w
        self.aug_rotate_deg = aug_rotate_deg
        self.max_len = scenes.max_len
        self.rng = np.random.default_rng(seed)

    def batch(self, batch_size: int) -> Tuple[Dict[str, np.ndarray], List[str]]:
        crops: List[np.ndarray] = []
        texts: List[str] = []
        while len(crops) < batch_size:
            scene, placed = self.scenes.sample_scene()
            for text, box in placed:
                if len(crops) >= batch_size:
                    break
                crop = self.scenes.crop_with_margin(scene, box)
                if crop.shape[0] < 4 or crop.shape[1] < 4:
                    continue
                if self.aug_rotate_deg > 0:
                    angle = float(
                        self.rng.uniform(
                            -self.aug_rotate_deg, self.aug_rotate_deg
                        )
                    )
                    ch, cw = crop.shape[:2]
                    m = get_rotation_matrix_2d((cw / 2, ch / 2), angle, 1.0)
                    crop = warp_affine(crop, m, cw, ch, border_value=(255, 255, 255))
                crops.append(
                    crnn_resize(
                        crop,
                        self.img_w / self.img_h,
                        (3, self.img_h, self.img_w),
                    )
                )
                texts.append(text)
        # raw uint8; normalization happens on device
        # (trainer.normalize_rec_images)
        x = np.stack(crops)
        labels = np.zeros((batch_size, self.max_len), np.int32)
        pad = np.ones((batch_size, self.max_len), np.float32)
        for i, t in enumerate(texts):
            for j, ch in enumerate(t):
                labels[i, j] = self.char_to_idx[ch]
                pad[i, j] = 0.0
        return {"images": x, "labels": labels, "label_paddings": pad}, texts
