"""libaom 3.14.1's deblocking filter in ``csrc/av1.cpp``: the default
lossy AVIFs of cv2 and Pillow, whose frames run it (and CDEF,
``tests/test_torch_avif_cdef.py``), against ``cv2.imdecode(buf,
IMREAD_COLOR)`` and ``cv2.imread`` (OpenCV 5.0 over libavif 1.4.2 and
libaom 3.14.1): the same ``None`` or not, and 0 differing pixels.

The files: cv2's default (quality 50) AVIF of both serving scenes; cv2's
files of a crop of one at q20 to q90 and speeds 4, 6 and 8; Pillow's
default file (4:2:0) and its 4:2:2 and 4:4:4 ones; every sharpness;
monochrome; sizes of every width and height modulo 8, where the filters
read the decoded samples past the visible frame. Then frames of this
file's own writer (``filtered_frame``) for what no writer here sets:
delta lf (one value or four), reference deltas updated, a segment's
ALT_LF features, a luma level of 0 in one direction. Each edge filter
(``aom_lpf_{vertical,horizontal}_{4,6,8,14}``) equals libaom's C and SSE2
functions, and its ``_dual`` and ``_quad`` forms, through ``ctypes``.
The writer also codes 4:2:0 frames, visible sizes off the 8-sample
grid, two tile columns and loop restoration's units, for
``tests/test_torch_avif_restoration.py``.

    python -m pytest tests/test_torch_avif_deblock.py -q
"""

import collections
import ctypes
import functools
import struct

import cv2
import numpy as np
import pytest

from ppocr_tpu_torch.ops import native
from ppocr_tpu_torch.utils import imcodec
from test_torch_avif import (Bits, avif_file, cv2_avif, decode_stats, item_data, mutations, noise, obu, pil_avif,
                             read_answers, smooth, text)
from test_torch_avif_lossy import SymbolWriter, _libaom, c_tables
from test_torch_tiff import answers, cv2_decode, port_decode

S = native.AV1_STATS


def lf_edges(stream: bytes) -> np.ndarray:
    """The deblocked 4-sample edge segments of a decode: [plane, length
    (4, 6, 8, 14)]."""
    return decode_stats(stream)[S["lf_edges"][0]:S["lf_edges"][1]].reshape(3, 4)


@functools.lru_cache(maxsize=None)
def serving_scene(index: int) -> np.ndarray:
    from ppocr_tpu_torch import assets

    return assets.load_scenes()["serving"][index]


@functools.lru_cache(maxsize=None)
def scene_crop() -> np.ndarray:
    """128x192 of the first serving scene: cv2's files of it run no loop
    restoration at any speed, and from q60 code a CDEF index per 64x64
    unit."""
    return np.ascontiguousarray(serving_scene(0)[:128, :192])


# -- cv2's files -----------------------------------------------------------------------------------

@pytest.mark.parametrize("index", [0, 1])
def test_cv2s_default_file_of_each_serving_scene_decodes_as_cv2(index, tmp_path):
    """Quality 50, cv2's default: 4:2:0, BT.601, deblocking at level 15
    (16 with the intra reference delta), sharpness 1, CDEF on luma."""
    scene = serving_scene(index)
    data = cv2.imencode(".avif", scene)[1].tobytes()
    assert data == cv2.imencode(".avif", scene, [cv2.IMWRITE_AVIF_QUALITY, 50])[1].tobytes()
    assert answers(data) == "equal"
    assert read_answers(data, tmp_path) == "equal"
    stats = decode_stats(item_data(data))
    assert lf_edges(item_data(data))[:, [0, 1, 3]].sum() > 0 and stats[S["cdef_y"]] > 0


@pytest.mark.parametrize("speed", [4, 6, 8])
@pytest.mark.parametrize("q", [20, 30, 40, 50, 60, 70, 80, 90])
def test_cv2s_files_at_each_quality_and_speed_decode_as_cv2(q, speed):
    data = cv2_avif(scene_crop(), speed, q)
    assert answers(data) == "equal"


# -- Pillow's files ----------------------------------------------------------------------------------

@pytest.mark.parametrize("subsampling", ["4:2:0", "4:2:2", "4:4:4"])
def test_pillows_default_files_decode_as_cv2(subsampling, tmp_path):
    """Pillow 12.1 with no quality given (its default, 4:2:0, is the first
    case): deblocking at level 3, CDEF off in the sequence."""
    for kind, img in (("scene", scene_crop()), ("smooth", smooth(64, 96, 3, 12)), ("text", text(48, 80, 3, 3))):
        data = pil_avif(img, subsampling=subsampling)
        assert answers(data) == "equal", kind
    if subsampling == "4:2:0":
        data = pil_avif(serving_scene(1))
        assert answers(data) == "equal" and read_answers(data, tmp_path) == "equal"


@pytest.mark.parametrize("sharpness", range(8))
def test_every_sharpness_decodes_as_cv2(sharpness):
    """libaom's ``sharpness`` sets the frame's (update_sharpness: the
    inside limit shrinks with it)."""
    for q, img in ((40, scene_crop()), (20, noise(40, 56, 3, sharpness))):
        data = pil_avif(img, quality=q, speed=6, advanced=[("sharpness", str(sharpness)), ("enable-cdef", "1")])
        assert answers(data) == "equal", q


@pytest.mark.parametrize("q", [30, 50, 80])
def test_monochrome_files_decode_as_cv2(q, tmp_path):
    grey = cv2.cvtColor(scene_crop(), cv2.COLOR_BGR2GRAY)
    for speed in (6, 8):
        data = cv2_avif(grey, speed, q)
        assert answers(data) == "equal" and read_answers(data, tmp_path) == "equal"
        assert lf_edges(item_data(data))[0].sum() > 0


# every width and height modulo 8 (the deblocking filter stops at the last
# visible 4-sample column or row; CDEF's frame is the 8-sample grid)
ODD_SIZES = [(1, 1), (7, 5), (9, 10), (11, 12), (13, 14), (15, 17), (19, 22), (20, 21), (30, 27), (44, 38),
             (221, 333)]


@pytest.mark.parametrize("size", ODD_SIZES, ids=[f"{h}x{w}" for h, w in ODD_SIZES])
def test_odd_sizes_decode_as_cv2(size):
    h, w = size
    img = cv2.resize(scene_crop(), (w, h), interpolation=cv2.INTER_AREA) if h * w > 64 else noise(h, w, 3, w)
    for data in (cv2_avif(img, 6, 40), pil_avif(img, quality=30, subsampling="4:2:2", advanced=[("enable-cdef", "1")]),
                 pil_avif(img, quality=30, subsampling="4:4:4", advanced=[("enable-cdef", "1")])):
        assert answers(data) == "equal"


# -- frames written here: the syntax no writer of this box sets ------------------------------------
# libaom's all-intra encoder never codes delta lf, new reference deltas or
# a segment's ALT_LF features, and cv2's and Pillow's files seldom hold a
# 64x64 unit of skipped blocks. ``filtered_frame`` writes a 4:4:4 key frame
# of 32x32 DC_PRED blocks (TX_MODE_LARGEST, so 32x32 DCT transforms of one
# DC coefficient each, or none) with libaom's entropy coder of
# ``test_torch_avif_lossy.py`` over the default CDFs of ``csrc/av1_tables.h``
# (CDF updates off), and whichever of those tools it is asked for.


def _su(value: int, n: int) -> int:
    """su(n): the n-bit two's complement of ``value``."""
    return value & ((1 << n) - 1)


def _neg_interleave(x: int, ref: int, n: int) -> int:
    """libaom's neg_interleave: a segment id coded beside its prediction."""
    diff = x - ref
    if not ref:
        return x
    if ref >= n - 1:
        return n - 1 - x
    near = abs(diff) <= ref if 2 * ref < n else abs(diff) < n - ref
    if near:
        return 2 * diff - 1 if diff > 0 else -2 * diff
    return x if 2 * ref < n else n - x - 1


def _write_delta(w: SymbolWriter, delta: int, cdf):
    """A delta q / delta lf: its magnitude by the 4-symbol CDF (3 and up as
    3, then the bit count less 1 in 3 bits and the rest), then its sign."""
    mag = abs(delta)
    w.symbol(min(mag, 3), cdf, 4)
    if mag >= 3:
        rem = max((mag - 1).bit_length() - 1, 1)
        for i in range(2, -1, -1):
            w.bit(((rem - 1) >> i) & 1)
        for i in range(rem - 1, -1, -1):
            w.bit(((mag - 1 - (1 << rem)) >> i) & 1)
    if mag:
        w.bit(int(delta < 0))


def write_coefficients_32x32(w: SymbolWriter, qc: int, ptype: int, coefs: dict, dc_ctx: int, txs: int = 3) -> int:
    """One DCT_DCT transform of TX_32X32 (``txs`` 3; TX_16X16 with ``txs``
    2) in plane type ``ptype``: ``coefs`` {scan index: (level 1 or 2,
    sign)}, the last index under 5. Returns the sum of the levels (the
    block's cul_level before its clip)."""
    T = c_tables()
    side = 4 << txs
    scan = T["scan_data"][T["scan_start"][txs][0]:][:side * side]
    nz = T["nz_map_ctx_offset_data"][T["nz_map_ctx_offset_start"][txs]:]
    eob = max(coefs) + 1
    eob_pt = {1: 1, 2: 2, 3: 3, 4: 3}[eob]
    if txs == 3:
        w.symbol(eob_pt - 1, T["eob_multi1024_cdfs"][qc][ptype][0], 11)
    else:
        w.symbol(eob_pt - 1, T["eob_multi256_cdfs"][qc][ptype][0], 9)
    if eob_pt == 3:
        w.symbol(eob - 3, T["eob_extra_cdfs"][qc][txs][ptype][0], 2)
    stride = side + 4
    levels = np.zeros(stride * stride, int)
    at = lambda pos: (pos // side) * stride + (pos % side)
    for c in range(eob - 1, -1, -1):
        pos, level = int(scan[c]), coefs.get(c, (0, 0))[0]
        if c == eob - 1:
            w.symbol(level - 1, T["coeff_base_eob_cdfs"][qc][txs][ptype][0 if c == 0 else 1], 3)
        else:
            mag = sum(min(levels[at(pos) + o], 3) for o in (1, stride, stride + 1, 2 * stride, 2))
            ctx = 0 if pos == 0 else min((mag + 1) >> 1, 4) + int(nz[pos])
            w.symbol(level, T["coeff_base_cdfs"][qc][txs][ptype][ctx], 4)
        levels[at(pos)] = level
    for c in sorted(coefs):
        if c == 0:
            w.symbol(coefs[c][1], T["dc_sign_cdfs"][qc][ptype][dc_ctx], 2)
        else:
            w.bit(coefs[c][1])
    return sum(level for level, _ in coefs.values())


def _literal(w: SymbolWriter, value: int, bits: int):
    for i in range(bits - 1, -1, -1):
        w.bit((value >> i) & 1)


def _write_refsubexpfin(w: SymbolWriter, lo: int, hi: int, k: int, ref: int, value: int):
    """aom_write_primitive_refsubexpfin: ``value`` of [lo, hi] recentred on
    ``ref``, then as a subexponential code with finite range."""
    n, r, v = hi - lo + 1, ref - lo, value - lo

    def recenter(r, v):
        return v if v > 2 * r else 2 * (v - r) if v >= r else 2 * (r - v) - 1

    v = recenter(r, v) if 2 * r <= n else recenter(n - 1 - r, n - 1 - v)
    i = mk = 0
    while True:
        b = k + i - 1 if i else k
        a = 1 << b
        if n <= mk + 3 * a:  # quniform over what is left
            m, left = (1 << (n - mk).bit_length()) - (n - mk), v - mk
            bits = (n - mk).bit_length() - 1
            if n - mk <= 1:
                return
            if left < m:
                _literal(w, left, bits)
            else:
                _literal(w, m + ((left - m) >> 1), bits)
                w.bit((left - m) & 1)
            return
        more = v >= mk + a
        w.bit(int(more))
        if not more:
            _literal(w, v - mk, b)
            return
        i, mk = i + 1, mk + a


class _Restoration:
    """Loop restoration's unit coefficients as libaom writes them
    (loop_restoration_write_sb_coeffs): random per unit, the references
    reset at each tile."""

    def __init__(self, rs, types, unit, sizes, sets):
        self.rs, self.types, self.unit, self.sets = rs, types, unit, list(sets)
        self.units = [(max((pw + unit[p] // 2) // unit[p], 1), max((ph + unit[p] // 2) // unit[p], 1))
                      for p, (pw, ph) in enumerate(sizes)]
        self.done = 0

    def reset(self):
        self.ref = [{"w": [[3, -7, 15], [3, -7, 15]], "xqd": [-32, 31]} for _ in range(3)]

    def superblock(self, sw: SymbolWriter, r4: int, c4: int, sb4: int, ss: tuple):
        """The units whose top-left corner lies in the superblock at 4x4
        unit (r4, c4), plane by plane (av1_loop_restoration_corners_in_sb)."""
        T = c_tables()
        for p, t in enumerate(self.types):
            if not t:
                continue
            size, (hu, vu) = self.unit[p], self.units[p]
            mx, my = 4 >> (ss[0] if p else 0), 4 >> (ss[1] if p else 0)
            c0, r0 = (c4 * mx + size - 1) // size, (r4 * my + size - 1) // size
            c1, r1 = min(((c4 + sb4) * mx + size - 1) // size, hu), min(((r4 + sb4) * my + size - 1) // size, vu)
            for _ in range(r0, r1):
                for _ in range(c0, c1):
                    self.write_unit(sw, p, t, T)

    def write_unit(self, sw, p, t, T):
        rs, ref = self.rs, self.ref[p]
        if t == 1:  # SWITCHABLE: NONE, WIENER, SGRPROJ
            kind = int(rs.randint(0, 3))
            sw.symbol(kind, T["switchable_restore_cdf"], 3)
        else:
            on = int(rs.rand() < 0.8)
            sw.symbol(on, T["wiener_restore_cdf" if t == 2 else "sgrproj_restore_cdf"], 2)
            kind = on * (1 if t == 2 else 2)
        if kind == 1:
            for d in range(2):  # vertical, then horizontal
                taps = [0 if p else int(rs.randint(-5, 11)), int(rs.randint(-23, 9)), int(rs.randint(-17, 47))]
                for i, (lo, hi, k) in enumerate(((-5, 10, 1), (-23, 8, 2), (-17, 46, 3))):
                    if i or not p:
                        _write_refsubexpfin(sw, lo, hi, k, ref["w"][d][i], taps[i])
                ref["w"][d] = taps
        elif kind == 2:
            ep = self.sets[self.done % len(self.sets)]
            self.done += 1
            _literal(sw, ep, 4)
            r0, r1 = T["sgr_params"][ep][:2]  # a radius of 0 skips its pass: its weight is not coded
            xqd = [int(rs.randint(-96, 32)) if r0 else 0, int(rs.randint(-32, 96))]
            if r0:
                _write_refsubexpfin(sw, -96, 31, 4, ref["xqd"][0], xqd[0])
            if not r1:
                xqd[1] = min(max(128 - xqd[0], -32), 95)
            if r1:
                _write_refsubexpfin(sw, -32, 95, 4, ref["xqd"][1], xqd[1])
            ref["xqd"] = xqd


def filtered_frame(seed: int, *, sb128: bool = False, q: int = 200, levels=(6, 5, 4, 3), sharpness: int = 0,
                   deltas_enabled: bool = True, ref_deltas: dict = None, mode_deltas: dict = None,
                   delta_lf: str = None, delta_lf_res: int = 1, segments: dict = None, cdef=None,
                   skipped_unit=None, w: int = 256, h: int = 128, subsampling: str = "4:4:4", visible=None,
                   tile_cols_log2: int = 0, lr=None) -> bytes:
    """A 4:4:4 key frame (reduced still-picture header, sRGB identity
    colours) of ``w`` x ``h`` (multiples of the superblock) in 32x32 blocks,
    each DC_PRED with a random DC and up to two of the next three
    coefficients (levels 1 or 2, either sign), or none, in each plane,
    about a fifth of the blocks skipping: deblocking ``levels`` (y
    vertical, y horizontal, u, v) at ``sharpness``; the deltas enabled or
    not, with ``ref_deltas`` / ``mode_deltas`` {index: value} as an update;
    ``delta_lf`` "single" or "multi" (random per superblock, in steps of
    ``1 << delta_lf_res``, beside a random delta q); ``segments`` {id:
    {feature: value}} (features 0-4: ALT_Q, ALT_LF_Y_V, _Y_H, _U, _V) with
    random ids; ``cdef`` (damping, bits, [(y, uv) strengths]) with a random
    index per 64x64 unit; ``skipped_unit`` (row, col) of a 64x64 unit whose
    four blocks all skip. ``subsampling`` "4:2:0" writes profile 0 with
    BT.709 colours, each block's chroma a 16x16 transform; ``visible``
    (width, height) a frame up to 7 samples narrower and shorter than
    ``w`` x ``h`` with the same blocks (the same 8-sample grid);
    ``tile_cols_log2`` 1 two uniform tile columns (no segments then);
    ``lr`` loop restoration: (lr_type of each plane as coded: 0 NONE, 1
    SWITCHABLE, 2 WIENER, 3 SGRPROJ; lr_unit_shift, 0-2 (0-1 with 128x128
    superblocks); lr_uv_shift; the self-guided sets the units take in
    turn), random units drawn apart from the blocks."""
    T = c_tables()
    rs = np.random.RandomState(seed)
    qc = 0 if q <= 20 else 1 if q <= 60 else 2 if q <= 120 else 3
    sb = 128 if sb128 else 64
    gh, gw = h // 32, w // 32
    skip = rs.rand(gh, gw) < 0.2
    if skipped_unit is not None:
        r, c = skipped_unit
        skip[2 * r:2 * r + 2, 2 * c:2 * c + 2] = True
    def coefs():  # the DC and up to two of the next three coefficients, or none
        if rs.rand() < 0.15:
            return None
        at = [0] + sorted(rs.choice([1, 2, 3], int(rs.randint(0, 3)), replace=False).tolist())
        return {int(c): (int(rs.randint(1, 3)), int(rs.randint(0, 2))) for c in at}

    dc = [[[coefs() for _ in range(gw)] for _ in range(gh)] for _ in range(3)]
    seg_ids = rs.randint(0, len(segments), (gh, gw)) if segments else np.zeros((gh, gw), int)
    delta_q = rs.randint(-12, 13, (h // sb, w // sb))  # all drawn whether or not they are written
    cdef_index = rs.randint(0, 4, (h // 64, w // 64)) % (1 << (cdef[1] if cdef else 0))
    deltas_lf = rs.randint(-4, 5, (h // sb, w // sb, 4))
    vw, vh = visible or (w, h)
    assert w - 8 < vw <= w and h - 8 < vh <= h and w % 8 == 0 and h % 8 == 0
    sub = subsampling == "4:2:0"
    ss = (1, 1) if sub else (0, 0)
    seq = Bits().f(0 if sub else 1, 3).f(1, 1).f(1, 1).f(8, 5)  # profile 0 or 1, still, reduced header, level 4.0
    seq.f((vw - 1).bit_length() - 1, 4).f((vh - 1).bit_length() - 1, 4).f(vw - 1, (vw - 1).bit_length())
    seq.f(vh - 1, (vh - 1).bit_length())
    seq.f(int(sb128), 1).f(0, 2)  # superblock size; no filter intra or intra edge filter
    seq.f(0, 1).f(int(cdef is not None), 1).f(int(lr is not None), 1)  # no superres, CDEF or not, LR or not
    if sub:  # 8 bits, colour, BT.709 / sRGB / BT.709, full range, chroma position 0, one uv delta, no grain
        seq.f(0, 1).f(0, 1).f(1, 1).f(1, 8).f(13, 8).f(1, 8).f(1, 1).f(0, 2).f(0, 1).f(0, 1)
    else:
        seq.f(0, 1).f(1, 1).f(1, 8).f(13, 8).f(0, 8).f(0, 1).f(0, 1)  # 8 bits, sRGB identity, one uv delta, no grain
    head = Bits().f(1, 1).f(0, 1).f(0, 1)  # CDF updates off, no screen content tools, render size
    sb_cols, sb_rows = w // sb, h // sb
    assert not (tile_cols_log2 and segments) and tile_cols_log2 <= (sb_cols - 1).bit_length()
    head.f(1, 1)  # uniform tiles: 1 << tile_cols_log2 tile columns, one tile row
    for i in range((sb_cols - 1).bit_length()):  # increment_tile_cols_log2 up to its maximum
        head.f(int(i < tile_cols_log2), 1)
        if i >= tile_cols_log2:
            break
    if sb_rows > 1:
        head.f(0, 1)
    if tile_cols_log2:
        head.f(0, tile_cols_log2).f(3, 2)  # context_update_tile_id 0, 4-byte tile sizes
    tile_w = -(-sb_cols // (1 << tile_cols_log2))
    tile_starts = list(range(0, sb_cols, tile_w))
    head.f(q, 8).f(0, 4)  # base_q_idx, no dc / ac deltas, no qmatrix
    head.f(int(bool(segments)), 1)
    if segments:
        bits = (8, 6, 6, 6, 6)
        for i in range(8):
            for j in range(8):
                v = (segments.get(i) or {}).get(j)
                head.f(int(v is not None), 1)
                if v is not None:
                    head.f(_su(v, 1 + bits[j]), 1 + bits[j])
    head.f(1, 1).f(0, 2)  # delta q present, res 0
    head.f(int(delta_lf is not None), 1)
    if delta_lf is not None:
        head.f(delta_lf_res, 2).f(int(delta_lf == "multi"), 1)
    head.f(levels[0], 6).f(levels[1], 6)
    if levels[0] or levels[1]:
        head.f(levels[2], 6).f(levels[3], 6)
    head.f(sharpness, 3).f(int(deltas_enabled), 1)
    if deltas_enabled:
        update = bool(ref_deltas or mode_deltas)
        head.f(int(update), 1)
        if update:
            for table, n in ((ref_deltas or {}, 8), (mode_deltas or {}, 2)):
                for i in range(n):
                    head.f(int(i in table), 1)
                    if i in table:
                        head.f(_su(table[i], 7), 7)
    cdef_bits = 0
    if cdef is not None:
        damping, cdef_bits, strengths = cdef
        head.f(damping - 3, 2).f(cdef_bits, 2)
        for y, uv in strengths:
            head.f(y, 6).f(uv, 6)
    restoration = None
    if lr is not None:
        types, unit_shift, uv_shift, sets = lr
        for t in types:
            head.f(t, 2)
        if any(types):
            if sb128:
                head.f(unit_shift, 1)
            else:
                head.f(int(unit_shift > 0), 1)
                if unit_shift:
                    head.f(unit_shift - 1, 1)
            if sub and any(types[1:]):
                head.f(uv_shift, 1)
        luma_unit = (128 if sb128 else 64) << unit_shift
        chroma_unit = luma_unit >> (uv_shift if sub and any(types[1:]) else 0)
        sizes = [(vw, vh)] + [((vw + ss[0]) >> ss[0], (vh + ss[1]) >> ss[1])] * 2
        restoration = _Restoration(np.random.RandomState(seed + 7919), types, (luma_unit, chroma_unit, chroma_unit),
                                   sizes, sets)
    head.f(0, 2)  # TX_MODE_LARGEST, the full transform sets
    head.bits += [0] * (-len(head.bits) % 8)
    sw = SymbolWriter()
    ctx = {p: (np.zeros(w // (8 if p and sub else 4), int), np.zeros(h // (8 if p and sub else 4), int))
           for p in range(3)}
    first_col = {32 * 0}  # the 32-sample columns that start a tile (no left neighbour)
    cdef_done = set()
    last_seg = max(segments) if segments else 0
    sign_of = lambda v: (0, -1, 1)[v >> 3]

    def block(r, c):  # one 32x32 block at (r, c) of the 32-sample grid
        up, left = r > 0, c not in first_col
        sw.symbol(int(skip[r, c]), T["skip_cdf"][int(up and skip[r - 1, c]) + int(left and skip[r, c - 1])], 2)
        if segments:
            pu = seg_ids[r - 1, c] if up else -1
            pl = seg_ids[r, c - 1] if left else -1
            pul = seg_ids[r - 1, c - 1] if up and left else -1
            pred = (0 if pl == -1 else pl) if pu == -1 else pu if pl == -1 else (pu if pul == pu else pl)
            if skip[r, c]:
                seg_ids[r, c] = pred
            else:
                sctx = 0 if pul < 0 else 2 if pul == pu == pl else 1 if (pul == pu or pul == pl or pu == pl) else 0
                coded = _neg_interleave(int(seg_ids[r, c]), int(pred), last_seg + 1)
                sw.symbol(coded, T["spatial_pred_seg_cdf"][sctx], 8)
        unit = (r // 2, c // 2)
        if cdef is not None and not skip[r, c] and unit not in cdef_done:
            for i in range(cdef_bits - 1, -1, -1):
                sw.bit((int(cdef_index[unit]) >> i) & 1)
            cdef_done.add(unit)
        if r % (sb // 32) == 0 and c % (sb // 32) == 0:  # the superblock's first block: delta q and lf
            sbr, sbc = r // (sb // 32), c // (sb // 32)
            _write_delta(sw, int(delta_q[sbr, sbc]), T["delta_q_lf_cdfs"][0])
            if delta_lf == "single":
                _write_delta(sw, int(deltas_lf[sbr, sbc, 0]), T["delta_q_lf_cdfs"][5])
            elif delta_lf == "multi":
                for i in range(4):
                    _write_delta(sw, int(deltas_lf[sbr, sbc, i]), T["delta_q_lf_cdfs"][1 + i])
        sw.symbol(0, T["kf_y_mode_cdf"][0][0], 13)  # DC_PRED
        sw.symbol(0, T["uv_mode_cdf"][1][0], 14)  # DC_PRED, CFL allowed
        for p in range(3):
            k = 4 if p and sub else 8
            cols, rows = slice(k * c, k * c + k), slice(k * r, k * r + k)
            above, lft = ctx[p]
            if skip[r, c]:
                above[cols], lft[rows] = 0, 0
                continue
            coef = dc[p][r][c]
            skip_ctx = 0 if p == 0 else 7 + int(above[cols].any()) + int(lft[rows].any())
            sw.symbol(int(coef is None), T["txb_skip_cdfs"][qc][2 if p and sub else 3][skip_ctx], 2)
            if coef is None:
                above[cols], lft[rows] = 0, 0
                continue
            s = sum(sign_of(v) for v in above[cols]) + sum(sign_of(v) for v in lft[rows])
            cul = write_coefficients_32x32(sw, qc, int(p > 0), coef, 1 if s < 0 else 2 if s else 0,
                                           2 if p and sub else 3)
            above[cols] = lft[rows] = min(cul, 7) | (8 if coef[0][1] else 16)

    tiles = []
    for t, start in enumerate(tile_starts):
        if t:
            sw = SymbolWriter()
        first_col.add(start * sb // 32)
        if restoration is not None:
            restoration.reset()
        for sr in range(sb_rows):
            for p in range(3):  # av1_zero_left_context at each superblock row of a tile
                ctx[p][1][:] = 0
            for sc in range(start, min(start + tile_w, sb_cols)):
                if restoration is not None:
                    restoration.superblock(sw, sr * sb // 4, sc * sb // 4, sb // 4, ss)
                left = sc > start
                if sb128:
                    sw.symbol(3, T["partition_cdf"][16 + 2 * left + (sr > 0)], 8)
                for qr, qc_ in (((0, 0), (0, 1), (1, 0), (1, 1)) if sb128 else ((0, 0),)):
                    ur, uc = sr * (sb // 64) + qr, sc * (sb // 64) + qc_
                    sw.symbol(3, T["partition_cdf"][12 + 2 * (left or qc_ > 0) + (ur > 0)], 10)
                    for br, bc in ((0, 0), (0, 1), (1, 0), (1, 1)):
                        sw.symbol(0, T["partition_cdf"][8], 10)
                        block(2 * ur + br, 2 * uc + bc)
        tiles.append(sw.done())
    data = b"".join(struct.pack("<I", len(t) - 1) + t for t in tiles[:-1]) + tiles[-1]
    if len(tiles) > 1:
        data = b"\0" + data  # tile_start_and_end_present_flag 0, byte-aligned
    frame = bytes(int("".join(map(str, head.bits[i:i + 8])), 2) for i in range(0, len(head.bits), 8)) + data
    return obu(1, seq.trailing()) + obu(6, frame)


# base_q_idx 200 and levels (6, 5, 4, 3) unless a case says otherwise:
# each case against the same blocks written without its tool
WRITTEN = {
    "deltas_disabled": dict(deltas_enabled=False),
    "ref_deltas_updated": dict(ref_deltas={0: 6, 1: -3}, mode_deltas={0: 2}),
    "intra_delta_below_zero": dict(ref_deltas={0: -20}),
    "delta_lf_single": dict(delta_lf="single"),
    "delta_lf_multi": dict(delta_lf="multi", delta_lf_res=2),
    "segment_alt_lf": dict(segments={0: {1: 12, 2: -7}, 1: {0: 30, 3: 14, 4: -9}}),
    "three_segments": dict(segments={0: {1: -10}, 1: {2: 20}, 2: {3: 30, 4: 30}}),
    "luma_vertical_level_0": dict(levels=(0, 30, 0, 0)),
    "sharpness_5": dict(sharpness=5, levels=(40, 63, 0, 50)),
}


@functools.lru_cache(maxsize=None)
def written_file(name: str, seed: int) -> bytes:
    kw = {"segments": {0: {}}} if name == "base" else WRITTEN[name]
    return avif_file(filtered_frame(seed, **kw), w=256, h=128)


@pytest.mark.parametrize("name", list(WRITTEN))
def test_written_frames_decode_as_cv2(name):
    """Each tool changes the pixels (against the same blocks without it)
    and the port gives cv2's."""
    for seed in range(2):
        data = written_file(name, seed)
        assert answers(data) == "equal", seed
        base = port_decode(written_file("base", seed) if name.startswith(("segment", "three")) else
                           avif_file(filtered_frame(seed), w=256, h=128))
        assert (port_decode(data) != base).any(), seed


# -- the edge filters against libaom's ---------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def lpf_functions() -> dict:
    """{(vertical, length, form, isa): libaom's function}: forms "" (one
    4-sample segment), "_dual" (two, each with its own limits) and "_quad"
    (four, one set of limits), as many as the library holds."""
    lib = _libaom()
    u8p = ctypes.POINTER(ctypes.c_uint8)
    out = {}
    for vertical in (0, 1):
        for length in (4, 6, 8, 14):
            for form, nlim in (("", 3), ("_dual", 6), ("_quad", 3)):
                for isa in ("c", "sse2"):
                    name = f"aom_lpf_{'vertical' if vertical else 'horizontal'}_{length}{form}_{isa}"
                    if name in lib.syms:
                        out[vertical, length, form, isa] = lib.function(name, None, u8p, ctypes.c_int, *[u8p] * nlim)
    return out


def _limits(level: int, sharpness: int) -> tuple:
    """update_sharpness and av1_loop_filter_init: (blimit, limit, thresh)."""
    limit = level >> ((sharpness > 0) + (sharpness > 4))
    if sharpness > 0:
        limit = min(limit, 9 - sharpness)
    limit = max(limit, 1)
    return 2 * (level + 2) + limit, limit, level >> 4


def _simd_limits(values) -> list:
    """Each limit as libaom's loop_filter_thresh holds it: 16 bytes,
    16-byte aligned."""
    out = []
    for v in values:
        buf = np.zeros(48, np.uint8)
        at = -buf.ctypes.data % 16
        buf[at:at + 16] = v
        out.append(buf[at:at + 16])
    return out


def _edge_samples(rs, kind: int, vertical: bool) -> np.ndarray:
    """A 32x32 block across whose middle the filters run: noise, a flat
    area of ±1 (the flat paths), or a step between two noisy sides."""
    if kind == 0:
        return rs.randint(0, 256, (32, 32)).astype(np.uint8)
    blk = int(rs.randint(0, 256)) + rs.randint(-1 if kind == 1 else -6, 2 if kind == 1 else 7, (32, 32))
    if kind == 2:
        step = int(rs.randint(-24, 25))
        if vertical:
            blk[:, 16:] += step
        else:
            blk[16:] += step
    return np.clip(blk, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("length", [4, 6, 8, 14])
@pytest.mark.parametrize("vertical", [True, False], ids=["vertical", "horizontal"])
def test_each_edge_filter_is_libaoms(vertical, length):
    """Random, flat and stepped samples at every level and sharpness: the
    decoder's filter equals libaom's C and SSE2 functions on each of four
    segments, their _dual forms on two at a time (each with its own
    limits) and their _quad forms on all four, to the sample."""
    fns = {k[2:]: f for k, f in lpf_functions().items() if k[:2] == (int(vertical), length)}
    assert ("", "c") in fns and ("", "sse2") in fns and ("_dual", "sse2") in fns
    rs = np.random.RandomState(length * 2 + vertical)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    changed = 0
    for trial in range(900):
        sharpness = int(rs.randint(0, 8))
        lims = [_limits(int(rs.randint(0, 64)), sharpness) for _ in range(2)]
        seg_lims = [lims[k % 2] if trial % 2 else lims[0] for k in range(4)]
        blk = _edge_samples(rs, trial % 3, vertical)
        ours = blk.copy()
        for k in range(4):
            row, col = (8 + 4 * k, 16) if vertical else (16, 8 + 4 * k)
            native.av1_loop_filter(ours, row, col, vertical, length, *seg_lims[k])
        changed += (ours != blk).any()
        at = (8 * 32 + 16) if vertical else (16 * 32 + 8)
        seg = lambda a, k: ctypes.cast(a.ctypes.data + at + (4 * 32 * k if vertical else 4 * k), u8p)
        lim = lambda *ls: [x.ctypes.data_as(u8p) for v in ls for x in _simd_limits(v)]
        for (form, isa), fn in fns.items():
            theirs = blk.copy()
            if form == "":
                for k in range(4):
                    fn(seg(theirs, k), 32, *lim(seg_lims[k]))
            elif form == "_dual":
                for k in (0, 2):
                    fn(seg(theirs, k), 32, *lim(seg_lims[k], seg_lims[k + 1]))
            elif trial % 2 == 0:
                fn(seg(theirs, 0), 32, *lim(lims[0]))
            else:
                continue
            assert (theirs == ours).all(), (form, isa, trial, lims, sharpness)
    assert changed > 300


# -- damage ----------------------------------------------------------------------------------------

def fuzz_bases() -> dict:
    """Small filtered files the fuzz changes: cv2's default, Pillow's
    default, Pillow's with CDEF in 4:4:4, 4:2:2 and 4:2:0, cv2's with a
    CDEF index per unit (cdef_bits 1) and a written frame with delta lf and
    two index bits."""
    crop = np.ascontiguousarray(scene_crop()[:64, :96])
    cdef = [("enable-cdef", "1")]
    return {
        "filtered_cv2_default": cv2.imencode(".avif", crop)[1].tobytes(),
        "filtered_pillow_default": pil_avif(smooth(40, 56, 3, 6)),
        "filtered_cdef444": pil_avif(noise(24, 40, 3, 7), quality=20, subsampling="4:4:4", advanced=cdef),
        "filtered_cdef422": pil_avif(noise(24, 40, 3, 8), quality=20, subsampling="4:2:2", advanced=cdef),
        "filtered_cdef420": pil_avif(noise(24, 40, 3, 9), quality=20, subsampling="4:2:0", advanced=cdef),
        "filtered_cdef_bits": cv2_avif(crop, 6, 70),
        "filtered_written": avif_file(filtered_frame(3, delta_lf="multi", cdef=(5, 2, [(9, 6), (0, 3), (62, 0), (7, 17)]),
                                                     w=128, h=64), w=128, h=64),
    }


@functools.lru_cache(maxsize=None)
def bases() -> dict:
    return fuzz_bases()


def test_the_fuzz_bases_run_their_filters():
    """Each deblocks; CDEF filters all but Pillow's default (CDEF off) and
    cv2's q70 file, whose index bit picks strengths of 0 here."""
    for name, data in bases().items():
        assert answers(data) == "equal", name
        stats = decode_stats(item_data(data))
        cdef = stats[S["cdef_y"]] > 0 or name in ("filtered_pillow_default", "filtered_cdef_bits")
        assert lf_edges(item_data(data)).sum() > 0 and cdef, name
    assert decode_stats(item_data(bases()["filtered_cdef_bits"]))[S["cdef_bits"]] == 1


@pytest.mark.parametrize("name", list(fuzz_bases()))
def test_mutated_filtered_files_answer_as_cv2(name):
    got = collections.Counter(answers(d) for d in mutations(bases()[name], 200, seed=len(name) + 83))
    assert set(got) <= {"none", "equal", "known"}, got
    assert got["equal"] >= 5


def fuzz_files(round_: int, n: int = 2000) -> list:
    """One fuzz round's filtered files: ``n`` mutations of each base."""
    return [m for i, data in enumerate(bases().values()) for m in mutations(data, n, seed=10000 * round_ + i + 900)]


# -- what the card decodes ---------------------------------------------------------------------

def written_cases() -> dict:
    """For ``assets/image_cases.npz``: cv2's files of the crop at each
    quality (speed 6), Pillow's defaults, sharpness, monochrome, odd sizes,
    the written frames, and mutated and cut filtered files."""
    cases = {f"filtered_cv2_q{q}": cv2_avif(scene_crop(), 6, q) for q in (20, 50, 70, 90)}
    cases.update({f"filtered_pillow_{s.replace(':', '')}": pil_avif(smooth(64, 96, 3, 12), subsampling=s)
                  for s in ("4:2:0", "4:2:2", "4:4:4")})
    cases.update({f"filtered_sharpness_{k}": pil_avif(noise(40, 56, 3, k), quality=20, speed=6,
                                                      advanced=[("sharpness", str(k)), ("enable-cdef", "1")])
                  for k in (1, 4, 7)})
    cases["filtered_mono_q50"] = cv2_avif(cv2.cvtColor(scene_crop(), cv2.COLOR_BGR2GRAY), 6, 50)
    for h, w in ODD_SIZES[:8]:
        img = cv2.resize(scene_crop(), (w, h), interpolation=cv2.INTER_AREA) if h * w > 64 else noise(h, w, 3, w)
        cases[f"filtered_{h}x{w}"] = pil_avif(img, quality=30, subsampling="4:2:2", advanced=[("enable-cdef", "1")])
    cases.update({f"filtered_written_{k}": written_file(k, 0) for k in WRITTEN})
    for i, (name, data) in enumerate(bases().items()):
        cases.update({f"{name}_mutated_{k}": m for k, m in enumerate(mutations(data, 3, seed=i + 990))})
        cases[f"{name}_cut"] = data[: len(data) * 3 // 4]
    return {k: v for k, v in cases.items() if answers(v) != "known"}


def scene_payload(scene: np.ndarray) -> dict:
    """The serving scene as cv2's default AVIF (quality 50: deblocking and
    CDEF) and as Pillow's: the smoke's filtered payloads, the first also
    its request."""
    return {"scene0_avif_default": cv2.imencode(".avif", scene)[1].tobytes(), "scene0_avif_pillow": pil_avif(scene)}


def test_the_written_cases_and_the_payload_decode_as_cv2():
    cases = {**written_cases(), **scene_payload(scene_crop())}
    got = collections.Counter(answers(d) for d in cases.values())
    assert set(got) <= {"none", "equal"} and got["equal"] >= 30, got
