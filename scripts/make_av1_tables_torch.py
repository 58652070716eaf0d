"""Write ``ppocr_tpu_torch/csrc/av1_tables.h``: the default CDFs and the
constant tables of AV1's intra syntax, taken from libaom 3.14.1 as cv2 5.0
ships it (``opencv_python.libs/libaom-a0d22147.so.3.14.1``).

    python scripts/make_av1_tables_torch.py [--lib PATH] [--out PATH] [--check]

This script alone in the port reads libaom; it runs where the
opencv-python 5.0.0 wheel is installed. The decoder (``csrc/av1.cpp``)
includes the header and reads no library at run time.

How each table is found:

* The coefficient CDFs (``av1_default_*_cdfs``, all four q contexts and
  every transform size), the MV context that IntraBC's displacement
  reads, ``dr_intra_derivative``, the filter-intra taps, the smooth
  weights, the upsampling kernel and the 4x4 scans are objects of the
  library's symbol table: read at their addresses, by their names.
* The mode CDFs are not all objects of their own: the compiler copies
  several of them into the frame context from vector constants (which it
  shares between tables), so the bytes at one address are not the table.
  The script calls the library's own ``av1_init_mode_probs`` on a zeroed
  frame context and takes each table from that context, at the offset
  where its anchor (its first rows as the AV1 specification lists them,
  or the bytes of its symbol) occurs exactly once.
* The intra edge filter's kernels are folded into code: the script calls
  ``av1_filter_intra_edge_c`` on an impulse for each strength.
* The transform syntax's CDFs (``tx_size_cdf``, ``txfm_partition_cdf``,
  ``intra_ext_tx_cdf``, ``inter_ext_tx_cdf``) come from the frame context
  like the mode CDFs (by their anchors; a set of one type has zero rows).
  The transform sets (``av1_ext_tx_*``, ``ext_tx_set_index``), the size
  maps (``sub_tx_size_map``, ``max_txsize_rect_lookup``,
  ``txsize_sqr_*``, and ``av1_ss_size_lookup``, a block's size in a
  subsampled plane, 255 where it has none), the 8-bit ``dc_qlookup_QTX`` / ``ac_qlookup_QTX``,
  the quantiser matrices (``iwt_matrix_ref``, levels 0-14, luma and
  chroma, each size at its offset in ``av1_qm_init``'s order), the
  cos/sin rows of cos_bit 12 (``INV_COS_BIT``: libaom 3.14 has no inverse
  cos_bit table, every size uses 12) and the EOB tables are objects. The
  scans, ``nz_map_ctx_offset`` and the inverse shifts are reached through
  libaom's own pointer tables (``av1_scan_orders``, ``av1_nz_map_ctx_offset``,
  ``av1_inv_txfm_shift_ls``), read from the loaded library: the file holds
  them unrelocated. Each is checked (permutations, rising lookups, shapes,
  the mapping of types to scans).

* Loop restoration's CDFs come from the frame context like the mode
  CDFs; its self-guided tables (``av1_sgr_params``, ``av1_x_by_xplus1``,
  ``av1_one_by_x``) are objects, and so are superres's upscaling filter
  (``av1_resize_filter_normative``) and film grain's
  ``gaussian_sequence``.

The transform tables grew the header from 112,348 to 620,891 bytes
(+508,543), 420 kB of it the quantiser matrices.

Every CDF row is checked: its values strictly decrease and stay above 0,
then come the 0 of the last symbol, the 0 of the adaptation counter and
the row's padding zeros (a row of a one-type transform set is all zero). The script fails and writes nothing otherwise.
``--check`` compares the header it would write with the committed one
byte for byte instead of writing.
"""

from __future__ import annotations

import argparse
import ctypes
import glob
import os
import struct
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "ppocr_tpu_torch", "csrc", "av1_tables.h")
VERSION = "3.14.1"


def default_lib() -> str:
    import cv2  # only to find the wheel's libraries

    pattern = os.path.join(os.path.dirname(os.path.dirname(cv2.__file__)), "opencv_python.libs",
                           f"libaom-*.so.{VERSION}")
    found = sorted(glob.glob(pattern))
    if not found:
        raise SystemExit(f"no {pattern}")
    return found[0]


def elf_symbols(data: bytes) -> dict:
    """name → [(value, size)] of the ELF64 file's .symtab and .dynsym."""
    shoff, = struct.unpack_from("<Q", data, 0x28)
    shentsize, shnum = struct.unpack_from("<HH", data, 0x3A)
    secs = [struct.unpack_from("<IIQQQQIIQQ", data, shoff + i * shentsize) for i in range(shnum)]
    out = {}
    for sec in secs:
        if sec[1] not in (2, 11):  # SHT_SYMTAB, SHT_DYNSYM
            continue
        strtab = secs[sec[6]][4]
        for k in range(sec[5] // sec[9]):
            name, _info, _other, _shndx, value, size = struct.unpack_from("<IBBHQQ", data, sec[4] + k * sec[9])
            if name:
                end = data.index(b"\0", strtab + name)
                out.setdefault(data[strtab + name:end].decode(), []).append((value, size))
    return out


class Library:
    def __init__(self, path: str):
        self.path = path
        self.data = open(path, "rb").read()
        self.syms = elf_symbols(self.data)
        self.lib = ctypes.CDLL(path)
        self.base = ctypes.cast(self.lib.aom_codec_av1_dx, ctypes.c_void_p).value - self.sym("aom_codec_av1_dx")[0]

    def sym(self, name: str):
        (found,) = set(self.syms[name])  # one object (copies in several units hold the same bytes: checked)
        return found

    def object(self, name: str, dtype: str) -> np.ndarray:
        contents = {self.data[v:v + s] for v, s in self.syms[name]}
        if len(contents) != 1:
            raise SystemExit(f"{name}: {len(contents)} different objects")
        return np.frombuffer(contents.pop(), dtype).copy()

    def pointers(self, name: str, count: int) -> list:
        """The names of the objects a table of ``count`` pointers points to,
        read from the loaded library (the file holds them unrelocated)."""
        value, size = self.sym(name)
        raw = np.frombuffer(ctypes.string_at(self.base + value, size), "<u8")[:count]
        at = {v: n for n, found in self.syms.items() for v, _ in found}
        return [at[int(p) - self.base] for p in raw]

    def function(self, name: str, restype, *argtypes):
        return ctypes.CFUNCTYPE(restype, *argtypes)(self.base + self.sym(name)[0])


def icdf(*values) -> list:
    """An AOM_CDFn row as libaom stores it: 32768 − x, then the last
    symbol's 0 and the counter's 0."""
    return [32768 - v for v in values] + [0, 0]


# the mode CDFs: (name in the header, shape, symbols of each row, anchor) —
# an anchor is the rows the table begins with (from the AV1 specification's
# defaults) or the name of the library object whose bytes it is
MODE_CDFS = [
    ("kf_y_mode_cdf", (5, 5, 14), 13, "default_kf_y_mode_cdf"),
    ("uv_mode_cdf", (2, 13, 15), lambda i: 13 if i < 13 else 14, "default_uv_mode_cdf"),
    ("partition_cdf", (20, 11), lambda i: (4, 10, 10, 10, 8)[i // 4], "default_partition_cdf"),
    ("angle_delta_cdf", (8, 8), 7, icdf(2180, 5032, 7567, 22776, 26989, 30217)),
    ("intrabc_cdf", (3,), 2, icdf(30531)),
    ("palette_y_size_cdf", (7, 8), 7, icdf(7952, 13000, 18149, 21478, 25527, 29241)),
    ("palette_uv_size_cdf", (7, 8), 7, icdf(8713, 19979, 27128, 29609, 31331, 32272)),
    ("palette_y_color_index_cdf", (7, 5, 9), lambda i: i // 5 + 2, "default_palette_y_color_index_cdf"),
    ("palette_uv_color_index_cdf", (7, 5, 9), lambda i: i // 5 + 2, "default_palette_uv_color_index_cdf"),
    ("palette_y_mode_cdf", (7, 3, 3), 2, icdf(31676) + icdf(3419) + icdf(1261)),
    ("palette_uv_mode_cdf", (2, 3), 2, icdf(32461) + icdf(21488)),
    ("filter_intra_cdfs", (22, 3), 2, icdf(4621) + icdf(6743)),
    ("filter_intra_mode_cdf", (6,), 5, icdf(8949, 12776, 17211, 29558)),
    ("cfl_sign_cdf", (9,), 8, icdf(1418, 2123, 13340, 18405, 26972, 28343, 32294)),
    ("cfl_alpha_cdf", (6, 17), 16, icdf(7637, 20719, 31401, 32481, 32657, 32688, 32692, 32696, 32700, 32704,
                                        32708, 32712, 32716, 32720, 32724)),
    ("skip_cdf", (3, 3), 2, icdf(31671) + icdf(16515) + icdf(4576)),
    ("spatial_pred_seg_cdf", (3, 9), 8, icdf(5622, 7893, 16093, 18233, 27809, 28373, 32533)),
    # delta_q_cdf, delta_lf_multi_cdf[4] and delta_lf_cdf lie one after
    # another in the frame context and hold the same row: anchored together
    ("delta_q_lf_cdfs", (6, 5), 4, icdf(28160, 32120, 32677) * 6),
    # the transform syntax: tx_size_cdf[category][context] (2 symbols in the
    # first category, 3 in the others; rows padded to 4), the var-tx split
    # flags, and the transform types by set (set 0 has one type: zero rows)
    ("tx_size_cdf", (4, 3, 4), lambda i: 2 if i < 3 else 3,
     (icdf(19968) + [0]) * 2 + icdf(24320) + [0] + icdf(12272, 30172) * 2 + icdf(18677, 30848)
     + icdf(12986, 15180) * 2 + icdf(24302, 25602) + icdf(5782, 11475) * 2 + icdf(16803, 22759)),
    ("txfm_partition_cdf", (21, 3), 2, icdf(28581) + icdf(23846) + icdf(20847) + icdf(24315) + icdf(18196)
     + icdf(12133)),
    ("intra_ext_tx_cdf", (3, 4, 13, 17), lambda i: (0, 7, 5)[i // 52], "default_intra_ext_tx_cdf"),
    ("inter_ext_tx_cdf", (4, 4, 17), lambda i: (0, 16, 12, 2)[i // 4], "default_inter_ext_tx_cdf"),
    # loop restoration: a unit's type in a SWITCHABLE plane (NONE, WIENER,
    # SGRPROJ), and whether a unit of a WIENER or an SGRPROJ plane filters
    ("switchable_restore_cdf", (4,), 3, icdf(9413, 22581)),
    ("wiener_restore_cdf", (3,), 2, icdf(11570)),
    ("sgrproj_restore_cdf", (3,), 2, icdf(16855)),
]

# the coefficient CDFs: library object, shape, symbols of each row
COEF_CDFS = [
    ("txb_skip_cdfs", "av1_default_txb_skip_cdfs", (4, 5, 13, 3), 2),
    ("eob_extra_cdfs", "av1_default_eob_extra_cdfs", (4, 5, 2, 9, 3), 2),
    ("dc_sign_cdfs", "av1_default_dc_sign_cdfs", (4, 2, 3, 3), 2),
    ("eob_multi16_cdfs", "av1_default_eob_multi16_cdfs", (4, 2, 2, 6), 5),
    ("eob_multi32_cdfs", "av1_default_eob_multi32_cdfs", (4, 2, 2, 7), 6),
    ("eob_multi64_cdfs", "av1_default_eob_multi64_cdfs", (4, 2, 2, 8), 7),
    ("eob_multi128_cdfs", "av1_default_eob_multi128_cdfs", (4, 2, 2, 9), 8),
    ("eob_multi256_cdfs", "av1_default_eob_multi256_cdfs", (4, 2, 2, 10), 9),
    ("eob_multi512_cdfs", "av1_default_eob_multi512_cdfs", (4, 2, 2, 11), 10),
    ("eob_multi1024_cdfs", "av1_default_eob_multi1024_cdfs", (4, 2, 2, 12), 11),
    ("coeff_base_eob_cdfs", "av1_default_coeff_base_eob_multi_cdfs", (4, 5, 2, 4, 4), 3),
    ("coeff_base_cdfs", "av1_default_coeff_base_multi_cdfs", (4, 5, 2, 42, 5), 4),
    ("coeff_br_cdfs", "av1_default_coeff_lps_multi_cdfs", (4, 5, 2, 21, 5), 4),
]

# nmv_context: joints, then two components of classes, class0_fp[2], fp,
# sign, class0_hp, hp, class0, bits[10]
NMV_ROWS = [5] + [12, 5, 5, 5, 3, 3, 3, 3] + [3] * 10
NMV_ROWS = NMV_ROWS[:1] + NMV_ROWS[1:] * 2


def check_rows(name: str, table: np.ndarray, symbols):
    rows = table.reshape(-1, table.shape[-1]) if table.ndim > 1 else table[None]
    for i, row in enumerate(rows):
        n = symbols(i) if callable(symbols) else symbols
        if n == 0:  # a set of one symbol, never read
            if row.any():
                raise SystemExit(f"{name} row {i}: not zero: {row.tolist()}")
            continue
        vals, rest = row[: n - 1].astype(np.int64), row[n - 1:]
        if not ((vals > 0).all() and (vals < 32768).all() and (np.diff(vals) < 0).all() and not rest.any()):
            raise SystemExit(f"{name} row {i}: not an inverted CDF of {n} symbols: {row.tolist()}")


def frame_context(lib: Library) -> np.ndarray:
    """The frame context ``av1_init_mode_probs`` writes (its last store is
    below 0x6100 bytes; 64 KiB are given)."""
    buf = (ctypes.c_uint16 * 32768)()
    lib.function("av1_init_mode_probs", None, ctypes.c_void_p)(ctypes.addressof(buf))
    return np.frombuffer(bytes(buf), "<u2").copy()


def find_once(haystack: bytes, needle: bytes, what: str) -> int:
    at = haystack.find(needle)
    if at < 0 or haystack.find(needle, at + 1) >= 0:
        raise SystemExit(f"{what}: the anchor occurs {'no' if at < 0 else 'more than one'} time")
    if at % 2:
        raise SystemExit(f"{what}: the anchor is not 16-bit aligned")
    return at // 2


def edge_kernels(lib: Library) -> np.ndarray:
    """``av1_filter_intra_edge_c(p, sz, strength)``: p[i] = (Σ k[j] ·
    p[i − 2 + j] + 8) >> 4 for i ≥ 1, so an impulse of 16 gives the taps."""
    fn = lib.function("av1_filter_intra_edge_c", None, ctypes.c_void_p, ctypes.c_int, ctypes.c_int)
    out = []
    for strength in (1, 2, 3):
        p = (ctypes.c_uint8 * 16)()
        p[8] = 16
        fn(ctypes.addressof(p), 16, strength)
        out.append([p[i] for i in range(10, 5, -1)])
    return np.array(out, np.int64)


def tables(lib: Library) -> list:
    """[(C type, name, array)] in the header's order."""
    fc = frame_context(lib)
    raw = fc.tobytes()
    out = []
    for name, shape, symbols, anchor in MODE_CDFS:
        needle = lib.object(anchor, "<u2").tobytes() if isinstance(anchor, str) else np.asarray(
            anchor, "<u2").tobytes()
        at = find_once(raw, needle, name)
        table = fc[at: at + int(np.prod(shape))].reshape(shape)
        check_rows(name, table, symbols)
        out.append(("uint16_t", name, table))
    nmv = lib.object("default_nmv_context", "<u2")
    if len(nmv) != sum(r for r in NMV_ROWS):
        raise SystemExit(f"default_nmv_context: {len(nmv)} values")
    at = 0
    for r in NMV_ROWS:
        check_rows("nmv_context", nmv[at: at + r], r - 1)
        at += r
    out.append(("uint16_t", "nmv_context", nmv))
    for name, obj, shape, symbols in COEF_CDFS:
        table = lib.object(obj, "<u2")
        if table.size != np.prod(shape):
            raise SystemExit(f"{obj}: {table.size} values, not {np.prod(shape)}")
        table = table.reshape(shape)
        check_rows(name, table, symbols)
        out.append(("uint16_t", name, table))
    deriv = lib.object("dr_intra_derivative", "<i2")
    if deriv[3] != 1023 or deriv[87] != 3 or deriv.size != 90:
        raise SystemExit("dr_intra_derivative: not the 90 derivatives")
    out.append(("int16_t", "dr_intra_derivative", deriv))
    taps = lib.object("av1_filter_intra_taps", "i1").reshape(5, 8, 8)
    if taps[..., 7].any() or (taps.sum(-1) != 16).any():
        raise SystemExit("av1_filter_intra_taps: a row does not sum to 16")
    out.append(("int8_t", "filter_intra_taps", taps[..., :7]))
    weights = lib.object("smooth_weights", "u1")
    if weights[:4].tolist() != [255, 149, 85, 64] or weights.size != 124:
        raise SystemExit("smooth_weights: not the weights of sizes 4 to 64")
    out.append(("uint8_t", "smooth_weights", weights))
    edge = edge_kernels(lib)
    if (edge.sum(1) != 16).any():
        raise SystemExit(f"intra edge kernels: {edge.tolist()}")
    out.append(("uint8_t", "intra_edge_kernel", edge))
    up = lib.object("kernel.4", "i1")
    if up[:4].tolist() != [-1, 9, 9, -1]:
        raise SystemExit("the upsampling kernel is not (-1, 9, 9, -1)")
    out.append(("int8_t", "intra_edge_upsample_kernel", up[:4]))
    for scan in ("default_scan_4x4", "mrow_scan_4x4", "mcol_scan_4x4"):
        s = lib.object(scan, "<i2")
        if sorted(s.tolist()) != list(range(16)):
            raise SystemExit(f"{scan}: not a permutation of 16")
        out.append(("int16_t", scan, s))
    out += transform_tables(lib)
    out += restoration_tables(lib)
    out += post_filter_tables(lib)
    return out


def restoration_tables(lib: Library) -> list:
    """Loop restoration's self-guided filter: ``av1_sgr_params`` (per set
    the radii r0, r1 and the scales s0, s1; a radius of 0 skips its pass),
    ``av1_x_by_xplus1`` (the blend factor A of z) and ``av1_one_by_x``
    (round(2^12 / n) for the box of n samples)."""
    sgr = lib.object("av1_sgr_params", "<i4").reshape(16, 4)
    if not ((sgr[:, 0] == 0) | (sgr[:, 0] == 2)).all() or not ((sgr[:, 1] == 0) | (sgr[:, 1] == 1)).all() \
            or ((sgr[:, 0] == 0) & (sgr[:, 1] == 0)).any():
        raise SystemExit(f"av1_sgr_params: not radii (2 or 0, 1 or 0): {sgr.tolist()}")
    xbx = lib.object("av1_x_by_xplus1", "<i4")
    if xbx.size != 256 or xbx[0] != 1 or xbx[-1] != 256 or (np.diff(xbx) < 0).any():
        raise SystemExit("av1_x_by_xplus1: not 256 rising factors from 1 to 256")
    obx = lib.object("av1_one_by_x", "<i4")
    if obx.size != 25 or obx[0] != 4096 or (np.abs(obx - np.round(4096 / np.arange(1, 26))) > 0).any():
        raise SystemExit("av1_one_by_x: not round(4096 / n) for n of 1 to 25")
    return [("int32_t", "sgr_params", sgr), ("int32_t", "x_by_xplus1", xbx), ("int32_t", "one_by_x", obx)]


def post_filter_tables(lib: Library) -> list:
    """What runs after loop restoration: superres's normative upscaling
    filter (``av1_resize_filter_normative``: 64 phases of 8 taps, each
    summing to 128) and film grain's ``gaussian_sequence`` (2,048 samples
    of [-2048, 2047], their mean near 0 and their deviation near 512)."""
    rs = lib.object("av1_resize_filter_normative", "<i2").reshape(64, 8)
    if not (rs.sum(1) == 128).all() or rs[0].tolist() != [0, 0, 0, 128, 0, 0, 0, 0]:
        raise SystemExit("av1_resize_filter_normative: not 64 phases of 8 taps summing to 128 from the identity")
    gs = lib.object("gaussian_sequence", "<i4")
    if gs.size != 2048 or gs.min() < -2048 or gs.max() > 2047 or abs(gs.mean()) > 16 or not 400 < gs.std() < 600:
        raise SystemExit("gaussian_sequence: not 2,048 samples of [-2048, 2047] about 0 with a deviation near 512")
    return [("int16_t", "resize_filter_normative", rs), ("int32_t", "gaussian_sequence", gs)]


# libaom's TX_SIZE order and each size's width and height
TX_NAMES = ("4x4 8x8 16x16 32x32 64x64 4x8 8x4 8x16 16x8 16x32 32x16 32x64 64x32 4x16 16x4 8x32 32x8 16x64 "
            "64x16").split()
TX_WH = [tuple(int(v) for v in n.split("x")) for n in TX_NAMES]


def adjusted(t: int) -> int:
    """``av1_get_adjusted_tx_size``: a side of 64 codes as 32."""
    w, h = TX_WH[t]
    return TX_NAMES.index(f"{min(w, 32)}x{min(h, 32)}")


def transform_tables(lib: Library) -> list:
    """The tables of the transform syntax, the dequantisation and the
    inverse transforms."""
    out = []
    small = [("sub_tx_size_map", "u1", "uint8_t"), ("max_txsize_rect_lookup", "u1", "uint8_t"),
             ("txsize_sqr_map", "u1", "uint8_t"), ("txsize_sqr_up_map", "u1", "uint8_t"),
             ("av1_ext_tx_set_lookup", "u1", "uint8_t"), ("ext_tx_set_index", "<i4", "int8_t"),
             ("av1_num_ext_tx_set", "<i4", "uint8_t"), ("av1_ext_tx_inv", "<i4", "uint8_t"),
             ("av1_ext_tx_used", "<i4", "uint8_t"), ("vtx_tab", "u1", "uint8_t"), ("htx_tab", "u1", "uint8_t"),
             ("fimode_to_intradir", "u1", "uint8_t"), ("nz_map_ctx_offset_1d", "<i4", "int8_t"),
             ("av1_eob_group_start", "<i2", "int16_t"), ("av1_eob_offset_bits", "<i2", "int8_t"),
             ("av1_ss_size_lookup", "u1", "uint8_t")]
    shapes = {"av1_ext_tx_set_lookup": (2, 2), "ext_tx_set_index": (2, 6), "av1_ext_tx_inv": (6, 16),
              "av1_ext_tx_used": (6, 16), "av1_ss_size_lookup": (22, 2, 2)}
    for name, dtype, ctype in small:
        a = lib.object(name, dtype)
        out.append((ctype, name.removeprefix("av1_"), a.reshape(shapes.get(name, a.shape))))
    wide, high = lib.object("tx_size_wide", "<i4"), lib.object("tx_size_high", "<i4")
    if list(zip(wide, high)) != TX_WH:
        raise SystemExit("tx_size_wide / tx_size_high: not libaom's TX_SIZE order")
    mode_types = lib.object("_intra_mode_to_tx_type.1", "u1")
    for copy in ("_intra_mode_to_tx_type.9", "_intra_mode_to_tx_type.16"):
        if (lib.object(copy, "u1") != mode_types).any():
            raise SystemExit(f"{copy}: another intra mode to transform type table")
    out.append(("uint8_t", "intra_mode_to_tx_type", mode_types))
    if (lib.object("av1_num_ext_tx_set", "<i4") != (1, 2, 5, 7, 12, 16)).any():
        raise SystemExit("av1_num_ext_tx_set: not the six sets")
    # the scans of each size (a 64-sample side codes as 32: no scan of its
    # own), default / mrow / mcol, one after another
    data, start = [], np.zeros((19, 3), np.int32)
    for t, name in enumerate(TX_NAMES):
        if adjusted(t) != t:
            start[t] = start[adjusted(t)]
            continue
        for k, kind in enumerate(("default", "mrow", "mcol")):
            s = lib.object(f"{kind}_scan_{name}", "<i2")
            if sorted(s.tolist()) != list(range(TX_WH[t][0] * TX_WH[t][1])):
                raise SystemExit(f"{kind}_scan_{name}: not a permutation")
            start[t, k] = sum(len(d) for d in data)
            data.append(s)
    orders = lib.pointers("av1_scan_orders", 19 * 16 * 2)[::2]  # {scan, iscan} per size and type
    for t, name in enumerate(TX_NAMES):
        a = TX_NAMES[adjusted(t)]
        want = ["default"] * 10 + ["mrow", "mcol"] * 3
        if orders[t * 16:(t + 1) * 16] != [f"{k}_scan_{a}" for k in want]:
            raise SystemExit(f"av1_scan_orders[{name}]: not default for the 2-D types, mrow / mcol for the 1-D ones")
    out.append(("int16_t", "scan_data", np.concatenate(data)))
    out.append(("int32_t", "scan_start", start))
    # nz_map_ctx_offset by size, read through libaom's own pointer table
    # (several sizes share an object: 8x4 reads the first half of 16x4's)
    data, start, seen = [], np.zeros(19, np.int32), {}
    for t, name in enumerate(lib.pointers("av1_nz_map_ctx_offset", 19)):
        w, h = TX_WH[adjusted(t)]
        if name not in seen:
            seen[name] = sum(len(d) for d in data)
            data.append(lib.object(name, "i1"))
        if w * h > len(data[list(seen).index(name)]):
            raise SystemExit(f"{name}: shorter than {TX_NAMES[t]}'s {w * h} contexts")
        start[t] = seen[name]
    out.append(("int8_t", "nz_map_ctx_offset_data", np.concatenate(data)))
    out.append(("int32_t", "nz_map_ctx_offset_start", start))
    shifts = np.array([lib.object(n, "i1") for n in lib.pointers("av1_inv_txfm_shift_ls", 19)])
    if shifts.shape != (19, 2) or (shifts > 0).any():
        raise SystemExit("av1_inv_txfm_shift_ls: not two right shifts per size")
    out.append(("int8_t", "inv_txfm_shift", shifts))
    # cos_bit 12 (INV_COS_BIT) is the third row (cos_bit_min is 10)
    cospi = lib.object("av1_cospi_arr_data", "<i4").reshape(-1, 64)[2]
    sinpi = lib.object("av1_sinpi_arr_data", "<i4").reshape(-1, 5)[2]
    if cospi[0] != 4096 or cospi[32] != 2896 or sinpi.tolist() != [0, 1321, 2482, 3344, 3803]:
        raise SystemExit("av1_cospi_arr_data / av1_sinpi_arr_data: not the 12-bit rows")
    out.append(("int16_t", "cospi", cospi))
    out.append(("int16_t", "sinpi", sinpi))
    for name in ("dc_qlookup_QTX", "ac_qlookup_QTX"):
        q = lib.object(name, "<i2")
        if q.size != 256 or (np.diff(q) < 0).any() or q[0] != 4:
            raise SystemExit(f"{name}: not 256 rising 8-bit steps")
        out.append(("int16_t", name.removesuffix("_QTX"), q))
    # the inverse quantiser matrices of levels 0-14 (15 is flat), luma and
    # chroma, each size's in av1_qm_init's order (a side of 64 reuses 32)
    iwt = lib.object("iwt_matrix_ref", "u1").reshape(15, 2, -1)
    qm_start, at = np.zeros(19, np.int32), 0
    for t in range(19):
        if adjusted(t) == t:
            qm_start[t] = at
            at += TX_WH[t][0] * TX_WH[t][1]
        else:
            qm_start[t] = qm_start[adjusted(t)]
    if iwt.shape[2] != at or not (iwt > 0).all():
        raise SystemExit(f"iwt_matrix_ref: {iwt.shape[2]} weights per level and plane, not {at}")
    out.append(("uint8_t", "iwt_matrix", iwt))
    out.append(("int32_t", "qm_start", qm_start))
    return out


def c_array(ctype: str, name: str, a: np.ndarray) -> str:
    dims = "".join(f"[{d}]" for d in a.shape)
    width = a.shape[-1] if a.shape[-1] <= 64 else 32
    flat = [str(int(v)) for v in a.reshape(-1)]
    lines = [", ".join(flat[i: i + width]) for i in range(0, len(flat), width)]
    body = ",\n    ".join(lines)
    return f"static const {ctype} {name}{dims} = {{\n    {body}}};\n"


def render(lib: Library, found: list) -> str:
    head = (f"// AV1's default CDFs and the constant tables of its intra syntax, as libaom {VERSION}\n"
            f"// (the copy in the opencv-python 5.0.0 wheel, {os.path.basename(lib.path)}) holds them.\n"
            "// Written by scripts/make_av1_tables_torch.py; do not edit. A CDF row is libaom's\n"
            "// inverted form: 32768 - cdf for each symbol but the last, the last symbol's 0, then\n"
            "// the adaptation counter (0), then zeros up to the row's declared width; rows are\n"
            "// indexed as libaom indexes them (coefficient tables by [q context][tx size]...).\n"
            "#pragma once\n#include <cstdint>\n\nnamespace av1tab {\n\n")
    return head + "\n".join(c_array(*t) for t in found) + "\n}  // namespace av1tab\n"


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--lib", default=None, help=f"libaom {VERSION} (default: the cv2 wheel's)")
    p.add_argument("--out", default=OUT)
    p.add_argument("--check", action="store_true", help="compare with the committed header, write nothing")
    args = p.parse_args()
    lib = Library(args.lib or default_lib())
    text = render(lib, tables(lib))
    if args.check:
        same = os.path.exists(args.out) and open(args.out).read() == text
        print(f"{args.out}: {'reproduced byte for byte' if same else 'DIFFERS from what the library gives'}")
        return 0 if same else 1
    with open(args.out, "w") as f:
        f.write(text)
    print(f"wrote {args.out} ({len(text)} bytes) from {lib.path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
