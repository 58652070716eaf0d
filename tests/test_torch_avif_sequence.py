"""AVIF image sequences (``avis``: a ``moov`` box of tracks) through the
port's decoder (``utils/imcodec.py``: the ``moov`` box and its sample
tables as libavif 1.4.2 reads them, the source and the tracks libavif
picks; ``csrc/av1.cpp``: the first sample) against ``cv2.imdecode(buf,
IMREAD_COLOR)`` and ``cv2.imread`` (OpenCV 5.0 over libavif 1.4.2 and
libaom 3.14.1), which answer with the first frame: the same ``None`` or
not, and 0 differing pixels.

The files come from cv2's ``imencodeanimation`` and Pillow's
``save_all=True`` (2 and 5 frames, lossless and lossy, 4:4:4 and 4:2:0,
RGBA with an alpha track, odd sizes), and from the sequence writer here
(``seq_file``: tracks of cv2's still streams, with or without a primary
item, every box and table of a track as asked: co64, chunks, several
colour tracks, sync samples, tkhd sizes, edit lists, a moov of size 0, a
sample past the end of the data). Then cut, XOR-ed and mutated files,
and files read by path.

    python -m pytest tests/test_torch_avif_sequence.py -q
"""

import io
import struct

import cv2
import numpy as np
import pytest
from PIL import Image

from ppocr_tpu_torch.utils import imcodec
from test_torch_avif import (Bits, avif_file, bits_of, box, colr, cv2_avif, full_box, full_headers, hdlr, item_data,
                             mutations, noise, obu, read_answers, smooth, split_obus, text)
from test_torch_tiff import answers, cv2_decode, port_decode

# -- the writers -------------------------------------------------------------------------


def cv2_sequence(frames, quality=100, speed=6) -> bytes:
    """cv2's animated AVIF (``imencodeanimation``) of BGR or BGRA frames."""
    anim = cv2.Animation()
    anim.frames = list(frames)
    anim.durations = [100] * len(frames)
    ok, buf = cv2.imencodeanimation(".avif", anim, [cv2.IMWRITE_AVIF_QUALITY, quality, cv2.IMWRITE_AVIF_SPEED, speed])
    assert ok
    return buf.tobytes()


def pil_sequence(frames, **kw) -> bytes:
    """Pillow's animated AVIF (``save_all=True``) of BGR or BGRA frames."""
    ims = [Image.fromarray(np.ascontiguousarray(f[..., [2, 1, 0, 3][:f.shape[2]]])) for f in frames]
    buf = io.BytesIO()
    ims[0].save(buf, "AVIF", save_all=True, append_images=ims[1:], **kw)
    return buf.getvalue()


u32 = lambda *v: struct.pack(f">{len(v)}I", *v)
MATRIX = u32(0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)


def mvhd(version=0) -> bytes:
    times = bytes(16) + u32(1000) + bytes(8) if version else bytes(8) + u32(1000) + bytes(4)
    return full_box(b"mvhd", version, 0, times + u32(0x10000) + b"\x01\x00" + bytes(10) + MATRIX + bytes(24) + u32(9))


def tkhd(track_id, w, h, version=0, flags=1, fixed=None, duration=300) -> bytes:
    n = 8 if version else 4
    wh = fixed if fixed is not None else (w << 16, h << 16)
    return full_box(b"tkhd", version, flags, bytes(2 * n) + u32(track_id, 0) + duration.to_bytes(n, "big") + bytes(16)
                    + MATRIX + u32(*wh))


def mdhd(version=0) -> bytes:
    times = bytes(16) + u32(1000) + bytes(8) if version else bytes(8) + u32(1000, 100)
    return full_box(b"mdhd", version, 0, times + b"\x55\xc4\0\0")


def elst(version=0, flags=1, count=1, duration=100) -> bytes:
    entry = (struct.pack(">Qq", duration, 0) if version else struct.pack(">Ii", duration, 0)) + u32(0x10000)
    return full_box(b"elst", version, flags, u32(count) + entry * max(count, 1))


def av01_entry(w, h, props: bytes, fmt=b"av01") -> bytes:
    """A VisualSampleEntry (78 bytes of fields) and its boxes."""
    fields = bytes(6) + b"\0\x01" + bytes(16) + struct.pack(">HH", w, h) + u32(0x480000, 0x480000, 0) + b"\0\x01"
    fields += bytes(32) + b"\0\x18\xff\xff"
    assert len(fields) == 78
    return box(fmt, fields + props)


def stsd(*entries) -> bytes:
    return full_box(b"stsd", 0, 0, u32(len(entries)) + b"".join(entries))


def stts(n) -> bytes:
    return full_box(b"stts", 0, 0, u32(1, n, 100))


def stsc(entries) -> bytes:
    return full_box(b"stsc", 0, 0, u32(len(entries)) + b"".join(u32(first, per, 1) for first, per in entries))


def stsz(sizes, all_size=0) -> bytes:
    return full_box(b"stsz", 0, 0, u32(all_size, len(sizes)) + (b"" if all_size else u32(*sizes)))


def stco(offsets, co64=False) -> bytes:
    if co64:
        return full_box(b"co64", 0, 0, u32(len(offsets)) + struct.pack(f">{len(offsets)}Q", *offsets))
    return full_box(b"stco", 0, 0, u32(len(offsets), *offsets))


def stss(numbers) -> bytes:
    return full_box(b"stss", 0, 0, u32(len(numbers), *numbers))


def props_of(still: bytes) -> bytes:
    """The av1C and colr boxes of a still AVIF's first item, for a sample
    entry."""
    out = b""
    for kind in (b"av1C", b"colr"):
        at = still.find(kind)
        if at >= 0:
            out += still[at - 4:at - 4 + struct.unpack(">I", still[at - 4:at])[0]]
    return out


LEAN = dict(mdhd=b"", hdlr=b"", edts=b"", stts=b"", minf_head=b"", sync=None)  # what libavif needs of a trak only


class Track:
    """A trak of ``samples``: ``chunks`` (samples per chunk, in order;
    default one chunk), and any box replaced or added (``boxes``: name →
    bytes; ``stsc``, ``stsz``, ``stco``, ``stss``, ``stts``, ``stsd``,
    ``tkhd``, ``mdhd``, ``edts``, ``tref``, ``hdlr``, ``minf_head``
    (vmhd and dinf), ``extra`` (more children of the trak), ``stbl_extra``,
    ``mdia_extra``)."""

    def __init__(self, track_id, w, h, samples, props, aux_for=0, chunks=None, co64=False, sync=(1,),
                 gap=0, **boxes):
        self.id, self.w, self.h, self.samples, self.props = track_id, w, h, list(samples), props
        self.aux_for, self.co64, self.sync, self.gap = aux_for, co64, sync, gap
        self.chunks = chunks or [len(self.samples)]
        assert sum(self.chunks) == len(self.samples)
        self.boxes = boxes

    def payload(self) -> bytes:
        """The samples as they lie in the media data: each chunk's in a
        row, ``gap`` bytes between chunks."""
        out, k = b"", 0
        for n in self.chunks:
            out += b"".join(self.samples[k:k + n]) + bytes(self.gap)
            k += n
        return out

    def trak(self, at: int) -> bytes:
        b = self.boxes
        offsets, pos, k = [], at, 0
        for n in self.chunks:
            offsets.append(pos)
            pos += sum(len(s) for s in self.samples[k:k + n]) + self.gap
            k += n
        entries = [(1, self.chunks[0])] + [(i + 1, n) for i, n in enumerate(self.chunks) if i and n != self.chunks[i - 1]]
        stbl = box(b"stbl", b.get("stsd", stsd(av01_entry(self.w, self.h, self.props))) + b.get("stts", stts(len(
            self.samples))) + b.get("stsc", stsc(entries)) + b.get("stsz", stsz([len(s) for s in self.samples]))
            + b.get("stco", stco(offsets, self.co64)) + (b.get("stss", stss(self.sync)) if self.sync is not None
                                                         else b"") + b.get("stbl_extra", b""))
        minf = box(b"minf", b.get("minf_head", full_box(b"vmhd", 0, 1, bytes(8)) + box(b"dinf", full_box(
            b"dref", 0, 0, u32(1) + full_box(b"url ", 0, 1, b"")))) + stbl)
        mdia = box(b"mdia", b.get("mdhd", mdhd()) + b.get("hdlr", hdlr(b"auxv" if self.aux_for else b"pict")) + minf
                   + b.get("mdia_extra", b""))
        tref = b.get("tref", box(b"tref", box(b"auxl", u32(self.aux_for))) if self.aux_for else b"")
        return box(b"trak", b.get("tkhd", tkhd(self.id, self.w, self.h)) + tref + b.get("edts", box(b"edts", elst()))
                   + mdia + b.get("extra", b""))


SEQ_COMPAT = (b"avis", b"msf1", b"iso8", b"miaf")


def seq_file(tracks, *, major=b"avis", compat=None, item=None, moov_first=False, moov_last=False, moov_extra=b"",
             mvhd_box=None, moov_size=None, tail=b"") -> bytes:
    """ftyp, a still's meta (``item``: (stream, w, h, props) for a primary
    item, in its own mdat before the moov, in an idat after it) and a moov
    of ``tracks``, their samples in one mdat after the moov (before it:
    ``moov_last``), then ``tail``; the moov before or after the meta.
    ``moov_size`` overrides the moov's size field (0: to the end)."""
    if compat is None:
        compat = (b"avif", b"mif1") + SEQ_COMPAT if item is not None else SEQ_COMPAT
    samples = box(b"mdat", b"".join(t.payload() for t in tracks))

    def moov(at):
        traks, pos = b"", at
        for t in tracks:
            traks += t.trak(pos)
            pos += len(t.payload())
        out = box(b"moov", (mvhd() if mvhd_box is None else mvhd_box) + traks + moov_extra)
        return out if moov_size is None else struct.pack(">I", moov_size) + out[4:]

    def assemble(at):
        m = moov(at)
        if item is None:
            head = box(b"ftyp", major + bytes(4) + b"".join(compat))
        else:
            stream, w, h, props = item
            kw = dict(w=w, h=h, major=major, compat=compat, color_props=props)
            # after the meta, the item's data is in an idat: an mdat between
            # them would put the moov's header past cv2's signature window
            head = (avif_file(stream, before_meta=m, **kw) if moov_first
                    else avif_file(stream, idat=True, iloc_version=1, **kw))
            if moov_first:
                return head, head + samples
        if moov_last:
            return head, head + samples + m
        return head + m, head + m + samples

    head, _ = assemble(0)
    return assemble(len(head) + 8)[1] + tail


# -- AV1 units of more than one frame ---------------------------------------------------------


def hidden_key(still: bytes, *, refresh=0xFF, showable=1, shows=(0,)) -> bytes:
    """A still stream of cv2's (reduced still-picture header) as a hidden
    key frame (show_frame 0, ``showable``, ``refresh`` as its
    refresh_frame_flags) in the full header forms (frame ids of a length
    that keeps the tile data byte-aligned), then a show_existing_frame
    header for each slot of ``shows``."""
    fb = bits_of(next(p for k, p in split_obus(still) if k == 6))
    id_len = next(n for n in range(3, 19) if (5 + (0 if fb[0] else 1) + n + 10) % 8 == 0)
    obus = split_obus(full_headers(still, frame_ids=id_len, still=0))
    frame = bits_of(obus[-1][1])
    head = 4 + 2 + fb[1]  # show_existing .. show_frame, disable_cdf_update, allow_screen_content_tools, force_integer_mv
    at = head + id_len + 1  # current_frame_id, frame_size_override_flag: refresh_frame_flags goes here
    bits = frame[:3] + [0, showable, 0] + frame[4:at] + [(refresh >> (7 - i)) & 1 for i in range(8)] + frame[at:]
    bits = bits[:len(bits) - len(bits) % 8]  # the zeros full_headers padded its misaligned frame with
    out = obu(2, b"") + obu(1, obus[1][1]) + obu(6, bytes(int("".join(map(str, bits[i:i + 8])), 2)
                                                    for i in range(0, len(bits), 8)))
    for slot in shows:
        out += obu(3, Bits().f(1, 1).f(slot, 3).f(3, id_len).trailing())
    return out


# -- cv2's and Pillow's sequences ------------------------------------------------------------


def frames_of(kind, h, w, c, n, seed):
    """``n`` frames: the first of ``kind``, the others cheap changes of it."""
    first = kind(h, w, c, seed)
    return [first] + [np.roll(first, 3 * k, axis=1) for k in range(1, n)]


def writer_files() -> dict:
    """cv2's and Pillow's sequences: 2 and 5 frames, lossless and lossy,
    4:4:4 and 4:2:0, alpha tracks, odd sizes."""
    out = {}
    for n in (2, 5):
        out[f"cv2_q100_{n}"] = cv2_sequence(frames_of(smooth, 48, 64, 3, n, n))
        out[f"cv2_q50_{n}"] = cv2_sequence(frames_of(smooth, 48, 64, 3, n, n + 1), 50)
        out[f"pil_q60_{n}"] = pil_sequence(frames_of(smooth, 48, 64, 3, n, n + 2), quality=60)
    out["cv2_q90_text"] = cv2_sequence(frames_of(text, 64, 128, 3, 2, 3), 90)
    out["cv2_rgba_q100"] = cv2_sequence(frames_of(noise, 20, 28, 4, 2, 4))
    out["cv2_rgba_q60"] = cv2_sequence(frames_of(smooth, 32, 48, 4, 3, 5), 60)
    out["cv2_odd_17x33"] = cv2_sequence(frames_of(smooth, 17, 33, 3, 2, 6), 70)
    out["cv2_1x1"] = cv2_sequence(frames_of(noise, 1, 1, 3, 2, 7))
    out["cv2_odd_65x47_q100"] = cv2_sequence(frames_of(noise, 65, 47, 3, 2, 8))
    out["pil_lossless_444"] = pil_sequence(frames_of(smooth, 30, 40, 3, 3, 9), quality=100, subsampling="4:4:4")
    out["pil_q90_444"] = pil_sequence(frames_of(smooth, 30, 40, 3, 2, 10), quality=90, subsampling="4:4:4")
    out["pil_rgba"] = pil_sequence(frames_of(smooth, 32, 48, 4, 3, 11), quality=80)
    out["pil_odd_9x13"] = pil_sequence(frames_of(noise, 9, 13, 3, 2, 12), quality=75)
    return out


WRITERS = writer_files()


@pytest.mark.parametrize("name", list(WRITERS))
def test_cv2s_and_pillows_sequences_decode_as_cv2(name, tmp_path):
    data = WRITERS[name]
    assert data[8:12] == b"avis" and b"moov" in data
    assert answers(data) == "equal"
    assert read_answers(data, tmp_path) == "equal"


def test_the_first_frame_is_what_cv2_answers():
    """Each writer file decodes to its first frame: cv2's decode of a still
    of that frame at the same quality."""
    frames = frames_of(smooth, 48, 64, 3, 2, 2)
    still = cv2_decode(cv2_avif(frames[0]))
    assert (port_decode(WRITERS["cv2_q100_2"]) == still).all()
    assert not (port_decode(cv2_sequence(frames[::-1])) == still).all()


# -- the sequence writer's files ----------------------------------------------------------------


def _still(seed, h=32, w=48, c=3):
    data = cv2_avif(smooth(h, w, c, seed))
    return data, item_data(data)


def _samples(data: bytes, track: int = 0) -> list:
    """The samples of a file's ``track``-th trak, by the port's parser (one
    chunk, as the writers lay them)."""
    t = imcodec._avif_parse(data)[2][track]
    sizes = t.sizes or [t.all_size] * t.to_chunk[0][1]
    at = t.chunks[0]
    out = []
    for n in sizes:
        out.append(data[at:at + n])
        at += n
    return out


def constructed() -> dict:
    """name → (file, cv2's answer: "equal", "none" or "known" (cv2 decodes
    what the port names as not decoded))."""
    (s0, a), (s1, b), (s2, c), (s3, d) = (_still(k) for k in range(4))
    props = props_of(s0)
    T = lambda samples=(a, b, c), props=props, **kw: Track(1, 48, 32, list(samples), props, **kw)
    item = (d, 48, 32, None)
    out = {"plain": (seq_file([T()]), "equal"),
           "lean": (seq_file([T(**LEAN)], mvhd_box=b""), "equal"),
           "co64": (seq_file([T(co64=True)]), "equal"),
           "chunks_1_2": (seq_file([T(chunks=[1, 2], gap=5)]), "equal"),
           "chunks_2_1": (seq_file([T(chunks=[2, 1], gap=3)]), "equal"),
           "chunks_1_1_1_co64": (seq_file([T(chunks=[1, 1, 1], gap=1, co64=True)]), "equal"),
           "all_samples_one_size": (seq_file([T((a, a, a), stsz=stsz([0] * 3, all_size=len(a)))]), "equal"),
           "mvhd_version_1": (seq_file([T()], mvhd_box=mvhd(1)), "equal"),
           "tkhd_version_1": (seq_file([T(tkhd=tkhd(1, 48, 32, version=1))]), "equal"),
           "mdhd_version_1": (seq_file([T(mdhd=mdhd(1))]), "equal"),
           "elst_version_1": (seq_file([T(edts=box(b"edts", elst(version=1)))]), "equal"),
           "elst_not_repeating": (seq_file([T(edts=box(b"edts", elst(flags=0, count=2)))]), "equal"),
           "no_stss": (seq_file([T(sync=None)]), "equal"),
           "first_sample_not_listed_as_sync": (seq_file([T(sync=(2,))]), "equal"),
           "stsz_longer_than_the_samples": (seq_file([T(stsz=stsz([len(a), len(b), len(c), 9]))]), "equal"),
           "track_meta": (seq_file([T(extra=full_box(b"meta", 0, 0, hdlr()))]), "equal"),
           "hdlr_vide": (seq_file([T(hdlr=hdlr(b"vide"))]), "equal"),
           "stsd_avc1_then_av01": (seq_file([T(stsd=stsd(av01_entry(48, 32, b"", b"avc1"), av01_entry(48, 32, props)))]),
                                   "equal"),
           "sample_entry_properties": (seq_file([T(props=props + box(b"auxC", b"x") + box(b"irot", b"\1")
                                                   + full_box(b"pixi", 0, 0, b"\3\x0a\x0a\x0a"))]), "equal"),
           # refused by libavif's checks, of any sample
           "tkhd_duration_0_repeating": (seq_file([T(tkhd=tkhd(1, 48, 32, duration=0))]), "none"),
           "elst_segment_0": (seq_file([T(edts=box(b"edts", elst(duration=0)))]), "none"),
           "elst_two_entries": (seq_file([T(edts=box(b"edts", elst(count=2)))]), "none"),
           "edts_without_elst": (seq_file([T(edts=box(b"edts", b""))]), "none"),
           "moov_without_trak": (seq_file([]), "none"),
           "no_tkhd": (seq_file([T(tkhd=b"")]), "none"),
           "tkhd_width_0": (seq_file([T(tkhd=tkhd(1, 0, 32))]), "none"),
           "tkhd_too_large": (seq_file([T(tkhd=tkhd(1, 16385, 16384))]), "none"),
           "track_id_0": (seq_file([T(tkhd=tkhd(0, 48, 32))]), "none"),
           "mdhd_version_2": (seq_file([T(mdhd=full_box(b"mdhd", 2, 0, bytes(40)))]), "none"),
           "hdlr_pre_defined": (seq_file([T(hdlr=full_box(b"hdlr", 0, 0, b"\0\0\0\1pict" + bytes(13)))]), "none"),
           "track_meta_not_pict": (seq_file([T(extra=full_box(b"meta", 0, 0, hdlr(b"mdir")))]), "none"),
           "two_stbl": (seq_file([T(mdia_extra=box(b"minf", box(b"stbl", b"")))]), "none"),
           "stsc_not_from_chunk_1": (seq_file([T(stsc=stsc([(2, 3)]))]), "none"),
           "stsc_not_increasing": (seq_file([T(stsc=stsc([(1, 3), (1, 3)]))]), "none"),
           "chunk_of_0_samples": (seq_file([T(stsc=stsc([(1, 0)]))]), "none"),
           "stsz_shorter_than_the_chunks": (seq_file([T(stsc=stsc([(1, 4)]))]), "none"),
           "later_sample_of_0_bytes": (seq_file([T(stsz=stsz([len(a), 0, len(c)]))]), "none"),
           "last_sample_past_the_end": (seq_file([T(stsz=stsz([len(a), len(b), len(c) + 1]))]), "none"),
           "first_sample_past_the_end": (seq_file([T((a,), stco=stco([10 ** 6]))]), "none"),
           "stco_version_1": (seq_file([T(stco=full_box(b"stco", 1, 0, u32(1, 0)))]), "none"),
           "no_av1C": (seq_file([T(props=props[12:])]), "none"),
           "two_colr_nclx": (seq_file([T(props=props + colr())]), "none"),
           "short_sample_entry": (seq_file([T(stsd=stsd(box(b"av01", bytes(70))))]), "none"),
           "no_av01_entry": (seq_file([T(stsd=stsd(av01_entry(48, 32, props, b"av02")))]), "none"),
           # what the first sample holds
           "sequence_header_only_in_av1C": (seq_file([T([obu(2, b"") + obu(6, split_obus(a)[-1][1])],
                                                        props=box(b"av1C", props[8:12] + obu(1, split_obus(a)[0][1]))
                                                        + props[12:])]), "none"),
           # the tkhd size bounds the frame: libavif scales to it
           "tkhd_larger_than_the_frame": (seq_file([T(tkhd=tkhd(1, 96, 64))]), "known"),
           "tkhd_smaller_than_the_frame": (seq_file([T(tkhd=tkhd(1, 47, 32))]), "known"),
           "a10_bit_av1C": (seq_file([T(props=box(b"av1C", bytes([0x81, 0x20, 0x40, 0])) + props[12:])]), "known"),
           }
    # source selection: the primary item (d) and the first sample (a) differ
    for major in (b"avis", b"avif", b"mif1"):
        for first in (False, True):
            where = "moov_first" if first else "meta_first"
            out[f"major_{major.decode()}_{where}"] = (seq_file([T()], item=item, major=major, moov_first=first), "equal")
    out["mif1_compat_avis_only"] = (seq_file([T()], major=b"mif1", compat=(b"mif1", b"avis")), "equal")
    out["mif1_compat_avif_moov_first"] = (seq_file([T()], item=item, major=b"mif1", compat=(b"mif1", b"avif"),
                                                   moov_first=True), "equal")
    out["mif1_compat_avif_moov_after"] = (seq_file([T()], item=item, major=b"mif1", compat=(b"mif1", b"avif")),
                                          "equal")
    out["major_avif_empty_moov_first"] = (seq_file([], item=item, major=b"avif", moov_first=True), "none")
    # without 'avis' libavif stops at the meta: a moov after it is not read
    out["major_avif_empty_moov_after"] = (seq_file([], item=item, major=b"avif", compat=(b"avif", b"mif1")), "equal")
    out["major_avif_avis_empty_moov_after"] = (seq_file([], item=item, major=b"avif"), "none")
    # several tracks
    two = lambda k, **kw: Track(k + 1, 48, 32, [(a, b)[k]], props, **kw)
    out["two_colour_tracks"] = (seq_file([two(0), two(1)]), "equal")
    out["first_track_without_stbl"] = (seq_file([two(0, stsd=b"", stts=b"", stsc=b"", stsz=b"", stco=b"",
                                                      sync=None), two(1)]), "equal")
    out["first_track_not_av01"] = (seq_file([two(0, stsd=stsd(av01_entry(48, 32, props, b"av02"))), two(1)]), "equal")
    out["first_track_auxiliary"] = (seq_file([two(0, aux_for=7), two(1)]), "equal")
    out["second_track_bad_table"] = (seq_file([two(0), two(1, stsc=stsc([(1, 2)]))]), "equal")
    out["first_track_bad_table"] = (seq_file([two(0, stsc=stsc([(1, 2)])), two(1)]), "none")
    # alpha tracks
    (s4, _), colours, alphas = _still(4, c=4), [], []
    for k in range(3):
        still = cv2_avif(smooth(32, 48, 4, k))
        colours.append(item_data(still, 1))
        alphas.append(item_data(still, 2))
    at = s4.find(b"av1C", s4.find(b"av1C") + 4)
    alpha_props = s4[at - 4:at + 8]
    urn = b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha\0"
    colour = lambda **kw: Track(1, 48, 32, colours, props_of(s4), **kw)
    alpha = lambda samples=alphas, extra=box(b"auxi", bytes(4) + urn), **kw: Track(2, 48, 32, samples,
                                                                                 alpha_props + extra, aux_for=1, **kw)
    bad = [alphas[0][:len(alphas[0]) // 2] + bytes(len(alphas[0]) - len(alphas[0]) // 2)] + alphas[1:]
    out["alpha"] = (seq_file([colour(), alpha()]), "equal")
    out["alpha_first"] = (seq_file([alpha(), colour()]), "equal")
    out["alpha_bad"] = (seq_file([colour(), alpha(bad)]), "none")
    out["alpha_bad_without_auxi"] = (seq_file([colour(), alpha(bad, b"")]), "none")
    out["alpha_bad_other_urn"] = (seq_file([colour(), alpha(bad, box(b"auxi", bytes(4) + b"x\0"))]), "equal")
    out["alpha_bad_auxi_without_nul"] = (seq_file([colour(), alpha(bad, box(b"auxi", bytes(4) + b"urn"))]), "none")
    out["alpha_of_another_track"] = (seq_file([colour(), Track(2, 48, 32, bad, alpha_props, aux_for=9)]), "equal")
    out["alpha_tkhd_differs"] = (seq_file([colour(), alpha(tkhd=tkhd(2, 24, 16))]), "none")
    out["alpha_frames_and_tkhd_differ"] = (seq_file([colour(), Track(2, 24, 16, [item_data(cv2_avif(smooth(
        16, 24, 4, 0)), 2)], alpha_props, aux_for=1)]), "none")
    out["alpha_prem"] = (seq_file([colour(tref=box(b"tref", box(b"prem", u32(2)))), alpha()]), "known")
    out["two_alphas_second_bad"] = (seq_file([colour(), alpha(), Track(3, 48, 32, bad, alpha_props, aux_for=1)]),
                                    "equal")
    grey, g = _still(5, c=1)
    out["monochrome"] = (seq_file([Track(1, 48, 32, [g], props_of(grey))]), "equal")
    out["monochrome_with_alpha"] = (seq_file([Track(1, 48, 32, [g], props_of(grey)), alpha()]), "none")
    # a moov of size 0 runs to the end of the data; cv2's signature window
    # parses it to byte 500, so cv2 takes it only where a box ends there
    small = [_still(k, 1, 2)[1] for k in range(2)]
    lean = lambda **kw: seq_file([Track(1, 2, 1, small, props_of(_still(0, 1, 2)[0]), **LEAN)], moov_last=True,
                                 mvhd_box=b"", **kw)
    size = len(lean(moov_size=0))
    for k in (-1, 0, 1, 40):
        pad = box(b"free", bytes(500 + k - size - 8))
        out[f"moov_size_0_ending_at_{500 + k}"] = (lean(moov_size=0, moov_extra=pad), "equal" if k == 0 else "none")
        out[f"moov_ending_at_{500 + k}"] = (lean(moov_extra=pad), "equal")
    out["moov_size_0_before_mdat"] = (seq_file([T()], moov_size=0), "none")
    out["moov_after_mdat"] = (seq_file([T()], moov_last=True), "none")  # its header is past the window
    out["moov_after_mdat_with_item"] = (seq_file([T()], item=item, moov_last=True), "equal")
    return out


CONSTRUCTED = constructed()


@pytest.mark.parametrize("name", list(CONSTRUCTED))
def test_written_sequences_answer_as_cv2(name):
    data, want = CONSTRUCTED[name]
    assert answers(data) == want


def test_the_image_count_limit_is_libavifs():
    """libavif's default limit of 12 * 3600 * 60 samples a track (cv2 keeps
    it): one sample of a frame, then that many 1-byte samples less one, or
    not less."""
    _, a = _still(0)
    props = props_of(_still(0)[0])
    for n, want in ((imcodec._AVIF_IMAGE_COUNT_LIMIT - 1, "equal"), (imcodec._AVIF_IMAGE_COUNT_LIMIT, "none")):
        track = Track(1, 48, 32, [a, bytes(n)], props, chunks=[1, 1], stsc=stsc([(1, 1), (2, n)]),
                      stsz=stsz([len(a)] + [1] * n), sync=None, stts=b"")
        assert answers(seq_file([track])) == want


def test_the_source_is_libavifs():
    """'avis' as the major brand takes the tracks, 'avif' the primary item,
    another brand the tracks where the moov holds one (parsed before the
    boxes the brands need are complete)."""
    track, item = cv2_decode(_still(0)[0]), cv2_decode(_still(3)[0])
    assert not (track == item).all()
    for name, source in (("major_avis_meta_first", track), ("major_avis_moov_first", track),
                         ("major_avif_meta_first", item), ("major_avif_moov_first", item),
                         ("major_mif1_meta_first", track), ("major_mif1_moov_first", track),
                         ("mif1_compat_avif_moov_first", track), ("mif1_compat_avif_moov_after", item)):
        assert (port_decode(CONSTRUCTED[name][0]) == source).all(), name


def units() -> dict:
    """First samples of more than one frame (libaom outputs the last frame
    shown): name → (file, cv2's answer)."""
    first, second = (_samples(cv2_sequence(frames_of(smooth, 32, 48, 3, 2, k))) for k in (20, 21))
    props = props_of(cv2_avif(smooth(32, 48, 3, 20)))
    one = lambda sample: seq_file([Track(1, 48, 32, [sample], props)])
    a, b = _still(0)[1], _still(1)[1]
    small = _still(2, 16, 24)[1]
    grey = _still(3, c=1)[1]
    show = lambda slot: obu(3, Bits().f(1, 1).f(slot, 3).trailing())
    q90 = cv2_avif(smooth(32, 48, 3, 6), quality=90)
    return {
        "two_key_frames": (one(first[0] + second[0]), "equal"),
        "two_key_frames_one_temporal_unit": (one(first[0] + second[0][2:]), "equal"),
        "a_key_frame_after_its_frame": (one(first[0] + obu(6, split_obus(second[0])[-1][1])), "equal"),
        "the_same_key_frame_twice": (one(first[0] + first[0]), "equal"),
        "zeros_after_the_frame": (one(first[0] + bytes(5)), "equal"),
        "a_key_frame_then_an_inter_frame": (one(first[0] + first[1]), "known"),
        "an_inter_frame_first": (one(first[1]), "none"),
        "a_shown_key_frame_shown_again": (one(first[0] + show(0)), "none"),
        "a_key_frame_of_another_size_after": (one(full_headers(a, still=0) + full_headers(small, still=0)), "known"),
        # a hidden key frame shown by show_existing_frame: once, from a slot it refreshed
        "hidden_key_frame": (one(hidden_key(a)), "equal"),
        "hidden_key_frame_in_slot_0_of_5": (one(hidden_key(a, shows=(5,))), "equal"),
        "hidden_key_frame_slot_0_only": (one(hidden_key(a, refresh=1)), "equal"),
        "hidden_key_frame_other_slot": (one(hidden_key(a, refresh=1, shows=(1,))), "none"),
        "hidden_key_frame_no_slot": (one(hidden_key(a, refresh=0)), "none"),
        "hidden_key_frame_never_shown": (one(hidden_key(a, shows=())), "none"),
        "hidden_key_frame_not_showable": (one(hidden_key(a, showable=0)), "none"),
        "hidden_key_frame_shown_twice": (one(hidden_key(a, shows=(0, 0))), "none"),
        "hidden_key_frames_of_one_frame_id": (one(hidden_key(a, refresh=1, shows=()) + obu(6, split_obus(
            hidden_key(b, refresh=2, shows=()))[-1][1]) + obu(3, Bits().f(1, 1).f(1, 3).f(3, 8).trailing())), "none"),
        # a new sequence header (other frame id lengths) before a hidden key frame
        "a_key_frame_then_a_hidden_one": (one(full_headers(a, still=0) + hidden_key(b)), "equal"),
        "a_key_frame_then_a_hidden_one_in_slot_0": (one(full_headers(a, still=0) + hidden_key(b, refresh=1)), "equal"),
        "a_key_frame_then_a_hidden_one_unshown": (one(full_headers(a, still=0) + hidden_key(b, shows=())), "equal"),
        "a_new_sequence_empties_the_slots": (one(full_headers(a, still=0) + hidden_key(b, refresh=1, shows=(1,))),
                                             "none"),
        # a later key frame may start a sequence of another format: cv2's
        # channels come from the av1C, the pixels from the frame output
        "monochrome_then_colour": (one(full_headers(grey, still=0) + full_headers(a, still=0)), "equal"),
        "colour_then_monochrome": (one(full_headers(a, still=0) + full_headers(grey, still=0)), "equal"),
        "colour_frames_under_a_monochrome_av1C": (seq_file([Track(1, 48, 32, [full_headers(grey, still=0) + full_headers(
            a, still=0)], props_of(_still(3, c=1)[0]))]), "equal"),
        # the colr box's identity matrix, which libavif does not convert from 4:2:0
        "a_420_key_frame_after_a_444_one": (one(full_headers(a, still=0) + full_headers(item_data(q90), still=0)),
                                            "none"),
        "a_420_key_frame_after_a_444_one_bt601": (seq_file([Track(1, 48, 32, [full_headers(a, still=0) + full_headers(
            item_data(q90), still=0)], props_of(q90))]), "equal"),
    }


UNITS = units()


@pytest.mark.parametrize("name", list(UNITS))
def test_samples_of_several_frames_answer_as_cv2(name):
    data, want = UNITS[name]
    assert answers(data) == want


def test_inter_and_intra_only_frames_give_none_and_one_log_line_naming_them(caplog):
    """cv2 decodes a key frame and an inter frame in one sample (libaom
    outputs the inter frame); the port names it."""
    data = UNITS["a_key_frame_then_an_inter_frame"][0]
    assert cv2_decode(data) is not None
    with caplog.at_level("WARNING", logger="ppocr_tpu_torch.utils.imcodec"):
        assert imcodec.decode_image(data) is None
    lines = [r.getMessage() for r in caplog.records if r.name == "ppocr_tpu_torch.utils.imcodec"]
    assert len(lines) == 1 and lines[0].startswith("AVIF payload not decoded"), lines
    assert "inter and intra-only frames (ROADMAP A14.7c)" in lines[0]
    assert imcodec.AVIF_UNPORTED["inter and intra-only frames"] == "A14.7c"
    assert "image sequences' first frame" not in imcodec.AVIF_UNPORTED


# -- damaged files ------------------------------------------------------------------------


def fuzz_bases() -> dict:
    """Small sequences of each kind the fuzz changes."""
    return {
        "cv2_q100": cv2_sequence(frames_of(noise, 12, 20, 3, 3, 40)),
        "cv2_q50": cv2_sequence(frames_of(smooth, 24, 40, 3, 3, 41), 50),
        "cv2_rgba": cv2_sequence(frames_of(noise, 10, 14, 4, 2, 42)),
        "pil_q60": pil_sequence(frames_of(smooth, 20, 28, 3, 2, 43), quality=60),
        "item_moov_first": CONSTRUCTED["major_mif1_moov_first"][0],
        "chunks_co64": CONSTRUCTED["chunks_1_1_1_co64"][0],
        "hidden_key_frame": UNITS["hidden_key_frame"][0],
    }


BASES = fuzz_bases()


def box_offsets(data: bytes) -> list:
    """Every box's start within the file: top-level, meta's, moov's and
    down to the sample entry's."""
    out = []
    skip = {b"meta": 4, b"iinf": 6, b"iref": 4, b"stsd": 8, b"av01": 78}

    def walk(a, b, depth):
        while a + 8 <= b:
            size, kind = struct.unpack(">I4s", data[a:a + 8])
            size = size or b - a
            out.append(a)
            if depth < 7 and kind in (b"meta", b"iprp", b"ipco", b"iinf", b"iref", b"moov", b"trak", b"mdia", b"minf",
                                      b"stbl", b"stsd", b"av01", b"edts", b"tref", b"dinf"):
                walk(a + 8 + skip.get(kind, 0), min(b, a + size), depth + 1)
            if size < 8:
                break
            a += size

    walk(0, len(data), 0)
    return out


@pytest.mark.parametrize("name", list(BASES))
def test_every_cut_at_a_box_and_stepped_cuts_answer_as_cv2(name):
    data = BASES[name]
    cuts = {at + k for at in box_offsets(data) for k in (0, 1, 4, 8)}
    cuts |= set(np.linspace(1, len(data) - 1, 40).astype(int).tolist())
    got = [answers(data[:k]) for k in sorted(cuts) if 0 < k < len(data)]
    assert set(got) <= {"none", "equal", "known"}, got


@pytest.mark.parametrize("name", ["cv2_q50", "cv2_rgba", "item_moov_first"])
def test_every_box_byte_xored_answers_as_cv2(name):
    """Each byte of the boxes before the first media data XOR-ed with 0x01,
    0x10 and 0xFF."""
    data = BASES[name]
    got = []
    for i in range(data.index(b"mdat") + 4):
        for x in (0x01, 0x10, 0xFF):
            d = bytearray(data)
            d[i] ^= x
            got.append(answers(bytes(d)))
    assert set(got) <= {"none", "equal", "known"}, sorted(set(got))
    assert got.count("equal") >= 100


@pytest.mark.parametrize("name", list(BASES))
def test_mutated_files_answer_as_cv2(name):
    got = [answers(d) for d in mutations(BASES[name], 300, seed=list(BASES).index(name) + 3100)]
    assert set(got) <= {"none", "equal", "known"}, sorted(set(got))
    assert got.count("equal") >= 5


def test_damaged_files_by_path_answer_as_cv2_imread(tmp_path):
    datas = [d for i, data in enumerate(BASES.values()) for d in mutations(data, 10, seed=i + 3400)]
    datas += [data[:len(data) * 2 // 3] for data in BASES.values()]
    assert {read_answers(d, tmp_path) for d in datas} <= {"none", "equal"}


# -- what the card decodes, and the fuzz ----------------------------------------------------------


def written_cases() -> dict:
    """A spread of the cases above for ``assets/image_cases.npz`` (the card
    has no cv2 to make or decode them): the writers' files, the written
    ones, the units, cut and mutated files; none the port names as not
    decoded."""
    cases = {f"sequence_{k}": v for k, v in WRITERS.items() if len(v) < 20_000}
    cases.update({f"sequence_box_{k}": v for i, (k, (v, _)) in enumerate(CONSTRUCTED.items())
                  if i % 3 == 0 or k.startswith("major_")})
    cases.update({f"sequence_unit_{k}": v for i, (k, (v, _)) in enumerate(UNITS.items()) if i % 2 == 0})
    for i, (name, data) in enumerate(BASES.items()):
        cases.update({f"sequence_{name}_mutated_{k}": m for k, m in enumerate(mutations(data, 2, seed=i + 3900))})
        cases[f"sequence_{name}_cut"] = data[: len(data) * 2 // 3]
    # what cv2 decodes and the port refuses is the named kind (the tests
    # above hold that): told without the log line, which --write turns off
    return {k: v for k, v in cases.items() if cv2_decode(v) is None or port_decode(v) is not None}


def scene_payload(scene: np.ndarray) -> dict:
    """A serving scene as the smoke run's sequence timing input and
    request: cv2's lossless (q100) animation, the scene as its first frame
    and two cheap later frames (flat grey), whose first frame decodes to
    the scene's lossless AVIF's pixels."""
    grey = np.full_like(scene, 128)
    return {"scene0_avif_sequence": cv2_sequence([scene, grey, grey])}


def fuzz_files(round_: int, n: int = 2000) -> list:
    """One fuzz round's files: ``n`` mutations of each base and every cut
    of the smaller ones."""
    files = []
    for i, data in enumerate(BASES.values()):
        files += mutations(data, n, seed=10000 * round_ + i + 7000)
        if len(data) < 4000:
            files += [data[:k] for k in range(1, len(data))]
    return files


def test_the_smoke_cases_and_payloads_decode_as_cv2():
    cases = {**written_cases(), **scene_payload(smooth(64, 96, 3, 5))}
    got = [answers(d) for d in cases.values()]
    assert set(got) <= {"none", "equal"} and got.count("equal") >= 50
