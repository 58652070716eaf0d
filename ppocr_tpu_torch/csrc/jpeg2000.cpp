// JPEG 2000 codestream decoder: OpenJPEG 2.5.3's as OpenCV 5.0 drives it
// (strict mode, a memory stream that can seek, the whole image decoded).
//
// The order of the work follows OpenJPEG's files, and so do the names in
// the comments:
//   * j2k.c: the main header (opj_j2k_read_header_procedure), the tile-part
//     headers and data (opj_j2k_read_tile_header, opj_j2k_read_sod), the
//     decode loop over tiles (opj_j2k_decode_tiles, opj_j2k_decode_tile)
//     and every marker handler's checks;
//   * pi.c: the packet iterator of the five progression orders and POC;
//   * t2.c: packet headers (bit stuffing, tag trees kept across layers,
//     pass counts, Lblock), SOP/EPH, PPM/PPT, code-block segments;
//   * t1.c / mqc.c: the MQ and raw decoders (a segment's data is followed by
//     a synthetic 0xFF 0xFF), the three passes, the mode switches, ROI
//     max-shift, and the reconstruction at one and a half of the last
//     decoded bit plane (values carry one extra bit, halved afterwards:
//     integer division in the reversible path, 0.5f * step in the other);
//   * dwt.c: the inverse 5/3 (integer) and 9/7 (float: K on the low band,
//     OpenJPEG's 2/K on the high band, then the delta, gamma, beta and alpha
//     lifting steps as (left + right) * c added to the sample), the parity
//     of odd origins and the one-sample cases;
//   * mct.c / tcd.c: the inverse RCT and ICT (float constants), the DC level
//     shift with lrintf (ties to even) and the clamp to the precision.
//
// What cv2 refuses after a successful decode (sub-sampled components, an
// image origin other than 0) is refused by the caller from the header, so
// such images are not decoded here. HT (Part 15) code-blocks are not
// decoded: status UNPORTED.
//
// -ffp-contract=off: the 9/7 lifting and the ICT are separate multiplies and
// adds in OpenJPEG's SSE code, and a fused multiply-add rounds otherwise.
#pragma GCC optimize("fp-contract=off")

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>
#include <atomic>
#include <condition_variable>
#include <functional>
#include <mutex>
#include <thread>
#include <vector>

namespace {

enum Status { OK = 0, HEADER_ERROR = 1, DECODE_ERROR = 2, UNPORTED = 3, BAD_CALL = 4 };

struct Error {
    int status;
    std::string msg;
};

[[noreturn]] void fail(int status, const std::string& msg) { throw Error{status, msg}; }

// decoder states (j2k.h J2K_STATE_*)
enum : uint32_t {
    ST_NONE = 0, ST_MHSOC = 1, ST_MHSIZ = 2, ST_MH = 4, ST_TPHSOT = 8, ST_TPH = 16, ST_MT = 32, ST_NEOC = 64,
    ST_DATA = 128, ST_EOC = 256, ST_ERR = 0x8000
};

enum : uint32_t {
    MS_SOC = 0xff4f, MS_SOT = 0xff90, MS_SOD = 0xff93, MS_EOC = 0xffd9, MS_CAP = 0xff50, MS_SIZ = 0xff51,
    MS_COD = 0xff52, MS_COC = 0xff53, MS_CPF = 0xff59, MS_RGN = 0xff5e, MS_QCD = 0xff5c, MS_QCC = 0xff5d,
    MS_POC = 0xff5f, MS_TLM = 0xff55, MS_PLM = 0xff57, MS_PLT = 0xff58, MS_PPM = 0xff60, MS_PPT = 0xff61,
    MS_SOP = 0xff91, MS_EPH = 0xff92, MS_CRG = 0xff63, MS_COM = 0xff64, MS_CBD = 0xff78, MS_MCC = 0xff75,
    MS_MCT = 0xff74, MS_MCO = 0xff77, MS_UNK = 0
};

enum { PROG_UNKNOWN = -1, LRCP = 0, RLCP = 1, RPCL = 2, PCRL = 3, CPRL = 4 };

const uint32_t CP_CSTY_PRT = 1, CP_CSTY_SOP = 2, CP_CSTY_EPH = 4;
const uint32_t CBLKSTY_LAZY = 1, CBLKSTY_RESET = 2, CBLKSTY_TERMALL = 4, CBLKSTY_VSC = 8, CBLKSTY_PTERM = 16,
               CBLKSTY_SEGSYM = 32, CBLKSTY_HT = 64, CBLKSTY_HTMIXED = 128;
const uint32_t MAXRLVLS = 33, MAXBANDS = 3 * MAXRLVLS - 2, MAX_POCS = 32;

uint32_t rd(const uint8_t* p, int n) {
    uint32_t v = 0;
    for (int i = 0; i < n; i++) v = (v << 8) | p[i];
    return v;
}

// opj_stream over cv2's memory buffer: reads return what is left, a skip past
// the end moves to the end and fails
struct Stream {
    const uint8_t* d;
    int64_t n, pos = 0;
    int64_t left() const { return n - pos; }
    bool read(uint8_t* out, int64_t k) {
        int64_t r = std::min<int64_t>(k, left());
        if (r > 0) memcpy(out, d + pos, (size_t)r);
        pos += std::max<int64_t>(r, 0);
        return r == k;
    }
    bool skip(int64_t k) {
        if (k <= left()) {
            pos += k;
            return true;
        }
        pos = n;
        return false;
    }
};

struct StepSize {
    int32_t expn = 0, mant = 0;
};

struct Tccp {
    uint32_t csty = 0, numresolutions = 0, cblkw = 0, cblkh = 0, cblksty = 0, qmfbid = 0, qntsty = 0, numgbits = 0;
    int32_t roishift = 0;
    uint32_t prcw[MAXRLVLS] = {}, prch[MAXRLVLS] = {};
    StepSize stepsizes[MAXBANDS];
    int32_t dc_level_shift = 0;
};

struct Poc {
    uint32_t resno0 = 0, compno0 = 0, layno1 = 0, resno1 = 0, compno1 = 0;
    int32_t prg = 0;
};

// Part 2 multiple component transform records (MCT, MCC): read and checked
// as OpenJPEG does; only an MCC offset array, named by an MCO stage, changes
// the decode (the DC level shift). The decorrelation itself needs an MCT
// type of 2 in COD, which OpenJPEG refuses.
struct MctRecord {
    uint32_t index = 0, element_type = 0;
    std::vector<uint8_t> data;
};

struct MccRecord {
    uint32_t index = 0, nb_comps = 0;
    int decorrelation = -1, offset = -1;  // MCT records, or none
};

struct Tcp {
    uint32_t csty = 0;
    int32_t prg = 0;
    uint32_t numlayers = 0, mct = 0;
    bool cod = false;
    std::vector<Tccp> tccps;
    bool poc = false;
    uint32_t numpocs = 0;
    Poc pocs[MAX_POCS];
    int32_t current_tile_part = -1;
    uint32_t nb_tile_parts = 0;
    bool has_data = false;  // m_data != NULL
    std::vector<uint8_t> data;
    bool ppt = false;
    std::vector<std::vector<uint8_t>> ppt_markers;
    std::vector<bool> ppt_present;
    std::vector<uint8_t> ppt_buffer;
    size_t ppt_pos = 0, ppt_len = 0;
    std::vector<MctRecord> mct_records;
    std::vector<MccRecord> mcc_records;
};

struct Comp {
    uint32_t prec = 0, sgnd = 0, dx = 0, dy = 0, x0 = 0, y0 = 0, w = 0, h = 0;
    uint32_t resno_decoded = 0;
    std::vector<int32_t> data;  // empty until a tile is written
};

struct Codec;
void decode_tile_data(Codec& j, uint32_t tileno);

struct Codec {
    Stream s;
    uint32_t state = ST_NONE;
    // image
    uint32_t x0 = 0, y0 = 0, x1 = 0, y1 = 0;
    std::vector<Comp> comps;
    uint32_t ihdr_w = 0, ihdr_h = 0;
    // coding parameters
    uint32_t rsiz = 0, tx0 = 0, ty0 = 0, tdx = 0, tdy = 0, tw = 0, th = 0;
    Tcp default_tcp;
    std::vector<Tcp> tcps;
    bool ppm = false;
    std::vector<std::vector<uint8_t>> ppm_markers;
    std::vector<bool> ppm_present;
    std::vector<uint8_t> ppm_buffer;
    size_t ppm_pos = 0, ppm_len = 0;
    // decoder
    uint32_t current_tile = 0;
    uint32_t sot_length = 0;
    bool last_tile_part = false, can_decode = false, skip_data = false;
    bool nb_tile_parts_correction_checked = false;
    uint32_t nb_tile_parts_correction = 0;
    std::vector<uint8_t> header;
    int threads = 1;

    Tcp& cur_tcp() { return state == ST_TPH ? tcps[current_tile] : default_tcp; }
    uint32_t numcomps() const { return (uint32_t)comps.size(); }
};

// -- marker handlers (j2k.c) -------------------------------------------------

void read_siz(Codec& j, const uint8_t* p, uint32_t size) {
    if (size < 36) fail(HEADER_ERROR, "Error with SIZ marker size");
    uint32_t remaining = size - 36;
    uint32_t nb_comp = remaining / 3;
    if (remaining % 3 != 0) fail(HEADER_ERROR, "Error with SIZ marker size");
    j.rsiz = rd(p, 2);
    j.x1 = rd(p + 2, 4);
    j.y1 = rd(p + 6, 4);
    j.x0 = rd(p + 10, 4);
    j.y0 = rd(p + 14, 4);
    j.tdx = rd(p + 18, 4);
    j.tdy = rd(p + 22, 4);
    j.tx0 = rd(p + 26, 4);
    j.ty0 = rd(p + 30, 4);
    uint32_t n = rd(p + 34, 2);
    if (n >= 16385) fail(HEADER_ERROR, "Error with SIZ marker: number of component is illegal");
    if (n != nb_comp)
        fail(HEADER_ERROR, "Error with SIZ marker: number of component is not compatible with the remaining number "
                           "of parameters");
    if (j.x0 >= j.x1 || j.y0 >= j.y1) fail(HEADER_ERROR, "Error with SIZ marker: negative or zero image size");
    if (j.tdx == 0 || j.tdy == 0) fail(HEADER_ERROR, "Error with SIZ marker: invalid tile size");
    uint64_t tx1 = std::min<uint64_t>((uint64_t)j.tx0 + j.tdx, 0xffffffffu);
    uint64_t ty1 = std::min<uint64_t>((uint64_t)j.ty0 + j.tdy, 0xffffffffu);
    if (j.tx0 > j.x0 || j.ty0 > j.y0 || tx1 <= j.x0 || ty1 <= j.y0)
        fail(HEADER_ERROR, "Error with SIZ marker: illegal tile offset");
    if (j.ihdr_w > 0 && j.ihdr_h > 0 && (j.ihdr_w != j.x1 - j.x0 || j.ihdr_h != j.y1 - j.y0))
        fail(HEADER_ERROR, "Error with SIZ marker: IHDR w/h vs. SIZ w/h");
    j.comps.assign(n, Comp());
    const uint8_t* c = p + 36;
    for (uint32_t i = 0; i < n; i++, c += 3) {
        Comp& comp = j.comps[i];
        comp.prec = (c[0] & 0x7f) + 1;
        comp.sgnd = c[0] >> 7;
        comp.dx = c[1];
        comp.dy = c[2];
        if (comp.dx < 1 || comp.dx > 255 || comp.dy < 1 || comp.dy > 255)
            fail(HEADER_ERROR, "Invalid values for comp: dx/dy should be between 1 and 255");
        if (comp.prec > 31) fail(HEADER_ERROR, "Invalid values for comp: prec (OpenJpeg only supports up to 31)");
    }
    j.tw = (uint32_t)(((uint64_t)(j.x1 - j.tx0) + j.tdx - 1) / j.tdx);
    j.th = (uint32_t)(((uint64_t)(j.y1 - j.ty0) + j.tdy - 1) / j.tdy);
    if (j.tw == 0 || j.th == 0 || j.tw > 65535 / j.th) fail(HEADER_ERROR, "Invalid number of tiles");
    j.default_tcp.tccps.assign(n, Tccp());
    for (uint32_t i = 0; i < n; i++)
        if (!j.comps[i].sgnd) j.default_tcp.tccps[i].dc_level_shift = 1 << (j.comps[i].prec - 1);
    j.tcps.assign((size_t)j.tw * j.th, Tcp());
    for (Tcp& t : j.tcps) t.tccps.assign(n, Tccp());
    j.state = ST_MH;
    // opj_image_comp_header_update
    uint32_t ix0 = std::max(j.tx0, j.x0), iy0 = std::max(j.ty0, j.y0);
    uint64_t ix1 = std::min<uint64_t>((uint64_t)j.tx0 + (uint64_t)(j.tw - 1) * j.tdx + j.tdx, j.x1);
    uint64_t iy1 = std::min<uint64_t>((uint64_t)j.ty0 + (uint64_t)(j.th - 1) * j.tdy + j.tdy, j.y1);
    for (Comp& comp : j.comps) {
        comp.x0 = (uint32_t)(((uint64_t)ix0 + comp.dx - 1) / comp.dx);
        comp.y0 = (uint32_t)(((uint64_t)iy0 + comp.dy - 1) / comp.dy);
        comp.w = (uint32_t)((ix1 + comp.dx - 1) / comp.dx) - comp.x0;
        comp.h = (uint32_t)((iy1 + comp.dy - 1) / comp.dy) - comp.y0;
    }
}

// opj_j2k_copy_tile_component_parameters
void copy_tile_component_parameters(Codec& j) {
    Tcp& t = j.cur_tcp();
    const Tccp& ref = t.tccps[0];
    for (uint32_t i = 1; i < j.numcomps(); i++) {
        Tccp& c = t.tccps[i];
        c.numresolutions = ref.numresolutions;
        c.cblkw = ref.cblkw;
        c.cblkh = ref.cblkh;
        c.cblksty = ref.cblksty;
        c.qmfbid = ref.qmfbid;
        memcpy(c.prcw, ref.prcw, sizeof(uint32_t) * ref.numresolutions);
        memcpy(c.prch, ref.prch, sizeof(uint32_t) * ref.numresolutions);
    }
}

void read_spcod_spcoc(Codec& j, uint32_t compno, const uint8_t* p, uint32_t* size) {
    Tccp& c = j.cur_tcp().tccps[compno];
    if (*size < 5) fail(HEADER_ERROR, "Error reading SPCod SPCoc element");
    c.numresolutions = (uint32_t)p[0] + 1;
    if (c.numresolutions > MAXRLVLS) fail(HEADER_ERROR, "Invalid value for numresolutions");
    c.cblkw = (uint32_t)p[1] + 2;
    c.cblkh = (uint32_t)p[2] + 2;
    if (c.cblkw > 10 || c.cblkh > 10 || c.cblkw + c.cblkh > 12)
        fail(HEADER_ERROR, "Error reading SPCod SPCoc element, Invalid cblkw/cblkh combination");
    c.cblksty = p[3];
    if (c.cblksty & CBLKSTY_HTMIXED)
        fail(HEADER_ERROR, "Error reading SPCod SPCoc element. Unsupported Mixed HT code-block style found");
    c.qmfbid = p[4];
    if (c.qmfbid > 1) fail(HEADER_ERROR, "Error reading SPCod SPCoc element, Invalid transformation found");
    *size -= 5;
    p += 5;
    if (c.csty & CP_CSTY_PRT) {
        if (*size < c.numresolutions) fail(HEADER_ERROR, "Error reading SPCod SPCoc element");
        for (uint32_t i = 0; i < c.numresolutions; i++) {
            uint32_t v = p[i];
            if (i != 0 && ((v & 0xf) == 0 || (v >> 4) == 0)) fail(HEADER_ERROR, "Invalid precinct size");
            c.prcw[i] = v & 0xf;
            c.prch[i] = v >> 4;
        }
        *size -= c.numresolutions;
    } else {
        for (uint32_t i = 0; i < c.numresolutions; i++) c.prcw[i] = c.prch[i] = 15;
    }
}

void read_cod(Codec& j, const uint8_t* p, uint32_t size) {
    Tcp& t = j.cur_tcp();
    t.cod = true;
    if (size < 5) fail(HEADER_ERROR, "Error reading COD marker");
    t.csty = p[0];
    if (t.csty & ~(CP_CSTY_PRT | CP_CSTY_SOP | CP_CSTY_EPH)) fail(HEADER_ERROR, "Unknown Scod value in COD marker");
    t.prg = p[1];
    if (t.prg > CPRL) t.prg = PROG_UNKNOWN;  // "Unknown progression order in COD marker": an error message only
    t.numlayers = rd(p + 2, 2);
    if (t.numlayers < 1) fail(HEADER_ERROR, "Invalid number of layers in COD marker");
    t.mct = p[4];
    if (t.mct > 1) fail(HEADER_ERROR, "Invalid multiple component transformation");
    size -= 5;
    for (Tccp& c : t.tccps) c.csty = t.csty & CP_CSTY_PRT;
    read_spcod_spcoc(j, 0, p + 5, &size);
    if (size != 0) fail(HEADER_ERROR, "Error reading COD marker");
    copy_tile_component_parameters(j);
}

void read_coc(Codec& j, const uint8_t* p, uint32_t size) {
    Tcp& t = j.cur_tcp();
    uint32_t room = j.numcomps() <= 256 ? 1 : 2;
    if (size < room + 1) fail(HEADER_ERROR, "Error reading COC marker");
    size -= room + 1;
    uint32_t compno = rd(p, room);
    if (compno >= j.numcomps()) fail(HEADER_ERROR, "Error reading COC marker (bad number of components)");
    t.tccps[compno].csty = p[room];
    read_spcod_spcoc(j, compno, p + room + 1, &size);
    if (size != 0) fail(HEADER_ERROR, "Error reading COC marker");
}

void read_sqcd_sqcc(Codec& j, uint32_t compno, const uint8_t* p, uint32_t* size) {
    Tccp& c = j.cur_tcp().tccps[compno];
    if (*size < 1) fail(HEADER_ERROR, "Error reading SQcd or SQcc element");
    *size -= 1;
    uint32_t v = p[0];
    p++;
    c.qntsty = v & 0x1f;
    c.numgbits = v >> 5;
    uint32_t num_band;
    if (c.qntsty == 1)
        num_band = 1;
    else
        num_band = c.qntsty == 0 ? *size : *size / 2;
    if (c.qntsty == 0) {
        for (uint32_t b = 0; b < num_band; b++)
            if (b < MAXBANDS) {
                c.stepsizes[b].expn = (int32_t)(p[b] >> 3);
                c.stepsizes[b].mant = 0;
            }
        *size -= num_band;
    } else {
        if (*size < 2 * num_band) fail(HEADER_ERROR, "Error reading SQcd or SQcc element");
        for (uint32_t b = 0; b < num_band; b++)
            if (b < MAXBANDS) {
                uint32_t w = rd(p + 2 * b, 2);
                c.stepsizes[b].expn = (int32_t)(w >> 11);
                c.stepsizes[b].mant = (int32_t)(w & 0x7ff);
            }
        *size -= 2 * num_band;
    }
    if (c.qntsty == 1)
        for (uint32_t b = 1; b < MAXBANDS; b++) {
            int32_t e = c.stepsizes[0].expn - (int32_t)((b - 1) / 3);
            c.stepsizes[b].expn = e > 0 ? e : 0;
            c.stepsizes[b].mant = c.stepsizes[0].mant;
        }
}

void read_qcd(Codec& j, const uint8_t* p, uint32_t size) {
    read_sqcd_sqcc(j, 0, p, &size);
    if (size != 0) fail(HEADER_ERROR, "Error reading QCD marker");
    Tcp& t = j.cur_tcp();
    for (uint32_t i = 1; i < j.numcomps(); i++) {
        t.tccps[i].qntsty = t.tccps[0].qntsty;
        t.tccps[i].numgbits = t.tccps[0].numgbits;
        memcpy(t.tccps[i].stepsizes, t.tccps[0].stepsizes, sizeof(t.tccps[0].stepsizes));
    }
}

void read_qcc(Codec& j, const uint8_t* p, uint32_t size) {
    uint32_t room = j.numcomps() <= 256 ? 1 : 2;
    if (size < room) fail(HEADER_ERROR, "Error reading QCC marker");
    uint32_t compno = rd(p, room);
    size -= room;
    if (compno >= j.numcomps()) fail(HEADER_ERROR, "Invalid component number in QCC");
    read_sqcd_sqcc(j, compno, p + room, &size);
    if (size != 0) fail(HEADER_ERROR, "Error reading QCC marker");
}

void read_rgn(Codec& j, const uint8_t* p, uint32_t size) {
    uint32_t room = j.numcomps() <= 256 ? 1 : 2;
    if (size != 2 + room) fail(HEADER_ERROR, "Error reading RGN marker");
    Tcp& t = j.cur_tcp();
    uint32_t compno = rd(p, room);
    if (compno >= j.numcomps()) fail(HEADER_ERROR, "bad component number in RGN");
    t.tccps[compno].roishift = p[room + 1];
}

void read_poc(Codec& j, const uint8_t* p, uint32_t size) {
    uint32_t n = j.numcomps();
    uint32_t room = n <= 256 ? 1 : 2;
    uint32_t chunk = 5 + 2 * room;
    uint32_t count = size / chunk;
    if (count == 0 || size % chunk != 0) fail(HEADER_ERROR, "Error reading POC marker");
    Tcp& t = j.cur_tcp();
    uint32_t old = t.poc ? t.numpocs + 1 : 0;
    count += old;
    if (count >= MAX_POCS) fail(HEADER_ERROR, "Too many POCs");
    t.poc = true;
    for (uint32_t i = old; i < count; i++, p += chunk) {
        Poc& c = t.pocs[i];
        c.resno0 = p[0];
        c.compno0 = rd(p + 1, room);
        c.layno1 = std::min(rd(p + 1 + room, 2), t.numlayers);
        c.resno1 = p[3 + room];
        c.compno1 = std::min(rd(p + 4 + room, room), n);
        c.prg = p[4 + 2 * room];
    }
    t.numpocs = count - 1;
}

void read_tlm(Codec&, const uint8_t*, uint32_t size) {
    // the entries only serve to decode a subset of the tiles
    if (size < 2) fail(HEADER_ERROR, "Error reading TLM marker");
}

void read_plm(Codec&, const uint8_t*, uint32_t size) {
    if (size < 1) fail(HEADER_ERROR, "Error reading PLM marker");
}

void read_plt(Codec&, const uint8_t* p, uint32_t size) {
    if (size < 1) fail(HEADER_ERROR, "Error reading PLT marker");
    uint32_t len = 0;
    for (uint32_t i = 1; i < size; i++) {
        len |= p[i] & 0x7f;
        if (p[i] & 0x80)
            len <<= 7;
        else
            len = 0;
    }
    if (len != 0) fail(HEADER_ERROR, "Error reading PLT marker");
}

void read_ppm(Codec& j, const uint8_t* p, uint32_t size) {
    if (size < 2) fail(HEADER_ERROR, "Error reading PPM marker");
    j.ppm = true;
    uint32_t z = p[0];
    if (j.ppm_markers.size() <= z) {
        j.ppm_markers.resize(z + 1);
        j.ppm_present.resize(z + 1, false);
    }
    if (j.ppm_present[z]) fail(HEADER_ERROR, "Zppm already read");
    j.ppm_present[z] = true;
    j.ppm_markers[z].assign(p + 1, p + size);
}

void read_ppt(Codec& j, const uint8_t* p, uint32_t size) {
    if (j.ppm)
        fail(HEADER_ERROR, "Error reading PPT marker: packet header have been previously found in the main header "
                           "(PPM marker).");
    if (size < 2) fail(HEADER_ERROR, "Error reading PPT marker");
    Tcp& t = j.tcps[j.current_tile];
    t.ppt = true;
    uint32_t z = p[0];
    if (t.ppt_markers.size() <= z) {
        t.ppt_markers.resize(z + 1);
        t.ppt_present.resize(z + 1, false);
    }
    if (t.ppt_present[z]) fail(HEADER_ERROR, "Zppt already read");
    t.ppt_present[z] = true;
    t.ppt_markers[z].assign(p + 1, p + size);
}

void read_crg(Codec& j, const uint8_t*, uint32_t size) {
    if (size != j.numcomps() * 4) fail(HEADER_ERROR, "Error reading CRG marker");
}

void read_mct(Codec& j, const uint8_t* p, uint32_t size) {
    Tcp& t = j.cur_tcp();
    if (size < 2) fail(HEADER_ERROR, "Error reading MCT marker");
    if (rd(p, 2) != 0) return;  // "Cannot take in charge mct data within multiple MCT records"
    if (size <= 6) fail(HEADER_ERROR, "Error reading MCT marker");
    uint32_t imct = rd(p + 2, 2), index = imct & 0xff;
    size_t i = 0;
    while (i < t.mct_records.size() && t.mct_records[i].index != index) i++;
    if (i == t.mct_records.size()) t.mct_records.emplace_back();
    MctRecord& r = t.mct_records[i];
    r.data.clear();
    r.index = index;
    r.element_type = (imct >> 10) & 3;
    if (rd(p + 4, 2) != 0) return;  // "Cannot take in charge multiple MCT markers"
    r.data.assign(p + 6, p + size);
}

// opj_j2k_merge_ppm: the PPM segments in Zppm order, each a run of
// (Nppm, Nppm bytes of packet headers) that may continue into the next
void merge_ppm(Codec& j) {
    if (!j.ppm) return;
    uint32_t remaining = 0;
    std::vector<uint8_t> out;
    for (size_t i = 0; i < j.ppm_markers.size(); i++) {
        if (!j.ppm_present[i]) continue;
        const std::vector<uint8_t>& m = j.ppm_markers[i];
        size_t pos = 0, size = m.size();
        if (remaining >= size) {
            out.insert(out.end(), m.begin(), m.end());
            remaining -= (uint32_t)size;
            continue;
        }
        out.insert(out.end(), m.begin(), m.begin() + remaining);
        pos = remaining;
        remaining = 0;
        while (pos < size) {
            if (size - pos < 4) fail(HEADER_ERROR, "Not enough bytes to read Nppm");
            uint32_t n = rd(m.data() + pos, 4);
            pos += 4;
            if (size - pos >= n) {
                out.insert(out.end(), m.begin() + pos, m.begin() + pos + n);
                pos += n;
            } else {
                out.insert(out.end(), m.begin() + pos, m.end());
                remaining = n - (uint32_t)(size - pos);
                pos = size;
            }
        }
    }
    if (remaining != 0) fail(HEADER_ERROR, "Corrupted PPM markers");
    j.ppm_buffer = std::move(out);
    j.ppm_pos = 0;
    j.ppm_len = j.ppm_buffer.size();
}

// opj_j2k_merge_ppt
void merge_ppt(Tcp& t) {
    if (!t.ppt_buffer.empty() || t.ppt_len) fail(DECODE_ERROR, "opj_j2k_merge_ppt() has already been called");
    if (!t.ppt) return;
    std::vector<uint8_t> out;
    for (size_t i = 0; i < t.ppt_markers.size(); i++)
        if (t.ppt_present[i]) out.insert(out.end(), t.ppt_markers[i].begin(), t.ppt_markers[i].end());
    t.ppt_buffer = std::move(out);
    t.ppt_pos = 0;
    t.ppt_len = t.ppt_buffer.size();
    t.ppt_markers.clear();
    t.ppt_present.clear();
}

void get_sot_values(const uint8_t* p, uint32_t size, uint32_t* tile, uint32_t* tot_len, uint32_t* part,
                    uint32_t* num_parts) {
    if (size != 8) fail(HEADER_ERROR, "Error reading SOT marker");
    *tile = rd(p, 2);
    *tot_len = rd(p + 2, 4);
    *part = p[6];
    *num_parts = p[7];
}

void read_sot(Codec& j, const uint8_t* p, uint32_t size) {
    uint32_t tot_len, part, num_parts;
    get_sot_values(p, size, &j.current_tile, &tot_len, &part, &num_parts);
    if (j.current_tile >= j.tw * j.th) fail(HEADER_ERROR, "Invalid tile number");
    Tcp& t = j.tcps[j.current_tile];
    if (t.current_tile_part + 1 != (int32_t)part) fail(HEADER_ERROR, "Invalid tile part index for tile number");
    t.current_tile_part = (int32_t)part;
    if (tot_len != 0 && tot_len < 14 && tot_len != 12)
        fail(HEADER_ERROR, "Psot value is not correct regards to the JPEG2000 norm");
    if (!tot_len) j.last_tile_part = true;
    if (t.nb_tile_parts != 0 && part >= t.nb_tile_parts) {
        j.last_tile_part = true;
        fail(HEADER_ERROR, "In SOT marker, TPSot is not valid regards to the previous number of tile-part");
    }
    if (num_parts != 0) {
        num_parts += j.nb_tile_parts_correction;
        if (t.nb_tile_parts && part >= t.nb_tile_parts) {
            j.last_tile_part = true;
            fail(HEADER_ERROR, "In SOT marker, TPSot is not valid regards to the current number of tile-part");
        }
        if (part >= num_parts) {
            j.last_tile_part = true;
            fail(HEADER_ERROR, "In SOT marker, TPSot is not valid regards to the current number of tile-part (header)");
        }
        t.nb_tile_parts = num_parts;
    }
    if (t.nb_tile_parts && t.nb_tile_parts == part + 1) j.can_decode = true;
    j.sot_length = j.last_tile_part ? 0 : tot_len - 12;
    j.state = ST_TPH;
    j.skip_data = false;
}

typedef void (*Handler)(Codec&, const uint8_t*, uint32_t);

void read_noop(Codec&, const uint8_t*, uint32_t) {}

struct MarkerHandler {
    uint32_t id, states;
    Handler handler;
};

// j2k_memory_marker_handler_tab
void read_cbd(Codec&, const uint8_t*, uint32_t);
void read_mcc(Codec&, const uint8_t*, uint32_t);
void read_mco(Codec&, const uint8_t*, uint32_t);

const MarkerHandler HANDLERS[] = {
    {MS_SOT, ST_MH | ST_TPHSOT, read_sot},  {MS_COD, ST_MH | ST_TPH, read_cod},   {MS_COC, ST_MH | ST_TPH, read_coc},
    {MS_RGN, ST_MH | ST_TPH, read_rgn},     {MS_QCD, ST_MH | ST_TPH, read_qcd},   {MS_QCC, ST_MH | ST_TPH, read_qcc},
    {MS_POC, ST_MH | ST_TPH, read_poc},     {MS_SIZ, ST_MHSIZ, read_siz},         {MS_TLM, ST_MH, read_tlm},
    {MS_PLM, ST_MH, read_plm},              {MS_PLT, ST_TPH, read_plt},           {MS_PPM, ST_MH, read_ppm},
    {MS_PPT, ST_TPH, read_ppt},             {MS_SOP, 0, nullptr},                 {MS_CRG, ST_MH, read_crg},
    {MS_COM, ST_MH | ST_TPH, read_noop},    {MS_MCT, ST_MH | ST_TPH, read_mct},   {MS_CBD, ST_MH, read_cbd},
    {MS_CAP, ST_MH, read_noop},             {MS_CPF, ST_MH, read_noop},           {MS_MCC, ST_MH | ST_TPH, read_mcc},
    {MS_MCO, ST_MH | ST_TPH, read_mco},
};
const MarkerHandler UNKNOWN_HANDLER = {MS_UNK, ST_MH | ST_TPH, nullptr};

const MarkerHandler& get_handler(uint32_t id) {
    for (const MarkerHandler& h : HANDLERS)
        if (h.id == id) return h;
    return UNKNOWN_HANDLER;
}

bool read2(Codec& j, uint32_t* v) {
    uint8_t b[2];
    if (!j.s.read(b, 2)) return false;
    *v = rd(b, 2);
    return true;
}

// opj_j2k_read_unk: skip two bytes at a time to the next known marker
uint32_t read_unk(Codec& j) {
    for (;;) {
        uint32_t m;
        if (!read2(j, &m)) fail(HEADER_ERROR, "Stream too short");
        if (m >= 0xff00) {
            const MarkerHandler& h = get_handler(m);
            if (!(j.state & h.states)) fail(HEADER_ERROR, "Marker is not compliant with its position");
            if (h.id != MS_UNK) return h.id;
        }
    }
}

void read_header(Codec& j) {
    uint32_t m;
    if (!read2(j, &m) || m != MS_SOC) fail(HEADER_ERROR, "Expected a SOC marker");
    j.state = ST_MHSIZ;
    if (!read2(j, &m)) fail(HEADER_ERROR, "Stream too short");
    bool has_siz = false, has_cod = false, has_qcd = false;
    while (m != MS_SOT) {
        if (m < 0xff00) fail(HEADER_ERROR, "A marker ID was expected (0xff--)");
        const MarkerHandler* h = &get_handler(m);
        if (h->id == MS_UNK) {
            m = read_unk(j);
            if (m == MS_SOT) break;
            h = &get_handler(m);
        }
        if (h->id == MS_SIZ) has_siz = true;
        if (h->id == MS_COD) has_cod = true;
        if (h->id == MS_QCD) has_qcd = true;
        if (!(j.state & h->states)) fail(HEADER_ERROR, "Marker is not compliant with its position");
        uint32_t size;
        if (!read2(j, &size)) fail(HEADER_ERROR, "Stream too short");
        if (size < 2) fail(HEADER_ERROR, "Invalid marker size");
        size -= 2;
        j.header.resize(std::max<size_t>(size, 1));
        if (!j.s.read(j.header.data(), size)) fail(HEADER_ERROR, "Stream too short");
        h->handler(j, j.header.data(), size);
        if (!read2(j, &m)) fail(HEADER_ERROR, "Stream too short");
    }
    if (!has_siz) fail(HEADER_ERROR, "required SIZ marker not found in main header");
    if (!has_cod) fail(HEADER_ERROR, "required COD marker not found in main header");
    if (!has_qcd) fail(HEADER_ERROR, "required QCD marker not found in main header");
    merge_ppm(j);
    j.state = ST_TPHSOT;
    // opj_j2k_copy_default_tcp_and_create_tcd
    for (Tcp& t : j.tcps) {
        std::vector<Tccp> tccps = j.default_tcp.tccps;
        t = j.default_tcp;
        t.cod = false;
        t.ppt = false;
        t.ppt_markers.clear();
        t.ppt_present.clear();
        t.ppt_buffer.clear();
        t.ppt_len = 0;
        t.current_tile_part = -1;
        t.tccps = std::move(tccps);
        t.has_data = false;
        t.data.clear();
    }
}

// Part 2 markers: CBD changes the components' precision and sign; MCO sets
// the DC level shifts to 0, or to an MCC record's offsets.
void read_cbd(Codec& j, const uint8_t* p, uint32_t size) {
    if (size != j.numcomps() + 2) fail(HEADER_ERROR, "Error reading CBD marker");
    if (rd(p, 2) != j.numcomps()) fail(HEADER_ERROR, "Error reading CBD marker");
    for (uint32_t i = 0; i < j.numcomps(); i++) {
        uint32_t v = p[2 + i];
        j.comps[i].sgnd = (v >> 7) & 1;
        j.comps[i].prec = (v & 0x7f) + 1;
        if (j.comps[i].prec > 31) fail(HEADER_ERROR, "Invalid values for comp: prec in CBD");
    }
}

// opj_j2k_read_mcc: one collection of array decorrelation, components in
// order; a record found by its index is changed in place, a new one kept
// only when the whole segment reads
void read_mcc(Codec& j, const uint8_t* p, uint32_t size) {
    Tcp& t = j.cur_tcp();
    if (size < 2) fail(HEADER_ERROR, "Error reading MCC marker");
    if (rd(p, 2) != 0) return;  // "Cannot take in charge multiple data spanning"
    if (size < 7) fail(HEADER_ERROR, "Error reading MCC marker");
    uint32_t index = p[2];
    size_t found = 0;
    while (found < t.mcc_records.size() && t.mcc_records[found].index != index) found++;
    MccRecord fresh;
    MccRecord& r = found < t.mcc_records.size() ? t.mcc_records[found] : fresh;
    r.index = index;
    if (rd(p + 3, 2) != 0) return;  // "Cannot take in charge multiple data spanning"
    uint32_t collections = rd(p + 5, 2);
    if (collections > 1) return;  // "Cannot take in charge multiple collections"
    size -= 7;
    p += 7;
    auto find_mct = [&](uint32_t idx) {
        for (size_t k = 0; k < t.mct_records.size(); k++)
            if (t.mct_records[k].index == idx) return (int)k;
        return -1;
    };
    for (uint32_t c = 0; c < collections; c++) {
        if (size < 3) fail(HEADER_ERROR, "Error reading MCC marker");
        if (p[0] != 1) return;  // "Cannot take in charge collections other than array decorrelation"
        uint32_t n = rd(p + 1, 2);
        p += 3;
        size -= 3;
        uint32_t bytes = 1 + (n >> 15);
        r.nb_comps = n & 0x7fff;
        if (size < bytes * r.nb_comps + 2) fail(HEADER_ERROR, "Error reading MCC marker");
        size -= bytes * r.nb_comps + 2;
        for (uint32_t k = 0; k < r.nb_comps; k++, p += bytes)
            if (rd(p, (int)bytes) != k) return;  // "Cannot take in charge collections with indix shuffle"
        n = rd(p, 2);
        p += 2;
        bytes = 1 + (n >> 15);
        if ((n & 0x7fff) != r.nb_comps) return;  // "... without same number of indixes"
        if (size < bytes * r.nb_comps + 3) fail(HEADER_ERROR, "Error reading MCC marker");
        size -= bytes * r.nb_comps + 3;
        for (uint32_t k = 0; k < r.nb_comps; k++, p += bytes)
            if (rd(p, (int)bytes) != k) return;  // "Cannot take in charge collections with indix shuffle"
        uint32_t v = rd(p, 3);
        p += 3;
        r.decorrelation = r.offset = -1;
        if ((v & 0xff) != 0) {
            r.decorrelation = find_mct(v & 0xff);
            if (r.decorrelation < 0) fail(HEADER_ERROR, "Error reading MCC marker");
        }
        if (((v >> 8) & 0xff) != 0) {
            r.offset = find_mct((v >> 8) & 0xff);
            if (r.offset < 0) fail(HEADER_ERROR, "Error reading MCC marker");
        }
    }
    if (size != 0) fail(HEADER_ERROR, "Error reading MCC marker");
    if (found == t.mcc_records.size()) t.mcc_records.push_back(fresh);
}

// an MCT record's element, as opj_j2k_read_*_to_int32 gives it
int32_t mct_element(const MctRecord& r, size_t i) {
    static const int SIZE[4] = {2, 4, 4, 8};
    const uint8_t* p = r.data.data() + i * SIZE[r.element_type];
    switch (r.element_type) {
    case 0:
        return (int32_t)rd(p, 2);
    case 1:
        return (int32_t)rd(p, 4);
    case 2: {
        uint32_t bits = rd(p, 4);
        float f;
        memcpy(&f, &bits, 4);
        return f > -2147483649.0f && f < 2147483648.0f ? (int32_t)f : INT32_MIN;  // cvttss2si
    }
    default: {
        uint64_t bits = ((uint64_t)rd(p, 4) << 32) | rd(p + 4, 4);
        double d;
        memcpy(&d, &bits, 8);
        return d > -2147483649.0 && d < 2147483648.0 ? (int32_t)d : INT32_MIN;
    }
    }
}

// opj_j2k_add_mct (its search looks at the first MCC record only): the
// record's offsets become the DC level shifts
void add_mct(Codec& j, Tcp& t, uint32_t index) {
    static const uint32_t SIZE[4] = {2, 4, 4, 8};
    if (t.mcc_records.empty() || t.mcc_records[0].index != index) return;  // "element discarded"
    const MccRecord& r = t.mcc_records[0];
    uint32_t n = j.numcomps();
    if (r.nb_comps != n) return;
    if (r.decorrelation >= 0) {
        const MctRecord& m = t.mct_records[(size_t)r.decorrelation];
        if (m.data.size() != SIZE[m.element_type] * n * n) fail(HEADER_ERROR, "an MCT decorrelation array of a bad size");
    }
    if (r.offset >= 0) {
        const MctRecord& m = t.mct_records[(size_t)r.offset];
        if (m.data.size() != SIZE[m.element_type] * n) fail(HEADER_ERROR, "an MCT offset array of a bad size");
        for (uint32_t c = 0; c < n; c++) t.tccps[c].dc_level_shift = mct_element(m, c);
    }
}

void read_mco(Codec& j, const uint8_t* p, uint32_t size) {
    if (size < 1) fail(HEADER_ERROR, "Error reading MCO marker");
    uint32_t stages = p[0];
    if (stages > 1) return;  // "Cannot take in charge multiple transformation stages."
    if (size != stages + 1) fail(HEADER_ERROR, "Error reading MCO marker");
    Tcp& t = j.cur_tcp();
    for (Tccp& c : t.tccps) c.dc_level_shift = 0;
    for (uint32_t i = 0; i < stages; i++) add_mct(j, t, p[1 + i]);
}

// -- tile structure (tcd.c opj_tcd_init_tile) --------------------------------

int32_t ceildivpow2(int64_t a, uint32_t b) { return (int32_t)((a + ((int64_t)1 << b) - 1) >> b); }
int32_t floordivpow2(int32_t a, uint32_t b) { return a >> b; }
uint32_t uceildiv(uint32_t a, uint32_t b) { return (uint32_t)(((uint64_t)a + b - 1) / b); }
uint32_t uceildivpow2(uint32_t a, uint32_t b) { return (uint32_t)(((uint64_t)a + ((uint64_t)1 << b) - 1) >> b); }
uint32_t floorlog2(uint32_t a) {
    uint32_t l = 0;
    while (a > 1) {
        a >>= 1;
        l++;
    }
    return l;
}

struct TagTree {
    std::vector<int32_t> value, low, parent;
    void build(uint32_t w, uint32_t h) {
        std::vector<uint32_t> base, nw, nh;
        uint32_t total = 0, cw = w, ch = h, n;
        do {
            n = cw * ch;
            base.push_back(total);
            nw.push_back(cw);
            nh.push_back(ch);
            total += n;
            cw = (cw + 1) / 2;
            ch = (ch + 1) / 2;
        } while (n > 1);
        value.assign(total, 999);
        low.assign(total, 0);
        parent.assign(total, -1);
        for (size_t l = 0; l + 1 < base.size(); l++)
            for (uint32_t y = 0; y < nh[l]; y++)
                for (uint32_t x = 0; x < nw[l]; x++)
                    parent[base[l] + y * nw[l] + x] = (int32_t)(base[l + 1] + (y / 2) * nw[l + 1] + x / 2);
    }
    void reset() {
        std::fill(value.begin(), value.end(), 999);
        std::fill(low.begin(), low.end(), 0);
    }
};

struct Bio {
    const uint8_t *start, *bp, *end;
    uint32_t buf = 0, ct = 0;
    Bio(const uint8_t* p, size_t len) : start(p), bp(p), end(p + len) {}
    void bytein() {
        buf = (buf << 8) & 0xffff;
        ct = buf == 0xff00 ? 7 : 8;
        if (bp < end) buf |= *bp++;
    }
    uint32_t bit() {
        if (ct == 0) bytein();
        ct--;
        return (buf >> ct) & 1;
    }
    uint32_t read(uint32_t n) {
        uint32_t v = 0;
        for (uint32_t i = n - 1; i < n; i--) v |= bit() << i;
        return v;
    }
    void inalign() {
        if ((buf & 0xff) == 0xff) bytein();
        ct = 0;
    }
    size_t numbytes() const { return (size_t)(bp - start); }
};

uint32_t tgt_decode(Bio& bio, TagTree& t, uint32_t leaf, int32_t threshold) {
    int32_t stk[32];
    int sp = 0;
    int32_t node = (int32_t)leaf;
    while (t.parent[node] >= 0) {
        stk[sp++] = node;
        node = t.parent[node];
    }
    int32_t low = 0;
    for (;;) {
        if (low > t.low[node])
            t.low[node] = low;
        else
            low = t.low[node];
        while (low < threshold && low < t.value[node]) {
            if (bio.read(1))
                t.value[node] = low;
            else
                ++low;
        }
        t.low[node] = low;
        if (sp == 0) break;
        node = stk[--sp];
    }
    return t.value[node] < threshold ? 1 : 0;
}

struct Seg {
    uint32_t len = 0, numpasses = 0, real_num_passes = 0, maxpasses = 0, numnewpasses = 0, newlen = 0;
};

struct Cblk {
    int32_t x0 = 0, y0 = 0, x1 = 0, y1 = 0;
    uint32_t numbps = 0, numlenbits = 0, numnewpasses = 0, numsegs = 0, real_num_segs = 0;
    std::vector<Seg> segs;
    std::vector<std::pair<const uint8_t*, uint32_t>> chunks;
};

struct Precinct {
    int32_t x0 = 0, y0 = 0, x1 = 0, y1 = 0;
    uint32_t cw = 0, ch = 0;
    std::vector<Cblk> cblks;
    bool trees = false;
    TagTree incl, imsb;
};

struct Band {
    uint32_t bandno = 0;
    int32_t x0 = 0, y0 = 0, x1 = 0, y1 = 0;
    float stepsize = 0;
    int32_t numbps = 0;
    std::vector<Precinct> precincts;
    bool empty() const { return x1 - x0 == 0 || y1 - y0 == 0; }
};

struct Res {
    int32_t x0 = 0, y0 = 0, x1 = 0, y1 = 0;
    uint32_t pw = 0, ph = 0, numbands = 0;
    Band bands[3];
};

struct TileComp {
    int32_t x0 = 0, y0 = 0, x1 = 0, y1 = 0;
    uint32_t numresolutions = 0;
    std::vector<Res> res;
    std::vector<int32_t> data;  // int32 or float bits, as OpenJPEG keeps them
};

struct Tile {
    int32_t x0 = 0, y0 = 0, x1 = 0, y1 = 0;
    std::vector<TileComp> comps;
};

void init_tile(Codec& j, uint32_t tileno, Tile& tile) {
    Tcp& tcp = j.tcps[tileno];
    uint32_t p = tileno % j.tw, q = tileno / j.tw;
    uint64_t ax = (uint64_t)j.tx0 + (uint64_t)p * j.tdx, ay = (uint64_t)j.ty0 + (uint64_t)q * j.tdy;
    uint32_t ux0 = (uint32_t)std::max<uint64_t>(ax, j.x0), uy0 = (uint32_t)std::max<uint64_t>(ay, j.y0);
    uint32_t ux1 = (uint32_t)std::min<uint64_t>(std::min<uint64_t>(ax + j.tdx, 0xffffffffu), j.x1);
    uint32_t uy1 = (uint32_t)std::min<uint64_t>(std::min<uint64_t>(ay + j.tdy, 0xffffffffu), j.y1);
    tile.x0 = (int32_t)ux0;
    tile.y0 = (int32_t)uy0;
    tile.x1 = (int32_t)ux1;
    tile.y1 = (int32_t)uy1;
    if (tile.x0 < 0 || tile.x1 <= tile.x0 || tile.y0 < 0 || tile.y1 <= tile.y0)
        fail(DECODE_ERROR, "Tile X coordinates are not supported");
    tile.comps.assign(j.numcomps(), TileComp());
    for (uint32_t compno = 0; compno < j.numcomps(); compno++) {
        const Comp& ic = j.comps[compno];
        const Tccp& tccp = tcp.tccps[compno];
        TileComp& tc = tile.comps[compno];
        tc.x0 = (int32_t)uceildiv(ux0, ic.dx);
        tc.y0 = (int32_t)uceildiv(uy0, ic.dy);
        tc.x1 = (int32_t)uceildiv(ux1, ic.dx);
        tc.y1 = (int32_t)uceildiv(uy1, ic.dy);
        tc.numresolutions = tccp.numresolutions;
        tc.res.assign(tc.numresolutions, Res());
        uint32_t level_no = tc.numresolutions;
        int band_index = 0;
        for (uint32_t resno = 0; resno < tc.numresolutions; resno++) {
            Res& r = tc.res[resno];
            --level_no;
            r.x0 = ceildivpow2(tc.x0, level_no);
            r.y0 = ceildivpow2(tc.y0, level_no);
            r.x1 = ceildivpow2(tc.x1, level_no);
            r.y1 = ceildivpow2(tc.y1, level_no);
            uint32_t pdx = tccp.prcw[resno], pdy = tccp.prch[resno];
            int32_t tl_x = floordivpow2(r.x0, pdx) << pdx, tl_y = floordivpow2(r.y0, pdy) << pdy;
            uint64_t brx = (uint64_t)(uint32_t)ceildivpow2(r.x1, pdx) << pdx;
            uint64_t bry = (uint64_t)(uint32_t)ceildivpow2(r.y1, pdy) << pdy;
            if ((uint32_t)brx > (uint32_t)INT32_MAX || (uint32_t)bry > (uint32_t)INT32_MAX)
                fail(DECODE_ERROR, "Integer overflow");
            int32_t br_x = (int32_t)(uint32_t)brx, br_y = (int32_t)(uint32_t)bry;
            r.pw = r.x0 == r.x1 ? 0 : (uint32_t)((br_x - tl_x) >> pdx);
            r.ph = r.y0 == r.y1 ? 0 : (uint32_t)((br_y - tl_y) >> pdy);
            if (r.pw != 0 && 0xffffffffu / r.pw < r.ph) fail(DECODE_ERROR, "Size of tile data exceeds system limits");
            uint32_t nb_precincts = r.pw * r.ph;
            if (nb_precincts > (1u << 22)) fail(DECODE_ERROR, "Size of tile data exceeds system limits");
            int32_t cbg_x, cbg_y;
            uint32_t cbgw, cbgh;
            if (resno == 0) {
                cbg_x = tl_x;
                cbg_y = tl_y;
                cbgw = pdx;
                cbgh = pdy;
                r.numbands = 1;
            } else {
                cbg_x = ceildivpow2(tl_x, 1);
                cbg_y = ceildivpow2(tl_y, 1);
                cbgw = pdx - 1;
                cbgh = pdy - 1;
                r.numbands = 3;
            }
            uint32_t cblkw = std::min(tccp.cblkw, cbgw), cblkh = std::min(tccp.cblkh, cbgh);
            for (uint32_t bandno = 0; bandno < r.numbands; bandno++, band_index++) {
                Band& b = r.bands[bandno];
                if (resno == 0) {
                    b.bandno = 0;
                    b.x0 = ceildivpow2(tc.x0, level_no);
                    b.y0 = ceildivpow2(tc.y0, level_no);
                    b.x1 = ceildivpow2(tc.x1, level_no);
                    b.y1 = ceildivpow2(tc.y1, level_no);
                } else {
                    b.bandno = bandno + 1;
                    int64_t x0b = b.bandno & 1, y0b = b.bandno >> 1;
                    b.x0 = ceildivpow2((int64_t)tc.x0 - (x0b << level_no), level_no + 1);
                    b.y0 = ceildivpow2((int64_t)tc.y0 - (y0b << level_no), level_no + 1);
                    b.x1 = ceildivpow2((int64_t)tc.x1 - (x0b << level_no), level_no + 1);
                    b.y1 = ceildivpow2((int64_t)tc.y1 - (y0b << level_no), level_no + 1);
                }
                const StepSize& ss = tccp.stepsizes[band_index];
                int32_t log2_gain = tccp.qmfbid == 0 ? 0 : b.bandno == 0 ? 0 : b.bandno == 3 ? 2 : 1;
                int32_t rb = (int32_t)ic.prec + log2_gain;
                b.stepsize = (float)((1.0 + ss.mant / 2048.0) * pow(2.0, (int32_t)(rb - ss.expn)));
                b.numbps = ss.expn + (int32_t)tccp.numgbits - 1;
                b.precincts.assign(nb_precincts, Precinct());
                for (uint32_t precno = 0; precno < nb_precincts; precno++) {
                    Precinct& pr = b.precincts[precno];
                    int32_t gx0 = cbg_x + (int32_t)(precno % r.pw) * (1 << cbgw);
                    int32_t gy0 = cbg_y + (int32_t)(precno / r.pw) * (1 << cbgh);
                    int32_t gx1 = gx0 + (1 << cbgw), gy1 = gy0 + (1 << cbgh);
                    pr.x0 = std::max(gx0, b.x0);
                    pr.y0 = std::max(gy0, b.y0);
                    pr.x1 = std::min(gx1, b.x1);
                    pr.y1 = std::min(gy1, b.y1);
                    int32_t tlx = floordivpow2(pr.x0, cblkw) << cblkw, tly = floordivpow2(pr.y0, cblkh) << cblkh;
                    int32_t brcx = ceildivpow2(pr.x1, cblkw) << cblkw, brcy = ceildivpow2(pr.y1, cblkh) << cblkh;
                    pr.cw = (uint32_t)((brcx - tlx) >> cblkw);
                    pr.ch = (uint32_t)((brcy - tly) >> cblkh);
                    uint64_t nb_cblks = (uint64_t)pr.cw * pr.ch;
                    if (nb_cblks > (1u << 22)) fail(DECODE_ERROR, "Size of code block data exceeds system limits");
                    if (nb_cblks) {
                        pr.incl.build(pr.cw, pr.ch);
                        pr.imsb.build(pr.cw, pr.ch);
                        pr.trees = true;
                    }
                    pr.cblks.assign(nb_cblks, Cblk());
                    for (uint32_t cblkno = 0; cblkno < nb_cblks; cblkno++) {
                        Cblk& cb = pr.cblks[cblkno];
                        int32_t cx0 = tlx + (int32_t)(cblkno % pr.cw) * (1 << cblkw);
                        int32_t cy0 = tly + (int32_t)(cblkno / pr.cw) * (1 << cblkh);
                        cb.x0 = std::max(cx0, pr.x0);
                        cb.y0 = std::max(cy0, pr.y0);
                        cb.x1 = std::min(cx0 + (1 << cblkw), pr.x1);
                        cb.y1 = std::min(cy0 + (1 << cblkh), pr.y1);
                    }
                }
            }
        }
    }
}

// -- packet iterator (pi.c) -----------------------------------------------------

struct PiRes {
    uint32_t pdx, pdy, pw, ph;
};

struct Pi {
    uint32_t tx0, ty0, tx1, ty1;
    uint32_t step_l, step_r, step_c, step_p;
    std::vector<std::vector<PiRes>> comps;  // per component, per resolution
    std::vector<uint32_t> dx, dy;          // the components' sub-sampling
    std::vector<int16_t>* include;
    // the current progression (its POC)
    int32_t prg;
    uint32_t resno0, resno1, compno0, compno1, layno0, layno1, precno0, precno1;
    bool first = true;
    uint32_t layno = 0, resno = 0, compno = 0, precno = 0, x = 0, y = 0, pdx_min = 0, pdy_min = 0;
    uint32_t numcomps() const { return (uint32_t)comps.size(); }
};

// the loops of opj_pi_next_* as a generator: `include` keeps the packets
// already given, and a call resumes after the packet it returned
bool pi_take(Pi& pi) {
    uint32_t index = pi.layno * pi.step_l + pi.resno * pi.step_r + pi.compno * pi.step_c + pi.precno * pi.step_p;
    if (index >= pi.include->size()) throw 0;  // "Invalid access to pi->include": the iteration ends
    if (!(*pi.include)[index]) {
        (*pi.include)[index] = 1;
        return true;
    }
    return false;
}

// B.12.1.3-5: the precinct of (x, y) at (compno, resno), or false to skip it
bool pi_position(Pi& pi) {
    uint32_t nres = (uint32_t)pi.comps[pi.compno].size();
    if (pi.resno >= nres) return false;
    const PiRes& res = pi.comps[pi.compno][pi.resno];
    uint32_t dx = pi.dx[pi.compno], dy = pi.dy[pi.compno];
    uint32_t levelno = nres - 1 - pi.resno;
    if (levelno >= 32 || ((dx << levelno) >> levelno) != dx || ((dy << levelno) >> levelno) != dy) return false;
    uint32_t trx0 = uceildiv(pi.tx0, dx << levelno), try0 = uceildiv(pi.ty0, dy << levelno);
    uint32_t trx1 = uceildiv(pi.tx1, dx << levelno), try1 = uceildiv(pi.ty1, dy << levelno);
    uint32_t rpx = res.pdx + levelno, rpy = res.pdy + levelno;
    if (rpx >= 31 || ((dx << rpx) >> rpx) != dx || rpy >= 31 || ((dy << rpy) >> rpy) != dy) return false;
    if (!(((uint64_t)pi.y % ((uint64_t)dy << rpy) == 0) ||
          ((pi.y == pi.ty0) && (((uint64_t)try0 << levelno) % ((uint64_t)1 << rpy)))))
        return false;
    if (!(((uint64_t)pi.x % ((uint64_t)dx << rpx) == 0) ||
          ((pi.x == pi.tx0) && (((uint64_t)trx0 << levelno) % ((uint64_t)1 << rpx)))))
        return false;
    if (res.pw == 0 || res.ph == 0) return false;
    if (trx0 == trx1 || try0 == try1) return false;
    uint32_t prci = (uceildiv(pi.x, dx << levelno) >> res.pdx) - (trx0 >> res.pdx);
    uint32_t prcj = (uceildiv(pi.y, dy << levelno) >> res.pdy) - (try0 >> res.pdy);
    pi.precno = prci + prcj * res.pw;
    return true;
}

void pi_minimum_steps(Pi& pi, uint32_t c0, uint32_t c1) {
    pi.pdx_min = pi.pdy_min = 0;
    for (uint32_t compno = c0; compno < c1; compno++) {
        uint32_t nres = (uint32_t)pi.comps[compno].size();
        for (uint32_t resno = 0; resno < nres; resno++) {
            const PiRes& res = pi.comps[compno][resno];
            uint32_t sx = res.pdx + nres - 1 - resno, sy = res.pdy + nres - 1 - resno;
            if (sx < 32 && pi.dx[compno] <= 0xffffffffu / (1u << sx)) {
                uint32_t d = pi.dx[compno] * (1u << sx);
                pi.pdx_min = !pi.pdx_min ? d : std::min(pi.pdx_min, d);
            }
            if (sy < 32 && pi.dy[compno] <= 0xffffffffu / (1u << sy)) {
                uint32_t d = pi.dy[compno] * (1u << sy);
                pi.pdy_min = !pi.pdy_min ? d : std::min(pi.pdy_min, d);
            }
        }
    }
}

// the next position of a precinct grid of step `d` (pi.c's x and y loops)
uint32_t next_step(uint32_t v, uint32_t d) { return v + d - v % d; }

// one generator per progression, written as the nested loops with a resume
// flag: `pi.first` starts them, otherwise control returns just after the
// packet last given
bool pi_next(Pi& pi) {
    try {
        if (pi.prg < LRCP || pi.prg > CPRL) return false;
        if (pi.compno0 >= pi.numcomps() || pi.compno1 >= pi.numcomps() + 1) return false;
        bool resume = !pi.first;
        pi.first = false;
        switch (pi.prg) {
        case LRCP:
            for (pi.layno = resume ? pi.layno : pi.layno0; pi.layno < pi.layno1; pi.layno++, resume = false) {
                for (pi.resno = resume ? pi.resno : pi.resno0; pi.resno < pi.resno1; pi.resno++, resume = false) {
                    for (pi.compno = resume ? pi.compno : pi.compno0; pi.compno < pi.compno1;
                         pi.compno++, resume = false) {
                        if (pi.resno >= pi.comps[pi.compno].size()) continue;
                        const PiRes& res = pi.comps[pi.compno][pi.resno];
                        pi.precno1 = res.pw * res.ph;
                        for (pi.precno = resume ? pi.precno + 1 : pi.precno0; pi.precno < pi.precno1; pi.precno++) {
                            resume = false;
                            if (pi_take(pi)) return true;
                        }
                    }
                }
            }
            return false;
        case RLCP:
            for (pi.resno = resume ? pi.resno : pi.resno0; pi.resno < pi.resno1; pi.resno++, resume = false) {
                for (pi.layno = resume ? pi.layno : pi.layno0; pi.layno < pi.layno1; pi.layno++, resume = false) {
                    for (pi.compno = resume ? pi.compno : pi.compno0; pi.compno < pi.compno1;
                         pi.compno++, resume = false) {
                        if (pi.resno >= pi.comps[pi.compno].size()) continue;
                        const PiRes& res = pi.comps[pi.compno][pi.resno];
                        pi.precno1 = res.pw * res.ph;
                        for (pi.precno = resume ? pi.precno + 1 : pi.precno0; pi.precno < pi.precno1; pi.precno++) {
                            resume = false;
                            if (pi_take(pi)) return true;
                        }
                    }
                }
            }
            return false;
        case RPCL:
            if (!resume) {
                pi_minimum_steps(pi, 0, pi.numcomps());
                if (pi.pdx_min == 0 || pi.pdy_min == 0) return false;
            }
            for (pi.resno = resume ? pi.resno : pi.resno0; pi.resno < pi.resno1; pi.resno++, resume = false) {
                for (pi.y = resume ? pi.y : pi.ty0; pi.y < pi.ty1; pi.y = next_step(pi.y, pi.pdy_min), resume = false) {
                    for (pi.x = resume ? pi.x : pi.tx0;
                         pi.x < pi.tx1;
                         pi.x = next_step(pi.x, pi.pdx_min), resume = false) {
                        for (pi.compno = resume ? pi.compno : pi.compno0; pi.compno < pi.compno1; pi.compno++) {
                            if (!resume && !pi_position(pi)) continue;
                            for (pi.layno = resume ? pi.layno + 1 : pi.layno0; pi.layno < pi.layno1; pi.layno++) {
                                resume = false;
                                if (pi_take(pi)) return true;
                            }
                            resume = false;
                        }
                    }
                }
            }
            return false;
        case PCRL:
            if (!resume) {
                pi_minimum_steps(pi, 0, pi.numcomps());
                if (pi.pdx_min == 0 || pi.pdy_min == 0) return false;
            }
            for (pi.y = resume ? pi.y : pi.ty0; pi.y < pi.ty1; pi.y = next_step(pi.y, pi.pdy_min), resume = false) {
                for (pi.x = resume ? pi.x : pi.tx0; pi.x < pi.tx1; pi.x = next_step(pi.x, pi.pdx_min), resume = false) {
                    for (pi.compno = resume ? pi.compno : pi.compno0;
                         pi.compno < pi.compno1;
                         pi.compno++, resume = false) {
                        uint32_t rmax = std::min(pi.resno1, (uint32_t)pi.comps[pi.compno].size());
                        for (pi.resno = resume ? pi.resno : pi.resno0; pi.resno < rmax; pi.resno++) {
                            if (!resume && !pi_position(pi)) continue;
                            for (pi.layno = resume ? pi.layno + 1 : pi.layno0; pi.layno < pi.layno1; pi.layno++) {
                                resume = false;
                                if (pi_take(pi)) return true;
                            }
                            resume = false;
                        }
                    }
                }
            }
            return false;
        case CPRL:
            for (pi.compno = resume ? pi.compno : pi.compno0; pi.compno < pi.compno1; pi.compno++, resume = false) {
                if (!resume) {
                    pi_minimum_steps(pi, pi.compno, pi.compno + 1);
                    if (pi.pdx_min == 0 || pi.pdy_min == 0) return false;
                }
                uint32_t rmax = std::min(pi.resno1, (uint32_t)pi.comps[pi.compno].size());
                for (pi.y = resume ? pi.y : pi.ty0; pi.y < pi.ty1; pi.y = next_step(pi.y, pi.pdy_min), resume = false) {
                    for (pi.x = resume ? pi.x : pi.tx0;
                         pi.x < pi.tx1;
                         pi.x = next_step(pi.x, pi.pdx_min), resume = false) {
                        for (pi.resno = resume ? pi.resno : pi.resno0; pi.resno < rmax; pi.resno++) {
                            if (!resume && !pi_position(pi)) continue;
                            for (pi.layno = resume ? pi.layno + 1 : pi.layno0; pi.layno < pi.layno1; pi.layno++) {
                                resume = false;
                                if (pi_take(pi)) return true;
                            }
                            resume = false;
                        }
                    }
                }
            }
            return false;
        }
    } catch (int) {
        return false;
    }
    return false;
}

// opj_pi_create_decode: one iterator per progression (the COD's, or each POC's)
std::vector<Pi> pi_create(Codec& j, uint32_t tileno, const Tile& tile, std::vector<int16_t>& include) {
    Tcp& tcp = j.tcps[tileno];
    uint32_t n = j.numcomps();
    Pi base;
    base.tx0 = (uint32_t)tile.x0;
    base.ty0 = (uint32_t)tile.y0;
    base.tx1 = (uint32_t)tile.x1;
    base.ty1 = (uint32_t)tile.y1;
    uint32_t max_prec = 0, max_res = 0;
    base.comps.resize(n);
    for (uint32_t compno = 0; compno < n; compno++) {
        const Tccp& tccp = tcp.tccps[compno];
        const Comp& ic = j.comps[compno];
        base.dx.push_back(ic.dx);
        base.dy.push_back(ic.dy);
        uint32_t tcx0 = uceildiv(base.tx0, ic.dx), tcy0 = uceildiv(base.ty0, ic.dy);
        uint32_t tcx1 = uceildiv(base.tx1, ic.dx), tcy1 = uceildiv(base.ty1, ic.dy);
        max_res = std::max(max_res, tccp.numresolutions);
        uint32_t level_no = tccp.numresolutions;
        for (uint32_t resno = 0; resno < tccp.numresolutions; resno++) {
            --level_no;
            PiRes r;
            r.pdx = tccp.prcw[resno];
            r.pdy = tccp.prch[resno];
            uint32_t rx0 = uceildivpow2(tcx0, level_no), ry0 = uceildivpow2(tcy0, level_no);
            uint32_t rx1 = uceildivpow2(tcx1, level_no), ry1 = uceildivpow2(tcy1, level_no);
            uint32_t px0 = (rx0 >> r.pdx) << r.pdx, py0 = (ry0 >> r.pdy) << r.pdy;
            uint32_t px1 = uceildivpow2(rx1, r.pdx) << r.pdx, py1 = uceildivpow2(ry1, r.pdy) << r.pdy;
            r.pw = rx0 == rx1 ? 0 : (px1 - px0) >> r.pdx;
            r.ph = ry0 == ry1 ? 0 : (py1 - py0) >> r.pdy;
            max_prec = std::max(max_prec, r.pw * r.ph);
            base.comps[compno].push_back(r);
        }
    }
    base.step_p = 1;
    base.step_c = max_prec;
    base.step_r = n * base.step_c;
    base.step_l = max_res * base.step_r;
    uint64_t size = (uint64_t)(tcp.numlayers + 1) * base.step_l;
    if ((uint64_t)base.step_l > 0xffffffffu / (tcp.numlayers + 1u) || size > (1u << 28))
        fail(DECODE_ERROR, "Cannot allocate the packet iterator");
    include.assign((size_t)size, 0);
    base.include = &include;
    std::vector<Pi> pis(tcp.numpocs + 1, base);
    for (uint32_t pino = 0; pino <= tcp.numpocs; pino++) {
        Pi& pi = pis[pino];
        pi.first = true;
        pi.layno0 = 0;
        pi.precno0 = 0;
        pi.precno1 = max_prec;
        if (tcp.poc) {
            const Poc& poc = tcp.pocs[pino];
            pi.prg = poc.prg;
            pi.resno0 = poc.resno0;
            pi.compno0 = poc.compno0;
            pi.resno1 = poc.resno1;
            pi.compno1 = poc.compno1;
            pi.layno1 = std::min(poc.layno1, tcp.numlayers);
        } else {
            pi.prg = tcp.prg;
            pi.resno0 = 0;
            pi.compno0 = 0;
            pi.resno1 = max_res;
            pi.compno1 = n;
            pi.layno1 = tcp.numlayers;
        }
    }
    return pis;
}

// -- tier 2 (t2.c) -------------------------------------------------------------

void init_seg(Cblk& cb, uint32_t index, uint32_t cblksty, bool first) {
    if (cb.segs.size() < index + 1) cb.segs.resize(index + 1);
    Seg& seg = cb.segs[index];
    seg = Seg();
    if (cblksty & CBLKSTY_TERMALL)
        seg.maxpasses = 1;
    else if (cblksty & CBLKSTY_LAZY) {
        if (first)
            seg.maxpasses = 10;
        else {
            uint32_t prev = cb.segs[index - 1].maxpasses;
            seg.maxpasses = (prev == 1 || prev == 10) ? 2 : 1;
        }
    } else
        seg.maxpasses = 109;
}

uint32_t getnumpasses(Bio& bio) {
    uint32_t n;
    if (!bio.read(1)) return 1;
    if (!bio.read(1)) return 2;
    if ((n = bio.read(2)) != 3) return 3 + n;
    if ((n = bio.read(5)) != 31) return 6 + n;
    return 37 + bio.read(7);
}

// opj_t2_read_packet_header, then opj_t2_read_packet_data; returns the bytes
// of the tile's data the packet took
uint32_t decode_packet(Codec& j, Tcp& tcp, Tile& tile, const Pi& pi, const uint8_t* src, uint32_t max_length) {
    Res& res = tile.comps[pi.compno].res[pi.resno];
    const uint8_t* cur = src;
    if (pi.layno == 0) {
        for (uint32_t bandno = 0; bandno < res.numbands; bandno++) {
            Band& b = res.bands[bandno];
            if (b.empty()) continue;
            if (pi.precno >= b.precincts.size()) fail(DECODE_ERROR, "Invalid precinct");
            Precinct& pr = b.precincts[pi.precno];
            if (pr.trees) {
                pr.incl.reset();
                pr.imsb.reset();
            }
            for (Cblk& cb : pr.cblks) cb.numsegs = cb.real_num_segs = 0;
        }
    }
    if (tcp.csty & CP_CSTY_SOP) {  // optional: a missing one is a warning
        if (max_length >= 6 && cur[0] == 0xff && cur[1] == 0x91) cur += 6;
    }
    // the packet header: from the PPM or PPT data where there are any, else
    // from the tile data
    const uint8_t* hdr_start;
    size_t* len_ptr;
    size_t remaining;
    if (j.ppm) {
        hdr_start = j.ppm_buffer.data() + j.ppm_pos;
        len_ptr = &j.ppm_len;
    } else if (tcp.ppt) {
        hdr_start = tcp.ppt_buffer.data() + tcp.ppt_pos;
        len_ptr = &tcp.ppt_len;
    } else {
        hdr_start = cur;
        remaining = (size_t)(src + max_length - cur);
        len_ptr = &remaining;
    }
    const uint8_t* hdr = hdr_start;
    Bio bio(hdr, *len_ptr);
    uint32_t present = bio.read(1);
    uint32_t cblksty = tcp.tccps[pi.compno].cblksty;
    if (present) {
        for (uint32_t bandno = 0; bandno < res.numbands; bandno++) {
            Band& b = res.bands[bandno];
            if (b.empty()) continue;
            Precinct& pr = b.precincts[pi.precno];
            uint32_t nb = (uint32_t)pr.cblks.size();
            for (uint32_t cblkno = 0; cblkno < nb; cblkno++) {
                Cblk& cb = pr.cblks[cblkno];
                uint32_t included;
                if (!cb.numsegs)
                    included = tgt_decode(bio, pr.incl, cblkno, (int32_t)(pi.layno + 1));
                else
                    included = bio.read(1);
                if (!included) {
                    cb.numnewpasses = 0;
                    continue;
                }
                if (!cb.numsegs) {
                    uint32_t i = 0;
                    while (!tgt_decode(bio, pr.imsb, cblkno, (int32_t)i)) ++i;
                    cb.numbps = (uint32_t)b.numbps + 1 - i;
                    cb.numlenbits = 3;
                }
                cb.numnewpasses = getnumpasses(bio);
                uint32_t increment = 0;
                while (bio.read(1)) ++increment;
                cb.numlenbits += increment;
                uint32_t segno = 0;
                if (!cb.numsegs)
                    init_seg(cb, 0, cblksty, true);
                else {
                    segno = cb.numsegs - 1;
                    if (cb.segs[segno].numpasses == cb.segs[segno].maxpasses) {
                        ++segno;
                        init_seg(cb, segno, cblksty, false);
                    }
                }
                int32_t n = (int32_t)cb.numnewpasses;
                do {
                    Seg& seg = cb.segs[segno];
                    seg.numnewpasses = (uint32_t)std::min<int32_t>((int32_t)(seg.maxpasses - seg.numpasses), n);
                    uint32_t bit_number = cb.numlenbits + floorlog2(seg.numnewpasses);
                    if (bit_number > 32) fail(DECODE_ERROR, "Invalid bit number in opj_t2_read_packet_header()");
                    seg.newlen = bit_number ? bio.read(bit_number) : 0;
                    n -= (int32_t)seg.numnewpasses;
                    if (n > 0) {
                        ++segno;
                        init_seg(cb, segno, cblksty, false);
                    }
                } while (n > 0);
            }
        }
    }
    bio.inalign();
    hdr += bio.numbytes();
    if (tcp.csty & CP_CSTY_EPH) {
        if (*len_ptr - (size_t)(hdr - hdr_start) < 2) fail(DECODE_ERROR, "Not enough space for required EPH marker");
        if (hdr[0] != 0xff || hdr[1] != 0x92) fail(DECODE_ERROR, "Expected EPH marker");
        hdr += 2;
    }
    size_t header_length = (size_t)(hdr - hdr_start);
    *len_ptr -= header_length;
    if (j.ppm)
        j.ppm_pos += header_length;
    else if (tcp.ppt)
        tcp.ppt_pos += header_length;
    else
        cur += header_length;
    uint32_t read = (uint32_t)(cur - src);
    if (!present) return read;
    // opj_t2_read_packet_data
    const uint8_t* data = cur;
    const uint8_t* end = src + max_length;
    for (uint32_t bandno = 0; bandno < res.numbands; bandno++) {
        Band& b = res.bands[bandno];
        if (b.empty()) continue;
        Precinct& pr = b.precincts[pi.precno];
        for (Cblk& cb : pr.cblks) {
            if (!cb.numnewpasses) continue;
            uint32_t segi;
            if (!cb.numsegs) {
                segi = 0;
                ++cb.numsegs;
            } else {
                segi = cb.numsegs - 1;
                if (cb.segs[segi].numpasses == cb.segs[segi].maxpasses) {
                    ++segi;
                    ++cb.numsegs;
                }
            }
            do {
                Seg& seg = cb.segs[segi];
                if ((size_t)(end - data) < seg.newlen) fail(DECODE_ERROR, "read: segment too long");
                cb.chunks.emplace_back(data, seg.newlen);
                data += seg.newlen;
                seg.len += seg.newlen;
                seg.numpasses += seg.numnewpasses;
                cb.numnewpasses -= seg.numnewpasses;
                seg.real_num_passes = seg.numpasses;
                if (cb.numnewpasses > 0) {
                    ++segi;
                    ++cb.numsegs;
                }
            } while (cb.numnewpasses > 0);
            cb.real_num_segs = cb.numsegs;
        }
    }
    return read + (uint32_t)(data - cur);
}

void t2_decode(Codec& j, uint32_t tileno, Tile& tile) {
    Tcp& tcp = j.tcps[tileno];
    std::vector<int16_t> include;
    std::vector<Pi> pis = pi_create(j, tileno, tile, include);
    for (Pi& pi : pis) pi.include = &include;
    const uint8_t* cur = tcp.data.data();
    uint32_t max_len = (uint32_t)tcp.data.size();
    for (Pi& pi : pis) {
        if (pi.prg == PROG_UNKNOWN) fail(DECODE_ERROR, "a progression order the COD marker does not define");
        while (pi_next(pi)) {
            uint32_t nread = decode_packet(j, tcp, tile, pi, cur, max_len);
            Comp& ic = j.comps[pi.compno];
            ic.resno_decoded = std::max(pi.resno, ic.resno_decoded);
            cur += nread;
            max_len -= nread;
        }
    }
}

// -- tier 1 (t1.c, mqc.c) ------------------------------------------------------

struct MqState {
    uint16_t qe;
    uint8_t nmps, nlps, sw;
};

const MqState MQ_STATES[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},   {0x0AC1, 4, 12, 0},  {0x0521, 5, 29, 0},
    {0x0221, 38, 33, 0}, {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},  {0x4801, 9, 14, 0},  {0x3801, 10, 14, 0},
    {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0}, {0x1C01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1},
    {0x5401, 16, 14, 0}, {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0}, {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0},
    {0x3001, 21, 19, 0}, {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0}, {0x1C01, 25, 22, 0},
    {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0}, {0x1401, 28, 25, 0}, {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0},
    {0x0AC1, 31, 28, 0}, {0x09C1, 32, 29, 0}, {0x08A1, 33, 30, 0}, {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0},
    {0x02A1, 36, 33, 0}, {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0}, {0x0085, 40, 37, 0},
    {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0}, {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0}, {0x0005, 45, 42, 0},
    {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0},
};

enum { CTX_ZC = 0, CTX_SC = 9, CTX_MAG = 14, CTX_AGG = 17, CTX_UNI = 18, NUM_CTX = 19 };

struct Mqc {
    const uint8_t* bp;  // within buf, which ends with 0xFF 0xFF
    uint32_t a = 0, c = 0, ct = 0;
    uint8_t state[NUM_CTX], mps[NUM_CTX];
    void reset_states() {
        memset(state, 0, sizeof(state));
        memset(mps, 0, sizeof(mps));
        state[CTX_UNI] = 46;
        state[CTX_AGG] = 3;
        state[CTX_ZC] = 4;
    }
    void bytein() {
        if (*bp == 0xff) {
            if (bp[1] > 0x8f) {
                c += 0xff00;
                ct = 8;
            } else {
                bp++;
                c += (uint32_t)*bp << 9;
                ct = 7;
            }
        } else {
            bp++;
            c += (uint32_t)*bp << 8;
            ct = 8;
        }
    }
    void init(const uint8_t* p, uint32_t len) {
        bp = p;
        c = len == 0 ? 0xffu << 16 : (uint32_t)*bp << 16;
        bytein();
        c <<= 7;
        ct -= 7;
        a = 0x8000;
    }
    void raw_init(const uint8_t* p) {
        bp = p;
        c = 0;
        ct = 0;
    }
    void renorm() {
        do {
            if (ct == 0) bytein();
            a <<= 1;
            c <<= 1;
            ct--;
        } while (a < 0x8000);
    }
    uint32_t decode(int cx) {
        const MqState& s = MQ_STATES[state[cx]];
        uint32_t d;
        a -= s.qe;
        if ((c >> 16) < s.qe) {
            if (a < s.qe) {
                d = mps[cx];
                state[cx] = s.nmps;
            } else {
                d = !mps[cx];
                if (s.sw) mps[cx] = !mps[cx];
                state[cx] = s.nlps;
            }
            a = s.qe;
            renorm();
        } else {
            c -= (uint32_t)s.qe << 16;
            if ((a & 0x8000) == 0) {
                if (a < s.qe) {
                    d = !mps[cx];
                    if (s.sw) mps[cx] = !mps[cx];
                    state[cx] = s.nlps;
                } else {
                    d = mps[cx];
                    state[cx] = s.nmps;
                }
                renorm();
            } else
                d = mps[cx];
        }
        return d;
    }
    uint32_t raw() {
        if (ct == 0) {
            if (c == 0xff) {
                if (*bp > 0x8f) {
                    c = 0xff;
                    ct = 8;
                } else {
                    c = *bp++;
                    ct = 7;
                }
            } else {
                c = *bp++;
                ct = 8;
            }
        }
        ct--;
        return (c >> ct) & 1;
    }
};

// a code-block's flags, 16 bits per sample with a border of one, the four
// rows of a stripe column side by side (one 64-bit word): the significance
// of the eight neighbours, the signs of the four direct ones, and the
// sample's own state. A sample that becomes significant sets its
// neighbours' bits, so a context is a table lookup; in VSC mode the first
// row of a stripe does not tell the stripe above (its south neighbours).
enum : uint32_t {
    N_NW = 1, N_N = 2, N_NE = 4, N_W = 8, N_E = 16, N_SW = 32, N_S = 64, N_SE = 128, NEIGHBOURS = 0xff,
    NEG_N = 1 << 8, NEG_S = 1 << 9, NEG_W = 1 << 10, NEG_E = 1 << 11,
    F_SIG = 1 << 12, F_NEG = 1 << 13, F_VISIT = 1 << 14, F_REFINED = 1 << 15
};

struct Luts {
    uint8_t zc[4][256];
    uint8_t sc[256];  // context | xor bit << 7, indexed by the N, S, W, E significance and sign bits
    Luts() {
        for (uint32_t orient = 0; orient < 4; orient++)
            for (uint32_t f = 0; f < 256; f++) {
                int hh = !!(f & N_W) + !!(f & N_E), vv = !!(f & N_N) + !!(f & N_S);
                int dd = !!(f & N_NW) + !!(f & N_NE) + !!(f & N_SW) + !!(f & N_SE);
                if (orient == 1) std::swap(hh, vv);
                int n;
                if (orient == 3) {
                    int hv = hh + vv;
                    if (!dd)
                        n = hv == 0 ? 0 : hv == 1 ? 1 : 2;
                    else if (dd == 1)
                        n = hv == 0 ? 3 : hv == 1 ? 4 : 5;
                    else if (dd == 2)
                        n = hv == 0 ? 6 : 7;
                    else
                        n = 8;
                } else if (!hh) {
                    n = !vv ? (!dd ? 0 : dd == 1 ? 1 : 2) : vv == 1 ? 3 : 4;
                } else if (hh == 1) {
                    n = !vv ? (!dd ? 5 : 6) : 7;
                } else {
                    n = 8;
                }
                zc[orient][f] = (uint8_t)n;
            }
        // index bits: 0 N sig, 1 S sig, 2 W sig, 3 E sig, 4 N neg, 5 S neg, 6 W neg, 7 E neg
        for (uint32_t i = 0; i < 256; i++) {
            auto c = [&](int sig, int neg) { return (i >> sig & 1) ? ((i >> neg & 1) ? -1 : 1) : 0; };
            int hc = std::max(-1, std::min(1, c(2, 6) + c(3, 7)));
            int vc = std::max(-1, std::min(1, c(0, 4) + c(1, 5)));
            int x = 0;
            if (hc < 0) {
                hc = -hc;
                vc = -vc;
                x = 1;
            } else if (hc == 0 && vc < 0) {
                vc = -vc;
                x = 1;
            }
            int ctx = CTX_SC + (hc == 1 ? (vc == 1 ? 4 : vc == 0 ? 3 : 2) : (vc == 1 ? 1 : 0));
            sc[i] = (uint8_t)(ctx | x << 7);
        }
    }
};

const Luts LUTS;

struct T1 {
    int w = 0, h = 0, cols = 0;
    bool vsc = false;
    std::vector<uint16_t> flags;
    std::vector<int32_t> data;
    Mqc mqc;
    // sample (x, y), -1 <= x <= w, -1 <= y <= h: stripe y / 4 (one stripe of
    // border above), column x (one of border left), row y % 4
    uint16_t* f(int x, int y) { return &flags[((size_t)((y >> 2) + 1) * cols + (size_t)(x + 1)) * 4 + (y & 3)]; }
    uint64_t column(int x, int y0) {
        uint64_t v;
        memcpy(&v, f(x, y0), 8);
        return v;
    }
    static int sc_index(uint32_t v) {
        return (int)(((v & N_N) ? 1 : 0) | ((v & N_S) ? 2 : 0) | ((v & N_W) ? 4 : 0) | ((v & N_E) ? 8 : 0) |
                     ((v >> 8 & 0xf) << 4));
    }
    void set_sig(int x, int y, uint32_t neg, int32_t value) {
        *f(x, y) |= (uint16_t)(F_SIG | (neg ? F_NEG : 0));
        data[(size_t)y * w + x] = neg ? -value : value;
        *f(x - 1, y) |= (uint16_t)(N_E | (neg ? NEG_E : 0));
        *f(x + 1, y) |= (uint16_t)(N_W | (neg ? NEG_W : 0));
        *f(x - 1, y + 1) |= N_NE;
        *f(x, y + 1) |= (uint16_t)(N_N | (neg ? NEG_N : 0));
        *f(x + 1, y + 1) |= N_NW;
        if (!(vsc && (y & 3) == 0)) {
            *f(x - 1, y - 1) |= N_SE;
            *f(x, y - 1) |= (uint16_t)(N_S | (neg ? NEG_S : 0));
            *f(x + 1, y - 1) |= N_SW;
        }
    }
    void decode_sign(int x, int y, int32_t oneplushalf, bool raw) {
        uint32_t v;
        if (raw)
            v = mqc.raw();
        else {
            uint8_t sc = LUTS.sc[sc_index(*f(x, y))];
            v = mqc.decode(sc & 0x7f) ^ (sc >> 7);
        }
        set_sig(x, y, v, oneplushalf);
    }
    static const uint64_t ALL_NEIGHBOURS = 0x00ff00ff00ff00ffull, ALL_SIG = (uint64_t)F_SIG * 0x0001000100010001ull;
    void sigpass(int bpno, uint32_t orient, bool raw) {
        int32_t one = 1 << bpno, oneplushalf = one | (one >> 1);
        const uint8_t* zc = LUTS.zc[orient];
        for (int y0 = 0; y0 < h; y0 += 4) {
            int y1 = std::min(y0 + 4, h);
            for (int x = 0; x < w; x++) {
                if (!(column(x, y0) & ALL_NEIGHBOURS)) continue;
                for (int y = y0; y < y1; y++) {
                    uint32_t v = *f(x, y);
                    if ((v & (F_SIG | F_VISIT)) || !(v & NEIGHBOURS)) continue;
                    if (raw ? mqc.raw() : mqc.decode(zc[v & NEIGHBOURS])) decode_sign(x, y, oneplushalf, raw);
                    *f(x, y) |= F_VISIT;
                }
            }
        }
    }
    void refpass(int bpno, bool raw) {
        int32_t poshalf = (1 << bpno) >> 1;
        for (int y0 = 0; y0 < h; y0 += 4) {
            int y1 = std::min(y0 + 4, h);
            for (int x = 0; x < w; x++) {
                if (!(column(x, y0) & ALL_SIG)) continue;
                for (int y = y0; y < y1; y++) {
                    uint16_t* p = f(x, y);
                    if ((*p & (F_SIG | F_VISIT)) != F_SIG) continue;
                    uint32_t v;
                    if (raw)
                        v = mqc.raw();
                    else
                        v = mqc.decode((*p & F_REFINED) ? CTX_MAG + 2 : (*p & NEIGHBOURS) ? CTX_MAG + 1 : CTX_MAG);
                    int32_t& d = data[(size_t)y * w + x];
                    d += (v ^ (uint32_t)(d < 0)) ? poshalf : -poshalf;
                    *p |= F_REFINED;
                }
            }
        }
    }
    void clnpass(int bpno, uint32_t orient, bool segsym) {
        int32_t one = 1 << bpno, oneplushalf = one | (one >> 1);
        const uint8_t* zc = LUTS.zc[orient];
        const uint64_t rl_mask = (uint64_t)(NEIGHBOURS | F_SIG | F_VISIT) * 0x0001000100010001ull;
        for (int y0 = 0; y0 < h; y0 += 4) {
            int y1 = std::min(y0 + 4, h);
            for (int x = 0; x < w; x++) {
                int start = y0;
                if (y1 - y0 == 4 && !(column(x, y0) & rl_mask)) {
                    if (!mqc.decode(CTX_AGG)) continue;  // all four stay insignificant
                    int runlen = (int)(mqc.decode(CTX_UNI) << 1);
                    runlen |= (int)mqc.decode(CTX_UNI);
                    decode_sign(x, y0 + runlen, oneplushalf, false);
                    start = y0 + runlen + 1;
                }
                for (int y = start; y < y1; y++) {
                    uint32_t v = *f(x, y);
                    if (v & (F_SIG | F_VISIT)) continue;
                    if (mqc.decode(zc[v & NEIGHBOURS])) decode_sign(x, y, oneplushalf, false);
                }
                for (int y = y0; y < y1; y++) *f(x, y) &= (uint16_t)~F_VISIT;
            }
        }
        if (segsym) {
            for (int i = 0; i < 4; i++) mqc.decode(CTX_UNI);  // "Bad segmentation symbol" is a warning only
        }
    }
};

// opj_t1_decode_cblk and the copy of opj_t1_clbl_decode_processor; false
// where OpenJPEG gives up on the tile
bool t1_decode_cblk(T1& t1, const Cblk& cb, const Band& b, const Tccp& tccp, std::vector<uint8_t>& buf) {
    t1.w = cb.x1 - cb.x0;
    t1.h = cb.y1 - cb.y0;
    t1.cols = t1.w + 2;
    t1.vsc = tccp.cblksty & CBLKSTY_VSC;
    t1.flags.assign((size_t)t1.cols * 4 * ((t1.h + 3) / 4 + 2), 0);
    t1.data.assign((size_t)t1.w * t1.h, 0);
    int32_t bpno_plus_one = (int32_t)((uint32_t)tccp.roishift + cb.numbps);
    if (bpno_plus_one >= 31) return false;
    if (cb.chunks.empty()) return true;
    size_t total = 0;
    for (auto& ch : cb.chunks) total += ch.second;
    buf.resize(total + 2);
    size_t at = 0;
    for (auto& ch : cb.chunks) {
        if (ch.second) memcpy(buf.data() + at, ch.first, ch.second);
        at += ch.second;
    }
    t1.mqc.reset_states();
    uint32_t cblksty = tccp.cblksty;
    int passtype = 2;
    size_t index = 0;
    std::vector<uint8_t> seg_buf;
    for (uint32_t segno = 0; segno < cb.real_num_segs; segno++) {
        const Seg& seg = cb.segs[segno];
        bool raw = (bpno_plus_one <= (int32_t)cb.numbps - 4) && passtype < 2 && (cblksty & CBLKSTY_LAZY);
        // the segment's bytes followed by OpenJPEG's synthetic 0xFF 0xFF
        seg_buf.resize(seg.len + 2);
        if (seg.len) memcpy(seg_buf.data(), buf.data() + index, seg.len);
        seg_buf[seg.len] = 0xff;
        seg_buf[seg.len + 1] = 0xff;
        index += seg.len;
        if (raw)
            t1.mqc.raw_init(seg_buf.data());
        else
            t1.mqc.init(seg_buf.data(), seg.len);
        for (uint32_t passno = 0; passno < seg.real_num_passes && bpno_plus_one >= 1; passno++) {
            if (passtype == 0)
                t1.sigpass(bpno_plus_one, b.bandno, raw);
            else if (passtype == 1)
                t1.refpass(bpno_plus_one, raw);
            else
                t1.clnpass(bpno_plus_one, b.bandno, cblksty & CBLKSTY_SEGSYM);
            if ((cblksty & CBLKSTY_RESET) && !raw) t1.mqc.reset_states();
            if (++passtype == 3) {
                passtype = 0;
                bpno_plus_one--;
            }
        }
    }
    return true;
}

// Host threads kept for the life of the process (starting one costs up to
// a millisecond on some hosts, and a decode asks for threads dozens of
// times). One parallel run at a time: a decode that finds the pool busy
// (another request's) runs its work on its own thread.
class Pool {
  public:
    // task(i) for every i in [0, n), on `threads` threads, this one included
    void run(size_t n, int threads, const std::function<void(size_t)>& task) {
        size_t helpers = std::min<size_t>((size_t)std::max(threads, 1), n);
        helpers = helpers ? helpers - 1 : 0;
        std::unique_lock<std::mutex> busy(run_lock_, std::try_to_lock);
        if (!helpers || !busy.owns_lock()) {
            for (size_t i = 0; i < n; i++) task(i);
            return;
        }
        {
            std::lock_guard<std::mutex> g(m_);
            while (workers_ < helpers) {
                std::thread(&Pool::work, this, workers_++).detach();
            }
            task_ = &task;
            n_ = n;
            next_ = 0;
            wanted_ = helpers;
            active_ = helpers;
            ++generation_;
        }
        wake_.notify_all();
        for (size_t i; (i = next_.fetch_add(1)) < n;) task(i);
        std::unique_lock<std::mutex> g(m_);
        done_.wait(g, [&] { return active_ == 0; });
        task_ = nullptr;
    }

  private:
    void work(size_t id) {
        uint64_t seen = 0;
        std::unique_lock<std::mutex> g(m_);
        for (;;) {
            wake_.wait(g, [&] { return generation_ != seen; });
            seen = generation_;
            if (id >= wanted_) continue;
            const std::function<void(size_t)>* task = task_;
            size_t n = n_;
            g.unlock();
            for (size_t i; (i = next_.fetch_add(1)) < n;) (*task)(i);
            g.lock();
            if (--active_ == 0) done_.notify_all();
        }
    }
    std::mutex run_lock_, m_;
    std::condition_variable wake_, done_;
    const std::function<void(size_t)>* task_ = nullptr;
    size_t n_ = 0, wanted_ = 0, active_ = 0, workers_ = 0;
    uint64_t generation_ = 0;
    std::atomic<size_t> next_{0};
};

Pool& pool() {
    static Pool* p = new Pool();  // never destroyed: its threads outlive static destructors
    return *p;
}

// fn(begin, end) over [0, n) in `threads` slices
template <typename Fn>
void parallel_for(size_t n, int threads, Fn fn) {
    size_t parts = std::min<size_t>((size_t)std::max(threads, 1), n);
    if (parts <= 1) {
        if (n) fn((size_t)0, n);
        return;
    }
    pool().run(parts, (int)parts, [&](size_t p) { fn(n * p / parts, n * (p + 1) / parts); });
}

struct CblkJob {
    TileComp* tc;
    const Tccp* tccp;
    const Band* band;
    const Cblk* cblk;
    int32_t x, y;  // its place in the tile component's buffer
};

// one code-block: decoded, shifted back by the ROI, dequantised into the
// tile buffer (opj_t1_clbl_decode_processor)
bool t1_job(T1& t1, std::vector<uint8_t>& buf, const CblkJob& job) {
    const Tccp& tccp = *job.tccp;
    if (!t1_decode_cblk(t1, *job.cblk, *job.band, tccp, buf)) return false;
    if (tccp.roishift) {
        if (tccp.roishift >= 31) {
            std::fill(t1.data.begin(), t1.data.end(), 0);
        } else {
            int32_t thresh = 1 << tccp.roishift;
            for (int32_t& v : t1.data) {
                int32_t mag = v < 0 ? -v : v;
                if (mag >= thresh) {
                    mag >>= tccp.roishift;
                    v = v < 0 ? -mag : mag;
                }
            }
        }
    }
    size_t tile_w = (size_t)(job.tc->x1 - job.tc->x0);
    int32_t* tiledp = job.tc->data.data() + (size_t)job.y * tile_w + job.x;
    const int32_t* datap = t1.data.data();
    int cw = t1.w, ch = t1.h;
    if (tccp.qmfbid == 1) {
        for (int yy = 0; yy < ch; yy++)
            for (int xx = 0; xx < cw; xx++) tiledp[yy * tile_w + xx] = datap[yy * cw + xx] / 2;
    } else {
        const float stepsize = 0.5f * job.band->stepsize;
        for (int yy = 0; yy < ch; yy++)
            for (int xx = 0; xx < cw; xx++) {
                float tmp = (float)datap[yy * cw + xx] * stepsize;
                memcpy(&tiledp[yy * tile_w + xx], &tmp, 4);
            }
    }
    return true;
}

void t1_decode(Codec& j, uint32_t tileno, Tile& tile) {
    Tcp& tcp = j.tcps[tileno];
    std::vector<CblkJob> jobs;
    for (uint32_t compno = 0; compno < tile.comps.size(); compno++) {
        TileComp& tc = tile.comps[compno];
        const Tccp& tccp = tcp.tccps[compno];
        if (tccp.cblksty & CBLKSTY_HT) fail(UNPORTED, "HT (Part 15) code-blocks");
        tc.data.assign((size_t)(tc.x1 - tc.x0) * (size_t)(tc.y1 - tc.y0), 0);
        for (uint32_t resno = 0; resno < tc.numresolutions; resno++) {
            Res& r = tc.res[resno];
            for (uint32_t bandno = 0; bandno < r.numbands; bandno++) {
                Band& b = r.bands[bandno];
                for (Precinct& pr : b.precincts)
                    for (Cblk& cb : pr.cblks) {
                        int32_t x = cb.x0 - b.x0, y = cb.y0 - b.y0;
                        if (b.bandno & 1) x += tc.res[resno - 1].x1 - tc.res[resno - 1].x0;
                        if (b.bandno & 2) y += tc.res[resno - 1].y1 - tc.res[resno - 1].y0;
                        jobs.push_back(CblkJob{&tc, &tccp, &b, &cb, x, y});
                    }
            }
        }
    }
    // code-blocks are independent: several threads change no sample; they
    // take them one at a time (their costs differ by orders of magnitude)
    std::vector<char> ok(jobs.size(), 1);
    int threads = jobs.size() >= 16 ? j.threads : 1;
    std::vector<T1> t1s((size_t)threads);
    std::vector<std::vector<uint8_t>> bufs((size_t)threads);
    std::atomic<size_t> next{0};
    pool().run((size_t)threads, threads, [&](size_t w) {
        for (size_t i; (i = next.fetch_add(1)) < jobs.size();) ok[i] = t1_job(t1s[w], bufs[w], jobs[i]);
    });
    for (char v : ok)
        if (!v) fail(DECODE_ERROR, "opj_t1_decode_cblk(): unsupported bpno_plus_one >= 31");
}

// -- inverse wavelets (dwt.c) --------------------------------------------------

const float DWT_ALPHA = -1.586134342f, DWT_BETA = -0.052980118f, DWT_GAMMA = 0.882911075f,
            DWT_DELTA = 0.443506852f, DWT_K = 1.230174105f, DWT_TWO_INVK = 1.625732422f;

// The 1-D inverse transforms over n columns at once: rows[k] is the k-th
// sample of the interleaved signal (the low samples at 2i + cas, the high at
// 2i + 1 - cas), n columns wide; a row of the image is the case n = 1.
// 5/3: X(even) = Y - floor((Y[-1] + Y[+1] + 2) / 4), then X(odd) = Y +
// floor((X[-1] + X[+1]) / 2), with symmetric extension; a lone sample at an
// odd coordinate is halved (C division).
void idwt53_rows(std::vector<int32_t*>& rows, int32_t sn, int32_t dn, int cas, size_t n) {
    int32_t len = sn + dn;
    if (cas == 0 ? len <= 1 : len == 1) {
        if (len == 1 && cas == 1)
            for (size_t j = 0; j < n; j++) rows[0][j] /= 2;
        return;
    }
    auto at = [&](int32_t k) {
        while (k < 0 || k >= len) {
            if (k < 0) k = -k;
            if (k >= len) k = 2 * (len - 1) - k;
        }
        return rows[k];
    };
    for (int32_t k = cas; k < len; k += 2) {
        int32_t *x = rows[k], *l = at(k - 1), *r = at(k + 1);
        for (size_t j = 0; j < n; j++) x[j] = x[j] - ((l[j] + r[j] + 2) >> 2);
    }
    for (int32_t k = 1 - cas; k < len; k += 2) {
        int32_t *x = rows[k], *l = at(k - 1), *r = at(k + 1);
        for (size_t j = 0; j < n; j++) x[j] = x[j] + ((l[j] + r[j]) >> 1);
    }
}

// opj_v8dwt_decode_step2: w[k] += (w[k - 1] + w[k + 1]) * c over the samples of
// one parity, the first reaching back to its right neighbour where it has no
// left one, the last (when the other band ends first) taking twice its left
// neighbour
void lift_rows(std::vector<float*>& v, int32_t first, int32_t count, int32_t m, float c, size_t n) {
    int32_t imax = std::min(count, m);
    for (int32_t i = 0; i < imax; i++) {
        int32_t k = first + 2 * i;
        float *x = v[k], *l = k - 1 >= 0 ? v[k - 1] : v[k + 1], *r = v[k + 1];
        for (size_t j = 0; j < n; j++) x[j] = x[j] + (l[j] + r[j]) * c;
    }
    if (m < count) {
        int32_t k = first + 2 * m;
        float *x = v[k], *l = v[k - 1];
        float c2 = c + c;
        for (size_t j = 0; j < n; j++) x[j] = x[j] + c2 * l[j];
    }
}

void idwt97_rows(std::vector<float*>& v, int32_t sn, int32_t dn, int cas, size_t n) {
    int a, b;
    if (cas == 0) {
        if (!(dn > 0 || sn > 1)) return;
        a = 0;
        b = 1;
    } else {
        if (!(sn > 0 || dn > 1)) return;
        a = 1;
        b = 0;
    }
    for (int32_t i = 0; i < sn; i++)
        for (size_t j = 0; j < n; j++) v[a + 2 * i][j] = v[a + 2 * i][j] * DWT_K;
    for (int32_t i = 0; i < dn; i++)
        for (size_t j = 0; j < n; j++) v[b + 2 * i][j] = v[b + 2 * i][j] * DWT_TWO_INVK;
    lift_rows(v, a, sn, std::min(sn, dn - a), -DWT_DELTA, n);
    lift_rows(v, b, dn, std::min(dn, sn - b), -DWT_GAMMA, n);
    lift_rows(v, a, sn, std::min(sn, dn - a), -DWT_BETA, n);
    lift_rows(v, b, dn, std::min(dn, sn - b), -DWT_ALPHA, n);
}

void dwt_decode(TileComp& tc, uint32_t numres, bool reversible, int threads) {
    if (numres <= 1) return;
    size_t w = (size_t)(tc.x1 - tc.x0);
    if (w == 0) return;
    const Res* r = &tc.res[0];
    int32_t rw = r->x1 - r->x0, rh = r->y1 - r->y0;
    std::vector<int32_t> buf;
    int32_t* data = tc.data.data();
    while (--numres) {
        ++r;
        int32_t sn_h = rw, sn_v = rh;
        rw = r->x1 - r->x0;
        rh = r->y1 - r->y0;
        int32_t dn_h = rw - sn_h, dn_v = rh - sn_v;
        int cas_h = r->x0 % 2, cas_v = r->y0 % 2;
        if (rw == 0 || rh == 0) continue;  // an empty resolution: nothing to transform
        // the columns in interleaved order: rows of a copy
        buf.resize((size_t)rw * rh);
        std::vector<int32_t*> irows((size_t)rh);
        for (int32_t i = 0; i < rh; i++) {
            int32_t k = i < sn_v ? 2 * i + cas_v : 2 * (i - sn_v) + 1 - cas_v;
            irows[k] = buf.data() + (size_t)k * rw;
        }
        int par = (size_t)rw * rh >= 65536 ? threads : 1;
        parallel_for((size_t)rh, par, [&](size_t y0, size_t y1) {  // rows: the horizontal pass
            std::vector<int32_t> tmp((size_t)rw);
            std::vector<int32_t*> ints((size_t)rw);
            std::vector<float*> floats((size_t)rw);
            for (int32_t k = 0; k < rw; k++) {
                ints[k] = &tmp[k];
                floats[k] = reinterpret_cast<float*>(&tmp[k]);
            }
            for (size_t y = y0; y < y1; y++) {
                int32_t* row = data + y * w;
                for (int32_t i = 0; i < sn_h; i++) tmp[2 * i + cas_h] = row[i];
                for (int32_t i = 0; i < dn_h; i++) tmp[2 * i + 1 - cas_h] = row[sn_h + i];
                if (reversible)
                    idwt53_rows(ints, sn_h, dn_h, cas_h, 1);
                else
                    idwt97_rows(floats, sn_h, dn_h, cas_h, 1);
                memcpy(row, tmp.data(), (size_t)rw * 4);
            }
        });
        for (int32_t i = 0; i < rh; i++) {
            int32_t k = i < sn_v ? 2 * i + cas_v : 2 * (i - sn_v) + 1 - cas_v;
            memcpy(irows[k], data + (size_t)i * w, (size_t)rw * 4);
        }
        parallel_for((size_t)rw, par, [&](size_t x0, size_t x1) {  // column slices: the vertical pass
            if (reversible) {
                std::vector<int32_t*> rows((size_t)rh);
                for (int32_t k = 0; k < rh; k++) rows[k] = irows[k] + x0;
                idwt53_rows(rows, sn_v, dn_v, cas_v, x1 - x0);
            } else {
                std::vector<float*> rows((size_t)rh);
                for (int32_t k = 0; k < rh; k++) rows[k] = reinterpret_cast<float*>(irows[k]) + x0;
                idwt97_rows(rows, sn_v, dn_v, cas_v, x1 - x0);
            }
        });
        for (int32_t k = 0; k < rh; k++) memcpy(data + (size_t)k * w, irows[k], (size_t)rw * 4);
    }
}

// -- tile decode (tcd.c) -------------------------------------------------------

void decode_tile_data(Codec& j, uint32_t tileno) {
    Tcp& tcp = j.tcps[tileno];
    Tile tile;
    init_tile(j, tileno, tile);
    t2_decode(j, tileno, tile);
    t1_decode(j, tileno, tile);
    for (uint32_t compno = 0; compno < tile.comps.size(); compno++)
        dwt_decode(tile.comps[compno], j.comps[compno].resno_decoded + 1, tcp.tccps[compno].qmfbid == 1, j.threads);
    // opj_tcd_mct_decode
    if (tcp.mct) {
        size_t samples = tile.comps[0].data.size();
        if (tile.comps.size() >= 3) {
            if (tile.comps[0].numresolutions != tile.comps[1].numresolutions ||
                tile.comps[0].numresolutions != tile.comps[2].numresolutions ||
                j.comps[0].resno_decoded != j.comps[1].resno_decoded ||
                j.comps[0].resno_decoded != j.comps[2].resno_decoded)
                fail(DECODE_ERROR, "Tiles don't all have the same dimension. Skip the MCT step.");
            int32_t *c0 = tile.comps[0].data.data(), *c1 = tile.comps[1].data.data(), *c2 = tile.comps[2].data.data();
            bool reversible = tcp.tccps[0].qmfbid == 1;
            parallel_for(samples, samples >= 65536 ? j.threads : 1, [&](size_t begin, size_t end) {
                if (reversible) {
                    for (size_t i = begin; i < end; i++) {
                        int32_t y = c0[i], u = c1[i], v = c2[i];
                        int32_t g = y - ((u + v) >> 2);
                        c0[i] = v + g;
                        c1[i] = g;
                        c2[i] = u + g;
                    }
                } else {
                    float *f0 = reinterpret_cast<float*>(c0), *f1 = reinterpret_cast<float*>(c1),
                          *f2 = reinterpret_cast<float*>(c2);
                    for (size_t i = begin; i < end; i++) {
                        float y = f0[i], u = f1[i], v = f2[i];
                        float r = y + (v * 1.402f);
                        float g = y - (u * 0.34413f) - (v * 0.71414f);
                        float b = y + (u * 1.772f);
                        f0[i] = r;
                        f1[i] = g;
                        f2[i] = b;
                    }
                }
            });
        }
    }
    // opj_tcd_dc_level_shift_decode, then opj_j2k_update_image_data
    for (uint32_t compno = 0; compno < tile.comps.size(); compno++) {
        TileComp& tc = tile.comps[compno];
        Comp& ic = j.comps[compno];
        const Tccp& tccp = tcp.tccps[compno];
        int32_t lo, hi;
        if (ic.sgnd) {
            lo = -(1 << (ic.prec - 1));
            hi = (1 << (ic.prec - 1)) - 1;
        } else {
            lo = 0;
            hi = (int32_t)((1u << ic.prec) - 1);
        }
        // only the resolution decoded so far (all of them, unless no packet
        // of the higher ones was read): its samples at the top left of the
        // tile's buffer, written at its own coordinates
        const Res& r = tc.res[std::min(ic.resno_decoded, tc.numresolutions - 1)];
        size_t tw = (size_t)(tc.x1 - tc.x0);
        int32_t rw = r.x1 - r.x0, rh = r.y1 - r.y0;
        int32_t* d = tc.data.data();
        parallel_for((size_t)rh, (size_t)rw * rh >= 65536 ? j.threads : 1, [&](size_t y0, size_t y1) {
            for (size_t y = y0; y < y1; y++) {
                int32_t* row = d + y * tw;
                if (tccp.qmfbid == 1) {
                    for (int32_t x = 0; x < rw; x++) {
                        int32_t v = (int32_t)((uint32_t)row[x] + (uint32_t)tccp.dc_level_shift);
                        row[x] = std::max(lo, std::min(hi, v));
                    }
                } else {
                    for (int32_t x = 0; x < rw; x++) {
                        float v;
                        memcpy(&v, &row[x], 4);
                        if (v > (float)INT32_MAX)
                            row[x] = hi;
                        else if (v < (float)INT32_MIN)
                            row[x] = lo;
                        else {
                            int64_t vi = (int64_t)lrintf(v) + tccp.dc_level_shift;
                            row[x] = (int32_t)std::max<int64_t>(lo, std::min<int64_t>(hi, vi));
                        }
                    }
                }
            }
        });
        if (ic.data.empty()) ic.data.assign((size_t)ic.w * ic.h, 0);
        int32_t x0 = std::max(r.x0, 0), y0 = std::max(r.y0, 0);
        int32_t x1 = std::min(r.x1, (int32_t)ic.w), y1 = std::min(r.y1, (int32_t)ic.h);
        for (int32_t y = y0; y < y1; y++)
            if (x1 > x0)
                memcpy(&ic.data[(size_t)y * ic.w + x0], &d[(size_t)(y - r.y0) * tw + (x0 - r.x0)],
                       (size_t)(x1 - x0) * 4);
    }
}

// -- tile-parts (j2k.c) ---------------------------------------------------------

// opj_j2k_read_sod
void read_sod(Codec& j) {
    Tcp& t = j.tcps[j.current_tile];
    if (j.last_tile_part)
        j.sot_length = (uint32_t)(j.s.left() - 2);
    else
        j.sot_length = j.sot_length >= 2 ? j.sot_length - 2 : 0;
    bool no_data = j.sot_length == 0;
    if (!no_data) {
        if ((int64_t)j.sot_length > j.s.left())
            fail(DECODE_ERROR, "Tile part length size inconsistent with stream length");
        if (j.sot_length > 0xffffffffu - 2) fail(DECODE_ERROR, "m_sot_length > UINT_MAX - OPJ_COMMON_CBLK_DATA_EXTRA");
        if (t.has_data && t.data.size() > 0xffffffffu - 2 - j.sot_length) fail(DECODE_ERROR, "tile data too large");
        t.has_data = true;
    }
    int64_t got = 0;
    if (!no_data) {
        size_t at = t.data.size();
        t.data.resize(at + j.sot_length);
        got = std::min<int64_t>(j.sot_length, j.s.left());
        memcpy(t.data.data() + at, j.s.d + j.s.pos, (size_t)got);
        j.s.pos += got;
        t.data.resize(at + (size_t)got);
    }
    j.state = got != (int64_t)j.sot_length ? ST_NEOC : ST_TPHSOT;
}

// opj_j2k_need_nb_tile_parts_correction: does a later tile-part of this tile
// say TPsot == TNsot? Read ahead, then back to where the data was.
bool need_nb_tile_parts_correction(Codec& j, uint32_t tile_no) {
    int64_t backup = j.s.pos;
    bool needed = false;
    for (;;) {
        uint32_t m;
        if (!read2(j, &m) || m != MS_SOT) break;  // "assume all is OK"
        uint32_t size;
        if (!read2(j, &size)) fail(DECODE_ERROR, "Stream too short");
        if (size != 10) fail(DECODE_ERROR, "Inconsistent marker size");
        uint8_t b[8];
        if (!j.s.read(b, 8)) fail(DECODE_ERROR, "Stream too short");
        uint32_t tile, tot_len, part, num_parts;
        get_sot_values(b, 8, &tile, &tot_len, &part, &num_parts);
        if (tile == tile_no) {
            needed = part == num_parts;
            break;
        }
        if (tot_len < 14) break;  // the last tile-part, or a bad Psot: assume all is OK
        if (!j.s.skip(tot_len - 12)) break;
    }
    j.s.pos = backup;
    return needed;
}

// opj_j2k_read_tile_header; false when there is no tile left to decode
bool read_tile_header(Codec& j) {
    uint32_t m = MS_SOT;
    uint32_t nb_tiles = j.tw * j.th;
    if (j.state == ST_EOC)
        m = MS_EOC;
    else if (j.state != ST_TPHSOT)
        fail(DECODE_ERROR, "a tile-part header out of place");
    while (!j.can_decode && m != MS_EOC) {
        while (m != MS_SOD) {
            if (j.s.left() == 0) {
                j.state = ST_NEOC;
                break;
            }
            uint32_t size;
            if (!read2(j, &size)) fail(DECODE_ERROR, "Stream too short");
            if (size < 2) fail(DECODE_ERROR, "Inconsistent marker size");
            if (m == 0x8080 && j.s.left() == 0) {
                j.state = ST_NEOC;
                break;
            }
            if ((j.state & ST_TPH) && j.sot_length != 0) {
                if (j.sot_length < size + 2) fail(DECODE_ERROR, "Sot length is less than marker size + marker ID");
                j.sot_length -= size + 2;
            }
            size -= 2;
            const MarkerHandler& h = get_handler(m);
            if (!(j.state & h.states)) fail(DECODE_ERROR, "Marker is not compliant with its position");
            j.header.resize(std::max<size_t>(size, 1));
            if (!j.s.read(j.header.data(), size)) fail(DECODE_ERROR, "Stream too short");
            if (!h.handler) fail(DECODE_ERROR, "Not sure how that happened.");
            try {
                h.handler(j, j.header.data(), size);
            } catch (Error& e) {
                if (e.status == HEADER_ERROR) e.status = DECODE_ERROR;
                throw;
            }
            if (!read2(j, &m)) fail(DECODE_ERROR, "Stream too short");
        }
        if (j.s.left() == 0 && j.state == ST_NEOC) break;
        read_sod(j);
        // the TPsot == TNsot correction, checked once, where the tile that can
        // be decoded came in several tile-parts (found on cv2: not after a
        // tile of one tile-part)
        if (j.can_decode && !j.nb_tile_parts_correction_checked &&
            j.tcps[j.current_tile].nb_tile_parts > 1) {
            j.nb_tile_parts_correction_checked = true;
            if (need_nb_tile_parts_correction(j, j.current_tile)) {
                j.can_decode = false;
                j.nb_tile_parts_correction = 1;
                for (Tcp& t : j.tcps)
                    if (t.nb_tile_parts != 0) t.nb_tile_parts += 1;
            }
        }
        if (!j.can_decode) {
            if (!read2(j, &m)) {
                if (j.current_tile + 1 == nb_tiles) {
                    uint32_t t;
                    for (t = 0; t < nb_tiles; t++)
                        if (j.tcps[t].current_tile_part == 0 && j.tcps[t].nb_tile_parts == 0) break;
                    if (t < nb_tiles) {
                        j.current_tile = t;
                        m = MS_EOC;
                        j.state = ST_EOC;
                        break;
                    }
                }
                fail(DECODE_ERROR, "Stream too short");
            }
        }
    }
    if (m == MS_EOC && j.state != ST_EOC) {
        j.current_tile = 0;
        j.state = ST_EOC;
    }
    if (!j.can_decode) {
        while (j.current_tile < nb_tiles && !j.tcps[j.current_tile].has_data) ++j.current_tile;
        if (j.current_tile == nb_tiles) return false;
    }
    merge_ppt(j.tcps[j.current_tile]);
    j.state |= ST_DATA;
    return true;
}

// opj_j2k_decode_tile
void decode_tile(Codec& j, uint32_t tileno) {
    if (!(j.state & ST_DATA) || tileno != j.current_tile) fail(DECODE_ERROR, "no tile data to decode");
    Tcp& t = j.tcps[tileno];
    if (!t.has_data) fail(DECODE_ERROR, "no tile data to decode");
    decode_tile_data(j, tileno);
    j.can_decode = false;
    j.state &= ~ST_DATA;
    if (j.s.left() == 0 && j.state == ST_NEOC) return;
    if (j.state != ST_EOC) {
        uint32_t m;
        if (!read2(j, &m)) fail(DECODE_ERROR, "Stream too short");
        if (m == MS_EOC) {
            j.current_tile = 0;
            j.state = ST_EOC;
        } else if (m != MS_SOT) {
            if (j.s.left() == 0) {
                j.state = ST_NEOC;  // "Stream does not end with EOC": a warning
                return;
            }
            fail(DECODE_ERROR, "Stream too short");
        }
    }
}

// opj_j2k_decode_tiles
void decode_tiles(Codec& j) {
    uint32_t nb_tiles = j.tw * j.th;
    if (j.tw == 1 && j.th == 1 && j.tx0 == 0 && j.ty0 == 0 && j.x0 == 0 && j.y0 == 0 && j.x1 == j.tdx &&
        j.y1 == j.tdy) {
        if (!read_tile_header(j)) fail(DECODE_ERROR, "Failed to decode tile 1/1");
        decode_tile(j, j.current_tile);
        return;
    }
    uint32_t nr_tiles = 0;
    for (;;) {
        if (j.tw == 1 && j.th == 1 && j.tcps[0].has_data) {
            j.current_tile = 0;
            j.state |= ST_DATA;
        } else if (!read_tile_header(j))
            break;
        uint32_t tileno = j.current_tile;
        decode_tile(j, tileno);
        j.tcps[tileno].has_data = false;
        j.tcps[tileno].data.clear();
        j.tcps[tileno].data.shrink_to_fit();
        if (j.s.left() == 0 && j.state == ST_NEOC) break;
        if (++nr_tiles == nb_tiles) break;
    }
    for (const Comp& c : j.comps)
        if (c.data.empty()) fail(DECODE_ERROR, "Failed to decode all used components");
}

void run(Codec& j, bool decode) {
    read_header(j);
    if (!decode) return;
    decode_tiles(j);
}

int finish(const Error& e, char* msg, int msg_len) {
    if (msg && msg_len > 0) {
        strncpy(msg, e.msg.c_str(), (size_t)msg_len - 1);
        msg[msg_len - 1] = 0;
    }
    return e.status;
}

}  // namespace

extern "C" {

// The main header of a codestream (from its SOC to the end of the data):
// info = [x0, y0, x1, y1, numcomps, then prec, sgnd, dx, dy of the first
// four components]. ``ihdr_w`` / ``ihdr_h``: a JP2 file's ihdr size (0 for a
// bare codestream), which the SIZ marker must match. Returns a Status;
// ``msg`` gets OpenJPEG's reason.
int j2k_header(const uint8_t* data, int64_t n, uint32_t ihdr_w, uint32_t ihdr_h, int32_t* info, char* msg,
               int msg_len) {
    Codec j;
    j.s.d = data;
    j.s.n = n;
    j.ihdr_w = ihdr_w;
    j.ihdr_h = ihdr_h;
    try {
        run(j, false);
    } catch (Error& e) {
        return finish(e, msg, msg_len);
    }
    info[0] = (int32_t)j.x0;
    info[1] = (int32_t)j.y0;
    info[2] = (int32_t)j.x1;
    info[3] = (int32_t)j.y1;
    info[4] = (int32_t)j.numcomps();
    for (uint32_t i = 0; i < 4 && i < j.numcomps(); i++) {
        info[5 + 4 * i] = (int32_t)j.comps[i].prec;
        info[6 + 4 * i] = (int32_t)j.comps[i].sgnd;
        info[7 + 4 * i] = (int32_t)j.comps[i].dx;
        info[8 + 4 * i] = (int32_t)j.comps[i].dy;
    }
    return OK;
}

// Decode the whole image into ``out``: numcomps planes of (y1 - y0) x
// (x1 - x0) int32 samples. Only for images with origin 0 and no sub-sampled
// component (what cv2 hands over); BAD_CALL otherwise. ``info`` gets the
// components' precision and sign again (a CBD marker may change them).
int j2k_decode(const uint8_t* data, int64_t n, uint32_t ihdr_w, uint32_t ihdr_h, int32_t* out, int64_t out_len,
               int32_t* info, int threads, char* msg, int msg_len) {
    Codec j;
    j.threads = threads > 0 ? threads : (int)std::max(1u, std::min(8u, std::thread::hardware_concurrency()));
    j.s.d = data;
    j.s.n = n;
    j.ihdr_w = ihdr_w;
    j.ihdr_h = ihdr_h;
    try {
        read_header(j);
        if (j.x0 != 0 || j.y0 != 0 || j.numcomps() > 4) return BAD_CALL;
        for (const Comp& c : j.comps)
            if (c.dx != 1 || c.dy != 1) return BAD_CALL;
        int64_t plane = (int64_t)j.x1 * j.y1;
        if (plane * j.numcomps() != out_len) return BAD_CALL;
        decode_tiles(j);
        for (uint32_t i = 0; i < j.numcomps(); i++) {
            memcpy(out + i * plane, j.comps[i].data.data(), (size_t)plane * 4);
            info[2 * i] = (int32_t)j.comps[i].prec;
            info[2 * i + 1] = (int32_t)j.comps[i].sgnd;
        }
    } catch (Error& e) {
        return finish(e, msg, msg_len);
    } catch (std::bad_alloc&) {
        return finish(Error{DECODE_ERROR, "Not enough memory"}, msg, msg_len);
    }
    return OK;
}

}  // extern "C"
