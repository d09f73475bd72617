// JPEG decoder for the port's image readers, bit-exact with libjpeg-turbo's
// default decode as PIL drives it (``Image.open(p).convert("RGB")``).
//
// Takes baseline and extended-sequential files (SOF0, SOF1), progressive
// files (SOF2), Huffman- or arithmetic-coded (SOF9, SOF10), and lossless
// Huffman files (SOF3), 8-bit, with 1 (gray), 3
// (YCbCr or RGB) or 4 (Adobe CMYK or YCCK) components, any sampling factors
// with integral ratios, restart intervals, and any image size. What PIL
// refuses is refused with the SOF marker named: hierarchical files (SOF5-7,
// SOF13-15), arithmetic-coded lossless ones (SOF11), and other precisions
// (PIL's JPEG plugin takes 8-bit frames only).
//
// The arithmetic is libjpeg-turbo's, step for step:
//   - Huffman decoding with ``0xFF00`` stuffing; bytes before a marker are
//     skipped as ``next_marker`` skips them; a sequential file's missing
//     tables default to the standard ones (``std_huff_tables``); bits past
//     the end of a data segment read as zeros, and once one is used the rest
//     of the segment's MCUs stay undecoded (``insufficient_data``);
//   - corrupt data as libjpeg takes it where PIL keeps the image: a code
//     longer than 16 bits reads as 0 (``jpeg_huff_decode``), a restart
//     marker out of order is resynchronised (``jpeg_resync_to_restart``),
//     marker segments shorter than their length field are skipped
//     (``skip_variable``), and a single-scan image is complete after its
//     scan, whatever follows it;
//   - progressive scans as ``jdphuff.c`` decodes them: DC first and
//     refinement, AC first with EOB runs, AC refinement with correction bits;
//   - arithmetic decoding as ``jdarith.c`` does it (the QM decoder of T.81
//     Annex D with the state table of ``jaricom.c``, DC and AC conditioning
//     from DAC, statistics reset at each restart, sequential and the four
//     progressive MCU kinds); a marker inside the data feeds zeros, and a
//     spectral or magnitude overflow leaves the rest of the scan (to its
//     next restart) undecoded;
//   - lossless files as ``jdlhuff.c``, ``jddiffct.c`` and ``jdlossls.c``
//     decode them: Huffman-coded differences (T.81 Annex H), the seven
//     predictors with the first-row, first-column and restart rules, modulo
//     2^16, and the point transform shifted back;
//   - block smoothing of progressive files whose scans leave coefficients
//     unrefined (``jdcoefct.c``'s ``smoothing_ok`` and libjpeg-turbo 2.1+'s
//     ``decompress_smooth_data``: the 5x5 DC neighbourhood, the first nine
//     AC coefficients estimated where unknown, the DC itself where no AC
//     coefficient is known);
//   - the ISLOW inverse DCT (``jidctint.c``: CONST_BITS 13, PASS1_BITS 2)
//     and its range-limit table with the ``& RANGE_MASK`` wrap;
//   - upsampling as ``jdsample.c`` picks it with fancy upsampling on:
//     h2v1 and h2v2 triangle filters (components more than 2 samples wide),
//     turbo's h1v2 filter, replication otherwise (and always for a lossless
//     file, whose 1x1 "blocks" turn fancy upsampling off); the row above the
//     first and below the last repeat them (``jdmainct.c``'s context rows);
//   - the colour space as ``default_decompress_parms`` guesses it (a JFIF
//     marker, an Adobe marker's transform, or the component ids; a lossless
//     frame with neither marker is RGB);
//   - YCbCr->RGB and YCCK->CMYK through ``jdcolor.c``'s 16-bit fixed-point
//     tables; CMYK is then inverted (PIL's ``CMYK;I``) and taken to RGB by
//     PIL's ``cmyk2rgb``; gray is repeated three times.
// ``jpeg_check`` finds the refused SOF markers from the frame header alone.
//
// C interface (ctypes, vavae_tpu_torch/utils/jpeg.py):
//   jpeg_header(data, len, dims[2], err, errlen)        -> 0 or -1
//   jpeg_decode_rgb(data, len, out, out_len, err, errlen) -> 0 or -1
//   jpeg_check(data, len, err, errlen)                  -> 0, -1 or 1

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Refusal : std::runtime_error {
  using std::runtime_error::runtime_error;
};

// the data ended before the parser did
struct Truncated : Refusal {
  Truncated() : Refusal("truncated JPEG file") {}
};

[[noreturn]] void refuse(const std::string& msg) { throw Refusal(msg); }

std::string hex2(int v) {
  char buf[8];
  std::snprintf(buf, sizeof buf, "0x%02X", v & 0xFF);
  return buf;
}

// zigzag position -> natural position, with libjpeg's 16 extra entries that
// absorb a run past the end of a block in corrupt data
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// the standard tables of the JPEG standard's section K.3 (jstdhuff.c)
const uint8_t kStdDcLumBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kStdDcChromBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kStdDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kStdAcLumBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kStdAcLumVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
    0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1,
    0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18,
    0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
    0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57,
    0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92,
    0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7,
    0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8,
    0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kStdAcChromBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kStdAcChromVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07,
    0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09,
    0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25,
    0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56,
    0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
    0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
    0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6,
    0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

constexpr int kLookBits = 9;

struct HuffTable {
  bool defined = false;
  uint8_t bits[17] = {};
  uint8_t vals[256] = {};
  int32_t maxcode[18] = {};
  int32_t valoffset[18] = {};
  uint16_t look[1 << kLookBits] = {};  // (length << 8) | symbol; 0: longer code

  void set(const uint8_t* b, const uint8_t* v) {
    std::memcpy(bits, b, 17);
    int n = 0;
    for (int l = 1; l <= 16; ++l) n += bits[l];
    std::memset(vals, 0, sizeof vals);
    std::memcpy(vals, v, n);
    defined = true;
  }

  // jpeg_make_d_derived_tbl, with its checks (a lossless DC table may hold 16)
  void derive(bool is_dc, int max_dc) {
    int huffsize[257], huffcode[257];
    int p = 0;
    for (int l = 1; l <= 16; ++l) {
      int i = bits[l];
      if (p + i > 256) refuse("bad Huffman table");
      while (i--) huffsize[p++] = l;
    }
    huffsize[p] = 0;
    const int numsymbols = p;
    int code = 0, si = huffsize[0];
    p = 0;
    while (huffsize[p]) {
      while (huffsize[p] == si) huffcode[p++] = code++;
      if (code >= (1 << si)) refuse("bad Huffman table");
      code <<= 1;
      ++si;
    }
    p = 0;
    for (int l = 1; l <= 16; ++l) {
      if (bits[l]) {
        valoffset[l] = p - huffcode[p];
        p += bits[l];
        maxcode[l] = huffcode[p - 1];
      } else {
        maxcode[l] = -1;
      }
    }
    maxcode[17] = 0x7FFFFFFF;
    std::memset(look, 0, sizeof look);
    p = 0;
    for (int l = 1; l <= kLookBits; ++l) {
      for (int i = 1; i <= bits[l]; ++i, ++p) {
        const int lookbits = huffcode[p] << (kLookBits - l);
        for (int ctr = 1 << (kLookBits - l); ctr > 0; --ctr)
          look[lookbits + ctr - 1] = static_cast<uint16_t>((l << 8) | vals[p]);
      }
    }
    if (is_dc)
      for (int i = 0; i < numsymbols; ++i)
        if (vals[i] > max_dc) refuse("bad Huffman table");
  }
};

// Entropy-coded data: bits MSB first, 0xFF00 as 0xFF. At a marker (or the
// end of the file) it stops and supplies zero bits; ``short_data`` is set
// once one of those zeros is consumed.
struct BitReader {
  const uint8_t* d = nullptr;
  size_t n = 0, pos = 0;
  uint64_t acc = 0;
  int cnt = 0;   // bits in acc
  int real = 0;  // of which read from the file
  int marker = 0;
  bool eof = false;
  bool short_data = false;

  void start(const uint8_t* data, size_t len, size_t at) {
    d = data; n = len; pos = at;
    acc = 0; cnt = 0; real = 0; marker = 0; eof = false; short_data = false;
  }

  void fill() {
    while (cnt <= 56) {
      uint32_t c = 0;
      bool got = false;
      if (marker == 0 && !eof) {
        if (pos >= n) {
          eof = true;
        } else {
          c = d[pos++];
          got = true;
          if (c == 0xFF) {
            // jdhuff.c's fill_bit_buffer: FF FF ... 00 is one FF data byte
            do {
              if (pos >= n) { eof = true; break; }
              c = d[pos++];
            } while (c == 0xFF);
            if (eof) { c = 0; got = false; }
            else if (c == 0) c = 0xFF;
            else { marker = static_cast<int>(c); c = 0; got = false; }
          }
        }
      }
      acc |= static_cast<uint64_t>(c) << (56 - cnt);
      cnt += 8;
      if (got) real += 8;
    }
  }

  inline void consume(int k) {
    acc <<= k;
    cnt -= k;
    real -= k;
    if (real < 0) { real = 0; short_data = true; }
  }

  inline int get(int k) {  // k in 1..16
    if (cnt < k) fill();
    const int v = static_cast<int>(acc >> (64 - k));
    consume(k);
    return v;
  }

  inline int decode(const HuffTable& t) {
    if (cnt < 17) fill();
    const int lk = t.look[acc >> (64 - kLookBits)];
    if (lk) {
      consume(lk >> 8);
      return lk & 0xFF;
    }
    int l = kLookBits + 1;
    int32_t code = static_cast<int32_t>(acc >> (64 - l));
    while (code > t.maxcode[l]) {
      ++l;
      if (l > 16) {  // jpeg_huff_decode: a bad code reads as 0 after 17 bits
        consume(17);
        return 0;
      }
      code = static_cast<int32_t>(acc >> (64 - l));
    }
    consume(l);
    return t.vals[(code + t.valoffset[l]) & 0xFF];
  }
};

inline int extend(int r, int s) {  // HUFF_EXTEND
  return r < (1 << (s - 1)) ? r + static_cast<int>((~0u) << s) + 1 : r;
}

// T.81 Table D.2 as jaricom.c packs it: Qe << 16 | Next_Index_MPS << 8 |
// Switch_MPS << 7 | Next_Index_LPS; entry 113 is the fixed 0.5 estimate
#define V(qe, lps, mps, sw) ((int64_t{qe} << 16) | ((mps) << 8) | ((sw) << 7) | (lps))
const int64_t kAriTab[114] = {
    V(0x5a1d,   1,   1, 1), V(0x2586,  14,   2, 0), V(0x1114,  16,   3, 0), V(0x080b,  18,   4, 0),
    V(0x03d8,  20,   5, 0), V(0x01da,  23,   6, 0), V(0x00e5,  25,   7, 0), V(0x006f,  28,   8, 0),
    V(0x0036,  30,   9, 0), V(0x001a,  33,  10, 0), V(0x000d,  35,  11, 0), V(0x0006,   9,  12, 0),
    V(0x0003,  10,  13, 0), V(0x0001,  12,  13, 0), V(0x5a7f,  15,  15, 1), V(0x3f25,  36,  16, 0),
    V(0x2cf2,  38,  17, 0), V(0x207c,  39,  18, 0), V(0x17b9,  40,  19, 0), V(0x1182,  42,  20, 0),
    V(0x0cef,  43,  21, 0), V(0x09a1,  45,  22, 0), V(0x072f,  46,  23, 0), V(0x055c,  48,  24, 0),
    V(0x0406,  49,  25, 0), V(0x0303,  51,  26, 0), V(0x0240,  52,  27, 0), V(0x01b1,  54,  28, 0),
    V(0x0144,  56,  29, 0), V(0x00f5,  57,  30, 0), V(0x00b7,  59,  31, 0), V(0x008a,  60,  32, 0),
    V(0x0068,  62,  33, 0), V(0x004e,  63,  34, 0), V(0x003b,  32,  35, 0), V(0x002c,  33,   9, 0),
    V(0x5ae1,  37,  37, 1), V(0x484c,  64,  38, 0), V(0x3a0d,  65,  39, 0), V(0x2ef1,  67,  40, 0),
    V(0x261f,  68,  41, 0), V(0x1f33,  69,  42, 0), V(0x19a8,  70,  43, 0), V(0x1518,  72,  44, 0),
    V(0x1177,  73,  45, 0), V(0x0e74,  74,  46, 0), V(0x0bfb,  75,  47, 0), V(0x09f8,  77,  48, 0),
    V(0x0861,  78,  49, 0), V(0x0706,  79,  50, 0), V(0x05cd,  48,  51, 0), V(0x04de,  50,  52, 0),
    V(0x040f,  50,  53, 0), V(0x0363,  51,  54, 0), V(0x02d4,  52,  55, 0), V(0x025c,  53,  56, 0),
    V(0x01f8,  54,  57, 0), V(0x01a4,  55,  58, 0), V(0x0160,  56,  59, 0), V(0x0125,  57,  60, 0),
    V(0x00f6,  58,  61, 0), V(0x00cb,  59,  62, 0), V(0x00ab,  61,  63, 0), V(0x008f,  61,  32, 0),
    V(0x5b12,  65,  65, 1), V(0x4d04,  80,  66, 0), V(0x412c,  81,  67, 0), V(0x37d8,  82,  68, 0),
    V(0x2fe8,  83,  69, 0), V(0x293c,  84,  70, 0), V(0x2379,  86,  71, 0), V(0x1edf,  87,  72, 0),
    V(0x1aa9,  87,  73, 0), V(0x174e,  72,  74, 0), V(0x1424,  72,  75, 0), V(0x119c,  74,  76, 0),
    V(0x0f6b,  74,  77, 0), V(0x0d51,  75,  78, 0), V(0x0bb6,  77,  79, 0), V(0x0a40,  77,  48, 0),
    V(0x5832,  80,  81, 1), V(0x4d1c,  88,  82, 0), V(0x438e,  89,  83, 0), V(0x3bdd,  90,  84, 0),
    V(0x34ee,  91,  85, 0), V(0x2eae,  92,  86, 0), V(0x299a,  93,  87, 0), V(0x2516,  86,  71, 0),
    V(0x5570,  88,  89, 1), V(0x4ca9,  95,  90, 0), V(0x44d9,  96,  91, 0), V(0x3e22,  97,  92, 0),
    V(0x3824,  99,  93, 0), V(0x32b4,  99,  94, 0), V(0x2e17,  93,  86, 0), V(0x56a8,  95,  96, 1),
    V(0x4f46, 101,  97, 0), V(0x47e5, 102,  98, 0), V(0x41cf, 103,  99, 0), V(0x3c3d, 104, 100, 0),
    V(0x375e,  99,  93, 0), V(0x5231, 105, 102, 0), V(0x4c0f, 106, 103, 0), V(0x4639, 107, 104, 0),
    V(0x415e, 103,  99, 0), V(0x5627, 105, 106, 1), V(0x50e7, 108, 107, 0), V(0x4b85, 109, 103, 0),
    V(0x5597, 110, 109, 0), V(0x504f, 111, 107, 0), V(0x5a10, 110, 111, 1), V(0x5522, 112, 109, 0),
    V(0x59eb, 112, 111, 1),
    V(0x5a1d, 113, 113, 0)};
#undef V

// The QM decoder of jdarith.c (arith_decode): C and A registers, bytes read
// on renormalisation; at a marker it stores the marker and feeds zeros.
struct ArithReader {
  const uint8_t* d = nullptr;
  size_t n = 0, pos = 0;
  int64_t c = 0, a = 0;
  int ct = -16;  // -16: two bytes to read first; -1: an overflow stopped the scan
  int marker = 0;

  void start(const uint8_t* data, size_t len, size_t at) {
    d = data; n = len; pos = at;
    marker = 0;
    reset();
  }

  void reset() { c = 0; a = 0; ct = -16; }

  int get_byte() {
    if (pos >= n) throw Truncated();  // libjpeg's arithmetic decoder cannot suspend
    return d[pos++];
  }

  int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        int data = 0;
        if (!marker) {
          data = get_byte();
          if (data == 0xFF) {
            do data = get_byte(); while (data == 0xFF);
            if (data == 0) {
              data = 0xFF;
            } else {
              marker = data;
              data = 0;
            }
          }
        }
        c = (c << 8) | data;
        if ((ct += 8) < 0)
          if (++ct == 0) a = 0x8000;  // two initial bytes read
      }
      a <<= 1;
    }
    int sv = *st;
    int64_t qe = kAriTab[sv & 0x7F];
    const int nl = static_cast<int>(qe & 0xFF);
    qe >>= 8;
    const int nm = static_cast<int>(qe & 0xFF);
    qe >>= 8;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dw = 0, dh = 0;        // downsampled_width/height
  int bw = 0, bh = 0;        // width_in_blocks, height_in_blocks
  int stride_blocks = 0;     // blocks per row of the coefficient buffer
  int rows_blocks = 0;
  std::vector<int16_t> coef;  // rows_blocks x stride_blocks x 64
  bool latched = false;
  uint16_t quant[64] = {};   // natural order
  int coef_bits[64];         // progressive: Al of the last scan, -1 before any
  int prev_bits[10];         // coef_bits[0..9] before the last scan of the component
  int pt = 0;                // lossless: the point transform of its scan
  std::vector<uint8_t> plane;  // dh x dw samples after the IDCT
};

class Decoder {
 public:
  Decoder(const uint8_t* data, size_t len) : d_(data), n_(len) {}

  // Reads markers up to the frame header; height and width.
  void header(int64_t* dims) {
    parse(kHeader);
    dims[0] = height_;
    dims[1] = width_;
  }

  // Refuses what decode would refuse on the markers before the data: an SOF
  // marker or a precision it does not decode, or a lossless frame in a
  // colour space other than RGB, gray or CMYK (libjpeg converts no colour
  // in a lossless file). A DCT file is judged at its SOF marker.
  void check() { parse(kCheck); }

  void decode(uint8_t* out) {
    try {
      parse(kDecode);
    } catch (const Truncated&) {
      // libjpeg reads what follows a single-scan image only to finish, and
      // PIL keeps the image when that runs out of data
      if (!image_done_) throw;
    }
    finish(out);
  }

 private:
  const uint8_t* d_;
  size_t n_;
  size_t pos_ = 0;

  uint16_t qt_[4][64] = {};
  bool qt_defined_[4] = {};
  HuffTable dc_[4], ac_[4];
  int restart_interval_ = 0;
  bool jfif_ = false, adobe_ = false;
  int adobe_transform_ = 0;
  bool frame_ = false, progressive_ = false, arith_ = false, lossless_ = false;
  bool scanned_ = false;
  bool image_done_ = false;  // libjpeg's single-scan mode, after its scan
  int width_ = 0, height_ = 0, max_h_ = 1, max_v_ = 1, mcux_ = 0, mcuy_ = 0;
  std::vector<Component> comps_;
  BitReader br_;
  ArithReader ar_;
  // DAC conditioning (jdmarker.c's defaults at SOI)
  uint8_t dc_l_[16], dc_u_[16], ac_k_[16];
  // arithmetic statistics areas, by table
  uint8_t dc_stats_[16][64] = {}, ac_stats_[16][256] = {};
  uint8_t fixed_bin_ = 113;
  // smoothing: scans read (input_scan_number), and the last iMCU row of the
  // last scan decoded before its data ran out (last_good_iMCU_row)
  int scans_ = 0, last_good_row_ = -1;
  // scan state
  int scan_comp_[4] = {};
  int ns_ = 0, ss_ = 0, se_ = 63, ah_ = 0, al_ = 0;
  int last_dc_[4] = {};
  int dc_context_[4] = {};
  int eobrun_ = 0;

  int byte() {
    if (pos_ >= n_) throw Truncated();
    return d_[pos_++];
  }

  int u16() {
    const int hi = byte();
    return (hi << 8) | byte();
  }

  // jdmarker.c's next_marker: skip non-FF bytes, fill FFs and FF00 pairs
  int next_marker() {
    for (;;) {
      int c = byte();
      while (c != 0xFF) c = byte();
      do c = byte(); while (c == 0xFF);
      if (c != 0) return c;
    }
  }

  enum Stop { kHeader, kCheck, kDecode };  // parse to the SOF, to what check needs, or to the end

  void parse(Stop stop) {
    if (n_ < 2 || d_[0] != 0xFF || d_[1] != 0xD8) refuse("not a JPEG file (no SOI marker)");
    pos_ = 2;
    for (int i = 0; i < 16; ++i) {
      dc_l_[i] = 0;
      dc_u_[i] = 1;
      ac_k_[i] = 5;
    }
    int marker = next_marker();
    for (;;) {
      switch (marker) {
        case 0xC0: case 0xC1: case 0xC2: case 0xC3: case 0xC9: case 0xCA:
          read_sof(marker);
          if (stop == kHeader || (stop == kCheck && !lossless_)) return;
          break;
        case 0xC5: case 0xC6: case 0xC7: case 0xC8: case 0xCB: case 0xCD: case 0xCE: case 0xCF: {
          static const char* kinds[] = {
              "differential (hierarchical) sequential", "differential (hierarchical) progressive",
              "differential (hierarchical) lossless", "reserved JPG", "", "",
              "arithmetic-coded lossless",
              "", "arithmetic-coded differential sequential",
              "arithmetic-coded differential progressive",
              "arithmetic-coded differential lossless"};
          refuse(std::string("unsupported JPEG: SOF marker ") + hex2(marker) + " (" +
                 kinds[marker - 0xC5] + "), which PIL does not decode either");
        }
        case 0xC4: read_dht(); break;
        case 0xDB: read_dqt(); break;
        case 0xDD: {
          const int len = u16();
          if (len != 4) refuse("bad DRI segment length");
          restart_interval_ = u16();
          break;
        }
        case 0xDA: {
          if (!frame_) refuse("SOS before any SOF marker");
          if (!scanned_ && lossless_ && ycc_frame())
            refuse("unsupported JPEG: a lossless " + std::string(comps_.size() == 3 ? "YCbCr" : "YCCK") +
                   " frame, which libjpeg-turbo does not convert to RGB for PIL either");
          if (stop == kCheck) return;
          // libjpeg finishes a single-scan image by reading its markers to
          // the EOI, and a scan there is an error (JERR_EOI_EXPECTED)
          if (image_done_) refuse("a second scan in a single-scan JPEG file");
          marker = read_sos_and_scan();
          continue;
        }
        case 0xD9:
          if (stop != kDecode) refuse("EOI before any SOF marker");
          if (!scanned_) refuse("no image data before the EOI marker");
          return;
        case 0xD8: refuse("duplicate SOI marker");
        case 0xCC: read_dac(); break;
        case 0xDC: skip_segment(); break;  // DNL
        case 0xD0: case 0xD1: case 0xD2: case 0xD3: case 0xD4: case 0xD5: case 0xD6:
        case 0xD7: case 0x01:
          break;  // stray RSTn, TEM: parameterless, ignored
        default:
          if (marker >= 0xE0 && marker <= 0xEF) read_app(marker);
          else if (marker == 0xFE) skip_segment();
          else refuse("unknown JPEG marker " + hex2(marker));
      }
      marker = next_marker();
    }
  }

  // jdmarker.c's skip_variable: a length under 2 skips nothing
  void skip_segment() {
    const int len = std::max(u16() - 2, 0);
    if (pos_ + len > n_) throw Truncated();
    pos_ += len;
  }

  // jdmarker.c's get_dac
  void read_dac() {
    int len = u16() - 2;
    while (len > 0) {
      const int index = byte();
      const int val = byte();
      len -= 2;
      if (index >= 32) refuse("bad DAC table index " + std::to_string(index));
      if (index >= 16) {
        ac_k_[index - 16] = static_cast<uint8_t>(val);
      } else {
        dc_l_[index] = static_cast<uint8_t>(val & 15);
        dc_u_[index] = static_cast<uint8_t>(val >> 4);
        if (dc_l_[index] > dc_u_[index]) refuse("bad DAC value " + std::to_string(val));
      }
    }
    if (len != 0) refuse("bad DAC segment length");
  }

  void read_app(int marker) {
    const size_t datalen = std::max(u16() - 2, 0);  // as skip_segment
    if (pos_ + datalen > n_) throw Truncated();
    const uint8_t* p = d_ + pos_;
    // libjpeg picks the colour space at the first scan; APP0 and APP14
    // segments after it change nothing
    if (scanned_) {
      pos_ += datalen;
      return;
    }
    if (marker == 0xE0 && datalen >= 14 && std::memcmp(p, "JFIF\0", 5) == 0) jfif_ = true;
    if (marker == 0xEE && datalen >= 12 && std::memcmp(p, "Adobe", 5) == 0) {
      adobe_ = true;
      adobe_transform_ = p[11];
    }
    pos_ += datalen;
  }

  void read_dqt() {
    int len = u16() - 2;
    while (len > 0) {
      const int pq_tq = byte();
      const int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3) refuse("bad DQT table index");
      for (int i = 0; i < 64; ++i) qt_[tq][kNatural[i]] = static_cast<uint16_t>(pq ? u16() : byte());
      qt_defined_[tq] = true;
      len -= 65 + (pq ? 64 : 0);
    }
    if (len != 0) refuse("bad DQT segment length");
  }

  void read_dht() {
    int len = u16() - 2;
    while (len > 16) {
      int index = byte();
      uint8_t bits[17] = {0};
      int count = 0;
      for (int i = 1; i <= 16; ++i) {
        bits[i] = static_cast<uint8_t>(byte());
        count += bits[i];
      }
      len -= 17;
      if (count > 256 || count > len) refuse("bad Huffman table");
      uint8_t vals[256] = {0};
      for (int i = 0; i < count; ++i) vals[i] = static_cast<uint8_t>(byte());
      len -= count;
      HuffTable* tbl;
      if (index & 0x10) {
        index -= 0x10;
        if (index < 0 || index > 3) refuse("bad DHT table index");
        tbl = &ac_[index];
      } else {
        if (index < 0 || index > 3) refuse("bad DHT table index");
        tbl = &dc_[index];
      }
      tbl->set(bits, vals);
    }
    if (len != 0) refuse("bad DHT segment length");
  }

  void read_sof(int marker) {
    if (frame_) refuse("duplicate SOF marker");
    const int len = u16();
    const int precision = byte();
    height_ = u16();
    width_ = u16();
    const int nf = byte();
    if (len != 8 + 3 * nf) refuse("bad SOF segment length");
    lossless_ = marker == 0xC3;
    // PIL's JPEG plugin takes 8-bit frames only, lossless ones too
    if (precision != 8)
      refuse("unsupported JPEG: SOF marker " + hex2(marker) + " with " +
             std::to_string(precision) + "-bit samples, which PIL does not decode either");
    if (height_ == 0) refuse("JPEG height 0 (a DNL marker) is not supported");
    if (width_ == 0 || nf == 0) refuse("empty JPEG image");
    if (nf != 1 && nf != 3 && nf != 4)
      refuse("unsupported JPEG: " + std::to_string(nf) + " components");
    progressive_ = marker == 0xC2 || marker == 0xCA;
    arith_ = marker == 0xC9 || marker == 0xCA;
    comps_.resize(nf);
    for (auto& c : comps_) {
      c.id = byte();
      const int hv = byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = byte();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) refuse("bad JPEG sampling factors");
      if (c.tq > 3 && !lossless_) refuse("bad quantization table index");
      max_h_ = std::max(max_h_, c.h);
      max_v_ = std::max(max_v_, c.v);
    }
    const int unit = lossless_ ? 1 : 8;  // a lossless "block" is one sample
    mcux_ = (width_ + unit * max_h_ - 1) / (unit * max_h_);
    mcuy_ = (height_ + unit * max_v_ - 1) / (unit * max_v_);
    for (auto& c : comps_) {
      c.dw = static_cast<int>((static_cast<int64_t>(width_) * c.h + max_h_ - 1) / max_h_);
      c.dh = static_cast<int>((static_cast<int64_t>(height_) * c.v + max_v_ - 1) / max_v_);
      c.bw = (c.dw + unit - 1) / unit;
      c.bh = (c.dh + unit - 1) / unit;
      for (int k = 0; k < 64; ++k) c.coef_bits[k] = -1;
      for (int k = 0; k < 10; ++k) c.prev_bits[k] = -1;
      if (max_h_ % c.h || max_v_ % c.v)
        refuse("unsupported JPEG: sampling factors whose ratios are not integers");
    }
    frame_ = true;
  }

  void alloc_coefficients() {
    for (auto& c : comps_) {
      c.stride_blocks = mcux_ * c.h;
      c.rows_blocks = mcuy_ * c.v;
      // a lossless file keeps one sample a "block": its differences, then
      // its samples (jddiffct.c's diff_buf and undiff_buf)
      c.coef.assign(static_cast<size_t>(c.stride_blocks) * c.rows_blocks * (lossless_ ? 1 : 64), 0);
    }
  }

  int16_t* block(Component& c, int by, int bx) {
    return &c.coef[(static_cast<size_t>(by) * c.stride_blocks + bx) * 64];
  }

  int read_sos_and_scan() {
    const int len = u16();
    ns_ = byte();
    if (ns_ < 1 || ns_ > 4 || len != 6 + 2 * ns_) refuse("bad SOS segment");
    int td[4], ta[4];
    for (int i = 0; i < ns_; ++i) {
      const int cs = byte();
      const int t = byte();
      int ci = -1;
      for (size_t k = 0; k < comps_.size(); ++k)
        if (comps_[k].id == cs) ci = static_cast<int>(k);
      if (ci < 0) refuse("SOS names a component the frame lacks");
      for (int j = 0; j < i; ++j)
        if (scan_comp_[j] == ci) refuse("SOS names a component twice");
      scan_comp_[i] = ci;
      td[i] = t >> 4;  // checked below where the scan uses the table, as libjpeg does
      ta[i] = t & 15;
    }
    ss_ = byte();
    se_ = byte();
    const int a = byte();
    ah_ = a >> 4;
    al_ = a & 15;

    const bool first = !scanned_;
    if (!scanned_) alloc_coefficients();
    if (!scanned_ && !progressive_ && !arith_ && !lossless_) {
      // jinit_huff_decoder's std_huff_tables: the sequential decoder's
      // defaults for slots 0 and 1 undefined at the first scan (the
      // progressive and lossless decoders have none)
      if (!dc_[0].defined) dc_[0].set(kStdDcLumBits, kStdDcVals);
      if (!dc_[1].defined) dc_[1].set(kStdDcChromBits, kStdDcVals);
      if (!ac_[0].defined) ac_[0].set(kStdAcLumBits, kStdAcLumVals);
      if (!ac_[1].defined) ac_[1].set(kStdAcChromBits, kStdAcChromVals);
    }
    scanned_ = true;
    ++scans_;

    int blocks_in_mcu = 0;
    for (int i = 0; i < ns_; ++i) {
      Component& c = comps_[scan_comp_[i]];
      blocks_in_mcu += ns_ == 1 ? 1 : c.h * c.v;
      if (!c.latched) {  // latch_quant_tables: the table as of the first scan
        if (!lossless_) {
          if (!qt_defined_[c.tq]) refuse("quantization table missing");
          std::memcpy(c.quant, qt_[c.tq], sizeof c.quant);
        }
        c.latched = true;
      }
    }
    if (blocks_in_mcu > 10) refuse("bad JPEG sampling factors (over 10 blocks an MCU)");

    if (lossless_) {
      // jdlossls.c's start_pass: Ss is the predictor, Pt = Al
      if (ss_ < 1 || ss_ > 7 || se_ != 0 || ah_ != 0 || al_ >= 8)
        refuse("bad lossless scan parameters Ss=" + std::to_string(ss_) + " Se=" +
               std::to_string(se_) + " Ah=" + std::to_string(ah_) + " Al=" + std::to_string(al_));
      HuffTable* dct[4];
      for (int i = 0; i < ns_; ++i) {
        if (td[i] > 3 || !dc_[td[i]].defined) refuse("Huffman table missing");
        dc_[td[i]].derive(true, 16);
        dct[i] = &dc_[td[i]];
      }
      return lossless_scan(dct, first);
    }

    const bool dc_band = ss_ == 0;
    if (progressive_) {
      bool bad = false;
      if (dc_band) {
        if (se_ != 0) bad = true;
      } else {
        if (ss_ > se_ || se_ > 63 || ns_ != 1) bad = true;
      }
      if (ah_ != 0 && al_ != ah_ - 1) bad = true;
      if (al_ > 13) bad = true;
      if (bad)
        refuse("bad progressive scan parameters Ss=" + std::to_string(ss_) +
               " Se=" + std::to_string(se_) + " Ah=" + std::to_string(ah_) +
               " Al=" + std::to_string(al_));
      for (int i = 0; i < ns_; ++i) {
        Component& c = comps_[scan_comp_[i]];
        for (int k = std::min(ss_, 1); k <= std::max(se_, 9); ++k)
          if (k < 10) c.prev_bits[k] = scans_ > 1 ? c.coef_bits[k] : 0;
        for (int k = ss_; k <= se_; ++k) c.coef_bits[k] = al_;
      }
    }
    const bool need_dc = !progressive_ || (dc_band && ah_ == 0);
    const bool need_ac = !progressive_ || !dc_band;
    // the tables this scan uses, derived (and checked) now; arithmetic
    // statistics areas cleared (jdarith.c's start_pass)
    HuffTable* dct[4] = {nullptr, nullptr, nullptr, nullptr};
    HuffTable* act[4] = {nullptr, nullptr, nullptr, nullptr};
    for (int i = 0; i < ns_; ++i) {
      if (arith_) {
        if (need_dc) {
          if (td[i] > 15) refuse("arithmetic table missing");
          std::memset(dc_stats_[td[i]], 0, sizeof dc_stats_[0]);
        }
        if (need_ac) {
          if (ta[i] > 15) refuse("arithmetic table missing");
          std::memset(ac_stats_[ta[i]], 0, sizeof ac_stats_[0]);
        }
        continue;
      }
      if (need_dc) {
        if (td[i] > 3 || !dc_[td[i]].defined) refuse("Huffman table missing");
        dc_[td[i]].derive(true, 15);
        dct[i] = &dc_[td[i]];
      }
      if (need_ac) {
        if (ta[i] > 3 || !ac_[ta[i]].defined) refuse("Huffman table missing");
        ac_[ta[i]].derive(false, 15);
        act[i] = &ac_[ta[i]];
      }
    }

    br_.start(d_, n_, pos_);
    ar_.start(d_, n_, pos_);
    for (int i = 0; i < 4; ++i) last_dc_[i] = dc_context_[i] = 0;
    eobrun_ = 0;
    int restarts_to_go = restart_interval_;
    int next_rst = 0;

    // jdhuff.c's and jdarith.c's process_restart
    auto restart = [&]() {
      restart_reader(next_rst);
      if (arith_)
        for (int i = 0; i < ns_; ++i) {
          if (need_dc) std::memset(dc_stats_[td[i]], 0, sizeof dc_stats_[0]);
          if (need_ac) std::memset(ac_stats_[ta[i]], 0, sizeof ac_stats_[0]);
        }
      for (int i = 0; i < 4; ++i) last_dc_[i] = dc_context_[i] = 0;
      eobrun_ = 0;
      restarts_to_go = restart_interval_;
    };
    // an MCU left undecoded: Huffman data past its end, or an arithmetic
    // overflow earlier in the segment (a DC refinement scan decodes on)
    auto skipped = [&]() {
      return arith_ ? ar_.ct == -1 && !(progressive_ && dc_band && ah_ != 0) : br_.short_data;
    };
    auto decode = [&](int16_t* blk, int i) {
      if (arith_) decode_block_arith(blk, i, td[i], ta[i]);
      else decode_block(blk, i, dct[i], act[i]);
    };

    if (ns_ == 1) {
      Component& c = comps_[scan_comp_[0]];
      for (int by = 0; by < c.bh; ++by) {
        for (int bx = 0; bx < c.bw; ++bx) {
          if (restart_interval_) {
            if (restarts_to_go == 0) restart();
            --restarts_to_go;
          }
          // jdcoefct.c: the iMCU row of the last MCU begun with data left
          if (!br_.short_data) last_good_row_ = by / c.v;
          if (skipped()) continue;
          decode(block(c, by, bx), 0);
        }
      }
    } else {
      for (int my = 0; my < mcuy_; ++my) {
        for (int mx = 0; mx < mcux_; ++mx) {
          if (restart_interval_) {
            if (restarts_to_go == 0) restart();
            --restarts_to_go;
          }
          if (!br_.short_data) last_good_row_ = my;
          if (skipped()) continue;
          for (int i = 0; i < ns_; ++i) {
            Component& c = comps_[scan_comp_[i]];
            for (int yy = 0; yy < c.v; ++yy)
              for (int xx = 0; xx < c.h; ++xx) decode(block(c, my * c.v + yy, mx * c.h + xx), i);
          }
        }
      }
    }
    return end_of_scan(first);
  }

  // jdmarker.c's read_restart_marker at a restart where RST``next_rst`` is
  // due, then the entropy reader started on the next segment
  void restart_reader(int& next_rst) {
    int m = arith_ ? ar_.marker : br_.marker;
    if (m == 0) {
      if (!arith_ && br_.eof) throw Truncated();
      m = (pos_ = arith_ ? ar_.pos : br_.pos, next_marker());
    } else {
      pos_ = arith_ ? ar_.pos : br_.pos;  // just past the marker
    }
    const bool pending = m != 0xD0 + next_rst && !resync(m, next_rst);
    next_rst = (next_rst + 1) & 7;
    if (arith_) {
      ar_.start(d_, n_, pos_);
      if (pending) ar_.marker = m;  // an empty segment, read as zeros
      return;
    }
    const bool was_short = br_.short_data;
    br_.start(d_, n_, pos_);
    if (pending) {  // an empty segment, read as zeros; out of data stays set
      br_.marker = m;
      br_.short_data = was_short;
    }
  }

  // The marker after a scan's data. A sequential first scan of every
  // component is libjpeg's single-scan mode: the image is complete after it,
  // whatever follows.
  int end_of_scan(bool first) {
    image_done_ = first && !progressive_ && ns_ == static_cast<int>(comps_.size());
    if (arith_ ? ar_.marker : br_.marker) {
      pos_ = arith_ ? ar_.pos : br_.pos;
      return arith_ ? ar_.marker : br_.marker;
    }
    if (!arith_ && br_.eof) {
      // PIL takes a sequential file that ends after its scan without the
      // EOI marker (libjpeg has every bit it reads); anything shorter, or
      // a progressive file, is truncated
      if (progressive_ || br_.short_data) refuse("truncated JPEG file");
      return 0xD9;
    }
    pos_ = arith_ ? ar_.pos : br_.pos;
    return next_marker();
  }

  // A lossless scan (jdlhuff.c's decode_mcus into jddiffct.c's difference
  // rows), then each row undifferenced (jdlossls.c): the first row of the
  // image, and of each restart interval, predicted from its left neighbour
  // (its first sample from 1 << (P - Pt - 1)), the first column from above,
  // the rest by the scan's predictor, modulo 2^16.
  int lossless_scan(HuffTable* const* dct, bool first_scan) {
    const bool single = ns_ == 1;
    const Component& c0 = comps_[scan_comp_[0]];
    const int mcus_per_row = single ? c0.dw : mcux_;
    const int mcu_rows = single ? c0.dh : mcuy_;
    // rows of MCUs an iMCU row holds: predictors reset at an iMCU row's first row
    const int rows_per_imcu = single ? c0.v : 1;
    if (restart_interval_ % mcus_per_row)
      refuse("unsupported JPEG: a lossless restart interval that is not a whole number of "
             "MCU rows");
    std::vector<std::vector<uint8_t>> first_row(ns_);  // rows predicted as a first row
    std::vector<int32_t> diff[4];
    for (int i = 0; i < ns_; ++i) {
      const Component& c = comps_[scan_comp_[i]];
      first_row[i].assign(c.rows_blocks, 0);
      first_row[i][0] = 1;
      diff[i].assign(static_cast<size_t>(c.rows_blocks) * c.stride_blocks, 0);
    }
    auto mark_first = [&](int my) {  // jdlossls.c's start_pass, from MCU row my on
      for (int i = 0; i < ns_; ++i) {
        const Component& c = comps_[scan_comp_[i]];
        first_row[i][single ? my / rows_per_imcu * rows_per_imcu : my * c.v] = 1;
      }
    };
    br_.start(d_, n_, pos_);
    int rows_to_go = restart_interval_ / mcus_per_row;
    int next_rst = 0;
    for (int my = 0; my < mcu_rows; ++my) {
      if (restart_interval_ && rows_to_go == 0) {
        restart_reader(next_rst);
        mark_first(my);
        rows_to_go = restart_interval_ / mcus_per_row;
      }
      if (restart_interval_) --rows_to_go;
      if (br_.short_data) {  // out of data: zeros from a reset predictor
        mark_first(my);
        continue;
      }
      for (int mx = 0; mx < mcus_per_row; ++mx)
        for (int i = 0; i < ns_; ++i) {
          const Component& c = comps_[scan_comp_[i]];
          const int h = single ? 1 : c.h, v = single ? 1 : c.v;
          for (int yy = 0; yy < v; ++yy)
            for (int xx = 0; xx < h; ++xx) {
              int s = br_.decode(*dct[i]);
              if (s == 16) s = 32768;
              else if (s) s = extend(br_.get(s), s);
              diff[i][static_cast<size_t>(my * v + yy) * c.stride_blocks + mx * h + xx] = s;
            }
        }
    }
    for (int i = 0; i < ns_; ++i) {
      Component& c = comps_[scan_comp_[i]];
      const int w = c.dw, stride = c.stride_blocks;
      auto* out = reinterpret_cast<uint16_t*>(c.coef.data());
      for (int y = 0; y < c.dh; ++y) {
        const int32_t* dr = &diff[i][static_cast<size_t>(y) * stride];
        uint16_t* cur = out + static_cast<size_t>(y) * stride;
        if (first_row[i][y]) {
          int ra = (dr[0] + (1 << (7 - al_))) & 0xFFFF;
          cur[0] = static_cast<uint16_t>(ra);
          for (int x = 1; x < w; ++x) cur[x] = static_cast<uint16_t>(ra = (dr[x] + ra) & 0xFFFF);
          continue;
        }
        const uint16_t* prev = cur - stride;
        int ra = (dr[0] + prev[0]) & 0xFFFF;
        cur[0] = static_cast<uint16_t>(ra);
        for (int x = 1; x < w; ++x) {
          const int rb = prev[x], rc = prev[x - 1];
          int p;
          switch (ss_) {
            case 1: p = ra; break;
            case 2: p = rb; break;
            case 3: p = rc; break;
            case 4: p = ra + rb - rc; break;
            case 5: p = ra + ((rb - rc) >> 1); break;
            case 6: p = rb + ((ra - rc) >> 1); break;
            default: p = (ra + rb) >> 1; break;
          }
          cur[x] = static_cast<uint16_t>(ra = (dr[x] + p) & 0xFFFF);
        }
      }
      c.pt = al_;
    }
    return end_of_scan(first_scan);
  }

  // jdmarker.c's jpeg_resync_to_restart, for marker m where RST``desired``
  // was due (m read, pos_ just past it): true to go on after m (discarded),
  // false to leave m unread for the segment (m is updated as markers are
  // skipped).
  bool resync(int& m, int desired) {
    const auto rst = [&](int k) { return 0xD0 + ((desired + k) & 7); };
    for (;;) {
      if (m < 0xC0) {
        m = next_marker();  // not a marker at all: scan on
      } else if (m < 0xD0 || m > 0xD7 || m == rst(1) || m == rst(2)) {
        return false;  // another marker, or one of the next two restarts
      } else if (m == rst(-1) || m == rst(-2)) {
        m = next_marker();  // an earlier restart: scan on
      } else {
        return true;  // the desired one, or too far away
      }
    }
  }

  void decode_block(int16_t* blk, int i, const HuffTable* dct, const HuffTable* act) {
    const int ci = scan_comp_[i];
    if (!progressive_) {
      int s = br_.decode(*dct);
      if (s) s = extend(br_.get(s), s);
      s += last_dc_[ci];
      last_dc_[ci] = s;
      blk[0] = static_cast<int16_t>(s);
      for (int k = 1; k < 64; ++k) {
        int rs = br_.decode(*act);
        const int r = rs >> 4;
        s = rs & 15;
        if (s) {
          k += r;
          blk[kNatural[k]] = static_cast<int16_t>(extend(br_.get(s), s));
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
      return;
    }
    if (ss_ == 0) {
      if (ah_ == 0) {  // DC first
        int s = br_.decode(*dct);
        if (s) s = extend(br_.get(s), s);
        s += last_dc_[ci];
        last_dc_[ci] = s;
        blk[0] = static_cast<int16_t>(static_cast<int>(static_cast<unsigned>(s) << al_));
      } else if (br_.get(1)) {  // DC refinement
        blk[0] = static_cast<int16_t>(blk[0] | (1 << al_));
      }
      return;
    }
    if (ah_ == 0) {  // AC first
      if (eobrun_ > 0) {
        --eobrun_;
        return;
      }
      for (int k = ss_; k <= se_; ++k) {
        int s = br_.decode(*act);
        int r = s >> 4;
        s &= 15;
        if (s) {
          k += r;
          const int v = extend(br_.get(s), s);
          blk[kNatural[k]] = static_cast<int16_t>(static_cast<int>(static_cast<unsigned>(v) << al_));
        } else if (r == 15) {
          k += 15;
        } else {
          eobrun_ = 1 << r;
          if (r) eobrun_ += br_.get(r);
          --eobrun_;
          break;
        }
      }
      return;
    }
    // AC refinement
    const int p1 = 1 << al_;
    const int m1 = static_cast<int>(~0u << al_);
    int k = ss_;
    if (eobrun_ == 0) {
      for (; k <= se_; ++k) {
        int s = br_.decode(*act);
        int r = s >> 4;
        s &= 15;
        if (s) {  // a newly nonzero coefficient (size 1; libjpeg only warns otherwise)
          s = br_.get(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun_ = 1 << r;
          if (r) eobrun_ += br_.get(r);
          break;
        }
        do {
          int16_t* coef = blk + kNatural[k];
          if (*coef != 0) {
            if (br_.get(1)) {
              if ((*coef & p1) == 0) *coef = static_cast<int16_t>(*coef >= 0 ? *coef + p1 : *coef + m1);
            }
          } else {
            if (--r < 0) break;
          }
          ++k;
        } while (k <= se_);
        if (s) blk[kNatural[k]] = static_cast<int16_t>(s);
      }
    }
    if (eobrun_ > 0) {
      for (; k <= se_; ++k) {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0) {
          if (br_.get(1)) {
            if ((*coef & p1) == 0) *coef = static_cast<int16_t>(*coef >= 0 ? *coef + p1 : *coef + m1);
          }
        }
      }
      --eobrun_;
    }
  }

  // jdarith.c's decode_mcu (sequential) and decode_mcu_DC_first,
  // _DC_refine, _AC_first and _AC_refine, for one block
  void decode_block_arith(int16_t* blk, int i, int td, int ta) {
    const int ci = scan_comp_[i];
    if (progressive_ && ss_ == 0 && ah_ != 0) {  // DC refinement: a bit at the fixed estimate
      if (ar_.decode(&fixed_bin_)) blk[0] = static_cast<int16_t>(blk[0] | (1 << al_));
      return;
    }
    if (ar_.ct == -1) return;  // an overflow ended the MCU, and the segment
    if (!progressive_ || ss_ == 0) {  // DC (Figures F.19-F.24)
      uint8_t* st = dc_stats_[td] + dc_context_[ci];
      if (ar_.decode(st) == 0) {
        dc_context_[ci] = 0;
      } else {
        const int sign = ar_.decode(st + 1);
        st += 2 + sign;
        int m = ar_.decode(st);
        if (m != 0) {
          st = dc_stats_[td] + 20;
          while (ar_.decode(st)) {
            if ((m <<= 1) == 0x8000) {  // magnitude overflow
              ar_.ct = -1;
              return;
            }
            st += 1;
          }
        }
        if (m < ((1 << dc_l_[td]) >> 1)) dc_context_[ci] = 0;
        else if (m > ((1 << dc_u_[td]) >> 1)) dc_context_[ci] = 12 + sign * 4;
        else dc_context_[ci] = 4 + sign * 4;
        int v = m;
        st += 14;
        while (m >>= 1)
          if (ar_.decode(st)) v |= m;
        v += 1;
        if (sign) v = -v;
        last_dc_[ci] = (last_dc_[ci] + v) & 0xFFFF;
      }
      blk[0] = static_cast<int16_t>(progressive_ ? static_cast<int>(static_cast<unsigned>(last_dc_[ci]) << al_)
                                                 : last_dc_[ci]);
      if (progressive_) return;
    }
    const int start = progressive_ ? ss_ : 1, end = progressive_ ? se_ : 63;
    const int shift = progressive_ ? al_ : 0;
    if (progressive_ && ah_ != 0) {  // AC refinement
      const int p1 = 1 << al_, m1 = static_cast<int>(~0u << al_);
      int kex = se_;  // the previous stage's end of block
      for (; kex > 0; --kex)
        if (blk[kNatural[kex]]) break;
      for (int k = ss_; k <= se_; ++k) {
        uint8_t* st = ac_stats_[ta] + 3 * (k - 1);
        if (k > kex && ar_.decode(st)) break;  // EOB
        for (;;) {
          int16_t* coef = blk + kNatural[k];
          if (*coef) {
            if (ar_.decode(st + 2)) *coef = static_cast<int16_t>(*coef + (*coef < 0 ? m1 : p1));
            break;
          }
          if (ar_.decode(st + 1)) {
            *coef = static_cast<int16_t>(ar_.decode(&fixed_bin_) ? m1 : p1);
            break;
          }
          st += 3;
          if (++k > se_) {  // spectral overflow
            ar_.ct = -1;
            return;
          }
        }
      }
      return;
    }
    for (int k = start; k <= end; ++k) {  // AC (Figure F.20)
      uint8_t* st = ac_stats_[ta] + 3 * (k - 1);
      if (ar_.decode(st)) break;  // EOB
      while (ar_.decode(st + 1) == 0) {
        st += 3;
        if (++k > end) {  // spectral overflow
          ar_.ct = -1;
          return;
        }
      }
      const int sign = ar_.decode(&fixed_bin_);
      st += 2;
      int m = ar_.decode(st);
      if (m != 0 && ar_.decode(st)) {
        m <<= 1;
        st = ac_stats_[ta] + (k <= ac_k_[ta] ? 189 : 217);
        while (ar_.decode(st)) {
          if ((m <<= 1) == 0x8000) {  // magnitude overflow
            ar_.ct = -1;
            return;
          }
          st += 1;
        }
      }
      int v = m;
      st += 14;
      while (m >>= 1)
        if (ar_.decode(st)) v |= m;
      v += 1;
      if (sign) v = -v;
      blk[kNatural[k]] = static_cast<int16_t>(static_cast<int>(static_cast<unsigned>(v) << shift));
    }
  }

  // jdcoefct.c's smoothing_ok, after the last scan: whether libjpeg smooths
  // the blocks of this progressive file
  bool smoothing_ok() const {
    if (!progressive_) return false;
    bool useful = false;
    for (const auto& c : comps_) {
      if (!c.latched) return false;
      const uint16_t* q = c.quant;
      if (q[0] == 0 || q[1] == 0 || q[8] == 0 || q[16] == 0 || q[9] == 0 || q[2] == 0 ||
          q[3] == 0 || q[10] == 0 || q[17] == 0 || q[24] == 0)
        return false;
      if (c.coef_bits[0] < 0) return false;
      // SAVED_COEFS = 10: the first ten coefficients in zigzag order
      for (int k = 1; k < 10; ++k)
        if (c.coef_bits[k] != 0) useful = true;
    }
    return useful;
  }

  void finish(uint8_t* out) {
    const bool smooth = smoothing_ok();
    for (auto& c : comps_) {
      // a DCT component no scan reached has no quantization table latched
      // and decodes to 128 everywhere, as in libjpeg
      if (!c.latched && lossless_) refuse("a component without image data");
      if (lossless_) lossless_plane(c);
      else idct_component(c, smooth);
    }
    upsample_and_convert(out);
  }

  // jdlossls.c's scaler: each sample shifted back by the point transform
  void lossless_plane(Component& c) {
    c.plane.resize(static_cast<size_t>(c.dh) * c.dw);
    const auto* in = reinterpret_cast<const uint16_t*>(c.coef.data());
    for (int y = 0; y < c.dh; ++y)
      for (int x = 0; x < c.dw; ++x)
        c.plane[static_cast<size_t>(y) * c.dw + x] =
            static_cast<uint8_t>(in[static_cast<size_t>(y) * c.stride_blocks + x] << c.pt);
  }

  // libjpeg-turbo 2.1+'s decompress_smooth_data for one block: estimates of
  // the unknown low-frequency coefficients from the 5x5 neighbourhood of DC
  // values ``dc`` (row-major, this block in the middle), into ``ws``
  static void smooth_block(const int* dc, const int* bits, const uint16_t* q, int16_t* ws) {
    // change_dc: no AC coefficient known, so the DC is interpolated too
    bool change_dc = true;
    for (int k = 1; k < 10; ++k)
      if (bits[k] != -1) change_dc = false;
    const int64_t q00 = q[0];
    const int* D = dc - 1;  // D[1..25] is libjpeg's DC01..DC25
    auto estimate = [&](int k, int pos, int64_t qk, int64_t num) {
      const int al = bits[k];
      if (al == 0 || ws[pos] != 0) return;
      int pred;
      if (num >= 0) {
        pred = static_cast<int>(((qk << 7) + num) / (qk << 8));
        if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
      } else {
        pred = static_cast<int>(((qk << 7) - num) / (qk << 8));
        if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
        pred = -pred;
      }
      ws[pos] = static_cast<int16_t>(pred);
    };
    estimate(1, 1, q[1], q00 * (change_dc
        ? -D[1] - D[2] + D[4] + D[5] - 3 * D[6] + 13 * D[7] - 13 * D[9] + 3 * D[10] -
              3 * D[11] + 38 * D[12] - 38 * D[14] + 3 * D[15] - 3 * D[16] + 13 * D[17] -
              13 * D[19] + 3 * D[20] - D[21] - D[22] + D[24] + D[25]
        : -7 * D[11] + 50 * D[12] - 50 * D[14] + 7 * D[15]));
    estimate(2, 8, q[8], q00 * (change_dc
        ? -D[1] - 3 * D[2] - 3 * D[3] - 3 * D[4] - D[5] - D[6] + 13 * D[7] + 38 * D[8] +
              13 * D[9] - D[10] + D[16] - 13 * D[17] - 38 * D[18] - 13 * D[19] + D[20] +
              D[21] + 3 * D[22] + 3 * D[23] + 3 * D[24] + D[25]
        : -7 * D[3] + 50 * D[8] - 50 * D[18] + 7 * D[23]));
    estimate(3, 16, q[16], q00 * (change_dc
        ? D[3] + 2 * D[7] + 7 * D[8] + 2 * D[9] - 5 * D[12] - 14 * D[13] - 5 * D[14] +
              2 * D[17] + 7 * D[18] + 2 * D[19] + D[23]
        : -D[3] + 13 * D[8] - 24 * D[13] + 13 * D[18] - D[23]));
    estimate(4, 9, q[9], q00 * (change_dc
        ? -D[1] + D[5] + 9 * D[7] - 9 * D[9] - 9 * D[17] + 9 * D[19] + D[21] - D[25]
        : D[10] + D[16] - 10 * D[17] + 10 * D[19] - D[2] - D[20] + D[22] - D[24] + D[4] -
              D[6] + 10 * D[7] - 10 * D[9]));
    estimate(5, 2, q[2], q00 * (change_dc
        ? 2 * D[7] - 5 * D[8] + 2 * D[9] + D[11] + 7 * D[12] - 14 * D[13] + 7 * D[14] +
              D[15] + 2 * D[17] - 5 * D[18] + 2 * D[19]
        : -D[11] + 13 * D[12] - 24 * D[13] + 13 * D[14] - D[15]));
    if (!change_dc) return;
    estimate(6, 3, q[3], q00 * (D[7] - D[9] + 2 * D[12] - 2 * D[14] + D[17] - D[19]));
    estimate(7, 10, q[10], q00 * (D[7] - 3 * D[8] + D[9] - D[17] + 3 * D[18] - D[19]));
    estimate(8, 17, q[17], q00 * (D[7] - D[9] - 3 * D[12] + 3 * D[14] + D[17] - D[19]));
    estimate(9, 24, q[24], q00 * (D[7] + 2 * D[8] + D[9] - D[17] - 2 * D[18] - D[19]));
    const int64_t num = q00 * (
        -2 * D[1] - 6 * D[2] - 8 * D[3] - 6 * D[4] - 2 * D[5] - 6 * D[6] + 6 * D[7] +
        42 * D[8] + 6 * D[9] - 6 * D[10] - 8 * D[11] + 42 * D[12] + 152 * D[13] +
        42 * D[14] - 8 * D[15] - 6 * D[16] + 6 * D[17] + 42 * D[18] + 6 * D[19] -
        6 * D[20] - 2 * D[21] - 6 * D[22] - 8 * D[23] - 6 * D[24] - 2 * D[25]);
    const int pred = num >= 0 ? static_cast<int>(((q00 << 7) + num) / (q00 << 8))
                              : -static_cast<int>(((q00 << 7) - num) / (q00 << 8));
    ws[0] = static_cast<int16_t>(pred);
  }

  static inline uint8_t idct_limit(int64_t x) {
    // jdmaster.c's post-IDCT range-limit table, indexed by x & RANGE_MASK
    const int i = static_cast<int>(x & 1023);
    if (i < 128) return static_cast<uint8_t>(i + 128);
    if (i < 512) return 255;
    if (i < 896) return 0;
    return static_cast<uint8_t>(i - 896);
  }

  // jidctint.c's jpeg_idct_islow on every block of the component, smoothed
  // first where libjpeg smooths
  void idct_component(Component& c, bool smooth) {
    c.plane.assign(static_cast<size_t>(c.bh) * 8 * c.bw * 8, 0);
    const int pw = c.bw * 8;
    int16_t qs[64];
    for (int i = 0; i < 64; ++i) qs[i] = static_cast<int16_t>(c.quant[i]);  // ISLOW_MULT_TYPE
    int cur_bits[10], prev_bits[10];  // coef_bits_latch: now, and before the last scan
    for (int k = 0; k < 10; ++k) {
      cur_bits[k] = c.coef_bits[k];
      prev_bits[k] = scans_ > 1 ? c.prev_bits[k] : -1;
    }
    for (int by = 0; by < c.bh; ++by) {
      // the rows decompress_smooth_data reads around block row ``by``, with
      // its image_block_row arithmetic (block_rows is the last iMCU row's
      // count of rows there, as libjpeg counts it)
      const int imcu = by / c.v, br = by % c.v;
      int block_rows = c.v;
      if (imcu == mcuy_ - 1) block_rows = c.bh % c.v ? c.bh % c.v : c.v;
      const int ibr = imcu * block_rows + br, ibrs = block_rows * mcuy_;
      const int prev = ibr > 0 ? by - 1 : by, next = ibr < ibrs - 1 ? by + 1 : by;
      const int rows[5] = {ibr > 1 ? by - 2 : prev, prev, by, next, ibr < ibrs - 2 ? by + 2 : next};
      const int* bits = imcu > last_good_row_ ? prev_bits : cur_bits;
      for (int bx = 0; bx < c.bw; ++bx) {
        const int16_t* src = block(c, by, bx);
        int16_t ws[64];
        if (smooth) {
          std::memcpy(ws, src, sizeof ws);
          int dc[25];
          for (int r = 0; r < 5; ++r)
            for (int k = 0; k < 5; ++k)
              dc[5 * r + k] = block(c, rows[r], std::max(0, std::min(c.bw - 1, bx + k - 2)))[0];
          smooth_block(dc, bits, c.quant, ws);
          src = ws;
        }
        idct_islow(src, qs, &c.plane[static_cast<size_t>(by) * 8 * pw + bx * 8], pw);
      }
    }
    // keep dh x dw
    if (c.dw != pw) {
      for (int y = 0; y < c.dh; ++y)
        std::memmove(&c.plane[static_cast<size_t>(y) * c.dw], &c.plane[static_cast<size_t>(y) * pw], c.dw);
    }
    c.plane.resize(static_cast<size_t>(c.dh) * c.dw);
  }

  static void idct_islow(const int16_t* in, const int16_t* q, uint8_t* out, int stride) {
    constexpr int CONST_BITS = 13, PASS1_BITS = 2;
    constexpr int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                      F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069,
                      F2053 = 16819, F2562 = 20995, F3072 = 25172;
    auto descale = [](int64_t x, int n) { return (x + (int64_t{1} << (n - 1))) >> n; };
    int ws[64];
    for (int col = 0; col < 8; ++col) {
      const int16_t* ip = in + col;
      const int16_t* qp = q + col;
      int* wp = ws + col;
      if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 && ip[40] == 0 &&
          ip[48] == 0 && ip[56] == 0) {
        const int dc = static_cast<int>(static_cast<unsigned>(ip[0] * qp[0]) << PASS1_BITS);
        for (int r = 0; r < 8; ++r) wp[8 * r] = dc;
        continue;
      }
      int64_t z2 = ip[16] * qp[16], z3 = ip[48] * qp[48];
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * (-F1847);
      int64_t tmp3 = z1 + z2 * F0765;
      z2 = ip[0] * qp[0];
      z3 = ip[32] * qp[32];
      int64_t tmp0 = (z2 + z3) * (int64_t{1} << CONST_BITS);
      int64_t tmp1 = (z2 - z3) * (int64_t{1} << CONST_BITS);
      const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = ip[56] * qp[56];
      tmp1 = ip[40] * qp[40];
      tmp2 = ip[24] * qp[24];
      tmp3 = ip[8] * qp[8];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      const int64_t z5 = (z3 + z4) * F1175;
      tmp0 *= F0298;
      tmp1 *= F2053;
      tmp2 *= F3072;
      tmp3 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      constexpr int S = CONST_BITS - PASS1_BITS;
      wp[0] = static_cast<int>(descale(tmp10 + tmp3, S));
      wp[56] = static_cast<int>(descale(tmp10 - tmp3, S));
      wp[8] = static_cast<int>(descale(tmp11 + tmp2, S));
      wp[48] = static_cast<int>(descale(tmp11 - tmp2, S));
      wp[16] = static_cast<int>(descale(tmp12 + tmp1, S));
      wp[40] = static_cast<int>(descale(tmp12 - tmp1, S));
      wp[24] = static_cast<int>(descale(tmp13 + tmp0, S));
      wp[32] = static_cast<int>(descale(tmp13 - tmp0, S));
    }
    for (int row = 0; row < 8; ++row) {
      const int* wp = ws + 8 * row;
      uint8_t* op = out + static_cast<size_t>(row) * stride;
      if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 && wp[5] == 0 && wp[6] == 0 &&
          wp[7] == 0) {
        const uint8_t dc = idct_limit(descale(wp[0], PASS1_BITS + 3));
        for (int i = 0; i < 8; ++i) op[i] = dc;
        continue;
      }
      int64_t z2 = wp[2], z3 = wp[6];
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * (-F1847);
      int64_t tmp3 = z1 + z2 * F0765;
      int64_t tmp0 = (static_cast<int64_t>(wp[0]) + wp[4]) * (int64_t{1} << CONST_BITS);
      int64_t tmp1 = (static_cast<int64_t>(wp[0]) - wp[4]) * (int64_t{1} << CONST_BITS);
      const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = wp[7];
      tmp1 = wp[5];
      tmp2 = wp[3];
      tmp3 = wp[1];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      const int64_t z5 = (z3 + z4) * F1175;
      tmp0 *= F0298;
      tmp1 *= F2053;
      tmp2 *= F3072;
      tmp3 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      constexpr int S = CONST_BITS + PASS1_BITS + 3;
      op[0] = idct_limit(descale(tmp10 + tmp3, S));
      op[7] = idct_limit(descale(tmp10 - tmp3, S));
      op[1] = idct_limit(descale(tmp11 + tmp2, S));
      op[6] = idct_limit(descale(tmp11 - tmp2, S));
      op[2] = idct_limit(descale(tmp12 + tmp1, S));
      op[5] = idct_limit(descale(tmp12 - tmp1, S));
      op[3] = idct_limit(descale(tmp13 + tmp0, S));
      op[4] = idct_limit(descale(tmp13 - tmp0, S));
    }
  }

  // jdapimin.c's default_decompress_parms: whether 3 components are YCbCr
  // (not RGB) and 4 are YCCK (not CMYK). Three are YCbCr with a JFIF marker
  // or an Adobe transform other than 0, RGB with transform 0, and without
  // either marker RGB when their ids are 'R', 'G', 'B' (libjpeg-turbo 3:
  // always, in a lossless frame). Four are YCCK by an Adobe transform other
  // than 0, else CMYK.
  bool ycc_frame() const {
    if (comps_.size() == 4) return adobe_ && adobe_transform_ != 0;
    if (comps_.size() != 3) return false;
    if (jfif_) return true;
    if (adobe_) return adobe_transform_ != 0;
    return !lossless_ && !(comps_[0].id == 82 && comps_[1].id == 71 && comps_[2].id == 66);
  }

  // One component at full size (height_ x width_), as jdsample.c makes it.
  std::vector<uint8_t> upsample(const Component& c) const {
    const int hr = max_h_ / c.h, vr = max_v_ / c.v;
    const int dw = c.dw, dh = c.dh;
    const int ow = dw * hr;  // rows are built this wide, then cut to width_
    std::vector<uint8_t> out(static_cast<size_t>(height_) * width_);
    std::vector<uint8_t> row(static_cast<size_t>(ow) + 8);
    auto in_row = [&](int y) {  // context rows repeat the first and last
      y = std::max(0, std::min(dh - 1, y));
      return &c.plane[static_cast<size_t>(y) * dw];
    };
    // fancy upsampling needs DCT blocks larger than 1x1 (jdsample.c's do_fancy)
    const bool fancy = !lossless_;
    const bool fancy_h2 = fancy && hr == 2 && dw > 2;
    for (int oy = 0; oy < height_; ++oy) {
      const int iy = oy / vr;
      const uint8_t* p0 = in_row(iy);
      uint8_t* o = row.data();
      if (hr == 1 && vr == 1) {
        std::memcpy(o, p0, dw);
      } else if (hr == 2 && vr == 1 && fancy_h2) {  // h2v1_fancy_upsample
        int v = p0[0];
        o[0] = static_cast<uint8_t>(v);
        o[1] = static_cast<uint8_t>((v * 3 + p0[1] + 2) >> 2);
        for (int x = 1; x < dw - 1; ++x) {
          v = p0[x] * 3;
          o[2 * x] = static_cast<uint8_t>((v + p0[x - 1] + 1) >> 2);
          o[2 * x + 1] = static_cast<uint8_t>((v + p0[x + 1] + 2) >> 2);
        }
        v = p0[dw - 1];
        o[2 * (dw - 1)] = static_cast<uint8_t>((v * 3 + p0[dw - 2] + 1) >> 2);
        o[2 * (dw - 1) + 1] = static_cast<uint8_t>(v);
      } else if (fancy && hr == 1 && vr == 2) {  // h1v2_fancy_upsample
        const bool upper = (oy % 2) == 0;
        const uint8_t* p1 = in_row(upper ? iy - 1 : iy + 1);
        const int bias = upper ? 1 : 2;
        for (int x = 0; x < dw; ++x) o[x] = static_cast<uint8_t>((p0[x] * 3 + p1[x] + bias) >> 2);
      } else if (hr == 2 && vr == 2 && fancy_h2) {  // h2v2_fancy_upsample
        const bool upper = (oy % 2) == 0;
        const uint8_t* p1 = in_row(upper ? iy - 1 : iy + 1);
        int thiscol = p0[0] * 3 + p1[0];
        int nextcol = p0[1] * 3 + p1[1];
        o[0] = static_cast<uint8_t>((thiscol * 4 + 8) >> 4);
        o[1] = static_cast<uint8_t>((thiscol * 3 + nextcol + 7) >> 4);
        int lastcol = thiscol;
        thiscol = nextcol;
        for (int x = 1; x < dw - 1; ++x) {
          nextcol = p0[x + 1] * 3 + p1[x + 1];
          o[2 * x] = static_cast<uint8_t>((thiscol * 3 + lastcol + 8) >> 4);
          o[2 * x + 1] = static_cast<uint8_t>((thiscol * 3 + nextcol + 7) >> 4);
          lastcol = thiscol;
          thiscol = nextcol;
        }
        o[2 * (dw - 1)] = static_cast<uint8_t>((thiscol * 3 + lastcol + 8) >> 4);
        o[2 * (dw - 1) + 1] = static_cast<uint8_t>((thiscol * 4 + 7) >> 4);
      } else {  // h2v1_upsample, h2v2_upsample, int_upsample: replication
        for (int x = 0; x < dw; ++x)
          for (int k = 0; k < hr; ++k) o[x * hr + k] = p0[x];
      }
      std::memcpy(&out[static_cast<size_t>(oy) * width_], o, width_);
    }
    return out;
  }

  void upsample_and_convert(uint8_t* out) {
    const size_t npix = static_cast<size_t>(height_) * width_;
    std::vector<std::vector<uint8_t>> full;
    for (const auto& c : comps_) full.push_back(upsample(c));
    const int nc = static_cast<int>(comps_.size());
    if (nc == 1) {
      const uint8_t* g = full[0].data();
      for (size_t i = 0; i < npix; ++i) out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = g[i];
      return;
    }
    // jdcolor.c's build_ycc_rgb_table
    constexpr int SCALEBITS = 16;
    constexpr int64_t ONE_HALF = int64_t{1} << (SCALEBITS - 1);
    auto fix = [](double x) { return static_cast<int64_t>(x * (1L << SCALEBITS) + 0.5); };
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = static_cast<int>((fix(1.40200) * x + ONE_HALF) >> SCALEBITS);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + ONE_HALF) >> SCALEBITS);
      cr_g[i] = (-fix(0.71414)) * x;
      cb_g[i] = (-fix(0.34414)) * x + ONE_HALF;
    }
    auto clamp = [](int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); };
    const uint8_t* c0 = full[0].data();
    const uint8_t* c1 = full[1].data();
    const uint8_t* c2 = full[2].data();
    if (nc == 3) {
      const bool rgb = !ycc_frame();
      for (size_t i = 0; i < npix; ++i) {
        if (rgb) {
          out[3 * i] = c0[i]; out[3 * i + 1] = c1[i]; out[3 * i + 2] = c2[i];
          continue;
        }
        const int y = c0[i], cb = c1[i], cr = c2[i];
        out[3 * i] = clamp(y + cr_r[cr]);
        out[3 * i + 1] = clamp(y + static_cast<int>((cb_g[cb] + cr_g[cr]) >> SCALEBITS));
        out[3 * i + 2] = clamp(y + cb_b[cb]);
      }
      return;
    }
    const bool ycck = ycc_frame();
    const uint8_t* c3 = full[3].data();
    for (size_t i = 0; i < npix; ++i) {
      int cmyk[4];
      if (ycck) {  // ycck_cmyk_convert
        const int y = c0[i], cb = c1[i], cr = c2[i];
        cmyk[0] = clamp(255 - (y + cr_r[cr]));
        cmyk[1] = clamp(255 - (y + static_cast<int>((cb_g[cb] + cr_g[cr]) >> SCALEBITS)));
        cmyk[2] = clamp(255 - (y + cb_b[cb]));
      } else {
        cmyk[0] = c0[i]; cmyk[1] = c1[i]; cmyk[2] = c2[i];
      }
      cmyk[3] = c3[i];
      // PIL inverts what libjpeg gives ("CMYK;I"), then cmyk2rgb: with the
      // inverted K' = 255 - k, nk = 255 - K' = k
      const int nk = cmyk[3];
      for (int k = 0; k < 3; ++k) {
        const int tmp = (255 - cmyk[k]) * nk + 128;
        const int mul = ((tmp >> 8) + tmp) >> 8;
        out[3 * i + k] = clamp(nk - mul);
      }
    }
  }
};

void set_error(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) {
    std::strncpy(err, msg.c_str(), errlen - 1);
    err[errlen - 1] = 0;
  }
}

}  // namespace

extern "C" {

// Whether the decoder refuses the file on its markers alone (Decoder::check):
// 0 if not, -1 with a message in err, 1 if the data ends before that is known.
int jpeg_check(const uint8_t* data, size_t len, char* err, int errlen) {
  try {
    Decoder(data, len).check();
    return 0;
  } catch (const Truncated&) {
    return 1;
  } catch (const Refusal& e) {
    set_error(err, errlen, e.what());
  } catch (const std::bad_alloc&) {
    set_error(err, errlen, "out of memory");
  }
  return -1;
}

// Height and width from the frame header: 0, or -1 with a message in err.
int jpeg_header(const uint8_t* data, size_t len, int64_t* dims, char* err, int errlen) {
  try {
    Decoder(data, len).header(dims);
    return 0;
  } catch (const Refusal& e) {
    set_error(err, errlen, e.what());
  } catch (const std::bad_alloc&) {
    set_error(err, errlen, "out of memory");
  }
  return -1;
}

// Decodes into out, (height, width, 3) uint8 from jpeg_header: 0, or -1 with
// a message in err.
int jpeg_decode_rgb(const uint8_t* data, size_t len, uint8_t* out, size_t out_len, char* err,
                    int errlen) {
  try {
    Decoder dec(data, len);
    int64_t dims[2];
    Decoder(data, len).header(dims);
    if (static_cast<size_t>(dims[0]) * static_cast<size_t>(dims[1]) * 3 != out_len) {
      set_error(err, errlen, "output buffer does not match the image size");
      return -1;
    }
    dec.decode(out);
    return 0;
  } catch (const Refusal& e) {
    set_error(err, errlen, e.what());
  } catch (const std::bad_alloc&) {
    set_error(err, errlen, "out of memory");
  }
  return -1;
}

}  // extern "C"
