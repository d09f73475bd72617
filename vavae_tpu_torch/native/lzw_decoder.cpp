// The port's LZW and PackBits decoders, loaded through ctypes by
// utils/gif.py and utils/tiff.py. Loops that are slow in Python, each
// written after the decoder PIL 12 reaches, so that a file decodes to the
// same pixels and a broken one fails where PIL's fails:
//   - GIF's LZW (gif_decode), after PIL's GifDecode.c: LSB-first codes of
//     1 + minimum code size bits, up to 12; the width grows when the next
//     free code equals the code mask, so a minimum code size of 1 never
//     grows; no entry is added once the table holds 4,096 codes, until the
//     next clear; a code equal to the next free one repeats the last string
//     and its first byte. It is driven as ImageFile.load drives it: the data
//     after the minimum code size byte handed over in 64 KiB reads, a
//     sub-block decoded only once it is whole, the frame done when its last
//     row is written. An EOI before that returns to the reader, which needs
//     more of the file; where the file holds no more, the image is
//     truncated. Rows go to the frame's box on the canvas, in the four
//     interlace passes if asked.
//   - TIFF's LZW, after libtiff 4.7's LZWDecode: MSB-first codes of 9-12
//     bits, the width growing one code early; the first code a clear; the
//     table allowed 1,024 entries past 4,096; a strip that ends without EOI
//     read as if it ended with one. Fewer bytes than the strip holds is an
//     error, as in libtiff.
//   - PackBits, after libtiff's PackBitsDecode: a run that passes the strip
//     is cut; -128 is a no-op; too few bytes is an error.
// tiff_decode_blocks decodes every strip or tile of a TIFF in one call and
// then, as libtiff does, swaps wide samples to the host's order and undoes
// horizontal differencing (predictor 2); palette_rgb expands palette
// indices to RGB. Each returns 0, or -1 with a message in ``err``. No call
// holds Python's interpreter lock, so threads decode in parallel.
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <utility>
#include <vector>

namespace {

void set_err(char* err, int err_len, const char* msg) {
  if (err && err_len > 0) std::snprintf(err, err_len, "%s", msg);
}

// ---------------------------------------------------------------- GIF ----

constexpr int kGifBits = 12;
constexpr int kGifTable = 4096;
constexpr int64_t kMaxBlock = 65536;  // ImageFile.MAXBLOCK: load's read size

// GifDecode.c's codec state (codec error codes as PIL's)
enum { kCodecOverrun = -1, kCodecBroken = -2, kCodecConfig = -8 };

struct GifState {
  // the frame's box on the canvas
  uint8_t* canvas;
  int64_t canvas_w;
  int xoff, yoff, xsize, ysize;
  int x = 0, y = 0;
  int state = 0;  // 0 start, 1 clear, 2 first symbol, 3 symbols
  int errcode = 0;
  // GIFDECODERSTATE
  int bits, interlace;
  int step = 1, repeat = 0;
  int clear = 0, end = 0, next = 0;
  int codesize = 0, codemask = 0;
  uint32_t bitbuffer = 0;
  int bitcount = 0;
  int blocksize = 0;
  int bufferindex = kGifTable;
  uint8_t lastdata = 0;
  int lastcode = 0;
  uint8_t buffer[kGifTable];
  uint8_t data[kGifTable];
  uint16_t link[kGifTable];

  uint8_t* row() { return canvas + (int64_t)(y + yoff) * canvas_w + xoff; }

  // NEWLINE: false once the last row of the last pass is written
  bool newline() {
    x = 0;
    y += step;
    while (y >= ysize) {
      switch (interlace) {
        case 1: repeat = y = 4; interlace = 2; break;
        case 2: step = 4; repeat = y = 2; interlace = 3; break;
        case 3: step = 2; repeat = y = 1; interlace = 0; break;
        default: return false;
      }
    }
    return true;
  }

  // ImagingGifDecode: the bytes consumed, or -1 when the frame is done
  // (errcode 0) or broken (errcode < 0).
  int64_t decode(const uint8_t* buf, int64_t bytes) {
    const uint8_t* ptr = buf;
    if (!state) {
      if (bits < 0 || bits > kGifBits) {
        errcode = kCodecConfig;
        return -1;
      }
      clear = 1 << bits;
      end = clear + 1;
      if (interlace) {
        interlace = 1;
        step = repeat = 8;
      } else {
        step = 1;
      }
      state = 1;
    }
    uint8_t* out = row() + x;
    for (;;) {
      if (state == 1) {
        next = clear + 2;
        codesize = bits + 1;
        codemask = (1 << codesize) - 1;
        bufferindex = kGifTable;
        state = 2;
      }
      const uint8_t* p;
      int i;
      if (bufferindex < kGifTable) {
        i = kGifTable - bufferindex;
        p = &buffer[bufferindex];
        bufferindex = kGifTable;
      } else {
        while (bitcount < codesize) {
          if (blocksize > 0) {
            int c = *ptr++;
            bytes--;
            blocksize--;
            bitbuffer |= (uint32_t)c << bitcount;
            bitcount += 8;
          } else {
            // a new sub-block, decoded only once it is whole
            if (bytes < 1) return ptr - buf;
            int c = *ptr;
            if (bytes < c + 1) return ptr - buf;
            blocksize = c;
            ptr++;
            bytes--;
          }
        }
        int c = (int)(bitbuffer & (uint32_t)codemask);
        bitbuffer >>= codesize;
        bitcount -= codesize;
        if (c == clear) {
          if (state != 2) state = 1;
          continue;
        }
        if (c == end) break;
        i = 1;
        p = &lastdata;
        if (state == 2) {
          if (c > clear) {
            errcode = kCodecBroken;
            return -1;
          }
          lastdata = (uint8_t)c;
          lastcode = c;
          state = 3;
        } else {
          int thiscode = c;
          if (c > next) {
            errcode = kCodecBroken;
            return -1;
          }
          if (c == next) {  // KwKwK: the last string and its first byte
            if (bufferindex <= 0) {
              errcode = kCodecBroken;
              return -1;
            }
            buffer[--bufferindex] = lastdata;
            c = lastcode;
          }
          while (c >= clear) {
            if (bufferindex <= 0 || c >= kGifTable) {
              errcode = kCodecBroken;
              return -1;
            }
            buffer[--bufferindex] = data[c];
            c = link[c];
          }
          lastdata = (uint8_t)c;
          if (next < kGifTable) {
            data[next] = (uint8_t)c;
            link[next] = (uint16_t)lastcode;
            if (next == codemask && codesize < kGifBits) {
              codesize++;
              codemask = (1 << codesize) - 1;
            }
            next++;
          }
          lastcode = thiscode;
        }
      }
      if (y >= ysize) {
        errcode = kCodecOverrun;
        return -1;
      }
      // the shortcuts of GifDecode.c, which write what the loop below would
      if (i == 1) {
        if (x < xsize - 1) {
          *out++ = p[0];
          x++;
          continue;
        }
      } else if (x + i <= xsize) {
        std::memcpy(out, p, i);
        out += i;
        x += i;
        if (x == xsize) {
          if (!newline()) return -1;
          out = row();
        }
        continue;
      }
      for (int k = 0; k < i; k++) {
        *out++ = p[k];
        if (++x >= xsize) {
          if (!newline()) return -1;
          out = row();
        }
      }
    }
    return ptr - buf;
  }
};

// ------------------------------------------------------------ TIFF LZW ----

constexpr int kBitsMin = 9;
constexpr int kBitsMax = 12;
constexpr int kCodeClear = 256;
constexpr int kCodeEoi = 257;
constexpr int kCodeFirst = 258;
constexpr int kCsize = ((1 << kBitsMax) - 1) + 1024;

struct Code {
  int next;  // index of the prefix's entry, -1 for none
  uint16_t length;
  uint8_t value;
  uint8_t firstchar;
};

// One TIFF LZW strip or tile (``n`` bytes) into ``occ`` bytes of ``out``.
int tiff_lzw_decode(const uint8_t* in, int64_t n, uint8_t* out, int64_t occ, char* err,
                    int err_len) {
  std::vector<Code> tab(kCsize);
  for (int c = 0; c < 256; c++) tab[c] = Code{-1, 1, (uint8_t)c, (uint8_t)c};
  for (int c = 256; c < kCsize; c++) tab[c] = Code{-1, 0, 0, 0};
  int nbits = kBitsMin, nbitsmask = (1 << kBitsMin) - 1;
  int free_ent = kCodeFirst, maxcode = nbitsmask - 1;
  int oldcode = -2;  // libtiff's &dec_codetab[-1]: no string before the first clear
  uint64_t bitsleft = (uint64_t)n * 8;
  uint64_t nextdata = 0;
  int nextbits = 0;
  int64_t pos = 0;
  uint8_t* op = out;
  auto next_code = [&]() -> int {
    if (bitsleft < (uint64_t)nbits) return kCodeEoi;  // no EOI: read as one
    nextdata = (nextdata << 8) | in[pos++];
    nextbits += 8;
    if (nextbits < nbits) {
      nextdata = (nextdata << 8) | in[pos++];
      nextbits += 8;
    }
    int code = (int)((nextdata >> (nextbits - nbits)) & (uint64_t)nbitsmask);
    nextbits -= nbits;
    bitsleft -= nbits;
    return code;
  };
  while (occ > 0) {
    int code = next_code();
    if (code == kCodeEoi) break;
    if (code == kCodeClear) {
      do {
        free_ent = kCodeFirst;
        for (int c = kCodeFirst; c < kCsize; c++) tab[c] = Code{-1, 0, 0, 0};
        nbits = kBitsMin;
        nbitsmask = (1 << kBitsMin) - 1;
        maxcode = nbitsmask - 1;
        code = next_code();
      } while (code == kCodeClear);
      if (code == kCodeEoi) break;
      if (code > kCodeClear) {
        set_err(err, err_len, "LZWDecode: Corrupted LZW table");
        return -1;
      }
      *op++ = (uint8_t)code;
      occ--;
      oldcode = code;
      continue;
    }
    if (free_ent >= kCsize || oldcode < 0) {
      set_err(err, err_len, "LZWDecode: Corrupted LZW table");
      return -1;
    }
    Code& fe = tab[free_ent];
    fe.next = oldcode;
    fe.firstchar = tab[oldcode].firstchar;
    fe.length = tab[oldcode].length + 1;
    fe.value = code < free_ent ? tab[code].firstchar : fe.firstchar;
    if (++free_ent > maxcode) {
      if (++nbits > kBitsMax) nbits = kBitsMax;
      nbitsmask = (1 << nbits) - 1;
      maxcode = nbitsmask - 1;
    }
    oldcode = code;
    if (code >= 256) {
      const Code* cp = &tab[code];
      if (cp->length == 0) {
        set_err(err, err_len, "LZWDecode: Wrong length of decoded string");
        return -1;
      }
      if (cp->length > occ) {  // the string's prefix that fits, then done
        int c = code;
        while (c >= 0 && tab[c].length > occ) c = tab[c].next;
        if (c >= 0) {
          uint8_t* tp = op + occ;
          do {
            *--tp = tab[c].value;
            c = tab[c].next;
          } while (--occ && c >= 0);
        }
        break;
      }
      int len = cp->length;
      uint8_t* tp = op + len;
      int c = code;
      do {
        *--tp = tab[c].value;
        c = tab[c].next;
      } while (c >= 0 && tp > op);
      if (c >= 0) {
        set_err(err, err_len, "LZWDecode: Bogus encoding, loop in the code table");
        return -1;
      }
      op += len;
      occ -= len;
    } else {
      *op++ = (uint8_t)code;
      occ--;
    }
  }
  if (occ > 0) {
    set_err(err, err_len, "LZWDecode: Not enough data");
    return -1;
  }
  return 0;
}

// One PackBits strip or tile (``n`` bytes) into ``occ`` bytes of ``out``.
int packbits_decode(const uint8_t* in, int64_t n, uint8_t* out, int64_t occ, char* err,
                    int err_len) {
  const int8_t* bp = reinterpret_cast<const int8_t*>(in);
  int64_t cc = n;
  uint8_t* op = out;
  while (cc > 0 && occ > 0) {
    long k = *bp++;
    cc--;
    if (k < 0) {  // the next byte -k + 1 times
      if (k == -128) continue;
      k = -k + 1;
      if (occ < k) k = (long)occ;
      if (cc == 0) break;
      occ -= k;
      uint8_t b = (uint8_t)*bp++;
      cc--;
      std::memset(op, b, k);
      op += k;
    } else {  // the next k + 1 bytes as they are
      if (occ < k + 1) k = (long)occ - 1;
      if (cc < k + 1) break;
      ++k;
      std::memcpy(op, bp, k);
      op += k;
      occ -= k;
      bp += k;
      cc -= k;
    }
  }
  if (occ > 0) {
    std::memset(op, 0, occ);
    set_err(err, err_len, "PackBitsDecode: Not enough data");
    return -1;
  }
  return 0;
}

// TIFF predictor 2 undone in place on ``rows`` rows of ``row_bytes``:
// samples of ``nbytes`` (1, 2 or 4) bytes in the host's order, each summed
// with the one ``spp`` samples to its left, modulo 2^(8 nbytes).
void tiff_undo_predictor(uint8_t* buf, int64_t rows, int64_t row_bytes, int spp, int nbytes) {
  int64_t n = row_bytes / nbytes;  // samples a row
  for (int64_t r = 0; r < rows; r++) {
    uint8_t* row = buf + r * row_bytes;
    if (nbytes == 1) {
      for (int64_t i = spp; i < n; i++) row[i] = (uint8_t)(row[i] + row[i - spp]);
    } else if (nbytes == 2) {
      for (int64_t i = spp; i < n; i++) {
        uint16_t a, b;
        std::memcpy(&a, row + 2 * i, 2);
        std::memcpy(&b, row + 2 * (i - spp), 2);
        a = (uint16_t)(a + b);
        std::memcpy(row + 2 * i, &a, 2);
      }
    } else {
      for (int64_t i = spp; i < n; i++) {
        uint32_t a, b;
        std::memcpy(&a, row + 4 * i, 4);
        std::memcpy(&b, row + 4 * (i - spp), 4);
        a += b;
        std::memcpy(row + 4 * i, &a, 4);
      }
    }
  }
}

}  // namespace

extern "C" {

// The first frame of a GIF: ``data[offset:]`` is the frame's LZW data (after
// its minimum code size byte ``bits``); its indices are written into the
// ``canvas_w``-wide canvas at the box (x0, y0, w, h). Returns 0 or -1.
int gif_decode(const uint8_t* data, int64_t n, int64_t offset, int bits, int interlace,
               uint8_t* canvas, int64_t canvas_w, int x0, int y0, int w, int h, char* err,
               int err_len) {
  std::vector<GifState> holder(1);  // ~12 KiB: off the (thread's) stack
  GifState& s = holder[0];
  s.canvas = canvas;
  s.canvas_w = canvas_w;
  s.xoff = x0;
  s.yoff = y0;
  s.xsize = w;
  s.ysize = h;
  s.bits = bits;
  s.interlace = interlace;
  if (offset < 0 || offset > n) {
    set_err(err, err_len, "GIF frame data past the file");
    return -1;
  }
  int64_t consumed = offset, read_end = offset;
  for (;;) {
    if (read_end >= n) {
      set_err(err, err_len, "image file is truncated");
      return -1;
    }
    read_end = read_end + kMaxBlock < n ? read_end + kMaxBlock : n;
    int64_t got = s.decode(data + consumed, read_end - consumed);
    if (got < 0) break;
    consumed += got;
  }
  if (s.errcode < 0) {
    char msg[64];
    std::snprintf(msg, sizeof msg, "decoder error %d", s.errcode);
    set_err(err, err_len, msg);
    return -1;
  }
  return 0;
}

// The strips or tiles of one TIFF that a decode reads, each decoded whole,
// as libtiff's TIFFReadEncodedStrip and TIFFReadTile give them, in one call:
// block i, data[offsets[i]:offsets[i] + counts[i]] of the ``n`` bytes of
// ``data`` (a block not wholly inside them is refused; its bits reversed first
// with ``reverse``, FillOrder 2), is decoded by ``codec`` (5 LZW, 32773
// PackBits; 1: already decoded into place) into the next occs[i] bytes of
// ``out``; then, on its rows of ``row_bytes``, samples of ``nbytes`` bytes
// are swapped to the host's order (``swap``) and predictor 2 undone
// (``predictor``, ``spp`` samples apart). Returns 0, or -1 with the failing
// block's message in ``err``.
int tiff_decode_blocks(const uint8_t* data, int64_t n, const int64_t* offsets,
                       const int64_t* counts, const int64_t* occs, int64_t nblocks, int codec,
                       int reverse, int swap, int predictor, int64_t row_bytes, int spp,
                       int nbytes, uint8_t* out, char* err, int err_len) {
  uint8_t flip[256];
  for (int b = 0; b < 256; b++) {
    int r = 0;
    for (int k = 0; k < 8; k++) r |= ((b >> k) & 1) << (7 - k);
    flip[b] = (uint8_t)r;
  }
  std::vector<uint8_t> reversed;
  for (int64_t i = 0; i < nblocks; i++) {
    if (offsets[i] < 0 || counts[i] < 0 || offsets[i] > n || counts[i] > n - offsets[i]) {
      set_err(err, err_len, "TIFF strip or tile lies past the file");
      return -1;
    }
    const uint8_t* in = data + offsets[i];
    if (reverse && codec != 1) {
      reversed.resize(counts[i]);
      for (int64_t k = 0; k < counts[i]; k++) reversed[k] = flip[in[k]];
      in = reversed.data();
    }
    int rc = 0;
    if (codec == 5) rc = tiff_lzw_decode(in, counts[i], out, occs[i], err, err_len);
    if (codec == 32773) rc = packbits_decode(in, counts[i], out, occs[i], err, err_len);
    if (rc != 0) return rc;
    if (swap && nbytes > 1) {
      for (int64_t k = 0; k + nbytes <= occs[i]; k += nbytes) {
        for (int a = 0, b = nbytes - 1; a < b; a++, b--) std::swap(out[k + a], out[k + b]);
      }
    }
    if (predictor == 2) tiff_undo_predictor(out, occs[i] / row_bytes, row_bytes, spp, nbytes);
    out += occs[i];
  }
  return 0;
}

// ``n`` palette indices → ``n`` RGB triples of the 256-entry ``palette``.
void palette_rgb(const uint8_t* idx, int64_t n, const uint8_t* palette, uint8_t* out) {
  for (int64_t i = 0; i < n; i++) {
    const uint8_t* c = palette + 3 * idx[i];
    out[3 * i] = c[0];
    out[3 * i + 1] = c[1];
    out[3 * i + 2] = c[2];
  }
}

}  // extern "C"
