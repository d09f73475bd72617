// WebP decoder for the port's image readers, bit-exact with libwebp 1.6's
// decode as Pillow drives it: ``Image.open(p)`` goes through libwebp's
// ``WebPAnimDecoder`` in non-premultiplied RGBA for every WebP file, and
// ``convert("RGB")`` drops the alpha.
//
// The container is read as ``WebPDemux`` reads a complete file: a RIFF size
// past the end of the data, a chunk running past the RIFF end, a VP8X file
// whose image does not fill its canvas, a VP8L frame with an ALPH chunk, a
// frame outside an animated canvas or flags outside the defined ones are
// refused; ICCP, EXIF, XMP and unknown chunks are skipped; an ALPH chunk is
// used only under VP8X's alpha flag. An animation is decoded to its first
// frame, which is always a key frame: the canvas is cleared to transparent
// black and the frame is written at its offset, unblended.
//
// The bitstreams are decoded as libwebp's C code decodes them:
//   - VP8 (lossy, RFC 6386 key frames): the boolean decoder with libwebp's
//     byte loading, so a partition that runs out is refused at the row where
//     libwebp refuses it; the frame header, segmentation and its tree, the
//     loop-filter header and deltas, 1-8 token partitions, the quantiser
//     tables (``kDcTable``/``kAcTable``, y2 scaled by 155/100 and floored at
//     8, uv DC capped at index 117), the coefficient probabilities and their
//     updates, skip flags; intra 16x16, 4x4 and chroma prediction with
//     libwebp's edge samples (127 above the frame, 129 left of it, the
//     top-right samples of the macroblock above-right, repeated down the
//     right column); the inverse WHT and DCT; the simple and normal loop
//     filters with their per-segment strengths, sharpness and inner-edge
//     rule, over the whole frame after reconstruction (prediction reads the
//     unfiltered samples);
//   - YUV 4:2:0 to RGB with libwebp's "fancy" upsampler (the 9-3-3-1
//     two-row filter with its rounding, the first and last rows mirrored)
//     and its 14-bit fixed-point ``VP8YUVToR/G/B``;
//   - VP8L (lossless): the LSB-first bit reader with libwebp's end-of-stream
//     rule, simple and normal prefix codes checked for completeness as
//     ``BuildHuffmanTable`` checks them, meta prefix codes, LZ77 lengths and
//     distances through the 120-entry distance map, the colour cache, and
//     the inverse predictor (14 modes), cross-colour, subtract-green and
//     colour-indexing transforms (with 1, 2 and 4-bit pixel bundling);
//   - ALPH: raw or VP8L-compressed alpha, with the horizontal, vertical and
//     gradient unfilters; a corrupt alpha plane refuses the file as libwebp
//     refuses it, with the 8-bit path's end-of-stream rule where libwebp
//     takes that path.
//
// C interface (ctypes, vavae_tpu_torch/utils/webp.py):
//   webp_header(data, len, dims[2], err, errlen)                     -> 0 or -1
//   webp_decode(data, len, channels, out, out_len, info, err, errlen) -> 0 or -1
// ``webp_header`` reads the container and the frame's bitstream header
// (what the file is refused for without decoding, a canvas past PIL's
// decompression-bomb bound included); ``webp_decode`` writes
// (height, width, channels) uint8, channels 3 (RGB) or 4 (RGBA), and, when
// ``info`` is not null, facts about the first frame's bitstream (see
// ``kInfo*``).
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Refusal : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void refuse(const std::string& msg) { throw Refusal(msg); }

void set_error(char* err, int errlen, const char* msg) {
  if (err == nullptr || errlen <= 0) return;
  std::strncpy(err, msg, static_cast<size_t>(errlen) - 1);
  err[errlen - 1] = '\0';
}

inline uint32_t le16(const uint8_t* p) { return p[0] | (p[1] << 8); }
inline uint32_t le24(const uint8_t* p) { return le16(p) | (static_cast<uint32_t>(p[2]) << 16); }
inline uint32_t le32(const uint8_t* p) { return le16(p) | (le16(p + 2) << 16); }

// facts reported through ``info`` (indices)
enum {
  kInfoLossless = 0,     // 1 for VP8L, 0 for VP8
  kInfoAlpha,            // 0 none, 1 raw ALPH, 2 VP8L-compressed ALPH, 3 VP8L's own
  kInfoAlphaFilter,      // ALPH filter 0-3
  kInfoAnimated,         // frames in the file (1 for a still image)
  kInfoTransforms,       // VP8L transforms seen, bit t for type t
  kInfoCacheBits,        // VP8L main image's colour-cache bits
  kInfoMetaCodes,        // VP8L main image's prefix-code groups
  kInfoPartitions,       // VP8 token partitions
  kInfoFilterType,       // VP8 0 none, 1 simple, 2 normal
  kInfoSegments,         // VP8 segmentation on, with its map updated (2) or not (1)
  kInfoIntra4,           // VP8 macroblocks coded 4x4
  kInfoSkipProba,        // VP8 uses the skip probability
  kInfoPredictorModes,   // VP8L predictor modes used, bit m for mode m
  kInfoAlpha8b,          // the VP8L alpha stream took libwebp's 8-bit path
  kInfoCount
};

// ------------------------------------------------------------------ tables

const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};
const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};
const uint8_t kCoeffsProba0[4][8][3][11] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
    106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
    181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
    1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
    77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
    170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
    1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
    102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
    177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
    131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
    1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
    81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
    99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
    1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
    44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
    94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
    1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
    35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
    121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
    1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
    175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
    1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
    155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
    201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
    1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
    141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
    213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
    126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
    1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
    39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
    124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
    1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
    28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
    123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
    1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
    47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
    141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};
const uint8_t kCoeffsUpdateProba[4][8][3][11] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
    250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};
const uint8_t kBModesProba[10][10][9] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112,
    152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103,
    56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173,
    121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26,
    170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226,
    81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148,
    72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128,
    41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157,
    65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7,
    87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194,
    66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205,
    43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171,
    56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64,
    34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31,
    68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124,
    62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111,
    60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114,
    40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154,
    61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71,
    142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221,
    51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229,
    67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154,
    40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183,
    46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37,
    65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223,
    87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226,
    64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213,
    30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255,
    31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51,
    88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192,
    55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82,
    95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1,
    57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85,
    41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6,
    101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43,
    117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192,
    69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171,
    62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1,
    63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16,
    86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128,
    58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218,
    51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128,
    22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197,
    56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28,
    85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246,
    35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45,
    85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85,
    56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138,
    101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20,
    138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163,
    112, 19, 12, 61, 195, 128, 48, 4, 24,
};
const int8_t kYModesIntra4[18] = {
    0, 1, -1, 2, -2, 3, 4, 6, -3, 5, -4, -5, -6, 7, -7, 8, -8, -9,
};
const uint8_t kCodeToPlane[120] = {
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42,
    56, 5, 55, 57, 21, 27, 54, 58, 37, 43, 72, 4,
    71, 73, 20, 28, 53, 59, 70, 74, 36, 44, 88, 69,
    75, 52, 60, 3, 87, 89, 19, 29, 86, 90, 35, 45,
    68, 76, 85, 91, 51, 61, 104, 2, 103, 105, 18, 30,
    102, 106, 34, 46, 84, 92, 67, 77, 101, 107, 50, 62,
    120, 1, 119, 121, 83, 93, 17, 31, 100, 108, 66, 78,
    118, 122, 33, 47, 117, 123, 49, 63, 99, 109, 82, 94,
    0, 116, 124, 65, 79, 16, 32, 98, 110, 48, 115, 125,
    81, 95, 64, 114, 126, 97, 111, 80, 113, 127, 96, 112,
};

const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

// ------------------------------------------------------ VP8 boolean decoder

// libwebp's VP8BitReader: ``range_`` holds the range minus one, and bytes are
// loaded as bits run out, so ``eof_`` is set exactly when libwebp sets it
// (a zero byte is shifted in once, then nothing).
class BoolReader {
 public:
  void init(const uint8_t* p, size_t n) {
    buf_ = p;
    end_ = p + n;
    value_ = 0;
    bits_ = -8;
    range_ = 255 - 1;
    eof_ = false;
    load();
  }
  bool eof() const { return eof_; }

  int get_bit(int prob) {
    uint32_t range = range_;
    if (bits_ < 0) load();
    const int pos = bits_;
    const uint32_t split = (range * static_cast<uint32_t>(prob)) >> 8;
    const uint32_t value = static_cast<uint32_t>(value_ >> pos);
    int bit;
    if (value > split) {
      range -= split;
      value_ -= static_cast<uint64_t>(split + 1) << pos;
      bit = 1;
    } else {
      range = split + 1;
      bit = 0;
    }
    const int shift = 7 ^ (31 - __builtin_clz(range));
    range <<= shift;
    bits_ -= shift;
    range_ = range - 1;
    return bit;
  }
  uint32_t get_value(int nbits) {
    uint32_t v = 0;
    while (nbits-- > 0) v |= static_cast<uint32_t>(get_bit(0x80)) << nbits;
    return v;
  }
  int get_signed_value(int nbits) {
    const int v = static_cast<int>(get_value(nbits));
    return get_value(1) ? -v : v;
  }
  // VP8GetSigned: a uniform sign bit (the same split and shift as
  // get_bit(0x80) once the range has left its initial value)
  int get_signed(int v) { return get_bit(0x80) ? -v : v; }

 private:
  void load() {
    if (buf_ < end_) {
      bits_ += 8;
      value_ = (value_ << 8) | *buf_++;
    } else if (!eof_) {
      value_ <<= 8;
      bits_ += 8;
      eof_ = true;
    } else {
      bits_ = 0;
    }
  }
  const uint8_t* buf_ = nullptr;
  const uint8_t* end_ = nullptr;
  uint64_t value_ = 0;
  int bits_ = 0;
  uint32_t range_ = 0;
  bool eof_ = false;
};

// -------------------------------------------------------------- VP8 lossy

constexpr int BPS = 32;  // the stride of the reconstruction scratch
constexpr int Y_OFF = BPS * 1 + 8;
constexpr int U_OFF = Y_OFF + BPS * 16 + BPS;
constexpr int V_OFF = U_OFF + 16;
constexpr int YUV_SIZE = BPS * 17 + BPS * 9;

enum {
  B_DC_PRED = 0, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_RD_PRED, B_VR_PRED, B_LD_PRED, B_VL_PRED,
  B_HD_PRED, B_HU_PRED,
  DC_PRED = B_DC_PRED, V_PRED = B_VE_PRED, H_PRED = B_HE_PRED, TM_PRED = B_TM_PRED,
  B_DC_PRED_NOTOP = 4, B_DC_PRED_NOLEFT = 5, B_DC_PRED_NOTOPLEFT = 6
};

const int kScan[16] = {
    0 + 0 * BPS, 4 + 0 * BPS, 8 + 0 * BPS, 12 + 0 * BPS,
    0 + 4 * BPS, 4 + 4 * BPS, 8 + 4 * BPS, 12 + 4 * BPS,
    0 + 8 * BPS, 4 + 8 * BPS, 8 + 8 * BPS, 12 + 8 * BPS,
    0 + 12 * BPS, 4 + 12 * BPS, 8 + 12 * BPS, 12 + 12 * BPS};

inline int clip_pixel(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }  // VP8kclip1
inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }
inline uint8_t avg3(int a, int b, int c) { return static_cast<uint8_t>((a + 2 * b + c + 2) >> 2); }
inline uint8_t avg2(int a, int b) { return static_cast<uint8_t>((a + b + 1) >> 1); }

// inverse transforms (dsp/dec.c)
inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

void transform_one(const int16_t* in, uint8_t* dst) {
  int C[16];
  int* tmp = C;
  for (int i = 0; i < 4; ++i) {  // vertical pass
    const int a = in[0] + in[8];
    const int b = in[0] - in[8];
    const int c = mul2(in[4]) - mul1(in[12]);
    const int d = mul1(in[4]) + mul2(in[12]);
    tmp[0] = a + d;
    tmp[1] = b + c;
    tmp[2] = b - c;
    tmp[3] = a - d;
    tmp += 4;
    in++;
  }
  tmp = C;
  for (int i = 0; i < 4; ++i) {  // horizontal pass
    const int dc = tmp[0] + 4;
    const int a = dc + tmp[8];
    const int b = dc - tmp[8];
    const int c = mul2(tmp[4]) - mul1(tmp[12]);
    const int d = mul1(tmp[4]) + mul2(tmp[12]);
    dst[0] = static_cast<uint8_t>(clip_pixel(dst[0] + ((a + d) >> 3)));
    dst[1] = static_cast<uint8_t>(clip_pixel(dst[1] + ((b + c) >> 3)));
    dst[2] = static_cast<uint8_t>(clip_pixel(dst[2] + ((b - c) >> 3)));
    dst[3] = static_cast<uint8_t>(clip_pixel(dst[3] + ((a - d) >> 3)));
    tmp++;
    dst += BPS;
  }
}

void transform_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc - tmp[3 + i * 4];
    out[0] = static_cast<int16_t>((a0 + a1) >> 3);
    out[16] = static_cast<int16_t>((a3 + a2) >> 3);
    out[32] = static_cast<int16_t>((a0 - a1) >> 3);
    out[48] = static_cast<int16_t>((a3 - a2) >> 3);
    out += 64;
  }
}

// libwebp picks a DC-only or three-coefficient shortcut by the block's code;
// both equal the full transform on such blocks, and a block without
// coefficients adds nothing
inline void do_transform(uint32_t bits, const int16_t* src, uint8_t* dst) {
  if (bits >> 30) transform_one(src, dst);
}

void do_uv_transform(uint32_t bits, const int16_t* src, uint8_t* dst) {
  if (bits & 0xff) {
    transform_one(src + 0 * 16, dst);
    transform_one(src + 1 * 16, dst + 4);
    transform_one(src + 2 * 16, dst + 4 * BPS);
    transform_one(src + 3 * 16, dst + 4 * BPS + 4);
  }
}

// intra predictors on the scratch (dst points at the block's first sample)
void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  const int tl = top[-1];
  for (int y = 0; y < size; ++y) {
    const int left = dst[-1];
    for (int x = 0; x < size; ++x) dst[x] = static_cast<uint8_t>(clip_pixel(top[x] + left - tl));
    dst += BPS;
  }
}

void fill(uint8_t* dst, int v, int size) {
  for (int j = 0; j < size; ++j) std::memset(dst + j * BPS, v, size);
}

void pred_luma16(int mode, uint8_t* dst) {
  switch (mode) {
    case DC_PRED: {
      int dc = 16;
      for (int j = 0; j < 16; ++j) dc += dst[-1 + j * BPS] + dst[j - BPS];
      fill(dst, dc >> 5, 16);
      break;
    }
    case TM_PRED: true_motion(dst, 16); break;
    case V_PRED:
      for (int j = 0; j < 16; ++j) std::memcpy(dst + j * BPS, dst - BPS, 16);
      break;
    case H_PRED:
      for (int j = 16; j > 0; --j) {
        std::memset(dst, dst[-1], 16);
        dst += BPS;
      }
      break;
    case B_DC_PRED_NOTOP: {
      int dc = 8;
      for (int j = 0; j < 16; ++j) dc += dst[-1 + j * BPS];
      fill(dst, dc >> 4, 16);
      break;
    }
    case B_DC_PRED_NOLEFT: {
      int dc = 8;
      for (int i = 0; i < 16; ++i) dc += dst[i - BPS];
      fill(dst, dc >> 4, 16);
      break;
    }
    default: fill(dst, 0x80, 16); break;
  }
}

void pred_chroma8(int mode, uint8_t* dst) {
  switch (mode) {
    case DC_PRED: {
      int dc0 = 8;
      for (int i = 0; i < 8; ++i) dc0 += dst[i - BPS] + dst[-1 + i * BPS];
      fill(dst, dc0 >> 4, 8);
      break;
    }
    case TM_PRED: true_motion(dst, 8); break;
    case V_PRED:
      for (int j = 0; j < 8; ++j) std::memcpy(dst + j * BPS, dst - BPS, 8);
      break;
    case H_PRED:
      for (int j = 0; j < 8; ++j) {
        std::memset(dst, dst[-1], 8);
        dst += BPS;
      }
      break;
    case B_DC_PRED_NOTOP: {
      int dc0 = 4;
      for (int i = 0; i < 8; ++i) dc0 += dst[-1 + i * BPS];
      fill(dst, dc0 >> 3, 8);
      break;
    }
    case B_DC_PRED_NOLEFT: {
      int dc0 = 4;
      for (int i = 0; i < 8; ++i) dc0 += dst[i - BPS];
      fill(dst, dc0 >> 3, 8);
      break;
    }
    default: fill(dst, 0x80, 8); break;
  }
}

#define DST(x, y) dst[(x) + (y) * BPS]

void pred_luma4(int mode, uint8_t* dst) {
  switch (mode) {
    case B_DC_PRED: {
      uint32_t dc = 4;
      for (int i = 0; i < 4; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      dc >>= 3;
      for (int i = 0; i < 4; ++i) std::memset(dst + i * BPS, static_cast<int>(dc), 4);
      break;
    }
    case B_TM_PRED: true_motion(dst, 4); break;
    case B_VE_PRED: {
      const uint8_t* top = dst - BPS;
      const uint8_t vals[4] = {avg3(top[-1], top[0], top[1]), avg3(top[0], top[1], top[2]),
                               avg3(top[1], top[2], top[3]), avg3(top[2], top[3], top[4])};
      for (int i = 0; i < 4; ++i) std::memcpy(dst + i * BPS, vals, 4);
      break;
    }
    case B_HE_PRED: {
      const int A = dst[-1 - BPS], B = dst[-1], C = dst[-1 + BPS], D = dst[-1 + 2 * BPS],
                E = dst[-1 + 3 * BPS];
      std::memset(dst + 0 * BPS, avg3(A, B, C), 4);
      std::memset(dst + 1 * BPS, avg3(B, C, D), 4);
      std::memset(dst + 2 * BPS, avg3(C, D, E), 4);
      std::memset(dst + 3 * BPS, avg3(D, E, E), 4);
      break;
    }
    case B_RD_PRED: {
      const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS], K = dst[-1 + 2 * BPS],
                L = dst[-1 + 3 * BPS], X = dst[-1 - BPS], A = dst[0 - BPS], B = dst[1 - BPS],
                C = dst[2 - BPS], D = dst[3 - BPS];
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    }
    case B_LD_PRED: {
      const int A = dst[0 - BPS], B = dst[1 - BPS], C = dst[2 - BPS], D = dst[3 - BPS],
                E = dst[4 - BPS], F = dst[5 - BPS], G = dst[6 - BPS], H = dst[7 - BPS];
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    }
    case B_VR_PRED: {
      const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS], K = dst[-1 + 2 * BPS],
                X = dst[-1 - BPS], A = dst[0 - BPS], B = dst[1 - BPS], C = dst[2 - BPS],
                D = dst[3 - BPS];
      DST(0, 0) = DST(1, 2) = avg2(X, A);
      DST(1, 0) = DST(2, 2) = avg2(A, B);
      DST(2, 0) = DST(3, 2) = avg2(B, C);
      DST(3, 0) = avg2(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      break;
    }
    case B_VL_PRED: {
      const int A = dst[0 - BPS], B = dst[1 - BPS], C = dst[2 - BPS], D = dst[3 - BPS],
                E = dst[4 - BPS], F = dst[5 - BPS], G = dst[6 - BPS], H = dst[7 - BPS];
      DST(0, 0) = avg2(A, B);
      DST(1, 0) = DST(0, 2) = avg2(B, C);
      DST(2, 0) = DST(1, 2) = avg2(C, D);
      DST(3, 0) = DST(2, 2) = avg2(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      break;
    }
    case B_HD_PRED: {
      const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS], K = dst[-1 + 2 * BPS],
                L = dst[-1 + 3 * BPS], X = dst[-1 - BPS], A = dst[0 - BPS], B = dst[1 - BPS],
                C = dst[2 - BPS];
      DST(0, 0) = DST(2, 1) = avg2(I, X);
      DST(0, 1) = DST(2, 2) = avg2(J, I);
      DST(0, 2) = DST(2, 3) = avg2(K, J);
      DST(0, 3) = avg2(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = avg3(K, J, I);
      DST(1, 3) = avg3(L, K, J);
      break;
    }
    default: {  // B_HU_PRED
      const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS], K = dst[-1 + 2 * BPS],
                L = dst[-1 + 3 * BPS];
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) =
          static_cast<uint8_t>(L);
      break;
    }
  }
}

#undef DST

// loop filters (dsp/dec.c), on a plane of stride ``stride``
inline void do_filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = static_cast<uint8_t>(clip_pixel(p0 + a2));
  p[0] = static_cast<uint8_t>(clip_pixel(q0 - a1));
}

inline void do_filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = static_cast<uint8_t>(clip_pixel(p1 + a3));
  p[-step] = static_cast<uint8_t>(clip_pixel(p0 + a2));
  p[0] = static_cast<uint8_t>(clip_pixel(q0 - a1));
  p[step] = static_cast<uint8_t>(clip_pixel(q1 - a3));
}

inline void do_filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = static_cast<uint8_t>(clip_pixel(p2 + a3));
  p[-2 * step] = static_cast<uint8_t>(clip_pixel(p1 + a2));
  p[-step] = static_cast<uint8_t>(clip_pixel(p0 + a1));
  p[0] = static_cast<uint8_t>(clip_pixel(q0 - a1));
  p[step] = static_cast<uint8_t>(clip_pixel(q1 - a2));
  p[2 * step] = static_cast<uint8_t>(clip_pixel(q2 - a3));
}

inline bool hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
}

inline bool needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * std::abs(p0 - q0) + std::abs(p1 - q1) <= t;
}

inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
  const int p0 = p[-step], q0 = p[0];
  const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it && std::abs(p1 - p0) <= it &&
         std::abs(q3 - q2) <= it && std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

// simple filter: the edge across ``hstride`` at 16 points ``vstride`` apart
void simple_filter16(uint8_t* p, int hstride, int vstride, int thresh) {
  const int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i) {
    if (needs_filter(p + i * vstride, hstride, thresh2)) do_filter2(p + i * vstride, hstride);
  }
}

void filter_loop26(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh,
                   int hev_thresh) {
  const int thresh2 = 2 * thresh + 1;
  while (size-- > 0) {
    if (needs_filter2(p, hstride, thresh2, ithresh)) {
      if (hev(p, hstride, hev_thresh)) {
        do_filter2(p, hstride);
      } else {
        do_filter6(p, hstride);
      }
    }
    p += vstride;
  }
}

void filter_loop24(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh,
                   int hev_thresh) {
  const int thresh2 = 2 * thresh + 1;
  while (size-- > 0) {
    if (needs_filter2(p, hstride, thresh2, ithresh)) {
      if (hev(p, hstride, hev_thresh)) {
        do_filter2(p, hstride);
      } else {
        do_filter4(p, hstride);
      }
    }
    p += vstride;
  }
}

struct FInfo {
  int limit = 0;  // 0: no filtering
  int ilevel = 0;
  int inner = 0;
  int hev_thresh = 0;
};

struct MBData {
  int16_t coeffs[384];
  uint8_t is_i4x4 = 0;
  uint8_t imodes[16] = {0};
  uint8_t uvmode = 0;
  uint8_t segment = 0;
  uint8_t skip = 0;
  uint32_t non_zero_y = 0;
  uint32_t non_zero_uv = 0;
};

// The planes of a decoded VP8 frame: macroblock-aligned, filtered.
struct Planes {
  int width = 0, height = 0;
  int y_stride = 0, uv_stride = 0;
  std::vector<uint8_t> y, u, v;
};

class Vp8Decoder {
 public:
  Vp8Decoder(const uint8_t* data, size_t size, int64_t* info) : data_(data), size_(size), info_(info) {}

  void decode(Planes& out) {
    get_headers();
    out.width = width_;
    out.height = height_;
    out.y_stride = mb_w_ * 16;
    out.uv_stride = mb_w_ * 8;
    out.y.assign(static_cast<size_t>(out.y_stride) * mb_h_ * 16, 0);
    out.u.assign(static_cast<size_t>(out.uv_stride) * mb_h_ * 8, 0);
    out.v.assign(static_cast<size_t>(out.uv_stride) * mb_h_ * 8, 0);
    planes_ = &out;
    parse_frame();
    if (filter_type_ > 0) filter_frame();
  }

 private:
  void get_headers() {
    const uint8_t* buf = data_;
    size_t buf_size = size_;
    if (buf_size < 4) refuse("VP8: truncated header");
    const uint32_t bits = buf[0] | (buf[1] << 8) | (buf[2] << 16);
    const bool key_frame = !(bits & 1);
    const int profile = (bits >> 1) & 7;
    const int show = (bits >> 4) & 1;
    const uint32_t partition_length = bits >> 5;
    if (profile > 3) refuse("VP8: incorrect keyframe parameters");
    if (!show) refuse("VP8: frame not displayable");
    buf += 3;
    buf_size -= 3;
    if (!key_frame) refuse("VP8: not a key frame");
    if (buf_size < 7) refuse("VP8: cannot parse picture header");
    if (buf[0] != 0x9d || buf[1] != 0x01 || buf[2] != 0x2a) refuse("VP8: bad code word");
    width_ = ((buf[4] << 8) | buf[3]) & 0x3fff;
    height_ = ((buf[6] << 8) | buf[5]) & 0x3fff;
    buf += 7;
    buf_size -= 7;
    mb_w_ = (width_ + 15) >> 4;
    mb_h_ = (height_ + 15) >> 4;
    std::memset(segments_proba_, 255, sizeof(segments_proba_));
    if (partition_length > buf_size) refuse("VP8: bad partition length");
    br_.init(buf, partition_length);
    buf += partition_length;
    buf_size -= partition_length;

    br_.get_value(1);  // colour space
    br_.get_value(1);  // clamping type
    // segment header
    use_segment_ = br_.get_value(1);
    if (use_segment_) {
      update_map_ = br_.get_value(1);
      if (br_.get_value(1)) {  // update data
        absolute_delta_ = br_.get_value(1);
        for (int s = 0; s < 4; ++s) quantizer_[s] = br_.get_value(1) ? br_.get_signed_value(7) : 0;
        for (int s = 0; s < 4; ++s)
          filter_strength_[s] = br_.get_value(1) ? br_.get_signed_value(6) : 0;
      }
      if (update_map_) {
        for (int s = 0; s < 3; ++s)
          segments_proba_[s] = static_cast<uint8_t>(br_.get_value(1) ? br_.get_value(8) : 255u);
      }
    } else {
      update_map_ = 0;
    }
    if (br_.eof()) refuse("VP8: cannot parse segment header");
    // filter header
    simple_ = br_.get_value(1);
    level_ = static_cast<int>(br_.get_value(6));
    sharpness_ = static_cast<int>(br_.get_value(3));
    use_lf_delta_ = br_.get_value(1);
    if (use_lf_delta_) {
      if (br_.get_value(1)) {
        for (int i = 0; i < 4; ++i)
          if (br_.get_value(1)) ref_lf_delta_[i] = br_.get_signed_value(6);
        for (int i = 0; i < 4; ++i)
          if (br_.get_value(1)) mode_lf_delta_[i] = br_.get_signed_value(6);
      }
    }
    filter_type_ = (level_ == 0) ? 0 : simple_ ? 1 : 2;
    if (br_.eof()) refuse("VP8: cannot parse filter header");
    // partitions
    {
      const uint8_t* sz = buf;
      const uint8_t* buf_end = buf + buf_size;
      num_parts_minus_one_ = (1 << br_.get_value(2)) - 1;
      const size_t last_part = static_cast<size_t>(num_parts_minus_one_);
      if (buf_size < 3 * last_part) refuse("VP8: cannot parse partitions");
      const uint8_t* part_start = buf + last_part * 3;
      size_t size_left = buf_size - last_part * 3;
      for (size_t p = 0; p < last_part; ++p) {
        size_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
        if (psize > size_left) psize = size_left;
        parts_[p].init(part_start, psize);
        part_start += psize;
        size_left -= psize;
        sz += 3;
      }
      parts_[last_part].init(part_start, size_left);
      if (!(part_start < buf_end)) refuse("VP8: cannot parse partitions");
    }
    parse_quant();
    br_.get_value(1);  // update_proba, ignored
    parse_proba();
    precompute_filter_strengths();
    if (info_ != nullptr) {
      info_[kInfoPartitions] = num_parts_minus_one_ + 1;
      info_[kInfoFilterType] = filter_type_;
      info_[kInfoSegments] = use_segment_ ? (update_map_ ? 2 : 1) : 0;
      info_[kInfoSkipProba] = use_skip_proba_;
    }
  }

  static int clip(int v, int m) { return v < 0 ? 0 : v > m ? m : v; }

  void parse_quant() {
    const int base_q0 = static_cast<int>(br_.get_value(7));
    const int dqy1_dc = br_.get_value(1) ? br_.get_signed_value(4) : 0;
    const int dqy2_dc = br_.get_value(1) ? br_.get_signed_value(4) : 0;
    const int dqy2_ac = br_.get_value(1) ? br_.get_signed_value(4) : 0;
    const int dquv_dc = br_.get_value(1) ? br_.get_signed_value(4) : 0;
    const int dquv_ac = br_.get_value(1) ? br_.get_signed_value(4) : 0;
    for (int i = 0; i < 4; ++i) {
      int q;
      if (use_segment_) {
        q = quantizer_[i];
        if (!absolute_delta_) q += base_q0;
      } else {
        if (i > 0) {
          std::memcpy(dqm_[i], dqm_[0], sizeof(dqm_[0]));
          continue;
        }
        q = base_q0;
      }
      int* m = dqm_[i];  // y1 dc, y1 ac, y2 dc, y2 ac, uv dc, uv ac
      m[0] = kDcTable[clip(q + dqy1_dc, 127)];
      m[1] = kAcTable[clip(q + 0, 127)];
      m[2] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
      m[3] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;  // x * 155 / 100
      if (m[3] < 8) m[3] = 8;
      m[4] = kDcTable[clip(q + dquv_dc, 117)];
      m[5] = kAcTable[clip(q + dquv_ac, 127)];
    }
  }

  void parse_proba() {
    for (int t = 0; t < 4; ++t)
      for (int b = 0; b < 8; ++b)
        for (int c = 0; c < 3; ++c)
          for (int p = 0; p < 11; ++p) {
            const int v = br_.get_bit(kCoeffsUpdateProba[t][b][c][p])
                              ? static_cast<int>(br_.get_value(8))
                              : kCoeffsProba0[t][b][c][p];
            proba_[t][b][c][p] = static_cast<uint8_t>(v);
          }
    use_skip_proba_ = br_.get_value(1);
    if (use_skip_proba_) skip_p_ = static_cast<int>(br_.get_value(8));
  }

  void precompute_filter_strengths() {
    if (filter_type_ == 0) return;
    for (int s = 0; s < 4; ++s) {
      int base_level;
      if (use_segment_) {
        base_level = filter_strength_[s];
        if (!absolute_delta_) base_level += level_;
      } else {
        base_level = level_;
      }
      for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
        FInfo& info = fstrengths_[s][i4x4];
        int level = base_level;
        if (use_lf_delta_) {
          level += ref_lf_delta_[0];
          if (i4x4) level += mode_lf_delta_[0];
        }
        level = (level < 0) ? 0 : (level > 63) ? 63 : level;
        if (level > 0) {
          int ilevel = level;
          if (sharpness_ > 0) {
            if (sharpness_ > 4) {
              ilevel >>= 2;
            } else {
              ilevel >>= 1;
            }
            if (ilevel > 9 - sharpness_) ilevel = 9 - sharpness_;
          }
          if (ilevel < 1) ilevel = 1;
          info.ilevel = ilevel;
          info.limit = 2 * level + ilevel;
          info.hev_thresh = (level >= 40) ? 2 : (level >= 15) ? 1 : 0;
        } else {
          info.limit = 0;
        }
        info.inner = i4x4;
      }
    }
  }

  void parse_intra_mode(int mb_x, MBData& block) {
    uint8_t* const top = intra_t_.data() + 4 * mb_x;
    uint8_t* const left = intra_l_;
    if (update_map_) {
      block.segment = static_cast<uint8_t>(
          !br_.get_bit(segments_proba_[0]) ? br_.get_bit(segments_proba_[1])
                                           : br_.get_bit(segments_proba_[2]) + 2);
    } else {
      block.segment = 0;
    }
    if (use_skip_proba_) block.skip = static_cast<uint8_t>(br_.get_bit(skip_p_));
    block.is_i4x4 = static_cast<uint8_t>(!br_.get_bit(145));
    if (!block.is_i4x4) {
      const int ymode = br_.get_bit(156) ? (br_.get_bit(128) ? TM_PRED : H_PRED)
                                         : (br_.get_bit(163) ? V_PRED : DC_PRED);
      block.imodes[0] = static_cast<uint8_t>(ymode);
      std::memset(top, ymode, 4);
      std::memset(left, ymode, 4);
    } else {
      uint8_t* modes = block.imodes;
      for (int y = 0; y < 4; ++y) {
        int ymode = left[y];
        for (int x = 0; x < 4; ++x) {
          const uint8_t* const prob = kBModesProba[top[x]][ymode];
          int i = kYModesIntra4[br_.get_bit(prob[0])];
          while (i > 0) i = kYModesIntra4[2 * i + br_.get_bit(prob[i])];
          ymode = -i;
          top[x] = static_cast<uint8_t>(ymode);
        }
        std::memcpy(modes, top, 4);
        modes += 4;
        left[y] = static_cast<uint8_t>(ymode);
      }
      ++n_intra4_;
    }
    block.uvmode = static_cast<uint8_t>(!br_.get_bit(142)   ? DC_PRED
                                        : !br_.get_bit(114) ? V_PRED
                                        : br_.get_bit(183)  ? TM_PRED
                                                            : H_PRED);
  }

  int get_large_value(BoolReader& br, const uint8_t* p) {
    int v;
    if (!br.get_bit(p[3])) {
      if (!br.get_bit(p[4])) {
        v = 2;
      } else {
        v = 3 + br.get_bit(p[5]);
      }
    } else {
      if (!br.get_bit(p[6])) {
        if (!br.get_bit(p[7])) {
          v = 5 + br.get_bit(159);
        } else {
          v = 7 + 2 * br.get_bit(165);
          v += br.get_bit(145);
        }
      } else {
        const int bit1 = br.get_bit(p[8]);
        const int bit0 = br.get_bit(p[9 + bit1]);
        const int cat = 2 * bit1 + bit0;
        v = 0;
        for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br.get_bit(*tab);
        v += 3 + (8 << cat);
      }
    }
    return v;
  }

  // GetCoeffs: returns the position after the last coefficient read
  int get_coeffs(BoolReader& br, int type, int ctx, int dc_q, int ac_q, int n, int16_t* out) {
    const uint8_t* p = proba_[type][kBands[n]][ctx];
    for (; n < 16; ++n) {
      if (!br.get_bit(p[0])) return n;
      while (!br.get_bit(p[1])) {
        ++n;
        if (n == 16) return 16;
        p = proba_[type][kBands[n]][0];
      }
      const uint8_t(*p_ctx)[11] = proba_[type][kBands[n + 1]];
      int v;
      if (!br.get_bit(p[2])) {
        v = 1;
        p = p_ctx[1];
      } else {
        v = get_large_value(br, p);
        p = p_ctx[2];
      }
      out[kZigzag[n]] = static_cast<int16_t>(br.get_signed(v) * (n > 0 ? ac_q : dc_q));
    }
    return 16;
  }

  static uint32_t nz_code_bits(uint32_t nz_coeffs, int nz, int dc_nz) {
    nz_coeffs <<= 2;
    nz_coeffs |= (nz > 3) ? 3 : (nz > 1) ? 2 : dc_nz;
    return nz_coeffs;
  }

  // ParseResiduals: returns whether the macroblock has no coefficient
  bool parse_residuals(int mb_x, MBData& block, BoolReader& token_br) {
    const int* q = dqm_[block.segment];
    int16_t* dst = block.coeffs;
    uint8_t& mb_nz = nz_[mb_x + 1];
    uint8_t& mb_nz_dc = nz_dc_[mb_x + 1];
    uint8_t& left_nz = nz_[0];
    uint8_t& left_nz_dc = nz_dc_[0];
    uint32_t non_zero_y = 0, non_zero_uv = 0;
    int first, ac_type;
    std::memset(dst, 0, 384 * sizeof(*dst));
    if (!block.is_i4x4) {  // the DCs through the WHT
      int16_t dc[16] = {0};
      const int ctx = mb_nz_dc + left_nz_dc;
      const int nz = get_coeffs(token_br, 1, ctx, q[2], q[3], 0, dc);
      mb_nz_dc = left_nz_dc = static_cast<uint8_t>(nz > 0);
      if (nz > 1) {
        transform_wht(dc, dst);
      } else {
        const int dc0 = (dc[0] + 3) >> 3;
        for (int i = 0; i < 16 * 16; i += 16) dst[i] = static_cast<int16_t>(dc0);
      }
      first = 1;
      ac_type = 0;
    } else {
      first = 0;
      ac_type = 3;
    }
    uint8_t tnz = mb_nz & 0x0f;
    uint8_t lnz = left_nz & 0x0f;
    for (int y = 0; y < 4; ++y) {
      int l = lnz & 1;
      uint32_t nz_coeffs = 0;
      for (int x = 0; x < 4; ++x) {
        const int ctx = l + (tnz & 1);
        const int nz = get_coeffs(token_br, ac_type, ctx, q[0], q[1], first, dst);
        l = (nz > first);
        tnz = static_cast<uint8_t>((tnz >> 1) | (l << 7));
        nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
        dst += 16;
      }
      tnz >>= 4;
      lnz = static_cast<uint8_t>((lnz >> 1) | (l << 7));
      non_zero_y = (non_zero_y << 8) | nz_coeffs;
    }
    uint32_t out_t_nz = tnz;
    uint32_t out_l_nz = lnz >> 4;
    for (int ch = 0; ch < 4; ch += 2) {
      uint32_t nz_coeffs = 0;
      tnz = static_cast<uint8_t>(mb_nz >> (4 + ch));
      lnz = static_cast<uint8_t>(left_nz >> (4 + ch));
      for (int y = 0; y < 2; ++y) {
        int l = lnz & 1;
        for (int x = 0; x < 2; ++x) {
          const int ctx = l + (tnz & 1);
          const int nz = get_coeffs(token_br, 2, ctx, q[4], q[5], 0, dst);
          l = (nz > 0);
          tnz = static_cast<uint8_t>((tnz >> 1) | (l << 3));
          nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
          dst += 16;
        }
        tnz >>= 2;
        lnz = static_cast<uint8_t>((lnz >> 1) | (l << 5));
      }
      non_zero_uv |= nz_coeffs << (4 * ch);
      out_t_nz |= static_cast<uint32_t>(tnz << 4) << ch;
      out_l_nz |= static_cast<uint32_t>(lnz & 0xf0) << ch;
    }
    mb_nz = static_cast<uint8_t>(out_t_nz);
    left_nz = static_cast<uint8_t>(out_l_nz);
    block.non_zero_y = non_zero_y;
    block.non_zero_uv = non_zero_uv;
    return !(non_zero_y | non_zero_uv);
  }

  void decode_mb(int mb_x, int mb_y, MBData& block, BoolReader& token_br) {
    int skip = use_skip_proba_ ? block.skip : 0;
    if (!skip) {
      skip = parse_residuals(mb_x, block, token_br);
    } else {
      nz_[0] = nz_[mb_x + 1] = 0;
      if (!block.is_i4x4) nz_dc_[0] = nz_dc_[mb_x + 1] = 0;
      block.non_zero_y = 0;
      block.non_zero_uv = 0;
    }
    if (filter_type_ > 0) {
      FInfo& finfo = finfo_[static_cast<size_t>(mb_y) * mb_w_ + mb_x];
      finfo = fstrengths_[block.segment][block.is_i4x4];
      finfo.inner |= !skip;
    }
    if (token_br.eof()) refuse("VP8: premature end of file");
  }

  static int check_mode(int mb_x, int mb_y, int mode) {
    if (mode == B_DC_PRED) {
      if (mb_x == 0) return (mb_y == 0) ? B_DC_PRED_NOTOPLEFT : B_DC_PRED_NOLEFT;
      return (mb_y == 0) ? B_DC_PRED_NOTOP : B_DC_PRED;
    }
    return mode;
  }

  void reconstruct_row(int mb_y) {
    uint8_t* const y_dst = yuv_b_ + Y_OFF;
    uint8_t* const u_dst = yuv_b_ + U_OFF;
    uint8_t* const v_dst = yuv_b_ + V_OFF;
    for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = 129;
    for (int j = 0; j < 8; ++j) {
      u_dst[j * BPS - 1] = 129;
      v_dst[j * BPS - 1] = 129;
    }
    if (mb_y > 0) {
      y_dst[-1 - BPS] = u_dst[-1 - BPS] = v_dst[-1 - BPS] = 129;
    } else {
      std::memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
      std::memset(u_dst - BPS - 1, 127, 8 + 1);
      std::memset(v_dst - BPS - 1, 127, 8 + 1);
    }
    for (int mb_x = 0; mb_x < mb_w_; ++mb_x) {
      const MBData& block = mb_data_[mb_x];
      if (mb_x > 0) {
        for (int j = -1; j < 16; ++j) std::memcpy(&y_dst[j * BPS - 4], &y_dst[j * BPS + 12], 4);
        for (int j = -1; j < 8; ++j) {
          std::memcpy(&u_dst[j * BPS - 4], &u_dst[j * BPS + 4], 4);
          std::memcpy(&v_dst[j * BPS - 4], &v_dst[j * BPS + 4], 4);
        }
      }
      uint8_t* const top_y = &top_y_[static_cast<size_t>(mb_x) * 16];
      uint8_t* const top_u = &top_u_[static_cast<size_t>(mb_x) * 8];
      uint8_t* const top_v = &top_v_[static_cast<size_t>(mb_x) * 8];
      const int16_t* const coeffs = block.coeffs;
      uint32_t bits = block.non_zero_y;
      if (mb_y > 0) {
        std::memcpy(y_dst - BPS, top_y, 16);
        std::memcpy(u_dst - BPS, top_u, 8);
        std::memcpy(v_dst - BPS, top_v, 8);
      }
      if (block.is_i4x4) {
        uint8_t* const top_right = y_dst - BPS + 16;
        if (mb_y > 0) {
          if (mb_x >= mb_w_ - 1) {
            std::memset(top_right, top_y[15], 4);
          } else {
            std::memcpy(top_right, top_y + 16, 4);
          }
        }
        std::memcpy(top_right + 4 * BPS, top_right, 4);
        std::memcpy(top_right + 8 * BPS, top_right, 4);
        std::memcpy(top_right + 12 * BPS, top_right, 4);
        for (int n = 0; n < 16; ++n, bits <<= 2) {
          uint8_t* const dst = y_dst + kScan[n];
          pred_luma4(block.imodes[n], dst);
          do_transform(bits, coeffs + n * 16, dst);
        }
      } else {
        pred_luma16(check_mode(mb_x, mb_y, block.imodes[0]), y_dst);
        if (bits != 0) {
          for (int n = 0; n < 16; ++n, bits <<= 2) do_transform(bits, coeffs + n * 16, y_dst + kScan[n]);
        }
      }
      {
        const uint32_t bits_uv = block.non_zero_uv;
        const int pred = check_mode(mb_x, mb_y, block.uvmode);
        pred_chroma8(pred, u_dst);
        pred_chroma8(pred, v_dst);
        do_uv_transform(bits_uv >> 0, coeffs + 16 * 16, u_dst);
        do_uv_transform(bits_uv >> 8, coeffs + 20 * 16, v_dst);
      }
      if (mb_y < mb_h_ - 1) {
        std::memcpy(top_y, y_dst + 15 * BPS, 16);
        std::memcpy(top_u, u_dst + 7 * BPS, 8);
        std::memcpy(top_v, v_dst + 7 * BPS, 8);
      }
      Planes& pl = *planes_;
      for (int j = 0; j < 16; ++j)
        std::memcpy(&pl.y[static_cast<size_t>(mb_y * 16 + j) * pl.y_stride + mb_x * 16],
                    y_dst + j * BPS, 16);
      for (int j = 0; j < 8; ++j) {
        const size_t o = static_cast<size_t>(mb_y * 8 + j) * pl.uv_stride + mb_x * 8;
        std::memcpy(&pl.u[o], u_dst + j * BPS, 8);
        std::memcpy(&pl.v[o], v_dst + j * BPS, 8);
      }
    }
  }

  void parse_frame() {
    intra_t_.assign(static_cast<size_t>(4) * mb_w_, B_DC_PRED);
    nz_.assign(static_cast<size_t>(mb_w_) + 1, 0);
    nz_dc_.assign(static_cast<size_t>(mb_w_) + 1, 0);
    mb_data_.assign(static_cast<size_t>(mb_w_), MBData());
    top_y_.assign(static_cast<size_t>(mb_w_) * 16 + 4, 0);
    top_u_.assign(static_cast<size_t>(mb_w_) * 8, 0);
    top_v_.assign(static_cast<size_t>(mb_w_) * 8, 0);
    if (filter_type_ > 0) finfo_.assign(static_cast<size_t>(mb_w_) * mb_h_, FInfo());
    std::memset(yuv_b_, 0, sizeof(yuv_b_));
    std::memset(intra_l_, B_DC_PRED, sizeof(intra_l_));
    for (int mb_y = 0; mb_y < mb_h_; ++mb_y) {
      BoolReader& token_br = parts_[mb_y & num_parts_minus_one_];
      for (int mb_x = 0; mb_x < mb_w_; ++mb_x) parse_intra_mode(mb_x, mb_data_[mb_x]);
      if (br_.eof()) refuse("VP8: premature end of partition 0");
      for (int mb_x = 0; mb_x < mb_w_; ++mb_x) decode_mb(mb_x, mb_y, mb_data_[mb_x], token_br);
      nz_[0] = 0;
      nz_dc_[0] = 0;
      std::memset(intra_l_, B_DC_PRED, sizeof(intra_l_));
      reconstruct_row(mb_y);
    }
    if (info_ != nullptr) info_[kInfoIntra4] = n_intra4_;
  }

  void filter_mb(int mb_x, int mb_y) {
    const FInfo& f = finfo_[static_cast<size_t>(mb_y) * mb_w_ + mb_x];
    const int ilevel = f.ilevel;
    const int limit = f.limit;
    if (limit == 0) return;
    Planes& pl = *planes_;
    const int ys = pl.y_stride;
    uint8_t* const y_dst = &pl.y[static_cast<size_t>(mb_y) * 16 * ys + mb_x * 16];
    if (filter_type_ == 1) {  // simple
      if (mb_x > 0) simple_filter16(y_dst, 1, ys, limit + 4);
      if (f.inner)
        for (int k = 1; k <= 3; ++k) simple_filter16(y_dst + 4 * k, 1, ys, limit);
      if (mb_y > 0) simple_filter16(y_dst, ys, 1, limit + 4);
      if (f.inner)
        for (int k = 1; k <= 3; ++k) simple_filter16(y_dst + 4 * k * ys, ys, 1, limit);
    } else {  // normal
      const int uvs = pl.uv_stride;
      const size_t uv_off = static_cast<size_t>(mb_y) * 8 * uvs + mb_x * 8;
      uint8_t* const u_dst = &pl.u[uv_off];
      uint8_t* const v_dst = &pl.v[uv_off];
      const int hev_thresh = f.hev_thresh;
      if (mb_x > 0) {
        filter_loop26(y_dst, 1, ys, 16, limit + 4, ilevel, hev_thresh);
        filter_loop26(u_dst, 1, uvs, 8, limit + 4, ilevel, hev_thresh);
        filter_loop26(v_dst, 1, uvs, 8, limit + 4, ilevel, hev_thresh);
      }
      if (f.inner) {
        for (int k = 1; k <= 3; ++k) filter_loop24(y_dst + 4 * k, 1, ys, 16, limit, ilevel, hev_thresh);
        filter_loop24(u_dst + 4, 1, uvs, 8, limit, ilevel, hev_thresh);
        filter_loop24(v_dst + 4, 1, uvs, 8, limit, ilevel, hev_thresh);
      }
      if (mb_y > 0) {
        filter_loop26(y_dst, ys, 1, 16, limit + 4, ilevel, hev_thresh);
        filter_loop26(u_dst, uvs, 1, 8, limit + 4, ilevel, hev_thresh);
        filter_loop26(v_dst, uvs, 1, 8, limit + 4, ilevel, hev_thresh);
      }
      if (f.inner) {
        for (int k = 1; k <= 3; ++k)
          filter_loop24(y_dst + 4 * k * ys, ys, 1, 16, limit, ilevel, hev_thresh);
        filter_loop24(u_dst + 4 * uvs, uvs, 1, 8, limit, ilevel, hev_thresh);
        filter_loop24(v_dst + 4 * uvs, uvs, 1, 8, limit, ilevel, hev_thresh);
      }
    }
  }

  void filter_frame() {
    for (int mb_y = 0; mb_y < mb_h_; ++mb_y)
      for (int mb_x = 0; mb_x < mb_w_; ++mb_x) filter_mb(mb_x, mb_y);
  }

  const uint8_t* data_;
  size_t size_;
  int64_t* info_;
  Planes* planes_ = nullptr;
  int width_ = 0, height_ = 0, mb_w_ = 0, mb_h_ = 0;
  BoolReader br_;
  BoolReader parts_[8];
  int num_parts_minus_one_ = 0;
  uint32_t use_segment_ = 0, update_map_ = 0, absolute_delta_ = 1;
  int quantizer_[4] = {0}, filter_strength_[4] = {0};
  uint8_t segments_proba_[3];
  uint32_t simple_ = 0, use_lf_delta_ = 0;
  int level_ = 0, sharpness_ = 0;
  int ref_lf_delta_[4] = {0}, mode_lf_delta_[4] = {0};
  int filter_type_ = 0;
  int dqm_[4][6] = {{0}};
  uint8_t proba_[4][8][3][11];
  uint32_t use_skip_proba_ = 0;
  int skip_p_ = 0;
  FInfo fstrengths_[4][2];
  std::vector<uint8_t> intra_t_;
  uint8_t intra_l_[4];
  std::vector<uint8_t> nz_, nz_dc_;  // index 0: the left macroblock
  std::vector<MBData> mb_data_;
  std::vector<uint8_t> top_y_, top_u_, top_v_;
  std::vector<FInfo> finfo_;
  uint8_t yuv_b_[YUV_SIZE];
  int64_t n_intra4_ = 0;
};

// YUV -> RGB (dsp/yuv.h), 14-bit fixed point
inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline int yuv_clip8(int v) { return ((v & ~16383) == 0) ? (v >> 6) : (v < 0) ? 0 : 255; }
inline void yuv_to_rgb(int y, int u, int v, uint8_t* rgb) {
  rgb[0] = static_cast<uint8_t>(yuv_clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234));
  rgb[1] = static_cast<uint8_t>(
      yuv_clip8(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708));
  rgb[2] = static_cast<uint8_t>(yuv_clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685));
}

// The fancy upsampler's line pair (dsp/upsampling.c UPSAMPLE_FUNC), per
// channel: u and v are packed into one word there, and this equals it.
void upsample_pair(const uint8_t* top_y, const uint8_t* bottom_y, const uint8_t* top_u,
                   const uint8_t* top_v, const uint8_t* cur_u, const uint8_t* cur_v,
                   uint8_t* top_dst, uint8_t* bottom_dst, int len, int xstep) {
  const int last_pixel_pair = (len - 1) >> 1;
  int tl_u = top_u[0], tl_v = top_v[0];
  int l_u = cur_u[0], l_v = cur_v[0];
  yuv_to_rgb(top_y[0], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2, top_dst);
  if (bottom_y != nullptr)
    yuv_to_rgb(bottom_y[0], (3 * l_u + tl_u + 2) >> 2, (3 * l_v + tl_v + 2) >> 2, bottom_dst);
  for (int x = 1; x <= last_pixel_pair; ++x) {
    const int t_u = top_u[x], t_v = top_v[x];
    const int u = cur_u[x], v = cur_v[x];
    const int avg_u = tl_u + t_u + l_u + u + 8, avg_v = tl_v + t_v + l_v + v + 8;
    const int diag_12_u = (avg_u + 2 * (t_u + l_u)) >> 3;
    const int diag_12_v = (avg_v + 2 * (t_v + l_v)) >> 3;
    const int diag_03_u = (avg_u + 2 * (tl_u + u)) >> 3;
    const int diag_03_v = (avg_v + 2 * (tl_v + v)) >> 3;
    yuv_to_rgb(top_y[2 * x - 1], (diag_12_u + tl_u) >> 1, (diag_12_v + tl_v) >> 1,
               top_dst + (2 * x - 1) * xstep);
    yuv_to_rgb(top_y[2 * x], (diag_03_u + t_u) >> 1, (diag_03_v + t_v) >> 1,
               top_dst + (2 * x) * xstep);
    if (bottom_y != nullptr) {
      yuv_to_rgb(bottom_y[2 * x - 1], (diag_03_u + l_u) >> 1, (diag_03_v + l_v) >> 1,
                 bottom_dst + (2 * x - 1) * xstep);
      yuv_to_rgb(bottom_y[2 * x], (diag_12_u + u) >> 1, (diag_12_v + v) >> 1,
                 bottom_dst + (2 * x) * xstep);
    }
    tl_u = t_u;
    tl_v = t_v;
    l_u = u;
    l_v = v;
  }
  if (!(len & 1)) {
    yuv_to_rgb(top_y[len - 1], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2,
               top_dst + (len - 1) * xstep);
    if (bottom_y != nullptr)
      yuv_to_rgb(bottom_y[len - 1], (3 * l_u + tl_u + 2) >> 2, (3 * l_v + tl_v + 2) >> 2,
                 bottom_dst + (len - 1) * xstep);
  }
}

// EmitFancyRGB over the whole picture: the first row alone, then row pairs
// between chroma rows, and the last row alone when the height is even.
void planes_to_rgb(const Planes& pl, uint8_t* dst, size_t stride, int channels) {
  const int w = pl.width, h = pl.height;
  const uint8_t* y = pl.y.data();
  const uint8_t* u = pl.u.data();
  const uint8_t* v = pl.v.data();
  upsample_pair(y, nullptr, u, v, u, v, dst, nullptr, w, channels);
  int row = 0;
  for (; row + 2 < h; row += 2) {
    const uint8_t* top_u = u + static_cast<size_t>(row / 2) * pl.uv_stride;
    const uint8_t* top_v = v + static_cast<size_t>(row / 2) * pl.uv_stride;
    upsample_pair(y + static_cast<size_t>(row + 1) * pl.y_stride,
                  y + static_cast<size_t>(row + 2) * pl.y_stride, top_u, top_v,
                  top_u + pl.uv_stride, top_v + pl.uv_stride, dst + (row + 1) * stride,
                  dst + (row + 2) * stride, w, channels);
  }
  if (!(h & 1) && h > 1) {
    const uint8_t* cu = u + static_cast<size_t>(row / 2) * pl.uv_stride;
    const uint8_t* cv = v + static_cast<size_t>(row / 2) * pl.uv_stride;
    upsample_pair(y + static_cast<size_t>(row + 1) * pl.y_stride, nullptr, cu, cv, cu, cv,
                  dst + (row + 1) * stride, nullptr, w, channels);
  }
}

// ------------------------------------------------------------ VP8L lossless

// LSB-first reader; bits past the data read as zeros. libwebp's reader
// signals the end of the stream once more bits were used than the data holds
// (and than its 64-bit window, for streams under 8 bytes).
class LBitReader {
 public:
  LBitReader(const uint8_t* data, size_t len) : data_(data), len_(len) {
    limit_ = 8 * static_cast<uint64_t>(std::max<size_t>(len, 8));
  }
  uint64_t peek() const {
    const size_t byte = static_cast<size_t>(pos_ >> 3);
    uint64_t v = 0;
    if (byte + 8 <= len_) {
      std::memcpy(&v, data_ + byte, 8);
    } else {
      for (size_t i = 0; i < 8 && byte + i < len_; ++i) v |= static_cast<uint64_t>(data_[byte + i]) << (8 * i);
    }
    return v >> (pos_ & 7);
  }
  uint32_t read(int n) {
    if (n == 0) return 0;
    const uint32_t v = static_cast<uint32_t>(peek() & ((1ull << n) - 1));
    pos_ += static_cast<uint64_t>(n);
    return v;
  }
  void skip(int n) { pos_ += static_cast<uint64_t>(n); }
  bool eos() const { return pos_ > limit_; }

 private:
  const uint8_t* data_;
  size_t len_;
  uint64_t pos_ = 0;
  uint64_t limit_;
};

struct HuffmanCode {
  uint8_t bits;
  uint16_t value;
};

constexpr int kMaxCodeLength = 15;
constexpr int kHuffmanTableBits = 8;
constexpr int kNumLiteralCodes = 256;
constexpr int kNumLengthCodes = 24;
constexpr int kNumDistanceCodes = 40;
constexpr int kAlphabetSize[5] = {kNumLiteralCodes + kNumLengthCodes, 256, 256, 256,
                                  kNumDistanceCodes};
constexpr int kCodeLengthCodes = 19;
const uint8_t kCodeLengthCodeOrder[kCodeLengthCodes] = {17, 18, 0, 1,  2,  3,  4,  5,  16, 6,
                                                        7,  8,  9, 10, 11, 12, 13, 14, 15};
enum { GREEN = 0, RED = 1, BLUE = 2, ALPHA = 3, DIST = 4 };
enum { PREDICTOR_TRANSFORM = 0, CROSS_COLOR_TRANSFORM = 1, SUBTRACT_GREEN_TRANSFORM = 2,
       COLOR_INDEXING_TRANSFORM = 3 };

inline uint32_t next_key(uint32_t key, int len) {
  uint32_t step = 1u << (len - 1);
  while (key & step) step >>= 1;
  return step ? (key & (step - 1)) + step : key;
}

inline void replicate(HuffmanCode* table, int step, int end, HuffmanCode code) {
  do {
    end -= step;
    table[end] = code;
  } while (end > 0);
}

inline int next_table_bits(const int* count, int len, int root_bits) {
  int left = 1 << (len - root_bits);
  while (len < kMaxCodeLength) {
    left -= count[len];
    if (left <= 0) break;
    ++len;
    left <<= 1;
  }
  return len - root_bits;
}

// BuildHuffmanTable (utils/huffman_utils.c): fills ``table`` (when not null)
// and returns its size, or 0 for a code libwebp refuses (no symbol, an
// over- or under-subscribed tree, a length above 15).
int build_huffman(std::vector<HuffmanCode>* table, int root_bits, const int* code_lengths,
                  int code_lengths_size) {
  int count[kMaxCodeLength + 1] = {0};
  int offset[kMaxCodeLength + 1];
  for (int s = 0; s < code_lengths_size; ++s) {
    if (code_lengths[s] > kMaxCodeLength) return 0;
    ++count[code_lengths[s]];
  }
  if (count[0] == code_lengths_size) return 0;
  offset[1] = 0;
  for (int len = 1; len < kMaxCodeLength; ++len) {
    if (count[len] > (1 << len)) return 0;
    offset[len + 1] = offset[len] + count[len];
  }
  std::vector<uint16_t> sorted(static_cast<size_t>(code_lengths_size));
  for (int s = 0; s < code_lengths_size; ++s)
    if (code_lengths[s] > 0) sorted[offset[code_lengths[s]]++] = static_cast<uint16_t>(s);
  int total_size = 1 << root_bits;
  if (offset[kMaxCodeLength] == 1) {
    if (table != nullptr) {
      table->assign(static_cast<size_t>(total_size), HuffmanCode{0, sorted[0]});
    }
    return total_size;
  }
  // two passes: the first sizes the second-level tables, the second fills
  for (int pass = 0; pass < 2; ++pass) {
    const bool fill = pass == 1;
    if (fill) {
      if (table == nullptr) return total_size;
      table->assign(static_cast<size_t>(total_size), HuffmanCode{0, 0});
    }
    int cnt[kMaxCodeLength + 1];
    std::memcpy(cnt, count, sizeof(cnt));
    HuffmanCode* root = fill ? table->data() : nullptr;
    size_t tbl = 0;  // offset of the current table
    int size = 1 << root_bits;
    uint32_t low = 0xffffffffu;
    const uint32_t mask = static_cast<uint32_t>((1 << root_bits) - 1);
    uint32_t key = 0;
    int num_nodes = 1, num_open = 1;
    int table_bits = root_bits, table_size = 1 << table_bits;
    int symbol = 0;
    int step = 2;
    for (int len = 1; len <= root_bits; ++len, step <<= 1) {
      num_open <<= 1;
      num_nodes += num_open;
      num_open -= cnt[len];
      if (num_open < 0) return 0;
      for (; cnt[len] > 0; --cnt[len]) {
        if (fill) replicate(root + key, step, table_size, HuffmanCode{static_cast<uint8_t>(len), sorted[symbol]});
        ++symbol;
        key = next_key(key, len);
      }
    }
    step = 2;
    for (int len = root_bits + 1; len <= kMaxCodeLength; ++len, step <<= 1) {
      num_open <<= 1;
      num_nodes += num_open;
      num_open -= cnt[len];
      if (num_open < 0) return 0;
      for (; cnt[len] > 0; --cnt[len]) {
        if ((key & mask) != low) {
          tbl += static_cast<size_t>(table_size);
          table_bits = next_table_bits(cnt, len, root_bits);
          table_size = 1 << table_bits;
          size += table_size;
          low = key & mask;
          if (fill) {
            root[low].bits = static_cast<uint8_t>(table_bits + root_bits);
            root[low].value = static_cast<uint16_t>(tbl - low);
          }
        }
        if (fill)
          replicate(root + tbl + (key >> root_bits), step, table_size,
                    HuffmanCode{static_cast<uint8_t>(len - root_bits), sorted[symbol]});
        ++symbol;
        key = next_key(key, len);
      }
    }
    if (num_nodes != 2 * offset[kMaxCodeLength] - 1) return 0;
    total_size = size;
  }
  return total_size;
}

inline int read_symbol(const HuffmanCode* table, LBitReader& br) {
  uint64_t val = br.peek();
  table += val & ((1u << kHuffmanTableBits) - 1);
  const int nbits = table->bits - kHuffmanTableBits;
  if (nbits > 0) {
    br.skip(kHuffmanTableBits);
    val = br.peek();
    table += table->value;
    table += val & ((1u << nbits) - 1);
  }
  br.skip(table->bits);
  return table->value;
}

struct HTreeGroup {
  std::vector<HuffmanCode> trees[5];
};

struct Transform {
  int type = 0;
  int bits = 0;
  int xsize = 0, ysize = 0;
  std::vector<uint32_t> data;
};

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  const uint32_t alpha_and_green = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  const uint32_t red_and_blue = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (alpha_and_green & 0xff00ff00u) | (red_and_blue & 0x00ff00ffu);
}
inline uint32_t average2(uint32_t a0, uint32_t a1) {
  return (((a0 ^ a1) & 0xfefefefeu) >> 1) + (a0 & a1);
}
inline uint32_t clip255(uint32_t a) { return a < 256 ? a : ~a >> 24; }
inline int sub3(int a, int b, int c) { return std::abs(b - c) - std::abs(a - c); }
inline uint32_t select_pred(uint32_t a, uint32_t b, uint32_t c) {
  const int pa_minus_pb = sub3(a >> 24, b >> 24, c >> 24) +
                          sub3((a >> 16) & 0xff, (b >> 16) & 0xff, (c >> 16) & 0xff) +
                          sub3((a >> 8) & 0xff, (b >> 8) & 0xff, (c >> 8) & 0xff) +
                          sub3(a & 0xff, b & 0xff, c & 0xff);
  return (pa_minus_pb <= 0) ? a : b;
}
inline uint32_t clamped_add_subtract_full(uint32_t c0, uint32_t c1, uint32_t c2) {
  const uint32_t a = clip255((c0 >> 24) + (c1 >> 24) - (c2 >> 24));
  const uint32_t r = clip255(((c0 >> 16) & 0xff) + ((c1 >> 16) & 0xff) - ((c2 >> 16) & 0xff));
  const uint32_t g = clip255(((c0 >> 8) & 0xff) + ((c1 >> 8) & 0xff) - ((c2 >> 8) & 0xff));
  const uint32_t b = clip255((c0 & 0xff) + (c1 & 0xff) - (c2 & 0xff));
  return (a << 24) | (r << 16) | (g << 8) | b;
}
inline int add_subtract_half(int a, int b) {
  return static_cast<int>(clip255(static_cast<uint32_t>(a + (a - b) / 2)));
}
inline uint32_t clamped_add_subtract_half(uint32_t c0, uint32_t c1, uint32_t c2) {
  const uint32_t ave = average2(c0, c1);
  const int a = add_subtract_half(ave >> 24, c2 >> 24);
  const int r = add_subtract_half((ave >> 16) & 0xff, (c2 >> 16) & 0xff);
  const int g = add_subtract_half((ave >> 8) & 0xff, (c2 >> 8) & 0xff);
  const int b = add_subtract_half(ave & 0xff, c2 & 0xff);
  return (static_cast<uint32_t>(a) << 24) | (r << 16) | (g << 8) | b;
}

// VP8LPredictors: ``left`` the pixel before, ``top`` the pixel above (top[-1]
// top-left, top[1] top-right); modes 14 and 15 are libwebp's black
inline uint32_t predict(int mode, uint32_t left, const uint32_t* top) {
  switch (mode) {
    case 1: return left;
    case 2: return top[0];
    case 3: return top[1];
    case 4: return top[-1];
    case 5: return average2(average2(left, top[1]), top[0]);
    case 6: return average2(left, top[-1]);
    case 7: return average2(left, top[0]);
    case 8: return average2(top[-1], top[0]);
    case 9: return average2(top[0], top[1]);
    case 10: return average2(average2(left, top[-1]), average2(top[0], top[1]));
    case 11: return select_pred(top[0], left, top[-1]);
    case 12: return clamped_add_subtract_full(left, top[0], top[-1]);
    case 13: return clamped_add_subtract_half(left, top[0], top[-1]);
    default: return 0xff000000u;
  }
}

inline int color_transform_delta(int8_t color_pred, int8_t color) {
  return (static_cast<int>(color_pred) * color) >> 5;
}

class LosslessDecoder {
 public:
  LosslessDecoder(const uint8_t* data, size_t size, int64_t* info) : br_(data, size), info_(info) {}

  // the image of a VP8L chunk: header, then the ARGB pixels
  void decode_image(std::vector<uint32_t>& argb, int& width, int& height) {
    if (br_.read(8) != 0x2f) refuse("VP8L: bad signature");
    width = static_cast<int>(br_.read(14)) + 1;
    height = static_cast<int>(br_.read(14)) + 1;
    br_.read(1);  // alpha is used
    if (br_.read(3) != 0) refuse("VP8L: unknown version");
    if (br_.eos()) refuse("VP8L: truncated header");
    decode_level0(width, height, argb, false);
  }

  // an ALPH chunk's compressed plane: the green channel of a headerless
  // stream of the frame's size
  void decode_alpha(int width, int height, std::vector<uint8_t>& alpha) {
    std::vector<uint32_t> argb;
    decode_level0(width, height, argb, true);
    alpha.resize(argb.size());
    for (size_t i = 0; i < argb.size(); ++i) alpha[i] = static_cast<uint8_t>(argb[i] >> 8);
  }

 private:
  struct Meta {
    int cache_bits = 0;
    int huffman_bits = 0;
    int huffman_xsize = 0;
    std::vector<uint32_t> huffman_image;  // group per tile
    std::vector<HTreeGroup> groups;
  };

  void check_eos() {
    if (br_.eos()) refuse("VP8L: data ends early");
  }

  void decode_level0(int xsize, int ysize, std::vector<uint32_t>& argb, bool alpha) {
    int transform_xsize = xsize;
    while (br_.read(1)) {
      read_transform(transform_xsize, ysize);
      check_eos();
    }
    Meta hdr;
    read_color_cache_and_codes(hdr, transform_xsize, ysize, true);
    if (info_ != nullptr && !alpha) {
      info_[kInfoCacheBits] = hdr.cache_bits;
      info_[kInfoMetaCodes] = static_cast<int64_t>(hdr.groups.size());
    }
    argb.assign(static_cast<size_t>(transform_xsize) * ysize, 0);
    // libwebp's 8-bit alpha path: one colour-indexing transform, no colour
    // cache, and single-symbol red, blue and alpha codes in every group
    bool use_8b = false;
    if (alpha && transforms_.size() == 1 && transforms_[0].type == COLOR_INDEXING_TRANSFORM &&
        hdr.cache_bits == 0) {
      use_8b = true;
      for (const HTreeGroup& g : hdr.groups)
        if (g.trees[RED][0].bits > 0 || g.trees[BLUE][0].bits > 0 || g.trees[ALPHA][0].bits > 0)
          use_8b = false;
    }
    if (info_ != nullptr && alpha) info_[kInfoAlpha8b] = use_8b;
    decode_pixels(argb.data(), transform_xsize, ysize, hdr, use_8b);
    // inverse transforms, last read first
    for (size_t i = transforms_.size(); i-- > 0;) inverse_transform(transforms_[i], argb);
  }

  void read_transform(int& xsize, int ysize) {
    const int type = static_cast<int>(br_.read(2));
    if (transforms_seen_ & (1u << type)) refuse("VP8L: a transform used twice");
    transforms_seen_ |= 1u << type;
    if (info_ != nullptr) info_[kInfoTransforms] = transforms_seen_;
    Transform t;
    t.type = type;
    t.xsize = xsize;
    t.ysize = ysize;
    switch (type) {
      case PREDICTOR_TRANSFORM:
      case CROSS_COLOR_TRANSFORM:
        t.bits = static_cast<int>(br_.read(3)) + 2;
        t.data = decode_sub_image(subsample(t.xsize, t.bits), subsample(t.ysize, t.bits));
        if (type == PREDICTOR_TRANSFORM && info_ != nullptr)
          for (uint32_t m : t.data) info_[kInfoPredictorModes] |= 1 << ((m >> 8) & 0xf);
        break;
      case COLOR_INDEXING_TRANSFORM: {
        const int num_colors = static_cast<int>(br_.read(8)) + 1;
        const int bits = (num_colors > 16) ? 0 : (num_colors > 4) ? 1 : (num_colors > 2) ? 2 : 3;
        xsize = subsample(t.xsize, bits);
        t.bits = bits;
        std::vector<uint32_t> map = decode_sub_image(num_colors, 1);
        // ExpandColorMap: the entries are deltas; indices past them are 0
        const int final_num_colors = 1 << (8 >> bits);
        t.data.assign(static_cast<size_t>(final_num_colors), 0);
        uint8_t* const dst = reinterpret_cast<uint8_t*>(t.data.data());
        const uint8_t* const src = reinterpret_cast<const uint8_t*>(map.data());
        t.data[0] = map[0];
        for (int i = 4; i < 4 * num_colors; ++i) dst[i] = static_cast<uint8_t>(src[i] + dst[i - 4]);
        break;
      }
      default:  // subtract green
        break;
    }
    transforms_.push_back(std::move(t));
  }

  static int subsample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

  std::vector<uint32_t> decode_sub_image(int xsize, int ysize) {
    Meta hdr;
    read_color_cache_and_codes(hdr, xsize, ysize, false);
    std::vector<uint32_t> data(static_cast<size_t>(xsize) * ysize, 0);
    decode_pixels(data.data(), xsize, ysize, hdr, false);
    check_eos();
    return data;
  }

  void read_color_cache_and_codes(Meta& hdr, int xsize, int ysize, bool allow_recursion) {
    if (br_.read(1)) {
      hdr.cache_bits = static_cast<int>(br_.read(4));
      if (hdr.cache_bits < 1 || hdr.cache_bits > 11) refuse("VP8L: bad colour-cache size");
    }
    int num_groups_max = 1;
    if (allow_recursion && br_.read(1)) {
      hdr.huffman_bits = static_cast<int>(br_.read(3)) + 2;
      hdr.huffman_xsize = subsample(xsize, hdr.huffman_bits);
      hdr.huffman_image = decode_sub_image(hdr.huffman_xsize, subsample(ysize, hdr.huffman_bits));
      for (uint32_t& g : hdr.huffman_image) {
        g = (g >> 8) & 0xffff;
        num_groups_max = std::max(num_groups_max, static_cast<int>(g) + 1);
      }
    }
    check_eos();
    // groups no tile uses are read and checked, not kept
    std::vector<int> mapping;
    const bool map_groups =
        num_groups_max > 1000 || num_groups_max > static_cast<int64_t>(xsize) * ysize;
    int num_groups = num_groups_max;
    if (map_groups) {
      mapping.assign(static_cast<size_t>(num_groups_max), -1);
      num_groups = 0;
      for (uint32_t& g : hdr.huffman_image) {
        if (mapping[g] == -1) mapping[g] = num_groups++;
        g = static_cast<uint32_t>(mapping[g]);
      }
    }
    hdr.groups.resize(static_cast<size_t>(num_groups));
    std::vector<int> code_lengths(static_cast<size_t>(kAlphabetSize[0] + (hdr.cache_bits > 0 ? 1 << hdr.cache_bits : 0)));
    for (int i = 0; i < num_groups_max; ++i) {
      HTreeGroup* group = nullptr;
      if (!map_groups) {
        group = &hdr.groups[static_cast<size_t>(i)];
      } else if (mapping[i] != -1) {
        group = &hdr.groups[static_cast<size_t>(mapping[i])];
      }
      for (int j = 0; j < 5; ++j) {
        int alphabet_size = kAlphabetSize[j];
        if (j == 0 && hdr.cache_bits > 0) alphabet_size += 1 << hdr.cache_bits;
        read_huffman_code(alphabet_size, code_lengths.data(),
                          group != nullptr ? &group->trees[j] : nullptr);
      }
    }
  }

  void read_huffman_code(int alphabet_size, int* code_lengths, std::vector<HuffmanCode>* table) {
    std::fill(code_lengths, code_lengths + alphabet_size, 0);
    if (br_.read(1)) {  // simple code
      const int num_symbols = static_cast<int>(br_.read(1)) + 1;
      const int first_symbol_len_code = static_cast<int>(br_.read(1));
      int symbol = static_cast<int>(br_.read(first_symbol_len_code == 0 ? 1 : 8));
      code_lengths[symbol] = 1;
      if (num_symbols == 2) {
        symbol = static_cast<int>(br_.read(8));
        code_lengths[symbol] = 1;
      }
    } else {
      int code_length_code_lengths[kCodeLengthCodes] = {0};
      const int num_codes = static_cast<int>(br_.read(4)) + 4;
      for (int i = 0; i < num_codes; ++i)
        code_length_code_lengths[kCodeLengthCodeOrder[i]] = static_cast<int>(br_.read(3));
      read_code_lengths(code_length_code_lengths, alphabet_size, code_lengths);
    }
    check_eos();
    // symbols past the alphabet (an 8-bit simple symbol) are not part of it
    if (build_huffman(table, kHuffmanTableBits, code_lengths, alphabet_size) == 0)
      refuse("VP8L: invalid prefix code");
  }

  void read_code_lengths(const int* code_length_code_lengths, int num_symbols, int* code_lengths) {
    std::vector<HuffmanCode> table;
    if (build_huffman(&table, 7, code_length_code_lengths, kCodeLengthCodes) == 0)
      refuse("VP8L: invalid code-length code");
    int max_symbol;
    if (br_.read(1)) {
      const int length_nbits = 2 + 2 * static_cast<int>(br_.read(3));
      max_symbol = 2 + static_cast<int>(br_.read(length_nbits));
      if (max_symbol > num_symbols) refuse("VP8L: too many code lengths");
    } else {
      max_symbol = num_symbols;
    }
    int prev_code_len = 8;
    int symbol = 0;
    while (symbol < num_symbols) {
      if (max_symbol-- == 0) break;
      const HuffmanCode& p = table[br_.peek() & 127];
      br_.skip(p.bits);
      const int code_len = p.value;
      if (code_len < 16) {
        code_lengths[symbol++] = code_len;
        if (code_len != 0) prev_code_len = code_len;
      } else {
        static const int kExtraBits[3] = {2, 3, 7};
        static const int kRepeatOffsets[3] = {3, 3, 11};
        const int slot = code_len - 16;
        const int repeat = static_cast<int>(br_.read(kExtraBits[slot])) + kRepeatOffsets[slot];
        if (symbol + repeat > num_symbols) refuse("VP8L: code lengths run past the alphabet");
        const int length = (code_len == 16) ? prev_code_len : 0;
        for (int r = 0; r < repeat; ++r) code_lengths[symbol++] = length;
      }
    }
  }

  int copy_distance(int symbol) {
    if (symbol < 4) return symbol + 1;
    const int extra_bits = (symbol - 2) >> 1;
    const int offset = (2 + (symbol & 1)) << extra_bits;
    return offset + static_cast<int>(br_.read(extra_bits)) + 1;
  }

  static int plane_code_to_distance(int xsize, int plane_code) {
    if (plane_code > 120) return plane_code - 120;
    const int dist_code = kCodeToPlane[plane_code - 1];
    const int yoffset = dist_code >> 4;
    const int xoffset = 8 - (dist_code & 0xf);
    const int dist = yoffset * xsize + xoffset;
    return (dist >= 1) ? dist : 1;
  }

  // DecodeImageData (and DecodeAlphaData when ``alpha_8b``)
  void decode_pixels(uint32_t* data, int width, int height, const Meta& hdr, bool alpha_8b) {
    const int64_t end = static_cast<int64_t>(width) * height;
    const int len_code_limit = kNumLiteralCodes + kNumLengthCodes;
    const int color_cache_limit = len_code_limit + (hdr.cache_bits > 0 ? 1 << hdr.cache_bits : 0);
    std::vector<uint32_t> cache(hdr.cache_bits > 0 ? size_t{1} << hdr.cache_bits : 0, 0);
    const int hash_shift = 32 - hdr.cache_bits;
    const int mask = hdr.huffman_bits > 0 ? (1 << hdr.huffman_bits) - 1 : -1;
    int64_t pos = 0, last_cached = 0;
    int col = 0, row = 0;
    auto group_at = [&](int x, int y) -> const HTreeGroup& {
      if (hdr.huffman_bits == 0) return hdr.groups[0];
      const uint32_t g = hdr.huffman_image[static_cast<size_t>(y >> hdr.huffman_bits) * hdr.huffman_xsize + (x >> hdr.huffman_bits)];
      return hdr.groups[g];
    };
    auto insert_cached = [&]() {
      if (hdr.cache_bits > 0) {
        while (last_cached < pos) {
          const uint32_t argb = data[last_cached++];
          cache[(0x1e35a7bdu * argb) >> hash_shift] = argb;
        }
      }
    };
    const HTreeGroup* group = end > 0 ? &group_at(0, 0) : nullptr;
    while (pos < end) {
      if ((col & mask) == 0) group = &group_at(col, row);
      const int code = read_symbol(group->trees[GREEN].data(), br_);
      if (code < kNumLiteralCodes) {
        if (alpha_8b) {
          data[pos] = static_cast<uint32_t>(code) << 8;
        } else {
          const int red = read_symbol(group->trees[RED].data(), br_);
          const int blue = read_symbol(group->trees[BLUE].data(), br_);
          const int alpha = read_symbol(group->trees[ALPHA].data(), br_);
          if (br_.eos()) break;
          data[pos] = (static_cast<uint32_t>(alpha) << 24) | (red << 16) | (code << 8) | blue;
        }
        ++pos;
        if (++col >= width) {
          col = 0;
          ++row;
          insert_cached();
        }
      } else if (code < len_code_limit) {
        const int length = copy_distance(code - kNumLiteralCodes);
        const int dist_symbol = read_symbol(group->trees[DIST].data(), br_);
        const int dist = plane_code_to_distance(width, copy_distance(dist_symbol));
        if (!alpha_8b && br_.eos()) break;
        if (pos < dist || end - pos < length) refuse("VP8L: backward reference out of the image");
        for (int i = 0; i < length; ++i) data[pos + i] = data[pos + i - dist];
        pos += length;
        col += length;
        while (col >= width) {
          col -= width;
          ++row;
        }
        if (pos < end && (col & mask)) group = &group_at(col, row);
        insert_cached();
      } else if (code < color_cache_limit) {
        insert_cached();
        data[pos] = cache[static_cast<size_t>(code - len_code_limit)];
        ++pos;
        if (++col >= width) {
          col = 0;
          ++row;
          insert_cached();
        }
      } else {
        refuse("VP8L: invalid symbol");
      }
      if (alpha_8b && br_.eos() && pos < end) break;
    }
    // DecodeImageData refuses a stream that ran out; DecodeAlphaData only
    // one that ran out before its last pixel
    if (br_.eos() && (!alpha_8b || pos < end)) refuse("VP8L: data ends early");
  }

  void inverse_transform(const Transform& t, std::vector<uint32_t>& argb) {
    const int width = t.xsize, height = t.ysize;
    switch (t.type) {
      case SUBTRACT_GREEN_TRANSFORM:
        for (uint32_t& p : argb) {
          const uint32_t green = (p >> 8) & 0xff;
          uint32_t red_blue = p & 0x00ff00ffu;
          red_blue += (green << 16) | green;
          red_blue &= 0x00ff00ffu;
          p = (p & 0xff00ff00u) | red_blue;
        }
        break;
      case PREDICTOR_TRANSFORM: {
        uint32_t* out = argb.data();
        // the first row: black, then left
        out[0] = add_pixels(out[0], 0xff000000u);
        for (int x = 1; x < width; ++x) out[x] = add_pixels(out[x], out[x - 1]);
        const int tiles_per_row = subsample(width, t.bits);
        for (int y = 1; y < height; ++y) {
          uint32_t* const cur = out + static_cast<size_t>(y) * width;
          const uint32_t* const up = cur - width;
          const uint32_t* modes = &t.data[static_cast<size_t>(y >> t.bits) * tiles_per_row];
          cur[0] = add_pixels(cur[0], up[0]);  // the first column: top
          for (int x = 1; x < width; ++x) {
            const int mode = static_cast<int>((modes[x >> t.bits] >> 8) & 0xf);
            cur[x] = add_pixels(cur[x], predict(mode, cur[x - 1], up + x));
          }
        }
        break;
      }
      case CROSS_COLOR_TRANSFORM: {
        const int tiles_per_row = subsample(width, t.bits);
        for (int y = 0; y < height; ++y) {
          uint32_t* const cur = argb.data() + static_cast<size_t>(y) * width;
          const uint32_t* const codes = &t.data[static_cast<size_t>(y >> t.bits) * tiles_per_row];
          for (int x = 0; x < width; ++x) {
            const uint32_t code = codes[x >> t.bits];
            const int8_t green_to_red = static_cast<int8_t>(code & 0xff);
            const int8_t green_to_blue = static_cast<int8_t>((code >> 8) & 0xff);
            const int8_t red_to_blue = static_cast<int8_t>((code >> 16) & 0xff);
            const uint32_t p = cur[x];
            const int8_t green = static_cast<int8_t>(p >> 8);
            int new_red = (p >> 16) & 0xff;
            int new_blue = p & 0xff;
            new_red += color_transform_delta(green_to_red, green);
            new_red &= 0xff;
            new_blue += color_transform_delta(green_to_blue, green);
            new_blue += color_transform_delta(red_to_blue, static_cast<int8_t>(new_red));
            new_blue &= 0xff;
            cur[x] = (p & 0xff00ff00u) | (static_cast<uint32_t>(new_red) << 16) | static_cast<uint32_t>(new_blue);
          }
        }
        break;
      }
      default: {  // colour indexing, with pixels bundled when bits > 0
        const int packed_width = subsample(width, t.bits);
        std::vector<uint32_t> out(static_cast<size_t>(width) * height);
        const int bits_per_pixel = 8 >> t.bits;
        const int count_mask = (1 << t.bits) - 1;
        const uint32_t bit_mask = (1u << bits_per_pixel) - 1;
        for (int y = 0; y < height; ++y) {
          const uint32_t* src = argb.data() + static_cast<size_t>(y) * packed_width;
          uint32_t* dst = out.data() + static_cast<size_t>(y) * width;
          uint32_t packed = 0;
          for (int x = 0; x < width; ++x) {
            if ((x & count_mask) == 0) packed = (*src++ >> 8) & 0xff;
            dst[x] = t.data[packed & bit_mask];
            packed >>= bits_per_pixel;
          }
        }
        argb.swap(out);
        break;
      }
    }
  }

  LBitReader br_;
  int64_t* info_;
  uint32_t transforms_seen_ = 0;
  std::vector<Transform> transforms_;
};

// ------------------------------------------------------------------- ALPH

void unfilter_alpha(int filter, const uint8_t* deltas, uint8_t* out, int width, int height) {
  const uint8_t* prev = nullptr;
  for (int y = 0; y < height; ++y) {
    const uint8_t* in = deltas + static_cast<size_t>(y) * width;
    uint8_t* dst = out + static_cast<size_t>(y) * width;
    if (filter == 0) {
      std::memcpy(dst, in, static_cast<size_t>(width));
    } else if (filter == 1 || prev == nullptr) {  // horizontal (and every first row)
      uint8_t pred = (prev == nullptr) ? 0 : prev[0];
      for (int i = 0; i < width; ++i) {
        dst[i] = static_cast<uint8_t>(pred + in[i]);
        pred = dst[i];
      }
    } else if (filter == 2) {  // vertical
      for (int i = 0; i < width; ++i) dst[i] = static_cast<uint8_t>(prev[i] + in[i]);
    } else {  // gradient
      uint8_t top = prev[0], top_left = top, left = top;
      for (int i = 0; i < width; ++i) {
        top = prev[i];
        const int g = left + top - top_left;
        const int pred = ((g & ~0xff) == 0) ? g : (g < 0) ? 0 : 255;
        left = static_cast<uint8_t>(in[i] + pred);
        top_left = top;
        dst[i] = left;
      }
    }
    prev = dst;
  }
}

// ALPHInit + ALPHDecode: the frame's alpha plane, or a refusal
void decode_alpha_plane(const uint8_t* data, size_t size, int width, int height,
                        std::vector<uint8_t>& alpha, int64_t* info) {
  if (size <= 1) refuse("ALPH: chunk too short");
  const int method = data[0] & 0x03;
  const int filter = (data[0] >> 2) & 0x03;
  const int pre_processing = (data[0] >> 4) & 0x03;
  const int rsrv = (data[0] >> 6) & 0x03;
  if (method > 1 || pre_processing > 1 || rsrv != 0) refuse("ALPH: bad header");
  if (info != nullptr) {
    info[kInfoAlpha] = 1 + method;
    info[kInfoAlphaFilter] = filter;
  }
  const size_t n = static_cast<size_t>(width) * height;
  std::vector<uint8_t> deltas;
  if (method == 0) {
    if (size - 1 < n) refuse("ALPH: raw plane too short");
    deltas.assign(data + 1, data + 1 + n);
  } else {
    LosslessDecoder(data + 1, size - 1, info).decode_alpha(width, height, deltas);
  }
  alpha.resize(n);
  unfilter_alpha(filter, deltas.data(), alpha.data(), width, height);
}

// ------------------------------------------------------------- container

constexpr uint32_t kMaxChunkPayload = ~0u - 8 - 1;
constexpr uint64_t kMaxImageArea = 1ull << 32;
constexpr int ALPHA_FLAG = 0x10, ANIMATION_FLAG = 0x02, ICCP_FLAG = 0x20, EXIF_FLAG = 0x08,
              XMP_FLAG = 0x04;
constexpr int ALL_VALID_FLAGS = ALPHA_FLAG | ANIMATION_FLAG | EXIF_FLAG | ICCP_FLAG | XMP_FLAG;

inline uint32_t fourcc(const char* s) {
  return static_cast<uint32_t>(s[0]) | (s[1] << 8) | (s[2] << 16) | (static_cast<uint32_t>(s[3]) << 24);
}

struct ChunkData {
  size_t offset = 0, size = 0;
};

struct Frame {
  int x_offset = 0, y_offset = 0, width = 0, height = 0;
  int has_alpha = 0, frame_num = 0, complete = 0;
  ChunkData img[2];  // the image bitstream, the ALPH chunk
};

enum Parse { PARSE_OK, PARSE_NEED_MORE_DATA, PARSE_ERROR };
enum State { PARSING_HEADER = 0, PARSED_HEADER = 1, DONE = 2 };

// VP8GetInfo / VP8LGetInfo on a bitstream (after its chunk header)
bool vp8_get_info(const uint8_t* data, size_t data_size, size_t chunk_size, int* w, int* h) {
  if (data_size < 10) return false;
  if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a) return false;
  const uint32_t bits = data[0] | (data[1] << 8) | (data[2] << 16);
  const int key_frame = !(bits & 1);
  *w = ((data[7] << 8) | data[6]) & 0x3fff;
  *h = ((data[9] << 8) | data[8]) & 0x3fff;
  if (!key_frame) return false;
  if (((bits >> 1) & 7) > 3 || !((bits >> 4) & 1) || (bits >> 5) >= chunk_size) return false;
  if (*w == 0 || *h == 0) return false;
  return true;
}

bool vp8l_get_info(const uint8_t* data, size_t data_size, int* w, int* h, int* has_alpha) {
  if (data_size < 5 || data[0] != 0x2f || (data[4] >> 5) != 0) return false;
  LBitReader br(data, data_size);
  br.read(8);
  *w = static_cast<int>(br.read(14)) + 1;
  *h = static_cast<int>(br.read(14)) + 1;
  *has_alpha = static_cast<int>(br.read(1));
  if (br.read(3) != 0) return false;
  return !br.eos();
}

// ParseHeadersInternal on a run of raw chunks ([ALPH ...] VP8 or VP8L), as
// WebPGetFeatures (``all_data`` false) and WebPDecode (true) call it; the
// bitstream's place, size and dimensions.
struct Headers {
  const uint8_t* alpha_data = nullptr;
  size_t alpha_size = 0;
  size_t offset = 0;  // of the bitstream after its chunk header
  size_t compressed_size = 0;
  bool lossless = false;
  int width = 0, height = 0, has_alpha = 0;
};

enum Status { ST_OK, ST_NOT_ENOUGH_DATA, ST_ERROR };

Status parse_headers(const uint8_t* data, size_t data_size, bool all_data, Headers& hdrs) {
  const uint8_t* const start = data;
  if (data_size < 12) return ST_NOT_ENOUGH_DATA;  // RIFF_HEADER_SIZE
  if (std::memcmp(data, "ALPH", 4) == 0) {  // ParseOptionalChunks
    while (true) {
      if (data_size < 8) return ST_NOT_ENOUGH_DATA;
      const uint32_t chunk_size = le32(data + 4);
      if (chunk_size > kMaxChunkPayload) return ST_ERROR;
      const uint32_t disk_chunk_size = (8 + chunk_size + 1) & ~1u;
      if (!std::memcmp(data, "VP8 ", 4) || !std::memcmp(data, "VP8L", 4)) break;
      if (data_size < disk_chunk_size) return ST_NOT_ENOUGH_DATA;
      if (!std::memcmp(data, "ALPH", 4)) {
        hdrs.alpha_data = data + 8;
        hdrs.alpha_size = chunk_size;
      }
      data += disk_chunk_size;
      data_size -= disk_chunk_size;
    }
  }
  // ParseVP8Header
  if (data_size < 8) return ST_NOT_ENOUGH_DATA;
  const bool is_vp8 = !std::memcmp(data, "VP8 ", 4);
  const bool is_vp8l = !std::memcmp(data, "VP8L", 4);
  if (is_vp8 || is_vp8l) {
    const uint32_t size = le32(data + 4);
    if (all_data && size > data_size - 8) return ST_NOT_ENOUGH_DATA;
    hdrs.compressed_size = size;
    data += 8;
    data_size -= 8;
    hdrs.lossless = is_vp8l;
  } else {
    return ST_ERROR;  // the demuxer hands over chunks only
  }
  if (hdrs.compressed_size > kMaxChunkPayload) return ST_ERROR;
  if (!hdrs.lossless) {
    if (data_size < 10) return ST_NOT_ENOUGH_DATA;
    if (!vp8_get_info(data, data_size, hdrs.compressed_size, &hdrs.width, &hdrs.height)) return ST_ERROR;
  } else {
    if (data_size < 5) return ST_NOT_ENOUGH_DATA;
    if (!vp8l_get_info(data, data_size, &hdrs.width, &hdrs.height, &hdrs.has_alpha)) return ST_ERROR;
  }
  hdrs.has_alpha |= hdrs.alpha_data != nullptr;
  hdrs.offset = static_cast<size_t>(data - start);
  return ST_OK;
}

// WebPDemux over a complete file (src/demux/demux.c).
class Demuxer {
 public:
  Demuxer(const uint8_t* data, size_t size) : buf_(data), size_(size) {}

  void parse() {
    // ReadHeader
    if (size_ < 12 + 8) refuse("WebP: file too short");
    if (std::memcmp(buf_, "RIFF", 4) || std::memcmp(buf_ + 8, "WEBP", 4)) refuse("not a WebP file");
    const uint32_t riff_size = le32(buf_ + 4);
    if (riff_size < 8 || riff_size > kMaxChunkPayload) refuse("WebP: bad RIFF size");
    riff_end_ = static_cast<size_t>(riff_size) + 8;
    end_ = size_;
    if (end_ > riff_end_) end_ = riff_end_;
    if (end_ < riff_end_) refuse("WebP: file truncated (shorter than its RIFF size)");
    start_ = 12;
    Parse status = PARSE_ERROR;
    bool known = false;
    if (!std::memcmp(buf_ + start_, "VP8 ", 4) || !std::memcmp(buf_ + start_, "VP8L", 4)) {
      known = true;
      status = parse_single_image();
      if (status == PARSE_OK) state_ = DONE;
      if (status == PARSE_NEED_MORE_DATA) status = PARSE_ERROR;
      if (status != PARSE_ERROR && !valid_simple()) status = PARSE_ERROR;
    } else if (!std::memcmp(buf_ + start_, "VP8X", 4)) {
      known = true;
      status = parse_vp8x();
      if (status == PARSE_OK) state_ = DONE;
      if (status == PARSE_NEED_MORE_DATA) status = PARSE_ERROR;
      if (status != PARSE_ERROR && !valid_extended()) status = PARSE_ERROR;
    }
    if (!known || status == PARSE_ERROR) refuse("WebP: invalid container");
    if (frames_.empty()) refuse("WebP: no frame");
  }

  int canvas_width() const { return canvas_width_; }
  int canvas_height() const { return canvas_height_; }
  const Frame& first() const { return frames_[0]; }
  size_t num_frames() const { return frames_.size(); }
  const uint8_t* buf() const { return buf_; }

  // GetFramePayload: the frame's chunks, from its ALPH (if any) to its image
  void payload(const Frame& f, const uint8_t** data, size_t* size) const {
    size_t start = f.img[0].offset;
    *size = f.img[0].size;
    if (f.img[1].size > 0) {
      const size_t inter = (f.img[0].offset > 0) ? f.img[0].offset - (f.img[1].offset + f.img[1].size) : 0;
      start = f.img[1].offset;
      *size += f.img[1].size + inter;
    }
    *data = buf_ + start;
  }

 private:
  size_t data_size() const { return end_ - start_; }
  bool size_invalid(size_t size) const { return size > riff_end_ - start_; }
  uint32_t read_le32() {
    const uint32_t v = le32(buf_ + start_);
    start_ += 4;
    return v;
  }
  int read_le24s() {
    const int v = static_cast<int>(le24(buf_ + start_));
    start_ += 3;
    return v;
  }

  bool add_frame(const Frame& f) {
    if (!frames_.empty() && !frames_.back().complete) return false;
    frames_.push_back(f);
    return true;
  }

  Parse store_frame(int frame_num, uint32_t min_size, Frame& frame) {
    int alpha_chunks = 0, image_chunks = 0;
    bool done = data_size() < 8 || data_size() < min_size;
    Parse status = PARSE_OK;
    if (done) return PARSE_NEED_MORE_DATA;
    do {
      const size_t chunk_start = start_;
      const uint32_t id = read_le32();
      const uint32_t payload_size = read_le32();
      if (payload_size > kMaxChunkPayload) return PARSE_ERROR;
      const uint32_t padded = payload_size + (payload_size & 1);
      const size_t available = std::min<size_t>(padded, data_size());
      const size_t chunk_size = 8 + available;
      if (size_invalid(padded)) return PARSE_ERROR;
      if (padded > data_size()) status = PARSE_NEED_MORE_DATA;
      bool stop = false;
      if (id == fourcc("ALPH")) {
        if (alpha_chunks == 0) {
          ++alpha_chunks;
          frame.img[1] = {chunk_start, chunk_size};
          frame.has_alpha = 1;
          frame.frame_num = frame_num;
          start_ += available;
        } else {
          stop = true;
        }
      } else if (id == fourcc("VP8L") || id == fourcc("VP8 ")) {
        if (id == fourcc("VP8L") && alpha_chunks > 0) return PARSE_ERROR;  // VP8L has its own alpha
        if (image_chunks == 0) {
          Headers f;
          const Status st = parse_headers(buf_ + chunk_start, chunk_size, false, f);
          if (status == PARSE_NEED_MORE_DATA && st == ST_NOT_ENOUGH_DATA) return PARSE_NEED_MORE_DATA;
          if (st != ST_OK) return PARSE_ERROR;
          ++image_chunks;
          frame.img[0] = {chunk_start, chunk_size};
          frame.width = f.width;
          frame.height = f.height;
          frame.has_alpha |= f.has_alpha;
          frame.frame_num = frame_num;
          frame.complete = (status == PARSE_OK);
          start_ += available;
        } else {
          stop = true;
        }
      } else {
        stop = true;
      }
      if (stop) {
        start_ -= 8;
        done = true;
      }
      if (start_ == riff_end_) {
        done = true;
      } else if (data_size() < 8) {
        status = PARSE_NEED_MORE_DATA;
      }
    } while (!done && status == PARSE_OK);
    return status;
  }

  Parse parse_single_image() {
    if (!frames_.empty()) return PARSE_ERROR;
    if (size_invalid(8)) return PARSE_ERROR;
    if (data_size() < 8) return PARSE_NEED_MORE_DATA;
    Frame frame;
    Parse status = store_frame(1, 0, frame);
    if (status != PARSE_ERROR) {
      const bool has_alpha = feature_flags_ & ALPHA_FLAG;
      if (!has_alpha && frame.img[1].size > 0) {  // ALPH without the VP8X flag is ignored
        frame.img[1] = ChunkData();
        frame.has_alpha = 0;
      }
      if (!is_ext_format_ && frame.width > 0 && frame.height > 0) {
        state_ = PARSED_HEADER;
        canvas_width_ = frame.width;
        canvas_height_ = frame.height;
        feature_flags_ |= frame.has_alpha ? ALPHA_FLAG : 0;
      }
      if (!add_frame(frame)) status = PARSE_ERROR;
    }
    return status;
  }

  Parse parse_animation_frame(uint32_t frame_chunk_size) {
    const bool is_animation = feature_flags_ & ANIMATION_FLAG;
    const uint32_t anmf_payload_size = frame_chunk_size - 16;
    if (size_invalid(16)) return PARSE_ERROR;
    if (frame_chunk_size < 16) return PARSE_ERROR;
    if (data_size() < 16) return PARSE_NEED_MORE_DATA;
    Frame frame;
    frame.x_offset = 2 * read_le24s();
    frame.y_offset = 2 * read_le24s();
    frame.width = 1 + read_le24s();
    frame.height = 1 + read_le24s();
    read_le24s();  // duration
    start_ += 1;   // dispose and blend bits: the first frame is a key frame
    if (static_cast<uint64_t>(frame.width) * static_cast<uint64_t>(frame.height) >= kMaxImageArea)
      return PARSE_ERROR;
    const size_t start_offset = start_;
    Parse status = store_frame(static_cast<int>(frames_.size()) + 1, anmf_payload_size, frame);
    if (status != PARSE_ERROR && start_ - start_offset > anmf_payload_size) status = PARSE_ERROR;
    if (status != PARSE_ERROR && is_animation && frame.frame_num > 0) {
      if (!add_frame(frame)) status = PARSE_ERROR;
    }
    return status;
  }

  Parse parse_vp8x() {
    if (data_size() < 8) return PARSE_NEED_MORE_DATA;
    is_ext_format_ = true;
    start_ += 4;
    uint32_t vp8x_size = read_le32();
    if (vp8x_size > kMaxChunkPayload) return PARSE_ERROR;
    if (vp8x_size < 10) return PARSE_ERROR;
    vp8x_size += vp8x_size & 1;
    if (size_invalid(vp8x_size)) return PARSE_ERROR;
    if (data_size() < vp8x_size) return PARSE_NEED_MORE_DATA;
    feature_flags_ = buf_[start_];
    start_ += 4;
    canvas_width_ = 1 + read_le24s();
    canvas_height_ = 1 + read_le24s();
    if (static_cast<uint64_t>(canvas_width_) * static_cast<uint64_t>(canvas_height_) >= kMaxImageArea)
      return PARSE_ERROR;
    start_ += vp8x_size - 10;
    state_ = PARSED_HEADER;
    if (size_invalid(8)) return PARSE_ERROR;
    if (data_size() < 8) return PARSE_NEED_MORE_DATA;
    // ParseVP8XChunks
    const bool is_animation = feature_flags_ & ANIMATION_FLAG;
    int anim_chunks = 0;
    Parse status = PARSE_OK;
    do {
      const uint32_t id = read_le32();
      const uint32_t chunk_size = read_le32();
      if (chunk_size > kMaxChunkPayload) return PARSE_ERROR;
      const uint32_t padded = chunk_size + (chunk_size & 1);
      if (size_invalid(padded)) return PARSE_ERROR;
      if (id == fourcc("VP8X")) {
        return PARSE_ERROR;
      } else if (id == fourcc("ALPH") || id == fourcc("VP8 ") || id == fourcc("VP8L")) {
        if (anim_chunks > 0 || is_animation) return PARSE_ERROR;
        start_ -= 8;
        status = parse_single_image();
      } else if (id == fourcc("ANIM")) {
        if (padded < 6) return PARSE_ERROR;
        if (data_size() < padded) {
          status = PARSE_NEED_MORE_DATA;
        } else if (anim_chunks == 0) {
          ++anim_chunks;
          start_ += padded;  // background colour, loop count (never negative)
        } else {
          start_ += padded;
        }
      } else if (id == fourcc("ANMF")) {
        if (anim_chunks == 0) return PARSE_ERROR;
        status = parse_animation_frame(padded);
      } else {  // ICCP, EXIF, XMP and unknown chunks
        if (padded <= data_size()) {
          start_ += padded;
        } else {
          status = PARSE_NEED_MORE_DATA;
        }
      }
      if (start_ == riff_end_) {
        break;
      } else if (data_size() < 8) {
        status = PARSE_NEED_MORE_DATA;
      }
    } while (status == PARSE_OK);
    return status;
  }

  bool valid_simple() const {
    if (state_ == PARSING_HEADER) return true;
    if (canvas_width_ <= 0 || canvas_height_ <= 0) return false;
    if (state_ == DONE && frames_.empty()) return false;
    if (frames_[0].width <= 0 || frames_[0].height <= 0) return false;
    return true;
  }

  bool valid_extended() const {
    const bool is_animation = feature_flags_ & ANIMATION_FLAG;
    if (state_ == PARSING_HEADER) return true;
    if (canvas_width_ <= 0 || canvas_height_ <= 0) return false;
    if (state_ == DONE && frames_.empty()) return false;
    if (feature_flags_ & ~ALL_VALID_FLAGS) return false;
    for (size_t i = 0; i < frames_.size(); ++i) {
      const Frame& f = frames_[i];
      const ChunkData& image = f.img[0];
      const ChunkData& alpha = f.img[1];
      if (!is_animation && f.frame_num > 1) return false;
      if (f.complete) {
        if (alpha.size == 0 && image.size == 0) return false;
        if (alpha.size > 0 && alpha.offset > image.offset) return false;
        if (f.width <= 0 || f.height <= 0) return false;
      } else {
        if (state_ == DONE) return false;
        if (alpha.size > 0 && image.size > 0 && alpha.offset > image.offset) return false;
        if (i + 1 < frames_.size()) return false;
      }
      if (f.width > 0 && f.height > 0) {
        if (!is_animation) {
          if (f.x_offset != 0 || f.y_offset != 0) return false;
          if (f.width != canvas_width_ || f.height != canvas_height_) return false;
        } else {
          if (f.x_offset < 0 || f.y_offset < 0) return false;
          if (f.width + f.x_offset > canvas_width_) return false;
          if (f.height + f.y_offset > canvas_height_) return false;
        }
      }
    }
    return true;
  }

  const uint8_t* buf_;
  size_t size_;
  size_t start_ = 0, end_ = 0, riff_end_ = 0;
  int feature_flags_ = 0;
  int canvas_width_ = -1, canvas_height_ = -1;
  bool is_ext_format_ = false;
  int state_ = PARSING_HEADER;
  std::vector<Frame> frames_;
};

// The first frame's chunks as WebPDecode reads them: the headers, checked.
Headers frame_headers(const Demuxer& dmux, const uint8_t** data, size_t* size) {
  dmux.payload(dmux.first(), data, size);
  Headers hdrs;
  if (parse_headers(*data, *size, true, hdrs) != ST_OK) refuse("WebP: bad frame headers");
  return hdrs;
}

// PIL's decompression-bomb bound (twice ``Image.MAX_IMAGE_PIXELS``): PIL
// refuses a larger canvas when it opens the file, before anything is decoded.
constexpr uint64_t kMaxPixels = 2ull * 89478485;

// Parses the container and refuses a canvas past kMaxPixels, with PIL's message.
void parse_checked(Demuxer& dmux) {
  dmux.parse();
  const uint64_t pixels = static_cast<uint64_t>(dmux.canvas_width()) * dmux.canvas_height();
  if (pixels > kMaxPixels)
    refuse("Image size (" + std::to_string(pixels) + " pixels) exceeds limit of " +
           std::to_string(kMaxPixels) + " pixels, could be decompression bomb DOS attack.");
}

// Decodes the first frame into a (canvas_h, canvas_w, channels) buffer.
void decode_file(const uint8_t* file, size_t file_size, int channels, uint8_t* out, int64_t* info) {
  Demuxer dmux(file, file_size);
  parse_checked(dmux);
  const int cw = dmux.canvas_width(), ch = dmux.canvas_height();
  const Frame& frame = dmux.first();
  const uint8_t* data;
  size_t size;
  Headers hdrs = frame_headers(dmux, &data, &size);
  if (info != nullptr) {
    info[kInfoLossless] = hdrs.lossless;
    info[kInfoAnimated] = static_cast<int64_t>(dmux.num_frames());
  }
  const size_t stride = static_cast<size_t>(cw) * channels;
  std::memset(out, 0, stride * ch);  // a key frame's canvas: transparent black
  uint8_t* const dst = out + static_cast<size_t>(frame.y_offset) * stride +
                       static_cast<size_t>(frame.x_offset) * channels;
  const uint8_t* const bits = data + hdrs.offset;
  const size_t bits_size = size - hdrs.offset;  // to the end of the frame, padding included
  if (!hdrs.lossless) {
    Planes planes;
    Vp8Decoder(bits, bits_size, info).decode(planes);
    if (planes.width != frame.width || planes.height != frame.height) refuse("WebP: frame size mismatch");
    std::vector<uint8_t> alpha;
    if (hdrs.alpha_data != nullptr)
      decode_alpha_plane(hdrs.alpha_data, hdrs.alpha_size, planes.width, planes.height, alpha, info);
    planes_to_rgb(planes, dst, stride, channels);
    if (channels == 4) {
      for (int y = 0; y < planes.height; ++y)
        for (int x = 0; x < planes.width; ++x)
          dst[y * stride + x * 4 + 3] =
              alpha.empty() ? 255 : alpha[static_cast<size_t>(y) * planes.width + x];
    }
  } else {
    std::vector<uint32_t> argb;
    int w = 0, h = 0;
    LosslessDecoder(bits, bits_size, info).decode_image(argb, w, h);
    if (w != frame.width || h != frame.height) refuse("WebP: frame size mismatch");
    if (info != nullptr) info[kInfoAlpha] = 3;
    for (int y = 0; y < h; ++y) {
      uint8_t* row = dst + y * stride;
      for (int x = 0; x < w; ++x) {
        const uint32_t p = argb[static_cast<size_t>(y) * w + x];
        row[x * channels + 0] = static_cast<uint8_t>(p >> 16);
        row[x * channels + 1] = static_cast<uint8_t>(p >> 8);
        row[x * channels + 2] = static_cast<uint8_t>(p);
        if (channels == 4) row[x * channels + 3] = static_cast<uint8_t>(p >> 24);
      }
    }
  }
}

}  // namespace

extern "C" {

// Canvas height and width once the container and the first frame's bitstream
// header are read: 0, or -1 with a message in err.
int webp_header(const uint8_t* data, size_t len, int64_t* dims, char* err, int errlen) {
  try {
    Demuxer dmux(data, len);
    parse_checked(dmux);
    const uint8_t* frame;
    size_t size;
    frame_headers(dmux, &frame, &size);
    dims[0] = dmux.canvas_height();
    dims[1] = dmux.canvas_width();
    return 0;
  } catch (const Refusal& e) {
    set_error(err, errlen, e.what());
  } catch (const std::bad_alloc&) {
    set_error(err, errlen, "out of memory");
  }
  return -1;
}

// Decodes into out, (height, width, channels) uint8 from webp_header, with
// channels 3 or 4; fills info[kInfoCount] when it is not null: 0, or -1 with a
// message in err.
int webp_decode(const uint8_t* data, size_t len, int channels, uint8_t* out, size_t out_len,
                int64_t* info, char* err, int errlen) {
  try {
    if (channels != 3 && channels != 4) refuse("channels must be 3 or 4");
    Demuxer dmux(data, len);
    parse_checked(dmux);
    if (static_cast<size_t>(dmux.canvas_width()) * dmux.canvas_height() * channels != out_len)
      refuse("output buffer does not match the image size");
    if (info != nullptr) std::fill(info, info + kInfoCount, 0);
    decode_file(data, len, channels, out, info);
    return 0;
  } catch (const Refusal& e) {
    set_error(err, errlen, e.what());
  } catch (const std::bad_alloc&) {
    set_error(err, errlen, "out of memory");
  }
  return -1;
}

}  // extern "C"
