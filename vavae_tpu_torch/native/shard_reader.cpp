// Threaded, mmap-backed batch assembler over safetensors latent shards.
//
// The DiT trainer's batch reader: each shard is memory-mapped once, and a
// batch is gathered by a pool of threads that copy each item's (C, H, W)
// latents (or their flipped twin, where the shard has one) into the
// caller's (B, H, W, C) float32 buffer, normalising on the way, and read its
// label.
//
// The arithmetic is the Python reference's (ImgLatentDataset.reference_batch
// in data/latent_dataset.py), in its order and in float32: v = float(x);
// v = v - mean[c]; v = v / std[c] (when normalising); v = v * multiplier.
// Built with -ffp-contract=off, so no step is fused. ``float(x)`` is numpy's
// ``astype(np.float32)`` for every dtype numpy reads from a safetensors file
// (F16, F32, F64, the integers, BOOL); a label becomes int32 as
// ``np.asarray(label, np.int32)`` makes it: an integer wraps to its low 32
// bits, a float is cut toward zero, and one out of range (or NaN) gives
// INT32_MIN, as x86's conversion does.
//
// The shards' headers are read in Python, which hands over each tensor's
// offset in its file; this side checks them against the file's size.
//
// C interface (ctypes, vavae_tpu_torch/data/native_loader.py):
//   shard_reader_open(n, paths, rows, lat_off, flip_off, lab_off, lat_type,
//                     flip_type, lab_type, item, err, errlen)     -> handle or NULL
// where a shard without flips gives its latents' offset and type for both,
// and a type is one of the DType codes below.
//   shard_reader_batch(handle, indices, flip, B, mean, std, normalize,
//                      multiplier, C, HW, out, labels, threads, err, errlen) -> 0 or -1
//   shard_reader_close(handle)

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <algorithm>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

// safetensors dtypes, as data/native_loader.py numbers them
enum DType { F32, F16, F64, I8, U8, I16, U16, I32, U32, I64, U64, BOOL, N_DTYPES };
constexpr int kBytes[N_DTYPES] = {4, 2, 8, 1, 1, 2, 2, 4, 4, 8, 8, 1};

template <typename T>
inline T load(const uint8_t* p) {  // the map's offsets need not be aligned
  T v;
  std::memcpy(&v, p, sizeof v);
  return v;
}

// numpy's npy_halfbits_to_floatbits: exact, NaN payloads shifted up
inline float half_to_float(uint16_t h) {
  const uint32_t sign = static_cast<uint32_t>(h & 0x8000u) << 16;
  const uint32_t exp = h & 0x7c00u;
  uint32_t sig = h & 0x03ffu, bits;
  if (exp == 0x7c00u) {
    bits = sign | 0x7f800000u | (sig << 13);
  } else if (exp == 0) {
    if (sig == 0) {
      bits = sign;
    } else {  // subnormal: normalise
      int e = -1;
      do {
        sig <<= 1;
        ++e;
      } while ((sig & 0x0400u) == 0);
      bits = sign | (static_cast<uint32_t>(112 - e) << 23) | ((sig & 0x03ffu) << 13);
    }
  } else {
    bits = sign | ((exp + 0x1c000u) << 13) | (sig << 13);
  }
  float f;
  std::memcpy(&f, &bits, 4);
  return f;
}

template <int T>
inline float to_float(const uint8_t* p) {
  if constexpr (T == F32) return load<float>(p);
  else if constexpr (T == F16) return half_to_float(load<uint16_t>(p));
  else if constexpr (T == F64) return static_cast<float>(load<double>(p));
  else if constexpr (T == I8) return static_cast<float>(load<int8_t>(p));
  else if constexpr (T == U8) return static_cast<float>(load<uint8_t>(p));
  else if constexpr (T == I16) return static_cast<float>(load<int16_t>(p));
  else if constexpr (T == U16) return static_cast<float>(load<uint16_t>(p));
  else if constexpr (T == I32) return static_cast<float>(load<int32_t>(p));
  else if constexpr (T == U32) return static_cast<float>(load<uint32_t>(p));
  else if constexpr (T == I64) return static_cast<float>(load<int64_t>(p));
  else if constexpr (T == U64) return static_cast<float>(load<uint64_t>(p));
  else return p[0] != 0 ? 1.0f : 0.0f;
}

inline int32_t float_label(double d) {
  if (d > -2147483649.0 && d < 2147483648.0) return static_cast<int32_t>(d);
  return INT32_MIN;
}

inline int32_t wrap_label(uint64_t v) { return static_cast<int32_t>(static_cast<uint32_t>(v)); }

int32_t label_at(const uint8_t* p, int type) {
  switch (type) {
    case F32: return float_label(load<float>(p));
    case F16: return float_label(half_to_float(load<uint16_t>(p)));
    case F64: return float_label(load<double>(p));
    case I8: return load<int8_t>(p);
    case U8: return load<uint8_t>(p);
    case I16: return load<int16_t>(p);
    case U16: return load<uint16_t>(p);
    case I32: return load<int32_t>(p);
    case U32: return wrap_label(load<uint32_t>(p));
    case I64: return wrap_label(static_cast<uint64_t>(load<int64_t>(p)));
    case U64: return wrap_label(load<uint64_t>(p));
    default: return p[0] != 0;
  }
}

// one item's (C, H, W) latents at src into dst as (H, W, C), normalised
template <int T>
void gather(const uint8_t* src, int64_t C, int64_t HW, const float* mean, const float* std_,
            bool normalize, float multiplier, float* dst) {
  constexpr int64_t kB = kBytes[T];
  for (int64_t c = 0; c < C; ++c) {
    const uint8_t* sc = src + c * HW * kB;
    const float m = normalize ? mean[c] : 0.0f, sd = normalize ? std_[c] : 1.0f;
    for (int64_t i = 0; i < HW; ++i) {
      float v = to_float<T>(sc + i * kB);
      if (normalize) {
        v = v - m;
        v = v / sd;
      }
      v = v * multiplier;
      dst[i * C + c] = v;
    }
  }
}

using Gather = void (*)(const uint8_t*, int64_t, int64_t, const float*, const float*, bool, float,
                        float*);
const Gather kGather[N_DTYPES] = {gather<F32>, gather<F16>, gather<F64>, gather<I8>,
                                  gather<U8>,  gather<I16>, gather<U16>, gather<I32>,
                                  gather<U32>, gather<I64>, gather<U64>, gather<BOOL>};

struct Shard {
  void* map = nullptr;
  size_t size = 0;
  const uint8_t* base = nullptr;
  int64_t rows = 0, lat = 0, flip = 0, lab = 0;
  int lat_type = F32, flip_type = F32, lab_type = I64;
};

struct Reader {
  std::vector<Shard> shards;
  std::vector<int32_t> shard_of;  // global row -> shard
  std::vector<int64_t> row_of;    // global row -> row in its shard
  int64_t item = 0;               // floats of one latent
};

void set_error(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) {
    std::strncpy(err, msg.c_str(), errlen - 1);
    err[errlen - 1] = 0;
  }
}

void release(Reader* r) {
  for (auto& s : r->shards)
    if (s.map) munmap(s.map, s.size);
  delete r;
}

}  // namespace

extern "C" {

void* shard_reader_open(int n, const char** paths, const int64_t* rows, const int64_t* lat_off,
                        const int64_t* flip_off, const int64_t* lab_off,
                        const int32_t* lat_type, const int32_t* flip_type,
                        const int32_t* lab_type, int64_t item, char* err, int errlen) {
  auto* r = new Reader();
  r->item = item;
  for (int i = 0; i < n; ++i) {
    const int fd = open(paths[i], O_RDONLY);
    if (fd < 0) {
      set_error(err, errlen, std::string(paths[i]) + ": cannot open: " + std::strerror(errno));
      release(r);
      return nullptr;
    }
    struct stat st;
    if (fstat(fd, &st) != 0 || st.st_size == 0) {
      close(fd);
      set_error(err, errlen, std::string(paths[i]) + ": cannot stat, or empty");
      release(r);
      return nullptr;
    }
    void* map = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
    close(fd);
    if (map == MAP_FAILED) {
      set_error(err, errlen, std::string(paths[i]) + ": mmap failed: " + std::strerror(errno));
      release(r);
      return nullptr;
    }
    Shard s;
    s.map = map;
    s.size = static_cast<size_t>(st.st_size);
    s.base = static_cast<const uint8_t*>(map);
    s.rows = rows[i];
    s.lat = lat_off[i];
    s.flip = flip_off[i];
    s.lab = lab_off[i];
    s.lat_type = lat_type[i];
    s.flip_type = flip_type[i];
    s.lab_type = lab_type[i];
    r->shards.push_back(s);
    const auto known = [](int t) { return t >= 0 && t < N_DTYPES; };
    if (!known(s.lat_type) || !known(s.flip_type) || !known(s.lab_type)) {
      set_error(err, errlen, std::string(paths[i]) + ": unknown tensor type");
      release(r);
      return nullptr;
    }
    const auto fits = [&](int64_t off, int64_t bytes) {
      return off >= 0 && bytes >= 0 && static_cast<uint64_t>(off) + bytes <= s.size;
    };
    if (!fits(s.lat, s.rows * item * kBytes[s.lat_type]) ||
        !fits(s.flip, s.rows * item * kBytes[s.flip_type]) ||
        !fits(s.lab, s.rows * kBytes[s.lab_type])) {
      set_error(err, errlen, std::string(paths[i]) + ": tensors run past the end of the file");
      release(r);
      return nullptr;
    }
    for (int64_t row = 0; row < s.rows; ++row) {
      r->shard_of.push_back(i);
      r->row_of.push_back(row);
    }
  }
  return r;
}

int64_t shard_reader_len(void* h) { return static_cast<int64_t>(static_cast<Reader*>(h)->row_of.size()); }

int shard_reader_batch(void* h, const int64_t* indices, const uint8_t* flip, int batch,
                       const float* mean, const float* std_, int normalize, float multiplier,
                       int64_t C, int64_t HW, float* out, int32_t* labels, int n_threads,
                       char* err, int errlen) {
  auto* r = static_cast<Reader*>(h);
  const int64_t n = static_cast<int64_t>(r->row_of.size());
  if (C * HW != r->item) {
    set_error(err, errlen, "latent shape does not match the shards");
    return -1;
  }
  for (int b = 0; b < batch; ++b)
    if (indices[b] < 0 || indices[b] >= n) {
      set_error(err, errlen, "index " + std::to_string(indices[b]) + " out of range [0, " +
                                 std::to_string(n) + ")");
      return -1;
    }
  int threads = n_threads > 0 ? n_threads : static_cast<int>(std::thread::hardware_concurrency());
  threads = std::max(1, std::min(threads, batch));
  auto work = [&](int t) {
    for (int b = t; b < batch; b += threads) {
      const Shard& s = r->shards[r->shard_of[indices[b]]];
      const int64_t row = r->row_of[indices[b]];
      const int type = flip[b] ? s.flip_type : s.lat_type;
      const uint8_t* src = s.base + (flip[b] ? s.flip : s.lat) + row * r->item * kBytes[type];
      kGather[type](src, C, HW, mean, std_, normalize != 0, multiplier,
                    out + static_cast<int64_t>(b) * r->item);
      labels[b] = label_at(s.base + s.lab + row * kBytes[s.lab_type], s.lab_type);
    }
  };
  std::vector<std::thread> pool;
  for (int t = 1; t < threads; ++t) pool.emplace_back(work, t);
  work(0);
  for (auto& th : pool) th.join();
  return 0;
}

void shard_reader_close(void* h) {
  if (h) release(static_cast<Reader*>(h));
}

}  // extern "C"
