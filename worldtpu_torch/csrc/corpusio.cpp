// The port's copy of worldtpu/native/corpusio.cpp, unchanged below this line.
// Native batched WAV corpus loader.
//
// The reference keeps its IO in C++ (tools/audioio.cpp); worldtpu's corpus
// path does too: this loader reads a LIST of mono PCM wavs into one padded
// [B, T] float32 batch buffer with a thread per shard — the production IO
// feeder for HarvestKernel.compute_corpus / parallel.batch consumers.
// Decode semantics mirror worldtpu/io/wav.py (and the reference
// tools/audioio.cpp:236-251): 16-bit = int16/2^15, 8-bit = two's-complement
// byte/2^7, 24-bit = int24/2^23.
//
// Exposed C ABI (ctypes):
//   worldtpu_load_wavs(paths, n, T, out, lengths, rates, bits, n_threads)
//     paths:   array of n NUL-terminated file paths
//     out:     [n, T] float32, zero-padded beyond each file's length
//     lengths: [n] int64 true sample counts (-1 on per-file error)
//     rates:   [n] int32 sample rates
//     bits:    [n] int32 bit depths
//   returns the number of successfully decoded files.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct WavResult {
  int64_t length = -1;
  int32_t fs = 0;
  int32_t nbit = 0;
};

WavResult load_one(const char* path, float* out, int64_t T) {
  WavResult r;
  FILE* f = std::fopen(path, "rb");
  if (!f) return r;
  std::fseek(f, 0, SEEK_END);
  long fsize = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (fsize < 44) { std::fclose(f); return r; }
  std::vector<uint8_t> buf(static_cast<size_t>(fsize));
  if (std::fread(buf.data(), 1, buf.size(), f) != buf.size()) {
    std::fclose(f);
    return r;
  }
  std::fclose(f);

  if (std::memcmp(buf.data(), "RIFF", 4) != 0 ||
      std::memcmp(buf.data() + 8, "WAVE", 4) != 0)
    return r;

  size_t pos = 12;
  int32_t fs = 0;
  int nbit = 0;
  bool have_fmt = false;
  while (pos + 8 <= buf.size()) {
    uint32_t size;
    std::memcpy(&size, buf.data() + pos + 4, 4);
    const uint8_t* body = buf.data() + pos + 8;
    size_t avail = buf.size() - (pos + 8);
    if (size > avail) size = static_cast<uint32_t>(avail);
    if (std::memcmp(buf.data() + pos, "fmt ", 4) == 0 && size >= 16) {
      uint16_t fmt, nch, bits;
      std::memcpy(&fmt, body, 2);
      std::memcpy(&nch, body + 2, 2);
      std::memcpy(&fs, body + 4, 4);
      std::memcpy(&bits, body + 14, 2);
      if (fmt != 1 || nch != 1) return r;  // PCM mono only
      nbit = bits;
      have_fmt = true;
    } else if (std::memcmp(buf.data() + pos, "data", 4) == 0) {
      if (!have_fmt || nbit == 0) return r;
      int nbytes = nbit / 8;
      if (nbytes == 0) return r;
      int64_t n = static_cast<int64_t>(size) / nbytes;
      int64_t m = n < T ? n : T;
      if (nbit == 16) {
        for (int64_t i = 0; i < m; ++i) {
          int16_t v;
          std::memcpy(&v, body + 2 * i, 2);
          out[i] = static_cast<float>(v / 32768.0);
        }
      } else if (nbit == 8) {
        for (int64_t i = 0; i < m; ++i)
          out[i] = static_cast<float>(
              static_cast<int8_t>(body[i]) / 128.0);
      } else if (nbit == 24) {
        for (int64_t i = 0; i < m; ++i) {
          int32_t v = body[3 * i] | (body[3 * i + 1] << 8) |
                      (body[3 * i + 2] << 16);
          if (v >= (1 << 23)) v -= (1 << 24);
          out[i] = static_cast<float>(v / 8388608.0);
        }
      } else {
        return r;
      }
      for (int64_t i = m; i < T; ++i) out[i] = 0.0f;
      r.length = n;
      r.fs = fs;
      r.nbit = nbit;
      return r;
    }
    pos += 8 + size + (size & 1);
  }
  return r;
}

}  // namespace

extern "C" int64_t worldtpu_load_wavs(const char** paths, int64_t n,
                                      int64_t T, float* out,
                                      int64_t* lengths, int32_t* rates,
                                      int32_t* bits, int32_t n_threads) {
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n) n_threads = static_cast<int32_t>(n);
  std::vector<std::thread> ts;
  ts.reserve(n_threads);
  for (int32_t t = 0; t < n_threads; ++t) {
    ts.emplace_back([=]() {
      for (int64_t i = t; i < n; i += n_threads) {
        WavResult r = load_one(paths[i], out + i * T, T);
        lengths[i] = r.length;
        rates[i] = r.fs;
        bits[i] = r.nbit;
        if (r.length < 0)
          for (int64_t j = 0; j < T; ++j) out[i * T + j] = 0.0f;
      }
    });
  }
  for (auto& th : ts) th.join();
  int64_t ok = 0;
  for (int64_t i = 0; i < n; ++i) ok += lengths[i] >= 0;
  return ok;
}
