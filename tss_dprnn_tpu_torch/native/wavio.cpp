// Native host-side WAV decode + crop + batch assembly.
//
// The input-pipeline hot path: the reference spends its host time in
// soundfile/libsndfile reads inside DataLoader workers
// (src/datasets/librimix.py:77-79); this is the equivalent native component
// — a small, dependency-free RIFF/PCM decoder with a multithreaded batch
// API, driven from Python via ctypes (tss_dprnn_tpu_torch/data/native.py).
// The port's copy of tss_dprnn_tpu/native/wavio.cpp: the batch API also
// reports the frames it decoded per crop, so that the caller can refuse a
// short read instead of passing on its zero padding.
//
// Supports PCM16/24/32 and IEEE float32 mono/interleaved files; partial
// reads seek directly to the requested frame range.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Fmt {
  uint16_t audio_fmt = 0;
  uint16_t channels = 0;
  uint32_t rate = 0;
  uint16_t block = 0;
  uint16_t bits = 0;
  long data_off = -1;
  long data_size = 0;
};

bool parse_header(std::FILE* f, Fmt* fmt) {
  uint8_t head[12];
  if (std::fread(head, 1, 12, f) != 12) return false;
  if (std::memcmp(head, "RIFF", 4) != 0 || std::memcmp(head + 8, "WAVE", 4) != 0)
    return false;
  bool have_fmt = false;
  while (fmt->data_off < 0 || !have_fmt) {
    uint8_t hdr[8];
    if (std::fread(hdr, 1, 8, f) != 8) break;
    uint32_t size;
    std::memcpy(&size, hdr + 4, 4);
    if (std::memcmp(hdr, "fmt ", 4) == 0) {
      std::vector<uint8_t> blob(size);
      if (std::fread(blob.data(), 1, size, f) != size) return false;
      std::memcpy(&fmt->audio_fmt, blob.data() + 0, 2);
      std::memcpy(&fmt->channels, blob.data() + 2, 2);
      std::memcpy(&fmt->rate, blob.data() + 4, 4);
      std::memcpy(&fmt->block, blob.data() + 12, 2);
      std::memcpy(&fmt->bits, blob.data() + 14, 2);
      if (fmt->audio_fmt == 0xFFFE && size >= 40)
        std::memcpy(&fmt->audio_fmt, blob.data() + 24, 2);
      if (size & 1) std::fseek(f, 1, SEEK_CUR);
      have_fmt = true;
    } else if (std::memcmp(hdr, "data", 4) == 0) {
      fmt->data_off = std::ftell(f);
      fmt->data_size = size;
      std::fseek(f, size + (size & 1), SEEK_CUR);
    } else {
      std::fseek(f, size + (size & 1), SEEK_CUR);
    }
  }
  return have_fmt && fmt->data_off >= 0;
}

// Decode `count` frames starting at `start` into out[count] (channel 0 only,
// matching the mono LibriMix data; multichannel files take channel 0).
long read_frames(const char* path, long start, long count, float* out) {
  std::FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  Fmt fmt;
  if (!parse_header(f, &fmt) || fmt.block == 0) {
    std::fclose(f);
    return -2;
  }
  const long n_frames = fmt.data_size / fmt.block;
  if (start < 0) start = 0;
  if (start > n_frames) start = n_frames;
  if (count < 0 || start + count > n_frames) count = n_frames - start;
  std::fseek(f, fmt.data_off + start * fmt.block, SEEK_SET);
  std::vector<uint8_t> raw(static_cast<size_t>(count) * fmt.block);
  const size_t got = std::fread(raw.data(), fmt.block, count, f);
  std::fclose(f);
  const long n = static_cast<long>(got);
  const int ch = fmt.channels;
  const uint8_t* p = raw.data();
  if (fmt.audio_fmt == 1 && fmt.bits == 16) {
    for (long i = 0; i < n; ++i) {
      int16_t v;
      std::memcpy(&v, p + i * fmt.block, 2);
      out[i] = static_cast<float>(v) / 32768.0f;
    }
  } else if (fmt.audio_fmt == 1 && fmt.bits == 32) {
    for (long i = 0; i < n; ++i) {
      int32_t v;
      std::memcpy(&v, p + i * fmt.block, 4);
      out[i] = static_cast<float>(v) / 2147483648.0f;
    }
  } else if (fmt.audio_fmt == 1 && fmt.bits == 24) {
    for (long i = 0; i < n; ++i) {
      const uint8_t* b = p + i * fmt.block;
      int32_t v = (b[0] | (b[1] << 8) | (b[2] << 16)) << 8;
      out[i] = static_cast<float>(v >> 8) / 8388608.0f;
    }
  } else if (fmt.audio_fmt == 3 && fmt.bits == 32) {
    for (long i = 0; i < n; ++i)
      std::memcpy(&out[i], p + i * fmt.block, 4);
  } else {
    return -3;
  }
  (void)ch;
  return n;
}

}  // namespace

extern "C" {

// Single read: returns frames written, negative on error. `count < 0` =
// read to EOF. `out` must hold max(count, file frames).
long wavio_read(const char* path, long start, long count, float* out) {
  return read_frames(path, start, count, out);
}

// {rate, channels, frames} without decoding.
int wavio_info(const char* path, long* rate, long* channels, long* frames) {
  std::FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  Fmt fmt;
  const bool ok = parse_header(f, &fmt);
  std::fclose(f);
  if (!ok || fmt.block == 0) return -2;
  *rate = fmt.rate;
  *channels = fmt.channels;
  *frames = fmt.data_size / fmt.block;
  return 0;
}

// Batch API: decode `n` crops concurrently into a dense [n, seg_len] buffer
// (zero-padded when a file is shorter) and write the frames decoded for crop
// i to got[i] (negative: that crop's error code). paths is a char** of n
// entries. Returns 0 on success, else the first error code encountered.
int wavio_read_batch(const char** paths, const long* starts, const long* counts,
                     long n, long seg_len, float* out, long* got, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::vector<int> errs(static_cast<size_t>(n_threads), 0);
  std::vector<std::thread> workers;
  auto work = [&](int tid) {
    for (long i = tid; i < n; i += n_threads) {
      float* dst = out + i * seg_len;
      std::memset(dst, 0, sizeof(float) * seg_len);
      long want = counts[i] < 0 ? seg_len : counts[i];
      if (want > seg_len) want = seg_len;
      got[i] = read_frames(paths[i], starts[i], want, dst);
      if (got[i] < 0 && errs[tid] == 0) errs[tid] = static_cast<int>(got[i]);
    }
  };
  for (int t = 0; t < n_threads; ++t) workers.emplace_back(work, t);
  for (auto& w : workers) w.join();
  for (int e : errs)
    if (e != 0) return e;
  return 0;
}

}  // extern "C"
