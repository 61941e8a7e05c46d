// Native WAV codec + multithreaded batch loader for the data pipeline.
//
// The port's own copy of the JAX package's native/wavio.cpp: a
// dependency-free RIFF/WAVE parser (PCM 8/16/24/32 and IEEE float32/64, any
// channel count, downmix to mono) plus a thread-pooled batch reader for
// feeding the training input pipeline, exposed to Python through ctypes
// (iris_tts_tpu_torch/data/native.py, which builds it at first use).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread wavio.cpp -o libiriswav.so

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr uint16_t kPcm = 0x0001;
constexpr uint16_t kFloat = 0x0003;
constexpr uint16_t kExtensible = 0xFFFE;

struct Wav {
  std::vector<float> samples;  // interleaved
  int channels = 0;
  int sample_rate = 0;
};

uint32_t rd_u32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}
uint16_t rd_u16(const uint8_t* p) {
  return (uint16_t)p[0] | ((uint16_t)p[1] << 8);
}

// Returns 0 on success.
int parse_wav(const uint8_t* data, size_t size, Wav* out) {
  if (size < 12 || memcmp(data, "RIFF", 4) != 0 ||
      memcmp(data + 8, "WAVE", 4) != 0)
    return 1;

  const uint8_t* fmt = nullptr;
  size_t fmt_size = 0;
  const uint8_t* raw = nullptr;
  size_t raw_size = 0;

  size_t pos = 12;
  while (pos + 8 <= size) {
    const uint8_t* id = data + pos;
    uint32_t chunk = rd_u32(data + pos + 4);
    if (pos + 8 + chunk > size) chunk = (uint32_t)(size - pos - 8);
    if (memcmp(id, "fmt ", 4) == 0) {
      fmt = data + pos + 8;
      fmt_size = chunk;
    } else if (memcmp(id, "data", 4) == 0) {
      raw = data + pos + 8;
      raw_size = chunk;
    }
    pos += 8 + chunk + (chunk & 1);  // word-aligned chunks
  }
  if (!fmt || fmt_size < 16 || !raw) return 2;

  uint16_t format = rd_u16(fmt);
  uint16_t channels = rd_u16(fmt + 2);
  uint32_t rate = rd_u32(fmt + 4);
  uint16_t bits = rd_u16(fmt + 14);
  if (format == kExtensible && fmt_size >= 26) format = rd_u16(fmt + 24);
  if (channels == 0) return 3;

  size_t bytes_per = bits / 8;
  if (bytes_per == 0) return 3;
  size_t n = raw_size / bytes_per;
  out->samples.resize(n);
  out->channels = channels;
  out->sample_rate = (int)rate;

  if (format == kPcm) {
    switch (bits) {
      case 16:
        for (size_t i = 0; i < n; ++i) {
          int16_t v = (int16_t)rd_u16(raw + 2 * i);
          out->samples[i] = (float)v / 32768.0f;
        }
        break;
      case 32:
        for (size_t i = 0; i < n; ++i) {
          int32_t v = (int32_t)rd_u32(raw + 4 * i);
          out->samples[i] = (float)v / 2147483648.0f;
        }
        break;
      case 24:
        for (size_t i = 0; i < n; ++i) {
          const uint8_t* p = raw + 3 * i;
          int32_t v = (int32_t)p[0] | ((int32_t)p[1] << 8) |
                      ((int32_t)p[2] << 16);
          if (v & 0x800000) v -= (1 << 24);
          out->samples[i] = (float)v / 8388608.0f;
        }
        break;
      case 8:
        for (size_t i = 0; i < n; ++i)
          out->samples[i] = ((float)raw[i] - 128.0f) / 128.0f;
        break;
      default:
        return 4;
    }
  } else if (format == kFloat) {
    if (bits == 32) {
      memcpy(out->samples.data(), raw, n * 4);
    } else if (bits == 64) {
      for (size_t i = 0; i < n; ++i) {
        double v;
        memcpy(&v, raw + 8 * i, 8);
        out->samples[i] = (float)v;
      }
    } else {
      return 4;
    }
  } else {
    return 5;
  }
  return 0;
}

int read_file(const char* path, std::vector<uint8_t>* buf) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  long size = -1;
  if (fseek(f, 0, SEEK_END) == 0) size = ftell(f);
  // ftell returns -1 for pipes/directories (and >2 GB files on 32-bit
  // long); resizing to (size_t)-1 would throw and kill the host process.
  if (size < 0 || fseek(f, 0, SEEK_SET) != 0) {
    fclose(f);
    return 1;
  }
  buf->resize((size_t)size);
  size_t got = fread(buf->data(), 1, (size_t)size, f);
  fclose(f);
  return got == (size_t)size ? 0 : 1;
}

int load_mono(const char* path, std::vector<float>* mono, int* rate) {
  std::vector<uint8_t> buf;
  if (read_file(path, &buf)) return 1;
  Wav wav;
  int rc = parse_wav(buf.data(), buf.size(), &wav);
  if (rc) return rc + 10;
  *rate = wav.sample_rate;
  size_t frames = wav.samples.size() / wav.channels;
  mono->resize(frames);
  if (wav.channels == 1) {
    *mono = std::move(wav.samples);
  } else {
    float inv = 1.0f / (float)wav.channels;
    for (size_t i = 0; i < frames; ++i) {
      float acc = 0.0f;
      for (int c = 0; c < wav.channels; ++c)
        acc += wav.samples[i * wav.channels + c];
      (*mono)[i] = acc * inv;
    }
  }
  return 0;
}

}  // namespace

extern "C" {

// Read one WAV, downmixed to mono float32. Caller frees with iris_free.
// Returns 0 on success.
// NOTE: every extern "C" entry point catches all C++ exceptions (e.g.
// bad_alloc on a corrupt size field) and translates them to error codes —
// an exception escaping into the ctypes caller would std::terminate the
// host Python process.
int iris_read_wav_mono(const char* path, float** out, int64_t* n_samples,
                       int* sample_rate) try {
  std::vector<float> mono;
  int rate = 0;
  int rc = load_mono(path, &mono, &rate);
  if (rc) return rc;
  *out = (float*)malloc(mono.size() * sizeof(float));
  if (!*out) return 100;
  memcpy(*out, mono.data(), mono.size() * sizeof(float));
  *n_samples = (int64_t)mono.size();
  *sample_rate = rate;
  return 0;
} catch (...) {
  return 101;
}

void iris_free(void* p) { free(p); }

// Batch read: n paths (null-separated concatenated string), each decoded
// mono into caller-provided fixed-stride buffer [n, max_samples] (zero
// padded / truncated), with lengths + rates written per file. Thread-pooled.
// Returns number of failures.
int iris_read_wav_batch(const char* paths, int n, int64_t max_samples,
                        float* out, int64_t* lengths, int* rates,
                        int num_threads) try {
  std::vector<const char*> files(n);
  const char* p = paths;
  for (int i = 0; i < n; ++i) {
    files[i] = p;
    p += strlen(p) + 1;
  }
  std::atomic<int> next(0);
  std::atomic<int> failures(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      bool ok = false;
      // An exception leaving a std::thread body calls std::terminate, so
      // per-file failures (including allocation) become failure counts.
      try {
        std::vector<float> mono;
        int rate = 0;
        if (load_mono(files[i], &mono, &rate) == 0) {
          int64_t take =
              (int64_t)mono.size() < max_samples ? (int64_t)mono.size()
                                                 : max_samples;
          memcpy(out + (int64_t)i * max_samples, mono.data(),
                 (size_t)take * sizeof(float));
          memset(out + (int64_t)i * max_samples + take, 0,
                 (size_t)(max_samples - take) * sizeof(float));
          lengths[i] = take;
          rates[i] = rate;
          ok = true;
        }
      } catch (...) {
      }
      if (!ok) {
        failures.fetch_add(1);
        lengths[i] = 0;
        rates[i] = 0;
        memset(out + (int64_t)i * max_samples, 0,
               (size_t)max_samples * sizeof(float));
      }
    }
  };
  int threads = num_threads > 0 ? num_threads : 4;
  if (threads > n) threads = n > 0 ? n : 1;
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; ++t) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
  return failures.load();
} catch (...) {
  return n > 0 ? n : 1;  // treat a setup failure as "all files failed"
}

// Encode mono float32 → 16-bit PCM WAV on disk. Returns 0 on success.
int iris_write_wav_pcm16(const char* path, const float* samples,
                         int64_t n_samples, int sample_rate) try {
  // Encode before opening the file so an allocation failure can't leak the
  // FILE handle out of the catch below.
  std::vector<int16_t> pcm(n_samples);
  for (int64_t i = 0; i < n_samples; ++i) {
    float v = samples[i];
    if (v > 1.0f) v = 1.0f;
    if (v < -1.0f) v = -1.0f;
    pcm[i] = (int16_t)(v * 32767.0f);
  }
  FILE* f = fopen(path, "wb");
  if (!f) return 1;
  uint32_t data_size = (uint32_t)(n_samples * 2);
  uint32_t riff_size = 36 + data_size;
  uint8_t header[44];
  memcpy(header, "RIFF", 4);
  memcpy(header + 4, &riff_size, 4);
  memcpy(header + 8, "WAVEfmt ", 8);
  uint32_t fmt_size = 16;
  memcpy(header + 16, &fmt_size, 4);
  uint16_t fmt_tag = kPcm, channels = 1, block = 2, bits = 16;
  uint32_t rate = (uint32_t)sample_rate, byte_rate = rate * 2;
  memcpy(header + 20, &fmt_tag, 2);
  memcpy(header + 22, &channels, 2);
  memcpy(header + 24, &rate, 4);
  memcpy(header + 28, &byte_rate, 4);
  memcpy(header + 32, &block, 2);
  memcpy(header + 34, &bits, 2);
  memcpy(header + 36, "data", 4);
  memcpy(header + 40, &data_size, 4);
  fwrite(header, 1, 44, f);
  fwrite(pcm.data(), 2, (size_t)n_samples, f);
  fclose(f);
  return 0;
} catch (...) {
  return 2;
}

}  // extern "C"
