// aoti_runner — the port's zero-Python serving host.
//
// Serves the synthesis buckets that `python -m iris_tts_tpu_torch.serve.export
// --native` compiles with AOTInductor (`synth_b{B}_p{P}.aoti.pt2` beside each
// `torch.export` program). It links libtorch and nothing of Python: the
// Python package is needed at export time only; inference is this binary plus
// the artifact directory. It is the counterpart of the JAX package's
// native/pjrt_runner.cpp and keeps that host's command line and request
// protocol; where the JAX host compiles StableHLO through a PJRT plugin, this
// one loads each package with torch::inductor::AOTIModelPackageLoader.
//
// Usage:
//   aoti_runner --probe                       # libtorch, CUDA, devices
//   aoti_runner --npy-roundtrip in.npy out.npy   # IO self-test, no device
//   aoti_runner --package synth_b1_p16.aoti.pt2
//       --arg ids.npy --arg lengths.npy --arg eps.npy --arg f32:1.0
//       [--iters N] [--out-prefix /tmp/out] [--device cuda:0|cpu]
//
// `--serve` turns the one-shot run into a long-lived process: after loading
// the package once it reads one request per stdin line —
//   <arg> <arg> ... <out-prefix>
// (same <arg> syntax as --arg) — runs it, writes the outputs as
// <out-prefix>_<i>.npy and prints one JSON line per request.
//
// ARTIFACT MODE — the serving host:
//   aoti_runner --artifact DIR [--lexicon cmu_dict.txt] [--lazy] [--npy]
//       [--dry-run] [--device cuda|cuda:N|cpu]
// reads manifest.json and vocab.json, loads every bucket's package up front
// (or at its first use with --lazy), prints one
//   {"ready": true, "buckets": ..., "lexicon_words": ..., "vocab": ...}
// line and then serves TEXT requests on stdin, one per line, tab-separated:
//   synth<TAB>out_base<TAB>seed<TAB>temperature<TAB>raw text...
//   ids<TAB>out_base<TAB>seed<TAB>temperature<TAB>4,12,9,31
// Each request is tokenized (lowercase words → CMUdict phones → stress-
// stripped vocab ids; a word missing from the lexicon → <UNK>; an `ids`
// request skips the frontend) and run as the port's
// ExportedSynthesizer.synthesize runs it (serve/export.py): the smallest
// bucket that fits, ids padded with <PAD>, the live path's prior noise
// drawn by an ATen generator on the device seeded with the request's seed
// (so the draws are Python's, bit for bit, on the same device), the audio
// trimmed to n_frames · samples_per_frame and written to out_base.wav
// (16-bit PCM, the port's wavio.cpp). With --npy the trimmed audio and the
// bucket's mel go to out_base_audio.npy and out_base_mel.npy. One JSON
// reply per request on stdout; a bad request gets {"error": ...} and the
// host stays up. `--dry-run` runs the same request path up to the bucket
// pick and loads nothing, so it needs no device. Text normalization
// (numbers, dates) and the neural G2P are the Python frontend's; this host
// expects normalized text.
//
// No fallback hides the device: --device defaults to cuda:0, and asking for
// CUDA where there is none, or for another device type than the one the
// artifact was exported for, exits non-zero with a message.
//
// Exactly one JSON line goes to stdout per request; diagnostics go to
// stderr. Exit 0 on success.

#include <dlfcn.h>
#include <time.h>

#include <algorithm>
#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <iostream>
#include <memory>
#include <mutex>
#include <sstream>
#include <string>
#include <unordered_map>
#include <vector>

#include <ATen/CPUGeneratorImpl.h>
#include <ATen/Context.h>
#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <ATen/ops/full.h>
#include <ATen/ops/ones.h>
#include <ATen/ops/randn.h>
#include <ATen/ops/scalar_tensor.h>
#include <ATen/ops/zeros.h>
#include <c10/core/InferenceMode.h>
#include <torch/csrc/inductor/aoti_package/model_package_loader.h>
#include <torch/cuda.h>

#ifndef IRIS_TORCH_VERSION
#define IRIS_TORCH_VERSION "unknown"
#endif

// wavio.cpp (linked into this binary): mono float32 → 16-bit PCM WAV.
extern "C" int iris_write_wav_pcm16(const char* path, const float* samples,
                                    int64_t n_samples, int sample_rate);

namespace {

struct FatalError {
  std::string msg;
};

[[noreturn]] void Fatal(const std::string& msg) { throw FatalError{msg}; }

double NowMs() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec * 1e3 + ts.tv_nsec / 1e6;
}

std::string ReadFile(const std::string& path) {
  std::ifstream f(path, std::ios::binary);
  if (!f) Fatal("cannot open " + path);
  std::ostringstream ss;
  ss << f.rdbuf();
  return ss.str();
}

std::string JsonEscape(const std::string& in) {
  std::string out;
  for (char c : in)
    out += (c == '"' || c == '\\' || c == '\n' || c == '\r' || c == '\t')
               ? ' '
               : c;
  return out;
}

// ---------------------------------------------------------------------------
// Minimal .npy v1.0 IO (C-order, little-endian): the dtypes the serving
// surface uses. The reader bounds every size a forged header can claim.
// ---------------------------------------------------------------------------

struct DtypeInfo {
  const char* npy;  // descr string
  at::ScalarType type;
  size_t itemsize;
};

const DtypeInfo kDtypes[] = {
    {"<f4", at::kFloat, 4}, {"<i4", at::kInt, 4},  {"<i8", at::kLong, 8},
    {"<i2", at::kShort, 2}, {"<f2", at::kHalf, 2}, {"|b1", at::kBool, 1},
};

const DtypeInfo* DtypeByNpy(const std::string& descr) {
  for (const auto& d : kDtypes)
    if (descr == d.npy) return &d;
  return nullptr;
}

const DtypeInfo* DtypeByType(at::ScalarType t) {
  for (const auto& d : kDtypes)
    if (t == d.type) return &d;
  return nullptr;
}

struct HostArray {
  const DtypeInfo* dtype = nullptr;
  std::vector<int64_t> dims;
  std::vector<char> data;
};

HostArray ReadNpy(const std::string& path) {
  std::ifstream f(path, std::ios::binary);
  if (!f) Fatal("cannot open " + path);
  char magic[8];
  f.read(magic, 8);
  if (!f || std::memcmp(magic, "\x93NUMPY", 6) != 0)
    Fatal(path + ": not a .npy file");
  uint8_t major = magic[6];
  uint32_t header_len = 0;
  if (major == 1) {
    uint16_t hl;
    f.read(reinterpret_cast<char*>(&hl), 2);
    header_len = hl;
  } else {
    f.read(reinterpret_cast<char*>(&header_len), 4);
  }
  // Real npy headers are well under 64 KiB; a forged multi-GiB header_len
  // must not drive a giant allocation.
  if (!f || header_len == 0 || header_len > (1u << 20))
    Fatal(path + ": implausible npy header length");
  std::string header(header_len, '\0');
  f.read(header.data(), header_len);
  if (!f) Fatal(path + ": truncated npy header");
  auto field = [&](const char* key) -> std::string {
    size_t k = header.find(key);
    if (k == std::string::npos) Fatal(path + ": npy header missing " + key);
    return header.substr(k);
  };
  std::string descr = field("'descr'");
  size_t q1 = descr.find('\'', 8);
  size_t q2 =
      q1 == std::string::npos ? std::string::npos : descr.find('\'', q1 + 1);
  if (q2 == std::string::npos) Fatal(path + ": malformed descr field");
  std::string dt = descr.substr(q1 + 1, q2 - q1 - 1);
  HostArray arr;
  arr.dtype = DtypeByNpy(dt);
  if (arr.dtype == nullptr) Fatal(path + ": unsupported dtype " + dt);
  if (field("'fortran_order'").find("True") < 32)
    Fatal(path + ": fortran_order arrays unsupported");
  std::string shape = field("'shape'");
  size_t p1 = shape.find('('), p2 = shape.find(')');
  if (p1 == std::string::npos || p2 == std::string::npos || p2 < p1)
    Fatal(path + ": malformed shape field");
  std::stringstream ss(shape.substr(p1 + 1, p2 - p1 - 1));
  std::string tok;
  while (std::getline(ss, tok, ',')) {
    if (tok.find_first_of("0123456789") == std::string::npos) continue;
    int64_t d = 0;
    try {
      d = std::stoll(tok);
    } catch (const std::exception&) {  // 10^40-digit dims etc.
      Fatal(path + ": malformed shape dimension '" + tok + "'");
    }
    if (d < 0) Fatal(path + ": negative shape dimension");
    arr.dims.push_back(d);
  }
  // Overflow-safe element count: a forged shape must not wrap size_t and
  // under-allocate before the read.
  size_t n = 1;
  for (int64_t d : arr.dims) {
    if (d != 0 && n > (size_t{1} << 40) / static_cast<size_t>(d))
      Fatal(path + ": implausible element count");
    n *= static_cast<size_t>(d);
  }
  arr.data.resize(n * arr.dtype->itemsize);
  f.read(arr.data.data(), static_cast<std::streamsize>(arr.data.size()));
  if (!f) Fatal(path + ": truncated data");
  return arr;
}

void WriteNpy(const std::string& path, const HostArray& arr) {
  std::ostringstream hdr;
  hdr << "{'descr': '" << arr.dtype->npy << "', 'fortran_order': False, "
      << "'shape': (";
  for (size_t i = 0; i < arr.dims.size(); i++)
    hdr << arr.dims[i] << (arr.dims.size() == 1 ? "," : "")
        << (i + 1 < arr.dims.size() ? ", " : "");
  hdr << "), }";
  std::string h = hdr.str();
  size_t total = 10 + h.size() + 1;
  size_t pad = (64 - total % 64) % 64;
  h += std::string(pad, ' ');
  h += '\n';
  uint16_t hl = static_cast<uint16_t>(h.size());
  std::ofstream f(path, std::ios::binary);
  if (!f) Fatal("cannot write " + path);
  f.write("\x93NUMPY\x01\x00", 8);
  f.write(reinterpret_cast<char*>(&hl), 2);
  f.write(h.data(), static_cast<std::streamsize>(h.size()));
  f.write(arr.data.data(), static_cast<std::streamsize>(arr.data.size()));
  if (!f) Fatal("write failed: " + path);
}

// A host array as a CPU tensor (a copy).
at::Tensor ToTensor(const HostArray& arr) {
  at::Tensor t = at::empty(arr.dims, at::TensorOptions().dtype(arr.dtype->type));
  if (!arr.data.empty()) std::memcpy(t.data_ptr(), arr.data.data(), arr.data.size());
  return t;
}

// A tensor on any device as a host array; floats other than those numpy
// reads (bf16) widen to f32 on the host, as the port's to_host does.
HostArray FromTensor(const at::Tensor& tensor) {
  at::Tensor t = tensor.to(at::kCPU).contiguous();
  if (t.is_floating_point() && DtypeByType(t.scalar_type()) == nullptr)
    t = t.to(at::kFloat);
  HostArray arr;
  arr.dtype = DtypeByType(t.scalar_type());
  if (arr.dtype == nullptr)
    Fatal(std::string("output dtype ") + c10::toString(t.scalar_type()) +
          " has no .npy form here");
  arr.dims.assign(t.sizes().begin(), t.sizes().end());
  arr.data.resize(t.nbytes());
  if (!arr.data.empty()) std::memcpy(arr.data.data(), t.data_ptr(), t.nbytes());
  return arr;
}

// --arg TYPE:value scalar (rank 0), TYPE in i32, i64, f32.
bool ParseScalarArg(const std::string& spec, at::Tensor* out) {
  size_t c = spec.find(':');
  if (c == std::string::npos) return false;
  std::string t = spec.substr(0, c), v = spec.substr(c + 1);
  try {
    if (t == "i32") {
      *out = at::scalar_tensor(static_cast<int64_t>(std::stoll(v)),
                               at::TensorOptions().dtype(at::kInt));
    } else if (t == "i64") {
      *out = at::scalar_tensor(static_cast<int64_t>(std::stoll(v)),
                               at::TensorOptions().dtype(at::kLong));
    } else if (t == "f32") {
      *out = at::scalar_tensor(std::stod(v),
                               at::TensorOptions().dtype(at::kFloat));
    } else {
      return false;
    }
  } catch (const std::exception&) {
    Fatal("bad scalar argument '" + spec + "'");
  }
  return true;
}

at::Tensor ParseArg(const std::string& spec) {
  at::Tensor t;
  if (ParseScalarArg(spec, &t)) return t;
  return ToTensor(ReadNpy(spec));
}

std::string ShapesJson(const std::vector<at::Tensor>& outs,
                       const std::string& prefix) {
  std::ostringstream shapes;
  shapes << "[";
  for (size_t o = 0; o < outs.size(); o++) {
    if (!prefix.empty())
      WriteNpy(prefix + "_" + std::to_string(o) + ".npy", FromTensor(outs[o]));
    shapes << (o ? ", " : "") << "[";
    for (size_t d = 0; d < static_cast<size_t>(outs[o].dim()); d++)
      shapes << (d ? ", " : "") << outs[o].size(static_cast<int64_t>(d));
    shapes << "]";
  }
  shapes << "]";
  return shapes.str();
}

// ---------------------------------------------------------------------------
// Minimal JSON parser — enough for the machine-written manifest.json and
// vocab.json. Strict bounds, depth-limited; hostile input is a clean
// FatalError.
// ---------------------------------------------------------------------------

struct Json {
  enum Kind { kNull, kBool, kNum, kStr, kArr, kObj } kind = kNull;
  bool b = false;
  double num = 0;
  std::string str;
  std::vector<Json> arr;
  std::vector<std::pair<std::string, Json>> obj;

  const Json* Find(const std::string& key) const {
    for (const auto& kv : obj)
      if (kv.first == key) return &kv.second;
    return nullptr;
  }
  const Json& At(const std::string& key) const {
    const Json* v = Find(key);
    if (v == nullptr) Fatal("json: missing key '" + key + "'");
    return *v;
  }
  int64_t AsInt() const {
    if (kind != kNum) Fatal("json: expected number");
    return static_cast<int64_t>(num);
  }
  const std::string& AsStr() const {
    if (kind != kStr) Fatal("json: expected string");
    return str;
  }
  const std::vector<Json>& AsArr() const {
    if (kind != kArr) Fatal("json: expected array");
    return arr;
  }
};

class JsonParser {
 public:
  explicit JsonParser(const std::string& text)
      : p_(text.data()), end_(text.data() + text.size()) {}

  Json Parse() {
    Json v = ParseValue(0);
    SkipWs();
    if (p_ != end_) Fatal("json: trailing garbage");
    return v;
  }

 private:
  void SkipWs() {
    while (p_ != end_ &&
           (*p_ == ' ' || *p_ == '\t' || *p_ == '\n' || *p_ == '\r'))
      p_++;
  }
  char Peek() {
    SkipWs();
    if (p_ == end_) Fatal("json: unexpected end");
    return *p_;
  }
  void Expect(char c) {
    if (Peek() != c) Fatal(std::string("json: expected '") + c + "'");
    p_++;
  }
  bool Eat(const char* lit) {
    size_t n = std::strlen(lit);
    if (static_cast<size_t>(end_ - p_) >= n && std::memcmp(p_, lit, n) == 0) {
      p_ += n;
      return true;
    }
    return false;
  }
  Json ParseValue(int depth) {
    if (depth > 32) Fatal("json: nesting too deep");
    switch (Peek()) {
      case '{': {
        Json v;
        v.kind = Json::kObj;
        p_++;
        if (Peek() == '}') {
          p_++;
          return v;
        }
        while (true) {
          std::string key = ParseString();
          Expect(':');
          v.obj.emplace_back(std::move(key), ParseValue(depth + 1));
          char c = Peek();
          p_++;
          if (c == '}') return v;
          if (c != ',') Fatal("json: expected ',' or '}'");
        }
      }
      case '[': {
        Json v;
        v.kind = Json::kArr;
        p_++;
        if (Peek() == ']') {
          p_++;
          return v;
        }
        while (true) {
          v.arr.push_back(ParseValue(depth + 1));
          char c = Peek();
          p_++;
          if (c == ']') return v;
          if (c != ',') Fatal("json: expected ',' or ']'");
        }
      }
      case '"': {
        Json v;
        v.kind = Json::kStr;
        v.str = ParseString();
        return v;
      }
      default: {
        SkipWs();
        Json v;
        if (Eat("true")) {
          v.kind = Json::kBool;
          v.b = true;
          return v;
        }
        if (Eat("false")) {
          v.kind = Json::kBool;
          return v;
        }
        if (Eat("null")) return v;
        const char* start = p_;
        while (p_ != end_ &&
               (std::isdigit(static_cast<unsigned char>(*p_)) || *p_ == '-' ||
                *p_ == '+' || *p_ == '.' || *p_ == 'e' || *p_ == 'E'))
          p_++;
        if (p_ == start) Fatal("json: unexpected character");
        try {
          v.num = std::stod(std::string(start, p_));
        } catch (const std::exception&) {
          Fatal("json: malformed number");
        }
        v.kind = Json::kNum;
        return v;
      }
    }
  }
  std::string ParseString() {
    Expect('"');
    std::string out;
    while (true) {
      if (p_ == end_) Fatal("json: unterminated string");
      char c = *p_++;
      if (c == '"') return out;
      if (c != '\\') {
        out += c;
        continue;
      }
      if (p_ == end_) Fatal("json: bad escape");
      char e = *p_++;
      switch (e) {
        case '"': out += '"'; break;
        case '\\': out += '\\'; break;
        case '/': out += '/'; break;
        case 'n': out += '\n'; break;
        case 't': out += '\t'; break;
        case 'r': out += '\r'; break;
        case 'b': out += '\b'; break;
        case 'f': out += '\f'; break;
        case 'u': {
          // Artifact files are ASCII; BMP escapes beyond it decode to '?'.
          if (end_ - p_ < 4) Fatal("json: bad \\u escape");
          int code = 0;
          for (int i = 0; i < 4; i++) {
            char h = *p_++;
            code <<= 4;
            if (h >= '0' && h <= '9') code += h - '0';
            else if (h >= 'a' && h <= 'f') code += h - 'a' + 10;
            else if (h >= 'A' && h <= 'F') code += h - 'A' + 10;
            else Fatal("json: bad \\u escape");
          }
          out += code < 128 ? static_cast<char>(code) : '?';
          break;
        }
        default:
          Fatal("json: unknown escape");
      }
    }
  }
  const char* p_;
  const char* end_;
};

// ---------------------------------------------------------------------------
// Host text frontend: vocab.json + CMUdict lexicon. The Python frontend owns
// normalization and the neural G2P; this maps normalized words to stress-
// stripped ARPABET ids with the <UNK> fallback, as the port's
// create_text_processor(use_g2p=False) does for lexicon words.
// ---------------------------------------------------------------------------

struct Frontend {
  std::unordered_map<std::string, int64_t> vocab;
  std::unordered_map<std::string, std::vector<std::string>> lexicon;
  int64_t pad_id = 0, unk_id = 1;

  void LoadVocab(const std::string& path) {
    Json v = JsonParser(ReadFile(path)).Parse();
    if (v.kind != Json::kObj) Fatal(path + ": vocab.json must be an object");
    for (const auto& kv : v.obj) vocab[kv.first] = kv.second.AsInt();
    auto pad = vocab.find("<PAD>"), unk = vocab.find("<UNK>");
    if (pad != vocab.end()) pad_id = pad->second;
    if (unk != vocab.end()) unk_id = unk->second;
  }

  static std::string StripStress(const std::string& phone) {
    std::string out = phone;
    while (!out.empty() && std::isdigit(static_cast<unsigned char>(out.back())))
      out.pop_back();
    return out;
  }

  void LoadLexicon(const std::string& path) {
    std::ifstream f(path);
    if (!f) Fatal("cannot open lexicon " + path);
    std::string line;
    while (std::getline(f, line)) {
      if (line.empty() || line[0] == ';') continue;
      std::stringstream ss(line);
      std::string word;
      ss >> word;
      if (word.empty()) continue;
      // alternate pronunciations "WORD(2)": the first one wins
      if (word.back() == ')') continue;
      std::transform(word.begin(), word.end(), word.begin(),
                     [](unsigned char c) { return std::tolower(c); });
      if (lexicon.count(word)) continue;
      std::vector<std::string> phones;
      std::string ph;
      while (ss >> ph) phones.push_back(StripStress(ph));
      if (!phones.empty()) lexicon.emplace(std::move(word), std::move(phones));
    }
    if (lexicon.empty()) Fatal(path + ": no lexicon entries parsed");
  }

  // normalized text → vocab ids (lowercase, strip non-alpha/apostrophe,
  // lexicon lookup with an apostrophe-less retry, <UNK> fallback).
  std::vector<int64_t> TextToIds(const std::string& text) const {
    std::vector<int64_t> ids;
    std::string word;
    auto flush = [&]() {
      if (word.empty()) return;
      const std::vector<std::string>* phones = nullptr;
      auto it = lexicon.find(word);
      if (it != lexicon.end()) {
        phones = &it->second;
      } else if (word.find('\'') != std::string::npos) {
        std::string plain;
        for (char c : word)
          if (c != '\'') plain += c;
        auto it2 = lexicon.find(plain);
        if (it2 != lexicon.end()) phones = &it2->second;
      }
      if (phones == nullptr) {
        ids.push_back(unk_id);
      } else {
        for (const std::string& p : *phones) {
          auto v = vocab.find(p);
          ids.push_back(v == vocab.end() ? unk_id : v->second);
        }
      }
      word.clear();
    };
    for (char ch : text) {
      unsigned char c = static_cast<unsigned char>(ch);
      if (std::isalpha(c)) word += static_cast<char>(std::tolower(c));
      else if (ch == '\'') word += ch;
      else flush();
    }
    flush();
    if (ids.empty()) ids.push_back(unk_id);
    return ids;
  }

  static std::vector<int64_t> ParseIdsCsv(const std::string& csv) {
    std::vector<int64_t> ids;
    std::stringstream ss(csv);
    std::string tok;
    while (std::getline(ss, tok, ',')) {
      try {
        ids.push_back(static_cast<int64_t>(std::stoll(tok)));
      } catch (const std::exception&) {
        Fatal("bad id token '" + tok + "'");
      }
    }
    if (ids.empty()) Fatal("empty id list");
    return ids;
  }
};

// ---------------------------------------------------------------------------
// Device: parse, check, pin the port's numerics.
// ---------------------------------------------------------------------------

c10::Device ParseDevice(const std::string& spec) {
  if (spec != "cpu" && spec != "cuda" && spec.rfind("cuda:", 0) != 0)
    Fatal("--device wants cpu, cuda or cuda:N, not '" + spec + "'");
  try {
    c10::Device d(spec);
    if (d.is_cuda() && !d.has_index()) d.set_index(0);
    return d;
  } catch (const std::exception&) {
    Fatal("--device wants cpu, cuda or cuda:N, not '" + spec + "'");
  }
}

// Refuses a CUDA device that does not exist (there is no CPU fallback) and
// makes f32 mean f32 on the card, as the port's runtime.pin_math_precision
// does for Python: cuDNN and cuBLAS otherwise default to TF32, and cuBLAS
// may reduce a bf16 product's partial sums in bf16.
void OpenDevice(const c10::Device& device) {
  if (device.is_cuda()) {
    if (!torch::cuda::is_available())
      Fatal("--device " + device.str() +
            ": no CUDA device is available to this process (pass --device "
            "cpu to run on the CPU with an artifact exported there)");
    if (device.index() >= torch::cuda::device_count())
      Fatal("--device " + device.str() + ": only " +
            std::to_string(torch::cuda::device_count()) + " CUDA device(s)");
  }
  at::globalContext().setAllowTF32CuDNN(false);
  at::globalContext().setAllowTF32CuBLAS(false);
  at::globalContext().setAllowBF16ReductionCuBLAS(false);
}

void Sync(const c10::Device& device) {
  if (device.is_cuda()) torch::cuda::synchronize(device.index());
}

// The name libcuda gives device `index` (the library is loaded at run
// time, so the host needs no CUDA headers to build).
std::string CudaDeviceName(int index) {
  void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
  if (h == nullptr) return "unknown";
  auto init = reinterpret_cast<int (*)(unsigned)>(dlsym(h, "cuInit"));
  auto get = reinterpret_cast<int (*)(int*, int)>(dlsym(h, "cuDeviceGet"));
  auto name =
      reinterpret_cast<int (*)(char*, int, int)>(dlsym(h, "cuDeviceGetName"));
  char buf[256] = {0};
  int dev = 0;
  if (init == nullptr || get == nullptr || name == nullptr || init(0) != 0 ||
      get(&dev, index) != 0 || name(buf, sizeof(buf) - 1, dev) != 0)
    return "unknown";
  return buf;
}

// A generator on `device` seeded with `seed`: what Python's
// torch.Generator(device).manual_seed(seed) gives, so randn draws the same
// numbers on the same device.
at::Generator SeededGenerator(const c10::Device& device, int64_t seed) {
  at::Generator gen;
  if (device.is_cpu()) {
    gen = at::detail::createCPUGenerator();
  } else {
    at::Generator def = at::globalContext().defaultGenerator(device);
    std::lock_guard<std::mutex> lock(def.mutex());
    gen = def.clone();
  }
  std::lock_guard<std::mutex> lock(gen.mutex());
  gen.set_current_seed(static_cast<uint64_t>(seed));
  return gen;
}

using Loader = torch::inductor::AOTIModelPackageLoader;

std::unique_ptr<Loader> LoadPackage(const std::string& path,
                                    const c10::Device& device) {
  std::ifstream probe(path, std::ios::binary);
  if (!probe) Fatal("cannot open " + path);
  try {
    return std::make_unique<Loader>(path, "model", false, 1,
                                    device.is_cuda() ? device.index() : -1);
  } catch (const c10::Error& e) {
    Fatal(path + ": AOTInductor load failed: " + e.what_without_backtrace());
  }
}

std::vector<at::Tensor> RunPackage(Loader* loader,
                                   const std::vector<at::Tensor>& inputs) {
  try {
    return loader->run(inputs);
  } catch (const c10::Error& e) {
    Fatal(std::string("AOTInductor run failed: ") + e.what_without_backtrace());
  }
}

// ---------------------------------------------------------------------------
// Artifact serving host: manifest + every bucket's package + vocab (+
// lexicon) → long-lived text/ids request loop.
// ---------------------------------------------------------------------------

constexpr int64_t kFormatVersion = 1;  // serve/export.py AOT_FORMAT_VERSION

struct Bucket {
  int64_t batch = 0, phonemes = 0, frames = 0;
  std::string package_path;
  std::unique_ptr<Loader> loader;  // loaded up front, or at first use
  double load_ms = 0, warm_ms = 0;
};

struct ArtifactHost {
  c10::Device device{c10::kCPU};
  Frontend frontend;
  std::vector<Bucket> buckets;  // sorted by (phonemes, batch)
  std::string exported_on;
  at::ScalarType dtype = at::kFloat;
  int64_t sample_rate = 22050, samples_per_frame = 256;
  int64_t latent_dim = 0, down_factor = 1, frames_per_phoneme = 1;
  std::vector<int64_t> frame_buckets;
  bool dry_run = false, write_npy = false;

  void Load(const std::string& dir) {
    Json manifest = JsonParser(ReadFile(dir + "/manifest.json")).Parse();
    int64_t fmt = manifest.At("format_version").AsInt();
    if (fmt != kFormatVersion)
      Fatal("artifact format_version " + std::to_string(fmt) +
            " unsupported (want " + std::to_string(kFormatVersion) +
            ") — re-export with python -m iris_tts_tpu_torch.serve.export "
            "--native");
    exported_on = manifest.At("device").AsStr();
    const std::string& dt = manifest.At("dtype").AsStr();
    if (dt == "float32") dtype = at::kFloat;
    else if (dt == "bfloat16") dtype = at::kBFloat16;
    else Fatal("artifact dtype '" + dt + "' unsupported");
    sample_rate = manifest.At("sample_rate").AsInt();
    samples_per_frame = manifest.At("samples_per_frame").AsInt();
    latent_dim = manifest.At("latent_dim").AsInt();
    down_factor = manifest.At("down_factor").AsInt();
    frames_per_phoneme = manifest.At("fused_frames_per_phoneme").AsInt();
    for (const Json& f : manifest.At("frame_buckets").AsArr())
      frame_buckets.push_back(f.AsInt());
    if (frame_buckets.empty() || down_factor < 1 || latent_dim < 1)
      Fatal("artifact manifest has no frame ladder or latent shape");
    if (!dry_run) {
      const Json* torch_version = manifest.Find("native_torch");
      if (torch_version == nullptr ||
          torch_version->AsStr() != IRIS_TORCH_VERSION)
        Fatal(std::string("artifact packages were compiled by torch ") +
              (torch_version ? torch_version->AsStr() : "(none)") +
              ", this host links " + IRIS_TORCH_VERSION +
              " — re-export with --native under this torch");
    }
    for (const Json& e : manifest.At("entries").AsArr()) {
      Bucket b;
      b.batch = e.At("batch").AsInt();
      b.phonemes = e.At("phoneme_bucket").AsInt();
      b.frames = e.At("frame_bucket").AsInt();
      const Json* nf = e.Find("native_file");
      if (nf == nullptr)
        Fatal("artifact entry " + e.At("file").AsStr() +
              " has no native_file — re-export with python -m "
              "iris_tts_tpu_torch.serve.export --native");
      b.package_path = dir + "/" + nf->AsStr();
      buckets.push_back(std::move(b));
    }
    if (buckets.empty()) Fatal("artifact has no synthesis entries");
    std::sort(buckets.begin(), buckets.end(),
              [](const Bucket& a, const Bucket& b) {
                return a.phonemes != b.phonemes ? a.phonemes < b.phonemes
                                                 : a.batch < b.batch;
              });
    frontend.LoadVocab(dir + "/vocab.json");
  }

  // The device this host serves on must be the one the programs were
  // exported for: their device literals are baked in.
  void CheckDevice() const {
    if (c10::Device(exported_on).type() != device.type())
      Fatal("artifact was exported for " + exported_on + ", --device " +
            device.str() + " cannot serve it — export on the device type "
            "that serves");
  }

  // The port's _pick_bucket for one row: the smallest phoneme bucket that
  // fits, then the smallest batch at it.
  Bucket* Pick(size_t n_ids) {
    for (Bucket& b : buckets)
      if (static_cast<size_t>(b.phonemes) >= n_ids) return &b;
    return nullptr;
  }

  // Loads a bucket's package and runs it once, so that the first request
  // does not pay for the first use of its kernels and libraries.
  void EnsureLoaded(Bucket* b) {
    if (b->loader != nullptr || dry_run) return;
    double t0 = NowMs();
    b->loader = LoadPackage(b->package_path, device);
    b->load_ms = NowMs() - t0;
    t0 = NowMs();
    {
      c10::InferenceMode guard;
      RunPackage(b->loader.get(), Inputs(*b, {frontend.unk_id}, 0, 0.0));
      Sync(device);
    }
    b->warm_ms = NowMs() - t0;
    std::fprintf(stderr, "aoti_runner: loaded b%ld_p%ld (%.0f ms, first "
                 "run %.0f ms)\n", static_cast<long>(b->batch),
                 static_cast<long>(b->phonemes), b->load_ms, b->warm_ms);
  }

  void LoadAll() {
    for (Bucket& b : buckets) EnsureLoaded(&b);
  }

  // serve/export.py live_frame_budget: the live fused path's frame budget
  // for `n` ids, from the manifest's ladder.
  int64_t LiveFrameBudget(int64_t n) const {
    int64_t est = std::max(n * frames_per_phoneme, down_factor);
    est = (est + down_factor - 1) / down_factor * down_factor;
    for (int64_t f : frame_buckets)
      if (est <= f) return f;
    return frame_buckets.back();
  }

  // serve/export.py _request_inputs + _fill_synth_inputs, on the device:
  // one row of ids padded with <PAD> (unused rows: <PAD>, length 1), the
  // live path's noise in front of a zeroed eps, the temperature as a 0-d
  // f32.
  std::vector<at::Tensor> Inputs(const Bucket& b,
                                 const std::vector<int64_t>& ids, int64_t seed,
                                 double temperature) const {
    at::Tensor ids_h = at::full({b.batch, b.phonemes}, frontend.pad_id,
                                at::TensorOptions().dtype(at::kLong));
    std::memcpy(ids_h.data_ptr<int64_t>(), ids.data(),
                ids.size() * sizeof(int64_t));
    at::Tensor len_h = at::ones({b.batch}, at::TensorOptions().dtype(at::kLong));
    len_h.data_ptr<int64_t>()[0] = static_cast<int64_t>(ids.size());
    int64_t live = LiveFrameBudget(static_cast<int64_t>(ids.size()));
    if (live > b.frames)
      Fatal("bucket frame budget " + std::to_string(b.frames) +
            " is under the live budget " + std::to_string(live) +
            " — re-export the artifact");
    at::TensorOptions on_device = at::TensorOptions().device(device);
    at::Tensor noise = at::randn({1, latent_dim, live / down_factor},
                                 SeededGenerator(device, seed),
                                 on_device.dtype(at::kFloat))
                           .to(dtype);
    at::Tensor eps = at::zeros({b.batch, latent_dim, b.frames / down_factor},
                               on_device.dtype(dtype));
    eps.narrow(0, 0, 1).narrow(2, 0, noise.size(2)).copy_(noise);
    return {ids_h.to(device), len_h.to(device), eps,
            at::scalar_tensor(temperature, on_device.dtype(at::kFloat))};
  }

  // One request: ids → the bucket's inputs → run → trim → wav. Returns the
  // JSON reply line.
  std::string Handle(const std::vector<int64_t>& ids, int64_t seed,
                     double temperature, const std::string& out_base) {
    double t_start = NowMs();
    Bucket* b = Pick(ids.size());
    if (b == nullptr)
      Fatal("no exported bucket fits " + std::to_string(ids.size()) +
            " ids (largest is " + std::to_string(buckets.back().phonemes) +
            ") — split the text or re-export with bigger buckets");
    if (dry_run) {
      std::ostringstream js;
      js << "{\"dry_run\": true, \"bucket\": [" << b->batch << ", "
         << b->phonemes << "], \"n_ids\": " << ids.size() << ", \"ids\": [";
      for (size_t i = 0; i < ids.size(); i++) js << (i ? ", " : "") << ids[i];
      js << "]}";
      return js.str();
    }
    EnsureLoaded(b);
    c10::InferenceMode guard;
    double t0 = NowMs();
    std::vector<at::Tensor> inputs = Inputs(*b, ids, seed, temperature);
    Sync(device);
    double upload_ms = NowMs() - t0;

    t0 = NowMs();
    std::vector<at::Tensor> out = RunPackage(b->loader.get(), inputs);
    Sync(device);
    double run_ms = NowMs() - t0;
    // outputs: audio [B, T·hop], mel [B, T, n_mels] (the compute dtype),
    // n_frames [B] int32, deficit [B]
    if (out.size() != 4)
      Fatal(b->package_path + ": package has " + std::to_string(out.size()) +
            " outputs, format_version 1 wants 4 — re-export the artifact");

    t0 = NowMs();
    int64_t n_frames = out[2].select(0, 0).item<int64_t>();
    int64_t deficit = out[3].select(0, 0).item<int64_t>();
    int64_t row = out[0].size(1);
    int64_t n_samples = std::min(n_frames * samples_per_frame, row);
    HostArray audio = FromTensor(out[0].select(0, 0).narrow(0, 0, n_samples));
    HostArray mel;
    if (write_npy) mel = FromTensor(out[1]);
    double fetch_ms = NowMs() - t0;

    std::string wav_path = out_base + ".wav";
    if (iris_write_wav_pcm16(wav_path.c_str(),
                             reinterpret_cast<const float*>(audio.data.data()),
                             n_samples, static_cast<int>(sample_rate)) != 0)
      Fatal("wav write failed: " + wav_path);
    if (write_npy) {
      WriteNpy(out_base + "_audio.npy", audio);
      WriteNpy(out_base + "_mel.npy", mel);
    }
    std::ostringstream js;
    js << "{\"bucket\": [" << b->batch << ", " << b->phonemes << "], "
       << "\"n_ids\": " << ids.size() << ", \"ids\": [";
    for (size_t i = 0; i < ids.size(); i++) js << (i ? ", " : "") << ids[i];
    js << "], \"n_frames\": " << n_frames << ", \"deficit\": " << deficit
       << ", \"audio_s\": " << static_cast<double>(n_samples) / sample_rate
       << ", \"upload_ms\": " << upload_ms << ", \"run_ms\": " << run_ms
       << ", \"fetch_ms\": " << fetch_ms
       << ", \"exec_fetch_ms\": " << run_ms + fetch_ms
       << ", \"total_ms\": " << NowMs() - t_start << ", \"wav\": \""
       << JsonEscape(wav_path) << "\"}";
    return js.str();
  }

  // The stdin loop: synth/ids requests, tab-separated (see the file
  // header). Every line gets one reply; a bad one an error reply.
  int Serve() {
    std::fprintf(stderr,
                 "aoti_runner: serving — "
                 "synth\\tout_base\\tseed\\ttemp\\ttext  |  "
                 "ids\\tout_base\\tseed\\ttemp\\tid,id,...\n");
    std::string line;
    while (std::getline(std::cin, line)) {
      if (line.empty()) continue;
      try {
        std::vector<std::string> f;
        size_t pos = 0;
        while (f.size() < 4) {
          size_t tab = line.find('\t', pos);
          if (tab == std::string::npos) break;
          f.push_back(line.substr(pos, tab - pos));
          pos = tab + 1;
        }
        f.push_back(line.substr(pos));
        if (f.size() != 5)
          Fatal("request wants 5 tab-separated fields: "
                "verb, out_base, seed, temperature, payload");
        const std::string &verb = f[0], &out_base = f[1];
        int64_t seed = 0;
        double temperature = 0;
        try {
          seed = std::stoll(f[2]);
          temperature = std::stod(f[3]);
        } catch (const std::exception&) {
          Fatal("bad seed or temperature");
        }
        // The port's one seed normalisation (runtime.wrap_int32).
        seed = static_cast<int32_t>(static_cast<uint32_t>(
            static_cast<uint64_t>(seed)));
        std::vector<int64_t> ids;
        if (verb == "synth") ids = frontend.TextToIds(f[4]);
        else if (verb == "ids") ids = Frontend::ParseIdsCsv(f[4]);
        else Fatal("unknown verb '" + verb + "' (synth|ids)");
        std::string reply = Handle(ids, seed, temperature, out_base);
        std::printf("%s\n", reply.c_str());
      } catch (const FatalError& e) {
        std::printf("{\"error\": \"%s\"}\n", JsonEscape(e.msg).c_str());
      } catch (const c10::Error& e) {
        std::printf("{\"error\": \"%s\"}\n",
                    JsonEscape(e.what_without_backtrace()).c_str());
      } catch (const std::exception& e) {
        std::printf("{\"error\": \"%s\"}\n", JsonEscape(e.what()).c_str());
      }
      std::fflush(stdout);
    }
    return 0;
  }
};

int Probe() {
  bool cuda = torch::cuda::is_available();
  int n = cuda ? static_cast<int>(torch::cuda::device_count()) : 0;
  std::ostringstream js;
  js << "{\"libtorch\": \"" << IRIS_TORCH_VERSION
     << "\", \"cuda_available\": " << (cuda ? "true" : "false")
     << ", \"device_count\": " << n << ", \"devices\": [";
  for (int i = 0; i < n; i++)
    js << (i ? ", " : "") << "\"" << JsonEscape(CudaDeviceName(i)) << "\"";
  js << "]}";
  std::printf("%s\n", js.str().c_str());
  return 0;
}

int Run(int argc, char** argv) {
  std::string package_path, out_prefix, artifact_dir, lexicon_path;
  std::string device_spec = "cuda:0";
  std::vector<std::string> arg_specs;
  bool probe = false, serve = false, lazy = false, dry_run = false;
  bool write_npy = false;
  int iters = 1;
  for (int i = 1; i < argc; i++) {
    std::string a = argv[i];
    auto next = [&]() -> std::string {
      if (i + 1 >= argc) Fatal(a + " wants a value");
      return argv[++i];
    };
    if (a == "--npy-roundtrip") {
      std::string in = next(), out = next();
      HostArray arr = ReadNpy(in);
      WriteNpy(out, arr);
      std::printf("{\"roundtrip\": true, \"bytes\": %zu}\n", arr.data.size());
      return 0;
    }
    if (a == "--probe") probe = true;
    else if (a == "--package") package_path = next();
    else if (a == "--artifact") artifact_dir = next();
    else if (a == "--lexicon") lexicon_path = next();
    else if (a == "--lazy") lazy = true;
    else if (a == "--dry-run") dry_run = true;
    else if (a == "--npy") write_npy = true;
    else if (a == "--arg") arg_specs.push_back(next());
    else if (a == "--iters") {
      try {
        iters = std::stoi(next());
      } catch (const std::exception&) {
        Fatal("--iters wants a positive integer");
      }
      if (iters < 1) Fatal("--iters wants a positive integer");
    } else if (a == "--out-prefix") out_prefix = next();
    else if (a == "--device") device_spec = next();
    else if (a == "--serve") serve = true;
    else Fatal("unknown flag " + a);
  }
  if (probe) return Probe();
  c10::Device device = ParseDevice(device_spec);

  // ---- artifact serving host ----------------------------------------------
  if (!artifact_dir.empty()) {
    ArtifactHost host;
    host.dry_run = dry_run;
    host.write_npy = write_npy;
    host.device = device;
    double t0 = NowMs();
    host.Load(artifact_dir);
    if (!lexicon_path.empty()) host.frontend.LoadLexicon(lexicon_path);
    if (!dry_run) {
      OpenDevice(device);
      host.CheckDevice();
      if (!lazy) host.LoadAll();
    }
    double cold_ms = NowMs() - t0;
    std::ostringstream ready;
    ready << "{\"ready\": true, \"buckets\": [";
    for (size_t i = 0; i < host.buckets.size(); i++)
      ready << (i ? ", " : "") << "[" << host.buckets[i].batch << ", "
            << host.buckets[i].phonemes << "]";
    ready << "], \"lexicon_words\": " << host.frontend.lexicon.size()
          << ", \"vocab\": " << host.frontend.vocab.size()
          << ", \"device\": \"" << (dry_run ? "none" : device.str())
          << "\", \"cold_start_ms\": " << cold_ms;
    double load_ms = 0, warm_ms = 0;
    for (const Bucket& b : host.buckets) {
      load_ms += b.load_ms;
      warm_ms += b.warm_ms;
    }
    ready << ", \"load_ms\": " << load_ms << ", \"first_run_ms\": "
          << warm_ms << "}";
    std::printf("%s\n", ready.str().c_str());
    std::fflush(stdout);
    return host.Serve();
  }

  if (package_path.empty())
    Fatal("--package is required (or --probe / --artifact / "
          "--npy-roundtrip)");
  OpenDevice(device);
  c10::InferenceMode guard;
  double t0 = NowMs();
  std::unique_ptr<Loader> loader = LoadPackage(package_path, device);
  double load_ms = NowMs() - t0;
  std::fprintf(stderr, "aoti_runner: loaded %s (%.0f ms)\n",
               package_path.c_str(), load_ms);

  auto upload = [&](const std::vector<std::string>& specs) {
    std::vector<at::Tensor> ins;
    for (const std::string& s : specs) ins.push_back(ParseArg(s).to(device));
    return ins;
  };

  if (serve) {
    std::fprintf(stderr, "aoti_runner: serving (package loaded; one request "
                         "per line: args... out-prefix)\n");
    std::string line;
    while (std::getline(std::cin, line)) {
      if (line.empty()) continue;
      std::stringstream ss(line);
      std::vector<std::string> toks;
      std::string t;
      while (ss >> t) toks.push_back(t);
      // A bad request (missing .npy, wrong shape or dtype, a run error)
      // must not take the server down: an error reply, and keep serving.
      try {
        if (toks.size() < 2) Fatal("request wants: args... out-prefix");
        std::string prefix = toks.back();
        toks.pop_back();
        std::vector<at::Tensor> ins = upload(toks);
        double s = NowMs();
        std::vector<at::Tensor> outs = RunPackage(loader.get(), ins);
        Sync(device);
        std::string shapes = ShapesJson(outs, prefix);
        std::printf("{\"run_fetch_ms\": %.3f, \"output_shapes\": %s}\n",
                    NowMs() - s, shapes.c_str());
      } catch (const FatalError& e) {
        std::printf("{\"error\": \"%s\"}\n", JsonEscape(e.msg).c_str());
      } catch (const c10::Error& e) {
        std::printf("{\"error\": \"%s\"}\n",
                    JsonEscape(e.what_without_backtrace()).c_str());
      }
      std::fflush(stdout);
    }
    return 0;
  }

  // One-shot: upload the --arg inputs once, run --iters times.
  std::vector<at::Tensor> ins = upload(arg_specs);
  std::vector<at::Tensor> outs;
  double total_ms = 0;
  for (int it = 0; it < iters; it++) {
    double s = NowMs();
    outs = RunPackage(loader.get(), ins);
    Sync(device);
    total_ms += NowMs() - s;
  }
  std::string shapes = ShapesJson(outs, out_prefix);
  std::printf(
      "{\"load_ms\": %.1f, \"iters\": %d, \"mean_run_ms\": %.3f, "
      "\"num_outputs\": %zu, \"output_shapes\": %s}\n",
      load_ms, iters, total_ms / iters, outs.size(), shapes.c_str());
  return 0;
}

}  // namespace

int main(int argc, char** argv) {
  try {
    return Run(argc, argv);
  } catch (const FatalError& e) {
    std::fprintf(stderr, "aoti_runner: %s\n", e.msg.c_str());
    return 1;
  } catch (const c10::Error& e) {
    std::fprintf(stderr, "aoti_runner: %s\n", e.what_without_backtrace());
    return 1;
  } catch (const std::exception& e) {
    // No hostile input may reach std::terminate: a malformed file is a
    // clean diagnostic and exit 1.
    std::fprintf(stderr, "aoti_runner: error: %s\n", e.what());
    return 1;
  }
}
