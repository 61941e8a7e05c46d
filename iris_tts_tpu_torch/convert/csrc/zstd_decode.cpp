// Zstandard frame decoder (RFC 8878), with CRC-32C for the OCDBT reader.
//
// Built by convert/zstd.py with g++ at first use and bound with ctypes. It
// decodes whole frames into memory: raw, RLE and compressed blocks; raw,
// RLE, Huffman (1 or 4 streams) and treeless literals; predefined, RLE,
// FSE and repeat sequence tables with the repeat offsets; concatenated and
// skippable frames; any window size the format can state (the whole output
// stays in memory, so a match may reach back as far as the frame's start);
// the XXH64 content checksum where a frame carries one. Dictionaries are
// not supported. Malformed input fails with a message and never reads or
// writes out of bounds.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Error : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const char* what) { throw Error(what); }

inline void need(bool ok, const char* what) {
  if (!ok) fail(what);
}

constexpr uint32_t kFrameMagic = 0xFD2FB528u;
constexpr uint32_t kSkippableMask = 0xFFFFFFF0u;
constexpr uint32_t kSkippableMagic = 0x184D2A50u;
constexpr size_t kBlockMax = 128 * 1024;

inline uint32_t rd32(const uint8_t* p) {
  return uint32_t(p[0]) | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16 |
         uint32_t(p[3]) << 24;
}

inline uint64_t rd64(const uint8_t* p) {
  return uint64_t(rd32(p)) | uint64_t(rd32(p + 4)) << 32;
}

inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

// ---------------------------------------------------------------------------
// XXH64 (seed 0): the frame content checksum is its low 32 bits.
// ---------------------------------------------------------------------------

constexpr uint64_t P1 = 11400714785074694791ULL;
constexpr uint64_t P2 = 14029467366897019727ULL;
constexpr uint64_t P3 = 1609587929392839161ULL;
constexpr uint64_t P4 = 9650029242287828579ULL;
constexpr uint64_t P5 = 2870177450012600261ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

inline uint64_t xxround(uint64_t acc, uint64_t in) {
  acc += in * P2;
  return rotl(acc, 31) * P1;
}

inline uint64_t xxmerge(uint64_t h, uint64_t v) {
  h ^= xxround(0, v);
  return h * P1 + P4;
}

uint64_t xxh64(const uint8_t* p, size_t n) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    const uint8_t* limit = end - 32;
    do {
      v1 = xxround(v1, rd64(p));
      v2 = xxround(v2, rd64(p + 8));
      v3 = xxround(v3, rd64(p + 16));
      v4 = xxround(v4, rd64(p + 24));
      p += 32;
    } while (p <= limit);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xxmerge(h, v1);
    h = xxmerge(h, v2);
    h = xxmerge(h, v3);
    h = xxmerge(h, v4);
  } else {
    h = P5;
  }
  h += uint64_t(n);
  for (; p + 8 <= end; p += 8) {
    h ^= xxround(0, rd64(p));
    h = rotl(h, 27) * P1 + P4;
  }
  if (p + 4 <= end) {
    h ^= uint64_t(rd32(p)) * P1;
    h = rotl(h, 23) * P2 + P3;
    p += 4;
  }
  for (; p < end; ++p) {
    h ^= uint64_t(*p) * P5;
    h = rotl(h, 11) * P1;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ---------------------------------------------------------------------------
// CRC-32C (Castagnoli), as OCDBT's file trailers carry it.
// ---------------------------------------------------------------------------

struct Crc32cTable {
  uint32_t t[8][256];
  Crc32cTable() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c >> 1) ^ ((c & 1) ? 0x82F63B78u : 0);
      t[0][i] = c;
    }
    for (int s = 1; s < 8; ++s)
      for (int i = 0; i < 256; ++i)
        t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
  }
};

const Crc32cTable kCrc;

uint32_t crc32c(const uint8_t* p, size_t n) {
  uint32_t c = 0xFFFFFFFFu;
  for (; n >= 8; n -= 8, p += 8) {
    uint32_t lo = rd32(p) ^ c, hi = rd32(p + 4);
    c = kCrc.t[7][lo & 0xFF] ^ kCrc.t[6][(lo >> 8) & 0xFF] ^
        kCrc.t[5][(lo >> 16) & 0xFF] ^ kCrc.t[4][lo >> 24] ^
        kCrc.t[3][hi & 0xFF] ^ kCrc.t[2][(hi >> 8) & 0xFF] ^
        kCrc.t[1][(hi >> 16) & 0xFF] ^ kCrc.t[0][hi >> 24];
  }
  for (; n; --n, ++p) c = kCrc.t[0][(c ^ *p) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

// ---------------------------------------------------------------------------
// Bit readers
// ---------------------------------------------------------------------------

// Little-endian, least significant bit first (FSE table descriptions).
struct ForwardBits {
  const uint8_t* p;
  size_t size;
  size_t bit = 0;  // bits consumed
  uint32_t peek(int n) const {  // n <= 25; bits past the end read as 0
    size_t byte = bit >> 3;
    uint64_t v = 0;
    for (int i = 0; i < 5 && byte + i < size; ++i)
      v |= uint64_t(p[byte + i]) << (8 * i);
    return uint32_t(v >> (bit & 7)) & ((1u << n) - 1);
  }
  void skip(int n) { bit += n; }
};

// The backward bitstreams of Huffman literals and of sequences: read from
// the end towards the start, most significant bit first, after the
// padding up to and including the stream's highest set bit. A read past
// the start yields zero bits and leaves `pos` negative, which the callers
// treat as the stream's end (overflow).
struct BackwardBits {
  const uint8_t* p = nullptr;
  size_t size = 0;
  int64_t pos = 0;  // bits not yet consumed

  void init(const uint8_t* src, size_t n) {
    need(n > 0, "empty bitstream");
    uint8_t last = src[n - 1];
    need(last != 0, "bitstream has no end mark");
    p = src;
    size = n;
    pos = int64_t(n) * 8 - 8 + highbit(last);
  }
  // The n (<= 56) bits below `pos`, without consuming them.
  uint64_t peek(int n) const {
    if (n == 0) return 0;
    int64_t lo = pos - n;
    if (lo >= 0) {
      size_t byte = size_t(lo >> 3);
      uint64_t v;
      if (byte + 8 <= size) {
        v = rd64(p + byte);
      } else {
        v = 0;
        for (size_t i = 0; byte + i < size; ++i)
          v |= uint64_t(p[byte + i]) << (8 * i);
      }
      return (v >> (lo & 7)) & ((uint64_t(1) << n) - 1);
    }
    if (pos <= 0) return 0;
    // Fewer than n bits remain: they are the high bits, zeros below.
    uint64_t v = 0;
    for (int64_t i = 0; i < (pos + 7) / 8 && size_t(i) < size; ++i)
      v |= uint64_t(p[i]) << (8 * i);
    v &= (uint64_t(1) << pos) - 1;
    return v << (-lo);
  }
  uint64_t read(int n) {
    uint64_t v = peek(n);
    pos -= n;
    return v;
  }
  bool overflowed() const { return pos < 0; }
};

// ---------------------------------------------------------------------------
// FSE
// ---------------------------------------------------------------------------

struct FseEntry {
  uint16_t symbol;
  uint8_t bits;
  uint16_t base;
};

struct FseTable {
  int log = 0;
  std::vector<FseEntry> e;
  bool valid = false;

  void build(const int16_t* norm, int nsym, int accuracy_log) {
    log = accuracy_log;
    const int size = 1 << accuracy_log;
    e.assign(size, FseEntry{0, 0, 0});
    std::vector<uint32_t> next(nsym);
    int high = size - 1;
    for (int s = 0; s < nsym; ++s) {
      if (norm[s] == -1) {
        e[high--].symbol = uint16_t(s);
        next[s] = 1;
      } else {
        next[s] = uint32_t(norm[s]);
      }
    }
    const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
    int pos = 0;
    for (int s = 0; s < nsym; ++s) {
      for (int i = 0; i < norm[s]; ++i) {
        e[pos].symbol = uint16_t(s);
        do {
          pos = (pos + step) & mask;
        } while (pos > high);
      }
    }
    need(pos == 0, "corrupt FSE distribution");
    for (int st = 0; st < size; ++st) {
      uint32_t x = next[e[st].symbol]++;
      int bits = accuracy_log - highbit(x);
      e[st].bits = uint8_t(bits);
      e[st].base = uint16_t((x << bits) - size);
    }
    valid = true;
  }

  void rle(int symbol) {
    log = 0;
    e.assign(1, FseEntry{uint16_t(symbol), 0, 0});
    valid = true;
  }
};

// Reads an FSE table description; returns the bytes it took.
size_t read_fse_description(const uint8_t* src, size_t n, int max_log,
                            int max_symbol, FseTable& out) {
  need(n > 0, "truncated FSE table description");
  ForwardBits br{src, n};
  const int log = int(br.peek(4)) + 5;
  br.skip(4);
  need(log <= max_log, "FSE accuracy log too large");
  int16_t norm[256] = {0};
  int remaining = (1 << log) + 1;
  int threshold = 1 << log;
  int nbits = log + 1;
  int sym = 0;
  bool prev_zero = false;
  while (remaining > 1) {
    if (prev_zero) {
      for (;;) {
        int rep = int(br.peek(2));
        br.skip(2);
        sym += rep;
        need(sym <= max_symbol + 1, "too many FSE symbols");
        if (rep != 3) break;
      }
    }
    need(sym <= max_symbol, "too many FSE symbols");
    const int max = (2 * threshold - 1) - remaining;
    int count;
    const int low = int(br.peek(nbits - 1));
    if (low < max) {
      count = low;
      br.skip(nbits - 1);
    } else {
      count = int(br.peek(nbits));
      if (count >= threshold) count -= max;
      br.skip(nbits);
    }
    --count;
    remaining -= count < 0 ? -count : count;
    norm[sym++] = int16_t(count);
    prev_zero = count == 0;
    need(remaining >= 1, "corrupt FSE table description");
    while (remaining < threshold) {
      --nbits;
      threshold >>= 1;
    }
    need(br.bit <= n * 8, "truncated FSE table description");
  }
  need(remaining == 1, "corrupt FSE table description");
  const size_t used = (br.bit + 7) / 8;
  need(used <= n, "truncated FSE table description");
  out.build(norm, sym, log);
  return used;
}

// ---------------------------------------------------------------------------
// Huffman literals
// ---------------------------------------------------------------------------

struct HufEntry {
  uint8_t symbol;
  uint8_t bits;
};

struct HufTable {
  int log = 0;
  std::vector<HufEntry> e;
  bool valid = false;
};

// Reads a Huffman tree description into `t`; returns the bytes it took.
size_t read_huffman_tree(const uint8_t* src, size_t n, HufTable& t) {
  need(n > 0, "truncated Huffman tree description");
  uint8_t weights[256] = {0};
  int nw = 0;
  const int header = src[0];
  size_t used;
  if (header >= 128) {
    nw = header - 127;
    used = 1 + size_t(nw + 1) / 2;
    need(used <= n, "truncated Huffman tree description");
    for (int i = 0; i < nw; ++i) {
      uint8_t b = src[1 + i / 2];
      weights[i] = (i & 1) ? (b & 15) : (b >> 4);
    }
  } else {
    used = 1 + size_t(header);
    need(header > 0 && used <= n, "truncated Huffman tree description");
    FseTable ft;
    const size_t desc = read_fse_description(src + 1, header, 6, 255, ft);
    need(desc < size_t(header), "truncated Huffman weights");
    BackwardBits br;
    br.init(src + 1 + desc, header - desc);
    uint32_t s1 = uint32_t(br.read(ft.log)), s2 = uint32_t(br.read(ft.log));
    need(!br.overflowed(), "truncated Huffman weights");
    // Two interleaved states; when an update runs past the stream's start,
    // the other state gives the last weight.
    for (;;) {
      need(nw < 255, "too many Huffman weights");
      weights[nw++] = uint8_t(ft.e[s1].symbol);
      s1 = ft.e[s1].base + uint32_t(br.read(ft.e[s1].bits));
      if (br.overflowed()) {
        need(nw < 255, "too many Huffman weights");
        weights[nw++] = uint8_t(ft.e[s2].symbol);
        break;
      }
      need(nw < 255, "too many Huffman weights");
      weights[nw++] = uint8_t(ft.e[s2].symbol);
      s2 = ft.e[s2].base + uint32_t(br.read(ft.e[s2].bits));
      if (br.overflowed()) {
        need(nw < 255, "too many Huffman weights");
        weights[nw++] = uint8_t(ft.e[s1].symbol);
        break;
      }
    }
  }
  uint32_t total = 0;
  for (int i = 0; i < nw; ++i) {
    need(weights[i] <= 11, "Huffman weight too large");
    if (weights[i]) total += 1u << (weights[i] - 1);
  }
  need(total > 0, "empty Huffman tree");
  const int maxbits = highbit(total) + 1;
  need(maxbits <= 11, "Huffman tree too deep");
  const uint32_t rest = (1u << maxbits) - total;
  need((rest & (rest - 1)) == 0, "Huffman weights do not complete a tree");
  need(nw < 256, "too many Huffman weights");
  weights[nw++] = uint8_t(highbit(rest) + 1);

  uint32_t rank[13] = {0};
  for (int i = 0; i < nw; ++i) ++rank[weights[i]];
  need(rank[1] >= 2 && (rank[1] & 1) == 0, "corrupt Huffman tree");
  uint32_t start[13] = {0}, next = 0;
  for (int w = 1; w <= maxbits; ++w) {
    start[w] = next;
    next += rank[w] << (w - 1);
  }
  t.log = maxbits;
  t.e.assign(size_t(1) << maxbits, HufEntry{0, 0});
  for (int s = 0; s < nw; ++s) {
    const int w = weights[s];
    if (!w) continue;
    const uint32_t len = (1u << w) >> 1;
    for (uint32_t i = 0; i < len; ++i)
      t.e[start[w] + i] = HufEntry{uint8_t(s), uint8_t(maxbits + 1 - w)};
    start[w] += len;
  }
  t.valid = true;
  return used;
}

void decode_huffman_stream(const HufTable& t, const uint8_t* src, size_t n,
                           uint8_t* out, size_t count) {
  BackwardBits br;
  br.init(src, n);
  const int log = t.log;
  const HufEntry* e = t.e.data();
  const uint64_t mask = (uint64_t(1) << log) - 1;
  size_t i = 0;
  // Four symbols (at most 44 bits) from each 56-bit load while the stream
  // holds that many.
  while (i + 4 <= count && br.pos >= 56) {
    const uint64_t v = br.peek(56);
    int used = 0;
    for (int k = 0; k < 4; ++k) {
      const HufEntry& h = e[(v >> (56 - used - log)) & mask];
      out[i++] = h.symbol;
      used += h.bits;
    }
    br.pos -= used;
  }
  for (; i < count; ++i) {
    const HufEntry& h = e[br.peek(log)];
    out[i] = h.symbol;
    br.pos -= h.bits;
    need(br.pos >= 0, "Huffman stream overrun");
  }
  need(br.pos == 0, "Huffman stream not fully consumed");
}

// ---------------------------------------------------------------------------
// Sequences
// ---------------------------------------------------------------------------

const uint32_t kLLBase[36] = {
    0,  1,  2,   3,   4,   5,    6,    7,    8,    9,     10,    11,
    12, 13, 14,  15,  16,  18,   20,   22,   24,   28,    32,    40,
    48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3,  3,
                             4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11,  12,  13,   14,   15,   16,
    17, 18, 19, 20, 21, 22, 23, 24, 25,  26,  27,   28,   29,   30,
    31, 32, 33, 34, 35, 37, 39, 41, 43,  47,  51,   59,   67,   83,
    99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                             5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1,  1,  1,  1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,  1,  1,  1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,  1,  1,  1,
                                1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

struct FrameState {
  HufTable huf;
  FseTable ll, of, ml;
  uint64_t rep[3] = {1, 4, 8};
};

// One sequence-table mode: predefined, RLE, FSE description or repeat.
size_t read_seq_table(int mode, const uint8_t* src, size_t n,
                      const int16_t* dflt, int dflt_n, int dflt_log,
                      int max_log, int max_symbol, FseTable& t) {
  switch (mode) {
    case 0:
      t.build(dflt, dflt_n, dflt_log);
      return 0;
    case 1:
      need(n >= 1, "truncated RLE sequence table");
      need(src[0] <= max_symbol, "RLE sequence symbol out of range");
      t.rle(src[0]);
      return 1;
    case 2:
      return read_fse_description(src, n, max_log, max_symbol, t);
    default:
      need(t.valid, "repeat sequence table with no previous table");
      return 0;
  }
}

// ---------------------------------------------------------------------------
// Blocks and frames
// ---------------------------------------------------------------------------

// Decodes one compressed block, appending to `out` (whose first
// `frame_start` bytes belong to earlier frames).
void decode_compressed_block(const uint8_t* src, size_t n,
                             std::vector<uint8_t>& out, size_t frame_start,
                             FrameState& fs) {
  need(n >= 1, "truncated block");
  // --- literals ---
  const uint8_t b0 = src[0];
  const int ltype = b0 & 3, lformat = (b0 >> 2) & 3;
  size_t regen, csize = 0, hsize;
  if (ltype < 2) {
    if ((lformat & 1) == 0) {
      hsize = 1;
      regen = b0 >> 3;
    } else if (lformat == 1) {
      hsize = 2;
      need(n >= 2, "truncated literals header");
      regen = (b0 >> 4) + (size_t(src[1]) << 4);
    } else {
      hsize = 3;
      need(n >= 3, "truncated literals header");
      regen = (b0 >> 4) + (size_t(src[1]) << 4) + (size_t(src[2]) << 12);
    }
  } else {
    hsize = lformat < 2 ? 3 : size_t(lformat) + 2;
    need(n >= hsize, "truncated literals header");
    uint64_t v = 0;
    for (size_t i = 0; i < hsize; ++i) v |= uint64_t(src[i]) << (8 * i);
    const int bits = hsize == 3 ? 10 : hsize == 4 ? 14 : 18;
    regen = size_t((v >> 4) & ((1u << bits) - 1));
    csize = size_t((v >> (4 + bits)) & ((1u << bits) - 1));
  }
  need(regen <= kBlockMax, "literals larger than a block");
  std::vector<uint8_t> lits(regen);
  size_t pos = hsize;
  if (ltype == 0) {
    need(n - pos >= regen, "truncated raw literals");
    if (regen) memcpy(lits.data(), src + pos, regen);
    pos += regen;
  } else if (ltype == 1) {
    need(n - pos >= 1, "truncated RLE literals");
    memset(lits.data(), src[pos], regen);
    pos += 1;
  } else {
    need(n - pos >= csize, "truncated compressed literals");
    const uint8_t* c = src + pos;
    size_t cn = csize;
    if (ltype == 2) {
      const size_t tree = read_huffman_tree(c, cn, fs.huf);
      c += tree;
      cn -= tree;
    } else {
      need(fs.huf.valid, "treeless literals with no previous Huffman table");
    }
    if (lformat == 0) {
      decode_huffman_stream(fs.huf, c, cn, lits.data(), regen);
    } else {
      need(cn >= 6, "truncated jump table");
      const size_t s1 = c[0] | size_t(c[1]) << 8, s2 = c[2] | size_t(c[3]) << 8,
                   s3 = c[4] | size_t(c[5]) << 8;
      need(s1 + s2 + s3 + 6 <= cn, "corrupt jump table");
      const size_t s4 = cn - 6 - s1 - s2 - s3;
      const size_t seg = (regen + 3) / 4;
      need(seg * 3 <= regen, "too few literals for four streams");
      const uint8_t* sp = c + 6;
      decode_huffman_stream(fs.huf, sp, s1, lits.data(), seg);
      decode_huffman_stream(fs.huf, sp + s1, s2, lits.data() + seg, seg);
      decode_huffman_stream(fs.huf, sp + s1 + s2, s3, lits.data() + 2 * seg,
                            seg);
      decode_huffman_stream(fs.huf, sp + s1 + s2 + s3, s4,
                            lits.data() + 3 * seg, regen - 3 * seg);
    }
    pos += csize;
  }

  // --- sequences ---
  need(pos < n, "truncated sequences section");
  size_t nseq = src[pos++];
  if (nseq >= 128) {
    if (nseq < 255) {
      need(pos < n, "truncated sequence count");
      nseq = ((nseq - 128) << 8) + src[pos++];
    } else {
      need(pos + 2 <= n, "truncated sequence count");
      nseq = src[pos] + (size_t(src[pos + 1]) << 8) + 0x7F00;
      pos += 2;
    }
  }
  const size_t out0 = out.size();
  out.resize(out0 + kBlockMax);
  uint8_t* const ob = out.data();
  size_t op = out0, lp = 0;
  const size_t oend = out0 + kBlockMax;
  if (nseq > 0) {
    need(pos < n, "truncated sequence modes");
    const uint8_t modes = src[pos++];
    need((modes & 3) == 0, "reserved sequence mode bits set");
    pos += read_seq_table(modes >> 6, src + pos, n - pos, kLLDefault, 36, 6,
                          9, 35, fs.ll);
    pos += read_seq_table((modes >> 4) & 3, src + pos, n - pos, kOFDefault, 29,
                          5, 8, 31, fs.of);
    pos += read_seq_table((modes >> 2) & 3, src + pos, n - pos, kMLDefault, 53,
                          6, 9, 52, fs.ml);
    need(pos < n, "truncated sequence bitstream");
    BackwardBits br;
    br.init(src + pos, n - pos);
    uint32_t sll = uint32_t(br.read(fs.ll.log));
    uint32_t sof = uint32_t(br.read(fs.of.log));
    uint32_t sml = uint32_t(br.read(fs.ml.log));
    for (size_t i = 0; i < nseq; ++i) {
      const unsigned llc = fs.ll.e[sll].symbol, ofc = fs.of.e[sof].symbol,
                     mlc = fs.ml.e[sml].symbol;
      need(ofc <= 31, "offset code out of range");
      uint64_t ofv = (uint64_t(1) << ofc) + br.read(int(ofc));
      const uint64_t ml = kMLBase[mlc] + br.read(kMLBits[mlc]);
      const uint64_t ll = kLLBase[llc] + br.read(kLLBits[llc]);
      uint64_t offset;
      if (ofv > 3) {
        offset = ofv - 3;
        fs.rep[2] = fs.rep[1];
        fs.rep[1] = fs.rep[0];
        fs.rep[0] = offset;
      } else {
        unsigned idx = unsigned(ofv) - 1 + (ll == 0 ? 1 : 0);
        if (idx == 0) {
          offset = fs.rep[0];
        } else {
          offset = idx == 3 ? fs.rep[0] - 1 : fs.rep[idx];
          if (idx != 1) fs.rep[2] = fs.rep[1];
          fs.rep[1] = fs.rep[0];
          fs.rep[0] = offset;
        }
      }
      if (i + 1 < nseq) {
        sll = fs.ll.e[sll].base + uint32_t(br.read(fs.ll.e[sll].bits));
        sml = fs.ml.e[sml].base + uint32_t(br.read(fs.ml.e[sml].bits));
        sof = fs.of.e[sof].base + uint32_t(br.read(fs.of.e[sof].bits));
      }
      need(!br.overflowed(), "sequence bitstream overrun");
      need(ll <= regen - lp, "sequence reads past the literals");
      need(ll + ml <= oend - op, "block larger than its maximum size");
      memcpy(ob + op, lits.data() + lp, ll);
      op += ll;
      lp += ll;
      need(offset > 0 && offset <= op - frame_start,
           "match offset before the frame's start");
      const uint8_t* m = ob + op - offset;
      uint8_t* d = ob + op;
      if (offset >= ml) {
        memcpy(d, m, ml);
      } else {
        for (uint64_t k = 0; k < ml; ++k) d[k] = m[k];
      }
      op += ml;
    }
    need(br.pos == 0, "sequence bitstream not fully consumed");
  } else {
    need(pos == n, "bytes after an empty sequences section");
  }
  const size_t rest = regen - lp;
  need(rest <= oend - op, "block larger than its maximum size");
  if (rest) memcpy(ob + op, lits.data() + lp, rest);
  op += rest;
  out.resize(op);
}

struct Decoder {
  const uint8_t* src;
  size_t n;
  uint64_t max_out;
  std::vector<uint8_t> out;

  size_t frame(size_t at) {
    const uint8_t* p = src + at;
    const size_t left = n - at;
    need(left >= 4, "truncated frame");
    const uint32_t magic = rd32(p);
    if ((magic & kSkippableMask) == kSkippableMagic) {
      need(left >= 8, "truncated skippable frame");
      const uint64_t size = rd32(p + 4);
      need(size <= left - 8, "truncated skippable frame");
      return 8 + size_t(size);
    }
    need(magic == kFrameMagic, "bad zstd magic number");
    need(left >= 5, "truncated frame header");
    const uint8_t fhd = p[4];
    need((fhd & 0x08) == 0, "reserved frame header bit set");
    const int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1,
              checksum = (fhd >> 2) & 1, dict_flag = fhd & 3;
    size_t pos = 5;
    if (!single) {
      need(left > pos, "truncated frame header");
      ++pos;  // window descriptor: the whole output stays in memory
    }
    const size_t dict_bytes = dict_flag == 3 ? 4 : size_t(dict_flag);
    need(left >= pos + dict_bytes, "truncated frame header");
    uint32_t dict = 0;
    for (size_t i = 0; i < dict_bytes; ++i) dict |= uint32_t(p[pos + i]) << (8 * i);
    need(dict == 0, "zstd dictionaries are not supported");
    pos += dict_bytes;
    const size_t fcs_bytes =
        fcs_flag == 0 ? (single ? 1 : 0) : size_t(1) << fcs_flag;
    need(left >= pos + fcs_bytes, "truncated frame header");
    bool has_size = fcs_bytes > 0;
    uint64_t content = 0;
    for (size_t i = 0; i < fcs_bytes; ++i)
      content |= uint64_t(p[pos + i]) << (8 * i);
    if (fcs_bytes == 2) content += 256;
    pos += fcs_bytes;
    const size_t start = out.size();
    if (has_size) {
      need(content <= max_out - start, "output over the stated maximum size");
      out.reserve(start + size_t(content));
    }
    FrameState fs;
    for (;;) {
      need(left >= pos + 3, "truncated block header");
      const uint32_t bh = p[pos] | uint32_t(p[pos + 1]) << 8 |
                          uint32_t(p[pos + 2]) << 16;
      pos += 3;
      const bool last = bh & 1;
      const int type = (bh >> 1) & 3;
      const size_t bsize = bh >> 3;
      need(type != 3, "reserved block type");
      const size_t body = type == 1 ? 1 : bsize;
      need(left - pos >= body, "truncated block");
      need(bsize <= kBlockMax, "block larger than its maximum size");
      if (type == 0) {
        out.insert(out.end(), p + pos, p + pos + bsize);
      } else if (type == 1) {
        out.insert(out.end(), bsize, p[pos]);
      } else {
        decode_compressed_block(p + pos, bsize, out, start, fs);
      }
      pos += body;
      need(out.size() <= max_out, "output over the stated maximum size");
      if (has_size)
        need(out.size() - start <= content,
             "frame output over its stated content size");
      if (last) break;
    }
    if (has_size)
      need(out.size() - start == content,
           "frame output under its stated content size");
    if (checksum) {
      need(left >= pos + 4, "truncated content checksum");
      const uint32_t want = rd32(p + pos);
      const uint32_t got =
          uint32_t(xxh64(out.data() + start, out.size() - start));
      need(want == got, "content checksum mismatch");
      pos += 4;
    }
    return pos;
  }

  void run() {
    need(n > 0, "empty input");
    for (size_t at = 0; at < n;) at += frame(at);
  }
};

void set_error(char* err, size_t cap, const char* msg) {
  if (err && cap) snprintf(err, cap, "%s", msg);
}

}  // namespace

extern "C" {

// Decodes every frame of src[0:n). On success returns 0, sets *out to a
// buffer of *out_len bytes (free it with iris_zstd_free) and *out to NULL
// when the output is empty. On failure returns 1 and writes the reason to
// err. max_out caps the total output.
int iris_zstd_decompress(const uint8_t* src, size_t n, uint64_t max_out,
                         uint8_t** out, uint64_t* out_len, char* err,
                         size_t err_cap) {
  *out = nullptr;
  *out_len = 0;
  try {
    Decoder d{src, n, max_out, {}};
    d.run();
    if (!d.out.empty()) {
      uint8_t* buf = static_cast<uint8_t*>(malloc(d.out.size()));
      if (!buf) fail("out of memory");
      memcpy(buf, d.out.data(), d.out.size());
      *out = buf;
      *out_len = d.out.size();
    }
    return 0;
  } catch (const Error& e) {
    set_error(err, err_cap, e.what());
  } catch (const std::bad_alloc&) {
    set_error(err, err_cap, "out of memory");
  } catch (const std::length_error&) {
    set_error(err, err_cap, "output too large");
  }
  return 1;
}

void iris_zstd_free(void* p) { free(p); }

uint32_t iris_crc32c(const uint8_t* p, size_t n) { return crc32c(p, n); }

}  // extern "C"
