// A Zstandard decoder (RFC 8878), XXH64 and CRC-32C, behind a plain C
// interface that mimrl_tpu_torch/native/__init__.py loads with ctypes.
//
// It reads what mimrl_tpu's orbax checkpoints hold (core/orbax_slot.py):
// zarr chunks and OCDBT nodes compressed as zstd frames, and the CRC-32C
// that closes every OCDBT manifest and node. Written from the RFC; no
// library's code is carried over and no system libzstd is linked.
//
// Covered: frames and skippable frames; the frame header's window,
// dictionary-ID (a non-zero ID raises: no dictionary is ever given),
// content-size and checksum fields; Raw, RLE and Compressed blocks; the
// literals section (Raw, RLE, Huffman in 1 or 4 streams, treeless; Huffman
// weights direct or FSE-coded); the sequences section (predefined, RLE,
// FSE and repeat modes, the three repeat offsets); the XXH64 content
// checksum, verified when the frame asks for it. A fault raises with the
// byte offset in the input where it was found.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC collate.cpp zstd.cpp -o <library>.so
// (native/__init__.py does this at first use).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Fault {
  std::string msg;
};

[[noreturn]] void fail(const std::string& what, int64_t at) {
  throw Fault{what + " at input byte " + std::to_string(at)};
}

inline int highbit(uint32_t x) { return 31 - __builtin_clz(x); }

inline uint64_t load_le(const uint8_t* p, int64_t avail) {
  uint64_t v = 0;
  if (avail >= 8) {
    std::memcpy(&v, p, 8);
  } else if (avail > 0) {
    std::memcpy(&v, p, static_cast<size_t>(avail));
  }
  return v;  // little-endian hosts (x86-64, aarch64)
}

inline uint32_t rd16(const uint8_t* p) { return p[0] | (p[1] << 8); }
inline uint32_t rd24(const uint8_t* p) { return p[0] | (p[1] << 8) | (p[2] << 16); }
inline uint32_t rd32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

// ------------------------------------------------------------------
// Bit readers. Forward: FSE table descriptions. Backward: Huffman
// streams and the sequences bitstream, which are read from their last
// byte (whose highest set bit marks the start) towards their first.
// ------------------------------------------------------------------
struct ForwardBits {
  const uint8_t* p;
  int64_t len, bit = 0, base;  // base: offset of p in the whole input
  uint32_t read(int n) {
    int64_t byte = bit >> 3;
    if (((bit + n + 7) >> 3) > len) fail("FSE table description runs past its section", base + len);
    uint64_t v = load_le(p + byte, len - byte) >> (bit & 7);
    bit += n;
    return static_cast<uint32_t>(v & ((1ull << n) - 1));
  }
  void unread(int n) { bit -= n; }
  int64_t bytes() const { return (bit + 7) >> 3; }
};

struct BackBits {
  const uint8_t* p;
  int64_t len, base;
  int64_t bit;  // bits left above the stream's start; may go negative

  BackBits(const uint8_t* src, int64_t n, int64_t at) : p(src), len(n), base(at) {
    if (n <= 0) fail("empty bitstream", at);
    uint8_t last = src[n - 1];
    if (last == 0) fail("bitstream without its end marker", at + n - 1);
    bit = n * 8 - (8 - highbit(last));
  }
  // n <= 56 bits; bits before the stream's start read as zeros
  uint64_t read(int n) {
    if (n == 0) return 0;
    bit -= n;
    if (bit >= 0) {
      int64_t byte = bit >> 3;
      uint64_t v = load_le(p + byte, len - byte) >> (bit & 7);
      return v & ((1ull << n) - 1);
    }
    int have = static_cast<int>(n + bit);
    if (have <= 0) return 0;
    uint64_t v = load_le(p, len) & ((1ull << have) - 1);
    return v << (-bit);
  }
};

// ------------------------------------------------------------------
// FSE
// ------------------------------------------------------------------
struct FseTable {
  int log = 0;
  std::vector<uint8_t> sym, nbits;
  std::vector<uint16_t> base;
};

void fse_build(FseTable& t, const int16_t* norm, int nsym, int log, int64_t at) {
  const int size = 1 << log;
  t.log = log;
  t.sym.assign(size, 0);
  t.nbits.assign(size, 0);
  t.base.assign(size, 0);
  std::vector<uint16_t> next(nsym > 0 ? nsym : 1, 0);
  int high = size;
  for (int s = 0; s < nsym; ++s) {
    if (norm[s] == -1) {
      if (high == 0) fail("FSE table overfull", at);
      t.sym[--high] = static_cast<uint8_t>(s);
      next[s] = 1;
    }
  }
  const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  int pos = 0;
  for (int s = 0; s < nsym; ++s) {
    if (norm[s] <= 0) continue;
    next[s] = static_cast<uint16_t>(norm[s]);
    for (int i = 0; i < norm[s]; ++i) {
      t.sym[pos] = static_cast<uint8_t>(s);
      do {
        pos = (pos + step) & mask;
      } while (pos >= high);
    }
  }
  if (pos != 0) fail("FSE distribution does not fill its table", at);
  for (int i = 0; i < size; ++i) {
    uint16_t d = next[t.sym[i]]++;
    int nb = log - highbit(d);
    t.nbits[i] = static_cast<uint8_t>(nb);
    t.base[i] = static_cast<uint16_t>((d << nb) - size);
  }
}

// Reads an FSE table description; returns the bytes it took.
int64_t fse_read(FseTable& t, const uint8_t* src, int64_t len, int max_log, int max_sym,
                 int64_t at) {
  ForwardBits br{src, len, 0, at};
  int log = 5 + static_cast<int>(br.read(4));
  if (log > max_log) fail("FSE accuracy log " + std::to_string(log) + " above " + std::to_string(max_log), at);
  int remaining = 1 << log;
  int16_t norm[256];
  int nsym = 0;
  while (remaining > 0) {
    if (nsym > max_sym) fail("FSE distribution has too many symbols", at);
    int bits = highbit(static_cast<uint32_t>(remaining + 1)) + 1;
    uint32_t val = br.read(bits);
    uint32_t lower = (1u << (bits - 1)) - 1;
    uint32_t threshold = (1u << bits) - 1 - static_cast<uint32_t>(remaining + 1);
    if ((val & lower) < threshold) {
      br.unread(1);
      val &= lower;
    } else if (val > lower) {
      val -= threshold;
    }
    int proba = static_cast<int>(val) - 1;
    remaining -= proba < 0 ? -proba : proba;
    norm[nsym++] = static_cast<int16_t>(proba);
    if (proba == 0) {
      for (;;) {
        uint32_t rep = br.read(2);
        for (uint32_t i = 0; i < rep; ++i) {
          if (nsym > max_sym) fail("FSE distribution has too many symbols", at);
          norm[nsym++] = 0;
        }
        if (rep != 3) break;
      }
    }
  }
  if (remaining != 0 || nsym > max_sym + 1) fail("corrupt FSE distribution", at);
  fse_build(t, norm, nsym, log, at);
  return br.bytes();
}

void fse_rle(FseTable& t, uint8_t symbol) {
  t.log = 0;
  t.sym.assign(1, symbol);
  t.nbits.assign(1, 0);
  t.base.assign(1, 0);
}

// ------------------------------------------------------------------
// Huffman
// ------------------------------------------------------------------
constexpr int kHufMaxBits = 11;

struct HufTable {
  int max_bits = 0;
  std::vector<uint8_t> sym, nbits;
};

void huf_build(HufTable& t, const uint8_t* weights, int nsym, int64_t at) {
  // the last symbol's weight is implied: the one that completes a power of 2
  uint32_t total = 0;
  for (int s = 0; s < nsym - 1; ++s) {
    if (weights[s] > kHufMaxBits) fail("Huffman weight above 11", at);
    if (weights[s]) total += 1u << (weights[s] - 1);
  }
  if (total == 0) fail("Huffman weights all zero", at);
  int max_bits = highbit(total) + 1;
  if (max_bits > kHufMaxBits) fail("Huffman code longer than 11 bits", at);
  uint32_t left = (1u << max_bits) - total;
  if (left & (left - 1)) fail("Huffman weights do not sum to a power of 2", at);
  uint8_t w[256];
  std::memcpy(w, weights, nsym - 1);
  w[nsym - 1] = static_cast<uint8_t>(highbit(left) + 1);
  uint8_t bits[256];
  int count[kHufMaxBits + 2] = {0};
  for (int s = 0; s < nsym; ++s) {
    bits[s] = w[s] ? static_cast<uint8_t>(max_bits + 1 - w[s]) : 0;
    count[bits[s]]++;
  }
  const int size = 1 << max_bits;
  t.max_bits = max_bits;
  t.sym.assign(size, 0);
  t.nbits.assign(size, 0);
  int64_t start[kHufMaxBits + 2];
  start[max_bits] = 0;
  for (int b = max_bits; b >= 1; --b) {
    start[b - 1] = start[b] + static_cast<int64_t>(count[b]) * (1 << (max_bits - b));
    if (start[b - 1] > size) fail("Huffman table overfull", at);
    std::memset(&t.nbits[start[b]], b, static_cast<size_t>(start[b - 1] - start[b]));
  }
  if (start[0] != size) fail("Huffman table not full", at);
  for (int s = 0; s < nsym; ++s) {
    if (!bits[s]) continue;
    int span = 1 << (max_bits - bits[s]);
    std::memset(&t.sym[start[bits[s]]], s, span);
    start[bits[s]] += span;
  }
}

// Reads a Huffman tree description; returns the bytes it took.
int64_t huf_read(HufTable& t, const uint8_t* src, int64_t len, int64_t at) {
  if (len < 1) fail("Huffman tree description missing", at);
  uint8_t header = src[0];
  uint8_t weights[256];
  int n = 0;
  int64_t used;
  if (header >= 128) {
    n = header - 127;
    used = 1 + (n + 1) / 2;
    if (used > len) fail("Huffman weights run past the literals section", at);
    for (int i = 0; i < n; ++i) {
      uint8_t b = src[1 + i / 2];
      weights[i] = (i % 2 == 0) ? (b >> 4) : (b & 15);
    }
  } else {
    used = 1 + header;
    if (used > len || header == 0) fail("Huffman weights run past the literals section", at);
    FseTable ft;
    int64_t hdr = fse_read(ft, src + 1, header, 6, 255, at + 1);
    if (hdr >= header) fail("FSE-coded Huffman weights without a bitstream", at + 1);
    BackBits br(src + 1 + hdr, header - hdr, at + 1 + hdr);
    uint32_t s1 = static_cast<uint32_t>(br.read(ft.log));
    uint32_t s2 = static_cast<uint32_t>(br.read(ft.log));
    for (;;) {
      if (n >= 255) fail("too many Huffman weights", at);
      weights[n++] = ft.sym[s1];
      s1 = ft.base[s1] + static_cast<uint32_t>(br.read(ft.nbits[s1]));
      if (br.bit < 0) {
        weights[n++] = ft.sym[s2];
        break;
      }
      if (n >= 255) fail("too many Huffman weights", at);
      weights[n++] = ft.sym[s2];
      s2 = ft.base[s2] + static_cast<uint32_t>(br.read(ft.nbits[s2]));
      if (br.bit < 0) {
        weights[n++] = ft.sym[s1];
        break;
      }
    }
  }
  if (n + 1 > 256) fail("too many Huffman weights", at);
  huf_build(t, weights, n + 1, at);
  return used;
}

// Decodes k Huffman streams (1 or 4) into out, one after another; their
// symbols are decoded in turns, so that the streams' dependency chains
// (state -> code length -> next state) overlap.
void huf_streams(const HufTable& t, int k, const uint8_t* const* src, const int64_t* len,
                 const int64_t* at, uint8_t* out, const int64_t* n) {
  const int mb = t.max_bits;
  const uint32_t mask = (1u << mb) - 1;
  std::vector<BackBits> br;
  uint32_t state[4];
  uint8_t* dst[4];
  int64_t common = n[0];
  for (int j = 0; j < k; ++j) {
    br.emplace_back(src[j], len[j], at[j]);
    state[j] = static_cast<uint32_t>(br[j].read(mb));
    dst[j] = j ? dst[j - 1] + n[j - 1] : out;
    common = n[j] < common ? n[j] : common;
  }
  for (int64_t i = 0; i < common; ++i) {
    for (int j = 0; j < k; ++j) {
      dst[j][i] = t.sym[state[j]];
      int nb = t.nbits[state[j]];
      state[j] = ((state[j] << nb) | static_cast<uint32_t>(br[j].read(nb))) & mask;
    }
  }
  for (int j = 0; j < k; ++j) {
    for (int64_t i = common; i < n[j]; ++i) {
      dst[j][i] = t.sym[state[j]];
      int nb = t.nbits[state[j]];
      state[j] = ((state[j] << nb) | static_cast<uint32_t>(br[j].read(nb))) & mask;
    }
    if (br[j].bit != -mb) fail("Huffman stream not consumed exactly", at[j]);
  }
}

// ------------------------------------------------------------------
// Sequences
// ------------------------------------------------------------------
const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

const uint32_t kLLBase[36] = {0,  1,  2,   3,   4,   5,    6,    7,    8,    9,     10,    11,
                              12, 13, 14,  15,  16,  18,   20,   22,   24,   28,    32,    40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  1,  1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {3,  4,  5,  6,  7,  8,  9,   10,  11,  12,   13,   14,   15,   16,
                              17, 18, 19, 20, 21, 22, 23,  24,  25,  26,   27,   28,   29,   30,
                              31, 32, 33, 34, 35, 37, 39,  41,  43,  47,   51,   59,   67,   83,
                              99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

constexpr int64_t kBlockMax = 128 * 1024;

struct FrameState {
  HufTable huf;
  bool have_huf = false;
  FseTable ll, of, ml;
  bool have_ll = false, have_of = false, have_ml = false;
  uint64_t rep[3] = {1, 4, 8};
};

// Reads one of the three tables of a sequences section; returns the bytes it took.
int64_t seq_table(FseTable& t, bool& have, int mode, const int16_t* def, int ndef, int def_log,
                  int max_log, int max_sym, const uint8_t* src, int64_t len, int64_t at) {
  switch (mode) {
    case 0:
      fse_build(t, def, ndef, def_log, at);
      have = true;
      return 0;
    case 1:
      if (len < 1) fail("RLE sequence table runs past the block", at);
      if (src[0] > max_sym) fail("RLE sequence code out of range", at);
      fse_rle(t, src[0]);
      have = true;
      return 1;
    case 2: {
      int64_t used = fse_read(t, src, len, max_log, max_sym, at);
      have = true;
      return used;
    }
    default:
      if (!have) fail("repeat mode without an earlier sequence table", at);
      return 0;
  }
}

class Decoder {
 public:
  Decoder(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap)
      : src_(src), n_(n), dst_(dst), cap_(cap) {}

  int64_t run() {
    int64_t pos = 0;
    if (n_ == 0) fail("no zstd frame", 0);
    while (pos < n_) {
      if (n_ - pos < 4) fail("truncated frame magic", pos);
      uint32_t magic = rd32(src_ + pos);
      if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
        if (n_ - pos < 8) fail("truncated skippable frame", pos);
        uint32_t size = rd32(src_ + pos + 4);
        if (static_cast<int64_t>(size) > n_ - pos - 8) fail("skippable frame runs past the input", pos);
        pos += 8 + size;
        continue;
      }
      if (magic != 0xFD2FB528u) fail("bad zstd magic number", pos);
      pos = frame(pos + 4);
    }
    return out_;
  }

 private:
  const uint8_t* src_;
  int64_t n_;
  uint8_t* dst_;
  int64_t cap_;
  int64_t out_ = 0;
  std::vector<uint8_t> lit_;

  void need(int64_t pos, int64_t k, const char* what) {
    if (k < 0 || pos + k > n_) fail(std::string("truncated ") + what, pos);
  }

  void room(int64_t k, int64_t at) {
    if (k > cap_ - out_)
      fail("decoded data larger than the " + std::to_string(cap_) + " bytes expected", at);
  }

  int64_t frame(int64_t pos) {
    const int64_t start = pos - 4;
    need(pos, 1, "frame header");
    uint8_t fhd = src_[pos++];
    int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1,
        did_flag = fhd & 3;
    if (fhd & 8) fail("reserved bit set in the frame header", pos - 1);
    uint64_t window = 0;
    if (!single) {
      need(pos, 1, "window descriptor");
      uint8_t wd = src_[pos++];
      int wlog = 10 + (wd >> 3);
      if (wlog > 41) fail("window too large", pos - 1);
      uint64_t wbase = 1ull << wlog;
      window = wbase + (wbase / 8) * (wd & 7);
    }
    static const int kDidSize[4] = {0, 1, 2, 4};
    int did_size = kDidSize[did_flag];
    need(pos, did_size, "dictionary ID");
    uint32_t did = 0;
    for (int i = 0; i < did_size; ++i) did |= static_cast<uint32_t>(src_[pos + i]) << (8 * i);
    if (did != 0) fail("frame needs dictionary " + std::to_string(did) + ", and none is given", pos);
    pos += did_size;
    static const int kFcsSize[4] = {0, 2, 4, 8};
    int fcs_size = kFcsSize[fcs_flag];
    if (fcs_flag == 0 && single) fcs_size = 1;
    need(pos, fcs_size, "frame content size");
    bool have_fcs = fcs_size > 0;
    uint64_t fcs = 0;
    for (int i = 0; i < fcs_size; ++i) fcs |= static_cast<uint64_t>(src_[pos + i]) << (8 * i);
    if (fcs_size == 2) fcs += 256;
    pos += fcs_size;
    if (single) window = fcs;
    (void)window;

    FrameState st;
    const int64_t frame_out = out_;
    for (;;) {
      need(pos, 3, "block header");
      uint32_t bh = rd24(src_ + pos);
      const int64_t at = pos;
      pos += 3;
      bool last = bh & 1;
      int type = (bh >> 1) & 3;
      int64_t size = bh >> 3;
      switch (type) {
        case 0:
          need(pos, size, "raw block");
          if (size > kBlockMax) fail("block larger than 128 KiB", at);
          room(size, at);
          std::memcpy(dst_ + out_, src_ + pos, static_cast<size_t>(size));
          out_ += size;
          pos += size;
          break;
        case 1:
          need(pos, 1, "RLE block");
          if (size > kBlockMax) fail("block larger than 128 KiB", at);
          room(size, at);
          std::memset(dst_ + out_, src_[pos], static_cast<size_t>(size));
          out_ += size;
          pos += 1;
          break;
        case 2:
          need(pos, size, "compressed block");
          if (size > kBlockMax) fail("block larger than 128 KiB", at);
          compressed(st, pos, size, frame_out);
          pos += size;
          break;
        default:
          fail("reserved block type", at);
      }
      if (last) break;
    }
    if (have_fcs && static_cast<uint64_t>(out_ - frame_out) != fcs)
      fail("frame holds " + std::to_string(out_ - frame_out) + " bytes, its header says " +
               std::to_string(fcs),
           start);
    if (checksum) {
      need(pos, 4, "content checksum");
      uint64_t h = xxh64(dst_ + frame_out, out_ - frame_out, 0);
      if (static_cast<uint32_t>(h) != rd32(src_ + pos)) fail("content checksum mismatch", pos);
      pos += 4;
    }
    return pos;
  }

 public:
  static uint64_t xxh64(const uint8_t* p, int64_t len, uint64_t seed);

 private:
  // Decodes the literals section into lit_; returns its size in bytes.
  int64_t literals(FrameState& st, int64_t pos, int64_t len, int64_t* nlit) {
    const uint8_t* s = src_ + pos;
    if (len < 1) fail("empty compressed block", pos);
    int type = s[0] & 3, sf = (s[0] >> 2) & 3;
    if (type <= 1) {
      int64_t hsize, regen;
      if (sf == 0 || sf == 2) {
        hsize = 1;
        regen = s[0] >> 3;
      } else if (sf == 1) {
        hsize = 2;
        if (len < 2) fail("truncated literals header", pos);
        regen = (s[0] >> 4) + (s[1] << 4);
      } else {
        hsize = 3;
        if (len < 3) fail("truncated literals header", pos);
        regen = (s[0] >> 4) + (s[1] << 4) + (static_cast<int64_t>(s[2]) << 12);
      }
      if (regen > kBlockMax) fail("literals larger than 128 KiB", pos);
      lit_.resize(static_cast<size_t>(regen));
      *nlit = regen;
      if (type == 0) {
        if (hsize + regen > len) fail("raw literals run past the block", pos);
        std::memcpy(lit_.data(), s + hsize, static_cast<size_t>(regen));
        return hsize + regen;
      }
      if (hsize + 1 > len) fail("RLE literals run past the block", pos);
      std::memset(lit_.data(), s[hsize], static_cast<size_t>(regen));
      return hsize + 1;
    }
    int64_t hsize, regen, csize;
    int streams = sf == 0 ? 1 : 4;
    if (sf <= 1) {
      hsize = 3;
      if (len < 3) fail("truncated literals header", pos);
      uint32_t v = rd24(s);
      regen = (v >> 4) & 0x3FF;
      csize = (v >> 14) & 0x3FF;
    } else if (sf == 2) {
      hsize = 4;
      if (len < 4) fail("truncated literals header", pos);
      uint32_t v = rd32(s);
      regen = (v >> 4) & 0x3FFF;
      csize = (v >> 18) & 0x3FFF;
    } else {
      hsize = 5;
      if (len < 5) fail("truncated literals header", pos);
      uint64_t v = rd32(s) | (static_cast<uint64_t>(s[4]) << 32);
      regen = (v >> 4) & 0x3FFFF;
      csize = (v >> 22) & 0x3FFFF;
    }
    if (regen > kBlockMax) fail("literals larger than 128 KiB", pos);
    if (hsize + csize > len) fail("compressed literals run past the block", pos);
    int64_t p = pos + hsize, end = pos + hsize + csize;
    if (type == 2) {
      p += huf_read(st.huf, src_ + p, end - p, p);
      st.have_huf = true;
    } else if (!st.have_huf) {
      fail("treeless literals without an earlier Huffman table", pos);
    }
    lit_.resize(static_cast<size_t>(regen));
    *nlit = regen;
    if (streams == 1) {
      const uint8_t* one = src_ + p;
      int64_t len1 = end - p;
      huf_streams(st.huf, 1, &one, &len1, &p, lit_.data(), &regen);
    } else {
      if (end - p < 6) fail("truncated Huffman jump table", p);
      int64_t sz[4];
      sz[0] = rd16(src_ + p);
      sz[1] = rd16(src_ + p + 2);
      sz[2] = rd16(src_ + p + 4);
      p += 6;
      sz[3] = (end - p) - sz[0] - sz[1] - sz[2];
      if (sz[3] < 1) fail("Huffman jump table past the literals", p - 6);
      int64_t seg = (regen + 3) / 4;
      if (3 * seg > regen) fail("too few literals for four streams", pos);
      const uint8_t* srcs[4];
      int64_t ats[4], counts[4] = {seg, seg, seg, regen - 3 * seg};
      for (int i = 0; i < 4; ++i) {
        srcs[i] = src_ + p;
        ats[i] = p;
        p += sz[i];
      }
      huf_streams(st.huf, 4, srcs, sz, ats, lit_.data(), counts);
    }
    return hsize + csize;
  }

  void compressed(FrameState& st, int64_t pos, int64_t len, int64_t frame_out) {
    int64_t nlit = 0;
    int64_t used = literals(st, pos, len, &nlit);
    int64_t p = pos + used, end = pos + len;
    if (p >= end) fail("compressed block without a sequences section", p);
    int64_t nseq;
    uint8_t b0 = src_[p];
    if (b0 < 128) {
      nseq = b0;
      p += 1;
    } else if (b0 < 255) {
      if (end - p < 2) fail("truncated sequences header", p);
      nseq = ((b0 - 128) << 8) + src_[p + 1];
      p += 2;
    } else {
      if (end - p < 3) fail("truncated sequences header", p);
      nseq = src_[p + 1] + (src_[p + 2] << 8) + 0x7F00;
      p += 3;
    }
    const uint8_t* lit = lit_.data();
    int64_t lpos = 0;
    if (nseq == 0) {
      if (p != end) fail("bytes after an empty sequences section", p);
      room(nlit, pos);
      std::memcpy(dst_ + out_, lit, static_cast<size_t>(nlit));
      out_ += nlit;
      return;
    }
    if (p >= end) fail("truncated sequence modes", p);
    uint8_t modes = src_[p++];
    if (modes & 3) fail("reserved bits set in the sequence modes", p - 1);
    p += seq_table(st.ll, st.have_ll, modes >> 6, kLLDefault, 36, 6, 9, 35, src_ + p, end - p, p);
    p += seq_table(st.of, st.have_of, (modes >> 4) & 3, kOFDefault, 29, 5, 8, 31, src_ + p,
                   end - p, p);
    p += seq_table(st.ml, st.have_ml, (modes >> 2) & 3, kMLDefault, 53, 6, 9, 52, src_ + p,
                   end - p, p);
    if (p >= end) fail("sequences section without a bitstream", p);
    BackBits br(src_ + p, end - p, p);
    uint32_t sll = static_cast<uint32_t>(br.read(st.ll.log));
    uint32_t sof = static_cast<uint32_t>(br.read(st.of.log));
    uint32_t sml = static_cast<uint32_t>(br.read(st.ml.log));
    const int64_t block_start = out_;
    for (int64_t i = 0; i < nseq; ++i) {
      uint8_t ofc = st.of.sym[sof], mlc = st.ml.sym[sml], llc = st.ll.sym[sll];
      if (ofc > 31) fail("offset code out of range", p);
      uint64_t ofv = (1ull << ofc) + br.read(ofc);
      uint64_t ml = kMLBase[mlc] + br.read(kMLBits[mlc]);
      uint64_t ll = kLLBase[llc] + br.read(kLLBits[llc]);
      uint64_t offset;
      if (ofv > 3) {
        offset = ofv - 3;
        st.rep[2] = st.rep[1];
        st.rep[1] = st.rep[0];
        st.rep[0] = offset;
      } else {
        uint32_t idx = static_cast<uint32_t>(ofv - 1) + (ll == 0 ? 1 : 0);
        if (idx == 0) {
          offset = st.rep[0];
        } else {
          offset = idx < 3 ? st.rep[idx] : st.rep[0] - 1;
          if (idx > 1) st.rep[2] = st.rep[1];
          st.rep[1] = st.rep[0];
          st.rep[0] = offset;
        }
      }
      if (i + 1 < nseq) {
        sll = st.ll.base[sll] + static_cast<uint32_t>(br.read(st.ll.nbits[sll]));
        sml = st.ml.base[sml] + static_cast<uint32_t>(br.read(st.ml.nbits[sml]));
        sof = st.of.base[sof] + static_cast<uint32_t>(br.read(st.of.nbits[sof]));
      }
      if (static_cast<int64_t>(ll) > nlit - lpos) fail("sequence takes more literals than decoded", p);
      room(static_cast<int64_t>(ll + ml), pos);
      std::memcpy(dst_ + out_, lit + lpos, static_cast<size_t>(ll));
      out_ += ll;
      lpos += ll;
      if (offset == 0 || offset > static_cast<uint64_t>(out_ - frame_out))
        fail("match offset " + std::to_string(offset) + " reaches before the frame", p);
      uint8_t* d = dst_ + out_;
      const uint8_t* m = d - offset;
      if (offset >= ml) {
        std::memcpy(d, m, static_cast<size_t>(ml));
      } else {
        for (uint64_t k = 0; k < ml; ++k) d[k] = m[k];
      }
      out_ += ml;
    }
    if (br.bit != 0) fail("sequences bitstream not consumed exactly", p);
    int64_t rest = nlit - lpos;
    room(rest, pos);
    std::memcpy(dst_ + out_, lit + lpos, static_cast<size_t>(rest));
    out_ += rest;
    if (out_ - block_start > kBlockMax) fail("block decodes to more than 128 KiB", pos);
  }
};

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

constexpr uint64_t kP1 = 0x9E3779B185EBCA87ull, kP2 = 0xC2B2AE3D27D4EB4Full,
                   kP3 = 0x165667B19E3779F9ull, kP4 = 0x85EBCA77C2B2AE63ull,
                   kP5 = 0x27D4EB2F165667C5ull;

inline uint64_t xround(uint64_t acc, uint64_t in) {
  acc += in * kP2;
  acc = rotl(acc, 31);
  return acc * kP1;
}

inline uint64_t xmerge(uint64_t acc, uint64_t v) {
  acc ^= xround(0, v);
  return acc * kP1 + kP4;
}

uint64_t Decoder::xxh64(const uint8_t* p, int64_t len, uint64_t seed) {
  const uint8_t* end = p + len;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = seed + kP1 + kP2, v2 = seed + kP2, v3 = seed, v4 = seed - kP1;
    const uint8_t* limit = end - 32;
    do {
      uint64_t w[4];
      std::memcpy(w, p, 32);
      v1 = xround(v1, w[0]);
      v2 = xround(v2, w[1]);
      v3 = xround(v3, w[2]);
      v4 = xround(v4, w[3]);
      p += 32;
    } while (p <= limit);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xmerge(h, v1);
    h = xmerge(h, v2);
    h = xmerge(h, v3);
    h = xmerge(h, v4);
  } else {
    h = seed + kP5;
  }
  h += static_cast<uint64_t>(len);
  while (end - p >= 8) {
    uint64_t k;
    std::memcpy(&k, p, 8);
    h ^= xround(0, k);
    h = rotl(h, 27) * kP1 + kP4;
    p += 8;
  }
  if (end - p >= 4) {
    h ^= static_cast<uint64_t>(rd32(p)) * kP1;
    h = rotl(h, 23) * kP2 + kP3;
    p += 4;
  }
  while (p < end) {
    h ^= (*p++) * kP5;
    h = rotl(h, 11) * kP1;
  }
  h ^= h >> 33;
  h *= kP2;
  h ^= h >> 29;
  h *= kP3;
  h ^= h >> 32;
  return h;
}

// CRC-32C (Castagnoli, reflected polynomial 0x82F63B78), eight bytes a step
struct Crc32cTables {
  uint32_t t[8][256];
  Crc32cTables() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1)));
      t[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i)
      for (int k = 1; k < 8; ++k) t[k][i] = (t[k - 1][i] >> 8) ^ t[0][t[k - 1][i] & 0xFF];
  }
};

const Crc32cTables& crc_tables() {
  static const Crc32cTables tables;
  return tables;
}

void put_error(char* err, int64_t err_len, const std::string& msg) {
  if (err && err_len > 0) std::snprintf(err, static_cast<size_t>(err_len), "%s", msg.c_str());
}

}  // namespace

extern "C" {

// Decodes every frame of src[0:src_len] into dst (capacity dst_cap);
// returns the bytes written, or -1 with a message (and the input offset)
// in err.
int64_t zstd_decompress(const uint8_t* src, int64_t src_len, uint8_t* dst, int64_t dst_cap,
                        char* err, int64_t err_len) {
  try {
    Decoder d(src, src_len, dst, dst_cap);
    return d.run();
  } catch (const Fault& f) {
    put_error(err, err_len, "zstd: " + f.msg);
  } catch (const std::exception& e) {
    put_error(err, err_len, std::string("zstd: ") + e.what());
  }
  return -1;
}

// CRC-32C of data[0:n], continuing from crc (0 to start).
uint32_t crc32c(const uint8_t* data, int64_t n, uint32_t crc) {
  const auto& T = crc_tables().t;
  uint32_t c = ~crc;
  while (n >= 8) {
    uint64_t w;
    std::memcpy(&w, data, 8);
    w ^= c;
    c = T[7][w & 0xFF] ^ T[6][(w >> 8) & 0xFF] ^ T[5][(w >> 16) & 0xFF] ^
        T[4][(w >> 24) & 0xFF] ^ T[3][(w >> 32) & 0xFF] ^ T[2][(w >> 40) & 0xFF] ^
        T[1][(w >> 48) & 0xFF] ^ T[0][w >> 56];
    data += 8;
    n -= 8;
  }
  while (n-- > 0) c = (c >> 8) ^ T[0][(c ^ *data++) & 0xFF];
  return ~c;
}

}  // extern "C"
