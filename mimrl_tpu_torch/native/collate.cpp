// Host-side data-pipeline routines of mimrl_tpu_torch (the port's own copy
// of the JAX package's collate.cpp, without its row gather, which no path
// calls): padded-batch assembly and a WordPiece tokenizer, behind a plain
// C interface that mimrl_tpu_torch/native/__init__.py loads with ctypes.
//
// The reference leans on torch's DataLoader workers and HF's Rust
// tokenizers for its host pipeline (ref: DataLoaderCMUSDK.py collate fns,
// DataLoaderCMUDeclareLab.py:426-436 per-batch tokenization).
//
// Build: g++ -O3 -std=c++17 -shared -fPIC collate.cpp -o <library>.so
// (native/__init__.py does this at first use).

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

extern "C" {

// ----------------------------------------------------------------------
// Padded batch assembly: stack n variable-length [len_i, d] float32
// arrays into [n, time_len, d], truncating/zero-padding the time axis.
// ----------------------------------------------------------------------
void pad_stack_f32(const float** srcs, const int64_t* lens, int64_t n,
                   int64_t time_len, int64_t d, float* out) {
  const int64_t row_bytes = d * static_cast<int64_t>(sizeof(float));
  const int64_t sample_elems = time_len * d;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t keep = lens[i] < time_len ? lens[i] : time_len;
    float* dst = out + i * sample_elems;
    std::memcpy(dst, srcs[i], keep * row_bytes);
    if (keep < time_len) {
      std::memset(dst + keep * d, 0, (time_len - keep) * row_bytes);
    }
  }
}

// ----------------------------------------------------------------------
// WordPiece tokenizer.
//
// Vocabulary is installed once per process; texts arrive as one UTF-8
// buffer with offsets; output is [n, max_len] int32 (ids / type_ids /
// attention_mask write into caller-provided buffers).
// ----------------------------------------------------------------------

namespace {

struct Vocab {
  std::unordered_map<std::string, int32_t> table;
  int32_t pad_id = 0, unk_id = 1, cls_id = 2, sep_id = 3;
  bool lower = true;
  int32_t max_word_chars = 100;
};

Vocab* g_vocab = nullptr;

inline bool is_space(unsigned char c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\f' ||
         c == '\v';
}

inline bool is_ascii_punct(unsigned char c) {
  return (c >= 33 && c <= 47) || (c >= 58 && c <= 64) ||
         (c >= 91 && c <= 96) || (c >= 123 && c <= 126);
}

// Greedy longest-match WordPiece of a single word into ids.
void wordpiece(const Vocab& v, const std::string& word,
               std::vector<int32_t>& out) {
  if (static_cast<int32_t>(word.size()) > v.max_word_chars) {
    out.push_back(v.unk_id);
    return;
  }
  size_t start = 0;
  std::vector<int32_t> pieces;
  std::string sub;
  while (start < word.size()) {
    size_t end = word.size();
    int32_t piece_id = -1;
    while (start < end) {
      sub.assign(word, start, end - start);
      if (start > 0) sub = "##" + sub;
      auto it = v.table.find(sub);
      if (it != v.table.end()) {
        piece_id = it->second;
        break;
      }
      --end;
    }
    if (piece_id < 0) {
      out.push_back(v.unk_id);
      return;
    }
    pieces.push_back(piece_id);
    start = end;
  }
  out.insert(out.end(), pieces.begin(), pieces.end());
}

}  // namespace

// vocab_blob: '\n'-joined tokens, token index = vocab id (vocab.txt order).
int32_t tokenizer_init(const char* vocab_blob, int64_t blob_len,
                       int32_t pad_id, int32_t unk_id, int32_t cls_id,
                       int32_t sep_id, int32_t lower) {
  delete g_vocab;
  g_vocab = new Vocab();
  g_vocab->pad_id = pad_id;
  g_vocab->unk_id = unk_id;
  g_vocab->cls_id = cls_id;
  g_vocab->sep_id = sep_id;
  g_vocab->lower = lower != 0;
  int32_t id = 0;
  const char* p = vocab_blob;
  const char* endp = vocab_blob + blob_len;
  while (p < endp) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', endp - p));
    size_t len = nl ? static_cast<size_t>(nl - p) : static_cast<size_t>(endp - p);
    g_vocab->table.emplace(std::string(p, len), id++);
    p = nl ? nl + 1 : endp;
  }
  return id;  // vocab size
}

// Encode n texts (utf8 buffer + offsets[n+1]) to [n, max_len] ids/types/mask.
// Reproduces encode(..., max_length, pad_to_max=True): [CLS] body [SEP] pad.
void tokenizer_encode_batch(const char* utf8, const int64_t* offsets,
                            int64_t n, int32_t max_len, int32_t* ids,
                            int32_t* types, int32_t* mask) {
  const Vocab& v = *g_vocab;
  std::vector<int32_t> body;
  std::string word;
  for (int64_t i = 0; i < n; ++i) {
    body.clear();
    const char* p = utf8 + offsets[i];
    const char* endp = utf8 + offsets[i + 1];
    word.clear();
    const size_t body_cap = static_cast<size_t>(max_len) - 2;
    while (p <= endp && body.size() < body_cap + 8) {
      char c = (p < endp) ? *p : ' ';
      unsigned char uc = static_cast<unsigned char>(c);
      if (v.lower && uc >= 'A' && uc <= 'Z') c = c - 'A' + 'a';
      if (p == endp || is_space(uc)) {
        if (!word.empty()) {
          wordpiece(v, word, body);
          word.clear();
        }
      } else if (is_ascii_punct(uc)) {
        if (!word.empty()) {
          wordpiece(v, word, body);
          word.clear();
        }
        wordpiece(v, std::string(1, c), body);
      } else {
        word.push_back(c);
      }
      if (p == endp) break;
      ++p;
    }
    if (body.size() > body_cap) body.resize(body_cap);

    int32_t* id_row = ids + i * max_len;
    int32_t* ty_row = types + i * max_len;
    int32_t* mk_row = mask + i * max_len;
    int32_t pos = 0;
    id_row[pos++] = v.cls_id;
    for (int32_t b : body) id_row[pos++] = b;
    id_row[pos++] = v.sep_id;
    const int32_t valid = pos;
    for (; pos < max_len; ++pos) id_row[pos] = v.pad_id;
    for (int32_t j = 0; j < max_len; ++j) {
      ty_row[j] = 0;
      mk_row[j] = j < valid ? 1 : 0;
    }
  }
}

void tokenizer_free() {
  delete g_vocab;
  g_vocab = nullptr;
}

}  // extern "C"
