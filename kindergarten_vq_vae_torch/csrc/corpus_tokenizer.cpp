// Corpus tokenizer and packer on the host, for the PyTorch port.
//
// The port's own copy of native/corpus_tokenizer.cpp: the offline pass that
// turns the clean sentence corpus into fixed-shape int32 [ids, mask] arrays
// (data/prepare.py tokenize_corpus), sharded over std::thread workers:
// word-level lookup and greedy longest-match-first WordPiece, the same ids
// and masks as data/tokenizer.py's encode_batch (the tests hold them bit for
// bit, and to the JAX package's packer).
//
// Built into kindergarten_vq_vae_torch/build/ by data/native.py (g++ -O3
// -shared -fPIC -std=c++17 -pthread) at first use and called through
// ctypes; the Python path stays where no toolchain is found.

#include <cstring>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct Vocab {
  std::unordered_map<std::string, int> map;
  int unk_id;
  int cls_id;
  int sep_id;
  bool word_level;  // word-level lookup vs WordPiece subword splitting
};

// WordPiece greedy longest-match-first (data/tokenizer.py:_wordpiece).
void encode_word(const Vocab& v, const std::string& word, std::vector<int>* out) {
  if (v.word_level) {
    auto it = v.map.find(word);
    out->push_back(it == v.map.end() ? v.unk_id : it->second);
    return;
  }
  size_t start = 0;
  std::vector<int> pieces;
  while (start < word.size()) {
    size_t end = word.size();
    int cur = -1;
    while (start < end) {
      std::string sub = word.substr(start, end - start);
      if (start > 0) sub = "##" + sub;
      auto it = v.map.find(sub);
      if (it != v.map.end()) {
        cur = it->second;
        break;
      }
      --end;
    }
    if (cur < 0) {  // unmatchable word -> single UNK
      out->push_back(v.unk_id);
      return;
    }
    pieces.push_back(cur);
    start = end;
  }
  out->insert(out->end(), pieces.begin(), pieces.end());
}

void encode_range(const Vocab& v, const char* text, const long* offsets,
                  long begin, long end, int add_special, int max_len,
                  int* out_ids, int* out_mask) {
  std::vector<int> ids;
  for (long s = begin; s < end; ++s) {
    ids.clear();
    if (add_special) ids.push_back(v.cls_id);
    const char* p = text + offsets[s];
    const char* stop = text + offsets[s + 1];
    while (p < stop) {
      while (p < stop && *p == ' ') ++p;
      const char* w = p;
      while (p < stop && *p != ' ') ++p;
      if (p > w) encode_word(v, std::string(w, p - w), &ids);
    }
    if (add_special) ids.push_back(v.sep_id);
    int n = static_cast<int>(ids.size());
    if (n > max_len) n = max_len;
    int* row_ids = out_ids + s * max_len;
    int* row_mask = out_mask + s * max_len;
    for (int i = 0; i < n; ++i) {
      row_ids[i] = ids[i];
      row_mask[i] = 1;
    }
    for (int i = n; i < max_len; ++i) {
      row_ids[i] = 0;
      row_mask[i] = 0;
    }
  }
}

}  // namespace

extern "C" {

// text: concatenated sentence bytes; offsets: n_sentences+1 byte offsets.
// vocab_blob: NUL-separated tokens, id = position in blob.
// Returns 0 on success.
int tokenize_corpus(const char* text, const long* offsets, long n_sentences,
                    const char* vocab_blob, long vocab_blob_len, long n_vocab,
                    int unk_id, int cls_id, int sep_id, int word_level,
                    int add_special, int max_len, int n_threads,
                    int* out_ids, int* out_mask) {
  Vocab v;
  v.unk_id = unk_id;
  v.cls_id = cls_id;
  v.sep_id = sep_id;
  v.word_level = word_level != 0;
  v.map.reserve(static_cast<size_t>(n_vocab) * 2);
  const char* p = vocab_blob;
  const char* blob_end = vocab_blob + vocab_blob_len;
  for (long i = 0; i < n_vocab && p < blob_end; ++i) {
    size_t len = strnlen(p, blob_end - p);
    v.map.emplace(std::string(p, len), static_cast<int>(i));
    p += len + 1;
  }
  if (static_cast<long>(v.map.size()) != n_vocab) return 1;

  if (n_threads < 1) n_threads = 1;
  if (n_threads > n_sentences) n_threads = static_cast<int>(n_sentences ? n_sentences : 1);
  std::vector<std::thread> workers;
  long chunk = (n_sentences + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    long begin = t * chunk;
    long end = begin + chunk < n_sentences ? begin + chunk : n_sentences;
    if (begin >= end) break;
    workers.emplace_back(encode_range, std::cref(v), text, offsets, begin, end,
                         add_special, max_len, out_ids, out_mask);
  }
  for (auto& w : workers) w.join();
  return 0;
}

}  // extern "C"
