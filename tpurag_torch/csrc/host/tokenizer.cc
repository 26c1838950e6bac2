// Ported from the JAX package's native/tokenizer.cc: its tokenizer and tr_batch_postings.
//
// Native tokenizer + term counter for the keyword index's batched ingest
// (index/postings.py, InvertedIndex.add_batch). Behavior must match
// tpurag_torch/ingest/tokenizer.py, which tokenizes str.lower(), exactly
// (it is the spec; tests cross-check both on every code point):
//   - ASCII [a-z0-9_]+ runs, lowercased, are word tokens;
//   - CJK runs (U+3040-30FF, U+3400-4DBF, U+4E00-9FFF, U+AC00-D7AF) emit
//     character bigrams (single char -> unigram);
//   - U+0130 and U+212A, the only other characters whose str.lower()
//     holds a word or CJK character, are folded as str.lower() folds
//     them (the JAX package's copy treats them as separators);
//   - everything else separates tokens.
//
// Exposed C ABI (ctypes, index/postings.py):
//   char* tr_batch_postings(const char* buf, const uint64_t* offs,
//                           uint64_t n_docs, uint32_t n_threads);
//   void  tr_free(void* p);

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <system_error>
#include <thread>
#include <vector>

namespace {

inline uint64_t fnv1a(const char* s, size_t n) {
  uint64_t h = 1469598103934665603ULL;
  for (size_t i = 0; i < n; ++i) {
    h ^= static_cast<unsigned char>(s[i]);
    h *= 1099511628211ULL;
  }
  return h;
}

// String interner: open-addressing table over one contiguous byte arena.
// Replaces unordered_map<string,...> on the ingest hot path — no per-token
// std::string allocation, no per-node heap traffic, one memcmp per probe.
class Interner {
 public:
  Interner() : table_(kInitCap, 0), mask_(kInitCap - 1) {}

  uint32_t intern(const char* s, size_t n, uint64_t h) {
    size_t i = h & mask_;
    while (true) {
      uint32_t v = table_[i];
      if (v == 0) {
        uint32_t idx = size();
        offs_.push_back(static_cast<uint32_t>(buf_.size()));
        lens_.push_back(static_cast<uint32_t>(n));
        hash_.push_back(h);
        buf_.insert(buf_.end(), s, s + n);
        table_[i] = idx + 1;
        if ((size() + 1) * 10 >= (mask_ + 1) * 7) grow();
        return idx;
      }
      uint32_t idx = v - 1;
      if (hash_[idx] == h && lens_[idx] == n &&
          std::memcmp(buf_.data() + offs_[idx], s, n) == 0)
        return idx;
      i = (i + 1) & mask_;
    }
  }

  uint32_t size() const { return static_cast<uint32_t>(offs_.size()); }
  const char* term(uint32_t idx) const { return buf_.data() + offs_[idx]; }
  uint32_t term_len(uint32_t idx) const { return lens_[idx]; }
  uint64_t hash(uint32_t idx) const { return hash_[idx]; }
  size_t arena_payload() const {  // Σ (4 + len) for the packed layout
    return buf_.size() + 4 * offs_.size();
  }

 private:
  static constexpr size_t kInitCap = 4096;

  void grow() {
    size_t cap = (mask_ + 1) * 2;
    std::vector<uint32_t> nt(cap, 0);
    size_t nm = cap - 1;
    for (uint32_t idx = 0; idx < size(); ++idx) {
      size_t i = hash_[idx] & nm;
      while (nt[i]) i = (i + 1) & nm;
      nt[i] = idx + 1;
    }
    table_.swap(nt);
    mask_ = nm;
  }

  std::vector<uint32_t> table_;  // slot -> intern idx + 1 (0 = empty)
  size_t mask_;
  std::vector<char> buf_;
  std::vector<uint32_t> offs_, lens_;
  std::vector<uint64_t> hash_;
};

inline bool is_word_byte(unsigned char c) {
  return (c >= 'a' && c <= 'z') || (c >= '0' && c <= '9') || c == '_';
}

inline bool is_cjk(uint32_t cp) {
  return (cp >= 0x3040 && cp <= 0x30FF) || (cp >= 0x3400 && cp <= 0x4DBF) ||
         (cp >= 0x4E00 && cp <= 0x9FFF) || (cp >= 0xAC00 && cp <= 0xD7AF);
}

// Decode one UTF-8 codepoint; returns bytes consumed (0 on invalid).
inline size_t decode_utf8(const unsigned char* s, size_t len, uint32_t* cp) {
  if (len == 0) return 0;
  unsigned char c = s[0];
  if (c < 0x80) { *cp = c; return 1; }
  if ((c >> 5) == 0x6 && len >= 2 && (s[1] & 0xC0) == 0x80) {
    *cp = ((c & 0x1F) << 6) | (s[1] & 0x3F);
    return 2;
  }
  if ((c >> 4) == 0xE && len >= 3 && (s[1] & 0xC0) == 0x80 &&
      (s[2] & 0xC0) == 0x80) {
    *cp = ((c & 0x0F) << 12) | ((s[1] & 0x3F) << 6) | (s[2] & 0x3F);
    return 3;
  }
  if ((c >> 3) == 0x1E && len >= 4 && (s[1] & 0xC0) == 0x80 &&
      (s[2] & 0xC0) == 0x80 && (s[3] & 0xC0) == 0x80) {
    *cp = ((c & 0x07) << 18) | ((s[1] & 0x3F) << 12) | ((s[2] & 0x3F) << 6) |
          (s[3] & 0x3F);
    return 4;
  }
  *cp = 0xFFFD;
  return 1;
}

inline void encode_utf8(uint32_t cp, std::string* out) {
  if (cp < 0x80) {
    out->push_back(static_cast<char>(cp));
  } else if (cp < 0x800) {
    out->push_back(static_cast<char>(0xC0 | (cp >> 6)));
    out->push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  } else if (cp < 0x10000) {
    out->push_back(static_cast<char>(0xE0 | (cp >> 12)));
    out->push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
    out->push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  } else {
    out->push_back(static_cast<char>(0xF0 | (cp >> 18)));
    out->push_back(static_cast<char>(0x80 | ((cp >> 12) & 0x3F)));
    out->push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
    out->push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  }
}

// Emit signature: (const char* token_utf8, size_t len). Tokens live in
// reused buffers — callers must copy (or intern) before the next emit.
template <typename Emit>
void tokenize(const char* data, size_t len, Emit emit) {
  const unsigned char* s = reinterpret_cast<const unsigned char*>(data);
  size_t i = 0;
  std::string word;
  std::vector<uint32_t> cjk_run;
  std::string bigram;  // reused scratch for CJK uni/bigrams

  auto flush_word = [&]() {
    if (!word.empty()) {
      emit(word.data(), word.size());
      word.clear();
    }
  };
  auto flush_cjk = [&]() {
    if (cjk_run.size() == 1) {
      bigram.clear();
      encode_utf8(cjk_run[0], &bigram);
      emit(bigram.data(), bigram.size());
    } else if (cjk_run.size() > 1) {
      for (size_t j = 0; j + 1 < cjk_run.size(); ++j) {
        bigram.clear();
        encode_utf8(cjk_run[j], &bigram);
        encode_utf8(cjk_run[j + 1], &bigram);
        emit(bigram.data(), bigram.size());
      }
    }
    cjk_run.clear();
  };

  while (i < len) {
    unsigned char c = s[i];
    if (c < 0x80) {
      unsigned char lc =
          (c >= 'A' && c <= 'Z') ? static_cast<unsigned char>(c + 32) : c;
      if (is_word_byte(lc)) {
        flush_cjk();
        word.push_back(static_cast<char>(lc));
      } else {
        flush_word();
        flush_cjk();
      }
      ++i;
      continue;
    }
    uint32_t cp = 0;
    size_t used = decode_utf8(s + i, len - i, &cp);
    i += used ? used : 1;
    if (is_cjk(cp)) {
      flush_word();
      cjk_run.push_back(cp);
    } else if (cp == 0x212A) {  // KELVIN SIGN: str.lower() gives "k"
      flush_cjk();
      word.push_back('k');
    } else if (cp == 0x130) {  // str.lower() gives "i" + U+0307, a separator
      flush_cjk();
      word.push_back('i');
      flush_word();
    } else {
      flush_word();
      flush_cjk();
    }
  }
  flush_word();
  flush_cjk();
}

// One thread's share of a batch: documents [lo, hi), their terms interned
// in first-occurrence order, their (term, count) pairs doc-major.
struct Part {
  uint64_t lo = 0, hi = 0;
  Interner intern;
  std::vector<uint32_t> pair_idx, pair_cnt;
  std::vector<uint32_t> doc_pair_start;  // hi - lo + 1 offsets into pairs
  bool failed = false;
};

void tokenize_part(const char* buf, const uint64_t* offs, Part* part,
                   uint32_t* doc_total) {
  try {
    std::vector<uint32_t> stamp, slot;  // per-doc dedup, sized n_unique
    part->doc_pair_start.assign(part->hi - part->lo + 1, 0);
    for (uint64_t d = part->lo; d < part->hi; ++d) {
      const uint32_t mark = static_cast<uint32_t>(d - part->lo) + 1;
      tokenize(buf + offs[d], static_cast<size_t>(offs[d + 1] - offs[d]),
               [&](const char* t, size_t n) {
                 uint32_t idx = part->intern.intern(t, n, fnv1a(t, n));
                 if (idx >= stamp.size()) {
                   stamp.resize(part->intern.size(), 0);
                   slot.resize(part->intern.size(), 0);
                 }
                 ++doc_total[d];
                 if (stamp[idx] != mark) {
                   stamp[idx] = mark;
                   slot[idx] = static_cast<uint32_t>(part->pair_idx.size());
                   part->pair_idx.push_back(idx);
                   part->pair_cnt.push_back(1);
                 } else {
                   ++part->pair_cnt[slot[idx]];
                 }
               });
      part->doc_pair_start[d - part->lo + 1] =
          static_cast<uint32_t>(part->pair_idx.size());
    }
  } catch (...) {  // out of memory: the call returns NULL
    part->failed = true;
  }
}

}  // namespace

extern "C" {

// Batch tokenize + count + GROUP BY TERM — the whole host-side restructure
// an inverted-index batch add needs, in one C call. Interning uses the
// open-addressing arena Interner (no per-token allocation), the per-doc
// dedup uses stamp arrays instead of a hash map, and the grouping is a
// counting pass (O(pairs), no sort). n_threads threads tokenize ranges
// of the documents, each into its own interner; the merge keeps the
// first-occurrence order and doc arrival order of one pass over the
// batch, so the output does not depend on n_threads.
//
//   buf:  concatenated UTF-8 documents
//   offs: n_docs+1 byte offsets into buf
//
// The counts are 32-bit: the caller keeps a call's output under 4 GiB
// (index/postings.py cuts a batch into calls of MAX_CALL_BYTES of text).
//
// Returns one malloc'd packed little-endian buffer (tr_free to release),
// or NULL when memory runs out:
//   u32 total_bytes              (size of the whole buffer)
//   u32 n_unique                 (batch-unique terms, first-occurrence order)
//   u32 arena_bytes              (4-padded)
//   u32 n_docs
//   u32 total_pairs
//   arena:      n_unique x (u32 len, len bytes)  then pad to 4
//   doc_total:  n_docs u32       (total token count per doc -> doc_len)
//   gcount:     n_unique u32     (docs containing term u)
//   gdoc:       total_pairs u32  (doc index in batch; grouped by term u
//                                 ascending, doc arrival order within term)
//   gcnt:       total_pairs u32  (term frequency for the same pair)
char* tr_batch_postings(const char* buf, const uint64_t* offs,
                        uint64_t n_docs, uint32_t n_threads) try {
  // Cut the documents into ranges of about equal bytes, one a thread;
  // the caller's thread takes the first.
  const uint64_t n_parts = std::max<uint64_t>(
      1, std::min<uint64_t>(n_threads, n_docs));
  std::vector<Part> parts(n_parts);
  const uint64_t bytes = offs[n_docs] - offs[0];
  for (uint64_t t = 1; t < n_parts; ++t) {
    const uint64_t target = offs[0] + bytes / n_parts * t;
    parts[t].lo = std::max<uint64_t>(
        parts[t - 1].lo,
        std::lower_bound(offs, offs + n_docs, target) - offs);
    parts[t - 1].hi = parts[t].lo;
  }
  parts[n_parts - 1].hi = n_docs;
  std::vector<uint32_t> doc_total(n_docs, 0);
  std::vector<std::thread> threads;
  std::vector<uint64_t> inline_parts;  // where no thread could be started
  threads.reserve(n_parts);  // no allocation while threads run
  inline_parts.reserve(n_parts);
  for (uint64_t t = 1; t < n_parts; ++t) {
    try {
      threads.emplace_back(tokenize_part, buf, offs, &parts[t],
                           doc_total.data());
    } catch (const std::system_error&) {
      inline_parts.push_back(t);
    }
  }
  tokenize_part(buf, offs, &parts[0], doc_total.data());
  for (uint64_t t : inline_parts)
    tokenize_part(buf, offs, &parts[t], doc_total.data());
  for (auto& th : threads) th.join();
  for (const Part& part : parts)
    if (part.failed) return nullptr;

  // The batch's terms in first-occurrence order: each part's in its own
  // order, those an earlier part met kept where they were.
  Interner intern;
  std::vector<std::vector<uint32_t>> global(n_parts);
  for (uint64_t t = 0; t < n_parts; ++t) {
    const Interner& local = parts[t].intern;
    global[t].resize(local.size());
    for (uint32_t u = 0; u < local.size(); ++u)
      global[t][u] = intern.intern(local.term(u), local.term_len(u),
                                   local.hash(u));
  }
  const uint32_t n_unique = intern.size();
  size_t total_pairs = 0;
  for (const Part& part : parts) total_pairs += part.pair_idx.size();

  // Counting-group by term: offsets, then the parts' pairs in document
  // order, so each term's postings keep doc arrival order (sequential-add
  // parity).
  std::vector<uint32_t> gcount(n_unique, 0);
  for (uint64_t t = 0; t < n_parts; ++t)
    for (uint32_t u : parts[t].pair_idx) ++gcount[global[t][u]];
  std::vector<uint32_t> cursor(n_unique + 1, 0);
  for (uint32_t u = 0; u < n_unique; ++u) cursor[u + 1] = cursor[u] + gcount[u];
  std::vector<uint32_t> gdoc(total_pairs), gcnt(total_pairs);
  for (uint64_t t = 0; t < n_parts; ++t) {
    const Part& part = parts[t];
    for (uint64_t d = part.lo; d < part.hi; ++d) {
      for (uint32_t p = part.doc_pair_start[d - part.lo];
           p < part.doc_pair_start[d - part.lo + 1]; ++p) {
        const uint32_t c = cursor[global[t][part.pair_idx[p]]]++;
        gdoc[c] = static_cast<uint32_t>(d);
        gcnt[c] = part.pair_cnt[p];
      }
    }
  }
  parts.clear();

  size_t arena_bytes = (intern.arena_payload() + 3) & ~size_t(3);
  const size_t total = 20 + arena_bytes + 4 * n_docs + 4 * n_unique +
                       8 * total_pairs;
  char* out = static_cast<char*>(std::malloc(total));
  if (out == nullptr) return nullptr;
  uint32_t* hdr = reinterpret_cast<uint32_t*>(out);
  hdr[0] = static_cast<uint32_t>(total);
  hdr[1] = n_unique;
  hdr[2] = static_cast<uint32_t>(arena_bytes);
  hdr[3] = static_cast<uint32_t>(n_docs);
  hdr[4] = static_cast<uint32_t>(total_pairs);
  char* p = out + 20;
  for (uint32_t u = 0; u < n_unique; ++u) {
    const uint32_t len = intern.term_len(u);
    std::memcpy(p, &len, 4);
    std::memcpy(p + 4, intern.term(u), len);
    p += 4 + len;
  }
  p = out + 20 + arena_bytes;  // skip pad
  std::memcpy(p, doc_total.data(), 4 * n_docs);
  p += 4 * n_docs;
  if (n_unique) std::memcpy(p, gcount.data(), 4 * n_unique);
  p += 4 * n_unique;
  if (total_pairs) {
    std::memcpy(p, gdoc.data(), 4 * total_pairs);
    std::memcpy(p + 4 * total_pairs, gcnt.data(), 4 * total_pairs);
  }
  return out;
} catch (...) {  // out of memory
  return nullptr;
}

void tr_free(void* p) { std::free(p); }

}  // extern "C"
