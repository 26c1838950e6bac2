// Batched query-term highlighting on the host (no CUDA): the native form
// of index/inverted.highlight over every keyword-found result of a search.
//
// The Python version's alternation under re.IGNORECASE, longest token
// first, marks the leftmost match, the longest of those that start
// there, and resumes after it. Here, over UTF-8 with A-Z folded onto
// a-z (given the input gate below):
//
// 1. One pass over each text, from its end to its start, finds every
//    (start, longest token starting there): a shift-and automaton over
//    the query's tokens reversed, packed end to end into 64-bit words
//    (one pass per word; a query rarely needs two). A byte's step is a
//    shift, an or and an and, with no branch but the rare match test.
// 2. A walk over those starts, left to right, keeps each one at or past
//    the end of the last kept match, and writes the marked text.
//
// A token is UTF-8, so a match can start only where a character starts.
// A query with a token longer than 64 bytes is not taken here.
//
// The gate: the caller routes to the Python version every query whose
// tokens hold a cased non-ASCII character; this file routes every text
// that holds one of the four non-ASCII characters re.IGNORECASE matches
// to ASCII letters (U+0130, U+0131, U+017F, U+212A), and flags it.
//
// Re-entrant: no state outside the call's own objects. The output buffer
// belongs to the call's handle until tr_highlight_free.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <utility>
#include <vector>

namespace {

inline uint8_t fold(uint8_t b) {
  return (b >= 'A' && b <= 'Z') ? static_cast<uint8_t>(b + 32) : b;
}

// Reversed tokens packed into 64 bits: token j holds bits [o, o + len),
// bit o + k for its byte len - 1 - k.
struct Word {
  uint64_t mask[256];  // by text byte: the bits whose token byte it folds to
  uint64_t start = 0;  // each token's first bit
  uint64_t end = 0;    // each token's last bit
  uint8_t len[64];     // at a last bit: its token's bytes
};

struct QueryTable {
  std::vector<Word> words;
  bool ok = true;  // no token is longer than 64 bytes

  // The n tokens at tok[off[t]:off[t + 1]], t < n.
  void build(const uint8_t* tok, const int64_t* off, int64_t n) {
    std::vector<std::string> toks;
    for (int64_t t = 0; t < n; ++t) {
      if (off[t + 1] == off[t]) continue;  // empty tokens match nothing
      std::string s(reinterpret_cast<const char*>(tok + off[t]),
                    static_cast<size_t>(off[t + 1] - off[t]));
      for (auto& c : s) c = static_cast<char>(fold(static_cast<uint8_t>(c)));
      toks.push_back(std::move(s));
    }
    std::sort(toks.begin(), toks.end());
    toks.erase(std::unique(toks.begin(), toks.end()), toks.end());
    words.clear();
    ok = true;
    int used = 64;
    for (const auto& s : toks) {
      const int len = static_cast<int>(s.size());
      if (len > 64) {
        ok = false;
        return;
      }
      if (used + len > 64) {
        words.emplace_back();
        std::memset(words.back().mask, 0, sizeof(Word::mask));
        used = 0;
      }
      Word& w = words.back();
      for (int k = 0; k < len; ++k) {
        const uint8_t c = s[len - 1 - k];
        const uint64_t bit = uint64_t{1} << (used + k);
        w.mask[c] |= bit;
        if (c >= 'a' && c <= 'z') w.mask[c - 32] |= bit;
      }
      w.start |= uint64_t{1} << used;
      w.end |= uint64_t{1} << (used + len - 1);
      w.len[used + len - 1] = static_cast<uint8_t>(len);
      used += len;
    }
  }
};

// True when t[0:n] begins with U+0130, U+0131, U+017F or U+212A.
inline bool gated(const uint8_t* t, int64_t n) {
  if (n >= 2 && t[0] == 0xC4) return t[1] == 0xB0 || t[1] == 0xB1;
  if (n >= 2 && t[0] == 0xC5) return t[1] == 0xBF;
  if (n >= 3 && t[0] == 0xE2) return t[1] == 0x84 && t[2] == 0xAA;
  return false;
}

bool has_gated(const uint8_t* t, int64_t n) {
  for (int64_t p = 0; p < n; ++p) {
    if (t[p] >= 0xC4 && gated(t + p, n - p)) return true;
  }
  return false;
}

// Appends every (start, longest token there) of t[0:n] for one word, in
// descending start order.
void find(const Word& w, const uint8_t* t, int64_t n,
          std::vector<std::pair<int64_t, int64_t>>& hits) {
  uint64_t d = 0;
  for (int64_t p = n - 1; p >= 0; --p) {
    d = ((d << 1) | w.start) & w.mask[t[p]];
    if (uint64_t e = d & w.end) {
      int64_t best = 0;
      for (; e; e &= e - 1)
        best = std::max<int64_t>(best, w.len[__builtin_ctzll(e)]);
      hits.emplace_back(p, best);
    }
  }
}

// Appends the marked text to out; returns the number of marks.
int64_t mark_text(const QueryTable& q, const uint8_t* t, int64_t n,
                  const uint8_t* mark, int64_t mark_len, std::string& out,
                  std::vector<std::pair<int64_t, int64_t>>& hits) {
  hits.clear();
  for (const Word& w : q.words) find(w, t, n, hits);
  if (q.words.size() > 1) {  // one start per position, its longest token
    std::sort(hits.begin(), hits.end(),
              [](const auto& a, const auto& b) {
                return a.first != b.first ? a.first > b.first
                                          : a.second < b.second;
              });
  }
  int64_t last = 0, marks = 0;
  for (auto it = hits.rbegin(); it != hits.rend(); ++it) {
    const int64_t p = it->first, len = it->second;
    if (p < last) continue;  // inside a kept match, or a shorter token
    out.append(reinterpret_cast<const char*>(t + last), p - last);
    out.append(reinterpret_cast<const char*>(mark), mark_len);
    out.append(reinterpret_cast<const char*>(t + p), len);
    out.append(reinterpret_cast<const char*>(mark), mark_len);
    last = p + len;
    ++marks;
  }
  out.append(reinterpret_cast<const char*>(t + last), n - last);
  return marks;
}

}  // namespace

extern "C" {

// Marks n_texts texts, each with its query's tokens.
//   text: the texts' UTF-8, back to back, text_len bytes; text_chars[i]:
//     text i's length in code points; ascii != 0 says every byte is ASCII
//     (then the two lengths agree, and neither the code-point walk nor
//     the gate runs);
//   text_query[i]: text i's query, in [0, n_queries); runs of one query
//     are fastest (a query's table is built when the query changes);
//   tok, tok_off: every query's tokens' UTF-8, back to back, token t at
//     tok[tok_off[t]:tok_off[t + 1]]; query q's tokens are
//     [query_tok[q], query_tok[q + 1]);
//   mark: the mark's UTF-8 (mark_chars code points);
//   fallback[i]: in, 1 to skip text i; out, also 1 where text i is gated
//     or its query has a token longer than 64 bytes. Such a text adds
//     nothing to the output;
//   out_chars[i]: the output's code-point offset of text i's marked text,
//     out_chars[n_texts] the total.
// Returns a handle for tr_highlight_free, with *out / *out_len the
// output's UTF-8, or null if memory ran out.
void* tr_highlight_batch(const uint8_t* text, int64_t text_len,
                         const int64_t* text_chars, int64_t n_texts,
                         int ascii, const int32_t* text_query,
                         const uint8_t* tok, const int64_t* tok_off,
                         const int64_t* query_tok, const uint8_t* mark,
                         int64_t mark_len, int64_t mark_chars,
                         uint8_t* fallback, int64_t* out_chars,
                         const char** out, int64_t* out_len) {
  std::string* buf = nullptr;
  try {
    buf = new std::string();
    buf->reserve(static_cast<size_t>(text_len + text_len / 4 + 64));
    QueryTable q;
    std::vector<std::pair<int64_t, int64_t>> hits;
    int32_t built = -1;
    int64_t pos = 0, chars = 0;
    out_chars[0] = 0;
    for (int64_t i = 0; i < n_texts; ++i) {
      int64_t n = text_chars[i];
      if (!ascii) {  // the byte length of text_chars[i] code points
        int64_t end = pos, seen = 0;
        for (; end < text_len; ++end) {
          if ((text[end] & 0xC0) != 0x80) {
            if (seen == n) break;
            ++seen;
          }
        }
        n = end - pos;
      }
      if (!fallback[i]) {
        const int32_t qi = text_query[i];
        if (qi != built) {
          q.build(tok, tok_off + query_tok[qi],
                  query_tok[qi + 1] - query_tok[qi]);
          built = qi;
        }
        if (!q.ok || (!ascii && has_gated(text + pos, n))) fallback[i] = 1;
      }
      if (!fallback[i]) {
        chars += text_chars[i] + 2 * mark_chars *
                     mark_text(q, text + pos, n, mark, mark_len, *buf, hits);
      }
      out_chars[i + 1] = chars;
      pos += n;
    }
  } catch (...) {
    delete buf;
    return nullptr;
  }
  *out = buf->data();
  *out_len = static_cast<int64_t>(buf->size());
  return buf;
}

void tr_highlight_free(void* handle) {
  delete static_cast<std::string*>(handle);
}

}  // extern "C"
