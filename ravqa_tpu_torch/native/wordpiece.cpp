// Fast WordPiece tokenizer — C library (ctypes interface).
//
// The native half of ravqa_tpu_torch.tokenization (a copy of
// ravqa_tpu/native/wordpiece.cpp): host-side tokenization is on the
// serving hot path. Algorithm is byte-identical with the Python reference
// implementation for ASCII text (lowercase, punctuation/whitespace split,
// greedy longest-match-first with "##" continuations); non-ASCII strings
// are routed to the Python path by the wrapper.
//
// Build: ravqa_tpu_torch/native/__init__.py (c++ -O2 -shared -fPIC, into
// ravqa_tpu_torch/_build/native/ at first use).

#include <cstdint>
#include <cstring>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>
#include <fstream>
#include <mutex>

namespace {

struct Vocab {
    std::unordered_map<std::string, int32_t> map;
    int32_t unk_id = 100;
    int max_chars_per_word = 100;
};

std::vector<Vocab*> g_vocabs;
std::mutex g_mutex;

inline bool is_ws(unsigned char c) {
    return c == ' ' || c == '\t' || c == '\n' || c == '\r';
}

inline bool is_punct(unsigned char c) {
    return (c >= 33 && c <= 47) || (c >= 58 && c <= 64) ||
           (c >= 91 && c <= 96) || (c >= 123 && c <= 126);
}

// DEL (0x7F) is Unicode category Cc like the other controls — the Python
// reference drops it inside words; keeping it would silently break the
// byte-parity contract (no -1 fallback fires for pure-ASCII rows)
inline bool is_control(unsigned char c) {
    return (c < 32 && !is_ws(c)) || c == 0x7F;
}

// CJK ideograph ranges (matches tokenization/wordpiece.py _is_cjk) —
// each ideograph is isolated as its own word before wordpiece lookup.
inline bool is_cjk_cp(uint32_t cp) {
    return (cp >= 0x4E00 && cp <= 0x9FFF) || (cp >= 0x3400 && cp <= 0x4DBF)
        || (cp >= 0x20000 && cp <= 0x2A6DF)
        || (cp >= 0x2A700 && cp <= 0x2B73F)
        || (cp >= 0x2B740 && cp <= 0x2B81F)
        || (cp >= 0x2B820 && cp <= 0x2CEAF)
        || (cp >= 0xF900 && cp <= 0xFAFF)
        || (cp >= 0x2F800 && cp <= 0x2FA1F);
}

// Common CJK/fullwidth punctuation we can isolate without Unicode
// category tables (each is category P* in the Python reference).
inline bool is_cjk_punct_cp(uint32_t cp) {
    switch (cp) {
        case 0x3001: case 0x3002: case 0x300A: case 0x300B:
        case 0x300C: case 0x300D: case 0x3010: case 0x3011:
        case 0xFF01: case 0xFF08: case 0xFF09: case 0xFF0C:
        case 0xFF1A: case 0xFF1B: case 0xFF1F:
            return true;
        default:
            return false;
    }
}

// greedy longest-match-first wordpiece of one lowercase word
void wordpiece(const Vocab& v, const std::string& word,
               std::vector<int32_t>& out) {
    if ((int)word.size() > v.max_chars_per_word) {
        out.push_back(v.unk_id);
        return;
    }
    size_t start = 0;
    size_t begin_out = out.size();
    std::string sub;
    while (start < word.size()) {
        size_t end = word.size();
        int32_t cur = -1;
        size_t cur_end = 0;
        while (start < end) {
            sub.clear();
            if (start > 0) sub = "##";
            sub.append(word, start, end - start);
            auto it = v.map.find(sub);
            if (it != v.map.end()) {
                cur = it->second;
                cur_end = end;
                break;
            }
            --end;
        }
        if (cur < 0) {
            out.resize(begin_out);
            out.push_back(v.unk_id);
            return;
        }
        out.push_back(cur);
        start = cur_end;
    }
}

}  // namespace

extern "C" {

// Load a vocab.txt; returns a handle (>=0) or -1 on failure.
int32_t wp_load_vocab(const char* path, int32_t unk_id) {
    auto* v = new Vocab();
    v->unk_id = unk_id;
    std::ifstream f(path);
    if (!f.good()) {
        delete v;
        return -1;
    }
    std::string line;
    int32_t idx = 0;
    while (std::getline(f, line)) {
        if (!line.empty() && line.back() == '\r') line.pop_back();
        if (!line.empty()) v->map.emplace(line, idx);
        ++idx;
    }
    std::lock_guard<std::mutex> lock(g_mutex);
    g_vocabs.push_back(v);
    return (int32_t)g_vocabs.size() - 1;
}

// Encode one UTF-8 text: basic tokenize (ASCII lowercase, punctuation
// split, CJK ideograph isolation) + wordpiece. Writes up to maxlen ids
// into out; returns the number written, or -1 when the text contains a
// non-ASCII codepoint outside the handled CJK set (accents, Unicode
// whitespace/punctuation needing category tables) — the Python wrapper
// re-encodes those rows with the reference implementation.
int32_t wp_encode(int32_t handle, const char* text, int32_t* out,
                  int32_t maxlen) {
    const Vocab& v = *g_vocabs[(size_t)handle];
    std::vector<int32_t> ids;
    std::string word;
    size_t n = strlen(text);
    auto flush = [&]() {
        if (!word.empty()) {
            wordpiece(v, word, ids);
            word.clear();
        }
    };
    size_t i = 0;
    while (i < n) {
        unsigned char c = (unsigned char)text[i];
        if (c < 0x80) {                                  // ASCII fast path
            ++i;
            if (c == 0 || is_control(c)) continue;
            if (is_ws(c)) {
                flush();
            } else if (is_punct(c)) {
                flush();
                std::string p(1, (char)c);
                wordpiece(v, p, ids);
            } else {
                if (c >= 'A' && c <= 'Z') c = (unsigned char)(c - 'A' + 'a');
                word.push_back((char)c);
            }
            continue;
        }
        // decode one UTF-8 sequence
        uint32_t cp = 0;
        size_t len = 0;
        if ((c & 0xE0) == 0xC0) { cp = c & 0x1F; len = 2; }
        else if ((c & 0xF0) == 0xE0) { cp = c & 0x0F; len = 3; }
        else if ((c & 0xF8) == 0xF0) { cp = c & 0x07; len = 4; }
        else return -1;                                  // malformed
        if (i + len > n) return -1;
        for (size_t j = 1; j < len; ++j) {
            unsigned char cc = (unsigned char)text[i + j];
            if ((cc & 0xC0) != 0x80) return -1;
            cp = (cp << 6) | (cc & 0x3F);
        }
        if (cp == 0x3000) {                              // ideographic space
            flush();
        } else if (is_cjk_cp(cp) || is_cjk_punct_cp(cp)) {
            flush();
            wordpiece(v, std::string(text + i, len), ids);
        } else {
            return -1;                                   // needs Python path
        }
        i += len;
    }
    flush();
    int32_t m = (int32_t)ids.size();
    if (m > maxlen) m = maxlen;
    memcpy(out, ids.data(), (size_t)m * sizeof(int32_t));
    return m;
}

// Batch encode: texts are NUL-separated in one buffer; offsets[i] is the
// start of text i. out is (n, maxlen) int32 (caller-zeroed); lens out (n,).
// Parallel over contiguous row ranges with disjoint output slices (the
// same safety-by-construction pattern as the reference's pthread kernels,
// segmented_maxsim.cpp:22-47); corpus-scale tokenization (1M passages for
// an index build) scales with host cores, small batches stay serial.
void wp_encode_batch(int32_t handle, const char* buf, const int64_t* offsets,
                     int32_t n, int32_t maxlen, int32_t* out,
                     int32_t* lens) {
    auto run = [=](int32_t lo, int32_t hi) {
        for (int32_t i = lo; i < hi; ++i) {
            lens[i] = wp_encode(handle, buf + offsets[i],
                                out + (int64_t)i * maxlen, maxlen);
        }
    };
    int32_t nthreads = (int32_t)std::thread::hardware_concurrency();
    int32_t max_useful = n / 256 + 1;   // >=256 rows per worker
    if (nthreads > max_useful) nthreads = max_useful;
    if (nthreads <= 1) {
        run(0, n);
        return;
    }
    std::vector<std::thread> workers;
    int32_t chunk = (n + nthreads - 1) / nthreads;
    for (int32_t t = 0; t < nthreads; ++t) {
        int32_t lo = t * chunk;
        int32_t hi = lo + chunk < n ? lo + chunk : n;
        if (lo >= hi) break;
        workers.emplace_back(run, lo, hi);
    }
    for (auto& w : workers) w.join();
}

}  // extern "C"
