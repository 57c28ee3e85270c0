// libdgrep: the host hot loops of distributed_grep_tpu_torch.
//
// Plain C++ (no CUDA, no PyTorch headers), built on first use with g++ by
// ops/_build.py (build_host: -O3 -march=native -fPIC -Wall -Wextra -Werror
// -std=c++17 -shared -lpthread) into _build/, and bound with ctypes in
// utils/native.py, where each entry point also has its plain numpy or
// Python version.  The entry points and their callers in the package:
//
//   * fnv32a          FNV-32a partition hash (ihash % nReduce); the
//                     vectorized runtime/columnar.LineBatch.partitions and
//                     runtime/shuffle.partition_many fold the same hash.
//   * newline_index   '\n' offsets (ops/lines.newline_index).
//   * literal_scan    end offsets of every occurrence of one literal
//                     (apps/grep.literal_mode_lines: -w/-x on a literal).
//   * dfa_scan(_mt)   table-driven DFA walk emitting accept offsets
//                     (ops/host_match.dfa_lines_match: the regex path's
//                     host oracle).
//   * confirm_*       literal-set candidate confirm (ops/confirm_set.py).
//   * gather_ranges, line_spans, build_records, format_batch, utf8_valid,
//     unique_lines   the columnar record path (runtime/columnar.py,
//                     ops/lines.unique_match_lines).
//   * merge_display   the CLI's display merge of several mr-out files
//                     (runtime/job.JobResult.display_blocks_sorted).
//   * trigram_summary shard-index trigram bloom (no caller yet).

#include <cstdint>
#include <cstring>
#include <cstddef>
#include <thread>
#include <vector>

#if defined(__AVX2__)
#include <immintrin.h>
#endif

extern "C" {

// FNV-32a over `len` bytes, masked to non-negative int32 like the reference
// does (worker.go:13-17 masks with 0x7fffffff).
uint32_t dgrep_fnv32a(const uint8_t* data, size_t len) {
    uint32_t h = 2166136261u;
    for (size_t i = 0; i < len; ++i) {
        h ^= data[i];
        h *= 16777619u;
    }
    return h & 0x7fffffffu;
}

// Write byte offsets of every '\n' into out (capacity max_out).
// Returns the total number of newlines found (may exceed max_out; caller
// re-calls with a bigger buffer in that case).  SIMD path: on text-shaped
// corpora newlines land every few dozen bytes, so the memchr loop's
// per-hit call overhead dominates; the AVX2 block compare + movemask bit
// walk pays no call per hit.
size_t dgrep_newline_index(const uint8_t* data, size_t len,
                           uint64_t* out, size_t max_out) {
    size_t count = 0;
#if defined(__AVX2__)
    const __m256i nl_v = _mm256_set1_epi8('\n');
    size_t i = 0;
    for (; i + 32 <= len; i += 32) {
        __m256i block = _mm256_loadu_si256((const __m256i*)(data + i));
        uint32_t mask = (uint32_t)_mm256_movemask_epi8(
            _mm256_cmpeq_epi8(block, nl_v));
        while (mask) {
            unsigned b = (unsigned)__builtin_ctz(mask);
            mask &= mask - 1;
            if (count < max_out) out[count] = (uint64_t)(i + b);
            ++count;
        }
    }
    for (; i < len; ++i) {  // scalar tail
        if (data[i] == '\n') {
            if (count < max_out) out[count] = (uint64_t)i;
            ++count;
        }
    }
    return count;
#else
    const uint8_t* p = data;
    const uint8_t* end = data + len;
    while (p < end) {
        const uint8_t* nl = (const uint8_t*)memchr(p, '\n', (size_t)(end - p));
        if (!nl) break;
        if (count < max_out) out[count] = (uint64_t)(nl - data);
        ++count;
        p = nl + 1;
    }
    return count;
#endif
}

// Find end-offsets (offset of last byte + 1) of every occurrence of
// `needle` in `hay` (overlapping occurrences included, matching regex
// scan-all semantics). Returns total count; writes up to max_out offsets.
size_t dgrep_literal_scan(const uint8_t* hay, size_t hay_len,
                          const uint8_t* needle, size_t needle_len,
                          uint64_t* out, size_t max_out) {
    if (needle_len == 0 || needle_len > hay_len) return 0;
    size_t count = 0;
#if defined(__AVX2__)
    if (needle_len >= 2) {
        // SIMD first/last-byte filter (Mula's "SIMD-friendly substring
        // search"): candidate start positions are those where the needle's
        // first byte matches a 32-wide block AND its last byte matches the
        // block shifted by needle_len-1; only candidates run the memcmp.
        const __m256i first = _mm256_set1_epi8((char)needle[0]);
        const __m256i last = _mm256_set1_epi8((char)needle[needle_len - 1]);
        size_t i = 0;
        while (i + needle_len - 1 + 32 <= hay_len) {
            __m256i b0 = _mm256_loadu_si256((const __m256i*)(hay + i));
            __m256i b1 = _mm256_loadu_si256(
                (const __m256i*)(hay + i + needle_len - 1));
            uint32_t mask = (uint32_t)_mm256_movemask_epi8(_mm256_and_si256(
                _mm256_cmpeq_epi8(b0, first), _mm256_cmpeq_epi8(b1, last)));
            while (mask) {
                unsigned b = (unsigned)__builtin_ctz(mask);
                mask &= mask - 1;
                if (memcmp(hay + i + b + 1, needle + 1, needle_len - 2) == 0) {
                    if (count < max_out)
                        out[count] = (uint64_t)(i + b) + needle_len;
                    ++count;
                }
            }
            i += 32;
        }
        for (; i + needle_len <= hay_len; ++i) {  // scalar tail
            if (hay[i] == needle[0] &&
                memcmp(hay + i + 1, needle + 1, needle_len - 1) == 0) {
                if (count < max_out) out[count] = (uint64_t)i + needle_len;
                ++count;
            }
        }
        return count;
    }
#endif
    const uint8_t* p = hay;
    const uint8_t* end = hay + hay_len;
    while (p + needle_len <= end) {
        const uint8_t* hit =
            (const uint8_t*)memmem(p, (size_t)(end - p), needle, needle_len);
        if (!hit) break;
        if (count < max_out)
            out[count] = (uint64_t)(hit - hay) + needle_len;
        ++count;
        p = hit + 1;  // overlapping matches
    }
    return count;
}

// Table-driven DFA scan. `table` is row-major [n_states][256] uint16 next
// states; `accept` is a per-state 0/1 byte map. Starts in `start_state`,
// feeds every byte, records offset i+1 whenever the post-transition state is
// accepting. Returns total accept count (writes up to max_out offsets) and
// stores the final state in *final_state (for cross-chunk state carry).
size_t dgrep_dfa_scan(const uint8_t* data, size_t len,
                      const uint16_t* table, const uint8_t* accept,
                      uint32_t start_state,
                      uint64_t* out, size_t max_out,
                      uint32_t* final_state) {
    uint32_t s = start_state;
    size_t count = 0;
    for (size_t i = 0; i < len; ++i) {
        s = table[((size_t)s << 8) | data[i]];
        if (accept[s]) {
            if (count < max_out) out[count] = (uint64_t)i + 1;
            ++count;
        }
    }
    if (final_state) *final_state = s;
    return count;
}

// Multithreaded DFA scan.  Chunk boundaries snap to the byte AFTER a
// newline; because every state's '\n' transition is the start state (the
// newline-reset invariant all tables here share, models/dfa.py DfaTable),
// scanning each chunk from start_state produces byte-identical output to
// the sequential scan — the same property the device path's stripe layout
// exploits.  Offsets are written in ascending order; returns the total
// accept count (writes up to max_out).
size_t dgrep_dfa_scan_mt(const uint8_t* data, size_t len,
                         const uint16_t* table, const uint8_t* accept,
                         uint32_t start_state,
                         uint64_t* out, size_t max_out,
                         uint32_t n_threads) {
    if (n_threads < 2 || len < (size_t)n_threads * 4096) {
        uint32_t fin;
        return dgrep_dfa_scan(data, len, table, accept, start_state,
                              out, max_out, &fin);
    }
    std::vector<size_t> bounds;
    bounds.push_back(0);
    for (uint32_t t = 1; t < n_threads; ++t) {
        size_t want = len * t / n_threads;
        if (want <= bounds.back()) continue;
        const void* nl = memchr(data + want, '\n', len - want);
        size_t b = nl ? (size_t)((const uint8_t*)nl - data) + 1 : len;
        if (b > bounds.back() && b < len) bounds.push_back(b);
    }
    bounds.push_back(len);

    size_t parts = bounds.size() - 1;
    std::vector<std::vector<uint64_t>> hits(parts);
    std::vector<std::thread> threads;
    for (size_t p = 0; p < parts; ++p) {
        threads.emplace_back([&, p]() {
            size_t lo = bounds[p], hi = bounds[p + 1];
            uint32_t s = start_state;
            std::vector<uint64_t>& h = hits[p];
            for (size_t i = lo; i < hi; ++i) {
                s = table[((size_t)s << 8) | data[i]];
                if (accept[s]) h.push_back((uint64_t)i + 1);
            }
        });
    }
    for (auto& th : threads) th.join();

    size_t count = 0;
    for (size_t p = 0; p < parts; ++p) {
        for (uint64_t off : hits[p]) {
            if (count < max_out) out[count] = off;
            ++count;
        }
    }
    return count;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Literal-set candidate confirm: the host side of the FDR filter path
// (models/fdr.py, ops/confirm_set.py).  The device filter emits candidate END offsets (offset of
// last byte + 1); each candidate is confirmed by probing a hash table keyed
// on the last 4 bytes of the pattern and memcmp'ing the full literal.  This
// replaces re-scanning each candidate's whole line through the Aho-Corasick
// DFA (~120 ns/candidate) with a ~10 ns probe, which is what lets the FDR
// tuner trade filter passes for candidates (fewer device lookups per byte).
// ---------------------------------------------------------------------------

struct DgrepConfirmSlot {
    uint32_t key;   // last-4-byte key owning this slot (valid when head >= 0)
    int32_t head;   // first pattern idx sharing the key, or -1 for empty
};

struct DgrepConfirmSet {
    std::vector<uint8_t> pat_bytes;       // folded copy when ci
    std::vector<uint32_t> pat_off;        // n+1 prefix offsets into pat_bytes
    std::vector<DgrepConfirmSlot> slots;  // open addressing, linear probe;
                                          // one slot per distinct key, so a
                                          // non-candidate rejects on the
                                          // first (usually only) cacheline
    std::vector<int32_t> next;            // same-key pattern chain link
    std::vector<uint32_t> shorts;         // indices of patterns with len < 4
    std::vector<uint8_t> bloom;           // L1-resident bitmap over the key
                                          // hash's high 18 bits: rejects the
                                          // ~96% absent-key majority without
                                          // touching the (L2-sized) slots
    uint32_t mask = 0;                    // table size - 1 (power of two)
    bool has_fold = false;                // ignore_case: fold data bytes
    uint8_t fold[256];                    // identity, or ASCII tolower when ci
};

// 2^18-bit bloom = 32 KB: fits L1 alongside the streamed data; at 10k keys
// the bit density is ~4%, so an absent key (the common case by construction
// — the device filter's false candidates rarely have their exact 4-byte
// suffix in the set) is rejected by one predictable L1 load.
static constexpr uint32_t DGREP_BLOOM_BYTES = 1u << 15;
static inline uint32_t dgrep_bloom_bit(uint32_t h) { return h >> 14; }

static inline uint32_t dgrep_confirm_hash(uint32_t key) {
    key *= 2654435761u;  // Knuth multiplicative mix
    return key ^ (key >> 15);
}

extern "C" {

// Build a confirm set from concatenated pattern bytes + n+1 prefix offsets.
// Patterns must be pre-normalized (lowercased when ignore_case) by the
// caller — `ignore_case` here only controls folding of the *data* bytes.
void* dgrep_confirm_build(const uint8_t* pat_bytes, const uint32_t* pat_off,
                          uint32_t n, int ignore_case) {
    auto* cs = new DgrepConfirmSet();
    cs->has_fold = ignore_case != 0;
    cs->pat_bytes.assign(pat_bytes, pat_bytes + pat_off[n]);
    cs->pat_off.assign(pat_off, pat_off + n + 1);
    for (int i = 0; i < 256; ++i)
        cs->fold[i] = (uint8_t)((ignore_case && i >= 'A' && i <= 'Z')
                                    ? i - 'A' + 'a' : i);
    uint32_t bits = 2;
    while ((1u << bits) < 4 * n + 4) ++bits;  // load factor <= 0.25
    cs->mask = (1u << bits) - 1;
    cs->slots.assign((size_t)cs->mask + 1, DgrepConfirmSlot{0u, -1});
    cs->next.assign(n, -1);
    cs->bloom.assign(DGREP_BLOOM_BYTES, 0);
    for (uint32_t i = 0; i < n; ++i) {
        uint32_t len = pat_off[i + 1] - pat_off[i];
        if (len < 4) {
            cs->shorts.push_back(i);
            continue;
        }
        const uint8_t* tail = cs->pat_bytes.data() + pat_off[i + 1] - 4;
        uint32_t key;
        memcpy(&key, tail, 4);
        uint32_t hb = dgrep_bloom_bit(dgrep_confirm_hash(key));
        cs->bloom[hb >> 3] |= (uint8_t)(1u << (hb & 7));
        uint32_t s = dgrep_confirm_hash(key) & cs->mask;
        while (cs->slots[s].head >= 0 && cs->slots[s].key != key)
            s = (s + 1) & cs->mask;  // linear probe to the key's slot
        cs->next[i] = cs->slots[s].head;
        cs->slots[s] = DgrepConfirmSlot{key, (int32_t)i};
    }
    return cs;
}

void dgrep_confirm_free(void* handle) {
    delete (DgrepConfirmSet*)handle;
}

}  // extern "C"

// Confirm one candidate range.  A naive loop pays 4 fold loads and a probe
// into the L2-sized slots table with a poorly predicted occupancy branch
// per candidate; the loop below avoids most of that:
//
//   * no-fold specialization (one unaligned u32 load for the key),
//   * a 32 KB L1-resident bloom bitmap over the key hash rejects the
//     absent-key majority (~96% of device-filter false candidates) with
//     one predictable load — the slots table is only touched by survivors,
//   * a rolling prefetch keeps the streamed corpus ahead of the key loads
//     (candidates arrive sorted, so data access is near-sequential).
//
// The FDR tuner prices device filtering against this loop's cost per
// candidate (models/fdr.py CONFIRM_PS_PER_CANDIDATE).
template <bool FOLD, bool SHORTS>
static void dgrep_confirm_range_t(const DgrepConfirmSet* cs,
                                  const uint8_t* data, size_t len,
                                  const uint64_t* cand,
                                  size_t lo, size_t hi, uint8_t* out) {
    constexpr size_t P = 24;  // data prefetch distance (candidates)
    const uint8_t* f = cs->fold;
    const uint8_t* bloom = cs->bloom.data();
    for (size_t i = lo; i < hi; ++i) {
        if (i + P < hi) {
            uint64_t ep = cand[i + P];
            if (ep >= 4 && ep <= len) __builtin_prefetch(data + ep - 4, 0, 3);
        }
        uint64_t e = cand[i];
        bool hit = false;
        if (e <= len && e >= 4) {
            uint32_t key;
            if (FOLD) {
                uint8_t kb[4] = {f[data[e - 4]], f[data[e - 3]],
                                 f[data[e - 2]], f[data[e - 1]]};
                memcpy(&key, kb, 4);
            } else {
                memcpy(&key, data + e - 4, 4);
            }
            uint32_t h = dgrep_confirm_hash(key);
            uint32_t hb = dgrep_bloom_bit(h);
            if (bloom[hb >> 3] & (1u << (hb & 7))) {
                uint32_t s = h & cs->mask;
                while (cs->slots[s].head >= 0) {  // empty slot: key absent
                    if (cs->slots[s].key == key) {
                        for (int32_t pi = cs->slots[s].head; pi >= 0;
                             pi = cs->next[pi]) {
                            uint32_t plen =
                                cs->pat_off[pi + 1] - cs->pat_off[pi];
                            if (plen > e) continue;
                            const uint8_t* p =
                                cs->pat_bytes.data() + cs->pat_off[pi];
                            const uint8_t* d = data + e - plen;
                            uint32_t k = 0;
                            if (FOLD) {
                                for (; k < plen && p[k] == f[d[k]]; ++k) {}
                            } else {
                                for (; k < plen && p[k] == d[k]; ++k) {}
                            }
                            if (k == plen) { hit = true; break; }
                        }
                        break;
                    }
                    s = (s + 1) & cs->mask;
                }
            }
        }
        if (SHORTS && !hit && e > 0 && e <= len) {
            for (uint32_t si : cs->shorts) {
                uint32_t plen = cs->pat_off[si + 1] - cs->pat_off[si];
                if (plen > e) continue;
                const uint8_t* p = cs->pat_bytes.data() + cs->pat_off[si];
                const uint8_t* d = data + e - plen;
                uint32_t k = 0;
                for (; k < plen && (FOLD ? p[k] == f[d[k]] : p[k] == d[k]);
                     ++k) {}
                if (k == plen) { hit = true; break; }
            }
        }
        out[i] = hit ? 1 : 0;
    }
}

static void dgrep_confirm_range(const DgrepConfirmSet* cs, const uint8_t* data,
                                size_t len, const uint64_t* cand,
                                size_t lo, size_t hi, uint8_t* out,
                                bool fold, bool shorts) {
    auto fn = fold ? (shorts ? dgrep_confirm_range_t<true, true>
                             : dgrep_confirm_range_t<true, false>)
                   : (shorts ? dgrep_confirm_range_t<false, true>
                             : dgrep_confirm_range_t<false, false>);
    fn(cs, data, len, cand, lo, hi, out);
}

extern "C" {

// Confirm candidate end-offsets against the set; out[i] = 1 when some
// pattern truly ends at cand[i].  Threads split the candidate array.
void dgrep_confirm_scan(const void* handle, const uint8_t* data, size_t len,
                        const uint64_t* cand, size_t n_cand, uint8_t* out,
                        uint32_t n_threads) {
    const auto* cs = (const DgrepConfirmSet*)handle;
    bool fold = cs->has_fold, shorts = !cs->shorts.empty();
    if (n_threads < 2 || n_cand < 4096) {
        dgrep_confirm_range(cs, data, len, cand, 0, n_cand, out, fold, shorts);
        return;
    }
    std::vector<std::thread> threads;
    for (uint32_t t = 0; t < n_threads; ++t) {
        size_t lo = n_cand * t / n_threads, hi = n_cand * (t + 1) / n_threads;
        threads.emplace_back([=]() {
            dgrep_confirm_range(cs, data, len, cand, lo, hi, out, fold, shorts);
        });
    }
    for (auto& th : threads) th.join();
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Columnar merge/print hot loops.  The match-dense output path moves
// LineBatch slabs (runtime/columnar.py) around as bytes; three per-record
// Python/numpy passes become plain memcpy/merge loops here:
//
//   * gather_ranges   — concatenate arr[starts[i]:ends[i]] (the slab
//                       rebuild under LineBatch.select / make_batch /
//                       the display gather; numpy's cumsum-index gather
//                       moved ~10 bytes of index traffic per output byte).
//   * format_batch    — the mr-out text form "<prefix>N)<sep><line>\n"
//                       per record (LineBatch.format_lines_bytes).  Refuses
//                       non-UTF-8 slabs (-2): the Python path decodes
//                       utf-8/replace, so only strictly-valid slabs copy
//                       through byte-identically; the caller takes its
//                       Python leg.
//   * merge_display   — k-way merge of pre-sorted mr-out buffers into the
//                       final display bytes (tab -> space), ordered by
//                       (path, line) where paths compare as Python str —
//                       surrogateescape codepoints, NOT raw bytes (see
//                       se_cmp below; runtime/job._iter_records_bytes_sorted
//                       documents why byte order would misorder exotic
//                       filenames).  Refuses (-1) on any line that is not
//                       grep-key-shaped; the caller takes its record
//                       merge.
// ---------------------------------------------------------------------------

extern "C" {

// out must hold sum(ends[i] - starts[i]) bytes (the caller's cumsum).
void dgrep_gather_ranges(const uint8_t* data, const int64_t* starts,
                         const int64_t* ends, size_t n, uint8_t* out) {
    uint8_t* p = out;
    for (size_t i = 0; i < n; ++i) {
        int64_t len = ends[i] - starts[i];
        if (len <= 0) continue;
        memcpy(p, data + starts[i], (size_t)len);
        p += len;
    }
}

// Strict UTF-8 validation (RFC 3629: no overlongs, no surrogates, max
// U+10FFFF) — exactly the inputs Python's utf-8 decode accepts, i.e. the
// inputs for which decode('utf-8','replace') then encode('utf-8') is the
// identity.  Returns 1 when valid.
int dgrep_utf8_valid(const uint8_t* p, size_t len) {
    const uint8_t* end = p + len;
    while (p < end) {
        uint8_t b = *p;
        if (b < 0x80) { ++p; continue; }
        if (b >= 0xC2 && b <= 0xDF) {
            if (end - p < 2 || (p[1] & 0xC0) != 0x80) return 0;
            p += 2; continue;
        }
        if (b >= 0xE0 && b <= 0xEF) {
            if (end - p < 3 || (p[1] & 0xC0) != 0x80 ||
                (p[2] & 0xC0) != 0x80) return 0;
            if (b == 0xE0 && p[1] < 0xA0) return 0;        // overlong
            if (b == 0xED && p[1] > 0x9F) return 0;        // surrogate
            p += 3; continue;
        }
        if (b >= 0xF0 && b <= 0xF4) {
            if (end - p < 4 || (p[1] & 0xC0) != 0x80 ||
                (p[2] & 0xC0) != 0x80 || (p[3] & 0xC0) != 0x80) return 0;
            if (b == 0xF0 && p[1] < 0x90) return 0;        // overlong
            if (b == 0xF4 && p[1] > 0x8F) return 0;        // > U+10FFFF
            p += 4; continue;
        }
        return 0;  // lone continuation byte or 0xC0/0xC1/0xF5+
    }
    return 1;
}

// Write "<prefix><decimal lineno>)<sep><line>\n" per record — byte-for-byte
// LineBatch.format_lines_bytes_numpy (utf-8/
// surrogateescape), PROVIDED every LINE is strictly valid UTF-8 (checked
// per line range, NOT whole-slab: the Python path decodes per line, and
// two invalid line tails/heads can concatenate into valid slab bytes —
// whole-slab validity does not imply per-line identity.  The prefix
// needs no check — the Python path writes the filename's
// surrogateescape bytes verbatim either way).  Returns bytes written,
// -1 when out_cap is too small, -2 when some line needs Python's
// utf-8/replace semantics (the caller takes its Python leg).
int64_t dgrep_format_batch(const uint8_t* prefix, size_t prefix_len,
                           const int64_t* linenos, const int64_t* offsets,
                           const uint8_t* slab, size_t n, uint8_t sep,
                           uint8_t* out, size_t out_cap) {
    if (n == 0) return 0;
    for (size_t i = 0; i < n; ++i)
        if (!dgrep_utf8_valid(slab + offsets[i],
                              (size_t)(offsets[i + 1] - offsets[i])))
            return -2;
    uint8_t* p = out;
    uint8_t* cap = out + out_cap;
    char digits[24];
    for (size_t i = 0; i < n; ++i) {
        int nd = 0;
        uint64_t v = (uint64_t)linenos[i];
        do { digits[nd++] = (char)('0' + v % 10); v /= 10; } while (v);
        int64_t line_len = offsets[i + 1] - offsets[i];
        if (p + prefix_len + nd + 3 + line_len > cap) return -1;
        memcpy(p, prefix, prefix_len);
        p += prefix_len;
        while (nd) *p++ = (uint8_t)digits[--nd];
        *p++ = ')';
        *p++ = sep;
        memcpy(p, slab + offsets[i], (size_t)line_len);
        p += line_len;
        *p++ = '\n';
    }
    return (int64_t)(p - out);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Native map-record pipeline.  Everything between kernel output
// and the partitioned mr-out slabs used to be a chain of numpy passes
// (runtime/columnar.py: make_batch_from_lines -> partitions() ->
// per-partition select()/gather): line-span computation, an intermediate
// whole-batch slab gather, a vectorized-but-multi-pass FNV over the line
// numbers, then one more gather per partition.  The three entries below
// collapse that into ONE byte-touching pass:
//
//   * unique_lines   — sorted match end-offsets -> unique 1-based line
//                      numbers (linear merge against the newline index;
//                      replaces searchsorted + np.unique).
//   * line_spans     — [start, end) byte span per line from the newline
//                      index (the vectorized ops/lines.line_span; clip
//                      semantics mirror make_batch_from_lines exactly).
//   * build_records  — line spans in, per-reduce-partition LineBatch
//                      arrays out: FNV-32a of "<prefix><lineno>)" per
//                      record (bit-identical to fnv32a above — the
//                      reference ihash — as runtime/columnar.partitions
//                      already pins), stable partition grouping, and one
//                      memcpy per line straight into its partition's
//                      region of the output slab.
// ---------------------------------------------------------------------------

extern "C" {

// Unique 1-based line numbers containing sorted match END offsets (i+1
// convention: the match's last byte is at offset-1).  Equals
// np.unique(np.searchsorted(nl, ends - 1, 'right') + 1) for ascending
// `ends`; a linear merge because both arrays are sorted.  Returns the
// number of distinct lines written to out (capacity n suffices).
int64_t dgrep_unique_lines(const uint64_t* nl, int64_t n_nl,
                           const int64_t* ends, int64_t n,
                           int64_t* out) {
    int64_t count = 0;
    int64_t line = 0;  // index into nl: nl[line] is current line's '\n'
    int64_t last = 0;
    for (int64_t i = 0; i < n; ++i) {
        int64_t pos = ends[i] - 1;  // byte offset of the match's last byte
        while (line < n_nl && (int64_t)nl[line] <= pos) ++line;
        int64_t ln = line + 1;
        if (ln != last) {
            out[count++] = ln;
            last = ln;
        }
    }
    return count;
}

// [start, end) byte span per 1-based line number from the newline index
// (end excludes the '\n').  Mirrors the numpy clip semantics of
// runtime/columnar.make_batch_from_lines bit for bit, including its
// defensive clamping of out-of-range line numbers.
void dgrep_line_spans(const uint64_t* nl, int64_t n_nl,
                      const int64_t* linenos, int64_t n, int64_t n_bytes,
                      int64_t* starts, int64_t* ends) {
    if (n_nl == 0) {  // chunk with no newline: only line 1 exists
        for (int64_t i = 0; i < n; ++i) { starts[i] = 0; ends[i] = n_bytes; }
        return;
    }
    for (int64_t i = 0; i < n; ++i) {
        int64_t ln = linenos[i];
        int64_t a = ln - 2;
        if (a < 0) a = 0; else if (a >= n_nl) a = n_nl - 1;
        starts[i] = (ln == 1) ? 0 : (int64_t)nl[a] + 1;
        int64_t b = ln - 1;
        if (b < 0) b = 0; else if (b >= n_nl) b = n_nl - 1;
        ends[i] = (ln - 1 < n_nl) ? (int64_t)nl[b] : n_bytes;
    }
}

// One-pass partitioned record build.  Inputs: the source bytes, one
// [start, end) span + one STORED line number per record (spans come from
// dgrep_line_spans over local numbers, or from a built batch's offsets),
// and the pre-encoded key prefix "<filename> (line number #".  Outputs,
// grouped by partition in ascending partition order with the original
// record order preserved inside each partition (exactly what
// np.flatnonzero-based select() produced):
//
//   out_linenos [n]     stored line numbers, grouped
//   out_offsets [n+1]   GLOBAL slab offsets of the grouped records (each
//                       partition's own offsets array = the slice minus
//                       its byte base — contiguity makes that exact)
//   out_slab            gathered line bytes, grouped (caller sizes it as
//                       sum(end-start))
//   out_counts [n_reduce], out_bytes [n_reduce]  per-partition totals
//
// The per-record hash is FNV-32a over "<prefix><decimal lineno>)" —
// bit-identical to dgrep_fnv32a on the formatted key; partition =
// (h & 0x7fffffff) % n_reduce (reference ihash semantics).  Returns the
// total slab bytes written, or -1 on a malformed span (a caller's bug: the
// binding raises).
int64_t dgrep_build_records(const uint8_t* data, int64_t data_len,
                            const int64_t* starts, const int64_t* ends,
                            const int64_t* linenos, int64_t n,
                            const uint8_t* prefix, int64_t prefix_len,
                            int32_t n_reduce,
                            int64_t* out_linenos, int64_t* out_offsets,
                            uint8_t* out_slab,
                            int64_t* out_counts, int64_t* out_bytes) {
    if (n_reduce <= 0) return -1;
    uint32_t h0 = 2166136261u;
    for (int64_t i = 0; i < prefix_len; ++i) {
        h0 ^= prefix[i];
        h0 *= 16777619u;
    }
    for (int32_t p = 0; p < n_reduce; ++p) {
        out_counts[p] = 0;
        out_bytes[p] = 0;
    }
    std::vector<int32_t> part((size_t)n);
    for (int64_t i = 0; i < n; ++i) {
        int64_t s = starts[i], e = ends[i];
        if (s < 0 || e > data_len || e < s) return -1;
        char digits[24];
        int nd = 0;
        uint64_t v = (uint64_t)linenos[i];
        do { digits[nd++] = (char)('0' + v % 10); v /= 10; } while (v);
        uint32_t h = h0;
        while (nd) {  // decimal digits fold most-significant first
            h ^= (uint8_t)digits[--nd];
            h *= 16777619u;
        }
        h ^= (uint8_t)')';
        h *= 16777619u;
        int32_t p = (int32_t)((h & 0x7fffffffu) % (uint32_t)n_reduce);
        part[(size_t)i] = p;
        out_counts[p] += 1;
        out_bytes[p] += e - s;
    }
    std::vector<int64_t> rec_at((size_t)n_reduce), byte_at((size_t)n_reduce);
    int64_t rec_base = 0, byte_base = 0;
    for (int32_t p = 0; p < n_reduce; ++p) {
        rec_at[(size_t)p] = rec_base;
        byte_at[(size_t)p] = byte_base;
        rec_base += out_counts[p];
        byte_base += out_bytes[p];
    }
    for (int64_t i = 0; i < n; ++i) {
        int32_t p = part[(size_t)i];
        int64_t len = ends[i] - starts[i];
        int64_t ri = rec_at[(size_t)p]++;
        int64_t bi = byte_at[(size_t)p];
        byte_at[(size_t)p] += len;
        out_linenos[ri] = linenos[i];
        out_offsets[ri] = bi;
        if (len) memcpy(out_slab + bi, data + starts[i], (size_t)len);
    }
    out_offsets[n] = byte_base;
    return byte_base;
}

}  // extern "C"

// --- surrogateescape string comparison -------------------------------------
// Python's display merge orders records by the DECODED path
// (utf-8/surrogateescape -> str), compared by codepoint.  Codepoint order
// diverges from byte order exactly where a valid multi-byte sequence
// (codepoint < U+DC00) meets a surrogate-escaped raw byte (0xDC00 + b >=
// 0xDC80), so the native merge must decode to compare.

static inline int se_is_cont(uint8_t b) { return (b & 0xC0) == 0x80; }

// Decode ONE codepoint at p (strict UTF-8; any invalid byte becomes
// 0xDC00 + byte and advances 1, the surrogateescape handler's behavior).
static inline uint32_t se_next(const uint8_t* p, const uint8_t* end,
                               int* adv) {
    uint8_t b = p[0];
    if (b < 0x80) { *adv = 1; return b; }
    if (b >= 0xC2 && b <= 0xDF && end - p >= 2 && se_is_cont(p[1])) {
        *adv = 2;
        return ((uint32_t)(b & 0x1F) << 6) | (p[1] & 0x3F);
    }
    if (b >= 0xE0 && b <= 0xEF && end - p >= 3 && se_is_cont(p[1]) &&
        se_is_cont(p[2]) && !(b == 0xE0 && p[1] < 0xA0) &&
        !(b == 0xED && p[1] > 0x9F)) {
        *adv = 3;
        return ((uint32_t)(b & 0x0F) << 12) |
               ((uint32_t)(p[1] & 0x3F) << 6) | (p[2] & 0x3F);
    }
    if (b >= 0xF0 && b <= 0xF4 && end - p >= 4 && se_is_cont(p[1]) &&
        se_is_cont(p[2]) && se_is_cont(p[3]) &&
        !(b == 0xF0 && p[1] < 0x90) && !(b == 0xF4 && p[1] > 0x8F)) {
        *adv = 4;
        return ((uint32_t)(b & 0x07) << 18) |
               ((uint32_t)(p[1] & 0x3F) << 12) |
               ((uint32_t)(p[2] & 0x3F) << 6) | (p[3] & 0x3F);
    }
    *adv = 1;
    return 0xDC00u + b;
}

// Compare two byte strings as their surrogateescape-decoded str forms.
// Fast path: scan to the first differing byte; byte-equal strings are
// equal.  Everywhere else — including the full-common-prefix case, where
// "shorter sorts first" would be WRONG if the shorter string ends
// mid-sequence of the longer's valid UTF-8 codepoint (b"foo\xC3" decodes
// to U+DCC3 and sorts AFTER b"foo\xC3\xA9"'s U+00E9) — back up to a safe
// decode boundary in the common prefix (every non-continuation byte is a
// true boundary — valid sequences have continuation-only interiors and
// invalid bytes decode standalone; after skipping <= 3 continuation
// bytes, an adjacent lead byte is included so a codepoint straddling the
// divergence decodes whole) and compare decoded codepoints from there;
// the decode loop's exhaustion handling yields codepoint-prefix order.
static int se_cmp(const uint8_t* a, size_t alen,
                  const uint8_t* b, size_t blen) {
    size_t common = alen < blen ? alen : blen;
    size_t i = 0;
    while (i < common && a[i] == b[i]) ++i;
    if (i == common && alen == blen) return 0;
    size_t j = i;
    int k = 0;
    while (j > 0 && k < 3 && se_is_cont(a[j - 1])) { --j; ++k; }
    if (j > 0 && a[j - 1] >= 0xC0) --j;
    const uint8_t *pa = a + j, *pb = b + j;
    const uint8_t *ea = a + alen, *eb = b + blen;
    while (pa < ea && pb < eb) {
        int adva, advb;
        uint32_t ca = se_next(pa, ea, &adva);
        uint32_t cb = se_next(pb, eb, &advb);
        if (ca != cb) return ca < cb ? -1 : 1;
        pa += adva;
        pb += advb;
    }
    if (pa < ea) return 1;
    if (pb < eb) return -1;
    return 0;
}

// --- k-way display merge ---------------------------------------------------

struct DgrepMergeCursor {
    const uint8_t* pos;        // next unread byte of this buffer
    const uint8_t* end;
    const uint8_t* line;       // current record's line start
    size_t line_len;           // excluding '\n'
    const uint8_t* path;       // parsed key: path bytes
    size_t path_len;
    uint64_t lineno;
    size_t tab;                // offset of '\t' in line, or line_len
    int idx;                   // buffer index (merge tie-break, heapq order)
};

static const uint8_t DGREP_KEY_MARKER[] = " (line number #";
static const size_t DGREP_KEY_MARKER_LEN = sizeof(DGREP_KEY_MARKER) - 1;

// Advance to the cursor's next nonempty line and parse its grep key.
// Returns 1 on a record, 0 at end-of-buffer, -1 on a non-grep-shaped line.
static int dgrep_merge_advance(DgrepMergeCursor* c) {
    for (;;) {
        if (c->pos >= c->end) return 0;
        const uint8_t* nl = (const uint8_t*)memchr(
            c->pos, '\n', (size_t)(c->end - c->pos));
        const uint8_t* eol = nl ? nl : c->end;
        const uint8_t* line = c->pos;
        c->pos = nl ? nl + 1 : c->end;
        size_t len = (size_t)(eol - line);
        if (len == 0) continue;  // skip empty lines (the Python merge does)
        const uint8_t* tab = (const uint8_t*)memchr(line, '\t', len);
        size_t key_len = tab ? (size_t)(tab - line) : len;
        // key must end "...#<digits>)" with the marker before the digits
        if (key_len < DGREP_KEY_MARKER_LEN + 2 || line[key_len - 1] != ')')
            return -1;
        size_t d = key_len - 1;  // scan digits backwards
        while (d > 0 && line[d - 1] >= '0' && line[d - 1] <= '9') --d;
        if (d == key_len - 1 || d < DGREP_KEY_MARKER_LEN) return -1;
        if (memcmp(line + d - DGREP_KEY_MARKER_LEN, DGREP_KEY_MARKER,
                   DGREP_KEY_MARKER_LEN) != 0)
            return -1;
        if (key_len - 1 - d > 19) return -1;  // int64 overflow guard
        uint64_t v = 0;
        for (size_t q = d; q < key_len - 1; ++q) v = v * 10 + (line[q] - '0');
        c->line = line;
        c->line_len = len;
        c->path = line;
        c->path_len = d - DGREP_KEY_MARKER_LEN;
        c->lineno = v;
        c->tab = tab ? (size_t)(tab - line) : len;
        return 1;
    }
}

// (path, lineno, idx) ordering — paths by surrogateescape codepoints.
static int dgrep_merge_less(const DgrepMergeCursor* x,
                            const DgrepMergeCursor* y) {
    int c;
    if (x->path_len == y->path_len &&
        memcmp(x->path, y->path, x->path_len) == 0)
        c = 0;
    else
        c = se_cmp(x->path, x->path_len, y->path, y->path_len);
    if (c) return c < 0;
    if (x->lineno != y->lineno) return x->lineno < y->lineno;
    return x->idx < y->idx;
}

extern "C" {

// Merge n_bufs pre-sorted mr-out buffers (concatenated in `data`,
// boundaries in buf_off[n_bufs + 1]) into display bytes: each record's
// line with its first '\t' replaced by ' ', plus '\n', in (path, line)
// order.  out needs up to buf_off[n_bufs] + n_bufs bytes: a buffer
// whose final line lacks a terminating '\n' gains one on output.
// Returns the output length, or -1 when any line is not grep-shaped
// (the caller takes its record merge).
int64_t dgrep_merge_display(const uint8_t* data, const int64_t* buf_off,
                            int32_t n_bufs, uint8_t* out) {
    std::vector<DgrepMergeCursor> cur;
    cur.reserve((size_t)n_bufs);
    for (int32_t i = 0; i < n_bufs; ++i) {
        DgrepMergeCursor c;
        c.pos = data + buf_off[i];
        c.end = data + buf_off[i + 1];
        c.idx = i;
        int r = dgrep_merge_advance(&c);
        if (r < 0) return -1;
        if (r) cur.push_back(c);
    }
    uint8_t* p = out;
    while (!cur.empty()) {
        size_t best = 0;
        for (size_t i = 1; i < cur.size(); ++i)
            if (dgrep_merge_less(&cur[i], &cur[best])) best = i;
        DgrepMergeCursor* c = &cur[best];
        memcpy(p, c->line, c->line_len);
        if (c->tab < c->line_len) p[c->tab] = ' ';
        p += c->line_len;
        *p++ = '\n';
        int r = dgrep_merge_advance(c);
        if (r < 0) return -1;
        if (!r) cur.erase(cur.begin() + (ptrdiff_t)best);
    }
    return (int64_t)(p - out);
}

}  // extern "C"

// --------------------------------------------------------------------------
// Trigram shard summaries (the shard-index tier): one pass over a shard's
// bytes ORs its case-folded trigram presence bloom into `bloom`.  Two bits
// per trigram position: the 24-bit folded trigram code is mixed with one
// 64-bit Fibonacci multiply and the low/high 32-bit halves index the bit
// array (bloom_bytes MUST be a power of two — the Python wrapper enforces
// it).  The numpy version (utils/native.trigram_summary_numpy) computes
// the IDENTICAL bits, so persisted summaries are interchangeable between
// builds; a query's required literal is absent whenever any of its folded
// trigrams' bit pairs is missing ("cannot match" — never the reverse).

static inline uint32_t dgrep_tg_fold(uint8_t c) {
    return (c >= 'A' && c <= 'Z') ? (uint32_t)c + 32u : (uint32_t)c;
}

extern "C" {

void dgrep_trigram_summary(const uint8_t* data, size_t len,
                           uint8_t* bloom, size_t bloom_bytes) {
    if (len < 3 || bloom_bytes == 0) return;
    const uint64_t mask = (uint64_t)bloom_bytes * 8u - 1u;
    uint32_t a = dgrep_tg_fold(data[0]);
    uint32_t b = dgrep_tg_fold(data[1]);
    for (size_t i = 2; i < len; ++i) {
        uint32_t c = dgrep_tg_fold(data[i]);
        uint64_t v = ((uint64_t)a << 16) | ((uint64_t)b << 8) | (uint64_t)c;
        uint64_t h = v * 0x9E3779B97F4A7C15ull;
        uint64_t h1 = h & mask;
        uint64_t h2 = (h >> 32) & mask;
        bloom[h1 >> 3] = (uint8_t)(bloom[h1 >> 3] | (1u << (h1 & 7u)));
        bloom[h2 >> 3] = (uint8_t)(bloom[h2 >> 3] | (1u << (h2 & 7u)));
        a = b;
        b = c;
    }
}

}  // extern "C"
