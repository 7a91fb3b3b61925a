// m-sequence taps verification — tools/mseq_calculator.c territory.
//
// Same criterion as the reference (tools/mseq_calculator.c:31-38 and
// amaranth_twstft/common.py:44-51): walk the LFSR 2^bitlen - 2 steps; the
// taps are maximal iff the state never revisits the seed nor hits zero.
// C++ walks a 22-bit sequence (4M steps) in milliseconds where the Python
// oracle takes seconds — this is the batch search engine behind
// ops/lfsr.find_mseq_taps for production code lengths.

#include <cstdint>

extern "C" {

// 1 if maximal-length, 0 if not.
int twstft_is_mseq(int bit_len, uint64_t taps, uint64_t seed) {
    const uint64_t period = (1ull << bit_len) - 1ull;
    uint64_t s = seed;
    for (uint64_t i = 0; i + 1 < period; ++i) {
        uint64_t bit = __builtin_parityll(s & taps);
        s = (s >> 1) | (bit << (bit_len - 1));
        if (s == seed || s == 0)
            return 0;
    }
    return 1;
}

// Fill out[] with the first `limit` odd maximal tap masks; returns count.
int twstft_find_mseq(int bit_len, uint64_t *out, int limit) {
    int found = 0;
    for (uint64_t taps = 1; taps < (1ull << bit_len); taps += 2) {
        if (twstft_is_mseq(bit_len, taps, 1)) {
            out[found++] = taps;
            if (found >= limit)
                break;
        }
    }
    return found;
}

// First n chips (0/1 bytes) of the PRN stream — the write_prn_seq payload
// (amaranth_twstft/common.py:59-73).
void twstft_prn_chips(int bit_len, uint64_t taps, uint64_t seed, int64_t n,
                      uint8_t *out) {
    uint64_t s = seed;
    for (int64_t i = 0; i < n; ++i) {
        out[i] = (uint8_t)(s & 1ull);
        uint64_t bit = __builtin_parityll(s & taps);
        s = (s >> 1) | (bit << (bit_len - 1));
    }
}

} // extern "C"
