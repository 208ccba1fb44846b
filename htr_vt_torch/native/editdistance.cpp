// Batch Levenshtein distance over uint32 symbol sequences.
//
// Native replacement for the reference's `editdistance` pip dependency
// (C++ module used at valid.py:50,63 for CER/WER). Works on unicode
// codepoints for CER and on word-id sequences for WER — the Python side maps
// words to ids so one kernel serves both.
//
// Build: g++ -O3 -march=native -shared -fPIC editdistance.cpp -o libhtrvt_native.so

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" {

// Single-pair Levenshtein with the classic two-row DP.
int64_t htrvt_levenshtein_u32(const uint32_t* a, int64_t la,
                              const uint32_t* b, int64_t lb) {
    if (la == 0) return lb;
    if (lb == 0) return la;
    // Iterate over the shorter sequence in the inner loop for cache locality.
    if (lb > la) { std::swap(a, b); std::swap(la, lb); }
    std::vector<int64_t> prev(lb + 1), cur(lb + 1);
    for (int64_t j = 0; j <= lb; ++j) prev[j] = j;
    for (int64_t i = 1; i <= la; ++i) {
        cur[0] = i;
        const uint32_t ai = a[i - 1];
        for (int64_t j = 1; j <= lb; ++j) {
            const int64_t sub = prev[j - 1] + (ai != b[j - 1]);
            cur[j] = std::min({prev[j] + 1, cur[j - 1] + 1, sub});
        }
        std::swap(prev, cur);
    }
    return prev[lb];
}

// Batch API over flattened sequences: seqs `data` with per-item offsets.
// out[i] = levenshtein(pred_i, ref_i).
void htrvt_levenshtein_batch_u32(
    const uint32_t* pred_data, const int64_t* pred_offsets,
    const uint32_t* ref_data, const int64_t* ref_offsets,
    int64_t n, int64_t* out) {
    for (int64_t i = 0; i < n; ++i) {
        out[i] = htrvt_levenshtein_u32(
            pred_data + pred_offsets[i], pred_offsets[i + 1] - pred_offsets[i],
            ref_data + ref_offsets[i], ref_offsets[i + 1] - ref_offsets[i]);
    }
}

}  // extern "C"
