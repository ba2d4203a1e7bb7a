// Native host-side kernels of duckdb_faiss_ext_tpu_torch (a copy of
// duckdb_faiss_ext_tpu/native/bitmapper.cpp).
//
// dfx_build_bitmap: dense selection-bitmap construction — the equivalent of
// the reference's ProcessSelectionvector hot loop
// (src/faiss_extension.cpp:729-804): a sequential-id fast path that packs 8
// flags per byte per iteration, and a scatter fallback for arbitrary ids.
// LSB-first bit order within each byte, matching faiss::IDSelectorBitmap.
//
// dfx_merge_topk: S-way merge of per-shard sorted top-k lists into a global
// top-k per query — the host-side final merge of the multi-process search
// search (parallel/multihost.py) once the ranks' k-lists have been gathered.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 (see native/__init__.py).

#include <cstdint>
#include <cstring>

extern "C" {

void dfx_build_bitmap(const uint8_t* flags, const int64_t* ids, int64_t n,
                      uint8_t* bitmap, int64_t nbytes) {
    (void)nbytes;
    int64_t i = 0;
    // Fast path: runs of 8 consecutive ids starting at a byte boundary are
    // packed in one shot (the reference's aligned 8-lane loop, :789-796).
    while (i + 8 <= n) {
        int64_t id0 = ids[i];
        if ((id0 & 7) == 0) {
            bool seq = true;
            for (int j = 1; j < 8; j++) {
                if (ids[i + j] != id0 + j) { seq = false; break; }
            }
            if (seq) {
                uint8_t b = 0;
                for (int j = 0; j < 8; j++) {
                    b |= (uint8_t)((flags[i + j] != 0) ? 1u : 0u) << j;
                }
                bitmap[id0 >> 3] = b;
                i += 8;
                continue;
            }
        }
        // Scatter fallback for this element (:770-778).
        if (flags[i] != 0) {
            int64_t id = ids[i];
            bitmap[id >> 3] |= (uint8_t)(1u << (id & 7));
        }
        i++;
    }
    for (; i < n; i++) {
        if (flags[i] != 0) {
            int64_t id = ids[i];
            bitmap[id >> 3] |= (uint8_t)(1u << (id & 7));
        }
    }
}

// Merge S sorted (best-first) top-k lists per query into one sorted top-k.
// dists/labels laid out as (S, nq, k); outputs (nq, k).  Missing slots carry
// label -1 and sentinel distances; they sort last naturally because shards
// emit them after real hits.
void dfx_merge_topk(const float* dists, const int64_t* labels, int64_t s,
                    int64_t nq, int64_t k, int32_t descending,
                    float* out_d, int64_t* out_l) {
    // Per-query S-way merge with a linear scan over shard heads; S is small
    // (number of shards), so this beats a heap in practice.
    constexpr int64_t kMaxShards = 4096;
    int64_t heads[kMaxShards];
    for (int64_t q = 0; q < nq; q++) {
        for (int64_t j = 0; j < s; j++) heads[j] = 0;
        for (int64_t r = 0; r < k; r++) {
            int64_t best_s = -1;
            float best_v = 0.f;
            for (int64_t j = 0; j < s; j++) {
                if (heads[j] >= k) continue;
                const int64_t idx = (j * nq + q) * k + heads[j];
                if (labels[idx] < 0) continue;  // exhausted shard
                const float v = dists[idx];
                const bool better = best_s < 0 ||
                    (descending ? (v > best_v) : (v < best_v));
                if (better) { best_s = j; best_v = v; }
            }
            if (best_s < 0) {
                out_d[q * k + r] = descending
                    ? -__builtin_inff() : __builtin_inff();
                out_l[q * k + r] = -1;
            } else {
                const int64_t idx = (best_s * nq + q) * k + heads[best_s];
                out_d[q * k + r] = dists[idx];
                out_l[q * k + r] = labels[idx];
                heads[best_s]++;
            }
        }
    }
}

}  // extern "C"
