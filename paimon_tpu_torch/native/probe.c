/* Batched SST point-probe: bloom filter + binary search over the flat
 * sorted key buffer, one call per (bucket, sorted-run) file.
 *
 * The Python side (lookup/sst.py SstReader) lays the per-file state
 * out once at SST build time as contiguous buffers — the packed
 * normalized keys (fixed width, byte-lexicographic order) and the
 * bloom filter words — and resolves a whole /lookup batch with one
 * call here instead of a per-key Python walk.  ctypes releases the
 * GIL for the duration of the call, so probes from concurrent serving
 * threads overlap.
 *
 * The bloom probe replicates index/bloom.py exactly: h1 is the
 * precomputed key hash, h2 = splitmix64(h1), probe i tests bit
 * (h1 + i*h2) mod num_bits.  Keeping the hash fold itself in numpy
 * (vectorized, shared with the build side) means C and Python can
 * never disagree on the sequence.
 */

#include <stdint.h>
#include <string.h>

static inline uint64_t splitmix64(uint64_t x) {
    x += 0x9E3779B97F4A7C15ULL;
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
    x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
    return x ^ (x >> 31);
}

static int64_t lower_bound(const uint8_t *keys, int64_t n, int64_t w,
                           const uint8_t *q) {
    int64_t lo = 0, hi = n;
    while (lo < hi) {
        int64_t mid = lo + ((hi - lo) >> 1);
        if (memcmp(keys + (size_t)mid * (size_t)w, q, (size_t)w) < 0)
            lo = mid + 1;
        else
            hi = mid;
    }
    return lo;
}

static int64_t upper_bound(const uint8_t *keys, int64_t n, int64_t w,
                           const uint8_t *q) {
    int64_t lo = 0, hi = n;
    while (lo < hi) {
        int64_t mid = lo + ((hi - lo) >> 1);
        if (memcmp(keys + (size_t)mid * (size_t)w, q, (size_t)w) <= 0)
            lo = mid + 1;
        else
            hi = mid;
    }
    return lo;
}

/* keys:       n_rows * key_width bytes, ascending byte-lexicographic
 * bloom_bits: bloom filter words (bloom_words may be 0: no filter)
 * qkeys:      m * key_width query bytes
 * qhashes:    m precomputed uint64 key hashes (bloom h1)
 * out_lo/hi:  per query the matching row range [lo, hi); lo == hi == -1
 *             marks a bloom rejection (never searched)
 * returns 0 on success, nonzero on invalid arguments. */
int sst_probe_batch(const uint8_t *keys, int64_t n_rows,
                    int64_t key_width, const uint64_t *bloom_bits,
                    int64_t bloom_words, int64_t bloom_k,
                    const uint8_t *qkeys, const uint64_t *qhashes,
                    int64_t m, int64_t *out_lo, int64_t *out_hi) {
    if (n_rows < 0 || key_width <= 0 || m < 0 || bloom_words < 0)
        return 1;
    uint64_t num_bits = (uint64_t)bloom_words * 64u;
    for (int64_t j = 0; j < m; j++) {
        if (bloom_words > 0) {
            uint64_t h1 = qhashes[j];
            uint64_t h2 = splitmix64(h1);
            int maybe = 1;
            for (int64_t i = 0; i < bloom_k; i++) {
                uint64_t pos = (h1 + (uint64_t)i * h2) % num_bits;
                if (!((bloom_bits[pos >> 6] >> (pos & 63u)) & 1u)) {
                    maybe = 0;
                    break;
                }
            }
            if (!maybe) {
                out_lo[j] = -1;
                out_hi[j] = -1;
                continue;
            }
        }
        const uint8_t *q = qkeys + (size_t)j * (size_t)key_width;
        int64_t lo = lower_bound(keys, n_rows, key_width, q);
        int64_t hi = lo;
        if (lo < n_rows &&
            memcmp(keys + (size_t)lo * (size_t)key_width, q,
                   (size_t)key_width) == 0)
            hi = upper_bound(keys, n_rows, key_width, q);
        out_lo[j] = lo;
        out_hi[j] = hi;
    }
    return 0;
}
