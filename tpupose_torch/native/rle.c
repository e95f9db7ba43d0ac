/* COCO run-length-encoded mask codec.
 *
 * The port's copy of the JAX package's native/rle.c (same code): a native
 * replacement for the pycocotools `mask` C extension, used by dataset
 * preparation to build miss-masks from crowd/unannotated person
 * segmentations (SURVEY.md C18/C19).
 *
 * COCO conventions implemented:
 *   - masks are column-major (Fortran order) h x w uint8;
 *   - RLE counts alternate runs of 0s and 1s, starting with 0s;
 *   - the compressed string format is the LEB128-style variant with
 *     delta-encoding of every count from the count two places back.
 *
 * Exposed as a plain C shared library consumed via ctypes
 * (tpupose_torch/data/rle.py); no CPython API dependency.
 */

#include <stddef.h>
#include <stdint.h>

/* Decode counts -> column-major binary mask. Returns 0 on success. */
int rle_decode(const uint32_t *counts, int m, int h, int w, uint8_t *out) {
    long total = (long)h * w;
    long pos = 0;
    uint8_t v = 0;
    for (int i = 0; i < m; i++) {
        long run = counts[i];
        if (pos + run > total) return 1;
        for (long j = 0; j < run; j++) out[pos++] = v;
        v = 1 - v;
    }
    return pos == total ? 0 : 1;
}

/* Encode column-major binary mask -> counts. Returns m (number of runs).
 * counts_out must have room for h*w+1 entries. */
int rle_encode(const uint8_t *mask, int h, int w, uint32_t *counts_out) {
    long total = (long)h * w;
    int m = 0;
    uint8_t v = 0;
    uint32_t run = 0;
    for (long i = 0; i < total; i++) {
        uint8_t cur = mask[i] ? 1 : 0;
        if (cur != v) {
            counts_out[m++] = run;
            run = 0;
            v = cur;
        }
        run++;
    }
    counts_out[m++] = run;
    return m;
}

/* COCO compressed string -> counts. Returns m, or -1 on malformed input.
 * counts_out must have room for strlen(s) entries (upper bound). */
int rle_from_string(const char *s, int n, uint32_t *counts_out) {
    int m = 0;
    int i = 0;
    while (i < n) {
        long x = 0;
        int k = 0;
        int more = 1;
        while (more) {
            if (i >= n) return -1;
            int c = s[i] - 48;
            x |= ((long)(c & 0x1f)) << (5 * k);
            more = c & 0x20;
            i++;
            k++;
            if (!more && (c & 0x10)) x |= (-1L) << (5 * k);
        }
        if (m > 2) x += (long)counts_out[m - 2];
        counts_out[m++] = (uint32_t)x;
    }
    return m;
}

/* counts -> COCO compressed string. Returns output length.
 * s_out must have room for m*7 bytes. */
int rle_to_string(const uint32_t *counts, int m, char *s_out) {
    int p = 0;
    for (int i = 0; i < m; i++) {
        long x = (long)counts[i];
        if (i > 2) x -= (long)counts[i - 2];
        int more = 1;
        while (more) {
            int c = x & 0x1f;
            x >>= 5;
            more = (c & 0x10) ? (x != -1) : (x != 0);
            if (more) c |= 0x20;
            c += 48;
            s_out[p++] = (char)c;
        }
    }
    return p;
}

/* Union-merge n masks (already decoded) into out; all h*w column-major. */
void mask_union(const uint8_t *masks, int n, long hw, uint8_t *out) {
    for (long i = 0; i < hw; i++) out[i] = 0;
    for (int k = 0; k < n; k++) {
        const uint8_t *mk = masks + (long)k * hw;
        for (long i = 0; i < hw; i++) out[i] |= mk[i] ? 1 : 0;
    }
}

/* Run-length area without decoding. */
long rle_area(const uint32_t *counts, int m) {
    long a = 0;
    for (int i = 1; i < m; i += 2) a += counts[i];
    return a;
}
