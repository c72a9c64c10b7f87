/* Baseline JPEG entropy decoding on the host (data/jpeg.py).
 *
 * `jpeg_decode_scan` decodes the Huffman-coded data of one scan (ITU T.81
 * Annex F.2, sequential DCT, 8-bit) into quantised DCT coefficients, int16
 * in natural (row-major) order, 64 a block. All components share one
 * coefficient buffer of `capacity` blocks; component c of the scan owns the
 * `bw[c]` x `bh[c]` blocks from block `off[c]` on. An interleaved scan
 * (ns > 1) walks `mcus_x` x `mcus_y` MCUs of h[c] x v[c] blocks per
 * component; a scan of one component walks its blocks one at a time over
 * `mcus_x` x `mcus_y` blocks. A restart interval of `restart` MCUs resets
 * the DC predictions at each RSTn marker, which must follow in order.
 *
 * The tables are the 4 DC then the 4 AC slots of the file: `bits` 8 x 16
 * code counts by length, `vals` 8 x 256 symbols, `present` 8 flags.
 *
 * Every read of the stream is checked against `len`, and every write
 * against the coefficient buffer: corrupt or truncated data returns a
 * negative code (JPEG_E_*) and never reads or writes out of bounds; it
 * returns 0 on success. (The Python side finds where each scan's data
 * starts and ends from its markers.)
 *
 * Built at first use with the host C compiler into a shared library and
 * called through ctypes; `jpeg.decode_scan_plain` is its plain version.
 */
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#define JPEG_E_CODE (-1)      /* no Huffman code of 16 bits or fewer matches */
#define JPEG_E_DATA (-2)      /* the scan's data ended (truncated, or a marker) */
#define JPEG_E_COEF (-3)      /* a coefficient index past 63 */
#define JPEG_E_RESTART (-4)   /* the expected RSTn marker is missing */
#define JPEG_E_ARGS (-5)      /* a block outside the buffer, or bad geometry */
#define JPEG_E_TABLE (-6)     /* a missing or malformed Huffman table */

#define LOOKAHEAD 9

typedef struct {
    int32_t maxcode[18];  /* largest code of each length, -1 if none; [17] sentinel */
    int32_t valoff[17];   /* symbol index minus the first code of each length */
    uint8_t vals[256];
    int total;            /* symbols in the table */
    uint8_t look_len[1 << LOOKAHEAD];  /* 0: code longer than LOOKAHEAD */
    uint8_t look_sym[1 << LOOKAHEAD];
} huff_t;

typedef struct {
    const uint8_t *d;
    size_t len, pos;
    uint64_t buf;  /* the low `nbits` bits, oldest first */
    int nbits;
    int nvirt;     /* zero bits appended past the end of the data (never consumed) */
    int ended;     /* a marker or the end of the data was reached */
} reader_t;

static int build_table(huff_t *t, const uint8_t *bits, const uint8_t *vals) {
    int total = 0;
    for (int l = 0; l < 16; l++) total += bits[l];
    if (total > 256) return JPEG_E_TABLE;
    t->total = total;
    memset(t->vals, 0, sizeof t->vals);
    memcpy(t->vals, vals, (size_t)total);
    memset(t->look_len, 0, sizeof t->look_len);
    int32_t code = 0;
    int k = 0;
    for (int l = 1; l <= 16; l++) {
        const int n = bits[l - 1];
        if (n) {
            t->valoff[l] = k - code;
            for (int i = 0; i < n; i++, k++, code++) {
                if (code >= (1 << l)) return JPEG_E_TABLE;
                if (l <= LOOKAHEAD) {
                    const int shift = LOOKAHEAD - l;
                    for (int j = 0; j < (1 << shift); j++) {
                        t->look_len[(code << shift) | j] = (uint8_t)l;
                        t->look_sym[(code << shift) | j] = t->vals[k];
                    }
                }
            }
            t->maxcode[l] = code - 1;
        } else {
            t->maxcode[l] = -1;
            t->valoff[l] = 0;
        }
        /* as libjpeg: the all-ones code of each length stays unused */
        if (code >= (1 << l)) return JPEG_E_TABLE;
        code <<= 1;
    }
    t->maxcode[17] = 0x7fffffff;
    return 0;
}

static void fill(reader_t *r) {
    while (r->nbits <= 56) {
        uint32_t b = 0;
        if (!r->ended) {
            for (;;) {
                if (r->pos >= r->len) {
                    r->ended = 1;
                    break;
                }
                b = r->d[r->pos];
                if (b != 0xFF) {
                    r->pos++;
                    break;
                }
                if (r->pos + 1 >= r->len) {
                    r->ended = 1;
                    break;
                }
                const uint8_t next = r->d[r->pos + 1];
                if (next == 0x00) {  /* a stuffed 0xFF data byte */
                    r->pos += 2;
                    break;
                }
                if (next == 0xFF) {  /* a fill byte before a marker */
                    r->pos++;
                    continue;
                }
                r->ended = 1;        /* a marker: the data stops at r->pos */
                break;
            }
        }
        if (r->ended) {
            b = 0;
            r->nvirt += 8;
        }
        r->buf = (r->buf << 8) | b;
        r->nbits += 8;
    }
}

/* the next `n` (1..16) bits, consumed; -1 past the data */
static inline int32_t get_bits(reader_t *r, int n) {
    if (r->nbits < n) fill(r);
    if (r->nbits - r->nvirt < n) return -1;
    r->nbits -= n;
    return (int32_t)((r->buf >> r->nbits) & ((1u << n) - 1u));
}

/* one Huffman symbol; JPEG_E_DATA or JPEG_E_CODE on failure */
static inline int decode_symbol(reader_t *r, const huff_t *t) {
    if (r->nbits < 16) fill(r);
    const int peek = (int)((r->buf >> (r->nbits - LOOKAHEAD)) & ((1u << LOOKAHEAD) - 1u));
    int l = t->look_len[peek];
    if (l) {
        if (r->nbits - r->nvirt < l) return JPEG_E_DATA;
        r->nbits -= l;
        return t->look_sym[peek];
    }
    int32_t code = (int32_t)((r->buf >> (r->nbits - LOOKAHEAD)) & ((1u << LOOKAHEAD) - 1u));
    l = LOOKAHEAD;
    while (code > t->maxcode[l]) {
        l++;
        if (l > 16) return JPEG_E_CODE;
        code = (code << 1) | (int32_t)((r->buf >> (r->nbits - l)) & 1u);
    }
    if (r->nbits - r->nvirt < l) return JPEG_E_DATA;
    r->nbits -= l;
    const int idx = code + t->valoff[l];
    if (idx < 0 || idx >= t->total) return JPEG_E_CODE;
    return t->vals[idx];
}

static inline int32_t extend(int32_t v, int s) {
    return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

static const uint8_t NATURAL[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

static int decode_block(reader_t *r, const huff_t *dc, const huff_t *ac, int32_t *pred,
                        int16_t *blk) {
    int s = decode_symbol(r, dc);
    if (s < 0) return s;
    if (s > 15) return JPEG_E_CODE;
    int32_t diff = 0;
    if (s) {
        const int32_t v = get_bits(r, s);
        if (v < 0) return JPEG_E_DATA;
        diff = extend(v, s);
    }
    /* wraps as libjpeg's int sum does in practice, without signed overflow */
    *pred = (int32_t)((uint32_t)*pred + (uint32_t)diff);
    blk[0] = (int16_t)*pred;
    for (int k = 1; k < 64;) {
        const int rs = decode_symbol(r, ac);
        if (rs < 0) return rs;
        const int run = rs >> 4, size = rs & 15;
        if (size) {
            k += run;
            if (k > 63) return JPEG_E_COEF;
            const int32_t v = get_bits(r, size);
            if (v < 0) return JPEG_E_DATA;
            blk[NATURAL[k]] = (int16_t)extend(v, size);
            k++;
        } else if (run == 15) {
            k += 16;
        } else {
            break;
        }
    }
    return 0;
}

int jpeg_decode_scan(const uint8_t *data, long long len, long long start, int ns,
                     const int *h, const int *v, const int *bw, const int *bh, const int *off,
                     const int *dc_sel, const int *ac_sel, int mcus_x, int mcus_y, int restart,
                     const uint8_t *bits, const uint8_t *vals, const int *present,
                     int16_t *coef, long long capacity) {
    if (len < 0 || start < 0 || start > len || ns < 1 || ns > 4 || mcus_x < 1 || mcus_y < 1
        || restart < 0 || capacity < 0)
        return JPEG_E_ARGS;
    huff_t tables[8];
    int built[8] = {0};
    for (int c = 0; c < ns; c++) {
        if (h[c] < 1 || h[c] > 4 || v[c] < 1 || v[c] > 4 || bw[c] < 0 || bh[c] < 0 || off[c] < 0
            || dc_sel[c] < 0 || dc_sel[c] > 3 || ac_sel[c] < 0 || ac_sel[c] > 3)
            return JPEG_E_ARGS;
        if ((long long)off[c] + (long long)bw[c] * (long long)bh[c] > capacity) return JPEG_E_ARGS;
        const int sel[2] = {dc_sel[c], 4 + ac_sel[c]};
        for (int i = 0; i < 2; i++) {
            const int t = sel[i];
            if (!present[t]) return JPEG_E_TABLE;
            if (!built[t]) {
                const int rc = build_table(&tables[t], bits + 16 * t, vals + 256 * t);
                if (rc) return rc;
                built[t] = 1;
            }
        }
    }
    reader_t r = {data, (size_t)len, (size_t)start, 0, 0, 0, 0};
    int32_t pred[4] = {0, 0, 0, 0};
    const long long n_mcu = (long long)mcus_x * mcus_y;
    int rst = 0;
    for (long long m = 0; m < n_mcu; m++) {
        if (restart && m > 0 && m % restart == 0) {
            /* the bits left before the marker are padding; the marker follows */
            if (!r.ended) {
                r.nbits = 0;
                r.nvirt = 0;
                r.buf = 0;
                fill(&r);  /* runs to the marker: nothing but padding may remain */
                if (r.nbits - r.nvirt > 0) return JPEG_E_RESTART;
            }
            if (r.pos + 1 >= r.len || r.d[r.pos] != 0xFF || r.d[r.pos + 1] != 0xD0 + (rst & 7))
                return JPEG_E_RESTART;
            r.pos += 2;
            r.buf = 0;
            r.nbits = 0;
            r.nvirt = 0;
            r.ended = 0;
            rst++;
            memset(pred, 0, sizeof pred);
        }
        const int mx = (int)(m % mcus_x), my = (int)(m / mcus_x);
        for (int c = 0; c < ns; c++) {
            const int hh = ns > 1 ? h[c] : 1, vv = ns > 1 ? v[c] : 1;
            for (int by = 0; by < vv; by++) {
                for (int bx = 0; bx < hh; bx++) {
                    const int row = my * vv + by, col = mx * hh + bx;
                    if (row >= bh[c] || col >= bw[c]) return JPEG_E_ARGS;
                    int16_t *blk = coef + 64 * ((long long)off[c] + (long long)row * bw[c] + col);
                    memset(blk, 0, 64 * sizeof(int16_t));
                    const int rc = decode_block(&r, &tables[dc_sel[c]], &tables[4 + ac_sel[c]],
                                                &pred[c], blk);
                    if (rc) return rc;
                }
            }
        }
    }
    return 0;
}
