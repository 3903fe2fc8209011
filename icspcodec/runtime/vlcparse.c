/* Native bitstream parser for the icspcodec decoder.
 *
 * The bitstream's variable-length codes force a sequential parse; doing it
 * in Python costs minutes per 300-frame sequence, so the parse runs here
 * (loaded via ctypes) and hands fixed-shape int32 symbol arrays to the
 * batched JAX inverse pipeline.
 *
 * Syntax (reference intraBody/interBody, encoder source:4923-5236):
 *   intra MB: 4 x [ mpm(1) modebit(1) DC-VLC acflag(1) {63 zero bits | 63 AC-VLC} ]
 *             then Cb [DC acflag {...}] and Cr likewise
 *   inter MB: mvmode(1)=1, MVx-VLC, MVy-VLC, 4 x [DC acflag {...}], Cb, Cr
 * VLC: 13-category sign+offset code (DCentropy, encoder source:5417-5602).
 */
#include <stdint.h>
#include <stddef.h>

typedef struct {
    const uint8_t *data;
    long nbits;
    long pos;
} BitReader;

static inline int get_bit(BitReader *br) {
    if (br->pos >= br->nbits) return -1;
    long p = br->pos++;
    return (br->data[p >> 3] >> (7 - (p & 7))) & 1;
}

static inline long read_vlc(BitReader *br, int32_t *out) {
    int b0 = get_bit(br);
    if (b0 < 0) return -1;
    int exp, sign;
    if (b0 == 0) {
        int b1 = get_bit(br);
        if (b1 < 0) return -1;
        if (b1 == 0) { *out = 0; return 0; }          /* 00 */
        int b2 = get_bit(br);
        if (b2 < 0) return -1;
        if (b2 == 0) {                                 /* 010 s */
            sign = get_bit(br);
            if (sign < 0) return -1;
            *out = sign ? 1 : -1;
            return 0;
        }
        exp = 1;                                       /* 011 */
    } else {
        int ones = 1, b;
        while ((b = get_bit(br)) == 1) ones++;
        if (b < 0) return -1;
        if (ones == 1) {                               /* 10x -> exp 2|3 */
            int b2 = get_bit(br);
            if (b2 < 0) return -1;
            exp = 2 + b2;
        } else if (ones == 2) {                        /* 110 -> exp 4 */
            exp = 4;
        } else {                                       /* 1^(exp-2) 0 */
            exp = ones + 2;
        }
    }
    sign = get_bit(br);
    if (sign < 0) return -1;
    int32_t payload = 0;
    for (int i = 0; i < exp; i++) {
        int b = get_bit(br);
        if (b < 0) return -1;
        payload = (payload << 1) | b;
    }
    int32_t v = (1 << exp) + payload;
    *out = sign ? v : -v;
    return 0;
}

static long parse_coeff_block(BitReader *br, int32_t *scan, int32_t *acflag) {
    if (read_vlc(br, &scan[0]) < 0) return -1;
    int f = get_bit(br);
    if (f < 0) return -1;
    *acflag = f;
    if (f) {
        br->pos += 63;            /* 63 literal zero bits */
        if (br->pos > br->nbits) return -1;
        for (int i = 1; i < 64; i++) scan[i] = 0;
    } else {
        for (int i = 1; i < 64; i++)
            if (read_vlc(br, &scan[i]) < 0) return -1;
    }
    return 0;
}

/* Returns bits consumed, or -1 on truncation. */
long parse_frames(
    const uint8_t *data, long nbytes, int nframes, int mbh, int mbw, int period,
    int32_t *y_scan,    /* nframes * (2*mbh) * (2*mbw) * 64 */
    int32_t *y_acflag,  /* nframes * (2*mbh) * (2*mbw)      */
    int32_t *mpm,       /* idem                              */
    int32_t *mode_bit,  /* idem                              */
    int32_t *cb_scan,   /* nframes * mbh * mbw * 64          */
    int32_t *cb_acflag, /* nframes * mbh * mbw               */
    int32_t *cr_scan,
    int32_t *cr_acflag,
    int32_t *mv_diff    /* nframes * mbh * mbw * 2           */
) {
    BitReader br = { data, nbytes * 8, 0 };
    int gw = 2 * mbw;
    long ystride = (long)(2 * mbh) * gw;
    for (int n = 0; n < nframes; n++) {
        int is_intra = (period == 0) || (period >= 1 && n % period == 0);
        for (int mb = 0; mb < mbh * mbw; mb++) {
            int by = mb / mbw, bx = mb % mbw;
            if (!is_intra) {
                if (get_bit(&br) < 0) return -1;   /* mv mode flag */
                int32_t *mv = mv_diff + ((long)n * mbh * mbw + mb) * 2;
                if (read_vlc(&br, &mv[0]) < 0) return -1;
                if (read_vlc(&br, &mv[1]) < 0) return -1;
            }
            for (int k = 0; k < 4; k++) {
                int gy = 2 * by + (k >> 1), gx = 2 * bx + (k & 1);
                long gidx = (long)n * ystride + (long)gy * gw + gx;
                if (is_intra) {
                    int f1 = get_bit(&br), f2 = get_bit(&br);
                    if (f1 < 0 || f2 < 0) return -1;
                    mpm[gidx] = f1;
                    mode_bit[gidx] = f2;
                }
                if (parse_coeff_block(&br, y_scan + gidx * 64, y_acflag + gidx) < 0)
                    return -1;
            }
            long cidx = (long)n * mbh * mbw + mb;
            if (parse_coeff_block(&br, cb_scan + cidx * 64, cb_acflag + cidx) < 0)
                return -1;
            if (parse_coeff_block(&br, cr_scan + cidx * 64, cr_acflag + cidx) < 0)
                return -1;
        }
    }
    return br.pos;
}

/* MSB-first bit packer: items are (code, length) pairs with right-aligned
 * code bits.  Replicates the reference's tail convention (makebitstream):
 * the final partial byte keeps its bits in the LOW positions and one extra
 * zero byte is appended when the stream ends byte-aligned.
 * Returns the number of bytes written into out (caller sizes it as
 * total_bits/8 + 1). */
long pack_items(const uint64_t *codes, const int64_t *lengths, long n,
                uint8_t *out) {
    uint64_t acc = 0;   /* bit accumulator, MSB-first in low `fill` bits */
    int fill = 0;
    long nbytes = 0;
    for (long i = 0; i < n; i++) {
        int len = (int)lengths[i];
        acc = (acc << len) | (codes[i] & ((len >= 64) ? ~0ULL : ((1ULL << len) - 1)));
        fill += len;
        while (fill >= 8) {
            out[nbytes++] = (uint8_t)(acc >> (fill - 8));
            fill -= 8;
        }
    }
    /* tail: remaining bits stay in the LOW positions of the last byte */
    out[nbytes++] = (uint8_t)(acc & ((fill >= 64) ? ~0ULL : ((1ULL << fill) - 1)));
    return nbytes;
}
