/* PNG row unfiltering on the host (data/image_io.py).
 *
 * The inflated IDAT stream of a non-interlaced PNG is `height` rows, each a
 * filter-type byte followed by `stride` bytes. Each filter predicts a byte
 * from its left neighbour a (the byte `bpp` earlier in the row), the byte
 * above b and the byte above-left c, all 0 outside the image:
 *   0 None, 1 Sub (a), 2 Up (b), 3 Average (floor((a + b) / 2)),
 *   4 Paeth (whichever of a, b, c is nearest to a + b - c; ties to a, then b),
 * and the file stores the difference modulo 256. `png_unfilter` adds the
 * predictions back, writing `height * stride` bytes to `dst`. It returns 0,
 * or -(y + 1) when row y has an unknown filter type.
 *
 * Built at first use with the host C compiler into a shared library and
 * called through ctypes; `image_io.unfilter_plain` is its plain version.
 */
#include <stddef.h>
#include <stdint.h>
#include <string.h>

static inline uint8_t paeth(int a, int b, int c) {
    int p = a + b - c;
    int pa = p > a ? p - a : a - p;
    int pb = p > b ? p - b : b - p;
    int pc = p > c ? p - c : c - p;
    if (pa <= pb && pa <= pc) return (uint8_t)a;
    if (pb <= pc) return (uint8_t)b;
    return (uint8_t)c;
}

int png_unfilter(const uint8_t *src, uint8_t *dst, int height, int stride, int bpp) {
    for (int y = 0; y < height; y++) {
        const uint8_t *in = src + (size_t)y * (size_t)(stride + 1);
        const int type = in[0];
        in += 1;
        uint8_t *out = dst + (size_t)y * (size_t)stride;
        const uint8_t *up = y > 0 ? out - stride : NULL;
        int i;
        switch (type) {
        case 0:
            memcpy(out, in, (size_t)stride);
            break;
        case 1:
            for (i = 0; i < bpp && i < stride; i++) out[i] = in[i];
            for (; i < stride; i++) out[i] = (uint8_t)(in[i] + out[i - bpp]);
            break;
        case 2:
            if (up)
                for (i = 0; i < stride; i++) out[i] = (uint8_t)(in[i] + up[i]);
            else
                memcpy(out, in, (size_t)stride);
            break;
        case 3:
            for (i = 0; i < stride; i++) {
                int a = i >= bpp ? out[i - bpp] : 0;
                int b = up ? up[i] : 0;
                out[i] = (uint8_t)(in[i] + ((a + b) >> 1));
            }
            break;
        case 4:
            for (i = 0; i < stride; i++) {
                int a = i >= bpp ? out[i - bpp] : 0;
                int b = up ? up[i] : 0;
                int c = (up && i >= bpp) ? up[i - bpp] : 0;
                out[i] = (uint8_t)(in[i] + paeth(a, b, c));
            }
            break;
        default:
            return -(y + 1);
        }
    }
    return 0;
}
