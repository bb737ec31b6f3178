/* Host helpers of the float64 parity path: the port's copy of the
 * sequential, order-dependent details that worldtpu/native/
 * worldtpu_native.c replicates from the C++ reference vocoder:
 *  - the xorshift128 sum-of-12-uniforms randn() stream, stateful and
 *    call-order dependent, starting from the reference's fixed seed;
 *  - the int-truncating accumulator of Harvest's DC removal
 *    (accumulate(y, y+n, 0) with an int initial value truncates the
 *    running sum toward zero at every step).
 */
#include <stdint.h>
#include <stddef.h>

typedef struct {
    uint32_t x, y, z, w;
} WtXorshiftState;

void wt_randn_init(WtXorshiftState* s) {
    s->x = 123456789u;
    s->y = 362436069u;
    s->z = 521288629u;
    s->w = 88675123u;
}

static double randn_one(WtXorshiftState* s) {
    /* the reference advances x, y, z once before its 12 draws */
    uint32_t t;
    s->x = s->y; s->y = s->z; s->z = s->w;
    uint32_t tmp = 0u;
    for (int i = 0; i < 12; ++i) {
        t = s->x ^ (s->x << 11);
        s->x = s->y; s->y = s->z; s->z = s->w;
        s->w = (s->w ^ (s->w >> 19)) ^ (t ^ (t >> 8));
        tmp += s->w >> 4;
    }
    return tmp / 268435456.0 - 6.0;
}

void wt_randn_fill(WtXorshiftState* s, double* out, int64_t n) {
    for (int64_t i = 0; i < n; ++i) out[i] = randn_one(s);
}

double wt_int_trunc_sum(const double* x, int64_t n) {
    long long acc = 0;
    for (int64_t i = 0; i < n; ++i) {
        double v = (double)acc + x[i];
        acc = (long long)v; /* a C cast truncates toward zero */
    }
    return (double)acc;
}
