/* Host helper of the F0 contour smoother (C, built on demand via ctypes).
 *
 * The port's copy of worldtpu/native/worldtpu_native.c's worldtpu_filter_f0:
 * the zero-lag biquad of worldtpu_torch/analysis/contour.py:_filtering_f0,
 * one forward pass writing its output time-reversed, applied twice (so the
 * second pass runs over the reversed signal and un-reverses it).  It keeps
 * the exact operation order of that module's Python loop (no FMA
 * contraction: built with -ffp-contract=off), so both give the same bits.
 */
#include <stdint.h>

static void biquad_pass(const double* sig, int64_t n, double* out,
                        double b0, double b1, double a0, double a1) {
    double w0 = 0.0, w1 = 0.0;
    for (int64_t i = 0; i < n; ++i) {
        double wt = sig[i] + a0 * w0 + a1 * w1;
        out[n - i - 1] = b0 * wt + b1 * w0 + b0 * w1;
        w1 = w0;
        w0 = wt;
    }
}

void wt_filter_f0(const double* x, int64_t n, double* tmp, double* out,
                  double b0, double b1, double a0, double a1) {
    biquad_pass(x, n, tmp, b0, b1, a0, a1);
    biquad_pass(tmp, n, out, b0, b1, a0, a1);
}
