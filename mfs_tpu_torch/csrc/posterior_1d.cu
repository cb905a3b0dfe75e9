// The 1D Bayes update for Hopper (sm_90a), in f64: posterior moments
// from a quadrature rule and the likelihood at its nodes, in one pass
// over the rule, with the 2N sums held in registers.
//
// Replaces no TPU kernel.  The JAX package leaves this update to XLA,
// which fuses "monomials of the nodes, times the weighted likelihood,
// summed over the nodes" into one loop.  Eager PyTorch cannot: it stacks
// the node monomials into a (B, n, 2N) tensor, multiplies it and sums it,
// ~1.9 GB written and read twice at N = 15, B = 524,288.  This kernel
// computes the same sums without that tensor.
//
// Per trial, with wp_k = p_k w_k (likelihood at node k times its weight):
//   pass 1: pdf_y = sum_k wp_k; mean = sum_k x_k wp_k / pdf_y
//           (the raw mode needs no mean and skips it);
//   pass 2 (scaled mode): scale = sqrt(sum_k (x_k - mean)^2 wp_k / pdf_y);
//   pass 3: u_k = x_k (raw), x_k - mean (central), (x_k - mean) / scale
//           (scaled); acc_j = sum_k u_k^j wp_k for j < num by the product
//           chain u^j = u^(j-1) u; moments_j = acc_j / pdf_y.
// The arithmetic is the plain version's, operation for operation
// (ops/posterior_kernel.py::posterior_moments_1d_plain): every product
// and sum is rounded on its own (__dmul_rn, __dadd_rn: no FMA
// contraction), a division stays a division, and nothing is clamped, so
// a NaN node or a zero pdf_y gives the plain version's NaN or inf.  Only
// the order of the sums over the nodes differs (here k = 0, 1, ...).
//
// Layout: one thread per trial.  x, w, p are (n, B) row-major, so a
// warp's loads of node k are 32 neighbouring doubles; K1 returns its
// nodes and weights in that layout.  Passes 2 and 3 read the rule again,
// from L1/L2.  The moments leave through a (threads, CHUNK | 1) tile in
// shared memory (odd row stride: no bank conflicts), so the stores of
// the (B, num) row-major output are coalesced too.  The accumulators
// stay in registers: num is bucketed at compile time (CHUNK = 8, 16, 32,
// 64), and beyond 64 moments pass 3 runs once per block of 64, reading
// the rule again and starting each block's product chain at u^(64c) by
// the same chain of products, so every power is rounded as before.
//
// Bound: bytes.  At n = 15, num = 30 a trial reads 3 n doubles and
// writes num + 2 (the central mode), ~0.098 ms at 3.35 TB/s for
// B = 524,288, against ~3 n num FP64 operations (~0.04 ms at 34 TFLOP/s,
// no FMA).
#include <cuda_runtime.h>

#define POST_THREADS 64
#define MAX_CHUNK 64

enum { RAW = 0, CENTRAL = 1, SCALED = 2 };

template <int MODE, int CHUNK>
__global__ void __launch_bounds__(POST_THREADS)
posterior_1d_kernel(const double* __restrict__ x, const double* __restrict__ w,
                    const double* __restrict__ p, double* __restrict__ moments,
                    double* __restrict__ mean_out, double* __restrict__ scale_out,
                    double* __restrict__ pdf_y_out, int n, int num, int B) {
    extern __shared__ double tile[];  // (POST_THREADS, min(num, CHUNK) | 1)
    const int ld = min(num, CHUNK) | 1;
    const int b0 = blockIdx.x * POST_THREADS;
    const int b = b0 + threadIdx.x;
    const int trials = min(POST_THREADS, B - b0);

    // A thread past the batch edge computes nothing but still reaches
    // every barrier.
    double pdf_y = 0.0, mean = 0.0, scale = 1.0;
    if (b < B) {
        // ---- pass 1: evidence and mean ---------------------------------
        double sx = 0.0;
        for (int k = 0; k < n; ++k) {
            const size_t i = (size_t)k * B + b;
            const double wp = __dmul_rn(p[i], w[i]);
            pdf_y = __dadd_rn(pdf_y, wp);
            if (MODE != RAW) sx = __dadd_rn(sx, __dmul_rn(x[i], wp));
        }
        if (MODE != RAW) mean = sx / pdf_y;

        // ---- pass 2: scale ---------------------------------------------
        if (MODE == SCALED) {
            double ss = 0.0;
            for (int k = 0; k < n; ++k) {
                const size_t i = (size_t)k * B + b;
                const double c = __dsub_rn(x[i], mean);
                ss = __dadd_rn(ss, __dmul_rn(__dmul_rn(c, c), __dmul_rn(p[i], w[i])));
            }
            scale = sqrt(ss / pdf_y);
        }
        pdf_y_out[b] = pdf_y;
        if (MODE != RAW) mean_out[b] = mean;
        if (MODE == SCALED) scale_out[b] = scale;
    }

    // ---- pass 3: the moments, a block of CHUNK at a time ---------------
    for (int c0 = 0; c0 < num; c0 += CHUNK) {
        const int cn = min(CHUNK, num - c0);
        if (b < B) {
            double acc[CHUNK];
#pragma unroll
            for (int j = 0; j < CHUNK; ++j) acc[j] = 0.0;
            for (int k = 0; k < n; ++k) {
                const size_t i = (size_t)k * B + b;
                const double wp = __dmul_rn(p[i], w[i]);
                double u = x[i];
                if (MODE != RAW) u = __dsub_rn(u, mean);
                if (MODE == SCALED) u = u / scale;
                // u^c0 by the chain u^j = u^(j-1) u; u^0 wp is wp itself.
                double pw = 1.0;
                for (int j = 0; j < c0; ++j) pw = __dmul_rn(pw, u);
                acc[0] = __dadd_rn(acc[0], c0 == 0 ? wp : __dmul_rn(pw, wp));
#pragma unroll
                for (int j = 1; j < CHUNK; ++j) {
                    if (j < cn) {
                        pw = __dmul_rn(pw, u);
                        acc[j] = __dadd_rn(acc[j], __dmul_rn(pw, wp));
                    }
                }
            }
            double* row = tile + threadIdx.x * ld;
#pragma unroll
            for (int j = 0; j < CHUNK; ++j)
                if (j < cn) row[j] = acc[j] / pdf_y;
        }
        __syncthreads();
        // The block's moments c0 .. c0 + cn - 1: one contiguous run of the
        // output when the block holds them all, else one run a trial.
        double* out = moments + (size_t)b0 * num + c0;
        for (int e = threadIdx.x; e < trials * cn; e += POST_THREADS)
            out[(size_t)(e / cn) * num + e % cn] = tile[(e / cn) * ld + e % cn];
        __syncthreads();
    }
}

template <int MODE, int CHUNK>
static int launch(const double* x, const double* w, const double* p, double* moments,
                  double* mean, double* scale, double* pdf_y, int n, int num, int B,
                  cudaStream_t stream) {
    // at most 64 * 65 * 8 = 33,280 bytes (CHUNK = 64)
    const size_t smem = (size_t)POST_THREADS * (min(num, CHUNK) | 1) * sizeof(double);
    const int blocks = (B + POST_THREADS - 1) / POST_THREADS;
    posterior_1d_kernel<MODE, CHUNK><<<blocks, POST_THREADS, smem, stream>>>(
        x, w, p, moments, mean, scale, pdf_y, n, num, B);
    return (int)cudaGetLastError();
}

template <int MODE>
static int launch_mode(const double* x, const double* w, const double* p, double* moments,
                       double* mean, double* scale, double* pdf_y, int n, int num, int B,
                       cudaStream_t stream) {
    if (num <= 8) return launch<MODE, 8>(x, w, p, moments, mean, scale, pdf_y, n, num, B, stream);
    if (num <= 16) return launch<MODE, 16>(x, w, p, moments, mean, scale, pdf_y, n, num, B, stream);
    if (num <= 32) return launch<MODE, 32>(x, w, p, moments, mean, scale, pdf_y, n, num, B, stream);
    return launch<MODE, MAX_CHUNK>(x, w, p, moments, mean, scale, pdf_y, n, num, B, stream);
}

// x, w, p: (n, B) row-major; moments: (B, num) row-major; pdf_y: (B,);
// mean: (B,) in the central and scaled modes, else unused (may be null);
// scale: (B,) in the scaled mode, else unused.  mode: 0 raw, 1 central,
// 2 scaled.  Launches on `stream`; returns cudaGetLastError() (0 on
// success).
extern "C" int mfs_posterior_1d(const double* x, const double* w, const double* p,
                                double* moments, double* mean, double* scale, double* pdf_y,
                                int n, int num, int B, int mode, void* stream) {
    if (n < 1 || num < 1 || B < 0 || mode < RAW || mode > SCALED)
        return (int)cudaErrorInvalidValue;
    if ((mode != RAW && mean == nullptr) || (mode == SCALED && scale == nullptr))
        return (int)cudaErrorInvalidValue;
    if (B == 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    if (mode == RAW) return launch_mode<RAW>(x, w, p, moments, mean, scale, pdf_y, n, num, B, s);
    if (mode == CENTRAL)
        return launch_mode<CENTRAL>(x, w, p, moments, mean, scale, pdf_y, n, num, B, s);
    return launch_mode<SCALED>(x, w, p, moments, mean, scale, pdf_y, n, num, B, s);
}
