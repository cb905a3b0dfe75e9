// Fused 1D moment-matched Gauss quadrature for Hopper (sm_90a), in f64.
//
// Replaces the Pallas TPU kernel mfs_tpu/ops/pallas_quadrature.py::
// _quadrature_kernel.  Same function, same constants and iteration
// counts, per trial:
//   1. van der Sluis equilibration c_j = 1/sqrt(m_{2j}) (moment floor 1e-30);
//   2. LDL^T of the equilibrated Hankel Gram with true pivots; optional
//      jitter*I added to the equilibrated Gram first; a pivot <= 0 gets
//      the completion diagonal 1e-8*n; signed tiny guard 1e-35;
//   3. Golub-Welsch alpha/beta from the LDL ratios, the last alpha from
//      the back-solve quadratic form against the shifted Hankel;
//   4. eigenvalues: Gershgorin bracket (1e-3 pad), 32 Sturm-bisection
//      iterations, 2^-17 hand-off margin, 8 clamped Newton steps on the
//      monic recurrence (denominator floor 1e-30);
//   5. Christoffel weights w_k = 1/sum_j p_j(lam_k)^2, p_0 = 1/(s'_0 sqrt(m_0)),
//      so the weights sum to m_0 (the mass convention of the TPU kernel);
//   6. affine node map x = lam*scale + mean.
// The TPU kernel's double-f32 arithmetic, its 512-lane blocks and its
// standard-normal pad filler are not ported: the H100 has an FP64 ALU,
// and the ragged batch edge is masked here.
//
// Layout: one thread per trial.  ms is (2n, B) row-major, so thread b
// reads ms[k*B + b] and neighbouring threads read neighbouring
// addresses; outputs w, x are (n, B) the same way.
//
// Bound: FP64 arithmetic, not bytes.  The Sturm counts alone do 32*n*n
// f64 divisions per trial (7,200 at n = 15), against ~(4n+2)*8 bytes of
// I/O per trial.  The per-trial arrays (the packed strictly-lower L
// factor, n(n-1)/2 doubles) live in local memory.
// Occupancy: at B = 4096 and 128 threads a block only 32 of the 132 SMs
// get a block (a 512-trial rescue bucket fills 4).  The n eigenvalues'
// bisection and Newton phases are independent, so threads over
// (trial, k) are the natural next design.
// nvcc contracts a*b+c to FMA (no -use_fast_math, but -fmad is on by
// default), which the plain PyTorch version does not: the two differ in
// the last bits, amplified by the Hankel conditioning at large n.
#include <cuda_runtime.h>

#define MAXN 32
#define THREADS 128

__device__ __forceinline__ double nan_min(double a, double b) {
    return (a != a || b != b) ? a + b : fmin(a, b);
}

__device__ __forceinline__ double nan_max(double a, double b) {
    return (a != a || b != b) ? a + b : fmax(a, b);
}

// Number of eigenvalues of the Jacobi matrix below x (Sturm sign count).
__device__ int sturm_count(const double* alpha, const double* beta2, double x, int n) {
    const double tiny = 1e-20;
    double q = alpha[0] - x;
    if (fabs(q) < tiny) q = -tiny;
    int cnt = q < 0.0;
    for (int i = 1; i < n; ++i) {
        q = (alpha[i] - x) - beta2[i - 1] / q;
        if (fabs(q) < tiny) q = -tiny;
        cnt += q < 0.0;
    }
    return cnt;
}

__global__ void __launch_bounds__(THREADS)
quadrature_1d_kernel(const double* __restrict__ ms, const double* __restrict__ mean,
                     const double* __restrict__ scale, double* __restrict__ w_out,
                     double* __restrict__ x_out, int n, int B, double jitter) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;

    double mv[2 * MAXN];
    for (int k = 0; k < 2 * n; ++k) mv[k] = ms[(size_t)k * B + b];

    // ---- van der Sluis equilibration ---------------------------------
    double sq[MAXN], cs[MAXN], rs[MAXN];
    for (int j = 0; j < n; ++j) {
        double m2j = mv[2 * j];
        if (m2j <= 1e-30) m2j = 1e-30;
        sq[j] = sqrt(m2j);
        cs[j] = 1.0 / sq[j];
    }
    for (int i = 0; i < n - 1; ++i) rs[i] = sq[i + 1] / sq[i];

    // ---- LDL^T of the equilibrated Gram, column by column ------------
    // L(i, k), i > k, packed by column.
    double L[MAXN * (MAXN - 1) / 2];
    double d[MAXN], diag[MAXN];
#define LIDX(i, k) ((k) * n - (k) * ((k) + 1) / 2 + ((i) - (k) - 1))
    const double pivot_diag = 1e-8 * n;
    for (int j = 0; j < n; ++j) {
        double dj = (cs[j] * mv[2 * j]) * cs[j] + jitter;
        for (int k = 0; k < j; ++k) {
            const double ljk = L[LIDX(j, k)];
            dj -= ljk * (d[k] * ljk);
        }
        const bool bad = dj <= 0.0;
        if (fabs(dj) < 1e-35) dj = dj < 0.0 ? -1e-35 : 1e-35;
        diag[j] = bad ? pivot_diag : sqrt(dj);
        d[j] = dj;
        for (int i = j + 1; i < n; ++i) {
            double acc = (cs[i] * mv[i + j]) * cs[j];
            for (int k = 0; k < j; ++k) acc -= L[LIDX(i, k)] * (d[k] * L[LIDX(j, k)]);
            L[LIDX(i, j)] = acc / dj;
        }
    }

    // ---- Golub-Welsch recurrence coefficients ------------------------
    double alpha[MAXN], beta[MAXN], beta2[MAXN];
    double sup_prev = 0.0;
    for (int i = 0; i < n - 1; ++i) {
        const double sup = rs[i] * L[LIDX(i + 1, i)];
        alpha[i] = i == 0 ? sup : sup - sup_prev;
        sup_prev = sup;
    }
    for (int k = 1; k < n; ++k) beta[k - 1] = rs[k - 1] * (diag[k] / diag[k - 1]);

    // alpha_{n-1} = u^T H u with R^T u = e_{n-1}, H[i, j] = m_{i+j+1}:
    // unit back-solve in the equilibrated basis, then u_i = c_i v_i.
    double u[MAXN];
    u[n - 1] = 1.0 / diag[n - 1];
    for (int i = n - 2; i >= 0; --i) {
        double acc = 0.0;
        for (int j = i + 1; j < n; ++j) acc += L[LIDX(j, i)] * u[j];
        u[i] = -acc;
    }
    for (int i = 0; i < n; ++i) u[i] = cs[i] * u[i];
    double alpha_last = 0.0;
    for (int i = 0; i < n; ++i) {
        for (int j = i; j < n; ++j) {
            double term = (u[i] * u[j]) * mv[i + j + 1];
            if (j > i) term *= 2.0;
            alpha_last += term;
        }
    }
    alpha[n - 1] = alpha_last;
    for (int i = 0; i < n - 1; ++i) beta2[i] = beta[i] * beta[i];
#undef LIDX

    // ---- Gershgorin bracket ------------------------------------------
    double glo, ghi;
    {
        double babs_prev = sqrt(fabs(beta2[0]));
        glo = alpha[0] - babs_prev;
        ghi = alpha[0] + babs_prev;
        for (int i = 1; i < n; ++i) {
            const double babs_i = i < n - 1 ? sqrt(fabs(beta2[i])) : 0.0;
            const double left = babs_prev + babs_i;
            glo = nan_min(glo, alpha[i] - left);
            ghi = nan_max(ghi, alpha[i] + left);
            babs_prev = babs_i;
        }
        const double pad = 1e-3 * (ghi - glo) + 1e-20;
        glo -= pad;
        ghi += pad;
    }
    const double margin = 0x1p-17 * (ghi - glo);

    const double mu = mean[b];
    const double sc = scale[b];
    const double r00 = diag[0] * sq[0];
    for (int k = 0; k < n; ++k) {
        // ---- Sturm bisection for the k-th eigenvalue -----------------
        double lo = glo, hi = ghi;
        for (int it = 0; it < 32; ++it) {
            const double mid = 0.5 * (lo + hi);
            if (sturm_count(alpha, beta2, mid, n) >= k + 1) hi = mid;
            else lo = mid;
        }
        const double clamp_lo = lo - margin;
        const double clamp_hi = hi + margin;

        // ---- clamped Newton on the monic characteristic recurrence ---
        double lam = 0.5 * (lo + hi);
        for (int it = 0; it < 8; ++it) {
            double p_prev = 0.0, p_cur = 1.0, d_prev = 0.0, d_cur = 0.0;
            for (int j = 0; j < n; ++j) {
                const double dl = lam - alpha[j];
                double t = dl * p_cur;
                double dt = dl * d_cur + p_cur;
                if (j > 0) {
                    t -= beta2[j - 1] * p_prev;
                    dt -= beta2[j - 1] * d_prev;
                }
                p_prev = p_cur;
                p_cur = t;
                d_prev = d_cur;
                d_cur = dt;
            }
            const double denom = fabs(d_cur) < 1e-30 ? 1e-30 : d_cur;
            lam -= p_cur / denom;
            if (lam < clamp_lo) lam = clamp_lo;
            if (lam > clamp_hi) lam = clamp_hi;
        }

        // ---- Christoffel weight --------------------------------------
        double p_prev = 0.0;
        double p = 1.0 / r00;
        double s = p * p;
        for (int j = 0; j < n - 1; ++j) {
            double t = (lam - alpha[j]) * p;
            if (j > 0) t -= beta[j - 1] * p_prev;
            const double p_next = t / beta[j];
            p_prev = p;
            p = p_next;
            s += p * p;
        }
        w_out[(size_t)k * B + b] = 1.0 / s;
        x_out[(size_t)k * B + b] = lam * sc + mu;
    }
}

// Launch on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int mfs_quadrature_1d(const double* ms, const double* mean, const double* scale,
                                 double* w, double* x, int n, int B, double jitter,
                                 void* stream) {
    if (n < 2 || n > MAXN || B < 0) return (int)cudaErrorInvalidValue;
    if (B == 0) return 0;
    const int blocks = (B + THREADS - 1) / THREADS;
    quadrature_1d_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        ms, mean, scale, w, x, n, B, jitter);
    return (int)cudaGetLastError();
}
