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
// Layout: a team of TEAM lanes per trial, lanes over rows and then over
// eigenvalues: 16-lane teams (two trials a warp) for n <= 16, whole
// warps above; a CTA of K1_THREADS threads holds K1_THREADS / TEAM
// neighbouring trials.  ms is (2n, B) row-major: the CTA copies its
// (2n, trials) tile into shared memory with neighbouring threads on
// neighbouring trials, and stores w, x (n, B) the same way from a tile.
// Each trial's L factor, pivots and recurrence coefficients live in
// shared memory.
//   - LDL^T right-looking, lane i owns row i: per column k the pivot is
//     read by every lane, lane i > k divides its L_ik and forms
//     v_i = d_k L_ik once, then updates A_ij -= L_ik v_j (j <= i).  Each
//     entry gets its updates L_ik (d_k L_jk) in the order k = 0, 1, ...,
//     the arithmetic of the former one-thread-per-trial loop.
//   - The back-solve for u and the quadratic form for alpha_{n-1} are
//     O(n^2) and stay serial on the team's first lane, in that order.
//   - alpha, beta, beta^2 sit in shared memory, read by every lane as a
//     broadcast; lane k runs the bisection, Newton steps and Christoffel
//     weight of eigenvalue k.
// Bound: FP64 arithmetic, not bytes: the Sturm counts do 32*n*n f64
// divisions per trial (7,200 at n = 15) against ~(4n+2)*8 bytes of I/O.
// Spreading the eigenvalues over lanes cuts each thread's chain from n
// eigenvalues to one (~480 dependent divisions at n = 15) and puts ~2,000
// warps on the 132 SMs at B = 4096 (~256 at B = 512) where one thread per
// trial put 128.  The kernel stays latency-bound on that division chain;
// at B = 4096 the 16-lane teams also halve the FP64 instructions issued
// (15 of 16 lanes busy at n = 15, against 15 of 32).
// nvcc contracts a*b+c to FMA (no -use_fast_math, but -fmad is on by
// default), which the plain PyTorch version does not: the two differ in
// the last bits, amplified by the Hankel conditioning at large n.
#include <cuda_runtime.h>

#define MAXN 32
#define K1_THREADS 64
#define FULL_MASK 0xffffffffu

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

// One trial's shared scratch: L (n x (n|1)) and six n-vectors.
__host__ __device__ constexpr int trial_doubles(int n) { return n * (n | 1) + 6 * n; }

template <int TEAM>
__global__ void __launch_bounds__(K1_THREADS)
quadrature_1d_kernel(const double* __restrict__ ms, const double* __restrict__ mean,
                     const double* __restrict__ scale, double* __restrict__ w_out,
                     double* __restrict__ x_out, int n, int B, double jitter) {
    constexpr int TRIALS = K1_THREADS / TEAM;
    extern __shared__ double smem[];
    const int ld = n | 1;  // odd row stride: lanes reading a column hit distinct banks
    double* mt = smem;                 // (2n, TRIALS): the CTA's moments
    double* wt = mt + 2 * n * TRIALS;  // (n, TRIALS): weights out
    double* xt = wt + n * TRIALS;      // (n, TRIALS): nodes out
    const int slot = threadIdx.x / TEAM, lane = threadIdx.x % TEAM;
    double* A = xt + n * TRIALS + slot * trial_doubles(n);  // G' on and below the diagonal, then L
    double* cs = A + n * ld;
    double* v = cs + n;  // d_k L_ik of the current column, then the back-solve's u
    double* dg = v + n;  // R's diagonal
    double* alpha = dg + n;
    double* beta = alpha + n;
    double* beta2 = beta + n;
    const int b0 = blockIdx.x * TRIALS, b = b0 + slot;

    // A trial past the batch edge runs on a dummy tile and stores nothing,
    // so every lane reaches every barrier and shuffle.
    for (int e = threadIdx.x; e < 2 * n * TRIALS; e += K1_THREADS) {
        const int k = e / TRIALS, bb = b0 + e % TRIALS;
        mt[e] = bb < B ? ms[(size_t)k * B + bb] : 1.0;
    }
    __syncthreads();
    const double* mv = mt + slot;
#define MV(k) mv[(k) * TRIALS]

    // ---- van der Sluis equilibration, lane i: c_i, sqrt(m_2i) ---------
    const bool row = lane < n;
    double sq = 1.0, c = 0.0;
    if (row) {
        double m2 = MV(2 * lane);
        if (m2 <= 1e-30) m2 = 1e-30;
        sq = sqrt(m2);
        c = 1.0 / sq;
        cs[lane] = c;
    }
    const double rs = __shfl_down_sync(FULL_MASK, sq, 1, TEAM) / sq;  // sq_{i+1} / sq_i
    const double sq0 = __shfl_sync(FULL_MASK, sq, 0, TEAM);
    __syncwarp();
    if (row) {
        for (int j = 0; j < lane; ++j) A[lane * ld + j] = (c * MV(lane + j)) * cs[j];
        A[lane * ld + lane] = (c * MV(2 * lane)) * c + jitter;
    }

    // ---- LDL^T of the equilibrated Gram, right-looking ----------------
    const double pivot_diag = 1e-8 * n;
    for (int k = 0; k < n; ++k) {
        __syncwarp();
        const double dk_raw = A[k * ld + k];
        double dk = dk_raw;
        if (fabs(dk) < 1e-35) dk = dk < 0.0 ? -1e-35 : 1e-35;
        if (lane == k) dg[k] = dk_raw <= 0.0 ? pivot_diag : sqrt(dk);
        const bool below = lane > k && row;
        double lik = 0.0;
        if (below) {
            lik = A[lane * ld + k] / dk;
            A[lane * ld + k] = lik;
            v[lane] = dk * lik;
        }
        __syncwarp();
        if (below)
            for (int j = k + 1; j <= lane; ++j) A[lane * ld + j] -= lik * v[j];
    }
    __syncwarp();

    // ---- Golub-Welsch recurrence coefficients, lane i < n - 1 ---------
    const double sup = lane < n - 1 ? rs * A[(lane + 1) * ld + lane] : 0.0;
    const double sup_prev = __shfl_up_sync(FULL_MASK, sup, 1, TEAM);
    if (lane < n - 1) {
        alpha[lane] = lane == 0 ? sup : sup - sup_prev;
        const double bt = rs * (dg[lane + 1] / dg[lane]);
        beta[lane] = bt;
        beta2[lane] = bt * bt;
    }

    // alpha_{n-1} = u^T H u with R^T u = e_{n-1}, H[i, j] = m_{i+j+1}:
    // unit back-solve in the equilibrated basis, then u_i = c_i v_i.
    if (lane == 0) {
        double* u = v;
        u[n - 1] = 1.0 / dg[n - 1];
        for (int i = n - 2; i >= 0; --i) {
            double acc = 0.0;
            for (int j = i + 1; j < n; ++j) acc += A[j * ld + i] * u[j];
            u[i] = -acc;
        }
        for (int i = 0; i < n; ++i) u[i] = cs[i] * u[i];
        double alpha_last = 0.0;
        for (int i = 0; i < n; ++i) {
            for (int j = i; j < n; ++j) {
                double term = (u[i] * u[j]) * MV(i + j + 1);
                if (j > i) term *= 2.0;
                alpha_last += term;
            }
        }
        alpha[n - 1] = alpha_last;
    }
    __syncwarp();
#undef MV

    // ---- Gershgorin bracket, the same bits on every lane ---------------
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

    // ---- lane k: Sturm bisection for the k-th eigenvalue ---------------
    // (a lane k >= n finds no eigenvalue and stores nothing)
    const int k = lane;
    double lo = glo, hi = ghi;
    for (int it = 0; it < 32; ++it) {
        const double mid = 0.5 * (lo + hi);
        if (sturm_count(alpha, beta2, mid, n) >= k + 1) hi = mid;
        else lo = mid;
    }
    const double clamp_lo = lo - margin;
    const double clamp_hi = hi + margin;

    // ---- clamped Newton on the monic characteristic recurrence ---------
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

    // ---- Christoffel weight ----------------------------------------------
    const double r00 = dg[0] * sq0;
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
    if (row) {
        wt[k * TRIALS + slot] = 1.0 / s;
        xt[k * TRIALS + slot] = lam * (b < B ? scale[b] : 1.0) + (b < B ? mean[b] : 0.0);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < n * TRIALS; e += K1_THREADS) {
        const int kk = e / TRIALS, bb = b0 + e % TRIALS;
        if (bb < B) {
            w_out[(size_t)kk * B + bb] = wt[e];
            x_out[(size_t)kk * B + bb] = xt[e];
        }
    }
}

template <int TEAM>
static int launch(const double* ms, const double* mean, const double* scale, double* w,
                  double* x, int n, int B, double jitter, cudaStream_t stream) {
    constexpr int TRIALS = K1_THREADS / TEAM;
    // at most (4 * 32 * 2 + 2 * trial_doubles(32)) * 8 = 22,016 bytes (n = 32)
    const size_t smem = ((size_t)4 * n * TRIALS + (size_t)TRIALS * trial_doubles(n)) * sizeof(double);
    const int blocks = (B + TRIALS - 1) / TRIALS;
    quadrature_1d_kernel<TEAM><<<blocks, K1_THREADS, smem, stream>>>(ms, mean, scale, w, x, n,
                                                                     B, jitter);
    return (int)cudaGetLastError();
}

// Launch on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int mfs_quadrature_1d(const double* ms, const double* mean, const double* scale,
                                 double* w, double* x, int n, int B, double jitter,
                                 void* stream) {
    if (n < 2 || n > MAXN || B < 0) return (int)cudaErrorInvalidValue;
    if (B == 0) return 0;
    if (n <= 16)  // 16-lane teams, two trials a warp
        return launch<16>(ms, mean, scale, w, x, n, B, jitter, (cudaStream_t)stream);
    return launch<32>(ms, mean, scale, w, x, n, B, jitter, (cudaStream_t)stream);
}
