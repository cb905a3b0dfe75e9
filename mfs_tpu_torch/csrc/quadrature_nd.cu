// ND moment-quadrature kernels for Hopper (sm_90a), in f64: K2 (fused
// eigenpairs) and the K-builder pair nd_ldl / nd_ksolve.
//
// K2, mfs_nd_eigh, replaces the Pallas TPU kernel
// mfs_tpu/ops/pallas_quadrature_nd.py::_nd_kernel (through nd_eigh_pallas).
// mfs_nd_ldl and mfs_nd_ksolve together compute the K-builder: mfs_nd_ldl
// replaces ::_nd_ldl_kernel, ::_nd_cvec_kernel and ::_nd_ldl_panel_kernel,
// mfs_nd_ksolve replaces ::_nd_fsolve_kernel and ::_nd_tsolve_kernel (the
// five programs of nd_k_pallas_staged, split there only to stay under the
// Mosaic compiler's statement-count limit), and the two replace
// ::_nd_k_kernel (through nd_k_pallas), which computes the same function
// for s <= 28 in one program.
// All start from a graded-lex moment vector ms (B, z), row-major, and the
// index tables inds (d+1, s, s), int32: G = ms[inds[0]], H_m = ms[inds[1+m]].
// Per trial:
//   1. equilibration c_j = 1/sqrt(G_jj) (G_jj <= 1e-30 -> 1) and
//      G'_ij = (c_i G_ij) c_j;
//   2. LDL^T of G' with true pivots, left-looking (entry (i, j) gets its
//      updates L_ik (d_k L_jk) in the order k = 0, 1, ...); a pivot <= 0 gets
//      the completion diagonal 1e-8*s in R = Lu diag(scale); a pivot below
//      1e-35 in magnitude is replaced by a signed 1e-35 before dividing;
//   3. K_m = R^{-1} H'_m R^{-T}, H'_m = (c_i H_ij) c_j, by two triangular
//      solves, symmetrised 0.5 (K + K^T).
//      nd_ksolve: two unit solves W = Lu^{-1} H', Y = W Lu^{-T}, then
//          K_ij = (Y_ij / scale_i) / scale_j (as _nd_k_kernel);
//      K2: each solve divides by scale[r] inside the recursion (as _nd_kernel).
//   4. K2 only: cyclic Jacobi in f64 from V = I, in the round-robin order of
//      mfs_tpu/ops/eigh.py::_round_robin_schedule (circle method; per round
//      all angles, then all column updates, then all row updates, then V),
//      until the off-diagonal mass is at most (1e-14)^2 of the total, at
//      most 20 sweeps.  The TPU kernel's f32 sweeps and Newton-Schulz steps
//      exist because the TPU has no f64 ALU and are not ported.
// The TPU kernels' double-f32 arithmetic, lane blocks, VMEM caps and the
// one-hot MXU gather are not ported: indices are read directly, and the
// ragged batch edge is masked (no padding with a copy of trial 0).
// A trial whose moments are not finite comes out NaN: nd_ldl / nd_ksolve by
// propagation, K2 by an explicit check of K before the Jacobi stage.
//
// Layouts and bounds:
// - K2: one thread per (trial, dimension), s <= 10, d <= 3; each thread
//   redoes the trial's LDL (O(s^3/6), cheaper than sharing it).  The s x s
//   matrices live in local memory.  Bound: FP64 operations of the Jacobi
//   sweeps (~9 s^3 per sweep per dimension), not bytes.
// - nd_ldl + nd_ksolve, s <= 119, in two launches.  nd_ldl: one 128-thread
//   CTA per trial, one thread per row of the left-looking LDL (two
//   __syncthreads per column), G' and then L in shared memory; it writes
//   Lu (B, s, s), the guarded pivots, c and 1/scale.  nd_ksolve: one CTA
//   per (trial, dimension), Lu and W = H'_m in shared memory (2 s (s|1)
//   doubles, the odd row stride against bank conflicts: s <= 119 fits the
//   227 KB opt-in); threads over columns for W = Lu^{-1} H', over rows of
//   W for the second solve, over the flat output for the scaled,
//   symmetrised, coalesced K.  The factor is computed once per trial and
//   the d solves run as independent CTAs (2,048 at B = 1024, d = 2).
//   Bound: bytes for both (Lu written, then read d times; K written); each
//   thread's loop over k is sequential, so both sit well above it.
// nvcc contracts a*b+c to FMA, which the plain PyTorch versions do not: the
// two differ in the last bits.
#include <cuda_runtime.h>

#define MAXS_EIGH 10
#define EIGH_THREADS 64
#define LARGE_THREADS 128
#define MAXS_LARGE 119
#define MAX_SWEEPS 20
#define JACOBI_TOL2 1e-28

__device__ __forceinline__ double guard_pivot(double dj) {
    if (fabs(dj) < 1e-35) dj = dj < 0.0 ? -1e-35 : 1e-35;
    return dj;
}

// ---------------------------------------------------------------------------
// K2: equilibrated LDL, scaled solves, cyclic Jacobi
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(EIGH_THREADS)
nd_eigh_kernel(const double* __restrict__ ms, const int* __restrict__ inds,
               double* __restrict__ vals, double* __restrict__ vecs,
               int d, int s, int z, int B) {
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= B * d) return;
    const int b = t / d, m = t % d;
    const double* mv = ms + (size_t)b * z;
    const int* ig = inds;
    const int* ih = inds + (size_t)(1 + m) * s * s;
#define IX(i, j) ((i) * MAXS_EIGH + (j))

    double c[MAXS_EIGH], scale[MAXS_EIGH], piv[MAXS_EIGH], acc[MAXS_EIGH];
    double Lu[MAXS_EIGH * MAXS_EIGH];
    for (int j = 0; j < s; ++j) {
        double g = mv[ig[j * s + j]];
        if (g <= 1e-30) g = 1.0;
        c[j] = 1.0 / sqrt(g);
    }

    // ---- LDL^T of G', true pivots -------------------------------------
    const double pivot_diag = 1e-8 * s;
    for (int j = 0; j < s; ++j) {
        for (int i = j; i < s; ++i) {
            double a = (c[i] * mv[ig[i * s + j]]) * c[j];
            for (int k = 0; k < j; ++k) a -= Lu[IX(i, k)] * (piv[k] * Lu[IX(j, k)]);
            acc[i] = a;
        }
        const bool bad = acc[j] <= 0.0;
        const double dj = guard_pivot(acc[j]);
        scale[j] = bad ? pivot_diag : sqrt(dj);
        piv[j] = dj;
        for (int i = j + 1; i < s; ++i) Lu[IX(i, j)] = acc[i] / dj;
    }

    // ---- K = R^{-1} H' R^{-T}, scale[r] divided inside each recursion --
    double X[MAXS_EIGH * MAXS_EIGH], A[MAXS_EIGH * MAXS_EIGH];
    for (int col = 0; col < s; ++col)
        for (int r = 0; r < s; ++r) {
            double a = (c[r] * mv[ih[r * s + col]]) * c[col];
            for (int k = 0; k < r; ++k) a -= Lu[IX(r, k)] * (scale[k] * X[IX(k, col)]);
            X[IX(r, col)] = a / scale[r];
        }
    for (int col = 0; col < s; ++col)
        for (int r = 0; r < s; ++r) {
            double a = X[IX(col, r)];
            for (int k = 0; k < r; ++k) a -= Lu[IX(r, k)] * (scale[k] * A[IX(k, col)]);
            A[IX(r, col)] = a / scale[r];
        }
    bool finite = true;
    for (int i = 0; i < s; ++i) {
        for (int j = i + 1; j < s; ++j) {
            const double avg = 0.5 * (A[IX(i, j)] + A[IX(j, i)]);
            A[IX(i, j)] = avg;
            A[IX(j, i)] = avg;
        }
        for (int j = 0; j < s; ++j) finite = finite && isfinite(A[IX(i, j)]);
    }

    // ---- cyclic Jacobi, round-robin order (V reuses X) ----------------
    double* V = X;
    for (int i = 0; i < s; ++i)
        for (int j = 0; j < s; ++j) V[IX(i, j)] = i == j ? 1.0 : 0.0;
    const int m2 = s + (s & 1);
    for (int sw = 0; finite && sw < MAX_SWEEPS; ++sw) {
        double off = 0.0, tot = 0.0;
        for (int i = 0; i < s; ++i)
            for (int j = 0; j < s; ++j) {
                const double q = A[IX(i, j)] * A[IX(i, j)];
                tot += q;
                if (i != j) off += q;
            }
        if (!(off > JACOBI_TOL2 * tot)) break;
        int players[MAXS_EIGH + 1];
        for (int i = 0; i < m2; ++i) players[i] = i;
        for (int round = 0; round < m2 - 1; ++round) {
            int P[MAXS_EIGH / 2 + 1], Q[MAXS_EIGH / 2 + 1];
            double cr[MAXS_EIGH / 2 + 1], sr[MAXS_EIGH / 2 + 1];
            int np = 0;
            for (int i = 0; i < m2 / 2; ++i) {
                const int a = players[i], bb = players[m2 - 1 - i];
                if (a < s && bb < s) {
                    P[np] = min(a, bb);
                    Q[np] = max(a, bb);
                    ++np;
                }
            }
            for (int k = 0; k < np; ++k) {
                const double app = A[IX(P[k], P[k])], aqq = A[IX(Q[k], Q[k])];
                const double apq = A[IX(P[k], Q[k])];
                double tr = 0.0;
                if (apq != 0.0) {
                    const double tau = (aqq - app) / (2.0 * apq);
                    tr = (tau >= 0.0 ? 1.0 : -1.0) / (fabs(tau) + sqrt(1.0 + tau * tau));
                }
                cr[k] = 1.0 / sqrt(1.0 + tr * tr);
                sr[k] = tr * cr[k];
            }
            for (int k = 0; k < np; ++k)
                for (int i = 0; i < s; ++i) {
                    const double aip = A[IX(i, P[k])], aiq = A[IX(i, Q[k])];
                    A[IX(i, P[k])] = cr[k] * aip - sr[k] * aiq;
                    A[IX(i, Q[k])] = sr[k] * aip + cr[k] * aiq;
                }
            for (int k = 0; k < np; ++k)
                for (int j = 0; j < s; ++j) {
                    const double apj = A[IX(P[k], j)], aqj = A[IX(Q[k], j)];
                    A[IX(P[k], j)] = cr[k] * apj - sr[k] * aqj;
                    A[IX(Q[k], j)] = sr[k] * apj + cr[k] * aqj;
                }
            for (int k = 0; k < np; ++k)
                for (int i = 0; i < s; ++i) {
                    const double vip = V[IX(i, P[k])], viq = V[IX(i, Q[k])];
                    V[IX(i, P[k])] = cr[k] * vip - sr[k] * viq;
                    V[IX(i, Q[k])] = sr[k] * vip + cr[k] * viq;
                }
            // circle method: [p0, p_last, p1, ..., p_{m2-2}]
            const int last = players[m2 - 1];
            for (int i = m2 - 1; i >= 2; --i) players[i] = players[i - 1];
            players[1] = last;
        }
    }

    const size_t o = (size_t)t;  // (b * d + m)
    const double nan = __longlong_as_double(0x7ff8000000000000LL);
    for (int j = 0; j < s; ++j) vals[o * s + j] = finite ? A[IX(j, j)] : nan;
    for (int i = 0; i < s; ++i)
        for (int j = 0; j < s; ++j) vecs[(o * s + i) * s + j] = finite ? V[IX(i, j)] : nan;
#undef IX
}

// ---------------------------------------------------------------------------
// Large bases: nd_ldl (one CTA per trial) and nd_ksolve (one CTA per
// (trial, dimension)); one thread per row or column, s <= 119 < 128
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(LARGE_THREADS)
nd_ldl_kernel(const double* __restrict__ ms, const int* __restrict__ ig,
              double* __restrict__ Lu, double* __restrict__ piv_out,
              double* __restrict__ c_out, double* __restrict__ isc_out, int s, int z) {
    extern __shared__ double smem[];
    const int ld = s | 1;
    double* A = smem;         // s x ld: G' on and below the diagonal, then L below it
    double* cv = A + s * ld;  // c
    double* piv = cv + s;     // guarded pivots
    double* isc = piv + s;    // 1/scale
    double* dsh = isc + s;    // the current column's raw pivot
    const int b = blockIdx.x, t = threadIdx.x;
    const double* mv = ms + (size_t)b * z;
    const int ss = s * s;

    // c_j = 1/sqrt(G_jj) (_nd_cvec_kernel), then G'_ij = (c_i G_ij) c_j, i >= j
    if (t < s) {
        double g = mv[ig[t * s + t]];
        if (g <= 1e-30) g = 1.0;
        cv[t] = 1.0 / sqrt(g);
    }
    __syncthreads();
    for (int e = t; e < ss; e += LARGE_THREADS) {
        const int i = e / s, j = e - i * s;
        if (j <= i) A[i * ld + j] = (cv[i] * mv[ig[e]]) * cv[j];
    }
    __syncthreads();

    // left-looking LDL^T (_nd_ldl_kernel / _nd_ldl_panel_kernel), thread = row
    const double pivot_diag = 1e-8 * s;
    for (int j = 0; j < s; ++j) {
        double acc = 0.0;
        if (t >= j && t < s) {
            acc = A[t * ld + j];
            for (int k = 0; k < j; ++k) acc -= A[t * ld + k] * (piv[k] * A[j * ld + k]);
            if (t == j) *dsh = acc;
        }
        __syncthreads();
        const double dj_raw = *dsh;
        const double dj = guard_pivot(dj_raw);
        if (t > j && t < s) A[t * ld + j] = acc / dj;
        if (t == j) {
            piv[j] = dj;
            isc[j] = 1.0 / (dj_raw <= 0.0 ? pivot_diag : sqrt(dj));
        }
        __syncthreads();
    }

    double* lo = Lu + (size_t)b * ss;
    for (int e = t; e < ss; e += LARGE_THREADS) {
        const int i = e / s, j = e - i * s;
        lo[e] = j < i ? A[i * ld + j] : (i == j ? 1.0 : 0.0);
    }
    if (t < s) {
        piv_out[(size_t)b * s + t] = piv[t];
        c_out[(size_t)b * s + t] = cv[t];
        isc_out[(size_t)b * s + t] = isc[t];
    }
}

__global__ void __launch_bounds__(LARGE_THREADS)
nd_ksolve_kernel(const double* __restrict__ ms, const int* __restrict__ inds,
                 const double* __restrict__ Lu, const double* __restrict__ cvec,
                 const double* __restrict__ isc_in, double* __restrict__ K,
                 int d, int s, int z) {
    extern __shared__ double smem[];
    const int ld = s | 1;
    double* L = smem;         // s x ld
    double* W = L + s * ld;   // s x ld: H'_m, then Lu^{-1} H'_m, then W Lu^{-T}
    double* cv = W + s * ld;
    double* isc = cv + s;
    const int b = blockIdx.x, m = blockIdx.y, t = threadIdx.x;
    const int ss = s * s;
    const double* mv = ms + (size_t)b * z;
    const int* ih = inds + (size_t)(m + 1) * ss;
    const double* lb = Lu + (size_t)b * ss;

    if (t < s) {
        cv[t] = cvec[(size_t)b * s + t];
        isc[t] = isc_in[(size_t)b * s + t];
    }
    for (int e = t; e < ss; e += LARGE_THREADS) {
        const int i = e / s;
        L[i * ld + e - i * s] = lb[e];
    }
    __syncthreads();
    for (int e = t; e < ss; e += LARGE_THREADS) {
        const int i = e / s, j = e - i * s;
        W[i * ld + j] = (cv[i] * mv[ih[e]]) * cv[j];
    }
    __syncthreads();
    // W = Lu^{-1} H' (_nd_fsolve_kernel): thread = column, axpy order
    if (t < s)
        for (int k = 0; k < s - 1; ++k) {
            const double xk = W[k * ld + t];
            for (int i = k + 1; i < s; ++i) W[i * ld + t] -= L[i * ld + k] * xk;
        }
    __syncthreads();
    // Y = W Lu^{-T} (_nd_tsolve_kernel): thread = row of W, in place
    if (t < s) {
        double* row = W + t * ld;
        for (int k = 0; k < s - 1; ++k) {
            const double yk = row[k];
            for (int j = k + 1; j < s; ++j) row[j] -= L[j * ld + k] * yk;
        }
    }
    __syncthreads();
    // K_m[i, j] = 0.5 (Y_ij/scale_i/scale_j + Y_ji/scale_j/scale_i), coalesced rows;
    // the products and the sum are rounded apart (no FMA), so K_m is exactly
    // symmetric, as the plain version's 0.5 (K + K^T) is
    double* out = K + ((size_t)b * d + m) * ss;
    for (int e = t; e < ss; e += LARGE_THREADS) {
        const int i = e / s, j = e - i * s;
        const double kij = __dmul_rn(W[i * ld + j] * isc[i], isc[j]);
        const double kji = __dmul_rn(W[j * ld + i] * isc[j], isc[i]);
        out[e] = 0.5 * __dadd_rn(kij, kji);
    }
}

// Launch on `stream`; each returns the CUDA error code (0 on success).
extern "C" int mfs_nd_eigh(const double* ms, const int* inds, double* vals, double* vecs,
                           int d, int s, int z, int B, void* stream) {
    if (s < 1 || s > MAXS_EIGH || d < 1 || d > 3) return (int)cudaErrorInvalidValue;
    if (B <= 0) return 0;
    const int blocks = (B * d + EIGH_THREADS - 1) / EIGH_THREADS;
    nd_eigh_kernel<<<blocks, EIGH_THREADS, 0, (cudaStream_t)stream>>>(
        ms, inds, vals, vecs, d, s, z, B);
    return (int)cudaGetLastError();
}

static size_t ldl_smem(int s) { return ((size_t)s * (s | 1) + 3 * (size_t)s + 1) * sizeof(double); }
static size_t ksolve_smem(int s) { return (2 * (size_t)s * (s | 1) + 2 * (size_t)s) * sizeof(double); }

extern "C" int mfs_nd_ldl(const double* ms, const int* inds, double* Lu, double* piv, double* c,
                          double* isc, int s, int z, int B, void* stream) {
    if (s < 1 || s > MAXS_LARGE) return (int)cudaErrorInvalidValue;
    if (B <= 0) return 0;
    const size_t smem = ldl_smem(s);
    cudaError_t err = cudaFuncSetAttribute(nd_ldl_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    nd_ldl_kernel<<<B, LARGE_THREADS, smem, (cudaStream_t)stream>>>(ms, inds, Lu, piv, c, isc, s, z);
    return (int)cudaGetLastError();
}

extern "C" int mfs_nd_ksolve(const double* ms, const int* inds, const double* Lu, const double* c,
                             const double* isc, double* K, int d, int s, int z, int B,
                             void* stream) {
    if (s < 1 || s > MAXS_LARGE || d < 1 || d > 3) return (int)cudaErrorInvalidValue;
    if (B <= 0) return 0;
    const size_t smem = ksolve_smem(s);
    cudaError_t err = cudaFuncSetAttribute(nd_ksolve_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    nd_ksolve_kernel<<<dim3(B, d), LARGE_THREADS, smem, (cudaStream_t)stream>>>(
        ms, inds, Lu, c, isc, K, d, s, z);
    return (int)cudaGetLastError();
}
