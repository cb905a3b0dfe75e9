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
//   2. LDL^T of G' with true pivots (entry (i, j) gets its updates
//      L_ik (d_k L_jk) in the order k = 0, 1, ...); a pivot <= 0 gets
//      the completion diagonal 1e-8*s in R = Lu diag(scale); a pivot below
//      1e-35 in magnitude is replaced by a signed 1e-35 before dividing;
//   3. K_m = R^{-1} H'_m R^{-T}, H'_m = (c_i H_ij) c_j, by two triangular
//      solves, symmetrised 0.5 (K + K^T).
//      nd_ksolve: two unit solves W = Lu^{-1} H', Y = W Lu^{-T}, then
//          K_ij = (Y_ij / scale_i) / scale_j (as _nd_k_kernel);
//      K2: each solve divides by scale[r] inside the recursion (as _nd_kernel).
//   4. K2 only: cyclic Jacobi in f64 from V = I, in the round-robin order of
//      mfs_tpu/ops/eigh.py::_round_robin_schedule (circle method; per round
//      all angles, then all column updates, then all row updates and V),
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
// - K2, s <= 10, d <= 3: one CTA per EIGH_TRIALS trials, one warp per
//   (trial, dimension).  c, the pivots, scale and Lu of each trial and A, V
//   of each dimension live in shared memory (odd row stride), under 14 KB a
//   CTA, so ~2,000 warps are in flight at B = 1022, d = 2.  The warps gather
//   G and their H_m together; the trial's first warp factors the LDL once,
//   lanes over rows; after one __syncthreads each warp runs the two scaled
//   solves (lanes over columns) and its own Jacobi (jacobi_cyclic): the <= 5
//   disjoint pairs of a round get their angles on <= 5 lanes, and each
//   update phase spreads its (pair, index) items over the 32 lanes, with
//   __syncwarp between phases; the masses are warp-shuffle sums.  Bound:
//   FP64 operations outside the tensor cores (the 2x2 rotations;
//   chip_smoke.py::k2_flops), not bytes.  The kernel stays latency-bound:
//   each round's angles are a chain of three f64 divisions and two square
//   roots, each a multi-instruction sequence, and a round has three phases.
// - nd_ldl + nd_ksolve, s <= 119, in two launches.  nd_ldl: one CTA of
//   LDL_THREADS per trial; the z moments arrive by asynchronous copies and
//   G' is gathered from them into a column-major packed lower triangle in
//   shared memory, so that the entries still to be updated at column k,
//   those of columns k + 1 .. s - 1, are one contiguous range.  The LDL is
//   right-looking: per column k every thread forms the next pivot from its
//   last update (the same bits everywhere), and one pass spread flat over
//   the CTA's threads gives each entry of that range A_ij -= L_ik v_j,
//   with v_j = d_k L_jk formed once; column k + 1's entries are divided by
//   the pivot in the same pass.  No thread runs a serial dot product, each
//   thread has several independent updates in flight, and one barrier a
//   column is left.  It writes Lu (B, s, s) dense, the guarded pivots, c
//   and 1/scale.  Bound: bytes (the Lu write; chip_smoke.py::ldl_flops at
//   the tensor-core rate is below it); the rest is the chain of s
//   barriers, each behind a division, and the updates' issue.  Shared
//   memory (ldl_smem): s(s+1)/2 doubles and 16-bit entry codes, the z
//   moments and five s-vectors: 26,774 bytes at s = 66 (z = 253), so 8
//   CTAs an SM hold B = 1024 in one wave; 6,020 bytes at s = 28; 79,880
//   bytes at s = 119 (z = 465).  At s = 28 (B ~ 906) registers cap an SM
//   at 10 CTAs (48 a thread), so the batch is one wave of ~7 CTAs (28
//   warps) an SM; the range of column k's pass falls below 128 entries
//   from k = 12 on, so the 27 passes take 43 rounds of 128 threads for
//   3,627 updates: 66% of the thread slots are busy (92% at s = 66).
//   Several trials a CTA at s <= 32 would fill them.  nd_ksolve: one CTA per
//   trial; Lu is read from HBM once, by asynchronous copies, into shared
//   memory and serves the d dimensions, taken `g` at a time side by side
//   (ksolve_config), each H_m gathered by asynchronous copies too.  Both
//   solves are X <- Lu^{-1} X on sp x sp tiles (s padded to a multiple of 8
//   with zeros; pads never reach K): X = H'_m, then X = W^T read and written
//   through transposed strides (Y^T = Lu^{-1} W^T), so W's buffer ends up
//   holding Y.  Columns of a triangular solve are independent, so each warp
//   owns an 8-column strip and needs no CTA barrier inside a solve.  Per
//   8-row panel the FP64 tensor cores (mma.sync m8n8k4 .f64) form
//   L[panel, :8p] X[:8p], and then apply the inverse of the unit 8 x 8
//   diagonal block (inverted once per trial, kept in the block's unused
//   upper half): no serial step is left inside a panel.  Bound: bytes (Lu
//   and the moments read once, K written once), and the 67 TFLOP/s FP64
//   tensor-core rate for the operations (chip_smoke.py::ksolve_flops).
// nvcc contracts a*b+c to FMA, which the plain PyTorch versions do not: the
// two differ in the last bits.
#include <cuda_runtime.h>

#define MAXS_EIGH 10
#define EIGH_LD (MAXS_EIGH + 1)  // odd row stride of K2's matrices
#define EIGH_MAT (MAXS_EIGH * EIGH_LD)
#define EIGH_TRIALS 2            // trials per K2 CTA
#define LDL_THREADS 128
#define MAXS_LARGE 119
#define KSOLVE_MAX_WARPS 16      // nd_ksolve CTAs of <= 512 threads, two an SM: <= 64 registers
#define SMEM_LIMIT 232448        // dynamic shared memory a block may opt in to
#define SMEM_PER_SM 233472       // shared memory of an SM, 1 KB of it reserved per CTA
#define KSOLVE_CTAS_PER_SM 2     // CTAs whose shared memory nd_ksolve keeps room for
#define MAX_SWEEPS 20
#define JACOBI_TOL2 1e-28
#define FULL_MASK 0xffffffffu

__device__ __forceinline__ double guard_pivot(double dj) {
    if (fabs(dj) < 1e-35) dj = dj < 0.0 ? -1e-35 : 1e-35;
    return dj;
}

// ---------------------------------------------------------------------------
// Cyclic Jacobi on a symmetric matrix in shared memory, run by a team of
// threads (here a warp; a later CTA-wide team needs only sync() and sum()).
// ---------------------------------------------------------------------------

struct WarpTeam {
    int rank;  // lane
    __device__ static constexpr int size() { return 32; }
    __device__ void sync() const { __syncwarp(); }
    // Butterfly sum: every lane adds the same two operands at each level
    // (in either order, which IEEE addition does not see), so all lanes end
    // with the same bits and take the same branch on it.
    __device__ double sum(double v) const {
        for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
        return v;
    }
};

// Player at position `pos` of round `round` (< m2 - 1) of the circle
// method on m2 players: position 0 stays, positions 1..m2-1 rotate right
// once a round (mfs_tpu/ops/eigh.py::_round_robin_schedule).
__device__ __forceinline__ int rr_player(int pos, int round, int m2) {
    if (pos == 0) return 0;
    const int x = pos - 1 - round;
    return 1 + (x < 0 ? x + m2 - 1 : x);
}

// A (s x s, s <= MAXS, row stride LD) is diagonalised in place and V
// (same layout) receives the eigenvectors in its columns, from V = I.  Per
// round: all angles, then all column updates, then all row updates and
// the V updates (disjoint elements, one pass); each sweep starts with the
// test off <= (1e-14)^2 tot, at most MAX_SWEEPS sweeps.  Scratch: `rot` 2 (MAXS/2 + 1) doubles, `pq` as many
// ints.  Each thread's (pair slot, index) items of a phase and its
// elements of the masses are fixed for the whole run, so they are
// decomposed once.  Every element update is the serial loop's
// arithmetic; only the masses' order differs.
template <int LD, int MAXS, class Team>
__device__ void jacobi_cyclic(double* A, double* V, double* rot, int* pq, int s,
                              const Team& team) {
    constexpr int NT = Team::size();
    constexpr int IP = ((MAXS + 1) / 2 * MAXS + NT - 1) / NT;  // passes of a phase
    constexpr int MP = (MAXS * MAXS + NT - 1) / NT;            // passes of the masses
    const int m2 = s + (s & 1), half = m2 / 2, ss = s * s;
    int ik[IP], ii[IP], mo[MP];
    bool md[MP];
#pragma unroll
    for (int u = 0; u < IP; ++u) {
        const int e = team.rank + u * NT;
        ik[u] = e < half * s ? e / s : -1;
        ii[u] = e - max(ik[u], 0) * s;
    }
#pragma unroll
    for (int u = 0; u < MP; ++u) {
        const int e = team.rank + u * NT, i = e / s, j = e - i * s;
        mo[u] = e < ss ? i * LD + j : -1;
        md[u] = i == j;
        if (e < ss) V[mo[u]] = md[u] ? 1.0 : 0.0;
    }
    team.sync();
    double* cr = rot;
    double* sr = rot + half;
    int* P = pq;
    int* Q = pq + half;
    for (int sw = 0; sw < MAX_SWEEPS; ++sw) {
        double off = 0.0, tot = 0.0;
#pragma unroll
        for (int u = 0; u < MP; ++u)
            if (mo[u] >= 0) {
                const double q = A[mo[u]] * A[mo[u]];
                tot += q;
                if (!md[u]) off += q;
            }
        off = team.sum(off);
        tot = team.sum(tot);
        if (!(off > JACOBI_TOL2 * tot)) break;
        for (int round = 0; round < m2 - 1; ++round) {
            for (int k = team.rank; k < half; k += NT) {
                const int a = rr_player(k, round, m2), b = rr_player(m2 - 1 - k, round, m2);
                const int p = min(a, b), q = max(a, b);
                P[k] = p;
                Q[k] = q;  // q == s: the virtual index, no rotation
                if (q >= s) continue;
                const double app = A[p * LD + p], aqq = A[q * LD + q], apq = A[p * LD + q];
                double tr = 0.0;
                if (apq != 0.0) {
                    const double tau = (aqq - app) / (2.0 * apq);
                    tr = (tau >= 0.0 ? 1.0 : -1.0) / (fabs(tau) + sqrt(1.0 + tau * tau));
                }
                cr[k] = 1.0 / sqrt(1.0 + tr * tr);
                sr[k] = tr * cr[k];
            }
            team.sync();
#pragma unroll
            for (int u = 0; u < IP; ++u) {
                const int k = ik[u], i = ii[u];
                if (k < 0 || Q[k] >= s) continue;
                const int p = P[k], q = Q[k];
                const double aip = A[i * LD + p], aiq = A[i * LD + q];
                A[i * LD + p] = cr[k] * aip - sr[k] * aiq;
                A[i * LD + q] = sr[k] * aip + cr[k] * aiq;
            }
            team.sync();
#pragma unroll
            for (int u = 0; u < IP; ++u) {
                const int k = ik[u], j = ii[u];
                if (k < 0 || Q[k] >= s) continue;
                const int p = P[k], q = Q[k];
                const double apj = A[p * LD + j], aqj = A[q * LD + j];
                A[p * LD + j] = cr[k] * apj - sr[k] * aqj;
                A[q * LD + j] = sr[k] * apj + cr[k] * aqj;
                // V's columns p, q: no element the row updates touch, so
                // one pass gives the serial order's results
                const double vjp = V[j * LD + p], vjq = V[j * LD + q];
                V[j * LD + p] = cr[k] * vjp - sr[k] * vjq;
                V[j * LD + q] = sr[k] * vjp + cr[k] * vjq;
            }
            team.sync();  // the next round's angles overwrite cr, sr, P, Q
        }
    }
}

// ---------------------------------------------------------------------------
// K2: equilibrated LDL, scaled solves, cyclic Jacobi
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(EIGH_TRIALS * 3 * 32)
nd_eigh_kernel(const double* __restrict__ ms, const int* __restrict__ inds,
               double* __restrict__ vals, double* __restrict__ vecs,
               int d, int s, int z, int B) {
    __shared__ double c_sh[EIGH_TRIALS][MAXS_EIGH], scale_sh[EIGH_TRIALS][MAXS_EIGH];
    __shared__ double piv_sh[EIGH_TRIALS][MAXS_EIGH], L_sh[EIGH_TRIALS][EIGH_MAT];
    __shared__ double A_sh[EIGH_TRIALS * 3][EIGH_MAT], V_sh[EIGH_TRIALS * 3][EIGH_MAT];
    __shared__ double rot_sh[EIGH_TRIALS * 3][MAXS_EIGH + 2];
    __shared__ int pq_sh[EIGH_TRIALS * 3][MAXS_EIGH + 2];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int slot = warp / d, m = warp - slot * d;
    const int b = blockIdx.x * EIGH_TRIALS + slot;
    const bool live = b < B;
    const double* mv = ms + (size_t)b * z;
    const int* ig = inds;
    double* c = c_sh[slot];
    double* scale = scale_sh[slot];
    double* piv = piv_sh[slot];
    double* L = L_sh[slot];
#define IX(i, j) ((i) * EIGH_LD + (j))

    // ---- gather: every warp its raw H_m into A, the first warp G into L;
    // the loads of a warp are independent and in flight together ----------
    const int ss = s * s;
    const int* ih = inds + (size_t)(1 + m) * ss;
    double* A = A_sh[warp];
    double* X = V_sh[warp];
    if (live) {
#pragma unroll
        for (int u = 0; u < (MAXS_EIGH * MAXS_EIGH + 31) / 32; ++u) {
            const int e = lane + 32 * u, i = e / s, j = e - i * s;
            if (e < ss) {
                A[IX(i, j)] = mv[ih[e]];
                if (m == 0) L[IX(i, j)] = mv[ig[e]];
            }
        }
    }
    __syncwarp();

    // ---- the trial's first warp: c and the LDL^T of G', lanes over rows,
    // L overwriting G' column by column -----------------------------------
    if (live && m == 0) {
        if (lane < s) {
            double g = L[IX(lane, lane)];
            if (g <= 1e-30) g = 1.0;
            c[lane] = 1.0 / sqrt(g);
        }
        __syncwarp();
        const double pivot_diag = 1e-8 * s;
        for (int j = 0; j < s; ++j) {
            double a = 0.0;
            if (lane >= j && lane < s) {
                a = (c[lane] * L[IX(lane, j)]) * c[j];
                for (int k = 0; k < j; ++k) a -= L[IX(lane, k)] * (piv[k] * L[IX(j, k)]);
            }
            const double aj = __shfl_sync(FULL_MASK, a, j);
            const double dj = guard_pivot(aj);
            if (lane == j) {
                scale[j] = aj <= 0.0 ? pivot_diag : sqrt(dj);
                piv[j] = dj;
            }
            if (lane > j && lane < s) L[IX(lane, j)] = a / dj;
            __syncwarp();
        }
    }
    __syncthreads();
    if (!live) return;

    // ---- K = R^{-1} H' R^{-T}, lanes over columns, scale[r] divided inside
    // each recursion; X (in V's buffer) = R^{-1} H', then A = R^{-1} X^T --
    if (lane < s)
        for (int r = 0; r < s; ++r) {
            double a = (c[r] * A[IX(r, lane)]) * c[lane];
            for (int k = 0; k < r; ++k) a -= L[IX(r, k)] * (scale[k] * X[IX(k, lane)]);
            X[IX(r, lane)] = a / scale[r];
        }
    __syncwarp();
    if (lane < s)
        for (int r = 0; r < s; ++r) {
            double a = X[IX(lane, r)];
            for (int k = 0; k < r; ++k) a -= L[IX(r, k)] * (scale[k] * A[IX(k, lane)]);
            A[IX(r, lane)] = a / scale[r];
        }
    __syncwarp();
    bool fin = true;
    for (int e = lane; e < ss; e += 32) {
        const int i = e / s, j = e - i * s;
        if (i < j) {
            const double avg = 0.5 * (A[IX(i, j)] + A[IX(j, i)]);
            A[IX(i, j)] = avg;
            A[IX(j, i)] = avg;
            fin = fin && isfinite(avg);
        } else if (i == j) {
            fin = fin && isfinite(A[IX(i, i)]);
        }
    }
    // a trial whose K is not finite skips the Jacobi stage and comes out NaN
    const bool finite = __all_sync(FULL_MASK, fin);
    __syncwarp();
    if (finite)
        jacobi_cyclic<EIGH_LD, MAXS_EIGH>(A, X, rot_sh[warp], pq_sh[warp], s, WarpTeam{lane});

    const size_t o = (size_t)b * d + m;
    const double nan = __longlong_as_double(0x7ff8000000000000LL);
    if (lane < s) vals[o * s + lane] = finite ? A[IX(lane, lane)] : nan;
    for (int e = lane; e < ss; e += 32) {
        const int i = e / s, j = e - i * s;
        vecs[o * ss + e] = finite ? X[IX(i, j)] : nan;
    }
#undef IX
}

// ---------------------------------------------------------------------------
// Large bases: nd_ldl (one CTA per trial, right-looking, updates over the
// CTA) and nd_ksolve (one CTA per trial, one warp per 8-column strip)
// ---------------------------------------------------------------------------

// 8-byte asynchronous copy global -> shared; zero-fills when !valid.
__device__ __forceinline__ void cp_async8(double* dst, const double* src, bool valid) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;"
                 :: "r"(d), "l"(src), "r"(valid ? 8 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;" ::: "memory");
}

// Column j of a column-major packed lower triangle of order s starts at
// col_start(j, s); its entry (i, j), i >= j, sits at col_start(j, s) + i - j.
__host__ __device__ __forceinline__ int col_start(int j, int s) { return j * s - j * (j - 1) / 2; }

__global__ void __launch_bounds__(LDL_THREADS)
nd_ldl_kernel(const double* __restrict__ ms, const int* __restrict__ ig,
              double* __restrict__ Lu, double* __restrict__ piv_out,
              double* __restrict__ c_out, double* __restrict__ isc_out, int s, int z) {
    extern __shared__ double smem[];
    const int ne = col_start(s, s);  // s (s + 1) / 2 entries
    double* P = smem;          // G' on and below the diagonal, then L below it
    double* mv = P + ne;       // the trial's z moments
    double* cv = mv + z;       // c
    double* va = cv + s;       // v_i = d_k L_ik of column k, k even
    double* vb = va + s;       // ... k odd
    double* piv = vb + s;      // guarded pivots
    double* isc = piv + s;     // 1/scale
    unsigned short* code = (unsigned short*)(isc + s);  // entry e's (i << 7) | j
    constexpr int NW = LDL_THREADS / 32;
    const int b = blockIdx.x, t = threadIdx.x, warp = t >> 5, lane = t & 31;
    const double* mg = ms + (size_t)b * z;
    for (int e = t; e < z; e += LDL_THREADS) cp_async8(mv + e, mg + e, true);
    cp_async_wait_all();
    __syncthreads();

    // c_j = 1/sqrt(G_jj) (_nd_cvec_kernel), then G'_ij = (c_i G_ij) c_j, i >= j
    if (t < s) {
        double g = mv[ig[t * s + t]];
        if (g <= 1e-30) g = 1.0;
        cv[t] = 1.0 / sqrt(g);
    }
    __syncthreads();
    for (int j = warp; j < s; j += NW)
        for (int i = j + lane; i < s; i += 32) {
            const int e = col_start(j, s) + i - j;
            P[e] = (cv[i] * mv[ig[i * s + j]]) * cv[j];
            code[e] = (unsigned short)(i << 7 | j);
        }
    __syncthreads();

    // Right-looking true-pivot LDL^T (_nd_ldl_kernel / _nd_ldl_panel_kernel).
    // Column 0's division, then per column k one pass over the entries of
    // columns k + 1 .. s - 1, a contiguous range, spread flat over the CTA:
    // every thread forms the next pivot (the same bits everywhere), each
    // entry gets A_ij -= L_ik v_j, and column k + 1's entries are divided
    // by the pivot and form v_i = d L_i,k+1 once.  One barrier a column.
    const double pivot_diag = 1e-8 * s;
    {
        const double d_raw = P[0], d0 = guard_pivot(d_raw);
        if (t == 0) {
            piv[0] = d0;
            isc[0] = 1.0 / (d_raw <= 0.0 ? pivot_diag : sqrt(d0));
        }
        for (int i = 1 + t; i < s; i += LDL_THREADS) {
            const double l = P[i] / d0;
            P[i] = l;
            va[i] = d0 * l;
        }
    }
    __syncthreads();
    for (int k = 0; k + 1 < s; ++k) {
        const double* vk = k & 1 ? vb : va;
        double* vn = k & 1 ? va : vb;
        const double* Lk = P + col_start(k, s) - k;  // Lk[i] = L_ik
        const int o1 = col_start(k + 1, s);
        const double d_raw = P[o1] - Lk[k + 1] * vk[k + 1];
        const double dn = guard_pivot(d_raw);
        if (t == 0) {
            piv[k + 1] = dn;
            isc[k + 1] = 1.0 / (d_raw <= 0.0 ? pivot_diag : sqrt(dn));
        }
#pragma unroll 4
        for (int e = o1 + 1 + t; e < ne; e += LDL_THREADS) {
            const int ij = code[e], i = ij >> 7, j = ij & 127;
            const double a = P[e] - Lk[i] * vk[j];
            if (j == k + 1) {
                const double l = a / dn;
                P[e] = l;
                vn[i] = dn * l;
            } else {
                P[e] = a;
            }
        }
        __syncthreads();
    }

    double* lo = Lu + (size_t)b * s * s;
    for (int i = warp; i < s; i += NW)
        for (int j = lane; j < s; j += 32)
            lo[i * s + j] = j < i ? P[col_start(j, s) + i - j] : (i == j ? 1.0 : 0.0);
    if (t < s) {
        piv_out[(size_t)b * s + t] = piv[t];
        c_out[(size_t)b * s + t] = cv[t];
        isc_out[(size_t)b * s + t] = isc[t];
    }
}

// D += A B for one 8x8 tile and one k-step of 4, on the FP64 tensor cores.
// Lane (g = lane/4, t = lane%4) holds A[g][t], B[t][g] and D[g][2t], D[g][2t+1].
__device__ __forceinline__ void mma_f64(double& d0, double& d1, double a, double b) {
    asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};"
        : "+d"(d0), "+d"(d1) : "d"(a), "d"(b));
}

// X <- Lu^{-1} X for `nmat` matrices X (sp x sp each, one after the other
// at sp * ld in W), sp a multiple of 8.  L holds Lu's strictly lower part
// (zero pads) and, in each 8 x 8 diagonal block, 1 on the diagonal and the
// block's inverse transposed above it (invert_diagonal_blocks).  TRANS: X
// is the transpose of what W holds, and the result is stored transposed
// too.  SCALE: X is scaled to (c_i X_ij) c_j as each element is first
// read.  Each warp owns 8-column strips of X.  Per 8-row panel p, on the
// tensor cores: T = X[panel] - L[panel, :8p] X[:8p] (lane (g, t) holds
// row g, columns 2t and 2t+1 of the 8 x 8 tile), then X[panel] =
// L[panel, panel]^{-1} T.  A strip reads and writes only itself.
template <bool TRANS, bool SCALE>
__device__ void unit_lower_solve(const double* L, double* W, const double* cv, int sp,
                                 int ld, int nmat, int warp, int nwarps, int lane) {
    const int g = lane >> 2, t = lane & 3, np = sp >> 3;
    const int rs = TRANS ? 1 : ld, cs = TRANS ? ld : 1;  // X[r][c] at r * rs + c * cs
    for (int strip = warp; strip < nmat * np; strip += nwarps) {
        const int mat = strip / np, n0 = (strip - mat * np) * 8;
        double* X = W + (size_t)mat * sp * ld + n0 * cs;
        for (int p = 0; p < np; ++p) {
            const int r = 8 * p + g;
            const double* Lr = L + r * ld;
            const double* Bg = X + g * cs;  // B fragments: X[k + t][g]
            double* x0 = X + r * rs + 2 * t * cs;
            double* x1 = x0 + cs;
            // the diagonal block's inverse as A fragments: Linv[g][kk + t]
            double inv[2];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int kk = 4 * h + t;
                inv[h] = g >= kk ? L[(8 * p + kk) * ld + 8 * p + g] : 0.0;
            }
            double c0 = SCALE ? (cv[r] * *x0) * cv[n0 + 2 * t] : *x0;
            double c1 = SCALE ? (cv[r] * *x1) * cv[n0 + 2 * t + 1] : *x1;
            double a0 = 0.0, a1 = 0.0;
            if (p > 0) {
                double a = Lr[t], bb = Bg[t * rs];
                for (int k = 4; k < 8 * p; k += 4) {
                    const double an = Lr[k + t], bn = Bg[(k + t) * rs];
                    mma_f64(a0, a1, a, bb);
                    a = an;
                    bb = bn;
                }
                mma_f64(a0, a1, a, bb);
            }
            *x0 = c0 - a0;
            *x1 = c1 - a1;
            __syncwarp();
            double e0 = 0.0, e1 = 0.0;
#pragma unroll
            for (int h = 0; h < 2; ++h)
                mma_f64(e0, e1, inv[h], Bg[(8 * p + 4 * h + t) * rs]);
            __syncwarp();  // every lane has read the tile
            *x0 = e0;
            *x1 = e1;
            __syncwarp();  // the next panel reads these rows as B
        }
    }
}

// In each 8 x 8 diagonal block of L (unit lower, strictly lower part
// stored), put 1 on the diagonal and the block's inverse, transposed,
// in the strictly upper part: lane c < 8 of a warp solves for column c.
__device__ void invert_diagonal_blocks(double* L, int sp, int ld, int warp, int nwarps,
                                       int lane) {
    for (int p = warp; p < sp / 8; p += nwarps) {
        double* Lb = L + 8 * p * ld + 8 * p;
        double x[8];
        if (lane < 8) {
#pragma unroll
            for (int i = 0; i < 8; ++i) x[i] = i == lane ? 1.0 : 0.0;
#pragma unroll
            for (int k = 0; k < 7; ++k)
#pragma unroll
                for (int i = k + 1; i < 8; ++i)
                    if (k >= lane) x[i] -= Lb[i * ld + k] * x[k];
        }
        __syncwarp();
        if (lane < 8) {
#pragma unroll
            for (int i = 0; i < 8; ++i)
                if (i >= lane) Lb[lane * ld + i] = x[i];
        }
    }
}

// Loops below run rows over warps and columns over lanes, so no thread
// divides an element index.
__global__ void __launch_bounds__(KSOLVE_MAX_WARPS * 32, KSOLVE_CTAS_PER_SM)
nd_ksolve_kernel(const double* __restrict__ ms, const int* __restrict__ inds,
                 const double* __restrict__ Lu, const double* __restrict__ cvec,
                 const double* __restrict__ isc_in, double* __restrict__ K,
                 int d, int s, int z, int sp, int ld, int g) {
    extern __shared__ double smem[];
    const size_t mat = (size_t)sp * ld;
    double* L = smem;         // sp x ld: Lu below the diagonal blocks' inverses, zero pads
    double* W = L + mat;      // g matrices sp x ld: H_m, W = Lu^{-1} H'_m, Y = W Lu^{-T}
    double* cv = W + g * mat;
    double* isc = cv + sp;
    const int b = blockIdx.x, tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31, nwarps = blockDim.x >> 5;
    const int ss = s * s;
    const double* mv = ms + (size_t)b * z;
    const double* lb = Lu + (size_t)b * ss;

    // Lu's strictly lower part, c and 1/scale by asynchronous copies (zeros
    // elsewhere), all in flight at once; sp <= 128 = 4 x 32 lanes
    for (int i = warp; i < sp; i += nwarps)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            const int j = lane + 32 * u;
            const bool ok = j < i && i < s;
            if (j < sp) cp_async8(L + i * ld + j, ok ? lb + i * s + j : lb, ok);
        }
    for (int e = tid; e < sp; e += blockDim.x) {
        const size_t o = (size_t)b * s + (e < s ? e : 0);
        cp_async8(cv + e, cvec + o, e < s);
        cp_async8(isc + e, isc_in + o, e < s);
    }
    for (int m0 = 0; m0 < d; m0 += g) {
        const int gm = min(g, d - m0), rows = gm * sp;
        // raw H_m by asynchronous gathers; each thread loads the indices of
        // four rows before it issues their copies
        for (int r0 = warp; r0 < rows; r0 += 4 * nwarps) {
            int idx[4][4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int r = r0 + q * nwarps, mm = r / sp, i = r - mm * sp;
                const int* ih = inds + (size_t)(m0 + mm + 1) * ss + i * s;
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    const int j = lane + 32 * u;
                    idx[q][u] = r < rows && i < s && j < s ? ih[j] : -1;
                }
            }
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int r = r0 + q * nwarps, mm = r / sp, i = r - mm * sp;
                double* row = W + mm * mat + i * ld;
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    const int j = lane + 32 * u;
                    if (r < rows && j < sp)
                        cp_async8(row + j, mv + max(idx[q][u], 0), idx[q][u] >= 0);
                }
            }
        }
        cp_async_wait_all();
        __syncthreads();
        if (m0 == 0) {
            invert_diagonal_blocks(L, sp, ld, warp, nwarps, lane);
            __syncthreads();
        }
        // W = Lu^{-1} H', H' = (c_i H_ij) c_j (_nd_fsolve_kernel)
        unit_lower_solve<false, true>(L, W, cv, sp, ld, gm, warp, nwarps, lane);
        __syncthreads();
        // Y^T = Lu^{-1} W^T, stored transposed: W's buffer ends up holding
        // Y = W Lu^{-T} (_nd_tsolve_kernel)
        unit_lower_solve<true, false>(L, W, cv, sp, ld, gm, warp, nwarps, lane);
        __syncthreads();
        // K_m[i, j] = 0.5 (Y_ij/scale_i/scale_j + Y_ji/scale_j/scale_i),
        // coalesced rows; the products and the sum are rounded apart (no
        // FMA), so K_m is exactly symmetric, as the plain version's
        // 0.5 (K + K^T) is
        for (int r = warp; r < gm * s; r += nwarps) {
            const int mm = r / s, i = r - mm * s;
            const double* Y = W + mm * mat;
            double* out = K + ((size_t)b * d + m0 + mm) * ss + i * s;
            for (int j = lane; j < s; j += 32) {
                const double kij = __dmul_rn(Y[i * ld + j] * isc[i], isc[j]);
                const double kji = __dmul_rn(Y[j * ld + i] * isc[j], isc[i]);
                out[j] = 0.5 * __dadd_rn(kij, kji);
            }
        }
        __syncthreads();  // the next group overwrites W
    }
}

// Launch on `stream`; each returns the CUDA error code (0 on success).
extern "C" int mfs_nd_eigh(const double* ms, const int* inds, double* vals, double* vecs,
                           int d, int s, int z, int B, void* stream) {
    if (s < 1 || s > MAXS_EIGH || d < 1 || d > 3) return (int)cudaErrorInvalidValue;
    if (B <= 0) return 0;
    const int blocks = (B + EIGH_TRIALS - 1) / EIGH_TRIALS;
    nd_eigh_kernel<<<blocks, EIGH_TRIALS * d * 32, 0, (cudaStream_t)stream>>>(
        ms, inds, vals, vecs, d, s, z, B);
    return (int)cudaGetLastError();
}

// nd_ldl's shared memory: the packed triangle, the moments, five
// s-vectors and the triangle's 16-bit entry codes.
static size_t ldl_smem(int s, int z) {
    const size_t ne = (size_t)col_start(s, s);
    return (ne + (size_t)z + 5 * (size_t)s) * sizeof(double) + ne * sizeof(unsigned short);
}

// nd_ksolve's layout for (s, d): s padded to sp (a multiple of 8); row
// stride ld = sp + 4 (== 4 or 12 mod 16 doubles: the tensor-core operand
// loads hit 16 distinct banks), or sp where that does not fit (sp = 120,
// s > 112: L and one W take 232,320 bytes); g dimensions side by side, the
// most that still leaves room for two CTAs on an SM (one CTA's loads and
// stores overlap the other's solves) and at most KSOLVE_MAX_WARPS strips.
struct KsolveConfig {
    int sp, ld, g, warps;
    size_t smem;
};

static size_t ksolve_bytes(int sp, int ld, int g) {
    return ((size_t)(1 + g) * sp * ld + 2 * (size_t)sp) * sizeof(double);
}

static KsolveConfig ksolve_config(int s, int d) {
    KsolveConfig c;
    c.sp = (s + 7) & ~7;
    c.ld = ksolve_bytes(c.sp, c.sp + 4, 1) <= SMEM_LIMIT ? c.sp + 4 : c.sp;
    const int np = c.sp / 8;
    c.g = 1;
    for (int g = d; g > 1; --g)
        if (ksolve_bytes(c.sp, c.ld, g) <= SMEM_PER_SM / KSOLVE_CTAS_PER_SM - 1024
            && g * np <= KSOLVE_MAX_WARPS) {
            c.g = g;
            break;
        }
    c.warps = min(c.g * np, KSOLVE_MAX_WARPS);
    c.smem = ksolve_bytes(c.sp, c.ld, c.g);
    return c;
}

extern "C" int mfs_nd_ldl(const double* ms, const int* inds, double* Lu, double* piv, double* c,
                          double* isc, int s, int z, int B, void* stream) {
    if (s < 1 || s > MAXS_LARGE) return (int)cudaErrorInvalidValue;
    if (B <= 0) return 0;
    const size_t smem = ldl_smem(s, z);
    if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(nd_ldl_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    nd_ldl_kernel<<<B, LDL_THREADS, smem, (cudaStream_t)stream>>>(ms, inds, Lu, piv, c, isc, s, z);
    return (int)cudaGetLastError();
}

extern "C" int mfs_nd_ksolve(const double* ms, const int* inds, const double* Lu, const double* c,
                             const double* isc, double* K, int d, int s, int z, int B,
                             void* stream) {
    if (s < 1 || s > MAXS_LARGE || d < 1 || d > 3) return (int)cudaErrorInvalidValue;
    if (B <= 0) return 0;
    const KsolveConfig cfg = ksolve_config(s, d);
    cudaError_t err = cudaFuncSetAttribute(nd_ksolve_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)cfg.smem);
    if (err != cudaSuccess) return (int)err;
    nd_ksolve_kernel<<<B, cfg.warps * 32, cfg.smem, (cudaStream_t)stream>>>(
        ms, inds, Lu, c, isc, K, d, s, z, cfg.sp, cfg.ld, cfg.g);
    return (int)cudaGetLastError();
}

// nd_ksolve's layout for (s, d) and the CTAs an SM holds at once:
// out = {sp, ld, g, warps, shared bytes, CTAs per SM}.
extern "C" int mfs_nd_ksolve_layout(int s, int d, int* out) {
    if (s < 1 || s > MAXS_LARGE || d < 1 || d > 3) return (int)cudaErrorInvalidValue;
    const KsolveConfig cfg = ksolve_config(s, d);
    cudaError_t err = cudaFuncSetAttribute(nd_ksolve_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)cfg.smem);
    if (err != cudaSuccess) return (int)err;
    int ctas = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, nd_ksolve_kernel, cfg.warps * 32,
                                                        cfg.smem);
    out[0] = cfg.sp, out[1] = cfg.ld, out[2] = cfg.g, out[3] = cfg.warps;
    out[4] = (int)cfg.smem, out[5] = ctas;
    return (int)err;
}
