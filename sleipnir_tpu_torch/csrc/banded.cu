// Block-tridiagonal factor and solve for Hopper (sm_90a), in native f64.
//
// Replaces the Pallas TPU kernels of sleipnir_tpu/ops/pallas_banded.py:
//   sleipnir_banded_factor  <- pallas_banded_factor (_factor_kernel)
//   sleipnir_banded_solve   <- pallas_banded_solve  (_solve_kernel)
// and, for long horizons, their chunked forms:
//   sleipnir_banded_factor  <- _pallas_factor_chunked (_factor_kernel_chunked)
//   sleipnir_banded_solve   <- _pallas_solve_chunked (the two chunked sweeps)
// The TPU chunks the stage grid because its scoped VMEM cannot hold a
// long horizon; these kernels read each stage's blocks from device memory
// inside their stage loop whatever K is, so one kernel serves every K.
// Offsets into the (B, K, ...) arrays are size_t: at B=4, K=5001, w=37 an
// array holds 27 million entries.
//
// The matrix is symmetric block tridiagonal: diagonal blocks D_k (K, w, w)
// and sub-diagonal blocks E_k (K-1, w, w), E_k = M[k+1, k]. The factor is
// the block-Thomas recursion
//     S_0 = D_0,   X_k = S_k^{-1} E_k^T,   S_{k+1} = D_{k+1} - E_k X_k,
// with each S_k stored as a row-pivoted LU (LAPACK packing, strict-lower
// unit L plus upper U) and its permutation as an index vector,
// (P S_k)[i] = S_k[perm[i]], plus the pivots d of the unpivoted LDL^T of
// S_k, whose signs give the inertia of the whole matrix (Sylvester).
//
// What bounds these kernels on the card: latency, not arithmetic or bytes.
// A factorization is K dependent stages of O(w) block-synchronised steps
// (about 1 MFLOP in all at K=101, w=13), and a solve is 2K dependent
// stages; neither comes near the card's f64 rate or its memory bandwidth.
// The design keeps every stage's working set (S_k, the LU, the LDL^T work
// copy, E_k, D_{k+1}, X_k) in shared memory, so the only device-memory
// traffic is one read of D and E and one write of the factor, and it
// takes its parallelism from the batch: one thread block per system in
// the factor (the regularization ladder factors its candidates in one
// launch), one per (system, right-hand side) in the solve. The TPU
// kernels' double-float arithmetic and one-hot permutations are not
// carried over: Hopper has native f64 and real row swaps. Making the
// per-stage steps cheaper (fewer barriers, warp-level elimination for
// small w) is left for later work.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxWidth = 37;
constexpr int kFactorThreads = 256;
constexpr int kSolveThreads = 64;

// First row r >= c holding the largest |A[r][c]| (LAPACK's idamax rule).
// Called by all 32 lanes of warp 0; every lane returns the same row.
__device__ int pivot_row(const double* A, int w, int c) {
  const int lane = threadIdx.x;
  double best = -1.0;
  int row = w;
  for (int r = c + lane; r < w; r += 32) {
    const double v = fabs(A[r * w + c]);
    if (v > best) {
      best = v;
      row = r;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const double other = __shfl_down_sync(0xffffffffu, best, off);
    const int other_row = __shfl_down_sync(0xffffffffu, row, off);
    if (other > best || (other == best && other_row < row)) {
      best = other;
      row = other_row;
    }
  }
  row = __shfl_sync(0xffffffffu, row, 0);
  return row < w ? row : c;  // an all-NaN column keeps its own row
}

__global__ void factor_kernel(const double* __restrict__ D,
                              const double* __restrict__ E,
                              double* __restrict__ LU,
                              int* __restrict__ perm,
                              double* __restrict__ dpiv,
                              double* __restrict__ X, int K, int w) {
  extern __shared__ double smem[];
  __shared__ int P[kMaxWidth];
  __shared__ int pivot_s;

  const int ww = w * w;
  double* S = smem;      // Schur complement S_k
  double* A = S + ww;    // LDL^T work copy, then the LU of S_k
  double* Y = A + ww;    // X_k under construction
  double* Ek = Y + ww;   // E_k
  double* Dn = Ek + ww;  // D_{k+1}

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const size_t sys = blockIdx.x;
  const double* Db = D + sys * K * ww;
  const double* Eb = E + sys * (K - 1) * ww;
  double* LUb = LU + sys * K * ww;
  int* Pb = perm + sys * K * w;
  double* db = dpiv + sys * K * w;
  double* Xb = X + sys * (K - 1) * ww;

  for (int i = tid; i < ww; i += nt) S[i] = Db[i];
  __syncthreads();

  for (int k = 0; k < K; ++k) {
    const bool coupled = k + 1 < K;
    for (int i = tid; i < ww; i += nt) {
      A[i] = S[i];
      if (coupled) {
        Ek[i] = Eb[(size_t)k * ww + i];
        Dn[i] = Db[(size_t)(k + 1) * ww + i];
      }
    }
    __syncthreads();

    // 1. Unpivoted LDL^T pivots of S_k (inertia only).
    for (int j = 0; j < w; ++j) {
      const double dj = A[j * w + j];
      const double dj_safe = dj == 0.0 ? 1.0 : dj;
      const int t = w - j - 1;
      for (int idx = tid; idx < t * t; idx += nt) {
        const int r = j + 1 + idx / t;
        const int c = j + 1 + idx % t;
        const double lr = A[r * w + j] / dj_safe;
        const double lc = A[c * w + j] / dj_safe;
        A[r * w + c] -= dj * (lr * lc);
      }
      if (tid == 0) db[(size_t)k * w + j] = dj;
      __syncthreads();
    }

    // 2. Row-pivoted LU of S_k.
    for (int i = tid; i < ww; i += nt) A[i] = S[i];
    if (tid < w) P[tid] = tid;
    __syncthreads();
    for (int c = 0; c < w; ++c) {
      if (tid < 32) {
        const int p = pivot_row(A, w, c);
        if (tid == 0) pivot_s = p;
      }
      __syncthreads();
      const int p = pivot_s;
      if (p != c) {
        for (int j = tid; j < w; j += nt) {
          const double a = A[c * w + j];
          A[c * w + j] = A[p * w + j];
          A[p * w + j] = a;
        }
        if (tid == 0) {
          const int q = P[c];
          P[c] = P[p];
          P[p] = q;
        }
      }
      __syncthreads();
      const double pivot = A[c * w + c];
      if (pivot != 0.0) {
        for (int r = c + 1 + tid; r < w; r += nt) A[r * w + c] /= pivot;
      }
      __syncthreads();
      const int t = w - c - 1;
      for (int idx = tid; idx < t * t; idx += nt) {
        const int r = c + 1 + idx / t;
        const int j = c + 1 + idx % t;
        A[r * w + j] -= A[r * w + c] * A[c * w + j];
      }
      __syncthreads();
    }
    for (int i = tid; i < ww; i += nt) LUb[(size_t)k * ww + i] = A[i];
    if (tid < w) Pb[(size_t)k * w + tid] = P[tid];
    if (!coupled) break;

    // 3. X_k = S_k^{-1} E_k^T: permute, unit-lower, then upper solve.
    for (int idx = tid; idx < ww; idx += nt) {
      const int i = idx / w;
      const int j = idx % w;
      Y[idx] = Ek[j * w + P[i]];
    }
    __syncthreads();
    for (int c = 0; c + 1 < w; ++c) {
      const int t = w - c - 1;
      for (int idx = tid; idx < t * w; idx += nt) {
        const int r = c + 1 + idx / w;
        const int j = idx % w;
        Y[r * w + j] -= A[r * w + c] * Y[c * w + j];
      }
      __syncthreads();
    }
    for (int c = w - 1; c >= 0; --c) {
      for (int j = tid; j < w; j += nt) Y[c * w + j] /= A[c * w + c];
      __syncthreads();
      for (int idx = tid; idx < c * w; idx += nt) {
        const int r = idx / w;
        const int j = idx % w;
        Y[r * w + j] -= A[r * w + c] * Y[c * w + j];
      }
      __syncthreads();
    }
    for (int i = tid; i < ww; i += nt) Xb[(size_t)k * ww + i] = Y[i];

    // 4. S_{k+1} = D_{k+1} - E_k X_k.
    for (int idx = tid; idx < ww; idx += nt) {
      const int i = idx / w;
      const int j = idx % w;
      double acc = 0.0;
      for (int l = 0; l < w; ++l) acc += Ek[i * w + l] * Y[l * w + j];
      S[idx] = Dn[idx] - acc;
    }
    __syncthreads();
  }
}

__global__ void solve_kernel(const double* __restrict__ LU,
                             const int* __restrict__ perm,
                             const double* __restrict__ X,
                             const double* __restrict__ b,
                             double* __restrict__ x, int K, int w, int r) {
  extern __shared__ double smem[];
  __shared__ int P[kMaxWidth];

  const int ww = w * w;
  double* A = smem;      // LU of S_k
  double* y = A + ww;    // running forward vector
  double* t = y + w;     // scratch
  double* xn = t + w;    // x_{k+1}

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const size_t sys = blockIdx.x;
  const int col = blockIdx.y;
  const double* LUb = LU + sys * K * ww;
  const int* Pb = perm + sys * K * w;
  const double* Xb = X + sys * (K - 1) * ww;
  // Entry i of stage k of this (system, column).
  auto at = [&](int k, int i) {
    return ((sys * K + k) * w + i) * r + col;
  };

  // Forward sweep: y_0 = b_0, y_{k+1} = b_{k+1} - X_k^T y_k; the y_k are
  // parked in x until the backward sweep overwrites them.
  if (tid < w) y[tid] = b[at(0, tid)];
  __syncthreads();
  for (int k = 0; k + 1 < K; ++k) {
    if (tid < w) {
      const double* Xk = Xb + (size_t)k * ww;
      double acc = 0.0;
      for (int l = 0; l < w; ++l) acc += Xk[l * w + tid] * y[l];
      x[at(k, tid)] = y[tid];
      t[tid] = b[at(k + 1, tid)] - acc;
    }
    __syncthreads();
    if (tid < w) y[tid] = t[tid];
    __syncthreads();
  }
  if (tid < w) x[at(K - 1, tid)] = y[tid];
  __syncthreads();

  // Backward sweep: x_k = S_k^{-1} y_k - X_k x_{k+1}.
  for (int k = K - 1; k >= 0; --k) {
    for (int i = tid; i < ww; i += nt) A[i] = LUb[(size_t)k * ww + i];
    if (tid < w) P[tid] = Pb[(size_t)k * w + tid];
    __syncthreads();
    if (tid < w) t[tid] = x[at(k, P[tid])];
    __syncthreads();
    for (int c = 0; c + 1 < w; ++c) {
      if (tid > c && tid < w) t[tid] -= A[tid * w + c] * t[c];
      __syncthreads();
    }
    for (int c = w - 1; c >= 0; --c) {
      // Every thread reads t[c] before any writes it; only thread c
      // writes it, after the barrier, and nothing reads it again.
      const double tc = t[c] / A[c * w + c];
      if (tid < c) t[tid] -= A[tid * w + c] * tc;
      __syncthreads();
      if (tid == c) t[c] = tc;
    }
    __syncthreads();
    if (tid < w) {
      double v = t[tid];
      if (k + 1 < K) {
        const double* Xk = Xb + (size_t)k * ww;
        double acc = 0.0;
        for (int l = 0; l < w; ++l) acc += Xk[tid * w + l] * xn[l];
        v -= acc;
      }
      x[at(k, tid)] = v;
      t[tid] = v;
    }
    __syncthreads();
    if (tid < w) xn[tid] = t[tid];
    __syncthreads();
  }
}

size_t factor_smem_bytes(int w) { return 5 * (size_t)w * w * sizeof(double); }

size_t solve_smem_bytes(int w) {
  return ((size_t)w * w + 3 * (size_t)w) * sizeof(double);
}

}  // namespace

extern "C" {

int sleipnir_banded_max_width() { return kMaxWidth; }

// D (B, K, w, w), E (B, K-1, w, w) in; LU (B, K, w, w), perm (B, K, w),
// d (B, K, w), X (B, K-1, w, w) out. All row-major and contiguous.
int sleipnir_banded_factor(const double* D, const double* E, double* LU,
                           int* perm, double* d, double* X, int B, int K,
                           int w, void* stream) {
  const size_t smem = factor_smem_bytes(w);
  cudaError_t err = cudaFuncSetAttribute(
      factor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  factor_kernel<<<B, kFactorThreads, smem, (cudaStream_t)stream>>>(
      D, E, LU, perm, d, X, K, w);
  return (int)cudaGetLastError();
}

// LU, perm, X from sleipnir_banded_factor; b and x (B, K, w, r).
int sleipnir_banded_solve(const double* LU, const int* perm, const double* X,
                          const double* b, double* x, int B, int K, int w,
                          int r, void* stream) {
  const dim3 grid(B, r);
  solve_kernel<<<grid, kSolveThreads, solve_smem_bytes(w),
                 (cudaStream_t)stream>>>(LU, perm, X, b, x, K, w, r);
  return (int)cudaGetLastError();
}

const char* sleipnir_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
