// Block-tridiagonal factor and solve for Hopper (sm_90a), in native f64
// and, for the float32 solve, in f32.
//
// Replaces the Pallas TPU kernels of sleipnir_tpu/ops/pallas_banded.py:
//   sleipnir_banded_factor  <- pallas_banded_factor (_factor_kernel)
//   sleipnir_banded_solve   <- pallas_banded_solve  (_solve_kernel)
// and, for long horizons, their chunked forms:
//   sleipnir_banded_factor  <- _pallas_factor_chunked (_factor_kernel_chunked)
//   sleipnir_banded_solve   <- _pallas_solve_chunked (the two chunked sweeps)
// The TPU chunks the stage grid because its scoped VMEM cannot hold a
// long horizon; these kernels stream each stage's blocks from device
// memory whatever K is, so one kernel serves every K. Offsets into the
// (B, K, ...) arrays are size_t: at B=4, K=5001, w=37 an array holds 27
// million entries.
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
// What bounds these kernels on the card: the latency of one sequential
// chain per system, not arithmetic or bytes. A factorization is K
// dependent stages of O(w) dependent steps, a solve two sweeps of K
// dependent stages; neither comes near the card's f64 rate or its memory
// bandwidth. So the design shortens each step of the chain and takes off
// the chain whatever does not feed it:
//   - one warp runs a system's chain (for w > 32 a second warp joins it,
//     and the block's barrier takes the place of __syncwarp): lanes own
//     rows of S_k for the LU and columns for X_k and the Schur update, in
//     registers, so the LU takes no barrier at all (the pivot search is a
//     butterfly of shuffles, the pivot row goes by shuffle) and a stage
//     takes two. The kernels are templated on width classes (w up to 4,
//     8, 16, 32, 37), so that loops along a row unroll and shared
//     addresses are immediate offsets;
//   - the LU swaps no rows: each lane keeps its rows' positions in the
//     pivot order, and the pivot rule stays LAPACK's (the first position
//     holding the largest |entry|); every entry goes through the same
//     operations in the same order as in a block-wide kernel that swaps
//     rows, so the factor is the same bit for bit;
//   - each stage's blocks (E_k and D_{k+1} in the factor, X_k and the
//     right-hand side in the sweeps) are copied into a ring of shared
//     buffers with cp.async several stages ahead of their use;
//   - the inertia LDL^T runs after the chain, in a second launch with one
//     warp for each (system, stage), on the S_k the chain wrote out;
//   - the solve is three launches: the forward sweep y_{k+1} = b_{k+1} -
//     X_k^T y_k and the backward sweep x_k = z_k - X_k x_{k+1}, one warp per
//     (system, column), hold two matrix-vector products per stage and no
//     division; the block solves z_k = S_k^{-1} y_k run between them, one
//     warp per (system, stage, column), all at once.
// The batch (the regularization ladder's candidates) takes one warp each.
// The TPU kernels' double-float arithmetic and one-hot permutations are
// not carried over: Hopper has native f64.
//
// Every kernel is templated on its scalar T and instantiated for double
// (sleipnir_banded_factor, sleipnir_banded_solve) and for float
// (sleipnir_banded_factor_f32, sleipnir_banded_solve_f32): the same
// operations in the same order, on 4-byte words. Shared memory is sized in
// sizeof(T), the cp.async copies are sizeof(T) wide, and the odd row
// stride W | 1 puts the lanes reading down a column of 4-byte words on 32
// distinct banks. The kernels write the pivots d; the inertia threshold is
// the caller's, taken from the dtype.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace {

constexpr int kMaxWidth = 37;
constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
// Ring depths: stage buffers in flight, the one in use included.
constexpr int kFactorRing = 3;
constexpr int kSweepRing = 8;

// One copy of a T (8 or 4 bytes) from device to shared memory that does
// not wait, and the fences that group and await such copies (cp.async).
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
  static_assert(sizeof(T) == 8 || sizeof(T) == 4, "cp.async copies 4 or 8 bytes here");
#ifdef __CUDA_ARCH__
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (sizeof(T) == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
                 : "memory");
  }
#else
  *dst = *src;
#endif
}

// |v| in T's own arithmetic.
__device__ __forceinline__ double abs_of(double v) { return fabs(v); }
__device__ __forceinline__ float abs_of(float v) { return fabsf(v); }

// The dynamic shared memory of a kernel as T: one byte array for every
// instantiation, since `extern __shared__ T smem[]` may name one type only.
template <typename T>
__device__ __forceinline__ T* shared_as() {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  return reinterpret_cast<T*>(smem_bytes);
}

__device__ __forceinline__ void commit_async() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// Waits until at most `Pending` of this thread's copy groups are in flight.
template <int Pending>
__device__ __forceinline__ void wait_async() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
#endif
}

// Row of entry idx of a w-wide block, without an integer division: the
// float product is within 2e-4 of (idx + 0.5) / w for idx < 2^11, and
// the nearest integers lie 0.5 / w >= 0.013 away.
__device__ __forceinline__ int row_of(int idx, float inv_w) {
  return static_cast<int>((static_cast<float>(idx) + 0.5f) * inv_w);
}

// A w x w block, row stride w in device memory, to row stride Ld in
// shared memory, by Threads threads.
template <int Ld, int Threads, typename T>
__device__ __forceinline__ void block_to_shared(T* dst, const T* src, int w, int tid) {
  const float inv_w = 1.0f / static_cast<float>(w);
  for (int idx = tid; idx < w * w; idx += Threads) {
    const int i = row_of(idx, inv_w);
    dst[i * Ld + idx - i * w] = src[idx];
  }
}

// The same block back to device memory (row stride w), coalesced.
template <int Ld, int Threads, typename T>
__device__ __forceinline__ void block_to_device(T* dst, const T* src, int w, int tid) {
  const float inv_w = 1.0f / static_cast<float>(w);
  for (int idx = tid; idx < w * w; idx += Threads) {
    const int i = row_of(idx, inv_w);
    dst[idx] = src[i * Ld + idx - i * w];
  }
}

// K1. One warp per system walks the K stages; for w > 32 a second warp
// joins it for X_k and the Schur update. W is the width class, a
// compile-time bound on w: each lane's rows and each thread's column live
// in registers, every loop along a row or column is unrolled, and shared
// blocks have the compile-time row stride kLd = W | 1 (odd, so that
// lanes reading down a column hit distinct banks), so shared addresses are
// immediate offsets. R is the rows each lane owns in the LU (1 up to
// w=32, 2 beyond); kThreads is 32, or 64 where w > 32 columns need a
// thread each. Columns past w are masked, not skipped, so that every
// shuffle runs on the whole warp.
template <typename T, int W>
constexpr size_t factor_smem_bytes() {
  return (5 + 2 * kFactorRing) * (size_t)W * (W | 1) * sizeof(T) + 2 * W * sizeof(int);
}

template <typename T, int W, int R, int kThreads>
__global__ void __launch_bounds__(kThreads)
    factor_kernel(const T* __restrict__ D, const T* __restrict__ E,
                  T* __restrict__ LU, int* __restrict__ perm,
                  T* __restrict__ S_out, T* __restrict__ X, int K, int w) {
  static_assert(W <= kWarp * R && W <= kThreads, "a row or column without an owner");
  constexpr int kSpan = W < kWarp ? W : kWarp;  // lanes that own rows
  constexpr int kLd = W | 1;
  constexpr int kBlock = W * kLd;
  T* A = shared_as<T>();     // S_k; the Schur update writes it by columns
  T* L = A + kBlock;         // two buffers: the LU of S_k in pivot order
  T* Y = L + 2 * kBlock;     // two buffers: X_k
  T* ring = Y + 2 * kBlock;  // kFactorRing slots of (E_k, D_{k+1})
  int* P = reinterpret_cast<int*>(ring + kFactorRing * 2 * kBlock);  // two buffers

  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int ww = w * w;
  const size_t sys = blockIdx.x;
  const T* Db = D + sys * K * ww;
  const T* Eb = E + sys * (K - 1) * ww;
  T* LUb = LU + sys * K * ww;
  int* Pb = perm + sys * K * w;
  T* Sb = S_out + sys * K * ww;
  T* Xb = X + sys * (K - 1) * ww;
  // One warp: __syncwarp; two: the block's barrier (w > 32 only).
  auto sync = [] {
    if constexpr (kThreads == kWarp) {
      __syncwarp();
    } else {
      __syncthreads();
    }
  };

  // Stage s's E_s and D_{s+1} into ring slot s mod kFactorRing: one copy
  // group per stage, empty past the last coupled stage.
  const float inv_w = 1.0f / static_cast<float>(w);
  auto fetch_stage = [&](int s) {
    if (s + 1 < K) {
      T* slot = ring + (s % kFactorRing) * 2 * kBlock;
      const T* Es = Eb + (size_t)s * ww;
      const T* Dn = Db + (size_t)(s + 1) * ww;
      for (int idx = tid; idx < ww; idx += kThreads) {
        const int i = row_of(idx, inv_w);
        const int at = i * kLd + idx - i * w;
        copy_async(slot + at, Es + idx);
        copy_async(slot + kBlock + at, Dn + idx);
      }
    }
    commit_async();
  };

  block_to_shared<kLd, kThreads>(A, Db, w, tid);
  for (int s = 0; s + 1 < kFactorRing; ++s) fetch_stage(s);
  sync();

  for (int k = 0; k < K; ++k) {
    T* Lk = L + (k & 1) * kBlock;
    T* Yk = Y + (k & 1) * kBlock;
    int* Pk = P + (k & 1) * W;
    // The slot of stage k-1 is free: every thread passed its last read.
    // S_k and stage k-1's LU, perm and X go to device memory here, with
    // the LU between these stores and the next barrier.
    fetch_stage(k + kFactorRing - 1);
    {
      const T* Lp = L + ((k - 1) & 1) * kBlock;
      const T* Yp = Y + ((k - 1) & 1) * kBlock;
      for (int idx = tid; idx < ww; idx += kThreads) {
        const int i = row_of(idx, inv_w);
        const int at = i * kLd + idx - i * w;
        Sb[(size_t)k * ww + idx] = A[at];
        if (k > 0) {
          LUb[(size_t)(k - 1) * ww + idx] = Lp[at];
          Xb[(size_t)(k - 1) * ww + idx] = Yp[at];
        }
      }
      if (k > 0) {
        for (int i = tid; i < w; i += kThreads) Pb[(size_t)(k - 1) * w + i] = P[((k - 1) & 1) * W + i];
      }
    }

    // 1. Row-pivoted LU of S_k in registers: lane r owns rows r and r + 32
    // and keeps their positions in the pivot order; rows never move, and
    // the pivot row reaches the other lanes by shuffle. With two warps
    // both compute it, and warp 0 writes it.
    T a[R][W];
    int pos[R];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int r = lane + kWarp * q;
      pos[q] = r;
      const T* row = A + r * kLd;
#pragma unroll
      for (int j = 0; j < W; ++j) a[q][j] = r < w && j < w ? row[j] : T(0);
    }
#pragma unroll
    for (int c = 0; c < W; ++c) {
      const bool live = c < w;
      // The first position holding the largest |S[., c]| among positions
      // >= c; NaN entries lose to every number, and an all-NaN column
      // keeps the row at position c. Key -2 marks "no row here".
      T best = T(-2);
      int best_id = INT_MAX;  // position * 64 + row
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int r = lane + kWarp * q;
        const T v = abs_of(a[q][c]);
        const T key = v == v ? v : T(-1);
        const int id = pos[q] * 64 + r;
        if (r < w && pos[q] >= c && (key > best || (key == best && id < best_id))) {
          best = key;
          best_id = id;
        }
      }
#pragma unroll
      for (int off = kSpan >> 1; off > 0; off >>= 1) {
        const T other = __shfl_xor_sync(kFull, best, off);
        const int other_id = __shfl_xor_sync(kFull, best_id, off);
        if (other > best || (other == best && other_id < best_id)) {
          best = other;
          best_id = other_id;
        }
      }
      // Lanes past kSpan own no row and hold no valid pivot, and past w
      // there is no column: what they compute is never used.
      const int p = best_id & 63;
      const int p_pos = best_id >> 6;
      const int src = p & (kWarp - 1);
      const bool high = R > 1 && p >= kWarp;
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int r = lane + kWarp * q;
        if (live && r == p) {
          pos[q] = c;
        } else if (live && pos[q] == c) {
          pos[q] = p_pos;
        }
      }
      const T pivot = __shfl_sync(kFull, high ? a[R - 1][c] : a[0][c], src);
      T l[R];
      bool below[R];
#pragma unroll
      for (int q = 0; q < R; ++q) {
        below[q] = live && lane + kWarp * q < w && pos[q] > c;
        l[q] = a[q][c];
        if (below[q] && pivot != T(0)) l[q] /= pivot;
        a[q][c] = l[q];
      }
#pragma unroll
      for (int j = c + 1; j < W; ++j) {
        const T pj = __shfl_sync(kFull, high ? a[R - 1][j] : a[0][j], src);
#pragma unroll
        for (int q = 0; q < R; ++q) {
          if (below[q] && j < w) a[q][j] -= l[q] * pj;
        }
      }
    }
    // Rows into pivot order.
    if (tid < kWarp) {
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int r = lane + kWarp * q;
        if (r < w) {
          T* row = Lk + pos[q] * kLd;
#pragma unroll
          for (int j = 0; j < W; ++j) {
            if (j < w) row[j] = a[q][j];
          }
          Pk[pos[q]] = r;
        }
      }
    }
    wait_async<kFactorRing - 1>();
    sync();
    if (k + 1 == K) {  // the last LU and perm
      block_to_device<kLd, kThreads>(LUb + (size_t)k * ww, Lk, w, tid);
      for (int i = tid; i < w; i += kThreads) Pb[(size_t)k * w + i] = Pk[i];
      break;
    }
    const T* Ek = ring + (k % kFactorRing) * 2 * kBlock;
    const T* Dn = Ek + kBlock;

    if (tid < w) {
      // 2. X_k = S_k^{-1} E_k^T by columns in registers: thread j owns
      // column j through the permutation and both triangles, reading L
      // and U as broadcasts.
      const int jj = tid;
      const T* erow = Ek + jj * kLd;
      T y[W];
#pragma unroll
      for (int i = 0; i < W; ++i) y[i] = i < w ? erow[Pk[i]] : T(0);
#pragma unroll
      for (int c = 0; c + 1 < W; ++c) {
#pragma unroll
        for (int r = c + 1; r < W; ++r) {
          if (r < w) y[r] -= Lk[r * kLd + c] * y[c];
        }
      }
#pragma unroll
      for (int c = W - 1; c >= 0; --c) {
        if (c < w) {
          y[c] /= Lk[c * kLd + c];
#pragma unroll
          for (int r = 0; r < c; ++r) y[r] -= Lk[r * kLd + c] * y[c];
        }
      }

      // 3. S_{k+1} = D_{k+1} - E_k X_k by the same columns, four rows at
      // a time (each sum in the order l = 0, 1, ...), into A; X_k to its
      // shared buffer, for the next stage to store.
      for (int i0 = 0; i0 < w; i0 += 4) {
        T acc[4] = {T(0), T(0), T(0), T(0)};
        const T* e[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) e[t] = Ek + min(i0 + t, w - 1) * kLd;
#pragma unroll
        for (int l = 0; l < W; ++l) {
          if (l < w) {
#pragma unroll
            for (int t = 0; t < 4; ++t) acc[t] += e[t][l] * y[l];
          }
        }
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int i = i0 + t;
          if (i < w) A[i * kLd + jj] = Dn[i * kLd + jj] - acc[t];
        }
      }
#pragma unroll
      for (int i = 0; i < W; ++i) {
        if (i < w) Yk[i * kLd + jj] = y[i];
      }
    }
    sync();
  }
}

// The unpivoted LDL^T pivots of every S_k (inertia only), one warp per
// (system, stage), after the chain.
template <typename T, int W>
__global__ void __launch_bounds__(kWarp)
    ldl_pivots_kernel(const T* __restrict__ S, T* __restrict__ d, int w) {
  constexpr int ld = W | 1;
  T* A = shared_as<T>();
  T* lcol = A + W * ld;
  const int lane = threadIdx.x;
  const size_t blk = blockIdx.x;
  T* db = d + blk * w;

  block_to_shared<ld, kWarp>(A, S + blk * w * w, w, lane);
  __syncwarp();
  for (int j = 0; j < w; ++j) {
    const T dj = A[j * ld + j];
    const T dj_safe = dj == T(0) ? T(1) : dj;
    for (int r = j + 1 + lane; r < w; r += kWarp) lcol[r] = A[r * ld + j] / dj_safe;
    __syncwarp();
    for (int r = j + 1 + lane; r < w; r += kWarp) {
      const T lr = lcol[r];
      for (int c = j + 1; c < w; ++c) A[r * ld + c] -= dj * (lr * lcol[c]);
    }
    if (lane == 0) db[j] = dj;
    __syncwarp();
  }
}

// K2 (a). Forward sweep y_0 = b_0, y_{k+1} = b_{k+1} - X_k^T y_k, one warp
// per (system, column); the y_k go to x. Lane i owns entries i and i + 32
// and copies into its ring slots only what it reads (column i of X_k and
// entry i of b_{k+1}), so the sweep needs no barrier: y_k reaches the
// other lanes by shuffle.
template <typename T, int W, int R>
__global__ void __launch_bounds__(kWarp)
    forward_kernel(const T* __restrict__ X, const T* __restrict__ b,
                   T* __restrict__ x, int K, int w, int r) {
  constexpr int ld = W | 1;
  constexpr int wl = W * ld;
  constexpr int slot_size = wl + W;
  T* ring = shared_as<T>();  // (X_k, b_{k+1}) per slot

  const int lane = threadIdx.x;
  const size_t sys = blockIdx.x;
  const int col = blockIdx.y;
  const T* Xb = X + sys * (K - 1) * w * w;
  auto at = [&](int k, int i) { return ((sys * K + k) * w + i) * r + col; };
  auto fetch_stage = [&](int s) {
    if (s + 1 < K) {
      T* slot = ring + (s % kSweepRing) * slot_size;
      const T* Xs = Xb + (size_t)s * w * w;
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int i = lane + kWarp * q;
        if (i < w) {
          for (int l = 0; l < w; ++l) copy_async(slot + l * ld + i, Xs + l * w + i);
          copy_async(slot + wl + i, b + at(s + 1, i));
        }
      }
    }
    commit_async();
  };

  for (int s = 0; s + 1 < kSweepRing; ++s) fetch_stage(s);
  T y[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int i = lane + kWarp * q;
    y[q] = i < w ? b[at(0, i)] : T(0);
  }
  for (int k = 0; k + 1 < K; ++k) {
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int i = lane + kWarp * q;
      if (i < w) x[at(k, i)] = y[q];
    }
    wait_async<kSweepRing - 2>();
    fetch_stage(k + kSweepRing - 1);  // into the slot of stage k-1, read already
    const T* Xk = ring + (k % kSweepRing) * slot_size;
    T acc[R];
#pragma unroll
    for (int q = 0; q < R; ++q) acc[q] = T(0);
#pragma unroll
    for (int l = 0; l < W; ++l) {
      const T yl = __shfl_sync(kFull, l < kWarp ? y[0] : y[R - 1], l % kWarp);
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int i = lane + kWarp * q;
        if (l < w && i < w) acc[q] += Xk[l * ld + i] * yl;
      }
    }
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int i = lane + kWarp * q;
      if (i < w) y[q] = Xk[wl + i] - acc[q];
    }
  }
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int i = lane + kWarp * q;
    if (i < w) x[at(K - 1, i)] = y[q];
  }
}

// K2 (b). z_k = S_k^{-1} y_k in place in x, one warp per (system, stage,
// column), every stage at once: lane i owns rows i and i + 32 of the
// permuted vector through both triangles.
template <typename T, int W, int R>
__global__ void __launch_bounds__(kWarp)
    block_solve_kernel(const T* __restrict__ LU, const int* __restrict__ perm,
                       T* __restrict__ x, int w, int r) {
  constexpr int ld = W | 1;
  T* A = shared_as<T>();
  const int lane = threadIdx.x;
  const size_t blk = blockIdx.x;  // system * K + stage
  const int col = blockIdx.y;
  const int* Pk = perm + blk * w;

  block_to_shared<ld, kWarp>(A, LU + blk * w * w, w, lane);
  T t[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int i = lane + kWarp * q;
    t[q] = i < w ? x[(blk * w + Pk[i]) * r + col] : T(0);
  }
  __syncwarp();
  for (int c = 0; c + 1 < w; ++c) {
    const T tc = __shfl_sync(kFull, c < kWarp ? t[0] : t[R - 1], c % kWarp);
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int i = lane + kWarp * q;
      if (i > c && i < w) t[q] -= A[i * ld + c] * tc;
    }
  }
  for (int c = w - 1; c >= 0; --c) {
    const T tc = __shfl_sync(kFull, c < kWarp ? t[0] : t[R - 1], c % kWarp) / A[c * ld + c];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int i = lane + kWarp * q;
      if (i < c) {
        t[q] -= A[i * ld + c] * tc;
      } else if (i == c) {
        t[q] = tc;
      }
    }
  }
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int i = lane + kWarp * q;
    if (i < w) x[(blk * w + i) * r + col] = t[q];
  }
}

// K2 (c). Backward sweep x_{K-1} = z_{K-1}, x_k = z_k - X_k x_{k+1}, in
// place in x, one warp per (system, column). As in the forward sweep, lane
// i copies only what it reads (row i of X_k and z_k[i]) and x_{k+1}
// reaches the other lanes by shuffle.
template <typename T, int W, int R>
__global__ void __launch_bounds__(kWarp)
    backward_kernel(const T* __restrict__ X, T* __restrict__ x, int K, int w, int r) {
  constexpr int ld = W | 1;
  constexpr int wl = W * ld;
  constexpr int slot_size = wl + W;
  T* ring = shared_as<T>();  // (X_k, z_k) per slot

  const int lane = threadIdx.x;
  const size_t sys = blockIdx.x;
  const int col = blockIdx.y;
  const T* Xb = X + sys * (K - 1) * w * w;
  auto at = [&](int k, int i) { return ((sys * K + k) * w + i) * r + col; };
  // Step s handles stage k = K - 2 - s. The z_k it prefetches lie below
  // every stage written so far.
  auto fetch_stage = [&](int s) {
    const int k = K - 2 - s;
    if (k >= 0) {
      T* slot = ring + (s % kSweepRing) * slot_size;
      const T* Xs = Xb + (size_t)k * w * w;
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int i = lane + kWarp * q;
        if (i < w) {
          for (int l = 0; l < w; ++l) copy_async(slot + i * ld + l, Xs + i * w + l);
          copy_async(slot + wl + i, x + at(k, i));
        }
      }
    }
    commit_async();
  };

  for (int s = 0; s + 1 < kSweepRing; ++s) fetch_stage(s);
  T v[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int i = lane + kWarp * q;
    v[q] = i < w ? x[at(K - 1, i)] : T(0);
  }
  for (int s = 0; s + 1 < K; ++s) {
    const int k = K - 2 - s;
    wait_async<kSweepRing - 2>();
    fetch_stage(s + kSweepRing - 1);
    const T* Xk = ring + (s % kSweepRing) * slot_size;
    T acc[R];
#pragma unroll
    for (int q = 0; q < R; ++q) acc[q] = T(0);
#pragma unroll
    for (int l = 0; l < W; ++l) {
      const T xl = __shfl_sync(kFull, l < kWarp ? v[0] : v[R - 1], l % kWarp);
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int i = lane + kWarp * q;
        if (l < w && i < w) acc[q] += Xk[i * ld + l] * xl;
      }
    }
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int i = lane + kWarp * q;
      if (i < w) {
        v[q] = Xk[wl + i] - acc[q];
        x[at(k, i)] = v[q];
      }
    }
  }
}

template <typename T, int W>
constexpr size_t ldl_smem_bytes() { return ((size_t)W * (W | 1) + W) * sizeof(T); }

template <typename T, int W>
constexpr size_t sweep_smem_bytes() {
  return kSweepRing * ((size_t)W * (W | 1) + W) * sizeof(T);
}

template <typename T, int W>
constexpr size_t block_solve_smem_bytes() { return (size_t)W * (W | 1) * sizeof(T); }

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// The width classes: W bounds w at compile time, R rows per lane, and the
// factor's threads per system.
template <int W, int R, int Threads>
struct WidthClass {
  static constexpr int kW = W;
  static constexpr int kR = R;
  static constexpr int kThreads = Threads;
};

template <typename Fn>
cudaError_t by_width(int w, Fn&& fn) {
  if (w <= 4) return fn(WidthClass<4, 1, kWarp>{});
  if (w <= 8) return fn(WidthClass<8, 1, kWarp>{});
  if (w <= 16) return fn(WidthClass<16, 1, kWarp>{});
  if (w <= 32) return fn(WidthClass<32, 1, kWarp>{});
  return fn(WidthClass<kMaxWidth, 2, 2 * kWarp>{});
}

// The factor, two launches: the chain, then the inertia pivots.
template <typename T>
cudaError_t factor_launch(const T* D, const T* E, T* LU, int* perm, T* d, T* X, T* S,
                          int B, int K, int w, cudaStream_t st) {
  return by_width(w, [&](auto cls) {
    using C = decltype(cls);
    auto kernel = factor_kernel<T, C::kW, C::kR, C::kThreads>;
    constexpr size_t smem = factor_smem_bytes<T, C::kW>();
    cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<B, C::kThreads, smem, st>>>(D, E, LU, perm, S, X, K, w);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    auto ldl = ldl_pivots_kernel<T, C::kW>;
    ldl<<<B * K, kWarp, ldl_smem_bytes<T, C::kW>(), st>>>(S, d, w);
    return cudaGetLastError();
  });
}

// The solve, three launches: forward sweep, block solves, backward sweep.
template <typename T>
cudaError_t solve_launch(const T* LU, const int* perm, const T* X, const T* b, T* x,
                         int B, int K, int w, int r, cudaStream_t st) {
  const dim3 per_column(B, r);
  return by_width(w, [&](auto cls) {
    using C = decltype(cls);
    auto forward = forward_kernel<T, C::kW, C::kR>;
    auto solve = block_solve_kernel<T, C::kW, C::kR>;
    auto backward = backward_kernel<T, C::kW, C::kR>;
    constexpr size_t sweep = sweep_smem_bytes<T, C::kW>();
    cudaError_t e = allow_smem(forward, sweep);
    if (e == cudaSuccess) e = allow_smem(backward, sweep);
    if (e != cudaSuccess) return e;
    forward<<<per_column, kWarp, sweep, st>>>(X, b, x, K, w, r);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    solve<<<dim3(B * K, r), kWarp, block_solve_smem_bytes<T, C::kW>(), st>>>(LU, perm, x, w, r);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    backward<<<per_column, kWarp, sweep, st>>>(X, x, K, w, r);
    return cudaGetLastError();
  });
}

}  // namespace

extern "C" {

int sleipnir_banded_max_width() { return kMaxWidth; }

// D (B, K, w, w), E (B, K-1, w, w) in; LU (B, K, w, w), perm (B, K, w),
// d (B, K, w), X (B, K-1, w, w) out; S (B, K, w, w) scratch that receives
// the S_k for the inertia pass. All row-major and contiguous. Two launches:
// the chain, then the inertia pivots.
int sleipnir_banded_factor(const double* D, const double* E, double* LU,
                           int* perm, double* d, double* X, double* S, int B,
                           int K, int w, void* stream) {
  return (int)factor_launch(D, E, LU, perm, d, X, S, B, K, w, (cudaStream_t)stream);
}

// The same in float32.
int sleipnir_banded_factor_f32(const float* D, const float* E, float* LU, int* perm,
                               float* d, float* X, float* S, int B, int K, int w,
                               void* stream) {
  return (int)factor_launch(D, E, LU, perm, d, X, S, B, K, w, (cudaStream_t)stream);
}

// LU, perm, X from sleipnir_banded_factor; b and x (B, K, w, r). Three
// launches: forward sweep, block solves, backward sweep.
int sleipnir_banded_solve(const double* LU, const int* perm, const double* X,
                          const double* b, double* x, int B, int K, int w,
                          int r, void* stream) {
  return (int)solve_launch(LU, perm, X, b, x, B, K, w, r, (cudaStream_t)stream);
}

// The same in float32, on sleipnir_banded_factor_f32's factor.
int sleipnir_banded_solve_f32(const float* LU, const int* perm, const float* X,
                              const float* b, float* x, int B, int K, int w, int r,
                              void* stream) {
  return (int)solve_launch(LU, perm, X, b, x, B, K, w, r, (cudaStream_t)stream);
}

const char* sleipnir_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
