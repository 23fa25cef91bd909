// Double-float precision probe for Hopper (sm_90a).
//
// Replaces the TPU probe tools/pallas_dd_probe.py (run_kernel), which runs
// each double-float primitive of sleipnir_tpu/ops/dd.py inside a trivial
// Pallas kernel to see what the TPU's compiler does to it. Here each
// primitive is its own elementwise kernel, written operation for operation
// as sleipnir_tpu_torch/ops/dd.py writes it:
//   two_sum, two_prod (Dekker splitting with 4097), add2, mul2, div2,
// plus a kernel that forms the 13x13 one-hot float32 product in its body.
//
// Build with -fmad=false and without --use_fast_math. nvcc contracts a
// multiply followed by an add into one FMA by default, which rounds once
// where the source rounds twice: `ah * bh - p` in two_prod would then no
// longer be the rounded product minus p, and the error-free transforms
// would compute something else. Built this way every line below is one
// IEEE float32 operation, so the kernels must agree bit for bit with the
// plain torch version; a difference is a finding about the compiler.
//
// What bounds them: nothing of interest. They read four (8, 128) float32
// arrays and write two, 24 KB in all, and launch one block of threads per
// 256 elements; the time is launch latency.

#include <cuda_runtime.h>

namespace {

constexpr float kSplit = 4097.0f;
constexpr int kThreads = 256;

struct Pair {
  float hi;
  float lo;
};

__device__ Pair two_sum(float a, float b) {
  const float s = a + b;
  const float bb = s - a;
  const float err = (a - (s - bb)) + (b - bb);
  return {s, err};
}

__device__ Pair quick_two_sum(float a, float b) {
  const float s = a + b;
  const float err = b - (s - a);
  return {s, err};
}

__device__ Pair split(float a) {
  const float t = kSplit * a;
  const float hi = t - (t - a);
  return {hi, a - hi};
}

__device__ Pair two_prod(float a, float b) {
  const float p = a * b;
  const Pair as = split(a);
  const Pair bs = split(b);
  const float err =
      ((as.hi * bs.hi - p) + as.hi * bs.lo + as.lo * bs.hi) + as.lo * bs.lo;
  return {p, err};
}

__device__ Pair add2(float xh, float xl, float yh, float yl) {
  Pair s = two_sum(xh, yh);
  const Pair t = two_sum(xl, yl);
  float s2 = s.lo + t.hi;
  s = quick_two_sum(s.hi, s2);
  s2 = s.lo + t.lo;
  return quick_two_sum(s.hi, s2);
}

__device__ Pair sub2(float xh, float xl, float yh, float yl) {
  return add2(xh, xl, -yh, -yl);
}

__device__ Pair mul2(float xh, float xl, float yh, float yl) {
  const Pair p = two_prod(xh, yh);
  const float p2 = p.lo + (xh * yl + xl * yh);
  return quick_two_sum(p.hi, p2);
}

__device__ Pair div2(float xh, float xl, float yh, float yl) {
  const float yh_safe = yh == 0.0f ? 1.0f : yh;
  const float yl_safe = yh == 0.0f ? 0.0f : yl;
  const float q1 = xh / yh_safe;
  Pair t = mul2(q1, 0.0f, yh_safe, yl_safe);
  Pair r = sub2(xh, xl, t.hi, t.lo);
  const float q2 = r.hi / yh_safe;
  t = mul2(q2, 0.0f, yh_safe, yl_safe);
  r = sub2(r.hi, r.lo, t.hi, t.lo);
  const float q3 = r.hi / yh_safe;
  const Pair q = quick_two_sum(q1, q2);
  return add2(q.hi, q.lo, q3, 0.0f);
}

__global__ void two_sum_kernel(const float* a, const float* b, float* hi,
                               float* lo, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Pair r = two_sum(a[i], b[i]);
  hi[i] = r.hi;
  lo[i] = r.lo;
}

__global__ void two_prod_kernel(const float* a, const float* b, float* hi,
                                float* lo, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Pair r = two_prod(a[i], b[i]);
  hi[i] = r.hi;
  lo[i] = r.lo;
}

__global__ void add2_kernel(const float* xh, const float* xl, const float* yh,
                            const float* yl, float* hi, float* lo, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Pair r = add2(xh[i], xl[i], yh[i], yl[i]);
  hi[i] = r.hi;
  lo[i] = r.lo;
}

__global__ void mul2_kernel(const float* xh, const float* xl, const float* yh,
                            const float* yl, float* hi, float* lo, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Pair r = mul2(xh[i], xl[i], yh[i], yl[i]);
  hi[i] = r.hi;
  lo[i] = r.lo;
}

__global__ void div2_kernel(const float* xh, const float* xl, const float* yh,
                            const float* yl, float* hi, float* lo, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Pair r = div2(xh[i], xl[i], yh[i], yl[i]);
  hi[i] = r.hi;
  lo[i] = r.lo;
}

// out = P X for (w, w) row-major matrices, one thread per entry, summed
// over the inner index in order.
__global__ void onehot_kernel(const float* P, const float* X, float* out,
                              int w) {
  const int idx = threadIdx.x;
  if (idx >= w * w) return;
  const int i = idx / w;
  const int j = idx % w;
  float acc = 0.0f;
  for (int l = 0; l < w; ++l) acc = acc + P[i * w + l] * X[l * w + j];
  out[idx] = acc;
}

}  // namespace

extern "C" {

// op: 0 two_sum(a, b), 1 two_prod(a, b), 2 add2, 3 mul2, 4 div2 (each of
// the last three on (xh, xl, yh, yl) = (a, b, c, d)). Writes the (hi, lo)
// result to out_hi, out_lo; n entries each.
int sleipnir_dd_elementwise(int op, const float* a, const float* b,
                            const float* c, const float* d, float* out_hi,
                            float* out_lo, int n, void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  cudaStream_t s = (cudaStream_t)stream;
  switch (op) {
    case 0:
      two_sum_kernel<<<blocks, kThreads, 0, s>>>(a, b, out_hi, out_lo, n);
      break;
    case 1:
      two_prod_kernel<<<blocks, kThreads, 0, s>>>(a, b, out_hi, out_lo, n);
      break;
    case 2:
      add2_kernel<<<blocks, kThreads, 0, s>>>(a, b, c, d, out_hi, out_lo, n);
      break;
    case 3:
      mul2_kernel<<<blocks, kThreads, 0, s>>>(a, b, c, d, out_hi, out_lo, n);
      break;
    case 4:
      div2_kernel<<<blocks, kThreads, 0, s>>>(a, b, c, d, out_hi, out_lo, n);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// P, X, out (w, w) float32, w * w <= 1024.
int sleipnir_dd_onehot(const float* P, const float* X, float* out, int w,
                       void* stream) {
  onehot_kernel<<<1, w * w, 0, (cudaStream_t)stream>>>(P, X, out, w);
  return (int)cudaGetLastError();
}

const char* sleipnir_dd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
