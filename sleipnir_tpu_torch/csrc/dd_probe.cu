// Double-float precision probe for Hopper (sm_90a), in one kernel.
//
// Replaces the TPU probe tools/pallas_dd_probe.py (run_kernel), which runs
// each double-float primitive of sleipnir_tpu/ops/dd.py inside a trivial
// Pallas kernel to see what the TPU's compiler does to it, and asks what
// the TPU's matrix unit does to a one-hot float32 product. Here one launch
// computes every output of a probe run: the primitives two_sum, two_prod
// (Dekker splitting with 4097), add2, mul2 and div2, written operation for
// operation as sleipnir_tpu_torch/ops/dd.py writes them, and the 13x13
// one-hot product on the card's matrix unit.
//
// Build with -fmad=false and without --use_fast_math. nvcc contracts a
// multiply followed by an add into one FMA by default, which rounds once
// where the source rounds twice: `ah * bh - p` in two_prod would then no
// longer be the rounded product minus p, and the error-free transforms
// would compute something else. Built this way every line below is one
// IEEE float32 operation, so the kernel must agree bit for bit with the
// plain torch version; a difference is a finding about the compiler.
//
// The one-hot product runs on the tensor cores: mma.sync m16n8k8 with TF32
// operands, P and X padded from w <= 16 to 16. A TF32 operand keeps 11
// significant bits of a float32 (the unit reads the top 19 bits of the
// register), so one pass truncates X; that pass is computed too and its
// error reported, as the TPU probe reports its MXU's. The exact product
// splits X into three parts of at most 11 significant bits each
// (x = x1 + x2 + x3, each a truncation of what the parts before it left),
// multiplies each by P with a zero accumulator, and sums the parts in
// float32 as (x1 + x2) + x3. With P one-hot, each part's product holds one
// part of one entry of X, and (x1 + x2) and x are bit patterns of x, so
// every sum is exact and the result equals X's rows in P's order bit for
// bit. (A part that is subnormal with bits below 2^-136 is not a TF32
// register value; the probe's entries are O(1).)
//
// What bounds it: the launch. A probe run reads four (8, 128) float32
// arrays and two 13x13 ones and writes ten arrays and two products, 57 KB
// in all; the device work is a few microseconds, so the design removes
// launches and host work: one launch per run, grid (elementwise blocks,
// parts), and the wrapper allocates one output tensor per call.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kSplit = 4097.0f;
constexpr int kThreads = 256;
constexpr int kNumPrimitives = 5;  // ops 0..4; op 5 is the one-hot product
constexpr int kNumOps = 6;
constexpr int kMaxWidth = 16;

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

// x truncated to its 11 leading significant bits, as ops/dd.py
// tf32_truncate: the low 13 bits of a normal number's field, or of a
// subnormal's the bits 11 and more below its leading one.
__device__ float trunc11(float x) {
  const uint32_t bits = __float_as_uint(x);
  uint32_t clear = 0x1fffu;
  if ((bits & 0x7f800000u) == 0) {
    const int lead = 31 - __clz(bits & 0x7fffffu);  // -1 for a zero
    clear = lead > 10 ? (1u << (lead - 10)) - 1u : 0u;
  }
  return __uint_as_float(bits & ~clear);
}

// d = a b + d on the tensor cores: A 16x8 row-major, B 8x8 column-major,
// TF32 operands, float32 accumulator.
__device__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], float b0,
                         float b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(__float_as_uint(b0)),
        "r"(__float_as_uint(b1)));
}

__device__ float padded(const float* M, int row, int col, int w) {
  return row < w && col < w ? M[row * w + col] : 0.0f;
}

// exact = P X and, unless single is null, single = P X in one TF32 pass,
// for (w, w) row-major matrices; one warp. Fragment layouts of
// mma.m16n8k8 (PTX ISA): lane = 4 g + t; A holds (g, t), (g + 8, t),
// (g, t + 4), (g + 8, t + 4); B holds (t, g), (t + 4, g); C holds (g, 2t),
// (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
__device__ void onehot_warp(const float* P, const float* X, float* exact,
                            float* single, int w) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  uint32_t a[2][4];
  for (int ks = 0; ks < 2; ++ks) {
    const int k = 8 * ks + t;
    a[ks][0] = __float_as_uint(padded(P, g, k, w));
    a[ks][1] = __float_as_uint(padded(P, g + 8, k, w));
    a[ks][2] = __float_as_uint(padded(P, g, k + 4, w));
    a[ks][3] = __float_as_uint(padded(P, g + 8, k + 4, w));
  }
  for (int nt = 0; nt < 2; ++nt) {
    const int col = 8 * nt + g;
    float b[2][2];
    float parts[3][2][2];
    for (int ks = 0; ks < 2; ++ks) {
      for (int h = 0; h < 2; ++h) {
        const float x = padded(X, 8 * ks + t + 4 * h, col, w);
        b[ks][h] = x;
        const float x1 = trunc11(x);
        const float r = x - x1;
        const float x2 = trunc11(r);
        parts[0][ks][h] = x1;
        parts[1][ks][h] = x2;
        parts[2][ks][h] = r - x2;
      }
    }
    float acc[3][4];
    float one[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int p = 0; p < 3; ++p) {
      for (int i = 0; i < 4; ++i) acc[p][i] = 0.0f;
      for (int ks = 0; ks < 2; ++ks)
        mma_tf32(acc[p], a[ks], parts[p][ks][0], parts[p][ks][1]);
    }
    for (int ks = 0; ks < 2; ++ks) mma_tf32(one, a[ks], b[ks][0], b[ks][1]);
    for (int i = 0; i < 4; ++i) {
      const int row = g + 8 * (i >> 1);
      const int c = 8 * nt + 2 * t + (i & 1);
      if (row < w && c < w) {
        exact[row * w + c] = (acc[0][i] + acc[1][i]) + acc[2][i];
        if (single != nullptr) single[row * w + c] = one[i];
      }
    }
  }
}

struct ProbeArgs {
  const float* xh;  // two_sum and two_prod read (xh, yh)
  const float* xl;
  const float* yh;
  const float* yl;
  const float* P;
  const float* X;
  float* out;
  int n;            // elements of each elementwise input
  int w;            // width of P and X
  int first;        // ops [first, first + count), one per blockIdx.y
  int single_pass;  // the product also writes its single-pass TF32 P X
};

// Op k writes its (hi, lo) pair to out[2n(k - first) ...]; the one-hot
// product writes P X after the pairs, then the single-pass TF32 P X if
// asked for.
__global__ void __launch_bounds__(kThreads) probe_kernel(ProbeArgs args) {
  const int op = args.first + blockIdx.y;
  const int n = args.n;
  if (op == kNumPrimitives) {
    if (blockIdx.x != 0 || threadIdx.x >= 32) return;
    float* exact = args.out + 2 * n * (kNumPrimitives - args.first);
    float* single = args.single_pass ? exact + args.w * args.w : nullptr;
    onehot_warp(args.P, args.X, exact, single, args.w);
    return;
  }
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float xh = args.xh[i];
  const float yh = args.yh[i];
  Pair r;
  switch (op) {
    case 0:
      r = two_sum(xh, yh);
      break;
    case 1:
      r = two_prod(xh, yh);
      break;
    case 2:
      r = add2(xh, args.xl[i], yh, args.yl[i]);
      break;
    case 3:
      r = mul2(xh, args.xl[i], yh, args.yl[i]);
      break;
    default:
      r = div2(xh, args.xl[i], yh, args.yl[i]);
      break;
  }
  float* hi = args.out + 2 * n * blockIdx.y;
  hi[i] = r.hi;
  hi[n + i] = r.lo;
}

}  // namespace

extern "C" {

// Runs ops [first, first + count) of {two_sum, two_prod, add2, mul2, div2,
// one-hot product} in one launch. The primitives take n float32 entries
// of (xh, xl, yh, yl) (two_sum and two_prod read xh and yh only); the
// product takes (w, w) P and X, w <= 16. out holds 2n floats per
// primitive, then w^2 for the product, and w^2 more for its single-pass
// TF32 value when single_pass is not 0.
int sleipnir_dd_probe(const float* xh, const float* xl, const float* yh,
                      const float* yl, int n, const float* P, const float* X,
                      int w, int first, int count, int single_pass, float* out,
                      void* stream) {
  if (first < 0 || count < 1 || first + count > kNumOps || w < 0 ||
      w > kMaxWidth || n < 0)
    return (int)cudaErrorInvalidValue;
  const bool elementwise = first < kNumPrimitives;
  const int blocks = elementwise ? (n + kThreads - 1) / kThreads : 1;
  if (blocks == 0) return (int)cudaErrorInvalidValue;
  const ProbeArgs args{xh, xl, yh, yl, P, X, out, n, w, first, single_pass};
  probe_kernel<<<dim3(blocks, count), kThreads, 0, (cudaStream_t)stream>>>(
      args);
  return (int)cudaGetLastError();
}

// The one-hot product alone: P X for (w, w) P and X into out, the same
// kernel as op 5 of sleipnir_dd_probe without its single-pass output.
int sleipnir_dd_onehot(const float* P, const float* X, float* out, int w,
                       void* stream) {
  return sleipnir_dd_probe(nullptr, nullptr, nullptr, nullptr, 0, P, X, w,
                           kNumPrimitives, 1, 0, out, stream);
}

const char* sleipnir_dd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
