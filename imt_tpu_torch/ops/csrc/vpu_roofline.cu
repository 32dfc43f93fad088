// Elementwise throughput probe for Hopper: k chained applications of one
// small arithmetic body per element of a [rows, B] array.
//
// Replaces the TPU kernel tools/vpu_roofline.py::main.make(...).f (its
// pallas_call at :98), which chained f32 bodies over [48, 2048] tiles to
// measure the TPU vector unit's real elementwise ceiling.  Here the same six
// f32 bodies run on CUDA cores, plus two 32-bit integer bodies: the Poseidon
// kernel (poseidon_bn254.cu) is built from 32x32->64-bit integer
// multiply-adds, so their measured ceiling is what bounds it on this card.
//
// What bounds it: operations.  Each element is read once and written once
// (8 B) around k * (1..48) dependent operations held in registers, so at the
// probe's k (thousands) memory time is noise.  The design is the plain one:
// one thread per element, a guard on the ragged edge, the k loop kept a loop
// (#pragma unroll 1) with the body inlined, and c, d passed as kernel
// arguments so that nothing constant-folds.  Enough elements (48 x 65536 at
// the tool's shape) keep every SM's pipelines full without ILP in a thread.
//
// Bit-exactness: every f32 body is written with __fmul_rn / __fadd_rn /
// __fsub_rn and floorf, which nvcc never contracts into an FFMA, in the
// tool's association order, so each op rounds once as in XLA and in the
// plain torch version (ops/vpu_roofline.py).  Integer bodies wrap mod 2^32.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC; a plain C interface, bound with ctypes (ops/_build.py).
// Each launcher returns cudaGetLastError(); launches go on the caller's
// stream, never synchronise, and allocate nothing.

#include <cstdint>

#ifdef __CUDACC__
#include <cuda_runtime.h>

namespace {

using u32 = std::uint32_t;
using u64 = std::uint64_t;

constexpr int kBlock = 256;

// body ids, in the order of ops/vpu_roofline.py BODIES
enum Body : int {
  kMul = 0, kMulAdd = 1, kMul16 = 2, kFma16 = 3, kMod4 = 4, kIlp16 = 5,
  kImad16 = 6, kCios16 = 7,
};

template <int B>
__device__ __forceinline__ float body_f32(float x, float c, float d) {
  if constexpr (B == kMul) {
    return __fmul_rn(x, c);
  } else if constexpr (B == kMulAdd) {
    return __fadd_rn(__fmul_rn(x, c), d);
  } else if constexpr (B == kMul16) {
#pragma unroll
    for (int i = 0; i < 16; ++i) x = __fmul_rn(x, c);
    return x;
  } else if constexpr (B == kFma16) {
#pragma unroll
    for (int i = 0; i < 16; ++i) x = __fadd_rn(__fmul_rn(x, c), d);
    return x;
  } else if constexpr (B == kMod4) {
    // x - c * floor(x * d), 4 times
#pragma unroll
    for (int i = 0; i < 4; ++i) x = __fsub_rn(x, __fmul_rn(c, floorf(__fmul_rn(x, d))));
    return x;
  } else {
    // ilp16: 4 independent 3-op chains, recombined
    const float a = __fmul_rn(__fmul_rn(__fmul_rn(x, c), c), c);
    const float b = __fmul_rn(__fmul_rn(__fmul_rn(x, d), d), d);
    const float e = __fadd_rn(__fadd_rn(__fadd_rn(x, c), c), c);
    const float f = __fadd_rn(__fadd_rn(__fadd_rn(x, d), d), d);
    return __fmul_rn(__fmul_rn(a, b), __fmul_rn(e, f));
  }
}

template <int B>
__global__ void __launch_bounds__(kBlock)
roofline_f32(const float* in, float* out, long long n, int k, float c,
             float d) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float x = in[i];
#pragma unroll 1
  for (int it = 0; it < k; ++it) x = body_f32<B>(x, c, d);
  out[i] = x;
}

// imad16: 16 x (x = x*c + d mod 2^32), one IMAD each.
// cios16: 16 x the inner step of mont_mul (poseidon_bn254.cu:123-125),
//   cur = (u64)x*c + t + carry; t = lo(cur); carry = hi(cur),
// one IMAD.WIDE.U32 and its carry adds each; the multiplicand rotates
// (x takes the old t) so that no product is loop-invariant.  The state
// (x, t, carry) starts as (in, d, 0) and lives across the k loop; the
// output is t.
__global__ void __launch_bounds__(kBlock)
roofline_imad16(const u32* in, u32* out, long long n, int k, u32 c, u32 d) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  u32 x = in[i];
#pragma unroll 1
  for (int it = 0; it < k; ++it) {
#pragma unroll
    for (int j = 0; j < 16; ++j) x = x * c + d;
  }
  out[i] = x;
}

__global__ void __launch_bounds__(kBlock)
roofline_cios16(const u32* in, u32* out, long long n, int k, u32 c, u32 d) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  u32 x = in[i], t = d, carry = 0;
#pragma unroll 1
  for (int it = 0; it < k; ++it) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const u64 cur = (u64)x * c + t + carry;
      x = t;
      t = (u32)cur;
      carry = (u32)(cur >> 32);
    }
  }
  out[i] = t;
}

unsigned grid_for(long long n) {
  return (unsigned)((n + kBlock - 1) / kBlock);
}

}  // namespace

extern "C" {

// out = body^k(in) elementwise over n f32 values; body is one of kMul..kIlp16.
// Returns cudaErrorInvalidValue for an unknown body.
int imt_roofline_f32(int body, const void* in, void* out, long long n, int k,
                     float c, float d, void* stream) {
  if (n > 0) {
    const unsigned g = grid_for(n);
    cudaStream_t s = (cudaStream_t)stream;
    const float* x = (const float*)in;
    float* y = (float*)out;
    switch (body) {
      case kMul: roofline_f32<kMul><<<g, kBlock, 0, s>>>(x, y, n, k, c, d); break;
      case kMulAdd: roofline_f32<kMulAdd><<<g, kBlock, 0, s>>>(x, y, n, k, c, d); break;
      case kMul16: roofline_f32<kMul16><<<g, kBlock, 0, s>>>(x, y, n, k, c, d); break;
      case kFma16: roofline_f32<kFma16><<<g, kBlock, 0, s>>>(x, y, n, k, c, d); break;
      case kMod4: roofline_f32<kMod4><<<g, kBlock, 0, s>>>(x, y, n, k, c, d); break;
      case kIlp16: roofline_f32<kIlp16><<<g, kBlock, 0, s>>>(x, y, n, k, c, d); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}

// out = body^k(in) elementwise over n u32 values; body is kImad16 or kCios16.
int imt_roofline_u32(int body, const void* in, void* out, long long n, int k,
                     unsigned c, unsigned d, void* stream) {
  if (n > 0) {
    const unsigned g = grid_for(n);
    cudaStream_t s = (cudaStream_t)stream;
    const u32* x = (const u32*)in;
    u32* y = (u32*)out;
    switch (body) {
      case kImad16: roofline_imad16<<<g, kBlock, 0, s>>>(x, y, n, k, c, d); break;
      case kCios16: roofline_cios16<<<g, kBlock, 0, s>>>(x, y, n, k, c, d); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}

}  // extern "C"

#endif  // __CUDACC__
