// Elementwise throughput probe for Hopper: k chained applications of one
// small arithmetic body per element of a [rows, B] array.
//
// Replaces the TPU kernel tools/vpu_roofline.py::main.make(...).f (its
// pallas_call at :98), which chained f32 bodies over [48, 2048] tiles to
// measure the TPU vector unit's real elementwise ceiling.  Here the same six
// f32 bodies run on CUDA cores, plus three 32-bit integer bodies: the
// Poseidon kernels (poseidon_bn254.cu) are built from 32x32->64-bit integer
// multiply-adds, so their measured ceiling is what bounds them on this card.
//
// What bounds it: operations, and in front of them the dispatch slot.  On
// Hopper the FP32 pipe's published rate (128 per clock per SM) is one warp
// instruction per SM partition per clock, which is also the dispatch rate, so
// every instruction that is not the body's own (a loop counter, a compare,
// a branch, an address) costs the counted share one for one.  Memory is
// noise at the probe's k (thousands): each element is read once and written
// once (8 B) around k applications held in registers.  The design keeps the
// dispatch slots for the body:
//
// - each thread takes kVec = 4 elements with one 16-byte load and store, in
//   a grid-stride loop over a grid sized from the SM count and the kernel's
//   occupancy, so the 4 independent chains give the scheduler work even
//   where the registers allow few warps; the next group's load goes out
//   before this group's chain, so at small k (the bytes bound) memory
//   overlaps the arithmetic although every warp of the grid starts at once;
// - the k loop is unrolled by the body's unroll_of (16 for the one- and
//   two-op bodies, 4 for cios16, 2 for the others), with the remainder
//   in a second loop of the same launch, so the counter, compare and branch
//   are paid once per 8-64 applications;
// - a start that is not 16-byte aligned (a view at an offset), and the
//   ragged tail of n % 4 elements, take a scalar path (one element, the
//   same chain); no vector access is ever misaligned.
//
// mod4's floor.  floorf compiles to FRND.FLOOR, which runs on the
// conversion unit at 16 results per clock per SM, an eighth of the FP32
// rate: four floors cost 32 FP32 dispatch slots against the body's 12 counted
// multiplies and adds, a cap of 37.5%.  kMagicFloors of every 16 floors
// (4 steps x 4 elements) take an exact floor on the FP32 pipe instead
// (floor_magic: two adds with the magic number 2^23, rounding down, and
// four bit and compare instructions), which trades the conversion unit
// against dispatch slots; 5 of 16 was the fastest split measured (PERF.md).
//
// cios16: the row shape the Poseidon kernels run (redc_row /
// mac_row_acc, poseidon_bn254.cu): per row a 32-bit multiplier from the
// state, eight independent 32x32+64 -> 64-bit multiply-adds (mad.wide.u32)
// and one carry chain of adds; two rows per application.  Its addends are
// 64-bit register pairs, each the product pair of the row before with its
// low word updated in place by the chain, so no register is zeroed to
// widen a 32-bit addend (the Poseidon rows' 32-bit addends cost one
// zeroing move each on the IMAD pipe).  Defined in cios16_row below.
//
// wide16: 16 wide multiply-adds alone, a = lo(a) c + a mod 2^64 on a 64-bit
// word, to time a wide multiply-add against imad16's 32-bit one.
//
// Bit-exactness: every f32 body is written with __fmul_rn / __fadd_rn /
// __fsub_rn and an exact floor, which nvcc never contracts into an FFMA, in
// the tool's association order, so each op rounds once as in XLA and in the
// plain torch version (ops/vpu_roofline.py).  Integer bodies wrap (mod 2^32,
// 2^64 or 2^256).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC; a plain C interface, bound with ctypes (ops/_build.py).
// Each launcher returns the first CUDA error of the launch; launches go on
// the caller's stream, never synchronise, and allocate nothing.  The floor
// and the cios16 row are plain C++ (IMT_HD), so they also compile for the
// host, where they take the C++ branch of the same arithmetic
// (tests/test_torch_vpu_roofline_host.py builds them with g++).

#include <cfenv>
#include <cmath>
#include <cstdint>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define IMT_HD __host__ __device__ __forceinline__
#else
#define IMT_HD inline
#endif

namespace {

using u32 = std::uint32_t;
using u64 = std::uint64_t;

constexpr int kWords = 8;          // cios16's state words per element
constexpr float kTwo23 = 8388608.0f;

// ---- the floor on the FP32 pipe ---------------------------------------------

// a + b rounded toward -infinity
IMT_HD float fadd_rd(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fadd_rd(a, b);
#else
  const int mode = std::fegetround();
  std::fesetround(FE_DOWNWARD);
  volatile float va = a, vb = b;
  volatile float s = va + vb;
  std::fesetround(mode);
  return s;
#endif
}

// floor(y), bit for bit as floorf.  For |y| < 2^23, y + M with M = +-2^23
// (y's sign) lies in [2^23, 2^24) in magnitude, where the float spacing is
// 1, so rounding it down gives floor(y) + M exactly, and subtracting M is
// exact.  The subtraction gives +0 for y = -0; y's sign is put back (every
// other result already has it: floor of y < 0 is <= -1).  |y| >= 2^23 is an
// integer already, and +-inf and NaN are their own floor: those keep y.
IMT_HD float floor_magic(float y) {
#ifdef __CUDA_ARCH__
  const float m = copysignf(kTwo23, y);
  const float r = __fsub_rn(fadd_rd(y, m), m);
  return fabsf(y) < kTwo23 ? copysignf(r, y) : y;
#else
  const float m = std::copysign(kTwo23, y);
  const float r = fadd_rd(y, m) - m;
  return std::fabs(y) < kTwo23 ? std::copysign(r, y) : y;
#endif
}

// ---- cios16: two rows of the Poseidon kernels' row shape ---------------------
//
// State: 8 words a[0..7] of 64 bits per element, starting as a[j] = x + j d
// (high words 0); the row's words w[j] = c + j d; the output is the low word
// of a[0].  One row:
//   m = lo(a[0]) c mod 2^32;  p[j] = m w[j] + a[j] mod 2^64;
//   s = (l[1..7], l[0]) + (h[0..7])  as 256-bit numbers, mod 2^256;
//   a'[j] = s[j] + 2^32 h[j+1 mod 8],
// where l[j], h[j] are the low and high words of p[j]: the low words shift
// down one word (as in redc_row, l[0] wraps round to the top), each high
// half adds to the next low half in one carry chain, the carry out of the
// top word is dropped, and each new word keeps the high half of the
// product whose low word it replaced, so a'[j] is p[j+1] with its low word
// changed in place.  The multiplier comes from the state and every word
// reaches a[0] within 8 rows, so nothing is loop-invariant and nothing is
// dead.  Per row: 8 wide multiply-adds (IMAD.WIDE.U32, each addend the
// register pair it overwrites), 1 32-bit multiply (IMAD), 8 carry-chained
// adds.  ptxas still adds a zero to some high halves as it places them
// (PERF.md has the census); the one asm statement per row of
// mad.wide.u32 and the chain, and an unrotated row, each came out slower.

IMT_HD void cios16_words(u32 w[kWords], u32 c, u32 d) {
  for (int j = 0; j < kWords; ++j) w[j] = c + (u32)j * d;
}

IMT_HD void cios16_start(u64 a[kWords], u32 x, u32 d) {
  for (int j = 0; j < kWords; ++j) a[j] = (u32)(x + (u32)j * d);
}

IMT_HD void cios16_row(u64 a[kWords], const u32 w[kWords], u32 c) {
  const u32 m = (u32)a[0] * c;
  u64 p[kWords];
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
  for (int j = 0; j < kWords; ++j) p[j] = (u64)m * w[j] + a[j];
#ifdef __CUDA_ARCH__
  // one asm statement: the carry flag does not survive between statements
  asm("{\n\t.reg .u32 l<8>, h<8>;\n\t"
      "mov.b64 {l0, h0}, %8;\n\t"
      "mov.b64 {l1, h1}, %9;\n\t"
      "mov.b64 {l2, h2}, %10;\n\t"
      "mov.b64 {l3, h3}, %11;\n\t"
      "mov.b64 {l4, h4}, %12;\n\t"
      "mov.b64 {l5, h5}, %13;\n\t"
      "mov.b64 {l6, h6}, %14;\n\t"
      "mov.b64 {l7, h7}, %15;\n\t"
      "add.cc.u32 l1, l1, h0;\n\t"
      "addc.cc.u32 l2, l2, h1;\n\t"
      "addc.cc.u32 l3, l3, h2;\n\t"
      "addc.cc.u32 l4, l4, h3;\n\t"
      "addc.cc.u32 l5, l5, h4;\n\t"
      "addc.cc.u32 l6, l6, h5;\n\t"
      "addc.cc.u32 l7, l7, h6;\n\t"
      "addc.u32 l0, l0, h7;\n\t"
      "mov.b64 %0, {l1, h1};\n\t"
      "mov.b64 %1, {l2, h2};\n\t"
      "mov.b64 %2, {l3, h3};\n\t"
      "mov.b64 %3, {l4, h4};\n\t"
      "mov.b64 %4, {l5, h5};\n\t"
      "mov.b64 %5, {l6, h6};\n\t"
      "mov.b64 %6, {l7, h7};\n\t"
      "mov.b64 %7, {l0, h0};\n\t}"
      : "=l"(a[0]), "=l"(a[1]), "=l"(a[2]), "=l"(a[3]), "=l"(a[4]),
        "=l"(a[5]), "=l"(a[6]), "=l"(a[7])
      : "l"(p[0]), "l"(p[1]), "l"(p[2]), "l"(p[3]), "l"(p[4]), "l"(p[5]),
        "l"(p[6]), "l"(p[7]));
#else
  u64 carry = 0;
  for (int j = 0; j < kWords; ++j) {
    const u64 next = p[(j + 1) % kWords];
    const u64 s = (u64)(u32)next + (p[j] >> 32) + carry;
    a[j] = (u32)s | (next >> 32) << 32;
    carry = s >> 32;
  }
#endif
}

}  // namespace

#ifdef __CUDACC__

namespace {

constexpr int kBlock = 256;
constexpr int kVec = 4;            // elements per thread: one 16-byte access
constexpr int kMagicFloors = 5;    // mod4's floors of every 16 on the FP32 pipe

// body ids, in the order of ops/vpu_roofline.py BODIES
enum Body : int {
  kMul = 0, kMulAdd = 1, kMul16 = 2, kFma16 = 3, kMod4 = 4, kIlp16 = 5,
  kImad16 = 6, kCios16 = 7, kWide16 = 8,
};

// applications per trip of the unrolled k loop
__host__ __device__ constexpr int unroll_of(int b) {
  return b == kMul || b == kMulAdd ? 16 : b == kCios16 ? 4 : 2;
}

// floor number i of a mod4 application over V elements (i = step * V + e)
// takes floor_magic: kMagicFloors of every 16, spread evenly
__host__ __device__ constexpr bool magic_floor(int i) {
  return (i % 16) * kMagicFloors % 16 < kMagicFloors;
}

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
  } else {
    // ilp16: 4 independent 3-op chains, recombined
    const float a = __fmul_rn(__fmul_rn(__fmul_rn(x, c), c), c);
    const float b = __fmul_rn(__fmul_rn(__fmul_rn(x, d), d), d);
    const float e = __fadd_rn(__fadd_rn(__fadd_rn(x, c), c), c);
    const float f = __fadd_rn(__fadd_rn(__fadd_rn(x, d), d), d);
    return __fmul_rn(__fmul_rn(a, b), __fmul_rn(e, f));
  }
}

// one application of body B to each of V elements
template <int B, int V>
__device__ __forceinline__ void apply(float (&x)[V], float c, float d) {
  if constexpr (B == kMod4) {
    // x - c * floor(x * d), 4 times
#pragma unroll
    for (int s = 0; s < 4; ++s) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float y = __fmul_rn(x[e], d);
        const float f = magic_floor(s * V + e) ? floor_magic(y) : floorf(y);
        x[e] = __fsub_rn(x[e], __fmul_rn(c, f));
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) x[e] = body_f32<B>(x[e], c, d);
  }
}

// imad16: 16 x (x = x*c + d mod 2^32), one IMAD each; wide16: a = x +
// 2^32 d, 16 x (a = lo(a) c + a mod 2^64), one IMAD.WIDE.U32 each, then
// x = lo(a) ^ hi(a)
template <int B, int V>
__device__ __forceinline__ void apply(u32 (&x)[V], u32 c, u32 d) {
  if constexpr (B == kWide16) {
    u64 a[V];
#pragma unroll
    for (int e = 0; e < V; ++e) a[e] = x[e] | (u64)d << 32;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < V; ++e) a[e] = (u64)(u32)a[e] * c + a[e];
    }
#pragma unroll
    for (int e = 0; e < V; ++e) x[e] = (u32)a[e] ^ (u32)(a[e] >> 32);
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < V; ++e) x[e] = x[e] * c + d;
    }
  }
}

// body^k over V elements in registers
template <int B, typename T, int V>
__device__ __forceinline__ void chain(T (&x)[V], int k, T c, T d) {
  if constexpr (B == kCios16) {
    constexpr int U = unroll_of(B);
    u32 w[kWords];
    u64 a[V][kWords];
    cios16_words(w, c, d);
#pragma unroll
    for (int e = 0; e < V; ++e) cios16_start(a[e], x[e], d);
    // U applications (2U rows) a trip: the 8 words' register pairs rotate
    // by one word a row and come back to their places every 8 rows
#pragma unroll 1
    for (int r = k / U; r > 0; --r) {
#pragma unroll
      for (int u = 0; u < 2 * U; ++u) {
#pragma unroll
        for (int e = 0; e < V; ++e) cios16_row(a[e], w, c);
      }
    }
#pragma unroll 1
    for (int r = k % U; r > 0; --r) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        cios16_row(a[e], w, c);
        cios16_row(a[e], w, c);
      }
    }
#pragma unroll
    for (int e = 0; e < V; ++e) x[e] = (u32)a[e][0];
  } else {
    constexpr int U = unroll_of(B);
#pragma unroll 1
    for (int r = k / U; r > 0; --r) {
#pragma unroll
      for (int u = 0; u < U; ++u) apply<B, V>(x, c, d);
    }
#pragma unroll 1
    for (int r = k % U; r > 0; --r) apply<B, V>(x, c, d);
  }
}

template <typename T> struct Vec4;
template <> struct Vec4<float> { using type = float4; };
template <> struct Vec4<u32> { using type = uint4; };

// out = body^k(in) over n elements: nv 16-byte groups (in and out both
// 16-byte aligned; nv = 0 otherwise), then the elements from 4 nv on one at
// a time (the scalar path; the threads with the fewest groups take them)
template <int B, typename T>
__global__ void __launch_bounds__(kBlock)
roofline_kernel(const T* in, T* out, long long n, long long nv, int k, T c,
                T d) {
  using V4 = typename Vec4<T>::type;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const V4* vin = reinterpret_cast<const V4*>(in);
  V4* vout = reinterpret_cast<V4*>(out);
  V4 a;
  if (tid < nv) a = vin[tid];
  for (long long i = tid; i < nv; i += stride) {
    // the next group's load goes out before this group's chain
    V4 next = a;
    if (i + stride < nv) next = vin[i + stride];
    T x[kVec] = {a.x, a.y, a.z, a.w};
    chain<B, T, kVec>(x, k, c, d);
    vout[i] = V4{x[0], x[1], x[2], x[3]};
    a = next;
  }
  const long long done = kVec * nv;
  for (long long i = stride - 1 - tid; i < n - done; i += stride) {
    T x[1] = {in[done + i]};
    chain<B, T, 1>(x, k, c, d);
    out[done + i] = x[0];
  }
}

template <int B, typename T>
int launch(const void* in, void* out, long long n, int k, T c, T d,
           void* stream) {
  // blocks of this kernel one SM holds, found once per process
  static int per_sm = 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && per_sm == 0)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, roofline_kernel<B, T>, kBlock, 0);
  if (err != cudaSuccess) return (int)err;
  const bool aligned = ((std::uintptr_t)in | (std::uintptr_t)out) % 16 == 0;
  const long long nv = aligned ? n / kVec : 0;
  const long long items = nv > n - kVec * nv ? nv : n - kVec * nv;
  long long blocks = (items + kBlock - 1) / kBlock;
  const long long full = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > full) blocks = full;
  roofline_kernel<B, T><<<(unsigned)blocks, kBlock, 0,
                          (cudaStream_t)stream>>>(
      (const T*)in, (T*)out, n, nv, k, c, d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out = body^k(in) elementwise over n f32 values; body is one of kMul..kIlp16.
// Returns cudaErrorInvalidValue for an unknown body.
int imt_roofline_f32(int body, const void* in, void* out, long long n, int k,
                     float c, float d, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  switch (body) {
    case kMul: return launch<kMul>(in, out, n, k, c, d, stream);
    case kMulAdd: return launch<kMulAdd>(in, out, n, k, c, d, stream);
    case kMul16: return launch<kMul16>(in, out, n, k, c, d, stream);
    case kFma16: return launch<kFma16>(in, out, n, k, c, d, stream);
    case kMod4: return launch<kMod4>(in, out, n, k, c, d, stream);
    case kIlp16: return launch<kIlp16>(in, out, n, k, c, d, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// out = body^k(in) elementwise over n u32 values; body is kImad16, kCios16
// or kWide16.
int imt_roofline_u32(int body, const void* in, void* out, long long n, int k,
                     unsigned c, unsigned d, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  switch (body) {
    case kImad16: return launch<kImad16, u32>(in, out, n, k, c, d, stream);
    case kCios16: return launch<kCios16, u32>(in, out, n, k, c, d, stream);
    case kWide16: return launch<kWide16, u32>(in, out, n, k, c, d, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"

#endif  // __CUDACC__
