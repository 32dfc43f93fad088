// Poseidon-BN254 (T=3, RATE=2, x^5, 8 full + 57 partial rounds) for Hopper.
//
// Replaces the TPU kernel family imt_tpu/ops/poseidon_rns_pallas.py::
// _make_kernel in its three modes: "perm" (n chained permutations,
// imt_permute_n), "hash2" (imt_hash2_nodes) and "hash3" (imt_hash3_leaf),
// plus the limb <-> node conversions at the API boundary
// (imt_limbs_to_nodes / imt_nodes_to_limbs), which the TPU ran as XLA around
// the kernel (field_rns.from_limbs / to_limbs).
//
// Node form: a field element in Montgomery form (R = 2^256), fully reduced
// (< p), as 8 little-endian 32-bit limbs, limb-major in memory: limb k of
// lane i sits at [k * B + i], so neighbouring threads read neighbouring
// words.  Canonical limbs are 16 limbs of 16 bits in int32, also limb-major.
// The plain torch version of every entry point is ops/poseidon.py; both
// produce the same bits.
//
// What bounds it: 32-bit integer multiply-add throughput, not memory.  A
// hash reads 64-96 B and writes 32 B per lane, against two permutations of
// 828 field multiplies each, and each multiply is 128 32x32->64-bit
// multiply-adds (8x32-bit CIOS).  The design is the plain
// one: one thread per lane, the whole state in registers for all 65 rounds,
// the standard round structure of poseidon_ref.permute, CIOS Montgomery
// multiplication after imt_tpu/native/imt_native.cpp, and the round
// constants and MDS (Montgomery form) in __constant__ memory, where every
// thread of a warp reads the same word.  Tuning it -- the optimized-spec
// sparse partial rounds (imt_tpu/ops/poseidon_opt.py), PTX carry chains,
// limb and register scheduling -- is later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC; a plain C interface, bound with ctypes (ops/_build.py).
// Each launcher returns cudaGetLastError(); launches go on the caller's
// stream, never synchronise, and allocate nothing.  The arithmetic and the
// per-lane bodies are plain C++ (IMT_HD), so they also compile for the host.

#include <cstdint>
#include <cstring>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define IMT_HD __host__ __device__ __forceinline__
#else
#define IMT_HD inline
#endif

namespace {

using u32 = std::uint32_t;
using u64 = std::uint64_t;

constexpr int kWords = 8;    // 32-bit limbs of a field element
constexpr int kT = 3;        // state width
constexpr int kRF = 8;       // full rounds
constexpr int kRP = 57;      // partial rounds
constexpr int kRounds = kRF + kRP;
constexpr u32 kInv = 0xefffffffu;   // -p^{-1} mod 2^32

struct Fr {
  u32 v[kWords];
};

struct Consts {
  Fr rc[kRounds][kT];  // round constants, Montgomery form
  Fr mds[kT][kT];      // MDS matrix, Montgomery form
  Fr iv0;              // 2^64 mod p (sponge capacity word), Montgomery form
  Fr one;              // 1 (squeeze pad word), Montgomery form
};

// modulus p (BN254 scalar field), little-endian words; after unrolling,
// every call has a constant index and folds to an immediate
IMT_HD u32 mod_word(int i) {
  return i == 0 ? 0xf0000001u : i == 1 ? 0x43e1f593u : i == 2 ? 0x79b97091u
       : i == 3 ? 0x2833e848u : i == 4 ? 0x8181585du : i == 5 ? 0xb85045b6u
       : i == 6 ? 0xe131a029u : 0x30644e72u;
}

// R^2 mod p, little-endian words
IMT_HD u32 r2_word(int i) {
  return i == 0 ? 0xae216da7u : i == 1 ? 0x1bb8e645u : i == 2 ? 0xe35c59e3u
       : i == 3 ? 0x53fe3ab1u : i == 4 ? 0x53bb8085u : i == 5 ? 0x8c49833du
       : i == 6 ? 0x7f4e44a5u : 0x0216d0b1u;
}

// r = t - p if (hi or t >= p) else t; t < 2p.  Branch-free select.
IMT_HD void reduce_once(Fr& r, const u32 t[kWords], u32 hi) {
  u32 d[kWords];
  u32 borrow = 0;
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    u64 x = (u64)t[i] - mod_word(i) - borrow;
    d[i] = (u32)x;
    borrow = (u32)(x >> 63);
  }
  const bool use_d = hi != 0 || borrow == 0;
#pragma unroll
  for (int i = 0; i < kWords; ++i) r.v[i] = use_d ? d[i] : t[i];
}

IMT_HD void add_mod(Fr& r, const Fr& a, const Fr& b) {
  u32 s[kWords];
  u64 carry = 0;
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    u64 x = (u64)a.v[i] + b.v[i] + carry;
    s[i] = (u32)x;
    carry = x >> 32;
  }
  reduce_once(r, s, (u32)carry);
}

// CIOS Montgomery product r = a*b/R mod p (after imt_native.cpp:74-102,
// 8x32-bit words, 64-bit accumulators).  a < 2^256 and b < p (or the
// reverse) give a result < 2p before the final subtraction, < p after.
// r may alias a or b.
IMT_HD void mont_mul(Fr& r, const Fr& a, const Fr& b) {
  u32 t[kWords + 2];
#pragma unroll
  for (int j = 0; j < kWords + 2; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    u64 carry = 0;
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      u64 cur = (u64)a.v[i] * b.v[j] + t[j] + carry;
      t[j] = (u32)cur;
      carry = cur >> 32;
    }
    u64 cur = (u64)t[kWords] + carry;
    t[kWords] = (u32)cur;
    t[kWords + 1] = (u32)(cur >> 32);

    const u32 m = t[0] * kInv;
    carry = ((u64)m * mod_word(0) + t[0]) >> 32;
#pragma unroll
    for (int j = 1; j < kWords; ++j) {
      cur = (u64)m * mod_word(j) + t[j] + carry;
      t[j - 1] = (u32)cur;
      carry = cur >> 32;
    }
    cur = (u64)t[kWords] + carry;
    t[kWords - 1] = (u32)cur;
    t[kWords] = t[kWords + 1] + (u32)(cur >> 32);
  }
  reduce_once(r, t, t[kWords]);
}

IMT_HD void to_mont(Fr& r, const Fr& a) {
  Fr r2;
#pragma unroll
  for (int i = 0; i < kWords; ++i) r2.v[i] = r2_word(i);
  mont_mul(r, a, r2);
}

IMT_HD void from_mont(Fr& r, const Fr& a) {
  Fr one;
#pragma unroll
  for (int i = 0; i < kWords; ++i) one.v[i] = i == 0 ? 1u : 0u;
  mont_mul(r, a, one);
}

IMT_HD void pow5(Fr& x) {
  Fr x2, x4;
  mont_mul(x2, x, x);
  mont_mul(x4, x2, x2);
  mont_mul(x, x4, x);
}

// One permutation, the standard round structure (poseidon_ref.permute):
// add round constants, S-box (all words in full rounds, word 0 in partial
// rounds), MDS.
IMT_HD void permute(Fr st[kT], const Consts& c) {
#pragma unroll 1
  for (int r = 0; r < kRounds; ++r) {
    Fr s[kT];
#pragma unroll
    for (int i = 0; i < kT; ++i) add_mod(s[i], st[i], c.rc[r][i]);
    if (r >= kRF / 2 && r < kRF / 2 + kRP) {
      pow5(s[0]);
    } else {
#pragma unroll
      for (int i = 0; i < kT; ++i) pow5(s[i]);
    }
#pragma unroll
    for (int i = 0; i < kT; ++i) {
      Fr acc, p;
      mont_mul(acc, c.mds[i][0], s[0]);
#pragma unroll
      for (int j = 1; j < kT; ++j) {
        mont_mul(p, c.mds[i][j], s[j]);
        add_mod(acc, acc, p);
      }
      st[i] = acc;
    }
  }
}

// ---- per-lane bodies (limb-major global layouts, B lanes) ------------------

IMT_HD void load_node(Fr& x, const u32* src, long long B, long long lane) {
#pragma unroll
  for (int k = 0; k < kWords; ++k) x.v[k] = src[k * B + lane];
}

IMT_HD void store_node(u32* dst, const Fr& x, long long B, long long lane) {
#pragma unroll
  for (int k = 0; k < kWords; ++k) dst[k * B + lane] = x.v[k];
}

// canonical 16-bit limbs -> the same value in 32-bit words (each limb
// masked to 16 bits)
IMT_HD void load_limbs(Fr& x, const u32* src, long long B, long long lane) {
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    x.v[k] = (src[(2 * k) * B + lane] & 0xffffu) |
             (src[(2 * k + 1) * B + lane] << 16);
  }
}

IMT_HD void store_limbs(u32* dst, const Fr& x, long long B, long long lane) {
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    dst[(2 * k) * B + lane] = x.v[k] & 0xffffu;
    dst[(2 * k + 1) * B + lane] = x.v[k] >> 16;
  }
}

// st: [3, 8, B] nodes in and out
IMT_HD void permute_lane(const u32* in, u32* out, long long B, long long lane,
                         int n_perms, const Consts& c) {
  Fr st[kT];
#pragma unroll
  for (int j = 0; j < kT; ++j) load_node(st[j], in + j * kWords * B, B, lane);
  for (int n = 0; n < n_perms; ++n) permute(st, c);
#pragma unroll
  for (int j = 0; j < kT; ++j) store_node(out + j * kWords * B, st[j], B, lane);
}

// 2-to-1 sponge: [iv0, a, b] -> permute -> word1 += 1 -> permute -> word1
IMT_HD void hash2_lane(const u32* a, const u32* b, u32* out, long long B,
                       long long lane, const Consts& c) {
  Fr st[kT];
  st[0] = c.iv0;
  load_node(st[1], a, B, lane);
  load_node(st[2], b, B, lane);
  permute(st, c);
  add_mod(st[1], st[1], c.one);
  permute(st, c);
  store_node(out, st[1], B, lane);
}

// 3-to-1 leaf hash from canonical limbs: [iv0, a, b] -> permute ->
// words 1, 2 += (c, 1) -> permute -> word1 (node form)
IMT_HD void hash3_lane(const u32* a, const u32* b, const u32* c_in, u32* out,
                       long long B, long long lane, const Consts& c) {
  Fr st[kT], x;
  st[0] = c.iv0;
  load_limbs(x, a, B, lane);
  to_mont(st[1], x);
  load_limbs(x, b, B, lane);
  to_mont(st[2], x);
  permute(st, c);
  load_limbs(x, c_in, B, lane);
  to_mont(x, x);
  add_mod(st[1], st[1], x);
  add_mod(st[2], st[2], c.one);
  permute(st, c);
  store_node(out, st[1], B, lane);
}

IMT_HD void limbs_to_nodes_lane(const u32* in, u32* out, long long B,
                                long long lane) {
  Fr x;
  load_limbs(x, in, B, lane);
  to_mont(x, x);
  store_node(out, x, B, lane);
}

IMT_HD void nodes_to_limbs_lane(const u32* in, u32* out, long long B,
                                long long lane) {
  Fr x;
  load_node(x, in, B, lane);
  from_mont(x, x);
  store_limbs(out, x, B, lane);
}

void pack_consts(Consts& h, const u32* rc, const u32* mds, const u32* iv0,
                 const u32* one) {
  std::memcpy(h.rc, rc, sizeof(h.rc));
  std::memcpy(h.mds, mds, sizeof(h.mds));
  std::memcpy(h.iv0.v, iv0, sizeof(h.iv0.v));
  std::memcpy(h.one.v, one, sizeof(h.one.v));
}

}  // namespace

#ifdef __CUDACC__

namespace {

constexpr int kBlock = 128;

__constant__ Consts g_consts;

__device__ __forceinline__ long long lane_id() {
  return (long long)blockIdx.x * blockDim.x + threadIdx.x;
}

__global__ void __launch_bounds__(kBlock)
permute_kernel(const u32* in, u32* out, long long B, int n_perms) {
  const long long lane = lane_id();
  if (lane >= B) return;
  permute_lane(in, out, B, lane, n_perms, g_consts);
}

__global__ void __launch_bounds__(kBlock)
hash2_kernel(const u32* a, const u32* b, u32* out, long long B) {
  const long long lane = lane_id();
  if (lane >= B) return;
  hash2_lane(a, b, out, B, lane, g_consts);
}

__global__ void __launch_bounds__(kBlock)
hash3_kernel(const u32* a, const u32* b, const u32* c, u32* out,
             long long B) {
  const long long lane = lane_id();
  if (lane >= B) return;
  hash3_lane(a, b, c, out, B, lane, g_consts);
}

__global__ void __launch_bounds__(kBlock)
limbs_to_nodes_kernel(const u32* in, u32* out, long long B) {
  const long long lane = lane_id();
  if (lane >= B) return;
  limbs_to_nodes_lane(in, out, B, lane);
}

__global__ void __launch_bounds__(kBlock)
nodes_to_limbs_kernel(const u32* in, u32* out, long long B) {
  const long long lane = lane_id();
  if (lane >= B) return;
  nodes_to_limbs_lane(in, out, B, lane);
}

unsigned grid_for(long long B) {
  return (unsigned)((B + kBlock - 1) / kBlock);
}

}  // namespace

extern "C" {

// Copy the Montgomery constant tables (uint32 words: rc [65][3][8],
// mds [3][3][8], iv0 [8], one [8]) into constant memory of the current
// device.  Called once per process and device, before any launch.
int imt_init_constants(const u32* rc, const u32* mds, const u32* iv0,
                       const u32* one) {
  Consts h;
  pack_consts(h, rc, mds, iv0, one);
  return (int)cudaMemcpyToSymbol(g_consts, &h, sizeof(h));
}

int imt_permute_n(const void* in, void* out, long long B, int n_perms,
                  void* stream) {
  if (B > 0) {
    permute_kernel<<<grid_for(B), kBlock, 0, (cudaStream_t)stream>>>(
        (const u32*)in, (u32*)out, B, n_perms);
  }
  return (int)cudaGetLastError();
}

int imt_hash2_nodes(const void* a, const void* b, void* out, long long B,
                    void* stream) {
  if (B > 0) {
    hash2_kernel<<<grid_for(B), kBlock, 0, (cudaStream_t)stream>>>(
        (const u32*)a, (const u32*)b, (u32*)out, B);
  }
  return (int)cudaGetLastError();
}

int imt_hash3_leaf(const void* a, const void* b, const void* c, void* out,
                   long long B, void* stream) {
  if (B > 0) {
    hash3_kernel<<<grid_for(B), kBlock, 0, (cudaStream_t)stream>>>(
        (const u32*)a, (const u32*)b, (const u32*)c, (u32*)out, B);
  }
  return (int)cudaGetLastError();
}

int imt_limbs_to_nodes(const void* in, void* out, long long B, void* stream) {
  if (B > 0) {
    limbs_to_nodes_kernel<<<grid_for(B), kBlock, 0, (cudaStream_t)stream>>>(
        (const u32*)in, (u32*)out, B);
  }
  return (int)cudaGetLastError();
}

int imt_nodes_to_limbs(const void* in, void* out, long long B, void* stream) {
  if (B > 0) {
    nodes_to_limbs_kernel<<<grid_for(B), kBlock, 0, (cudaStream_t)stream>>>(
        (const u32*)in, (u32*)out, B);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"

#endif  // __CUDACC__
