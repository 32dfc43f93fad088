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
// some 600 field multiplies each, and each multiply is 128 32x32->64-bit
// multiply-adds and 8 32-bit products (8x32-bit CIOS).  At the main path's
// widths (2 to 8192 lanes) a launch does not fill the card, so its time is
// one thread's dependent instruction chain.
// One thread per lane, the whole state in registers, the constants
// (Montgomery form) in __constant__ memory, where every thread of a warp
// reads the same word.  Two permutation cores:
//
// - permute (the dense core, imt_permute_n): the standard round structure
//   of poseidon_ref.permute, 828 products per permutation, with the CIOS
//   product of imt_tpu/native/imt_native.cpp on 64-bit C++ accumulators.
// - permute_sparse (the hash kernels): the optimized-spec schedule of
//   ops/poseidon_opt.py::permute_opt -- 4 full rounds (the last with the
//   folded MDS), 57 partial rounds of one S-box and a sparse matrix (3 + 5
//   products), 4 full rounds: 600 products per permutation -- on a CIOS
//   product (mont_mul_cc) whose rows are eight independent 64-bit
//   multiply-adds (IMAD.WIDE.U32) and one PTX carry chain of adds.  Each
//   chain (a row of the product, a row of the reduction, the final
//   subtraction) is one asm statement: the carry flag does not survive
//   from one asm statement to the next.
//
// Both cores compute the same permutation, so the hashes equal the plain
// version bit for bit.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC; a plain C interface, bound with ctypes (ops/_build.py).
// Each launcher returns cudaGetLastError(); launches go on the caller's
// stream, never synchronise, and allocate nothing.  The arithmetic and the
// per-lane bodies are plain C++ (IMT_HD), so they also compile for the host:
// there the carry-chained functions take the C++ branch of the same
// arithmetic, which a host build (g++) holds against ops/poseidon.py.

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

constexpr int kHalf = kRF / 2;
constexpr int kSparse = 5;   // m00, v1, v2, w1, w2

// All tables in Montgomery form.  The host packs them word by word in this
// order (poseidon_spec.kernel_words).
struct Consts {
  Fr rc[kRounds][kT];  // round constants
  Fr mds[kT][kT];      // MDS matrix
  Fr iv0;              // 2^64 mod p (sponge capacity word)
  Fr one;              // 1 (squeeze pad word)
  // the sparse schedule (poseidon_opt.optimize_params)
  Fr pre[kHalf][kT];        // leading full rounds' constants
  Fr mds_pre[kT][kT];       // MDS of the last leading full round, folded
  Fr c0[kRP];               // partial rounds' word-0 constants
  Fr sparse[kRP][kSparse];  // partial rounds' sparse matrices
  Fr post[kHalf][kT];       // trailing full rounds' constants
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

// ---- carry-chained arithmetic ----------------------------------------------
//
// The same functions as add_mod / mont_mul / reduce_once, with every carry
// in a PTX carry chain (add.cc / addc, sub.cc / subc).  The carry flag is
// not kept from one asm statement to the next, so each chain is one
// statement.  The host branch is the C++ arithmetic above.

#ifdef __CUDA_ARCH__

// r = t - p if t[8:0] >= p else t (t < 2p, t[8] its ninth word)
__device__ __forceinline__ void reduce_once_cc(Fr& r,
                                               const u32 t[kWords + 1]) {
  u32 d[kWords], hi = t[kWords];
#pragma unroll
  for (int i = 0; i < kWords; ++i) d[i] = t[i];
  asm("sub.cc.u32 %0, %0, %9;\n\t"
      "subc.cc.u32 %1, %1, %10;\n\t"
      "subc.cc.u32 %2, %2, %11;\n\t"
      "subc.cc.u32 %3, %3, %12;\n\t"
      "subc.cc.u32 %4, %4, %13;\n\t"
      "subc.cc.u32 %5, %5, %14;\n\t"
      "subc.cc.u32 %6, %6, %15;\n\t"
      "subc.cc.u32 %7, %7, %16;\n\t"
      "subc.u32 %8, %8, %17;"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(hi)
      : "r"(mod_word(0)), "r"(mod_word(1)), "r"(mod_word(2)),
        "r"(mod_word(3)), "r"(mod_word(4)), "r"(mod_word(5)),
        "r"(mod_word(6)), "r"(mod_word(7)), "r"(0u));
  // hi = t[8] - borrow: all ones exactly when t < p
  const bool use_d = hi != 0xffffffffu;
#pragma unroll
  for (int i = 0; i < kWords; ++i) r.v[i] = use_d ? d[i] : t[i];
}

// One row of the CIOS product: t[0..9] = t[0..8] + ai * b.  The eight
// 32x32-bit products, each with its word of t added, are 64-bit multiply-
// adds (mad.wide.u32: one IMAD.WIDE.U32 each, no overflow, independent of
// one another); one carry chain then adds each high half to the next low
// half.  (mad.lo.cc / madc.hi.cc chains cost two instructions per half on
// this card: IMAD has no carry-in-and-out form, so each becomes a multiply
// and an IADD3.X.)
__device__ __forceinline__ void mac_row(u32 t[kWords + 2], u32 ai,
                                        const Fr& b) {
  u64 p[kWords];
#pragma unroll
  for (int j = 0; j < kWords; ++j) p[j] = (u64)ai * b.v[j] + t[j];
  asm("{\n\t.reg .u32 l<8>, h<8>;\n\t"
      "mov.b64 {l0, h0}, %10;\n\t"
      "mov.b64 {l1, h1}, %11;\n\t"
      "mov.b64 {l2, h2}, %12;\n\t"
      "mov.b64 {l3, h3}, %13;\n\t"
      "mov.b64 {l4, h4}, %14;\n\t"
      "mov.b64 {l5, h5}, %15;\n\t"
      "mov.b64 {l6, h6}, %16;\n\t"
      "mov.b64 {l7, h7}, %17;\n\t"
      "mov.b32 %0, l0;\n\t"
      "add.cc.u32 %1, l1, h0;\n\t"
      "addc.cc.u32 %2, l2, h1;\n\t"
      "addc.cc.u32 %3, l3, h2;\n\t"
      "addc.cc.u32 %4, l4, h3;\n\t"
      "addc.cc.u32 %5, l5, h4;\n\t"
      "addc.cc.u32 %6, l6, h5;\n\t"
      "addc.cc.u32 %7, l7, h6;\n\t"
      "addc.cc.u32 %8, %18, h7;\n\t"
      "addc.u32 %9, %19, %19;\n\t}"
      : "=r"(t[0]), "=r"(t[1]), "=r"(t[2]), "=r"(t[3]), "=r"(t[4]),
        "=r"(t[5]), "=r"(t[6]), "=r"(t[7]), "=r"(t[8]), "=r"(t[9])
      : "l"(p[0]), "l"(p[1]), "l"(p[2]), "l"(p[3]), "l"(p[4]), "l"(p[5]),
        "l"(p[6]), "l"(p[7]), "r"(t[8]), "r"(0u));
}

// One row of the reduction: m = t[0] * (-p^-1); t = (t + m * p) >> 32 (the
// low word of t + m * p is 0).  The same shape as mac_row.
__device__ __forceinline__ void redc_row(u32 t[kWords + 2]) {
  const u32 m = t[0] * kInv;
  u64 p[kWords];
#pragma unroll
  for (int j = 0; j < kWords; ++j) p[j] = (u64)m * mod_word(j) + t[j];
  asm("{\n\t.reg .u32 l<8>, h<8>;\n\t"
      "mov.b64 {l0, h0}, %9;\n\t"
      "mov.b64 {l1, h1}, %10;\n\t"
      "mov.b64 {l2, h2}, %11;\n\t"
      "mov.b64 {l3, h3}, %12;\n\t"
      "mov.b64 {l4, h4}, %13;\n\t"
      "mov.b64 {l5, h5}, %14;\n\t"
      "mov.b64 {l6, h6}, %15;\n\t"
      "mov.b64 {l7, h7}, %16;\n\t"
      "add.cc.u32 %0, l1, h0;\n\t"
      "addc.cc.u32 %1, l2, h1;\n\t"
      "addc.cc.u32 %2, l3, h2;\n\t"
      "addc.cc.u32 %3, l4, h3;\n\t"
      "addc.cc.u32 %4, l5, h4;\n\t"
      "addc.cc.u32 %5, l6, h5;\n\t"
      "addc.cc.u32 %6, l7, h6;\n\t"
      "addc.cc.u32 %7, %17, h7;\n\t"
      "addc.u32 %8, %18, %19;\n\t}"
      : "=r"(t[0]), "=r"(t[1]), "=r"(t[2]), "=r"(t[3]), "=r"(t[4]),
        "=r"(t[5]), "=r"(t[6]), "=r"(t[7]), "=r"(t[8])
      : "l"(p[0]), "l"(p[1]), "l"(p[2]), "l"(p[3]), "l"(p[4]), "l"(p[5]),
        "l"(p[6]), "l"(p[7]), "r"(t[8]), "r"(t[9]), "r"(0u));
  t[kWords + 1] = 0;
}

#endif  // __CUDA_ARCH__

IMT_HD void add_mod_cc(Fr& r, const Fr& a, const Fr& b) {
#ifdef __CUDA_ARCH__
  u32 s[kWords + 1];
#pragma unroll
  for (int i = 0; i < kWords; ++i) s[i] = a.v[i];
  s[kWords] = 0;
  asm("add.cc.u32 %0, %0, %9;\n\t"
      "addc.cc.u32 %1, %1, %10;\n\t"
      "addc.cc.u32 %2, %2, %11;\n\t"
      "addc.cc.u32 %3, %3, %12;\n\t"
      "addc.cc.u32 %4, %4, %13;\n\t"
      "addc.cc.u32 %5, %5, %14;\n\t"
      "addc.cc.u32 %6, %6, %15;\n\t"
      "addc.cc.u32 %7, %7, %16;\n\t"
      "addc.u32 %8, %8, %8;"
      : "+r"(s[0]), "+r"(s[1]), "+r"(s[2]), "+r"(s[3]), "+r"(s[4]),
        "+r"(s[5]), "+r"(s[6]), "+r"(s[7]), "+r"(s[8])
      : "r"(b.v[0]), "r"(b.v[1]), "r"(b.v[2]), "r"(b.v[3]), "r"(b.v[4]),
        "r"(b.v[5]), "r"(b.v[6]), "r"(b.v[7]));
  reduce_once_cc(r, s);
#else
  add_mod(r, a, b);
#endif
}

// r = a*b/R mod p, the CIOS product of mont_mul (same result, < p) with its
// carries in PTX carry chains.  r may alias a or b.
IMT_HD void mont_mul_cc(Fr& r, const Fr& a, const Fr& b) {
#ifdef __CUDA_ARCH__
  u32 t[kWords + 2];
#pragma unroll
  for (int j = 0; j < kWords + 2; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    mac_row(t, a.v[i], b);
    redc_row(t);
  }
  reduce_once_cc(r, t);
#else
  mont_mul(r, a, b);
#endif
}

IMT_HD void to_mont(Fr& r, const Fr& a) {
  Fr r2;
#pragma unroll
  for (int i = 0; i < kWords; ++i) r2.v[i] = r2_word(i);
  mont_mul_cc(r, a, r2);
}

IMT_HD void pow5_cc(Fr& x) {
  Fr x2, x4;
  mont_mul_cc(x2, x, x);
  mont_mul_cc(x4, x2, x2);
  mont_mul_cc(x, x4, x);
}

// ---- the sparse core (poseidon_opt.permute_opt) -----------------------------

// add constants, S-box on every word, dense MDS: 18 products
IMT_HD void full_round_sparse(Fr st[kT], const Fr rc[kT],
                              const Fr mds[kT][kT]) {
  Fr s[kT];
#pragma unroll
  for (int i = 0; i < kT; ++i) {
    add_mod_cc(s[i], st[i], rc[i]);
    pow5_cc(s[i]);
  }
#pragma unroll
  for (int i = 0; i < kT; ++i) {
    Fr acc, p;
    mont_mul_cc(acc, mds[i][0], s[0]);
#pragma unroll
    for (int j = 1; j < kT; ++j) {
      mont_mul_cc(p, mds[i][j], s[j]);
      add_mod_cc(acc, acc, p);
    }
    st[i] = acc;
  }
}

// One permutation: 4 full rounds (the last with the folded MDS), 57 partial
// rounds (x0 += c0, s = x0^5, x0 = m00 s + v1 x1 + v2 x2, x1 += w1 s,
// x2 += w2 s: 8 products), 4 full rounds.  600 products in all.  Every
// matrix is a fixed constant-bank address (the last leading round runs
// outside the loop), so its words are instruction operands: picking the
// matrix per round made the compiler load them into registers, and spill.
IMT_HD void permute_sparse(Fr st[kT], const Consts& c) {
#pragma unroll 1
  for (int r = 0; r < kHalf - 1; ++r) full_round_sparse(st, c.pre[r], c.mds);
  full_round_sparse(st, c.pre[kHalf - 1], c.mds_pre);
#pragma unroll 1
  for (int r = 0; r < kRP; ++r) {
    const Fr* m = c.sparse[r];
    Fr s, x0, p;
    add_mod_cc(s, st[0], c.c0[r]);
    pow5_cc(s);
    mont_mul_cc(x0, m[0], s);
    mont_mul_cc(p, m[1], st[1]);
    add_mod_cc(x0, x0, p);
    mont_mul_cc(p, m[2], st[2]);
    add_mod_cc(x0, x0, p);
    mont_mul_cc(p, m[3], s);
    add_mod_cc(st[1], st[1], p);
    mont_mul_cc(p, m[4], s);
    add_mod_cc(st[2], st[2], p);
    st[0] = x0;
  }
#pragma unroll 1
  for (int r = 0; r < kHalf; ++r) full_round_sparse(st, c.post[r], c.mds);
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
  permute_sparse(st, c);
  add_mod_cc(st[1], st[1], c.one);
  permute_sparse(st, c);
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
  permute_sparse(st, c);
  load_limbs(x, c_in, B, lane);
  to_mont(x, x);
  add_mod_cc(st[1], st[1], x);
  add_mod_cc(st[2], st[2], c.one);
  permute_sparse(st, c);
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

// The tables from their words in struct order; false if the count differs.
bool pack_consts(Consts& h, const u32* words, long long n_words) {
  if (n_words * (long long)sizeof(u32) != (long long)sizeof(Consts)) {
    return false;
  }
  std::memcpy(&h, words, sizeof(Consts));
  return true;
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

// Copy the Montgomery constant tables (the uint32 words of Consts, in its
// field order) into constant memory of the current device.  Called once per
// process and device, before any launch.  Returns -1 if n_words does not
// match the struct.
int imt_init_constants(const u32* words, long long n_words) {
  Consts h;
  if (!pack_consts(h, words, n_words)) return -1;
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
