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
// What bounds it: 32-bit integer multiply-adds, not memory.  A hash reads
// 64-96 B and writes 32 B per lane, against two permutations of some 600
// field multiplies each, and each multiply is 128 32x32->64-bit
// multiply-adds and 8 32-bit products (8x32-bit CIOS).  The state stays in
// registers, the constants (Montgomery form) in __constant__ memory, where
// every thread of a warp reads the same word.  Three permutation cores, all
// on the optimized-spec schedule of ops/poseidon_opt.py::permute_opt -- 4
// full rounds (the last with the folded MDS), 57 partial rounds of one
// S-box and a sparse matrix, 4 full rounds:
//
// - permute_sparse (the hash kernels, one thread a lane): 600 Montgomery
//   products per permutation, each a CIOS product (mont_mul_cc) whose rows
//   are eight independent 64-bit multiply-adds (IMAD.WIDE.U32) and one PTX
//   carry chain of adds.  Each chain (a row of the product, a row of the
//   reduction, the final subtraction) is one asm statement: the carry flag
//   does not survive from one asm statement to the next.
// - permute_coop (the hash kernels, a group of kCoop = 4 threads a lane):
//   the same products, each round's independent ones split between the
//   group's threads, which exchange words by warp shuffles: a partial
//   round is three products in a row where permute_sparse takes eight, a
//   full round an S-box and one reduced dot (see the section).  Its four
//   threads do about 1.5 times permute_sparse's work between them.
// - permute_lazy (K1, imt_permute_n): the least-work arithmetic on the
//   same schedule.  Each dot product (an MDS row; a partial round's
//   m00 s + v1 x1 + v2 x2) sums its three products' rows before one
//   reduction row per row (mont_dot3), and each S-box square takes its 36
//   products with a separated reduction (mont_sqr): 61,896 wide and 3,504
//   32-bit multiply-adds per permutation, against the sparse core's 76,800
//   and 4,800.  Every intermediate word is fully reduced, so a chain of
//   permutations carries node-form states.
//
// Which bounds each hash path: a narrow launch does not fill the card, so
// its time is one lane's dependent instruction chain; the cooperative
// kernels shorten that chain (0.47 against 0.75 ms a hash2 launch of 1 to
// 4,096 lanes on an H100).  A wide launch is bound by the multiply-add
// throughput, where the cooperative kernels' extra work loses: the
// launchers take them up to kCoopLanesPerSM lanes an SM (lane_threads) and
// one thread a lane above.
//
// The three cores compute the same permutation, so the outputs equal the
// plain version bit for bit.
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

// ---- K1's core: one reduction per dot, squares of 36 products -------------
//
// The sparse core's schedule with the least-work arithmetic.  A dot product
// (each MDS row, each partial round's m00 s + v1 x1 + v2 x2) sums its three
// products unreduced and reduces once: in CIOS form (mont_dot3) each of the
// 8 rows adds the three products' rows before its one reduction row, 256
// wide multiply-adds and 8 32-bit ones per dot, where three mont_mul_cc
// products take 384 and 24 and two add_mod_cc follow.  A square (mont_sqr)
// computes each cross product once, doubles, adds the 8 squares, then
// reduces: 100 wide multiply-adds, where mont_mul_cc takes 128.

#ifdef __CUDA_ARCH__

// t[0..9] += ai * b, as mac_row, with t[9] holding the carries of the
// earlier rows since the last reduction row (< 4) instead of 0.
__device__ __forceinline__ void mac_row_acc(u32 t[kWords + 2], u32 ai,
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
      "addc.u32 %9, %19, %20;\n\t}"
      : "=r"(t[0]), "=r"(t[1]), "=r"(t[2]), "=r"(t[3]), "=r"(t[4]),
        "=r"(t[5]), "=r"(t[6]), "=r"(t[7]), "=r"(t[8]), "=r"(t[9])
      : "l"(p[0]), "l"(p[1]), "l"(p[2]), "l"(p[3]), "l"(p[4]), "l"(p[5]),
        "l"(p[6]), "l"(p[7]), "r"(t[8]), "r"(t[9]), "r"(0u));
}

#endif  // __CUDA_ARCH__

// r = (a[0] b[0] + a[1] b[1] + a[2] b[2]) / R mod p, < p, with one
// Montgomery reduction per row of the CIOS product instead of one per
// product.  Every a[k] and b[k] < p: the sum stays below 3 p^2 < p R, so
// the result is < 2p before the final subtraction, and between rows t < 4p
// plus the rows' products, inside t[0..9] with t[9] < 4.
IMT_HD void mont_dot3(Fr& r, const Fr a[kT], const Fr b[kT]) {
  u32 t[kWords + 2];
#pragma unroll
  for (int j = 0; j < kWords + 2; ++j) t[j] = 0;
#ifdef __CUDA_ARCH__
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
#pragma unroll
    for (int k = 0; k < kT; ++k) mac_row_acc(t, a[k].v[i], b[k]);
    redc_row(t);
  }
  reduce_once_cc(r, t);
#else
  for (int i = 0; i < kWords; ++i) {
    for (int k = 0; k < kT; ++k) {
      u64 carry = 0;
      for (int j = 0; j < kWords; ++j) {
        u64 cur = (u64)a[k].v[i] * b[k].v[j] + t[j] + carry;
        t[j] = (u32)cur;
        carry = cur >> 32;
      }
      u64 cur = (u64)t[kWords] + carry;
      t[kWords] = (u32)cur;
      t[kWords + 1] += (u32)(cur >> 32);
    }
    const u32 m = t[0] * kInv;
    u64 carry = ((u64)m * mod_word(0) + t[0]) >> 32;
    for (int j = 1; j < kWords; ++j) {
      u64 cur = (u64)m * mod_word(j) + t[j] + carry;
      t[j - 1] = (u32)cur;
      carry = cur >> 32;
    }
    u64 cur = (u64)t[kWords] + carry;
    t[kWords - 1] = (u32)cur;
    t[kWords] = t[kWords + 1] + (u32)(cur >> 32);
    t[kWords + 1] = 0;
  }
  reduce_once(r, t, t[kWords]);
#endif
}

#ifdef __CUDA_ARCH__

// t[0..15] = a^2: the 28 cross products a_i a_j (i < j) once, in rows of
// 64-bit multiply-adds and one carry chain each, doubled by funnel shifts,
// then the 8 squares a_i^2 added in one chain: 36 wide multiply-adds.
__device__ __forceinline__ void sqr_wide(u32 t[2 * kWords], const Fr& a) {
#pragma unroll
  for (int k = 0; k < 2 * kWords; ++k) t[k] = 0;
  {
    u64 p[7];
    p[0] = (u64)a.v[0] * a.v[1] + t[1];
    p[1] = (u64)a.v[0] * a.v[2] + t[2];
    p[2] = (u64)a.v[0] * a.v[3] + t[3];
    p[3] = (u64)a.v[0] * a.v[4] + t[4];
    p[4] = (u64)a.v[0] * a.v[5] + t[5];
    p[5] = (u64)a.v[0] * a.v[6] + t[6];
    p[6] = (u64)a.v[0] * a.v[7] + t[7];
    asm("{\n\t.reg .u32 l<7>, h<7>;\n\t"
        "mov.b64 {l0, h0}, %8;\n\t"
        "mov.b64 {l1, h1}, %9;\n\t"
        "mov.b64 {l2, h2}, %10;\n\t"
        "mov.b64 {l3, h3}, %11;\n\t"
        "mov.b64 {l4, h4}, %12;\n\t"
        "mov.b64 {l5, h5}, %13;\n\t"
        "mov.b64 {l6, h6}, %14;\n\t"
        "mov.b32 %0, l0;\n\t"
        "add.cc.u32 %1, l1, h0;\n\t"
        "addc.cc.u32 %2, l2, h1;\n\t"
        "addc.cc.u32 %3, l3, h2;\n\t"
        "addc.cc.u32 %4, l4, h3;\n\t"
        "addc.cc.u32 %5, l5, h4;\n\t"
        "addc.cc.u32 %6, l6, h5;\n\t"
        "addc.u32 %7, h6, 0;\n\t}"
        : "=r"(t[1]), "=r"(t[2]), "=r"(t[3]), "=r"(t[4]), "=r"(t[5]),
          "=r"(t[6]), "=r"(t[7]), "=r"(t[8])
        : "l"(p[0]), "l"(p[1]), "l"(p[2]), "l"(p[3]), "l"(p[4]), "l"(p[5]),
          "l"(p[6]));
  }
  {
    u64 p[6];
    p[0] = (u64)a.v[1] * a.v[2] + t[3];
    p[1] = (u64)a.v[1] * a.v[3] + t[4];
    p[2] = (u64)a.v[1] * a.v[4] + t[5];
    p[3] = (u64)a.v[1] * a.v[5] + t[6];
    p[4] = (u64)a.v[1] * a.v[6] + t[7];
    p[5] = (u64)a.v[1] * a.v[7] + t[8];
    asm("{\n\t.reg .u32 l<6>, h<6>;\n\t"
        "mov.b64 {l0, h0}, %7;\n\t"
        "mov.b64 {l1, h1}, %8;\n\t"
        "mov.b64 {l2, h2}, %9;\n\t"
        "mov.b64 {l3, h3}, %10;\n\t"
        "mov.b64 {l4, h4}, %11;\n\t"
        "mov.b64 {l5, h5}, %12;\n\t"
        "mov.b32 %0, l0;\n\t"
        "add.cc.u32 %1, l1, h0;\n\t"
        "addc.cc.u32 %2, l2, h1;\n\t"
        "addc.cc.u32 %3, l3, h2;\n\t"
        "addc.cc.u32 %4, l4, h3;\n\t"
        "addc.cc.u32 %5, l5, h4;\n\t"
        "addc.u32 %6, h5, 0;\n\t}"
        : "=r"(t[3]), "=r"(t[4]), "=r"(t[5]), "=r"(t[6]), "=r"(t[7]),
          "=r"(t[8]), "=r"(t[9])
        : "l"(p[0]), "l"(p[1]), "l"(p[2]), "l"(p[3]), "l"(p[4]), "l"(p[5]));
  }
  {
    u64 p[5];
    p[0] = (u64)a.v[2] * a.v[3] + t[5];
    p[1] = (u64)a.v[2] * a.v[4] + t[6];
    p[2] = (u64)a.v[2] * a.v[5] + t[7];
    p[3] = (u64)a.v[2] * a.v[6] + t[8];
    p[4] = (u64)a.v[2] * a.v[7] + t[9];
    asm("{\n\t.reg .u32 l<5>, h<5>;\n\t"
        "mov.b64 {l0, h0}, %6;\n\t"
        "mov.b64 {l1, h1}, %7;\n\t"
        "mov.b64 {l2, h2}, %8;\n\t"
        "mov.b64 {l3, h3}, %9;\n\t"
        "mov.b64 {l4, h4}, %10;\n\t"
        "mov.b32 %0, l0;\n\t"
        "add.cc.u32 %1, l1, h0;\n\t"
        "addc.cc.u32 %2, l2, h1;\n\t"
        "addc.cc.u32 %3, l3, h2;\n\t"
        "addc.cc.u32 %4, l4, h3;\n\t"
        "addc.u32 %5, h4, 0;\n\t}"
        : "=r"(t[5]), "=r"(t[6]), "=r"(t[7]), "=r"(t[8]), "=r"(t[9]),
          "=r"(t[10])
        : "l"(p[0]), "l"(p[1]), "l"(p[2]), "l"(p[3]), "l"(p[4]));
  }
  {
    u64 p[4];
    p[0] = (u64)a.v[3] * a.v[4] + t[7];
    p[1] = (u64)a.v[3] * a.v[5] + t[8];
    p[2] = (u64)a.v[3] * a.v[6] + t[9];
    p[3] = (u64)a.v[3] * a.v[7] + t[10];
    asm("{\n\t.reg .u32 l<4>, h<4>;\n\t"
        "mov.b64 {l0, h0}, %5;\n\t"
        "mov.b64 {l1, h1}, %6;\n\t"
        "mov.b64 {l2, h2}, %7;\n\t"
        "mov.b64 {l3, h3}, %8;\n\t"
        "mov.b32 %0, l0;\n\t"
        "add.cc.u32 %1, l1, h0;\n\t"
        "addc.cc.u32 %2, l2, h1;\n\t"
        "addc.cc.u32 %3, l3, h2;\n\t"
        "addc.u32 %4, h3, 0;\n\t}"
        : "=r"(t[7]), "=r"(t[8]), "=r"(t[9]), "=r"(t[10]), "=r"(t[11])
        : "l"(p[0]), "l"(p[1]), "l"(p[2]), "l"(p[3]));
  }
  {
    u64 p[3];
    p[0] = (u64)a.v[4] * a.v[5] + t[9];
    p[1] = (u64)a.v[4] * a.v[6] + t[10];
    p[2] = (u64)a.v[4] * a.v[7] + t[11];
    asm("{\n\t.reg .u32 l<3>, h<3>;\n\t"
        "mov.b64 {l0, h0}, %4;\n\t"
        "mov.b64 {l1, h1}, %5;\n\t"
        "mov.b64 {l2, h2}, %6;\n\t"
        "mov.b32 %0, l0;\n\t"
        "add.cc.u32 %1, l1, h0;\n\t"
        "addc.cc.u32 %2, l2, h1;\n\t"
        "addc.u32 %3, h2, 0;\n\t}"
        : "=r"(t[9]), "=r"(t[10]), "=r"(t[11]), "=r"(t[12])
        : "l"(p[0]), "l"(p[1]), "l"(p[2]));
  }
  {
    u64 p[2];
    p[0] = (u64)a.v[5] * a.v[6] + t[11];
    p[1] = (u64)a.v[5] * a.v[7] + t[12];
    asm("{\n\t.reg .u32 l<2>, h<2>;\n\t"
        "mov.b64 {l0, h0}, %3;\n\t"
        "mov.b64 {l1, h1}, %4;\n\t"
        "mov.b32 %0, l0;\n\t"
        "add.cc.u32 %1, l1, h0;\n\t"
        "addc.u32 %2, h1, 0;\n\t}"
        : "=r"(t[11]), "=r"(t[12]), "=r"(t[13])
        : "l"(p[0]), "l"(p[1]));
  }
  {
    const u64 p = (u64)a.v[6] * a.v[7] + t[13];
    t[13] = (u32)p;
    t[14] = (u32)(p >> 32);
  }
#pragma unroll
  for (int k = 2 * kWords - 1; k > 1; --k) {
    t[k] = __funnelshift_l(t[k - 1], t[k], 1);
  }
  t[1] <<= 1;
  u64 q[kWords];
#pragma unroll
  for (int i = 0; i < kWords; ++i) q[i] = (u64)a.v[i] * a.v[i];
  asm("{\n\t.reg .u32 l<8>, h<8>;\n\t"
      "mov.b64 {l0, h0}, %16;\n\t"
      "mov.b64 {l1, h1}, %17;\n\t"
      "mov.b64 {l2, h2}, %18;\n\t"
      "mov.b64 {l3, h3}, %19;\n\t"
      "mov.b64 {l4, h4}, %20;\n\t"
      "mov.b64 {l5, h5}, %21;\n\t"
      "mov.b64 {l6, h6}, %22;\n\t"
      "mov.b64 {l7, h7}, %23;\n\t"
      "add.cc.u32 %0, %0, l0;\n\t"
      "addc.cc.u32 %1, %1, h0;\n\t"
      "addc.cc.u32 %2, %2, l1;\n\t"
      "addc.cc.u32 %3, %3, h1;\n\t"
      "addc.cc.u32 %4, %4, l2;\n\t"
      "addc.cc.u32 %5, %5, h2;\n\t"
      "addc.cc.u32 %6, %6, l3;\n\t"
      "addc.cc.u32 %7, %7, h3;\n\t"
      "addc.cc.u32 %8, %8, l4;\n\t"
      "addc.cc.u32 %9, %9, h4;\n\t"
      "addc.cc.u32 %10, %10, l5;\n\t"
      "addc.cc.u32 %11, %11, h5;\n\t"
      "addc.cc.u32 %12, %12, l6;\n\t"
      "addc.cc.u32 %13, %13, h6;\n\t"
      "addc.cc.u32 %14, %14, l7;\n\t"
      "addc.u32 %15, %15, h7;\n\t}"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]),
        "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9]),
        "+r"(t[10]), "+r"(t[11]), "+r"(t[12]), "+r"(t[13]), "+r"(t[14]),
        "+r"(t[15])
      : "l"(q[0]), "l"(q[1]), "l"(q[2]), "l"(q[3]), "l"(q[4]), "l"(q[5]),
        "l"(q[6]), "l"(q[7]));
}

// One row of the separated reduction, on t[0..8] of the 16-word product:
// m = t[0] * (-p^-1), t += m * p (its low word becomes 0).  e carries the
// previous row's carry out of its top word, which lands on this row's
// t[8]: it rides in the high half of the last product's addend, and the
// row's own carry out goes back in e.
__device__ __forceinline__ void sos_redc_row(u32 t[kWords + 1], u32& e) {
  const u32 m = t[0] * kInv;
  u64 p[kWords];
#pragma unroll
  for (int j = 0; j < kWords - 1; ++j) p[j] = (u64)m * mod_word(j) + t[j];
  p[kWords - 1] = (u64)m * mod_word(kWords - 1) +
                  (((u64)e << 32) | t[kWords - 1]);
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
      "addc.u32 %8, %18, %18;\n\t}"
      : "=r"(t[1]), "=r"(t[2]), "=r"(t[3]), "=r"(t[4]), "=r"(t[5]),
        "=r"(t[6]), "=r"(t[7]), "=r"(t[8]), "=r"(e)
      : "l"(p[0]), "l"(p[1]), "l"(p[2]), "l"(p[3]), "l"(p[4]), "l"(p[5]),
        "l"(p[6]), "l"(p[7]), "r"(t[8]), "r"(0u));
}

#endif  // __CUDA_ARCH__

// r = a^2 / R mod p, < p: the square's 36 products (sqr_wide), then the
// separated reduction, 8 rows of sos_redc_row.  a < p: a^2 < p R, so the
// result is < 2p before the final subtraction, and the last row's carry
// out is 0.
IMT_HD void mont_sqr(Fr& r, const Fr& a) {
  u32 t[2 * kWords], e = 0;
#ifdef __CUDA_ARCH__
  sqr_wide(t, a);
#pragma unroll
  for (int i = 0; i < kWords; ++i) sos_redc_row(t + i, e);
  u32 u[kWords + 1];
#pragma unroll
  for (int k = 0; k < kWords; ++k) u[k] = t[kWords + k];
  u[kWords] = e;
  reduce_once_cc(r, u);
#else
  for (int k = 0; k < 2 * kWords; ++k) t[k] = 0;
  for (int i = 0; i < kWords - 1; ++i) {
    u64 carry = 0;
    for (int j = i + 1; j < kWords; ++j) {
      u64 cur = (u64)a.v[i] * a.v[j] + t[i + j] + carry;
      t[i + j] = (u32)cur;
      carry = cur >> 32;
    }
    t[i + kWords] = (u32)carry;
  }
  for (int k = 2 * kWords - 1; k > 0; --k) {
    t[k] = (t[k] << 1) | (t[k - 1] >> 31);
  }
  t[0] <<= 1;
  u64 carry = 0;
  for (int i = 0; i < kWords; ++i) {
    u64 cur = (u64)a.v[i] * a.v[i] + t[2 * i] + carry;
    t[2 * i] = (u32)cur;
    cur = (u64)t[2 * i + 1] + (cur >> 32);
    t[2 * i + 1] = (u32)cur;
    carry = cur >> 32;
  }
  for (int i = 0; i < kWords; ++i) {
    const u32 m = t[i] * kInv;
    u64 c = ((u64)m * mod_word(0) + t[i]) >> 32;
    for (int j = 1; j < kWords; ++j) {
      u64 cur = (u64)m * mod_word(j) + t[i + j] + c;
      t[i + j] = (u32)cur;
      c = cur >> 32;
    }
    u64 cur = (u64)t[i + kWords] + c + e;
    t[i + kWords] = (u32)cur;
    e = (u32)(cur >> 32);
  }
  reduce_once(r, t + kWords, e);
#endif
}

// x^5 with both squares as mont_sqr: 2 x 100 + 128 wide multiply-adds
IMT_HD void pow5_sqr(Fr& x) {
  Fr x2, x4;
  mont_sqr(x2, x);
  mont_sqr(x4, x2);
  mont_mul_cc(x, x4, x);
}

// add constants, S-box on every word, dense MDS by dots
IMT_HD void full_round_lazy(Fr st[kT], const Fr rc[kT], const Fr mds[kT][kT]) {
  Fr s[kT];
#pragma unroll
  for (int i = 0; i < kT; ++i) {
    add_mod_cc(s[i], st[i], rc[i]);
    pow5_sqr(s[i]);
  }
#pragma unroll
  for (int i = 0; i < kT; ++i) mont_dot3(st[i], mds[i], s);
}

// One permutation on permute_sparse's schedule, each dot reduced once: row
// 0 of a partial round is (m00, v1, v2) . (s, x1, x2).
IMT_HD void permute_lazy(Fr st[kT], const Consts& c) {
#pragma unroll 1
  for (int r = 0; r < kHalf - 1; ++r) full_round_lazy(st, c.pre[r], c.mds);
  full_round_lazy(st, c.pre[kHalf - 1], c.mds_pre);
#pragma unroll 1
  for (int r = 0; r < kRP; ++r) {
    const Fr* m = c.sparse[r];
    Fr b[kT], p;
    add_mod_cc(b[0], st[0], c.c0[r]);
    pow5_sqr(b[0]);
    b[1] = st[1];
    b[2] = st[2];
    mont_dot3(st[0], m, b);
    mont_mul_cc(p, m[3], b[0]);
    add_mod_cc(st[1], st[1], p);
    mont_mul_cc(p, m[4], b[0]);
    add_mod_cc(st[2], st[2], p);
  }
#pragma unroll 1
  for (int r = 0; r < kHalf; ++r) full_round_lazy(st, c.post[r], c.mds);
}

// ---- the cooperative core: kCoop threads a lane ----------------------------
//
// permute_sparse's schedule with each round's independent products split
// between the kCoop threads of a group, which together carry one lane.
// Every thread holds the whole state and runs the same instructions: its
// role (0..kCoop - 1) only picks its operands (pick4, in registers), so a
// warp never diverges and every constant is loaded warp-uniform.  After a
// step the roles exchange the words the next step needs.
//
// A partial round, x = x0 + c0 and s = x^5, by role 0 | 1 | 2 | 3:
//   1: x^2            | m00 x           | w1 x           | w2 x
//   2: x^4 = (x^2)^2  | v1 x1           | v2 x2          | (v2 x2)
//   3: (x^6)          | x^4 m00 x       | x^4 w1 x       | x^4 w2 x
// then x0' = m00 s + (v1 x1 + v2 x2) on role 1, x1' = x1 + w1 s on role
// 2, x2' = x2 + w2 s on role 3, and every role takes the three: three
// products in a row where the sparse core takes eight.  A full round: role
// j < 3 takes word j's S-box (pow5_sqr) and, after the exchange, row j of
// the MDS matrix as one reduced dot (mont_dot3); role 3 repeats role 2.
// Every value is fully reduced, so the result equals the sparse core's bit
// for bit.

constexpr int kCoop = 4;

// r = k == 0 ? a : k == 1 ? b : k == 2 ? c : d, word by word
IMT_HD void pick4(Fr& r, int k, const Fr& a, const Fr& b, const Fr& c,
                  const Fr& d) {
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    r.v[i] = k == 0 ? a.v[i] : k == 1 ? b.v[i] : k == 2 ? c.v[i] : d.v[i];
  }
}

// The group's roles as one thread holds them (G): G::kN roles, the k-th
// being role(k), each with its own copy of the state st[k]; from(v, src)
// is role src's value of v.  On the host one thread holds all kCoop roles
// (HostRoles) and runs each step for every role in turn; on the card each
// thread holds its own (WarpRoles, kN = 1) and reads another's by a warp
// shuffle.

struct HostRoles {
  static constexpr int kN = kCoop;
  IMT_HD int role(int k) const { return k; }
  IMT_HD Fr from(const Fr v[], int src) const { return v[src]; }
};

template <class G>
IMT_HD void full_round_coop(const G& g, Fr st[][kT], const Fr rc[kT],
                            const Fr mds[kT][kT]) {
  constexpr int n = G::kN;
  Fr s[n], t[n];
#pragma unroll
  for (int k = 0; k < n; ++k) {
    const int q = g.role(k);
    Fr x, a;
    pick4(x, q, st[k][0], st[k][1], st[k][2], st[k][2]);
    pick4(a, q, rc[0], rc[1], rc[2], rc[2]);
    add_mod_cc(s[k], x, a);
    pow5_sqr(s[k]);
  }
#pragma unroll
  for (int k = 0; k < n; ++k) {
    const int q = g.role(k);
    Fr sv[kT], row[kT];
#pragma unroll
    for (int j = 0; j < kT; ++j) {
      sv[j] = g.from(s, j);
      pick4(row[j], q, mds[0][j], mds[1][j], mds[2][j], mds[2][j]);
    }
    mont_dot3(t[k], row, sv);
  }
#pragma unroll
  for (int k = 0; k < n; ++k) {
#pragma unroll
    for (int i = 0; i < kT; ++i) st[k][i] = g.from(t, i);
  }
}

// m: the round's (m00, v1, v2, w1, w2)
template <class G>
IMT_HD void partial_round_coop(const G& g, Fr st[][kT], const Fr& c0,
                               const Fr m[kSparse]) {
  constexpr int n = G::kN;
  Fr p1[n], p2[n], y[n];
#pragma unroll
  for (int k = 0; k < n; ++k) {
    const int q = g.role(k);
    Fr x, a, b;
    add_mod_cc(x, st[k][0], c0);
    pick4(a, q, x, m[0], m[3], m[4]);
    mont_mul_cc(p1[k], a, x);
    pick4(a, q, p1[k], m[1], m[2], m[2]);
    pick4(b, q, p1[k], st[k][1], st[k][2], st[k][2]);
    mont_mul_cc(p2[k], a, b);
  }
#pragma unroll
  for (int k = 0; k < n; ++k) {
    const int q = g.role(k);
    const Fr x4 = g.from(p2, 0), vx2 = g.from(p2, 2);
    Fr p3, d, z;
    mont_mul_cc(p3, x4, p1[k]);
    add_mod_cc(d, p2[k], vx2);
    pick4(z, q, d, d, st[k][1], st[k][2]);
    add_mod_cc(y[k], p3, z);
  }
#pragma unroll
  for (int k = 0; k < n; ++k) {
#pragma unroll
    for (int i = 0; i < kT; ++i) st[k][i] = g.from(y, i + 1);
  }
}

// One permutation on permute_sparse's schedule, each round shared by the
// group's roles.
template <class G>
IMT_HD void permute_coop(const G& g, Fr st[][kT], const Consts& c) {
#pragma unroll 1
  for (int r = 0; r < kHalf - 1; ++r) full_round_coop(g, st, c.pre[r], c.mds);
  full_round_coop(g, st, c.pre[kHalf - 1], c.mds_pre);
#pragma unroll 1
  for (int r = 0; r < kRP; ++r) {
    partial_round_coop(g, st, c.c0[r], c.sparse[r]);
  }
#pragma unroll 1
  for (int r = 0; r < kHalf; ++r) full_round_coop(g, st, c.post[r], c.mds);
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
#pragma unroll 1
  for (int n = 0; n < n_perms; ++n) permute_lazy(st, c);
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

// hash2_lane by a group of kCoop threads; role 0 stores if `store`
template <class G>
IMT_HD void hash2_coop(const G& g, const u32* a, const u32* b, u32* out,
                       long long B, long long lane, bool store,
                       const Consts& c) {
  Fr st[G::kN][kT];
#pragma unroll
  for (int k = 0; k < G::kN; ++k) {
    st[k][0] = c.iv0;
    load_node(st[k][1], a, B, lane);
    load_node(st[k][2], b, B, lane);
  }
  permute_coop(g, st, c);
#pragma unroll
  for (int k = 0; k < G::kN; ++k) add_mod_cc(st[k][1], st[k][1], c.one);
  permute_coop(g, st, c);
#pragma unroll
  for (int k = 0; k < G::kN; ++k) {
    if (store && g.role(k) == 0) store_node(out, st[k][1], B, lane);
  }
}

// hash3_lane by a group of kCoop threads: role j < 3 brings input j into
// Montgomery form (role 3 repeats input 2); role 0 stores if `store`
template <class G>
IMT_HD void hash3_coop(const G& g, const u32* a, const u32* b,
                       const u32* c_in, u32* out, long long B, long long lane,
                       bool store, const Consts& c) {
  Fr st[G::kN][kT], x[G::kN], xc[G::kN];
#pragma unroll
  for (int k = 0; k < G::kN; ++k) {
    const int q = g.role(k);
    load_limbs(x[k], q == 0 ? a : q == 1 ? b : c_in, B, lane);
    to_mont(x[k], x[k]);
  }
#pragma unroll
  for (int k = 0; k < G::kN; ++k) {
    st[k][0] = c.iv0;
    st[k][1] = g.from(x, 0);
    st[k][2] = g.from(x, 1);
    xc[k] = g.from(x, 2);
  }
  permute_coop(g, st, c);
#pragma unroll
  for (int k = 0; k < G::kN; ++k) {
    add_mod_cc(st[k][1], st[k][1], xc[k]);
    add_mod_cc(st[k][2], st[k][2], c.one);
  }
  permute_coop(g, st, c);
#pragma unroll
  for (int k = 0; k < G::kN; ++k) {
    if (store && g.role(k) == 0) store_node(out, st[k][1], B, lane);
  }
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
// The cooperative hash kernels' block, one warp of 8 lanes, and their
// crossover: up to 96 lanes an SM, three such warps on each of its four
// schedulers, a group per lane beats one thread per lane; a fourth warp a
// scheduler makes it slower (on an H100: 0.735 against 0.874 ms a hash2
// launch of 12,544 lanes, 0.92 against 0.87 at 12,800; CUDA events,
// tools/hash_lane_threads_torch.py).
constexpr int kCoopBlock = 32;
constexpr long long kCoopLanesPerSM = 96;

// K1's launch shape: threads per block, and the blocks per SM that
// __launch_bounds__ asks registers to leave room for.  tools/
// k1_launch_torch.py builds other values with -D to measure them.
#ifndef IMT_K1_BLOCK
#define IMT_K1_BLOCK 128
#endif
#ifndef IMT_K1_MIN_BLOCKS
#define IMT_K1_MIN_BLOCKS 1
#endif
constexpr int kK1Block = IMT_K1_BLOCK;

__constant__ Consts g_consts;

__device__ __forceinline__ long long lane_id() {
  return (long long)blockIdx.x * blockDim.x + threadIdx.x;
}

// K1: n_perms chained permutations per lane (imt_tpu's _permute_fn,
// poseidon_rns_pallas.py:1199), 192 B per lane against some 65K multiply-
// adds per permutation, so bound by operations at every width.  Caps of 128
// registers spill here; at the default (150 registers, 3 blocks of 128 per
// SM) it runs 2^17 lanes in 2.6 waves and 66,560 in 1.3.
__global__ void __launch_bounds__(kK1Block, IMT_K1_MIN_BLOCKS)
permute_kernel(const u32* in, u32* out, long long B, int n_perms) {
  const long long lane = lane_id();
  if (lane >= B) return;
  permute_lane(in, out, B, lane, n_perms, g_consts);
}

// A group of kCoop neighbouring threads of one warp, role own: another
// role's words come from that thread's registers.  Only the card runs it.
struct WarpRoles {
  static constexpr int kN = 1;
  int own;
  IMT_HD int role(int) const { return own; }
  IMT_HD Fr from(const Fr v[], int src) const {
    Fr x;
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
#ifdef __CUDA_ARCH__
      x.v[i] = __shfl_sync(0xffffffffu, v[0].v[i], src, kCoop);
#else
      x.v[i] = v[0].v[i];
#endif
    }
    return x;
  }
};

// The hash kernels, one thread a lane (kLaneThreads 1) or a group of
// kCoop (kLaneThreads kCoop).  A group's lanes past B repeat lane B - 1
// and store nothing, so that every warp stays whole for its shuffles.
template <int kLaneThreads>
__global__ void __launch_bounds__(kLaneThreads == 1 ? kBlock : kCoopBlock)
hash2_kernel(const u32* a, const u32* b, u32* out, long long B) {
  const long long t = lane_id();
  if constexpr (kLaneThreads == 1) {
    if (t >= B) return;
    hash2_lane(a, b, out, B, t, g_consts);
  } else {
    const long long lane = t / kCoop;
    hash2_coop(WarpRoles{(int)(t % kCoop)}, a, b, out, B,
               lane < B ? lane : B - 1, lane < B, g_consts);
  }
}

template <int kLaneThreads>
__global__ void __launch_bounds__(kLaneThreads == 1 ? kBlock : kCoopBlock)
hash3_kernel(const u32* a, const u32* b, const u32* c, u32* out,
             long long B) {
  const long long t = lane_id();
  if constexpr (kLaneThreads == 1) {
    if (t >= B) return;
    hash3_lane(a, b, c, out, B, t, g_consts);
  } else {
    const long long lane = t / kCoop;
    hash3_coop(WarpRoles{(int)(t % kCoop)}, a, b, c, out, B,
               lane < B ? lane : B - 1, lane < B, g_consts);
  }
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

// SMs of each device, set by imt_init_constants
constexpr int kMaxDevices = 64;
int g_sms[kMaxDevices];

// Threads a lane of a hash launch of width B on the current device: a
// group of kCoop up to the crossover, one thread a lane above.  The one
// place the choice is made (the launchers, imt_hash_lane_threads).
int lane_threads(long long B) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) {
    return 1;
  }
  return B <= kCoopLanesPerSM * (long long)g_sms[dev] ? kCoop : 1;
}

unsigned coop_grid_for(long long B) {
  return (unsigned)((B * kCoop + kCoopBlock - 1) / kCoopBlock);
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
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev >= 0 && dev < kMaxDevices) {
    err = cudaDeviceGetAttribute(&g_sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemcpyToSymbol(g_consts, &h, sizeof(h));
}

int imt_permute_n(const void* in, void* out, long long B, int n_perms,
                  void* stream) {
  if (B > 0) {
    const unsigned grid = (unsigned)((B + kK1Block - 1) / kK1Block);
    permute_kernel<<<grid, kK1Block, 0, (cudaStream_t)stream>>>(
        (const u32*)in, (u32*)out, B, n_perms);
  }
  return (int)cudaGetLastError();
}

// Threads a lane that a hash launch of width B takes on the current
// device (kCoop or 1): the launchers' own choice, for the tracer's count.
int imt_hash_lane_threads(long long B) { return lane_threads(B); }

int imt_hash2_nodes(const void* a, const void* b, void* out, long long B,
                    void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (B > 0 && lane_threads(B) == kCoop) {
    hash2_kernel<kCoop><<<coop_grid_for(B), kCoopBlock, 0, s>>>(
        (const u32*)a, (const u32*)b, (u32*)out, B);
  } else if (B > 0) {
    hash2_kernel<1><<<grid_for(B), kBlock, 0, s>>>(
        (const u32*)a, (const u32*)b, (u32*)out, B);
  }
  return (int)cudaGetLastError();
}

int imt_hash3_leaf(const void* a, const void* b, const void* c, void* out,
                   long long B, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (B > 0 && lane_threads(B) == kCoop) {
    hash3_kernel<kCoop><<<coop_grid_for(B), kCoopBlock, 0, s>>>(
        (const u32*)a, (const u32*)b, (const u32*)c, (u32*)out, B);
  } else if (B > 0) {
    hash3_kernel<1><<<grid_for(B), kBlock, 0, s>>>(
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
