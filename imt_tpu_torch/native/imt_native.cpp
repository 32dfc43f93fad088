// Native (C++) oracle of imt_tpu_torch, on the host CPU.
//
// An independent, bit-exact implementation of what the port computes on the
// card, in the role pse-poseidon + halo2curves play for the reference
// (Cargo.toml:14-16):
//   * BN254 Fr Montgomery arithmetic on 4x64-bit limbs (the port's CUDA
//     kernel uses 8x32-bit limbs, its plain torch path 16x16-bit ones),
//   * the Poseidon permutation and sponge (T=3, RATE=2, R_F=8, R_P=57) in
//     the standard round structure (the kernel runs the sparse schedule),
//   * Merkle tree build, and an incremental indexed tree with witnesses.
// The port's CUDA kernels and plain torch path are held against it
// (tests/test_torch_native_oracle.py, chip_smoke.py phase 9), and it is the
// single-core CPU baseline a benchmark compares with.
//
// Built with g++ into a plain shared library and bound with ctypes
// (imt_tpu_torch/native/oracle.py).  The round constants and MDS matrix are
// injected from Python at init (imt_tpu_torch/ops/grain.py derives them), so
// the constant derivation lives in one place.

#include <cstdint>
#include <cstring>
#include <map>
#include <vector>

namespace {

// ----------------------------------------------------------------------------
// BN254 Fr, Montgomery form, 4x64 limbs (little-endian limb order)
// ----------------------------------------------------------------------------

using u64 = std::uint64_t;
using u128 = unsigned __int128;

struct Fr {
  u64 v[4];
};

// modulus r (reference src/indexed_merkle_tree.rs:382-385)
constexpr u64 kMod[4] = {0x43e1f593f0000001ull, 0x2833e84879b97091ull,
                         0xb85045b68181585dull, 0x30644e72e131a029ull};
// -r^{-1} mod 2^64
constexpr u64 kInv = 0xc2e1f593efffffffull;
// R^2 mod r (R = 2^256)
constexpr u64 kR2[4] = {0x1bb8e645ae216da7ull, 0x53fe3ab1e35c59e3ull,
                        0x8c49833d53bb8085ull, 0x0216d0b17f4e44a5ull};

inline bool ge_mod(const u64 a[4]) {
  for (int i = 3; i >= 0; --i) {
    if (a[i] > kMod[i]) return true;
    if (a[i] < kMod[i]) return false;
  }
  return true;
}

inline void sub_mod_inplace(u64 a[4]) {
  u128 borrow = 0;
  for (int i = 0; i < 4; ++i) {
    u128 d = (u128)a[i] - kMod[i] - borrow;
    a[i] = (u64)d;
    borrow = (d >> 64) & 1;
  }
}

inline Fr add(const Fr& a, const Fr& b) {
  Fr r;
  u128 carry = 0;
  for (int i = 0; i < 4; ++i) {
    u128 s = (u128)a.v[i] + b.v[i] + carry;
    r.v[i] = (u64)s;
    carry = s >> 64;
  }
  if (carry || ge_mod(r.v)) sub_mod_inplace(r.v);
  return r;
}

// CIOS Montgomery multiply.
inline Fr mul(const Fr& a, const Fr& b) {
  u64 t[6] = {0, 0, 0, 0, 0, 0};
  for (int i = 0; i < 4; ++i) {
    u128 carry = 0;
    for (int j = 0; j < 4; ++j) {
      u128 cur = (u128)t[j] + (u128)a.v[i] * b.v[j] + carry;
      t[j] = (u64)cur;
      carry = cur >> 64;
    }
    u128 cur = (u128)t[4] + carry;
    t[4] = (u64)cur;
    t[5] = (u64)(cur >> 64);

    u64 m = t[0] * kInv;
    carry = ((u128)t[0] + (u128)m * kMod[0]) >> 64;
    for (int j = 1; j < 4; ++j) {
      u128 c2 = (u128)t[j] + (u128)m * kMod[j] + carry;
      t[j - 1] = (u64)c2;
      carry = c2 >> 64;
    }
    cur = (u128)t[4] + carry;
    t[3] = (u64)cur;
    t[4] = t[5] + (u64)(cur >> 64);
  }
  Fr r;
  std::memcpy(r.v, t, sizeof(r.v));
  if (t[4] || ge_mod(r.v)) sub_mod_inplace(r.v);
  return r;
}

inline Fr to_mont(const Fr& a) {
  Fr r2;
  std::memcpy(r2.v, kR2, sizeof(kR2));
  return mul(a, r2);
}

inline Fr from_mont(const Fr& a) {
  Fr one = {{1, 0, 0, 0}};
  return mul(a, one);
}

// ----------------------------------------------------------------------------
// Poseidon (constants injected from Python, Montgomery form)
// ----------------------------------------------------------------------------

constexpr int T = 3;
int g_rf = 8, g_rp = 57;
std::vector<Fr> g_rc;   // (rf+rp) rows of T, Montgomery
Fr g_mds[T][T];         // Montgomery
Fr g_iv0;               // 2^64 mod p, Montgomery

inline Fr pow5(const Fr& x) {
  Fr x2 = mul(x, x);
  Fr x4 = mul(x2, x2);
  return mul(x4, x);
}

void permute(Fr st[T]) {
  const int half = g_rf / 2;
  const int rounds = g_rf + g_rp;
  for (int r = 0; r < rounds; ++r) {
    Fr s[T];
    for (int i = 0; i < T; ++i) s[i] = add(st[i], g_rc[r * T + i]);
    if (r >= half && r < half + g_rp) {
      s[0] = pow5(s[0]);
    } else {
      for (int i = 0; i < T; ++i) s[i] = pow5(s[i]);
    }
    for (int i = 0; i < T; ++i) {
      Fr acc = mul(g_mds[i][0], s[0]);
      for (int j = 1; j < T; ++j) acc = add(acc, mul(g_mds[i][j], s[j]));
      st[i] = acc;
    }
  }
}

// sponge hashes (standard-form in/out); see poseidon_ref.py for the scheme
Fr hash2(const Fr& a, const Fr& b) {
  Fr st[T] = {g_iv0, to_mont(a), to_mont(b)};
  permute(st);
  Fr one = to_mont(Fr{{1, 0, 0, 0}});
  st[1] = add(st[1], one);
  permute(st);
  return from_mont(st[1]);
}

Fr hash3(const Fr& a, const Fr& b, const Fr& c) {
  Fr st[T] = {g_iv0, to_mont(a), to_mont(b)};
  permute(st);
  Fr one = to_mont(Fr{{1, 0, 0, 0}});
  st[1] = add(st[1], to_mont(c));
  st[2] = add(st[2], one);
  permute(st);
  return from_mont(st[1]);
}

// ----------------------------------------------------------------------------
// Native indexed Merkle tree (the reference's L2 witness-generation layer —
// src/utils.rs + the update_idx_leaf planner of src/indexed_merkle_tree.rs:632-
// 660 — as a native runtime component).  The port's semantics: duplicate or
// zero inserts are REJECTED (ok=0) but still consume their slot, as
// imt_tpu_torch/tree/indexed.py documents against the reference planner.
// Dense: idx_new allocates all 2^depth slots and every level.
//
// Incremental: each insert costs 2*(depth+1) hashes (two dirty leaves, two
// root paths) plus an O(log n) ordered-map predecessor lookup — vs the
// reference's full-tree rebuild per insert (src/indexed_merkle_tree.rs:724-730).
// ----------------------------------------------------------------------------

inline int cmp_fr(const Fr& a, const Fr& b) {
  for (int i = 3; i >= 0; --i) {
    if (a.v[i] < b.v[i]) return -1;
    if (a.v[i] > b.v[i]) return 1;
  }
  return 0;
}

struct FrLess {
  bool operator()(const Fr& a, const Fr& b) const { return cmp_fr(a, b) < 0; }
};

inline bool is_zero_fr(const Fr& a) {
  return !(a.v[0] | a.v[1] | a.v[2] | a.v[3]);
}

struct IndexedTree {
  int depth;
  long n;       // slots = 2^depth
  long count;   // inserts performed (slot cursor; slot i = count-th insert + 1)
  // standard-form preimages, struct-of-arrays
  std::vector<Fr> vals, next_vals, next_idxs;
  std::vector<std::vector<Fr>> levels;  // [depth+1] levels, level 0 = leaf hashes
  std::map<Fr, long, FrLess> by_val;    // linked-list participants (incl. slot 0)
};

// Rehash leaf `idx` and recompute its root path.
void idx_update_path(IndexedTree* t, long idx) {
  t->levels[0][idx] = hash3(t->vals[idx], t->next_vals[idx], t->next_idxs[idx]);
  long cur = idx;
  for (int d = 0; d < t->depth; ++d) {
    long p = cur >> 1;
    t->levels[d + 1][p] = hash2(t->levels[d][2 * p], t->levels[d][2 * p + 1]);
    cur = p;
  }
}

// Sibling path + helper bits (helper=1 iff left child — src/utils.rs:70-79).
void idx_gather_proof(const IndexedTree* t, long idx, u64* proof, u64* helpers) {
  long cur = idx;
  for (int d = 0; d < t->depth; ++d) {
    std::memcpy(proof + 4 * d, t->levels[d][cur ^ 1].v, 32);
    helpers[d] = (cur % 2 == 0) ? 1 : 0;
    cur >>= 1;
  }
}

IndexedTree* idx_new(int depth) {
  auto* t = new IndexedTree;
  t->depth = depth;
  t->n = 1L << depth;
  t->count = 0;
  Fr zero = {{0, 0, 0, 0}};
  t->vals.assign(t->n, zero);
  t->next_vals.assign(t->n, zero);
  t->next_idxs.assign(t->n, zero);
  Fr h = hash3(zero, zero, zero);
  t->levels.resize(depth + 1);
  for (int d = 0; d <= depth; ++d) {
    t->levels[d].assign(t->n >> d, h);
    if (d < depth) h = hash2(h, h);
  }
  t->by_val[zero] = 0;  // slot-0 sentinel participates in the linked list
  return t;
}

// Witness layout (u64 counts; d = depth):
//   old_root 4 | low_val 4 | low_nv 4 | low_ni 4 |
//   new_root 4 | new_val 4 | new_nv 4 | new_ni 4 |
//   low_proof 4d | new_proof 4d | low_help d | new_help d |
//   new_index 1 | is_largest 1 | ok 1          (total 35 + 10d)
int idx_insert(IndexedTree* t, const Fr& nv, u64* wit) {
  if (t->count + 1 >= t->n) return -1;  // tree full
  const int d = t->depth;
  const long slot = t->count + 1;
  u64* old_root = wit;
  u64* low_val = wit + 4;
  u64* low_nv = wit + 8;
  u64* low_ni = wit + 12;
  u64* new_root = wit + 16;
  u64* new_val = wit + 20;
  u64* new_nv = wit + 24;
  u64* new_ni = wit + 28;
  u64* low_proof = wit + 32;
  u64* new_proof = wit + 32 + 4 * d;
  u64* low_help = wit + 32 + 8 * d;
  u64* new_help = wit + 32 + 9 * d;
  u64* tail = wit + 32 + 10 * d;  // new_index, is_largest, ok

  std::memcpy(old_root, t->levels[d][0].v, 32);

  bool ok = !is_zero_fr(nv) && t->by_val.find(nv) == t->by_val.end();
  long low_idx = 0;
  if (ok) {
    auto it = t->by_val.upper_bound(nv);
    --it;  // predecessor: largest participant value < nv (sentinel guarantees one)
    low_idx = it->second;
  }
  Fr lv = t->vals[low_idx], lnv = t->next_vals[low_idx],
     lni = t->next_idxs[low_idx];
  std::memcpy(low_val, lv.v, 32);
  std::memcpy(low_nv, lnv.v, 32);
  std::memcpy(low_ni, lni.v, 32);
  idx_gather_proof(t, low_idx, low_proof, low_help);

  Fr nleaf_nv = lnv, nleaf_ni = lni;
  if (ok) {
    Fr slot_fr = {{(u64)slot, 0, 0, 0}};
    t->vals[slot] = nv;
    t->next_vals[slot] = nleaf_nv;
    t->next_idxs[slot] = nleaf_ni;
    t->next_vals[low_idx] = nv;
    t->next_idxs[low_idx] = slot_fr;
    idx_update_path(t, low_idx);
    // slot's own path update only rewrites slot's ancestors, never its
    // siblings, so the proof gathered here equals the final-tree proof
    // (the reference's witness discipline, src/indexed_merkle_tree.rs:734)
    idx_gather_proof(t, slot, new_proof, new_help);
    idx_update_path(t, slot);
    t->by_val[nv] = slot;
  } else {
    idx_gather_proof(t, slot, new_proof, new_help);
  }
  std::memcpy(new_root, t->levels[d][0].v, 32);
  std::memcpy(new_val, nv.v, 32);
  std::memcpy(new_nv, nleaf_nv.v, 32);
  std::memcpy(new_ni, nleaf_ni.v, 32);
  tail[0] = (u64)slot;
  tail[1] = is_zero_fr(nleaf_nv) ? 1 : 0;
  tail[2] = ok ? 1 : 0;
  t->count += 1;  // slot consumed even when rejected (the port's semantics)
  return ok ? 1 : 0;
}

}  // namespace

// ----------------------------------------------------------------------------
// C API (ctypes).  Field elements cross the boundary as 4x u64 (LE limbs),
// standard (non-Montgomery) form.
// ----------------------------------------------------------------------------

extern "C" {

// rc: (rf+rp)*T*4 u64, mds: T*T*4 u64, both standard form; the sponge's
// initial capacity word 2^64 is fixed here.
void imt_init(const u64* rc, const u64* mds, int rf, int rp) {
  g_rf = rf;
  g_rp = rp;
  const int rounds = rf + rp;
  g_rc.resize(rounds * T);
  for (int i = 0; i < rounds * T; ++i) {
    Fr x;
    std::memcpy(x.v, rc + 4 * i, 32);
    g_rc[i] = to_mont(x);
  }
  for (int i = 0; i < T; ++i)
    for (int j = 0; j < T; ++j) {
      Fr x;
      std::memcpy(x.v, mds + 4 * (i * T + j), 32);
      g_mds[i][j] = to_mont(x);
    }
  Fr iv = {{0, 1, 0, 0}};  // 2^64
  g_iv0 = to_mont(iv);
}

void imt_hash2(const u64* a, const u64* b, u64* out, long n) {
  for (long k = 0; k < n; ++k) {
    Fr x, y;
    std::memcpy(x.v, a + 4 * k, 32);
    std::memcpy(y.v, b + 4 * k, 32);
    Fr h = hash2(x, y);
    std::memcpy(out + 4 * k, h.v, 32);
  }
}

void imt_hash3(const u64* a, const u64* b, const u64* c, u64* out, long n) {
  for (long k = 0; k < n; ++k) {
    Fr x, y, z;
    std::memcpy(x.v, a + 4 * k, 32);
    std::memcpy(y.v, b + 4 * k, 32);
    std::memcpy(z.v, c + 4 * k, 32);
    Fr h = hash3(x, y, z);
    std::memcpy(out + 4 * k, h.v, 32);
  }
}

// Montgomery product (standard-form in/out) for field property tests.
void imt_mul_mod(const u64* a, const u64* b, u64* out, long n) {
  for (long k = 0; k < n; ++k) {
    Fr x, y;
    std::memcpy(x.v, a + 4 * k, 32);
    std::memcpy(y.v, b + 4 * k, 32);
    Fr h = from_mont(mul(to_mont(x), to_mont(y)));
    std::memcpy(out + 4 * k, h.v, 32);
  }
}

void imt_add_mod(const u64* a, const u64* b, u64* out, long n) {
  for (long k = 0; k < n; ++k) {
    Fr x, y;
    std::memcpy(x.v, a + 4 * k, 32);
    std::memcpy(y.v, b + 4 * k, 32);
    Fr h = add(x, y);
    std::memcpy(out + 4 * k, h.v, 32);
  }
}

// Full Merkle tree build: leaves (n*4 u64) -> all levels concatenated
// (leaves first).  out must hold (2n-1)*4 u64.  n must be a power of two.
void imt_tree_build(const u64* leaves, u64* out, long n) {
  std::memcpy(out, leaves, n * 32);
  const u64* src = out;
  u64* dst = out + n * 4;
  for (long w = n; w > 1; w /= 2) {
    for (long i = 0; i < w / 2; ++i) {
      Fr l, r;
      std::memcpy(l.v, src + 8 * i, 32);
      std::memcpy(r.v, src + 8 * i + 4, 32);
      Fr h = hash2(l, r);
      std::memcpy(dst + 4 * i, h.v, 32);
    }
    src = dst;
    dst += (w / 2) * 4;
  }
}

// --- native indexed tree (opaque handle) ------------------------------------

void* imt_idx_new(int depth) { return idx_new(depth); }

void imt_idx_free(void* h) { delete static_cast<IndexedTree*>(h); }

long imt_idx_count(const void* h) {
  return static_cast<const IndexedTree*>(h)->count;
}

void imt_idx_root(const void* h, u64* out) {
  auto* t = static_cast<const IndexedTree*>(h);
  std::memcpy(out, t->levels[t->depth][0].v, 32);
}

// out: 12 u64 — (val, next_val, next_idx)
void imt_idx_leaf(const void* h, long i, u64* out) {
  auto* t = static_cast<const IndexedTree*>(h);
  std::memcpy(out, t->vals[i].v, 32);
  std::memcpy(out + 4, t->next_vals[i].v, 32);
  std::memcpy(out + 8, t->next_idxs[i].v, 32);
}

// One insert with full witness (layout above).  Returns 1 accepted,
// 0 rejected (duplicate/zero; slot still consumed), -1 tree full.
int imt_idx_insert(void* h, const u64* val, u64* wit) {
  Fr v;
  std::memcpy(v.v, val, 32);
  return idx_insert(static_cast<IndexedTree*>(h), v, wit);
}

// Sequential batch insert, no witness materialization.  ok_out: k bytes.
// Returns the number accepted, or -1 if the batch would overflow the tree.
long imt_idx_insert_batch(void* h, const u64* vals, long k,
                          unsigned char* ok_out) {
  auto* t = static_cast<IndexedTree*>(h);
  if (t->count + k >= t->n) return -1;
  std::vector<u64> wit(35 + 10 * (size_t)t->depth);
  long acc = 0;
  for (long i = 0; i < k; ++i) {
    Fr v;
    std::memcpy(v.v, vals + 4 * i, 32);
    int r = idx_insert(t, v, wit.data());
    ok_out[i] = (unsigned char)(r == 1);
    acc += (r == 1);
  }
  return acc;
}

// Sibling path + helper bits for an arbitrary slot (proof against the
// CURRENT tree).  proof: 4*depth u64; helpers: depth u64.
void imt_idx_proof(const void* h, long index, u64* proof, u64* helpers) {
  idx_gather_proof(static_cast<const IndexedTree*>(h), index, proof, helpers);
}

}  // extern "C"
