// Shared device routines: Montgomery arithmetic over NW 32-bit words and the
// RCB15 complete point addition, used by every kernel source (fold.cuh adds
// the lane-group form of the addition and the window fold).
//
// Host layout: a field element is 2*NW little-endian 16-bit limbs, each held
// in a 32-bit int (the port's int32 [..., L] tensors, L = 2*NW). A thread
// packs them into NW 32-bit words on load and unpacks on store; Montgomery
// form uses R = 2^(32 NW) = 2^(16 L), the same R as the limb code, so every
// reduced result equals the plain PyTorch version limb for limb.
#pragma once

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

template <int NW>
struct FieldConsts {
  uint32_t p[NW];
  uint32_t n0;  // -p^-1 mod 2^32
};

template <int NW>
struct CurveConsts {
  FieldConsts<NW> f;
  uint32_t a[NW];    // curve a, Montgomery form (read only in the general a-case)
  uint32_t b3[NW];   // 3*b, Montgomery form
  uint32_t one[NW];  // 1, Montgomery form
};

// Host side: fill the constants from a flat word array
// [p (NW), n0 (1), a (NW), b3 (NW), one (NW)].
template <int NW>
inline FieldConsts<NW> field_consts(const uint32_t* w) {
  FieldConsts<NW> F;
  for (int j = 0; j < NW; ++j) F.p[j] = w[j];
  F.n0 = w[NW];
  return F;
}

template <int NW>
inline CurveConsts<NW> curve_consts(const uint32_t* w) {
  CurveConsts<NW> C;
  C.f = field_consts<NW>(w);
  for (int j = 0; j < NW; ++j) {
    C.a[j] = w[NW + 1 + j];
    C.b3[j] = w[2 * NW + 1 + j];
    C.one[j] = w[3 * NW + 1 + j];
  }
  return C;
}

// ---------------------------------------------------------------- load/store
// 16-byte vector accesses: every element starts on a multiple of 4*L bytes of
// a 16-byte-aligned buffer (the wrappers check the base alignment).
template <int NW>
__device__ __forceinline__ void load_elem(const uint32_t* __restrict__ src, uint32_t (&w)[NW]) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int q = 0; q < NW / 2; ++q) {
    uint4 v = __ldg(s + q);
    w[2 * q] = v.x | (v.y << 16);
    w[2 * q + 1] = v.z | (v.w << 16);
  }
}

template <int NW>
__device__ __forceinline__ void store_elem(uint32_t* __restrict__ dst, const uint32_t (&w)[NW]) {
  uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int q = 0; q < NW / 2; ++q) {
    d[q] = make_uint4(w[2 * q] & 0xFFFFu, w[2 * q] >> 16, w[2 * q + 1] & 0xFFFFu, w[2 * q + 1] >> 16);
  }
}

// Packed 32-bit words (device-memory scratch and shared memory): an element
// is NW words, a point three elements, each 16-byte aligned.
template <int NW>
__device__ __forceinline__ void load_words(const uint32_t* __restrict__ src, uint32_t (&w)[NW]) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int q = 0; q < NW / 4; ++q) {
    uint4 v = s[q];
    w[4 * q] = v.x;
    w[4 * q + 1] = v.y;
    w[4 * q + 2] = v.z;
    w[4 * q + 3] = v.w;
  }
}

template <int NW>
__device__ __forceinline__ void store_words(uint32_t* __restrict__ dst, const uint32_t (&w)[NW]) {
  uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int q = 0; q < NW / 4; ++q) d[q] = make_uint4(w[4 * q], w[4 * q + 1], w[4 * q + 2], w[4 * q + 3]);
}

// ------------------------------------------------------------ curve a-cases
// The products by the curve constant a are specialised at compile time:
// AC = 0 for a = 0 (BLS12-377), AC = 1 for a = 1 (Stark), AC = 2 for any other
// a. This is exact: mont_mul(x, 0) = 0 and mont_mul(x, R mod p) = x for a
// reduced x, so every case gives the general formula's limbs.
constexpr int kAZero = 0, kAOne = 1, kAGeneral = 2;

// Host side: does `acase` describe the constants' a? (a = 0, a = R mod p, or
// the general case, which takes any a.)
template <int NW>
inline bool acase_matches(const CurveConsts<NW>& C, int acase) {
  if (acase == kAGeneral) return true;
  if (acase != kAZero && acase != kAOne) return false;
  for (int j = 0; j < NW; ++j) {
    if (C.a[j] != (acase == kAOne ? C.one[j] : 0u)) return false;
  }
  return true;
}

// Host side: the constants from host words, checked against the a-case, then
// f(C, std::integral_constant<int, AC>) for that case.
template <int NW, class F>
inline int with_curve(int acase, const uint32_t* consts, F&& f) {
  const CurveConsts<NW> C = curve_consts<NW>(consts);
  if (!acase_matches<NW>(C, acase)) return (int)cudaErrorInvalidValue;
  switch (acase) {
    case kAZero: return f(C, std::integral_constant<int, kAZero>{});
    case kAOne: return f(C, std::integral_constant<int, kAOne>{});
    default: return f(C, std::integral_constant<int, kAGeneral>{});
  }
}

// ------------------------------------------------------ carry-flag primitives
// One PTX instruction each: the .cc forms write the carry flag, the c forms
// read it. A carry chain is a run of these calls with nothing in between that
// writes the flag (the compiler's own code does not use it); `volatile` keeps
// the calls in program order.
__device__ __forceinline__ uint32_t add_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t addc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t addc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t sub_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t subc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t subc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
// lo/hi word of a*b + c
__device__ __forceinline__ uint32_t mad_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("mad.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t madc_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t madc_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.hi.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t madc_hi(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.hi.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
// ------------------------------------------------- end carry-flag primitives

// ------------------------------------------------------------ field routines
// Montgomery product r = a*b*R^-1 mod p, inputs reduced, output reduced; r
// may alias a or b. CIOS, one row per word b[i], on the carry flag. The
// running sum t is kept in two NW-word accumulators so that each row's
// products form two independent carry chains: `e` holds the columns 0..NW-1
// that take the even-indexed words' products (lo(a_j b_i) in column j, hi in
// column j + 1, j even), `o` the columns 1..NW that take the odd-indexed
// words' products. Dividing t by 2^32 at the end of a row turns `o` into the
// next row's `e` (same columns, one lower) and `e`'s columns 1..NW-1 into
// the next row's `o` (added in while the next row's odd products go in,
// shifted down two words). So the two arrays swap roles every row and NW must
// be even. The carry out of column NW goes into o[NW-1]; the carry out of
// column NW+1 is 0 because t < 2^33 p throughout, so each accumulator stays
// below 2p < R. The last row leaves t < 2p; one conditional subtraction
// reduces it.
template <int NW>
__device__ __forceinline__ void mont_row(uint32_t (&e)[NW], uint32_t (&o)[NW], const uint32_t (&a)[NW],
                                         uint32_t bi, bool first, const FieldConsts<NW>& F) {
  static_assert(NW % 2 == 0, "mont_mul needs an even word count");
  if (first) {
#pragma unroll
    for (int j = 0; j < NW; j += 2) {
      e[j] = a[j] * bi;
      e[j + 1] = __umulhi(a[j], bi);
      o[j] = a[j + 1] * bi;
      o[j + 1] = __umulhi(a[j + 1], bi);
    }
  } else {
    // column 0 takes the old column 1's even part; the old even words move
    // down two places into o while the odd products go in
    e[0] = add_cc(e[0], o[1]);
#pragma unroll
    for (int j = 0; j < NW - 2; j += 2) {
      o[j] = madc_lo_cc(a[j + 1], bi, o[j + 2]);
      o[j + 1] = madc_hi_cc(a[j + 1], bi, o[j + 3]);
    }
    o[NW - 2] = madc_lo_cc(a[NW - 1], bi, 0);
    o[NW - 1] = madc_hi(a[NW - 1], bi, 0);
    e[0] = mad_lo_cc(a[0], bi, e[0]);
    e[1] = madc_hi_cc(a[0], bi, e[1]);
#pragma unroll
    for (int j = 2; j < NW; j += 2) {
      e[j] = madc_lo_cc(a[j], bi, e[j]);
      e[j + 1] = madc_hi_cc(a[j], bi, e[j + 1]);
    }
    o[NW - 1] = addc(o[NW - 1], 0);
  }
  // t += m p with m = t[0] * (-p^-1): column 0 becomes 0
  const uint32_t m = e[0] * F.n0;
  o[0] = mad_lo_cc(F.p[1], m, o[0]);
  o[1] = madc_hi_cc(F.p[1], m, o[1]);
#pragma unroll
  for (int j = 2; j < NW - 2; j += 2) {
    o[j] = madc_lo_cc(F.p[j + 1], m, o[j]);
    o[j + 1] = madc_hi_cc(F.p[j + 1], m, o[j + 1]);
  }
  o[NW - 2] = madc_lo_cc(F.p[NW - 1], m, o[NW - 2]);
  o[NW - 1] = madc_hi(F.p[NW - 1], m, o[NW - 1]);
  e[0] = mad_lo_cc(F.p[0], m, e[0]);
  e[1] = madc_hi_cc(F.p[0], m, e[1]);
#pragma unroll
  for (int j = 2; j < NW; j += 2) {
    e[j] = madc_lo_cc(F.p[j], m, e[j]);
    e[j + 1] = madc_hi_cc(F.p[j], m, e[j + 1]);
  }
  o[NW - 1] = addc(o[NW - 1], 0);
}

// r = x if x < p else x - p, for x < 2p.
template <int NW>
__device__ __forceinline__ void cond_sub_p(uint32_t (&r)[NW], const uint32_t (&x)[NW], const FieldConsts<NW>& F) {
  uint32_t d[NW];
  d[0] = sub_cc(x[0], F.p[0]);
#pragma unroll
  for (int j = 1; j < NW; ++j) d[j] = subc_cc(x[j], F.p[j]);
  const uint32_t borrow = subc(0, 0);  // all ones when x < p
#pragma unroll
  for (int j = 0; j < NW; ++j) r[j] = borrow ? x[j] : d[j];
}

template <int NW>
__device__ __forceinline__ void mont_mul(uint32_t (&r)[NW], const uint32_t (&a)[NW],
                                         const uint32_t (&b)[NW], const FieldConsts<NW>& F) {
  uint32_t x[NW], y[NW];
#pragma unroll
  for (int i = 0; i < NW; i += 2) {
    mont_row<NW>(x, y, a, b[i], i == 0, F);
    mont_row<NW>(y, x, a, b[i + 1], false, F);
  }
  // after an even number of rows y holds the even columns: t / 2^32 has
  // word k = x[k] + y[k + 1]
  uint32_t t[NW];
  t[0] = add_cc(x[0], y[1]);
#pragma unroll
  for (int k = 1; k < NW - 1; ++k) t[k] = addc_cc(x[k], y[k + 1]);
  t[NW - 1] = addc(x[NW - 1], 0);
  cond_sub_p<NW>(r, t, F);
}

// r = (a + b) mod p for reduced inputs (2p < R, so a + b never carries out).
template <int NW>
__device__ __forceinline__ void add_mod(uint32_t (&r)[NW], const uint32_t (&a)[NW],
                                        const uint32_t (&b)[NW], const FieldConsts<NW>& F) {
  uint32_t s[NW];
  s[0] = add_cc(a[0], b[0]);
#pragma unroll
  for (int j = 1; j < NW; ++j) s[j] = addc_cc(a[j], b[j]);
  cond_sub_p<NW>(r, s, F);
}

// r = (a - b) mod p for reduced inputs: a - b, plus p where that borrowed.
template <int NW>
__device__ __forceinline__ void sub_mod(uint32_t (&r)[NW], const uint32_t (&a)[NW],
                                        const uint32_t (&b)[NW], const FieldConsts<NW>& F) {
  uint32_t d[NW];
  d[0] = sub_cc(a[0], b[0]);
#pragma unroll
  for (int j = 1; j < NW; ++j) d[j] = subc_cc(a[j], b[j]);
  const uint32_t borrow = subc(0, 0);  // all ones when a < b
  r[0] = add_cc(d[0], F.p[0] & borrow);
#pragma unroll
  for (int j = 1; j < NW; ++j) r[j] = addc_cc(d[j], F.p[j] & borrow);
}

// ------------------------------------------------------------ point routines
template <int NW>
struct Pt {
  uint32_t x[NW], y[NW], z[NW];
};

template <int NW>
__device__ __forceinline__ void load_pt(const uint32_t* src, Pt<NW>& P) {
  load_words<NW>(src, P.x);
  load_words<NW>(src + NW, P.y);
  load_words<NW>(src + 2 * NW, P.z);
}

template <int NW>
__device__ __forceinline__ void store_pt(uint32_t* dst, const Pt<NW>& P) {
  store_words<NW>(dst, P.x);
  store_words<NW>(dst + NW, P.y);
  store_words<NW>(dst + 2 * NW, P.z);
}

template <int NW>
__device__ __forceinline__ void set_identity(Pt<NW>& P, const CurveConsts<NW>& C) {
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    P.x[j] = 0;
    P.y[j] = C.one[j];
    P.z[j] = 0;
  }
}

// Complete projective addition, Renes-Costello-Batina 2015 Algorithm 1 (any
// a), with the operation schedule of `mental_poker_tpu/ops/pallas/curve.py::
// _rcb_add`: 12 general Montgomery products, 2 by 3b and 3 by a (the last
// three only in the general a-case), and 19 modular additions/subtractions.
// Doubling is add(P, P). R may alias P or Q: both are read only before R is
// written. One thread does the whole formula; fold.cuh spreads it over a
// lane group.
template <int NW, int AC>
__device__ __forceinline__ void point_add(Pt<NW>& R, const Pt<NW>& P, const Pt<NW>& Q,
                                          const CurveConsts<NW>& C) {
  const FieldConsts<NW>& F = C.f;
  uint32_t t0[NW], t1[NW], t2[NW], t3[NW], t4[NW], t5[NW], u[NW], v[NW];
  mont_mul(t0, P.x, Q.x, F);
  mont_mul(t1, P.y, Q.y, F);
  mont_mul(t2, P.z, Q.z, F);
  add_mod(u, P.x, P.y, F);
  add_mod(v, Q.x, Q.y, F);
  mont_mul(t3, u, v, F);
  add_mod(u, P.x, P.z, F);
  add_mod(v, Q.x, Q.z, F);
  mont_mul(t4, u, v, F);
  add_mod(u, P.y, P.z, F);
  add_mod(v, Q.y, Q.z, F);
  mont_mul(t5, u, v, F);
  // P and Q are not read below this line.
  add_mod(u, t0, t1, F);
  sub_mod(t3, t3, u, F);  // t3 = (X1+Y1)(X2+Y2) - (t0+t1)
  add_mod(u, t0, t2, F);
  sub_mod(t4, t4, u, F);  // t4 = (X1+Z1)(X2+Z2) - (t0+t2)
  add_mod(u, t1, t2, F);
  sub_mod(t5, t5, u, F);  // t5 = (Y1+Z1)(Y2+Z2) - (t1+t2)

  // u0 = a t4, u1 = 3b t2, u2 = a t2, u3 = 3b t4, u4 = a (t0 - t2);
  // z3p = u1 + u0, t4b = u3 + u4, t1b = 3 t0 + u2
  uint32_t z3p[NW], x3a[NW], z3a[NW], t1b[NW], t4b[NW];
  mont_mul(z3p, t2, C.b3, F);  // u1
  mont_mul(t4b, t4, C.b3, F);  // u3
  add_mod(t1b, t0, t0, F);
  add_mod(t1b, t1b, t0, F);    // 3 t0
  if (AC == kAOne) {
    add_mod(z3p, z3p, t4, F);
    sub_mod(u, t0, t2, F);
    add_mod(t4b, t4b, u, F);
    add_mod(t1b, t1b, t2, F);
  } else if (AC == kAGeneral) {
    mont_mul(u, t4, C.a, F);
    add_mod(z3p, z3p, u, F);
    sub_mod(u, t0, t2, F);
    mont_mul(u, u, C.a, F);
    add_mod(t4b, t4b, u, F);
    mont_mul(u, t2, C.a, F);
    add_mod(t1b, t1b, u, F);
  }
  sub_mod(x3a, t1, z3p, F);
  add_mod(z3a, t1, z3p, F);

  uint32_t w0[NW], w1[NW];
  mont_mul(w0, x3a, t3, F);   // v3
  mont_mul(w1, t5, t4b, F);   // v2
  sub_mod(R.x, w0, w1, F);    // X3 = v3 - v2
  mont_mul(w0, x3a, z3a, F);  // v0
  mont_mul(w1, t1b, t4b, F);  // v1
  add_mod(R.y, w0, w1, F);    // Y3 = v0 + v1
  mont_mul(w0, t5, z3a, F);   // v5
  mont_mul(w1, t3, t1b, F);   // v4
  add_mod(R.z, w0, w1, F);    // Z3 = v5 + v4
}
