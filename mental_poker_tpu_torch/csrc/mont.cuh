// Shared device routines: Montgomery arithmetic over NW 32-bit words and the
// RCB15 complete point addition, used by field.cu, curve.cu and msm.cu.
//
// Host layout: a field element is 2*NW little-endian 16-bit limbs, each held
// in a 32-bit int (the port's int32 [..., L] tensors, L = 2*NW). A thread
// packs them into NW 32-bit words on load and unpacks on store; Montgomery
// form uses R = 2^(32 NW) = 2^(16 L), the same R as the limb code, so every
// reduced result equals the plain PyTorch version limb for limb.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

template <int NW>
struct FieldConsts {
  uint32_t p[NW];
  uint32_t n0;  // -p^-1 mod 2^32
};

template <int NW>
struct CurveConsts {
  FieldConsts<NW> f;
  uint32_t a[NW];    // curve a, Montgomery form
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

// ------------------------------------------------------------ field routines
// Montgomery product r = a*b*R^-1 mod p (CIOS), inputs reduced, output
// reduced. r may alias a or b.
template <int NW>
__device__ __forceinline__ void mont_mul(uint32_t (&r)[NW], const uint32_t (&a)[NW],
                                         const uint32_t (&b)[NW], const FieldConsts<NW>& F) {
  uint32_t t[NW + 2];
#pragma unroll
  for (int j = 0; j < NW + 2; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      uint64_t s = (uint64_t)a[j] * b[i] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[NW] + c;
    t[NW] = (uint32_t)s;
    t[NW + 1] = (uint32_t)(s >> 32);
    const uint32_t m = t[0] * F.n0;
    s = (uint64_t)m * F.p[0] + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < NW; ++j) {
      s = (uint64_t)m * F.p[j] + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[NW] + c;
    t[NW - 1] = (uint32_t)s;
    t[NW] = t[NW + 1] + (uint32_t)(s >> 32);
  }
  // t < 2p: subtract p once if t >= p
  uint32_t d[NW];
  uint32_t br = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    uint64_t s = (uint64_t)t[j] - F.p[j] - br;
    d[j] = (uint32_t)s;
    br = (uint32_t)(s >> 32) & 1u;
  }
  const bool ge = (t[NW] != 0) || (br == 0);
#pragma unroll
  for (int j = 0; j < NW; ++j) r[j] = ge ? d[j] : t[j];
}

// r = (a + b) mod p for reduced inputs (2p < R, so a + b never carries out).
template <int NW>
__device__ __forceinline__ void add_mod(uint32_t (&r)[NW], const uint32_t (&a)[NW],
                                        const uint32_t (&b)[NW], const FieldConsts<NW>& F) {
  uint32_t s[NW], d[NW];
  uint32_t c = 0, br = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    uint64_t t = (uint64_t)a[j] + b[j] + c;
    s[j] = (uint32_t)t;
    c = (uint32_t)(t >> 32);
  }
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    uint64_t t = (uint64_t)s[j] - F.p[j] - br;
    d[j] = (uint32_t)t;
    br = (uint32_t)(t >> 32) & 1u;
  }
#pragma unroll
  for (int j = 0; j < NW; ++j) r[j] = br ? s[j] : d[j];
}

// r = (a - b) mod p for reduced inputs.
template <int NW>
__device__ __forceinline__ void sub_mod(uint32_t (&r)[NW], const uint32_t (&a)[NW],
                                        const uint32_t (&b)[NW], const FieldConsts<NW>& F) {
  uint32_t d[NW], e[NW];
  uint32_t c = 0, br = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    uint64_t t = (uint64_t)a[j] - b[j] - br;
    d[j] = (uint32_t)t;
    br = (uint32_t)(t >> 32) & 1u;
  }
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    uint64_t t = (uint64_t)d[j] + F.p[j] + c;
    e[j] = (uint32_t)t;
    c = (uint32_t)(t >> 32);
  }
#pragma unroll
  for (int j = 0; j < NW; ++j) r[j] = br ? e[j] : d[j];
}

// ------------------------------------------------------------ point routines
template <int NW>
struct Pt {
  uint32_t x[NW], y[NW], z[NW];
};

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
// _rcb_add`: 17 Montgomery products (5 of them by the constants a and 3b) and
// 19 modular additions/subtractions. Doubling is add(P, P). R may alias P or
// Q: both are read only before R is written.
template <int NW>
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

  uint32_t z3p[NW], x3a[NW], z3a[NW], t1b[NW], t4b[NW];
  sub_mod(u, t0, t2, F);    // t0 - t2
  mont_mul(t4b, u, C.a, F);  // u4 = a (t0 - t2)
  mont_mul(u, t4, C.b3, F);  // u3 = 3b t4
  add_mod(t4b, u, t4b, F);   // t4b = u3 + u4
  mont_mul(u, t4, C.a, F);   // u0 = a t4
  mont_mul(v, t2, C.b3, F);  // u1 = 3b t2
  add_mod(z3p, v, u, F);     // z3p = u1 + u0
  mont_mul(v, t2, C.a, F);   // u2 = a t2
  add_mod(t1b, t0, t0, F);
  add_mod(t1b, t1b, t0, F);
  add_mod(t1b, t1b, v, F);   // t1b = 3 t0 + u2
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

// Horner fold of W window sums, most significant window first, from the
// identity: acc = 2^CB acc + S_w for w = W-1 .. 0, the doublings as
// add(acc, acc). The schedule of mental_poker_tpu/ops/pallas/curve.py::
// _fold_kernel, W * (CB + 1) dependent additions. `load(w, S)` fills S with
// window w's sum. Shared by curve.cu's fold kernel and msm.cu's window/fold
// kernel, so both fold the same way as their plain versions.
template <int NW, int W, int CB, class Load>
__device__ __forceinline__ void fold_windows(Pt<NW>& acc, Load load, const CurveConsts<NW>& C) {
  set_identity<NW>(acc, C);
  for (int w = W - 1; w >= 0; --w) {
    for (int b = 0; b < CB; ++b) point_add<NW>(acc, acc, acc, C);
    Pt<NW> s;
    load(w, s);
    point_add<NW>(acc, acc, s, C);
  }
}
