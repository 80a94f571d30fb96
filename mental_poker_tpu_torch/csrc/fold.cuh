// The lane-group point addition and the Horner window fold, shared by
// curve.cu's fold kernel and msm.cu's window/fold kernel.
//
// A fold is one chain of W * (c + 1) dependent point operations (315 on
// Stark, 320 on BLS12-377): window w must be doubled c*w times, so no
// reordering shortens the chain of doublings. What the design shortens is the
// latency of each operation. RCB15 Algorithm 1 in the schedule of
// `mental_poker_tpu/ops/pallas/curve.py::_rcb_add` has three layers of
// independent Montgomery products (t0..t5: six; u0..u4: five, two of them
// once a is specialised; v0..v5: six). A group of kGroup = 8 consecutive lanes
// of a warp takes one statement: lane g computes product g of each layer, and
// the sums and differences between layers run on the lanes that produce
// them. Operands and products go through a per-group scratch area in shared
// memory, with __syncwarp over the group's lanes between layers, so the
// critical path of an operation is three products instead of 14-17.
//
// Every product and every add/sub has the one-thread schedule's operands and
// every result is reduced, so each operation gives the same projective triple
// as point_add (and as the plain PyTorch version) limb for limb.
#pragma once

#include "mont.cuh"

constexpr int kGroup = 8;  // lanes per statement

// Scratch slots of one group, in field elements of NW words.
constexpr int kSlotT = 0;     // t0, t1, t2, then t3, t4, t5 (6)
constexpr int kSlotD = 6;     // t0 - t2 (general a only)
constexpr int kSlotU = 7;     // u0..u4 (5; u1 and u3 only unless a is general)
constexpr int kSlotX3a = 12;  // t1 - (u1 + u0)
constexpr int kSlotZ3a = 13;  // t1 + (u1 + u0)
constexpr int kSlotT4b = 14;  // u3 + u4
constexpr int kSlotT1b = 15;  // 3 t0 + u2
constexpr int kSlotV = 16;    // v0..v5 (6)
constexpr int kGroupSlots = 22;

// Shared-memory words one statement's fold takes: its W window sums, its
// accumulator and its group's scratch.
template <int NW, int W>
__host__ __device__ constexpr int fold_words() {
  return (W * 3 + 3 + kGroupSlots) * NW;
}

// The __syncwarp mask of the calling lane's group: groups start at lanes
// 0, 8, 16 and 24 of a warp.
__device__ __forceinline__ unsigned group_mask() { return 0xFFu << (threadIdx.x & 24); }

// R = P + Q on the group's lanes (g = lane within the group, 0..7; all eight
// take part). P, Q and R are points in shared memory, three elements of NW
// words (x, y, z); R may alias P or Q; sc holds kGroupSlots elements.
template <int NW, int AC>
__device__ __forceinline__ void group_point_add(uint32_t* R, const uint32_t* P, const uint32_t* Q, uint32_t* sc,
                                                int g, unsigned mask, const CurveConsts<NW>& C) {
  const FieldConsts<NW>& F = C.f;
  auto slot = [sc](int i) { return sc + i * NW; };
  uint32_t x[NW], y[NW], r[NW];
  // layer 1: X1 X2, Y1 Y2, Z1 Z2, (X1+Y1)(X2+Y2), (X1+Z1)(X2+Z2), (Y1+Z1)(Y2+Z2)
  if (g < 6) {
    const int i = g < 3 ? g : (g == 5 ? 1 : 0);
    load_words<NW>(P + i * NW, x);
    load_words<NW>(Q + i * NW, y);
    if (g >= 3) {
      const int k = g == 3 ? 1 : 2;
      load_words<NW>(P + k * NW, r);
      add_mod(x, x, r, F);
      load_words<NW>(Q + k * NW, r);
      add_mod(y, y, r, F);
    }
    mont_mul(r, x, y, F);
    store_words<NW>(slot(kSlotT + g), r);
  }
  __syncwarp(mask);
  // t3 = p3 - (t0 + t1), t4 = p4 - (t0 + t2), t5 = p5 - (t1 + t2); t0 - t2
  if (g >= 3 && g < 6) {
    load_words<NW>(slot(kSlotT + (g == 5 ? 1 : 0)), x);
    load_words<NW>(slot(kSlotT + (g == 3 ? 1 : 2)), y);
    add_mod(x, x, y, F);
    load_words<NW>(slot(kSlotT + g), y);
    sub_mod(y, y, x, F);
    store_words<NW>(slot(kSlotT + g), y);
  } else if (AC == kAGeneral && g == 0) {
    load_words<NW>(slot(kSlotT), x);
    load_words<NW>(slot(kSlotT + 2), y);
    sub_mod(x, x, y, F);
    store_words<NW>(slot(kSlotD), x);
  }
  __syncwarp(mask);
  // layer 2: u0 = a t4, u1 = 3b t2, u2 = a t2, u3 = 3b t4, u4 = a (t0 - t2);
  // with a = 0 or 1 only u1 (lane 0) and u3 (lane 1) are products
  if (AC == kAGeneral ? g < 5 : g < 2) {
    const int u = AC == kAGeneral ? g : 1 + 2 * g;
    const int src = u == 4 ? kSlotD : (u == 0 || u == 3) ? kSlotT + 4 : kSlotT + 2;
    const bool by_b3 = u == 1 || u == 3;
#pragma unroll
    for (int j = 0; j < NW; ++j) y[j] = by_b3 ? C.b3[j] : C.a[j];
    load_words<NW>(slot(src), x);
    mont_mul(r, x, y, F);
    store_words<NW>(slot(kSlotU + u), r);
  }
  __syncwarp(mask);
  // z3p = u1 + u0, x3a = t1 - z3p, z3a = t1 + z3p (lane 0); t4b = u3 + u4
  // (lane 1); t1b = 3 t0 + u2 (lane 2). a = 1: u0 = t4, u2 = t2, u4 = t0 - t2;
  // a = 0: all three are 0.
  if (g == 0) {
    load_words<NW>(slot(kSlotU + 1), x);
    if (AC != kAZero) {
      load_words<NW>(slot(AC == kAOne ? kSlotT + 4 : kSlotU), y);
      add_mod(x, x, y, F);
    }
    load_words<NW>(slot(kSlotT + 1), y);
    sub_mod(r, y, x, F);
    store_words<NW>(slot(kSlotX3a), r);
    add_mod(r, y, x, F);
    store_words<NW>(slot(kSlotZ3a), r);
  } else if (g == 1) {
    load_words<NW>(slot(kSlotU + 3), x);
    if (AC == kAOne) {
      load_words<NW>(slot(kSlotT), y);
      load_words<NW>(slot(kSlotT + 2), r);
      sub_mod(y, y, r, F);
      add_mod(x, x, y, F);
    } else if (AC == kAGeneral) {
      load_words<NW>(slot(kSlotU + 4), y);
      add_mod(x, x, y, F);
    }
    store_words<NW>(slot(kSlotT4b), x);
  } else if (g == 2) {
    load_words<NW>(slot(kSlotT), x);
    add_mod(y, x, x, F);
    add_mod(y, y, x, F);
    if (AC != kAZero) {
      load_words<NW>(slot(AC == kAOne ? kSlotT + 2 : kSlotU + 2), x);
      add_mod(y, y, x, F);
    }
    store_words<NW>(slot(kSlotT1b), y);
  }
  __syncwarp(mask);
  // layer 3: v0 = x3a z3a, v1 = t1b t4b, v2 = t5 t4b, v3 = x3a t3,
  // v4 = t3 t1b, v5 = t5 z3a
  if (g < 6) {
    const int s1 = g == 0 || g == 3 ? kSlotX3a : g == 1 ? kSlotT1b : g == 4 ? kSlotT + 3 : kSlotT + 5;
    const int s2 = g == 0 || g == 5 ? kSlotZ3a : g == 1 || g == 2 ? kSlotT4b : g == 3 ? kSlotT + 3 : kSlotT1b;
    load_words<NW>(slot(s1), x);
    load_words<NW>(slot(s2), y);
    mont_mul(r, x, y, F);
    store_words<NW>(slot(kSlotV + g), r);
  }
  __syncwarp(mask);
  // X3 = v3 - v2 (lane 0), Y3 = v0 + v1 (lane 1), Z3 = v5 + v4 (lane 2)
  if (g < 3) {
    load_words<NW>(slot(kSlotV + (g == 0 ? 3 : g == 1 ? 0 : 5)), x);
    load_words<NW>(slot(kSlotV + (g == 0 ? 2 : g == 1 ? 1 : 4)), y);
    if (g == 0) {
      sub_mod(r, x, y, F);
    } else {
      add_mod(r, x, y, F);
    }
    store_words<NW>(R + g * NW, r);
  }
  __syncwarp(mask);
}

// Horner fold of W window sums on one lane group, most significant window
// first, from the identity: acc = 2^CB acc + S_w for w = W-1 .. 0, the
// doublings as add(acc, acc): the schedule of mental_poker_tpu/ops/pallas/
// curve.py::_fold_kernel. sums: the W window sums in shared memory, window w
// at sums + 3 NW w; acc: one point and sc: kGroupSlots elements of shared
// memory, both the group's own. The result is left in acc.
template <int NW, int W, int CB, int AC>
__device__ __forceinline__ void group_fold(uint32_t* acc, uint32_t* sc, const uint32_t* sums, int g,
                                           const CurveConsts<NW>& C) {
  const unsigned mask = group_mask();
  if (g < 3) {
    uint32_t v[NW];
#pragma unroll
    for (int j = 0; j < NW; ++j) v[j] = g == 1 ? C.one[j] : 0u;
    store_words<NW>(acc + g * NW, v);
  }
  __syncwarp(mask);
#pragma unroll 1
  for (int w = W - 1; w >= 0; --w) {
#pragma unroll 1
    for (int b = 0; b < CB; ++b) group_point_add<NW, AC>(acc, acc, acc, sc, g, mask, C);
    group_point_add<NW, AC>(acc, acc, sums + w * 3 * NW, sc, g, mask, C);
  }
}
