// Per-statement multi-scalar multiplication: out[s] = sum_i k[s, i] * P[s, i].
//
// Replaces mental_poker_tpu/ops/pallas/msm.py::_msm_kernel (the nc=1 lane
// kernel). The TPU kernel keeps statements on vector lanes and picks each
// window's table entry by a masked select; on Hopper each (statement,
// window) pair gets its own thread instead, so the W = ceil(bits/4) windows
// of a statement accumulate in parallel. The window is fixed at c = 4 bits
// (the JAX default), so the table size T = 16 and W (63 for Stark scalars,
// 64 for BLS12-377 ones) are compile-time constants:
//
//   msm_table_kernel        (msm_table.cuh, shared with msm_chunked.cu) one
//                           thread per (statement, point): the multiples
//                           table t*P for t < T (T - 2 additions), in
//                           device memory as packed 32-bit words;
//   msm_window_fold_kernel  one block of W threads per statement, one thread
//                           per window: the window sum over the N points (one
//                           table read and one addition per point), then
//                           thread 0 folds the W sums MSB-first,
//                           acc = 2^c acc + S_w (W * (c + 1) additions;
//                           mont.cuh's fold_windows, which curve.cu's fold
//                           kernel runs too).
//
// The schedule is the same as the plain PyTorch version in ops/cuda/msm.py,
// so both give the same projective triples limb for limb. Bound on the H100:
// integer multiply-adds; the fold is one sequential chain of W*(c+1)
// additions per statement, which is what the time of a narrow call is made
// of. Device memory sees the points and scalars once, the tables (written
// once and read by every window thread of their statement, mostly from L2)
// and the outputs once.
#include "msm_table.cuh"

// Block s, thread w: S_w = sum_i tbl[s, i, digit_w(k[s, i])], starting from
// the identity and adding in point order. Thread 0 then folds.
template <int NW, int W>
__global__ void msm_window_fold_kernel(const uint32_t* __restrict__ tbl, const uint32_t* __restrict__ k,
                                       int Lk, int N, uint32_t* __restrict__ ox,
                                       uint32_t* __restrict__ oy, uint32_t* __restrict__ oz,
                                       CurveConsts<NW> C) {
  __shared__ __align__(16) uint32_t sums[W * 3 * NW];
  const long long s = blockIdx.x;
  const int w = threadIdx.x;
  {
    const int limb = (w * kC) >> 4;
    const int shift = (w * kC) & 15;
    Pt<NW> acc, e;
    set_identity<NW>(acc, C);
    for (int i = 0; i < N; ++i) {
      const long long sn = s * N + i;
      const uint32_t d = (k[sn * Lk + limb] >> shift) & (uint32_t)(kT - 1);
      load_pt<NW>(tbl + (sn * kT + d) * 3 * NW, e);
      point_add<NW>(acc, acc, e, C);
    }
    store_pt<NW>(sums + w * 3 * NW, acc);
  }
  __syncthreads();
  if (w == 0) {
    const uint32_t* sp = sums;
    Pt<NW> acc;
    fold_windows<NW, W, kC>(acc, [sp](int j, Pt<NW>& e) { load_pt<NW>(sp + j * 3 * NW, e); }, C);
    store_elem<NW>(ox + s * 2 * NW, acc.x);
    store_elem<NW>(oy + s * 2 * NW, acc.y);
    store_elem<NW>(oz + s * 2 * NW, acc.z);
  }
}

template <int NW, int W>
static int launch(const void* px, const void* py, const void* pz, const void* k, int Lk, void* tbl,
                  void* ox, void* oy, void* oz, long long S, int N, const uint32_t* consts,
                  cudaStream_t stream) {
  const CurveConsts<NW> C = curve_consts<NW>(consts);
  cudaError_t err = launch_tables<NW>(px, py, pz, tbl, S * (long long)N, C, stream);
  if (err != cudaSuccess) return (int)err;
  msm_window_fold_kernel<NW, W><<<(unsigned)S, W, 0, stream>>>(
      static_cast<const uint32_t*>(tbl), static_cast<const uint32_t*>(k), Lk, N,
      static_cast<uint32_t*>(ox), static_cast<uint32_t*>(oy), static_cast<uint32_t*>(oz), C);
  return (int)cudaGetLastError();
}

// L: limbs per coordinate; W: 4-bit windows of the scalar field; the two
// curves are Stark (L = 16, W = 63) and BLS12-377 G1 (L = 24, W = 64).
// points [S, N, L]; k: canonical scalar limbs [S, N, Lk] with Lk >= W / 4;
// tbl: scratch of S*N*16*3*(L/2) words; outputs [S, L]; consts as in curve.cu.
extern "C" int mp_msm_lanes(int L, int W, const void* px, const void* py, const void* pz,
                            const void* k, int Lk, void* tbl, void* ox, void* oy, void* oz,
                            long long S, int N, const void* consts, void* stream) {
  if (S <= 0 || N <= 0 || 4 * Lk < W) return (int)cudaErrorInvalidValue;
  const uint32_t* w = static_cast<const uint32_t*>(consts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L == 16 && W == 63) return launch<8, 63>(px, py, pz, k, Lk, tbl, ox, oy, oz, S, N, w, s);
  if (L == 24 && W == 64) return launch<12, 64>(px, py, pz, k, Lk, tbl, ox, oy, oz, S, N, w, s);
  return (int)cudaErrorInvalidValue;
}
