// Chunked per-statement MSM, window sums out: for each statement s and 4-bit
// window w, S[w, s] = sum_i digit_w(k[s, i]) * P[s, i], taking NC points per
// sequential step.
//
// Replaces mental_poker_tpu/ops/pallas/msm.py::_msm_kernel_chunked in its
// `emit` mode (builder _build_msm_chunked(emit=True), adapter
// _kern_drop_fld): the window sums go out and the fold kernel of curve.cu
// folds them (ops/cuda/msm.py::msm_lanes with nc > 1). The TPU kernel walks
// NB = ceil(N / NC) chunks; in each it builds the NC points' multiples
// tables, selects every window's entry per point, reduces the NC entries by
// a pairwise tree (left to right, an odd element carried up) and adds the
// tree's root to the window sums. Here:
//
//   msm_table_kernel          (msm_table.cuh, shared with msm.cu) one thread
//                             per (statement, point): the multiples table
//                             t*P for t < 16, in device memory;
//   msm_chunked_window_kernel one thread per (statement, window, chunk slot
//                             k < NC), a block holding 128 / NC windows of
//                             one statement: per chunk, slot k picks point
//                             j*NC + k's entry by digit (the identity for a
//                             pad slot past N, as the TPU's digit-0 pad
//                             points); the tree runs through shared memory,
//                             at level h slot i (a multiple of 2h) adding
//                             slot i + h when that slot exists, which is the
//                             TPU's pairing with its odd carry; slot 0 then
//                             adds the root to its window sum, which starts
//                             at the identity.
//
// Every addition has the TPU kernel's operands in its order, so the window
// sums equal the plain PyTorch version (ops/cuda/msm.py::msm_chunked_plain)
// limb for limb. NC is a runtime argument from 1 to kMaxNC = 8. Bound on the
// H100: integer multiply-adds (14 table additions per point, NB * NC
// additions per window); the dependent chain of one window is NB tree-and-
// accumulate steps of ceil(log2 NC) + 1 additions. Points, scalars and
// window sums cross device memory once; the tables are written once and read
// by the window threads of their statement.
#include "msm_table.cuh"

constexpr int kMaxNC = 8;
constexpr int kBlockThreads = 128;

template <int NW, int AC>
__global__ void msm_chunked_window_kernel(const uint32_t* __restrict__ tbl, const uint32_t* __restrict__ k,
                                          int Lk, int N, int NC, int W, int groups,
                                          uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                                          uint32_t* __restrict__ oz, long long S, CurveConsts<NW> C) {
  extern __shared__ __align__(16) uint32_t slots[];  // [blockDim.x][3 NW]
  const int wg = blockDim.x / NC;                      // windows per block
  const long long s = blockIdx.x / groups;
  const int w = (blockIdx.x % groups) * wg + threadIdx.x / NC;
  const int slot = threadIdx.x % NC;
  const bool live = w < W;
  const int limb = (w * kC) >> 4;
  const int shift = (w * kC) & 15;
  uint32_t* mine = slots + threadIdx.x * 3 * NW;
  Pt<NW> acc, v, e;
  set_identity<NW>(acc, C);
  const int nb = (N + NC - 1) / NC;
  for (int j = 0; j < nb; ++j) {
    const int i = j * NC + slot;
    if (live && i < N) {
      const long long sn = s * N + i;
      const uint32_t d = (k[sn * Lk + limb] >> shift) & (uint32_t)(kT - 1);
      load_pt<NW>(tbl + (sn * kT + d) * 3 * NW, v);
    } else {
      set_identity<NW>(v, C);
    }
    for (int h = 1; h < NC; h <<= 1) {
      if (slot % (2 * h) == h) store_pt<NW>(mine, v);
      __syncthreads();
      if (slot % (2 * h) == 0 && slot + h < NC) {
        load_pt<NW>(mine + h * 3 * NW, e);
        point_add<NW, AC>(v, v, e, C);
      }
    }
    if (slot == 0) point_add<NW, AC>(acc, acc, v, C);
    __syncthreads();  // the next chunk's stores wait for this chunk's reads
  }
  if (live && slot == 0) {
    const long long off = ((long long)w * S + s) * 2 * NW;
    store_elem<NW>(ox + off, acc.x);
    store_elem<NW>(oy + off, acc.y);
    store_elem<NW>(oz + off, acc.z);
  }
}

template <int NW, int AC>
static int launch(int W, const void* px, const void* py, const void* pz, const void* k, int Lk, void* tbl,
                  void* ox, void* oy, void* oz, long long S, int N, int NC, const CurveConsts<NW>& C,
                  cudaStream_t stream) {
  cudaError_t err = launch_tables<NW, AC>(px, py, pz, tbl, S * (long long)N, C, stream);
  if (err != cudaSuccess) return (int)err;
  const int wg = kBlockThreads / NC;
  const int groups = (W + wg - 1) / wg;
  const int threads = wg * NC;
  const size_t shared = (size_t)threads * 3 * NW * sizeof(uint32_t);
  msm_chunked_window_kernel<NW, AC><<<(unsigned)(S * groups), threads, shared, stream>>>(
      static_cast<const uint32_t*>(tbl), static_cast<const uint32_t*>(k), Lk, N, NC, W, groups,
      static_cast<uint32_t*>(ox), static_cast<uint32_t*>(oy), static_cast<uint32_t*>(oz), S, C);
  return (int)cudaGetLastError();
}

// L: limbs per coordinate (16 Stark, 24 BLS12-377 G1); W: 4-bit windows,
// with Lk >= W / 4; points [S, N, L]; k: canonical scalar limbs [S, N, Lk];
// NC: points per step, 1..kMaxNC; tbl: scratch of S*N*16*3*(L/2) words;
// outputs: window sums [W, S, L]; acase and consts as in curve.cu.
extern "C" int mp_msm_chunked(int L, int W, int acase, const void* px, const void* py, const void* pz,
                              const void* k, int Lk, void* tbl, void* ox, void* oy, void* oz,
                              long long S, int N, int NC, const void* consts, void* stream) {
  if (S <= 0 || N <= 0 || W <= 0 || 4 * Lk < W || NC < 1 || NC > kMaxNC) return (int)cudaErrorInvalidValue;
  const uint32_t* w = static_cast<const uint32_t*>(consts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L == 16) {
    return with_curve<8>(acase, w, [&](const CurveConsts<8>& C, auto ac) {
      return launch<8, decltype(ac)::value>(W, px, py, pz, k, Lk, tbl, ox, oy, oz, S, N, NC, C, s);
    });
  }
  if (L == 24) {
    return with_curve<12>(acase, w, [&](const CurveConsts<12>& C, auto ac) {
      return launch<12, decltype(ac)::value>(W, px, py, pz, k, Lk, tbl, ox, oy, oz, S, N, NC, C, s);
    });
  }
  return (int)cudaErrorInvalidValue;
}
