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
//   msm_window_fold_kernel  one block of 2 W threads for two statements, one
//                           thread per (statement, window): the window sum
//                           over the N points (one table read and one
//                           addition per point) into shared memory; then, for
//                           each statement, one lane group of eight threads
//                           of the block folds the W sums MSB-first,
//                           acc = 2^c acc + S_w (W * (c + 1) additions;
//                           fold.cuh's group_fold, which curve.cu's fold
//                           kernel runs too).
//
// The schedule is the same as the plain PyTorch version in ops/cuda/msm.py,
// so both give the same projective triples limb for limb. Bound on the H100:
// integer multiply-adds in the window phase (a dependent chain of N
// additions per thread, many threads per SM: __launch_bounds__ caps the
// registers so that four blocks, 16 warps, fit on an SM for Stark); for a
// narrow call the latency of the fold, three products per point operation on
// the lane group. Device memory sees the points and scalars once, the tables
// (written once and read by every window thread of their statement, mostly
// from L2) and the outputs once.
#include "fold.cuh"
#include "msm_table.cuh"

constexpr int kMsmStatements = 2;  // statements per block

// Block b, thread t: statement s = 2 b + t / W, window w = t % W:
// S_w = sum_i tbl[s, i, digit_w(k[s, i])], from the identity, adding in
// point order. Then lane group j of the block (threads 8 j .. 8 j + 7) folds
// statement 2 b + j. The launch bounds ask for four blocks an SM on Stark
// (at most 128 registers a thread) and two for BLS12-377's wider additions.
template <int NW, int W, int AC>
__global__ void __launch_bounds__(kMsmStatements * W, NW == 8 ? 4 : 2)
    msm_window_fold_kernel(const uint32_t* __restrict__ tbl, const uint32_t* __restrict__ k, int Lk, int N,
                           long long S, uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                           uint32_t* __restrict__ oz, CurveConsts<NW> C) {
  extern __shared__ __align__(16) uint32_t smem[];
  constexpr int kPer = fold_words<NW, W>();
  const long long s0 = (long long)blockIdx.x * kMsmStatements;
  {
    const int local = threadIdx.x / W;
    const int w = threadIdx.x % W;
    const long long s = s0 + local;
    if (s < S) {
      const int limb = (w * kC) >> 4;
      const int shift = (w * kC) & 15;
      Pt<NW> acc, e;
      set_identity<NW>(acc, C);
      for (int i = 0; i < N; ++i) {
        const long long sn = s * N + i;
        const uint32_t d = (k[sn * Lk + limb] >> shift) & (uint32_t)(kT - 1);
        load_pt<NW>(tbl + (sn * kT + d) * 3 * NW, e);
        point_add<NW, AC>(acc, acc, e, C);
      }
      store_pt<NW>(smem + local * kPer + w * 3 * NW, acc);
    }
  }
  __syncthreads();
  const int grp = threadIdx.x / kGroup, g = threadIdx.x % kGroup;
  if (grp < kMsmStatements && s0 + grp < S) {
    uint32_t* sums = smem + grp * kPer;
    uint32_t* acc = sums + W * 3 * NW;
    group_fold<NW, W, kC, AC>(acc, acc + 3 * NW, sums, g, C);
    if (g < 3) {
      uint32_t v[NW];
      load_words<NW>(acc + g * NW, v);
      store_elem<NW>((g == 0 ? ox : g == 1 ? oy : oz) + (s0 + grp) * 2 * NW, v);
    }
  }
}

template <int NW, int W, int AC>
static int launch(const void* px, const void* py, const void* pz, const void* k, int Lk, void* tbl,
                  void* ox, void* oy, void* oz, long long S, int N, const CurveConsts<NW>& C,
                  cudaStream_t stream) {
  cudaError_t err = launch_tables<NW, AC>(px, py, pz, tbl, S * (long long)N, C, stream);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (S + kMsmStatements - 1) / kMsmStatements;
  const size_t shared = (size_t)kMsmStatements * fold_words<NW, W>() * sizeof(uint32_t);
  msm_window_fold_kernel<NW, W, AC><<<(unsigned)blocks, kMsmStatements * W, shared, stream>>>(
      static_cast<const uint32_t*>(tbl), static_cast<const uint32_t*>(k), Lk, N, S,
      static_cast<uint32_t*>(ox), static_cast<uint32_t*>(oy), static_cast<uint32_t*>(oz), C);
  return (int)cudaGetLastError();
}

// L: limbs per coordinate; W: 4-bit windows of the scalar field; the two
// curves are Stark (L = 16, W = 63) and BLS12-377 G1 (L = 24, W = 64).
// points [S, N, L]; k: canonical scalar limbs [S, N, Lk] with Lk >= W / 4;
// tbl: scratch of S*N*16*3*(L/2) words; outputs [S, L]; acase and consts as
// in curve.cu.
extern "C" int mp_msm_lanes(int L, int W, int acase, const void* px, const void* py, const void* pz,
                            const void* k, int Lk, void* tbl, void* ox, void* oy, void* oz,
                            long long S, int N, const void* consts, void* stream) {
  if (S <= 0 || N <= 0 || 4 * Lk < W) return (int)cudaErrorInvalidValue;
  const uint32_t* w = static_cast<const uint32_t*>(consts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L == 16 && W == 63) {
    return with_curve<8>(acase, w, [&](const CurveConsts<8>& C, auto ac) {
      return launch<8, 63, decltype(ac)::value>(px, py, pz, k, Lk, tbl, ox, oy, oz, S, N, C, s);
    });
  }
  if (L == 24 && W == 64) {
    return with_curve<12>(acase, w, [&](const CurveConsts<12>& C, auto ac) {
      return launch<12, 64, decltype(ac)::value>(px, py, pz, k, Lk, tbl, ox, oy, oz, S, N, C, s);
    });
  }
  return (int)cudaErrorInvalidValue;
}
