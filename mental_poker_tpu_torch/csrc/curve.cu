// Batched complete point addition: (X3:Y3:Z3)[i] = P[i] + Q[i], and the
// window fold of the gather MSM engine (below).
//
// Replaces mental_poker_tpu/ops/pallas/curve.py::_add_kernel. One thread per
// addition runs mont.cuh's point_add (RCB15 Algorithm 1: 12 general
// Montgomery products, 2 by 3b, 3 by a unless a is 0 or 1, and 19 modular
// adds) with all intermediates in registers: device memory sees exactly six
// coordinates in and three out. Bound on the H100: memory and arithmetic
// nearly balance at the peak rates: a Stark addition (a = 1) moves 576 bytes
// against 14 x 136 = 1,904 word products (3,808 multiply-add instructions),
// and the multiply-adds take about 1.3x longer.
#include "fold.cuh"

template <int NW, int AC>
__global__ void point_add_kernel(const uint32_t* __restrict__ x1, const uint32_t* __restrict__ y1,
                                 const uint32_t* __restrict__ z1, const uint32_t* __restrict__ x2,
                                 const uint32_t* __restrict__ y2, const uint32_t* __restrict__ z2,
                                 uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                                 uint32_t* __restrict__ oz, long long n, CurveConsts<NW> C) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long off = i * 2 * NW;
  Pt<NW> P, Q;
  load_elem<NW>(x1 + off, P.x);
  load_elem<NW>(y1 + off, P.y);
  load_elem<NW>(z1 + off, P.z);
  load_elem<NW>(x2 + off, Q.x);
  load_elem<NW>(y2 + off, Q.y);
  load_elem<NW>(z2 + off, Q.z);
  point_add<NW, AC>(P, P, Q, C);
  store_elem<NW>(ox + off, P.x);
  store_elem<NW>(oy + off, P.y);
  store_elem<NW>(oz + off, P.z);
}

template <int NW, int AC>
static int launch(const void* const* in, void* const* out, long long n, const CurveConsts<NW>& C,
                  cudaStream_t stream) {
  const int threads = 128;
  const long long blocks = (n + threads - 1) / threads;
  const uint32_t* const* i = reinterpret_cast<const uint32_t* const*>(in);
  uint32_t* const* o = reinterpret_cast<uint32_t* const*>(out);
  point_add_kernel<NW, AC><<<(unsigned)blocks, threads, 0, stream>>>(
      i[0], i[1], i[2], i[3], i[4], i[5], o[0], o[1], o[2], n, C);
  return (int)cudaGetLastError();
}

// L: limbs per coordinate (16 or 24); acase: 0 for a = 0, 1 for a = 1, 2 for
// any a (mont.cuh); consts: host words [p (L/2), n0, a (L/2), b3 (L/2),
// one (L/2)].
extern "C" int mp_point_add(int L, int acase, const void* x1, const void* y1, const void* z1,
                            const void* x2, const void* y2, const void* z2, void* ox, void* oy, void* oz,
                            long long n, const void* consts, void* stream) {
  const void* in[6] = {x1, y1, z1, x2, y2, z2};
  void* out[3] = {ox, oy, oz};
  const uint32_t* w = static_cast<const uint32_t*>(consts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (L) {
    case 16:
      return with_curve<8>(acase, w, [&](const CurveConsts<8>& C, auto ac) {
        return launch<8, decltype(ac)::value>(in, out, n, C, s);
      });
    case 24:
      return with_curve<12>(acase, w, [&](const CurveConsts<12>& C, auto ac) {
        return launch<12, decltype(ac)::value>(in, out, n, C, s);
      });
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// Window fold: out[i] = sum_w 2^(4 w) * S[w, i], window 0 least significant.
//
// Replaces mental_poker_tpu/ops/pallas/curve.py::_fold_kernel (the last step
// of the gather MSM engine and of the chunked MSM). Bound on the H100: for the
// few-statement calls of the host Bayer-Groth argument the latency of the
// fold's chain of W * 5 dependent point operations (315 Stark, 320
// BLS12-377), not the card's rate. Design: one warp per block, four lane
// groups of eight lanes, one statement each (fold.cuh's group_fold: the
// products of each RCB layer spread over a group's lanes, three products on
// the critical path of an operation). The block first stages its statements'
// W window sums from device memory ([W, n, L] 16-bit limbs, read once) into
// shared memory as packed words, all loads in flight together; the
// accumulators and the groups' scratch live there too. A group past n runs
// nothing (the __syncwarp masks are per group). The window (4 bits) and W are
// built in, as in msm.cu.
constexpr int kFoldC = 4;
constexpr int kFoldStatements = 32 / kGroup;  // statements per block

template <int NW, int W, int AC>
__global__ void __launch_bounds__(32) fold_windows_kernel(const uint32_t* __restrict__ sx,
                                                          const uint32_t* __restrict__ sy,
                                                          const uint32_t* __restrict__ sz,
                                                          uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                                                          uint32_t* __restrict__ oz, long long n,
                                                          CurveConsts<NW> C) {
  extern __shared__ __align__(16) uint32_t smem[];
  constexpr int kPer = fold_words<NW, W>();
  constexpr int kHalf = NW / 2;  // 16-byte loads per coordinate: 4 limbs -> 2 words each
  const long long s0 = (long long)blockIdx.x * kFoldStatements;
  const int ns = (int)min((long long)kFoldStatements, n - s0);
  // for window w and coordinate c the block's statements are ns * L
  // consecutive limbs of device memory
  const int per_wc = ns * kHalf;
  for (int idx = threadIdx.x; idx < W * 3 * per_wc; idx += blockDim.x) {
    const int wc = idx / per_wc, q = idx % per_wc;
    const int w = wc / 3, c = wc % 3;
    const uint32_t* src = (c == 0 ? sx : c == 1 ? sy : sz) + ((long long)w * n + s0) * 2 * NW;
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(src) + q);
    uint32_t* dst = smem + (q / kHalf) * kPer + wc * NW + 2 * (q % kHalf);
    dst[0] = v.x | (v.y << 16);
    dst[1] = v.z | (v.w << 16);
  }
  __syncthreads();
  const int grp = threadIdx.x / kGroup, g = threadIdx.x % kGroup;
  if (grp < ns) {
    uint32_t* sums = smem + grp * kPer;
    uint32_t* acc = sums + W * 3 * NW;
    group_fold<NW, W, kFoldC, AC>(acc, acc + 3 * NW, sums, g, C);
    if (g < 3) {
      uint32_t v[NW];
      load_words<NW>(acc + g * NW, v);
      store_elem<NW>((g == 0 ? ox : g == 1 ? oy : oz) + (s0 + grp) * 2 * NW, v);
    }
  }
}

template <int NW, int W, int AC>
static int launch_fold(const void* sx, const void* sy, const void* sz, void* ox, void* oy, void* oz,
                       long long n, const CurveConsts<NW>& C, cudaStream_t stream) {
  const long long blocks = (n + kFoldStatements - 1) / kFoldStatements;
  const size_t shared = (size_t)kFoldStatements * fold_words<NW, W>() * sizeof(uint32_t);
  fold_windows_kernel<NW, W, AC><<<(unsigned)blocks, 32, shared, stream>>>(
      static_cast<const uint32_t*>(sx), static_cast<const uint32_t*>(sy),
      static_cast<const uint32_t*>(sz), static_cast<uint32_t*>(ox), static_cast<uint32_t*>(oy),
      static_cast<uint32_t*>(oz), n, C);
  return (int)cudaGetLastError();
}

// L: limbs per coordinate; W: windows, built in per curve (Stark L = 16 with
// W = 63, BLS12-377 G1 L = 24 with W = 64); acase as for mp_point_add; window
// sums [W, n, L]; outputs [n, L]; consts as for mp_point_add.
extern "C" int mp_fold_windows(int L, int W, int acase, const void* sx, const void* sy, const void* sz,
                               void* ox, void* oy, void* oz, long long n, const void* consts,
                               void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const uint32_t* w = static_cast<const uint32_t*>(consts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L == 16 && W == 63) {
    return with_curve<8>(acase, w, [&](const CurveConsts<8>& C, auto ac) {
      return launch_fold<8, 63, decltype(ac)::value>(sx, sy, sz, ox, oy, oz, n, C, s);
    });
  }
  if (L == 24 && W == 64) {
    return with_curve<12>(acase, w, [&](const CurveConsts<12>& C, auto ac) {
      return launch_fold<12, 64, decltype(ac)::value>(sx, sy, sz, ox, oy, oz, n, C, s);
    });
  }
  return (int)cudaErrorInvalidValue;
}
