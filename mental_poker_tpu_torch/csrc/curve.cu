// Batched complete point addition: (X3:Y3:Z3)[i] = P[i] + Q[i], and the
// window fold of the gather MSM engine (below).
//
// Replaces mental_poker_tpu/ops/pallas/curve.py::_add_kernel. One thread per
// addition runs mont.cuh's point_add (RCB15 Algorithm 1, 17 Montgomery
// products and 19 modular adds) with all intermediates in registers: device
// memory sees exactly six coordinates in and three out. Bound on the H100:
// memory and arithmetic nearly balance at the peak rates: a Stark addition
// moves 576 bytes against 17 x 136 = 2,312 word products (4,624 multiply-add
// instructions), and the bytes take about 1.2x longer.
#include "mont.cuh"

template <int NW>
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
  point_add<NW>(P, P, Q, C);
  store_elem<NW>(ox + off, P.x);
  store_elem<NW>(oy + off, P.y);
  store_elem<NW>(oz + off, P.z);
}

template <int NW>
static int launch(const void* const* in, void* const* out, long long n, const uint32_t* consts,
                  cudaStream_t stream) {
  const int threads = 128;
  const long long blocks = (n + threads - 1) / threads;
  const uint32_t* const* i = reinterpret_cast<const uint32_t* const*>(in);
  uint32_t* const* o = reinterpret_cast<uint32_t* const*>(out);
  point_add_kernel<NW><<<(unsigned)blocks, threads, 0, stream>>>(
      i[0], i[1], i[2], i[3], i[4], i[5], o[0], o[1], o[2], n, curve_consts<NW>(consts));
  return (int)cudaGetLastError();
}

// L: limbs per coordinate (16 or 24); consts: host words
// [p (L/2), n0, a (L/2), b3 (L/2), one (L/2)].
extern "C" int mp_point_add(int L, const void* x1, const void* y1, const void* z1, const void* x2,
                            const void* y2, const void* z2, void* ox, void* oy, void* oz,
                            long long n, const void* consts, void* stream) {
  const void* in[6] = {x1, y1, z1, x2, y2, z2};
  void* out[3] = {ox, oy, oz};
  const uint32_t* w = static_cast<const uint32_t*>(consts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (L) {
    case 16: return launch<8>(in, out, n, w, s);
    case 24: return launch<12>(in, out, n, w, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// Window fold: out[i] = sum_w 2^(4 w) * S[w, i], window 0 least significant.
//
// Replaces mental_poker_tpu/ops/pallas/curve.py::_fold_kernel (the last step
// of the gather MSM engine). One thread per statement runs mont.cuh's
// fold_windows with the accumulator in registers: W * 5 dependent additions
// (315 for Stark, 320 for BLS12-377), reading each window sum once from
// device memory and writing the result once. Bound on the H100: for a single
// statement (the host Bayer-Groth argument's combos) the latency of that
// chain, not the card's rate; the window (4 bits) and W are built in, as in
// msm.cu.
constexpr int kFoldC = 4;

template <int NW, int W>
__global__ void fold_windows_kernel(const uint32_t* __restrict__ sx, const uint32_t* __restrict__ sy,
                                    const uint32_t* __restrict__ sz, uint32_t* __restrict__ ox,
                                    uint32_t* __restrict__ oy, uint32_t* __restrict__ oz, long long n,
                                    CurveConsts<NW> C) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Pt<NW> acc;
  fold_windows<NW, W, kFoldC>(acc, [=](int w, Pt<NW>& s) {
    const long long off = ((long long)w * n + i) * 2 * NW;
    load_elem<NW>(sx + off, s.x);
    load_elem<NW>(sy + off, s.y);
    load_elem<NW>(sz + off, s.z);
  }, C);
  const long long off = i * 2 * NW;
  store_elem<NW>(ox + off, acc.x);
  store_elem<NW>(oy + off, acc.y);
  store_elem<NW>(oz + off, acc.z);
}

template <int NW, int W>
static int launch_fold(const void* sx, const void* sy, const void* sz, void* ox, void* oy, void* oz,
                       long long n, const uint32_t* consts, cudaStream_t stream) {
  const int threads = 128;
  const long long blocks = (n + threads - 1) / threads;
  fold_windows_kernel<NW, W><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const uint32_t*>(sx), static_cast<const uint32_t*>(sy),
      static_cast<const uint32_t*>(sz), static_cast<uint32_t*>(ox), static_cast<uint32_t*>(oy),
      static_cast<uint32_t*>(oz), n, curve_consts<NW>(consts));
  return (int)cudaGetLastError();
}

// L: limbs per coordinate; W: windows, built in per curve (Stark L = 16 with
// W = 63, BLS12-377 G1 L = 24 with W = 64); window sums [W, n, L]; outputs
// [n, L]; consts as for mp_point_add.
extern "C" int mp_fold_windows(int L, int W, const void* sx, const void* sy, const void* sz,
                               void* ox, void* oy, void* oz, long long n, const void* consts,
                               void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const uint32_t* w = static_cast<const uint32_t*>(consts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L == 16 && W == 63) return launch_fold<8, 63>(sx, sy, sz, ox, oy, oz, n, w, s);
  if (L == 24 && W == 64) return launch_fold<12, 64>(sx, sy, sz, ox, oy, oz, n, w, s);
  return (int)cudaErrorInvalidValue;
}
