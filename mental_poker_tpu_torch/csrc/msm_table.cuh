// Shared by msm.cu and msm_chunked.cu: the 4-bit window, packed-word point
// access in device-memory scratch, and the kernel that builds every point's
// multiples table (the first pass of both per-statement MSM kernels).
#pragma once

#include "mont.cuh"

constexpr int kC = 4;         // window bits
constexpr int kT = 1 << kC;  // multiples per point

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

// tbl[(sn * T + t) * 3NW ...] = t * P[sn]: entry 0 the identity, entry 1 the
// point itself, entry t = entry (t - 1) + P.
template <int NW>
__global__ void msm_table_kernel(const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
                                 const uint32_t* __restrict__ pz, uint32_t* __restrict__ tbl,
                                 long long sn_count, CurveConsts<NW> C) {
  const long long sn = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (sn >= sn_count) return;
  Pt<NW> P, acc;
  load_elem<NW>(px + sn * 2 * NW, P.x);
  load_elem<NW>(py + sn * 2 * NW, P.y);
  load_elem<NW>(pz + sn * 2 * NW, P.z);
  uint32_t* out = tbl + sn * kT * 3 * NW;
  set_identity<NW>(acc, C);
  store_pt<NW>(out, acc);
  store_pt<NW>(out + 3 * NW, P);
  acc = P;
  for (int t = 2; t < kT; ++t) {
    point_add<NW>(acc, acc, P, C);
    store_pt<NW>(out + t * 3 * NW, acc);
  }
}

// Launch msm_table_kernel over sn_count (statement, point) pairs.
template <int NW>
inline cudaError_t launch_tables(const void* px, const void* py, const void* pz, void* tbl,
                                 long long sn_count, const CurveConsts<NW>& C, cudaStream_t stream) {
  const int threads = 128;
  msm_table_kernel<NW><<<(unsigned)((sn_count + threads - 1) / threads), threads, 0, stream>>>(
      static_cast<const uint32_t*>(px), static_cast<const uint32_t*>(py),
      static_cast<const uint32_t*>(pz), static_cast<uint32_t*>(tbl), sn_count, C);
  return cudaGetLastError();
}
