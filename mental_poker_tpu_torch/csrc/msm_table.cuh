// Shared by msm.cu and msm_chunked.cu: the 4-bit window and the kernel that
// builds every point's multiples table (the first pass of both per-statement
// MSM kernels).
#pragma once

#include "mont.cuh"

constexpr int kC = 4;         // window bits
constexpr int kT = 1 << kC;  // multiples per point

// tbl[(sn * T + t) * 3NW ...] = t * P[sn]: entry 0 the identity, entry 1 the
// point itself, entry t = entry (t - 1) + P.
template <int NW, int AC>
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
    point_add<NW, AC>(acc, acc, P, C);
    store_pt<NW>(out + t * 3 * NW, acc);
  }
}

// Launch msm_table_kernel over sn_count (statement, point) pairs.
template <int NW, int AC>
inline cudaError_t launch_tables(const void* px, const void* py, const void* pz, void* tbl,
                                 long long sn_count, const CurveConsts<NW>& C, cudaStream_t stream) {
  const int threads = 128;
  msm_table_kernel<NW, AC><<<(unsigned)((sn_count + threads - 1) / threads), threads, 0, stream>>>(
      static_cast<const uint32_t*>(px), static_cast<const uint32_t*>(py),
      static_cast<const uint32_t*>(pz), static_cast<uint32_t*>(tbl), sn_count, C);
  return cudaGetLastError();
}
