// Batched Montgomery multiply: out[i] = a[i] * b[i] * R^-1 mod p.
//
// Replaces mental_poker_tpu/ops/pallas/field.py::_mont_mul_kernel. One
// thread per element: it loads both operands' 16-bit limbs as 32-bit words,
// runs mont.cuh's CIOS product on the carry flag (2*NW^2 + NW word products) and stores
// the reduced result. Bound on the H100: device memory. A Stark element
// moves 192 bytes (two operands in, one out, 16-bit limbs stored as 32-bit
// ints) against 136 word products (272 multiply-add instructions), which at
// the peak rates is about 7x more time in memory than in arithmetic; so the
// design reads each operand once with 16-byte loads and keeps every
// intermediate in registers.
#include "mont.cuh"

template <int NW>
__global__ void mont_mul_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                                uint32_t* __restrict__ out, long long n, FieldConsts<NW> F) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[NW], y[NW], r[NW];
  load_elem<NW>(a + i * 2 * NW, x);
  load_elem<NW>(b + i * 2 * NW, y);
  mont_mul<NW>(r, x, y, F);
  store_elem<NW>(out + i * 2 * NW, r);
}

template <int NW>
static int launch(const void* a, const void* b, void* out, long long n, const uint32_t* consts,
                  cudaStream_t stream) {
  const int threads = 128;
  const long long blocks = (n + threads - 1) / threads;
  mont_mul_kernel<NW><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<uint32_t*>(out), n, field_consts<NW>(consts));
  return (int)cudaGetLastError();
}

// L: limbs per element (16 or 24); consts: host words [p (L/2), n0].
extern "C" int mp_mont_mul(int L, const void* a, const void* b, void* out, long long n,
                           const void* consts, void* stream) {
  const uint32_t* w = static_cast<const uint32_t*>(consts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (L) {
    case 16: return launch<8>(a, b, out, n, w, s);
    case 24: return launch<12>(a, b, out, n, w, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
