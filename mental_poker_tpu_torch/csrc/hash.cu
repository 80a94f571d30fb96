// The Fiat-Shamir transcript's two hash primitives, one thread per transcript
// lane:
//
//   blake2s_kernel      Blake2s-256 (unkeyed, 32-byte digest) of one message
//                       row a lane, optionally followed by a 32-byte suffix
//                       given as eight little-endian words (the transcript's
//                       seed: absorb hashes data || seed);
//   chacha_draw_kernel  the transcript's challenge draw: K consecutive
//                       candidates of NW words from a lane's ChaCha20
//                       keystream, the top word masked, the first candidate
//                       below the modulus kept (arkworks UniformRand).
//
// Replaces no TPU kernel: the JAX package computes both as jnp code
// (mental_poker_tpu/crypto/hash_jax.py, transcript_jax.py), which the port's
// plain versions (crypto/hash_dev.py, transcript_dev.py) follow op for op.
// On the card those plain versions launch ~670 elementwise kernels a
// 64-byte block or a draw round, each moving a few words of every lane.
// Bound on the H100: 32-bit integer operations (about 1,200 a Blake2s
// compression, 1,000 a ChaCha20 block); device memory sees each message
// byte once. So one thread keeps its lane's whole state (the chaining value,
// the message block, the keystream block) in registers or shared memory and
// runs every compression or block of the lane in one loop; rotations are
// funnel shifts.
//
// Message rows are staged a 64-byte block at a time through shared memory:
// the block's threads load the rows' bytes together, neighbouring threads on
// neighbouring bytes (rows may have any length and alignment, and a row
// stride of 0 when every lane hashes the same row), then each thread reads
// its own row's 16 words. The counter t and the last-block flag are those of
// hash_dev.blake2s: t = 64 (i + 1) for block i before the last, t = the
// message length for the last; a message of 0 bytes is one block of zeros.
#include <cstdint>
#include <cuda_runtime.h>

constexpr int kThreads = 128;  // lanes a block, both kernels
constexpr int kRowWords = 17;  // a staged row: 16 words and one of padding (no bank conflicts)

constexpr uint32_t kIV0 = 0x6A09E667u, kIV1 = 0xBB67AE85u, kIV2 = 0x3C6EF372u, kIV3 = 0xA54FF53Au;
constexpr uint32_t kIV4 = 0x510E527Fu, kIV5 = 0x9B05688Cu, kIV6 = 0x1F83D9ABu, kIV7 = 0x5BE0CD19u;

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) { return __funnelshift_r(x, x, n); }
__device__ __forceinline__ uint32_t rotl(uint32_t x, int n) { return __funnelshift_l(x, x, n); }

#define B2S_G(a, b, c, d, x, y) \
  do {                          \
    a = a + b + (x);            \
    d = rotr(d ^ a, 16);        \
    c = c + d;                  \
    b = rotr(b ^ c, 12);        \
    a = a + b + (y);            \
    d = rotr(d ^ a, 8);         \
    c = c + d;                  \
    b = rotr(b ^ c, 7);         \
  } while (0)

// One round: the four column G functions, then the four diagonal ones; the
// arguments are the round's message permutation (Blake2s' SIGMA row).
#define B2S_ROUND(s0, s1, s2, s3, s4, s5, s6, s7, s8, s9, s10, s11, s12, s13, s14, s15) \
  do {                                                                                  \
    B2S_G(v0, v4, v8, v12, m[s0], m[s1]);                                               \
    B2S_G(v1, v5, v9, v13, m[s2], m[s3]);                                               \
    B2S_G(v2, v6, v10, v14, m[s4], m[s5]);                                              \
    B2S_G(v3, v7, v11, v15, m[s6], m[s7]);                                              \
    B2S_G(v0, v5, v10, v15, m[s8], m[s9]);                                              \
    B2S_G(v1, v6, v11, v12, m[s10], m[s11]);                                            \
    B2S_G(v2, v7, v8, v13, m[s12], m[s13]);                                             \
    B2S_G(v3, v4, v9, v14, m[s14], m[s15]);                                             \
  } while (0)

__device__ __forceinline__ void blake2s_compress(uint32_t h[8], const uint32_t m[16], unsigned long long t,
                                                 bool last) {
  uint32_t v0 = h[0], v1 = h[1], v2 = h[2], v3 = h[3], v4 = h[4], v5 = h[5], v6 = h[6], v7 = h[7];
  uint32_t v8 = kIV0, v9 = kIV1, v10 = kIV2, v11 = kIV3;
  uint32_t v12 = kIV4 ^ (uint32_t)t, v13 = kIV5 ^ (uint32_t)(t >> 32);
  uint32_t v14 = last ? ~kIV6 : kIV6, v15 = kIV7;
  B2S_ROUND(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15);
  B2S_ROUND(14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3);
  B2S_ROUND(11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4);
  B2S_ROUND(7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8);
  B2S_ROUND(9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13);
  B2S_ROUND(2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9);
  B2S_ROUND(12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11);
  B2S_ROUND(13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10);
  B2S_ROUND(6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5);
  B2S_ROUND(10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0);
  h[0] ^= v0 ^ v8;
  h[1] ^= v1 ^ v9;
  h[2] ^= v2 ^ v10;
  h[3] ^= v3 ^ v11;
  h[4] ^= v4 ^ v12;
  h[5] ^= v5 ^ v13;
  h[6] ^= v6 ^ v14;
  h[7] ^= v7 ^ v15;
}

// Lane i hashes data[i * data_stride, + n) || suffix words [i * suffix_stride,
// + 8) (no suffix when `suffix` is null) and writes its digest as eight int64
// words (out_words, [lanes, 8]) or as 32 bytes (out_bytes, [lanes, 32]),
// whichever is not null.
__global__ void __launch_bounds__(kThreads)
    blake2s_kernel(const uint8_t* __restrict__ data, long long data_stride, long long n,
                   const long long* __restrict__ suffix, long long suffix_stride, long long lanes,
                   long long* __restrict__ out_words, uint8_t* __restrict__ out_bytes) {
  __shared__ uint32_t stage[kThreads * kRowWords];
  uint8_t* stage_bytes = reinterpret_cast<uint8_t*>(stage);
  const long long lane0 = (long long)blockIdx.x * kThreads;
  const long long lane = lane0 + threadIdx.x;
  const int rows = (int)min((long long)kThreads, lanes - lane0);
  const long long total = n + (suffix ? 32 : 0);
  const long long nblocks = total > 0 ? (total + 63) / 64 : 1;
  uint32_t h[8] = {kIV0 ^ 0x01010020u, kIV1, kIV2, kIV3, kIV4, kIV5, kIV6, kIV7};
  for (long long blk = 0; blk < nblocks; ++blk) {
    __syncthreads();  // every thread has read the previous block's row
    for (int k = threadIdx.x; k < rows * 64; k += kThreads) {
      const int r = k >> 6, b = k & 63;
      const long long pos = blk * 64 + b;
      uint32_t byte = 0;
      if (pos < n) {
        byte = data[(lane0 + r) * data_stride + pos];
      } else if (pos < total) {
        const long long q = pos - n;
        byte = (uint32_t)(suffix[(lane0 + r) * suffix_stride + (q >> 2)] >> (8 * (q & 3))) & 0xFFu;
      }
      stage_bytes[r * kRowWords * 4 + b] = (uint8_t)byte;
    }
    __syncthreads();
    if (lane < lanes) {
      uint32_t m[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) m[i] = stage[threadIdx.x * kRowWords + i];
      const bool last = blk == nblocks - 1;
      blake2s_compress(h, m, last ? (unsigned long long)total : (unsigned long long)(blk + 1) * 64, last);
    }
  }
  if (lane >= lanes) return;
  if (out_words) {
#pragma unroll
    for (int i = 0; i < 8; ++i) out_words[lane * 8 + i] = h[i];
  } else {
    uint32_t* o = reinterpret_cast<uint32_t*>(out_bytes + lane * 32);  // 32-byte rows: aligned
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = h[i];
  }
}

#define CHACHA_QR(a, b, c, d) \
  do {                        \
    a += b;                   \
    d = rotl(d ^ a, 16);      \
    c += d;                   \
    b = rotl(b ^ c, 12);      \
    a += b;                   \
    d = rotl(d ^ a, 8);       \
    c += d;                   \
    b = rotl(b ^ c, 7);       \
  } while (0)

// ChaCha20 block `counter` of `key` (64-bit counter in words 12-13, nonce 0:
// the rand_chacha layout of crypto/transcript.py) -> out[16].
__device__ __forceinline__ void chacha_block(const uint32_t key[8], unsigned long long counter, uint32_t out[16]) {
  const uint32_t s[16] = {0x61707865u, 0x3320646Eu, 0x79622D32u, 0x6B206574u,
                          key[0], key[1], key[2], key[3], key[4], key[5], key[6], key[7],
                          (uint32_t)counter, (uint32_t)(counter >> 32), 0u, 0u};
  uint32_t x0 = s[0], x1 = s[1], x2 = s[2], x3 = s[3], x4 = s[4], x5 = s[5], x6 = s[6], x7 = s[7];
  uint32_t x8 = s[8], x9 = s[9], x10 = s[10], x11 = s[11], x12 = s[12], x13 = s[13], x14 = s[14], x15 = s[15];
  for (int r = 0; r < 10; ++r) {
    CHACHA_QR(x0, x4, x8, x12);
    CHACHA_QR(x1, x5, x9, x13);
    CHACHA_QR(x2, x6, x10, x14);
    CHACHA_QR(x3, x7, x11, x15);
    CHACHA_QR(x0, x5, x10, x15);
    CHACHA_QR(x1, x6, x11, x12);
    CHACHA_QR(x2, x7, x8, x13);
    CHACHA_QR(x3, x4, x9, x14);
  }
  out[0] = x0 + s[0];
  out[1] = x1 + s[1];
  out[2] = x2 + s[2];
  out[3] = x3 + s[3];
  out[4] = x4 + s[4];
  out[5] = x5 + s[5];
  out[6] = x6 + s[6];
  out[7] = x7 + s[7];
  out[8] = x8 + s[8];
  out[9] = x9 + s[9];
  out[10] = x10 + s[10];
  out[11] = x11 + s[11];
  out[12] = x12 + s[12];
  out[13] = x13 + s[13];
  out[14] = x14 + s[14];
  out[15] = x15 + s[15];
}

struct DrawConsts {
  uint32_t p[12];   // the modulus, little-endian words (NW of them used)
  uint32_t hi_mask;  // mask of a candidate's top word
};

// Lane i draws from keystream word widx[i] of key seed[i * seed_stride, + 8):
// candidate c is words widx + c NW .. widx + c NW + NW - 1. It writes the
// first candidate below the modulus (the last one, K - 1, when none is) as
// 2 NW 16-bit limbs, whether one was, and the words consumed: up to and
// including the accepted candidate, or all K candidates' when none was.
// The lane stops at its first accepted candidate. A candidate may start at
// any word of a keystream block and reach into the next, so each thread
// keeps its last two blocks in shared memory, word q at q % 32 (word-major,
// so the lanes of a warp hit different banks).
template <int NW>
__global__ void __launch_bounds__(kThreads)
    chacha_draw_kernel(const long long* __restrict__ seed, long long seed_stride,
                       const long long* __restrict__ widx, long long lanes, int K, DrawConsts F,
                       int32_t* __restrict__ value, bool* __restrict__ found, long long* __restrict__ adv) {
  __shared__ uint32_t ring[32][kThreads];
  const long long lane = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (lane >= lanes) return;
  uint32_t key[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) key[i] = (uint32_t)seed[lane * seed_stride + i];
  const unsigned long long start = (unsigned long long)widx[lane];
  unsigned long long next = start >> 4;  // the next keystream block to compute
  uint32_t cand[NW];
  int first = K;
  for (int c = 0; c < K; ++c) {
    const unsigned long long q0 = start + (unsigned long long)c * NW;
    while (next <= (q0 + NW - 1) >> 4) {
      uint32_t blk[16];
      chacha_block(key, next, blk);
#pragma unroll
      for (int i = 0; i < 16; ++i) ring[(int)(next & 1) * 16 + i][threadIdx.x] = blk[i];
      ++next;
    }
#pragma unroll
    for (int w = 0; w < NW; ++w) cand[w] = ring[(q0 + w) & 31][threadIdx.x];
    cand[NW - 1] &= F.hi_mask;
    bool lt = false;  // cand < p, most significant word first
#pragma unroll
    for (int w = NW - 1; w >= 0; --w) {
      if (cand[w] != F.p[w]) {
        lt = cand[w] < F.p[w];
        break;
      }
    }
    if (lt) {
      first = c;
      break;
    }
  }
  int32_t* v = value + lane * 2 * NW;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    v[2 * w] = (int32_t)(cand[w] & 0xFFFFu);
    v[2 * w + 1] = (int32_t)(cand[w] >> 16);
  }
  found[lane] = first < K;
  adv[lane] = first < K ? (long long)(first + 1) * NW : (long long)K * NW;
}

// data: uint8 rows (row stride data_stride, n bytes each, n may be 0);
// suffix: int64 words [lanes, 8] (row stride suffix_stride) or null; one of
// out_words (int64 [lanes, 8]) and out_bytes (uint8 [lanes, 32]) non-null.
extern "C" int mp_blake2s(const void* data, long long data_stride, long long n, const void* suffix,
                          long long suffix_stride, long long lanes, void* out_words, void* out_bytes,
                          void* stream) {
  if (lanes <= 0) return 0;
  const long long blocks = (lanes + kThreads - 1) / kThreads;
  blake2s_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), data_stride, n, static_cast<const long long*>(suffix), suffix_stride,
      lanes, static_cast<long long*>(out_words), static_cast<uint8_t*>(out_bytes));
  return (int)cudaGetLastError();
}

template <int NW>
static int launch_draw(const void* seed, long long seed_stride, const void* widx, long long lanes, int K,
                       const DrawConsts& F, void* value, void* found, void* adv, cudaStream_t stream) {
  const long long blocks = (lanes + kThreads - 1) / kThreads;
  chacha_draw_kernel<NW><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const long long*>(seed), seed_stride, static_cast<const long long*>(widx), lanes, K, F,
      static_cast<int32_t*>(value), static_cast<bool*>(found), static_cast<long long*>(adv));
  return (int)cudaGetLastError();
}

// nw: words a candidate (8 or 12); consts: host words [p (nw words), top-word mask].
extern "C" int mp_chacha_draw(int nw, const void* seed, long long seed_stride, const void* widx, long long lanes,
                              int K, const void* consts, void* value, void* found, void* adv, void* stream) {
  if (lanes <= 0) return 0;
  if (K <= 0) return (int)cudaErrorInvalidValue;
  const uint32_t* w = static_cast<const uint32_t*>(consts);
  DrawConsts F = {};
  for (int j = 0; j < nw && j < 12; ++j) F.p[j] = w[j];
  F.hi_mask = w[nw];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nw) {
    case 8: return launch_draw<8>(seed, seed_stride, widx, lanes, K, F, value, found, adv, s);
    case 12: return launch_draw<12>(seed, seed_stride, widx, lanes, K, F, value, found, adv, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
