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
// a pairwise tree, level by level (left to right, an odd element carried
// up), and adds the tree's root to the window sums. Here:
//
//   msm_table_kernel          (msm_table.cuh, shared with msm.cu) one thread
//                             per (statement, point): the multiples table
//                             t*P for t < 16, in device memory;
//   msm_chunked_window_kernel one thread per (statement, window), two
//                             statements to a block of 2 W threads: each
//                             thread walks its window's chunks in order and
//                             evaluates each chunk's tree in post-order, the
//                             way a binary counter carries. A slot's value is
//                             the table entry at its point's digit (the
//                             identity for a pad slot past N, as the TPU's
//                             digit-0 pad points). Slot values come in left
//                             to right; while the two newest partial sums
//                             cover blocks of one size they merge as
//                             (older + newer); at the chunk's end what is
//                             left folds from the newest down as (older +
//                             newer); then the root goes into the window sum,
//                             which starts at the identity. That is the TPU's
//                             level-by-level pairing with its odd carry for
//                             every NC (NC = 7: (0123) + ((45) + 6)).
//
// What bounds it on the H100: integer multiply-adds. The TPU kernel's tree
// has independent additions within a level; a lane per chunk slot would
// leave half the lanes idle at each level and need a block barrier per
// level. Here every lane of a warp does one addition per step and nothing
// waits on a barrier: a window's dependent chain is 14 table additions and
// then NB * NC additions (NC - 1 in each tree and one accumulate per chunk),
// where a lane per slot would have NB * (ceil(log2 NC) + 1). The running
// value and the operand live in registers; the partial sums a chunk can
// leave waiting (two for up to 8 slots, five for up to 64) and the window
// sum live in shared memory, thread-private, with the thread index
// innermost so that a warp's 32 accesses of a word fall on 32 banks.
// __launch_bounds__ caps the registers so that four blocks (16 warps) fit
// on an SM for Stark at NC <= 8. Points, scalars and
// window sums cross device memory once; the tables are written once and read
// by the window threads of their statement, mostly from L2.
//
// Every addition has the TPU kernel's operands in its order, so the window
// sums equal the plain PyTorch version (ops/cuda/msm.py::msm_chunked_plain)
// limb for limb. NC is a runtime argument from 1 to kMaxNC = 64, which
// covers the JAX package's largest NC (52, its most points per call).
//
// A chunk of up to 2^(k+1) slots leaves at most k partial sums waiting, so
// the launch sizes each thread's shared memory for NC: k + 1 points (the
// window sum after the k partial sums). NC 5-8 takes three points a thread
// (36,288 bytes a block on Stark, four blocks an SM), NC 33-64 six (72,576
// bytes on Stark, three blocks an SM; 110,592 on BLS12-377, two).
#include "msm_table.cuh"

constexpr int kMaxNC = 64;
constexpr int kStatements = 2;    // statements per block
constexpr int kMaxW = 64;         // windows a statement may have: blocks of at most 128 threads

// Partial sums a chunk of NC slots can leave waiting: k = ceil(log2 NC) - 1
// (none for NC <= 2). The window sum takes the shared-memory slot after them.
static int stack_depth(int NC) {
  int k = 0;
  while ((2 << k) < NC) ++k;
  return k;
}

// Thread-private points in shared memory: word j of slot q of thread t at
// smem[(q * 3 NW + j) * T + t] for a block of T threads (`mine` = smem + t).
template <int NW>
__device__ __forceinline__ void load_slot(const uint32_t* mine, int q, int T, Pt<NW>& P) {
  const uint32_t* src = mine + q * 3 * NW * T;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    P.x[j] = src[j * T];
    P.y[j] = src[(NW + j) * T];
    P.z[j] = src[(2 * NW + j) * T];
  }
}

template <int NW>
__device__ __forceinline__ void store_slot(uint32_t* mine, int q, int T, const Pt<NW>& P) {
  uint32_t* dst = mine + q * 3 * NW * T;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    dst[j * T] = P.x[j];
    dst[(NW + j) * T] = P.y[j];
    dst[(2 * NW + j) * T] = P.z[j];
  }
}

// Block b, thread t: statement s = 2 b + t / W, window w = t % W; `acc` is
// the window sum's slot, stack_depth(NC). Each pass of the inner loop is one addition cur = e + cur (e
// the older block): the chunk's NC - 1 tree additions, then its accumulate.
// Before each, e (and cur) are set by the walk's state: `pending` merges still owed to the
// newest pair, `next` slots taken, `sp` partial sums waiting in slots
// 0 .. sp - 1. Control flow depends on N, NC and the chunk only, so the
// lanes of a warp never diverge.
template <int NW, int AC>
__global__ void __launch_bounds__(kStatements * kMaxW, NW == 8 ? 4 : 2)
    msm_chunked_window_kernel(const uint32_t* __restrict__ tbl, const uint32_t* __restrict__ k, int Lk, int N,
                              int NC, int acc, int W, long long S, uint32_t* __restrict__ ox,
                              uint32_t* __restrict__ oy, uint32_t* __restrict__ oz, CurveConsts<NW> C) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int T = blockDim.x;
  const long long s = (long long)blockIdx.x * kStatements + threadIdx.x / W;
  const int w = threadIdx.x % W;
  if (s >= S) return;
  const int shift = (w * kC) & 15;
  const uint32_t* ks = k + s * N * Lk + ((w * kC) >> 4);  // this window's limb of statement s's scalars
  const uint32_t* ts = tbl + s * N * kT * 3 * NW;          // statement s's tables
  uint32_t* mine = smem + threadIdx.x;
  // slot value of point i: its table entry at this window's digit, the identity past N
  auto leaf = [&](int i, Pt<NW>& P) {
    if (i < N) {
      const uint32_t d = (ks[(long long)i * Lk] >> shift) & (uint32_t)(kT - 1);
      load_pt<NW>(ts + ((long long)i * kT + d) * 3 * NW, P);
    } else {
      set_identity<NW>(P, C);
    }
  };
  Pt<NW> cur, e;
  set_identity<NW>(cur, C);
  store_slot<NW>(mine, acc, T, cur);
  const int nb = (N + NC - 1) / NC;
  for (int j = 0; j < nb; ++j) {
    const int base = j * NC;
    int next = 0, sp = 0, pending = 0;
    for (int a = 0; a < NC; ++a) {
      bool paired = false;
      if (pending > 0) {  // the pair just made merges with the block below it
        --pending;
        load_slot<NW>(mine, --sp, T, e);
        paired = true;
      } else if (next < NC) {  // an even slot opens a block; the odd slot after it pairs with it
        if (next > 0) store_slot<NW>(mine, sp++, T, cur);
        leaf(base + next++, cur);
        if (next < NC) {
          e = cur;
          leaf(base + next++, cur);
          pending = __ffs(next) - 2;  // blocks of equal size below: one merge per trailing zero bit of next, less this one
          paired = true;
        }
      }
      if (!paired) load_slot<NW>(mine, sp > 0 ? --sp : acc, T, e);  // the chunk's end: fold down, then accumulate
      point_add<NW, AC>(cur, e, cur, C);
    }
    store_slot<NW>(mine, acc, T, cur);
  }
  const long long off = ((long long)w * S + s) * 2 * NW;
  store_elem<NW>(ox + off, cur.x);
  store_elem<NW>(oy + off, cur.y);
  store_elem<NW>(oz + off, cur.z);
}

template <int NW, int AC>
static int launch(int W, const void* px, const void* py, const void* pz, const void* k, int Lk, void* tbl,
                  void* ox, void* oy, void* oz, long long S, int N, int NC, const CurveConsts<NW>& C,
                  cudaStream_t stream) {
  cudaError_t err = launch_tables<NW, AC>(px, py, pz, tbl, S * (long long)N, C, stream);
  if (err != cudaSuccess) return (int)err;
  const int acc = stack_depth(NC);
  const int threads = kStatements * W;
  const size_t shared = (size_t)threads * (acc + 1) * 3 * NW * sizeof(uint32_t);
  if (shared > 48 * 1024) {  // above the default: BLS12-377 at NC > 4, Stark at NC > 16
    err = cudaFuncSetAttribute(msm_chunked_window_kernel<NW, AC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)shared);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (S + kStatements - 1) / kStatements;
  msm_chunked_window_kernel<NW, AC><<<(unsigned)blocks, threads, shared, stream>>>(
      static_cast<const uint32_t*>(tbl), static_cast<const uint32_t*>(k), Lk, N, NC, acc, W, S,
      static_cast<uint32_t*>(ox), static_cast<uint32_t*>(oy), static_cast<uint32_t*>(oz), C);
  return (int)cudaGetLastError();
}

// L: limbs per coordinate (16 Stark, 24 BLS12-377 G1); W: 4-bit windows, at
// most kMaxW, with Lk >= W / 4; points [S, N, L]; k: canonical scalar limbs
// [S, N, Lk]; NC: points per step, 1..kMaxNC (64); tbl: scratch of S*N*16*3*(L/2)
// words; outputs: window sums [W, S, L]; acase and consts as in curve.cu.
extern "C" int mp_msm_chunked(int L, int W, int acase, const void* px, const void* py, const void* pz,
                              const void* k, int Lk, void* tbl, void* ox, void* oy, void* oz,
                              long long S, int N, int NC, const void* consts, void* stream) {
  if (S <= 0 || N <= 0 || W <= 0 || W > kMaxW || 4 * Lk < W || NC < 1 || NC > kMaxNC) {
    return (int)cudaErrorInvalidValue;
  }
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
