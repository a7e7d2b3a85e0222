// The gen decoder's LM head for Hopper (sm_90a), CUDA-core FMAs: per-token
// target log-probabilities with the row logsumexp (K5), and the d-logits of
// the training loss (K6), without ever writing the (NT, V) logits.
//
// K5, lm_score_partial_kernel + lm_score_combine_kernel, replaces the TPU
// kernel visdial_tpu/ops/lm_score_pallas.py::_lm_score_kernel (wrapper
// lm_token_logprobs_lse_pallas): for each row i of x (NT, H),
//   logits_i = x_i . W + b             (W (H, V) in T, b f32, f32 accumulation)
//   lse_i    = logsumexp_v logits_i[v]
//   logp_i   = logits_i[tgt_i] - lse_i
// K6, lm_dlogits_kernel, replaces _lm_dlogits_kernel (wrapper
// lm_dlogits_pallas): dlog[i, v] = g_i (onehot(tgt_i)[v] - exp(logits_i[v] -
// lse_i)), rounded to T, the logits tile recomputed from x and W.
//
// What bounds them on this card.  Both are one (NT, H) x (H, V) product with
// a cheap epilogue: 2 NT H V operations (26 GFLOP at the training shape NT
// 2,880, H 512, V 8,804), against a few MB read and, for K5, 8 bytes a row
// written; K6 writes NT V elements (101 MB in f32 at that shape), still far
// under the product's time at the 67 TFLOP/s f32 CUDA-core peak.  So the
// product bounds both, and the design is about feeding the FMA units.
//
// What the design does about it.
//  * One tile product for both kernels (logits_tile): a BM x BN logits tile
//    from BK-deep shared-memory tiles of x and W, double-buffered with a
//    register prefetch so that one tile's global loads overlap the previous
//    tile's FMAs, and a TM x TN register micro-tile per thread (strided
//    columns, so the shared reads are conflict-free).  x and W are read in
//    T and widened to f32, so a bf16 product is exact in f32.
//  * K5: the TPU walks the vocab tiles of a row tile in order on one core,
//    carrying (max, sum, target logit) in VMEM.  Hopper has no ordered grid,
//    and 45 row tiles (training) would leave most of the 132 SMs idle, so
//    the vocab is split: block (row tile, split) walks its contiguous range
//    of vocab tiles, each thread keeping a running (max, sum of exp, target
//    logit) over its own columns, merged across the row's threads with warp
//    shuffles at the end and written as a partial (splits, NT, 3); a second
//    small launch combines the splits per row.  The split count is chosen
//    so that about four blocks per SM are in flight.  The target logit is
//    read from its own column (no one-hot sum).
//  * Ragged edges: columns >= V are skipped (what the TPU's -1e30 pad bias
//    amounts to) and rows >= NT are neither loaded nor written.  Running
//    maxima start at -1e30, not -inf, so an empty range gives no NaN.
//  * K6's grid (row tiles x vocab tiles) is fully parallel; a block writes
//    its d-logits tile straight from registers.
//  Tensor cores (wgmma), TMA and a persistent kernel are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using vd::from_f;
using vd::to_f;

constexpr int BM = 64;               // rows of a tile
constexpr int BN = 128;              // vocab columns of a tile
constexpr int BK = 16;               // depth of a shared-memory step
constexpr int TX = 16;               // column threads (TN columns each, strided)
constexpr int TY = 16;               // row threads (TM rows each, strided)
constexpr int TM = BM / TY;
constexpr int TN = BN / TX;
constexpr int kThreads = TX * TY;
constexpr float kNeg = -1e30f;

struct TileSmem {
  float As[2][BK][BM + 1];   // x tile, transposed (+1: conflict-free store)
  float Bs[2][BK][BN];       // W tile
};

// acc[i][q] = sum_k x[m0 + ty + i*TY][k] * w[k][n0 + tx + q*TX] for the
// block's BM x BN tile; out-of-range rows, columns and depths contribute
// zeros.  Every thread of the block must call it.
template <typename T>
__device__ __forceinline__ void logits_tile(float (&acc)[TM][TN], TileSmem& sm,
                                            const T* __restrict__ x,
                                            const T* __restrict__ w, int NT,
                                            int H, int V, int m0, int n0) {
  constexpr int A_PER = BK * BM / kThreads;
  constexpr int B_PER = BK * BN / kThreads;
  static_assert((BK * BM) % kThreads == 0 && (BK * BN) % kThreads == 0, "tile loads");
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;

  float a_reg[A_PER], b_reg[B_PER];
  auto load = [&](int k0) {
#pragma unroll
    for (int s = 0; s < A_PER; ++s) {
      const int l = tid + s * kThreads;
      const int row = m0 + l / BK, k = k0 + l % BK;
      a_reg[s] = (row < NT && k < H) ? to_f(x[(size_t)row * H + k]) : 0.f;
    }
#pragma unroll
    for (int s = 0; s < B_PER; ++s) {
      const int l = tid + s * kThreads;
      const int k = k0 + l / BN, col = n0 + l % BN;
      b_reg[s] = (k < H && col < V) ? to_f(w[(size_t)k * V + col]) : 0.f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int s = 0; s < A_PER; ++s) {
      const int l = tid + s * kThreads;
      sm.As[buf][l % BK][l / BK] = a_reg[s];
    }
#pragma unroll
    for (int s = 0; s < B_PER; ++s) {
      const int l = tid + s * kThreads;
      sm.Bs[buf][l / BN][l % BN] = b_reg[s];
    }
  };

#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int q = 0; q < TN; ++q) acc[i][q] = 0.f;

  const int n_k = (H + BK - 1) / BK;
  load(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < n_k; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < n_k) load((kt + 1) * BK);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], bb[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = sm.As[cur][kk][ty + i * TY];
#pragma unroll
      for (int q = 0; q < TN; ++q) bb[q] = sm.Bs[cur][kk][tx + q * TX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int q = 0; q < TN; ++q) acc[i][q] = fmaf(a[i], bb[q], acc[i][q]);
    }
    if (kt + 1 < n_k) store(cur ^ 1);
    __syncthreads();
  }
}

// K5, pass 1.  Grid (row tiles, splits); split s walks vocab tiles
// [s * tiles_per_split, min((s + 1) * tiles_per_split, n_vt)).  Writes
// part[s][row] = (running max, sum of exp(logit - max), target logit).
template <typename T>
__global__ void __launch_bounds__(kThreads)
lm_score_partial_kernel(const T* __restrict__ x, const T* __restrict__ w,
                        const float* __restrict__ b, const int* __restrict__ tgt,
                        float* __restrict__ part, int NT, int H, int V,
                        int tiles_per_split) {
  __shared__ TileSmem sm;
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int m0 = blockIdx.x * BM;
  const int split = blockIdx.y;
  const int n_vt = (V + BN - 1) / BN;
  const int t_lo = split * tiles_per_split;
  const int t_hi = min(t_lo + tiles_per_split, n_vt);

  float m[TM], s[TM], tl[TM];
  int tg[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + ty + i * TY;
    tg[i] = row < NT ? tgt[row] : -1;
    m[i] = kNeg;
    s[i] = 0.f;
    tl[i] = 0.f;
  }

  for (int t = t_lo; t < t_hi; ++t) {
    const int n0 = t * BN;
    float acc[TM][TN];
    logits_tile<T>(acc, sm, x, w, NT, H, V, m0, n0);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float lmax = kNeg;
#pragma unroll
      for (int q = 0; q < TN; ++q) {
        const int col = n0 + tx + q * TX;
        if (col < V) {
          const float v = acc[i][q] + b[col];
          acc[i][q] = v;
          lmax = fmaxf(lmax, v);
          if (col == tg[i]) tl[i] += v;
        }
      }
      const float m_new = fmaxf(m[i], lmax);
      float add = 0.f;
#pragma unroll
      for (int q = 0; q < TN; ++q)
        if (n0 + tx + q * TX < V) add += expf(acc[i][q] - m_new);
      s[i] = s[i] * expf(m[i] - m_new) + add;
      m[i] = m_new;
    }
  }

  // merge the TX column threads of each row (16-lane groups of a warp)
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int o = TX / 2; o > 0; o >>= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[i], o);
      const float so = __shfl_xor_sync(0xffffffffu, s[i], o);
      const float to = __shfl_xor_sync(0xffffffffu, tl[i], o);
      const float mn = fmaxf(m[i], mo);
      s[i] = s[i] * expf(m[i] - mn) + so * expf(mo - mn);
      m[i] = mn;
      tl[i] += to;
    }
    const int row = m0 + ty + i * TY;
    if (tx == 0 && row < NT) {
      float* p = part + ((size_t)split * NT + row) * 3;
      p[0] = m[i];
      p[1] = s[i];
      p[2] = tl[i];
    }
  }
}

// K5, pass 2: one thread per row combines the splits' partials.
__global__ void lm_score_combine_kernel(const float* __restrict__ part,
                                        float* __restrict__ logp,
                                        float* __restrict__ lse, int NT,
                                        int splits) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= NT) return;
  float M = kNeg;
  for (int j = 0; j < splits; ++j) M = fmaxf(M, part[((size_t)j * NT + row) * 3]);
  float S = 0.f, TL = 0.f;
  for (int j = 0; j < splits; ++j) {
    const float* p = part + ((size_t)j * NT + row) * 3;
    S += p[1] * expf(p[0] - M);
    TL += p[2];
  }
  const float l = M + logf(S);
  lse[row] = l;
  logp[row] = TL - l;
}

// K6.  Grid (row tiles, vocab tiles).
template <typename T>
__global__ void __launch_bounds__(kThreads)
lm_dlogits_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const float* __restrict__ b, const int* __restrict__ tgt,
                  const float* __restrict__ lse, const float* __restrict__ g,
                  T* __restrict__ dlog, int NT, int H, int V) {
  __shared__ TileSmem sm;
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  float acc[TM][TN];
  logits_tile<T>(acc, sm, x, w, NT, H, V, m0, n0);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + ty + i * TY;
    if (row >= NT) continue;
    const float l = lse[row], gi = g[row];
    const int tg = tgt[row];
#pragma unroll
    for (int q = 0; q < TN; ++q) {
      const int col = n0 + tx + q * TX;
      if (col >= V) continue;
      const float p = expf(acc[i][q] + b[col] - l);
      dlog[(size_t)row * V + col] = from_f<T>(gi * ((col == tg ? 1.f : 0.f) - p));
    }
  }
}

template <typename T>
int launch_score(const void* x, const void* w, const float* b, const int* tgt,
                 float* part, float* logp, float* lse, int NT, int H, int V,
                 int tiles_per_split, int splits, cudaStream_t stream) {
  const dim3 grid((NT + BM - 1) / BM, splits);
  lm_score_partial_kernel<T><<<grid, kThreads, 0, stream>>>(
      (const T*)x, (const T*)w, b, tgt, part, NT, H, V, tiles_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  lm_score_combine_kernel<<<(NT + 255) / 256, 256, 0, stream>>>(part, logp, lse, NT,
                                                                splits);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dlogits(const void* x, const void* w, const float* b, const int* tgt,
                   const float* lse, const float* g, void* dlog, int NT, int H,
                   int V, cudaStream_t stream) {
  const dim3 grid((NT + BM - 1) / BM, (V + BN - 1) / BN);
  lm_dlogits_kernel<T><<<grid, kThreads, 0, stream>>>(
      (const T*)x, (const T*)w, b, tgt, lse, g, (T*)dlog, NT, H, V);
  return (int)cudaGetLastError();
}

}  // namespace

// K5.  dtype 0 = float32, 1 = bfloat16 for x (NT, H) and w (H, V); b (V,)
// f32; tgt (NT,) int32; part (splits, NT, 3) f32 scratch; logp and lse (NT,)
// f32.  The vocab's ceil(V / 128) tiles are cut into `splits` ranges of
// tiles_per_split tiles, none of them empty.  Returns a cudaError_t value.
extern "C" int vd_lm_score(int dtype, const void* x, const void* w, const float* b,
                           const int* tgt, float* part, float* logp, float* lse,
                           int NT, int H, int V, int tiles_per_split, int splits,
                           void* stream) {
  const int n_vt = (V + BN - 1) / BN;
  if (NT < 1 || H < 1 || V < 1 || tiles_per_split < 1 || splits < 1 ||
      (splits - 1) * tiles_per_split >= n_vt || splits * tiles_per_split < n_vt)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_score<float>(x, w, b, tgt, part, logp, lse, NT, H, V,
                               tiles_per_split, splits, s);
  if (dtype == 1)
    return launch_score<__nv_bfloat16>(x, w, b, tgt, part, logp, lse, NT, H, V,
                                       tiles_per_split, splits, s);
  return (int)cudaErrorInvalidValue;
}

// K6.  dtype as K5 for x, w and dlog (NT, V); b (V,), lse (NT,) and g (NT,)
// f32; tgt (NT,) int32.  Returns a cudaError_t value.
extern "C" int vd_lm_dlogits(int dtype, const void* x, const void* w,
                             const float* b, const int* tgt, const float* lse,
                             const float* g, void* dlog, int NT, int H, int V,
                             void* stream) {
  if (NT < 1 || H < 1 || V < 1 || (V + BN - 1) / BN > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_dlogits<float>(x, w, b, tgt, lse, g, dlog, NT, H, V, s);
  if (dtype == 1)
    return launch_dlogits<__nv_bfloat16>(x, w, b, tgt, lse, g, dlog, NT, H, V, s);
  return (int)cudaErrorInvalidValue;
}
