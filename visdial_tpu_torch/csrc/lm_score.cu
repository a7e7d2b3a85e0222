// The gen decoder's LM head for Hopper (sm_90a), on the tensor cores:
// per-token target log-probabilities with the row logsumexp (K5), and the
// d-logits of the training loss (K6), without ever writing the (NT, V)
// logits.
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
// 2,880, H 512, V 8,804; 665 GFLOP at one 73,728-row eval chunk), against a
// few MB read and, for K5, 8 bytes a row written; K6 writes NT V elements
// (101 MB in f32 at the training shape, ~30 us at 3.35 TB/s).  So the
// product bounds both: bf16 at the tensor cores' 989 TFLOP/s, f32 at 165
// (3xTF32, three TF32 products a term, the least an f32-accurate product
// takes here).  The epilogue's exps are NT V MUFU operations, a quarter of
// the bf16 bound.
//
// What the design does about it.
//  * The product is common.cuh::tile_product, K1's and K2's: wgmma from a
//    ring of 128-byte-swizzled shared tiles fed by 16-byte cp.async; bf16 x
//    bf16 -> f32, and for f32 3xTF32 with each k-tile summed apart and added
//    with round-to-nearest (f32 results nearer an f64 reference than
//    cuBLAS's f32 path, scripts/lm_f64_error.py).  Its operands are K-major,
//    so the wrapper (ops/lm_score_cuda.py) packs W^T once per call as (V,
//    Hp), H zero-padded to a whole k-tile (Hp), and pads x to Hp only where
//    H is not a whole number of k-tiles.  Tiles are 128 rows x 128 vocab
//    columns (LmTile below).
//  * The wrapper pads b to whole vocab tiles with -1e30, the TPU kernel's pad
//    bias, and W's rows past V load as zeros, so a column >= V holds -1e30,
//    adds exp(...) = 0 to every sum, and never wins a maximum over a real
//    column; K6 does not store it.
//  * Both epilogues work on the accumulator in wgmma's register layout (no
//    shared-memory staging): thread l of warp w of warpgroup g holds rows
//    64g + 16w + l/4 and +8, columns 8i + 2(l%4) and +1.
//  * K5: the TPU walks the vocab tiles of a row tile in order on one core,
//    carrying (max, sum, target logit) in VMEM.  Hopper has no ordered grid,
//    and 23 row tiles (training) would leave most of the 132 SMs idle, so
//    the vocab is split: block (row tile, split) walks its contiguous range
//    of vocab tiles, each thread keeping a running (max, sum of exp, target
//    logit) for its two rows over its own columns, merged across the four
//    lanes of a row with warp shuffles at the end and written as a partial
//    (splits, NT, 3); a second small launch combines the splits per row.
//    The wrapper picks the split count that fills whole waves of blocks
//    (ops/lm_score_cuda.py::vocab_splits).  The target logit is read from
//    its own column (no one-hot sum).
//  * K6's grid (vocab tiles x row tiles) is fully parallel; a block writes
//    its d-logits straight from the accumulator, a column pair per store
//    (8 bytes in f32) where V is even, with streaming stores (the output
//    does not fit in L2; W and x do).
//  * exp: f32 takes expf; bf16 exp2f of its argument scaled by log2(e).
//  * Rows >= NT load zeros and are not written.  Running maxima start at
//    -1e30, not -inf, so no difference of two of them is NaN.
//  Tried and dropped (PERF.md): a ring kept running across a K5 block's
//  vocab tiles, so that the next tile's copies overlap this one's epilogue,
//  and four f32 / six bf16 stages: no faster.  What holds the k-loop to
//  ~2 us a k-tile in f32 (~40% of the 3xTF32 rate at 73,728 rows) is not
//  known.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "common.cuh"

namespace {

using vd::Operand;

constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBN = 128;   // vocab columns of a tile (VOCAB_TILE in the wrapper)

// Tiles of BM rows x kBN vocab columns, a ring of STAGES k-tiles, BLOCKS
// blocks an SM (BLOCKS_PER_SM in the wrapper).  f32: 164,864 bytes of shared
// memory, one block an SM.  bf16: 99,328 bytes and at most 128 registers a
// thread, so two blocks share an SM and one's epilogue runs beside the
// other's product (measured faster than four stages at one block an SM, or
// 256-row tiles; PERF.md).
template <typename T> struct LmTile;
template <> struct LmTile<float> { static constexpr int BM = 128, STAGES = 3, BLOCKS = 1; };
template <> struct LmTile<__nv_bfloat16> {
  static constexpr int BM = 128, STAGES = 3, BLOCKS = 2;
};

// exp(v): f32 takes expf; bf16, whose operands carry 8 bits, one MUFU op
template <typename T> __device__ __forceinline__ float exp_(float v) {
  if constexpr (std::is_same<T, float>::value)
    return expf(v);
  else
    return exp2f(v * kLog2e);
}

// This thread's place in wgmma's accumulator layout (common.cuh::stage_acc):
// acc[4i + 2h + j] is row r + 8h, column 8i + c + j of the tile.
struct AccPos {
  int r, c;
  __device__ __forceinline__ AccPos() {
    const int lane = threadIdx.x % 32;
    r = (threadIdx.x / 128) * 64 + ((threadIdx.x / 32) % 4) * 16 + lane / 4;
    c = 2 * (lane % 4);
  }
};

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  __stcs(reinterpret_cast<float2*>(p), make_float2(a, b));
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  __stcs(reinterpret_cast<unsigned int*>(p), *reinterpret_cast<const unsigned int*>(&v));
}
__device__ __forceinline__ void store_one(float* p, float a) { __stcs(p, a); }
__device__ __forceinline__ void store_one(__nv_bfloat16* p, float a) {
  const __nv_bfloat16 v = __float2bfloat16(a);
  __stcs(reinterpret_cast<unsigned short*>(p),
         *reinterpret_cast<const unsigned short*>(&v));
}

// K5, pass 1.  Grid (row tiles, splits); split s walks vocab tiles
// [s * tiles_per_split, min((s + 1) * tiles_per_split, n_vt)).  Writes
// part[s][row] = (running max, sum of exp(logit - max), target logit).
template <typename T, int BM, int BN, int STAGES>
__global__ void __launch_bounds__(BM * 2, LmTile<T>::BLOCKS)
lm_score_partial_kernel(const T* __restrict__ x, const T* __restrict__ w,
                        const float* __restrict__ b, const int* __restrict__ tgt,
                        float* __restrict__ part, int NT, int Hp, int V,
                        int tiles_per_split) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = vd::align1024(smem_raw);
  const int m0 = blockIdx.x * BM, split = blockIdx.y;
  const int n_vt = (V + BN - 1) / BN;
  const int t_lo = split * tiles_per_split;
  const int t_hi = min(t_lo + tiles_per_split, n_vt);
  const int nkt = Hp / vd::TileK<T>::BK;
  const Operand<T> xo{x, Hp, NT, Hp}, wo{w, Hp, V, Hp};
  const AccPos p;

  float m[2], s[2], tl[2];
  int tg[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = m0 + p.r + 8 * h;
    // a target outside [0, V) lies in another rank's vocab shard (the model
    // axis re-bases targets to the shard and gives the rest -1): no target
    // logit here, so tl stays 0 and logp = -lse
    const int t = row < NT ? tgt[row] : -1;
    tg[h] = t >= 0 && t < V ? t : -1;
    m[h] = kNeg;
    s[h] = 0.f;
    tl[h] = 0.f;
  }

  for (int t = t_lo; t < t_hi; ++t) {
    const int n0 = t * BN;
    float acc[BN / 2];
    vd::tile_product<T, BM, BN, STAGES>(acc, smem, xo, nkt, xo, wo, nkt, m0, n0);
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const float2 bb = __ldg(reinterpret_cast<const float2*>(b + n0 + 8 * i + p.c));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        acc[4 * i + 2 * h] += bb.x;
        acc[4 * i + 2 * h + 1] += bb.y;
        mx[h] = fmaxf(mx[h], fmaxf(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]));
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // the target's column, when it is one of this thread's in this tile
      const int d = tg[h] - n0 - p.c;
      if (d >= 0 && d < BN && (d & 6) == 0) {
#pragma unroll
        for (int i = 0; i < BN / 8; ++i) {
          if (d == 8 * i) tl[h] = acc[4 * i + 2 * h];
          if (d == 8 * i + 1) tl[h] = acc[4 * i + 2 * h + 1];
        }
      }
      // A thread whose columns so far were all pads (-1e30) counts each as
      // exp(0) here; the lane merge below scales that count by exp(-1e30 -
      // max) = 0, since one of a row's four lanes holds a real column.
      const float mn = fmaxf(m[h], mx[h]);
      float add = 0.f;
#pragma unroll
      for (int i = 0; i < BN / 8; ++i)
        add += exp_<T>(acc[4 * i + 2 * h] - mn) + exp_<T>(acc[4 * i + 2 * h + 1] - mn);
      s[h] = s[h] * exp_<T>(m[h] - mn) + add;
      m[h] = mn;
    }
  }

  // merge the four lanes of each row
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[h], o);
      const float so = __shfl_xor_sync(0xffffffffu, s[h], o);
      const float to = __shfl_xor_sync(0xffffffffu, tl[h], o);
      const float mn = fmaxf(m[h], mo);
      s[h] = s[h] * exp_<T>(m[h] - mn) + so * exp_<T>(mo - mn);
      m[h] = mn;
      tl[h] += to;
    }
    const int row = m0 + p.r + 8 * h;
    if (p.c == 0 && row < NT) {
      float* q = part + ((size_t)split * NT + row) * 3;
      q[0] = m[h];
      q[1] = s[h];
      q[2] = tl[h];
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

// K6.  Grid (vocab tiles, row tiles).
template <typename T, int BM, int BN, int STAGES>
__global__ void __launch_bounds__(BM * 2, LmTile<T>::BLOCKS)
lm_dlogits_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const float* __restrict__ b, const int* __restrict__ tgt,
                  const float* __restrict__ lse, const float* __restrict__ g,
                  T* __restrict__ dlog, int NT, int Hp, int V) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = vd::align1024(smem_raw);
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int nkt = Hp / vd::TileK<T>::BK;
  const Operand<T> xo{x, Hp, NT, Hp}, wo{w, Hp, V, Hp};
  const AccPos p;
  // with V even, a thread's column pair starts at an even element
  const bool pairs = (V & 1) == 0;
  float acc[BN / 2];
  vd::tile_product<T, BM, BN, STAGES>(acc, smem, xo, nkt, xo, wo, nkt, m0, n0);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = m0 + p.r + 8 * h;
    if (row >= NT) continue;
    const float l = lse[row], gi = g[row];
    // a target outside [0, V) (another shard's) matches no stored column, so
    // its row gets no one-hot term
    const int tg = tgt[row];
    T* out = dlog + (size_t)row * V;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int col = n0 + 8 * i + p.c;
      if (col >= V) continue;
      const float2 bb = __ldg(reinterpret_cast<const float2*>(b + col));
      const float d0 =
          gi * ((col == tg ? 1.f : 0.f) - exp_<T>(acc[4 * i + 2 * h] + bb.x - l));
      const float d1 =
          gi * ((col + 1 == tg ? 1.f : 0.f) - exp_<T>(acc[4 * i + 2 * h + 1] + bb.y - l));
      if (pairs) {
        store_pair(out + col, d0, d1);
      } else {
        store_one(out + col, d0);
        if (col + 1 < V) store_one(out + col + 1, d1);
      }
    }
  }
}

template <typename T>
int launch_score(const void* x, const void* w, const float* b, const int* tgt,
                 float* part, float* logp, float* lse, int NT, int Hp, int V,
                 int tiles_per_split, int splits, cudaStream_t stream) {
  constexpr int BM = LmTile<T>::BM, STAGES = LmTile<T>::STAGES;
  using L = vd::TileSmem<T, BM, kBN, STAGES>;
  if (Hp % vd::TileK<T>::BK != 0) return (int)cudaErrorInvalidValue;
  const auto kernel = lm_score_partial_kernel<T, BM, kBN, STAGES>;
  const cudaError_t attr =
      vd::allow_smem<lm_score_partial_kernel<T, BM, kBN, STAGES>, L::BYTES>();
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((NT + BM - 1) / BM, splits);
  kernel<<<grid, BM * 2, L::BYTES, stream>>>((const T*)x, (const T*)w, b, tgt, part,
                                              NT, Hp, V, tiles_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  lm_score_combine_kernel<<<(NT + 255) / 256, 256, 0, stream>>>(part, logp, lse, NT,
                                                                splits);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dlogits(const void* x, const void* w, const float* b, const int* tgt,
                   const float* lse, const float* g, void* dlog, int NT, int Hp,
                   int V, cudaStream_t stream) {
  constexpr int BM = LmTile<T>::BM, STAGES = LmTile<T>::STAGES;
  using L = vd::TileSmem<T, BM, kBN, STAGES>;
  if (Hp % vd::TileK<T>::BK != 0 || (NT + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  const auto kernel = lm_dlogits_kernel<T, BM, kBN, STAGES>;
  const cudaError_t attr = vd::allow_smem<lm_dlogits_kernel<T, BM, kBN, STAGES>, L::BYTES>();
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((V + kBN - 1) / kBN, (NT + BM - 1) / BM);
  kernel<<<grid, BM * 2, L::BYTES, stream>>>((const T*)x, (const T*)w, b, tgt, lse, g,
                                              (T*)dlog, NT, Hp, V);
  return (int)cudaGetLastError();
}

}  // namespace

// K5.  dtype 0 = float32, 1 = bfloat16 for x (NT, Hp) and w (V, Hp), W^T
// packed as ops/lm_score_cuda.py::pack_lm_weight packs it (Hp a whole number
// of 128-byte k-tiles, zeros past H in both); b f32, padded with -1e30 to
// whole 128-column vocab tiles; tgt (NT,) int32; part (splits, NT, 3) f32
// scratch; logp and lse (NT,) f32; a target outside [0, V) gives logp =
// -lse (no target logit).  The vocab's ceil(V / 128) tiles are cut
// into `splits` ranges of tiles_per_split tiles, none of them empty.
// Returns a cudaError_t value.
extern "C" int vd_lm_score(int dtype, const void* x, const void* w, const float* b,
                           const int* tgt, float* part, float* logp, float* lse,
                           int NT, int Hp, int V, int tiles_per_split, int splits,
                           void* stream) {
  const int n_vt = (V + kBN - 1) / kBN;
  if (NT < 1 || Hp < 1 || V < 1 || tiles_per_split < 1 || splits < 1 ||
      splits > 65535 || (splits - 1) * tiles_per_split >= n_vt ||
      splits * tiles_per_split < n_vt)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_score<float>(x, w, b, tgt, part, logp, lse, NT, Hp, V,
                               tiles_per_split, splits, s);
  if (dtype == 1)
    return launch_score<__nv_bfloat16>(x, w, b, tgt, part, logp, lse, NT, Hp, V,
                                       tiles_per_split, splits, s);
  return (int)cudaErrorInvalidValue;
}

// K6.  dtype, x, w and b as K5; dlog (NT, V) in the dtype; lse (NT,) and g
// (NT,) f32; tgt (NT,) int32.  Returns a cudaError_t value.
extern "C" int vd_lm_dlogits(int dtype, const void* x, const void* w,
                             const float* b, const int* tgt, const float* lse,
                             const float* g, void* dlog, int NT, int Hp, int V,
                             void* stream) {
  if (NT < 1 || Hp < 1 || V < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_dlogits<float>(x, w, b, tgt, lse, g, dlog, NT, Hp, V, s);
  if (dtype == 1)
    return launch_dlogits<__nv_bfloat16>(x, w, b, tgt, lse, g, dlog, NT, Hp, V, s);
  return (int)cudaErrorInvalidValue;
}
