// Masked LSTM layer forward for Hopper (sm_90a), CUDA-core FMAs.
//
// Replaces the TPU kernel visdial_tpu/ops/lstm_pallas.py::_lstm_layer_kernel
// (wrapper lstm_layer_pallas).  Same math, per step t:
//   gates = [x_t; h] . W + b          (W packed (E+H, 4H), gate order i,f,g,o)
//   c' = sig(f) c + sig(i) tanh(g),   h' = sig(o) tanh(c')
//   (h, c) <- m (h', c') + (1 - m) (h, c)        m = mask[:, t]
// Matmul inputs are in the activation type T (float or bf16; h is rounded to
// T before its product, as the TPU kernel does), products accumulate in f32,
// and the h/c carries are f32.
//
// What bounds it on this card.  The T steps are sequential: step t needs all
// of h_{t-1}.  The per-step product h.Wh is a skinny GEMM (N rows x H deep x
// 4H wide).  At serving shapes (N = 10 questions or facts) a step is a few
// MFLOP, so the kernel is bound by launch and memory latency, not by FLOPs
// or bytes.  At the answer-table chunks (N = 8192 rows) a step is 27 GFLOP
// and every row tile rereads its slice of W from the 50 MB L2, which holds
// W (~1.3 GB of L2 reads a step); with CUDA-core FMAs the product itself
// bounds it (measured on an H100 at about half the f32 FMA peak).
//
// What the design does about it.
//  * No per-layer weight residency (the TPU design keeps Wx and Wh in ~16 MB
//    of VMEM; a Hopper block has 227 KB of shared memory).  One launch per
//    time step; f32 h/c ping-pong buffers in device memory carry the state
//    between launches, and all T launches of a layer are issued from one
//    host call (vd_lstm_layer_fwd), so the Python side pays one call a layer.
//  * Each block owns BN rows x BJ hidden units and computes the four gate
//    columns j, H+j, 2H+j, 3H+j of each, so the cell update, the mask blend
//    and the write of hs[:, t] happen in registers inside the block.  The
//    column map is strided so that every thread holds all four gates of the
//    units it owns.
//  * x_t.Wx is computed in the same K loop as h.Wh (K = E + H), so nothing
//    but hs and the carries is written to device memory.
//  * Shared-memory tiles are double-buffered with a register prefetch, so
//    one tile's global loads overlap the previous tile's FMAs; at small N a
//    narrow tile config gives 64 blocks instead of 16.
//  * The block reads the mask of its rows at step t.  When no row of the tile
//    is real there (which covers the steps outside the [start, stop) span that
//    the TPU wrapper prefetches as _tile_bounds), the block skips the product
//    and emits the carried state, exactly as the TPU kernel's skipped steps
//    do.  Rows with m == 0 load no operands and keep their carry.
//  Tensor cores (wgmma), TMA and a persistent kernel are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float sigmoidf_(float v) { return 1.f / (1.f + expf(-v)); }

// BN rows x BJ hidden units per block; the block's 4*BJ gate columns are
// spread over TX column threads (TN each, strided by TX) and its rows over
// TY row threads (TM each, strided by TY).  BK is the K tile depth; MINB
// the blocks an SM must be able to hold (caps registers per thread).
template <typename T, int BN, int BJ, int TX, int TY, int TM, int TN, int BK,
          int MINB>
__global__ void __launch_bounds__(TX * TY, MINB)
lstm_step_kernel(const T* __restrict__ x, const float* __restrict__ mask,
                 const T* __restrict__ w, const float* __restrict__ b,
                 const float* __restrict__ h_in, const float* __restrict__ c_in,
                 float* __restrict__ h_out, float* __restrict__ c_out,
                 T* __restrict__ hs, int N, int Tn, int E, int H, int t) {
  constexpr int NT = TX * TY;
  constexpr int COLS = 4 * BJ;
  constexpr int Q = BJ / TX;  // hidden units per thread
  static_assert(TM * TY == BN, "row tiling");
  static_assert(TN * TX == COLS, "column tiling");
  static_assert(BJ % TX == 0, "each thread must own all four gates of a unit");
  static_assert((BK * BN) % NT == 0 && (BK * COLS) % NT == 0, "tile loads");
  constexpr int A_PER = BK * BN / NT;
  constexpr int B_PER = BK * COLS / NT;

  __shared__ float As[2][BK][BN + 1];  // +1: conflict-free transposed store
  __shared__ float Bs[2][BK][COLS];
  __shared__ float ms[BN];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int j0 = blockIdx.x * BJ;
  const int n0 = blockIdx.y * BN;
  const int K = E + H;
  const int G = 4 * H;

  bool real = false;
  if (tid < BN) {
    const int n = n0 + tid;
    const float m = n < N ? mask[(size_t)n * Tn + t] : 0.f;
    ms[tid] = m;
    real = m != 0.f;
  }
  if (!__syncthreads_or(real)) {
    // No real token in this tile at step t: emit the carried state.
    for (int idx = tid; idx < BN * BJ; idx += NT) {
      const int n = n0 + idx / BJ, j = j0 + idx % BJ;
      if (n < N && j < H) {
        const size_t o = (size_t)n * H + j;
        const float h = h_in[o];
        h_out[o] = h;
        c_out[o] = c_in[o];
        hs[((size_t)n * Tn + t) * H + j] = from_f<T>(h);
      }
    }
    return;
  }

  float a_reg[A_PER], b_reg[B_PER];
  auto load = [&](int k0) {
#pragma unroll
    for (int s = 0; s < A_PER; ++s) {
      const int l = tid + s * NT;
      const int r = l / BK, k = k0 + l % BK, n = n0 + r;
      float v = 0.f;
      if (ms[r] != 0.f && k < K) {
        v = k < E ? to_f(x[((size_t)n * Tn + t) * E + k])
                  : to_f(from_f<T>(h_in[(size_t)n * H + (k - E)]));
      }
      a_reg[s] = v;
    }
#pragma unroll
    for (int s = 0; s < B_PER; ++s) {
      const int l = tid + s * NT;
      const int kk = l / COLS, c = l % COLS;
      const int k = k0 + kk, j = j0 + c % BJ;
      b_reg[s] = (k < K && j < H) ? to_f(w[(size_t)k * G + (c / BJ) * H + j]) : 0.f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int s = 0; s < A_PER; ++s) {
      const int l = tid + s * NT;
      As[buf][l % BK][l / BK] = a_reg[s];
    }
#pragma unroll
    for (int s = 0; s < B_PER; ++s) {
      const int l = tid + s * NT;
      Bs[buf][l / COLS][l % COLS] = b_reg[s];
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int q = 0; q < TN; ++q) acc[i][q] = 0.f;

  const int n_k = (K + BK - 1) / BK;
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
      for (int i = 0; i < TM; ++i) a[i] = As[cur][kk][ty + i * TY];
#pragma unroll
      for (int q = 0; q < TN; ++q) bb[q] = Bs[cur][kk][tx + q * TX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int q = 0; q < TN; ++q) acc[i][q] = fmaf(a[i], bb[q], acc[i][q]);
    }
    if (kt + 1 < n_k) store(cur ^ 1);
    __syncthreads();
  }

  // Column tx + q*TX of the tile is gate (q / Q), unit j0 + tx + (q % Q)*TX.
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty + i * TY, n = n0 + r;
    if (n >= N) continue;
    const float m = ms[r];
#pragma unroll
    for (int u = 0; u < Q; ++u) {
      const int j = j0 + tx + u * TX;
      if (j >= H) continue;
      const size_t o = (size_t)n * H + j;
      float h = h_in[o], c = c_in[o];
      if (m != 0.f) {
        const float gi = sigmoidf_(acc[i][0 * Q + u] + b[j]);
        const float gf = sigmoidf_(acc[i][1 * Q + u] + b[H + j]);
        const float gg = tanhf(acc[i][2 * Q + u] + b[2 * H + j]);
        const float go = sigmoidf_(acc[i][3 * Q + u] + b[3 * H + j]);
        const float c_new = gf * c + gi * gg;
        const float h_new = go * tanhf(c_new);
        h = m * h_new + (1.f - m) * h;
        c = m * c_new + (1.f - m) * c;
      }
      h_out[o] = h;
      c_out[o] = c;
      hs[((size_t)n * Tn + t) * H + j] = from_f<T>(h);
    }
  }
}

// Rows at or below this count take the narrow tile (more blocks at serving
// shapes); above it the wide tile reuses each loaded operand 4-8 times.
constexpr int kSmallRows = 512;

template <typename T>
int layer_fwd(const void* x, const float* mask, const void* w, const float* b,
              const float* h0, const float* c0, float* hbuf, float* cbuf,
              void* hs, int N, int Tn, int E, int H, cudaStream_t stream) {
  const size_t NH = (size_t)N * H;
  for (int t = 0; t < Tn; ++t) {
    const float* h_in = t == 0 ? h0 : hbuf + ((t - 1) & 1) * NH;
    const float* c_in = t == 0 ? c0 : cbuf + ((t - 1) & 1) * NH;
    float* h_out = hbuf + (t & 1) * NH;
    float* c_out = cbuf + (t & 1) * NH;
    if (N <= kSmallRows) {
      constexpr int BN = 16, BJ = 8;
      dim3 grid((H + BJ - 1) / BJ, (N + BN - 1) / BN);
      lstm_step_kernel<T, BN, BJ, 8, 16, 1, 4, 64, 1><<<grid, 128, 0, stream>>>(
          (const T*)x, mask, (const T*)w, b, h_in, c_in, h_out, c_out, (T*)hs,
          N, Tn, E, H, t);
    } else {
      constexpr int BN = 64, BJ = 32;
      dim3 grid((H + BJ - 1) / BJ, (N + BN - 1) / BN);
      lstm_step_kernel<T, BN, BJ, 16, 16, 4, 8, 16, 1><<<grid, 256, 0, stream>>>(
          (const T*)x, mask, (const T*)w, b, h_in, c_in, h_out, c_out, (T*)hs,
          N, Tn, E, H, t);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// One masked LSTM layer, all Tn steps.  dtype 0 = float32, 1 = bfloat16 for
// x, w and hs.  hbuf/cbuf are (2, N, H) f32 scratch; the final state lands in
// slot (Tn - 1) & 1.  Returns a cudaError_t value (0 on success).
extern "C" int vd_lstm_layer_fwd(int dtype, const void* x, const float* mask,
                                 const void* w, const float* b, const float* h0,
                                 const float* c0, float* hbuf, float* cbuf,
                                 void* hs, int N, int Tn, int E, int H,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return layer_fwd<float>(x, mask, w, b, h0, c0, hbuf, cbuf, hs, N, Tn, E, H, s);
  if (dtype == 1)
    return layer_fwd<__nv_bfloat16>(x, mask, w, b, h0, c0, hbuf, cbuf, hs, N, Tn,
                                    E, H, s);
  return (int)cudaErrorInvalidValue;
}
