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
//  * The training forward also writes cs (the post-mask cell state of every
//    step, the TPU kernel's save_cell output) beside hs, so the backward
//    (lstm_bwd.cu) never rebuilds the cell recurrence; serving passes no cs
//    buffer and writes none.
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

#include "common.cuh"

namespace {

using vd::from_f;
using vd::sigmoidf_;
using vd::to_f;

// BN rows x BJ hidden units per block; the block's 4*BJ gate columns are
// spread over TX column threads (TN each, strided by TX) and its rows over
// TY row threads (TM each, strided by TY).  BK is the K tile depth; MINB
// the blocks an SM must be able to hold (caps registers per thread).
// cs may be null (no cell states wanted).
template <typename T, int BN, int BJ, int TX, int TY, int TM, int TN, int BK,
          int MINB>
__global__ void __launch_bounds__(TX * TY, MINB)
lstm_step_kernel(const T* __restrict__ x, const float* __restrict__ mask,
                 const T* __restrict__ w, const float* __restrict__ b,
                 const float* __restrict__ h_in, const float* __restrict__ c_in,
                 float* __restrict__ h_out, float* __restrict__ c_out,
                 T* __restrict__ hs, T* __restrict__ cs, int N, int Tn, int E,
                 int H, int t) {
  constexpr int NT = TX * TY;
  constexpr int Q = BJ / TX;  // hidden units per thread

  __shared__ float As[2][BK][BN + 1];  // +1: conflict-free transposed store
  __shared__ float Bs[2][BK][4 * BJ];
  __shared__ float ms[BN];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int j0 = blockIdx.x * BJ;
  const int n0 = blockIdx.y * BN;

  if (!vd::load_tile_mask<BN>(ms, mask, n0, N, Tn, t)) {
    // No real token in this tile at step t: emit the carried state.
    for (int idx = tid; idx < BN * BJ; idx += NT) {
      const int n = n0 + idx / BJ, j = j0 + idx % BJ;
      if (n < N && j < H) {
        const size_t o = (size_t)n * H + j;
        const size_t ot = ((size_t)n * Tn + t) * H + j;
        const float h = h_in[o], c = c_in[o];
        h_out[o] = h;
        c_out[o] = c;
        hs[ot] = from_f<T>(h);
        if (cs) cs[ot] = from_f<T>(c);
      }
    }
    return;
  }

  // A = [x_t; h] with h rounded to T before its product, as the TPU kernel does
  auto load_a = [&](int r, int k) {
    const int n = n0 + r;
    return k < E ? to_f(x[((size_t)n * Tn + t) * E + k])
                 : to_f(from_f<T>(h_in[(size_t)n * H + (k - E)]));
  };
  float acc[TM][TN];
  vd::gate_tile_product<T, BN, BJ, TX, TY, TM, TN, BK>(acc, As, Bs, ms, load_a,
                                                        w, E + H, H, j0);

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
      const size_t ot = ((size_t)n * Tn + t) * H + j;
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
      hs[ot] = from_f<T>(h);
      if (cs) cs[ot] = from_f<T>(c);
    }
  }
}

// Rows at or below this count take the narrow tile (more blocks at serving
// shapes); above it the wide tile reuses each loaded operand 4-8 times.  At
// the 320-row question and fact LSTMs of training the wide tile is already
// the faster one (about 2x on an H100; the backward's phase (a) is not, so
// lstm_bwd.cu keeps a higher threshold).
constexpr int kSmallRows = 128;

template <typename T>
int layer_fwd(const void* x, const float* mask, const void* w, const float* b,
              const float* h0, const float* c0, float* hbuf, float* cbuf,
              void* hs, void* cs, int N, int Tn, int E, int H,
              cudaStream_t stream) {
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
          (T*)cs, N, Tn, E, H, t);
    } else {
      constexpr int BN = 64, BJ = 32;
      dim3 grid((H + BJ - 1) / BJ, (N + BN - 1) / BN);
      lstm_step_kernel<T, BN, BJ, 16, 16, 4, 8, 16, 1><<<grid, 256, 0, stream>>>(
          (const T*)x, mask, (const T*)w, b, h_in, c_in, h_out, c_out, (T*)hs,
          (T*)cs, N, Tn, E, H, t);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// One masked LSTM layer, all Tn steps.  dtype 0 = float32, 1 = bfloat16 for
// x, w, hs and cs.  hbuf/cbuf are (2, N, H) f32 scratch; the final state lands
// in slot (Tn - 1) & 1.  cs (N, Tn, H), the post-mask cell state of every
// step (the training forward's residual), may be null: serving writes none.
// Returns a cudaError_t value (0 on success).
extern "C" int vd_lstm_layer_fwd(int dtype, const void* x, const float* mask,
                                 const void* w, const float* b, const float* h0,
                                 const float* c0, float* hbuf, float* cbuf,
                                 void* hs, void* cs, int N, int Tn, int E, int H,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return layer_fwd<float>(x, mask, w, b, h0, c0, hbuf, cbuf, hs, cs, N, Tn, E,
                            H, s);
  if (dtype == 1)
    return layer_fwd<__nv_bfloat16>(x, mask, w, b, h0, c0, hbuf, cbuf, hs, cs, N,
                                    Tn, E, H, s);
  return (int)cudaErrorInvalidValue;
}
