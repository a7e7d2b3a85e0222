// Masked LSTM layer backward for Hopper (sm_90a), CUDA-core FMAs.
//
// Replaces the TPU kernel visdial_tpu/ops/lstm_pallas.py::_lstm_bwd_kernel
// (wrapper lstm_layer_bwd_pallas, caller _layer_bwd_kernel_path).  Reverse
// time, per step t, with the forward's residuals h_prev[:, t], c_prev[:, t]
// (the state that fed step t, in the activation type T):
//   gates = [x_t; h_prev] . W + b     (recomputed; gate order i, f, g, o)
//   cn = f c_prev + i g,   tcn = tanh(cn)
//   Dh = g_hs[:, t] + dh,  Dc = dc,  dhn = m Dh,  dcn = m Dc + dhn o (1 - tcn^2)
//   dgp[:, t] = [dcn g i(1-i), dcn c_prev f(1-f), dcn i (1-g^2), dhn tcn o(1-o)]
//   dc <- (1 - m) Dc + dcn f
//   dh <- (1 - m) Dh + dgp[:, t] . Wh^T        (dgp rounded to T first)
// with (dh, dc) f32 carries starting at (g_hT, g_cT) and ending as
// (dh0, dc0).  A row with m = 0 reduces exactly to dh += g_hs[:, t],
// dgp[:, t] = 0, dc unchanged (lstm_pallas.py:392-395); a tile with no real
// row at step t takes that path for all its rows without any product.  The
// dW, db and dx contractions over all N*T rows stay outside, as GEMMs
// (ops/lstm_cuda.py), as the JAX package leaves them to XLA.
//
// What bounds it on this card.  Two products a step, each about as large as
// the forward's: the gate recompute (N x (E+H) x 4H) and dgp . Wh^T
// (N x 4H x H).  At the option LSTM's 32,000 rows a step is ~55-70 GFLOP, so
// like K1 the CUDA-core FMA loops bound it; at the 320-row question and fact
// LSTMs the ~2T launches a layer and their latency do.
//
// What the design does about it.  The TPU kernel keeps Wx and Wh in VMEM and
// carries (dh, dc) in scratch across its sequential grid; Hopper has neither
// the room nor an ordered grid.  So each step is two launches, all 2T issued
// from one host call (vd_lstm_layer_bwd):
//  (a) lstm_bwd_gates_kernel: K1's tiling (BN rows x BJ units, all four gate
//      columns of a unit in one thread, common.cuh::gate_tile_product over
//      K = E + H), then the chain rule in registers; writes dgp[:, t], the
//      new dc and the pass-through part (1 - m) Dh of the new dh.
//  (b) lstm_bwd_dh_kernel: dh += dgp[:, t] . Wh^T.  It contracts over all 4H
//      gate columns, which every unit tile of (a) writes, so it needs all of
//      (a) done: the launch boundary is the grid-wide barrier.
// The carries live in two (N, H) f32 buffers updated in place: in each phase
// an element of dh or dc is read and written only by the thread that owns it,
// so no ping-pong copy is needed.  Tiles with no real row at step t skip both
// products.  Tensor cores, and a persistent kernel with a grid barrier in
// place of the 2T launches, are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using vd::from_f;
using vd::sigmoidf_;
using vd::to_f;

// Phase (a).  Tiling as in lstm_fwd.cu::lstm_step_kernel.
template <typename T, int BN, int BJ, int TX, int TY, int TM, int TN, int BK>
__global__ void __launch_bounds__(TX * TY, 1)
lstm_bwd_gates_kernel(const T* __restrict__ x, const T* __restrict__ hprev,
                      const T* __restrict__ cprev, const float* __restrict__ mask,
                      const T* __restrict__ w, const float* __restrict__ b,
                      const T* __restrict__ ghs, float* __restrict__ dh,
                      float* __restrict__ dc, T* __restrict__ dgp, int N, int Tn,
                      int E, int H, int t) {
  constexpr int NT = TX * TY;
  constexpr int Q = BJ / TX;  // hidden units per thread

  __shared__ float As[2][BK][BN + 1];
  __shared__ float Bs[2][BK][4 * BJ];
  __shared__ float ms[BN];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int j0 = blockIdx.x * BJ;
  const int n0 = blockIdx.y * BN;
  const size_t G = 4 * (size_t)H;
  const T zero = from_f<T>(0.f);

  if (!vd::load_tile_mask<BN>(ms, mask, n0, N, Tn, t)) {
    // m = 0 for every row: dh += g_hs[:, t], dgp[:, t] = 0, dc unchanged.
    for (int idx = tid; idx < BN * BJ; idx += NT) {
      const int n = n0 + idx / BJ, j = j0 + idx % BJ;
      if (n < N && j < H) {
        const size_t nt = (size_t)n * Tn + t;
        dh[(size_t)n * H + j] += to_f(ghs[nt * H + j]);
        T* d = dgp + nt * G + j;
        d[0] = zero;
        d[H] = zero;
        d[2 * (size_t)H] = zero;
        d[3 * (size_t)H] = zero;
      }
    }
    return;
  }

  // A = [x_t; h_prev_t], both already in T
  auto load_a = [&](int r, int k) {
    const size_t nt = (size_t)(n0 + r) * Tn + t;
    return k < E ? to_f(x[nt * E + k]) : to_f(hprev[nt * H + (k - E)]);
  };
  float acc[TM][TN];
  vd::gate_tile_product<T, BN, BJ, TX, TY, TM, TN, BK>(acc, As, Bs, ms, load_a,
                                                        w, E + H, H, j0);

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty + i * TY, n = n0 + r;
    if (n >= N) continue;
    const float m = ms[r];
    const size_t nt = (size_t)n * Tn + t;
#pragma unroll
    for (int u = 0; u < Q; ++u) {
      const int j = j0 + tx + u * TX;
      if (j >= H) continue;
      const size_t o = (size_t)n * H + j;
      const float Dh = to_f(ghs[nt * H + j]) + dh[o];
      T* d = dgp + nt * G + j;
      if (m == 0.f) {
        dh[o] = Dh;
        d[0] = zero;
        d[H] = zero;
        d[2 * (size_t)H] = zero;
        d[3 * (size_t)H] = zero;
        continue;
      }
      const float Dc = dc[o];
      const float gi = sigmoidf_(acc[i][0 * Q + u] + b[j]);
      const float gf = sigmoidf_(acc[i][1 * Q + u] + b[H + j]);
      const float gg = tanhf(acc[i][2 * Q + u] + b[2 * H + j]);
      const float go = sigmoidf_(acc[i][3 * Q + u] + b[3 * H + j]);
      const float cp = to_f(cprev[nt * H + j]);
      const float tcn = tanhf(gf * cp + gi * gg);
      const float dhn = m * Dh;
      const float dcn = m * Dc + dhn * go * (1.f - tcn * tcn);
      dc[o] = (1.f - m) * Dc + dcn * gf;
      dh[o] = (1.f - m) * Dh;   // phase (b) adds dgp . Wh^T
      d[0] = from_f<T>((dcn * gg) * gi * (1.f - gi));
      d[H] = from_f<T>((dcn * cp) * gf * (1.f - gf));
      d[2 * (size_t)H] = from_f<T>((dcn * gi) * (1.f - gg * gg));
      d[3 * (size_t)H] = from_f<T>((dhn * tcn) * go * (1.f - go));
    }
  }
}

// Phase (b): dh[n, j] += sum_k dgp[n, t, k] Wh[j, k], k < 4H, Wh = W[E:].
// BN rows x BJ units per block, rows over TY threads (TM each, strided),
// units over TX threads (TN each, strided); a BK-deep K tile of dgp and of
// Wh^T at a time (Wh^T[k][j] = w[(E + j) * 4H + k], read along k).
template <typename T, int BN, int BJ, int TX, int TY, int TM, int TN, int BK>
__global__ void __launch_bounds__(TX * TY, 1)
lstm_bwd_dh_kernel(const T* __restrict__ dgp, const float* __restrict__ mask,
                   const T* __restrict__ w, float* __restrict__ dh, int N, int Tn,
                   int E, int H, int t) {
  constexpr int NT = TX * TY;
  static_assert(TM * TY == BN && TN * TX == BJ, "tiling");
  static_assert((BK * BN) % NT == 0 && (BK * BJ) % NT == 0, "tile loads");
  constexpr int A_PER = BK * BN / NT;
  constexpr int B_PER = BK * BJ / NT;

  __shared__ float As[BK][BN + 1];
  __shared__ float Bs[BK][BJ + 1];
  __shared__ float ms[BN];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int j0 = blockIdx.x * BJ;
  const int n0 = blockIdx.y * BN;
  const int K = 4 * H;

  // rows with m = 0 have dgp[:, t] = 0: nothing to add
  if (!vd::load_tile_mask<BN>(ms, mask, n0, N, Tn, t)) return;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int q = 0; q < TN; ++q) acc[i][q] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int s = 0; s < A_PER; ++s) {
      const int l = tid + s * NT;
      const int r = l / BK, kk = l % BK, k = k0 + kk;
      As[kk][r] = (ms[r] != 0.f && k < K)
                      ? to_f(dgp[((size_t)(n0 + r) * Tn + t) * K + k])
                      : 0.f;
    }
#pragma unroll
    for (int s = 0; s < B_PER; ++s) {
      const int l = tid + s * NT;
      const int c = l / BK, kk = l % BK, k = k0 + kk, j = j0 + c;
      Bs[kk][c] = (k < K && j < H) ? to_f(w[(size_t)(E + j) * K + k]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], bb[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + i * TY];
#pragma unroll
      for (int q = 0; q < TN; ++q) bb[q] = Bs[kk][tx + q * TX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int q = 0; q < TN; ++q) acc[i][q] = fmaf(a[i], bb[q], acc[i][q]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty + i * TY, n = n0 + r;
    if (n >= N || ms[r] == 0.f) continue;
#pragma unroll
    for (int q = 0; q < TN; ++q) {
      const int j = j0 + tx + q * TX;
      if (j < H) dh[(size_t)n * H + j] += acc[i][q];
    }
  }
}

// Rows at or below this count take the narrow tiles (more blocks at the
// 320-row question and fact LSTMs; here they beat the wide tiles, unlike in
// lstm_fwd.cu, whose threshold is lower).
constexpr int kSmallRows = 512;

template <typename T>
int layer_bwd(const void* x, const void* hprev, const void* cprev,
              const float* mask, const void* w, const float* b, const void* ghs,
              float* dh, float* dc, void* dgp, int N, int Tn, int E, int H,
              cudaStream_t stream) {
  const T* xt = (const T*)x;
  const T* hp = (const T*)hprev;
  const T* cp = (const T*)cprev;
  const T* wt = (const T*)w;
  const T* gh = (const T*)ghs;
  T* d = (T*)dgp;
  for (int t = Tn - 1; t >= 0; --t) {
    if (N <= kSmallRows) {
      constexpr int BN = 16, BJ = 8;
      dim3 grid_a((H + BJ - 1) / BJ, (N + BN - 1) / BN);
      lstm_bwd_gates_kernel<T, BN, BJ, 8, 16, 1, 4, 64><<<grid_a, 128, 0, stream>>>(
          xt, hp, cp, mask, wt, b, gh, dh, dc, d, N, Tn, E, H, t);
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      constexpr int BNB = 16, BJB = 32;
      dim3 grid_b((H + BJB - 1) / BJB, (N + BNB - 1) / BNB);
      lstm_bwd_dh_kernel<T, BNB, BJB, 32, 4, 4, 1, 16><<<grid_b, 128, 0, stream>>>(
          d, mask, wt, dh, N, Tn, E, H, t);
    } else {
      constexpr int BN = 64, BJ = 32;
      dim3 grid_a((H + BJ - 1) / BJ, (N + BN - 1) / BN);
      lstm_bwd_gates_kernel<T, BN, BJ, 16, 16, 4, 8, 16><<<grid_a, 256, 0, stream>>>(
          xt, hp, cp, mask, wt, b, gh, dh, dc, d, N, Tn, E, H, t);
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      constexpr int BNB = 64, BJB = 64;
      dim3 grid_b((H + BJB - 1) / BJB, (N + BNB - 1) / BNB);
      lstm_bwd_dh_kernel<T, BNB, BJB, 16, 16, 4, 4, 16><<<grid_b, 256, 0, stream>>>(
          d, mask, wt, dh, N, Tn, E, H, t);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// One masked LSTM layer backward, all Tn steps in reverse.  dtype 0 =
// float32, 1 = bfloat16 for x (N, Tn, E), hprev, cprev, ghs (N, Tn, H), w
// (E+H, 4H) and dgp (N, Tn, 4H); mask (N, Tn) and b (4H,) f32.  dh and dc
// (N, H) f32 hold (g_hT, g_cT) on entry and (dh0, dc0) on return.  Returns
// a cudaError_t value (0 on success).
extern "C" int vd_lstm_layer_bwd(int dtype, const void* x, const void* hprev,
                                 const void* cprev, const float* mask,
                                 const void* w, const float* b, const void* ghs,
                                 float* dh, float* dc, void* dgp, int N, int Tn,
                                 int E, int H, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return layer_bwd<float>(x, hprev, cprev, mask, w, b, ghs, dh, dc, dgp, N, Tn,
                            E, H, s);
  if (dtype == 1)
    return layer_bwd<__nv_bfloat16>(x, hprev, cprev, mask, w, b, ghs, dh, dc, dgp,
                                    N, Tn, E, H, s);
  return (int)cudaErrorInvalidValue;
}
