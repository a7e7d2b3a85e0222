// Helpers shared by the port's kernels: f32 <-> activation-type conversion,
// the logistic function, warp reductions, and the gate-tile product of the
// LSTM kernels (lstm_fwd.cu, lstm_bwd.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace vd {

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The gate pre-activations of one LSTM block tile, without the bias:
//   acc[i][q] = sum_k A[row ty + i*TY][k] * W[k][col(tx + q*TX)],  k < K = E + H
// for BN rows x the 4*BJ gate columns of hidden units j0 .. j0+BJ-1.  Tile
// column c is gate c / BJ of unit j0 + c % BJ, i.e. W column (c/BJ)*H + j;
// so thread column tx + q*TX holds gate q / Q of unit j0 + tx + (q % Q)*TX
// (Q = BJ / TX) and every thread owns all four gates of its units.
// load_a(r, k) gives A[r][k] as float for a tile row r whose mask ms[r] is
// non-zero (rows with ms[r] == 0 load nothing and contribute zeros).
// Shared tiles are double-buffered with a register prefetch so that one
// tile's global loads overlap the previous tile's FMAs.  Every thread of the
// block must call it.
template <typename T, int BN, int BJ, int TX, int TY, int TM, int TN, int BK,
          typename LoadA>
__device__ __forceinline__ void gate_tile_product(
    float (&acc)[TM][TN], float (&As)[2][BK][BN + 1], float (&Bs)[2][BK][4 * BJ],
    const float* ms, LoadA load_a, const T* __restrict__ w, int K, int H, int j0) {
  constexpr int NT = TX * TY;
  constexpr int COLS = 4 * BJ;
  static_assert(TM * TY == BN, "row tiling");
  static_assert(TN * TX == COLS, "column tiling");
  static_assert(BJ % TX == 0, "each thread must own all four gates of a unit");
  static_assert((BK * BN) % NT == 0 && (BK * COLS) % NT == 0, "tile loads");
  constexpr int A_PER = BK * BN / NT;
  constexpr int B_PER = BK * COLS / NT;
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int G = 4 * H;

  float a_reg[A_PER], b_reg[B_PER];
  auto load = [&](int k0) {
#pragma unroll
    for (int s = 0; s < A_PER; ++s) {
      const int l = tid + s * NT;
      const int r = l / BK, k = k0 + l % BK;
      a_reg[s] = (ms[r] != 0.f && k < K) ? load_a(r, k) : 0.f;
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
}

// Loads the mask of the block's BN rows at step t into ms[] and returns
// whether any of them is real (every thread of the block must call it).
template <int BN>
__device__ __forceinline__ bool load_tile_mask(float* ms, const float* __restrict__ mask,
                                               int n0, int N, int Tn, int t) {
  bool real = false;
  if ((int)threadIdx.x < BN) {
    const int n = n0 + threadIdx.x;
    const float m = n < N ? mask[(size_t)n * Tn + t] : 0.f;
    ms[threadIdx.x] = m;
    real = m != 0.f;
  }
  return __syncthreads_or(real);
}

}  // namespace vd
