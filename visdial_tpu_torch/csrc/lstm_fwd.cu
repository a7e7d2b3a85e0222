// Masked LSTM layer forward for Hopper (sm_90a), on the tensor cores.
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
// of h_{t-1}.  A step is one GEMM (N rows x (E+H) deep x 4H wide) and a cell
// update.  At the option LSTM's 32,000 rows a step is ~106 GFLOP, so in
// principle the tensor cores bound it: 989 TFLOP/s in bf16, and for
// f32-accurate results three TF32 products a term (3xTF32), 495 / 3 = 165
// TFLOP/s.  At serving shapes (N = 10) and the 320-row question and fact
// LSTMs a step is a few to ~1 GFLOP, and the T launches, the k-loop's
// latency and the wrapper's host work bound it.
//
// What the design does about it.
//  * The gate product is common.cuh::tile_product: wgmma from a ring of
//    128-byte-swizzled shared tiles fed by 16-byte cp.async, bf16 x bf16 ->
//    f32, or 3xTF32 for f32 with each k-tile summed apart and added with
//    round-to-nearest.  Each block owns BM rows x BN gate columns, on one
//    of three tiles: 64 x 64, 128 x 128, and 256 x 128 in bf16 only (f32
//    needs room for its second accumulator).  The wrapper picks the tile
//    from the launch's shape and the card's SM count
//    (ops/lstm_cuda.py::lstm_tile): the one whose grid of (4H / BN) x
//    (N / BM) blocks runs in the fewest waves (an SM holds three 64 x 64
//    blocks in bf16, two in f32, one of the wider tiles), the narrowest of
//    those.  A step launch costs about a block's time a wave, and a block's
//    time grows with its tile, so a wider tile pays only where it saves a
//    wave: the 256 x 128 tile runs 640 rows as 48 blocks on 132 SMs in
//    about twice the 64 x 64 tile's time (320 blocks, one wave).
//  * The wrapper prepares W once per call (ops/lstm_cuda.py::pack_weights):
//    K-major, gate columns interleaved (row 4j + g of the packed W is gate g
//    of unit j), so one N-tile holds all four gates of its BN / 4 units, and
//    the x part zero-padded to a whole k-tile (Kx).  It pads E to a multiple
//    of 8, so that rows of x start 16-byte aligned.
//  * The A operand [x_t; h] is two plain strided tiles: x[:, t] and
//    hs[:, t-1], which the previous step wrote in T (h0 cast once for t = 0),
//    so h reaches the product rounded to T, as the TPU kernel rounds it.
//  * Epilogue: the accumulator goes through shared memory, so that one
//    thread holds i, f, g, o of a unit; the cell update, the mask select and
//    the writes of hs, cs and the f32 carries (updated in place) follow in
//    f32, coalesced along the units, each thread loading the carries of 8
//    rows before it updates them.
//  * The training forward also writes cs (the post-mask cell state of every
//    step, the TPU kernel's save_cell output), so the backward (lstm_bwd.cu)
//    never rebuilds the cell recurrence; serving passes no cs buffer.
//  * The block reads the mask of its rows at step t.  When no row of the tile
//    is real there (the steps outside the [start, stop) span that the TPU
//    wrapper prefetches as _tile_bounds), it skips the product and emits the
//    carried state, as the TPU kernel's skipped steps do.  Rows with m == 0
//    keep their carry.
//  * One launch a step, all T issued from one host call (vd_lstm_layer_fwd).
//    (One cooperative launch for all T steps, with a grid-wide barrier
//    between steps, measured no faster at 10 and 320 rows on an H100.)
// What is left (PERF.md, section 5): at 32,000 rows the
// epilogue's carry traffic takes about a third of the time and overlaps
// nothing (one block per SM, the epilogue after the k-loop), and the k-loop
// reaches about two thirds of the tensor-core rate; a persistent,
// warp-specialised kernel (TMA producer, epilogue beside the next tile's
// product) is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using vd::from_f;
using vd::Operand;
using vd::sigmoidf_;
using vd::to_f;

template <typename T> struct FwdArgs {
  const T* x;          // (N, Tn, Ep), E zero-padded to Ep
  const float* mask;   // (N, Tn)
  const T* w;          // (4H, KW) packed W
  const float* b;      // (4H,) gate order i, f, g, o
  const T* h0;         // (N, H) h0 in T
  float* h;            // (N, H) f32 carries, h0 / c0 on entry, updated in place
  float* c;
  T* hs;               // (N, Tn, H)
  T* cs;               // (N, Tn, H) or null
  int N, Tn, Ep, Kx, KW, H;
};

// Step t of the tile of BM rows (blockIdx.y) x BN gate columns
// (blockIdx.x).
template <typename T, int BM, int BN, int STAGES>
__global__ void __launch_bounds__(BM * 2)
lstm_fwd_step_kernel(const FwdArgs<T> a, int t) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ float ms[BM];
  unsigned char* smem = vd::align1024(smem_raw);
  const int mt = blockIdx.y, nt = blockIdx.x;
  using L = vd::TileSmem<T, BM, BN, STAGES>;
  constexpr int NT = BM * 2, BJ = BN / 4, BK = vd::TileK<T>::BK;
  const int m0 = mt * BM, j0 = nt * BJ, H = a.H;

  if (!vd::load_tile_mask<BM>(ms, a.mask, m0, a.N, a.Tn, t)) {
    // No real token in this tile at step t: emit the carried state.
    for (int idx = threadIdx.x; idx < BM * BJ; idx += NT) {
      const int n = m0 + idx / BJ, j = j0 + idx % BJ;
      if (n < a.N && j < H) {
        const size_t o = (size_t)n * H + j;
        const size_t ot = ((size_t)n * a.Tn + t) * H + j;
        a.hs[ot] = from_f<T>(a.h[o]);
        if (a.cs) a.cs[ot] = from_f<T>(a.c[o]);
      }
    }
    return;
  }

  const int nkx = a.Kx / BK;
  const int nkt = nkx + (H + BK - 1) / BK;
  const Operand<T> xo{a.x + (size_t)t * a.Ep, (long long)a.Tn * a.Ep, a.N, a.Ep};
  const Operand<T> ho = t == 0 ? Operand<T>{a.h0, H, a.N, H}
                               : Operand<T>{a.hs + (size_t)(t - 1) * H,
                                            (long long)a.Tn * H, a.N, H};
  const Operand<T> wo{a.w, a.KW, 4 * H, a.KW};
  float acc[BN / 2];
  vd::tile_product<T, BM, BN, STAGES>(acc, smem, xo, nkx, ho, wo, nkt, m0, nt * BN);
  float* cbuf = reinterpret_cast<float*>(smem);
  vd::stage_acc<BN, L::LDC>(acc, cbuf);
  __syncthreads();

  // Column 4u + g of the tile is gate g of unit j0 + u.  A thread keeps one
  // unit in every pass (NT is a multiple of BJ), so its biases load once,
  // and it loads the carries of BATCH passes before it updates them.
  constexpr int IT = BM * BJ / NT, BATCH = IT < 8 ? IT : 8;
  static_assert(NT % BJ == 0 && IT % BATCH == 0, "epilogue passes");
  const int u = threadIdx.x % BJ, j = j0 + u;
  if (j < H) {
    const float bi = a.b[j], bf = a.b[H + j], bg = a.b[2 * H + j], bo = a.b[3 * H + j];
    for (int i0 = 0; i0 < IT; i0 += BATCH) {
      float hv[BATCH], cv[BATCH];
#pragma unroll
      for (int q = 0; q < BATCH; ++q) {
        const int r = (threadIdx.x + (i0 + q) * NT) / BJ, n = m0 + r;
        if (n < a.N) {   // a row with m = 1 takes h' whole: its h is not read
          hv[q] = ms[r] != 1.f ? a.h[(size_t)n * H + j] : 0.f;
          cv[q] = a.c[(size_t)n * H + j];
        }
      }
#pragma unroll
      for (int q = 0; q < BATCH; ++q) {
        const int r = (threadIdx.x + (i0 + q) * NT) / BJ, n = m0 + r;
        if (n >= a.N) continue;
        const size_t o = (size_t)n * H + j;
        const size_t ot = ((size_t)n * a.Tn + t) * H + j;
        float h = hv[q], c = cv[q];
        const float m = ms[r];
        if (m != 0.f) {
          const float4 g = *reinterpret_cast<const float4*>(cbuf + r * L::LDC + 4 * u);
          const float gi = sigmoidf_(g.x + bi);
          const float gf = sigmoidf_(g.y + bf);
          const float gg = tanhf(g.z + bg);
          const float go = sigmoidf_(g.w + bo);
          const float c_new = gf * c + gi * gg;
          const float h_new = go * tanhf(c_new);
          h = m * h_new + (1.f - m) * h;
          c = m * c_new + (1.f - m) * c;
          a.h[o] = h;
          a.c[o] = c;
        }
        a.hs[ot] = from_f<T>(h);
        if (a.cs) a.cs[ot] = from_f<T>(c);
      }
    }
  }
}

template <typename T, int BM, int BN, int STAGES>
int fwd_launch(const FwdArgs<T>& a, cudaStream_t stream) {
  using L = vd::TileSmem<T, BM, BN, STAGES>;
  const auto step = lstm_fwd_step_kernel<T, BM, BN, STAGES>;
  const cudaError_t attr = vd::allow_smem<lstm_fwd_step_kernel<T, BM, BN, STAGES>, L::BYTES>();
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((4 * a.H + BN - 1) / BN, (a.N + BM - 1) / BM);
  for (int t = 0; t < a.Tn; ++t) {
    step<<<grid, BM * 2, L::BYTES, stream>>>(a, t);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int layer_fwd(const FwdArgs<T>& a, int tile, cudaStream_t stream) {
  constexpr int BK = vd::TileK<T>::BK;
  if (a.Kx % BK != 0 || a.KW != a.Kx + (a.H + BK - 1) / BK * BK || a.Ep % 8 != 0)
    return (int)cudaErrorInvalidValue;
  constexpr bool F32 = std::is_same<T, float>::value;
  if (tile == 64) return fwd_launch<T, 64, 64, F32 ? 3 : 4>(a, stream);
  if (tile == 128) return fwd_launch<T, 128, 128, F32 ? 3 : 4>(a, stream);
  // f32 keeps a second accumulator (common.cuh::tile_product): 256 rows
  // leave a thread too few registers for both
  if constexpr (!F32)
    if (tile == 256) return fwd_launch<T, 256, 128, 4>(a, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// One masked LSTM layer, all Tn steps.  dtype 0 = float32, 1 = bfloat16 for
// x, w, h0c, hs and cs.  x (N, Tn, Ep) with E zero-padded to Ep (a multiple
// of 8); w (4H, KW) packed as ops/lstm_cuda.py::pack_weights packs it; b
// (4H,) f32; h0c (N, H) h0 in the compute type;
// h, c (N, H) f32 hold (h0, c0) on entry and (hT, cT) on return.  cs (N, Tn,
// H), the post-mask cell state of every step (the training forward's
// residual), may be null.  tile is the rows of the block's tile: 64 (64 x
// 64), 128 (128 x 128) or 256 (256 x 128, bf16 only), as
// ops/lstm_cuda.py::lstm_tile picks it.  Returns a cudaError_t value (0 on
// success).
extern "C" int vd_lstm_layer_fwd(int dtype, const void* x, const float* mask,
                                 const void* w, const float* b, const void* h0c,
                                 float* h, float* c, void* hs, void* cs, int N,
                                 int Tn, int Ep, int Kx, int KW, int H, int tile,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return layer_fwd<float>({(const float*)x, mask, (const float*)w, b,
                             (const float*)h0c, h, c, (float*)hs, (float*)cs, N,
                             Tn, Ep, Kx, KW, H},
                            tile, s);
  if (dtype == 1) {
    using B16 = __nv_bfloat16;
    return layer_fwd<B16>({(const B16*)x, mask, (const B16*)w, b, (const B16*)h0c,
                           h, c, (B16*)hs, (B16*)cs, N, Tn, Ep, Kx, KW, H},
                          tile, s);
  }
  return (int)cudaErrorInvalidValue;
}
