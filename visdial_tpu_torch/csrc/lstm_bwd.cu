// Masked LSTM layer backward for Hopper (sm_90a), on the tensor cores.
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
// (N x 4H x H).  At the option LSTM's 32,000 rows a step is ~140 GFLOP, so
// in principle the tensor cores bound it (989 TFLOP/s bf16; 165 TFLOP/s for
// f32-accurate 3xTF32); at the 320-row question and fact LSTMs the 2T
// launches a layer and the k-loop's latency do.
//
// What the design does about it.  The TPU kernel keeps Wx and Wh in VMEM and
// carries (dh, dc) in scratch across its sequential grid; Hopper has neither
// the room nor an ordered grid.  Each step has two phases:
//  (a) lstm_bwd_gates_kernel: K1's tensor-core tile product over K = E + H
//      (common.cuh::tile_product, the packed gate-interleaved W that
//      ops/lstm_cuda.py::pack_weights prepares), the accumulator through
//      shared memory so one thread holds a unit's four gates, then the chain
//      rule in f32; writes dgp[:, t], the new dc and the pass-through part
//      (1 - m) Dh of the new dh.
//  (b) lstm_bwd_dh_kernel: dgp[:, t] . Wh^T, the same tile product over
//      K = 4H, with Wh = W[E:] (H x 4H) as the K-major B operand as it is
//      stored.  It contracts over all 4H gate columns, which every tile of
//      (a) writes, so it needs all of (a) done: the launch boundary is the
//      grid-wide barrier.  K is cut into S slices, one block each (S = 8 up
//      to 512 rows, where 40 tiles would leave most SMs idle through a
//      64-k-tile loop; 1 above), and each writes its partial product to its
//      own (N, H) f32 buffer dhp[s]; phase (a) of the next step adds the S
//      buffers to dh in order, and the wrapper adds the last step's.  So the
//      sum is the same from run to run, and no block reads what another
//      writes within a launch.
// Each phase is a launch, all 2T issued from one host call
// (vd_lstm_layer_bwd).  The carries dh and dc are (N, H) f32 buffers
// updated in place by phase (a): an element is read and written only by the
// thread that owns it.  (One cooperative launch for all T steps, with a
// grid-wide barrier after each phase, measured no faster at 320 rows on an
// H100.)  What is left is K1's (lstm_fwd.cu): the epilogues overlap nothing,
// and the k-loop runs below the tensor-core rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using vd::from_f;
using vd::Operand;
using vd::sigmoidf_;
using vd::to_f;

template <typename T> struct BwdArgs {
  const T* x;          // (N, Tn, Ep), E zero-padded to Ep
  const T* hprev;      // (N, Tn, H)
  const T* cprev;      // (N, Tn, H)
  const float* mask;   // (N, Tn)
  const T* w;          // (4H, KW) packed W
  const T* wh;         // (H, 4H) = W[E:]
  const float* b;      // (4H,)
  const T* ghs;        // (N, Tn, H)
  float* dh;           // (N, H) f32 carries, updated in place
  float* dc;
  float* dhp;          // (S, N, H) f32: phase (b)'s partial dgp . Wh^T
  T* dgp;              // (N, Tn, 4H)
  int N, Tn, Ep, Kx, KW, H, S;
};

// dh[o] plus the S partial products of the previous step's phase (b), in
// order
template <typename T>
__device__ __forceinline__ float carried_dh(const BwdArgs<T>& a, size_t o) {
  const size_t NH = (size_t)a.N * a.H;
  float v = a.dh[o];
  for (int s = 0; s < a.S; ++s) v += a.dhp[s * NH + o];
  return v;
}

// Phase (a) of step t for the tile of BM rows (blockIdx.y) x BN gate columns
// (blockIdx.x).
template <typename T, int BM, int BN, int STAGES>
__global__ void __launch_bounds__(BM * 2)
lstm_bwd_gates_kernel(const BwdArgs<T> a, int t) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ float ms[BM];
  unsigned char* smem = vd::align1024(smem_raw);
  const int mt = blockIdx.y, nt = blockIdx.x;
  using L = vd::TileSmem<T, BM, BN, STAGES>;
  constexpr int NT = BM * 2, BJ = BN / 4, BK = vd::TileK<T>::BK;
  const int m0 = mt * BM, j0 = nt * BJ, H = a.H;
  const size_t G = 4 * (size_t)H;
  const T zero = from_f<T>(0.f);

  if (!vd::load_tile_mask<BM>(ms, a.mask, m0, a.N, a.Tn, t)) {
    // m = 0 for every row: dh += g_hs[:, t], dgp[:, t] = 0, dc unchanged.
    for (int idx = threadIdx.x; idx < BM * BJ; idx += NT) {
      const int n = m0 + idx / BJ, j = j0 + idx % BJ;
      if (n < a.N && j < H) {
        const size_t nt_ = (size_t)n * a.Tn + t;
        const size_t o = (size_t)n * H + j;
        a.dh[o] = carried_dh(a, o) + to_f(a.ghs[nt_ * H + j]);
        T* d = a.dgp + nt_ * G + j;
        d[0] = zero;
        d[H] = zero;
        d[2 * (size_t)H] = zero;
        d[3 * (size_t)H] = zero;
      }
    }
    return;
  }

  // A = [x_t; h_prev_t], both already in T
  const int nkx = a.Kx / BK;
  const int nkt = nkx + (H + BK - 1) / BK;
  const Operand<T> xo{a.x + (size_t)t * a.Ep, (long long)a.Tn * a.Ep, a.N, a.Ep};
  const Operand<T> ho{a.hprev + (size_t)t * H, (long long)a.Tn * H, a.N, H};
  const Operand<T> wo{a.w, a.KW, 4 * H, a.KW};
  float acc[BN / 2];
  vd::tile_product<T, BM, BN, STAGES>(acc, smem, xo, nkx, ho, wo, nkt, m0, nt * BN);
  float* cbuf = reinterpret_cast<float*>(smem);
  vd::stage_acc<BN, L::LDC>(acc, cbuf);
  __syncthreads();

  // Column 4u + g of the tile is gate g of unit j0 + u.  A thread keeps one
  // unit in every pass (NT is a multiple of BJ), so its biases load once,
  // and it loads the operands of BATCH passes before it uses them.
  constexpr int IT = BM * BJ / NT, BATCH = IT < 8 ? IT : 8;
  static_assert(NT % BJ == 0 && IT % BATCH == 0, "epilogue passes");
  const int u = threadIdx.x % BJ, j = j0 + u;
  if (j < H) {
    const float bi = a.b[j], bf = a.b[H + j], bg = a.b[2 * H + j], bo = a.b[3 * H + j];
    for (int i0 = 0; i0 < IT; i0 += BATCH) {
      float dhv[BATCH], dcv[BATCH], ghv[BATCH], cpv[BATCH];
#pragma unroll
      for (int q = 0; q < BATCH; ++q) {
        const int r = (threadIdx.x + (i0 + q) * NT) / BJ, n = m0 + r;
        if (n < a.N) {   // a row with m = 0 needs neither dc nor c_prev
          const size_t nt_ = (size_t)n * a.Tn + t, o = (size_t)n * H + j;
          dhv[q] = carried_dh(a, o);
          ghv[q] = to_f(a.ghs[nt_ * H + j]);
          dcv[q] = ms[r] != 0.f ? a.dc[o] : 0.f;
          cpv[q] = ms[r] != 0.f ? to_f(a.cprev[nt_ * H + j]) : 0.f;
        }
      }
#pragma unroll
      for (int q = 0; q < BATCH; ++q) {
        const int r = (threadIdx.x + (i0 + q) * NT) / BJ, n = m0 + r;
        if (n >= a.N) continue;
        const float m = ms[r];
        const size_t nt_ = (size_t)n * a.Tn + t;
        const size_t o = (size_t)n * H + j;
        const float Dh = ghv[q] + dhv[q];
        T* d = a.dgp + nt_ * G + j;
        if (m == 0.f) {
          a.dh[o] = Dh;
          d[0] = zero;
          d[H] = zero;
          d[2 * (size_t)H] = zero;
          d[3 * (size_t)H] = zero;
          continue;
        }
        const float4 g = *reinterpret_cast<const float4*>(cbuf + r * L::LDC + 4 * u);
        const float Dc = dcv[q], cp = cpv[q];
        const float gi = sigmoidf_(g.x + bi);
        const float gf = sigmoidf_(g.y + bf);
        const float gg = tanhf(g.z + bg);
        const float go = sigmoidf_(g.w + bo);
        const float tcn = tanhf(gf * cp + gi * gg);
        const float dhn = m * Dh;
        const float dcn = m * Dc + dhn * go * (1.f - tcn * tcn);
        a.dc[o] = (1.f - m) * Dc + dcn * gf;
        a.dh[o] = (1.f - m) * Dh;   // phase (b) adds dgp . Wh^T
        d[0] = from_f<T>((dcn * gg) * gi * (1.f - gi));
        d[H] = from_f<T>((dcn * cp) * gf * (1.f - gf));
        d[2 * (size_t)H] = from_f<T>((dcn * gi) * (1.f - gg * gg));
        d[3 * (size_t)H] = from_f<T>((dhn * tcn) * go * (1.f - go));
      }
    }
  }
}

// Phase (b) of step t for the tile of BM rows (blockIdx.y) x BN hidden units
// (blockIdx.x) and K slice s = blockIdx.z of ck k-tiles:
// dhp[s][n, j] = sum_k dgp[n, t, k] Wh[j, k] over the slice's k.
template <typename T, int BM, int BN, int STAGES>
__global__ void __launch_bounds__(BM * 2)
lstm_bwd_dh_kernel(const BwdArgs<T> a, int t, int ck) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ float ms[BM];
  unsigned char* smem = vd::align1024(smem_raw);
  using L = vd::TileSmem<T, BM, BN, STAGES>;
  constexpr int NT = BM * 2, BK = vd::TileK<T>::BK;
  const int m0 = blockIdx.y * BM, j0 = blockIdx.x * BN, H = a.H, K = 4 * H;
  const int k0 = blockIdx.z * ck * BK;
  float* dhp = a.dhp + (size_t)blockIdx.z * a.N * H;

  float acc[BN / 2];
  // rows with m = 0 have dgp[:, t] = 0: a tile without a real row, or a
  // slice past K, adds zeros
  const bool real = vd::load_tile_mask<BM>(ms, a.mask, m0, a.N, a.Tn, t);
  const int nkt = real && k0 < K ? min(ck, (K - k0 + BK - 1) / BK) : 0;
  const Operand<T> ao{a.dgp + (size_t)t * K + k0, (long long)a.Tn * K, a.N, K - k0};
  const Operand<T> bo{a.wh + k0, K, H, K - k0};
  vd::tile_product<T, BM, BN, STAGES>(acc, smem, ao, nkt, ao, bo, nkt, m0, j0);
  float* cbuf = reinterpret_cast<float*>(smem);
  vd::stage_acc<BN, L::LDC>(acc, cbuf);
  __syncthreads();
  static_assert(NT % BN == 0, "a thread keeps one unit in every pass");
  const int j = j0 + threadIdx.x % BN;
  if (j < H)
    for (int idx = threadIdx.x; idx < BM * BN; idx += NT) {
      const int r = idx / BN, n = m0 + r;
      if (n < a.N) dhp[(size_t)n * H + j] = cbuf[r * L::LDC + idx % BN];
    }
}

template <typename T, int BM, int BN, int STAGES>
int bwd_launch(const BwdArgs<T>& a, cudaStream_t stream) {
  using L = vd::TileSmem<T, BM, BN, STAGES>;
  constexpr int BK = vd::TileK<T>::BK;
  const auto gates = lstm_bwd_gates_kernel<T, BM, BN, STAGES>;
  const auto dh = lstm_bwd_dh_kernel<T, BM, BN, STAGES>;
  cudaError_t attr = vd::allow_smem<lstm_bwd_gates_kernel<T, BM, BN, STAGES>, L::BYTES>();
  if (attr == cudaSuccess)
    attr = vd::allow_smem<lstm_bwd_dh_kernel<T, BM, BN, STAGES>, L::BYTES>();
  if (attr != cudaSuccess) return (int)attr;
  const int ntm = (a.N + BM - 1) / BM;
  const int nkt = (4 * a.H + BK - 1) / BK, ck = (nkt + a.S - 1) / a.S;
  const dim3 grid_a((4 * a.H + BN - 1) / BN, ntm), grid_b((a.H + BN - 1) / BN, ntm, a.S);
  for (int t = a.Tn - 1; t >= 0; --t) {
    gates<<<grid_a, BM * 2, L::BYTES, stream>>>(a, t);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    dh<<<grid_b, BM * 2, L::BYTES, stream>>>(a, t, ck);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int layer_bwd(const BwdArgs<T>& a, cudaStream_t stream) {
  constexpr int BK = vd::TileK<T>::BK;
  if (a.Kx % BK != 0 || a.KW != a.Kx + (a.H + BK - 1) / BK * BK || a.Ep % 8 != 0 ||
      a.S < 1)
    return (int)cudaErrorInvalidValue;
  constexpr bool F32 = std::is_same<T, float>::value;
  if (a.N <= vd::kSmallRows) return bwd_launch<T, 64, 64, F32 ? 3 : 4>(a, stream);
  // f32 keeps a second accumulator (common.cuh::tile_product): 128 x 128
  // leaves a thread the registers for both
  if constexpr (F32)
    return bwd_launch<T, 128, 128, 3>(a, stream);
  else
    return bwd_launch<T, 256, 128, 4>(a, stream);
}

}  // namespace

// One masked LSTM layer backward, all Tn steps in reverse.  dtype 0 =
// float32, 1 = bfloat16 for x (N, Tn, Ep) (E zero-padded to Ep, a multiple
// of 8), hprev, cprev, ghs (N, Tn, H), w (4H, KW) packed as
// ops/lstm_cuda.py::pack_weights packs it, wh (H, 4H) = W[E:] and dgp (N,
// Tn, 4H); mask (N, Tn) and b (4H,) f32.  dh and dc (N, H) f32 hold (g_hT,
// g_cT) on entry; dhp (S, N, H) f32 zeros.  On return dc holds dc0 and
// dh0 = dh + the sum of dhp over S.  Returns a cudaError_t value (0 on
// success).
extern "C" int vd_lstm_layer_bwd(int dtype, const void* x, const void* hprev,
                                 const void* cprev, const float* mask,
                                 const void* w, const void* wh, const float* b,
                                 const void* ghs, float* dh, float* dc, float* dhp,
                                 void* dgp, int N, int Tn, int Ep, int Kx, int KW,
                                 int H, int S, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return layer_bwd<float>({(const float*)x, (const float*)hprev,
                             (const float*)cprev, mask, (const float*)w,
                             (const float*)wh, b, (const float*)ghs, dh, dc, dhp,
                             (float*)dgp, N, Tn, Ep, Kx, KW, H, S},
                            s);
  if (dtype == 1) {
    using B16 = __nv_bfloat16;
    return layer_bwd<B16>({(const B16*)x, (const B16*)hprev, (const B16*)cprev,
                           mask, (const B16*)w, (const B16*)wh, b,
                           (const B16*)ghs, dh, dc, dhp, (B16*)dgp, N, Tn, Ep, Kx,
                           KW, H, S},
                          s);
  }
  return (int)cudaErrorInvalidValue;
}
