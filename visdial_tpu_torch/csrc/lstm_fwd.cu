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
// LSTMs a step is a few to ~1 GFLOP: there moving W (3.4 MB in bf16 at E
// 300, H 512) and the chain of steps bound it, not the operations.
//
// Two routes, picked by ops/lstm_cuda.py::layer_plan from the launch's
// dtype, widths and rows and the card's cluster capacity; they share only
// common.cuh's helpers, since the two regimes want opposite things.
//
// The step route (lstm_fwd_step_kernel), many rows or f32: every SM wants
// rows of its own, with W streamed through wide tiles.
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
//    At 320 rows each launch pulls all of W through L2 five times and
//    round-trips the carries through device memory: 12.6 us a step against
//    ~1.1 us of operations (PERF.md).
//  What is left (PERF.md, section 5): at 32,000 rows the epilogue's carry
//  traffic takes about a third of the time and overlaps nothing (one block
//  per SM, the epilogue after the k-loop), and the k-loop reaches about two
//  thirds of the tensor-core rate; a persistent, warp-specialised kernel
//  (TMA producer, epilogue beside the next tile's product) is the next step.
//
// The resident route (lstm_fwd_step_kernel_resident), few rows in bf16: W
// stands still.  One launch a layer runs all T steps.
//  * A thread block cluster of CS = ceil(H / 32) blocks (16 at H 512, past
//    the portable 8) owns R rows (16, 32, 48 or 64) for all steps; block s
//    holds the 128 gate columns of units [32 s, 32 s + 32).  Clusters never
//    wait on each other, so they may run in waves; the wrapper takes the
//    route only where one wave holds them (vd_lstm_resident_clusters:
//    cudaOccupancyMaxActiveClusters, 7 of 16 blocks on an H100, or 0 where
//    the layer does not fit), with the fewest rows a cluster that allows,
//    so that the rows spread over every cluster that runs (320 rows: 7
//    clusters of 48).
//  * The product is gates^T = W . [x_t; h]^T: the block's 128 gate columns
//    are wgmma's M (64 a warpgroup), the R rows its N.  The W_h slice (128
//    columns x 512, 128 KB) lives for the whole call in the registers of
//    the two warpgroups as wgmma's A operand (128 a thread); the W_x slice
//    (128 columns x Kx, at most 128 KB) in shared memory.  Nothing of W
//    moves after the first step.
//  * h_{t-1} (R rows x H in bf16) sits in each block's shared memory as the
//    h part's B operand, one 64-byte-swizzled slice (R x 32 units) a block
//    of the cluster.  Each block stages its slice of h_t (two buffers,
//    alternate steps) and its first CS threads send it with the copy engine
//    (cp.async.bulk), thread p into block p's h tile, completing on that
//    block's mbarrier, which the next step's h part waits on.  One cluster barrier
//    a step, arrived at once the block's products are done and waited on
//    before it sends, keeps a slice from landing in an h tile still read.
//  * x_t . W_x does not depend on h: x_t's k-tiles come through a ring of
//    cp.async copies, the first ring's worth loaded during the step before,
//    and their product is issued before the step waits for h; the h part
//    accumulates onto it in f32 (the step route's order: x k-tiles, then h;
//    where the ring holds fewer than x's k-tiles, the rest follow the h
//    part).  No pre-gate buffer is written.
//  * The f32 c carries stay in registers: after one exchange between lanes
//    l and l ^ 16, a thread holds i, f, g, o of one unit at R / 8 rows, for
//    every step.  h's f32 carry stays in h as on the step route, read only
//    where 0 < m < 1.  hs[:, t] is written from the staged slice, cs[:, t]
//    from the registers, c once at the end.
//  * Steps where no row of the cluster's R is real (known from a bit a
//    step, set before step 0) cost no product and no barrier: the step
//    before writes the carried state into their hs and cs, as the step
//    route's skipped tiles do.
//  Earlier, one cooperative launch for all T steps with a grid-wide barrier
//  between steps measured no faster at 10 and 320 rows: it kept the step
//  route's structure, re-reading W every step behind a barrier of the whole
//  grid.  The resident route keeps W still and syncs within a cluster only.

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


// ---------------------------------------------------------------------------
// The resident route (bf16 only)

constexpr int kResMaxRows = 64;    // rows a cluster owns (R, wgmma's N) at most
constexpr int kResUnits = 32;      // units a block holds: 128 gate columns
constexpr int kResThreads = 256;   // two warpgroups, 64 gate columns each
constexpr int kResMaxH = 512;      // clusters of 16, W_h in 128 registers a thread
constexpr int kResKSteps = kResMaxH / 16;
constexpr int kResSmem = 232448;   // shared memory a block may use

// Byte offsets of the resident kernel's shared memory past its 1024-aligned
// base, and the bytes it asks for: W_x's slice (nkx k-tiles of 128 rows x
// 128 bytes), the h tile (a slice of R rows x 32 units a block of the
// cluster), the ring of S x k-tiles (R rows x 128 bytes), two staged slices,
// the step's mask, the h tile's mbarrier and the real-step bits.
struct ResSmem {
  int slice, wx, htile, ring, stage, ms, mbar, bits, bytes;
  __host__ __device__ ResSmem(int R, int nkx, int cs, int S, int Tn) {
    slice = R * kResUnits * 2;
    wx = 0;
    htile = wx + nkx * 2 * 64 * 128;
    ring = htile + cs * slice;
    stage = ring + S * R * 128;
    ms = stage + 2 * slice;
    mbar = ms + R * 4;
    bits = mbar + 16;
    bytes = bits + (Tn + 31) / 32 * 4 + 1024;
  }
};

// The ring's stages at R rows a cluster of cs blocks: as many of x's nkx
// k-tiles as fit in a block's shared memory beside the rest; below 1 where
// not even one does.
int res_stages(int R, int nkx, int cs, int Tn) {
  const int fit = (kResSmem - ResSmem(R, nkx, cs, 0, Tn).bytes) / (R * 128);
  return fit < nkx ? fit : nkx;
}

// The packed W row (gate column) of row mm of warpgroup g's 64 in block s.
// wgmma's accumulator gives lane l of warp w rows 16 w + l / 4 and + 8; the
// rows are laid out so that lane l (l / 4 < 4) holds i and f of unit
// 16 g + 4 w + l / 4 and lane l ^ 16 its g and o.
__device__ __forceinline__ int res_wrow(int s, int g, int mm) {
  const int w = mm >> 4, q = mm & 7, hi = (mm >> 3) & 1;
  const int u = 16 * g + 4 * w + (q & 3);
  return 4 * (kResUnits * s + u) + (q >= 4 ? 2 : 0) + hi;
}

// A slice (R rows x 32 units in bf16) is a K-major tile with the 64-byte
// swizzle: row n's 16-byte chunk c (units 8c..8c+7) at n * 64 + (c ^ (n / 2
// % 4)) * 16, so that each block's slice of h is 4 KB in one piece and
// wgmma reads it with a 64-byte-swizzle descriptor (stride 512 bytes
// between 8-row groups).
__device__ __forceinline__ int slice_off(int n, int c) {
  return n * 64 + ((c ^ ((n >> 1) & 3)) << 4);
}
__device__ __forceinline__ uint64_t smem_desc_sw64(uint32_t s) {
  return (uint64_t)((s & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(512 >> 4) << 32) | ((uint64_t)2 << 62);
}

// The h tile's mbarrier, and the bulk copies (the async proxy, the
// hardware's copy engine) that fill it from every block of the cluster
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra LAB_WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// the shared::cluster address of shared address a in block `rank`
__device__ __forceinline__ uint32_t peer_addr(uint32_t a, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}
// `bytes` from this block's shared src to dst (shared::cluster), completing
// on the mbarrier bar (shared::cluster, in dst's block)
__device__ __forceinline__ void bulk_to_peer(uint32_t dst, uint32_t src, int bytes,
                                             uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], "
      "%2, [%3];\n" ::"r"(dst),
      "r"(src), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// this thread's bulk copies but the last N have read their source
template <int N> __device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// The first step at or after t with a real row in the cluster's block, Tn
// where none is.
__device__ __forceinline__ int next_real(const uint32_t* bits, int t, int Tn) {
  while (t < Tn) {
    const uint32_t w = bits[t >> 5] >> (t & 31);
    if (w) return t + __ffs(w) - 1;
    t = (t | 31) + 1;
  }
  return Tn;
}

// All Tn steps of R rows (blockIdx.y) on a cluster of gridDim.x blocks;
// block blockIdx.x holds units [32 x, 32 x + 32).  S: the ring's stages.
template <int R>
__global__ void __launch_bounds__(kResThreads, 1)
lstm_fwd_step_kernel_resident(const FwdArgs<__nv_bfloat16> a, int S) {
  using T = __nv_bfloat16;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = vd::align1024(smem_raw);
  constexpr int G = R / 8;   // the accumulator's 8-row groups
  const int s = blockIdx.x, CS = gridDim.x, n0 = blockIdx.y * R;
  const int H = a.H, Tn = a.Tn, nkx = a.Kx / 64;
  const ResSmem L(R, nkx, CS, S, Tn);
  const int slice = L.slice;
  const uint32_t base = vd::smem_u32(smem);
  const uint32_t wx = base + L.wx, htile = base + L.htile, ring = base + L.ring;
  const uint32_t mbar = base + L.mbar;
  unsigned char* stage = smem + L.stage;   // two slices
  float* ms = reinterpret_cast<float*>(smem + L.ms);
  uint32_t* bits = reinterpret_cast<uint32_t*>(smem + L.bits);

  const int tid = threadIdx.x, g = tid >> 7, w = (tid >> 5) & 3, lane = tid & 31;
  const int q = lane >> 2, t4 = lane & 3;
  const bool upper = q >= 4;
  const int u = 16 * g + 4 * w + (q & 3), j = kResUnits * s + u;
  const bool jv = j < H;
  // after the exchange the thread's value r (of G) is row row_of(r) of the block
  auto row_of = [&](int r) { return 8 * ((r >> 1) + (upper ? G / 2 : 0)) + 2 * t4 + (r & 1); };
  // unit u of row n in a slice
  auto unit_off = [&](int n) { return slice_off(n, u >> 3) + (u & 7) * 2; };

  // which steps hold a real row of the block: a warp a step
  for (int i = tid; i < (Tn + 31) / 32; i += kResThreads) bits[i] = 0;
  if (tid == 0) mbar_init(mbar, 1);
  __syncthreads();
  for (int t = tid >> 5; t < Tn; t += kResThreads / 32) {
    bool real = false;
    for (int r = lane; r < R; r += 32)
      real |= n0 + r < a.N && a.mask[(size_t)(n0 + r) * Tn + t] != 0.f;
    if (__any_sync(0xffffffffu, real) && lane == 0) atomicOr(&bits[t >> 5], 1u << (t & 31));
  }

  // W_x's slice into shared memory, as 128-byte-swizzled k-tiles of each
  // warpgroup's 64 rows (common.cuh::tile_product's A layout)
  for (int i = tid; i < nkx * 1024; i += kResThreads) {
    const int kt = i >> 10, m = (i >> 3) & 127, c = i & 7, mg = m >> 6, mm = m & 63;
    const int wr = res_wrow(s, mg, mm);
    const bool ok = wr < 4 * H;
    vd::cp_async16(wx + kt * 16384 + mg * 8192 + mm * 128 + ((c ^ (mm & 7)) << 4),
                   ok ? a.w + (size_t)wr * a.KW + kt * 64 + c * 8 : a.w, ok ? 16 : 0);
  }
  vd::cp_async_commit();

  // W_h's slice into registers, wgmma's A fragments: k-step ks, the
  // thread's rows R0 (gate i or g) and R0 + 1 (f or o), columns 2 t4 (+1)
  // and + 8
  uint32_t wh[kResKSteps][4];
  {
    const int R0 = res_wrow(s, g, 16 * w + q);
    const T* p0 = a.w + (size_t)R0 * a.KW + a.Kx + 2 * t4;
    const T* p1 = p0 + a.KW;
#pragma unroll
    for (int ks = 0; ks < kResKSteps; ++ks) {
      const bool in = jv && ks < 2 * CS;
      const auto ld = [&](const T* p) {
        return in ? __ldg(reinterpret_cast<const unsigned int*>(p)) : 0u;
      };
      wh[ks][0] = ld(p0 + 16 * ks);
      wh[ks][1] = ld(p1 + 16 * ks);
      wh[ks][2] = ld(p0 + 16 * ks + 8);
      wh[ks][3] = ld(p1 + 16 * ks + 8);
    }
  }
  float bi = 0.f, bf = 0.f, bg = 0.f, bo = 0.f;
  if (jv) {
    bi = a.b[j];
    bf = a.b[H + j];
    bg = a.b[2 * H + j];
    bo = a.b[3 * H + j];
  }
  // the c carries of unit j at the thread's G rows; h's f32 carry stays in
  // a.h (read only where 0 < m < 1), its bf16 rounding in the staged slice
  float cc[G];
#pragma unroll
  for (int r = 0; r < G; ++r) {
    const int n = n0 + row_of(r);
    cc[r] = jv && n < a.N ? a.c[(size_t)n * H + j] : 0.f;
    T h0 = vd::from_f<T>(0.f);
    if (jv && n < a.N) h0 = vd::from_f<T>(a.h[(size_t)n * H + j]);
    *reinterpret_cast<T*>(stage + unit_off(row_of(r))) = h0;
  }

  // k-tile kt of x_t into ring stage st (rows past N and columns past Ep
  // as zeros), by the first warpgroup
  const auto load_x = [&](int t, int kt, int st) {
    if (tid >= 128) return;
    const vd::Operand<T> xo{a.x + (size_t)t * a.Ep, (long long)Tn * a.Ep, a.N, a.Ep};
    const vd::Loader<T, 128> lx(xo, n0);
    lx.load<R>(ring + st * R * 128 + vd::Loader<T, 128>::offset(), kt * 64);
  };
  const int nk0 = min(S, nkx);   // x's k-tiles loaded during the step before
  const auto load_x_first = [&](int t) {
    for (int kt = 0; kt < nk0; ++kt) load_x(t, kt, kt);
    vd::cp_async_commit();
  };
  // acc += W_x k-tiles [k0, k0 + nk) . x k-tiles in ring stages [0, nk)
  const auto x_part = [&](float(&acc)[R / 2], int k0, int nk) {
    for (int kt = 0; kt < nk; ++kt) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        vd::Wgmma<T, R>::run(acc, vd::smem_desc(wx + (k0 + kt) * 16384 + g * 8192 + kk * 32),
                             vd::smem_desc(ring + kt * R * 128 + kk * 32));
    }
  };
  // the staged slice sb to every block's h tile, thread p to block p (the
  // slice written and fenced for the async proxy before the block's
  // barrier); thread 0 sets the bytes its own h tile awaits
  const auto push = [&](int sb) {
    if (tid == 0) mbar_expect(mbar, CS * slice);
    if (tid < CS) {
      bulk_to_peer(peer_addr(htile + s * slice, tid), base + L.stage + sb * slice, slice,
                   peer_addr(mbar, tid));
      bulk_commit();
    }
  };
  // hs[:, t] from staged slice sb and cs[:, t] from the carries, t in
  // [t0, t1): a real step and the skipped ones after it
  const auto emit = [&](int sb, int t0, int t1) {
    const int nr = tid >> 2, ch = tid & 3, n = n0 + nr, j0 = kResUnits * s + 8 * ch;
    if (nr < R && n < a.N && j0 < H) {
      const uint4 v = *reinterpret_cast<const uint4*>(stage + sb * slice + slice_off(nr, ch));
      const T* e = reinterpret_cast<const T*>(&v);
      for (int t = t0; t < t1; ++t) {
        T* dst = a.hs + ((size_t)n * Tn + t) * H + j0;
        if (H % 8 == 0) {
          *reinterpret_cast<uint4*>(dst) = v;
        } else {
          for (int k = 0; k < 8 && j0 + k < H; ++k) dst[k] = e[k];
        }
      }
    }
    if (a.cs && jv) {
#pragma unroll
      for (int r = 0; r < G; ++r) {
        const int nn = n0 + row_of(r);
        if (nn >= a.N) continue;
        const T cv = vd::from_f<T>(cc[r]);
        for (int t = t0; t < t1; ++t) a.cs[((size_t)nn * Tn + t) * H + j] = cv;
      }
    }
  };

  vd::fence_proxy_async();   // h0's slice, for the bulk copies
  __syncthreads();           // the bits, the slice, the mbarrier
  vd::cluster_arrive();      // every block's mbarrier initialised
  int t = next_real(bits, 0, Tn);
  float mnext = 0.f;   // threads < 64: the mask of their row at step t
  if (t < Tn) {
    load_x_first(t);
    if (tid < R && n0 + tid < a.N) mnext = a.mask[(size_t)(n0 + tid) * Tn + t];
  }
  emit(0, 0, t);
  vd::cluster_wait();
  if (t < Tn) push(0);

  float acc[R / 2];
  int sb = 0;       // the staged slice of h_{t-1}
  int phase = 0;    // the mbarrier's phase that h_{t-1} completes
  while (t < Tn) {
    const int tn = next_real(bits, t + 1, Tn);
    if (tid < R) {
      ms[tid] = mnext;
      mnext = tn < Tn && n0 + tid < a.N ? a.mask[(size_t)(n0 + tid) * Tn + tn] : 0.f;
    }
    vd::cp_async_wait<0>();   // x's first k-tiles (and, at the first step, W_x)
    vd::fence_proxy_async();
    __syncthreads();
#pragma unroll
    for (int i = 0; i < R / 2; ++i) acc[i] = 0.f;
    vd::wgmma_fence();
    x_part(acc, 0, nk0);
    vd::wgmma_commit();

    mbar_wait(mbar, phase);   // h_{t-1}: every block's slice in the h tile
    phase ^= 1;
#pragma unroll
    for (int ks = 0; ks < kResKSteps; ++ks)
      if (ks < 2 * CS)
        vd::WgmmaRS<R>::run(acc, wh[ks],
                            smem_desc_sw64(htile + (ks >> 1) * slice + (ks & 1) * 32));
    vd::wgmma_commit();
    // x's k-tiles past the ring, a ring's worth at a time, once the
    // warpgroups' products that read the ring are done
    for (int k0 = nk0; k0 < nkx; k0 += S) {
      if (k0 == nk0)
        vd::wgmma_wait<1>();
      else
        vd::wgmma_wait<0>();
      __syncthreads();
      const int nk = min(S, nkx - k0);
      for (int kt = 0; kt < nk; ++kt) load_x(t, k0 + kt, kt);
      vd::cp_async_commit();
      vd::cp_async_wait<0>();
      vd::fence_proxy_async();
      __syncthreads();
      vd::wgmma_fence();
      x_part(acc, k0, nk);
      vd::wgmma_commit();
    }
    vd::wgmma_wait<0>();
    vd::cluster_arrive();   // this block's h tile is read
    if (tid < CS) bulk_wait_read<1>();   // slice sb ^ 1's copies (two steps back) read
    __syncthreads();

    // The cell update.  Lane l < 16 of a warp holds gates i (rows q) and f
    // (q + 8) of unit u at the R rows, lane l ^ 16 its g and o: they
    // swap halves of the rows, so that each holds all four at G rows.
    unsigned char* next = stage + (sb ^ 1) * slice;
    const unsigned char* prev = stage + sb * slice;
#pragma unroll
    for (int i = 0; i < G / 2; ++i) {
      float other[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        other[k] = __shfl_xor_sync(0xffffffffu,
                                   upper ? acc[4 * i + k] : acc[4 * (i + G / 2) + k], 16);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = 2 * i + e, nr = row_of(r), n = n0 + nr;
        const float own0 = upper ? acc[4 * (i + G / 2) + e] : acc[4 * i + e];
        const float own1 = upper ? acc[4 * (i + G / 2) + 2 + e] : acc[4 * i + 2 + e];
        const float zi = upper ? other[e] : own0, zf = upper ? other[2 + e] : own1;
        const float zg = upper ? own0 : other[e], zo = upper ? own1 : other[2 + e];
        const float m = ms[nr];
        T hb = *reinterpret_cast<const T*>(prev + unit_off(nr));
        if (jv && m != 0.f) {
          const float gi = sigmoidf_(zi + bi);
          const float gf = sigmoidf_(zf + bf);
          const float gg = tanhf(zg + bg);
          const float go = sigmoidf_(zo + bo);
          const float c_new = gf * cc[r] + gi * gg;
          const float h_new = go * tanhf(c_new);
          const size_t o = (size_t)n * H + j;
          // a row with m = 1 takes h' whole: its h is not read
          const float h = m * h_new + (1.f - m) * (m != 1.f ? a.h[o] : 0.f);
          cc[r] = m * c_new + (1.f - m) * cc[r];
          a.h[o] = h;
          hb = vd::from_f<T>(h);
        }
        *reinterpret_cast<T*>(next + unit_off(nr)) = hb;
      }
    }
    vd::fence_proxy_async();   // the slice, for the bulk copies
    __syncthreads();           // the slice staged; every warpgroup's products done
    if (tn < Tn) load_x_first(tn);
    vd::cluster_wait();        // every block's h tile is read
    if (tn < Tn) push(sb ^ 1);
    emit(sb ^ 1, t, tn);
    sb ^= 1;
    t = tn;
  }
  vd::cp_async_wait<0>();
#pragma unroll
  for (int r = 0; r < G; ++r) {
    const int n = n0 + row_of(r);
    if (jv && n < a.N) a.c[(size_t)n * H + j] = cc[r];
  }
}

// The resident kernel's attributes on the current device: the whole shared
// memory, and clusters past the portable 8.
template <int R> cudaError_t resident_attrs() {
  const cudaError_t e = vd::allow_smem<lstm_fwd_step_kernel_resident<R>, kResSmem>();
  if (e != cudaSuccess) return e;
  return vd::set_func_attr<lstm_fwd_step_kernel_resident<R>,
                           cudaFuncAttributeNonPortableClusterSizeAllowed, 1>();
}

// A launch of ceil(N / R) clusters of ceil(H / 32) blocks (grid x the
// cluster), with `smem` bytes of shared memory a block.
cudaLaunchConfig_t resident_config(int N, int R, int H, int smem, cudaStream_t stream,
                                   cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  const int cs = (H + kResUnits - 1) / kResUnits;
  cfg.gridDim = dim3(cs, (N + R - 1) / R);
  cfg.blockDim = dim3(kResThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int R> int resident_launch(const FwdArgs<__nv_bfloat16>& a, cudaStream_t stream) {
  const int nkx = a.Kx / 64, cs = (a.H + kResUnits - 1) / kResUnits;
  const int S = res_stages(R, nkx, cs, a.Tn);
  if (S < 1) return (int)cudaErrorInvalidValue;
  const ResSmem L(R, nkx, cs, S, a.Tn);
  const cudaError_t attr = resident_attrs<R>();
  if (attr != cudaSuccess) return (int)attr;
  cudaLaunchAttribute cl;
  const cudaLaunchConfig_t cfg = resident_config(a.N, R, a.H, L.bytes, stream, &cl);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, lstm_fwd_step_kernel_resident<R>, a, S);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

int layer_fwd_resident(const FwdArgs<__nv_bfloat16>& a, int R, cudaStream_t stream) {
  if (a.Kx % 64 != 0 || a.KW != a.Kx + (a.H + 63) / 64 * 64 || a.Ep % 8 != 0 ||
      a.H > kResMaxH)
    return (int)cudaErrorInvalidValue;
  switch (R) {
    case 16: return resident_launch<16>(a, stream);
    case 32: return resident_launch<32>(a, stream);
    case 48: return resident_launch<48>(a, stream);
    case 64: return resident_launch<64>(a, stream);
  }
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

// The same layer on the resident route (bf16 only, on a layer that
// vd_lstm_resident_clusters finds fits): the arguments of vd_lstm_layer_fwd,
// h0c unused (h0 is staged from h), with `rows` in place of tile: the rows a
// cluster owns (16, 32, 48 or 64), as ops/lstm_cuda.py::layer_plan picks
// them; the ring takes as many of x's k-tiles as the shared memory holds.
// Returns a cudaError_t value (0 on success).
extern "C" int vd_lstm_layer_fwd_resident(int dtype, const void* x, const float* mask,
                                          const void* w, const float* b, const void* h0c,
                                          float* h, float* c, void* hs, void* cs, int N,
                                          int Tn, int Ep, int Kx, int KW, int H, int rows,
                                          void* stream) {
  using B16 = __nv_bfloat16;
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  return layer_fwd_resident({(const B16*)x, mask, (const B16*)w, b, (const B16*)h0c, h, c,
                             (B16*)hs, (B16*)cs, N, Tn, Ep, Kx, KW, H},
                            rows, (cudaStream_t)stream);
}

// The resident route's clusters that the current device runs at once for a
// layer of Tn steps, Kx (E padded to 64) and H units
// (cudaOccupancyMaxActiveClusters at the whole shared memory a block; a
// block takes an SM at any R); 0 where the layer does not fit the resident
// kernel (H past 512, whose W_h slice the registers cannot hold, or no room
// for one ring stage beside W_x's slice at 64 rows); minus a cudaError_t
// value on a bad shape or a CUDA error.
extern "C" int vd_lstm_resident_clusters(int Kx, int H, int Tn) {
  if (H < 1 || Kx < 64 || Kx % 64 != 0 || Tn < 1) return -(int)cudaErrorInvalidValue;
  if (H > kResMaxH ||
      res_stages(kResMaxRows, Kx / 64, (H + kResUnits - 1) / kResUnits, Tn) < 1)
    return 0;
  cudaError_t e = resident_attrs<kResMaxRows>();
  int n = 0;
  if (e == cudaSuccess) {
    cudaLaunchAttribute cl;
    const cudaLaunchConfig_t cfg =
        resident_config(kResMaxRows, kResMaxRows, H, kResSmem, nullptr, &cl);
    e = cudaOccupancyMaxActiveClusters(&n, lstm_fwd_step_kernel_resident<kResMaxRows>, &cfg);
  }
  return e == cudaSuccess ? n : -(int)e;
}
