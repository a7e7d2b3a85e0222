// Masked slot attention, alone (K3) and with the fusion tail (K4), for
// Hopper (sm_90a).
//
// K3, attention_kernel, replaces the TPU kernel
// visdial_tpu/ops/attention_pallas.py::_attention_kernel (wrapper
// masked_slot_attention_pallas), the MN encoder's attention in training:
//   scores_rs = q_r . slot_s          (unscaled; -1e30 where valid == 0)
//   att_r     = softmax(scores_r)     (max-subtracted; an all-masked row gets
//                                      uniform weights, as the plain version
//                                      does; the TPU wrapper pads with valid
//                                      rows instead)
//   out_r     = sum_s att_rs slot_s   (f32 math, out in T, float or bf16)
// No backward kernel: the TPU kernel has none either (its vjp goes through
// the plain twin).
//
// K4 replaces _attention_fusion_kernel (wrapper attention_fusion_pallas),
// the eval-time tail of the MN encoder: mem = K3's out (rounded to T), then
//   out = tanh(q . Wf[:H] + mem . Wf[H:] + b)
// with q, mem and Wf in T, f32 accumulation, out in T.  Few rows (a served
// request) take one launch, fusion_stream_kernel; many rows (an eval batch)
// two: attention_kernel writes mem to a scratch buffer, then
// fusion_tiles_kernel runs the product on the tensor cores.
//
// What bounds them on this card.  K3 at the training batch (B, R, S, H =
// 32, 10, 10, 512) moves 1.98 MB in f32 (0.59 us at 3.35 TB/s) and does
// 6.6 MFLOP: bytes, and below them the latency of a few dependent steps
// (load, scores, a softmax, the weighted sum).  K4's product is (B R) x 2H x
// H: at one served request (10 rows) it is Wf's 2 MB, read once (0.65 us),
// spread over the card; at an eval batch (320 rows, 0.34 GFLOP) the
// operations bound it (2.07 us in f32 at 3xTF32's 165 TFLOP/s, 0.34 us in
// bf16).
//
// What the design does about it.
//  * K3 reads each dialog's slots once.  A cluster of CL blocks takes one
//    dialog (CL so that B CL reaches 256 blocks, at most 8: 8 at B = 32;
//    ops/attention_cuda.py::attention_blocks), each block H / CL of its
//    columns: the block copies its columns of the dialog's S x H slots and
//    R x H queries into shared memory with 16-byte cp.async (the mask
//    lands meanwhile), computes the R x S partial scores over them (a
//    thread a (r, s) pair, 16-byte shared reads), and the
//    cluster adds the CL partials in rank order through distributed shared
//    memory, so every block holds the same scores and no atomics run.  Each
//    block then takes the softmax (a warp a row) and writes its own columns
//    of the output, 16 bytes a thread.  The old design (a block per (b, r)
//    row) read a dialog's slots 2R times.  What is left is latency: ~5 us a
//    launch at any batch (PERF.md), against 0.59 us of bytes.
//  * K4 shares K3's code: cluster_attention, K3's kernel body, is a device
//    function over a group of dialogs.
//  * Few rows (serving; ops/attention_cuda.py::fusion_route): Wf is read
//    once a call, spread over 128 blocks, in one launch
//    (fusion_stream_kernel, where vd_fusion_stream_fits).  A cluster of CL
//    blocks takes 32 output columns; its block `rank` takes columns [c0,
//    c0 + cols) of H: it copies Wf's rows c0.. and H + c0.. of those 32
//    columns (f32, 16 bytes a copy;
//    rounded to T in shared memory) while cluster_attention computes every
//    dialog's attention over the same columns, and so holds every row's
//    slice of [q; mem] (the staged queries and mem's columns) in shared
//    memory.  It computes all rows from its slice of Wf (a lane a column);
//    the CL partial sums meet in rank order through distributed shared
//    memory, and the tanh epilogue is spread over the cluster by row.  Each
//    cluster repeats the attention (a few KFLOP a row) so that no launch
//    waits on another.  The old design read all of Wf once per row.
//  * Many rows (eval batches): the product runs on the tensor cores,
//    common.cuh::tile_product over [q; mem] (a0 = q, a1 = mem) against Wf^T,
//    packed K-major per call by the wrapper (H, 2 Hp), each half padded to a
//    whole k-tile; bf16 wgmma, 3xTF32 with round-to-nearest k-tile sums for
//    f32 (fusion_tiles_kernel).  64 x 64 tiles give 40 at 320 rows, so the
//    k-tiles are split over a cluster of KS blocks (4 in f32, 8 in bf16;
//    ops/attention_cuda.py::fusion_splits) whose staged accumulators meet
//    in rank order as above.  mem goes through a scratch buffer (655 KB at
//    320 rows in f32, in L2): building a row tile's mem in shared memory
//    would need 128 KB for the mem half of a 64-row f32 tile beside the
//    ring.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using vd::cluster_arrive;
using vd::cluster_wait;
using vd::from_f;
using vd::Operand;
using vd::to_f;
using vd::warp_max;
using vd::warp_sum;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSlots = 64;
constexpr int kMaxCluster = 8;       // the portable cluster size
constexpr int kMaxSmem = 232448;     // shared memory a block may use
constexpr float kNegInf = -1e30f;
// K4's few-rows route: a cluster's output columns (a lane each)
constexpr int kStreamCols = 32;
// K4's tensor-core route: tiles and ring stages
constexpr int kTileM = 64, kTileN = 64, kTileStages = 3;

// Programmatic dependent launch: a kernel launched with
// cudaLaunchAttributeProgrammaticStreamSerialization may start once every
// block of the kernel before it has called launch_dependents(); its
// grid_dependency_wait() returns once that kernel has finished and its
// writes are visible.
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
// 16 bytes of T (4 f32 or 8 bf16 values) as floats, and back
template <typename T> struct Vec {
  static constexpr int N = 16 / sizeof(T);
};
template <typename T>
__device__ __forceinline__ void unpack16(uint4 v, float (&f)[Vec<T>::N]) {
  if constexpr (std::is_same<T, float>::value) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  } else {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
}
template <typename T>
__device__ __forceinline__ uint4 pack16(const float (&f)[Vec<T>::N]) {
  uint4 v;
  if constexpr (std::is_same<T, float>::value) {
    v = make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                   __float_as_uint(f[3]));
  } else {
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  }
  return v;
}

// The sum over the cluster's n blocks, in rank order, of p[i] in each one's
// shared memory, the remote loads issued together (the same value in every
// block that asks).
__device__ __forceinline__ float cluster_sum(cg::cluster_group cluster, float* p,
                                             int i, int n) {
  float v[kMaxCluster];
#pragma unroll
  for (int j = 0; j < kMaxCluster; ++j) v[j] = j < n ? cluster.map_shared_rank(p, j)[i] : 0.f;
  float d = v[0];
#pragma unroll
  for (int j = 1; j < kMaxCluster; ++j)
    if (j < n) d += v[j];
  return d;
}

// ---------------------------------------------------------------------------
// The attention of a group of dialogs on one cluster (K3, and K4's prologue)

// Shared memory of cluster_attention, byte offsets: the block's columns of
// the group's slots (nb S rows) and queries (nb R rows) in T, each row `ld`
// values (the block's columns rounded up to 16 bytes, plus 16 bytes that
// spread a warp's rows over the banks), then the partial and the final
// scores (nb R x S f32 each); `bytes` is rounded up to 16.
struct AttnSmem {
  int ld, qs, part, sc, bytes;
};
__host__ __device__ __forceinline__ AttnSmem attn_smem(int nb, int R, int S, int cols,
                                                       int tsize) {
  const int v = 16 / tsize;
  AttnSmem L;
  L.ld = (cols + v - 1) / v * v + v;
  L.qs = nb * S * L.ld * tsize;
  L.part = L.qs + nb * R * L.ld * tsize;
  L.sc = L.part + nb * R * S * 4;
  L.bytes = (L.sc + nb * R * S * 4 + 15) / 16 * 16;
  return L;
}

// rows x nc values of T from global src (row stride H) into shared dst (row
// stride ld), zeros from column nc to the next multiple of 16 bytes: whole
// 16-byte chunks by cp.async where vec, the rest value by value
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* __restrict__ src, int rows,
                                           int H, int nc, int ld, bool vec) {
  constexpr int V = Vec<T>::N;
  const int nch = (nc + V - 1) / V;
  for (int i = threadIdx.x; i < rows * nch; i += kThreads) {
    const int r = i / nch, k = (i % nch) * V;
    T* d = dst + r * ld + k;
    const T* s = src + (size_t)r * H + k;
    if (vec && k + V <= nc) {
      vd::cp_async16(vd::smem_u32(d), s, 16);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) d[e] = k + e < nc ? s[e] : from_f<T>(0.f);
    }
  }
}

// The attention of dialogs [b0, b0 + nb) over block `rank`'s columns
// [rank cols, rank cols + cols) of H, in a cluster whose blocks split H so:
// stages those columns of the group's slots and queries at smem (AttnSmem;
// the mask lands meanwhile), computes the nb R x S partial scores over them
// (a thread a (row, slot) pair, 16-byte shared reads), adds the cluster's
// partials in rank order through distributed shared memory (the same sum in
// every block; no atomics), masks (valid[b vb + r vr + s] is 1.0 where slot
// s is visible to round r; vb = 0: one mask for every dialog), takes each
// row's softmax (a warp a row), and hands the weighted slot sums over the
// block's columns, 16 bytes of columns at a time, to emit(m, k, sums) (row
// m of the group, column rank cols + k; columns past H sum zeros).  Every
// thread of every block of the cluster calls it; it leaves the staged
// queries in shared memory.
template <typename T, typename Emit>
__device__ __forceinline__ void cluster_attention(
    cg::cluster_group cluster, unsigned char* smem, const T* __restrict__ q,
    const T* __restrict__ slots, const float* __restrict__ valid, long long vb,
    long long vr, int b0, int nb, int R, int S, int H, int cols, bool vec, Emit emit) {
  constexpr int V = Vec<T>::N;
  const int CL = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const AttnSmem L = attn_smem(nb, R, S, cols, sizeof(T));
  T* sl = reinterpret_cast<T*>(smem);
  T* qs = reinterpret_cast<T*>(smem + L.qs);
  float* part = reinterpret_cast<float*>(smem + L.part);
  float* sc = reinterpret_cast<float*>(smem + L.sc);
  const int c0 = rank * cols;
  const int nc = max(0, min(cols, H - c0));    // the block's real columns
  const int nk = (nc + V - 1) / V * V;         // ... zero-padded to 16 bytes
  const int M = nb * R, P = M * S;

  // 1. the block's columns of the group's slots and queries, and the mask
  // (into sc) while they land
  stage_rows(sl, slots + (size_t)b0 * S * H + c0, nb * S, H, nc, L.ld, vec);
  stage_rows(qs, q + (size_t)b0 * R * H + c0, M, H, nc, L.ld, vec);
  vd::cp_async_commit();
  for (int p = tid; p < P; p += kThreads) {
    const int m = p / S;
    sc[p] = valid[(b0 + m / R) * vb + (m % R) * vr + p % S];
  }
  vd::cp_async_wait<0>();
  __syncthreads();

  // 2. partial scores over those columns, a thread a (row, slot) pair
  for (int p = tid; p < P; p += kThreads) {
    const int m = p / S;
    const T* qr = qs + m * L.ld;
    const T* sr = sl + ((m / R) * S + p % S) * L.ld;
    float d = 0.f;
#pragma unroll 4
    for (int k = 0; k < nk; k += V) {
      float a[V], c[V];
      unpack16<T>(*reinterpret_cast<const uint4*>(qr + k), a);
      unpack16<T>(*reinterpret_cast<const uint4*>(sr + k), c);
#pragma unroll
      for (int e = 0; e < V; ++e) d = fmaf(a[e], c[e], d);
    }
    part[p] = d;
  }
  cluster.sync();

  // 3. a warp a row: the cluster's partials of its S <= 64 scores added in
  // rank order, masked, and their softmax
  const int lane = tid % 32;
  for (int m = tid / 32; m < M; m += kWarps) {
    float* row = sc + m * S;
    float v[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int s = lane + 32 * h;
      v[h] = kNegInf;
      if (s < S) {
        const float d = cluster_sum(cluster, part, m * S + s, CL);
        if (row[s] > 0.f) v[h] = d;
      }
    }
    const float mx = warp_max(fmaxf(v[0], v[1]));
    const float e0 = lane < S ? expf(v[0] - mx) : 0.f;
    const float e1 = lane + 32 < S ? expf(v[1] - mx) : 0.f;
    const float inv = 1.f / warp_sum(e0 + e1);
    if (lane < S) row[lane] = e0 * inv;
    if (lane + 32 < S) row[lane + 32] = e1 * inv;
  }
  cluster_arrive();   // this block has read its peers' partials
  __syncthreads();

  // 5. sum_s att_ms slot_s[k], 16 bytes of columns a thread
  const int nch = nk / V;
  for (int i = tid; i < M * nch; i += kThreads) {
    const int m = i / nch, k = (i % nch) * V;
    const float* att = sc + m * S;
    const T* sb = sl + (m / R) * S * L.ld + k;
    float sum[V];
#pragma unroll
    for (int e = 0; e < V; ++e) sum[e] = 0.f;
#pragma unroll 4
    for (int s = 0; s < S; ++s) {
      float c[V];
      unpack16<T>(*reinterpret_cast<const uint4*>(sb + s * L.ld), c);
      const float a = att[s];
#pragma unroll
      for (int e = 0; e < V; ++e) sum[e] = fmaf(a, c[e], sum[e]);
    }
    emit(m, k, sum);
  }
  cluster_wait();     // every block has read the partials (ours among them)
}

// K3: one dialog a cluster.  Grid: B CL blocks, clusters of CL (blocks a
// dialog); kThreads threads; dynamic shared memory attn_smem(1, R, S, cols).
// Also K4's prologue on its tensor-core route, where out is mem's scratch.
template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_kernel(const T* __restrict__ q, const T* __restrict__ slots,
                 const float* __restrict__ valid, long long vb, long long vr,
                 T* __restrict__ out, int R, int S, int H, int cols, int vec) {
  constexpr int V = Vec<T>::N;
  launch_dependents();   // K4's product may start copying Wf
  extern __shared__ __align__(16) unsigned char smem[];
  const cg::cluster_group cluster = cg::this_cluster();
  const int b = blockIdx.x / (int)cluster.num_blocks();
  const int c0 = (int)cluster.block_rank() * cols, nc = max(0, min(cols, H - c0));
  T* ob = out + (size_t)b * R * H + c0;
  cluster_attention<T>(cluster, smem, q, slots, valid, vb, vr, b, 1, R, S, H, cols,
                       vec != 0, [&](int m, int k, const float (&sum)[V]) {
                         T* o = ob + (size_t)m * H + k;
                         if (vec && k + V <= nc) {
                           *reinterpret_cast<uint4*>(o) = pack16<T>(sum);
                         } else {
#pragma unroll
                           for (int e = 0; e < V; ++e)
                             if (k + e < nc) o[e] = from_f<T>(sum[e]);
                         }
                       });
}

// ---------------------------------------------------------------------------
// K4, few rows, one launch: Wf streamed once a call

// Four values of T at p (8-byte aligned for bf16, 16 for f32) as floats
template <typename T> __device__ __forceinline__ float4 load4(const T* p) {
  if constexpr (std::is_same<T, float>::value) {
    return *reinterpret_cast<const float4*>(p);
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
}

// Grid (CL, ceil(H / 32)), clusters of CL along x; kThreads threads.
// Cluster n computes output columns [32 n, 32 n + 32) of all M = B R rows.
// Its block `rank` takes columns [c0, c0 + cols) of H, c0 = rank cols: the
// attention of every dialog over them (cluster_attention), whose staged
// query columns and mem columns (rounded to T) are the block's slice of
// [q; mem], and against it rows [c0, c0 + cols) and [H + c0, H + c0 + cols)
// of Wf (2H, H) f32.  Shared memory after cluster_attention's (attn_smem(B,
// R, S, cols)): those rows of Wf's 32 columns (2 cols x 32 f32), mem's
// columns (M x ld in T), the block's partial sums (M x 32 f32).  vec: H is a
// whole number of 16-byte chunks of T, and q, slots and wf are 16-byte
// aligned.
template <typename T>
__global__ void __launch_bounds__(kThreads)
fusion_stream_kernel(const T* __restrict__ q, const T* __restrict__ slots,
                     const float* __restrict__ valid, long long vb, long long vr,
                     const float* __restrict__ wf, const float* __restrict__ bias,
                     T* __restrict__ out, int B, int R, int S, int H, int cols, int vec) {
  constexpr int V = Vec<T>::N, WC = kStreamCols / 4;   // 16-byte chunks a Wf row
  extern __shared__ __align__(16) unsigned char smem[];
  const cg::cluster_group cluster = cg::this_cluster();
  const int CL = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int M = B * R, j0 = blockIdx.y * kStreamCols;
  const int c0 = rank * cols, nc = max(0, min(cols, H - c0));
  const int nk = (nc + V - 1) / V * V;
  const AttnSmem L = attn_smem(B, R, S, cols, sizeof(T));
  float* ws = reinterpret_cast<float*>(smem + L.bytes);
  T* ms = reinterpret_cast<T*>(ws + 2 * cols * kStreamCols);
  float* ps = reinterpret_cast<float*>(ms + M * L.ld);

  // 1. the block's rows of Wf: row i < cols is Wf row c0 + i (q's half),
  // row cols + i is Wf row H + c0 + i (mem's); they land with the attention's
  // copies
  for (int i = tid; i < 2 * cols * WC; i += kThreads) {
    const int r = i / WC, c = (i % WC) * 4, kr = r % cols;
    float* d = ws + r * kStreamCols + c;
    const float* s = wf + (size_t)((r < cols ? 0 : H) + c0 + kr) * H + j0 + c;
    if (vec && kr < nc && j0 + c + 4 <= H) {
      vd::cp_async16(vd::smem_u32(d), s, 16);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) d[e] = kr < nc && j0 + c + e < H ? __ldg(s + e) : 0.f;
    }
  }

  // 2. the attention of every dialog over the block's columns: mem's columns
  // into ms, rounded to T
  cluster_attention<T>(cluster, smem, q, slots, valid, vb, vr, 0, B, R, S, H, cols,
                       vec != 0, [&](int m, int k, const float (&sum)[V]) {
#pragma unroll
                         for (int e = 0; e < V; ++e) ms[m * L.ld + k + e] = from_f<T>(sum[e]);
                       });
  __syncthreads();
  if constexpr (!std::is_same<T, float>::value) {   // Wf in T, as the plain version
    for (int i = tid; i < 2 * cols * kStreamCols; i += kThreads) ws[i] = to_f(from_f<T>(ws[i]));
    __syncthreads();
  }

  // 3. the block's partial sums over its slice of [q; mem]: lane = column,
  // warp w rows w, w + 8, ..., four at a time, each Wf value read once for
  // the four
  const T* qs = reinterpret_cast<const T*>(smem + L.qs);
  for (int m0 = warp; m0 < M; m0 += 4 * kWarps) {
    int row[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) row[i] = min(m0 + i * kWarps, M - 1) * L.ld;
    // two chains a row (even and odd k), so that the FMA latency is not the
    // whole of the loop
    float acc[4][2] = {};
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const T* x = half == 0 ? qs : ms;
      const float* w = ws + half * cols * kStreamCols + lane;
#pragma unroll 4
      for (int k = 0; k < nk; k += 4) {
        const float w0 = w[k * kStreamCols], w1 = w[(k + 1) * kStreamCols];
        const float w2 = w[(k + 2) * kStreamCols], w3 = w[(k + 3) * kStreamCols];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 v = load4(x + row[i] + k);
          acc[i][0] = fmaf(v.x, w0, acc[i][0]);
          acc[i][1] = fmaf(v.y, w1, acc[i][1]);
          acc[i][0] = fmaf(v.z, w2, acc[i][0]);
          acc[i][1] = fmaf(v.w, w3, acc[i][1]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (m0 + i * kWarps < M)
        ps[(m0 + i * kWarps) * kStreamCols + lane] = acc[i][0] + acc[i][1];
  }
  cluster.sync();

  // 4. the blocks' sums in rank order, tanh: block `rank` takes rows m
  // with m % CL == rank; a thread keeps one column (kThreads is a multiple
  // of 32) and every kWarps-th of those rows
  const int c = lane, j = j0 + c;
  if (j < H) {
    const float bj = bias[j];
#pragma unroll 2
    for (int m = rank + CL * warp; m < M; m += CL * kWarps) {
      const float pre = cluster_sum(cluster, ps, m * kStreamCols + c, CL);
      out[(size_t)m * H + j] = from_f<T>(tanhf(pre + bj));
    }
  }
  cluster_arrive();
  cluster_wait();
}

// ---------------------------------------------------------------------------
// K4's product, many rows: tile_product on the tensor cores

// Grid (KS, ceil(H / BN), ceil(M / BM)), clusters of KS along x; BM * 2
// threads.  wk is Wf^T packed (H, 2 Hp): wk[j, k] = Wf[k, j] and wk[j, Hp +
// k] = Wf[H + k, j] for k < H, zeros elsewhere; Hp is H rounded up to a
// whole k-tile.  Block rank takes k-tiles [t0, t1) of the 2 Hp / BK, where
// the first Hp / BK read q and the rest mem.
template <typename T, int BM, int BN, int STAGES>
__global__ void __launch_bounds__(BM * 2)
fusion_tiles_kernel(const T* __restrict__ q, const T* __restrict__ mem,
                    const T* __restrict__ wk, const float* __restrict__ bias,
                    T* __restrict__ out, int M, int H, int Hp) {
  using L = vd::TileSmem<T, BM, BN, STAGES>;
  constexpr int BK = vd::TileK<T>::BK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = vd::align1024(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int KS = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int nkh = Hp / BK, nkt = 2 * nkh;
  const int t0 = rank * nkt / KS, t1 = (rank + 1) * nkt / KS;
  const int n0 = blockIdx.y * BN, m0 = blockIdx.z * BM;
  // the k-tiles' A: q from k-tile t0 (a0), then mem from its start (a1); or
  // mem from k-tile t0 - nkh alone
  const bool in_q = t0 < nkh;
  const int ka = (in_q ? t0 : t0 - nkh) * BK;
  const Operand<T> a0{(in_q ? q : mem) + ka, H, M, H - ka};
  const Operand<T> a1{mem, H, M, H};
  const int nk0 = (in_q ? min(t1, nkh) : t1) - t0;
  const Operand<T> b{wk + (size_t)t0 * BK, 2LL * Hp, H, (t1 - t0) * BK};

  if (t1 > nkh) grid_dependency_wait();   // mem is the attention launch's output
  float acc[BN / 2];
  vd::tile_product<T, BM, BN, STAGES>(acc, smem, a0, nk0, a1, b, t1 - t0, m0, n0);
  float* c = reinterpret_cast<float*>(smem);
  vd::stage_acc<BN, L::LDC>(acc, c);
  cluster.sync();

  // the k-slices' sums in rank order, tanh: block `rank` takes the tile's
  // rows with row % KS == rank (KS divides BM); a thread keeps one column
  // (BM * 2 is a multiple of BN) and every (BM * 2 / BN)-th of those rows
  static_assert((BM * 2) % BN == 0, "a thread keeps its column");
  const int col = threadIdx.x % BN, j = n0 + col;
  if (j < H) {
    const float bj = bias[j];
#pragma unroll 4
    for (int row = rank + KS * (threadIdx.x / BN); row < BM; row += KS * (BM * 2 / BN)) {
      if (m0 + row >= M) break;
      const float pre = cluster_sum(cluster, c, row * L::LDC + col, KS);
      out[(size_t)(m0 + row) * H + j] = from_f<T>(tanhf(pre + bj));
    }
  }
  cluster_arrive();
  cluster_wait();
}

// ---------------------------------------------------------------------------
// Launches

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// A launch in clusters of `cluster` blocks along x; `dependent` lets it start
// before the launch ahead of it in the stream has finished (that kernel
// calls launch_dependents, this one grid_dependency_wait).
template <typename... Params, typename... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), dim3 grid, int threads, int smem,
                           int cluster, bool dependent, cudaStream_t stream,
                           Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = dependent ? 2 : 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The columns of H each of a cluster's cl blocks takes: a whole number of
// 16-byte chunks of T
template <typename T> int block_cols(int H, int cl) {
  constexpr int V = Vec<T>::N;
  return ((H + V - 1) / V + cl - 1) / cl * V;
}

template <typename T>
cudaError_t launch_attention(const void* q, const void* slots, const float* valid,
                             long long vb, long long vr, void* out, int B, int R, int S,
                             int H, int cl, cudaStream_t stream) {
  const int cols = block_cols<T>(H, cl);
  const AttnSmem L = attn_smem(1, R, S, cols, sizeof(T));
  if (L.bytes > kMaxSmem) return cudaErrorInvalidValue;
  const auto kernel = attention_kernel<T>;
  const cudaError_t attr = vd::allow_smem<attention_kernel<T>, kMaxSmem>();
  if (attr != cudaSuccess) return attr;
  const bool vec = H % Vec<T>::N == 0 && aligned16(q) && aligned16(slots) && aligned16(out);
  return launch_cluster(kernel, dim3(B * cl), kThreads, L.bytes, cl, false, stream,
                        (const T*)q, (const T*)slots, valid, vb, vr, (T*)out, R, S, H,
                        cols, (int)vec);
}

// The few-rows route's shared memory a block, for clusters of cl blocks
// (fusion_stream_kernel lays it out)
template <typename T> long long stream_smem(int B, int R, int S, int H, int cl) {
  // each slot and query row takes at least 16 bytes: past this, no plan fits
  if ((long long)B * (S + R) > kMaxSmem) return kMaxSmem + 1LL;
  const int cols = block_cols<T>(H, cl);
  const AttnSmem L = attn_smem(B, R, S, cols, sizeof(T));
  const long long M = (long long)B * R;
  return L.bytes + 2LL * cols * kStreamCols * 4 + M * L.ld * sizeof(T) + M * kStreamCols * 4;
}

template <typename T>
cudaError_t launch_stream(const void* q, const void* slots, const float* valid,
                          long long vb, long long vr, const float* wf, const float* bias,
                          void* out, int B, int R, int S, int H, int cl,
                          cudaStream_t stream) {
  const long long smem = stream_smem<T>(B, R, S, H, cl);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const auto kernel = fusion_stream_kernel<T>;
  const cudaError_t attr = vd::allow_smem<fusion_stream_kernel<T>, kMaxSmem>();
  if (attr != cudaSuccess) return attr;
  const bool vec = H % Vec<T>::N == 0 && aligned16(q) && aligned16(slots) && aligned16(wf);
  return launch_cluster(kernel, dim3(cl, (H + kStreamCols - 1) / kStreamCols), kThreads,
                        (int)smem, cl, false, stream, (const T*)q, (const T*)slots, valid,
                        vb, vr, wf, bias, (T*)out, B, R, S, H, block_cols<T>(H, cl),
                        (int)vec);
}

template <typename T>
cudaError_t launch_tiles(const void* q, const void* mem, const void* wk, const float* bias,
                         void* out, int M, int H, int ks, cudaStream_t stream) {
  using L = vd::TileSmem<T, kTileM, kTileN, kTileStages>;
  constexpr int BK = vd::TileK<T>::BK;
  const int Hp = (H + BK - 1) / BK * BK;
  const int tiles_m = (M + kTileM - 1) / kTileM, tiles_n = (H + kTileN - 1) / kTileN;
  if (tiles_m > 65535 || ks > 2 * Hp / BK) return cudaErrorInvalidValue;
  const auto kernel = fusion_tiles_kernel<T, kTileM, kTileN, kTileStages>;
  const cudaError_t attr =
      vd::allow_smem<fusion_tiles_kernel<T, kTileM, kTileN, kTileStages>, kMaxSmem>();
  if (attr != cudaSuccess) return attr;
  return launch_cluster(kernel, dim3(ks, tiles_n, tiles_m), kTileM * 2, L::BYTES, ks, true,
                        stream, (const T*)q, (const T*)mem, (const T*)wk, bias, (T*)out, M,
                        H, Hp);
}

template <typename T>
cudaError_t launch_fusion(int route, const void* q, const void* slots, const float* valid,
                          long long vb, long long vr, const void* w, const float* bias,
                          void* mem, void* out, int B, int R, int S, int H, int cl, int ks,
                          cudaStream_t stream) {
  if (route == 0)
    return launch_stream<T>(q, slots, valid, vb, vr, (const float*)w, bias, out, B, R, S, H,
                            cl, stream);
  const cudaError_t err =
      launch_attention<T>(q, slots, valid, vb, vr, mem, B, R, S, H, cl, stream);
  if (err != cudaSuccess) return err;
  return launch_tiles<T>(q, mem, w, bias, out, B * R, H, ks, stream);
}

bool cluster_ok(int n) { return n >= 1 && n <= kMaxCluster; }

}  // namespace

// K4.  dtype 0 = float32, 1 = bfloat16 for q (B, R, H), slots (B, S, H),
// mem (B, R, H) and out (B, R, H); valid f32, element (b, r, s) at b vb + r
// vr + s; bias (H,) f32.  route 0 (few rows, one launch, where
// vd_fusion_stream_fits): w is Wf (2H, H) f32, mem is not used, cl blocks a
// cluster split H; route 1 (tensor cores, two launches): w is Wf^T packed in
// the dtype as ops/attention_cuda.py::pack_fusion_weight packs it, (H, 2 Hp),
// mem is scratch, the attention takes cl blocks a dialog and the product ks
// k-slices (blocks a cluster, at most the product's k-tiles).  cl and ks are
// 1 to 8, chosen by ops/attention_cuda.py.  Returns a cudaError_t value (0 on
// success).
extern "C" int vd_attention_fusion(int dtype, int route, const void* q, const void* slots,
                                   const float* valid, long long vb, long long vr,
                                   const void* w, const float* bias, void* mem, void* out,
                                   int B, int R, int S, int H, int cl, int ks, void* stream) {
  if (S < 1 || S > kMaxSlots || B < 1 || R < 1 || H < 1 || (route != 0 && route != 1) ||
      !cluster_ok(cl) || (route == 1 && !cluster_ok(ks)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch_fusion<float>(route, q, slots, valid, vb, vr, w, bias, mem, out, B,
                                     R, S, H, cl, ks, s);
  if (dtype == 1)
    return (int)launch_fusion<__nv_bfloat16>(route, q, slots, valid, vb, vr, w, bias, mem,
                                             out, B, R, S, H, cl, ks, s);
  return (int)cudaErrorInvalidValue;
}

// 1 where K4's few-rows route (route 0) with clusters of cl blocks fits a
// block's shared memory at this shape, else 0: the route's one size rule.
extern "C" int vd_fusion_stream_fits(int dtype, int B, int R, int S, int H, int cl) {
  if (S < 1 || S > kMaxSlots || B < 1 || R < 1 || H < 1 || !cluster_ok(cl) ||
      (dtype != 0 && dtype != 1))
    return 0;
  const long long smem = dtype == 0 ? stream_smem<float>(B, R, S, H, cl)
                                    : stream_smem<__nv_bfloat16>(B, R, S, H, cl);
  return smem <= kMaxSmem;
}

// K3.  dtype 0 = float32, 1 = bfloat16 for q (B, R, H), slots (B, S, H) and
// out (B, R, H); valid f32, element (b, r, s) at b vb + r vr + s; cl: the
// blocks a dialog (1 to 8, chosen by ops/attention_cuda.py::attention_blocks).
// Returns a cudaError_t value.
extern "C" int vd_attention(int dtype, const void* q, const void* slots,
                            const float* valid, long long vb, long long vr, void* out,
                            int B, int R, int S, int H, int cl, void* stream) {
  if (S < 1 || S > kMaxSlots || B < 1 || R < 1 || H < 1 || !cluster_ok(cl))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch_attention<float>(q, slots, valid, vb, vr, out, B, R, S, H, cl, s);
  if (dtype == 1)
    return (int)launch_attention<__nv_bfloat16>(q, slots, valid, vb, vr, out, B, R, S, H,
                                                cl, s);
  return (int)cudaErrorInvalidValue;
}
