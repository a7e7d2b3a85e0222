// Masked slot attention, alone (K3) and with the fusion tail (K4), for
// Hopper (sm_90a), CUDA-core FMAs.
//
// K3, attention_kernel, replaces the TPU kernel
// visdial_tpu/ops/attention_pallas.py::_attention_kernel (wrapper
// masked_slot_attention_pallas), the MN encoder's attention in training:
// out = sum_s att_s slot_s, the weights computed as below, f32 math, out
// in T.  A block per (b, r) row reads the row's S <= 64 slots (a few KFLOP,
// 20 KB at S = 10, H = 512); at the training batch of 320 rows the call is
// bound by launch latency and the slots' reads.  No batch padding: an
// all-masked row gets uniform weights, as the plain version does (the TPU
// wrapper pads with valid rows to avoid NaN).  No backward kernel: the
// TPU kernel has none either (its vjp goes through the plain twin).
//
// K4, attention_fusion_kernel, replaces the TPU kernel
// visdial_tpu/ops/attention_pallas.py::_attention_fusion_kernel (wrapper
// attention_fusion_pallas), the eval-time tail of the MN encoder:
//   scores_s = q . slot_s             (unscaled; -1e30 where valid == 0)
//   att      = softmax(scores)        (max-subtracted; an all-masked row
//                                      gets uniform weights, as the plain
//                                      version does)
//   mem      = sum_s att_s slot_s     (f32, then rounded to the type T)
//   out      = tanh(q . Wf[:H] + mem . Wf[H:] + b)
// with q, slots and Wf in T (float or bf16), f32 accumulation, out in T.
//
// What bounds it on this card.  Per (b, r) row the attention is S <= 64 dot
// products of length H, a few KFLOP.  The fusion product reads all of Wf,
// (2H, H) in T, 1-4 MB, for each row; the rows of one call share it through
// the L2.  At serving size (B*R = 10 rows) the bound is how fast the blocks
// can pull Wf: one SM alone reads it at a small fraction of the L2's rate
// (one block per row measured ~0.17 ms a call on an H100), so the product
// has to be spread over many SMs.  At larger batches L2 bandwidth bounds it.
//
// What the design does about it.  A block per (b, r) row and per JB-wide
// slice of the output columns (grid B*R x ceil(H/JB)), so a serving call
// runs 80 blocks, each reading a 2H x JB slice of Wf.  Every column block
// recomputes its row's attention, which costs far less than its Wf slice.
// No batch padding (the TPU wrapper pads B to its 8-row tile; here ragged
// edges do not exist).  Warps compute the S scores with shuffle reductions,
// one warp takes the softmax, and q and mem live in shared memory as the f32
// vector in = [q; mem].  In the product a thread owns one column j (loads
// of a row of Wf are coalesced across the warp) and a quarter of the
// 2H-deep contraction; the KG partial sums meet in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using vd::from_f;
using vd::to_f;
using vd::warp_max;
using vd::warp_sum;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSlots = 64;
constexpr int KG = 4;                  // contraction groups in the fusion product
constexpr int JB = kThreads / KG;      // output columns per block
constexpr float kNegInf = -1e30f;

// Attention weights of one (b, r) row over its S slots into att[0:S]: masked
// unscaled scores, then a max-subtracted softmax.  qf (shared) holds the
// query row in f32; sb points at the row's slots (S, H).  All threads of the
// block call it; it ends with a barrier.
template <typename T>
__device__ __forceinline__ void attention_weights(const float* qf,
                                                  const T* __restrict__ sb,
                                                  const float* __restrict__ vrow,
                                                  float* att, int S, int H) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  for (int s = warp; s < S; s += kWarps) {
    const T* srow = sb + (size_t)s * H;
    float d = 0.f;
    for (int k = lane; k < H; k += 32) d = fmaf(qf[k], to_f(srow[k]), d);
    d = warp_sum(d);
    if (lane == 0) att[s] = vrow[s] > 0.f ? d : kNegInf;
  }
  __syncthreads();
  if (warp == 0) {  // softmax over S <= 64 slots
    const float v0 = lane < S ? att[lane] : kNegInf;
    const float v1 = lane + 32 < S ? att[lane + 32] : kNegInf;
    const float mx = warp_max(fmaxf(v0, v1));
    const float e0 = lane < S ? expf(v0 - mx) : 0.f;
    const float e1 = lane + 32 < S ? expf(v1 - mx) : 0.f;
    const float inv = 1.f / warp_sum(e0 + e1);
    if (lane < S) att[lane] = e0 * inv;
    if (lane + 32 < S) att[lane + 32] = e1 * inv;
  }
  __syncthreads();
}

// K3.  Dynamic shared memory: qf[H].  Grid: B*R blocks.
template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_kernel(const T* __restrict__ q, const T* __restrict__ slots,
                 const float* __restrict__ valid, T* __restrict__ out, int R,
                 int S, int H) {
  extern __shared__ float qf[];
  __shared__ float att[kMaxSlots];
  const int row = blockIdx.x;     // b * R + r
  const T* sb = slots + (size_t)(row / R) * S * H;
  for (int k = threadIdx.x; k < H; k += kThreads) qf[k] = to_f(q[(size_t)row * H + k]);
  __syncthreads();
  attention_weights(qf, sb, valid + (size_t)row * S, att, S, H);
  for (int k = threadIdx.x; k < H; k += kThreads) {
    float m = 0.f;
    for (int s = 0; s < S; ++s) m = fmaf(att[s], to_f(sb[(size_t)s * H + k]), m);
    out[(size_t)row * H + k] = from_f<T>(m);
  }
}

// K4.  Dynamic shared memory: in[2H].
template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_fusion_kernel(const T* __restrict__ q, const T* __restrict__ slots,
                        const float* __restrict__ valid, const T* __restrict__ wf,
                        const float* __restrict__ bias, T* __restrict__ out,
                        int R, int S, int H) {
  extern __shared__ float in[];   // [q; mem], 2H
  __shared__ float att[kMaxSlots];
  __shared__ float part[KG][JB];

  const int row = blockIdx.x;     // b * R + r
  const int tid = threadIdx.x;
  const T* sb = slots + (size_t)(row / R) * S * H;

  for (int k = tid; k < H; k += kThreads) in[k] = to_f(q[(size_t)row * H + k]);
  __syncthreads();
  attention_weights(in, sb, valid + (size_t)row * S, att, S, H);

  // mem = att . slots, rounded to T as the fusion product's input
  for (int k = tid; k < H; k += kThreads) {
    float m = 0.f;
    for (int s = 0; s < S; ++s) m = fmaf(att[s], to_f(sb[(size_t)s * H + k]), m);
    in[H + k] = to_f(from_f<T>(m));
  }
  __syncthreads();

  // out[:, j0:j0+JB] = tanh(in . Wf[:, j0:j0+JB] + b): thread (g, jl) sums
  // column j0 + jl over group g's quarter of the 2H contraction
  const int g = tid / JB, jl = tid % JB, j = blockIdx.y * JB + jl;
  const int K = 2 * H;
  const int k_lo = (int)((long long)K * g / KG), k_hi = (int)((long long)K * (g + 1) / KG);
  float acc = 0.f;
  if (j < H) {
#pragma unroll 8
    for (int k = k_lo; k < k_hi; ++k) acc = fmaf(in[k], to_f(wf[(size_t)k * H + j]), acc);
  }
  part[g][jl] = acc;
  __syncthreads();
  if (tid < JB && j < H) {
    float pre = bias[j];
#pragma unroll
    for (int gg = 0; gg < KG; ++gg) pre += part[gg][tid];
    out[(size_t)row * H + j] = from_f<T>(tanhf(pre));
  }
}

// Opt a kernel into more than 48 KB of dynamic shared memory where needed.
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename T>
int launch_attention(const void* q, const void* slots, const float* valid,
                     void* out, int B, int R, int S, int H, cudaStream_t stream) {
  const size_t smem = (size_t)H * sizeof(float);
  const cudaError_t err = allow_smem(attention_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  attention_kernel<T><<<B * R, kThreads, smem, stream>>>(
      (const T*)q, (const T*)slots, valid, (T*)out, R, S, H);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* slots, const float* valid, const void* wf,
           const float* bias, void* out, int B, int R, int S, int H,
           cudaStream_t stream) {
  const size_t smem = (size_t)2 * H * sizeof(float);
  const cudaError_t err = allow_smem(attention_fusion_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * R, (H + JB - 1) / JB);
  attention_fusion_kernel<T><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)slots, valid, (const T*)wf, bias, (T*)out, R, S, H);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype 0 = float32, 1 = bfloat16 for q, slots, wf and out.  q (B, R, H),
// slots (B, S, H), valid (B, R, S) f32, wf (2H, H), bias (H,) f32, out
// (B, R, H).  Returns a cudaError_t value (0 on success).
extern "C" int vd_attention_fusion(int dtype, const void* q, const void* slots,
                                   const float* valid, const void* wf,
                                   const float* bias, void* out, int B, int R,
                                   int S, int H, void* stream) {
  if (S < 1 || S > kMaxSlots) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(q, slots, valid, wf, bias, out, B, R, S, H, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, slots, valid, wf, bias, out, B, R, S, H, s);
  return (int)cudaErrorInvalidValue;
}

// K3.  dtype 0 = float32, 1 = bfloat16 for q (B, R, H), slots (B, S, H) and
// out (B, R, H); valid (B, R, S) f32.  Returns a cudaError_t value.
extern "C" int vd_attention(int dtype, const void* q, const void* slots,
                            const float* valid, void* out, int B, int R, int S,
                            int H, void* stream) {
  if (S < 1 || S > kMaxSlots) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch_attention<float>(q, slots, valid, out, B, R, S, H, s);
  if (dtype == 1)
    return launch_attention<__nv_bfloat16>(q, slots, valid, out, B, R, S, H, s);
  return (int)cudaErrorInvalidValue;
}
