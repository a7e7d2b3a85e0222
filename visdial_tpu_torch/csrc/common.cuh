// Helpers shared by the port's kernels: the launchers' per-device shared-
// memory attribute, f32 <-> activation-type conversion, the logistic
// function, warp reductions, and the tensor-core tile product
// of the LSTM kernels (lstm_fwd.cu, lstm_bwd.cu) and the LM head's
// (lm_score.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace vd {

// The device ordinals the launchers track (a larger one gets
// cudaErrorInvalidDevice).
constexpr int kMaxDevices = 64;

// For each kernel and device: 0 until the kernel's dynamic shared-memory
// limit is raised there, then that attribute call's cudaError_t plus one.
// The attribute belongs to a device, so a process that launches a kernel
// on two cards sets it on each.
template <auto Kernel> inline std::atomic<int> smem_attr_state[kMaxDevices];

// Raises Kernel's dynamic shared-memory limit to Bytes on the current
// device, once a device, and returns that call's error on every later call
// too (the launchers return it to the wrapper, which raises).  After the
// first call a launch pays one atomic load; two threads that race to the
// first call both set the same attribute, which is harmless.
template <auto Kernel, int Bytes> cudaError_t allow_smem() {
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::atomic<int>& state = smem_attr_state<Kernel>[dev];
  int s = state.load(std::memory_order_acquire);
  if (s == 0) {
    s = 1 + (int)cudaFuncSetAttribute((const void*)Kernel,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, Bytes);
    state.store(s, std::memory_order_release);
  }
  return (cudaError_t)(s - 1);
}

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

// ---------------------------------------------------------------------------
// The tensor-core tile product (Hopper wgmma), shared by K1, both phases of
// K2, K5 and K6:  acc = A[m0:m0+BM, :K] . B[n0:n0+BN, :K]^T, f32
// accumulation.
//
// Both operands are K-major (a row holds its K values contiguously), the
// only layout wgmma takes for tf32.  K is walked in k-tiles of 128 bytes
// (64 bf16 or 32 f32 values); a k-tile of a BM- or BN-row operand lands in
// shared memory as rows of 128 bytes with the 16-byte chunks of row r
// permuted by chunk ^ (r % 8), the 128-byte swizzle that wgmma's descriptor
// names (layout 1), so that both the 16-byte cp.async writes of a row and
// wgmma's reads are free of bank conflicts.  A ring of STAGES k-tiles keeps
// up to STAGES - 1 copies in flight while the tensor cores work.
//
// bf16: wgmma m64nBNk16, bf16 x bf16 -> f32, the TPU kernel's numerics.
// f32: 3xTF32.  Each operand is split into a TF32 high part and the
// remainder rounded to TF32 (each off by at most 2^-22 of the value), and
// acc += a_lo b_hi + a_hi b_lo + a_hi b_hi (wgmma m64nBNk8 tf32).  The
// tensor cores' f32 sums round toward zero, and over a long k-loop that
// bias alone moves results by ~1e-5, so each k-tile's three products sum
// into a fresh accumulator that is added to the total with round-to-nearest;
// so the kernel lands nearer an f64 reference than cuBLAS's f32 path does
// (single-pass TF32 would move results by ~1e-3).  Both operands arrive in
// f32 and are split in shared memory after they land (hi in place, lo into
// a second buffer), so L2 carries 4 bytes a value, not 8.
//
// Each warpgroup (128 threads) owns 64 rows of the BM-row tile, so the
// block has BM * 2 threads.  Out-of-range rows and k >= K load zeros.

// A row-major view of an operand: element (r, k) at p[r * ld + k], real for
// r < rows and k < K.
template <typename T> struct Operand {
  const T* p;
  long long ld;
  int rows;
  int K;
};

template <typename T> struct TileK;
template <> struct TileK<__nv_bfloat16> { static constexpr int BK = 64, KS = 16; };
template <> struct TileK<float> { static constexpr int BK = 32, KS = 8; };

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src to shared dst, or 16 zero bytes when n is 0
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void st_shared16(uint32_t dst, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst), "r"(v.x),
               "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}
__device__ __forceinline__ uint4 ld_shared16(uint32_t src) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(src)
               : "memory");
  return v;
}
// shared-memory writes of this thread (generic proxy) become visible to
// wgmma's reads (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Descriptor of a K-major 128-byte-swizzled tile at shared address s (whose
// 8-row group is 1024-byte aligned): stride 1024 bytes between 8-row groups.
__device__ __forceinline__ uint64_t smem_desc(uint32_t s) {
  return (uint64_t)((s & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// v rounded to the nearest TF32 value (10 mantissa bits; wgmma would
// truncate the low 13 bits of an f32 operand)
__device__ __forceinline__ float tf32_round(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return __uint_as_float(r);
}

#define VD_D8(o)                                                              \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), "+f"(d[o + 4]), \
      "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])
#define VD_R32                                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, " \
  "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define VD_R64                                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, " \
  "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "  \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "  \
  "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "  \
  "%62, %63}"

// d (64 x N f32, N / 2 values a thread) = A . B^T + (acc ? d : 0) for one
// k-step.
template <typename T, int N> struct Wgmma;
template <> struct Wgmma<__nv_bfloat16, 64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t a, uint64_t b,
                                             bool acc = true) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " VD_R32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : VD_D8(0), VD_D8(8), VD_D8(16), VD_D8(24)
        : "l"(a), "l"(b), "r"((int)acc));
  }
};
template <> struct Wgmma<__nv_bfloat16, 128> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t a, uint64_t b,
                                             bool acc = true) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " VD_R64
        ", %64, %65, p, 1, 1, 0, 0;\n}\n"
        : VD_D8(0), VD_D8(8), VD_D8(16), VD_D8(24), VD_D8(32), VD_D8(40),
          VD_D8(48), VD_D8(56)
        : "l"(a), "l"(b), "r"((int)acc));
  }
};
template <> struct Wgmma<float, 64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t a, uint64_t b,
                                             bool acc = true) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " VD_R32
        ", %32, %33, p, 1, 1;\n}\n"
        : VD_D8(0), VD_D8(8), VD_D8(16), VD_D8(24)
        : "l"(a), "l"(b), "r"((int)acc));
  }
};
template <> struct Wgmma<float, 128> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t a, uint64_t b,
                                             bool acc = true) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " VD_R64
        ", %64, %65, p, 1, 1;\n}\n"
        : VD_D8(0), VD_D8(8), VD_D8(16), VD_D8(24), VD_D8(32), VD_D8(40),
          VD_D8(48), VD_D8(56)
        : "l"(a), "l"(b), "r"((int)acc));
  }
};
#undef VD_D8
#undef VD_R32
#undef VD_R64

// One thread's share of the k-tiles of an operand's R-row tile, set up once
// a tile: thread x copies the 16-byte chunk x % 8 of tile rows x / 8 + i NT/8
// (i < R * 8 / NT), whose swizzled shared offsets differ by i * NT * 16.
// Whole chunks in range go by cp.async when the operand's rows are 16-byte
// aligned (rows past the operand and chunks past K as zero fill); a chunk
// that is misaligned or crosses K goes element by element through L2.
template <typename T, int NT> struct Loader {
  static constexpr int CH = 16 / sizeof(T);
  const T* p;       // the thread's first chunk at k = 0
  long long step;   // NT / 8 rows
  int nvalid;       // rows of the operand from the thread's first row on
  int kmax;         // K less the thread's chunk offset
  bool vec;

  __device__ __forceinline__ Loader(const Operand<T>& op, int r0) {
    const int r = threadIdx.x >> 3, kc = threadIdx.x & 7;
    p = op.p + (long long)(r0 + r) * op.ld + kc * CH;
    step = (long long)(NT / 8) * op.ld;
    nvalid = op.rows - r0 - r;
    kmax = op.K - kc * CH;
    vec = ((reinterpret_cast<uintptr_t>(op.p) |
            (uintptr_t)(op.ld * (long long)sizeof(T))) & 15) == 0;
  }

  // the thread's shared offset of chunk 0 in an R-row tile
  static __device__ __forceinline__ uint32_t offset() {
    const int r = threadIdx.x >> 3, kc = threadIdx.x & 7;
    return r * 128 + ((kc ^ (r & 7)) << 4);
  }

  // k-tile at k0 into the tile whose thread chunk 0 is at shared dst
  template <int R> __device__ __forceinline__ void load(uint32_t dst, int k0) const {
    static_assert((R * 8) % NT == 0, "tile chunks per thread");
    constexpr int I = R * 8 / NT;
    const bool full = k0 + CH <= kmax, none = k0 >= kmax;
    if (vec && (full || none)) {
#pragma unroll
      for (int i = 0; i < I; ++i) {
        const bool ok = full && i * (NT / 8) < nvalid;
        cp_async16(dst + i * NT * 16, ok ? p + i * step + k0 : p, ok ? 16 : 0);
      }
      return;
    }
    using U = typename std::conditional<sizeof(T) == 2, unsigned short,
                                        unsigned int>::type;
#pragma unroll
    for (int i = 0; i < I; ++i) {
      uint32_t v[4] = {0, 0, 0, 0};
      if (i * (NT / 8) < nvalid) {
        U* e = reinterpret_cast<U*>(v);
        const U* g = reinterpret_cast<const U*>(p + i * step + k0);
#pragma unroll
        for (int j = 0; j < CH; ++j)
          if (k0 + j < kmax) e[j] = __ldcg(g + j);
      }
      st_shared16(dst + i * NT * 16, make_uint4(v[0], v[1], v[2], v[3]));
    }
  }
};

// Shared memory of a tile product with BM rows, BN columns and STAGES
// stages: per stage A (BM x 128 bytes) then B (BN x 128 bytes), then, for
// f32, two buffers of the same size for the lo parts; the epilogue reuses it
// for the BM x (BN + 8) f32 result (stage_acc).  +1024 for aligning the
// base.
template <typename T, int BM, int BN, int STAGES> struct TileSmem {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int A_BYTES = BM * 128;
  static constexpr int B_BYTES = BN * 128;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int RING = (STAGES + (F32 ? 2 : 0)) * STAGE;
  static constexpr int LDC = BN + 8;
  static constexpr int C_BYTES = BM * LDC * 4;
  static constexpr int BYTES = (RING > C_BYTES ? RING : C_BYTES) + 1024;
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// Splits the 16 bytes of f32 at shared s into their TF32 high parts (in
// place) and remainders (at shared lo).
__device__ __forceinline__ void split16(uint32_t s, uint32_t lo) {
  uint4 v = ld_shared16(s);
  float* f = reinterpret_cast<float*>(&v);
  float r[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float hi = tf32_round(f[e]);
    r[e] = tf32_round(f[e] - hi);
    f[e] = hi;
  }
  st_shared16(s, v);
  st_shared16(lo, make_uint4(__float_as_uint(r[0]), __float_as_uint(r[1]),
                             __float_as_uint(r[2]), __float_as_uint(r[3])));
}

// acc (BN / 2 values a thread, wgmma's accumulator layout) = the product of
// rows [m0, m0 + BM) of A and rows [n0, n0 + BN) of b over nkt k-tiles, A
// being a0 for k-tiles [0, nk0) and a1 after (K1's [x_t; h]: each part
// starts at a whole k-tile).  smem is 1024-aligned.  Every thread of the
// block (BM * 2 of them) must call it; it ends with a barrier, and the
// caller may then reuse smem.
//
// Schedule of k-tile kt, one block barrier each: wait for the thread's own
// copies of k-tile kt + 1; issue kt's wgmma; while it runs, (f32) split
// those copies into the lo buffer k-tile kt - 1 used and start the copy of
// k-tile kt + STAGES - 1 into the stage k-tile kt - 1 used; wait for the
// wgmma; proxy fence; barrier.  Every warpgroup's wgmma of kt - 1 ended
// before the barrier that closed it, so that stage and lo buffer are free.
// (ptxas crashes on a fence.proxy.async between a wgmma's commit and its
// wait, so the fence comes after the wait.)
template <typename T, int BM, int BN, int STAGES>
__device__ __forceinline__ void tile_product(float (&acc)[BN / 2], unsigned char* smem,
                                             const Operand<T>& a0, int nk0,
                                             const Operand<T>& a1, const Operand<T>& b,
                                             int nkt, int m0, int n0) {
  using L = TileSmem<T, BM, BN, STAGES>;
  constexpr int NT = BM * 2;
  constexpr int BK = TileK<T>::BK, KS = TileK<T>::KS;
  static_assert(STAGES >= 3, "k-tile kt + 1 lands while kt's wgmma runs");
  const uint32_t base = smem_u32(smem);
  const int wg = threadIdx.x / 128;
  // f32: the tensor cores' f32 sums round toward zero, which biases a long
  // chain of them; so each k-tile sums into part, and acc adds the k-tiles
  // with round-to-nearest
  float part[L::F32 ? BN / 2 : 1];

  const Loader<T, NT> la0(a0, m0), la1(a1, m0), lb(b, n0);
  const uint32_t own = Loader<T, NT>::offset();
  auto stage = [&](int kt) { return base + (kt % STAGES) * L::STAGE; };
  auto lo_buf = [&](int kt) { return base + (STAGES + (kt & 1)) * L::STAGE; };
  auto load_stage = [&](int kt) {
    const uint32_t s = stage(kt) + own;
    if (kt < nk0)
      la0.template load<BM>(s, kt * BK);
    else
      la1.template load<BM>(s, (kt - nk0) * BK);
    lb.template load<BN>(s + L::A_BYTES, kt * BK);
  };
  // the chunks this thread copied (Loader's map), split after they land
  auto split_stage = [&](int kt) {
    const uint32_t s = stage(kt) + own, lo = lo_buf(kt) + own;
#pragma unroll
    for (int i = 0; i < BM * 8 / NT; ++i) split16(s + i * NT * 16, lo + i * NT * 16);
#pragma unroll
    for (int i = 0; i < BN * 8 / NT; ++i)
      split16(s + L::A_BYTES + i * NT * 16, lo + L::A_BYTES + i * NT * 16);
  };

#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int kt = 0; kt < STAGES - 1; ++kt) {
    if (kt < nkt) load_stage(kt);
    cp_async_commit();
  }
  cp_async_wait<STAGES - 2>();
  if constexpr (L::F32)
    if (nkt > 0) split_stage(0);
  fence_proxy_async();
  __syncthreads();
  for (int kt = 0; kt < nkt; ++kt) {
    const uint32_t sa = stage(kt) + wg * 64 * 128, sb = stage(kt) + L::A_BYTES;
    const uint32_t lo = lo_buf(kt);
    cp_async_wait<STAGES - 3>();   // this thread's copies of k-tile kt + 1
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < BK / KS; ++j) {
      const uint32_t kofs = j * KS * sizeof(T);   // 32 bytes a k-step
      const uint64_t da = smem_desc(sa + kofs), db = smem_desc(sb + kofs);
      if constexpr (L::F32) {   // the small terms first
        Wgmma<T, BN>::run(part, smem_desc(lo + wg * 64 * 128 + kofs), db, j > 0);
        Wgmma<T, BN>::run(part, da, smem_desc(lo + L::A_BYTES + kofs));
        Wgmma<T, BN>::run(part, da, db);
      } else {
        Wgmma<T, BN>::run(acc, da, db);
      }
    }
    wgmma_commit();
    if constexpr (L::F32)
      if (kt + 1 < nkt) split_stage(kt + 1);
    if (kt + STAGES - 1 < nkt) load_stage(kt + STAGES - 1);
    cp_async_commit();
    wgmma_wait<0>();
    if constexpr (L::F32) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
    }
    fence_proxy_async();
    __syncthreads();
  }
  cp_async_wait<0>();
}

// Writes acc to c (BM x LDC f32 in shared memory): wgmma's accumulator
// layout gives thread l of warp w of warpgroup g rows 64g + 16w + l/4 (+8)
// and columns 8i + 2(l%4) (+1).  The caller synchronises before reading.
template <int BN, int LDC>
__device__ __forceinline__ void stage_acc(const float (&acc)[BN / 2], float* c) {
  const int lane = threadIdx.x % 32;
  const int row = (threadIdx.x / 128) * 64 + ((threadIdx.x / 32) % 4) * 16 + lane / 4;
  const int col = 2 * (lane % 4);
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    *reinterpret_cast<float2*>(c + row * LDC + 8 * i + col) =
        make_float2(acc[4 * i], acc[4 * i + 1]);
    *reinterpret_cast<float2*>(c + (row + 8) * LDC + 8 * i + col) =
        make_float2(acc[4 * i + 2], acc[4 * i + 3]);
  }
}

}  // namespace vd
