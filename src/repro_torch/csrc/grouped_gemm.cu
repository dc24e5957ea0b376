// Grouped (per-expert) matmul of the MoE FFN, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/grouped_gemm/grouped_gemm.py:37 grouped_gemm_kernel
// (body `_kernel`): out[e] = x[e] @ w[e] for x (E,M,K) and w (E,K,N), with
// an f32 accumulator and the output in x's dtype. The MoE sort dispatch
// hands it uniform (E, C, D) expert batches: the gate and up products
// (E,C,D)@(E,D,F) and the down product (E,C,F)@(E,F,D).
//
// Where the TPU walks K as the innermost sequential grid axis into a VMEM
// scratch tile, and its wrapper pads M, N and K to the blocks, here one
// thread block owns one (expert, 128 x 128 output tile) and loops over K
// itself with the accumulator in registers. Ragged M, N and K are masked
// by zero-filling the shared-memory tiles; nothing is padded in memory.
// There is no split-K and no atomic: every output element is summed by one
// thread in one fixed order, so a launch is deterministic, as the bitwise
// Scale-Down replay needs.
//
// What bounds it on this card. qwen3-moe-30b-a3b's gate product at the
// forward shape (E=128, C=640, D=2048, F=768, bf16) is 2.58e11 FLOP, 0.26
// ms at the 989 TFLOP/s bf16 tensor-core peak, against 0.86 GB moved,
// 0.26 ms at 3.35 TB/s: both. At the decode shape (C=8) it is the 0.40 GB
// of expert weights: bytes. What the design does about it:
//   * the bf16 instance (the model's) runs on the tensor cores with
//     mma.sync.m16n8k16 (bf16 in, f32 accumulate): eight warps, each a
//     64 x 32 piece of the tile; x fragments come through ldmatrix, w's
//     through ldmatrix.trans (w is (K, N) with N contiguous, the case of
//     V in the flash-attention kernel);
//   * 32-deep K slices of x and w are staged through shared memory by
//     cp.async three stages deep, so two slices are in flight while one
//     is multiplied;
//   * the f32 instance (the f32 smoke configs and the co-emulator's 1e-5
//     parity) stays on the CUDA cores' f32 FMAs, not TF32: a 64 x 64 tile,
//     4 x 4 outputs a thread.
// wgmma with TMA, and a variant for the decode's few rows an expert, are
// the next steps toward the bound.
//
// Plain C interface, loaded with ctypes: grouped_gemm_launch returns
// cudaGetLastError() after the launch, or -1 for arguments it does not
// take. `vec` = 1 says every row of x and w starts on a 16-byte boundary
// (K and N multiples of 16 bytes, aligned bases): the tiles are then
// copied 16 bytes at a time, else element by element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// ------------------------------------------------ bf16: tensor cores ----

constexpr int kBM = 128, kBN = 128, kBK = 32, kStages = 3;
constexpr int kWarpsM = 2, kWarpsN = 4;
constexpr int kMmaThreads = 32 * kWarpsM * kWarpsN;
constexpr int kWM = kBM / kWarpsM;   // 64 rows a warp
constexpr int kWN = kBN / kWarpsN;   // 32 columns a warp
constexpr int kMT = kWM / 16;        // 16-row m-tiles a warp
constexpr int kNT = kWN / 8;         // 8-column n-tiles a warp
// row strides in elements, padded by 16 bytes so that the eight 16-byte
// rows one ldmatrix reads fall in distinct banks
constexpr int kARow = kBK + 8;
constexpr int kBRow = kBN + 8;
constexpr int kAStage = kBM * kARow;
constexpr int kBStage = kBK * kBRow;
constexpr size_t kMmaSmem = kStages * (kAStage + kBStage) * sizeof(bf16);
constexpr int kChunks = kBM * kBK / 8;   // 16-byte chunks of a slice of x
static_assert(kChunks == kBK * kBN / 8, "x and w slices have equal chunks");
static_assert(kChunks % kMmaThreads == 0, "whole chunks a thread");

// One 32-deep K slice of x (rows m0.., (kBM, kBK)) and of w (columns n0..,
// (kBK, kBN)) into shared memory, zero outside (M, K) and (K, N).
template <bool kVec>
__device__ __forceinline__ void load_slice(bf16* a_s, bf16* b_s,
                                           const bf16* xe, const bf16* we,
                                           int m0, int n0, int k0, int M,
                                           int K, int N, int tid) {
#pragma unroll
  for (int j = 0; j < kChunks / kMmaThreads; ++j) {
    const int i = tid + j * kMmaThreads;
    {  // x: row r, columns c..c+7
      const int r = i / (kBK / 8), c = (i % (kBK / 8)) * 8;
      const int row = m0 + r, col = k0 + c;
      bf16* dst = a_s + r * kARow + c;
      if constexpr (kVec) {
        const bool ok = row < M && col < K;
        cp_async16(dst, ok ? xe + (size_t)row * K + col : xe, ok);
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q)
          dst[q] = (row < M && col + q < K) ? xe[(size_t)row * K + col + q]
                                            : __float2bfloat16(0.f);
      }
    }
    {  // w: row r (a k index), columns c..c+7
      const int r = i / (kBN / 8), c = (i % (kBN / 8)) * 8;
      const int row = k0 + r, col = n0 + c;
      bf16* dst = b_s + r * kBRow + c;
      if constexpr (kVec) {
        const bool ok = row < K && col < N;
        cp_async16(dst, ok ? we + (size_t)row * N + col : we, ok);
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q)
          dst[q] = (row < K && col + q < N) ? we[(size_t)row * N + col + q]
                                            : __float2bfloat16(0.f);
      }
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kMmaThreads, 2)
grouped_gemm_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                        bf16* __restrict__ out, int M, int K, int N) {
  extern __shared__ __align__(16) bf16 smem[];
  bf16* a_s = smem;                       // kStages slices of x
  bf16* b_s = smem + kStages * kAStage;   // kStages slices of w

  const int e = blockIdx.z;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const int g = lane / 4, tig = lane % 4;   // mma fragment coordinates
  const int mi = lane / 8;                  // the 8x8 matrix a lane addresses
  const bf16* xe = x + (size_t)e * M * K;
  const bf16* we = w + (size_t)e * K * N;

  float acc[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;

  const int nk = (K + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk)
      load_slice<kVec>(a_s + s * kAStage, b_s + s * kBStage, xe, we, m0, n0,
                       s * kBK, M, K, N, tid);
    cp_async_commit();
  }

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();   // slice kt has landed
    __syncthreads();                // ...for every thread; slice kt-1 is read
    const int pre = kt + kStages - 1;
    if (pre < nk)
      load_slice<kVec>(a_s + (pre % kStages) * kAStage,
                       b_s + (pre % kStages) * kBStage, xe, we, m0, n0,
                       pre * kBK, M, K, N, tid);
    cp_async_commit();

    const bf16* as = a_s + (kt % kStages) * kAStage;
    const bf16* bs = b_s + (kt % kStages) * kBStage;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      // A fragments: lane l gives row l % 8 of matrix l / 8 (rows +8 for
      // odd matrices, k +8 for the upper two)
      uint32_t af[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
        ldmatrix_x4(af[mt], as + (wm * kWM + mt * 16 + (mi & 1) * 8 +
                                  lane % 8) * kARow +
                                kk + (mi >> 1) * 8);
      // B fragments of two n-tiles a load: k +8 for odd matrices,
      // columns +8 for the upper two
      uint32_t bfr[kNT][2];
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, bs + (kk + (mi & 1) * 8 + lane % 8) * kBRow +
                                 wn * kWN + np * 16 + (mi >> 1) * 8);
        bfr[2 * np][0] = r[0];
        bfr[2 * np][1] = r[1];
        bfr[2 * np + 1][0] = r[2];
        bfr[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
          mma_bf16(acc[mt][nt], af[mt], bfr[nt][0], bfr[nt][1]);
    }
  }
  cp_async_wait<0>();

  // element q of acc[mt][nt] is row g + 8 (q / 2), column tig * 2 + q % 2
  bf16* oe = out + (size_t)e * M * N;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm * kWM + mt * 16 + g + 8 * half;
      if (row >= M) continue;
      bf16* orow = oe + (size_t)row * N;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int col = n0 + wn * kWN + nt * 8 + tig * 2;
        const float v0 = acc[mt][nt][2 * half];
        const float v1 = acc[mt][nt][2 * half + 1];
        if ((N & 1) == 0) {   // col even: the pair is 4-byte aligned
          if (col < N)
            *reinterpret_cast<__nv_bfloat162*>(orow + col) =
                __floats2bfloat162_rn(v0, v1);
        } else {
          if (col < N) orow[col] = __float2bfloat16(v0);
          if (col + 1 < N) orow[col + 1] = __float2bfloat16(v1);
        }
      }
    }
}

// ----------------------------------------------- f32: CUDA-core FMAs ----

constexpr int kFBM = 64, kFBN = 64, kFBK = 16;
constexpr int kFThreads = 256;   // 16 x 16 threads, 4 x 4 outputs each
static_assert(kFBM * kFBK == 4 * kFThreads, "four x values a thread");
static_assert(kFBK * kFBN == 4 * kFThreads, "four w values a thread");

template <bool kVec>
__global__ void __launch_bounds__(kFThreads)
grouped_gemm_f32_kernel(const float* __restrict__ x,
                        const float* __restrict__ w, float* __restrict__ out,
                        int M, int K, int N) {
  // x's slice transposed (k-major), so a thread reads its 4 rows as one
  // float4; w's slice as it lies
  __shared__ __align__(16) float a_s[kFBK][kFBM];
  __shared__ __align__(16) float b_s[kFBK][kFBN];

  const int e = blockIdx.z;
  const int m0 = blockIdx.y * kFBM, n0 = blockIdx.x * kFBN;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const float* xe = x + (size_t)e * M * K;
  const float* we = w + (size_t)e * K * N;
  // this thread's 4 values of each slice
  const int ar = tid / (kFBK / 4), ac = (tid % (kFBK / 4)) * 4;
  const int br = tid / (kFBN / 4), bc = (tid % (kFBN / 4)) * 4;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kFBK) {
    float av[4], bv[4];
    {
      const int row = m0 + ar, col = k0 + ac;
      if (kVec && row < M && col < K) {
        const float4 u =
            *reinterpret_cast<const float4*>(xe + (size_t)row * K + col);
        av[0] = u.x; av[1] = u.y; av[2] = u.z; av[3] = u.w;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          av[q] = (!kVec && row < M && col + q < K)
                      ? xe[(size_t)row * K + col + q]
                      : 0.f;
      }
    }
    {
      const int row = k0 + br, col = n0 + bc;
      if (kVec && row < K && col < N) {
        const float4 u =
            *reinterpret_cast<const float4*>(we + (size_t)row * N + col);
        bv[0] = u.x; bv[1] = u.y; bv[2] = u.z; bv[3] = u.w;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          bv[q] = (!kVec && row < K && col + q < N)
                      ? we[(size_t)row * N + col + q]
                      : 0.f;
      }
    }
    __syncthreads();   // the previous slice is read
#pragma unroll
    for (int q = 0; q < 4; ++q) a_s[ac + q][ar] = av[q];
    *reinterpret_cast<float4*>(&b_s[br][bc]) =
        make_float4(bv[0], bv[1], bv[2], bv[3]);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&a_s[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&b_s[kk][tx * 4]);
      const float ai[4] = {a.x, a.y, a.z, a.w};
      const float bj[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ai[i], bj[j], acc[i][j]);
    }
  }

  float* oe = out + (size_t)e * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < N) oe[(size_t)row * N + col] = acc[i][j];
    }
  }
}

template <bool kVec>
int launch(const void* x, const void* w, void* out, int E, int M, int K,
           int N, int dtype, cudaStream_t stream) {
  if (dtype == 1) {
    // more than 48 KB of dynamic shared memory only when opted in
    const cudaError_t err = cudaFuncSetAttribute(
        grouped_gemm_mma_kernel<kVec>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMmaSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, E);
    grouped_gemm_mma_kernel<kVec><<<grid, kMmaThreads, kMmaSmem, stream>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w),
        static_cast<bf16*>(out), M, K, N);
  } else {
    const dim3 grid((N + kFBN - 1) / kFBN, (M + kFBM - 1) / kFBM, E);
    grouped_gemm_f32_kernel<kVec><<<grid, kFThreads, 0, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(out), M, K, N);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns 0 on a good launch.
extern "C" int grouped_gemm_launch(const void* x, const void* w, void* out,
                                   int E, int M, int K, int N, int dtype,
                                   int vec, void* stream) {
  if (E < 1 || M < 1 || K < 1 || N < 1 || E > 65535 ||
      (M + kFBM - 1) / kFBM > 65535 || (dtype != 0 && dtype != 1))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec ? launch<true>(x, w, out, E, M, K, N, dtype, s)
             : launch<false>(x, w, out, E, M, K, N, dtype, s);
}
