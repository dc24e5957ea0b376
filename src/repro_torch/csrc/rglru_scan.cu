// RG-LRU diagonal linear recurrence, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/rglru_scan/rglru_scan.py:41 rglru_scan_kernel (body
// `_kernel`). For every channel (b, w), in f32:
//
//   h_t = a_t * h_{t-1} + b_t,   from h_{-1} = h0[b, w],
//
// storing every h_t and the last one as h_last (B, W). The TPU kernel
// keeps a (1, block_w) state in VMEM scratch across a sequential grid axis
// over time chunks; here blocks run in no order, so one thread walks the
// whole time axis of its channel itself with h in a register.
//
// What bounds it on this card: bytes. Each step of each channel reads a_t
// and b_t and writes h_t, 12 bytes for two flops. At recurrentgemma-2b's
// forward shape (B=2, S=4096, W=2560) that is 3 x 83.9 MB = 251.7 MB, 75.1
// us at 3.35 TB/s; at its serve prefill (B=8, S=2048) 150.2 us. A
// channel's chain of 4,096 dependent steps takes about 33k cycles, well
// under that, so what the card needs is its loads issued far enough
// ahead: the forward has only 5,120 channels (160 warps), and one thread a
// channel with loads in registers keeps too few bytes in flight there.
// Two kernels; the Python wrapper picks one from host ints
// (ops.choose_path), never by catching a failure:
//   * "tma" (W a multiple of 4 and a, b 16-byte aligned, so TMA can map
//     them): one block a (batch row, 32 channels), each 32-channel row of
//     a box one 128-byte line. A producer thread keeps a ring of kStages
//     stages in shared memory filled with TMA, each stage a kSteps-step x
//     32-channel box of a and one of b, completing on an mbarrier. One
//     consumer warp, lane w on channel w, reads a stage's a and b into
//     registers, walks its steps in time order with h in a register, and
//     writes each h_t into one of two output boxes in shared memory (word
//     w of a 128-byte row: no bank conflict); one lane sends each
//     finished box out with a TMA store and frees the input stage. Five
//     stages of 32 steps (a 40 KB ring a block) measured fastest at the
//     forward's 160 blocks on an H100; deeper rings and 64-step stages
//     were slower there. TMA fills loads past S or W with zeros and clips
//     stores there, so nothing is padded; the walk stops at step S - 1,
//     which h_last holds, and lanes past W write no h_last. The three maps
//     (a, b, h_all over (W, S, B)) are encoded on the host once per
//     (pointer, shape, box) and cached (sm90.cuh); a launch passes them by
//     value (__grid_constant__);
//   * "registers" (any other W or alignment, and grids of more than two
//     blocks an SM, as the serve prefill's 640, where its 64 steps a
//     channel already keep enough bytes in flight: it matched every TMA
//     ring there): one thread a channel, one warp a block, loads kept
//     kAhead = 64 steps ahead of the arithmetic in a ring of registers
//     (16 KB in flight a warp; threads past W retire at once, steps past
//     S are masked).
//
// Each step is rounded as the plain version rounds it, a product and then
// a sum (__fmul_rn, __fadd_rn: no contraction into an FMA), in one fixed
// order per channel on both paths: the kernels are deterministic, as the
// Scale-Down replay needs, and agree with the plain version to the bit.
// Time is never split into chunks scanned apart: that would change the
// rounding.
//
// Plain C interface, loaded with ctypes: rglru_scan_launch returns
// cudaGetLastError() after the launch, -2 where a tensor map cannot be
// encoded, or -1 for arguments it does not take (the Python wrapper
// checks them first).

#include "sm90.cuh"

namespace {

constexpr int kC = 32;        // channels a block, both paths
constexpr int kAhead = 64;    // "registers": steps of a and b in flight
constexpr int kSteps = 32;    // "tma": steps a stage (ops.STEPS)
constexpr int kStages = 5;    // "tma": stages of the ring (ops.STAGES)
constexpr int kOutStages = 2;
constexpr int kTmaThreads = 64;   // warp 0 the producer, warp 1 consumes
constexpr int kBoxFloats = kSteps * kC;
constexpr int kBoxBytes = kBoxFloats * 4;
constexpr int kStageBytes = 2 * kBoxBytes;   // a and b
// dynamic shared memory of a "tma" block: the ring, the output boxes and
// room to align the first box to 128 bytes (49,280 bytes: above the 48 KB
// a launch takes without opting in)
constexpr int kTmaSmem = (2 * kStages + kOutStages) * kBoxBytes + 128;

// ------------------------------------------------------------ "tma" ----

// a, b, h_all: maps over (W, S, B), boxes of kC x kSteps x 1; h0, h_last:
// (B, W) f32, contiguous
__global__ void __launch_bounds__(kTmaThreads)
    rglru_scan_tma_kernel(const __grid_constant__ CUtensorMap a_map,
                          const __grid_constant__ CUtensorMap b_map,
                          const __grid_constant__ CUtensorMap h_map,
                          const float* __restrict__ h0,
                          float* __restrict__ h_last, int S, int W) {
  constexpr int T = kSteps;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  unsigned char* const smem =
      smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  const float* const ring = reinterpret_cast<const float*>(smem);
  float* const out = reinterpret_cast<float*>(smem + kStages * kStageBytes);
  const int bi = blockIdx.y;
  const int w0 = blockIdx.x * kC;
  const int n_stages = (S + T - 1) / T;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 32) {
    // the producer: stage `it` of the time axis into ring slot
    // it % kStages once the consumer has freed it
    if (lane == 0) {
      for (int it = 0; it < n_stages; ++it) {
        const int s = it % kStages;
        if (it >= kStages)
          mbar_wait(smem_u32(&empty[s]), (it / kStages - 1) & 1);
        const uint32_t bar = smem_u32(&full[s]);
        const uint32_t dst = smem_u32(ring + s * 2 * kBoxFloats);
        mbar_expect_tx(bar, kStageBytes);
        tma_load_3d(dst, &a_map, bar, w0, it * T, bi);
        tma_load_3d(dst + kBoxBytes, &b_map, bar, w0, it * T, bi);
      }
    }
    return;
  }

  // the consumer warp: lane w walks channel w0 + w
  const int w = w0 + lane;
  float h = w < W ? h0[static_cast<int64_t>(bi) * W + w] : 0.f;
  for (int it = 0; it < n_stages; ++it) {
    const int s = it % kStages;
    const int o = it % kOutStages;
    const int n = min(T, S - it * T);   // steps of this stage before S
    // the store that last read output box o has read it
    if (lane == 0 && it >= kOutStages) bulk_wait_read<kOutStages - 1>();
    mbar_wait(smem_u32(&full[s]), (it / kStages) & 1);
    __syncwarp();
    const float* const as = ring + s * 2 * kBoxFloats + lane;
    const float* const bs = as + kBoxFloats;
    float* const os = out + o * kBoxFloats + lane;
    // the stage's a and b into registers first, so the loads are issued
    // ahead of the chain and not held behind its stores
    float ra[T], rb[T];
#pragma unroll
    for (int i = 0; i < T; ++i) {
      ra[i] = as[i * kC];
      rb[i] = bs[i * kC];
    }
#pragma unroll
    for (int i = 0; i < T; ++i) {
      if (i < n) h = __fadd_rn(__fmul_rn(ra[i], h), rb[i]);
      os[i * kC] = h;   // rows past S are not stored
    }
    fence_proxy_async();   // this lane's writes, visible to the TMA store
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(smem_u32(&empty[s]));
      tma_store_3d(&h_map, smem_u32(out + o * kBoxFloats), w0, it * T, bi);
      bulk_commit();
    }
  }
  if (w < W) h_last[static_cast<int64_t>(bi) * W + w] = h;
  if (lane == 0) bulk_wait();   // the last store has completed
}

// ------------------------------------------------------ "registers" ----

// a, b, h_all: (B, S, W); h0, h_last: (B, W); all f32, contiguous.
__global__ void __launch_bounds__(kC)
    rglru_scan_reg_kernel(const float* __restrict__ a,
                          const float* __restrict__ b,
                          const float* __restrict__ h0,
                          float* __restrict__ h_all,
                          float* __restrict__ h_last, int S, int W) {
  const int bi = blockIdx.y;
  const int w = blockIdx.x * kC + threadIdx.x;
  if (w >= W) return;
  const int64_t row = W;  // elements between time steps
  const int64_t base = static_cast<int64_t>(bi) * S * row + w;
  const float* ap = a + base;
  const float* bp = b + base;
  float* hp = h_all + base;

  float ra[kAhead], rb[kAhead];
#pragma unroll
  for (int i = 0; i < kAhead; ++i) {
    const bool ok = i < S;
    ra[i] = ok ? ap[i * row] : 0.f;
    rb[i] = ok ? bp[i * row] : 0.f;
  }

  float h = h0[static_cast<int64_t>(bi) * W + w];
  for (int t0 = 0; t0 < S; t0 += kAhead) {
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      const int t = t0 + i;
      if (t < S) {
        h = __fadd_rn(__fmul_rn(ra[i], h), rb[i]);
        hp[t * row] = h;
      }
      const int tn = t + kAhead;
      if (tn < S) {
        ra[i] = ap[tn * row];
        rb[i] = bp[tn * row];
      }
    }
  }
  h_last[static_cast<int64_t>(bi) * W + w] = h;
}

// ------------------------------------------------------------- host ----

// an f32 (B, S, W) tensor as a map over (W, S, B), boxes of kC x kSteps
bool lru_map(CUtensorMap* map, const void* ptr, int Bsz, int S, int W) {
  return cached_map_3d(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, ptr, W, S,
                       Bsz, kC, kSteps, CU_TENSOR_MAP_SWIZZLE_NONE);
}

int launch_tma(const void* a, const void* b, const void* h0, void* h_all,
               void* h_last, int Bsz, int S, int W, cudaStream_t stream) {
  CUtensorMap a_map, b_map, h_map;
  if (!lru_map(&a_map, a, Bsz, S, W) || !lru_map(&b_map, b, Bsz, S, W) ||
      !lru_map(&h_map, h_all, Bsz, S, W))
    return -2;
  static bool opted[kMaxDevices] = {};
  const int dev = current_device();
  if (dev < 0) return -1;
  if (!opted[dev]) {
    cudaError_t err = cudaFuncSetAttribute(
        rglru_scan_tma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kTmaSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          rglru_scan_tma_kernel,
          cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted[dev] = true;
  }
  const dim3 grid((W + kC - 1) / kC, Bsz);
  rglru_scan_tma_kernel<<<grid, kTmaThreads, kTmaSmem, stream>>>(
      a_map, b_map, h_map, static_cast<const float*>(h0),
      static_cast<float*>(h_last), S, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// path: 0 = "registers", 1 = "tma" (W a multiple of 4, a, b and h_all
// 16-byte aligned). Returns 0 on a good launch.
extern "C" int rglru_scan_launch(const void* a, const void* b,
                                 const void* h0, void* h_all, void* h_last,
                                 int Bsz, int S, int W, int path,
                                 void* stream) {
  if (Bsz < 1 || Bsz > 65535 || S < 1 || W < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == 1) {
    const bool mapped = W % 4 == 0 &&
                        reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                        reinterpret_cast<uintptr_t>(b) % 16 == 0 &&
                        reinterpret_cast<uintptr_t>(h_all) % 16 == 0;
    if (!mapped) return -1;
    return launch_tma(a, b, h0, h_all, h_last, Bsz, S, W, s);
  }
  if (path != 0) return -1;
  const dim3 grid((W + kC - 1) / kC, Bsz);
  rglru_scan_reg_kernel<<<grid, kC, 0, s>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(h_all),
      static_cast<float*>(h_last), S, W);
  return static_cast<int>(cudaGetLastError());
}
