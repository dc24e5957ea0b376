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
// scratch tile, and its wrapper pads M, N and K to the blocks, here each
// output tile is summed over the whole of K by one block with the
// accumulator in registers. There is no split-K and no atomic: every
// output element is summed by one thread in one fixed order, so a launch
// is bitwise-deterministic, as the Scale-Down replay needs. Nothing is
// padded in memory. One launch a call; the output is the only allocation
// and nothing syncs with the host, so a call can be captured in a CUDA
// graph.
//
// What bounds it on this card, at qwen3-moe-30b-a3b's shapes (E=128,
// D=2048, F=768, bf16):
//   * C = 640 (the forward) and 1280 (the serve prefill): a product is
//     2.58e11 / 5.15e11 FLOP, 0.26 / 0.52 ms at the 989 TFLOP/s bf16
//     tensor-core peak, against 0.86 / 1.4 GB moved, 0.26 / 0.42 ms at
//     3.35 TB/s: operations, with the bytes close behind;
//   * C = 8 (the decode, which computes every expert as the reference
//     does): the 0.40 GB of expert weights, 0.12 ms: bytes.
// One instance per case; the Python wrapper picks it from host ints
// (ops.choose_path), never by catching a failure:
//   * "wgmma" (bf16 wherever TMA maps the operands, at any M): a
//     persistent kernel, one block an SM, walks the (e, m-tile, n-tile)
//     tiles of 128 x 256 in a fixed order (tile t = blockIdx.x + i *
//     gridDim.x; e outermost, then the n-tile, the m-tile fastest, so
//     neighbouring tiles share w's slab). The tile counts and the grid
//     come from the host (ops.wgmma_plan); the walk is stated here only.
//     A producer warp keeps a three-stage ring of 64-deep K slices
//     in flight with TMA (x through a 3-D map over (K, M, E), w through
//     one over (N, K, E); rows past M, columns past N and K past its end
//     arrive zero-filled, so ragged shapes need no mask in the main loop)
//     and hands its registers to two consumer warpgroups (setmaxnreg).
//     Each consumer owns 64 rows of the tile and runs wgmma m64n256k16 from
//     shared memory, x K-major and w MN-major (w's N is contiguous: the
//     case of V in flash_attention.cu); a stage is freed as soon as the
//     next slice's products are issued, and the ring runs on across tiles,
//     so the next tile's loads land under this tile's products and store.
//     The output leaves through a swizzled staging tile and a TMA store
//     that drains while the next tile runs (stores from registers straight
//     to device memory held the tensor cores idle through each tile's
//     end, which the down product's short tiles of 12 slices felt most).
//     The maps are encoded on the host once per (pointer, shape) and
//     cached; a launch passes them by value (__grid_constant__). At the
//     decode's 8 rows an expert each tile is one m-tile whose rows past M
//     TMA fills with zeros on chip, so w is read once, with up to three
//     32 KB stages of it in flight an SM: the weight bytes bind. A kernel with
//     the roles swapped (w as wgmma's A operand, the rows as its n) was no
//     faster there (PERF.md) and is not kept;
//   * "mma" (bf16 where TMA cannot map the operands: K or N not a
//     multiple of 8, or a base not 16-byte aligned): the first port's
//     kernel, mma.sync.m16n8k16 over ldmatrix with 32-deep cp.async
//     slices three stages deep, one 128 x 128 tile a block, ragged edges
//     zero-filled in shared memory;
//   * "fma" (f32: the f32 smoke configs and the co-emulator's 1e-5
//     parity): CUDA-core f32 FMAs, not TF32, a 64 x 64 tile a block.
// Measured shares of the bound are in PERF.md (chip_smoke.py phase 34).
//
// Plain C interface, loaded with ctypes: grouped_gemm_launch returns
// cudaGetLastError() after the launch, -2 where a tensor map cannot be
// encoded, or -1 for arguments it does not take. `vec` = 1 (the "mma" and
// "fma" paths) says every row of x and w starts on a 16-byte boundary:
// their tiles are then copied 16 bytes at a time, else element by
// element.

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ------------------------------- "mma": bf16 where TMA cannot map ----

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

// ------------------------------------------ "fma": f32 on CUDA cores ----

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

// --------------------------------- "wgmma": bf16 where the products bind ----

constexpr int kWgBM = 128;                  // rows of x a tile
constexpr int kWgBN = 256;                  // columns of w a tile
constexpr int kWgBK = 64;                   // K a stage: one 128-byte row
constexpr int kWgStages = 3;
constexpr int kWgConsumers = 2;             // warpgroups of 64 rows
constexpr int kWgThreads = 128 * (kWgConsumers + 1);
constexpr int kWgABytes = kWgBM * kWgBK * 2;               // 16 KB of x
constexpr int kWgSlab = kWgBK * 128;                       // 64 columns of w
constexpr int kWgBBytes = (kWgBN / 64) * kWgSlab;          // 32 KB of w
constexpr int kWgStageBytes = kWgABytes + kWgBBytes;
constexpr int kWgBarOff = kWgStages * kWgStageBytes;
// after the stages: the full and empty barriers of each stage in 1 KB (so
// what follows keeps the 1024-byte period of the 128-byte swizzle), each
// consumer's 64 x 256 piece of the output tile staged for the TMA store
// as four swizzled 64-column slabs, and 1 KB to align the base
constexpr int kWgOutOff = kWgBarOff + 1024;
constexpr int kWgOutBytes = kWgConsumers * 4 * 64 * 128;
constexpr int kWgSmem = kWgOutOff + kWgOutBytes + 1024;
static_assert(kWgSmem <= 232448, "over the 227 KB a block may hold");

__global__ void __launch_bounds__(kWgThreads, 1)
grouped_gemm_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                          const __grid_constant__ CUtensorMap w_map,
                          const __grid_constant__ CUtensorMap o_map, int K,
                          int tiles_m, int tiles_n, int n_tiles) {
  extern __shared__ __align__(1024) unsigned char wg_smem_raw[];
  const uint32_t base = (smem_u32(wg_smem_raw) + 1023u) & ~1023u;
  auto a_tile = [&](int st) { return base + st * kWgStageBytes; };
  auto b_tile = [&](int st) { return a_tile(st) + kWgABytes; };
  auto full = [&](int st) { return base + kWgBarOff + 8 * st; };
  auto empty = [&](int st) {
    return base + kWgBarOff + 8 * (kWgStages + st);
  };
  // tile t: expert, then n-tile, then m-tile fastest
  const int per_e = tiles_m * tiles_n;
  auto tile = [&](int t, int& e, int& m0, int& n0) {
    e = t / per_e;
    const int r = t - e * per_e;
    const int nt = r / tiles_m;
    m0 = (r - nt * tiles_m) * kWgBM;
    n0 = nt * kWgBN;
  };
  const int nk = (K + kWgBK - 1) / kWgBK;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kWgStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 4 * kWgConsumers);   // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kWgConsumers) {
    // ------------------------------------------------------ producer --
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 128 * kWgConsumers) {
      int it = 0;   // slices issued, across this block's tiles
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        int e, m0, n0;
        tile(t, e, m0, n0);
        for (int kb = 0; kb < nk; ++kb, ++it) {
          const int st = it % kWgStages, ph = (it / kWgStages) & 1;
          mbar_wait(empty(st), ph ^ 1);
          mbar_expect_tx(full(st), kWgStageBytes);
          tma_load_3d(a_tile(st), &x_map, full(st), kb * kWgBK, m0, e);
#pragma unroll
          for (int j = 0; j < kWgBN / 64; ++j)
            tma_load_3d(b_tile(st) + j * kWgSlab, &w_map, full(st),
                        n0 + 64 * j, kb * kWgBK, e);
        }
      }
    }
  } else {
    // ----------------------------------------------------- consumers --
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wt = threadIdx.x % 128, warp = wt / 32, lane = wt % 32;
    const int g = lane / 4, tig = lane % 4;
    float acc[kWgBN / 2];
    int it = 0;
    auto release = [&](int i) {
      if (lane == 0) mbar_arrive(empty(i % kWgStages));
    };
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      int e, m0, n0;
      tile(t, e, m0, n0);
      for (int kb = 0; kb < nk; ++kb, ++it) {
        const int st = it % kWgStages;
        mbar_wait(full(st), (it / kWgStages) & 1);
        wg_fence();
        // four k16 steps: 32 bytes along x's swizzled 128-byte rows, 16
        // rows down w's slabs (kWgSlab apart along N)
#pragma unroll
        for (int kk = 0; kk < kWgBK / 16; ++kk)
          wgmma_ss_n256_bt(
              acc, wg_desc(a_tile(st) + wg * 64 * 128 + kk * 32, 16, 1024),
              wg_desc(b_tile(st) + kk * 16 * 128, kWgSlab, 1024),
              kb > 0 || kk > 0);
        wg_commit();
        wg_wait<1>();   // the previous slice's products are done
        wg_pin(acc);
        if (kb > 0) release(it - 1);
      }
      wg_wait<0>();
      wg_pin(acc);
      release(it - 1);
      // the store: element 4 j + 2 i + c is row warp * 16 + g + 8 i,
      // column 8 j + 2 tig + c of this warpgroup's 64 x 256 piece. It goes
      // in bf16 into the warpgroup's staging tile (four 64-column slabs,
      // 128-byte swizzled, so the 32 lanes of a store hit 32 banks), and
      // one thread sends it out with TMA, which writes no row past M and
      // no column past N; the warpgroup goes on to its next tile while the
      // store drains, and waits for it only before it stages again
      const uint32_t stage_out = base + kWgOutOff + wg * 4 * 64 * 128;
      auto wg_bar = [&]() {
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
      };
      if (wt == 0) bulk_wait_read<0>();   // the last tile's store has read it
      wg_bar();
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = warp * 16 + g + 8 * i;
#pragma unroll
        for (int j = 0; j < kWgBN / 8; ++j) {
          const uint32_t a = stage_out + (j / 8) * 64 * 128 + r * 128 +
                             (((j % 8) ^ (r & 7)) << 4) + tig * 4;
          asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(a),
                       "r"(pack_bf16(acc[4 * j + 2 * i],
                                     acc[4 * j + 2 * i + 1]))
                       : "memory");
        }
      }
      fence_proxy_async();
      wg_bar();
      if (wt == 0) {
#pragma unroll
        for (int j = 0; j < kWgBN / 64; ++j)
          tma_store_3d(&o_map, stage_out + j * 64 * 128, n0 + 64 * j,
                       m0 + wg * 64, e);
        bulk_commit();
      }
    }
    if (wt == 0) bulk_wait();   // the last store has completed
  }
}

// ------------------------------------------------------------- host ----

// A bf16 (d2, d1, d0) tensor as a 3-D map (d0, d1, d2), boxes of
// 64 x box1 x 1 with the 128-byte swizzle, zeros out of bounds, cached
// (sm90.cuh: cached_map_3d).
bool cached_map(CUtensorMap* map, const void* ptr, long long d0,
                long long d1, long long d2, int box1) {
  return cached_map_3d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ptr, d0,
                       d1, d2, 64, box1, CU_TENSOR_MAP_SWIZZLE_128B);
}

int launch_wgmma(const void* x, const void* w, void* out, int E, int M,
                 int K, int N, int tiles_m, int tiles_n, int grid,
                 cudaStream_t stream) {
  CUtensorMap x_map, w_map, o_map;
  if (!cached_map(&x_map, x, K, M, E, kWgBM) ||
      !cached_map(&w_map, w, N, K, E, kWgBK) ||
      !cached_map(&o_map, out, N, M, E, 64))
    return -2;
  static bool opted[kMaxDevices] = {};
  const int dev = current_device();
  if (dev < 0) return -1;
  if (!opted[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        grouped_gemm_wgmma_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kWgSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted[dev] = true;
  }
  // the host's tiling must cover the output, its grid at most one block
  // a tile
  const long long n_tiles = (long long)E * tiles_m * tiles_n;
  if ((long long)tiles_m * kWgBM < M || (long long)tiles_n * kWgBN < N ||
      n_tiles > 0x7fffffff || grid < 1 || grid > n_tiles)
    return -1;
  grouped_gemm_wgmma_kernel<<<grid, kWgThreads, kWgSmem, stream>>>(
      x_map, w_map, o_map, K, tiles_m, tiles_n, (int)n_tiles);
  return static_cast<int>(cudaGetLastError());
}

template <bool kVec>
int launch_simple(const void* x, const void* w, void* out, int E, int M,
                  int K, int N, int dtype, cudaStream_t stream) {
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

// dtype: 0 = float32, 1 = bfloat16. path: 0 = the tile kernels ("fma" for
// f32, "mma" for bf16, with `vec`), 1 = "wgmma" (bf16 only, with K and N
// multiples of 8 and 16-byte aligned bases; `tiles_m`, `tiles_n` and
// `grid` from ops.wgmma_plan, unused by the tile kernels).
// Returns 0 on a good launch.
extern "C" int grouped_gemm_launch(const void* x, const void* w, void* out,
                                   int E, int M, int K, int N, int dtype,
                                   int path, int vec, int tiles_m,
                                   int tiles_n, int grid, void* stream) {
  if (E < 1 || M < 1 || K < 1 || N < 1 || (dtype != 0 && dtype != 1))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == 1) {
    const bool mapped = dtype == 1 && K % 8 == 0 && N % 8 == 0 &&
                        reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                        reinterpret_cast<uintptr_t>(w) % 16 == 0;
    if (!mapped) return -1;
    return launch_wgmma(x, w, out, E, M, K, N, tiles_m, tiles_n, grid, s);
  }
  if (path != 0 || E > 65535 || (M + kFBM - 1) / kFBM > 65535) return -1;
  return vec ? launch_simple<true>(x, w, out, E, M, K, N, dtype, s)
             : launch_simple<false>(x, w, out, E, M, K, N, dtype, s);
}
