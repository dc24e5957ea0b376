// Decode attention over a ring KV cache, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/decode_attention/decode_attention.py::
// decode_attention_kernel (body `_kernel`). One new query token per
// sequence attends over a ring cache of W slots. All G = H/K query heads
// of one kv head are handled together. Slots above `pos` are masked until
// the ring is full, and the logits may be soft-capped. The softmax is an
// online one in f32. As on the TPU, the weights are rounded to the value
// dtype before the PV product, and the final normaliser is clamped at
// 1e-30.
//
// What bounds it on this card: bytes. At glm4-9b's decode shapes (B=8,
// H=32, K=2, hd=128, W=2120, bf16) a launch reads ~17.4 MB of cache and
// does ~0.28 GFLOP: 5.2 us at 3.35 TB/s against 0.3 us at the bf16
// tensor-core peak. The TPU runs the cache blocks as a sequential grid
// axis of one (b, kv head); a block per (b, kv head) here would fill 8 to
// 32 of the 132 SMs at the serve shapes, each block bound by latency. What
// the design does about it:
//   * the ring is split across the card: (B*K) x n_split blocks, each
//     owning one contiguous chunk of slots (a multiple of the 32-slot
//     tile) for all G query heads of its kv head. The wrapper picks the
//     chunk from B*K and W alone (host ints, never `pos`; about one and
//     a half blocks an SM, at most 16 splits), so the grid is fixed for a
//     cache and a CUDA graph can capture the launch;
//   * each block streams its chunk through a 3-stage cp.async ring of
//     16-byte copies, so two tiles are in flight while one is computed;
//     slots past `pos` (ring not full) or past W are neither read nor
//     kept: the copy zero-fills them and the scores mask them;
//   * the combine runs in the same launch, without a trip through device
//     memory: the splits of one (b, kv head) form a thread-block cluster.
//     Each block keeps its partial (running max m, sum l and the
//     unnormalised f32 accumulator, G x hd) in its shared memory; after a
//     cluster barrier every block merges a slice of the output, reading
//     the partials of the live splits (the first ceil(min(W, pos + 1) /
//     chunk)) through distributed shared memory in split-index order, so
//     the result is the same bit for bit from run to run. A block whose
//     chunk starts above `pos` while the ring is not full reads nothing
//     and only merges its slice. A merge by the last block to finish,
//     through device memory, cost more than the rest of the kernel at
//     recurrentgemma-2b's shape on an H100: one SM read every partial;
//   * the bf16 instance (the model's) runs QK^T and PV on the tensor cores
//     (mma.sync.m16n8k16, the G <= 16 heads padded to 16 rows): at
//     glm4-9b's G = 16 the f32 FMAs alone would take about as long as the
//     bytes. The f32 instance stays on FMAs, exact to 2e-5;
//   * `pos` is read from device memory (the TPU kernel's SMEM scalar
//     prefetch), so no host sync is needed.
//
// Plain C interface, loaded with ctypes: decode_attention_launch returns
// cudaGetLastError() after the launch, or -1 for arguments it does not
// take (the Python wrapper checks them first, including the 16-byte
// alignment of q, k and v).

#include <cooperative_groups.h>

#include "sm90.cuh"

#include <type_traits>

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;   // cache slots per stage: one per lane
constexpr int kMaxG = 16;   // query heads per kv head: one m16 tile
constexpr int kMaxSplit = 16;   // blocks per (b, kv head): one cluster
constexpr int kRowsPerWarp = kMaxG / kWarps;
constexpr float kNegInf = -1e30f;
static_assert(kTile == 32, "the softmax maps one slot to each lane");
static_assert(kTile == 8 * kWarps, "QK^T gives each warp one n8 slot tile");

// Shared-memory layout in bytes. k and v rows are padded by 16 bytes, so
// the 8 rows an mma fragment or a float4 sweep touches hit distinct banks.
template <typename T, int HD>
struct Smem {
  static constexpr bool kBf16 = std::is_same<T, bf16>::value;
  static constexpr int kRow = HD + 16 / (int)sizeof(T);   // elements
  static constexpr int kTileBytes = kTile * kRow * (int)sizeof(T);
  // three k/v stages: at head_dim 128 a bf16 block then takes 60 KB and
  // two share an SM well (with four, 77 KB, two an SM ran slower than one
  // on an H100)
  static constexpr int kStages = 3;
  static constexpr int kQRow = kBf16 ? HD + 8 : HD;        // elements
  // one tile's scores (bf16) or weights (f32): 40 floats a row keep the
  // float2 reads of 8 rows x 4 lanes on distinct banks
  static constexpr int kPRow = kTile + 8;
  static constexpr int k_off = 0;
  static constexpr int v_off = k_off + kStages * kTileBytes;
  static constexpr int q_off = v_off + kStages * kTileBytes;
  // one tile's scores or weights, and the f32 instance's softmax state
  // (bf16 keeps it in registers)
  static constexpr int p_off = q_off + kMaxG * kQRow * (int)sizeof(T);
  static constexpr int m_off = p_off + kMaxG * kPRow * 4;
  static constexpr int l_off = m_off + kMaxG * 4;
  static constexpr int alpha_off = l_off + kMaxG * 4;
  // the combine's weights and l values of every (head, split), and the
  // normalisers
  static constexpr int w_off = alpha_off + kMaxG * 4;
  static constexpr int bytes = w_off + (2 * kMaxSplit + 1) * kMaxG * 4;
  // the partial (G x HD accumulator, m, l) lies over the k/v ring
  static_assert((kMaxG * HD + 2 * kMaxG) * 4 <= q_off,
                "the partial fits where the ring was");
  static_assert(kTileBytes % 16 == 0 && q_off % 16 == 0 &&
                    kQRow * sizeof(T) % 16 == 0,
                "16-byte copies");
  static_assert(bytes <= 232448, "over the 227 KB a block may hold");
};

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// q, out: (B, K, G, HD) == (B, H, HD); k, v: (B, W, K, HD); pos: one int32.
// The grid is (n_split, B*K) in clusters of (n_split, 1): block x of row y
// takes slots [x chunk, (x + 1) chunk) of (b, kv head) = divmod(y, K).
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int32_t* __restrict__ pos_ptr,
                        T* __restrict__ out, int W, int K, int G, int window,
                        int chunk, float scale, float softcap) {
  using L = Smem<T, HD>;
  constexpr bool kBf16 = L::kBf16;
  constexpr int kRow = L::kRow;
  constexpr int kStages = L::kStages;
  constexpr int kPerVec = 16 / (int)sizeof(T);
  constexpr int kVecsPerSlot = HD / kPerVec;
  constexpr int kTileVecs = kTile * kVecsPerSlot;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  T* k_s = reinterpret_cast<T*>(smem + L::k_off);
  T* v_s = reinterpret_cast<T*>(smem + L::v_off);
  T* q_s = reinterpret_cast<T*>(smem + L::q_off);
  float* p_s = reinterpret_cast<float*>(smem + L::p_off);
  float* m_s = reinterpret_cast<float*>(smem + L::m_off);
  float* l_s = reinterpret_cast<float*>(smem + L::l_off);
  float* alpha_s = reinterpret_cast<float*>(smem + L::alpha_off);
  float* w_s = reinterpret_cast<float*>(smem + L::w_off);
  // the partial lies over the k/v ring once it is read: the unnormalised
  // accumulator (G x HD), then m and l (G each)
  float* acc_s = reinterpret_cast<float*>(smem);
  float* ml_s = acc_s + G * HD;

  // the splits of one (b, kv head) are one cluster, split = rank in it
  cg::cluster_group cluster = cg::this_cluster();
  const int split = blockIdx.x, n_split = gridDim.x, bk = blockIdx.y;
  const int b = bk / K, kv = bk % K;
  // q (rows from G on zero) copied while pos is read: it opens the first
  // copy group, with the chunk's first tile
  const T* qb = q + (size_t)bk * G * HD;
  for (int i = tid; i < kMaxG * kVecsPerSlot; i += kThreads) {
    const int g = i / kVecsPerSlot, c = (i % kVecsPerSlot) * kPerVec;
    cp_async16(q_s + g * L::kQRow + c, qb + (g < G ? g * HD + c : 0),
               g < G);
  }
  const int pos = *pos_ptr;
  const bool ring_full = pos + 1 >= window;
  const int end = ring_full ? W : min(W, pos + 1);
  const int lo = split * chunk, hi = min(lo + chunk, end);

  if (lo < hi) {
    const size_t slot_stride = (size_t)K * HD;
    const T* kb = k + (size_t)b * W * slot_stride + (size_t)kv * HD;
    const T* vb = v + (size_t)b * W * slot_stride + (size_t)kv * HD;
    const int n_tiles = (hi - lo + kTile - 1) / kTile;
    // tile i's copies into stage i % kStages, one copy group a tile, empty
    // or not; slots from hi on are zero-filled
    auto load = [&](int i) {
      if (i < n_tiles) {
        T* ks = k_s + (i % kStages) * kTile * kRow;
        T* vs = v_s + (i % kStages) * kTile * kRow;
        const int t0 = lo + i * kTile;
        for (int j = tid; j < kTileVecs; j += kThreads) {
          const int t = j / kVecsPerSlot, c = (j % kVecsPerSlot) * kPerVec;
          const bool ok = t0 + t < hi;
          const size_t off = ok ? (size_t)(t0 + t) * slot_stride + c : 0;
          cp_async16(ks + t * kRow + c, kb + off, ok);
          cp_async16(vs + t * kRow + c, vb + off, ok);
        }
      }
      cp_async_commit();
    };
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) load(i);

    // the f32 instance's softmax state
    if (tid < kMaxG) {
      m_s[tid] = kNegInf;
      l_s[tid] = 0.f;
    }

    // bf16: each warp scores 8 slots of a tile for the 16 (padded) heads
    // on the tensor cores and every warp reads the tile's scores back, so
    // each row's softmax runs in its registers (4 lanes a row) and P is
    // already the A fragment of the PV product; warp w then owns
    // kWarpDims of the dims (at head_dim 16 and 32 only the first one or
    // two warps take part). f32: scores lane = slot, four heads a warp;
    // the weights go through shared memory, and each thread owns (head, 4
    // dims) items tid + j * kThreads.
    constexpr int kPVWarps = HD / 16 < kWarps ? HD / 16 : kWarps;
    constexpr int kWarpDims = HD / kPVWarps;
    constexpr int kDTiles = kWarpDims / 8;
    static_assert(kDTiles % 2 == 0, "V is read two n8 tiles at a time");
    constexpr int kItems = (kMaxG * HD / 4 + kThreads - 1) / kThreads;
    float o[kBf16 ? kDTiles : kItems][4];
#pragma unroll
    for (int j = 0; j < (kBf16 ? kDTiles : kItems); ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
    const int g = lane / 4, tig = lane % 4;  // mma fragment coordinates
    // bf16: rows g and g + 8; m is the row's, l this lane's share of it
    float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
    uint32_t qa[kBf16 ? HD / 16 : 1][4];

    for (int i = 0; i < n_tiles; ++i) {
      cp_async_wait<kStages - 2>();   // tile i has landed
      __syncthreads();                // ...for every thread; stage i-1 free
      load(i + kStages - 1);
      const int t0 = lo + i * kTile;
      const T* ks = k_s + (i % kStages) * kTile * kRow;
      const T* vs = v_s + (i % kStages) * kTile * kRow;

      if constexpr (kBf16) {
        if (i == 0) {
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk) {
            const bf16* r0 = q_s + g * L::kQRow + kk * 16 + tig * 2;
            qa[kk][0] = lds32(r0);
            qa[kk][1] = lds32(r0 + 8 * L::kQRow);
            qa[kk][2] = lds32(r0 + 8);
            qa[kk][3] = lds32(r0 + 8 * L::kQRow + 8);
          }
        }
        // S = Q K^T: warp w scores n8 tile w (slots t0 + 8 w ..) for the
        // 16 (padded) heads, scaled, capped and masked, into shared
        // memory; every warp then reads the whole tile back in the
        // accumulator layout: element e of n8 tile nt is row g + 8 (e / 2),
        // slot t0 + 8 nt + 2 tig + e % 2
        {
          float cw[4] = {0.f, 0.f, 0.f, 0.f};
          if constexpr (HD >= 32) {
            // k fragments four 8x8 matrices at a time: lane l addresses
            // slot l % 8 of the warp's n8 tile at dims 8 (l / 8) of a
            // k-step pair
#pragma unroll
            for (int kk = 0; kk < HD / 16; kk += 2) {
              uint32_t kb4[4];
              ldmatrix_x4(kb4, ks + (warp * 8 + lane % 8) * kRow + kk * 16 +
                                   (lane / 8) * 8);
              mma_bf16(cw, qa[kk], kb4[0], kb4[1]);
              mma_bf16(cw, qa[kk + 1], kb4[2], kb4[3]);
            }
          } else {
            const bf16* kr = ks + (warp * 8 + g) * kRow + tig * 2;
            mma_bf16(cw, qa[0], lds32(kr), lds32(kr + 8));
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = warp * 8 + tig * 2 + e % 2;
            float x = cw[e] * scale;
            if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
            const bool ok = t0 + col < hi && (t0 + col <= pos || ring_full);
            p_s[(g + 8 * (e / 2)) * L::kPRow + col] = ok ? x : kNegInf;
          }
        }
        __syncthreads();
        float c[kTile / 8][4];
#pragma unroll
        for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float2 x = *reinterpret_cast<const float2*>(
                p_s + (g + 8 * r) * L::kPRow + nt * 8 + tig * 2);
            c[nt][2 * r] = x.x;
            c[nt][2 * r + 1] = x.y;
          }
        float mx[2] = {kNegInf, kNegInf};
#pragma unroll
        for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], c[nt][e]);
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float m_new = fmaxf(m_r[r], mx[r]);
          alpha[r] = expf(m_r[r] - m_new);
          m_r[r] = m_new;
          l_r[r] *= alpha[r];
        }
#pragma unroll
        for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = expf(c[nt][e] - m_r[e / 2]);
            l_r[e / 2] += p;
            c[nt][e] = p;
          }
        // O = alpha O + P V, P rounded to bf16 (v's dtype)
        if (warp < kPVWarps) {
#pragma unroll
          for (int dt = 0; dt < kDTiles; ++dt) {
            o[dt][0] *= alpha[0];
            o[dt][1] *= alpha[0];
            o[dt][2] *= alpha[1];
            o[dt][3] *= alpha[1];
          }
          const int mi = lane / 8;
#pragma unroll
          for (int j = 0; j < kTile / 16; ++j) {
            uint32_t pa[4];
            pa[0] = pack_bf16(c[2 * j][0], c[2 * j][1]);
            pa[1] = pack_bf16(c[2 * j][2], c[2 * j][3]);
            pa[2] = pack_bf16(c[2 * j + 1][0], c[2 * j + 1][1]);
            pa[3] = pack_bf16(c[2 * j + 1][2], c[2 * j + 1][3]);
            // lane l gives row l % 8 of matrix l / 8: slots +8 for odd
            // matrices, dims +8 for the upper two
            const bf16* vrow = vs +
                               (j * 16 + (mi & 1) * 8 + lane % 8) * kRow +
                               warp * kWarpDims + (mi >> 1) * 8;
#pragma unroll
            for (int dt = 0; dt < kDTiles; dt += 2) {
              uint32_t vb4[4];
              ldmatrix_x4_trans(vb4, vrow + dt * 8);
              mma_bf16(o[dt], pa, vb4[0], vb4[1]);
              mma_bf16(o[dt + 1], pa, vb4[2], vb4[3]);
            }
          }
        }
      } else {
        // scores: lane = slot, each warp four heads sharing every k read
        const int g0 = warp * kRowsPerWarp;
        float sc[kRowsPerWarp];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) sc[r] = 0.f;
        if (g0 < G) {
#pragma unroll 4
          for (int d = 0; d < HD; d += 4) {
            const float4 kx =
                *reinterpret_cast<const float4*>(&ks[lane * kRow + d]);
#pragma unroll
            for (int r = 0; r < kRowsPerWarp; ++r) {
              const float4 qx = *reinterpret_cast<const float4*>(
                  &q_s[(g0 + r) * L::kQRow + d]);
              sc[r] = fmaf(qx.x, kx.x, sc[r]);
              sc[r] = fmaf(qx.y, kx.y, sc[r]);
              sc[r] = fmaf(qx.z, kx.z, sc[r]);
              sc[r] = fmaf(qx.w, kx.w, sc[r]);
            }
          }
        }
        const int slot = t0 + lane;
        const bool ok = slot < hi && (slot <= pos || ring_full);
        // online softmax: one row at a time, lane = slot
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const int row = g0 + r;
          if (row < G) {
            float x = sc[r] * scale;
            if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
            x = ok ? x : kNegInf;
            const float m_prev = m_s[row];
            const float m_new = fmaxf(m_prev, warp_max(x));
            const float p = expf(x - m_new);
            const float sum = warp_sum(p);
            p_s[row * L::kPRow + lane] = p;
            if (lane == 0) {
              const float a = expf(m_prev - m_new);
              l_s[row] = l_s[row] * a + sum;
              m_s[row] = m_new;
              alpha_s[row] = a;
            }
          }
        }
        __syncthreads();
        const int n = min(kTile, hi - t0);
#pragma unroll
        for (int j = 0; j < kItems; ++j) {
          const int it = tid + j * kThreads;
          if (it < G * HD / 4) {
            const int gg = it / (HD / 4), d = (it % (HD / 4)) * 4;
            const float al = alpha_s[gg];
#pragma unroll
            for (int e = 0; e < 4; ++e) o[j][e] *= al;
            for (int t = 0; t < n; ++t) {
              const float p = p_s[gg * L::kPRow + t];
              const float4 vx =
                  *reinterpret_cast<const float4*>(&vs[t * kRow + d]);
              o[j][0] = fmaf(p, vx.x, o[j][0]);
              o[j][1] = fmaf(p, vx.y, o[j][1]);
              o[j][2] = fmaf(p, vx.z, o[j][2]);
              o[j][3] = fmaf(p, vx.w, o[j][3]);
            }
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();   // the ring is read: the partials may lie over it

    // this block's partial: the unnormalised accumulator, m and l
    if constexpr (kBf16) {
      if (warp < kPVWarps) {
#pragma unroll
        for (int dt = 0; dt < kDTiles; ++dt) {
          const int d = warp * kWarpDims + dt * 8 + tig * 2;
          if (g < G)
            *reinterpret_cast<float2*>(acc_s + g * HD + d) =
                make_float2(o[dt][0], o[dt][1]);
          if (g + 8 < G)
            *reinterpret_cast<float2*>(acc_s + (g + 8) * HD + d) =
                make_float2(o[dt][2], o[dt][3]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
        l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
      }
      if (warp == 0 && tig == 0) {
        if (g < G) {
          ml_s[g] = m_r[0];
          ml_s[G + g] = l_r[0];
        }
        if (g + 8 < G) {
          ml_s[g + 8] = m_r[1];
          ml_s[G + g + 8] = l_r[1];
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const int it = tid + j * kThreads;
        if (it < G * HD / 4)
          *reinterpret_cast<float4*>(acc_s + it * 4) =
              make_float4(o[j][0], o[j][1], o[j][2], o[j][3]);
      }
      if (tid < G) {
        ml_s[tid] = m_s[tid];
        ml_s[G + tid] = l_s[tid];
      }
    }
  } else {
    // the chunk lies above pos and the ring is not full: no partial
    cp_async_commit();
    cp_async_wait<0>();
  }

  // Every partial of the cluster is in its block's shared memory. The
  // live splits are the first ceil(end / chunk). Each block takes the
  // weights exp(m_s - M) and normaliser of every head, then merges its
  // slice of the output, reading the partials of the live splits through
  // distributed shared memory in split-index order.
  cluster.sync();
  const int n_live = (end + chunk - 1) / chunk;
  float* lv_s = w_s + kMaxG * kMaxSplit;
  float* norm_s = lv_s + kMaxG * kMaxSplit;
  for (int i = tid; i < G * n_live; i += kThreads) {
    const int sp = i / G, gg = i % G;
    const float* ml = cluster.map_shared_rank(ml_s, sp);
    w_s[gg * kMaxSplit + sp] = ml[gg];
    lv_s[gg * kMaxSplit + sp] = ml[G + gg];
  }
  __syncthreads();
  if (tid < G) {
    float* w = w_s + tid * kMaxSplit;
    const float* lv = lv_s + tid * kMaxSplit;
    float M = kNegInf;
    for (int sp = 0; sp < n_live; ++sp) M = fmaxf(M, w[sp]);
    float l = 0.f;
    for (int sp = 0; sp < n_live; ++sp) {
      w[sp] = expf(w[sp] - M);
      l = fmaf(w[sp], lv[sp], l);
    }
    norm_s[tid] = fmaxf(l, 1e-30f);
  }
  __syncthreads();
  const int n4 = G * HD / 4;   // float4s of one partial
  const int per = (n4 + n_split - 1) / n_split;
  T* ob = out + (size_t)bk * G * HD;
  for (int it = split * per + tid; it < min(n4, (split + 1) * per);
       it += kThreads) {
    const int gg = it / (HD / 4);
    // every split's loads in flight at once, then the sum in order
    float4 a[kMaxSplit];
#pragma unroll
    for (int sp = 0; sp < kMaxSplit; ++sp)
      if (sp < n_live)
        a[sp] = reinterpret_cast<const float4*>(
            cluster.map_shared_rank(acc_s, sp))[it];
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int sp = 0; sp < kMaxSplit; ++sp)
      if (sp < n_live) {
        const float w = w_s[gg * kMaxSplit + sp];
        sum.x = fmaf(w, a[sp].x, sum.x);
        sum.y = fmaf(w, a[sp].y, sum.y);
        sum.z = fmaf(w, a[sp].z, sum.z);
        sum.w = fmaf(w, a[sp].w, sum.w);
      }
    const float l = norm_s[gg];
    T* o4 = ob + it * 4;
    store(o4 + 0, sum.x / l);
    store(o4 + 1, sum.y / l);
    store(o4 + 2, sum.z / l);
    store(o4 + 3, sum.w / l);
  }
  cluster.sync();   // no block leaves while another reads its partial
}

template <typename T, int HD>
int launch_hd(const void* q, const void* k, const void* v, const void* pos,
              void* out, int B, int W, int K, int G, int window, int chunk,
              int n_split, float scale, float softcap, cudaStream_t stream) {
  constexpr int bytes = Smem<T, HD>::bytes;
  // more than 48 KB of dynamic shared memory, and clusters of more than
  // the 8 blocks every card takes, only when opted in, once a device
  static bool opted[kMaxDevices] = {};
  const int dev = current_device();
  if (dev < 0) return -1;
  if (!opted[dev]) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_attention_kernel<T, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(decode_attention_kernel<T, HD>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, B * K, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, decode_attention_kernel<T, HD>, static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int32_t*>(pos), static_cast<T*>(out), W, K, G,
      window, chunk, scale, softcap);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_typed(const void* q, const void* k, const void* v,
                 const void* pos, void* out, int B, int W, int K, int G,
                 int hd, int window, int chunk, int n_split, float scale,
                 float softcap, cudaStream_t stream) {
#define DA_LAUNCH(HD)                                                    \
  launch_hd<T, HD>(q, k, v, pos, out, B, W, K, G, window, chunk, n_split, \
                   scale, softcap, stream)
  switch (hd) {
    case 16:
      return DA_LAUNCH(16);
    case 32:
      return DA_LAUNCH(32);
    case 64:
      return DA_LAUNCH(64);
    case 128:
      return DA_LAUNCH(128);
    case 256:
      return DA_LAUNCH(256);
    default:
      return -1;
  }
#undef DA_LAUNCH
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; chunk and n_split from the
// wrapper's split plan (n_split <= 16, one cluster). Returns 0 on a good
// launch.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* pos,
                                       void* out, int B, int W, int K, int G,
                                       int hd, int window, int chunk,
                                       int n_split, float scale,
                                       float softcap, int dtype,
                                       void* stream) {
  if (B < 1 || W < 1 || K < 1 || G < 1 || G > kMaxG || window < 1 ||
      chunk < kTile || chunk % kTile || n_split < 1 || n_split > kMaxSplit ||
      B * K > 65535 || (long long)chunk * (n_split - 1) >= W ||
      (long long)chunk * n_split < W)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_typed<float>(q, k, v, pos, out, B, W, K, G, hd, window,
                               chunk, n_split, scale, softcap, s);
  if (dtype == 1)
    return launch_typed<bf16>(q, k, v, pos, out, B, W, K, G, hd, window,
                              chunk, n_split, scale, softcap, s);
  return -1;
}
