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
// tensor-core peak. What the design does about it:
//   * one thread block per (batch row, kv head) reads that head's slice
//     of the cache exactly once, for all G query heads at a time;
//   * the cache is read in 32-slot tiles with 16-byte loads, and the next
//     tile's loads are issued into registers before the current tile is
//     computed, so memory latency overlaps the arithmetic;
//   * the arithmetic reads shared memory as float4 and reuses each cache
//     vector for two query heads, so shared-memory bandwidth is not the
//     limit it would be with one scalar read per multiply-add;
//   * `pos` is read from device memory (the TPU kernel's SMEM scalar
//     prefetch), so no host sync is needed, and while the ring is not
//     full the loop stops at the last valid slot instead of reading and
//     masking the empty rest;
//   * the cache is not padded to the tile: the ragged last tile is masked
//     here, so the caller copies nothing;
//   * the shared tiles are dynamic shared memory, sized by head_dim: at
//     head_dim 256 (recurrentgemma-2b, G = 10) they come to 84 KB, over
//     the 48 KB a block may hold statically.
// The grid is only B*K blocks (16 at glm4-9b, 8 at recurrentgemma-2b, on
// 132 SMs), so one launch sits far from its bound. Splitting the cache
// across blocks with a combine step is the way to fill the card.
//
// Plain C interface, loaded with ctypes: decode_attention_launch returns
// cudaGetLastError() after the launch, or -1 for arguments it does not
// take (the Python wrapper checks them first, including the 16-byte
// alignment of k and v).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;   // cache slots per tile: one per lane
constexpr int kMaxG = 16;   // query heads per kv head: two per warp
constexpr float kNegInf = -1e30f;
static_assert(kTile == 32, "the softmax pass maps one slot to each lane");
static_assert(kMaxG <= 2 * kWarps,
              "the score pass gives each warp two heads");

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// softmax weights rounded to the value dtype before the PV product
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// one 16-byte vector of the cache, widened to f32 in shared memory
__device__ __forceinline__ void widen(const uint4& u, float* dst,
                                      const float*) {
  *reinterpret_cast<float4*>(dst) = make_float4(
      __uint_as_float(u.x), __uint_as_float(u.y), __uint_as_float(u.z),
      __uint_as_float(u.w));
}
// a bf16 is the high half of the f32 with the same bits: the first
// (lower-addressed) element of a packed pair is the low 16 bits
__device__ __forceinline__ float lo_bf16(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_bf16(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ void widen(const uint4& u, float* dst,
                                      const __nv_bfloat16*) {
  reinterpret_cast<float4*>(dst)[0] =
      make_float4(lo_bf16(u.x), hi_bf16(u.x), lo_bf16(u.y), hi_bf16(u.y));
  reinterpret_cast<float4*>(dst)[1] =
      make_float4(lo_bf16(u.z), hi_bf16(u.z), lo_bf16(u.w), hi_bf16(u.w));
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b,
                                      float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
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

// Shared memory, in floats: q (kMaxG x HD), the k tile (rows padded so
// that float4 reads by slot hit all banks), the v tile, the weights p
// (kMaxG x kTile, padded) and the per-head softmax state m, l, alpha.
template <int HD>
struct Smem {
  static constexpr int kRow = HD + 4;
  static constexpr int kPRow = kTile + 1;
  static constexpr int q_off = 0;
  static constexpr int k_off = q_off + kMaxG * HD;
  static constexpr int v_off = k_off + kTile * kRow;
  static constexpr int p_off = v_off + kTile * HD;
  static constexpr int m_off = p_off + kMaxG * kPRow;
  static constexpr int l_off = m_off + kMaxG;
  static constexpr int alpha_off = l_off + kMaxG;
  static constexpr int floats = alpha_off + kMaxG;
  static constexpr size_t bytes = floats * sizeof(float);
  static_assert(k_off % 4 == 0 && v_off % 4 == 0 && kRow % 4 == 0,
                "the q, k and v tiles are read as float4");
};

// q, out: (B, K, G, HD) == (B, H, HD); k, v: (B, W, K, HD); pos: one int32.
// One block per SM is all the grid (B*K blocks) can use; declaring it stops
// ptxas from capping registers for occupancy, which spilled a few bytes
// in the smaller instances.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int32_t* __restrict__ pos_ptr,
                        T* __restrict__ out, int W, int K, int G, int window,
                        float scale, float softcap) {
  constexpr int kPerVec = 16 / sizeof(T);            // elements per load
  constexpr int kVecsPerSlot = HD / kPerVec;
  constexpr int kTileVecs = kTile * kVecsPerSlot;
  constexpr int kLoads = (kTileVecs + kThreads - 1) / kThreads;
  constexpr int kOutVecs = (kMaxG * HD / 4 + kThreads - 1) / kThreads;
  using L = Smem<HD>;
  extern __shared__ __align__(16) float smem[];
  auto q_s = reinterpret_cast<float(*)[HD]>(smem + L::q_off);
  auto k_s = reinterpret_cast<float(*)[L::kRow]>(smem + L::k_off);
  auto v_s = reinterpret_cast<float(*)[HD]>(smem + L::v_off);
  auto p_s = reinterpret_cast<float(*)[L::kPRow]>(smem + L::p_off);
  float* m_s = smem + L::m_off;
  float* l_s = smem + L::l_off;
  float* alpha_s = smem + L::alpha_off;

  const int b = blockIdx.x / K, kv = blockIdx.x % K;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int pos = *pos_ptr;
  const bool ring_full = pos + 1 >= window;
  const int end = ring_full ? W : min(W, pos + 1);

  const T* qb = q + ((size_t)b * K + kv) * G * HD;
  for (int i = tid; i < G * HD; i += kThreads)
    q_s[i / HD][i % HD] = load_f32(qb + i);
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float4 acc[kOutVecs];
#pragma unroll
  for (int j = 0; j < kOutVecs; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);

  const size_t slot_stride = (size_t)K * HD;
  const T* kb = k + (size_t)b * W * slot_stride + (size_t)kv * HD;
  const T* vb = v + (size_t)b * W * slot_stride + (size_t)kv * HD;

  // this thread's share of one tile, in flight in registers
  uint4 k_r[kLoads], v_r[kLoads];
  auto fetch = [&](int t0, int n) {
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i = tid + j * kThreads;
      const int t = i / kVecsPerSlot, c = i % kVecsPerSlot;
      if (i < kTileVecs && t < n) {
        const size_t off = (size_t)(t0 + t) * slot_stride + c * kPerVec;
        k_r[j] = *reinterpret_cast<const uint4*>(kb + off);
        v_r[j] = *reinterpret_cast<const uint4*>(vb + off);
      } else {
        k_r[j] = make_uint4(0u, 0u, 0u, 0u);
        v_r[j] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };

  const int g0 = warp, g1 = warp + kWarps;  // score pass: this warp's heads
  if (end > 0) fetch(0, min(kTile, end));
  for (int t0 = 0; t0 < end; t0 += kTile) {
    const int n = min(kTile, end - t0);
    __syncthreads();  // the previous tile's readers are done
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i = tid + j * kThreads;
      if (i < kTileVecs) {
        const int t = i / kVecsPerSlot, c = i % kVecsPerSlot;
        widen(k_r[j], &k_s[t][c * kPerVec], k);
        widen(v_r[j], &v_s[t][c * kPerVec], k);
      }
    }
    __syncthreads();
    if (t0 + kTile < end) fetch(t0 + kTile, min(kTile, end - t0 - kTile));

    // scores: lane = slot, each warp two heads sharing every k read
    if (g0 < G) {
      const bool two = g1 < G;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; d += 4) {
        const float4 kx = *reinterpret_cast<const float4*>(&k_s[lane][d]);
        s0 = dot4(*reinterpret_cast<const float4*>(&q_s[g0][d]), kx, s0);
        if (two)
          s1 = dot4(*reinterpret_cast<const float4*>(&q_s[g1][d]), kx, s1);
      }
      const int slot = t0 + lane;
      const bool valid = lane < n && (slot <= pos || ring_full);
      s0 *= scale;
      if (softcap > 0.f) s0 = tanhf(s0 / softcap) * softcap;
      p_s[g0][lane] = valid ? s0 : kNegInf;
      if (two) {
        s1 *= scale;
        if (softcap > 0.f) s1 = tanhf(s1 / softcap) * softcap;
        p_s[g1][lane] = valid ? s1 : kNegInf;
      }
    }
    __syncthreads();
    // online softmax statistics: one warp per head, one lane per slot
    for (int g = warp; g < G; g += kWarps) {
      const float s = p_s[g][lane];
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float p = expf(s - m_new);
      const float sum = warp_sum(p);
      p_s[g][lane] = round_to(p, k);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
        alpha_s[g] = alpha;
      }
    }
    __syncthreads();
    // rescale and accumulate: each thread owns kOutVecs (head, 4 dims)
#pragma unroll
    for (int j = 0; j < kOutVecs; ++j) {
      const int i = tid + j * kThreads;
      if (i < G * HD / 4) {
        const int g = i / (HD / 4), d = (i % (HD / 4)) * 4;
        const float al = alpha_s[g];
        float4 a = acc[j];
        a.x *= al;
        a.y *= al;
        a.z *= al;
        a.w *= al;
        for (int t = 0; t < n; ++t) {
          const float p = p_s[g][t];
          const float4 vx = *reinterpret_cast<const float4*>(&v_s[t][d]);
          a.x = fmaf(p, vx.x, a.x);
          a.y = fmaf(p, vx.y, a.y);
          a.z = fmaf(p, vx.z, a.z);
          a.w = fmaf(p, vx.w, a.w);
        }
        acc[j] = a;
      }
    }
  }
  __syncthreads();
  T* ob = out + ((size_t)b * K + kv) * G * HD;
#pragma unroll
  for (int j = 0; j < kOutVecs; ++j) {
    const int i = tid + j * kThreads;
    if (i < G * HD / 4) {
      const int g = i / (HD / 4), d = (i % (HD / 4)) * 4;
      const float l = fmaxf(l_s[g], 1e-30f);
      T* o = ob + g * HD + d;
      store(o + 0, acc[j].x / l);
      store(o + 1, acc[j].y / l);
      store(o + 2, acc[j].z / l);
      store(o + 3, acc[j].w / l);
    }
  }
}

template <typename T, int HD>
int launch_hd(const void* q, const void* k, const void* v, const void* pos,
              void* out, int B, int W, int K, int G, int window, float scale,
              float softcap, cudaStream_t stream) {
  constexpr size_t bytes = Smem<HD>::bytes;
  // more than 48 KB of dynamic shared memory only when opted in
  const cudaError_t e = cudaFuncSetAttribute(
      decode_attention_kernel<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  decode_attention_kernel<T, HD><<<B * K, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(pos),
      static_cast<T*>(out), W, K, G, window, scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_typed(const void* q, const void* k, const void* v,
                 const void* pos, void* out, int B, int W, int K, int G,
                 int hd, int window, float scale, float softcap,
                 cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch_hd<T, 16>(q, k, v, pos, out, B, W, K, G, window, scale,
                              softcap, stream);
    case 32:
      return launch_hd<T, 32>(q, k, v, pos, out, B, W, K, G, window, scale,
                              softcap, stream);
    case 64:
      return launch_hd<T, 64>(q, k, v, pos, out, B, W, K, G, window, scale,
                              softcap, stream);
    case 128:
      return launch_hd<T, 128>(q, k, v, pos, out, B, W, K, G, window, scale,
                               softcap, stream);
    case 256:
      return launch_hd<T, 256>(q, k, v, pos, out, B, W, K, G, window, scale,
                               softcap, stream);
    default:
      return -1;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns 0 on a good launch.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* pos,
                                       void* out, int B, int W, int K, int G,
                                       int hd, int window, float scale,
                                       float softcap, int dtype,
                                       void* stream) {
  if (B < 1 || W < 1 || K < 1 || G < 1 || G > kMaxG || window < 1)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_typed<float>(q, k, v, pos, out, B, W, K, G, hd, window,
                               scale, softcap, s);
  if (dtype == 1)
    return launch_typed<__nv_bfloat16>(q, k, v, pos, out, B, W, K, G, hd,
                                       window, scale, softcap, s);
  return -1;
}
