// Blocked GQA flash attention (forward), for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py:84
// flash_attention_kernel (body `_kernel`). q (B,S,H,hd) attends over
// k/v (B,T,K,hd); query head h reads kv head h / (H/K). The causal,
// sliding-window and key-length masks come from the indices 0..S-1 and
// 0..T-1, the logits may be soft-capped, and the softmax is an online one
// in f32. As on the TPU: masked scores are -1e30 (not -inf), the weights
// are rounded to v's dtype before the PV product, PV accumulates in f32,
// the normaliser is clamped at 1e-30 and the output is in q's dtype.
//
// Where the TPU runs the k blocks as a sequential grid dimension with the
// accumulator in VMEM scratch, here one thread block owns one
// (batch, query head, q tile) and loops over the key tiles itself, with m,
// l and the accumulator in registers.
//
// What bounds it on this card: operations. At glm4-9b's forward shape
// (B=2, S=T=4096, H=32, K=2, hd=128, causal, bf16) the causal half of
// QK^T and PV is 2.75e11 FLOP, 0.28 ms at the 989 TFLOP/s bf16
// tensor-core peak, against ~143 MB of q, k, v and output, 0.043 ms at
// 3.35 TB/s. Only wgmma reaches that rate. What the design does about it:
//   * tiles that cannot contribute are never loaded or computed: above
//     the causal diagonal, before the window and past T. At causal
//     S=4096 that halves the work, as on the TPU; the q tiles are issued
//     heaviest first (the diagonal is last in q), so causal blocks do not
//     leave a long tail;
//   * bf16 at head_dim 128 and 256 (the model's): 128-row q tiles, two
//     consumer warpgroups on wgmma (S = Q K^T from shared memory, P fed
//     from registers for O += P V) and one producer thread that keeps
//     two-stage rings of k and v tiles in flight with TMA and mbarriers;
//     the producer hands its registers to the consumers (setmaxnreg),
//     whose O accumulator is 64 (hd 128) or 128 (hd 256) f32 registers a
//     thread. A warpgroup issues tile i's QK^T and tile i-1's PV together
//     and runs tile i's softmax while the PV is on the tensor cores, and
//     the two warpgroups take turns issuing (ping-pong), so one's softmax
//     runs under the other's products; to keep their turns paired both
//     walk every tile of the block, masking what one of them cannot see.
//     Tiles are 128 keys at hd 128 (160 KB of shared memory) and 64 at hd
//     256 (192 KB). The TMA maps are encoded on the host at each call,
//     through the runtime's driver entry point (no -lcuda);
//   * bf16 at head_dim 8 to 64 (the reference's test grid, the smoke
//     configs, and whisper-small's and internvl2-1b's head_dim 64) stays
//     on mma.sync.m16n8k16 with 64-row tiles, S and P in registers, and
//     the next k/v tile copied with cp.async under this one's products
//     (head_dim 8, command-r-35b's smoke config, pads its k-step of 16
//     with zeros);
//   * the f32 instance stays on the CUDA cores' f32 FMAs, which keeps it
//     exact to 2e-5 (a 4x4 block of scores per thread, float4
//     shared-memory reads, the next tile's 16-byte loads in flight in
//     registers; 32-key tiles at head_dim 256).
// Every instance rounds at the same points: f32 scores, f32 online
// softmax, p rounded to v's dtype before PV, f32 accumulation. A block
// owns one q tile (no persistent loop over tiles).
//
// The PTX building blocks (mbarriers, TMA, wgmma, mma.sync) are in
// sm90.cuh, shared with K2 and K5.
//
// Plain C interface, loaded with ctypes: flash_attention_launch returns
// cudaGetLastError() after the launch, -2 where a TMA map cannot be
// encoded, or -1 for arguments it does not take (the Python wrapper
// checks them first, including the 16-byte alignment of q, k and v).

#include "sm90.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;   // query rows per block: 16 row groups of 4
constexpr int kCG = 16;   // column groups; tid = row group * kCG + column group
constexpr float kNegInf = -1e30f;
static_assert(kThreads == (kBQ / 4) * kCG, "one thread per 4-row block");

// keys per tile: 64, or 32 at head_dim 256, where a thread's registers
// and a block's shared memory would not hold 64
template <int HD>
constexpr int keys_per_tile() {
  return HD >= 256 ? 32 : 64;
}

// ----------------------------------------------- f32: CUDA-core FMAs ----

__device__ __forceinline__ float dot4(const float4& a, const float4& b,
                                      float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

// reductions over the 16 lanes of one row group (a half warp)
__device__ __forceinline__ float group_max(float x) {
  for (int o = kCG / 2; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float group_sum(float x) {
  for (int o = kCG / 2; o > 0; o >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Shared-memory layout, in floats. Rows of k are padded so that the
// float4 reads of 8 neighbouring keys hit distinct banks; q rows are read
// as broadcasts and v rows contiguously, so they need no padding. p is
// kept transposed (key-major) so one float4 holds a thread's 4 rows. A
// thread scores its 4 rows against keys cg + 16 j, j < kKJ.
template <int HD>
struct Layout {
  static constexpr int kBK = keys_per_tile<HD>();
  static constexpr int kKJ = kBK / kCG;
  static constexpr int kKRow = HD + 4;
  static constexpr int kPRow = kBQ + 4;
  static constexpr int q_off = 0;
  static constexpr int k_off = q_off + kBQ * HD;
  static constexpr int v_off = k_off + kBK * kKRow;
  static constexpr int p_off = v_off + kBK * HD;
  static constexpr int floats = p_off + kBK * kPRow;
  static constexpr size_t bytes = floats * sizeof(float);
  static_assert(kBK % kCG == 0, "each column group takes kKJ keys");
};

// The output dims a thread owns: HD/16 of them, as float4 runs at
// (cg + 16 j) * 4 where HD >= 64, else single dims at cg + 16 j.
template <int HD>
__device__ __forceinline__ int out_dim(int cg, int dd) {
  if constexpr (HD >= 64)
    return (cg + kCG * (dd / 4)) * 4 + dd % 4;
  else
    return cg + kCG * dd;
}

// q, out: (B, S, H, HD); k, v: (B, T, K, HD). Both instances declare one
// block per SM as their minimum: without it ptxas capped the registers of
// the head_dim 64 instances for occupancy and spilled.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           float* __restrict__ out, int S, int T_len, int H,
                           int K, int causal, int window, float scale,
                           float softcap) {
  using L = Layout<HD>;
  constexpr int kBK = L::kBK;
  constexpr int kKJ = L::kKJ;
  // output dims per thread; at head_dim 8 the first 8 column groups own
  // one dim each and the other 8 none
  constexpr int kDPT = HD >= kCG ? HD / kCG : 1;
  constexpr int kPerVec = 4;                     // floats per 16 bytes
  constexpr int kVecsPerRow = HD / kPerVec;
  constexpr int kTileVecs = kBK * kVecsPerRow;
  constexpr int kLoads = (kTileVecs + kThreads - 1) / kThreads;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem + L::q_off;
  float* k_s = smem + L::k_off;
  float* v_s = smem + L::v_off;
  float* p_s = smem + L::p_off;

  const int qt = gridDim.x - 1 - blockIdx.x;     // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / K);
  const int q_lo = qt * kBQ;
  const int tid = threadIdx.x, rg = tid / kCG, cg = tid % kCG;
  const int row0 = rg * 4;                       // this thread's 4 rows
  const bool owns = HD >= kCG || cg < HD;        // an output dim

  // q tile, rows past S zero-filled
  const size_t q_row = (size_t)H * HD;           // elements between rows
  const float* qb = q + ((size_t)b * S * H + h) * HD;
  for (int i = tid; i < kBQ * kVecsPerRow; i += kThreads) {
    const int r = i / kVecsPerRow, c = i % kVecsPerRow;
    float4 u = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q_lo + r < S)
      u = *reinterpret_cast<const float4*>(qb + (size_t)(q_lo + r) * q_row +
                                           c * kPerVec);
    *reinterpret_cast<float4*>(q_s + r * HD + c * kPerVec) = u;
  }

  // the k tiles that can contribute: [k_begin, k_end)
  int k_begin = 0;
  if (window > 0 && q_lo - window + 1 > 0)
    k_begin = (q_lo - window + 1) / kBK * kBK;
  const int k_end = causal ? min(T_len, q_lo + kBQ) : T_len;

  const size_t kv_row = (size_t)K * HD;
  const float* kb = k + ((size_t)b * T_len * K + kvh) * HD;
  const float* vb = v + ((size_t)b * T_len * K + kvh) * HD;
  // this thread's share of one k/v tile, in flight in registers
  float4 k_r[kLoads], v_r[kLoads];
  auto fetch = [&](int t0) {
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i = tid + j * kThreads;
      const int t = i / kVecsPerRow, c = i % kVecsPerRow;
      if (i < kTileVecs && t0 + t < T_len) {
        const size_t off = (size_t)(t0 + t) * kv_row + c * kPerVec;
        k_r[j] = *reinterpret_cast<const float4*>(kb + off);
        v_r[j] = *reinterpret_cast<const float4*>(vb + off);
      } else {
        k_r[j] = make_float4(0.f, 0.f, 0.f, 0.f);
        v_r[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  };

  float acc[4][kDPT];
  float m_r[4], l_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_r[i] = kNegInf;
    l_r[i] = 0.f;
#pragma unroll
    for (int dd = 0; dd < kDPT; ++dd) acc[i][dd] = 0.f;
  }

  if (k_begin < k_end) fetch(k_begin);
  for (int t0 = k_begin; t0 < k_end; t0 += kBK) {
    __syncthreads();  // q_s written; the previous tile's readers are done
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i = tid + j * kThreads;
      if (i < kTileVecs) {
        const int t = i / kVecsPerRow, c = i % kVecsPerRow;
        *reinterpret_cast<float4*>(k_s + t * L::kKRow + c * kPerVec) = k_r[j];
        *reinterpret_cast<float4*>(v_s + t * HD + c * kPerVec) = v_r[j];
      }
    }
    __syncthreads();
    if (t0 + kBK < k_end) fetch(t0 + kBK);

    // scores of rows row0..row0+3 against keys cg + 16 j
    float s[4][kKJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kKJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[4], kx[kKJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(q_s + (row0 + i) * HD + d);
#pragma unroll
      for (int j = 0; j < kKJ; ++j)
        kx[j] = *reinterpret_cast<const float4*>(
            k_s + (cg + kCG * j) * L::kKRow + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kKJ; ++j) s[i][j] = dot4(qv[i], kx[j], s[i][j]);
    }

    // masks and the online softmax, one row at a time
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q_lo + row0 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kKJ; ++j) {
        const int c = t0 + cg + kCG * j;
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        bool ok = c < T_len;
        if (causal) ok = ok && c <= r;
        if (window > 0) ok = ok && c > r - window;
        s[i][j] = ok ? x : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m_r[i], group_max(mx));
      const float alpha = expf(m_r[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kKJ; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      l_r[i] = l_r[i] * alpha + group_sum(sum);
      m_r[i] = m_new;
#pragma unroll
      for (int dd = 0; dd < kDPT; ++dd) acc[i][dd] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < kKJ; ++j)
      *reinterpret_cast<float4*>(p_s + (cg + kCG * j) * L::kPRow + row0) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // PV: acc[i][:] += sum over keys t of p[t][row0 + i] * v[t][:]
#pragma unroll 4
    for (int t = 0; t < kBK; ++t) {
      const float4 p = *reinterpret_cast<const float4*>(p_s + t * L::kPRow +
                                                        row0);
      float vx[kDPT];
      if constexpr (HD >= 64) {
#pragma unroll
        for (int jj = 0; jj < kDPT / 4; ++jj) {
          const float4 w = *reinterpret_cast<const float4*>(
              v_s + t * HD + (cg + kCG * jj) * 4);
          vx[4 * jj + 0] = w.x;
          vx[4 * jj + 1] = w.y;
          vx[4 * jj + 2] = w.z;
          vx[4 * jj + 3] = w.w;
        }
      } else {
#pragma unroll
        for (int dd = 0; dd < kDPT; ++dd)
          vx[dd] = owns ? v_s[t * HD + cg + kCG * dd] : 0.f;
      }
#pragma unroll
      for (int dd = 0; dd < kDPT; ++dd) {
        acc[0][dd] = fmaf(p.x, vx[dd], acc[0][dd]);
        acc[1][dd] = fmaf(p.y, vx[dd], acc[1][dd]);
        acc[2][dd] = fmaf(p.z, vx[dd], acc[2][dd]);
        acc[3][dd] = fmaf(p.w, vx[dd], acc[3][dd]);
      }
    }
  }

  float* ob = out + ((size_t)b * S * H + h) * HD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q_lo + row0 + i;
    if (r < S && owns) {
      const float l = fmaxf(l_r[i], 1e-30f);
      float* o = ob + (size_t)r * q_row;
#pragma unroll
      for (int dd = 0; dd < kDPT; ++dd)
        o[out_dim<HD>(cg, dd)] = acc[i][dd] / l;
    }
  }
}

// -------------------------------- bf16 at head_dim 8 to 64: mma.sync ----
//
// The bf16 instance below head_dim 128 runs QK^T and PV on the tensor
// cores with
// mma.sync.m16n8k16 (bf16 in, f32 accumulate). Four warps share one
// 64-row q tile, 16 rows each. Each warp keeps its q rows as A fragments
// in registers for the whole loop; k and v tiles are copied into shared
// memory with cp.async, two stages deep, so the next tile's copy runs
// under this tile's products. S = QK^T stays in registers, and its
// accumulator layout is already the A-fragment layout of P for the PV
// product, so P never goes through shared memory; v is read with
// ldmatrix.trans. The rounding points are the same as the f32-FMA
// kernel's: f32 scores, f32 online softmax, p rounded to bf16 before PV
// (which the tensor core's bf16 input needs anyway), f32 accumulation.

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
static_assert(kBQ == 16 * kMmaWarps, "one 16-row m-tile per warp");

template <int HD>
struct MmaLayout {
  static constexpr int kBK = keys_per_tile<HD>();
  static constexpr int kRow = HD + 8;  // bf16 elements; +16 B: no conflicts
  static constexpr int q_off = 0;
  static constexpr int k_off = q_off + kBQ * kRow;      // two stages
  static constexpr int v_off = k_off + 2 * kBK * kRow;  // two stages
  static constexpr int elems = v_off + 2 * kBK * kRow;
  static constexpr size_t bytes = elems * sizeof(__nv_bfloat16);
};

template <int HD>
__global__ void __launch_bounds__(kMmaThreads, 1)
flash_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           __nv_bfloat16* __restrict__ out, int S,
                           int T_len, int H, int K, int causal, int window,
                           float scale, float softcap) {
  using L = MmaLayout<HD>;
  constexpr int kRow = L::kRow;
  constexpr int kBK = L::kBK;
  // k-steps of QK^T; head_dim 8 pads its one k-step with zeros (q's and
  // k's dims 8-15 enter as 0, not as shared memory)
  constexpr int kKSteps = (HD + 15) / 16;
  static_assert(HD <= 64, "head_dim 128 and 256 take the wgmma kernel");
  constexpr int kNTiles = kBK / 8;        // 8-key n-tiles of S
  constexpr int kDTiles = HD / 8;         // 8-dim n-tiles of O
  constexpr int kVecsPerRow = HD / 8;     // 16-byte vectors per row
  extern __shared__ __align__(16) __nv_bfloat16 mma_smem[];
  __nv_bfloat16* q_s = mma_smem + L::q_off;
  __nv_bfloat16* k_s = mma_smem + L::k_off;
  __nv_bfloat16* v_s = mma_smem + L::v_off;

  const int qt = gridDim.x - 1 - blockIdx.x;     // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / K);
  const int q_lo = qt * kBQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;        // mma fragment coordinates
  const int wrow = warp * 16;                    // this warp's first row

  const size_t q_row = (size_t)H * HD;
  const size_t kv_row = (size_t)K * HD;
  const __nv_bfloat16* qb = q + ((size_t)b * S * H + h) * HD;
  const __nv_bfloat16* kb = k + ((size_t)b * T_len * K + kvh) * HD;
  const __nv_bfloat16* vb = v + ((size_t)b * T_len * K + kvh) * HD;

  int k_begin = 0;
  if (window > 0 && q_lo - window + 1 > 0)
    k_begin = (q_lo - window + 1) / kBK * kBK;
  const int k_end = causal ? min(T_len, q_lo + kBQ) : T_len;

  // q tile (rows past S zero-filled) and the first k/v tile: one group
  for (int i = tid; i < kBQ * kVecsPerRow; i += kMmaThreads) {
    const int r = i / kVecsPerRow, c = (i % kVecsPerRow) * 8;
    const bool ok = q_lo + r < S;
    cp_async16(q_s + r * kRow + c,
               qb + (ok ? (size_t)(q_lo + r) * q_row + c : 0), ok);
  }
  auto load_kv = [&](int t0, int stage) {
    __nv_bfloat16* ks = k_s + stage * kBK * kRow;
    __nv_bfloat16* vs = v_s + stage * kBK * kRow;
    for (int i = tid; i < kBK * kVecsPerRow; i += kMmaThreads) {
      const int t = i / kVecsPerRow, c = (i % kVecsPerRow) * 8;
      const bool ok = t0 + t < T_len;
      const size_t off = ok ? (size_t)(t0 + t) * kv_row + c : 0;
      cp_async16(ks + t * kRow + c, kb + off, ok);
      cp_async16(vs + t * kRow + c, vb + off, ok);
    }
  };
  if (k_begin < k_end) load_kv(k_begin, 0);
  cp_async_commit();

  float o[kDTiles][4];
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  // rows wrow + g (index 0) and wrow + g + 8 (index 1); l is this
  // thread's partial sum over its columns, reduced over the 4 lanes of
  // the row at the end
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
  uint32_t qa[kKSteps][4];
  // the A fragment of this warp's 16 q rows at k-step ks
  auto load_q = [&](uint32_t(&a)[4], int ks) {
    const __nv_bfloat16* r0 = q_s + (wrow + g) * kRow + ks * 16 + tig * 2;
    a[0] = *reinterpret_cast<const uint32_t*>(r0);
    a[1] = *reinterpret_cast<const uint32_t*>(r0 + 8 * kRow);
    a[2] = HD >= 16 ? *reinterpret_cast<const uint32_t*>(r0 + 8) : 0u;
    a[3] = HD >= 16 ? *reinterpret_cast<const uint32_t*>(r0 + 8 * kRow + 8)
                    : 0u;
  };

  int stage = 0;
  for (int t0 = k_begin; t0 < k_end; t0 += kBK, stage ^= 1) {
    const bool more = t0 + kBK < k_end;
    if (more) load_kv(t0 + kBK, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();                 // all but the newest group landed
    __syncthreads();
    if (t0 == k_begin) {
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks) load_q(qa[ks], ks);
    }
    const __nv_bfloat16* ks_ = k_s + stage * kBK * kRow;
    const __nv_bfloat16* vs_ = v_s + stage * kBK * kRow;

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys
    float sc[kNTiles][4];
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
      const uint32_t(&a)[4] = qa[ks];
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt) {
        const __nv_bfloat16* kr = ks_ + (nt * 8 + g) * kRow + ks * 16 + tig * 2;
        mma_bf16(sc[nt], a, *reinterpret_cast<const uint32_t*>(kr),
                 HD >= 16 ? *reinterpret_cast<const uint32_t*>(kr + 8) : 0u);
      }
    }

    // masks and the online softmax; element e of n-tile nt is row
    // wrow + g + 8 (e / 2), key t0 + nt * 8 + tig * 2 + e % 2
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = q_lo + wrow + g + 8 * (e / 2);
        const int c = t0 + nt * 8 + tig * 2 + e % 2;
        float x = sc[nt][e] * scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        bool ok = c < T_len;
        if (causal) ok = ok && c <= r;
        if (window > 0) ok = ok && c > r - window;
        sc[nt][e] = ok ? x : kNegInf;
        mx[e / 2] = fmaxf(mx[e / 2], sc[nt][e]);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_r[i], mx[i]);
      alpha[i] = expf(m_r[i] - m_new);
      m_r[i] = m_new;
      l_r[i] *= alpha[i];
    }
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(sc[nt][e] - m_r[e / 2]);
        l_r[e / 2] += p;
        sc[nt][e] = p;
      }
#pragma unroll
    for (int dt = 0; dt < kDTiles; ++dt) {
      o[dt][0] *= alpha[0];
      o[dt][1] *= alpha[0];
      o[dt][2] *= alpha[1];
      o[dt][3] *= alpha[1];
    }

    // O += P V: P's A fragments come straight from S's accumulators
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
      uint32_t pa[4];
      pa[0] = pack_bf16(sc[2 * j][0], sc[2 * j][1]);
      pa[1] = pack_bf16(sc[2 * j][2], sc[2 * j][3]);
      pa[2] = pack_bf16(sc[2 * j + 1][0], sc[2 * j + 1][1]);
      pa[3] = pack_bf16(sc[2 * j + 1][2], sc[2 * j + 1][3]);
      // lane l gives row l % 8 of matrix l / 8: keys +8 for odd
      // matrices, dims +8 for the upper two
      const int mi = lane / 8;
      const __nv_bfloat16* vrow =
          vs_ + (j * 16 + (mi & 1) * 8 + lane % 8) * kRow + (mi >> 1) * 8;
#pragma unroll
      for (int dt = 0; dt < kDTiles; dt += 2) {
        uint32_t vb4[4];
        // (head_dim 8: matrices 2 and 3 lie in the rows' padding, read
        // and left unused)
        ldmatrix_x4_trans(vb4, vrow + dt * 8);
        mma_bf16(o[dt], pa, vb4[0], vb4[1]);
        if constexpr (kDTiles > 1) mma_bf16(o[dt + 1], pa, vb4[2], vb4[3]);
      }
    }
    __syncthreads();  // this stage is read; the next prefetch may reuse it
  }
  cp_async_wait<0>();

  __nv_bfloat16* ob = out + ((size_t)b * S * H + h) * HD;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_r[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l = fmaxf(l, 1e-30f);
    const int r = q_lo + wrow + g + 8 * i;
    if (r < S) {
      __nv_bfloat16* orow = ob + (size_t)r * q_row + tig * 2;
#pragma unroll
      for (int dt = 0; dt < kDTiles; ++dt)
        *reinterpret_cast<__nv_bfloat162*>(orow + dt * 8) =
            __floats2bfloat162_rn(o[dt][2 * i] / l, o[dt][2 * i + 1] / l);
    }
  }
}

// ------------------------------------- bf16 at head_dim 128 and 256: wgmma --
//
// One block owns a 128-row q tile of one (batch, head): two consumer
// warpgroups of 64 rows each and a producer warpgroup of which one thread
// works. The producer copies q once, then k and v tiles (128 keys at
// head_dim 128, 64 at 256) into two-stage rings with TMA, each stage of
// each ring behind a full/empty mbarrier pair; setmaxnreg moves its
// registers to the consumers. A consumer warpgroup computes S = Q K^T with
// wgmma from shared memory (both operands K-major), masks and soft-caps
// S, runs the online softmax in f32 on its registers, rounds P to bf16 in
// registers and feeds it as wgmma's A operand for O += P V, with V read
// transposed (MN-major) from shared memory. Tile i's QK^T and tile i-1's
// PV are issued together; the softmax of tile i waits only for its QK^T,
// and frees the k stage at once, so it runs while the PV does. The two
// warpgroups issue their products in turn. The TMA maps are 4-D over the
// tensors as they lie, (hd, heads, seq, batch), with the 128-byte
// swizzle; a box is 64 elements (128 bytes) wide, so a row of q, k or v
// arrives as hd / 64 column slabs, and the wgmma descriptors step across
// the slabs along K. Rows past S or T arrive zero-filled; keys past T are
// masked, and output rows past S are not stored.

constexpr int kWgBQ = 128;              // q rows per block
constexpr int kWgConsumers = 2;         // consumer warpgroups of 64 rows
constexpr int kWgThreads = 128 * (kWgConsumers + 1);
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct WgLayout {
  static constexpr int kBK = HD == 128 ? 128 : 64;   // keys per tile
  static constexpr int kSlabs = HD / 64;              // 128-byte columns
  static constexpr int q_bytes = kWgBQ * HD * 2;
  static constexpr int kv_bytes = kBK * HD * 2;       // one of k, v
  // k and v ring stages (a third at head_dim 128 measured no faster)
  static constexpr int kStages = 2;
  static constexpr int q_off = 0;
  static constexpr int k_off = q_off + q_bytes;       // kStages k tiles
  static constexpr int v_off = k_off + kStages * kv_bytes;
  static constexpr int bar_off = v_off + kStages * kv_bytes;
  // q_full, then k_full, k_empty, v_full, v_empty per stage; then 1 KB to
  // align the base
  static constexpr int bytes = bar_off + 8 * (1 + 4 * kStages) + 1024;
  static_assert(bytes <= 232448, "over the 227 KB a block may hold");
};

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int HD>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                             const __grid_constant__ CUtensorMap k_map,
                             const __grid_constant__ CUtensorMap v_map,
                             __nv_bfloat16* __restrict__ out, int S,
                             int T_len, int H, int K, int causal, int window,
                             float scale, float softcap) {
  using L = WgLayout<HD>;
  constexpr int kBK = L::kBK;
  constexpr int kSlabs = L::kSlabs;
  extern __shared__ __align__(1024) unsigned char wg_smem_raw[];
  // the swizzle pattern repeats every 1024 bytes: align the tiles to it
  const uint32_t raw = smem_u32(wg_smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_s = base + L::q_off;
  const uint32_t q_full = base + L::bar_off;
  // k_full, k_empty, v_full, v_empty of stage st
  auto bar = [&](int which, int st) {
    return q_full + 8 * (1 + which * L::kStages + st);
  };
  auto k_tile = [&](int st) { return base + L::k_off + st * L::kv_bytes; };
  auto v_tile = [&](int st) { return base + L::v_off + st * L::kv_bytes; };

  const int qt = gridDim.x - 1 - blockIdx.x;     // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / K);
  const int q_lo = qt * kWgBQ;
  int k_begin = 0;
  if (window > 0 && q_lo - window + 1 > 0)
    k_begin = (q_lo - window + 1) / kBK * kBK;
  const int k_end = causal ? min(T_len, q_lo + kWgBQ) : T_len;
  const int n_tiles = (k_end - k_begin + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(bar(0, s), 1);
      mbar_init(bar(1, s), 4 * kWgConsumers);   // one arrival per warp
      mbar_init(bar(2, s), 1);
      mbar_init(bar(3, s), 4 * kWgConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kWgConsumers) {
    // ------------------------------------------------------ producer --
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 128 * kWgConsumers) {
      mbar_expect_tx(q_full, L::q_bytes);
      for (int j = 0; j < kSlabs; ++j)
        tma_load_4d(q_s + j * kWgBQ * 128, &q_map, q_full, j * 64, h, q_lo,
                    b);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % L::kStages, ph = (i / L::kStages) & 1;
        const int t0 = k_begin + i * kBK;
        mbar_wait(bar(1, st), ph ^ 1);
        mbar_expect_tx(bar(0, st), L::kv_bytes);
        for (int j = 0; j < kSlabs; ++j)
          tma_load_4d(k_tile(st) + j * kBK * 128, &k_map, bar(0, st), j * 64,
                      kvh, t0, b);
        mbar_wait(bar(3, st), ph ^ 1);
        mbar_expect_tx(bar(2, st), L::kv_bytes);
        for (int j = 0; j < kSlabs; ++j)
          tma_load_4d(v_tile(st) + j * kBK * 128, &v_map, bar(2, st), j * 64,
                      kvh, t0, b);
      }
    }
  } else {
    // ----------------------------------------------------- consumers --
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wt = threadIdx.x % 128, warp = wt / 32, lane = wt % 32;
    const int g = lane / 4, tig = lane % 4;
    const int r_lo = q_lo + wg * 64;              // this warpgroup's rows
    const int row0 = r_lo + warp * 16 + g;        // this thread's two rows:
    const int row1 = row0 + 8;                    // row0 and row0 + 8
    const uint32_t q_wg = q_s + wg * 64 * 128;

    // tile i's k and v: wait until loaded, release when read
    auto wait_k = [&](int i) {
      mbar_wait(bar(0, i % L::kStages), (i / L::kStages) & 1);
    };
    auto wait_v = [&](int i) {
      mbar_wait(bar(2, i % L::kStages), (i / L::kStages) & 1);
    };
    auto free_k = [&](int i) {
      if (lane == 0) mbar_arrive(bar(1, i % L::kStages));
    };
    auto free_v = [&](int i) {
      if (lane == 0) mbar_arrive(bar(3, i % L::kStages));
    };
    // the two warpgroups take turns issuing their tensor-core work
    // (ping-pong): warpgroup w waits at barrier 1 + w and passes the turn
    // through barrier 2 - w, so one's softmax runs under the other's
    // products. Both walk every tile of the block, a tile that no row of
    // the warpgroup sees coming out as zero weights, so their turns pair.
    auto turn_wait = [&]() {
      asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
    };
    auto turn_pass = [&]() {
      asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
    };

    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
    float s[kBK / 2];             // S of one tile, then its weights
    uint32_t pa[kBK / 16][4];     // P in bf16: wgmma's A fragments

    // S = Q K^T of tile i, issued and committed (not waited for): HD / 16
    // k-steps, four to a 64-wide slab
    auto issue_s = [&](int i) {
      const uint32_t ks = k_tile(i % L::kStages);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        const uint64_t da =
            wg_desc(q_wg + (kk / 4) * kWgBQ * 128 + off, 16, 1024);
        const uint64_t db = wg_desc(ks + (kk / 4) * kBK * 128 + off, 16, 1024);
        if constexpr (kBK == 128)
          wgmma_ss_n128(s, da, db, kk > 0);
        else
          wgmma_ss_n64(s, da, db, kk > 0);
      }
      wg_commit();
    };
    // O += P V of tile i, issued and committed: k-step j covers keys
    // 16 j .. 16 j + 15, two 8-row groups 1024 bytes apart; the hd / 64
    // slabs lie kBK * 128 bytes apart
    auto issue_pv = [&](int i) {
      const uint32_t vs = v_tile(i % L::kStages);
#pragma unroll
      for (int j = 0; j < kBK / 16; ++j) {
        const uint64_t dv = wg_desc(vs + j * 16 * 128, kBK * 128, 1024);
        if constexpr (HD == 128)
          wgmma_rs_n128(o, pa[j], dv, 1);
        else
          wgmma_rs_n256(o, pa[j], dv, 1);
      }
      wg_commit();
    };
    // masks, soft cap and the online softmax of tile i's S, in place: s
    // becomes the weights, l_r takes them in, and alpha (the rescale of
    // O) comes back. Element e: n8 tile e / 4, row row0 (+8 for
    // e % 4 >= 2), key t0 + 8 (e / 4) + 2 tig + e % 2
    auto softmax = [&](int i, float(&alpha)[2]) {
      const int t0 = k_begin + i * kBK;
      const bool edge = t0 + kBK > T_len ||
                        (causal && t0 + kBK - 1 > r_lo) ||
                        (window > 0 && t0 <= r_lo + 63 - window);
      // one branch a tile, not one an element
      if (softcap > 0.f) {
#pragma unroll
        for (int e = 0; e < kBK / 2; ++e)
          s[e] = tanhf(s[e] * scale / softcap) * softcap;
      } else {
#pragma unroll
        for (int e = 0; e < kBK / 2; ++e) s[e] *= scale;
      }
      if (edge) {
#pragma unroll
        for (int e = 0; e < kBK / 2; ++e) {
          const int r = (e % 4) >= 2 ? row1 : row0;
          const int c = t0 + 8 * (e / 4) + 2 * tig + e % 2;
          bool ok = c < T_len;
          if (causal) ok = ok && c <= r;
          if (window > 0) ok = ok && c > r - window;
          s[e] = ok ? s[e] : kNegInf;
        }
      }
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int e = 0; e < kBK / 2; ++e)
        mx[(e % 4) / 2] = fmaxf(mx[(e % 4) / 2], s[e]);
      float mb[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_r[r], mx[r]);
        alpha[r] = fast_exp2((m_r[r] - m_new) * kLog2e);
        m_r[r] = m_new;
        // a row that sees no key yet keeps m = -1e30: exponents of 0
        // there, as (x - m) gives, where an FMA of the two rounded
        // products would leave a residue of ~1e23
        mb[r] = m_new == kNegInf ? 0.f : m_new * kLog2e;
        l_r[r] *= alpha[r];
      }
#pragma unroll
      for (int e = 0; e < kBK / 2; ++e) {
        const int r = (e % 4) / 2;
        s[e] = fast_exp2(fmaf(s[e], kLog2e, -mb[r]));
        l_r[r] += s[e];
      }
    };
    // the weights rounded to bf16 before PV: P's A fragment of k-step j
    // is S's n8 tiles 2 j and 2 j + 1
    auto pack_p = [&]() {
#pragma unroll
      for (int e = 0; e < kBK / 2; e += 2)
        pa[e / 8][(e % 8) / 2] = pack_bf16(s[e], s[e + 1]);
    };

    float alpha[2];
    mbar_wait(q_full, 0);
    if (wg == 1) turn_pass();   // warpgroup 0 issues first
    wait_k(0);
    turn_wait();
    wg_fence();
    issue_s(0);
    turn_pass();
    wg_wait<0>();
    wg_pin(s);
    free_k(0);
    softmax(0, alpha);
    pack_p();
    // tile i's S and tile i - 1's PV run on the tensor cores while the
    // softmax of tile i waits only for its S
    for (int i = 1; i < n_tiles; ++i) {
      wait_k(i);
      wait_v(i - 1);
      wg_pin(o);
      wg_pin(pa);
      turn_wait();
      wg_fence();
      issue_s(i);
      issue_pv(i - 1);
      turn_pass();
      wg_wait<1>();
      wg_pin(s);
      free_k(i);
      softmax(i, alpha);
      wg_wait<0>();
      wg_pin(o);
      wg_pin(pa);
      free_v(i - 1);
#pragma unroll
      for (int e = 0; e < HD / 2; ++e) o[e] *= alpha[(e % 4) / 2];
      pack_p();
    }
    wait_v(n_tiles - 1);
    wg_pin(o);
    wg_pin(pa);
    turn_wait();
    wg_fence();
    issue_pv(n_tiles - 1);
    turn_pass();
    wg_wait<0>();
    wg_pin(o);
    free_v(n_tiles - 1);
    if (wg == 0) turn_wait();   // warpgroup 1's last pass

    // O / l, rows past S not stored
    __nv_bfloat16* ob = out + ((size_t)b * S * H + h) * HD;
    const size_t q_row = (size_t)H * HD;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float l = l_r[i];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      l = fmaxf(l, 1e-30f);
      const int r = i ? row1 : row0;
      if (r < S) {
        __nv_bfloat16* orow = ob + (size_t)r * q_row + tig * 2;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(orow + j * 8) =
              __floats2bfloat162_rn(o[4 * j + 2 * i] / l,
                                    o[4 * j + 2 * i + 1] / l);
      }
    }
  }
}

// a bf16 (batch, seq, heads, HD) tensor as a 4-D map (HD, heads, seq,
// batch), boxes of 64 x 1 x rows x 1, 128-byte swizzle, zeros out of bounds
bool encode_map(CUtensorMap* map, const void* ptr, int batch, int seq,
                int heads, int hd, int rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)seq, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)seq * heads * hd * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 int B, int S, int T_len, int H, int K, int causal,
                 int window, float scale, float softcap,
                 cudaStream_t stream) {
  using L = WgLayout<HD>;
  CUtensorMap q_map, k_map, v_map;
  if (!encode_map(&q_map, q, B, S, H, HD, kWgBQ) ||
      !encode_map(&k_map, k, B, T_len, K, HD, L::kBK) ||
      !encode_map(&v_map, v, B, T_len, K, HD, L::kBK))
    return -2;
  // more than 48 KB of dynamic shared memory only when opted in, once a
  // device
  static bool opted[kMaxDevices] = {};
  const int dev = current_device();
  if (dev < 0) return -1;
  if (!opted[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_wgmma_kernel<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted[dev] = true;
  }
  const dim3 grid((S + kWgBQ - 1) / kWgBQ, H, B);
  flash_attention_wgmma_kernel<HD><<<grid, kWgThreads, L::bytes, stream>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(out), S, T_len, H, K,
      causal, window, scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_hd(const void* q, const void* k, const void* v, void* out,
              int B, int S, int T_len, int H, int K, int causal, int window,
              float scale, float softcap, int dtype, cudaStream_t stream) {
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  if (dtype == 1) {
    // bf16: wgmma and TMA at the model head dims, mma.sync below them
    if constexpr (HD == 128 || HD == 256) {
      return launch_wgmma<HD>(q, k, v, out, B, S, T_len, H, K, causal,
                              window, scale, softcap, stream);
    } else {
      using bf16 = __nv_bfloat16;
      constexpr size_t bytes = MmaLayout<HD>::bytes;
      // more than 48 KB of dynamic shared memory only when opted in
      const cudaError_t e = cudaFuncSetAttribute(
          flash_attention_mma_kernel<HD>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      if (e != cudaSuccess) return static_cast<int>(e);
      flash_attention_mma_kernel<HD><<<grid, kMmaThreads, bytes, stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<bf16*>(out), S, T_len,
          H, K, causal, window, scale, softcap);
    }
  } else {
    constexpr size_t bytes = Layout<HD>::bytes;
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_f32_kernel<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    flash_attention_f32_kernel<HD><<<grid, kThreads, bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), S, T_len, H,
        K, causal, window, scale, softcap);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; causal: 0 or 1. Returns 0 on a good
// launch.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int S,
                                      int T, int H, int K, int hd,
                                      int causal, int window, float scale,
                                      float softcap, int dtype,
                                      void* stream) {
  if (B < 1 || S < 1 || T < 1 || K < 1 || H < K || H % K || window < 0 ||
      (dtype != 0 && dtype != 1))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 8:
      return launch_hd<8>(q, k, v, out, B, S, T, H, K, causal, window,
                          scale, softcap, dtype, s);
    case 16:
      return launch_hd<16>(q, k, v, out, B, S, T, H, K, causal, window,
                           scale, softcap, dtype, s);
    case 32:
      return launch_hd<32>(q, k, v, out, B, S, T, H, K, causal, window,
                           scale, softcap, dtype, s);
    case 64:
      return launch_hd<64>(q, k, v, out, B, S, T, H, K, causal, window,
                           scale, softcap, dtype, s);
    case 128:
      return launch_hd<128>(q, k, v, out, B, S, T, H, K, causal, window,
                            scale, softcap, dtype, s);
    case 256:
      return launch_hd<256>(q, k, v, out, B, S, T, H, K, causal, window,
                            scale, softcap, dtype, s);
    default:
      return -1;
  }
}
