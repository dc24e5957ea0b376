// Mamba-1 selective scan, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/ssm_scan/ssm_scan.py::ssm_scan_kernel (body
// `_kernel`). For every channel (b, d) and state n, in f32:
//
//   h_t = exp(dt_t * A[d, n]) * h_{t-1} + (dt_t * x_t) * B_t[n]
//   y_t = sum_n h_t[n] * C_t[n]
//
// from h_0 = 0; the last state comes back as h_last (B, Din, N). The skip
// term D * x is added by the caller, as on the TPU. The TPU kernel keeps a
// (block_d, N) state in VMEM across a sequential grid axis over time
// chunks; here there is no sequential grid axis, so each channel's group
// of threads walks the whole time axis itself with the states in
// registers.
//
// What bounds it on this card: at falcon-mamba-7b's forward shape (B=2,
// S=4096, Din=8192, N=16) a launch moves ~0.81 GB (dt, x and y in f32, B_,
// C_ and h_last besides), 0.24 ms at 3.35 TB/s, and takes 1.07e9
// exponentials, 0.26 ms at the special-function units' 16 a clock per SM.
// In practice it is the instructions: the accurate expf is nine of them
// with its argument (the fast one would be two; the scan keeps the
// accurate one), and with the state update and y about twelve a state and
// step. Each step's exponential and state update is a chain of dependent
// instructions, so the card must hold enough warps and enough independent
// work to hide it. The first port gave each channel one
// thread: 16,384 threads at B=2, one warp for each of the card's 528
// schedulers.
//
// The design: each channel's N states are held by G lanes, G chosen by
// the host from the shape (ops.lane_group): one lane a channel where that
// puts at least 12 warps on each SM (three a scheduler), else N / 4 lanes
// of four states each. At falcon-mamba-7b's forward (B=2) that is four
// lanes at N=16, 2,048 warps instead of 512; at its serve prefill (B=8)
// one lane a channel already puts 2,048 warps on the card, and a group
// there only adds instructions (a lane's y partial sum, the tree that
// adds them): four lanes took about 6 % longer there, and two lanes a channel
// lost to one or four at both shapes (PERF.md).
// Splitting the states multiplies the warps without a second pass over
// memory, where splitting the time axis across a cluster would read dt,
// C_ and y again for its correction pass (about doubling the bytes) and
// add an exponential per state for the carried state. Each state's
// arithmetic keeps the first port's order, so h_last is the same at
// every G; each lane sums h . C over its states in n order, and y_t is
// those G partial sums added in a fixed tree, (p0 + p1) + (p2 + p3), so
// a launch is deterministic (y's rounding depends on G, which the shape
// fixes). A block holds 256 / G channels (256 threads) and walks time in
// chunks of kChunk steps:
//   * dt and x of a chunk are loaded by the whole block, a warp on 32
//     consecutive channels of one step (128-byte lines), into registers
//     while the previous chunk is computed, then staged in shared memory
//     as (dt, dt x) pairs, so each lane reads one 8-byte pair a step;
//     B_t and C_t, shared by every channel of a row, likewise, read through
//     their batch and row strides, so the strided views the caller splits
//     off one projection need no copy;
//   * a full chunk's 16 steps are unrolled with no guard and no store
//     between them, so the next steps' loads and exponentials (which do
//     not depend on h) run under this step's chain; the lanes' partial
//     sums go to shared memory when the chunk ends, and the whole block
//     adds and writes y out in 128-byte lines (at G = 1 each lane writes
//     its own y, a warp's 32 channels a line);
//   * double-buffered staging, one barrier a chunk; the ragged last chunk
//     and channels past Din are masked, nothing is padded.
// Accurate expf and no fast math: f32 stays within 1e-4 of the plain
// version. One launch a call, no allocation, no host sync: a CUDA graph
// can capture it. Measured share of the bound: PERF.md (chip_smoke.py
// phase 17).
//
// Plain C interface, loaded with ctypes: ssm_scan_launch returns
// cudaGetLastError() after the launch, or -1 for arguments it does not
// take (the Python wrapper checks them first) or a current device it
// cannot read.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"   // current_device, kMaxDevices

namespace {

constexpr int kThreads = 256;   // threads a block, at every lane group
constexpr int kChunk = 16;      // time steps staged a pass

// G lanes a channel, N / G states a lane
template <int N, int G>
struct Plan {
  static constexpr int kPerLane = N / G;              // states a lane
  static constexpr int kChannels = kThreads / G;      // channels a block
  static constexpr int kDX = kChunk * kChannels;      // dt (x, y) a chunk
  static constexpr int kDXPer = kDX / kThreads;       // ... a thread
  static constexpr int kBC = kChunk * N;              // B_ (C_) a chunk
  static constexpr int kBCPer = (kBC + kThreads - 1) / kThreads;
  static_assert(kPerLane % 4 == 0 && (G & (G - 1)) == 0,
                "a power-of-two lane group, whole float4s of states a lane");
  // dynamic shared memory, in floats: double-buffered (dt, dt x) pairs of
  // (step, channel), the lanes' partial sums of y (step, channel, lane;
  // none at one lane a channel, which writes y itself), B_ and C_ of
  // (step, state)
  static constexpr int dd_off = 0;
  static constexpr int part_off = dd_off + 2 * 2 * kDX;
  static constexpr int part_per = G == 1 ? 0 : kDX * G;
  static constexpr int b_off = part_off + 2 * part_per;
  static constexpr int c_off = b_off + 2 * kBC;
  static constexpr size_t bytes = (c_off + 2 * kBC) * sizeof(float);
};

// one chunk's inputs in flight in registers: dt and x of (step, channel)
// i = tid + k * threads, and B_, C_ element tid + k * threads
template <int N, int G>
struct Inflight {
  float dt[Plan<N, G>::kDXPer], x[Plan<N, G>::kDXPer];
  float b[Plan<N, G>::kBCPer], c[Plan<N, G>::kBCPer];
};

template <int N, int G>
__device__ __forceinline__ void load_chunk(
    Inflight<N, G>& r, const float* __restrict__ dt,
    const float* __restrict__ x, const float* __restrict__ Bb,
    const float* __restrict__ Cb, int64_t row0, int t0, int S, int Din,
    int d0, int64_t b_row, int64_t c_row) {
  using P = Plan<N, G>;
#pragma unroll
  for (int k = 0; k < P::kDXPer; ++k) {
    const int i = threadIdx.x + k * kThreads;
    const int t = t0 + i / P::kChannels, d = d0 + i % P::kChannels;
    const bool ok = t < S && d < Din;
    const int64_t off = (row0 + t) * Din + d;
    r.dt[k] = ok ? dt[off] : 0.f;
    r.x[k] = ok ? x[off] : 0.f;
  }
#pragma unroll
  for (int k = 0; k < P::kBCPer; ++k) {
    const int e = threadIdx.x + k * kThreads;
    const int t = t0 + e / N;
    const bool ok = e < P::kBC && t < S;
    r.b[k] = ok ? Bb[t * b_row + e % N] : 0.f;
    r.c[k] = ok ? Cb[t * c_row + e % N] : 0.f;
  }
}

// one block an SM is all the registers must leave room for (the slice
// shapes' grids are 256 blocks, two an SM at most): a bound of two blocks
// spilled the 16 states a lane of one lane a channel, and with no bound
// stated the compiler spilled the <8, 2> instance
template <int N, int G>
__global__ void __launch_bounds__(kThreads, 1)
    ssm_scan_kernel(const float* __restrict__ dt, const float* __restrict__ A,
                    const float* __restrict__ Bm,
                    const float* __restrict__ Cm, const float* __restrict__ x,
                    float* __restrict__ y, float* __restrict__ h_last, int S,
                    int Din, int64_t b_batch, int64_t b_row, int64_t c_batch,
                    int64_t c_row) {
  using P = Plan<N, G>;
  constexpr int L = P::kPerLane, Q = L / 4;
  extern __shared__ __align__(16) float smem[];

  const int b = blockIdx.y;
  const int d0 = blockIdx.x * P::kChannels;
  const int ch = threadIdx.x / G, sub = threadIdx.x % G;   // my states:
  const int d = d0 + ch;                                   // L sub .. +L-1
  const bool active = d < Din;
  const int64_t row0 = static_cast<int64_t>(b) * S;   // rows of dt, x, y
  const float* Bb = Bm + b * b_batch;
  const float* Cb = Cm + b * c_batch;

  // (dt, dt x) of step t, channel c; states L sub + 4 q .. + 3 of B_ or C_
  // at step t
  auto s_dd = [&](int buf, int t, int c) {
    return reinterpret_cast<float2*>(smem + P::dd_off) +
           (buf * kChunk + t) * P::kChannels + c;
  };
  auto s_bc = [&](int off, int buf, int t, int q) {
    return *reinterpret_cast<const float4*>(
        smem + off + buf * P::kBC + t * N + L * sub + 4 * q);
  };

  float a[L], h[L];
#pragma unroll
  for (int j = 0; j < L; ++j) {
    a[j] = active ? A[static_cast<int64_t>(d) * N + L * sub + j] : 0.f;
    h[j] = 0.f;
  }

  // dt and dt x (rounded once, as a lane would round it) into the staging
  // buffer, B_ and C_ beside them
  Inflight<N, G> r;
  auto stage = [&](int buf) {
#pragma unroll
    for (int k = 0; k < P::kDXPer; ++k) {
      const int i = threadIdx.x + k * kThreads;
      *s_dd(buf, i / P::kChannels, i % P::kChannels) =
          make_float2(r.dt[k], r.dt[k] * r.x[k]);
    }
#pragma unroll
    for (int k = 0; k < P::kBCPer; ++k) {
      const int e = threadIdx.x + k * kThreads;
      if (e < P::kBC) {
        smem[P::b_off + buf * P::kBC + e] = r.b[k];
        smem[P::c_off + buf * P::kBC + e] = r.c[k];
      }
    }
  };

  const int n_chunks = (S + kChunk - 1) / kChunk;
  load_chunk<N, G>(r, dt, x, Bb, Cb, row0, 0, S, Din, d0, b_row, c_row);
  stage(0);
  if (n_chunks > 1)
    load_chunk<N, G>(r, dt, x, Bb, Cb, row0, kChunk, S, Din, d0, b_row,
                     c_row);
  __syncthreads();

  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * kChunk, buf = c & 1;
    float* part = smem + P::part_off + buf * P::part_per;
    float* my_part = part + ch * G + sub;   // step i at i * kThreads
    // step i: this lane's states, returning its sum of h . C over them
    // (in n order)
    auto step = [&](int i) {
      const float2 dd = *s_dd(buf, i, ch);
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const float4 bq = s_bc(P::b_off, buf, i, q);
        const float4 cq = s_bc(P::c_off, buf, i, q);
        const float bv[4] = {bq.x, bq.y, bq.z, bq.w};
        const float cv[4] = {cq.x, cq.y, cq.z, cq.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = 4 * q + j;
          const float dA = expf(dd.x * a[n]);
          h[n] = fmaf(dA, h[n], dd.y * bv[j]);
          acc = fmaf(h[n], cv[j], acc);
        }
      }
      return acc;
    };
    // where the sum of step i goes: y itself at one lane a channel (a
    // warp's 32 consecutive channels, a 128-byte line), else this lane's
    // slot of the partial sums
    auto put = [&](int i, float v) {
      if constexpr (G == 1) {
        if (active) y[(row0 + t0 + i) * Din + d] = v;
      } else {
        my_part[i * kThreads] = v;
      }
    };
    if (t0 + kChunk <= S) {
      // a whole chunk unrolled with no guard and no store between its
      // steps (a store would keep the compiler from loading the next
      // steps' inputs early): the sums wait in registers until the chunk
      // ends
      float acc[kChunk];
#pragma unroll
      for (int i = 0; i < kChunk; ++i) acc[i] = step(i);
#pragma unroll
      for (int i = 0; i < kChunk; ++i) put(i, acc[i]);
    } else {
      for (int i = 0; i < S - t0; ++i) put(i, step(i));
    }
    if (c + 1 < n_chunks) stage(buf ^ 1);
    __syncthreads();
    if constexpr (G > 1) {
      // this chunk's y, a warp on 32 consecutive channels of one step:
      // each channel's G partial sums added in a fixed tree, pairs 1
      // apart, then 2 apart: (p0 + p1) + (p2 + p3)
#pragma unroll
      for (int k = 0; k < P::kDXPer; ++k) {
        const int i = threadIdx.x + k * kThreads;
        const int t = t0 + i / P::kChannels, dd = d0 + i % P::kChannels;
        float p[G];
#pragma unroll
        for (int s2 = 0; s2 < G; ++s2) p[s2] = part[i * G + s2];
#pragma unroll
        for (int o = 1; o < G; o <<= 1)
#pragma unroll
          for (int s2 = 0; s2 < G; s2 += 2 * o) p[s2] += p[s2 + o];
        if (t < S && dd < Din) y[(row0 + t) * Din + dd] = p[0];
      }
    }
    if (c + 2 < n_chunks)
      load_chunk<N, G>(r, dt, x, Bb, Cb, row0, t0 + 2 * kChunk, S, Din, d0,
                       b_row, c_row);
  }

  if (active) {
    float4* out = reinterpret_cast<float4*>(
        h_last + (static_cast<int64_t>(b) * Din + d) * N + L * sub);
#pragma unroll
    for (int q = 0; q < Q; ++q)
      out[q] = make_float4(h[4 * q], h[4 * q + 1], h[4 * q + 2],
                           h[4 * q + 3]);
  }
}

template <int N, int G>
int launch(const float* dt, const float* A, const float* Bm, const float* Cm,
           const float* x, float* y, float* h_last, int Bsz, int S, int Din,
           int64_t b_batch, int64_t b_row, int64_t c_batch, int64_t c_row,
           cudaStream_t stream) {
  using P = Plan<N, G>;
  // above 48 KB of dynamic shared memory only when opted in, once a
  // device
  static bool opted[kMaxDevices] = {};
  const int dev = current_device();
  if (dev < 0) return -1;
  if (!opted[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssm_scan_kernel<N, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)P::bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted[dev] = true;
  }
  const dim3 grid((Din + P::kChannels - 1) / P::kChannels, Bsz);
  ssm_scan_kernel<N, G><<<grid, kThreads, P::bytes, stream>>>(
      dt, A, Bm, Cm, x, y, h_last, S, Din, b_batch, b_row, c_batch, c_row);
  return static_cast<int>(cudaGetLastError());
}

using LaunchFn = int (*)(const float*, const float*, const float*,
                         const float*, const float*, float*, float*, int, int,
                         int, int64_t, int64_t, int64_t, int64_t,
                         cudaStream_t);

// the instance for (N, G): one lane a channel, or four states a lane
LaunchFn instance(int N, int G) {
  switch (N * 8 + G) {
    case 4 * 8 + 1: return launch<4, 1>;
    case 8 * 8 + 1: return launch<8, 1>;
    case 8 * 8 + 2: return launch<8, 2>;
    case 16 * 8 + 1: return launch<16, 1>;
    case 16 * 8 + 4: return launch<16, 4>;
    default: return nullptr;
  }
}

}  // namespace

// N: states a channel (4, 8 or 16); G: lanes a channel (1 or N / 4),
// from ops.plan. Returns 0 on a good launch.
extern "C" int ssm_scan_launch(const void* dt, const void* A, const void* Bm,
                               const void* Cm, const void* x, void* y,
                               void* h_last, int Bsz, int S, int Din, int N,
                               int G, long long b_batch, long long b_row,
                               long long c_batch, long long c_row,
                               void* stream) {
  if (Bsz < 1 || Bsz > 65535 || S < 1 || Din < 1) return -1;
  const LaunchFn fn = instance(N, G);
  if (fn == nullptr) return -1;
  return fn(static_cast<const float*>(dt), static_cast<const float*>(A),
            static_cast<const float*>(Bm), static_cast<const float*>(Cm),
            static_cast<const float*>(x), static_cast<float*>(y),
            static_cast<float*>(h_last), Bsz, S, Din, b_batch, b_row,
            c_batch, c_row, static_cast<cudaStream_t>(stream));
}
