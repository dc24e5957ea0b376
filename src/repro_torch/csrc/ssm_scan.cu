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
// chunks; here there is no sequential grid axis, so each thread walks the
// whole time axis itself with its channel's N states in registers.
//
// What bounds it on this card: at falcon-mamba-7b's forward shape (B=2,
// S=4096, Din=8192, N=16) a launch moves ~0.81 GB (dt, x and y in f32, B_,
// C_ and h_last besides), 0.24 ms at 3.35 TB/s, and takes 1.07e9
// exponentials, 0.26 ms at the special-function units' 16 a clock per SM.
// Bytes and exponentials bound it about equally. What the design does:
//   * one thread per (b, d) channel, 128 channels per block: each thread
//     reads its dt and x and writes its y at consecutive addresses of its
//     warp's neighbours, so every access to the large tensors is a
//     coalesced 128-byte line, each byte moved once;
//   * the states never leave registers; B_t and C_t, shared by every
//     channel of a row, are staged in shared memory for a chunk of
//     kChunk steps and read back as float4 broadcasts;
//   * the next chunk's dt, x, B_ and C_ are loaded into registers while
//     the current chunk is computed (double buffering), so memory latency
//     overlaps the exponentials; one barrier per chunk;
//   * nothing is padded: the ragged last chunk and channels past Din are
//     masked here; B_ and C_ are read through their batch and row
//     strides, so the strided views the caller splits off one projection
//     need no copy.
// At the forward shape there are only 16,384 channels, one warp for each
// of the card's 528 schedulers, so the dependent chain of each step's
// exponentials is not hidden well. Splitting the time axis into chunks
// scanned in parallel (with a second pass that carries the states across
// chunks) or the N states across lanes is the way to fill the card.
// Accurate expf and no fast math: f32 stays within 1e-4 of the plain
// version. Each channel's arithmetic runs in a fixed order, so the kernel
// is deterministic, as the Scale-Down replay needs.
//
// Plain C interface, loaded with ctypes: ssm_scan_launch returns
// cudaGetLastError() after the launch, or -1 for arguments it does not
// take (the Python wrapper checks them first).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // channels per block, one per thread
constexpr int kChunk = 8;      // time steps staged per pass

template <int N>
struct Staging {
  // elements of B_ (and of C_) in one chunk, and how many each thread loads
  static constexpr int kElems = kChunk * N;
  static constexpr int kPer = (kElems + kThreads - 1) / kThreads;
};

template <int N>
__device__ __forceinline__ void load_bc(const float* __restrict__ Bb,
                                        const float* __restrict__ Cb,
                                        int64_t b_row, int64_t c_row, int t0,
                                        int S, float (&rb)[Staging<N>::kPer],
                                        float (&rc)[Staging<N>::kPer]) {
#pragma unroll
  for (int k = 0; k < Staging<N>::kPer; ++k) {
    const int e = threadIdx.x + k * kThreads;
    const int t = t0 + e / N;
    const bool ok = e < Staging<N>::kElems && t < S;
    rb[k] = ok ? Bb[t * b_row + e % N] : 0.f;
    rc[k] = ok ? Cb[t * c_row + e % N] : 0.f;
  }
}

template <int N>
__device__ __forceinline__ void store_bc(float* sB, float* sC,
                                         const float (&rb)[Staging<N>::kPer],
                                         const float (&rc)[Staging<N>::kPer]) {
#pragma unroll
  for (int k = 0; k < Staging<N>::kPer; ++k) {
    const int e = threadIdx.x + k * kThreads;
    if (e < Staging<N>::kElems) {
      sB[e] = rb[k];
      sC[e] = rc[k];
    }
  }
}

// this channel's dt and x for the kChunk steps from t0 (0 past S or Din)
__device__ __forceinline__ void load_dtx(const float* __restrict__ dt,
                                         const float* __restrict__ x,
                                         int64_t row0, int t0, int S,
                                         int Din, int d, bool active,
                                         float (&rdt)[kChunk],
                                         float (&rx)[kChunk]) {
#pragma unroll
  for (int i = 0; i < kChunk; ++i) {
    const bool ok = active && t0 + i < S;
    const int64_t off = (row0 + t0 + i) * Din + d;
    rdt[i] = ok ? dt[off] : 0.f;
    rx[i] = ok ? x[off] : 0.f;
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads)
    ssm_scan_kernel(const float* __restrict__ dt, const float* __restrict__ A,
                    const float* __restrict__ Bm,
                    const float* __restrict__ Cm, const float* __restrict__ x,
                    float* __restrict__ y, float* __restrict__ h_last, int S,
                    int Din, int64_t b_batch, int64_t b_row, int64_t c_batch,
                    int64_t c_row) {
  static_assert(N % 4 == 0, "B_t and C_t are read as float4");
  __shared__ __align__(16) float sB[2][kChunk * N];
  __shared__ __align__(16) float sC[2][kChunk * N];

  const int b = blockIdx.y;
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const bool active = d < Din;
  const int64_t row0 = static_cast<int64_t>(b) * S;  // rows of dt, x, y
  const float* Bb = Bm + b * b_batch;
  const float* Cb = Cm + b * c_batch;

  float a[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a[n] = active ? A[static_cast<int64_t>(d) * N + n] : 0.f;
    h[n] = 0.f;
  }

  float ndt[kChunk], nx[kChunk];  // the next chunk, in flight
  float rb[Staging<N>::kPer], rc[Staging<N>::kPer];
  load_dtx(dt, x, row0, 0, S, Din, d, active, ndt, nx);
  load_bc<N>(Bb, Cb, b_row, c_row, 0, S, rb, rc);
  store_bc<N>(sB[0], sC[0], rb, rc);
  __syncthreads();

  const int n_chunks = (S + kChunk - 1) / kChunk;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * kChunk;
    const int buf = c & 1;
    float cdt[kChunk], cx[kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      cdt[i] = ndt[i];
      cx[i] = nx[i];
    }
    const bool more = c + 1 < n_chunks;
    if (more) {
      load_dtx(dt, x, row0, t0 + kChunk, S, Din, d, active, ndt, nx);
      load_bc<N>(Bb, Cb, b_row, c_row, t0 + kChunk, S, rb, rc);
    }
    const int len = min(kChunk, S - t0);
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      if (i < len) {
        const float dtv = cdt[i];
        const float dtx = dtv * cx[i];
        const float4* b4 = reinterpret_cast<const float4*>(sB[buf] + i * N);
        const float4* c4 = reinterpret_cast<const float4*>(sC[buf] + i * N);
        float acc = 0.f;
#pragma unroll
        for (int q = 0; q < N / 4; ++q) {
          const float4 bq = b4[q];
          const float4 cq = c4[q];
          const float bv[4] = {bq.x, bq.y, bq.z, bq.w};
          const float cv[4] = {cq.x, cq.y, cq.z, cq.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int n = 4 * q + j;
            const float dA = expf(dtv * a[n]);
            h[n] = fmaf(dA, h[n], dtx * bv[j]);
            acc = fmaf(h[n], cv[j], acc);
          }
        }
        if (active) y[(row0 + t0 + i) * Din + d] = acc;
      }
    }
    if (more) store_bc<N>(sB[buf ^ 1], sC[buf ^ 1], rb, rc);
    __syncthreads();
  }

  if (active) {
    float4* out = reinterpret_cast<float4*>(
        h_last + (static_cast<int64_t>(b) * Din + d) * N);
#pragma unroll
    for (int q = 0; q < N / 4; ++q)
      out[q] = make_float4(h[4 * q], h[4 * q + 1], h[4 * q + 2],
                           h[4 * q + 3]);
  }
}

template <int N>
int launch(const float* dt, const float* A, const float* Bm, const float* Cm,
           const float* x, float* y, float* h_last, int Bsz, int S, int Din,
           int64_t b_batch, int64_t b_row, int64_t c_batch, int64_t c_row,
           cudaStream_t stream) {
  const dim3 grid((Din + kThreads - 1) / kThreads, Bsz);
  ssm_scan_kernel<N><<<grid, kThreads, 0, stream>>>(
      dt, A, Bm, Cm, x, y, h_last, S, Din, b_batch, b_row, c_batch, c_row);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ssm_scan_launch(const void* dt, const void* A, const void* Bm,
                               const void* Cm, const void* x, void* y,
                               void* h_last, int Bsz, int S, int Din, int N,
                               long long b_batch, long long b_row,
                               long long c_batch, long long c_row,
                               void* stream) {
  if (Bsz < 1 || Bsz > 65535 || S < 1 || Din < 1) return -1;
  const auto* f_dt = static_cast<const float*>(dt);
  const auto* f_A = static_cast<const float*>(A);
  const auto* f_B = static_cast<const float*>(Bm);
  const auto* f_C = static_cast<const float*>(Cm);
  const auto* f_x = static_cast<const float*>(x);
  auto* f_y = static_cast<float*>(y);
  auto* f_h = static_cast<float*>(h_last);
  auto s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 4:
      return launch<4>(f_dt, f_A, f_B, f_C, f_x, f_y, f_h, Bsz, S, Din,
                       b_batch, b_row, c_batch, c_row, s);
    case 8:
      return launch<8>(f_dt, f_A, f_B, f_C, f_x, f_y, f_h, Bsz, S, Din,
                       b_batch, b_row, c_batch, c_row, s);
    case 16:
      return launch<16>(f_dt, f_A, f_B, f_C, f_x, f_y, f_h, Bsz, S, Din,
                        b_batch, b_row, c_batch, c_row, s);
    default:
      return -1;
  }
}
