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
// over time chunks; here blocks run in no order, so each thread walks the
// whole time axis of its channel itself with h in a register.
//
// What bounds it on this card: bytes. Each step of each channel reads a_t
// and b_t and writes h_t, 12 bytes for two flops. At recurrentgemma-2b's
// forward shape (B=2, S=4096, W=2560) that is 3 x 83.9 MB = 251.7 MB, 75.1
// us at 3.35 TB/s; at its serve prefill (B=8, S=2048) 150.2 us. What the
// design does:
//   * one thread per (b, w) channel, one warp per block: at each step a
//     warp reads 32 neighbouring channels of a and of b and writes 32 of
//     h, each a coalesced 128-byte line, and every byte moves once;
//   * the loads run kAhead steps ahead of the arithmetic in a ring of
//     registers: step t's a and b are used, and the same registers are
//     at once reloaded with step t + kAhead's, so every thread keeps
//     kAhead steps of a and b (2 x 256 bytes) in flight while its chain
//     of multiply-adds runs;
//   * nothing is padded: steps past S are masked, and threads past W
//     retire at once (there is no barrier to wait for them).
// At the forward shape there are only 5,120 channels, 160 warps for the
// card's 528 schedulers, so the bytes in flight (about 2.6 MB) are barely
// enough to cover the memory latency. Splitting the time axis into chunks
// scanned in parallel, with a second pass that carries each chunk's state
// into the next, is the way to fill the card.
//
// Each step is rounded as the plain version rounds it, a product and then
// a sum (__fmul_rn, __fadd_rn: no contraction into an FMA), in one fixed
// order per channel: the kernel is deterministic, as the Scale-Down replay
// needs, and agrees with the plain version to the bit.
//
// Plain C interface, loaded with ctypes: rglru_scan_launch returns
// cudaGetLastError() after the launch, or -1 for arguments it does not
// take (the Python wrapper checks them first).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;  // channels per block: one warp
constexpr int kAhead = 64;    // steps of a and b in flight per thread

// a, b, h_all: (B, S, W); h0, h_last: (B, W); all f32, contiguous.
__global__ void __launch_bounds__(kThreads)
    rglru_scan_kernel(const float* __restrict__ a,
                      const float* __restrict__ b,
                      const float* __restrict__ h0,
                      float* __restrict__ h_all,
                      float* __restrict__ h_last, int S, int W) {
  const int bi = blockIdx.y;
  const int w = blockIdx.x * kThreads + threadIdx.x;
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

}  // namespace

extern "C" int rglru_scan_launch(const void* a, const void* b,
                                 const void* h0, void* h_all, void* h_last,
                                 int Bsz, int S, int W, void* stream) {
  if (Bsz < 1 || Bsz > 65535 || S < 1 || W < 1) return -1;
  const dim3 grid((W + kThreads - 1) / kThreads, Bsz);
  rglru_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(h_all),
      static_cast<float*>(h_last), S, W);
  return static_cast<int>(cudaGetLastError());
}
