// The selective scan's step arithmetic alone, for tools/kernel_ab.py: each
// thread runs four states of one channel through the scan's update (the
// accurate expf of dt * A, the state's multiply-add, y's multiply-add), the
// kernel's work a state and step, with every input made in registers and
// nothing loaded or stored but one result a thread. Timed at the K3
// kernel's thread count it is the floor of its instruction stream.

#include <cuda_runtime.h>

namespace {

__global__ void k3_floor_kernel(float* out, int steps) {
  float a[4], h[4], b[4], c[4];
  for (int j = 0; j < 4; ++j) {
    a[j] = -1.f - 0.1f * j - 1e-4f * threadIdx.x;
    h[j] = 0.f;
    b[j] = 0.3f + j;
    c[j] = 0.7f - j;
  }
  float dt = 0.01f + 1e-5f * threadIdx.x, x = 0.5f, y = 0.f;
#pragma unroll 16
  for (int s = 0; s < steps; ++s) {
    const float dtx = dt * x;
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      h[j] = fmaf(expf(dt * a[j]), h[j], dtx * b[j]);
      acc = fmaf(h[j], c[j], acc);
    }
    y += acc;
    dt += 1e-7f;
    x *= 0.999f;
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = y + h[0] + h[1] + h[2] + h[3];
}

}  // namespace

extern "C" int k3_floor_launch(void* out, int blocks, int threads, int steps,
                               void* stream) {
  k3_floor_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), steps);
  return static_cast<int>(cudaGetLastError());
}
