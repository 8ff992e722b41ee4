// Row-order segment sums of f32 values on Hopper.
//
// The sum grid of the windowed analytics ops
// (sitewhere_tpu_torch/analytics/windows.py `windowed_stats`), where the
// reference has `jax.ops.segment_sum` (sitewhere_tpu/analytics/windows.py,
// `_windowed_stats_impl`): an XLA op, not a Pallas kernel. XLA's CPU
// scatter-add adds each segment's rows in row order, starting from +0.0,
// and flushes denormal results to signed zeros. This kernel gives the same
// bits whatever order the card runs its threads in, because each segment is
// folded by one thread, in order, from the rows sorted stably by segment:
//
//   out[s] = ftz(...ftz(ftz(+0.0 + v[off[s]]) + v[off[s] + 1])...)
//
// over v[off[s] .. off[s + 1]), every add rounded to nearest by __fadd_rn.
// The values come in already flushed. The plain version, held to the same
// bits, is `segment_row_sum_plain` in sitewhere_tpu_torch/ops/segsum.py.
//
// What bounds it: bytes. Every value is read once, every offset once
// (S + 1 int64) and every sum written once; the adds are few beside them.
// One thread per segment, grid-striding over the segments; a thread loads
// LOADS values of its segment at a time into registers before it adds
// them, so that a long segment (a hot key's window) keeps that many loads
// in flight instead of one.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int LOADS = 32;
constexpr float FLT_MIN_NORMAL = 1.17549435e-38f;  // 2^-126

// a denormal as the zero of its sign; anything else unchanged
__device__ __forceinline__ float ftz(float x) {
  return fabsf(x) < FLT_MIN_NORMAL ? copysignf(0.0f, x) : x;
}

__global__ void __launch_bounds__(THREADS)
segment_row_sum_kernel(const float* __restrict__ values,
                       const int64_t* __restrict__ offsets,
                       float* __restrict__ out, int64_t segments) {
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  for (int64_t s = (int64_t)blockIdx.x * THREADS + threadIdx.x; s < segments;
       s += stride) {
    int64_t i = offsets[s];
    const int64_t end = offsets[s + 1];
    float acc = 0.0f;
    for (; i + LOADS <= end; i += LOADS) {
      float buf[LOADS];
#pragma unroll
      for (int j = 0; j < LOADS; ++j) buf[j] = __ldg(values + i + j);
#pragma unroll
      for (int j = 0; j < LOADS; ++j) acc = ftz(__fadd_rn(acc, buf[j]));
    }
    for (; i < end; ++i) acc = ftz(__fadd_rn(acc, __ldg(values + i)));
    out[s] = acc;
  }
}

}  // namespace

extern "C" {

// Launches on `stream` of card `device` without synchronising; returns the
// CUDA error code (0 = the launch was accepted). `offsets` holds
// segments + 1 ascending int64 row offsets into `values`; segments > 0.
// This library carries its own (static) CUDA runtime, whose current device
// is set here rather than inherited from the caller's.
int swt_segment_row_sum(const void* values, const void* offsets, void* out,
                        long long segments, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (segments + THREADS - 1) / THREADS;
  const long long most = (long long)sms * (2048 / THREADS) * 8;
  const int grid = (int)(blocks < most ? blocks : most);
  segment_row_sum_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)values, (const int64_t*)offsets, (float*)out,
      (int64_t)segments);
  return (int)cudaGetLastError();
}

const char* swt_segsum_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
