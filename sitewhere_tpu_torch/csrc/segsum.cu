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
// over v[off[s] .. off[s + 1]). The values come in already flushed. The
// plain version, held to the same bits, is `segment_row_sum_plain` in
// sitewhere_tpu_torch/ops/segsum.py.
//
// One instruction an add. Each add is `add.rn.ftz.f32`, which flushes its
// operands and its result. Both operands are flushed already (an input, or
// a partial sum this fold flushed), and every f32 is a multiple of 2^-149,
// so the exact sum of two of them that lies below 2^-126 in magnitude is a
// denormal that needs no rounding: the IEEE sum rounded to nearest is then
// exact, and flushing it gives the zero of its sign, as `.ftz` does; a sum
// of 2^-126 or more is a normal number that neither flushes. So the one
// instruction gives the bits of ftz(__fadd_rn(acc, x)), whose compare,
// select and copysign would otherwise sit on the chain of dependent adds.
//
// What bounds it: bytes where segments are short (every value read once,
// every offset once, every sum written once), and the chain of dependent
// adds of the longest segment where one is long: a bit-equal fold cannot
// add a segment's rows in parallel, so a segment of R rows takes at least
// R add latencies.
//
// The design: two passes, launched one after the other on the stream.
//   - The short pass takes every segment: a warp takes a tile of 32
//     consecutive segments; its lanes read the tile's 33 offsets once each
//     (the next segment's start comes from the neighbour lane by a
//     shuffle; int32 offsets where the rows fit, which halves their bytes)
//     and write the 32 sums side by side. A lane folds a segment of at
//     most LONG_ROWS rows itself, LOADS values loaded at a time, then TAIL
//     at a time (a sparse grid's cells of 0 to 3 rows take one batch of
//     predicated loads: few instructions, all loads in flight). Registers
//     are held to 32 a thread, so that an SM keeps 2048 threads, and with
//     them 2048 segments' loads, in flight. A longer segment it appends to
//     a list in scratch (one atomic per warp).
//   - The long pass gives each listed segment a warp, spread over the
//     card: its lanes copy the segment's rows into a ring of STAGES chunks
//     of CHUNK values in shared memory with cp.async (16 bytes a lane, the
//     next chunk in flight), and lane 0 folds each chunk in row order
//     from shared memory. Lane 0 folds the rows before the first 16-byte
//     boundary from global memory; the copy of the last chunk reads only
//     the segment's bytes. Many long segments side by side (hourly windows
//     of chatty devices) fold in parallel, one warp each.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARP = 32;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / WARP;
constexpr int LOADS = 16;          // values in registers per batch (lane)
constexpr int TAIL = 4;            // ... and per batch of a segment's rest
constexpr int RING_LOADS = 16;     // values per batch of lane 0's ring fold
constexpr int LONG_ROWS = 256;     // longer segments go to the long pass
constexpr int CHUNK = 2048;        // values per staged chunk (8 KB)
constexpr int STAGES = 2;          // chunks in the ring of one warp
// a warp's ring, then 2 RING_LOADS values of pad that the last batch's
// look-ahead may read
constexpr int RING_STRIDE = STAGES * CHUNK + 2 * RING_LOADS;   // floats
constexpr size_t LONG_SHARED_BYTES = sizeof(float) * WARPS * RING_STRIDE;
constexpr int MAX_CARDS = 64;
constexpr unsigned FULL = 0xffffffffu;

// ftz(__fadd_rn(a, b)) for flushed a and b, in one instruction (see above)
__device__ __forceinline__ float add_ftz(float a, float b) {
  float r;
  asm("add.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem,
                                           int src_bytes) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// the warp's fold of v[i .. end) through its shared-memory ring; lane 0
// holds the sum
__device__ float fold_long(const float* __restrict__ v, long long i,
                           long long end, float* ring, int lane) {
  float acc = 0.0f;
  // rows up to the first 16-byte boundary: lane 0, from global memory
  long long a = i;
  while (a < end && (reinterpret_cast<uintptr_t>(v + a) & 15) != 0) ++a;
  if (lane == 0)
    for (long long k = i; k < a; ++k) acc = add_ftz(acc, __ldg(v + k));
  const long long chunks = (end - a + CHUNK - 1) / CHUNK;

  auto issue = [&](long long c) {   // copy chunk c into its slot
    if (c < chunks) {
      float* dst = ring + (c % STAGES) * CHUNK;
      const long long base = a + c * CHUNK;
      for (int k = lane * 4; k < CHUNK; k += WARP * 4) {
        const long long left = end - (base + k);
        if (left > 0) cp_async16(dst + k, v + base + k,
                                 left >= 4 ? 16 : (int)left * 4);
      }
    }
    cp_async_commit();   // empty groups keep the count uniform
  };
  for (int s = 0; s < STAGES - 1; ++s) issue(s);
  for (long long c = 0; c < chunks; ++c) {
    issue(c + STAGES - 1);   // into the slot folded one turn ago
    cp_async_wait<STAGES - 1>();
    __syncwarp();            // every lane's copies of chunk c have landed
    if (lane == 0) {
      const float4* q =
          reinterpret_cast<const float4*>(ring + (c % STAGES) * CHUNK);
      const int n = (int)min((long long)CHUNK, end - (a + c * CHUNK));
      const int pairs = n / (2 * RING_LOADS);
      float4 x[RING_LOADS / 4], y[RING_LOADS / 4];
#pragma unroll
      for (int j = 0; j < RING_LOADS / 4; ++j) x[j] = q[j];
      for (int k = 0; k < pairs; ++k) {   // each batch's loads run ahead
        const float4* b = q + k * (2 * RING_LOADS / 4);
#pragma unroll
        for (int j = 0; j < RING_LOADS / 4; ++j)
          y[j] = b[RING_LOADS / 4 + j];
#pragma unroll
        for (int j = 0; j < RING_LOADS / 4; ++j) {
          acc = add_ftz(acc, x[j].x);
          acc = add_ftz(acc, x[j].y);
          acc = add_ftz(acc, x[j].z);
          acc = add_ftz(acc, x[j].w);
        }
#pragma unroll
        for (int j = 0; j < RING_LOADS / 4; ++j)
          x[j] = b[2 * RING_LOADS / 4 + j];   // may read the pad
#pragma unroll
        for (int j = 0; j < RING_LOADS / 4; ++j) {
          acc = add_ftz(acc, y[j].x);
          acc = add_ftz(acc, y[j].y);
          acc = add_ftz(acc, y[j].z);
          acc = add_ftz(acc, y[j].w);
        }
      }
      const float* r = reinterpret_cast<const float*>(q);
      for (int k = pairs * 2 * RING_LOADS; k < n; ++k)
        acc = add_ftz(acc, r[k]);
    }
    __syncwarp();            // lane 0 is done with the slot
  }
  cp_async_wait<0>();
  return acc;
}

// The short pass (see above). `list` receives the indices of the segments
// of more than LONG_ROWS rows, `count` their number (zeroed before).
template <typename Off>
__global__ void __launch_bounds__(THREADS, 2048 / THREADS)
short_pass(const float* __restrict__ values, const Off* __restrict__ offsets,
           float* __restrict__ out, long long segments,
           long long* __restrict__ list, unsigned* __restrict__ count) {
  const int lane = threadIdx.x & (WARP - 1);
  const long long tiles = (segments + WARP - 1) / WARP;
  const long long warps = (long long)gridDim.x * WARPS;
  for (long long t = (long long)blockIdx.x * WARPS + threadIdx.x / WARP;
       t < tiles; t += warps) {
    const long long s = t * WARP + lane;
    const bool in = s < segments;
    const Off lo = offsets[in ? s : segments];
    Off hi = __shfl_down_sync(FULL, lo, 1);
    if (lane == WARP - 1) hi = offsets[in ? s + 1 : segments];
    const bool is_long = in && (long long)hi - (long long)lo > LONG_ROWS;
    const unsigned longs = __ballot_sync(FULL, is_long);
    if (longs) {   // one atomic for the warp's long segments
      unsigned base = 0;
      if (lane == __ffs(longs) - 1) base = atomicAdd(count, __popc(longs));
      base = __shfl_sync(FULL, base, __ffs(longs) - 1);
      if (is_long) list[base + __popc(longs & ((1u << lane) - 1))] = s;
    }
    if (!in || is_long) continue;
    float acc = 0.0f;
    long long i = lo;
    for (; i + LOADS <= hi; i += LOADS) {
      float buf[LOADS];
#pragma unroll
      for (int j = 0; j < LOADS; ++j) buf[j] = __ldg(values + i + j);
#pragma unroll
      for (int j = 0; j < LOADS; ++j) acc = add_ftz(acc, buf[j]);
    }
    for (; i < hi; i += TAIL) {   // the rest, TAIL loads in flight at once
      const int left = (int)(hi - i);
      float buf[TAIL];
#pragma unroll
      for (int j = 0; j < TAIL; ++j)
        buf[j] = j < left ? __ldg(values + i + j) : 0.0f;
#pragma unroll
      for (int j = 0; j < TAIL; ++j)
        if (j < left) acc = add_ftz(acc, buf[j]);
    }
    out[s] = acc;
  }
}

// The long pass: a warp per listed segment.
template <typename Off>
__global__ void __launch_bounds__(THREADS)
long_pass(const float* __restrict__ values, const Off* __restrict__ offsets,
          float* __restrict__ out, const long long* __restrict__ list,
          const unsigned* __restrict__ count) {
  extern __shared__ __align__(16) float rings[];
  const int lane = threadIdx.x & (WARP - 1);
  const int wib = threadIdx.x / WARP;
  const long long n = *count;
  const long long warps = (long long)gridDim.x * WARPS;
  for (long long k = (long long)blockIdx.x * WARPS + wib; k < n;
       k += warps) {
    const long long s = list[k];
    const float r = fold_long(values, (long long)offsets[s],
                              (long long)offsets[s + 1],
                              rings + wib * RING_STRIDE, lane);
    if (lane == 0) out[s] = r;
  }
}

struct CardState {
  int sm_count = 0;
  bool granted[2] = {};
};
CardState cards[MAX_CARDS];

template <typename Off>
int launch(const void* values, const void* offsets, void* out,
           long long segments, long long rows, void* scratch, int device,
           void* stream) {
  if (device < 0 || device >= MAX_CARDS) return (int)cudaErrorInvalidDevice;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  CardState& card = cards[device];
  if (card.sm_count == 0) {
    err = cudaDeviceGetAttribute(&card.sm_count,
                                 cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
  }
  const int which = sizeof(Off) == 8;
  if (!card.granted[which]) {
    err = cudaFuncSetAttribute(long_pass<Off>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)LONG_SHARED_BYTES);
    if (err != cudaSuccess) return (int)err;
    card.granted[which] = true;
  }
  cudaStream_t st = (cudaStream_t)stream;
  unsigned* count = (unsigned*)scratch;
  long long* list = (long long*)((char*)scratch + 16);
  err = cudaMemsetAsync(count, 0, sizeof(unsigned), st);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (segments + WARP - 1) / WARP;
  const long long blocks = (tiles + WARPS - 1) / WARPS;
  const long long most = (long long)card.sm_count * (2048 / THREADS) * 8;
  short_pass<Off><<<(int)(blocks < most ? blocks : most), THREADS, 0, st>>>(
      (const float*)values, (const Off*)offsets, (float*)out, segments,
      list, count);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // at most rows / (LONG_ROWS + 1) long segments; two blocks an SM
  const long long most_long = rows / (LONG_ROWS + 1);
  if (most_long == 0) return 0;
  const long long long_blocks = (most_long + WARPS - 1) / WARPS;
  const long long cap = (long long)card.sm_count * 2;
  long_pass<Off><<<(int)(long_blocks < cap ? long_blocks : cap), THREADS,
                   LONG_SHARED_BYTES, st>>>(
      (const float*)values, (const Off*)offsets, (float*)out, list, count);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of scratch a call over `rows` values needs: the long pass's
// counter, then its list of segment indices.
long long swt_segsum_scratch_bytes(long long rows) {
  return 16 + 8 * (rows / (LONG_ROWS + 1) + 1);
}

// Launches on `stream` of card `device` without synchronising; returns the
// CUDA error code (0 = the launches were accepted). `offsets` holds
// segments + 1 ascending row offsets into the `rows` values, int32 when
// `offset_bytes` is 4 and int64 when it is 8; segments > 0. `scratch` holds
// swt_segsum_scratch_bytes(rows) bytes, 16-byte aligned.
// This library carries its own (static) CUDA runtime, whose current device
// is set here rather than inherited from the caller's.
int swt_segment_row_sum(const void* values, const void* offsets, void* out,
                        long long segments, int offset_bytes, long long rows,
                        void* scratch, int device, void* stream) {
  if (offset_bytes == 4)
    return launch<int32_t>(values, offsets, out, segments, rows, scratch,
                           device, stream);
  if (offset_bytes == 8)
    return launch<int64_t>(values, offsets, out, segments, rows, scratch,
                           device, stream);
  return (int)cudaErrorInvalidValue;
}

const char* swt_segsum_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
