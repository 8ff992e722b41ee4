// Even-odd (crossing-number) containment of B points in Z polygons on Hopper.
//
// Replaces the TPU kernel `points_in_zones_pallas` in
// sitewhere_tpu/ops/pallas_geofence.py (body `_pip_kernel`). Semantics are
// those of the plain version, sitewhere_tpu_torch/ops/geofence.py
// `points_in_zones`, and the result is bit-equal to it: for every edge
// (v, v+1 mod V) of zone z and every point (py = lat, px = lon),
//   straddles = (y1 > py) != (y2 > py)
//   dy        = y2 - y1;  safe_dy = (dy == 0) ? 1 : dy
//   x_at_y    = x1 + ((x2 - x1) * (py - y1)) / safe_dy
//   parity   ^= straddles && (px < x_at_y)
// with every operation rounded to nearest by the __f*_rn intrinsics, so
// the compiler can neither contract a multiply-add nor use an approximate
// divide. Denormal coordinates and denormal intermediate results become
// signed zeros through ftz() below, explicitly, as the reference's compiled
// program treats them (sitewhere_tpu_torch/ops/numerics.py); the build
// itself keeps IEEE semantics (no --use_fast_math).
//
// Bound on the H100: operations. There are B*Z*V edge tests, each some
// eight f32 operations one of which is an IEEE divide (a multi-instruction
// sequence on the card), against about 8*B + 16*V*Z + B*Z bytes of input
// and output (34.6 MB at B=131072, Z=256, V=16: some 10 us at 3.35 TB/s,
// while 4.3 G f32 ops take at least 64 us at 67 TFLOP/s).
//
// What the design does about that bound:
//   - the divide runs only for edges that straddle the point's ray: a
//     non-straddling edge never changes the parity, whatever x_at_y is, so
//     skipping its divide leaves the result bit-equal;
//   - each block takes a tile of POINTS_PER_BLOCK points x ZONES_PER_BLOCK
//     zones; the tile's polygon vertices are staged in shared memory once
//     per chunk of EDGE_CHUNK edges and reused by every point of the tile;
//   - each thread keeps POINTS_PER_THREAD points in registers, so one pair
//     of shared-memory vertex reads feeds several edge tests;
//   - threadIdx.x runs along zones: a warp reads consecutive shared-memory
//     words (no bank conflicts) and writes consecutive bytes of the
//     row-major bool [B, Z] output.
// Ragged B and Z are masked with conditions, not padded.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ZONES_PER_BLOCK = 32;    // blockDim.x, one warp along zones
constexpr int ROWS_PER_BLOCK = 8;      // blockDim.y
constexpr int POINTS_PER_THREAD = 4;
constexpr int POINTS_PER_BLOCK = ROWS_PER_BLOCK * POINTS_PER_THREAD;
constexpr int EDGE_CHUNK = 32;         // edges staged per shared-memory pass
constexpr float FLT_MIN_NORMAL = 1.17549435e-38f;  // 2^-126

// a denormal as the zero of its sign; anything else unchanged
__device__ __forceinline__ float ftz(float x) {
  return fabsf(x) < FLT_MIN_NORMAL ? copysignf(0.0f, x) : x;
}

__global__ void __launch_bounds__(ZONES_PER_BLOCK * ROWS_PER_BLOCK)
points_in_zones_kernel(const float* __restrict__ lat,
                       const float* __restrict__ lon,
                       const float* __restrict__ vertices,  // [Z, V, 2]
                       uint8_t* __restrict__ out,            // [B, Z]
                       int B, int Z, int V) {
  // vertex j of the chunk (j in 0..EDGE_CHUNK) for each zone of the tile:
  // edge j of the chunk runs from vertex j to vertex j + 1
  __shared__ float vy[EDGE_CHUNK + 1][ZONES_PER_BLOCK];
  __shared__ float vx[EDGE_CHUNK + 1][ZONES_PER_BLOCK];

  const int tz = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * ZONES_PER_BLOCK + tz;
  const int z0 = blockIdx.y * ZONES_PER_BLOCK;
  const int z = z0 + tz;
  const long long b0 =
      (long long)blockIdx.x * POINTS_PER_BLOCK + ty * POINTS_PER_THREAD;

  float px[POINTS_PER_THREAD], py[POINTS_PER_THREAD];
  bool parity[POINTS_PER_THREAD];
#pragma unroll
  for (int p = 0; p < POINTS_PER_THREAD; ++p) {
    const long long b = b0 + p;
    py[p] = b < B ? ftz(lat[b]) : 0.0f;
    px[p] = b < B ? ftz(lon[b]) : 0.0f;
    parity[p] = false;
  }

  for (int e0 = 0; e0 < V; e0 += EDGE_CHUNK) {
    const int n_edges = min(EDGE_CHUNK, V - e0);
    __syncthreads();  // previous chunk fully consumed
    for (int i = tid; i < (n_edges + 1) * ZONES_PER_BLOCK;
         i += ZONES_PER_BLOCK * ROWS_PER_BLOCK) {
      const int j = i / ZONES_PER_BLOCK;
      const int zl = i % ZONES_PER_BLOCK;
      const int zz = z0 + zl;
      float y = 0.0f, x = 0.0f;
      if (zz < Z) {
        const int v = (e0 + j) % V;  // the closing edge wraps to vertex 0
        const float* vert = vertices + ((long long)zz * V + v) * 2;
        y = ftz(vert[0]);
        x = ftz(vert[1]);
      }
      vy[j][zl] = y;
      vx[j][zl] = x;
    }
    __syncthreads();
    for (int j = 0; j < n_edges; ++j) {
      const float y1 = vy[j][tz], x1 = vx[j][tz];
      const float y2 = vy[j + 1][tz], x2 = vx[j + 1][tz];
      const float dy = ftz(__fsub_rn(y2, y1));
      const float safe_dy = (dy == 0.0f) ? 1.0f : dy;
      const float dx = ftz(__fsub_rn(x2, x1));
#pragma unroll
      for (int p = 0; p < POINTS_PER_THREAD; ++p) {
        const bool straddles = (y1 > py[p]) != (y2 > py[p]);
        if (straddles) {
          const float num = ftz(__fmul_rn(dx, ftz(__fsub_rn(py[p], y1))));
          const float x_at_y =
              ftz(__fadd_rn(x1, ftz(__fdiv_rn(num, safe_dy))));
          parity[p] ^= (px[p] < x_at_y);
        }
      }
    }
  }

  if (z < Z) {
#pragma unroll
    for (int p = 0; p < POINTS_PER_THREAD; ++p) {
      const long long b = b0 + p;
      if (b < B) out[b * Z + z] = parity[p] ? 1 : 0;
    }
  }
}

}  // namespace

extern "C" {

// Launches on `stream` of card `device` without synchronising; returns
// the CUDA error code (0 = the launch was accepted). B, Z > 0; V >= 0.
// This library carries its own (static) CUDA runtime, whose current device
// is set here rather than inherited from the caller's.
int swt_points_in_zones(const void* lat, const void* lon,
                        const void* vertices, void* out, int B, int Z, int V,
                        int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const dim3 block(ZONES_PER_BLOCK, ROWS_PER_BLOCK);
  const dim3 grid((B + POINTS_PER_BLOCK - 1) / POINTS_PER_BLOCK,
                  (Z + ZONES_PER_BLOCK - 1) / ZONES_PER_BLOCK);
  points_in_zones_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)lat, (const float*)lon, (const float*)vertices,
      (uint8_t*)out, B, Z, V);
  return (int)cudaGetLastError();
}

const char* swt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
