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
// What bounds it on the H100: operations, counted for what the inputs
// need. A (point, zone) pair whose py lies outside the zone's y-range
// [ymin, ymax) has no straddling edge (proof below), so it costs two
// compares; a pair inside it costs about 8 f32 operations per edge. With
// P_in such pairs the work is 2*B*Z + 8*V*P_in operations at 67 TFLOP/s,
// against 8*B + 16*V*Z + B*Z bytes at 3.35 TB/s (chip_smoke.py computes
// both from each run's inputs; the dense count 8*B*Z*V is kept beside it).
//
// Exact y-rejection. Let ymin and ymax be the least and the greatest of
// the zone's flushed vertex y's under the float order of `<`, in which
// -0.0 == +0.0 and +-inf are ordinary ends. Every vertex y then satisfies
// ymin <= y <= ymax.
//   - py >= ymax: every y <= ymax <= py, so every (y > py) is false, no
//     edge straddles, and the parity is 0;
//   - py < ymin: every y >= ymin > py, so every (y > py) is true, no edge
//     straddles, and the parity is 0.
// Both hold for +-inf points and vertices (py = +inf is >= every ymax;
// py = -inf is below every ymin but -inf) and for signed zeros (py = +0.0
// against ymin = -0.0 is not below it, and is not rejected). A NaN point
// fails both compares and walks the edges, where no edge straddles, as in
// the plain version. A NaN vertex y breaks the premise (the compare
// against it is false while its neighbours' are true), so a zone with any
// NaN coordinate takes NaN bounds, which fail both compares: it is never
// rejected. ops/geofence.py `zone_reject_mask` is this predicate in plain
// torch; the CPU tests hold it against the straddle count and the plain
// result. No x-rejection is made.
//
// What the design does about the bound:
//   - one persistent launch per call, one block of 1024 threads per SM
//     (the grid from the SM count and the occupancy of the shared memory
//     asked for), walking (zone chunk, point tile) items: a zone table is
//     staged once per block, not per tile;
//   - the zone table of a chunk sits in dynamic shared memory: each edge's
//     crossing operands (y1, x1, dx, safe_dy) as one float4, each zone's
//     vertex y's as a row of float4s, its y-bounds; staged with coalesced
//     loads, a warp per zone; when Z*V does not fit, zones go in chunks.
//     When not even 32 zones fit (V above 330), only the y-bounds are
//     staged and the walk reads each kept zone's [V, 2] row from global
//     memory (through L1: a warp's lanes mostly read the same words), so
//     that any V runs;
//   - a tile is 1024 points, one per thread, sorted by py inside the block
//     (a bitonic network: shuffles within a warp, shared memory beyond), so
//     that a warp's 32 points are y-neighbours. The warp walks the zones:
//     when the zone's y-range misses the warp's y-span (its least and
//     greatest non-NaN py), the whole warp skips it, with no divergence:
//     each non-NaN point of the warp would be rejected as above, and a NaN
//     point's parity is 0 in any case. Else each lane rejects its own pair
//     exactly as above. Neighbouring points mostly straddle the same edges,
//     so the lanes that go on do the same work on the same (broadcast)
//     shared-memory words;
//   - a lane that keeps its pair builds a V-bit straddle mask with compares
//     only (the zone's vertex y's in 16 or 32 registers for V <= 32; 32-edge
//     chunks beyond), then runs the exact divide for the set bits alone: a
//     convex zone has 0 or 2 straddling edges per point;
//   - each point's parity bits go to a bit row in shared memory; the tile
//     is copied out in the original row order as 16-byte stores of whole
//     rows (ragged B, Z and row alignment handled at the row ends).
// chip_smoke.py prints ptxas' registers, shared memory and spills, and the
// launch plan (swt_points_in_zones_plan).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <mutex>

namespace {

constexpr int THREADS = 1024;            // one block per SM
constexpr int WARPS = THREADS / 32;
constexpr int P = THREADS;               // points per tile, one per thread
constexpr int STAGE_BATCH = 4;           // zones a warp loads at once
constexpr size_t BLOCK_SHARED_MAX = 227 * 1024;   // per block, opt-in
constexpr float FLT_MIN_NORMAL = 1.17549435e-38f;  // 2^-126
constexpr unsigned FULL = 0xffffffffu;

// a denormal as the zero of its sign; anything else unchanged
__device__ __forceinline__ float ftz(float x) {
  return fabsf(x) < FLT_MIN_NORMAL ? copysignf(0.0f, x) : x;
}

__host__ __device__ inline int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

// vertex y's a zone's y-row holds: 0..VR (VR = V or the instantiation's
// register count), in whole float4s
__host__ __device__ inline int yrow_len(int vr) { return round_up(vr + 1, 4); }

// words of a point's bit row for zc zones; odd, so that the lanes of a
// warp, writing the rows of unrelated points, spread over the banks
__host__ __device__ inline int bit_words(int zc) { return (zc + 31) / 32 | 1; }

// dynamic shared memory of a block for chunks of zc zones of V vertices,
// vertex y's in registers up to vr; unstaged, the zone table stays in
// global memory and only its y-bounds come to shared memory
size_t shared_bytes(int zc, int V, int vr, bool staged) {
  const size_t table = staged
      ? sizeof(float4) * (size_t)zc * V                 // edges
        + sizeof(float) * (size_t)zc * yrow_len(vr)     // y-rows
      : 0;
  return table
         + sizeof(float2) * (size_t)zc                   // y-bounds
         + sizeof(unsigned) * (size_t)P * bit_words(zc)  // bit rows
         + sizeof(unsigned long long) * P                // sort keys
         + sizeof(float2) * P;                           // tile points
}

// the flushed vertex v of a zone's [V, 2] row: (y, x)
__device__ __forceinline__ float2 vertex(const float* vert, int v) {
  return make_float2(ftz(vert[2 * v]), ftz(vert[2 * v + 1]));
}

// the crossing operands (y1, x1, dx, safe_dy) of the edge from vertex p
// to vertex q
__device__ __forceinline__ float4 edge_operands(float2 p, float2 q) {
  const float dy = ftz(__fsub_rn(q.x, p.x));
  return make_float4(p.x, p.y, ftz(__fsub_rn(q.y, p.y)),
                     dy == 0.0f ? 1.0f : dy);
}

__device__ __forceinline__ float warp_min(float v) {   // NaN where all are
  for (int off = 16; off; off >>= 1)
    v = fminf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

// an order-preserving map of non-NaN floats to unsigned; NaN last
__device__ __forceinline__ unsigned sort_bits(float y) {
  const unsigned u = __float_as_uint(y);
  return isnan(y) ? FULL : (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The block's keys in ascending order, one per thread (a bitonic network):
// thread t returns the t-th smallest. Steps within a warp go by shuffles,
// wider ones through `buf`.
__device__ unsigned long long block_sort(unsigned long long key,
                                         unsigned long long* buf) {
  const int tid = threadIdx.x;
  for (int k = 2; k <= THREADS; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      unsigned long long other;
      if (j >= 32) {
        buf[tid] = key;
        __syncthreads();
        other = buf[tid ^ j];
        __syncthreads();
      } else {
        other = __shfl_xor_sync(FULL, key, j);
      }
      // the lower thread of an ascending pair keeps the smaller key
      const bool keep_min = ((tid & j) == 0) == ((tid & k) == 0);
      key = (keep_min == (other < key)) ? other : key;
    }
  }
  return key;
}

// 4 bits as 4 bytes of 0 or 1
__device__ __forceinline__ unsigned expand4(unsigned n) {
  return (n & 1u) | ((n & 2u) << 7) | ((n & 4u) << 14) | ((n & 8u) << 21);
}

// Parity flip of one straddling edge e = (y1, x1, dx, safe_dy) for the
// point (py, px): px < x1 + (dx * (py - y1)) / safe_dy, each op rounded to
// nearest and flushed.
__device__ __forceinline__ bool crosses(float py, float px, float4 e) {
  const float num = ftz(__fmul_rn(e.z, ftz(__fsub_rn(py, e.x))));
  return px < ftz(__fadd_rn(e.y, ftz(__fdiv_rn(num, e.w))));
}

// Stages zones z0 .. z0 + nz - 1 into shared memory, a warp per zone (lane
// v takes vertex v and edge v, the warp STAGE_BATCH zones at once): their
// y-bounds (NaN, never rejected, for a zone with a NaN coordinate) and,
// STAGED, their edges and y-rows of R entries.
template <bool STAGED>
__device__ void stage_zones(const float* __restrict__ vertices, int z0,
                            int nz, int V, int R, float4* edges, float* yrow,
                            float2* bounds) {
  const float inf = __int_as_float(0x7f800000);
  const float qnan = __int_as_float(0x7fc00000);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_stage = V > R ? V : R;   // lanes' trips over a zone's row
  for (int c0 = warp; c0 < nz; c0 += WARPS * STAGE_BATCH) {
    float lo[STAGE_BATCH], hi[STAGE_BATCH];
    bool has_nan[STAGE_BATCH];
#pragma unroll
    for (int b = 0; b < STAGE_BATCH; ++b) {
      lo[b] = inf;
      hi[b] = -inf;
      has_nan[b] = false;
    }
    for (int v0 = 0; v0 < n_stage; v0 += 32) {
      const int v = v0 + lane;
      float2 p[STAGE_BATCH], q[STAGE_BATCH];
#pragma unroll
      for (int b = 0; b < STAGE_BATCH; ++b) {
        const int c = c0 + b * WARPS;
        const float* vert = vertices + (size_t)(z0 + c) * V * 2;
        if (c < nz && v < V) {
          p[b] = vertex(vert, v);
          if (STAGED) q[b] = vertex(vert, v + 1 < V ? v + 1 : 0);
        } else if (c < nz && v < R) {
          p[b] = V > 0 ? vertex(vert, 0) : make_float2(0.0f, 0.0f);
        }
      }
#pragma unroll
      for (int b = 0; b < STAGE_BATCH; ++b) {
        const int c = c0 + b * WARPS;
        if (c < nz && v < V) {
          if (STAGED) edges[(size_t)c * V + v] = edge_operands(p[b], q[b]);
          has_nan[b] |= isnan(p[b].x) || isnan(p[b].y);
          lo[b] = p[b].x < lo[b] ? p[b].x : lo[b];
          hi[b] = p[b].x > hi[b] ? p[b].x : hi[b];
        }
        if (STAGED && c < nz && v < R) yrow[(size_t)c * R + v] = p[b].x;
      }
    }
#pragma unroll
    for (int b = 0; b < STAGE_BATCH; ++b) {
      const int c = c0 + b * WARPS;
      // min and max by `<`, as ymin <= y <= ymax needs (fminf would
      // drop a NaN, which has_nan covers)
      float l = lo[b], h = hi[b];
      for (int off = 16; off; off >>= 1) {
        const float ol = __shfl_xor_sync(FULL, l, off);
        const float oh = __shfl_xor_sync(FULL, h, off);
        l = ol < l ? ol : l;
        h = oh > h ? oh : h;
      }
      const bool bad = __any_sync(FULL, has_nan[b]);
      if (lane == 0 && c < nz)
        bounds[c] = bad ? make_float2(qnan, qnan) : make_float2(l, h);
    }
  }
}

// Even-odd containment of the points in the zones: the block walks its
// (zone chunk, point tile) items, staging a chunk's zone table when its
// first item of that chunk comes. STAGED: the table is in shared memory;
// VR > 0: V <= VR, and the straddle mask takes a zone's vertex y's into
// registers, fully unrolled; VR == 0: any V, the mask reads them in 32-edge
// chunks. Not STAGED (VR == 0; zones too large for shared memory): the
// same reads go to the zone's [V, 2] row in global memory, and each
// straddling edge's operands are computed as staging computes them.
template <int VR, bool STAGED>
__global__ void __launch_bounds__(THREADS, 1)
points_in_zones_kernel(const float* __restrict__ lat,
                       const float* __restrict__ lon,
                       const float* __restrict__ vertices,  // [Z, V, 2]
                       uint8_t* __restrict__ out,            // [B, Z]
                       int B, int Z, int V, int zc) {
  static_assert(STAGED || VR == 0, "registers are filled from shared memory");
  extern __shared__ __align__(16) unsigned char smem[];
  const int R = STAGED ? yrow_len(VR > 0 ? VR : V) : 0;
  const int W = bit_words(zc);
  // edge v of zone c at [c * V + v]: (y1, x1, dx, safe_dy), the operands of
  // its crossing test; vertex y's of zone c at [c * R + k] (k >= V: vertex
  // 0, so that the edges past V are degenerate and never straddle)
  float4* edges = reinterpret_cast<float4*>(smem);
  float* yrow =
      reinterpret_cast<float*>(edges + (STAGED ? (size_t)zc * V : 0));
  float2* bounds = reinterpret_cast<float2*>(yrow + (size_t)zc * R);
  unsigned* bits = reinterpret_cast<unsigned*>(bounds + zc);  // [P][W]
  unsigned long long* keys =
      reinterpret_cast<unsigned long long*>(bits + (size_t)P * W);
  float2* pts = reinterpret_cast<float2*>(keys + P);          // (py, px)

  const float qnan = __int_as_float(0x7fc00000);
  const int tid = threadIdx.x;
  const int n_tiles = (B + P - 1) / P;
  const int n_items = (Z + zc - 1) / zc * n_tiles;   // (chunk, tile) pairs
  int staged = -1;                                   // the chunk staged

  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int chunk = item / n_tiles;
    const int z0 = chunk * zc, nz = min(zc, Z - z0);
    const long long b0 = (long long)(item % n_tiles) * P;
    const int np = (int)min((long long)P, (long long)B - b0);
    __syncthreads();  // the previous item's tile is copied out
    if (chunk != staged) {
      stage_zones<STAGED>(vertices, z0, nz, V, R, edges, yrow, bounds);
      staged = chunk;
    }

    // the tile's points sorted by py (NaN, and the rows past B, last):
    // thread t takes the t-th, so a warp's 32 points are y-neighbours
    int row;   // the tile row of this thread's point
    {
      const float y = tid < np ? ftz(lat[b0 + tid]) : qnan;
      const float x = tid < np ? ftz(lon[b0 + tid]) : 0.0f;
      pts[tid] = make_float2(y, x);
      row = (int)(block_sort((unsigned long long)sort_bits(y) << 32 | tid,
                             keys) & FULL);
    }   // (block_sort's barriers publish pts)
    const float py = pts[row].x, px = pts[row].y;
    // the warp's y-span; NaN (never skip) when all its points are NaN
    const float span_lo = warp_min(py), span_hi = warp_max(py);

    unsigned word = 0;   // parity bits of zones c & ~31 .. c
    for (int c = 0; c < nz; ++c) {
      const float2 bd = bounds[c];
      // warp-uniform: the zone's y-range misses every point of the warp;
      // per lane: it misses this point (the exact rejection)
      if (!(span_hi < bd.x || span_lo >= bd.y) &&
          !(py < bd.x || py >= bd.y)) {
        const float* zv = vertices + (size_t)(z0 + c) * V * 2;  // unstaged
        bool parity = false;
        for (int e0 = 0; e0 < V; e0 += 32) {
          // bit k of `above`: vertex e0+k lies above the ray; bit k of
          // `mask`: edge e0+k has one end above and one not
          unsigned mask;
          if (VR > 0) {
            const float4* yr = reinterpret_cast<const float4*>(
                yrow + (size_t)c * R);
            float ys[VR + 4];
#pragma unroll
            for (int i = 0; i < (VR + 4) / 4; ++i) {
              const float4 y4 = yr[i];
              ys[4 * i] = y4.x;
              ys[4 * i + 1] = y4.y;
              ys[4 * i + 2] = y4.z;
              ys[4 * i + 3] = y4.w;
            }
            unsigned above = 0;
#pragma unroll
            for (int k = 0; k < VR; ++k)
              above |= (unsigned)(ys[k] > py) << k;
            const unsigned last = ys[VR] > py;
            mask = above ^ ((above >> 1) | (last << (VR - 1)));
          } else {
            const int n = min(32, V - e0);
            unsigned long long above = 0;
            for (int k = 0; k <= n; ++k) {
              const float y = STAGED ? yrow[(size_t)c * R + e0 + k]
                                     : ftz(zv[2 * (e0 + k < V ? e0 + k : 0)]);
              above |= (unsigned long long)(y > py) << k;
            }
            mask = (unsigned)((above ^ (above >> 1)) & ((1ull << n) - 1));
          }
          while (mask) {
            const int j = e0 + __ffs(mask) - 1;
            mask &= mask - 1;
            parity ^= crosses(
                py, px,
                STAGED ? edges[(size_t)c * V + j]
                       : edge_operands(vertex(zv, j),
                                       vertex(zv, j + 1 < V ? j + 1 : 0)));
          }
        }
        word |= (unsigned)parity << (c & 31);
      }
      if ((c & 31) == 31 || c == nz - 1) {
        if (row < np) bits[(size_t)row * W + (c >> 5)] = word;
        word = 0;
      }
    }
    __syncthreads();

    // row p's bytes, aligned as in `out` (its first at byte `shift` of a
    // 16-byte word): whole words go out as one 16-byte store each
    const int words = (nz + 15) / 16 + 1;
    for (int i = tid; i < np * words; i += THREADS) {
      const int p = i / words, lo = (i % words) * 16, hi = lo + 16;
      const size_t orow = (size_t)(b0 + p) * Z + z0;
      const int shift = (int)(((uintptr_t)out + orow) & 15);
      if (hi <= shift || lo >= shift + nz) continue;
      uint8_t* base = out + orow - shift;
      const unsigned* prow = bits + (size_t)p * W;
      if (lo >= shift && hi <= shift + nz) {
        const int col = lo - shift, w = col >> 5, off = col & 31;
        unsigned window = prow[w] >> off;
        if (off > 16) window |= prow[w + 1] << (32 - off);
        *reinterpret_cast<uint4*>(base + lo) =
            make_uint4(expand4(window), expand4(window >> 4),
                       expand4(window >> 8), expand4(window >> 12));
      } else {
        for (int k = max(lo, shift); k < min(hi, shift + nz); ++k) {
          const int col = k - shift;
          base[k] = (prow[col >> 5] >> (col & 31)) & 1u;
        }
      }
    }
  }
}

// the instantiations: V <= 16 and V <= 32 (vertex y's in registers), any
// V staged, any V from global memory
using Kernel = void (*)(const float*, const float*, const float*, uint8_t*,
                        int, int, int, int);
const Kernel KERNELS[] = {points_in_zones_kernel<16, true>,
                          points_in_zones_kernel<32, true>,
                          points_in_zones_kernel<0, true>,
                          points_in_zones_kernel<0, false>};
constexpr int N_KERNELS = sizeof(KERNELS) / sizeof(KERNELS[0]);

// per card and instantiation, cached: SM count, whether the opt-in
// shared-memory size was granted, and the blocks per SM at the last size
// launched
struct CardState {
  int sm_count = 0;
  bool granted[N_KERNELS] = {};
  size_t occupancy_smem[N_KERNELS] = {};
  int blocks_per_sm[N_KERNELS] = {};
};
constexpr int MAX_CARDS = 64;
CardState cards[MAX_CARDS];
std::mutex cards_lock;

// how one call launches: zones per chunk, shared bytes, the kernel for V
// (its index in KERNELS), blocks per SM, grid
struct Launch {
  int which = 0;
  int zc = 0;
  size_t smem = 0;
  Kernel kernel = nullptr;
  int blocks_per_sm = 0;
  int grid = 0;
};

// Plans a launch (granting the kernel its shared memory on the way);
// returns the CUDA error code.
int plan_launch(int B, int Z, int V, int device, Launch* launch) {
  if (device < 0 || device >= MAX_CARDS) return (int)cudaErrorInvalidDevice;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;

  // the zone table staged when a chunk of 32 zones fits, else read from
  // global memory; then the largest chunk of whole 32-zone words that fits
  // one block per SM (unstaged, 32 zones always fit)
  int which = V <= 16 ? 0 : V <= 32 ? 1 : 2;
  if (which == 2 && shared_bytes(32, V, V, true) > BLOCK_SHARED_MAX)
    which = 3;
  const bool staged = which != 3;
  const int vr = which == 0 ? 16 : which == 1 ? 32 : V;
  int zc = round_up(Z, 32);
  while (zc > 32 && shared_bytes(zc, V, vr, staged) > BLOCK_SHARED_MAX)
    zc -= 32;
  const size_t smem = shared_bytes(zc, V, vr, staged);
  if (smem > BLOCK_SHARED_MAX) return (int)cudaErrorInvalidValue;

  const Kernel kernel = KERNELS[which];
  std::lock_guard<std::mutex> hold(cards_lock);
  CardState& card = cards[device];
  if (card.sm_count == 0) {
    err = cudaDeviceGetAttribute(&card.sm_count,
                                 cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
  }
  if (!card.granted[which]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)BLOCK_SHARED_MAX);
    if (err != cudaSuccess) return (int)err;
    card.granted[which] = true;
  }
  if (card.occupancy_smem[which] != smem) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &card.blocks_per_sm[which], kernel, THREADS, smem);
    if (err != cudaSuccess) return (int)err;
    card.occupancy_smem[which] = smem;
  }
  const int n_items = (Z + zc - 1) / zc * ((B + P - 1) / P);
  launch->which = which;
  launch->zc = zc;
  launch->smem = smem;
  launch->kernel = kernel;
  launch->blocks_per_sm = card.blocks_per_sm[which];
  launch->grid =
      std::min(n_items, card.sm_count * std::max(launch->blocks_per_sm, 1));
  return 0;
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
  Launch launch;
  const int err = plan_launch(B, Z, V, device, &launch);
  if (err != 0) return err;
  launch.kernel<<<launch.grid, THREADS, launch.smem, (cudaStream_t)stream>>>(
      (const float*)lat, (const float*)lon, (const float*)vertices,
      (uint8_t*)out, B, Z, V, launch.zc);
  return (int)cudaGetLastError();
}

// The launch plan of a call with these sizes on card `device`, for
// reports: plan[0..5] = zones per chunk, points per tile, dynamic shared
// bytes, blocks per SM, grid, the instantiation (0, 1: staged, 16 or 32
// vertex y's in registers; 2: staged; 3: global memory). Returns the CUDA
// error code.
int swt_points_in_zones_plan(int B, int Z, int V, int device, int* plan) {
  Launch launch;
  const int err = plan_launch(B, Z, V, device, &launch);
  plan[0] = launch.zc;
  plan[1] = P;
  plan[2] = (int)launch.smem;
  plan[3] = launch.blocks_per_sm;
  plan[4] = launch.grid;
  plan[5] = launch.which;
  return err;
}

const char* swt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
