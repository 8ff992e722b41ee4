// The rule-program pass of the stateful step on Hopper, in one launch.
//
// Evaluates the compiled rule-program tables (sitewhere_tpu_torch/rules/
// compiler.py) for every batch row and every program, with the per-(device,
// program) temporal state of the fused i32 slab [D, P, 4S+2]
// (sitewhere_tpu_torch/ops/slab.py). It replaces the XLA ops of the JAX
// package's `eval_rule_programs` (sitewhere_tpu/ops/stateful.py) — there is
// no Pallas kernel for it — and computes exactly what the port's plain
// version `eval_rule_programs_plain` (sitewhere_tpu_torch/ops/stateful.py)
// computes, bit for bit:
//   - only ATTACH rows (a device's last tracked-measurement row) tick; a
//     row that is not one gets fired = false, first_rule = -1,
//     alert_level = -1 and reads nothing else;
//   - an attach row reads its device's P records (a device index >= D
//     reads row D-1, < 0 row 0), treats a record whose generation lane
//     differs from the program's epoch as fresh (zeros, ts = NEG), walks
//     each program's nodes in slot order, and, unless its device index is
//     >= D, writes all P records back with the new root_prev bit and the
//     epoch in the generation lane;
//   - a program fires on the rising edge of its root (tick & root &
//     !root_prev) and counts a suppression where the root stays true; the
//     counts are added to fire_count / suppress_count, which the wrapper
//     has already reset where the epoch moved.
// The caller's rows hold at most one attach row per clamped device index
// (ops/stateful.py `observations_of_batch` gives exactly one per ticked
// device), so the records written never overlap one another or a record
// another row reads.
//
// Arithmetic is that of the plain version (ops/numerics.py sub_f32,
// mul_f32, div_f32, fma_f32), made explicit, as XLA's CPU code computes
// it: every f32 operation is an IEEE op rounded to nearest by an __*_rn
// intrinsic (no contraction, no approximate divide); operands are flushed
// by ftz(); a result is flushed where its exact value is tiny after
// rounding (x86's rule, decided in f64: a result that rounds up to FLT_MIN
// from below FLT_MIN * (1 - 2^-25) becomes a signed zero); a NaN operand
// gives the first NaN operand, quieted. The build keeps IEEE semantics (no
// --use_fast_math, no .ftz modifiers, whose tininess test may differ). The
// EWMA update is the fused multiply-add XLA contracts it into:
// fma(alpha, v, (1 - alpha) * sv), rounded once (round to odd in f64).
// int32 sums and differences (counter + 1, ts - since) wrap, as in XLA and
// torch: they are taken in uint32_t. A NaN value satisfies no comparison,
// `!=` included.
//
// What bounds it on the H100: bytes. Each attach row reads and writes its
// device's P * (4S+2) i32 words once (8704 B at P = 32, S = 8) and reads a
// few words of its measurement rows; every row reads its attach flag and
// writes 9 B of outputs; the node walk is a few hundred integer and f32
// operations a record. chip_smoke.py counts both from each run's rows.
//
// What the design does about it:
//   - a warp takes a tile of 32 rows: their attach flags and outputs move
//     coalesced, and the warp then walks the tile's attach rows one by one
//     (a ballot), one lane per program, looping over programs in chunks of
//     32 when P > 32;
//   - the attach row's P records are contiguous in the slab; the warp
//     stages them into shared memory with 16-byte loads, evaluates them in
//     place there, and writes them back the same way. When one warp's
//     records do not fit in a block's shared memory (P * (4S+2) words
//     beyond ~58k), they are staged in a global scratch slice of the warp
//     (the wrapper allocates it), so that any table runs;
//   - the node columns in use (9 fields of P x N) are staged once per block
//     in shared memory as [N][P], where they fit (64 KB), so that the
//     lanes of a warp read consecutive words; a [P][N] table read from
//     global memory costs one L1 wavefront per lane and field;
//   - node values are bits: a uint64_t in registers for N <= 64, else a
//     bit array in a global scratch slice of the warp (lane-interleaved
//     words), so that no node count is refused;
//   - first_rule is the lowest set bit of a ballot of fires, alert_level
//     a __reduce_max_sync; fires and suppressions are integer atomics into
//     per-block counters in shared memory, added to the [P] counters once
//     per block (order-independent, so the counts are exact).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <mutex>

namespace {

constexpr int WARP = 32;
constexpr int MAX_WARPS = 8;          // warps per block, records in shared
constexpr int MIN_BLOCKS = 4;         // blocks of MAX_WARPS an SM holds
constexpr int GLOBAL_WARPS = 4;       // warps per block, records in global
constexpr int MAX_CARDS = 64;
constexpr size_t BLOCK_SHARED_MAX = 232448;  // 227 KB, the opt-in maximum
constexpr long long TABLE_SHARED_MAX = 64 << 10;  // node columns staged
constexpr unsigned FULL = 0xffffffffu;
constexpr float FLT_MIN_NORMAL = 1.17549435e-38f;  // 2^-126
constexpr double TINY_AFTER_ROUNDING =
    1.1754943508222875e-38 * (1.0 - 0x1p-25);
#define INF64 __longlong_as_double(0x7ff0000000000000LL)
constexpr int NEG = INT32_MIN;        // "no timestamp"
constexpr int DEBOUNCE_CAP = 1 << 30;

// rules/compiler.py ProgramOp and ops/threshold.py ThresholdOp
enum Op { VALUE = 1, EWMA = 2, RATE = 3, NOT = 4, AND = 5, OR = 6,
          DEBOUNCE = 7, FOR_DURATION = 8, HYSTERESIS = 9 };
enum Cmp { GT = 0, GTE = 1, LT = 2, LTE = 3, EQ = 4 };

}  // namespace

// The launch's arguments; its layout is mirrored by `_RuleArgs` in
// sitewhere_tpu_torch/ops/stateful.py (bool tensors as one byte each).
struct RuleArgs {
  // the program table: [P] columns, then [P, node_stride] node columns
  const uint8_t* active;
  const int* tenant_idx;
  const int* device_type_idx;
  const int* alert_level;
  const int* root;
  const int* epoch;
  const int* opcode;
  const int* mm_idx;
  const int* lhs;
  const int* rhs;
  const int* cmp_op;
  const float* fconst;
  const float* falpha;
  const int* iparam;
  const int* state_slot;
  // the state slab [D, P, 4S+2], updated in place
  int* slab;
  // the rows [B] and [B, M]
  const int* dev;
  const uint8_t* attach;
  const uint8_t* obs_row;
  const int* now_row;
  const float* lm_row;
  const int* lmts_row;
  const int* tenant_row;
  const int* dtype_row;
  // outputs [B], and the [P] counters (already reset where the epoch moved)
  uint8_t* fired;
  int* first_rule;
  int* level;
  int* fire_count;
  int* suppress_count;
  // scratch (see plan_launch), may be null when the plan needs none
  int* scratch;
  long long B;
  int D, P, node_stride, N, M, S;
  long long scratch_words;
  // set by the launch: i32 words of the block's shared copy of the node
  // columns (0: read from the table)
  long long table_words;
};

namespace {

// a denormal as the zero of its sign; anything else unchanged
__device__ __forceinline__ float ftz(float x) {
  return fabsf(x) < FLT_MIN_NORMAL ? copysignf(0.0f, x) : x;
}

// XLA's CPU code, and so the plain version, flushes where the exact result
// is tiny AFTER rounding (to 24 bits, exponent unbounded): below
// FLT_MIN * (1 - 2^-25) in magnitude (ops/numerics.py TINY_AFTER_ROUNDING)
__device__ __forceinline__ float flush_by_exact(float r, double exact) {
  return fabs(exact) < TINY_AFTER_ROUNDING ? copysignf(0.0f, r) : r;
}

__device__ __forceinline__ float quiet(float x) {
  return __int_as_float(__float_as_int(x) | 0x00400000);
}

// ops/numerics.py `nan_first`: the first NaN operand, quieted
__device__ __forceinline__ float nan_first(float r, float a, float b) {
  return isnan(a) ? quiet(a) : (isnan(b) ? quiet(b) : r);
}

// ops/numerics.py sub_f32 / mul_f32 / div_f32 / fma_f32, operation for
// operation
__device__ __forceinline__ float sub_f32(float a, float b) {
  a = ftz(a);
  b = ftz(b);
  return nan_first(ftz(__fsub_rn(a, b)), a, b);
}

__device__ __forceinline__ float mul_f32(float a, float b) {
  a = ftz(a);
  b = ftz(b);
  const float r = flush_by_exact(__fmul_rn(a, b),
                                 __dmul_rn((double)a, (double)b));
  return nan_first(r, a, b);
}

__device__ __forceinline__ float div_f32(float a, float b) {
  a = ftz(a);
  b = ftz(b);
  const float r = flush_by_exact(__fdiv_rn(a, b),
                                 __ddiv_rn((double)a, (double)b));
  return nan_first(r, a, b);
}

// a * b + c rounded once: the exact f64 product, the f64 sum rounded to odd
// through its TwoSum error, then to f32 (53 >= 2 * 24 + 2 bits)
__device__ __forceinline__ float fma_f32(float a, float b, float c) {
  a = ftz(a);
  b = ftz(b);
  c = ftz(c);
  const double p = __dmul_rn((double)a, (double)b), cd = (double)c;
  double s = __dadd_rn(p, cd);
  const double bv = __dsub_rn(s, p);
  const double err = __dadd_rn(__dsub_rn(p, __dsub_rn(s, bv)),
                               __dsub_rn(cd, bv));
  if (isfinite(err) && err != 0.0 && (__double_as_longlong(s) & 1) == 0)
    s = nextafter(s, err > 0.0 ? INF64 : -INF64);
  const float r = flush_by_exact(ftz(__double2float_rn(s)), s);
  return isnan(a) ? quiet(a) : nan_first(r, b, c);
}

__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((uint32_t)a + (uint32_t)b);
}

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return (int)((uint32_t)a - (uint32_t)b);
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// ops/threshold.py `_compare`: NaN values never match; denormal operands
// compare as zeros; an op outside GT..EQ is `!=`
__device__ __forceinline__ bool compare(float v, int op, float c) {
  if (isnan(v)) return false;
  v = ftz(v);
  c = ftz(c);
  switch (op) {
    case GT: return v > c;
    case GTE: return v > c || v == c;
    case LT: return v < c;
    case LTE: return v < c || v == c;
    case EQ: return v == c;
    default: return !(v == c);
  }
}

// node output bits of one (row, program): registers for N <= 64
template <bool WIDE>
struct NodeBits {
  uint64_t bits;
  __device__ __forceinline__ void init(uint32_t*, int) { bits = 0; }
  __device__ __forceinline__ bool get(int k) const {
    return (bits >> k) & 1u;
  }
  __device__ __forceinline__ void set(int k, bool v) {
    bits |= (uint64_t)v << k;
  }
};

// ... else words in the warp's scratch slice, word k of this lane at w[32 k]
template <>
struct NodeBits<true> {
  uint32_t* w;
  __device__ __forceinline__ void init(uint32_t* base, int words) {
    w = base;
    for (int k = 0; k < words; ++k) w[k * WARP] = 0;
  }
  __device__ __forceinline__ bool get(int k) const {
    return (w[(k >> 5) * WARP] >> (k & 31)) & 1u;
  }
  __device__ __forceinline__ void set(int k, bool v) {
    if (v) w[(k >> 5) * WARP] |= 1u << (k & 31);
  }
};

struct Row {
  long long b;
  int tenant, dtype, now;
};

// The node columns as the kernel reads them: node j of program p at
// [j * js + p * ps], from the block's shared copy ([N][P], so that a warp's
// lanes read consecutive words) or from the table itself ([P][node_stride])
struct Nodes {
  const int *opcode, *mm_idx, *lhs, *rhs, *cmp_op, *iparam, *state_slot;
  const float *fconst, *falpha;
  long long js, ps;
};
constexpr int NODE_FIELDS = 9;

// One program's step on one attach row; `r` is its record (4S+2 words),
// updated in place. Sets *fired / *suppressed.
template <bool WIDE>
__device__ void eval_program(const RuleArgs& a, const Nodes& t,
                             const Row& row, int p, int* r,
                             uint32_t* bit_words, bool* fired,
                             bool* suppressed) {
  const int S = a.S, M = a.M, N = a.N;
  const int tp = a.tenant_idx[p], dp = a.device_type_idx[p];
  const bool tick = a.active[p] && (tp == 0 || tp == row.tenant) &&
                    (dp == 0 || dp == row.dtype);   // eligible & attach
  const int ep = a.epoch[p];
  const bool stale = r[4 * S + 1] != ep;
  if (stale) {   // a fresh record: value / aux +0.0, ts NEG, counter 0
    for (int k = 0; k < S; ++k) {
      r[k] = 0;
      r[S + k] = 0;
      r[2 * S + k] = NEG;
      r[3 * S + k] = 0;
    }
  }
  const bool prev = !stale && r[4 * S] != 0;

  const long long mrow = row.b * M;
  NodeBits<WIDE> nb;
  nb.init(bit_words, (N + 31) >> 5);
  for (int j = 0; j < N; ++j) {
    const long long idx = j * t.js + p * t.ps;
    const int op = t.opcode[idx];
    if (op < VALUE || op > HYSTERESIS) continue;   // NOP: false, no state
    bool out = false;
    if (op == VALUE || op == EWMA || op == RATE) {
      const int mm = clampi(t.mm_idx[idx], 0, M - 1);
      const float v = a.lm_row[mrow + mm];
      const int cmp = t.cmp_op[idx];
      const float c = t.fconst[idx];
      if (op == VALUE) {
        out = a.lmts_row[mrow + mm] > NEG && compare(v, cmp, c);
      } else {
        const int slot = clampi(t.state_slot[idx], 0, S - 1);
        const bool observed = a.obs_row[mrow + mm] && tick;
        const float sv = __int_as_float(r[slot]);
        const int sc = r[3 * S + slot];
        const int nsc = wrap_add(sc, observed ? 1 : 0);
        if (op == EWMA) {
          float nsv = sv;
          if (observed) {
            if (sc > 0) {
              const float alpha = t.falpha[idx];
              nsv = fma_f32(alpha, v, mul_f32(sub_f32(1.0f, alpha), sv));
            } else {
              nsv = v;
            }
          }
          out = nsc > 0 && compare(nsv, cmp, c);
          r[slot] = __float_as_int(nsv);
        } else {   // RATE
          const int cur_ts = a.lmts_row[mrow + mm];
          const int st = r[2 * S + slot];
          float nsa = __int_as_float(r[S + slot]);
          if (observed && sc > 0) {
            int dti = wrap_sub(cur_ts, st);
            if (dti < 1) dti = 1;
            nsa = div_f32(mul_f32(sub_f32(v, sv), 1000.0f),
                          __int2float_rn(dti));
          }
          out = nsc > 1 && compare(nsa, cmp, c);
          if (observed) {
            r[slot] = __float_as_int(v);
            r[2 * S + slot] = cur_ts;
          }
          r[S + slot] = __float_as_int(nsa);
        }
        r[3 * S + slot] = nsc;
      }
    } else {
      const bool l = nb.get(clampi(t.lhs[idx], 0, N - 1));
      const bool rr = nb.get(clampi(t.rhs[idx], 0, N - 1));
      if (op == NOT) {
        out = !l;
      } else if (op == AND) {
        out = l && rr;
      } else if (op == OR) {
        out = l || rr;
      } else {
        const int slot = clampi(t.state_slot[idx], 0, S - 1);
        if (op == DEBOUNCE) {
          const int sc = r[3 * S + slot];
          int nsc = sc;
          if (tick) {
            const int up = wrap_add(sc, 1);
            nsc = l ? (up < DEBOUNCE_CAP ? up : DEBOUNCE_CAP) : 0;
          }
          out = nsc >= t.iparam[idx];
          r[3 * S + slot] = nsc;
        } else if (op == FOR_DURATION) {
          const int st = r[2 * S + slot];
          const int since = st == NEG ? row.now : st;
          const int nst = tick ? (l ? since : NEG) : st;
          out = l && nst != NEG && wrap_sub(row.now, nst) >= t.iparam[idx];
          r[2 * S + slot] = nst;
        } else {   // HYSTERESIS
          const bool latch = r[3 * S + slot] > 0;
          const bool nl = tick ? ((latch || l) && !rr) : latch;
          out = nl;
          r[3 * S + slot] = nl ? 1 : 0;
        }
      }
    }
    nb.set(j, out);
  }
  const bool root = N > 0 && nb.get(clampi(a.root[p], 0, N - 1)) && tick;
  *fired = tick && root && !prev;
  *suppressed = tick && root && prev;
  r[4 * S] = (tick ? root : prev) ? 1 : 0;
  r[4 * S + 1] = ep;
}

// copy `words` i32 words from src to dst, the warp's lanes side by side
__device__ __forceinline__ void copy_words(int* dst, const int* src,
                                           long long words, bool vec,
                                           int lane) {
  if (vec) {
    int4* d = reinterpret_cast<int4*>(dst);
    const int4* s = reinterpret_cast<const int4*>(src);
    for (long long k = lane; k < words / 4; k += WARP) d[k] = s[k];
  } else {
    for (long long k = lane; k < words; k += WARP) dst[k] = src[k];
  }
}

__host__ __device__ __forceinline__ long long round_up4(long long x) {
  return (x + 3) & ~3LL;
}

template <bool WIDE, bool SHARED_RECORDS>
__global__ void __launch_bounds__(MAX_WARPS * WARP, MIN_BLOCKS)
rule_programs_kernel(RuleArgs a) {
  extern __shared__ __align__(16) int smem[];
  const int P = a.P;
  const long long rec_words = (long long)P * (4 * a.S + 2);
  const long long rec_stride = round_up4(rec_words);
  const int counters = (int)round_up4(2 * P);
  int* blk_fire = smem;
  int* blk_suppress = smem + P;
  for (int i = threadIdx.x; i < 2 * P; i += blockDim.x) smem[i] = 0;
  // the node columns in use, staged once per block as [N][P], or read from
  // the table where they do not fit (a.table_words == 0)
  const long long cells = (long long)P * a.N;
  Nodes nodes;
  if (a.table_words) {
    int* tab = smem + counters;
    const int* cols[NODE_FIELDS] = {
        a.opcode, a.mm_idx, a.lhs, a.rhs, a.cmp_op, a.iparam, a.state_slot,
        reinterpret_cast<const int*>(a.fconst),
        reinterpret_cast<const int*>(a.falpha)};
    for (int f = 0; f < NODE_FIELDS; ++f)
      for (long long k = threadIdx.x; k < cells; k += blockDim.x) {
        const long long p = k / a.N, j = k % a.N;
        tab[f * cells + j * P + p] = cols[f][p * a.node_stride + j];
      }
    nodes = Nodes{tab, tab + cells, tab + 2 * cells, tab + 3 * cells,
                  tab + 4 * cells, tab + 5 * cells, tab + 6 * cells,
                  reinterpret_cast<const float*>(tab + 7 * cells),
                  reinterpret_cast<const float*>(tab + 8 * cells), P, 1};
  } else {
    nodes = Nodes{a.opcode, a.mm_idx, a.lhs, a.rhs, a.cmp_op, a.iparam,
                  a.state_slot, a.fconst, a.falpha, 1, a.node_stride};
  }
  __syncthreads();

  const int lane = threadIdx.x & (WARP - 1);
  const int wib = threadIdx.x / WARP;
  const int wpb = blockDim.x / WARP;
  const long long gwarp = (long long)blockIdx.x * wpb + wib;
  const long long total_warps = (long long)gridDim.x * wpb;
  int* rec = SHARED_RECORDS
      ? smem + counters + a.table_words + wib * rec_stride
      : a.scratch + gwarp * rec_stride;
  uint32_t* bit_words = nullptr;
  if (WIDE) {
    const long long rec_region = SHARED_RECORDS ? 0 : total_warps * rec_stride;
    bit_words = reinterpret_cast<uint32_t*>(a.scratch) + rec_region +
                gwarp * ((a.N + 31) >> 5) * WARP + lane;
  }
  const bool vec = (rec_words & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(a.slab) & 15) == 0;

  const long long tiles = (a.B + WARP - 1) / WARP;
  for (long long t = gwarp; t < tiles; t += total_warps) {
    const long long b = t * WARP + lane;
    const bool in = b < a.B;
    bool my_fired = false;
    int my_first = -1, my_level = -1;
    unsigned pending = __ballot_sync(FULL, in && a.attach[b] != 0);
    while (pending) {
      const int i = __ffs(pending) - 1;
      pending &= pending - 1;
      Row row;
      row.b = t * WARP + i;
      const int d = a.dev[row.b];
      row.tenant = a.tenant_row[row.b];
      row.dtype = a.dtype_row[row.b];
      row.now = a.now_row[row.b];
      const int gd = clampi(d, 0, a.D - 1);
      int* src = a.slab + (size_t)gd * rec_words;
      copy_words(rec, src, rec_words, vec, lane);
      __syncwarp();

      int first = -1, level = INT32_MIN;
      for (int p0 = 0; p0 < P; p0 += WARP) {
        const int p = p0 + lane;
        bool f = false, s = false;
        int lv = INT32_MIN;
        if (p < P) {
          eval_program<WIDE>(a, nodes, row, p,
                             rec + (long long)p * (4 * a.S + 2), bit_words,
                             &f, &s);
          lv = f ? a.alert_level[p] : -1;
          if (f) atomicAdd(blk_fire + p, 1);
          if (s) atomicAdd(blk_suppress + p, 1);
        }
        const unsigned fm = __ballot_sync(FULL, f);
        if (fm && first < 0) first = p0 + __ffs(fm) - 1;
        level = max(level, __reduce_max_sync(FULL, lv));
      }
      __syncwarp();
      if (d < a.D) copy_words(src, rec, rec_words, vec, lane);
      __syncwarp();   // the record is read out before the next row's lands
      if (lane == i) {
        my_fired = first >= 0;
        my_first = first;
        my_level = level;
      }
    }
    if (in) {
      a.fired[b] = my_fired ? 1 : 0;
      a.first_rule[b] = my_first;
      a.level[b] = my_level;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    if (blk_fire[i]) atomicAdd(a.fire_count + i, blk_fire[i]);
    if (blk_suppress[i]) atomicAdd(a.suppress_count + i, blk_suppress[i]);
  }
}

typedef void (*Kernel)(RuleArgs);
// [wide][shared records]
const Kernel KERNELS[2][2] = {
    {rule_programs_kernel<false, false>, rule_programs_kernel<false, true>},
    {rule_programs_kernel<true, false>, rule_programs_kernel<true, true>}};

struct CardState {
  int sm_count = 0;
  bool granted[2][2] = {};
  int occupancy_threads[2][2] = {};
  size_t occupancy_smem[2][2] = {};
  int blocks_per_sm[2][2] = {};
};
std::mutex cards_lock;
CardState cards[MAX_CARDS];

struct Launch {
  Kernel kernel;
  int grid, threads, blocks_per_sm;
  size_t smem;
  bool wide, shared_records;
  long long scratch_words, table_words;
};

// Plans a launch (granting the kernel its shared memory on the way);
// returns the CUDA error code. The scratch the plan needs: each warp's
// records when they are not staged in shared memory, then each warp's node
// bits when N > 64.
int plan_launch(long long B, int P, int N, int S, int device, Launch* l) {
  if (device < 0 || device >= MAX_CARDS) return (int)cudaErrorInvalidDevice;
  if (B < 0 || P < 1 || N < 0 || S < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;

  const long long rec_bytes = round_up4((long long)P * (4 * S + 2)) * 4;
  const long long counter_bytes = round_up4(2 * (long long)P) * 4;
  if (counter_bytes > (long long)BLOCK_SHARED_MAX)
    return (int)cudaErrorInvalidValue;
  const bool shared_records =
      counter_bytes + rec_bytes <= (long long)BLOCK_SHARED_MAX;
  const bool wide = N > 64;
  // the node columns in use go to shared memory when they fit beside the
  // counters and one warp's records
  const long long table_bytes =
      round_up4((long long)NODE_FIELDS * P * N) * 4;
  const bool table_shared =
      table_bytes <= TABLE_SHARED_MAX &&
      counter_bytes + table_bytes + (shared_records ? rec_bytes : 0) <=
          (long long)BLOCK_SHARED_MAX;
  const long long fixed = counter_bytes + (table_shared ? table_bytes : 0);
  const int wpb = shared_records
      ? (int)std::min<long long>(
            MAX_WARPS, ((long long)BLOCK_SHARED_MAX - fixed) / rec_bytes)
      : GLOBAL_WARPS;
  const size_t smem = (size_t)(fixed + (shared_records ? wpb * rec_bytes
                                                       : 0));
  const Kernel kernel = KERNELS[wide][shared_records];

  std::lock_guard<std::mutex> hold(cards_lock);
  CardState& card = cards[device];
  if (card.sm_count == 0) {
    err = cudaDeviceGetAttribute(&card.sm_count,
                                 cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
  }
  if (!card.granted[wide][shared_records]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)BLOCK_SHARED_MAX);
    if (err != cudaSuccess) return (int)err;
    card.granted[wide][shared_records] = true;
  }
  if (card.occupancy_smem[wide][shared_records] != smem ||
      card.occupancy_threads[wide][shared_records] != wpb * WARP) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &card.blocks_per_sm[wide][shared_records], kernel, wpb * WARP, smem);
    if (err != cudaSuccess) return (int)err;
    card.occupancy_smem[wide][shared_records] = smem;
    card.occupancy_threads[wide][shared_records] = wpb * WARP;
  }
  const int bpsm = std::max(card.blocks_per_sm[wide][shared_records], 1);
  const long long tiles = (B + WARP - 1) / WARP;
  const long long needed = (tiles + wpb - 1) / wpb;
  // a warp per tile where nothing is scratch; else the resident warps (one
  // block per SM with records in global scratch) bound the scratch
  const long long most = !shared_records ? card.sm_count
      : wide ? (long long)card.sm_count * bpsm : needed;
  l->grid = (int)std::min(needed, most);
  l->threads = wpb * WARP;
  l->blocks_per_sm = bpsm;
  l->smem = smem;
  l->wide = wide;
  l->shared_records = shared_records;
  l->kernel = kernel;
  const long long warps = (long long)l->grid * wpb;
  l->scratch_words = (shared_records ? 0 : warps * (rec_bytes / 4)) +
                     (wide ? warps * WARP * ((N + 31) / 32) : 0);
  l->table_words = table_shared ? table_bytes / 4 : 0;
  return 0;
}

}  // namespace

extern "C" {

// Launches on `stream` of card `device` without synchronising; returns the
// CUDA error code (0 = the launch was accepted, or B == 0 and nothing ran).
// `args->scratch` must hold the plan's scratch words (swt_rule_programs_plan).
// This library carries its own (static) CUDA runtime, whose current device
// is set here rather than inherited from the caller's.
int swt_rule_programs(const RuleArgs* args, int device, void* stream) {
  Launch launch;
  const int err = plan_launch(args->B, args->P, args->N, args->S, device,
                              &launch);
  if (err != 0) return err;
  if (launch.grid == 0) return 0;
  if (args->scratch_words < launch.scratch_words ||
      (launch.scratch_words > 0 && args->scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  RuleArgs run = *args;
  run.table_words = launch.table_words;
  launch.kernel<<<launch.grid, launch.threads, launch.smem,
                  (cudaStream_t)stream>>>(run);
  return (int)cudaGetLastError();
}

// The launch plan for these sizes on card `device`: plan[0..7] = grid,
// threads per block, dynamic shared bytes, blocks per SM, scratch words
// (i32), records staged in shared memory (1) or global scratch (0), node
// bits in registers (0) or global scratch (1), node columns staged in
// shared memory (1) or read from the table (0). Returns the CUDA error
// code.
int swt_rule_programs_plan(long long B, int P, int N, int S, int device,
                           long long* plan) {
  Launch launch;
  const int err = plan_launch(B, P, N, S, device, &launch);
  if (err != 0) return err;
  plan[0] = launch.grid;
  plan[1] = launch.threads;
  plan[2] = (long long)launch.smem;
  plan[3] = launch.blocks_per_sm;
  plan[4] = launch.scratch_words;
  plan[5] = launch.shared_records ? 1 : 0;
  plan[6] = launch.wide ? 1 : 0;
  plan[7] = launch.table_words > 0 ? 1 : 0;
  return 0;
}

const char* swt_rule_programs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
