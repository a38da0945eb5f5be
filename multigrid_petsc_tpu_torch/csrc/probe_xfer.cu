// K18b-W, K18b-R, K18b-P: the halo-window extraction and the x-transfer
// passes on a resident slab, for Hopper (sm_90a), bound through a plain C
// interface (ctypes).  No solve runs them; the attribution probes
// windows_ab and transpose do (multigrid_petsc_tpu_torch/probes).
//
// K18b-W, mg_halo_windows: replaces benchmarks/probe_windows_ab.py
// halo_windows_pallas (its pallas_call at :72), which extracts the halo
// windows of every row block of `stride` rows in one pass:
//   tails[i][j] = x[i stride - top + j] (i >= 1), heads[i][j] =
//   x[(i + 1) stride + j], tails[0] and every row at or past n zero.
// The card's visits read their halos in place, so this kernel only
// measures what building the TPU's windows would cost.  What bounds it:
// bytes, each output row written once and each non-zero one read once
// (at 8191^2, stride 160, g = 52, top = bot = 5: 1035 rows of 32.8 KB,
// 33.9 MB).  Its design: a masked row copy, a block per (output row,
// 1024-column tile), 256 threads each loading WUNROLL values before
// storing them, neighbouring threads on neighbouring addresses.  An
// 8191-float row starts 16-byte aligned only every fourth row, and an
// output row and its source row sit at different offsets mod 16, so the
// loads and stores are coalesced 4-byte accesses, not 16-byte vectors.
//
// K18b-R and K18b-P, mg_xfer_pass: replace benchmarks/probe_transpose.py
// make (:109) and make_prolong (:139).  The TPU kernels run an
// x-transfer (the down visit's x-restriction _restrict_x_pad, or variants
// of its parts; the up visit's x-prolongation _prolong_x_pad) G times on a
// slab resident in VMEM, each pass on the slab scaled by
// s_i = 1 + 1e-7 i, summing the passes' outputs: what the pass costs
// with no device-memory traffic.  On the card the x-restriction is a
// pass over shared memory inside the visit kernel (visit.cuh), so here
// each warp loads its span of a slab row into shared memory once, runs
// the G passes from there, keeps the sums in registers and stores them
// once.
//
// What bounds them: the HBM bytes (the slab in, the sums out) are tiny.
// The yardstick is the larger of the JAX function's operations, one FP32
// instruction each (every product and sum is rounded on its own, so none
// fuses into an FMA) at 128 a clock an SM, and the slab's input columns
// read once a pass from shared memory at 128 B a clock an SM
// (xfer_probe_kernel.xfer_bound): noop, shuffle and full are bound by
// shared memory, arith, apply8 and prolong by operations.
//
// The design (Tiling<MODE>: K, P, EDGE, OVER):
// - A warp takes one span of 128 K consecutive input columns of one row,
//   a lane 4 K consecutive ones (K 16-byte units).  Warps are independent:
//   a block is ceil(spans / SMs) of them (at most MAX_WARPS, and 48 KB of
//   shared memory), so that the grid is about one block an SM with its
//   warps on different schedulers; there is no __syncthreads.
// - The fill: coalesced 16-byte loads, unit u of the span to slot
//   32 (u % K) + u / K of the warp's tile, so that lane l's c-th unit sits
//   at slot 32 c + l.  Each of a pass's K LDS.128 then reads 512
//   contiguous bytes, free of bank conflicts, and a pass reads every
//   column of the span once.  Units past the row are zero, apply8's wrap
//   cyclically on nxcp columns, prolong's pad column reads 0.  A slab that
//   is not 16-byte aligned takes 4-byte loads.
// - Neighbours: a lane takes the columns next to its own from the next
//   lane (arith 2, full 1) or the previous one (prolong 1) by
//   __shfl_*_sync; the warp's edge lane takes them from a halo unit kept
//   after the span, read by one broadcast load a pass (EDGE floats).
//   apply8's 8 steps take each neighbour by a shuffle a step; its spans
//   overlap by OVER = 8 columns a side, where the edge lanes' wrong
//   neighbours spread, and a warp stores the middle of its span.
// - No barrier in the pass loop: each window load is ld.volatile.shared,
//   which the compiler may neither hoist out of the loop nor merge, so
//   every pass reads its window from shared memory (scripts/xfer_sass.py
//   counts the loads in the loop's body).  A lane keeps P passes'
//   windows in registers: pass i's is loaded again for pass i + P as soon
//   as pass i has used it, so each load has P - 1 passes' arithmetic to
//   arrive in.  The sums are added in pass order.  s_i is made in
//   registers, bit for bit pass_scales.
// - The stores: the sums go through the warp's tile in the order of the
//   output row, then out in 16-byte units, consecutive lanes on
//   consecutive units.  Full's last output column (0 in JAX) is set
//   once, at the store.
//
// Arithmetic: the JAX kernels' order, each product and sum rounded on its
// own (__fmul_rn, __fadd_rn are never contracted into an FMA), so the
// kernels equal their plain PyTorch versions bit for bit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// ---- K18b-W: the halo windows.
constexpr int WTHREADS = 256;
constexpr int WUNROLL = 4;
constexpr int WTILE = WTHREADS * WUNROLL;  // columns a block of one row
constexpr int MAX_GRID_Y = 65535;

__global__ void __launch_bounds__(WTHREADS)
halo_windows_kernel(const float* __restrict__ x, long long ld, int n, int nx,
                    int stride, int g, int top, int bot,
                    float* __restrict__ tails, float* __restrict__ heads) {
  const int nrows = g * (top + bot);
  const int c0 = blockIdx.x * WTILE + threadIdx.x;
  for (int r = blockIdx.y; r < nrows; r += gridDim.y) {
    long long src;  // the source row; -1: a row of zeros
    float* dst;
    if (r < g * top) {
      const int i = r / top;
      src = i >= 1 ? (long long)i * stride - top + (r - i * top) : -1;
      dst = tails + (long long)r * nx;
    } else {
      const int q = r - g * top;
      const int i = q / bot;
      src = (long long)(i + 1) * stride + (q - i * bot);
      dst = heads + (long long)q * nx;
    }
    if (src >= n) src = -1;
    float v[WUNROLL];
    const float* row = x + (src < 0 ? 0 : src) * ld;
#pragma unroll
    for (int k = 0; k < WUNROLL; ++k) {
      const int c = c0 + k * WTHREADS;
      v[k] = (src >= 0 && c < nx) ? row[c] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < WUNROLL; ++k) {
      const int c = c0 + k * WTHREADS;
      if (c < nx) dst[c] = v[k];
    }
  }
}

// ---- K18b-R / K18b-P: the x-transfer passes.
enum XferMode { NOOP = 0, ARITH = 1, SHUFFLE = 2, FULL = 3, APPLY8 = 4,
                PROLONG = 5 };
constexpr int APPLY_STEPS = 8;  // apply8's smoothing steps
// nxp must be a multiple of XFER_UNIT (the probe's widths are).
constexpr int XFER_UNIT = 512;
constexpr int MAX_PASSES = 8192;  // passes a launch takes
constexpr int MAX_WARPS = 16;     // warps a block
constexpr int SMEM_A_BLOCK = 48 * 1024;  // bytes, without opting in

// A mode's tiling: a lane takes K 16-byte units (4 K consecutive input
// columns), a warp 128 K; a turn of the pass loop loads P passes'
// windows; the warp's edge lane reads EDGE floats of the halo unit kept
// after its span (arith, full: the columns after the span; prolong: the
// one before it); the spans overlap by OVER columns a side (apply8).
// The input columns tiled: nxcp (half the fine width) or, for full, nxp.
template <int MODE>
struct Tiling;
template <> struct Tiling<NOOP> {
  static constexpr int K = 1, P = 4, EDGE = 0, OVER = 0;
};
template <> struct Tiling<ARITH> {
  static constexpr int K = 1, P = 2, EDGE = 2, OVER = 0;
};
template <> struct Tiling<SHUFFLE> {
  static constexpr int K = 2, P = 4, EDGE = 0, OVER = 0;
};
template <> struct Tiling<FULL> {
  static constexpr int K = 2, P = 2, EDGE = 1, OVER = 0;
};
template <> struct Tiling<APPLY8> {
  static constexpr int K = 2, P = 2, EDGE = 0, OVER = APPLY_STEPS;
};
template <> struct Tiling<PROLONG> {
  static constexpr int K = 2, P = 4, EDGE = 1, OVER = 0;
};

// The outputs a lane sums: noop, arith, apply8 one a column; shuffle its
// even columns' then its odd ones'; full one a column pair; prolong two a
// column.
template <int MODE>
__host__ __device__ constexpr int lane_outputs() {
  return MODE == FULL ? 2 * Tiling<MODE>::K
                      : MODE == PROLONG ? 8 * Tiling<MODE>::K
                                        : 4 * Tiling<MODE>::K;
}

// A warp's shared memory, floats: its span and halo unit, or, where more,
// its outputs staged for the stores (prolong).
template <int MODE>
__host__ __device__ constexpr int warp_floats() {
  constexpr int tile = 128 * Tiling<MODE>::K + (Tiling<MODE>::EDGE ? 4 : 0);
  constexpr int outs = 32 * lane_outputs<MODE>();
  return tile > outs ? tile : outs;
}

__device__ __forceinline__ float4 lds4(unsigned a) {
  float4 v;
  asm volatile("ld.volatile.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a));
  return v;
}

__device__ __forceinline__ float2 lds2(unsigned a) {
  float2 v;
  asm volatile("ld.volatile.shared.v2.f32 {%0, %1}, [%2];"
               : "=f"(v.x), "=f"(v.y)
               : "r"(a));
  return v;
}

__device__ __forceinline__ float lds1(unsigned a) {
  float v;
  asm volatile("ld.volatile.shared.f32 %0, [%1];" : "=f"(v) : "r"(a));
  return v;
}

// s_i = f32(1 + 1e-7 i) as xfer_probe_kernel.pass_scales forms it (in
// f64, then one rounding), in integers: in [1, 2) the f32 spacing is
// 2^-23 and 1e-7 i is 65536 i / 78125 of it, never within 2e-5 of a
// rounding tie for i < MAX_PASSES, so s_i = 1 + 2^-23 round(65536 i /
// 78125), the rounding one 64-bit product, (i M + 2^31) >> 32 with
// M = round(2^32 65536 / 78125) (tests/test_torch_probes_xfer.py holds
// it equal to pass_scales for every such i).  No f64 work a pass.
__device__ __forceinline__ float pass_scale(int i) {
  const unsigned long long k =
      ((unsigned long long)i * 3602879702ull + 2147483648ull) >> 32;
  return __int_as_float(0x3f800000 + (int)k);
}

// One pass's reads: the lane's 4 K columns and the edge floats.
template <int MODE>
struct Win {
  float x[4 * Tiling<MODE>::K];
  float e[Tiling<MODE>::EDGE > 0 ? Tiling<MODE>::EDGE : 1];
};

// `base`: the lane's slot of unit 0 (units 512 B apart); `edge`: the
// halo floats (shared-space addresses).
template <int MODE>
__device__ __forceinline__ void load_win(Win<MODE>& w, unsigned base,
                                         unsigned edge) {
#pragma unroll
  for (int c = 0; c < Tiling<MODE>::K; ++c) {
    const float4 f = lds4(base + 512 * c);
    w.x[4 * c] = f.x;
    w.x[4 * c + 1] = f.y;
    w.x[4 * c + 2] = f.z;
    w.x[4 * c + 3] = f.w;
  }
  if constexpr (Tiling<MODE>::EDGE == 2) {
    const float2 f = lds2(edge);
    w.e[0] = f.x;
    w.e[1] = f.y;
  } else if constexpr (Tiling<MODE>::EDGE == 1) {
    w.e[0] = lds1(edge);
  }
}

// One pass: the lane's outputs of op(x s) added to its sums.  v[m] is
// the lane's m-th column scaled.
//   noop     o[m] = v[m]
//   arith    o[m] = v[m] + 2 v[m + 1] + v[m + 2]
//   shuffle  o[k] = v[2k], o[U / 2 + k] = v[2k + 1]
//   full     o[k] = 0.0625 (v[2k] + 2 v[2k + 1] + v[2k + 2])
//   apply8   8 steps r = 0.99 r + 0.01 (r[-1] + r[+1]), o[m] = r[m]
//   prolong  o[2m] = 0.5 (v[m] + v[m - 1]), o[2m + 1] = v[m]
template <int MODE>
__device__ __forceinline__ void pass(const Win<MODE>& w, float s, int lane,
                                     float (&acc)[lane_outputs<MODE>()]) {
  constexpr int U = 4 * Tiling<MODE>::K;
  constexpr unsigned ALL = 0xffffffffu;
  float v[U];
#pragma unroll
  for (int m = 0; m < U; ++m) v[m] = __fmul_rn(w.x[m], s);
  if constexpr (MODE == NOOP) {
#pragma unroll
    for (int m = 0; m < U; ++m) acc[m] = __fadd_rn(acc[m], v[m]);
  } else if constexpr (MODE == SHUFFLE) {
#pragma unroll
    for (int k = 0; k < U / 2; ++k) {
      acc[k] = __fadd_rn(acc[k], v[2 * k]);
      acc[U / 2 + k] = __fadd_rn(acc[U / 2 + k], v[2 * k + 1]);
    }
  } else if constexpr (MODE == ARITH) {
    float n0 = __shfl_down_sync(ALL, w.x[0], 1);
    float n1 = __shfl_down_sync(ALL, w.x[1], 1);
    if (lane == 31) {
      n0 = w.e[0];
      n1 = w.e[1];
    }
    float t[U + 2];
#pragma unroll
    for (int m = 0; m < U; ++m) t[m] = v[m];
    t[U] = __fmul_rn(n0, s);
    t[U + 1] = __fmul_rn(n1, s);
#pragma unroll
    for (int m = 0; m < U; ++m)
      acc[m] = __fadd_rn(
          acc[m], __fadd_rn(__fadd_rn(t[m], __fmul_rn(2.f, t[m + 1])),
                            t[m + 2]));
  } else if constexpr (MODE == FULL) {
    float n0 = __shfl_down_sync(ALL, w.x[0], 1);
    if (lane == 31) n0 = w.e[0];
    float t[U + 1];
#pragma unroll
    for (int m = 0; m < U; ++m) t[m] = v[m];
    t[U] = __fmul_rn(n0, s);
#pragma unroll
    for (int k = 0; k < U / 2; ++k) {
      const float r = __fadd_rn(
          __fadd_rn(t[2 * k], __fmul_rn(2.f, t[2 * k + 1])), t[2 * k + 2]);
      acc[k] = __fadd_rn(acc[k], __fmul_rn(0.0625f, r));
    }
  } else if constexpr (MODE == APPLY8) {
#pragma unroll
    for (int step = 0; step < APPLY_STEPS; ++step) {
      // t: the lane's columns between its neighbours'; the edge lanes
      // take their own other end (wrong, and the overlap absorbs it).
      float t[U + 2];
      t[0] = __shfl_up_sync(ALL, v[U - 1], 1);
      t[U + 1] = __shfl_down_sync(ALL, v[0], 1);
#pragma unroll
      for (int m = 0; m < U; ++m) t[m + 1] = v[m];
#pragma unroll
      for (int m = 0; m < U; ++m)
        v[m] = __fadd_rn(__fmul_rn(0.99f, t[m + 1]),
                         __fmul_rn(0.01f, __fadd_rn(t[m], t[m + 2])));
    }
#pragma unroll
    for (int m = 0; m < U; ++m) acc[m] = __fadd_rn(acc[m], v[m]);
  } else {  // PROLONG
    float p = __shfl_up_sync(ALL, w.x[U - 1], 1);
    if (lane == 0) p = w.e[0];
    float t[U + 1];  // the previous lane's last column, then the lane's
    t[0] = __fmul_rn(p, s);
#pragma unroll
    for (int m = 0; m < U; ++m) t[m + 1] = v[m];
#pragma unroll
    for (int m = 0; m < U; ++m) {
      acc[2 * m] = __fadd_rn(acc[2 * m],
                             __fmul_rn(0.5f, __fadd_rn(t[m + 1], t[m])));
      acc[2 * m + 1] = __fadd_rn(acc[2 * m + 1], t[m + 1]);
    }
  }
}

// Columns [col, col + 4) of row xr as the mode reads them: past the row
// zero (restriction modes: nxp columns; prolong: nxcp, its last one, the
// pad, 0 too), apply8's cyclic on nxcp.  `vec`: xr 16-byte aligned.
template <int MODE>
__device__ __forceinline__ float4 load_unit(const float* __restrict__ xr,
                                            int col, int nxp, bool vec) {
  const int nxcp = nxp / 2;
  if constexpr (MODE == APPLY8) {
    if (col < 0) col += nxcp;
    while (col >= nxcp) col -= nxcp;
  } else {
    if (col < 0 || col >= (MODE == PROLONG ? nxcp : nxp))
      return make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float4 f = vec ? *reinterpret_cast<const float4*>(xr + col)
                 : make_float4(xr[col], xr[col + 1], xr[col + 2],
                               xr[col + 3]);
  if (MODE == PROLONG && col == nxcp - 4) f.w = 0.f;
  return f;
}

// Warp g of the grid: span g % spans of row g / spans, input columns
// [a, a + 128 K) with a = (g % spans) (128 K - 2 OVER) - OVER, in shared
// memory; G passes; its outputs written once.
template <int MODE>
__global__ void __launch_bounds__(32 * MAX_WARPS)
xfer_pass_kernel(const float* __restrict__ x, float* __restrict__ out,
                 int rows, int nxp, int G, int spans) {
  using T = Tiling<MODE>;
  constexpr int K = T::K, P = T::P, U = 4 * K, SPAN = 128 * K;
  constexpr int NO = lane_outputs<MODE>();
  constexpr int TW = warp_floats<MODE>();
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = blockIdx.x * (blockDim.x >> 5) + warp;
  if (g >= rows * spans) return;
  const int row = g / spans;
  const int a = (g - row * spans) * (SPAN - 2 * T::OVER) - T::OVER;
  const int nxcp = nxp / 2;
  const float* xr = x + (long long)row * (MODE == PROLONG ? nxcp : nxp);
  const bool vec = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  float4* tile = reinterpret_cast<float4*>(smem + warp * TW);
#pragma unroll
  for (int c = 0; c < K; ++c) {
    const int u = 32 * c + lane;
    tile[32 * (u % K) + u / K] = load_unit<MODE>(xr, a + 4 * u, nxp, vec);
  }
  if (T::EDGE && lane == 0)
    tile[32 * K] = load_unit<MODE>(xr, MODE == PROLONG ? a - 4 : a + SPAN,
                                   nxp, vec);
  __syncwarp();
  const unsigned t0 = (unsigned)__cvta_generic_to_shared(tile);
  const unsigned base = t0 + 16 * lane;
  const unsigned edge = t0 + 16 * 32 * K + (MODE == PROLONG ? 12 : 0);
  float acc[NO];
#pragma unroll
  for (int k = 0; k < NO; ++k) acc[k] = 0.f;
  // w[p] holds pass i + p's window: loaded P passes ahead, and loaded
  // again for pass i + p + P as soon as pass i + p has used it.  The
  // loop runs while every such load is for a pass below G, so that its
  // body is one block of straight code.
  Win<MODE> w[P];
#pragma unroll
  for (int p = 0; p < P; ++p)
    if (p < G) load_win(w[p], base, edge);
  int i = 0;
#pragma unroll 1
  for (; i + 2 * P <= G; i += P) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      pass<MODE>(w[p], pass_scale(i + p), lane, acc);
      load_win(w[p], base, edge);
    }
  }
  // The last passes, fewer than 2 P; the first P of them loaded already.
#pragma unroll
  for (int p = 0; p < P; ++p)
    if (i + p < G) {
      pass<MODE>(w[p], pass_scale(i + p), lane, acc);
      if (i + P + p < G) load_win(w[p], base, edge);
    }
#pragma unroll
  for (int p = 0; p < P; ++p)
    if (i + P + p < G) pass<MODE>(w[p], pass_scale(i + P + p), lane, acc);
  // The stores: each lane's outputs, in their order in the output row,
  // through the warp's tile (unit u = Q lane + q of a run at slot
  // 32 q + lane), then 16-byte units u = 32 j + lane to the row, so that
  // every store is coalesced.  A run is the warp's outputs that sit
  // together in the row: shuffle's even columns and its odd ones, one
  // run for the other modes.
  constexpr int RUNS = MODE == SHUFFLE ? 2 : 1;
  constexpr int Q = NO / 4 / RUNS;  // 16-byte units of a run a lane
  static_assert(Q >= 1 && NO % (4 * RUNS) == 0, "whole units a run");
  if (MODE == FULL && a + U * (lane + 1) == nxp)
    acc[NO - 1] = 0.f;  // the last output column
  __syncwarp();  // every lane's last window read
#pragma unroll
  for (int r = 0; r < RUNS; ++r)
#pragma unroll
    for (int q = 0; q < Q; ++q)
      tile[32 * Q * r + 32 * q + lane] =
          make_float4(acc[4 * (Q * r + q)], acc[4 * (Q * r + q) + 1],
                      acc[4 * (Q * r + q) + 2], acc[4 * (Q * r + q) + 3]);
  __syncwarp();
  const int out_cols = MODE == PROLONG ? nxp : nxcp;
  float* orow = out + (long long)row * out_cols;
#pragma unroll
  for (int r = 0; r < RUNS; ++r) {
    // the run's first output column and its end in the row
    const int o0 = MODE == SHUFFLE ? r * nxcp / 2 + a / 2
                   : MODE == FULL  ? a / 2
                   : MODE == PROLONG ? 2 * a : a;
    const int end = MODE == SHUFFLE ? (r + 1) * nxcp / 2 : out_cols;
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      const int u = 32 * j + lane;
      const int o = o0 + 4 * u;
      bool keep = o + 4 <= end;
      if (MODE == APPLY8)  // the middle of the span
        keep &= 4 * u >= T::OVER && 4 * u < SPAN - T::OVER;
      if (keep)
        *reinterpret_cast<float4*>(orow + o) =
            tile[32 * Q * r + 32 * (u % Q) + u / Q];
    }
  }
}

template <int MODE>
int launch_xfer(const float* x, float* out, int rows, int nxp, int G,
                cudaStream_t stream) {
  using T = Tiling<MODE>;
  constexpr int SPAN = 128 * T::K, STEP = SPAN - 2 * T::OVER;
  constexpr int TW = warp_floats<MODE>();
  const int tiled = MODE == FULL ? nxp : nxp / 2;  // input columns tiled
  const int spans = (tiled + STEP - 1) / STEP;
  const long long warps = (long long)rows * spans;
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  constexpr int WB_MAX = SMEM_A_BLOCK / (4 * TW) < MAX_WARPS
                             ? SMEM_A_BLOCK / (4 * TW) : MAX_WARPS;
  long long wb = (warps + sms - 1) / sms;  // about one block an SM
  wb = wb < 1 ? 1 : wb > WB_MAX ? WB_MAX : wb;
  if (warps > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((warps + wb - 1) / wb);
  xfer_pass_kernel<MODE><<<blocks, 32 * (int)wb, 4 * TW * wb, stream>>>(
      x, out, rows, nxp, G, spans);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// (tails, heads) of x (n rows of nx f32, row pitch ld) in one launch:
// tails (g, top, nx), heads (g, bot, nx), contiguous; 1 <= top, bot <=
// stride.
int mg_halo_windows(const float* x, long long ld, int n, int nx, int stride,
                    int g, int top, int bot, float* tails, float* heads,
                    void* stream) {
  if (n < 1 || nx < 1 || ld < nx || g < 1 || top < 1 || bot < 1 ||
      top > stride || bot > stride)
    return (int)cudaErrorInvalidValue;
  const int nrows = g * (top + bot);
  const dim3 grid((nx + WTILE - 1) / WTILE,
                  nrows < MAX_GRID_Y ? nrows : MAX_GRID_Y);
  halo_windows_kernel<<<grid, WTHREADS, 0, (cudaStream_t)stream>>>(
      x, ld, n, nx, stride, g, top, bot, tails, heads);
  return (int)cudaGetLastError();
}

// G passes of x-transfer `mode` (XferMode) on a contiguous f32 slab, sums
// into out: restriction modes x (rows, nxp) -> out (rows, nxp / 2);
// prolong x (rows, nxp / 2) -> out (rows, nxp).  nxp a multiple of
// XFER_UNIT, out 16-byte aligned, 1 <= G <= MAX_PASSES; the kernel forms
// the passes' scales itself.
int mg_xfer_pass(const float* x, float* out, int rows, int nxp, int G,
                 int mode, void* stream) {
  if (rows < 1 || nxp < XFER_UNIT || nxp % XFER_UNIT || G < 1 ||
      G > MAX_PASSES || (reinterpret_cast<uintptr_t>(out) & 15))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case NOOP: return launch_xfer<NOOP>(x, out, rows, nxp, G, s);
    case ARITH: return launch_xfer<ARITH>(x, out, rows, nxp, G, s);
    case SHUFFLE: return launch_xfer<SHUFFLE>(x, out, rows, nxp, G, s);
    case FULL: return launch_xfer<FULL>(x, out, rows, nxp, G, s);
    case APPLY8: return launch_xfer<APPLY8>(x, out, rows, nxp, G, s);
    case PROLONG: return launch_xfer<PROLONG>(x, out, rows, nxp, G, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
