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
// pass over shared memory at stride 2 inside the visit kernel
// (visit.cuh), so here each block loads its tile of the slab into shared
// memory once, runs the G passes from there, keeps the sums in
// registers and stores them once.  The (48, 8192) f32 slab is 1.5 MB,
// more than a block's 227 KB, so the grid tiles it: TR rows (4; 2 for
// apply8) x 32 lanes, a lane taking U consecutive input columns and
// reading a window of NW floats around them (Window<MODE>), with the
// column halo a mode needs (arith, full: 2 to the right; apply8: 8 on
// each side, cyclic; prolong: 1 to the left); 384 blocks at the probe's
// shapes (480 for prolong), about three an SM.
//
// Hoisting: a pass's window loads do not change from pass to pass, so a
// compiler may keep them in registers across the loop, and the passes
// would then read no shared memory.  Each pass starts with
// __syncthreads(), which orders shared memory: no load is moved across
// it, so every pass loads its window anew (the SASS has the window's
// LDS.128 after the loop's BAR.SYNC; scripts/xfer_sass.py counts them).
//
// Arithmetic: the JAX kernels' order, each product and sum rounded on its
// own (__fmul_rn, __fadd_rn are never contracted into an FMA), so the
// kernels equal their plain PyTorch versions bit for bit.
//
// What bounds K18b-R / K18b-P: the HBM bytes (the slab in, the sums out)
// are tiny; their yardstick is shared memory, the window bytes read over
// 132 SMs x 128 B a clock (full: 203 MB over 86 passes, ~6 us at
// 1.98 GHz), and, for apply8, its 8 steps of 4 operations a point.

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
// The widest tile of input columns a block row takes is 256 (full); nxp
// must be a multiple of XFER_UNIT so that every mode's tiles fit whole.
constexpr int XFER_UNIT = 512;
constexpr int MAX_PASSES = 8192;  // the scales live in shared memory

// A lane's share of a pass: U consecutive input columns, a window of NW
// floats from U * lane + OFF (relative to the block's first column), the
// tile's halo LH columns to the left and RH to the right, TR rows a block.
// The input columns tiled: nxcp (half the fine width) or, for full, nxp.
template <int MODE>
struct Window;
template <> struct Window<NOOP> {
  static constexpr int U = 4, NW = 4, OFF = 0, LH = 0, RH = 0, TR = 4;
};
template <> struct Window<ARITH> {
  static constexpr int U = 4, NW = 8, OFF = 0, LH = 0, RH = 4, TR = 4;
};
template <> struct Window<SHUFFLE> {
  static constexpr int U = 4, NW = 4, OFF = 0, LH = 0, RH = 0, TR = 4;
};
template <> struct Window<FULL> {
  static constexpr int U = 8, NW = 12, OFF = 0, LH = 0, RH = 4, TR = 4;
};
template <> struct Window<APPLY8> {
  static constexpr int U = 8, NW = 24, OFF = -8, LH = 8, RH = 8, TR = 2;
};
template <> struct Window<PROLONG> {
  static constexpr int U = 4, NW = 8, OFF = -4, LH = 4, RH = 0, TR = 4;
};

// The outputs a lane makes from its window v (already scaled); `j0` its
// first input column.
//   noop     o[k] = v[k]                                   (k < 4)
//   arith    o[k] = v[k] + 2 v[k + 1] + v[k + 2]            (k < 4)
//   shuffle  o[k] = v[2k], o[2 + k] = v[2k + 1]             (k < 2)
//   full     o[k] = 0.0625 (v[2k] + 2 v[2k + 1] + v[2k + 2]), 0 for the
//            last output column                              (k < 4)
//   apply8   8 steps r = 0.99 r + 0.01 (r[-1] + r[+1]) on the 24 values,
//            o[k] = r[8 + k]                                 (k < 8)
//   prolong  o[2k] = 0.5 (v[4 + k] + v[3 + k]), o[2k + 1] = v[4 + k]
//                                                            (k < 4)
template <int MODE>
__host__ __device__ constexpr int outputs() {
  return MODE == APPLY8 || MODE == PROLONG ? 8 : 4;
}

template <int MODE>
__device__ __forceinline__ void pass(const float (&v)[Window<MODE>::NW],
                                     float (&o)[outputs<MODE>()], int j0,
                                     int nxcp) {
  if constexpr (MODE == NOOP) {
#pragma unroll
    for (int k = 0; k < 4; ++k) o[k] = v[k];
  } else if constexpr (MODE == ARITH) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      o[k] = __fadd_rn(__fadd_rn(v[k], __fmul_rn(2.f, v[k + 1])), v[k + 2]);
  } else if constexpr (MODE == SHUFFLE) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      o[k] = v[2 * k];
      o[2 + k] = v[2 * k + 1];
    }
  } else if constexpr (MODE == FULL) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      o[k] = j0 / 2 + k < nxcp - 1
                 ? __fmul_rn(0.0625f,
                             __fadd_rn(__fadd_rn(v[2 * k],
                                                 __fmul_rn(2.f, v[2 * k + 1])),
                                       v[2 * k + 2]))
                 : 0.f;
  } else if constexpr (MODE == APPLY8) {
    float r[24];
#pragma unroll
    for (int m = 0; m < 24; ++m) r[m] = v[m];
#pragma unroll
    for (int s = 1; s <= APPLY_STEPS; ++s) {
      float t[24];
#pragma unroll
      for (int m = s; m < 24 - s; ++m)
        t[m] = __fadd_rn(__fmul_rn(0.99f, r[m]),
                         __fmul_rn(0.01f, __fadd_rn(r[m - 1], r[m + 1])));
#pragma unroll
      for (int m = s; m < 24 - s; ++m) r[m] = t[m];
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) o[k] = r[8 + k];
  } else {  // PROLONG
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      o[2 * k] = __fmul_rn(0.5f, __fadd_rn(v[4 + k], v[3 + k]));
      o[2 * k + 1] = v[4 + k];
    }
  }
}

// One block: rows [r0, r0 + TR) of the slab x (rows x in_cols, row pitch
// in_cols) and input columns [c0, c0 + 32 U), with their halo, in shared
// memory; G passes; out (rows x out_cols) written once.
template <int MODE>
__global__ void __launch_bounds__(32 * Window<MODE>::TR)
xfer_pass_kernel(const float* __restrict__ x, float* __restrict__ out,
                 const float* __restrict__ scales, int rows, int nxp, int G) {
  using W = Window<MODE>;
  constexpr int SW = W::LH + 32 * W::U + W::RH;  // a tile row, floats
  extern __shared__ __align__(16) float smem[];
  float* tile = smem;                 // TR x SW
  float* sc = smem + W::TR * SW;      // G scales
  const int nxcp = nxp / 2;
  const int in_cols = MODE == PROLONG ? nxcp : nxp;
  const int out_cols = MODE == PROLONG ? nxp : nxcp;
  const int r0 = blockIdx.y * W::TR;
  const int c0 = blockIdx.x * 32 * W::U;
  for (int k = threadIdx.x; k < W::TR * SW; k += blockDim.x) {
    const int r = r0 + k / SW;
    int c = c0 - W::LH + k % SW;
    bool in;
    if constexpr (MODE == APPLY8) {  // cyclic on the first nxcp columns
      c = (c + nxcp) % nxcp;
      in = true;
    } else if constexpr (MODE == PROLONG) {  // e's last column is pad
      in = c >= 0 && c < nxcp - 1;
    } else {
      in = c >= 0 && c < in_cols;
    }
    tile[k] = r < rows && in ? x[(long long)r * in_cols + c] : 0.f;
  }
  for (int i = threadIdx.x; i < G; i += blockDim.x) sc[i] = scales[i];
  const int lane = threadIdx.x & 31;
  const int row = threadIdx.x >> 5;
  const float* win = tile + row * SW + W::LH + lane * W::U + W::OFF;
  const int j0 = c0 + lane * W::U;
  constexpr int NO = outputs<MODE>();
  float acc[NO];
#pragma unroll
  for (int k = 0; k < NO; ++k) acc[k] = 0.f;
  for (int i = 0; i < G; ++i) {
    __syncthreads();  // every pass loads its window anew (no hoisting)
    const float s = sc[i];
    float v[W::NW];
#pragma unroll
    for (int q = 0; q < W::NW / 4; ++q) {
      const float4 f = reinterpret_cast<const float4*>(win)[q];
      v[4 * q] = __fmul_rn(f.x, s);
      v[4 * q + 1] = __fmul_rn(f.y, s);
      v[4 * q + 2] = __fmul_rn(f.z, s);
      v[4 * q + 3] = __fmul_rn(f.w, s);
    }
    float o[NO];
    pass<MODE>(v, o, j0, nxcp);
#pragma unroll
    for (int k = 0; k < NO; ++k) acc[k] = __fadd_rn(acc[k], o[k]);
  }
  const int r = r0 + row;
  if (r >= rows) return;
  float* orow = out + (long long)r * out_cols;
  if constexpr (MODE == SHUFFLE) {  // even columns, then odd ones
    reinterpret_cast<float2*>(orow + j0 / 2)[0] = make_float2(acc[0], acc[1]);
    reinterpret_cast<float2*>(orow + nxcp / 2 + j0 / 2)[0] =
        make_float2(acc[2], acc[3]);
  } else {
    const int o0 = MODE == FULL ? j0 / 2 : MODE == PROLONG ? 2 * j0 : j0;
#pragma unroll
    for (int q = 0; q < NO / 4; ++q)
      reinterpret_cast<float4*>(orow + o0)[q] =
          make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2],
                      acc[4 * q + 3]);
  }
}

template <int MODE>
int launch_xfer(const float* x, float* out, const float* scales, int rows,
                int nxp, int G, cudaStream_t stream) {
  using W = Window<MODE>;
  constexpr int SW = W::LH + 32 * W::U + W::RH;
  const int tiled = MODE == FULL ? nxp : nxp / 2;  // input columns tiled
  const dim3 grid(tiled / (32 * W::U), (rows + W::TR - 1) / W::TR);
  const size_t smem = 4 * ((size_t)W::TR * SW + G);
  xfer_pass_kernel<MODE><<<grid, 32 * W::TR, smem, stream>>>(x, out, scales,
                                                            rows, nxp, G);
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
// XFER_UNIT, out 16-byte aligned, scales G f32 (1 <= G <= MAX_PASSES).
int mg_xfer_pass(const float* x, float* out, const float* scales, int rows,
                 int nxp, int G, int mode, void* stream) {
  if (rows < 1 || nxp < XFER_UNIT || nxp % XFER_UNIT || G < 1 ||
      G > MAX_PASSES || (reinterpret_cast<uintptr_t>(out) & 15))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case NOOP: return launch_xfer<NOOP>(x, out, scales, rows, nxp, G, s);
    case ARITH: return launch_xfer<ARITH>(x, out, scales, rows, nxp, G, s);
    case SHUFFLE:
      return launch_xfer<SHUFFLE>(x, out, scales, rows, nxp, G, s);
    case FULL: return launch_xfer<FULL>(x, out, scales, rows, nxp, G, s);
    case APPLY8: return launch_xfer<APPLY8>(x, out, scales, rows, nxp, G, s);
    case PROLONG:
      return launch_xfer<PROLONG>(x, out, scales, rows, nxp, G, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
