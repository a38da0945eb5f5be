// Level-visit and stencil kernels of the multigrid solvers, for Hopper
// (sm_90a), bound to Python through a plain C interface (ctypes).
//
// One templated visit kernel serves every fused level visit, for the
// 5-point (Coeffs) and the 9-point (Coeffs9) stencil; its flags pick what
// is read and written:
//   CG       b = r - alpha * ap formed in-kernel; r' and ||r'||^2 emitted
//            (5-point only)
//   GUESS    start from the given u (else the zero guess: z = D^-1 b first)
//   CORRECT  u += P e_c (bilinear prolongation) before the sweeps
//   EMIT     u | u + r | r | u + rc (rc: full-weighting restriction of r)
//   DOT      <b, u> partials
//
// Replaces (multigrid_petsc_tpu/ops/pallas/):
//   K1  cg_papply_u_kernel   <- mdma_kernel.py cg_papply_u_mdma
//   K2a visit <CG, rc>       <- mdma_kernel.py cg_visit_down_mdma
//   K2b visit <rc>           <- mdma_kernel.py visit_down_mdma
//   K3  visit <GUESS, CORRECT, u[, DOT]> <- mdma_kernel.py visit_up_mdma
//   K6  stencil_kernel<false, Coeffs> <- stencil_kernel.py
//       apply_stencil5_pallas
//   K7  visit <GUESS, u>     <- stencil_kernel.py smooth_sweeps_pallas
//   K8  stencil_kernel<RESID, Fields5> <- stencil_kernel.py
//       apply_stencil5_field_pallas (five (ny, nx) coefficient fields: 7
//       arrays moved for A u, 8 for b - A u; the fields are read in place,
//       not staged)
//   K9  visit (every flag set above) <- stencil_kernel.py
//       fused_level_visit_pallas; its k = 0 residual (residual5_pallas)
//       is stencil_kernel<true, Coeffs>
//   K12 stencil_kernel<RESID, Coeffs9> <- stencil9_kernel.py
//       apply_stencil9_pallas, residual9_pallas
//   K13 visit <GUESS, u, Coeffs9> <- stencil9_kernel.py
//       smooth9_sweeps_pallas
//   K14 visit <..., Coeffs9> (every flag set but CG) <- stencil9_kernel.py
//       fused_level_visit9_pallas
//
// What bounds them on the H100: bytes.  Every kernel does O(k) flops per
// point against 8-24 bytes of device-memory traffic per point, far below
// the card's flop:byte balance, so the design goal is to touch each big
// array once per visit:
//   * each block owns a TY x TX output tile and stages a tile + halo of H
//     rows/cols in shared memory; all k smoother steps, the residual and
//     the restriction (or the prolongation + correction) run there, so
//     the k sweeps cost one read of b (and u) and one write of the result
//     instead of ~3 passes per sweep;
//   * the halo is H = k for emit u, k + 1 for u + r and r, k + 2 for rc:
//     pollution from the unknown tile edge travels one point (one ring,
//     diagonals included for the 9-point stencil) per stencil
//     application, the residual needs one more point and the
//     full-weighting restriction one more fine row/column past the tile
//     (coarse I needs fine 2I..2I+2);
//   * the 9-point coefficients are staged in their own shape: a scalar as
//     one value, an (ny, 1) column or a (1, nx) row as one strip of the
//     tile, only an (ny, nx) field as a whole tile (the anisotropic
//     problem has one: cc, plus its inverse);
//   * halo rows and columns are re-read by neighbouring blocks; they come
//     from L2 for the most part.  cp.async/TMA pipelining is later work.
//
// Streams read with a halo (z, p, r, ap, b, u) are never written in place:
// blocks run concurrently, so a neighbour could read an updated halo.  The
// only in-place stream is K1's pointwise u -> u' (un may alias u).
//
// Dirichlet masking: points outside [0, ny) x [0, nx) hold zero in b and u
// and are re-zeroed after every step, as in the TPU kernels.
//
// Scalars (alpha, alpha_prev, beta) and the smoother's (alpha_s, beta_s)
// schedule are read from device memory by pointer, so neither the CG loop
// nor a visit needs a host round trip for them, and no sweep count is
// bound by the kernel-parameter block.  The only bound on a visit's sweep
// count is its shared memory (visit_smem_bytes <= MAX_SMEM): with emit rc
// at most 43 steps for the 5-point visit and 28 for the 9-point visit of
// the anisotropic stencil (45 and 30 with emit u); the wrappers raise
// ValueError above it.  Dot products are emitted as per-block f32
// partials; the caller sums them.

#include <cuda_runtime.h>

#include <type_traits>

#include "mg_common.cuh"

namespace {

using mg::Coeffs9;
using mg::coeffs9;
using mg::prolong_at;

constexpr int TY = 32;        // output tile rows (even: restriction pairs)
constexpr int TX = 64;        // output tile columns (even)
constexpr int NTHREADS = 256;
constexpr size_t MAX_SMEM = 232448;  // bytes of shared memory per block

enum Emit { EMIT_U = 0, EMIT_UR = 1, EMIT_R = 2, EMIT_RC = 3 };

// Flag bits of mg_visit's `flags` argument (mirrored in mdma_kernel.py).
constexpr int F_CG = 1, F_GUESS = 2, F_CORRECT = 4, F_DOT = 8, EMIT_SHIFT = 4;

// The 5-point stencil: five (ny, 1) columns.
struct Coeffs {
  const float* cs;
  const float* cw;
  const float* cc;
  const float* ce;
  const float* cn;
};

// A visit's streams; pointers its flags do not use are null.
struct VisitIO {
  const float* b;      // right-hand side (CG: r)
  const float* ap;     // CG: A p
  const float* alpha;  // CG: device scalar
  const float* u;      // GUESS: initial iterate
  const float* e;      // CORRECT: coarse correction, (ny-1)/2 x (nx-1)/2
  float* u_out;        // every emit but r
  float* r_out;        // u + r, r: b - A u
  float* rc_out;       // rc: R (b - A u), (ny-1)/2 x (nx-1)/2
  float* rnew_out;     // CG: r' = r - alpha ap
  float* part;         // CG: ||r'||^2 partials; DOT: <b, u> partials
};

// ---- 5-point coefficients staged for a tile: cs, cw, cc, ce, cn, dinv.
struct RowCoeffs {
  float* cs;
  float* cw;
  float* cc;
  float* ce;
  float* cn;
  float* dinv;
};

__host__ __device__ constexpr size_t coeff_floats(const Coeffs&, int SH,
                                                  int) {
  return 6 * (size_t)SH;
}

__device__ __forceinline__ RowCoeffs stage(const Coeffs& c, float* base,
                                           int SH, int, int gy0, int, int ny,
                                           int) {
  RowCoeffs rc{base, base + SH, base + 2 * SH, base + 3 * SH,
               base + 4 * SH, base + 5 * SH};
  for (int i = threadIdx.x; i < SH; i += NTHREADS) {
    int gy = gy0 + i;
    bool in = gy >= 0 && gy < ny;
    rc.cs[i] = in ? c.cs[gy] : 0.f;
    rc.cw[i] = in ? c.cw[gy] : 0.f;
    rc.cc[i] = in ? c.cc[gy] : 0.f;
    rc.ce[i] = in ? c.ce[gy] : 0.f;
    rc.cn[i] = in ? c.cn[gy] : 0.f;
    rc.dinv[i] = in ? 1.f / c.cc[gy] : 0.f;
  }
  return rc;
}

// (A v) at shared point (sy, sx) of an SH x SW tile; neighbours outside
// the tile count as zero (their pollution stays inside the halo).  Term
// order follows the JAX package: cc, south, north, west, east.
__device__ __forceinline__ float apply_at(const float* v, const RowCoeffs& rc,
                                          int sy, int sx, int SH, int SW) {
  int i = sy * SW + sx;
  float s = sy > 0 ? v[i - SW] : 0.f;
  float n = sy < SH - 1 ? v[i + SW] : 0.f;
  float w = sx > 0 ? v[i - 1] : 0.f;
  float e = sx < SW - 1 ? v[i + 1] : 0.f;
  return rc.cc[sy] * v[i] + rc.cs[sy] * s + rc.cn[sy] * n + rc.cw[sy] * w +
         rc.ce[sy] * e;
}

__device__ __forceinline__ float dinv_at(const RowCoeffs& rc, int sy, int) {
  return rc.dinv[sy];
}

// ---- 9-point coefficients staged for a tile: entry q (csw..cne, then
// dinv laid out as cc) at c[q][sy * ys[q] + sx * xs[q]], its shared strides
// (SW, 1) for a field, (1, 0) for a column, (0, 1) for a row, (0, 0) for a
// scalar.
struct Tile9 {
  const float* c[10];
  int ys[10];
  int xs[10];
};

__host__ __device__ inline size_t staged_size(int sy, int sx, int SH,
                                              int SW) {
  return (size_t)(sy ? SH : 1) * (sx ? SW : 1);
}

__host__ __device__ inline size_t coeff_floats(const Coeffs9& c, int SH,
                                               int SW) {
  size_t n = staged_size(c.sy[mg::CC], c.sx[mg::CC], SH, SW);  // dinv
  for (int q = 0; q < 9; ++q) n += staged_size(c.sy[q], c.sx[q], SH, SW);
  return n;
}

// Coefficients outside the domain are staged as 0 (their points are
// masked); dinv guards a zero cc as the JAX kernel does.
__device__ Tile9 stage(const Coeffs9& c, float* base, int SH, int SW,
                       int gy0, int gx0, int ny, int nx) {
  Tile9 t;
#pragma unroll
  for (int q = 0; q < 10; ++q) {
    const int src = q < 9 ? q : mg::CC;
    const int gys = c.sy[src], gxs = c.sx[src];
    const int rows = gys ? SH : 1, cols = gxs ? SW : 1;
    t.c[q] = base;
    t.ys[q] = gys ? cols : 0;
    t.xs[q] = gxs ? 1 : 0;
    for (int i = threadIdx.x; i < rows * cols; i += NTHREADS) {
      const int r = i / cols, s = i - (i / cols) * cols;
      const int gy = gy0 + r, gx = gx0 + s;
      const bool in = (!gys || (gy >= 0 && gy < ny)) &&
                      (!gxs || (gx >= 0 && gx < nx));
      float v = 0.f;
      if (in) {
        v = c.p[src][(gys ? (size_t)gy * gys : 0) +
                     (gxs ? (size_t)gx * gxs : 0)];
        if (q == 9) v = v == 0.f ? 1.f : 1.f / v;
      }
      base[i] = v;
    }
    base += rows * cols;
  }
  return t;
}

__device__ __forceinline__ float tat(const Tile9& t, int q, int sy, int sx) {
  return t.c[q][sy * t.ys[q] + sx * t.xs[q]];
}

// 9-point (A v) at shared point (sy, sx); term order of the JAX package:
// cc, s, n, w, e, sw, se, nw, ne.
__device__ __forceinline__ float apply_at(const float* v, const Tile9& t,
                                          int sy, int sx, int SH, int SW) {
  const int i = sy * SW + sx;
  const bool hs = sy > 0, hn = sy < SH - 1, hw = sx > 0, he = sx < SW - 1;
  const float s = hs ? v[i - SW] : 0.f;
  const float n = hn ? v[i + SW] : 0.f;
  const float w = hw ? v[i - 1] : 0.f;
  const float e = he ? v[i + 1] : 0.f;
  const float sw = hs && hw ? v[i - SW - 1] : 0.f;
  const float se = hs && he ? v[i - SW + 1] : 0.f;
  const float nw = hn && hw ? v[i + SW - 1] : 0.f;
  const float ne = hn && he ? v[i + SW + 1] : 0.f;
  return tat(t, mg::CC, sy, sx) * v[i] + tat(t, mg::CS, sy, sx) * s +
         tat(t, mg::CN, sy, sx) * n + tat(t, mg::CW, sy, sx) * w +
         tat(t, mg::CE, sy, sx) * e + tat(t, mg::CSW, sy, sx) * sw +
         tat(t, mg::CSE, sy, sx) * se + tat(t, mg::CNW, sy, sx) * nw +
         tat(t, mg::CNE, sy, sx) * ne;
}

__device__ __forceinline__ float dinv_at(const Tile9& t, int sy, int sx) {
  return tat(t, 9, sy, sx);
}

// ---- K8: five full (ny, nx) coefficient fields (the stencil form of an
// assembled level matrix, ops/sparse.py).  Each coefficient is used by its
// own point only, so nothing is staged: a thread reads the five values of
// its point straight from device memory (neighbouring threads, neighbouring
// addresses), once per point.
struct Fields5 {
  const float* cs;
  const float* cw;
  const float* cc;
  const float* ce;
  const float* cn;
};

struct FieldTile {
  Fields5 f;
  int gy0, gx0, nx;
};

__host__ __device__ constexpr size_t coeff_floats(const Fields5&, int, int) {
  return 0;
}

__device__ __forceinline__ FieldTile stage(const Fields5& c, float*, int,
                                           int, int gy0, int gx0, int,
                                           int nx) {
  return FieldTile{c, gy0, gx0, nx};
}

// Term order of the JAX field kernel: cc, south, north, west, east.  Only
// called at domain points (the stencil kernel's output tile).
__device__ __forceinline__ float apply_at(const float* v, const FieldTile& t,
                                          int sy, int sx, int SH, int SW) {
  const int i = sy * SW + sx;
  const size_t g = (size_t)(t.gy0 + sy) * t.nx + (t.gx0 + sx);
  const float s = sy > 0 ? v[i - SW] : 0.f;
  const float n = sy < SH - 1 ? v[i + SW] : 0.f;
  const float w = sx > 0 ? v[i - 1] : 0.f;
  const float e = sx < SW - 1 ? v[i + 1] : 0.f;
  return t.f.cc[g] * v[i] + t.f.cs[g] * s + t.f.cn[g] * n + t.f.cw[g] * w +
         t.f.ce[g] * e;
}

// k polynomial smoother steps on the shared tile, Dirichlet-masked; step s
// takes (alpha, beta) = (steps[2s], steps[2s + 1]).  zero_guess: u = p = 0
// on entry and the first step is z = dinv * b.
template <class R>
__device__ void smooth_tile(const float* b, float* u, float* p, const R& rc,
                            const float* __restrict__ steps, int k,
                            bool zero_guess, int SH, int SW, int gy0, int gx0,
                            int ny, int nx) {
  const int n = SH * SW;
  for (int s = 0; s < k; ++s) {
    const float a = steps[2 * s];
    const float bt = steps[2 * s + 1];
    const bool first = zero_guess && s == 0;
    for (int i = threadIdx.x; i < n; i += NTHREADS) {
      int sy = i / SW, sx = i - (i / SW) * SW;
      int gy = gy0 + sy, gx = gx0 + sx;
      if (gy < 0 || gy >= ny || gx < 0 || gx >= nx) {
        p[i] = 0.f;
        continue;
      }
      const float d = dinv_at(rc, sy, sx);
      float z = first ? d * b[i] : d * (b[i] - apply_at(u, rc, sy, sx, SH, SW));
      p[i] = (s == 0 ? 0.f : bt * p[i]) + a * z;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += NTHREADS) u[i] += p[i];  // p = 0 outside
    __syncthreads();
  }
}

template <class C>
size_t visit_smem_bytes(const C& c, int H) {
  const int SH = TY + 2 * H, SW = TX + 2 * H;
  return sizeof(float) * (3 * (size_t)SH * SW + coeff_floats(c, SH, SW) +
                          NTHREADS / 32);
}

constexpr int halo(int emit, int k) {
  return k + (emit == EMIT_U ? 0 : emit == EMIT_RC ? 2 : 1);
}

// The level visit: [b = r - alpha ap] [u + P e] -> k steps -> the emits.
// rc holds the coarse points whose 3x3 footprint the tile owns.
template <bool CG, bool GUESS, bool CORRECT, int EMIT, bool DOT, class C>
__global__ void __launch_bounds__(NTHREADS)
visit_kernel(C c, VisitIO io, int ny, int nx, int H,
             const float* __restrict__ steps, int k) {
  extern __shared__ float sm[];
  const int SH = TY + 2 * H, SW = TX + 2 * H, n = SH * SW;
  float* b = sm;
  float* u = b + n;
  float* p = u + n;
  float* red = p + n + coeff_floats(c, SH, SW);
  const int y0 = blockIdx.y * TY, x0 = blockIdx.x * TX;
  const int gy0 = y0 - H, gx0 = x0 - H;
  const int nyc = (ny - 1) / 2, nxc = (nx - 1) / 2;
  const auto rc = stage(c, p + n, SH, SW, gy0, gx0, ny, nx);
  const float alpha = CG ? *io.alpha : 0.f;
  for (int i = threadIdx.x; i < n; i += NTHREADS) {
    int sy = i / SW, sx = i - (i / SW) * SW;
    int gy = gy0 + sy, gx = gx0 + sx;
    float bv = 0.f, uv = 0.f;
    if (gy >= 0 && gy < ny && gx >= 0 && gx < nx) {
      size_t g = (size_t)gy * nx + gx;
      bv = CG ? io.b[g] - alpha * io.ap[g] : io.b[g];
      if (GUESS) uv = io.u[g];
      if (CORRECT) uv += prolong_at(io.e, gy, gx, nyc, nxc);
    }
    b[i] = bv;
    u[i] = uv;
    p[i] = 0.f;
  }
  __syncthreads();
  smooth_tile(b, u, p, rc, steps, k, !GUESS, SH, SW, gy0, gx0, ny, nx);

  float acc = 0.f;
  for (int t = threadIdx.x; t < TY * TX; t += NTHREADS) {
    int ty = t / TX, tx = t - (t / TX) * TX;
    int gy = y0 + ty, gx = x0 + tx;
    if (gy >= ny || gx >= nx) continue;
    int i = (ty + H) * SW + tx + H;
    size_t g = (size_t)gy * nx + gx;
    if (EMIT != EMIT_R) io.u_out[g] = u[i];
    if (EMIT == EMIT_UR || EMIT == EMIT_R)
      io.r_out[g] = b[i] - apply_at(u, rc, ty + H, tx + H, SH, SW);
    if (CG) {
      io.rnew_out[g] = b[i];
      acc += b[i] * b[i];
    }
    if (DOT) acc += b[i] * u[i];
  }
  if (EMIT == EMIT_RC) {
    // Residual into p (dead after the smoother) on the tile and one more
    // row/column, the restriction's footprint.
    for (int t = threadIdx.x; t < (TY + 1) * (TX + 1); t += NTHREADS) {
      int sy = H + t / (TX + 1), sx = H + t - (t / (TX + 1)) * (TX + 1);
      int gy = gy0 + sy, gx = gx0 + sx;
      bool in = gy < ny && gx < nx;
      int i = sy * SW + sx;
      p[i] = in ? b[i] - apply_at(u, rc, sy, sx, SH, SW) : 0.f;
    }
    __syncthreads();
    // Full weighting: y pass first, then x (ops/transfer.restrict_fw).
    for (int t = threadIdx.x; t < (TY / 2) * (TX / 2); t += NTHREADS) {
      int cy = t / (TX / 2), cx = t - (t / (TX / 2)) * (TX / 2);
      int I = y0 / 2 + cy, J = x0 / 2 + cx;
      if (I >= nyc || J >= nxc) continue;
      const float* r0 = p + (2 * cy + H) * SW + 2 * cx + H;  // fine (2I, 2J)
      float ycol[3];
      for (int d = 0; d < 3; ++d)
        ycol[d] = r0[d] + 2.f * r0[SW + d] + r0[2 * SW + d];
      io.rc_out[(size_t)I * nxc + J] =
          0.0625f * (ycol[0] + 2.f * ycol[1] + ycol[2]);
    }
  }
  if (CG || DOT) {
    float s = mg::block_sum<NTHREADS>(acc, red);
    if (threadIdx.x == 0) io.part[blockIdx.y * gridDim.x + blockIdx.x] = s;
  }
}

template <class C>
using VisitFn = void (*)(C, VisitIO, int, int, int, const float*, int);

template <bool GUESS, bool CORRECT, class C>
VisitFn<C> pick_emit(int emit, bool dot) {
  switch (emit) {
    case EMIT_U:
      return dot ? visit_kernel<false, GUESS, CORRECT, EMIT_U, true, C>
                 : visit_kernel<false, GUESS, CORRECT, EMIT_U, false, C>;
    case EMIT_UR:
      return dot ? nullptr
                 : visit_kernel<false, GUESS, CORRECT, EMIT_UR, false, C>;
    case EMIT_R:
      return dot ? nullptr
                 : visit_kernel<false, GUESS, CORRECT, EMIT_R, false, C>;
    case EMIT_RC:
      return dot ? nullptr
                 : visit_kernel<false, GUESS, CORRECT, EMIT_RC, false, C>;
  }
  return nullptr;
}

// The instantiation for a flag set, or null for a set the family lacks
// (CG is the 5-point zero-guess rc visit only; DOT goes with emit u only;
// a correction needs a guess).
template <class C>
VisitFn<C> pick_visit(int flags) {
  const bool cg = flags & F_CG, guess = flags & F_GUESS;
  const bool correct = flags & F_CORRECT, dot = flags & F_DOT;
  const int emit = flags >> EMIT_SHIFT;
  if (cg) {
    if constexpr (std::is_same<C, Coeffs>::value)
      return (guess || correct || dot || emit != EMIT_RC)
                 ? nullptr : visit_kernel<true, false, false, EMIT_RC, false, C>;
    return nullptr;
  }
  if (!guess) return correct ? nullptr : pick_emit<false, false, C>(emit, dot);
  return correct ? pick_emit<true, true, C>(emit, dot)
                 : pick_emit<true, false, C>(emit, dot);
}

// K1: p' = z + beta p (tile + 1-point halo in shared memory), A p',
// u' = u + alpha_prev p (pointwise; un may alias u), <p', A p'> partials.
__global__ void __launch_bounds__(NTHREADS)
cg_papply_u_kernel(Coeffs c, const float* __restrict__ z,
                   const float* __restrict__ p, const float* u,
                   const float* __restrict__ alpha_prev_ptr,
                   const float* __restrict__ beta_ptr,
                   float* __restrict__ pn_out, float* __restrict__ ap_out,
                   float* un_out, float* __restrict__ part, int ny, int nx) {
  constexpr int SH = TY + 2, SW = TX + 2;
  __shared__ float pn[SH * SW];
  __shared__ float crow[6 * SH];
  __shared__ float red[NTHREADS / 32];
  const int y0 = blockIdx.y * TY, x0 = blockIdx.x * TX;
  const int gy0 = y0 - 1, gx0 = x0 - 1;
  RowCoeffs rc = stage(c, crow, SH, SW, gy0, gx0, ny, nx);
  const float beta = *beta_ptr, alpha_prev = *alpha_prev_ptr;
  for (int i = threadIdx.x; i < SH * SW; i += NTHREADS) {
    int sy = i / SW, sx = i - (i / SW) * SW;
    int gy = gy0 + sy, gx = gx0 + sx;
    float v = 0.f;
    if (gy >= 0 && gy < ny && gx >= 0 && gx < nx) {
      size_t g = (size_t)gy * nx + gx;
      v = z[g] + beta * p[g];
    }
    pn[i] = v;
  }
  __syncthreads();
  float acc = 0.f;
  for (int t = threadIdx.x; t < TY * TX; t += NTHREADS) {
    int ty = t / TX, tx = t - (t / TX) * TX;
    int gy = y0 + ty, gx = x0 + tx;
    if (gy >= ny || gx >= nx) continue;
    int sy = ty + 1, sx = tx + 1;
    float a = apply_at(pn, rc, sy, sx, SH, SW);
    float v = pn[sy * SW + sx];
    size_t g = (size_t)gy * nx + gx;
    pn_out[g] = v;
    ap_out[g] = a;
    un_out[g] = u[g] + alpha_prev * p[g];
    acc += v * a;
  }
  float s = mg::block_sum<NTHREADS>(acc, red);
  if (threadIdx.x == 0) part[blockIdx.y * gridDim.x + blockIdx.x] = s;
}

// K6 / K12 (RESID = false): y = A u; residual5 / residual9 (RESID = true):
// y = b - A u.  The tile + 1-point halo of u in shared memory, as K1, with
// the coefficients staged after it.
template <bool RESID, class C>
__global__ void __launch_bounds__(NTHREADS)
stencil_kernel(C c, const float* __restrict__ b, const float* __restrict__ u,
               float* __restrict__ y, int ny, int nx) {
  constexpr int SH = TY + 2, SW = TX + 2;
  extern __shared__ float sm[];
  float* us = sm;
  const int y0 = blockIdx.y * TY, x0 = blockIdx.x * TX;
  const int gy0 = y0 - 1, gx0 = x0 - 1;
  const auto rc = stage(c, us + SH * SW, SH, SW, gy0, gx0, ny, nx);
  for (int i = threadIdx.x; i < SH * SW; i += NTHREADS) {
    int sy = i / SW, sx = i - (i / SW) * SW;
    int gy = gy0 + sy, gx = gx0 + sx;
    us[i] = (gy >= 0 && gy < ny && gx >= 0 && gx < nx)
                ? u[(size_t)gy * nx + gx] : 0.f;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < TY * TX; t += NTHREADS) {
    int ty = t / TX, tx = t - (t / TX) * TX;
    int gy = y0 + ty, gx = x0 + tx;
    if (gy >= ny || gx >= nx) continue;
    float a = apply_at(us, rc, ty + 1, tx + 1, SH, SW);
    size_t g = (size_t)gy * nx + gx;
    y[g] = RESID ? b[g] - a : a;
  }
}

dim3 visit_grid(int ny, int nx) {
  return dim3((nx + TX - 1) / TX, (ny + TY - 1) / TY);
}

template <class C>
int launch_visit(const C& c, const VisitIO& io, int ny, int nx,
                 const float* steps, int k, int flags, void* stream) {
  VisitFn<C> kern = pick_visit<C>(flags);
  if (kern == nullptr || k < 1) return (int)cudaErrorInvalidValue;
  const int H = halo(flags >> EMIT_SHIFT, k);
  const size_t smem = visit_smem_bytes(c, H);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  int err = (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  kern<<<visit_grid(ny, nx), NTHREADS, smem, (cudaStream_t)stream>>>(
      c, io, ny, nx, H, steps, k);
  return (int)cudaGetLastError();
}

template <class C>
int launch_stencil(const C& c, const float* b, const float* u, float* y,
                   int ny, int nx, int resid, void* stream) {
  auto kern = resid ? stencil_kernel<true, C> : stencil_kernel<false, C>;
  const size_t smem =
      sizeof(float) * ((TY + 2) * (TX + 2) + coeff_floats(c, TY + 2, TX + 2));
  int err = (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  kern<<<visit_grid(ny, nx), NTHREADS, smem, (cudaStream_t)stream>>>(
      c, b, u, y, ny, nx);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Number of per-block partials a visit kernel emits for an (ny, nx) grid.
int mg_visit_blocks(int ny, int nx) {
  dim3 g = visit_grid(ny, nx);
  return (int)(g.x * g.y);
}

int mg_cg_papply_u(const float* cs, const float* cw, const float* cc,
                   const float* ce, const float* cn, const float* z,
                   const float* p, const float* u, const float* alpha_prev,
                   const float* beta, float* pn, float* ap, float* un,
                   float* part, int ny, int nx, void* stream) {
  Coeffs c{cs, cw, cc, ce, cn};
  cg_papply_u_kernel<<<visit_grid(ny, nx), NTHREADS, 0,
                       (cudaStream_t)stream>>>(c, z, p, u, alpha_prev, beta,
                                               pn, ap, un, part, ny, nx);
  return (int)cudaGetLastError();
}

// One 5-point level visit (K2a, K2b, K3, K7, K9).  flags: F_CG | F_GUESS |
// F_CORRECT | F_DOT | emit << EMIT_SHIFT; the pointers the flags do not
// use may be null; steps: k (alpha, beta) pairs of f32 in device memory.
// A flag set outside the family, or a visit whose shared memory exceeds a
// block's, is refused.
int mg_visit(const float* cs, const float* cw, const float* cc,
             const float* ce, const float* cn, const float* b,
             const float* ap, const float* alpha, const float* u,
             const float* e, float* u_out, float* r_out, float* rc_out,
             float* rnew_out, float* part, int ny, int nx,
             const float* steps, int k, int flags, void* stream) {
  Coeffs c{cs, cw, cc, ce, cn};
  VisitIO io{b, ap, alpha, u, e, u_out, r_out, rc_out, rnew_out, part};
  return launch_visit(c, io, ny, nx, steps, k, flags, stream);
}

// One 9-point level visit (K13, K14): as mg_visit without F_CG; the
// coefficients as in mg_common.cuh's coeffs9().
int mg_visit9(const unsigned long long* cptrs, const int* cstrides,
              const float* b, const float* u, const float* e, float* u_out,
              float* r_out, float* rc_out, float* part, int ny, int nx,
              const float* steps, int k, int flags, void* stream) {
  VisitIO io{b, nullptr, nullptr, u, e, u_out, r_out, rc_out, nullptr, part};
  return launch_visit(coeffs9(cptrs, cstrides), io, ny, nx, steps, k, flags,
                      stream);
}

// K6 (resid == 0): y = A u; residual5 (resid != 0): y = b - A u.
int mg_stencil(const float* cs, const float* cw, const float* cc,
               const float* ce, const float* cn, const float* b,
               const float* u, float* y, int ny, int nx, int resid,
               void* stream) {
  Coeffs c{cs, cw, cc, ce, cn};
  return launch_stencil(c, b, u, y, ny, nx, resid, stream);
}

// K8: y = A u (resid == 0) or y = b - A u with five (ny, nx) coefficient
// fields.
int mg_stencil_field(const float* cs, const float* cw, const float* cc,
                     const float* ce, const float* cn, const float* b,
                     const float* u, float* y, int ny, int nx, int resid,
                     void* stream) {
  Fields5 c{cs, cw, cc, ce, cn};
  return launch_stencil(c, b, u, y, ny, nx, resid, stream);
}

// K12: y = A u (resid == 0) or y = b - A u, 9-point.
int mg_stencil9(const unsigned long long* cptrs, const int* cstrides,
                const float* b, const float* u, float* y, int ny, int nx,
                int resid, void* stream) {
  return launch_stencil(coeffs9(cptrs, cstrides), b, u, y, ny, nx, resid,
                        stream);
}

}  // extern "C"
