// Level-visit and stencil kernels of the multigrid solvers, for Hopper
// (sm_90a), as templates over the storage type T; visit.cu (f32),
// visit_f64.cu and visit_bf16.cu instantiate them and bind each to a plain
// C interface (ctypes), one entry per storage type.
//
// One templated visit kernel serves every fused level visit, for the
// 5-point (Coeffs) and the 9-point (Coeffs9) stencil; its flags pick what
// is read and written:
//   CG       b = r - alpha * ap formed in-kernel; r' and ||r'||^2 emitted
//            (5-point, f32 only)
//   GUESS    start from the given u (else the zero guess: z = D^-1 b first)
//   CORRECT  u += P e_c (bilinear prolongation) before the sweeps
//   EMIT     u | u + r | r | u + rc (rc: full-weighting restriction of r)
//   DOT      <b, u> partials
//
// Replaces (multigrid_petsc_tpu/ops/pallas/):
//   K1  cg_papply_kernel<UPDATE_U> <- mdma_kernel.py cg_papply_u_mdma
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
//   K10 visit <CG, rc> (K2a's flag set, unpadded) <- stencil_kernel.py
//       cg_visit_down_pallas
//   K11 cg_papply_kernel<!UPDATE_U> (K1 without the lagged u stream) <-
//       stencil_kernel.py cg_papply_pallas
//   K12 stencil_kernel<RESID, Coeffs9> <- stencil9_kernel.py
//       apply_stencil9_pallas, residual9_pallas
//   K13 visit <GUESS, u, Coeffs9> <- stencil9_kernel.py
//       smooth9_sweeps_pallas
//   K14 visit <..., Coeffs9> (every flag set but CG) <- stencil9_kernel.py
//       fused_level_visit9_pallas
//   K17 visit and stencil_kernel on a row block (RowBlock below; every flag
//       set but CG, both stencils, f32 and f64) <- dist_kernel.py
//       dist_level_visit_local
//
// Every launch covers a RowBlock: a whole grid, or one rank's block of a
// row-partitioned level (K17).  A block reads its own rows of b, u and e in
// place and the rows past it from small halo buffers that the neighbours'
// exchange filled (zeros at the global edges), so no extended copy of the
// block is made per visit.  Masking, the coefficients and the restriction's
// pad-row rule go by the GLOBAL row: rows at or past the domain's last row
// (the row partition's one pad row) are written as 0, as is the global
// coarse pad row of rc.  A block of R rows needs halo rows of the visit's
// H (below) and, to correct, H / 2 + 1 coarse rows; the wrappers assert
// H <= R, so rows come from the immediate neighbours only.
//
// Storage types: f32 and f64 compute in their own type; bf16 is storage
// only -- every load converts to f32, the arithmetic (smoother steps,
// residual, transfers, dots) runs in f32 in shared memory and registers,
// and each output rounds once, where it is stored (mg_common.cuh to_c /
// put), as the JAX kernels' _load_f32 / _store.  Dot partials and the
// step schedule are in the compute type.  K1, K2a/K10 and K11 (the f32
// mg-CG routes) and K8 (f32 sparse levels) are built for f32 only.
//
// What bounds them on the H100: bytes.  Every kernel does O(k) flops per
// point against 8-24 bytes of device-memory traffic per point (twice that
// in f64, half in bf16), far below the card's flop:byte balance, so the
// design goal is to touch each big array once per visit:
//   * each block owns a TY x TX output tile and stages a tile + halo of H
//     rows/cols in shared memory (in the compute type); all k smoother
//     steps, the residual and the restriction (or the prolongation +
//     correction) run there, so the k sweeps cost one read of b (and u)
//     and one write of the result instead of ~3 passes per sweep;
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
// count is its shared memory (visit_smem_bytes <= MAX_SMEM, with the
// compute type's element size): with emit rc at most 43 steps for the
// 5-point visit and 28 for the 9-point visit of the anisotropic stencil in
// f32 and bf16 (45 and 30 with emit u), 23 and 12 in f64; the wrappers
// raise ValueError above it.  Dot products are emitted as per-block
// partials in the compute type; the caller sums them.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "mg_common.cuh"

namespace {

using mg::Coeffs9;
using mg::compute_t;
using mg::put;
using mg::to_c;

constexpr int TY = 32;        // output tile rows (even: restriction pairs)
constexpr int TX = 64;        // output tile columns (even)
constexpr int NTHREADS = 256;
constexpr size_t MAX_SMEM = 232448;  // bytes of shared memory per block

enum Emit { EMIT_U = 0, EMIT_UR = 1, EMIT_R = 2, EMIT_RC = 3 };

// Flag bits of mg_visit's `flags` argument (mirrored in mdma_kernel.py).
constexpr int F_CG = 1, F_GUESS = 2, F_CORRECT = 4, F_DOT = 8, EMIT_SHIFT = 4;

// The 5-point stencil: five (ny, 1) columns.
template <class T>
struct Coeffs {
  const T* cs;
  const T* cw;
  const T* cc;
  const T* ce;
  const T* cn;
};

// A visit's streams; pointers its flags do not use are null.
template <class T>
struct VisitIO {
  const T* b;                 // right-hand side (CG: r)
  const T* ap;                // CG: A p
  const compute_t<T>* alpha;  // CG: device scalar
  const T* u;                 // GUESS: initial iterate
  const T* e;                 // CORRECT: coarse correction, (ny-1)/2 x (nx-1)/2
  T* u_out;                   // every emit but r
  T* r_out;                   // u + r, r: b - A u
  T* rc_out;                  // rc: R (b - A u), (ny-1)/2 x (nx-1)/2
  T* rnew_out;                // CG: r' = r - alpha ap
  compute_t<T>* part;         // CG: ||r'||^2 partials; DOT: <b, u> partials
};

// The rows a launch covers: R local rows from global row row0 (even) of a
// domain of nyg real rows.  A whole grid is R = nyg, row0 = 0, Rc = (nyg -
// 1) / 2 and no halo buffers.  A row block (K17) reads its rows above and
// below from b_top / u_top and b_bot / u_bot (hn rows each, (hn, nx)), the
// coarse correction's from e_top / e_bot (hc rows each, (hc, nxc)); its
// coarse block (e, rc) has Rc = R / 2 rows.
template <class T>
struct RowBlock {
  int R, row0, nyg, hn, Rc, hc;
  const T* b_top;
  const T* b_bot;
  const T* u_top;
  const T* u_bot;
  const T* e_top;
  const T* e_bot;
};

template <class T>
inline RowBlock<T> whole_grid(int ny) {
  return RowBlock<T>{ny,      0,       ny,      0,       (ny - 1) / 2, 0,
                     nullptr, nullptr, nullptr, nullptr, nullptr,      nullptr};
}

// A row block from the C entries' host arrays: geom = R, row0, nyg, hn, Rc,
// hc; halos = b_top, b_bot, u_top, u_bot, e_top, e_bot (device pointers).
template <class T>
inline RowBlock<T> row_block(const int* geom, const unsigned long long* h) {
  auto ptr = [&](int i) { return reinterpret_cast<const T*>(h[i]); };
  return RowBlock<T>{geom[0], geom[1], geom[2], geom[3], geom[4], geom[5],
                     ptr(0),  ptr(1),  ptr(2),  ptr(3),  ptr(4),  ptr(5)};
}

// Local row ly (< 0 above the block, >= R below it) of a field held as an
// R-row block `mid` with halo buffers of hn rows, each row w wide; null
// past the halos (such rows are never needed: they stay zero).
template <class T>
__device__ __forceinline__ const T* block_row(const T* mid, const T* top,
                                              const T* bot, int ly, int R,
                                              int hn, int w) {
  if (ly < 0) return ly >= -hn ? top + (size_t)(ly + hn) * w : nullptr;
  if (ly >= R) return ly - R < hn ? bot + (size_t)(ly - R) * w : nullptr;
  return mid + (size_t)ly * w;
}

// Bilinear prolongation of the coarse correction at the global fine point
// (gy, gx), in the compute type (the arithmetic of mg::prolong_at and
// ops/transfer.prolong_bilinear); coarse rows at or past the domain's
// (nyg - 1) / 2, the coarse pad row among them, count as zero.
template <class T>
__device__ __forceinline__ compute_t<T> prolong_rows(const T* e,
                                                     const RowBlock<T>& rb,
                                                     int gy, int gx, int nxc) {
  using C = compute_t<T>;
  const int nyc = (rb.nyg - 1) / 2, c0 = rb.row0 / 2;
  // Each coarse row the point reads is found once (null: zero).
  auto row = [&](int I) -> const T* {
    if (I < 0 || I >= nyc) return nullptr;
    return block_row(e, rb.e_top, rb.e_bot, I - c0, rb.Rc, rb.hc, nxc);
  };
  auto at = [&](const T* r, int J) -> C {
    return r != nullptr && J >= 0 && J < nxc ? to_c(r[J]) : C(0);
  };
  const int I = gy >> 1, J = gx >> 1;
  const bool oy = gy & 1, ox = gx & 1;
  const T* r1 = row(I);
  if (oy && ox) return at(r1, J);
  if (oy) return (at(r1, J - 1) + at(r1, J)) * C(0.5);
  const T* r0 = row(I - 1);
  if (ox) return (at(r0, J) + at(r1, J)) * C(0.5);
  return (at(r0, J - 1) + at(r0, J) + at(r1, J - 1) + at(r1, J)) * C(0.25);
}

// ---- 5-point coefficients staged for a tile: cs, cw, cc, ce, cn, dinv.
template <class C>
struct RowCoeffs {
  C* cs;
  C* cw;
  C* cc;
  C* ce;
  C* cn;
  C* dinv;
};

template <class T>
__host__ __device__ constexpr size_t coeff_elems(const Coeffs<T>&, int SH,
                                                 int) {
  return 6 * (size_t)SH;
}

template <class T>
__device__ __forceinline__ RowCoeffs<compute_t<T>> stage(
    const Coeffs<T>& c, compute_t<T>* base, int SH, int, int gy0, int, int ny,
    int) {
  using C = compute_t<T>;
  RowCoeffs<C> rc{base, base + SH, base + 2 * SH, base + 3 * SH,
                  base + 4 * SH, base + 5 * SH};
  for (int i = threadIdx.x; i < SH; i += NTHREADS) {
    int gy = gy0 + i;
    bool in = gy >= 0 && gy < ny;
    rc.cs[i] = in ? to_c(c.cs[gy]) : C(0);
    rc.cw[i] = in ? to_c(c.cw[gy]) : C(0);
    rc.cc[i] = in ? to_c(c.cc[gy]) : C(0);
    rc.ce[i] = in ? to_c(c.ce[gy]) : C(0);
    rc.cn[i] = in ? to_c(c.cn[gy]) : C(0);
    rc.dinv[i] = in ? C(1) / to_c(c.cc[gy]) : C(0);
  }
  return rc;
}

// (A v) at shared point (sy, sx) of an SH x SW tile; neighbours outside
// the tile count as zero (their pollution stays inside the halo).  Term
// order follows the JAX package: cc, south, north, west, east.
template <class C>
__device__ __forceinline__ C apply_at(const C* v, const RowCoeffs<C>& rc,
                                      int sy, int sx, int SH, int SW) {
  int i = sy * SW + sx;
  C s = sy > 0 ? v[i - SW] : C(0);
  C n = sy < SH - 1 ? v[i + SW] : C(0);
  C w = sx > 0 ? v[i - 1] : C(0);
  C e = sx < SW - 1 ? v[i + 1] : C(0);
  return rc.cc[sy] * v[i] + rc.cs[sy] * s + rc.cn[sy] * n + rc.cw[sy] * w +
         rc.ce[sy] * e;
}

template <class C>
__device__ __forceinline__ C dinv_at(const RowCoeffs<C>& rc, int sy, int) {
  return rc.dinv[sy];
}

// ---- 9-point coefficients staged for a tile: entry q (csw..cne, then
// dinv laid out as cc) at c[q][sy * ys[q] + sx * xs[q]], its shared strides
// (SW, 1) for a field, (1, 0) for a column, (0, 1) for a row, (0, 0) for a
// scalar.
template <class C>
struct Tile9 {
  const C* c[10];
  int ys[10];
  int xs[10];
};

__host__ __device__ inline size_t staged_size(int sy, int sx, int SH,
                                              int SW) {
  return (size_t)(sy ? SH : 1) * (sx ? SW : 1);
}

template <class T>
__host__ __device__ inline size_t coeff_elems(const Coeffs9<T>& c, int SH,
                                              int SW) {
  size_t n = staged_size(c.sy[mg::CC], c.sx[mg::CC], SH, SW);  // dinv
  for (int q = 0; q < 9; ++q) n += staged_size(c.sy[q], c.sx[q], SH, SW);
  return n;
}

// Coefficients outside the domain are staged as 0 (their points are
// masked); dinv guards a zero cc as the JAX kernel does.
template <class T>
__device__ Tile9<compute_t<T>> stage(const Coeffs9<T>& c, compute_t<T>* base,
                                     int SH, int SW, int gy0, int gx0, int ny,
                                     int nx) {
  using C = compute_t<T>;
  Tile9<C> t;
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
      C v = C(0);
      if (in) {
        v = to_c(c.p[src][(gys ? (size_t)(gy - c.oy) * gys : 0) +
                          (gxs ? (size_t)gx * gxs : 0)]);
        if (q == 9) v = v == C(0) ? C(1) : C(1) / v;
      }
      base[i] = v;
    }
    base += rows * cols;
  }
  return t;
}

template <class C>
__device__ __forceinline__ C tat(const Tile9<C>& t, int q, int sy, int sx) {
  return t.c[q][sy * t.ys[q] + sx * t.xs[q]];
}

// 9-point (A v) at shared point (sy, sx); term order of the JAX package:
// cc, s, n, w, e, sw, se, nw, ne.
template <class C>
__device__ __forceinline__ C apply_at(const C* v, const Tile9<C>& t, int sy,
                                      int sx, int SH, int SW) {
  const int i = sy * SW + sx;
  const bool hs = sy > 0, hn = sy < SH - 1, hw = sx > 0, he = sx < SW - 1;
  const C s = hs ? v[i - SW] : C(0);
  const C n = hn ? v[i + SW] : C(0);
  const C w = hw ? v[i - 1] : C(0);
  const C e = he ? v[i + 1] : C(0);
  const C sw = hs && hw ? v[i - SW - 1] : C(0);
  const C se = hs && he ? v[i - SW + 1] : C(0);
  const C nw = hn && hw ? v[i + SW - 1] : C(0);
  const C ne = hn && he ? v[i + SW + 1] : C(0);
  return tat(t, mg::CC, sy, sx) * v[i] + tat(t, mg::CS, sy, sx) * s +
         tat(t, mg::CN, sy, sx) * n + tat(t, mg::CW, sy, sx) * w +
         tat(t, mg::CE, sy, sx) * e + tat(t, mg::CSW, sy, sx) * sw +
         tat(t, mg::CSE, sy, sx) * se + tat(t, mg::CNW, sy, sx) * nw +
         tat(t, mg::CNE, sy, sx) * ne;
}

template <class C>
__device__ __forceinline__ C dinv_at(const Tile9<C>& t, int sy, int sx) {
  return tat(t, 9, sy, sx);
}

// ---- K8: five full (ny, nx) coefficient fields (the stencil form of an
// assembled level matrix, ops/sparse.py).  Each coefficient is used by its
// own point only, so nothing is staged: a thread reads the five values of
// its point straight from device memory (neighbouring threads, neighbouring
// addresses), once per point.
template <class T>
struct Fields5 {
  const T* cs;
  const T* cw;
  const T* cc;
  const T* ce;
  const T* cn;
};

template <class T>
struct FieldTile {
  Fields5<T> f;
  int gy0, gx0, nx;
};

template <class T>
__host__ __device__ constexpr size_t coeff_elems(const Fields5<T>&, int, int) {
  return 0;
}

template <class T>
__device__ __forceinline__ FieldTile<T> stage(const Fields5<T>& c,
                                              compute_t<T>*, int, int,
                                              int gy0, int gx0, int,
                                              int nx) {
  return FieldTile<T>{c, gy0, gx0, nx};
}

// Term order of the JAX field kernel: cc, south, north, west, east.  Only
// called at domain points (the stencil kernel's output tile).
template <class T>
__device__ __forceinline__ compute_t<T> apply_at(const compute_t<T>* v,
                                                 const FieldTile<T>& t,
                                                 int sy, int sx, int SH,
                                                 int SW) {
  using C = compute_t<T>;
  const int i = sy * SW + sx;
  const size_t g = (size_t)(t.gy0 + sy) * t.nx + (t.gx0 + sx);
  const C s = sy > 0 ? v[i - SW] : C(0);
  const C n = sy < SH - 1 ? v[i + SW] : C(0);
  const C w = sx > 0 ? v[i - 1] : C(0);
  const C e = sx < SW - 1 ? v[i + 1] : C(0);
  return to_c(t.f.cc[g]) * v[i] + to_c(t.f.cs[g]) * s + to_c(t.f.cn[g]) * n +
         to_c(t.f.cw[g]) * w + to_c(t.f.ce[g]) * e;
}

// k polynomial smoother steps on the shared tile, Dirichlet-masked; step s
// takes (alpha, beta) = (steps[2s], steps[2s + 1]).  zero_guess: u = p = 0
// on entry and the first step is z = dinv * b.
template <class C, class R>
__device__ void smooth_tile(const C* b, C* u, C* p, const R& rc,
                            const C* __restrict__ steps, int k,
                            bool zero_guess, int SH, int SW, int gy0, int gx0,
                            int ny, int nx) {
  const int n = SH * SW;
  for (int s = 0; s < k; ++s) {
    const C a = steps[2 * s];
    const C bt = steps[2 * s + 1];
    const bool first = zero_guess && s == 0;
    for (int i = threadIdx.x; i < n; i += NTHREADS) {
      int sy = i / SW, sx = i - (i / SW) * SW;
      int gy = gy0 + sy, gx = gx0 + sx;
      if (gy < 0 || gy >= ny || gx < 0 || gx >= nx) {
        p[i] = C(0);
        continue;
      }
      const C d = dinv_at(rc, sy, sx);
      C z = first ? d * b[i] : d * (b[i] - apply_at(u, rc, sy, sx, SH, SW));
      p[i] = (s == 0 ? C(0) : bt * p[i]) + a * z;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += NTHREADS) u[i] += p[i];  // p = 0 outside
    __syncthreads();
  }
}

// Shared memory of a visit block with halo H: the b, u, p tiles, the
// staged coefficients and the reduction slots, in the compute type.
template <class T, class K>
size_t visit_smem_bytes(const K& c, int H) {
  const int SH = TY + 2 * H, SW = TX + 2 * H;
  return sizeof(compute_t<T>) *
         (3 * (size_t)SH * SW + coeff_elems(c, SH, SW) + NTHREADS / 32);
}

constexpr int halo(int emit, int k) {
  return k + (emit == EMIT_U ? 0 : emit == EMIT_RC ? 2 : 1);
}

// The level visit: [b = r - alpha ap] [u + P e] -> k steps -> the emits.
// rc holds the coarse points whose 3x3 footprint the tile owns.  ROWS
// (K17): the launch covers a row block; its local rows ly map to global
// rows row0 + ly; masks, coefficients and the prolongation go by the
// global row, reads and writes by the local, rows past the block come from
// the halo buffers, and rows at or past the domain are written as 0.  A
// whole grid (ROWS false) compiles to the plain indexing, so the
// whole-grid visits pay nothing for the row-block mode.
template <class T, bool CG, bool GUESS, bool CORRECT, int EMIT, bool DOT,
          class K, bool ROWS>
__global__ void __launch_bounds__(NTHREADS)
visit_kernel(K c, VisitIO<T> io, RowBlock<T> rb, int nx, int H,
             const compute_t<T>* __restrict__ steps, int k) {
  using C = compute_t<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  C* sm = reinterpret_cast<C*>(smem_raw);
  const int SH = TY + 2 * H, SW = TX + 2 * H, n = SH * SW;
  C* b = sm;
  C* u = b + n;
  C* p = u + n;
  C* red = p + n + coeff_elems(c, SH, SW);
  const int ny = rb.nyg, nyc = (ny - 1) / 2, nxc = (nx - 1) / 2;
  // A whole grid's block is the grid: R = ny, Rc = nyc, row0 = 0.
  const int row0 = ROWS ? rb.row0 : 0, R = ROWS ? rb.R : ny;
  const int Rc = ROWS ? rb.Rc : nyc;
  const int y0 = blockIdx.y * TY, x0 = blockIdx.x * TX;  // local
  const int gy0 = row0 + y0 - H, gx0 = x0 - H;           // global
  const auto rc = stage(c, p + n, SH, SW, gy0, gx0, ny, nx);
  const C alpha = CG ? *io.alpha : C(0);
  for (int i = threadIdx.x; i < n; i += NTHREADS) {
    int sy = i / SW, sx = i - (i / SW) * SW;
    int gy = gy0 + sy, gx = gx0 + sx;
    C bv = C(0), uv = C(0);
    if (gy >= 0 && gy < ny && gx >= 0 && gx < nx) {
      if constexpr (ROWS) {
        const int ly = y0 - H + sy;
        const T* brow =
            block_row(io.b, rb.b_top, rb.b_bot, ly, rb.R, rb.hn, nx);
        if (brow != nullptr) {  // past the halos: never read, left 0
          bv = to_c(brow[gx]);
          if (GUESS)
            uv = to_c(block_row(io.u, rb.u_top, rb.u_bot, ly, rb.R, rb.hn,
                                nx)[gx]);
          if (CORRECT) uv += prolong_rows(io.e, rb, gy, gx, nxc);
        }
      } else {
        size_t g = (size_t)gy * nx + gx;
        bv = CG ? to_c(io.b[g]) - alpha * to_c(io.ap[g]) : to_c(io.b[g]);
        if (GUESS) uv = to_c(io.u[g]);
        if (CORRECT) uv += mg::prolong_at(io.e, gy, gx, nyc, nxc);
      }
    }
    b[i] = bv;
    u[i] = uv;
    p[i] = C(0);
  }
  __syncthreads();
  smooth_tile(b, u, p, rc, steps, k, !GUESS, SH, SW, gy0, gx0, ny, nx);

  C acc = C(0);
  for (int t = threadIdx.x; t < TY * TX; t += NTHREADS) {
    int ty = t / TX, tx = t - (t / TX) * TX;
    int ly = y0 + ty, gx = x0 + tx;  // a whole grid's ly is its gy
    if (ly >= R || gx >= nx) continue;
    const bool in = !ROWS || row0 + ly < ny;  // the pad row is written as 0
    int i = (ty + H) * SW + tx + H;
    size_t g = (size_t)ly * nx + gx;
    if (EMIT != EMIT_R) put(io.u_out, g, in ? u[i] : C(0));
    if (EMIT == EMIT_UR || EMIT == EMIT_R)
      put(io.r_out, g,
          in ? b[i] - apply_at(u, rc, ty + H, tx + H, SH, SW) : C(0));
    if (CG) {
      put(io.rnew_out, g, b[i]);
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
      p[i] = in ? b[i] - apply_at(u, rc, sy, sx, SH, SW) : C(0);
    }
    __syncthreads();
    // Full weighting: y pass first, then x (ops/transfer.restrict_fw).
    // A row block's coarse rows at or past nyc (the global coarse pad
    // row) are 0.
    for (int t = threadIdx.x; t < (TY / 2) * (TX / 2); t += NTHREADS) {
      int cy = t / (TX / 2), cx = t - (t / (TX / 2)) * (TX / 2);
      int I = y0 / 2 + cy, J = x0 / 2 + cx;  // local coarse row I
      if (I >= Rc || J >= nxc) continue;
      const C* r0 = p + (2 * cy + H) * SW + 2 * cx + H;  // fine (2I, 2J)
      C ycol[3];
      for (int d = 0; d < 3; ++d)
        ycol[d] = r0[d] + C(2) * r0[SW + d] + r0[2 * SW + d];
      put(io.rc_out, (size_t)I * nxc + J,
          !ROWS || row0 / 2 + I < nyc
              ? C(0.0625) * (ycol[0] + C(2) * ycol[1] + ycol[2])
              : C(0));
    }
  }
  if (CG || DOT) {
    C s = mg::block_sum<NTHREADS>(acc, red);
    if (threadIdx.x == 0) io.part[blockIdx.y * gridDim.x + blockIdx.x] = s;
  }
}

template <class T, class K>
using VisitFn = void (*)(K, VisitIO<T>, RowBlock<T>, int, int,
                         const compute_t<T>*, int);

template <class T, bool GUESS, bool CORRECT, class K, bool ROWS>
VisitFn<T, K> pick_emit(int emit, bool dot) {
  if (dot)  // DOT goes with emit u, on whole grids
    return emit == EMIT_U && !ROWS
               ? visit_kernel<T, false, GUESS, CORRECT, EMIT_U, true, K,
                              false>
               : nullptr;
  switch (emit) {
    case EMIT_U:
      return visit_kernel<T, false, GUESS, CORRECT, EMIT_U, false, K, ROWS>;
    case EMIT_UR:
      return visit_kernel<T, false, GUESS, CORRECT, EMIT_UR, false, K, ROWS>;
    case EMIT_R:
      return visit_kernel<T, false, GUESS, CORRECT, EMIT_R, false, K, ROWS>;
    case EMIT_RC:
      return visit_kernel<T, false, GUESS, CORRECT, EMIT_RC, false, K, ROWS>;
  }
  return nullptr;
}

// The instantiation for a flag set, or null for a set the family lacks
// (CG is the 5-point f32 zero-guess rc visit on a whole grid only; DOT goes
// with emit u on a whole grid only; a correction needs a guess).
template <class T, class K, bool ROWS>
VisitFn<T, K> pick_visit(int flags) {
  const bool cg = flags & F_CG, guess = flags & F_GUESS;
  const bool correct = flags & F_CORRECT, dot = flags & F_DOT;
  const int emit = flags >> EMIT_SHIFT;
  if (cg) {
    if constexpr (std::is_same<K, Coeffs<float>>::value && !ROWS)
      return (guess || correct || dot || emit != EMIT_RC)
                 ? nullptr
                 : visit_kernel<T, true, false, false, EMIT_RC, false, K,
                                false>;
    return nullptr;
  }
  if (!guess)
    return correct ? nullptr : pick_emit<T, false, false, K, ROWS>(emit, dot);
  return correct ? pick_emit<T, true, true, K, ROWS>(emit, dot)
                 : pick_emit<T, true, false, K, ROWS>(emit, dot);
}

// K1 (UPDATE_U) and K11: p' = z + beta p (tile + 1-point halo in shared
// memory), A p', <p', A p'> partials; K1 also u' = u + alpha_prev p
// (pointwise; un may alias u).
template <class T, bool UPDATE_U>
__global__ void __launch_bounds__(NTHREADS)
cg_papply_kernel(Coeffs<T> c, const T* __restrict__ z,
                 const T* __restrict__ p, const T* u,
                 const compute_t<T>* __restrict__ alpha_prev_ptr,
                 const compute_t<T>* __restrict__ beta_ptr,
                 T* __restrict__ pn_out, T* __restrict__ ap_out, T* un_out,
                 compute_t<T>* __restrict__ part, int ny, int nx) {
  using C = compute_t<T>;
  constexpr int SH = TY + 2, SW = TX + 2;
  __shared__ C pn[SH * SW];
  __shared__ C crow[6 * SH];
  __shared__ C red[NTHREADS / 32];
  const int y0 = blockIdx.y * TY, x0 = blockIdx.x * TX;
  const int gy0 = y0 - 1, gx0 = x0 - 1;
  RowCoeffs<C> rc = stage(c, crow, SH, SW, gy0, gx0, ny, nx);
  const C beta = *beta_ptr;
  const C alpha_prev = UPDATE_U ? *alpha_prev_ptr : C(0);
  for (int i = threadIdx.x; i < SH * SW; i += NTHREADS) {
    int sy = i / SW, sx = i - (i / SW) * SW;
    int gy = gy0 + sy, gx = gx0 + sx;
    C v = C(0);
    if (gy >= 0 && gy < ny && gx >= 0 && gx < nx) {
      size_t g = (size_t)gy * nx + gx;
      v = to_c(z[g]) + beta * to_c(p[g]);
    }
    pn[i] = v;
  }
  __syncthreads();
  C acc = C(0);
  for (int t = threadIdx.x; t < TY * TX; t += NTHREADS) {
    int ty = t / TX, tx = t - (t / TX) * TX;
    int gy = y0 + ty, gx = x0 + tx;
    if (gy >= ny || gx >= nx) continue;
    int sy = ty + 1, sx = tx + 1;
    C a = apply_at(pn, rc, sy, sx, SH, SW);
    C v = pn[sy * SW + sx];
    size_t g = (size_t)gy * nx + gx;
    put(pn_out, g, v);
    put(ap_out, g, a);
    if (UPDATE_U) put(un_out, g, to_c(u[g]) + alpha_prev * to_c(p[g]));
    acc += v * a;
  }
  C s = mg::block_sum<NTHREADS>(acc, red);
  if (threadIdx.x == 0) part[blockIdx.y * gridDim.x + blockIdx.x] = s;
}

// K6 / K12 (RESID = false): y = A u; residual5 / residual9 (RESID = true):
// y = b - A u.  The tile + 1-point halo of u in shared memory, as K1, with
// the coefficients staged after it.  ROWS (K17's emits a and r): a row
// block, u's rows past it from its 1-row halo buffers, b read on the
// block's own rows only, the pad row written as 0.
template <class T, bool RESID, class K, bool ROWS>
__global__ void __launch_bounds__(NTHREADS)
stencil_kernel(K c, const T* __restrict__ b, const T* __restrict__ u,
               T* __restrict__ y, RowBlock<T> rb, int nx) {
  using C = compute_t<T>;
  constexpr int SH = TY + 2, SW = TX + 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  C* us = reinterpret_cast<C*>(smem_raw);
  const int ny = rb.nyg;
  const int row0 = ROWS ? rb.row0 : 0, R = ROWS ? rb.R : ny;
  const int y0 = blockIdx.y * TY, x0 = blockIdx.x * TX;  // local
  const int gy0 = row0 + y0 - 1, gx0 = x0 - 1;           // global
  const auto rc = stage(c, us + SH * SW, SH, SW, gy0, gx0, ny, nx);
  for (int i = threadIdx.x; i < SH * SW; i += NTHREADS) {
    int sy = i / SW, sx = i - (i / SW) * SW;
    int gy = gy0 + sy, gx = gx0 + sx;
    C v = C(0);
    if (gy >= 0 && gy < ny && gx >= 0 && gx < nx) {
      if constexpr (ROWS) {
        const T* row =
            block_row(u, rb.u_top, rb.u_bot, y0 - 1 + sy, rb.R, rb.hn, nx);
        if (row != nullptr) v = to_c(row[gx]);
      } else {
        v = to_c(u[(size_t)gy * nx + gx]);
      }
    }
    us[i] = v;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < TY * TX; t += NTHREADS) {
    int ty = t / TX, tx = t - (t / TX) * TX;
    int ly = y0 + ty, gx = x0 + tx;  // a whole grid's ly is its gy
    if (ly >= R || gx >= nx) continue;
    C a = apply_at(us, rc, ty + 1, tx + 1, SH, SW);
    size_t g = (size_t)ly * nx + gx;
    put(y, g, !ROWS || row0 + ly < ny ? (RESID ? to_c(b[g]) - a : a) : C(0));
  }
}

inline dim3 visit_grid(int ny, int nx) {
  return dim3((nx + TX - 1) / TX, (ny + TY - 1) / TY);
}

// A row block needs halo buffers that hold the visit's halo H (at most
// the block), and H / 2 + 1 coarse halo rows to correct.
template <class T, bool ROWS>
bool row_block_ok(const RowBlock<T>& rb, int H, int flags) {
  if (!ROWS) return true;
  return H <= rb.hn && H <= rb.R &&
         (!(flags & F_CORRECT) || rb.hc >= H / 2 + 1);
}

template <class T, bool ROWS = false, class K>
int launch_visit(const K& c, const VisitIO<T>& io, const RowBlock<T>& rb,
                 int nx, const compute_t<T>* steps, int k, int flags,
                 void* stream) {
  VisitFn<T, K> kern = pick_visit<T, K, ROWS>(flags);
  if (kern == nullptr || k < 1) return (int)cudaErrorInvalidValue;
  const int H = halo(flags >> EMIT_SHIFT, k);
  if (!row_block_ok<T, ROWS>(rb, H, flags))
    return (int)cudaErrorInvalidValue;
  const size_t smem = visit_smem_bytes<T>(c, H);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  int err = (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  kern<<<visit_grid(rb.R, nx), NTHREADS, smem, (cudaStream_t)stream>>>(
      c, io, rb, nx, H, steps, k);
  return (int)cudaGetLastError();
}

template <class T, bool ROWS = false, class K>
int launch_stencil(const K& c, const T* b, const T* u, T* y,
                   const RowBlock<T>& rb, int nx, int resid, void* stream) {
  if (!row_block_ok<T, ROWS>(rb, 1, 0)) return (int)cudaErrorInvalidValue;
  auto kern = resid ? stencil_kernel<T, true, K, ROWS>
                    : stencil_kernel<T, false, K, ROWS>;
  const size_t smem = sizeof(compute_t<T>) *
                      ((TY + 2) * (TX + 2) + coeff_elems(c, TY + 2, TX + 2));
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  int err = (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  kern<<<visit_grid(rb.R, nx), NTHREADS, smem, (cudaStream_t)stream>>>(
      c, b, u, y, rb, nx);
  return (int)cudaGetLastError();
}

template <class T, bool UPDATE_U>
int launch_papply(const Coeffs<T>& c, const T* z, const T* p, const T* u,
                  const compute_t<T>* alpha_prev, const compute_t<T>* beta,
                  T* pn, T* ap, T* un, compute_t<T>* part, int ny, int nx,
                  void* stream) {
  cg_papply_kernel<T, UPDATE_U>
      <<<visit_grid(ny, nx), NTHREADS, 0, (cudaStream_t)stream>>>(
          c, z, p, u, alpha_prev, beta, pn, ap, un, part, ny, nx);
  return (int)cudaGetLastError();
}

}  // namespace

// The C entries every storage type has, named mg_<entry><SFX> for storage
// type T (SFX empty for f32, _f64, _bf16):
//   mg_visit    one 5-point level visit (K2b, K3, K7, K9; K2a/K10 in f32).
//               flags: F_CG | F_GUESS | F_CORRECT | F_DOT |
//               emit << EMIT_SHIFT; the pointers the flags do not use may
//               be null; steps: k (alpha, beta) pairs in the compute type
//               in device memory.  A flag set outside the family, or a
//               visit whose shared memory exceeds a block's, is refused.
//   mg_visit9   one 9-point level visit (K13, K14): as mg_visit without
//               F_CG; the coefficients as in mg_common.cuh's coeffs9().
//   mg_stencil  K6 (resid == 0): y = A u; residual5 (resid != 0): y = b - A u.
//   mg_stencil9 K12: y = A u (resid == 0) or y = b - A u, 9-point.
#define MG_VISIT_ENTRIES(SFX, T)                                             \
  extern "C" int mg_visit##SFX(                                              \
      const T* cs, const T* cw, const T* cc, const T* ce, const T* cn,       \
      const T* b, const T* ap, const compute_t<T>* alpha, const T* u,        \
      const T* e, T* u_out, T* r_out, T* rc_out, T* rnew_out,                \
      compute_t<T>* part, int ny, int nx, const compute_t<T>* steps, int k,  \
      int flags, void* stream) {                                             \
    Coeffs<T> c{cs, cw, cc, ce, cn};                                         \
    VisitIO<T> io{b, ap, alpha, u, e, u_out, r_out, rc_out, rnew_out, part}; \
    return launch_visit<T>(c, io, whole_grid<T>(ny), nx, steps, k, flags,    \
                           stream);                                          \
  }                                                                          \
  extern "C" int mg_visit9##SFX(                                             \
      const unsigned long long* cptrs, const int* cstrides, const T* b,      \
      const T* u, const T* e, T* u_out, T* r_out, T* rc_out,                 \
      compute_t<T>* part, int ny, int nx, const compute_t<T>* steps, int k,  \
      int flags, void* stream) {                                             \
    VisitIO<T> io{b,     nullptr, nullptr, u,       e,                       \
                  u_out, r_out,   rc_out,  nullptr, part};                   \
    return launch_visit<T>(mg::coeffs9<T>(cptrs, cstrides), io,              \
                           whole_grid<T>(ny), nx, steps, k, flags, stream);  \
  }                                                                          \
  extern "C" int mg_stencil##SFX(const T* cs, const T* cw, const T* cc,      \
                                 const T* ce, const T* cn, const T* b,       \
                                 const T* u, T* y, int ny, int nx,           \
                                 int resid, void* stream) {                  \
    Coeffs<T> c{cs, cw, cc, ce, cn};                                         \
    return launch_stencil<T>(c, b, u, y, whole_grid<T>(ny), nx, resid,       \
                             stream);                                        \
  }                                                                          \
  extern "C" int mg_stencil9##SFX(const unsigned long long* cptrs,           \
                                  const int* cstrides, const T* b,           \
                                  const T* u, T* y, int ny, int nx,          \
                                  int resid, void* stream) {                 \
    return launch_stencil<T>(mg::coeffs9<T>(cptrs, cstrides), b, u, y,       \
                             whole_grid<T>(ny), nx, resid, stream);          \
  }

// K17, the row-block entries (visit.cu and visit_f64.cu: f32 and f64), named
// as the whole-grid entries with _rows: one visit (mg_visit_rows,
// mg_visit9_rows: every flag set but F_CG) or A u / b - A u (mg_stencil_rows,
// mg_stencil9_rows, halo 1) on one rank's row block.  geom: R, row0, nyg,
// hn, Rc, hc (RowBlock); halos: device pointers b_top, b_bot, u_top, u_bot,
// e_top, e_bot, null where the flags read none; coff: the first global row
// the 9-point coefficients that vary with y hold.
#define MG_VISIT_ROWS_ENTRIES(SFX, T)                                        \
  extern "C" int mg_visit_rows##SFX(                                         \
      const T* cs, const T* cw, const T* cc, const T* ce, const T* cn,       \
      const T* b, const T* u, const T* e, T* u_out, T* r_out, T* rc_out,     \
      compute_t<T>* part, const int* geom, const unsigned long long* halos,  \
      int nx, const compute_t<T>* steps, int k, int flags, void* stream) {   \
    Coeffs<T> c{cs, cw, cc, ce, cn};                                         \
    VisitIO<T> io{b,     nullptr, nullptr, u,       e,                       \
                  u_out, r_out,   rc_out,  nullptr, part};                   \
    return launch_visit<T, true>(c, io, row_block<T>(geom, halos), nx,      \
                                 steps, k, flags, stream);                   \
  }                                                                          \
  extern "C" int mg_visit9_rows##SFX(                                        \
      const unsigned long long* cptrs, const int* cstrides, int coff,        \
      const T* b, const T* u, const T* e, T* u_out, T* r_out, T* rc_out,     \
      compute_t<T>* part, const int* geom, const unsigned long long* halos,  \
      int nx, const compute_t<T>* steps, int k, int flags, void* stream) {   \
    Coeffs9<T> c = mg::coeffs9<T>(cptrs, cstrides);                          \
    c.oy = coff;                                                             \
    VisitIO<T> io{b,     nullptr, nullptr, u,       e,                       \
                  u_out, r_out,   rc_out,  nullptr, part};                   \
    return launch_visit<T, true>(c, io, row_block<T>(geom, halos), nx,      \
                                 steps, k, flags, stream);                   \
  }                                                                          \
  extern "C" int mg_stencil_rows##SFX(                                       \
      const T* cs, const T* cw, const T* cc, const T* ce, const T* cn,       \
      const T* b, const T* u, T* y, const int* geom,                         \
      const unsigned long long* halos, int nx, int resid, void* stream) {    \
    Coeffs<T> c{cs, cw, cc, ce, cn};                                         \
    return launch_stencil<T, true>(c, b, u, y, row_block<T>(geom, halos),  \
                                   nx, resid, stream);                       \
  }                                                                          \
  extern "C" int mg_stencil9_rows##SFX(                                      \
      const unsigned long long* cptrs, const int* cstrides, int coff,        \
      const T* b, const T* u, T* y, const int* geom,                         \
      const unsigned long long* halos, int nx, int resid, void* stream) {    \
    Coeffs9<T> c = mg::coeffs9<T>(cptrs, cstrides);                          \
    c.oy = coff;                                                             \
    return launch_stencil<T, true>(c, b, u, y, row_block<T>(geom, halos),  \
                                   nx, resid, stream);                       \
  }
