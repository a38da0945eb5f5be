// Level-visit and stencil kernels of the multigrid solvers, for Hopper
// (sm_90a), as templates over the storage type T; visit.cu (f32),
// visit_f64.cu and visit_bf16.cu instantiate them and bind each to a plain
// C interface (ctypes), one entry per storage type.
//
// One templated visit kernel, visit5_kernel, serves every fused 5-point
// level visit (Coeffs), and visit9_kernel every 9-point one (Coeffs9);
// their flags pick what is read and written:
//   CG       b = r - alpha * ap formed in-kernel; r' and ||r'||^2 emitted
//            (5-point, f32 only)
//   GUESS    start from the given u (else the zero guess: z = D^-1 b first)
//   CORRECT  u += P e_c (bilinear prolongation) before the sweeps
//   EMIT     u | u + r | r | u + rc (rc: full-weighting restriction of r)
//   DOT      <b, u> partials
//
// Replaces (multigrid_petsc_tpu/ops/pallas/):
//   K1  cg_papply_kernel<UPDATE_U> <- mdma_kernel.py cg_papply_u_mdma
//   K2a visit5_kernel <CG, rc> <- mdma_kernel.py cg_visit_down_mdma
//   K2b visit5_kernel <rc>   <- mdma_kernel.py visit_down_mdma
//   K3  visit5_kernel <GUESS, CORRECT, u[, DOT]> <- mdma_kernel.py
//       visit_up_mdma
//   K6  stencil_kernel<false, Coeffs> <- stencil_kernel.py
//       apply_stencil5_pallas
//   K7  visit5_kernel <GUESS, u> <- stencil_kernel.py smooth_sweeps_pallas
//   K8  stencil_kernel<RESID, Fields5> <- stencil_kernel.py
//       apply_stencil5_field_pallas (five (ny, nx) coefficient fields: 7
//       arrays moved for A u, 8 for b - A u; the fields are read in place,
//       not staged)
//   K9  visit5_kernel (every flag set above) <- stencil_kernel.py
//       fused_level_visit_pallas; its k = 0 residual (residual5_pallas)
//       is stencil_kernel<true, Coeffs>
//   K10 visit5_kernel <CG, rc> (K2a's flag set, unpadded) <-
//       stencil_kernel.py
//       cg_visit_down_pallas
//   K11 cg_papply_kernel<!UPDATE_U> (K1 without the lagged u stream) <-
//       stencil_kernel.py cg_papply_pallas
//   K12 apply9_kernel <RESID, LAYOUT> <- stencil9_kernel.py
//       apply_stencil9_pallas, residual9_pallas
//   K13 visit9_kernel <GUESS, u> <- stencil9_kernel.py
//       smooth9_sweeps_pallas
//   K14 visit9_kernel (every flag set but CG) <- stencil9_kernel.py
//       fused_level_visit9_pallas
//   K17 visit5_kernel, visit9_kernel, stencil_kernel and apply9_kernel on
//       a block of a partitioned level (Block below: a row block of the
//       rows layout, or a 2-D block of the blocks layout; every flag set
//       but CG, both stencils, f32, f64 and bf16; the bf16 5-point visits
//       on visit5p_kernel, a thread per column pair) <-
//       dist_kernel.py dist_level_visit_local (the row blocks; JAX runs
//       its 2-D blocks as XLA ops under GSPMD, which no Pallas kernel
//       replaces)
//
// Every launch covers a Block: a whole grid, or one rank's block of a
// partitioned level (K17).  A block reads its own points of b, u and e in
// place and the points past it from small halo buffers that the
// neighbours' exchange filled (zeros at the global edges; a 2-D block's
// top and bottom buffers carry the corners), so no extended copy of the
// block is made per visit.  Masking, the coefficients, the prolongation
// and the restriction's pad rule go by the GLOBAL point: points at or past
// the domain's last row or column (the partition's one pad row, and under
// the blocks layout its pad column) are written as 0, as are the global
// coarse pad row and column of rc.  A block needs halos of the visit's H
// (below) and, to correct, H / 2 + 1 coarse points; the wrappers assert
// that H fits a split axis's extent, so points come from the immediate
// neighbours only.
//
// Storage types: f32 and f64 compute in their own type; bf16 is storage
// only -- every load converts to f32, the arithmetic (smoother steps,
// residual, transfers, dots) runs in f32 in shared memory and registers,
// and each output rounds once, where it is stored (mg_common.cuh to_c /
// put), as the JAX kernels' _load_f32 / _store.  A bf16 5-point visit of
// halo up to V5_PAIR_MAX_H runs visit5p_kernel (below), whose step is cut
// for bf16's halved bytes.  Dot partials and the
// step schedule are in the compute type.  K1, K2a/K10 and K11 (the f32
// mg-CG routes) and K8 (f32 sparse levels) are built for f32 only.
//
// What bounds them on the H100: bytes.  Every kernel does O(k) flops per
// point against 8-24 bytes of device-memory traffic per point (twice that
// in f64, half in bf16), far below the card's flop:byte balance, so the
// design goal is to touch each big array once per visit:
//   * a visit block owns a region -- its output tile plus a halo of H
//     rows / columns on every side -- in shared memory (in the compute
//     type); all k smoother steps, the residual and the restriction (or
//     the prolongation + correction) run there, so the k sweeps cost one
//     read of b (and u) and one write of the result instead of ~3 passes
//     per sweep;
//   * the halo is H = k for emit u, k + 1 for u + r and r, k + 2 for rc:
//     pollution from the unknown region edge travels one point (one ring,
//     diagonals included for the 9-point stencil) per stencil
//     application, the residual needs one more point and the
//     full-weighting restriction one more fine row/column past the tile
//     (coarse I needs fine 2I..2I+2);
//   * once in shared memory a visit is bound by the instructions it issues
//     and their latency, so both visits take the strip form (visit5_kernel,
//     visit9_kernel): a thread owns a vertical strip of one column of the
//     region for the whole visit, b and p of its points in registers, the
//     iterate u double-buffered in a ring of zeros (one barrier per step,
//     no bounds test, no u += p pass), a register window for the vertical
//     neighbours, no index division (the thread's column and rows come
//     from its warp and lane, the restriction's coarse points from a warp
//     x lane grid);
//   * halo rows and columns are re-read by neighbouring blocks; they come
//     from L2 for the most part.  A persistent block that prefetches its
//     next region with cp.async was measured slower (visit5_kernel).
//   * K12 (apply9_kernel) stages nothing: a thread walks a column strip
//     with a 3 x 3 window of u read straight from device memory.

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
// bound by the kernel-parameter block.  A 5-point visit's sweep count is
// bound by the wrappers (mdma_kernel.py visit_fits): with emit rc at most
// 43 steps in f32 and bf16 (45 with emit u), 23 in f64, the shared memory
// of its first design's tile + halo, kept as the contract; its regions
// (v5_fits) hold every halo within it.  A 9-point visit's is its fixed
// region (visit9_fits: 29 steps with emit rc, 31 with emit u, in every
// storage type); the wrappers raise ValueError above them.  Dot
// products are emitted as per-block partials in the compute type; the
// caller sums them.
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

// The part of a level a launch covers: R x C local points from the global
// point (row0, col0) (both even) of a domain of nyg x nxg real points.  A
// whole grid is R = nyg, C = nxg, row0 = col0 = 0, Rc = (nyg - 1) / 2, Cc
// = (nxg - 1) / 2 and no halo buffers.  A block of a partitioned level
// (K17) reads the points past it from halo buffers its neighbours'
// exchange filled (zeros at the global edges): b_top / b_bot (and u's)
// hold hn rows of C + 2 hx points each, the corners included, b_left /
// b_right R rows of hx points each; the coarse correction's e_top / e_bot
// hold hc rows of Cc + 2 hcx points, e_left / e_right Rc rows of hcx.  Its
// coarse block (e, rc) is Rc x Cc = R / 2 x C / 2 (floor: an axis that is
// not split has an odd extent).  A row block of the rows layout is a
// block with C = nxg, col0 = 0 and hx = hcx = 0 (no left or right
// buffers); a 2-D block of the blocks layout has hx = hn and hcx = hc.
template <class T>
struct Block {
  int R, row0, nyg, hn, Rc, hc;
  int C, col0, nxg, hx, Cc, hcx;
  const T* b_top;
  const T* b_bot;
  const T* u_top;
  const T* u_bot;
  const T* e_top;
  const T* e_bot;
  const T* b_left;
  const T* b_right;
  const T* u_left;
  const T* u_right;
  const T* e_left;
  const T* e_right;

  // Local point (ly, lx) of u (an R x C block with halos of depth hn, hx);
  // null past the halos (such points are never needed: they stay zero).
  __device__ __forceinline__ const T* u_at(const T* u, int ly, int lx) const;
};

// One local column lx of a field held as a block with halo buffers: its
// rows inside the block in `mid` (the block itself, or a left or right
// halo buffer) with stride ms, the rows above and below in `top` / `bot`
// with stride ws (hy of each); null where the column passes the halos.  A
// thread's column is fixed for a whole visit, so which buffer holds it is
// found once (column_of), and a point costs a row test.
template <class T>
struct Column {
  const T* mid;
  const T* top;
  const T* bot;
  int ms, ws, R, hy;

  __device__ __forceinline__ const T* at(int ly) const {
    if (ly < 0)
      return top != nullptr && ly >= -hy ? top + (size_t)(ly + hy) * ws
                                         : nullptr;
    if (ly >= R)
      return bot != nullptr && ly - R < hy ? bot + (size_t)(ly - R) * ws
                                           : nullptr;
    return mid != nullptr ? mid + (size_t)ly * ms : nullptr;
  }
};

// Column lx of an R x C block `m` with halo buffers: top / bot hy rows of
// C + 2 hx points, left / right R rows of hx points.
template <class T>
__device__ __forceinline__ Column<T> column_of(const T* m, const T* top,
                                               const T* bot, const T* left,
                                               const T* right, int lx, int R,
                                               int C, int hy, int hx) {
  const bool ring = lx >= -hx && lx < C + hx;
  Column<T> c{nullptr, nullptr, nullptr, hx, C + 2 * hx, R, hy};
  if (ring) {
    c.top = top + (lx + hx);
    c.bot = bot + (lx + hx);
  }
  if (lx >= 0 && lx < C) {
    c.mid = m + lx;
    c.ms = C;
  } else if (ring) {
    c.mid = lx < 0 ? left + (lx + hx) : right + (lx - C);
  }
  return c;
}

// A block's column lx of b or u, or coarse column lx of e.
template <class T>
__device__ __forceinline__ Column<T> b_column(const Block<T>& rb,
                                              const T* b, int lx) {
  return column_of(b, rb.b_top, rb.b_bot, rb.b_left, rb.b_right, lx, rb.R,
                   rb.C, rb.hn, rb.hx);
}

template <class T>
__device__ __forceinline__ Column<T> u_column(const Block<T>& rb,
                                              const T* u, int lx) {
  return column_of(u, rb.u_top, rb.u_bot, rb.u_left, rb.u_right, lx, rb.R,
                   rb.C, rb.hn, rb.hx);
}

template <class T>
__device__ __forceinline__ Column<T> e_column(const Block<T>& rb,
                                              const T* e, int lx) {
  return column_of(e, rb.e_top, rb.e_bot, rb.e_left, rb.e_right, lx, rb.Rc,
                   rb.Cc, rb.hc, rb.hcx);
}

template <class T>
inline Block<T> whole_grid(int ny, int nx) {
  Block<T> b{};
  b.R = b.nyg = ny;
  b.C = b.nxg = nx;
  b.Rc = (ny - 1) / 2;
  b.Cc = (nx - 1) / 2;
  return b;
}

// A block from the part entries' host arrays: geom = R, row0, nyg, hn, Rc,
// hc, C, col0, nxg, hx, Cc, hcx; halos = b_top, b_bot, u_top, u_bot,
// e_top, e_bot, b_left, b_right, u_left, u_right, e_left, e_right.
template <class T>
inline Block<T> part_block(const int* g, const unsigned long long* h) {
  auto ptr = [&](int i) { return reinterpret_cast<const T*>(h[i]); };
  return Block<T>{g[0],   g[1],   g[2],   g[3],   g[4],   g[5],
                  g[6],   g[7],   g[8],   g[9],   g[10],  g[11],
                  ptr(0), ptr(1), ptr(2), ptr(3), ptr(4), ptr(5),
                  ptr(6), ptr(7), ptr(8), ptr(9), ptr(10), ptr(11)};
}

// Local point (ly, lx) of a field held as an R x C block `mid` with halo
// buffers: top / bot hy rows of C + 2 hx points, left / right R rows of
// hx points; null past the halos.
template <class T>
__device__ __forceinline__ const T* block_at(const T* mid, const T* top,
                                             const T* bot, const T* left,
                                             const T* right, int ly, int lx,
                                             int R, int C, int hy, int hx) {
  if (ly < 0 || ly >= R) {
    if (lx < -hx || lx >= C + hx) return nullptr;
    const size_t w = (size_t)C + 2 * hx;
    if (ly < 0) return ly >= -hy ? top + (ly + hy) * w + (lx + hx) : nullptr;
    return ly - R < hy ? bot + (ly - R) * w + (lx + hx) : nullptr;
  }
  if (lx < 0) return lx >= -hx ? left + (size_t)ly * hx + (lx + hx) : nullptr;
  if (lx >= C)
    return lx - C < hx ? right + (size_t)ly * hx + (lx - C) : nullptr;
  return mid + (size_t)ly * C + lx;
}

template <class T>
__device__ __forceinline__ const T* Block<T>::u_at(const T* u, int ly,
                                                   int lx) const {
  return block_at(u, u_top, u_bot, u_left, u_right, ly, lx, R, C, hn, hx);
}

// The global row (column) at which a launch stops reading coefficients:
// the domain's end, or a block's halo past it.  A block's 9-point
// coefficients hold only the rows and columns around it (dist_kernel
// checks that they hold [row0 - hn, row0 + R + hn) x [col0 - hx, col0 + C
// + hx)), and a fixed region or tile may reach past them; such points lie
// beyond every output's reach (as b and u past the halos, which the
// readers above leave 0), so they are staged as 0, not read.
template <class T, bool ROWS>
__device__ __forceinline__ int row_end(const Block<T>& rb) {
  return ROWS ? min(rb.nyg, rb.row0 + rb.R + rb.hn) : rb.nyg;
}

template <class T, bool ROWS>
__device__ __forceinline__ int col_end(const Block<T>& rb) {
  return ROWS ? min(rb.nxg, rb.col0 + rb.C + rb.hx) : rb.nxg;
}

// Bilinear prolongation of a block's coarse correction at the global fine
// point (gy, gx), in the compute type (the arithmetic of mg::prolong_at
// and ops/transfer.prolong_bilinear), from the point's coarse columns J =
// gx / 2 (cj) and J - 1 (cjm) of e (e_column); coarse points outside [0,
// (nyg - 1) / 2) x [0, (nxg - 1) / 2), the coarse pad row and column among
// them, count as zero.
template <class T>
__device__ __forceinline__ compute_t<T> prolong_block(const Column<T>& cj,
                                                      const Column<T>& cjm,
                                                      const Block<T>& rb,
                                                      int gy, int gx) {
  using C = compute_t<T>;
  const int nyc = (rb.nyg - 1) / 2, nxc = (rb.nxg - 1) / 2;
  const int c0 = rb.row0 / 2;
  const int I = gy >> 1, J = gx >> 1;
  auto at = [&](int Ix, int Jx) -> C {
    if (Ix < 0 || Ix >= nyc || Jx < 0 || Jx >= nxc) return C(0);
    const T* p = (Jx == J ? cj : cjm).at(Ix - c0);
    return p != nullptr ? to_c(*p) : C(0);
  };
  const bool oy = gy & 1, ox = gx & 1;
  if (oy && ox) return at(I, J);
  if (oy) return (at(I, J - 1) + at(I, J)) * C(0.5);
  if (ox) return (at(I - 1, J) + at(I, J)) * C(0.5);
  return (at(I - 1, J - 1) + at(I - 1, J) + at(I, J - 1) + at(I, J)) *
         C(0.25);
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

// ---- 9-point coefficients staged for a region (visit9_kernel): entry q
// (csw..cne, then dinv laid out as cc) at c[q][sy * ys[q] + sx * xs[q]],
// its shared strides (SW, 1) for a field, (1, 0) for a column, (0, 1) for
// a row, (0, 0) for a scalar.
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

constexpr int halo(int emit, int k) {
  return k + (emit == EMIT_U ? 0 : emit == EMIT_RC ? 2 : 1);
}

template <class T, class K>
using VisitFn = void (*)(K, VisitIO<T>, Block<T>, int, int,
                         const compute_t<T>*, int);

// ---- The 5-point visit (K2a, K2b, K3, K7, K9, K10, K17's 5-point
// blocks; bf16 storage up to V5_PAIR_MAX_H takes visit5p_kernel, below):
// a thread per strip of a region.  A region is GY strips of RS
// rows down each of its 32 * GX columns; the output tile is the region
// less the halo H on every side, so the tile follows the sweep count.
//   * b and p of the strip's points live in registers; u is shared,
//     double-buffered inside a ring of zeros: a step reads the current
//     buffer and writes the next, one barrier, no bounds test, no u += p
//     pass.  A step walks the strip down with the column's u in a
//     register window (one shared load per point for the vertical
//     neighbours) and reads west and east from shared memory: the lanes of
//     a warp take 32 neighbouring columns of a row, so every access is
//     conflict-free.  West / east by __shfl_sync (the edge lanes reading
//     shared memory) measured 5-20% slower on the steps, and was dropped.
//   * The coefficients are (ny, 1) columns: each region row's cc, cs, cn,
//     cw, ce and dinv sit in one 8-slot row of shared memory, two vector
//     loads (f32; three in f64), each a broadcast to the warp.  Points
//     outside the domain stay 0: rows by a zero dinv, columns by a mask.
//   * A coarse correction is formed once per point from a strip's coarse
//     rows (prolong_strip); the restriction runs on a warp x lane grid.
//   * Two regions, picked by an explicit rule on H alone (v5_tall): 64 x
//     128 (two resident blocks in f32) up to V5_SHORT_MAX_H, 128 x 128 (one
//     block; f32 compute only) past it.  The rule's edge is measured A B B
//     A by scripts/time_5pt_visits.py --ab.
//   * Plain loads, not prefetch: a persistent block copying its next
//     tile's b and u with cp.async while it steps on the current one
//     measured 20-50% slower at k <= 3 and was dropped: its staging halves
//     the resident blocks, and two plain blocks already overlap one's loads
//     with the other's steps.  TMA (cp.async.bulk.tensor) does not apply:
//     its global strides must be multiples of 16 bytes, and a level's rows
//     are nx = 2^m - 1 values long.
template <int GX_, int GY_, int RS_>
struct Region5 {
  static constexpr int GX = GX_;  // 32-column groups
  static constexpr int GY = GY_;  // strips down a column
  static constexpr int RS = RS_;  // rows of a strip
  static constexpr int NT = 32 * GX * GY;
  static constexpr int SW = 32 * GX, SH = RS * GY;
  // A u buffer: the region inside a ring of zeros.
  static constexpr int PW = SW + 2;
  static constexpr int PN = (SH + 2) * PW;
  static __device__ __forceinline__ int at(int sy, int sx) {
    return (sy + 1) * PW + sx + 1;
  }
};
using V5Short = Region5<4, 4, 16>;  // 64 x 128
using V5Tall = Region5<4, 4, 32>;   // 128 x 128: f32 compute, large H
// The rule on H: a visit of halo H above this takes the tall region (f32
// compute type; an f64 visit always takes the short one, which holds the
// f64 bound, 25).  Measured (scripts/time_5pt_visits.py): the tall region
// is as fast at H = 7 and 5-12% faster at H = 10 and 12 (fewer halo
// points), 8-50% slower at H <= 5 (one resident block instead of two).
constexpr int V5_SHORT_MAX_H = 8;

template <class RG>
__host__ __device__ constexpr bool v5_fits(int H) {
  return H >= 1 && RG::SH - 2 * H >= 2 && RG::SW - 2 * H >= 2;
}

template <class C>
constexpr bool v5_tall(int H) {
  return sizeof(C) == 4 && H > V5_SHORT_MAX_H;
}

template <class RG>
inline dim3 visit5_grid(int R, int nx, int H) {
  const int ty = RG::SH - 2 * H, tx = RG::SW - 2 * H;
  return dim3((nx + tx - 1) / tx, (R + ty - 1) / ty);
}

// Shared memory of a block: the coefficient rows (8 slots each), the two u
// buffers and the reduction slots, in the compute type.
template <class C, class RG>
constexpr size_t visit5_smem_bytes() {
  return sizeof(C) * (8 * (size_t)RG::SH + 2 * (size_t)RG::PN + RG::NT / 32);
}

// Resident blocks per SM the registers are cut for: two short f32 blocks
// (b and p of 16 points a thread), else one.
template <class C, class RG>
constexpr int v5_min_blocks() {
  return sizeof(C) == 4 && RG::RS <= 16 ? 2 : 1;
}

// A region row's coefficients, staged as 8 slots (cc, cs, cn, cw, ce,
// dinv, 0, 0) so a row is two (f32) or three (f64) vector loads, each a
// broadcast to the warp.
template <class C>
struct Row5 {
  C cc, cs, cn, cw, ce, dinv;
};

__device__ __forceinline__ Row5<float> row5(const float* r) {
  const float4 a = *reinterpret_cast<const float4*>(r);
  const float2 b = *reinterpret_cast<const float2*>(r + 4);
  return {a.x, a.y, a.z, a.w, b.x, b.y};
}

__device__ __forceinline__ Row5<double> row5(const double* r) {
  const double2 a = *reinterpret_cast<const double2*>(r);
  const double2 b = *reinterpret_cast<const double2*>(r + 2);
  const double2 d = *reinterpret_cast<const double2*>(r + 4);
  return {a.x, a.y, b.x, b.y, d.x, d.y};
}

// (A v) at a point; term order of the JAX package: cc, south, north, west,
// east.
template <class C>
__device__ __forceinline__ C apply5(const Row5<C>& k, C c, C s, C n, C w,
                                    C e) {
  return k.cc * c + k.cs * s + k.cn * n + k.cw * w + k.ce * e;
}

// The bilinear prolongation of the coarse correction e onto a thread's
// strip: RS fine rows from global row gy at global column gx.  Each coarse
// row the strip reads is read once, as the sum its x-interpolation needs
// (odd gx: e[X][J]; even: e[X][J - 1] + e[X][J]); the weights follow the
// row and column parity, so the arithmetic is mg::prolong_at's but for the
// order of the four-point sum, and no lane branches on its column.  Coarse
// points outside [0, (nyg - 1) / 2) x [0, nxc) -- the coarse pad row and
// column among them -- and a block's points past its halo buffers count
// as zero.  nxc is the domain's coarse columns (a whole grid's e is
// nxc wide).
template <class T, bool ROWS, int RS>
__device__ __forceinline__ void prolong_strip(const T* e,
                                              const Block<T>& rb, int gy,
                                              int gx, bool colin, int nxc,
                                              compute_t<T> (&pe)[RS]) {
  using C = compute_t<T>;
  constexpr int NS = RS / 2 + 2;  // coarse rows (gy >> 1) - 1 on
  const int nyc = (rb.nyg - 1) / 2, J = gx >> 1, X0 = (gy >> 1) - 1;
  const bool ox = gx & 1, p = gy & 1;
  C sx[NS];
  // ROWS: the block's coarse columns J and J - 1 of e and its halos.
  const Column<T> cj = ROWS ? e_column(rb, e, J - rb.col0 / 2) : Column<T>{};
  const Column<T> cjm =
      ROWS ? e_column(rb, e, J - 1 - rb.col0 / 2) : Column<T>{};
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    const int X = X0 + k;
    if constexpr (ROWS) {
      auto at = [&](const Column<T>& col, int Jx) -> C {
        if (!colin || X < 0 || X >= nyc || Jx < 0 || Jx >= nxc) return C(0);
        const T* q = col.at(X - rb.row0 / 2);
        return q != nullptr ? to_c(*q) : C(0);
      };
      const C a = at(cj, J);
      sx[k] = ox ? a : at(cjm, J - 1) + a;
    } else {
      const T* r = colin && X >= 0 && X < nyc ? e + (size_t)X * nxc
                                              : nullptr;
      const C a = r != nullptr && J < nxc ? to_c(r[J]) : C(0);
      const C w = r != nullptr && !ox && J >= 1 ? to_c(r[J - 1]) : C(0);
      sx[k] = ox ? a : w + a;
    }
  }
  const C w_odd = ox ? C(1) : C(0.5);      // odd fine row: coarse row I
  const C w_even = ox ? C(0.5) : C(0.25);  // even: rows I - 1 and I
#pragma unroll
  for (int i = 0; i < RS; ++i) {
    // Coarse row I = (gy + i) >> 1 sits at sx[((p + i) >> 1) + 1].
    const int lo = (i >> 1) + 1, hi = ((i + 1) >> 1) + 1;
    const C sI = p ? sx[hi] : sx[lo];
    const C sIm = p ? sx[hi - 1] : sx[lo - 1];
    pe[i] = (p + i) & 1 ? sI * w_odd : (sIm + sI) * w_even;
  }
}

// The level visit: [b = r - alpha ap] [u + P e] -> k steps -> the emits.
// rc holds the coarse points whose 3x3 footprint the tile owns.  ROWS
// (K17): the launch covers a block of a partitioned level (a row block,
// or a 2-D block of the blocks layout: Block); its local points (ly, lx)
// map to global points (row0 + ly, col0 + lx); masks, coefficients and
// the prolongation go by the global point, reads and writes by the local,
// points past the block come from the halo buffers, and points at or past
// the domain (the pad row and column) are written as 0; nx is the block's
// width C.  A whole grid (ROWS false) compiles to the plain indexing.  A
// block visits the tile of its (blockIdx.x, blockIdx.y).
template <class T, bool CG, bool GUESS, bool CORRECT, int EMIT, bool DOT,
          bool ROWS, class RG>
__global__ void __launch_bounds__(RG::NT, v5_min_blocks<compute_t<T>, RG>())
visit5_kernel(Coeffs<T> c, VisitIO<T> io, Block<T> rb, int nx, int H,
              const compute_t<T>* __restrict__ steps, int k) {
  using C = compute_t<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  C* crow = reinterpret_cast<C*>(smem_raw);
  C* cur = crow + 8 * RG::SH;
  C* nxt = cur + RG::PN;
  C* red = nxt + RG::PN;
  // A whole grid's block is the grid: R = ny, C = nx, Rc = nyc, Cc = nxc,
  // row0 = col0 = 0.  nxg and nxc: the domain's columns, coarse columns.
  const int ny = rb.nyg, nyc = (ny - 1) / 2;
  const int nxg = ROWS ? rb.nxg : nx, nxc = (nxg - 1) / 2;
  const int row0 = ROWS ? rb.row0 : 0, R = ROWS ? rb.R : ny;
  const int col0 = ROWS ? rb.col0 : 0;
  const int Rc = ROWS ? rb.Rc : nyc, Cc = ROWS ? rb.Cc : nxc;
  const int TY = RG::SH - 2 * H, TX = RG::SW - 2 * H;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int sx = (wid % RG::GX) * 32 + lane;  // the thread's region column
  const int r0 = (wid / RG::GX) * RG::RS;     // its strip's first row
  const C alpha = CG ? *io.alpha : C(0);
  // The zero rings of both u buffers.
  for (int t = threadIdx.x; t < 2 * RG::PW + 2 * RG::SH; t += RG::NT) {
    const int i = t < RG::PW       ? t
                  : t < 2 * RG::PW ? (RG::SH + 1) * RG::PW + t - RG::PW
                                   : (1 + ((t - 2 * RG::PW) >> 1)) * RG::PW +
                                         (t & 1) * (RG::PW - 1);
    cur[i] = C(0);
    nxt[i] = C(0);
  }

  const int y0 = blockIdx.y * TY, x0 = blockIdx.x * TX;  // local
  const int gy0 = row0 + y0 - H;  // global
  const int lx = x0 - H + sx, gx = col0 + lx;  // the thread's column
  const bool colin = gx >= 0 && gx < nxg;
  // The coefficient rows, 0 outside the domain (so dinv keeps those
  // rows of u at 0; the columns outside are masked by colin).
  if (threadIdx.x < RG::SH) {
    const int gy = gy0 + threadIdx.x;
    const bool in = gy >= 0 && gy < ny;
    C* d = crow + 8 * threadIdx.x;
    const C cc = in ? to_c(c.cc[gy]) : C(0);
    d[0] = cc;
    d[1] = in ? to_c(c.cs[gy]) : C(0);
    d[2] = in ? to_c(c.cn[gy]) : C(0);
    d[3] = in ? to_c(c.cw[gy]) : C(0);
    d[4] = in ? to_c(c.ce[gy]) : C(0);
    d[5] = in ? C(1) / cc : C(0);
    d[6] = C(0);
    d[7] = C(0);
  }

  // b into registers, the iterate (u + P e) into the shared buffer.
  C bq[RG::RS], pq[RG::RS], pe[RG::RS];
  if constexpr (CORRECT)
    prolong_strip<T, ROWS>(io.e, rb, gy0 + r0, gx, colin, nxc, pe);
  // ROWS: the thread's column of b and u, the block's or a halo's.
  const Column<T> bcol = ROWS ? b_column(rb, io.b, lx) : Column<T>{};
  const Column<T> ucol =
      ROWS && GUESS ? u_column(rb, io.u, lx) : Column<T>{};
#pragma unroll
  for (int i = 0; i < RG::RS; ++i) {
    const int sy = r0 + i, gy = gy0 + sy;
    C bv = C(0), uv = C(0);
    if (colin && gy >= 0 && gy < ny) {
      if constexpr (ROWS) {
        const int ly = y0 - H + sy;
        const T* bp = bcol.at(ly);
        if (bp != nullptr) {  // past the halos: never read, left 0
          bv = to_c(*bp);
          if (GUESS) uv = to_c(*ucol.at(ly));
          if (CORRECT) uv += pe[i];
        }
      } else {
        const size_t g = (size_t)gy * nx + gx;
        bv = CG ? to_c(io.b[g]) - alpha * to_c(io.ap[g]) : to_c(io.b[g]);
        if (GUESS) uv = to_c(io.u[g]);
        if (CORRECT) uv += pe[i];
      }
    }
    bq[i] = bv;
    pq[i] = C(0);
    cur[RG::at(sy, sx)] = uv;
  }
  __syncthreads();

  for (int s = 0; s < k; ++s) {
    const C a = steps[2 * s];
    const C bt = steps[2 * s + 1];
    if (!GUESS && s == 0) {  // u = 0: z = D^-1 b
#pragma unroll
      for (int i = 0; i < RG::RS; ++i) {
        const int sy = r0 + i;
        const C d = row5(crow + 8 * sy).dinv;
        pq[i] = a * (colin ? d * bq[i] : C(0));
        nxt[RG::at(sy, sx)] = pq[i];
      }
    } else {
      const C* q = cur + RG::at(r0, sx);
      C c0 = q[-RG::PW], c1 = q[0];
#pragma unroll
      for (int i = 0; i < RG::RS; ++i) {
        const C c2 = q[RG::PW];
        const Row5<C> kr = row5(crow + 8 * (r0 + i));
        const C z =
            colin ? kr.dinv * (bq[i] - apply5(kr, c1, c0, c2, q[-1], q[1]))
                  : C(0);
        pq[i] = bt * pq[i] + a * z;  // p = 0 before the first step
        nxt[RG::at(r0 + i, sx)] = c1 + pq[i];
        c0 = c1;
        c1 = c2;
        q += RG::PW;
      }
    }
    __syncthreads();
    C* t = cur;
    cur = nxt;
    nxt = t;
  }

  // The emits, each thread on its own points of the output tile (RC:
  // and the one more row / column of the restriction's footprint).
  const int tx = sx - H;
  const bool xt = tx >= 0 && tx < TX && lx < nx;
  const bool xf = tx >= 0 && tx <= TX;
  // The pad row and column are 0.
  const bool xin = !ROWS || gx < nxg;
  C acc = C(0);
  if constexpr (EMIT == EMIT_U) {
#pragma unroll
    for (int i = 0; i < RG::RS; ++i) {
      const int sy = r0 + i, ty = sy - H, ly = y0 + ty;
      if (!xt || ty < 0 || ty >= TY || ly >= R) continue;
      const bool in = xin && (!ROWS || row0 + ly < ny);
      const C uv = cur[RG::at(sy, sx)];
      put(io.u_out, (size_t)ly * nx + lx, in ? uv : C(0));
      if (DOT) acc += bq[i] * uv;
    }
  } else {
    const C* q = cur + RG::at(r0, sx);
    C c0 = q[-RG::PW], c1 = q[0];
#pragma unroll
    for (int i = 0; i < RG::RS; ++i) {
      const int sy = r0 + i, ty = sy - H, ly = y0 + ty;
      const C c2 = q[RG::PW];
      const C r =
          bq[i] - apply5(row5(crow + 8 * sy), c1, c0, c2, q[-1], q[1]);
      if (xt && ty >= 0 && ty < TY && ly < R) {
        const bool in = xin && (!ROWS || row0 + ly < ny);
        const size_t g = (size_t)ly * nx + lx;
        if (EMIT != EMIT_R) put(io.u_out, g, in ? c1 : C(0));
        if (EMIT != EMIT_RC) put(io.r_out, g, in ? r : C(0));
        if (CG) {
          put(io.rnew_out, g, bq[i]);
          acc += bq[i] * bq[i];
        }
      }
      // Residual into the free buffer on the restriction's footprint.
      if (EMIT == EMIT_RC && xf && ty >= 0 && ty <= TY)
        nxt[RG::at(sy, sx)] = gy0 + sy < ny && gx < nxg ? r : C(0);
      c0 = c1;
      c1 = c2;
      q += RG::PW;
    }
  }
  if constexpr (EMIT == EMIT_RC) {
    __syncthreads();
    // Full weighting, y pass first, then x (ops/transfer.restrict_fw); a
    // warp per coarse row, its lanes along the coarse columns.  A block's
    // coarse points at or past nyc or nxc (the global coarse pad row and
    // column) are 0.
    for (int cy = wid; cy < TY / 2; cy += RG::NT / 32) {
      const int I = y0 / 2 + cy;  // local coarse row
      if (I >= Rc) break;
      for (int cx = lane; cx < TX / 2; cx += 32) {
        const int J = x0 / 2 + cx;  // local coarse column
        if (J >= Cc) break;
        const C* f = nxt + RG::at(2 * cy + H, 2 * cx + H);  // (2I, 2J)
        C ycol[3];
        for (int d = 0; d < 3; ++d)
          ycol[d] = f[d] + C(2) * f[RG::PW + d] + f[2 * RG::PW + d];
        put(io.rc_out, (size_t)I * Cc + J,
            !ROWS || (row0 / 2 + I < nyc && col0 / 2 + J < nxc)
                ? C(0.0625) * (ycol[0] + C(2) * ycol[1] + ycol[2])
                : C(0));
      }
    }
  }
  if (CG || DOT) {
    const C sum = mg::block_sum<RG::NT>(acc, red);
    if (threadIdx.x == 0) io.part[blockIdx.y * gridDim.x + blockIdx.x] = sum;
  }
}

template <class T, bool GUESS, bool CORRECT, bool ROWS, class RG>
VisitFn<T, Coeffs<T>> pick_emit5(int emit, bool dot) {
  if (dot)  // DOT goes with emit u, on whole grids
    return emit == EMIT_U && !ROWS
               ? visit5_kernel<T, false, GUESS, CORRECT, EMIT_U, true, false,
                               RG>
               : nullptr;
  switch (emit) {
    case EMIT_U:
      return visit5_kernel<T, false, GUESS, CORRECT, EMIT_U, false, ROWS, RG>;
    case EMIT_UR:
      return visit5_kernel<T, false, GUESS, CORRECT, EMIT_UR, false, ROWS,
                           RG>;
    case EMIT_R:
      return visit5_kernel<T, false, GUESS, CORRECT, EMIT_R, false, ROWS, RG>;
    case EMIT_RC:
      return visit5_kernel<T, false, GUESS, CORRECT, EMIT_RC, false, ROWS,
                           RG>;
  }
  return nullptr;
}

// The instantiation for a flag set, or null for a set the family lacks
// (CG is the f32 zero-guess rc visit on a whole grid only; DOT goes with
// emit u on a whole grid only; a correction needs a guess).
template <class T, bool ROWS, class RG>
VisitFn<T, Coeffs<T>> pick_visit5(int flags) {
  const bool cg = flags & F_CG, guess = flags & F_GUESS;
  const bool correct = flags & F_CORRECT, dot = flags & F_DOT;
  const int emit = flags >> EMIT_SHIFT;
  if (cg) {
    if constexpr (std::is_same<T, float>::value && !ROWS)
      return (guess || correct || dot || emit != EMIT_RC)
                 ? nullptr
                 : visit5_kernel<T, true, false, false, EMIT_RC, false, false,
                                 RG>;
    return nullptr;
  }
  if (!guess)
    return correct ? nullptr
                   : pick_emit5<T, false, false, ROWS, RG>(emit, dot);
  return correct ? pick_emit5<T, true, true, ROWS, RG>(emit, dot)
                 : pick_emit5<T, true, false, ROWS, RG>(emit, dot);
}

// ---- The bf16 5-point step (visit5p_kernel): K17's bf16 row-block and
// 2-D block visits and the whole-grid bf16 visits (K2b, K3, K7, K9), as
// the rule below sends them.  bf16 is storage only, so the region holds
// f32 as in visit5_kernel, and the step's arithmetic is the same (apply5's
// term order; p = bt p + a z; u + p; one rounding per stored output).
// What held visit5_kernel back in bf16 was not its bytes: its loads, one
// 2-byte load a point behind per-row halo tests, were not issued ahead
// (78% of a k = 3 block's time was paid once), and its step issues ~17
// instructions a point (a shared load of the row below, two coefficient
// broadcasts, west and east, the store, ~10 floating-point operations)
// at ~1 instruction a cycle per scheduler.  So here:
//   * a thread owns a group of NC = 4 neighbouring columns (starting at an
//     even global column) of a strip of RS rows: u moves as one float4
//     (one shared load or store per group and row), b stays in registers
//     (f32), the group's inner neighbours are in registers, the outer ones
//     come from the lanes beside (__shfl_up / __shfl_down), and the
//     warp's edge columns from one shared load by every lane (lane 31's
//     east, the others a broadcast of lane 0's west: a lane-dependent
//     branch before the shuffles cost a reconvergence per row); the
//     coefficient row is one pair of broadcasts per group.  A step is ~10
//     floating-point operations a point plus ~9 / NC other instructions:
//     it is bound by the instructions it issues, not by bytes.  A region
//     whose columns all lie inside the domain steps without the column
//     masks.  NC = 2 (pairs) and 8-row strips of 256 threads measured
//     slower (scripts/time_5pt_visits.py --ab, variants pairs, quad8).
//   * the region's x-halo is HL = H rounded up to even (the tile TX = SW -
//     2 HL stays even), so every column pair (gx, gx + 1) of a group
//     starts at an even global column: it shares its coarse columns J -
//     1, J in the prolongation and never straddles a split axis's block
//     edge.
//   * a pair whose two columns lie in one buffer (the block, or one side
//     buffer) and inside the domain loads one __nv_bfloat162 where its
//     address is 4-byte aligned and two bf16 values where it is not (a
//     row stride of odd length -- every level is 2^m - 1 wide -- aligns
//     every other row); the test is on the address, per row.  Any other
//     pair (the domain's last column, a pair across the block's and a
//     side buffer's edge, or past the halos) reads each column on its own
//     (block_at).  Stores: a pair of outputs is one __nv_bfloat162 store
//     where aligned and both columns are written, else one or two.
//   * a strip whose rows all lie inside the block and the domain reads
//     them (and, to correct, its coarse rows) with no per-row test, so
//     its loads issue ahead; other strips resolve each row in the halo
//     buffers (Column::at).
//   * the residual is formed on the rows the emits read only.
// Region5P: GX warps of 32 * NC columns across, GY strips of RS rows
// down.  The region rule: a bf16-storage visit of H <= V5_PAIR_MAX_H takes
// it, on a block (K17) or a whole grid (K2b, K3: measured faster there
// too, scripts/time_5pt_visits.py); every visit the solves run (k = 3:
// H = 3..5) is one.  Larger halos keep visit5_kernel's regions (the tall
// one past V5_SHORT_MAX_H), so the sweep-count contract is unchanged.
template <int GX_, int GY_, int RS_, int NC_>
struct Region5P {
  static constexpr int GX = GX_;  // warps across
  static constexpr int GY = GY_;  // strips down a column group
  static constexpr int RS = RS_;  // rows of a strip
  static constexpr int NC = NC_;  // columns of a thread's group
  static constexpr int NT = 32 * GX * GY;
  static constexpr int SW = 32 * NC * GX, SH = RS * GY;
  // A u buffer: the region inside a ring NC columns wide at each side (so
  // a group's values are one aligned vector; columns -1 and SW are the
  // ones read) and one row above and below.
  static constexpr int PW = SW + 2 * NC;
  static constexpr int PN = (SH + 2) * PW;
  static __device__ __forceinline__ int at(int sy, int sx) {
    return (sy + 1) * PW + sx + NC;
  }
};
// Columns a thread owns, strips down a group of columns, their rows: a
// 64 x 128 region, 512 threads, two resident blocks (64 registers).
constexpr int V5P_NC = 4, V5P_GY = 16, V5P_RS = 4;
using V5Pair = Region5P<128 / (32 * V5P_NC), V5P_GY, V5P_RS, V5P_NC>;
constexpr int V5_PAIR_MAX_H = 8;
constexpr int V5P_MIN_BLOCKS = 2;  // resident blocks the registers are cut for

// The region's x-halo: H rounded up to even.
__host__ __device__ constexpr int v5p_xhalo(int H) { return H + (H & 1); }

template <class T>
constexpr bool v5_pair(int H) {
  return std::is_same<T, __nv_bfloat16>::value && H >= 1 &&
         H <= V5_PAIR_MAX_H;
}

inline dim3 visit5p_grid(int R, int nx, int H) {
  const int ty = V5Pair::SH - 2 * H, tx = V5Pair::SW - 2 * v5p_xhalo(H);
  return dim3((nx + tx - 1) / tx, (R + ty - 1) / ty);
}

constexpr size_t visit5p_smem_bytes() {
  return sizeof(float) *
         (8 * (size_t)V5Pair::SH + 2 * (size_t)V5Pair::PN + V5Pair::NT / 32);
}

__device__ __forceinline__ bool aligned4(const void* p) {
  return (reinterpret_cast<size_t>(p) & 3) == 0;
}

// Two neighbouring bf16 values from p: one 4-byte load where aligned.
__device__ __forceinline__ float2 ld_pair(const __nv_bfloat16* p) {
  if (aligned4(p))
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  return make_float2(__bfloat162float(p[0]), __bfloat162float(p[1]));
}

// Store the pair (x, y) at p (rounded once each): columns w0, w1 wanted.
__device__ __forceinline__ void put_pair(__nv_bfloat16* p, float x, float y,
                                         bool w0, bool w1) {
  if (w0 && w1 && aligned4(p)) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
  } else {
    if (w0) p[0] = __float2bfloat16_rn(x);
    if (w1) p[1] = __float2bfloat16_rn(y);
  }
}

// A group's NC values in shared memory, one aligned vector.
template <int NC>
__device__ __forceinline__ void ldv(const float* p, float (&x)[NC]) {
  if constexpr (NC == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x, x[1] = t.y;
  } else {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x, x[1] = t.y, x[2] = t.z, x[3] = t.w;
  }
}

template <int NC>
__device__ __forceinline__ void stv(float* p, const float (&x)[NC]) {
  if constexpr (NC == 2)
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  else
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

// The coarse correction of a pair's strip: RS fine rows from global row gy
// at the even global column gx (pe0) and gx + 1 (pe1).  Both columns read
// coarse column J = gx / 2 (the odd one alone, the even one with J - 1),
// so each coarse row is read once for the pair; otherwise prolong_strip's
// arithmetic, column by column.
template <class T, bool ROWS, int RS>
__device__ __forceinline__ void prolong_pair(const T* e, const Block<T>& rb,
                                             int gy, int gx, bool in0,
                                             int nxc, float (&pe0)[RS],
                                             float (&pe1)[RS]) {
  constexpr int NS = RS / 2 + 2;  // coarse rows (gy >> 1) - 1 on
  const int nyc = (rb.nyg - 1) / 2, J = gx >> 1, X0 = (gy >> 1) - 1;
  const bool p = gy & 1;
  float se[NS], so[NS];  // e[X][J - 1] + e[X][J], e[X][J]
  const Column<T> cj = ROWS ? e_column(rb, e, J - rb.col0 / 2) : Column<T>{};
  const Column<T> cjm =
      ROWS ? e_column(rb, e, J - 1 - rb.col0 / 2) : Column<T>{};
  // ROWS: all NS coarse rows inside the block, the domain and both
  // columns' buffers: read without a row test.
  const int L0 = X0 - rb.row0 / 2;
  if (ROWS && in0 && L0 >= 0 && L0 + NS <= rb.Rc && X0 + NS <= nyc &&
      J >= 1 && J < nxc && cj.mid != nullptr && cjm.mid != nullptr) {
    const T* q = cj.mid + (size_t)L0 * cj.ms;
    const T* qm = cjm.mid + (size_t)L0 * cjm.ms;
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      so[k] = to_c(q[(size_t)k * cj.ms]);
      se[k] = to_c(qm[(size_t)k * cjm.ms]) + so[k];
    }
  } else {
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      const int X = X0 + k;
      float a = 0.f, w = 0.f;
      if (in0 && X >= 0 && X < nyc) {
        if constexpr (ROWS) {
          const T* q = J < nxc ? cj.at(X - rb.row0 / 2) : nullptr;
          const T* qm = J >= 1 ? cjm.at(X - rb.row0 / 2) : nullptr;
          a = q != nullptr ? to_c(*q) : 0.f;
          w = qm != nullptr ? to_c(*qm) : 0.f;
        } else {
          const T* r = e + (size_t)X * nxc;
          a = J < nxc ? to_c(r[J]) : 0.f;
          w = J >= 1 ? to_c(r[J - 1]) : 0.f;
        }
      }
      so[k] = a;
      se[k] = w + a;
    }
  }
#pragma unroll
  for (int i = 0; i < RS; ++i) {
    const int lo = (i >> 1) + 1, hi = ((i + 1) >> 1) + 1;
    const int a = p ? hi : lo;
    if ((p + i) & 1) {  // odd fine row: coarse row I
      pe0[i] = se[a] * 0.5f;
      pe1[i] = so[a];
    } else {  // even: rows I - 1 and I
      pe0[i] = (se[a - 1] + se[a]) * 0.25f;
      pe1[i] = (so[a - 1] + so[a]) * 0.5f;
    }
  }
}

// The level visit on bf16 storage, a thread per column group of a strip
// (above); flags and emits as visit5_kernel's (no CG: the CG flag set is
// f32's).
template <class T, bool GUESS, bool CORRECT, int EMIT, bool DOT, bool ROWS>
__global__ void __launch_bounds__(V5Pair::NT, V5P_MIN_BLOCKS)
visit5p_kernel(Coeffs<T> c, VisitIO<T> io, Block<T> rb, int nx, int H,
               const float* __restrict__ steps, int k) {
  static_assert(std::is_same<T, __nv_bfloat16>::value, "bf16 storage");
  using RG = V5Pair;
  using C = float;
  constexpr int NC = RG::NC, NP = NC / 2, RS = RG::RS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  C* crow = reinterpret_cast<C*>(smem_raw);
  C* cur = crow + 8 * RG::SH;
  C* nxt = cur + RG::PN;
  C* red = nxt + RG::PN;
  const int ny = rb.nyg, nyc = (ny - 1) / 2;
  const int nxg = ROWS ? rb.nxg : nx, nxc = (nxg - 1) / 2;
  const int row0 = ROWS ? rb.row0 : 0, R = ROWS ? rb.R : ny;
  const int col0 = ROWS ? rb.col0 : 0;
  const int Rc = ROWS ? rb.Rc : nyc, Cc = ROWS ? rb.Cc : nxc;
  const int HL = v5p_xhalo(H);
  const int TY = RG::SH - 2 * H, TX = RG::SW - 2 * HL;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int sx = (wid % RG::GX) * 32 * NC + NC * lane;  // the group's first
  const int r0 = (wid / RG::GX) * RS;  // its strip's first row
  // The zero rings of both u buffers: the top and bottom rows, columns -1
  // and SW.
  for (int t = threadIdx.x; t < 2 * RG::PW + 2 * RG::SH; t += RG::NT) {
    const int i = t < RG::PW       ? t
                  : t < 2 * RG::PW ? (RG::SH + 1) * RG::PW + t - RG::PW
                                   : (1 + ((t - 2 * RG::PW) >> 1)) * RG::PW +
                                         ((t & 1) ? RG::SW + NC : NC - 1);
    cur[i] = 0.f;
    nxt[i] = 0.f;
  }

  const int y0 = blockIdx.y * TY, x0 = blockIdx.x * TX;  // local
  const int gy0 = row0 + y0 - H;                         // global
  const int lx = x0 - HL + sx, gx = col0 + lx;  // the group's first column
  bool in[NC];  // the group's columns inside the domain (gx is even)
#pragma unroll
  for (int j = 0; j < NC; ++j) in[j] = gx + j >= 0 && gx + j < nxg;
  if (threadIdx.x < RG::SH) {
    const int gy = gy0 + threadIdx.x;
    const bool inr = gy >= 0 && gy < ny;
    C* d = crow + 8 * threadIdx.x;
    const C cc = inr ? to_c(c.cc[gy]) : 0.f;
    d[0] = cc;
    d[1] = inr ? to_c(c.cs[gy]) : 0.f;
    d[2] = inr ? to_c(c.cn[gy]) : 0.f;
    d[3] = inr ? to_c(c.cw[gy]) : 0.f;
    d[4] = inr ? to_c(c.ce[gy]) : 0.f;
    d[5] = inr ? 1.f / cc : 0.f;
    d[6] = 0.f;
    d[7] = 0.f;
  }

  // b into registers, the iterate (u + P e) into the shared buffer, pair
  // by pair of the group.
  float bq[RS][NC], pq[RS][NC];
  {
    float uq[RS][NC];
    const int ly0 = y0 - H + r0, gyf = gy0 + r0;  // the strip's first row
    // The strip's rows all inside the block and the domain.
    const bool inside = gyf >= 0 && gyf + RS <= ny &&
                        (!ROWS || (ly0 >= 0 && ly0 + RS <= R));
    // Where a point lies (null: outside the domain or past the halos).
    auto where = [&](const T* m, bool b, int ly, int x) -> const T* {
      const int gy = row0 + ly;
      if (gy < 0 || gy >= ny || col0 + x < 0 || col0 + x >= nxg)
        return nullptr;
      if constexpr (ROWS)
        return b ? block_at(m, rb.b_top, rb.b_bot, rb.b_left, rb.b_right, ly,
                            x, R, rb.C, rb.hn, rb.hx)
                 : rb.u_at(m, ly, x);
      return m + (size_t)ly * nx + x;
    };
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int lp = lx + 2 * p, j0 = 2 * p;
      float pe0[RS], pe1[RS];
      if constexpr (CORRECT)
        prolong_pair<T, ROWS>(io.e, rb, gyf, gx + j0, in[j0], nxc, pe0, pe1);
      // A pair: both columns inside the domain and in one buffer.
      const bool pair =
          in[j0 + 1] && (!ROWS || (lp >= 0 && lp + 1 < rb.C) ||
                         (lp >= -rb.hx && lp + 1 < 0) ||
                         (lp >= rb.C && lp + 1 < rb.C + rb.hx));
      if (pair) {
        // ROWS: the pair's column of b and u in its buffer.
        const Column<T> bcol = ROWS ? b_column(rb, io.b, lp) : Column<T>{};
        const Column<T> ucol =
            ROWS && GUESS ? u_column(rb, io.u, lp) : Column<T>{};
        if (inside) {  // no row test: the loads issue ahead
          const T* bp = ROWS ? bcol.mid + (size_t)ly0 * bcol.ms
                             : io.b + (size_t)gyf * nx + gx + j0;
          const T* up = !GUESS ? nullptr
                        : ROWS ? ucol.mid + (size_t)ly0 * ucol.ms
                               : io.u + (size_t)gyf * nx + gx + j0;
          const size_t bs = ROWS ? bcol.ms : nx, us = ROWS ? ucol.ms : nx;
#pragma unroll
          for (int i = 0; i < RS; ++i) {
            const float2 bv = ld_pair(bp + i * bs);
            float2 uv = make_float2(0.f, 0.f);
            if (GUESS) uv = ld_pair(up + i * us);
            if (CORRECT) uv.x += pe0[i], uv.y += pe1[i];
            bq[i][j0] = bv.x, bq[i][j0 + 1] = bv.y;
            uq[i][j0] = uv.x, uq[i][j0 + 1] = uv.y;
          }
        } else {  // each row resolved in the halo buffers
#pragma unroll
          for (int i = 0; i < RS; ++i) {
            const int ly = ly0 + i, gy = gyf + i;
            const T* bp = gy < 0 || gy >= ny ? nullptr
                          : ROWS            ? bcol.at(ly)
                                            : io.b + (size_t)gy * nx + gx + j0;
            float2 bv = make_float2(0.f, 0.f), uv = make_float2(0.f, 0.f);
            if (bp != nullptr) {  // past the halos: never read, left 0
              bv = ld_pair(bp);
              if (GUESS)
                uv = ld_pair(ROWS ? ucol.at(ly)
                                  : io.u + (size_t)gy * nx + gx + j0);
              if (CORRECT) uv.x += pe0[i], uv.y += pe1[i];
            }
            bq[i][j0] = bv.x, bq[i][j0 + 1] = bv.y;
            uq[i][j0] = uv.x, uq[i][j0 + 1] = uv.y;
          }
        }
      } else {
        // Each column on its own.
#pragma unroll
        for (int i = 0; i < RS; ++i) {
#pragma unroll
          for (int j = j0; j < j0 + 2; ++j) {
            const T* bpj = where(io.b, true, ly0 + i, lx + j);
            float bv = 0.f, uv = 0.f;
            if (bpj != nullptr) {
              bv = to_c(*bpj);
              if (GUESS) uv = to_c(*where(io.u, false, ly0 + i, lx + j));
              if (CORRECT) uv += j == j0 ? pe0[i] : pe1[i];
            }
            bq[i][j] = bv;
            uq[i][j] = uv;
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RS; ++i) {
      stv<NC>(cur + RG::at(r0 + i, sx), uq[i]);
#pragma unroll
      for (int j = 0; j < NC; ++j) pq[i][j] = 0.f;
    }
  }
  __syncthreads();

  // West of the group's first column and east of its last: from the lanes
  // beside, the warp's edge lanes from shared memory.  One load by every
  // lane, with no branch before the shuffles (a lane-dependent branch
  // there costs a reconvergence per row): lane 31 reads column sx + NC,
  // every other lane lane 0's column sx - 1 (a broadcast), at qe.
  const int eoff = lane == 31 ? NC : -1 - NC * lane;
  auto sides = [&](const C* qe, float first, float last, float& w,
                   float& e) {
    const float wl = __shfl_up_sync(0xffffffffu, last, 1);
    const float er = __shfl_down_sync(0xffffffffu, first, 1);
    const float v = *qe;
    w = lane == 0 ? v : wl;
    e = lane == 31 ? v : er;
  };
  // (A u) at the group's columns of one row, c1, from the rows above (c0)
  // and below (c2); term order of the JAX package.
  auto apply_row = [&](const Row5<C>& kr, const float (&c0)[NC],
                       const float (&c1)[NC], const float (&c2)[NC], float w,
                       float e, float (&au)[NC]) {
#pragma unroll
    for (int j = 0; j < NC; ++j)
      au[j] = apply5(kr, c1[j], c0[j], c2[j], j ? c1[j - 1] : w,
                     j < NC - 1 ? c1[j + 1] : e);
  };
  // A region whose columns all lie inside the domain steps without the
  // column masks (the same for the whole block).
  const int gxr = col0 + x0 - HL;  // the region's first global column
  const bool allin = gxr >= 0 && gxr + RG::SW <= nxg;
  auto step = [&](auto masked, C a, C bt, const C* src, C* dst) {
    constexpr bool M = decltype(masked)::value;
    const C* q = src + RG::at(r0, sx);
    float c0[NC], c1[NC], c2[NC];
    ldv<NC>(q - RG::PW, c0);
    ldv<NC>(q, c1);
#pragma unroll
    for (int i = 0; i < RS; ++i) {
      ldv<NC>(q + (i + 1) * RG::PW, c2);
      const Row5<C> kr = row5(crow + 8 * (r0 + i));
      float w, e, au[NC], nv[NC];
      sides(q + i * RG::PW + eoff, c1[0], c1[NC - 1], w, e);
      apply_row(kr, c0, c1, c2, w, e, au);
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        C z = kr.dinv * (bq[i][j] - au[j]);
        if (M) z = in[j] ? z : 0.f;
        pq[i][j] = bt * pq[i][j] + a * z;  // p = 0 before the first step
        nv[j] = c1[j] + pq[i][j];
      }
      stv<NC>(dst + RG::at(r0 + i, sx), nv);
#pragma unroll
      for (int j = 0; j < NC; ++j) c0[j] = c1[j], c1[j] = c2[j];
    }
  };
  for (int s = 0; s < k; ++s) {
    const C a = steps[2 * s];
    const C bt = steps[2 * s + 1];
    if (!GUESS && s == 0) {  // u = 0: z = D^-1 b
#pragma unroll
      for (int i = 0; i < RS; ++i) {
        const C d = crow[8 * (r0 + i) + 5];
#pragma unroll
        for (int j = 0; j < NC; ++j)
          pq[i][j] = a * (in[j] ? d * bq[i][j] : 0.f);
        stv<NC>(nxt + RG::at(r0 + i, sx), pq[i]);
      }
    } else if (allin) {
      step(std::false_type{}, a, bt, cur, nxt);
    } else {
      step(std::true_type{}, a, bt, cur, nxt);
    }
    __syncthreads();
    C* t = cur;
    cur = nxt;
    nxt = t;
  }

  // The emits, each thread on its own pairs of the output tile (RC: and
  // the restriction's one more row / column), pair by pair: a pair starts
  // at an even tile column, and the tile's width is even, so it lies
  // wholly in or out of the tile.
  bool wo[NC];  // columns written
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int tx = sx + (j & ~1) - HL;
    wo[j] = tx >= 0 && tx < TX && lx + j < nx;
  }
  // The pad column is 0 (a block's; a whole grid has none).
  bool xin[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) xin[j] = !ROWS || gx + j < nxg;
  C acc = 0.f;
  if constexpr (EMIT == EMIT_U) {
#pragma unroll
    for (int i = 0; i < RS; ++i) {
      const int sy = r0 + i, ty = sy - H, ly = y0 + ty;
      if (ty < 0 || ty >= TY || ly >= R) continue;
      const bool inr = !ROWS || row0 + ly < ny;
      float uv[NC];
      ldv<NC>(cur + RG::at(sy, sx), uv);
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const int j = 2 * p;
        if (!wo[j]) continue;
        put_pair(io.u_out + (size_t)ly * nx + lx + j,
                 inr && xin[j] ? uv[j] : 0.f,
                 inr && xin[j + 1] ? uv[j + 1] : 0.f, wo[j], wo[j + 1]);
        if (DOT) {
          acc += bq[i][j] * uv[j];
          if (wo[j + 1]) acc += bq[i][j + 1] * uv[j + 1];
        }
      }
    }
  } else {
    const C* q = cur + RG::at(r0, sx);
    float c0[NC], c1[NC], c2[NC];
    ldv<NC>(q - RG::PW, c0);
    ldv<NC>(q, c1);
#pragma unroll
    for (int i = 0; i < RS; ++i) {
      const int sy = r0 + i, ty = sy - H, ly = y0 + ty;
      ldv<NC>(q + (i + 1) * RG::PW, c2);
      // Only the tile's rows (RC: and the restriction's one more) need a
      // residual; the test is the same for the whole warp.
      if (ty >= 0 && (EMIT == EMIT_RC ? ty <= TY : ty < TY && ly < R)) {
        const Row5<C> kr = row5(crow + 8 * sy);
        float w, e, au[NC], r[NC];
        sides(q + i * RG::PW + eoff, c1[0], c1[NC - 1], w, e);
        apply_row(kr, c0, c1, c2, w, e, au);
#pragma unroll
        for (int j = 0; j < NC; ++j) r[j] = bq[i][j] - au[j];
        if (ty < TY && ly < R) {
          const bool inr = !ROWS || row0 + ly < ny;
#pragma unroll
          for (int p = 0; p < NP; ++p) {
            const int j = 2 * p;
            if (!wo[j]) continue;
            const size_t g = (size_t)ly * nx + lx + j;
            const bool i0 = inr && xin[j], i1 = inr && xin[j + 1];
            if (EMIT != EMIT_R)
              put_pair(io.u_out + g, i0 ? c1[j] : 0.f, i1 ? c1[j + 1] : 0.f,
                       wo[j], wo[j + 1]);
            if (EMIT != EMIT_RC)
              put_pair(io.r_out + g, i0 ? r[j] : 0.f, i1 ? r[j + 1] : 0.f,
                       wo[j], wo[j + 1]);
          }
        }
        // The residual into the free buffer (the restriction reads its
        // footprint), 0 on the global pad row and column.
        if (EMIT == EMIT_RC) {
          const bool iy = gy0 + sy < ny;
#pragma unroll
          for (int j = 0; j < NC; ++j) r[j] = iy && gx + j < nxg ? r[j] : 0.f;
          stv<NC>(nxt + RG::at(sy, sx), r);
        }
      }
#pragma unroll
      for (int j = 0; j < NC; ++j) c0[j] = c1[j], c1[j] = c2[j];
    }
  }
  if constexpr (EMIT == EMIT_RC) {
    __syncthreads();
    // Full weighting, y pass first, then x (ops/transfer.restrict_fw), as
    // visit5_kernel: a warp per coarse row, its lanes along the coarse
    // columns; the coarse pad row and column are 0.
    for (int cy = wid; cy < TY / 2; cy += RG::NT / 32) {
      const int I = y0 / 2 + cy;  // local coarse row
      if (I >= Rc) break;
      for (int cx = lane; cx < TX / 2; cx += 32) {
        const int J = x0 / 2 + cx;  // local coarse column
        if (J >= Cc) break;
        const C* f = nxt + RG::at(2 * cy + H, 2 * cx + HL);  // (2I, 2J)
        C ycol[3];
        for (int d = 0; d < 3; ++d)
          ycol[d] = f[d] + 2.f * f[RG::PW + d] + f[2 * RG::PW + d];
        put(io.rc_out, (size_t)I * Cc + J,
            !ROWS || (row0 / 2 + I < nyc && col0 / 2 + J < nxc)
                ? 0.0625f * (ycol[0] + 2.f * ycol[1] + ycol[2])
                : 0.f);
      }
    }
  }
  if (DOT) {
    const C sum = mg::block_sum<RG::NT>(acc, red);
    if (threadIdx.x == 0) io.part[blockIdx.y * gridDim.x + blockIdx.x] = sum;
  }
}

template <class T, bool GUESS, bool CORRECT, bool ROWS>
VisitFn<T, Coeffs<T>> pick_emit5p(int emit, bool dot) {
  if (dot)  // DOT goes with emit u, on whole grids
    return emit == EMIT_U && !ROWS
               ? visit5p_kernel<T, GUESS, CORRECT, EMIT_U, true, false>
               : nullptr;
  switch (emit) {
    case EMIT_U:
      return visit5p_kernel<T, GUESS, CORRECT, EMIT_U, false, ROWS>;
    case EMIT_UR:
      return visit5p_kernel<T, GUESS, CORRECT, EMIT_UR, false, ROWS>;
    case EMIT_R:
      return visit5p_kernel<T, GUESS, CORRECT, EMIT_R, false, ROWS>;
    case EMIT_RC:
      return visit5p_kernel<T, GUESS, CORRECT, EMIT_RC, false, ROWS>;
  }
  return nullptr;
}

// visit5p_kernel's instantiation for a flag set (pick_visit5's family
// without CG), or null.
template <class T, bool ROWS>
VisitFn<T, Coeffs<T>> pick_visit5p(int flags) {
  const bool guess = flags & F_GUESS, correct = flags & F_CORRECT;
  const bool dot = flags & F_DOT;
  const int emit = flags >> EMIT_SHIFT;
  if (flags & F_CG) return nullptr;
  if (!guess)
    return correct ? nullptr : pick_emit5p<T, false, false, ROWS>(emit, dot);
  return correct ? pick_emit5p<T, true, true, ROWS>(emit, dot)
                 : pick_emit5p<T, true, false, ROWS>(emit, dot);
}

// ---- The 9-point visit (K13, K14, K17's 9-point blocks): its own kernel.
//
// A 9-point step reads 8 neighbours and up to 10 coefficients per point,
// so once the region is in shared memory the visit is bound by the
// instructions it issues and their latency, not by bytes; a per-point loop
// over a tile pays a shared load for each of them, an index division and
// two barriers per step.  The 9-point visit takes the 5-point visit's
// strip form (above) with a 3 x 3 window and its coefficients' shapes.
// Each block owns a fixed V9_SH x V9_SW region
// (the output tile plus its halo H on every side: the tile is
// (V9_SH - 2H) x (V9_SW - 2H), so its size follows the sweep count and
// the region never changes), and each thread owns a vertical strip of
// V9_RS points of one column of it for the whole visit:
//   * b and p of its points live in registers, read / formed once;
//   * only the iterate u is shared, double-buffered, so a step is one
//     barrier: read the current buffer, write the next; each buffer has
//     a ring of zeros around the region, so no read needs a bounds test;
//   * a step walks the strip top to bottom with a 3 x 3 window of u in
//     registers, so each point loads 3 new values (its row below at
//     x - 1, x, x + 1), and the lanes of a warp take 32 neighbouring
//     columns of the same rows, so every shared access is conflict-free
//     (a coefficient that varies only with y is one broadcast);
//   * coefficients that do not vary with y (the anisotropic stencil's
//     corners, cw and ce) are read once per visit into registers; the
//     anisotropic stencil's layout (cs, cn (ny, 1) columns, cc an (ny, nx)
//     field, the rest constant along y: ANISO) is compiled with its
//     strides, so a coefficient read is a shared load at a fixed offset;
//     any other layout reads every coefficient per point through its
//     run-time strides;
//   * no division: the thread's column and rows come from its warp and
//     lane, the coarse points of the restriction from a warp x lane grid.
// Shared memory per block is the two u buffers plus the staged
// coefficients, independent of H (f32: 68 KB for the anisotropic stencil;
// registers allow two to three blocks per SM); the sweep count is bounded
// by the tile instead (2H <= V9_SH - 2: 29 steps with emit rc), mirrored
// by the wrappers (mdma_kernel.py visit_fits).  Loads are plain coalesced
// loads: staging the coefficients with cp.async was no faster on the
// anisotropic stencil (it took the zero-guess rc visit from 76 to 96
// registers, two resident blocks instead of three), though what a block
// pays once is ~83% of its time at k = 3 (scripts/time_9pt_visits.py).
// Registers per thread (f32, the anisotropic layout; `-Xptxas -v` in the
// build log): 72-128, no spills; the other layouts' instantiations spill
// at the 128 cap, off the main path.
constexpr int V9_RS = 16;  // rows of a thread's strip
constexpr int V9_GX = 2;   // 32-column groups of a region
constexpr int V9_GY = 4;   // strips down a region's column
constexpr int V9_NT = 32 * V9_GX * V9_GY;  // threads per block
constexpr int V9_SW = 32 * V9_GX;          // region width
constexpr int V9_SH = V9_RS * V9_GY;       // region height
constexpr int V9_N = V9_SH * V9_SW;
// A u buffer: the region inside a ring of zeros, so that a step reads its
// neighbours without a bounds test.
constexpr int V9_PW = V9_SW + 2;
constexpr int V9_PN = (V9_SH + 2) * V9_PW;

// Region point (sy, sx) in a u buffer.
__device__ __forceinline__ int v9_at(int sy, int sx) {
  return (sy + 1) * V9_PW + sx + 1;
}

// The output tile of a region with halo H (each side even).
__host__ __device__ constexpr int v9_tile(int extent, int H) {
  return extent - 2 * H;
}

inline bool visit9_fits(int H) {
  return H >= 1 && v9_tile(V9_SH, H) >= 2 && v9_tile(V9_SW, H) >= 2;
}

inline dim3 visit9_grid(int R, int nx, int H) {
  const int ty = v9_tile(V9_SH, H), tx = v9_tile(V9_SW, H);
  return dim3((nx + tx - 1) / tx, (R + ty - 1) / ty);
}

// The anisotropic stencil's layout: cs and cn (ny, 1) columns, cc an
// (ny, nx) field, every other coefficient constant along y.
template <class T>
bool aniso_layout(const Coeffs9<T>& c) {
  for (int q = 0; q < 9; ++q) {
    const bool col = q == mg::CS || q == mg::CN;
    if (col && !(c.sy[q] && !c.sx[q])) return false;
    if (q == mg::CC && !(c.sy[q] && c.sx[q])) return false;
    if (!col && q != mg::CC && c.sy[q]) return false;
  }
  return true;
}

// Stage the coefficients for a region, each in its own shape (as stage()
// above: entry q at base + sy * ys[q] + sx * xs[q]), without a division:
// a field point by point along the threads' strips, a column or a row by
// the first V9_SH or V9_SW threads.  Zero outside the domain and at or
// past row yend or column xend (see row_end, col_end); dinv guards a zero
// cc as the JAX kernel does.
template <class T>
__device__ Tile9<compute_t<T>> stage9(const Coeffs9<T>& c,
                                      compute_t<T>* base, int sx, int r0,
                                      int gy0, int gx0, int yend, int xend) {
  using C = compute_t<T>;
  Tile9<C> t;
#pragma unroll 1
  for (int q = 0; q < 10; ++q) {
    const int src = q < 9 ? q : mg::CC;
    const int gys = c.sy[src], gxs = c.sx[src];
    t.c[q] = base;
    t.ys[q] = gys ? (gxs ? V9_SW : 1) : 0;
    t.xs[q] = gxs ? 1 : 0;
    auto val = [&](int gy, int gx) -> C {
      const bool in = (!gys || (gy >= 0 && gy < yend)) &&
                      (!gxs || (gx >= 0 && gx < xend));
      if (!in) return C(0);
      const C v = to_c(c.p[src][(gys ? (size_t)(gy - c.oy) * gys : 0) +
                                (gxs ? (size_t)(gx - c.ox) * gxs : 0)]);
      return q == 9 ? (v == C(0) ? C(1) : C(1) / v) : v;
    };
    if (gys && gxs) {
      for (int i = 0; i < V9_RS; ++i)
        base[(r0 + i) * V9_SW + sx] = val(gy0 + r0 + i, gx0 + sx);
      base += V9_N;
    } else if (gys) {
      if (threadIdx.x < V9_SH) base[threadIdx.x] = val(gy0 + threadIdx.x, 0);
      base += V9_SH;
    } else if (gxs) {
      if (threadIdx.x < V9_SW) base[threadIdx.x] = val(0, gx0 + threadIdx.x);
      base += V9_SW;
    } else {
      if (threadIdx.x == 0) base[0] = val(0, 0);
      base += 1;
    }
  }
  return t;
}

// A thread's view of the staged coefficients at its column: coefficient
// q at region row sy.  ANISO: cs and cn from their staged columns, cc and
// its inverse from their staged fields, at offsets fixed at compile time
// but for the thread's column; the others held in registers (read once,
// after staging).  Otherwise every coefficient from shared memory through
// its run-time strides (offsets from the shared base, so the address
// stays 32-bit).
template <bool ANISO, class C>
struct Strip9 {
  const C* base;
  int o[10];
  int ys[10];
  C h[10];

  static __device__ __forceinline__ bool held(int q) {
    return ANISO && q != mg::CS && q != mg::CN && q != mg::CC && q != 9;
  }
  __device__ Strip9(const C* smem, const Tile9<C>& t, int sx) : base(smem) {
#pragma unroll
    for (int q = 0; q < 10; ++q) {
      o[q] = (int)(t.c[q] - smem) + sx * t.xs[q];
      ys[q] = t.ys[q];
      h[q] = held(q) ? smem[o[q]] : C(0);
    }
  }
  __device__ __forceinline__ C at(int q, int sy) const {
    if (!ANISO) return base[o[q] + sy * ys[q]];
    if (held(q)) return h[q];
    const bool field = q == mg::CC || q == 9;
    return base[o[q] + sy * (field ? V9_SW : 1)];
  }
  // (A v) at row sy from the window of v: rows sy - 1 (0), sy (1),
  // sy + 1 (2) at columns x - 1 (w), x (c), x + 1 (e); term order of the
  // JAX package: cc, s, n, w, e, sw, se, nw, ne.
  __device__ __forceinline__ C apply(int sy, C w0, C c0, C e0, C w1, C c1,
                                     C e1, C w2, C c2, C e2) const {
    return at(mg::CC, sy) * c1 + at(mg::CS, sy) * c0 + at(mg::CN, sy) * c2 +
           at(mg::CW, sy) * w1 + at(mg::CE, sy) * e1 + at(mg::CSW, sy) * w0 +
           at(mg::CSE, sy) * e0 + at(mg::CNW, sy) * w2 +
           at(mg::CNE, sy) * e2;
  }
};

// Resident blocks per SM the register budget is cut for: two in the f32
// compute type (up to 128 registers a thread: b and p of 16 points, the
// window, the coefficients held), one in f64 (its tiles take twice that).
template <class C>
constexpr int v9_min_blocks() {
  return sizeof(C) == 8 ? 1 : 2;
}

template <class T>
size_t visit9_smem_bytes(const Coeffs9<T>& c) {
  return sizeof(compute_t<T>) *
         (2 * (size_t)V9_PN + coeff_elems(c, V9_SH, V9_SW) + V9_NT / 32);
}

// The 9-point level visit: [u + P e] -> k steps -> the emits, with the
// flags, emits and ROWS mode of visit5_kernel (no CG).
template <class T, bool GUESS, bool CORRECT, int EMIT, bool DOT, bool ROWS,
          bool ANISO>
__global__ void __launch_bounds__(V9_NT, v9_min_blocks<compute_t<T>>())
visit9_kernel(Coeffs9<T> c, VisitIO<T> io, Block<T> rb, int nx, int H,
              const compute_t<T>* __restrict__ steps, int k) {
  using C = compute_t<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  C* cur = reinterpret_cast<C*>(smem_raw);
  C* nxt = cur + V9_PN;
  C* red = nxt + V9_PN + coeff_elems(c, V9_SH, V9_SW);
  const int ny = rb.nyg, nyc = (ny - 1) / 2;
  const int nxg = ROWS ? rb.nxg : nx, nxc = (nxg - 1) / 2;
  const int row0 = ROWS ? rb.row0 : 0, R = ROWS ? rb.R : ny;
  const int col0 = ROWS ? rb.col0 : 0;
  const int Rc = ROWS ? rb.Rc : nyc, Cc = ROWS ? rb.Cc : nxc;
  const int TY = v9_tile(V9_SH, H), TX = v9_tile(V9_SW, H);
  const int y0 = blockIdx.y * TY, x0 = blockIdx.x * TX;  // local
  const int gy0 = row0 + y0 - H, gx0 = col0 + x0 - H;    // global
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int sx = (wid % V9_GX) * 32 + lane;  // the thread's region column
  const int r0 = (wid / V9_GX) * V9_RS;      // its strip's first row
  const int gx = gx0 + sx, lx = gx - col0;  // the thread's column
  const bool colin = gx >= 0 && gx < nxg;
  const Tile9<C> tile = stage9(c, nxt + V9_PN, sx, r0, gy0, gx0,
                               row_end<T, ROWS>(rb), col_end<T, ROWS>(rb));
  // The zero rings of both u buffers.
  for (int t = threadIdx.x; t < 2 * V9_PW + 2 * V9_SH; t += V9_NT) {
    const int i = t < V9_PW       ? t
                  : t < 2 * V9_PW ? (V9_SH + 1) * V9_PW + t - V9_PW
                                  : (1 + ((t - 2 * V9_PW) >> 1)) * V9_PW +
                                        (t & 1) * (V9_PW - 1);
    cur[i] = C(0);
    nxt[i] = C(0);
  }

  // b into registers, the iterate (u + P e) into the shared buffer.
  C bq[V9_RS], pq[V9_RS];
  unsigned inmask = 0;  // bit i: the strip's point i lies in the domain
  // ROWS: the thread's column of b and u, and its coarse columns gx / 2
  // and gx / 2 - 1 of e, the block's or a halo's.
  const Column<T> bcol = ROWS ? b_column(rb, io.b, lx) : Column<T>{};
  const Column<T> ucol =
      ROWS && GUESS ? u_column(rb, io.u, lx) : Column<T>{};
  const int jc = (gx >> 1) - col0 / 2;
  const Column<T> ecj =
      ROWS && CORRECT ? e_column(rb, io.e, jc) : Column<T>{};
  const Column<T> ecjm =
      ROWS && CORRECT ? e_column(rb, io.e, jc - 1) : Column<T>{};
#pragma unroll
  for (int i = 0; i < V9_RS; ++i) {
    const int sy = r0 + i, gy = gy0 + sy;
    const bool in = colin && gy >= 0 && gy < ny;
    C bv = C(0), uv = C(0);
    if (in) {
      if constexpr (ROWS) {
        const int ly = y0 - H + sy;
        const T* bp = bcol.at(ly);
        if (bp != nullptr) {  // past the halos: never read, left 0
          bv = to_c(*bp);
          if (GUESS) uv = to_c(*ucol.at(ly));
          if (CORRECT) uv += prolong_block(ecj, ecjm, rb, gy, gx);
        }
      } else {
        const size_t g = (size_t)gy * nx + gx;
        bv = to_c(io.b[g]);
        if (GUESS) uv = to_c(io.u[g]);
        if (CORRECT) uv += mg::prolong_at(io.e, gy, gx, nyc, nxc);
      }
    }
    bq[i] = bv;
    pq[i] = C(0);
    cur[v9_at(sy, sx)] = uv;
    inmask |= (unsigned)in << i;
  }
  __syncthreads();
  const Strip9<ANISO, C> cf(reinterpret_cast<const C*>(smem_raw), tile, sx);

  // Row sy of v at columns x - 1, x, x + 1 (the ring: zero past the
  // region).
  auto row3 = [&](const C* v, int sy, C& w, C& m, C& e) {
    const C* q = v + v9_at(sy, sx);
    w = q[-1];
    m = q[0];
    e = q[1];
  };

  for (int s = 0; s < k; ++s) {
    const C a = steps[2 * s];
    const C bt = steps[2 * s + 1];
    if (!GUESS && s == 0) {  // u = 0: z = D^-1 b
#pragma unroll
      for (int i = 0; i < V9_RS; ++i) {
        const int sy = r0 + i;
        // ANISO: cc's inverse is staged 0 outside the domain, as is b.
        const C z =
            ANISO || (inmask >> i & 1) ? cf.at(9, sy) * bq[i] : C(0);
        pq[i] = a * z;
        nxt[v9_at(sy, sx)] = pq[i];
      }
    } else {
      C w0, c0, e0, w1, c1, e1, w2, c2, e2;
      row3(cur, r0 - 1, w0, c0, e0);
      row3(cur, r0, w1, c1, e1);
#pragma unroll
      for (int i = 0; i < V9_RS; ++i) {
        const int sy = r0 + i;
        row3(cur, sy + 1, w2, c2, e2);
        const C au = cf.apply(sy, w0, c0, e0, w1, c1, e1, w2, c2, e2);
        const C z = ANISO || (inmask >> i & 1)
                        ? cf.at(9, sy) * (bq[i] - au) : C(0);
        pq[i] = bt * pq[i] + a * z;  // p = 0 before the first step
        nxt[v9_at(sy, sx)] = c1 + pq[i];
        w0 = w1, c0 = c1, e0 = e1;
        w1 = w2, c1 = c2, e1 = e2;
      }
    }
    __syncthreads();
    C* t = cur;
    cur = nxt;
    nxt = t;
  }

  // The emits, each thread on its own points of the output tile (RC: and
  // the one more row / column of the restriction's footprint).
  const int tx = sx - H;
  const bool xt = tx >= 0 && tx < TX && lx < nx;
  const bool xin = !ROWS || gx < nxg;  // the pad column is written 0
  const bool xf = tx >= 0 && tx <= TX;  // RC: the footprint's columns
  C acc = C(0);
  if constexpr (EMIT == EMIT_U) {
#pragma unroll
    for (int i = 0; i < V9_RS; ++i) {
      const int sy = r0 + i, ty = sy - H, ly = y0 + ty;
      if (!xt || ty < 0 || ty >= TY || ly >= R) continue;
      const bool in = xin && (!ROWS || row0 + ly < ny);  // the pad row: 0
      const C uv = cur[v9_at(sy, sx)];
      put(io.u_out, (size_t)ly * nx + lx, in ? uv : C(0));
      if (DOT) acc += bq[i] * uv;
    }
  } else {
    C w0, c0, e0, w1, c1, e1, w2, c2, e2;
    row3(cur, r0 - 1, w0, c0, e0);
    row3(cur, r0, w1, c1, e1);
#pragma unroll
    for (int i = 0; i < V9_RS; ++i) {
      const int sy = r0 + i, ty = sy - H, ly = y0 + ty;
      row3(cur, sy + 1, w2, c2, e2);
      const C r = bq[i] - cf.apply(sy, w0, c0, e0, w1, c1, e1, w2, c2, e2);
      if (xt && ty >= 0 && ty < TY && ly < R) {
        const bool in = xin && (!ROWS || row0 + ly < ny);
        const size_t g = (size_t)ly * nx + lx;
        if (EMIT != EMIT_R) put(io.u_out, g, in ? c1 : C(0));
        if (EMIT != EMIT_RC) put(io.r_out, g, in ? r : C(0));
      }
      // Residual into the free buffer on the restriction's footprint.
      if (EMIT == EMIT_RC && xf && ty >= 0 && ty <= TY)
        nxt[v9_at(sy, sx)] = gy0 + sy < ny && gx < nxg ? r : C(0);
      w0 = w1, c0 = c1, e0 = e1;
      w1 = w2, c1 = c2, e1 = e2;
    }
  }
  if constexpr (EMIT == EMIT_RC) {
    __syncthreads();
    // Full weighting, y pass first, then x (ops/transfer.restrict_fw); a
    // warp per coarse row, a lane per coarse column.  A block's coarse
    // points at or past nyc or nxc (the global coarse pad row and column)
    // are 0.
    for (int cy = wid; cy < TY / 2; cy += V9_NT / 32) {
      const int cx = lane;
      const int I = y0 / 2 + cy, J = x0 / 2 + cx;  // local coarse point
      if (cx >= TX / 2 || I >= Rc || J >= Cc) continue;
      const C* f = nxt + v9_at(2 * cy + H, 2 * cx + H);  // fine (2I, 2J)
      C ycol[3];
      for (int d = 0; d < 3; ++d)
        ycol[d] = f[d] + C(2) * f[V9_PW + d] + f[2 * V9_PW + d];
      put(io.rc_out, (size_t)I * Cc + J,
          !ROWS || (row0 / 2 + I < nyc && col0 / 2 + J < nxc)
              ? C(0.0625) * (ycol[0] + C(2) * ycol[1] + ycol[2])
              : C(0));
    }
  }
  if (DOT) {
    const C sum = mg::block_sum<V9_NT>(acc, red);
    if (threadIdx.x == 0) io.part[blockIdx.y * gridDim.x + blockIdx.x] = sum;
  }
}

template <class T, bool GUESS, bool CORRECT, bool ROWS, bool ANISO>
VisitFn<T, Coeffs9<T>> pick_emit9(int emit, bool dot) {
  if (dot)  // DOT goes with emit u, on whole grids
    return emit == EMIT_U && !ROWS
               ? visit9_kernel<T, GUESS, CORRECT, EMIT_U, true, false, ANISO>
               : nullptr;
  switch (emit) {
    case EMIT_U:
      return visit9_kernel<T, GUESS, CORRECT, EMIT_U, false, ROWS, ANISO>;
    case EMIT_UR:
      return visit9_kernel<T, GUESS, CORRECT, EMIT_UR, false, ROWS, ANISO>;
    case EMIT_R:
      return visit9_kernel<T, GUESS, CORRECT, EMIT_R, false, ROWS, ANISO>;
    case EMIT_RC:
      return visit9_kernel<T, GUESS, CORRECT, EMIT_RC, false, ROWS, ANISO>;
  }
  return nullptr;
}

template <class T, bool ROWS, bool ANISO>
VisitFn<T, Coeffs9<T>> pick_visit9(int flags) {
  const bool guess = flags & F_GUESS, correct = flags & F_CORRECT;
  const bool dot = flags & F_DOT;
  const int emit = flags >> EMIT_SHIFT;
  if (flags & F_CG) return nullptr;
  if (!guess)
    return correct ? nullptr
                   : pick_emit9<T, false, false, ROWS, ANISO>(emit, dot);
  return correct ? pick_emit9<T, true, true, ROWS, ANISO>(emit, dot)
                 : pick_emit9<T, true, false, ROWS, ANISO>(emit, dot);
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

// K6 (RESID = false): y = A u; residual5 (RESID = true): y = b - A u; K8
// (Fields5) both.  The tile + 1-point halo of u in shared memory, as K1,
// with the coefficients staged after it.  ROWS (K17's emits a and r): a
// block (a row block or a 2-D block; nx its width), u's points past it
// from its 1-point halo buffers, b read on the block's own points only,
// the pad row and column written as 0.
template <class T, bool RESID, class K, bool ROWS>
__global__ void __launch_bounds__(NTHREADS)
stencil_kernel(K c, const T* __restrict__ b, const T* __restrict__ u,
               T* __restrict__ y, Block<T> rb, int nx) {
  using C = compute_t<T>;
  constexpr int SH = TY + 2, SW = TX + 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  C* us = reinterpret_cast<C*>(smem_raw);
  const int ny = rb.nyg, nxg = ROWS ? rb.nxg : nx;
  const int row0 = ROWS ? rb.row0 : 0, R = ROWS ? rb.R : ny;
  const int col0 = ROWS ? rb.col0 : 0;
  const int y0 = blockIdx.y * TY, x0 = blockIdx.x * TX;  // local
  const int gy0 = row0 + y0 - 1, gx0 = col0 + x0 - 1;    // global
  const auto rc =
      stage(c, us + SH * SW, SH, SW, gy0, gx0, row_end<T, ROWS>(rb), nxg);
  for (int i = threadIdx.x; i < SH * SW; i += NTHREADS) {
    int sy = i / SW, sx = i - (i / SW) * SW;
    int gy = gy0 + sy, gx = gx0 + sx;
    C v = C(0);
    if (gy >= 0 && gy < ny && gx >= 0 && gx < nxg) {
      if constexpr (ROWS) {
        const T* p = rb.u_at(u, y0 - 1 + sy, x0 - 1 + sx);
        if (p != nullptr) v = to_c(*p);
      } else {
        v = to_c(u[(size_t)gy * nx + gx]);
      }
    }
    us[i] = v;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < TY * TX; t += NTHREADS) {
    int ty = t / TX, tx = t - (t / TX) * TX;
    int ly = y0 + ty, lx = x0 + tx;  // a whole grid's (ly, lx): (gy, gx)
    if (ly >= R || lx >= nx) continue;
    C a = apply_at(us, rc, ty + 1, tx + 1, SH, SW);
    size_t g = (size_t)ly * nx + lx;
    put(y, g, !ROWS || (row0 + ly < ny && col0 + lx < nxg)
                  ? (RESID ? to_c(b[g]) - a : a) : C(0));
  }
}

// ---- K12 (and K17's 9-point emits a and r): y = A u (RESID false) or
// y = b - A u, 9-point, in the strip form of the visits.  A warp owns 32
// neighbouring columns and a thread walks A9_RS rows of its column with a
// 3 x 3 window of u in registers: each row of u is read from device memory
// once, at the thread's column, its west and east from the lanes beside
// (the warp's edge lanes read them).  Nothing is staged: a coefficient
// constant along y (a scalar or a (1, nx) row) is read once into a
// register, one that varies with y at the point that uses it (an (ny, 1)
// column as a broadcast, an (ny, nx) field coalesced), so no dinv and no
// division.  Two layouts compile their strides: SCALAR (all nine scalars,
// the constant-coefficient stencil) and ANISO (aniso_layout, the
// anisotropic problem's); any other goes through run-time strides.
constexpr int A9_RS = 16;  // rows a thread walks
constexpr int A9_GX = 2;   // 32-column groups of a block
constexpr int A9_GY = 4;   // strips down a block's column
constexpr int A9_NT = 32 * A9_GX * A9_GY;
constexpr int A9_TX = 32 * A9_GX, A9_TY = A9_RS * A9_GY;  // a block's tile
enum Layout9 { L9_ANY = 0, L9_SCALAR = 1, L9_ANISO = 2 };

template <class T>
Layout9 layout9(const Coeffs9<T>& c) {
  bool scalar = true;
  for (int q = 0; q < 9; ++q) scalar = scalar && !c.sy[q] && !c.sx[q];
  return scalar ? L9_SCALAR : aniso_layout(c) ? L9_ANISO : L9_ANY;
}

template <int LAYOUT>
__host__ __device__ constexpr bool yvar9(int q, int sy) {
  return LAYOUT == L9_SCALAR  ? false
         : LAYOUT == L9_ANISO ? q == mg::CS || q == mg::CN || q == mg::CC
                              : sy != 0;
}

template <class T, bool RESID, bool ROWS, int LAYOUT>
__global__ void __launch_bounds__(A9_NT)
apply9_kernel(Coeffs9<T> c, const T* __restrict__ b,
              const T* __restrict__ u, T* __restrict__ y, Block<T> rb,
              int nx) {
  using C = compute_t<T>;
  const int ny = rb.nyg, nxg = ROWS ? rb.nxg : nx;
  const int row0 = ROWS ? rb.row0 : 0, R = ROWS ? rb.R : ny;
  const int col0 = ROWS ? rb.col0 : 0;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int xw = blockIdx.x * A9_TX + (wid % A9_GX) * 32;  // warp's column 0
  const int ly0 = blockIdx.y * A9_TY + (wid / A9_GX) * A9_RS;  // local row
  if (xw >= nx || ly0 >= R) return;  // the whole warp
  const int gx = xw + lane;  // local column (a whole grid's: global)
  const int gxg = col0 + gx;  // global column
  const bool colin = gx < nx, xin = colin && gxg < nxg;
  C h[9];  // the coefficients constant along y, at the thread's column
#pragma unroll
  for (int q = 0; q < 9; ++q)
    h[q] = !yvar9<LAYOUT>(q, c.sy[q]) && xin
               ? to_c(c.p[q][(size_t)(gxg - c.ox) * c.sx[q]]) : C(0);
  auto coef = [&](int q, int gy) -> C {
    if (!yvar9<LAYOUT>(q, c.sy[q])) return h[q];
    const size_t r = (size_t)(gy - c.oy);
    if constexpr (LAYOUT == L9_ANISO) {
      if constexpr (ROWS)
        return to_c(c.p[q][q == mg::CC ? r * c.sy[q] + (gxg - c.ox) : r]);
      return to_c(c.p[q][q == mg::CC ? r * nx + gx : r]);
    }
    return to_c(c.p[q][r * c.sy[q] + (size_t)(gxg - c.ox) * c.sx[q]]);
  };
  // The strip's rows of u at the thread's column, and the column beside
  // for the warp's edge lanes (lane 0 its west, lane 31 its east), all
  // loaded before the arithmetic; 0 outside the domain and past a block's
  // halos (a 2-D block's lanes past its width load its right halo, which
  // their west neighbours read).
  C m[A9_RS + 2], x[A9_RS + 2];
  const int xs = lane == 0 ? gx - 1 : gx + 1;
  const bool edge = lane == 0 || lane == 31;
  // ROWS: the thread's column and the edge lanes' column beside it.
  const Column<T> ucol = ROWS ? u_column(rb, u, gx) : Column<T>{};
  const Column<T> xcol = ROWS && edge ? u_column(rb, u, xs) : Column<T>{};
#pragma unroll
  for (int i = 0; i < A9_RS + 2; ++i) {
    const int ly = ly0 - 1 + i, gy = row0 + ly;
    if constexpr (ROWS) {
      auto at = [&](const Column<T>& col, int lx) -> C {
        const int g = col0 + lx;
        if (gy < 0 || gy >= ny || g < 0 || g >= nxg) return C(0);
        const T* p = col.at(ly);
        return p != nullptr ? to_c(*p) : C(0);
      };
      m[i] = at(ucol, gx);
      x[i] = edge ? at(xcol, xs) : C(0);
    } else {
      const T* p = gy >= 0 && gy < ny ? u + (size_t)ly * nx : nullptr;
      m[i] = p != nullptr && colin ? to_c(p[gx]) : C(0);
      x[i] = p != nullptr && edge && xs >= 0 && xs < nx ? to_c(p[xs])
                                                         : C(0);
    }
  }
  auto west = [&](int i) {
    const C w = __shfl_up_sync(0xffffffffu, m[i], 1);
    return lane == 0 ? x[i] : w;
  };
  auto east = [&](int i) {
    const C e = __shfl_down_sync(0xffffffffu, m[i], 1);
    return lane == 31 ? x[i] : e;
  };
  const int n = min(A9_RS, R - ly0);  // the same for the whole warp
  C w0 = west(0), e0 = east(0), w1 = west(1), e1 = east(1);
#pragma unroll
  for (int i = 0; i < A9_RS; ++i) {
    const int ly = ly0 + i, gy = row0 + ly;
    const C w2 = west(i + 2), e2 = east(i + 2);
    if (colin && i < n) {
      const size_t g = (size_t)ly * nx + gx;
      C out = C(0);  // the pad row and column of a block are written 0
      if (!ROWS || (gy < ny && gxg < nxg)) {
        // Term order of the JAX package: cc, s, n, w, e, sw, se, nw, ne.
        const C a = coef(mg::CC, gy) * m[i + 1] + coef(mg::CS, gy) * m[i] +
                    coef(mg::CN, gy) * m[i + 2] + coef(mg::CW, gy) * w1 +
                    coef(mg::CE, gy) * e1 + coef(mg::CSW, gy) * w0 +
                    coef(mg::CSE, gy) * e0 + coef(mg::CNW, gy) * w2 +
                    coef(mg::CNE, gy) * e2;
        out = RESID ? to_c(b[g]) - a : a;
      }
      put(y, g, out);
    }
    w0 = w1, e0 = e1;
    w1 = w2, e1 = e2;
  }
}

inline dim3 visit_grid(int ny, int nx) {
  return dim3((nx + TX - 1) / TX, (ny + TY - 1) / TY);
}

// A block needs halo buffers that hold the visit's halo H, and H / 2 + 1
// coarse rows (and columns) to correct: a row block hn >= H rows (at most
// its R: rows come from the immediate neighbours only); a 2-D block (hx >
// 0) also hx >= H columns.
template <class T, bool ROWS>
bool block_ok(const Block<T>& rb, int H, int flags) {
  if (!ROWS) return true;
  const bool correct = flags & F_CORRECT, two_d = rb.hx > 0;
  if (!two_d)
    return H <= rb.hn && H <= rb.R && rb.C == rb.nxg && rb.col0 == 0 &&
           (!correct || rb.hc >= H / 2 + 1);
  return H <= rb.hn && H <= rb.hx &&
         (!correct || (rb.hc >= H / 2 + 1 && rb.hcx >= H / 2 + 1));
}

template <class T, bool ROWS>
int launch_visit9(const Coeffs9<T>& c, const VisitIO<T>& io,
                  const Block<T>& rb, int nx, const compute_t<T>* steps,
                  int k, int flags, void* stream) {
  VisitFn<T, Coeffs9<T>> kern = aniso_layout(c)
                                     ? pick_visit9<T, ROWS, true>(flags)
                                     : pick_visit9<T, ROWS, false>(flags);
  if (kern == nullptr || k < 1) return (int)cudaErrorInvalidValue;
  const int H = halo(flags >> EMIT_SHIFT, k);
  if (!visit9_fits(H) || !block_ok<T, ROWS>(rb, H, flags))
    return (int)cudaErrorInvalidValue;
  const size_t smem = visit9_smem_bytes(c);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  int err = (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  kern<<<visit9_grid(rb.R, nx, H), V9_NT, smem, (cudaStream_t)stream>>>(
      c, io, rb, nx, H, steps, k);
  return (int)cudaGetLastError();
}

template <class T, bool ROWS, class RG>
int launch_region5(const Coeffs<T>& c, const VisitIO<T>& io,
                   const Block<T>& rb, int nx, const compute_t<T>* steps,
                   int k, int H, int flags, void* stream) {
  VisitFn<T, Coeffs<T>> kern = pick_visit5<T, ROWS, RG>(flags);
  if (kern == nullptr || !v5_fits<RG>(H)) return (int)cudaErrorInvalidValue;
  const size_t smem = visit5_smem_bytes<compute_t<T>, RG>();
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  int err = (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  kern<<<visit5_grid<RG>(rb.R, nx, H), RG::NT, smem,
         (cudaStream_t)stream>>>(c, io, rb, nx, H, steps, k);
  return (int)cudaGetLastError();
}

// The bf16 step's launch (visit5p_kernel, the rule v5_pair).
template <class T, bool ROWS>
int launch_pair5(const Coeffs<T>& c, const VisitIO<T>& io,
                 const Block<T>& rb, int nx, const compute_t<T>* steps, int k,
                 int H, int flags, void* stream) {
  VisitFn<T, Coeffs<T>> kern = pick_visit5p<T, ROWS>(flags);
  if (kern == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = visit5p_smem_bytes();
  int err = (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  kern<<<visit5p_grid(rb.R, nx, H), V5Pair::NT, smem,
         (cudaStream_t)stream>>>(c, io, rb, nx, H, steps, k);
  return (int)cudaGetLastError();
}

// The 5-point visit's grid for halo H in compute type C: its region by
// the rule on H (v5_tall).
template <class C>
dim3 visit5_grid_for(int R, int nx, int H) {
  if constexpr (sizeof(C) == 4)
    if (v5_tall<C>(H)) return visit5_grid<V5Tall>(R, nx, H);
  return visit5_grid<V5Short>(R, nx, H);
}

template <class T, bool ROWS = false, class K>
int launch_visit(const K& c, const VisitIO<T>& io, const Block<T>& rb,
                 int nx, const compute_t<T>* steps, int k, int flags,
                 void* stream) {
  if constexpr (std::is_same<K, Coeffs9<T>>::value) {
    return launch_visit9<T, ROWS>(c, io, rb, nx, steps, k, flags, stream);
  } else {
    const int H = halo(flags >> EMIT_SHIFT, k);
    if (k < 1 || !block_ok<T, ROWS>(rb, H, flags))
      return (int)cudaErrorInvalidValue;
    if constexpr (std::is_same<T, __nv_bfloat16>::value)
      if (v5_pair<T>(H))
        return launch_pair5<T, ROWS>(c, io, rb, nx, steps, k, H, flags,
                                     stream);
    if constexpr (sizeof(compute_t<T>) == 4)
      if (v5_tall<compute_t<T>>(H))
        return launch_region5<T, ROWS, V5Tall>(c, io, rb, nx, steps, k, H,
                                               flags, stream);
    return launch_region5<T, ROWS, V5Short>(c, io, rb, nx, steps, k, H,
                                            flags, stream);
  }
}

template <class T, bool ROWS, int LAYOUT>
int launch_apply9(const Coeffs9<T>& c, const T* b, const T* u, T* y,
                  const Block<T>& rb, int nx, int resid, void* stream) {
  auto kern = resid ? apply9_kernel<T, true, ROWS, LAYOUT>
                    : apply9_kernel<T, false, ROWS, LAYOUT>;
  kern<<<dim3((nx + A9_TX - 1) / A9_TX, (rb.R + A9_TY - 1) / A9_TY), A9_NT,
         0, (cudaStream_t)stream>>>(c, b, u, y, rb, nx);
  return (int)cudaGetLastError();
}

template <class T, bool ROWS = false, class K>
int launch_stencil(const K& c, const T* b, const T* u, T* y,
                   const Block<T>& rb, int nx, int resid, void* stream) {
  if (!block_ok<T, ROWS>(rb, 1, 0)) return (int)cudaErrorInvalidValue;
  if constexpr (std::is_same<K, Coeffs9<T>>::value) {
    switch (layout9(c)) {
      case L9_SCALAR:
        return launch_apply9<T, ROWS, L9_SCALAR>(c, b, u, y, rb, nx, resid,
                                                 stream);
      case L9_ANISO:
        return launch_apply9<T, ROWS, L9_ANISO>(c, b, u, y, rb, nx, resid,
                                                stream);
      default:
        return launch_apply9<T, ROWS, L9_ANY>(c, b, u, y, rb, nx, resid,
                                              stream);
    }
  } else {
    auto kern = resid ? stencil_kernel<T, true, K, ROWS>
                      : stencil_kernel<T, false, K, ROWS>;
    const size_t smem =
        sizeof(compute_t<T>) *
        ((TY + 2) * (TX + 2) + coeff_elems(c, TY + 2, TX + 2));
    if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
    int err = (int)cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err) return err;
    kern<<<visit_grid(rb.R, nx), NTHREADS, smem, (cudaStream_t)stream>>>(
        c, b, u, y, rb, nx);
    return (int)cudaGetLastError();
  }
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
//               halo no region holds (v5_fits), is refused.
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
    return launch_visit<T>(c, io, whole_grid<T>(ny, nx), nx, steps, k,      \
                           flags, stream);                                   \
  }                                                                          \
  extern "C" int mg_visit9##SFX(                                             \
      const unsigned long long* cptrs, const int* cstrides, const T* b,      \
      const T* u, const T* e, T* u_out, T* r_out, T* rc_out,                 \
      compute_t<T>* part, int ny, int nx, const compute_t<T>* steps, int k,  \
      int flags, void* stream) {                                             \
    VisitIO<T> io{b,     nullptr, nullptr, u,       e,                       \
                  u_out, r_out,   rc_out,  nullptr, part};                   \
    return launch_visit<T>(mg::coeffs9<T>(cptrs, cstrides), io,              \
                           whole_grid<T>(ny, nx), nx, steps, k, flags,      \
                           stream);                                          \
  }                                                                          \
  extern "C" int mg_stencil##SFX(const T* cs, const T* cw, const T* cc,      \
                                 const T* ce, const T* cn, const T* b,       \
                                 const T* u, T* y, int ny, int nx,           \
                                 int resid, void* stream) {                  \
    Coeffs<T> c{cs, cw, cc, ce, cn};                                         \
    return launch_stencil<T>(c, b, u, y, whole_grid<T>(ny, nx), nx, resid,   \
                             stream);                                        \
  }                                                                          \
  extern "C" int mg_stencil9##SFX(const unsigned long long* cptrs,           \
                                  const int* cstrides, const T* b,           \
                                  const T* u, T* y, int ny, int nx,          \
                                  int resid, void* stream) {                 \
    return launch_stencil<T>(mg::coeffs9<T>(cptrs, cstrides), b, u, y,       \
                             whole_grid<T>(ny, nx), nx, resid, stream);      \
  }

// K17, the entries for one rank's block of a partitioned level
// (visit_rows.cu, visit_rows_f64.cu: f32, f64; bf16 in two sources, the
// 5-point entries in visit_rows_bf16.cu and the 9-point ones in
// visit9_rows_bf16.cu, so that nvcc builds them side by side), named as the
// whole-grid entries with _part: one visit (mg_visit_part, mg_visit9_part:
// every flag set but F_CG) or A u / b - A u (mg_stencil_part,
// mg_stencil9_part, halo 1) on R x C points from the global (row0, col0).
// geom: R, row0, nyg, hn, Rc, hc, C, col0, nxg, hx, Cc, hcx (Block; nx, the
// launch's width, is C); halos: device pointers b_top, b_bot, u_top, u_bot,
// e_top, e_bot (hn rows of C + 2 hx points, the corners included; e's hc
// rows of Cc + 2 hcx), then b_left, b_right, u_left, u_right, e_left,
// e_right (R rows of hx points; e's Rc of hcx), null where the flags read
// none.  A row block of the rows layout has C = nxg, col0 = 0, hx = hcx =
// 0 and no side buffers; a 2-D block of the blocks layout hx = hn, hcx =
// hc.  coff, coffx: the first global row and column the 9-point
// coefficients that vary with y and with x hold.
#define MG_VISIT_PART_ENTRIES(SFX, T)                                     \
  MG_VISIT5_PART_ENTRIES(SFX, T)                                             \
  MG_VISIT9_PART_ENTRIES(SFX, T)
#define MG_VISIT5_PART_ENTRIES(SFX, T)                                    \
  extern "C" int mg_visit_part##SFX(                                      \
      const T* cs, const T* cw, const T* cc, const T* ce, const T* cn,       \
      const T* b, const T* u, const T* e, T* u_out, T* r_out, T* rc_out,     \
      const int* geom, const unsigned long long* halos, int nx,              \
      const compute_t<T>* steps, int k, int flags, void* stream) {           \
    Coeffs<T> c{cs, cw, cc, ce, cn};                                         \
    VisitIO<T> io{b,     nullptr, nullptr, u,       e,                       \
                  u_out, r_out,   rc_out,  nullptr, nullptr};                \
    return launch_visit<T, true>(c, io, part_block<T>(geom, halos), nx, steps, \
                                 k, flags, stream);                          \
  }                                                                          \
  extern "C" int mg_stencil_part##SFX(                                    \
      const T* cs, const T* cw, const T* cc, const T* ce, const T* cn,       \
      const T* b, const T* u, T* y, const int* geom,                         \
      const unsigned long long* halos, int nx, int resid, void* stream) {    \
    Coeffs<T> c{cs, cw, cc, ce, cn};                                         \
    return launch_stencil<T, true>(c, b, u, y, part_block<T>(geom, halos), nx, \
                                   resid, stream);                           \
  }
#define MG_VISIT9_PART_ENTRIES(SFX, T)                                    \
  extern "C" int mg_visit9_part##SFX(                                     \
      const unsigned long long* cptrs, const int* cstrides, int coff,        \
      int coffx, const T* b, const T* u, const T* e, T* u_out, T* r_out,     \
      T* rc_out, const int* geom, const unsigned long long* halos, int nx,   \
      const compute_t<T>* steps, int k, int flags, void* stream) {           \
    Coeffs9<T> c = mg::coeffs9<T>(cptrs, cstrides);                          \
    c.oy = coff;                                                             \
    c.ox = coffx;                                                            \
    VisitIO<T> io{b,     nullptr, nullptr, u,       e,                       \
                  u_out, r_out,   rc_out,  nullptr, nullptr};                \
    return launch_visit<T, true>(c, io, part_block<T>(geom, halos), nx, steps, \
                                 k, flags, stream);                          \
  }                                                                          \
  extern "C" int mg_stencil9_part##SFX(                                   \
      const unsigned long long* cptrs, const int* cstrides, int coff,        \
      int coffx, const T* b, const T* u, T* y, const int* geom,              \
      const unsigned long long* halos, int nx, int resid, void* stream) {    \
    Coeffs9<T> c = mg::coeffs9<T>(cptrs, cstrides);                          \
    c.oy = coff;                                                             \
    c.ox = coffx;                                                            \
    return launch_stencil<T, true>(c, b, u, y, part_block<T>(geom, halos), nx, \
                                   resid, stream);                           \
  }
