// The y-line smoother's level visit (K15) for Hopper (sm_90a), bound
// through a plain C interface (ctypes), for f32 (mg_line_*, line.cu) and
// f64 (mg_line_*_f64, line_f64.cu) levels, two sources so that nvcc
// builds them side by side; the arithmetic runs in the storage type.
//
// Replaces multigrid_petsc_tpu/ops/pallas/line_kernel.py:208
// (line_visit9_pallas): k damped y-line Jacobi sweeps on a 9-point
// stencil -- each moves the off-line terms (w, e and the four corners) to
// the right-hand side from the previous iterate, solves the tridiagonal
// (cs, cc, cn) system of every column and blends
// u <- (1 - omega) u + omega u_line -- then the residual and its
// full-weighting restriction, the residual alone, or <b, u>.  A coarse
// correction u + P e is applied while the first sweep reads u.
//
// What bounds it on the H100: bytes, once the line solves keep enough
// threads busy.  The TPU kernel holds a whole level (up to ~1023^2) in
// VMEM; here a sweep couples all of a column's rows (the tridiagonal
// solve) and its neighbouring columns (the off-line terms from the
// previous sweep), and a column of an 8191^2 level is far larger than a
// block's shared memory, so each sweep is its own launches and reads the
// previous iterate from device memory.
//
// The solve is Thomas's recurrence with per-row factors made once per
// level on the host in f64 (m_i = 1 / (d_i - a_i cp_{i-1}),
// cp_i = c_i m_i), cut into segments of SEG rows so that ~nx * ny / SEG
// threads share the work (2.1 M at 8191^2).  Both recurrences are linear
// in their carry:
//   forward  dp_i = (rhs_i - a_i dp_{i-1}) m_i
//   backward x_i  = dp_i - cp_i x_{i+1}
// so a segment run from zero carries (dpl, then xl) is fixed up by
//   x_i = xl_i + C * above_i + D * below_i
// with C the true dp just above the segment, D the true x just below it,
// and above / below the segment's responses to a unit C / D (products of
// the fixed factors -a_i m_i and -cp_i), made on the host in f64 beside
// m and cp, as is `gain`, C's multiplier across a whole segment.  One
// sweep is three launches:
//   1. line_segment_kernel: each (column, segment) thread forms its rows'
//      right-hand sides and writes only two values, dpl at the segment's
//      end and xl at its start; both are linear in the right-hand side,
//      with per-row weights made on the host in f64 (end_w, start_w), so
//      the thread keeps two running sums and no array;
//   2. line_carry_kernel: C down (C_{s+1} = dpl_end_s + gain_s C_s) and D
//      up (D_{s-1} = x at segment s's first row) every column, in f64.
//      Both are first-order linear recurrences, chains of affine maps,
//      which compose associatively: a blocked scan (32 columns by CW
//      warps a block, each warp a chunk of segments composed into one
//      map, the chunk maps scanned through shared memory, each chunk
//      replayed from its true carry) in one launch.  Its first design, one
//      thread a column walking all S segments, was bound by latency on
//      too few threads (32-64 blocks of 4 warps, a chain of 2 (S - 1)
//      dependent steps: 0.050-0.073 ms at S = 256);
//   3. line_fix_kernel: the thread runs its segment again (the same
//      reads as 1.) through the forward recurrence, its dp staged in
//      shared memory, then back up through the backward one, fixes it up
//      with C and D, blends and stores, with the <b, u> partials.
// A level of one segment (the coarse levels, <= SEG rows) is launch 3
// alone with C = D = 0.  This is the segmented linear scan and not the
// partition (SPIKE) method: the pivots stay the whole column's, made in
// f64 as before, so each row runs today's Thomas arithmetic and config
// 4's nearly singular lines lose no accuracy; the carries add one f64
// pass over nx * ny / SEG values.  Launches 1 and 3 each read b and the
// previous iterate once (the iterate's row is loaded once per column and
// its neighbours come by warp shuffles); 3 writes u: five arrays per sweep
// against the three a sweep must move, traded for not storing dpl in a
// full-size pass.  A coarse correction is formed once per point, in
// launch 1, which stores the corrected iterate for launch 3 (one more
// array on the correcting sweep).
//
// After the sweeps, the residual and its restriction run on 32 x 64
// tiles of u staged in shared memory (one read of b and u).
//
// Registers: launch 3 keeps its segment's dp in shared memory (with a
// correction, the corrected iterate in registers); launch 1 keeps no
// array (`-Xptxas -v` in the build log prints the count per kernel).
//
// The rank-spanning mode (mg_line_rows_*): a row-sharded level's columns
// run across the ranks' row blocks, so its lines cross the ranks.  The
// segments are laid on the global rows (seg rows each, seg the largest
// power of two <= SEG that divides every rank's block, so no segment
// straddles two ranks; blocks of unequal rows hold unequal segment
// counts), and the three launches are split around the one exchange the
// carries need: each rank runs launch 1 on its own segments, from its
// block, its iterate's row above and below (from the neighbours) and the
// factors of its rows; the ranks all-gather the segment ends (the caller,
// over torch.distributed); every rank runs launch 2 over all the
// segments with the whole level's factors (redundantly, as the reference
// runs a replicated coarse level: the scan makes that cheap), reading the
// gathered ends in place -- the caller stacks them as one piece, every
// rank's ends, then every rank's starts, in the gather's own copy -- and
// storing only its own segments' carries, then launch 3 on its own
// segments, which also stores the block's pad row and column as 0.  No transpose of the level and no chain through
// the ranks: the carries move nx * ny / seg * 2 values a sweep.
//
// Its 2-D block mode (SIDES; the same entries, given side buffers): a
// level of the 2-D blocks layout, whose y-lines span a mesh column.  The
// rank's (R, C) block holds nyl x nxl real points (the last mesh row's
// pad row and the last mesh column's pad column are not real; their
// output is left to the caller), read with the row stride ld = C, and
// its depth-1 ring from the neighbours: the rows above and below from
// column -1 to nxl (the corners, which the 9-point line stencil's
// off-line terms read) and the columns left and right, one value a row.
// Only the right-hand sides read the ring.  The coefficients that vary
// with x and the line factors of a field are cut to the block's real
// columns, so the segment ends, the carries and every per-column value
// have nxl columns; the callers gather the ends over the mesh column.
// An x-line of a block is a y-line of the transposed block and its
// transposed ring, gathered over the mesh row.  A block that holds its
// lines whole (the level not split along them) is the same mode over a
// group of one rank: no gather, SEG-row segments, the last one cut by
// the edge.  The rows mode is this mode without side buffers.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "mg_common.cuh"

namespace {

using mg::Coeffs9;
using mg::coef_at;
using mg::prolong_at;

constexpr int SEG = 32;  // rows per segment (one thread's share of a column;
                         // the rank-spanning mode may run fewer, `seg`)
constexpr int ST = 128;  // columns (threads) per block of launches 1 and 3
constexpr int CW = 8;    // warps (of 32 columns' lanes) per carry block
constexpr int CB = 8;    // segments a carry thread loads at once
constexpr int RTY = 32, RTX = 64, RT = 256;  // residual tile and threads
constexpr unsigned LANES = 0xffffffffu;  // every lane of a warp

// The line factors: Thomas's m (1 / pivot) and cp (the eliminated
// super-diagonal), a segment's responses `above` and `below`, the weights
// of its zero-carry ends, each per row, and `gain` per segment; columns
// ((ny, 1), (nseg, 1); sx = 0) or fields ((ny, nx), (nseg, nx); sx = 1).
template <class T>
struct LineFactor {
  const T* m;
  const T* cp;
  const T* above;
  const T* below;
  const T* gain;
  const T* end_w;    // dpl at the segment's last row = sum end_w_i rhs_i
  const T* start_w;  // xl at its first row = sum start_w_i rhs_i
  const T* table;    // null, or every per-row value packed (LineRows)
  int sx;
};

// A coefficient or line factor along a thread's column from row y0 on:
// row y0 + i at p[i * s] (s: 0 for a scalar or an x-row, 1 for a
// (ny, 1) column, nx for an (ny, nx) field), so a row costs one
// multiply-add and a load, not a stride computation per coefficient.
template <class T>
struct ColView {
  const T* p;
  int s;
  __device__ __forceinline__ T operator[](int i) const {
    return p[(ptrdiff_t)i * s];
  }
};

template <class T>
__device__ __forceinline__ ColView<T> coef_col(const Coeffs9<T>& c, int q,
                                               int y0, int x) {
  return {c.p[q] + (ptrdiff_t)(y0 - c.oy) * c.sy[q] + (ptrdiff_t)x * c.sx[q],
          c.sy[q]};
}

// Factor f (m, cp, above, below: (ny, 1) or (ny, nx)) from row y0 on.
template <class T>
__device__ __forceinline__ ColView<T> fac_col(const T* f, int sx, int y0,
                                              int x, int nx) {
  const int s = sx ? nx : 1;
  return {f + (ptrdiff_t)y0 * s + (sx ? x : 0), s};
}

template <class T>
__device__ __forceinline__ T fat(const T* f, int sx, int y, int x, int nx) {
  return f[sx ? (size_t)y * nx + x : (size_t)y];
}

// The iterate's points just past a rank's block (the rank-spanning mode):
// the row above its first row and the row below its last, nx values each
// (SIDES, the 2-D block mode: ld + 2 each, from column -1, the corners
// included), null at the domain's edges and on a whole level; SIDES: the
// columns left and right of the block, one value per row (zeros at the
// domain's edges); ld: the row stride of b, u and the output (nx but in
// the 2-D block mode, whose nx counts the block's real columns).
template <class T>
struct RowHalo {
  const T* top;
  const T* bot;
  const T* left;
  const T* right;
  int ld;
};

// The 2-D block mode's code for one block of threads of launch 3:
// SIDE_EDGE where its columns, or their neighbours, reach the ring's side
// columns (-1 or nx), SIDE_INNER elsewhere (no read of the side columns is
// compiled in: their predicated loads cost launch 3 of a 4096^2 block 8%
// of its time; launch 1, 4% slower so, reads them everywhere); 0 without
// side buffers.
constexpr int SIDE_INNER = 1, SIDE_EDGE = 2;

template <bool SIDES, class F>
__device__ __forceinline__ auto with_sides(int nx, F f) {
  if constexpr (SIDES) {
    if (blockIdx.x == 0 || (int)(blockIdx.x + 1) * ST >= nx)
      return f(std::integral_constant<int, SIDE_EDGE>());
    return f(std::integral_constant<int, SIDE_INNER>());
  } else {
    return f(std::integral_constant<int, 0>());
  }
}

// The row stride of b, u and the output: the halo's in the rank-spanning
// mode, nx on a whole level.
template <bool ROWS, class T>
__device__ __forceinline__ int stride_of(const RowHalo<T>& hl, int nx) {
  return ROWS ? hl.ld : nx;
}

// The sweep's input iterate at (y, x): u (or zero) plus the prolonged
// correction, zero outside the domain; ROWS (the rank-spanning mode): rows
// -1 and ny from the halo rows where there are any; SIDES (its 2-D block
// mode, SIDE_INNER or SIDE_EDGE): rows -1 and ny and columns -1 and nx
// from the ring.  ROWS and SIDES are template flags so that a whole
// level's kernels compile as they did without them.  IN: row y is known
// to lie in [0, ny) (a full segment's own rows), so only the column is
// tested, and in the 2-D block mode with no branch (a predicated load
// from u, one from the ring's side column): with the row's tests between
// two rows, the compiler did not issue the next rows' loads ahead in the
// split modes, and their launches 1 and 3 waited on memory row by row
// (launch 3 on a whole 8191^2 level through the split entries: 0.871 ms,
// 0.375 with IN; the one-card kernels, whose row tests the compiler
// folds, 0.66 ms a sweep either way).
template <bool GUESS, bool CORRECT, bool ROWS, int SIDES, bool IN = false,
          class T>
__device__ __forceinline__ T iterate_at(const T* u, const T* e,
                                        const RowHalo<T>& hl, int y, int x,
                                        int ny, int nx) {
  if constexpr (ROWS && SIDES && IN) {
    static_assert(GUESS && !CORRECT, "the 2-D block mode reads u");
    const T v = x >= 0 && x < nx ? u[(size_t)y * hl.ld + x] : T(0);
    if constexpr (SIDES == SIDE_INNER) return v;
    const T* side = x == -1 ? hl.left : x == nx ? hl.right : nullptr;
    return v + (side != nullptr ? side[y] : T(0));  // one of them is 0
  } else if constexpr (ROWS && SIDES) {
    if (x < -1 || x > nx || y < -1 || y > ny) return T(0);
    if (y == -1) return hl.top[x + 1];
    if (y == ny) return hl.bot[x + 1];
    if (SIDES == SIDE_EDGE && x == -1) return hl.left[y];
    if (SIDES == SIDE_EDGE && x == nx) return hl.right[y];
  } else if constexpr (ROWS) {
    if (x < 0 || x >= nx) return T(0);
    if (!IN && y < 0)
      return y == -1 && hl.top != nullptr ? hl.top[x] : T(0);
    if (!IN && y >= ny)
      return y == ny && hl.bot != nullptr ? hl.bot[x] : T(0);
  } else {
    if ((!IN && (y < 0 || y >= ny)) || x < 0 || x >= nx) return T(0);
  }
  T v = GUESS ? u[(size_t)y * stride_of<ROWS>(hl, nx) + x] : T(0);
  if (CORRECT) v += prolong_at(e, y, x, (ny - 1) / 2, (nx - 1) / 2);
  return v;
}

// Row y of the iterate at columns j - 1, j, j + 1: each lane forms its own
// column's value once, its neighbours' come by shuffles, and the warp's
// edge lanes take the one column past the warp from a second value every
// lane loads (xo: the lane's other column; a plain load costs less than a
// branch) -- or, with a correction, that only the edge lanes form.
// Every lane of the warp calls it with the same y (IN: in [0, ny)).
template <bool GUESS, bool CORRECT, bool ROWS, int SIDES, bool IN = false,
          class T>
__device__ __forceinline__ void iterate_row(const T* u, const T* e,
                                            const RowHalo<T>& hl, int y,
                                            int j, int xo, int ny, int nx,
                                            T& w, T& c, T& ea) {
  const int lane = threadIdx.x & 31;
  c = iterate_at<GUESS, CORRECT, ROWS, SIDES, IN>(u, e, hl, y, j, ny, nx);
  w = __shfl_up_sync(LANES, c, 1);
  ea = __shfl_down_sync(LANES, c, 1);
  if constexpr (CORRECT) {
    if (lane == 0)
      w = iterate_at<GUESS, CORRECT, ROWS, SIDES, IN>(u, e, hl, y, j - 1,
                                                      ny, nx);
    if (lane == 31)
      ea = iterate_at<GUESS, CORRECT, ROWS, SIDES, IN>(u, e, hl, y, j + 1,
                                                       ny, nx);
  } else {
    const T o =
        iterate_at<GUESS, false, ROWS, SIDES, IN>(u, e, hl, y, xo, ny, nx);
    w = lane == 0 ? o : w;
    ea = lane == 31 ? o : ea;
  }
}

// The per-row values a segment reads, in the order of a row of the
// packed table: the off-line coefficients, cs, then the factors.
enum {
  R_CW, R_CE, R_CSW, R_CSE, R_CNW, R_CNE, R_CS, R_M, R_CP, R_ABOVE, R_BELOW,
  R_ENDW, R_STARTW, R_N
};
constexpr int TABW = 16;  // values per table row (R_N, padded)

// Value k of row y0 + i of a thread's column.  TAB: every value lies in one
// row of the packed table (the line stencil and its factors constant along
// x, BASELINE config 4's case), so a read is a load at a fixed offset
// from one pointer; else each comes from its own array through its
// strides (ColView).
template <class T, bool TAB>
struct LineRows {
  const T* tab;
  ColView<T> v[R_N];
  __device__ __forceinline__ LineRows(const Coeffs9<T>& c,
                                      const LineFactor<T>& f, int y0, int jc,
                                      int nx) {
    if (TAB) {
      tab = f.table + (size_t)y0 * TABW;
      return;
    }
    const int q[R_CS + 1] = {mg::CW,  mg::CE,  mg::CSW, mg::CSE,
                             mg::CNW, mg::CNE, mg::CS};
#pragma unroll
    for (int k = 0; k <= R_CS; ++k) v[k] = coef_col(c, q[k], y0, jc);
    const T* fs[R_N - R_M] = {f.m,     f.cp,    f.above, f.below,
                              f.end_w, f.start_w};
#pragma unroll
    for (int k = R_M; k < R_N; ++k) v[k] = fac_col(fs[k - R_M], f.sx, y0, jc,
                                                   nx);
  }
  __device__ __forceinline__ T operator()(int k, int i) const {
    return TAB ? tab[i * TABW + k] : v[k][i];
  }
};

// The right-hand side of row y0 + i: b minus the off-line terms of the
// iterate window (rows y0 + i - 1 (0), y0 + i (1), y0 + i + 1 (2) at
// columns j - 1 (w), j + 1 (e)) in the JAX package's order: w, e, sw, se,
// nw, ne.
template <bool GUESS, class T, class Rows>
__device__ __forceinline__ T line_rhs(const Rows& r, int i, T bv, T w0, T e0,
                                      T w1, T e1, T w2, T e2) {
  if (!GUESS) return bv;
  return bv - (r(R_CW, i) * w1 + r(R_CE, i) * e1 + r(R_CSW, i) * w0 +
               r(R_CSE, i) * e0 + r(R_CNW, i) * w2 + r(R_CNE, i) * e2);
}

// Walk rows y0 .. y0 + seg - 1 of column j (FULL: seg = SEG and all of
// them lie in the level, so the loop has no row test and its loads can be
// issued ahead; else those < ny; seg is SEG unless ROWS), calling row(i,
// rhs_i, u_i) with the row's right-hand side and the iterate's own value.
// Threads past the last column run along (the shuffles need the whole
// warp) on a clamped column.
template <bool FULL, bool GUESS, bool CORRECT, bool ROWS, int SIDES,
          class T, class Rows, class Row>
__device__ __forceinline__ void segment_rows(const Rows& rows,
                                             const T* __restrict__ b,
                                             const T* u, const T* e,
                                             const RowHalo<T>& hl, int y0,
                                             int seg, int j, int ny, int nx,
                                             Row row) {
  const bool col = j < nx;
  const int jc = col ? j : nx - 1;
  const int xo = (threadIdx.x & 31) == 0 ? j - 1 : j + 1;
  const int ld = stride_of<ROWS>(hl, nx);
  const T* bc = b + (size_t)y0 * ld + jc;
  T w0 = T(0), c0 = T(0), e0 = T(0), w1 = T(0), c1 = T(0), e1 = T(0);
  T w2 = T(0), c2 = T(0), e2 = T(0);
  if (GUESS) {
    iterate_row<GUESS, CORRECT, ROWS, SIDES>(u, e, hl, y0 - 1, j, xo, ny, nx,
                                             w0, c0, e0);
    iterate_row<GUESS, CORRECT, ROWS, SIDES, FULL>(u, e, hl, y0, j, xo, ny,
                                                   nx, w1, c1, e1);
  }
#pragma unroll
  for (int i = 0; i < SEG; ++i) {
    // The same rows for the whole warp; a full segment's own rows lie in
    // the level (IN), the row below it may not.
    if (FULL || ((!ROWS || i < seg) && y0 + i < ny)) {
      if (GUESS && FULL && i + 1 < SEG)
        iterate_row<GUESS, CORRECT, ROWS, SIDES, true>(
            u, e, hl, y0 + i + 1, j, xo, ny, nx, w2, c2, e2);
      else if (GUESS)
        iterate_row<GUESS, CORRECT, ROWS, SIDES>(u, e, hl, y0 + i + 1, j, xo,
                                                 ny, nx, w2, c2, e2);
      const T bv = col ? bc[(size_t)i * ld] : T(0);
      row(i, line_rhs<GUESS>(rows, i, bv, w0, e0, w1, e1, w2, e2), c1);
      w0 = w1, c0 = c1, e0 = e1;
      w1 = w2, c1 = c2, e1 = e2;
    }
  }
}

// The segment a block of launch 1 or 3 runs: the last first, so that a
// level's or a block's last segment, cut by its edge and run on the
// slower path with the row tests, starts with the first wave instead of
// trailing the launch.
__device__ __forceinline__ int segment_of_block() {
  return gridDim.y - 1 - blockIdx.y;
}

// Launch 1 of a sweep: thread (column j, segment s) forms its
// rows' right-hand sides and the two values the carries need, dpl at the
// segment's last row (ends) and xl at its first (starts), (nseg, nx) each.
// Both are linear in the right-hand side with weights fixed per level
// (end_w, start_w; made on the host in f64), so they are two running sums
// and the thread keeps no array.  CORRECT: it also stores its column of
// the corrected iterate u + P e (u_corr), which launch 3 then reads as
// its guess, so the correction is formed once per point.
template <bool FULL, class T, bool GUESS, bool CORRECT, bool TAB, bool ROWS,
          int SIDES>
__device__ __forceinline__ void segment_ends(
    const Coeffs9<T>& c, const LineFactor<T>& f, const T* b, const T* u,
    const T* e, const RowHalo<T>& hl, T* ends, T* starts, T* u_corr, int s,
    int seg, int j, int ny, int nx) {
  const int y0 = s * (ROWS ? seg : SEG);
  const LineRows<T, TAB> rows(c, f, y0, j < nx ? j : nx - 1, nx);
  T* uc = u_corr + (size_t)y0 * nx + j;
  T de = T(0), xs = T(0);
  segment_rows<FULL, GUESS, CORRECT, ROWS, SIDES, T>(rows, b, u, e, hl, y0,
                                                     seg, j, ny, nx,
                                        [&](int i, T rhs, T ui) {
                                          de += rows(R_ENDW, i) * rhs;
                                          xs += rows(R_STARTW, i) * rhs;
                                          if (CORRECT && j < nx)
                                            uc[(size_t)i * nx] = ui;
                                        });
  if (j >= nx) return;
  ends[(size_t)s * nx + j] = de;
  starts[(size_t)s * nx + j] = xs;
}

template <class T, bool GUESS, bool CORRECT, bool TAB, bool ROWS = false,
          bool SIDES = false>
__global__ void __launch_bounds__(ST)
line_segment_kernel(Coeffs9<T> c, LineFactor<T> f, const T* __restrict__ b,
                    const T* __restrict__ u, const T* __restrict__ e,
                    RowHalo<T> hl, T* __restrict__ ends,
                    T* __restrict__ starts, T* __restrict__ u_corr, int seg,
                    int ny, int nx) {
  constexpr int SD = SIDES ? SIDE_EDGE : 0;
  const int j = blockIdx.x * ST + threadIdx.x, s = segment_of_block();
  if ((!ROWS || seg == SEG) && (s + 1) * SEG <= ny)
    segment_ends<true, T, GUESS, CORRECT, TAB, ROWS, SD>(
        c, f, b, u, e, hl, ends, starts, u_corr, s, seg, j, ny, nx);
  else
    segment_ends<false, T, GUESS, CORRECT, TAB, ROWS, SD>(
        c, f, b, u, e, hl, ends, starts, u_corr, s, seg, j, ny, nx);
}

// Launch 2: the carries of every column as two first-order linear
// recurrences over its S segments, each a chain of affine maps, composed
// by a blocked scan.  It reads the segment ends and starts as one (2, S,
// nx) piece, the ends of the lines' S segments, then their starts: launch
// 1's own output on a whole level, the ranks' stacked so by the caller in
// the rank-spanning mode (the ranks may hold unequal counts: blocks of
// unequal rows under the 2-D blocks layout on any rank count).  A first
// design read the ranks' outputs where the gather left them, (2, n_q,
// nx) each, through a table of each rank's first segment: its lookup
// before every load made the launch ~22-34% slower than reading one
// piece, and the stacking rides the copy the gather makes anyway.  Forward: C_0 = 0, C_{s+1} = ends_s + gain_s C_s (the
// true dp on the row above segment s + 1); backward: D_{S-1} = 0,
// D_{s-1} = (starts_s + C_s above_s) + below_s D_s (the true x on the row
// below segment s - 1), with C_s as launch 3 reads it (rounded to T).  A
// block is 32 columns (the lanes: a row of a segment is one load a warp)
// by CW warps; warp w takes the K consecutive segments [w K, w K + K) (K
// a multiple of the load batch CB, CW K >= S; the last warps may hold
// none).  Each direction is three steps: a thread composes its chunk's
// maps into one (G, E) from loads issued a batch at a time, the CW chunk
// maps of a column are scanned through shared memory (each warp folds the
// maps before its own), and the thread replays its chunk from its true
// incoming carry.  The forward replay also composes the chunk's backward
// maps (they need C_s), and keeps its forward carry at each batch's start
// in shared memory (32 bytes a segment: S up to ~7000), from which the
// backward replay recomputes a batch's C_s before walking it down.  The
// dependent chain is ~4 K + 2 CW f64 steps instead of 2 (S - 1).  cin and
// din are stored for segments [s0, s0 + nown) only (a rank's own),
// rounded once to T; the arithmetic is f64 throughout, as the serial
// walk's, in another order of roundings.  CW = 16 ran no faster than 8,
// and CB = 16 (more loads in flight, 128 registers) 6% slower than 8.
template <class T, bool ROWS = false>
__global__ void __launch_bounds__(32 * CW, 2)
line_carry_kernel(LineFactor<T> f, const T* __restrict__ g,
                  T* __restrict__ cin, T* __restrict__ din, int seg, int S,
                  int K, int s0, int nown, int ny, int nx) {
  extern __shared__ double batch_c[];  // [CW][K / CB][32]
  __shared__ double fg[CW][32], fe[CW][32], bg[CW][32], be[CW][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int j = blockIdx.x * 32 + lane;
  const bool col = j < nx;
  const int jc = col ? j : nx - 1;  // loads of a column past the last
  const int rs = ROWS ? seg : SEG;
  const int a = min(S, w * K), b = min(S, a + K), nb = K / CB;
  const int s1 = s0 + nown;
  double* bc = batch_c + (size_t)w * nb * 32 + lane;
  // Segment s's row of the carries' inputs: its end and start, its gain,
  // and its first row's responses (0 past the level: a segment of pad
  // rows alone has no rows).
  auto gain = [&](int s) {
    return s * rs < ny ? fat(f.gain, f.sx, s, jc, nx) : T(0);
  };
  auto load = [&](int s, T& e, T& gn, T& x, T& ab, T& bl) {
    e = g[(size_t)s * nx + jc];
    x = g[(size_t)(S + s) * nx + jc];
    gn = gain(s);
    const bool real = s * rs < ny;
    ab = real ? fat(f.above, f.sx, s * rs, jc, nx) : T(0);
    bl = real ? fat(f.below, f.sx, s * rs, jc, nx) : T(0);
  };
  // 1. The chunk's forward map C_a -> C_b.
  double G = 1.0, E = 0.0;
  for (int lo = a; lo < b; lo += CB) {
    T ev[CB], gv[CB];
#pragma unroll
    for (int q = 0; q < CB; ++q)
      if (lo + q < b) {
        ev[q] = g[(size_t)(lo + q) * nx + jc];
        gv[q] = gain(lo + q);
      }
#pragma unroll
    for (int q = 0; q < CB; ++q)
      if (lo + q < b && lo + q < S - 1) {
        E = __fma_rn((double)gv[q], E, (double)ev[q]);
        G *= (double)gv[q];
      }
  }
  fg[w][lane] = G;
  fe[w][lane] = E;
  __syncthreads();
  // 2. The true C_a: the chunk maps before this one, from C_0 = 0.
  double c = 0.0;
  for (int v = 0; v < w; ++v) c = __fma_rn(fg[v][lane], c, fe[v][lane]);
  // 3. The forward replay, storing the own C_s, and the chunk's backward
  // map D_{b-1} -> D_{a-1}, composed upwards.
  double Gb = 1.0, Eb = 0.0;
  for (int lo = a, i = 0; lo < b; lo += CB, ++i) {
    bc[i * 32] = c;
    T ev[CB], gv[CB], xv[CB], av[CB], bv[CB];
#pragma unroll
    for (int q = 0; q < CB; ++q)
      if (lo + q < b) load(lo + q, ev[q], gv[q], xv[q], av[q], bv[q]);
#pragma unroll
    for (int q = 0; q < CB; ++q) {
      const int s = lo + q;
      if (s < b) {
        const T ct = T(c);
        if (col && s >= s0 && s < s1) cin[(size_t)(s - s0) * nx + j] = ct;
        if (s >= 1) {
          Eb = __fma_rn(Gb, __fma_rn((double)ct, (double)av[q],
                                     (double)xv[q]), Eb);
          Gb *= (double)bv[q];
        }
        if (s < S - 1) c = __fma_rn((double)gv[q], c, (double)ev[q]);
      }
    }
  }
  bg[w][lane] = Gb;
  be[w][lane] = Eb;
  __syncthreads();
  // 4. The true D_{b-1}: the chunk maps after this one, from D_{S-1} = 0.
  if (a >= s1 || b <= s0) return;  // no own segment in this chunk
  double d = 0.0;
  for (int v = CW - 1; v > w; --v) d = __fma_rn(bg[v][lane], d, be[v][lane]);
  // 5. The backward replay, a batch at a time from the top, down to the
  // first own segment: the batch's C_s again from its start (into ev,
  // once its end is used), then D.
  for (int i = (b - a - 1) / CB; i >= 0 && a + (i + 1) * CB > s0; --i) {
    const int lo = a + i * CB;
    T ev[CB], gv[CB], xv[CB], av[CB], bv[CB];
#pragma unroll
    for (int q = 0; q < CB; ++q)
      if (lo + q < b) load(lo + q, ev[q], gv[q], xv[q], av[q], bv[q]);
    c = bc[i * 32];
#pragma unroll
    for (int q = 0; q < CB; ++q)
      if (lo + q < b) {
        const T ct = T(c);
        if (lo + q < S - 1) c = __fma_rn((double)gv[q], c, (double)ev[q]);
        ev[q] = ct;
      }
#pragma unroll
    for (int q = CB - 1; q >= 0; --q) {
      const int s = lo + q;
      if (s < b) {
        if (col && s >= s0 && s < s1) din[(size_t)(s - s0) * nx + j] = T(d);
        if (s >= 1)
          d = __fma_rn((double)bv[q], d,
                       __fma_rn((double)ev[q], (double)av[q],
                                (double)xv[q]));
      }
    }
  }
}

template <class T, bool ROWS>
int carry_launch(const LineFactor<T>& f, const T* g, T* cin, T* din,
                 int seg, int S, int s0, int nown, int ny, int nx,
                 cudaStream_t st) {
  const int K = CB * ((S + CW * CB - 1) / (CW * CB));
  const size_t smem = (size_t)CW * (K / CB) * 32 * sizeof(double);
  auto kern = line_carry_kernel<T, ROWS>;
  if (smem > 48 * 1024)
    if (int err = (int)cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem))
      return err;
  kern<<<(nx + 31) / 32, 32 * CW, smem, st>>>(f, g, cin, din, seg, S, K, s0,
                                              nown, ny, nx);
  return (int)cudaGetLastError();
}

template <bool FULL, class T, bool GUESS, bool CORRECT, bool DOT, bool TAB,
          bool ROWS, int SIDES>
__device__ __forceinline__ T segment_fix(const Coeffs9<T>& c,
                                         const LineFactor<T>& f, const T* b,
                                         const T* u, const T* e,
                                         const RowHalo<T>& hl, const T* cin,
                                         const T* din, T* u_out, T* dp,
                                         int s, int seg, int j, int ny,
                                         int rows_out, int nx, T omega,
                                         T one_minus_omega) {
  const int y0 = s * (ROWS ? seg : SEG);
  const LineRows<T, TAB> rows(c, f, y0, j < nx ? j : nx - 1, nx);
  // Thomas's forward recurrence from a zero carry, its dp staged in the
  // thread's column of shared memory (dp[i * ST]); with a correction the
  // corrected iterate is kept too (it is formed once per point), else the
  // backward pass reloads u (a cache hit: this thread has just read it).
  T uc[CORRECT ? SEG : 1];
  T d = T(0);
  segment_rows<FULL, GUESS, CORRECT, ROWS, SIDES, T>(
      rows, b, u, e, hl, y0, seg, j, ny, nx, [&](int i, T rhs, T ui) {
        d = (rhs - rows(R_CS, i) * d) * rows(R_M, i);
        dp[i * ST] = d;
        if (CORRECT) uc[CORRECT ? i : 0] = ui;
      });
  T acc = T(0);
  const int ld = stride_of<ROWS>(hl, nx);
  if (j >= nx) {  // the block's pad column (ROWS): 0
    if (ROWS && j < ld)
      for (int i = 0; i < seg && y0 + i < rows_out; ++i)
        u_out[(size_t)(y0 + i) * ld + j] = T(0);
    return acc;
  }
  const size_t sj = (size_t)s * nx + j;
  const T cv = cin != nullptr ? cin[sj] : T(0);
  const T dv = din != nullptr ? din[sj] : T(0);
  T* out = u_out + (size_t)y0 * ld + j;
  const T* bc = b + (size_t)y0 * ld + j;
  const T* uo = GUESS ? u + (size_t)y0 * ld + j : nullptr;
  T x = T(0);
#pragma unroll
  for (int i = SEG - 1; i >= 0; --i) {
    if (FULL || ((!ROWS || i < seg) && y0 + i < ny)) {
      x = dp[i * ST] - rows(R_CP, i) * x;
      const T ui = CORRECT ? uc[CORRECT ? i : 0]
                   : GUESS ? uo[(size_t)i * ld] : T(0);
      const T un = one_minus_omega * ui +
                   omega * (x + cv * rows(R_ABOVE, i) + dv * rows(R_BELOW, i));
      out[(size_t)i * ld] = un;
      if (DOT) acc += bc[(size_t)i * ld] * un;
    } else if (ROWS && i < seg && y0 + i < rows_out) {  // its pad row: 0
      out[(size_t)i * ld] = T(0);
    }
  }
  return acc;
}

// Launch 3: the segment again, fixed up with its carries (null: a level
// of one segment, C = D = 0), blended and stored; DOT: <b, u_out>
// partials, one per block.  ROWS: the block's rows [ny, rows_out) and
// columns [nx, ld) (its pad row and column) are stored as 0, so the
// output needs no clearing.  u_out must not alias u: neighbouring columns
// read u while this one is written.
// The segment's dp lives in shared memory (SEG x ST values a block, 16 KB
// in f32, 32 KB in f64), not in registers: held there, 32 (64) registers
// a thread spilled or starved the loads in flight.  Resident blocks per
// SM launch 3's registers are cut for: five in f32 (up to 102 registers),
// three in f64 (up to 170).
template <class T>
constexpr int fix_min_blocks() {
  return sizeof(T) == 8 ? 3 : 5;
}

template <class T, bool GUESS, bool CORRECT, bool DOT, bool TAB,
          bool ROWS = false, bool SIDES = false>
__global__ void __launch_bounds__(ST, fix_min_blocks<T>())
line_fix_kernel(Coeffs9<T> c, LineFactor<T> f, const T* __restrict__ b,
                const T* __restrict__ u, const T* __restrict__ e,
                RowHalo<T> hl, const T* __restrict__ cin,
                const T* __restrict__ din, T* __restrict__ u_out,
                T* __restrict__ part, int seg, int ny, int rows_out, int nx,
                T omega, T one_minus_omega) {
  __shared__ T red[ST / 32];
  __shared__ T dp[SEG * ST];
  const int j = blockIdx.x * ST + threadIdx.x, s = segment_of_block();
  T* dpj = dp + threadIdx.x;
  const bool full = (!ROWS || seg == SEG) && (s + 1) * SEG <= ny;
  const T acc = with_sides<SIDES>(nx, [&](auto sides) {
    constexpr int SD = decltype(sides)::value;
    return full ? segment_fix<true, T, GUESS, CORRECT, DOT, TAB, ROWS, SD>(
                      c, f, b, u, e, hl, cin, din, u_out, dpj, s, seg, j,
                      ny, rows_out, nx, omega, one_minus_omega)
                : segment_fix<false, T, GUESS, CORRECT, DOT, TAB, ROWS, SD>(
                      c, f, b, u, e, hl, cin, din, u_out, dpj, s, seg, j,
                      ny, rows_out, nx, omega, one_minus_omega);
  });
  if (DOT) {
    const T sum = mg::block_sum<ST, T>(acc, red);
    if (threadIdx.x == 0) part[blockIdx.y * gridDim.x + blockIdx.x] = sum;
  }
}

// After the sweeps: r = b - A u (RC = false) or rc = R (b - A u) (RC =
// true; full weighting, y pass first, as ops/transfer.restrict_fw), on a
// tile of RTY x RTX fine points (RC: the RTY/2 x RTX/2 coarse points whose
// footprint starts in it) with u and its 1-point halo in shared memory.
// Term order of the JAX package: cc, s, n, w, e, sw, se, nw, ne.
template <class T, bool RC>
__global__ void __launch_bounds__(RT)
line_residual_kernel(Coeffs9<T> c, const T* __restrict__ b,
                     const T* __restrict__ u, T* __restrict__ out, int ny,
                     int nx) {
  constexpr int FH = RTY + (RC ? 1 : 0), FW = RTX + (RC ? 1 : 0);
  constexpr int SH = FH + 2, SW = FW + 2;
  __shared__ T us[SH * SW];
  __shared__ T rs[RC ? FH * FW : 1];
  const int y0 = blockIdx.y * RTY, x0 = blockIdx.x * RTX;
  for (int i = threadIdx.x; i < SH * SW; i += RT) {
    const int gy = y0 - 1 + i / SW, gx = x0 - 1 + i % SW;
    us[i] = gy >= 0 && gy < ny && gx >= 0 && gx < nx
                ? u[(size_t)gy * nx + gx] : T(0);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < FH * FW; t += RT) {
    const int ry = t / FW, rx = t % FW;
    const int gy = y0 + ry, gx = x0 + rx;
    T r = T(0);
    if (gy < ny && gx < nx) {
      const T* v = us + (ry + 1) * SW + rx + 1;
      r = b[(size_t)gy * nx + gx] -
          (coef_at(c, mg::CC, gy, gx) * v[0] +
           coef_at(c, mg::CS, gy, gx) * v[-SW] +
           coef_at(c, mg::CN, gy, gx) * v[SW] +
           coef_at(c, mg::CW, gy, gx) * v[-1] +
           coef_at(c, mg::CE, gy, gx) * v[1] +
           coef_at(c, mg::CSW, gy, gx) * v[-SW - 1] +
           coef_at(c, mg::CSE, gy, gx) * v[-SW + 1] +
           coef_at(c, mg::CNW, gy, gx) * v[SW - 1] +
           coef_at(c, mg::CNE, gy, gx) * v[SW + 1]);
    }
    if (RC)
      rs[t] = r;
    else if (gy < ny && gx < nx)
      out[(size_t)gy * nx + gx] = r;
  }
  if constexpr (RC) {
    __syncthreads();
    const int nyc = (ny - 1) / 2, nxc = (nx - 1) / 2;
    for (int t = threadIdx.x; t < (RTY / 2) * (RTX / 2); t += RT) {
      const int cy = t / (RTX / 2), cx = t % (RTX / 2);
      const int I = y0 / 2 + cy, J = x0 / 2 + cx;
      if (I >= nyc || J >= nxc) continue;
      const T* r0 = rs + 2 * cy * FW + 2 * cx;  // fine (2I, 2J)
      T ycol[3];
      for (int d = 0; d < 3; ++d)
        ycol[d] = r0[d] + T(2) * r0[FW + d] + r0[2 * FW + d];
      out[(size_t)I * nxc + J] = T(0.0625) * (ycol[0] + T(2) * ycol[1] +
                                              ycol[2]);
    }
  }
}

template <class T>
using SegmentFn = void (*)(Coeffs9<T>, LineFactor<T>, const T*, const T*,
                           const T*, RowHalo<T>, T*, T*, T*, int, int, int);
template <class T>
using FixFn = void (*)(Coeffs9<T>, LineFactor<T>, const T*, const T*,
                       const T*, RowHalo<T>, const T*, const T*, T*, T*, int,
                       int, int, int, T, T);

template <class T>
LineFactor<T> line_factor(const unsigned long long* fptrs, int fsx) {
  auto fp = [&](int i) { return reinterpret_cast<const T*>(fptrs[i]); };
  return LineFactor<T>{fp(0), fp(1), fp(2), fp(3), fp(4),
                       fp(5), fp(6), fp(7), fsx};
}

template <class T, bool TAB>
SegmentFn<T> pick_segment(bool guess, bool correct) {
  return !guess    ? line_segment_kernel<T, false, false, TAB>
         : correct ? line_segment_kernel<T, true, true, TAB>
                   : line_segment_kernel<T, true, false, TAB>;
}

template <class T, bool TAB>
FixFn<T> pick_fix(bool guess, bool correct, bool dot) {
  if (!guess)
    return dot ? line_fix_kernel<T, false, false, true, TAB>
               : line_fix_kernel<T, false, false, false, TAB>;
  if (correct)
    return dot ? line_fix_kernel<T, true, true, true, TAB>
               : line_fix_kernel<T, true, true, false, TAB>;
  return dot ? line_fix_kernel<T, true, false, true, TAB>
             : line_fix_kernel<T, true, false, false, TAB>;
}

template <class T>
int line_sweep(const unsigned long long* cptrs, const int* cstrides,
               const unsigned long long* fptrs, int fsx, int seg, const T* b,
               const T* u, const T* e, T* u_out, T* part, T* scratch,
               T* u_corr, int ny, int nx, T omega, T one_minus_omega,
               void* stream) {
  const int nseg = (ny + SEG - 1) / SEG;
  if (seg != SEG || ny < 1 || nx < 1 || (u == nullptr && e != nullptr) ||
      (nseg > 1 && scratch == nullptr) ||
      (nseg > 1 && e != nullptr && (u_corr == nullptr || u_corr == u)))
    return (int)cudaErrorInvalidValue;
  const Coeffs9<T> c = mg::coeffs9<T>(cptrs, cstrides);
  const LineFactor<T> f = line_factor<T>(fptrs, fsx);
  const RowHalo<T> hl{nullptr, nullptr, nullptr, nullptr, nx};
  const bool tab = f.table != nullptr, guess = u != nullptr;
  bool correct = e != nullptr;
  const bool dot = part != nullptr;
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((nx + ST - 1) / ST, nseg);
  T *cin = nullptr, *din = nullptr;
  if (nseg > 1) {
    T* ends = scratch;  // then the starts: one rank's (2, nseg, nx)
    T* starts = ends + (size_t)nseg * nx;
    cin = starts + (size_t)nseg * nx;
    din = cin + (size_t)nseg * nx;
    SegmentFn<T> seg_kern = tab ? pick_segment<T, true>(guess, correct)
                                : pick_segment<T, false>(guess, correct);
    seg_kern<<<grid, ST, 0, st>>>(c, f, b, u, e, hl, ends, starts, u_corr,
                                  SEG, ny, nx);
    if (int err = (int)cudaGetLastError()) return err;
    if (correct) {  // launch 3 reads the corrected iterate launch 1 stored
      u = u_corr;
      e = nullptr;
      correct = false;
    }
    if (int err = carry_launch<T, false>(f, ends, cin, din, SEG, nseg, 0,
                                         nseg, ny, nx, st))
      return err;
  }
  FixFn<T> fix = tab ? pick_fix<T, true>(guess, correct, dot)
                     : pick_fix<T, false>(guess, correct, dot);
  fix<<<grid, ST, 0, st>>>(c, f, b, u, e, hl, cin, din, u_out, part, SEG,
                           ny, ny, nx, omega, one_minus_omega);
  return (int)cudaGetLastError();
}

// The rank-spanning mode's launches on one rank's block of nyl real rows
// (R = nseg * seg rows, or fewer where the last segment is cut by the
// domain's edge; the last rank's pad row is not a real row, and launch 3
// stores it as 0), local row 0 its first row: the
// factors and the coefficients that vary with y are the slices of the
// block's rows, hl its iterate's rows above and below and, in the 2-D
// block mode (u_left non-null), the columns left and right; nx real
// columns at the row stride ld.  seg must divide SEG; launch 1 and 3 take
// the iterate (no zero guess, no correction).
template <class T>
bool rows_ok(int seg, int nseg, int nyl, int nx) {
  return seg >= 1 && seg <= SEG && SEG % seg == 0 && nseg >= 1 &&
         nyl >= 1 && nyl <= nseg * seg && nx >= 1;
}

template <class T>
bool halo_ok(const RowHalo<T>& hl, int nx) {
  const bool sides = hl.left != nullptr;
  return (sides == (hl.right != nullptr)) &&
         (sides ? hl.ld >= nx && hl.top != nullptr && hl.bot != nullptr
                : hl.ld == nx);
}

template <class T>
int line_rows_ends(const unsigned long long* cptrs, const int* cstrides,
                   const unsigned long long* fptrs, int fsx, int seg,
                   const T* b, const T* u, RowHalo<T> hl, T* ends, T* starts,
                   int nseg, int nyl, int nx, void* stream) {
  if (!rows_ok<T>(seg, nseg, nyl, nx) || !halo_ok(hl, nx) || u == nullptr)
    return (int)cudaErrorInvalidValue;
  const Coeffs9<T> c = mg::coeffs9<T>(cptrs, cstrides);
  const LineFactor<T> f = line_factor<T>(fptrs, fsx);
  const bool tab = f.table != nullptr, sides = hl.left != nullptr;
  SegmentFn<T> kern =
      sides ? (tab ? line_segment_kernel<T, true, false, true, true, true>
                   : line_segment_kernel<T, true, false, false, true, true>)
            : (tab ? line_segment_kernel<T, true, false, true, true>
                   : line_segment_kernel<T, true, false, false, true>);
  kern<<<dim3((nx + ST - 1) / ST, nseg), ST, 0, (cudaStream_t)stream>>>(
      c, f, b, u, nullptr, hl, ends, starts, nullptr, seg, nyl, nx);
  return (int)cudaGetLastError();
}

template <class T>
int line_rows_carry(const unsigned long long* fptrs, int fsx, int seg,
                    const T* gathered, int S, T* cin, T* din, int s0,
                    int nown, int ny, int nx, void* stream) {
  if (!rows_ok<T>(seg, nown, 1, nx) || s0 < 0 || s0 + nown > S || ny < 1 ||
      gathered == nullptr || cin == nullptr || din == nullptr)
    return (int)cudaErrorInvalidValue;
  return carry_launch<T, true>(line_factor<T>(fptrs, fsx), gathered, cin,
                               din, seg, S, s0, nown, ny, nx,
                               (cudaStream_t)stream);
}

template <class T>
int line_rows_fix(const unsigned long long* cptrs, const int* cstrides,
                  const unsigned long long* fptrs, int fsx, int seg,
                  const T* b, const T* u, RowHalo<T> hl, const T* cin,
                  const T* din, T* u_out, int nseg, int nyl, int rows_out,
                  int nx, T omega, T one_minus_omega, void* stream) {
  if (!rows_ok<T>(seg, nseg, nyl, nx) || !halo_ok(hl, nx) || u == nullptr ||
      u_out == u || cin == nullptr || din == nullptr || rows_out < nyl ||
      rows_out > nseg * seg)
    return (int)cudaErrorInvalidValue;
  const Coeffs9<T> c = mg::coeffs9<T>(cptrs, cstrides);
  const LineFactor<T> f = line_factor<T>(fptrs, fsx);
  const bool tab = f.table != nullptr, sides = hl.left != nullptr;
  FixFn<T> fix =
      sides ? (tab ? line_fix_kernel<T, true, false, false, true, true, true>
                   : line_fix_kernel<T, true, false, false, false, true, true>)
            : (tab ? line_fix_kernel<T, true, false, false, true, true>
                   : line_fix_kernel<T, true, false, false, false, true>);
  fix<<<dim3((hl.ld + ST - 1) / ST, nseg), ST, 0, (cudaStream_t)stream>>>(
      c, f, b, u, nullptr, hl, cin, din, u_out, nullptr, seg, nyl, rows_out,
      nx, omega, one_minus_omega);
  return (int)cudaGetLastError();
}

template <class T>
int line_residual(const unsigned long long* cptrs, const int* cstrides,
                  const T* b, const T* u, T* out, int ny, int nx, int rc,
                  void* stream) {
  const Coeffs9<T> c = mg::coeffs9<T>(cptrs, cstrides);
  const dim3 grid((nx + RTX - 1) / RTX, (ny + RTY - 1) / RTY);
  if (rc)
    line_residual_kernel<T, true><<<grid, RT, 0, (cudaStream_t)stream>>>(
        c, b, u, out, ny, nx);
  else
    line_residual_kernel<T, false><<<grid, RT, 0, (cudaStream_t)stream>>>(
        c, b, u, out, ny, nx);
  return (int)cudaGetLastError();
}

}  // namespace

// The C entries of storage type T, named mg_<entry><SFX> (SFX empty for
// f32, _f64):
//   mg_line_sweep     one y-line sweep.  cptrs/cstrides: the 9-point
//                     coefficients as in mg_common.cuh's coeffs9(); fptrs:
//                     device pointers to the line factors m, cp, above,
//                     below, gain, end_w, start_w, columns (fsx = 0) or
//                     fields (fsx = 1), then the packed per-row table (null:
//                     none), made for segments of `seg` rows (refused
//                     unless it is SEG); u null: the zero guess; e
//                     non-null: correct u + P e first (u_corr: where the
//                     corrected iterate is kept, an (ny, nx) buffer other
//                     than u; unused, and may be null, for a level of one
//                     segment); part non-null: the <b, u_out> partials;
//                     scratch: 4 * nseg * nx values (unused, and may be
//                     null, for a level of one segment).
//   mg_line_residual  the visit's last pass: r = b - A u (rc == 0) or its
//                     restriction.
//   mg_line_rows_ends, mg_line_rows_carry, mg_line_rows_fix
//                     the rank-spanning mode, one sweep of a rank's block
//                     (see the top of this file): launch 1 (the segment
//                     ends and starts of its nseg segments, (nseg, nx)
//                     each, one (2, nseg, nx) buffer: ends = the first
//                     half), launch 2 (from the gathered launch-1 outputs
//                     of the ranks stacked as one (2, S, nx) piece, every
//                     rank's ends, then every rank's starts, read in place,
//                     with the whole level's factors (ny rows): the
//                     carries cin, din, (nown, nx) each, of segments [s0,
//                     s0 + nown) of the S) and launch 3 (the swept block of
//                     rows_out rows from its carries, its pad row and
//                     column stored as 0).  fptrs as for mg_line_sweep;
//                     for launches 1 and 3 the slices of the block's rows
//                     (gain unused), for launch 2 the whole level's.
//                     u_top, u_bot: the rows above and below; u_left,
//                     u_right null (the rows mode, ld == nx) or the
//                     columns left and right (the 2-D block mode: u_top
//                     and u_bot from column -1, ld + 2 values; nx real
//                     columns at the row stride ld).
#define MG_LINE_ENTRIES(SFX, T)                                             \
  extern "C" int mg_line_sweep##SFX(                                        \
      const unsigned long long* cptrs, const int* cstrides,                 \
      const unsigned long long* fptrs, int fsx, int seg, const T* b,        \
      const T* u, const T* e, T* u_out, T* part, T* scratch, T* u_corr,     \
      int ny, int nx, T omega, T one_minus_omega, void* stream) {           \
    return line_sweep<T>(cptrs, cstrides, fptrs, fsx, seg, b, u, e, u_out,  \
                         part, scratch, u_corr, ny, nx, omega,              \
                         one_minus_omega, stream);                          \
  }                                                                         \
  extern "C" int mg_line_residual##SFX(                                     \
      const unsigned long long* cptrs, const int* cstrides, const T* b,     \
      const T* u, T* out, int ny, int nx, int rc, void* stream) {           \
    return line_residual<T>(cptrs, cstrides, b, u, out, ny, nx, rc,         \
                            stream);                                        \
  }                                                                         \
  extern "C" int mg_line_rows_ends##SFX(                                    \
      const unsigned long long* cptrs, const int* cstrides,                 \
      const unsigned long long* fptrs, int fsx, int seg, const T* b,        \
      const T* u, const T* u_top, const T* u_bot, const T* u_left,          \
      const T* u_right, T* ends, T* starts, int nseg, int nyl, int nx,      \
      int ld, void* stream) {                                               \
    return line_rows_ends<T>(cptrs, cstrides, fptrs, fsx, seg, b, u,        \
                             RowHalo<T>{u_top, u_bot, u_left, u_right, ld}, \
                             ends, starts, nseg, nyl, nx, stream);          \
  }                                                                         \
  extern "C" int mg_line_rows_carry##SFX(                                   \
      const unsigned long long* fptrs, int fsx, int seg, const T* gathered, \
      int S, T* cin, T* din, int s0, int nown, int ny, int nx,              \
      void* stream) {                                                       \
    return line_rows_carry<T>(fptrs, fsx, seg, gathered, S, cin, din, s0,   \
                              nown, ny, nx, stream);                        \
  }                                                                         \
  extern "C" int mg_line_rows_fix##SFX(                                     \
      const unsigned long long* cptrs, const int* cstrides,                 \
      const unsigned long long* fptrs, int fsx, int seg, const T* b,        \
      const T* u, const T* u_top, const T* u_bot, const T* u_left,          \
      const T* u_right, const T* cin, const T* din, T* u_out, int nseg,     \
      int nyl, int rows_out, int nx, int ld, T omega, T one_minus_omega,    \
      void* stream) {                                                       \
    return line_rows_fix<T>(cptrs, cstrides, fptrs, fsx, seg, b, u,         \
                            RowHalo<T>{u_top, u_bot, u_left, u_right, ld},  \
                            cin, din, u_out, nseg, nyl, rows_out, nx,       \
                            omega, one_minus_omega, stream);                \
  }
