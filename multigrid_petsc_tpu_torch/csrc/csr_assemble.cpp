// CSR assembly of (possibly composite) level operators, for the port's
// explicit sparse backend (ops/sparse.py).  Host C++, built with the host
// compiler (not nvcc) into its own library and loaded with ctypes.
//
// The port's own copy of the JAX package's native/csr_assemble.cpp: it
// builds the same operator the matrix-free path applies (diag 5-point
// blocks + R*A_f / A_f*P coupling blocks between merged grids) as CSR
// arrays (reference: src/solver.c:185-556 fillJacobians/
// fillRestrictionPortion/fillProlongationPortion + src/matbuild.c:355-442
// stencil composition), around a per-row accumulator.  Row ordering:
// grid-after-grid within the level, row = i*nx + j (i = y), matching the
// Python side's state flattening.  Every entry, and its place in its row,
// is the original's; two changes make it scale to 8193^2:
//   * the composed transfer stencils are made once per grid pair, not
//     once per row;
//   * the prolongation portion visits only the coarse points I, J whose
//     stencil covers the neighbour (a handful), not all nc^2 of them, so
//     the assembly is O(rows) instead of O(N_fine * N_coarse).
//
// Exposed C ABI (ctypes):
//   assemble_level(npts, mesh_type, gids, n_g, include_diag,
//                  include_couplings, indptr, indices, data, nnz_cap)
//     -> nnz on success, -1 if nnz_cap too small, -2 on bad input.
//     With indices == NULL it only counts: nnz, nothing written (the
//     caller sizes its arrays exactly from it).
//   level_rows(npts, gids, n_g) -> total rows.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr double kPi = 3.14159265358979323846;

int grid_n(int npts, int g) { return ((npts - 1) >> g) - 1; }

// floor(a / b) for b > 0 and any sign of a.
int floor_div(int a, int b) { return a >= 0 ? a / b : -((-a + b - 1) / b); }

// Physical y coordinate of interior row i (0-based) on a grid with n
// interior points, for the three mesh families
// (reference: src/mesh.c:144-175; x is always uniform).
double phys_y(int mesh_type, int n, int i) {
  double eta = double(i + 1) / double(n + 1);
  switch (mesh_type) {
    case 1:  // cosine stretch (NONUNIFORM1)
      return 1.0 - std::cos(kPi * 0.5 * eta);
    case 2:  // exponential stretch (NONUNIFORM2)
      return (std::exp(2.0 * eta) - 1.0) / (std::exp(2.0) - 1.0);
    default:
      return eta;
  }
}

// Metric terms (m0, m1, m2, m3) at height y
// (reference: src/mesh.c:29-107 with unit bounds).
void metrics_at(int mesh_type, double y, double m[4]) {
  switch (mesh_type) {
    case 1: {
      double t = 1.0 - (1.0 - y) * (1.0 - y);
      m[0] = 1.0;
      m[1] = 4.0 / (kPi * kPi * t);
      m[2] = 0.0;
      m[3] = -2.0 * (1.0 - y) / (kPi * std::sqrt(t * t * t));
      break;
    }
    case 2: {
      double e2m1 = std::exp(2.0) - 1.0;
      double d = y * e2m1 + 1.0;
      double t = e2m1 * e2m1 / (d * d);
      m[0] = 1.0;
      m[1] = 0.25 * t;
      m[2] = 0.0;
      m[3] = -0.5 * t;
      break;
    }
    default:
      m[0] = 1.0; m[1] = 1.0; m[2] = 0.0; m[3] = 0.0;
  }
}

// 5-point coefficients [S, W, C, E, N] at interior point (i, j) of an
// n x n grid (reference: src/problem.c:3-22 OpA; neighbor identification
// per src/solver.c:218-252: S = u[i-1,j], W = u[i,j-1], ...).
void op_a(int mesh_type, int n, int i, double a[5]) {
  double h = 1.0 / double(n + 1);
  double h2 = h * h;
  double m[4];
  metrics_at(mesh_type, phys_y(mesh_type, n, i), m);
  a[0] = m[1] / h2 - m[3] / (2.0 * h);   // S
  a[1] = m[0] / h2 - m[2] / (2.0 * h);   // W
  a[2] = -2.0 * (m[0] + m[1]) / h2;      // C
  a[3] = m[0] / h2 + m[2] / (2.0 * h);   // E
  a[4] = m[1] / h2 + m[3] / (2.0 * h);   // N
}

// Composed transfer stencil for a `gap`-level jump: sizes 3, 7, 15, ...
// (reference: src/matbuild.c:336-396).  base = {1,2,1;2,4,2;1,2,1}*scale.
std::vector<double> composed_stencil(double scale, int gap, int* size_out) {
  int s = 3;
  std::vector<double> cur(9);
  const double b3[3] = {1.0, 2.0, 1.0};
  for (int i = 0; i < 3; i++)
    for (int j = 0; j < 3; j++) cur[i * 3 + j] = b3[i] * b3[j] * scale;
  std::vector<double> base = cur;
  for (int level = 1; level < gap; level++) {
    int ns = (s + 1) * 2 - 1;
    std::vector<double> nxt(ns * ns, 0.0);
    for (int il = 0; il < s; il++)
      for (int jl = 0; jl < s; jl++) {
        int iu = 2 * il;  // 2*(il+1)-1 - 1
        int ju = 2 * jl;
        double w = cur[il * s + jl];
        for (int a = 0; a < 3; a++)
          for (int b = 0; b < 3; b++)
            nxt[(iu + a) * ns + (ju + b)] += base[a * 3 + b] * w;
      }
    cur.swap(nxt);
    s = ns;
  }
  *size_out = s;
  return cur;
}

struct RowAccum {
  // Sparse row accumulator keyed by global column.
  std::vector<int64_t> cols;
  std::vector<double> vals;
  void add(int64_t c, double v) {
    for (size_t k = 0; k < cols.size(); k++) {
      if (cols[k] == c) { vals[k] += v; return; }
    }
    cols.push_back(c);
    vals.push_back(v);
  }
  void clear() { cols.clear(); vals.clear(); }
};

}  // namespace

extern "C" {

int64_t level_rows(int npts, const int* gids, int n_g) {
  int64_t rows = 0;
  for (int k = 0; k < n_g; k++) {
    int64_t n = grid_n(npts, gids[k]);
    rows += n * n;
  }
  return rows;
}

// Assemble the composite level operator in CSR.  Returns nnz (>= 0) or a
// negative error code.
int64_t assemble_level(int npts, int mesh_type, const int* gids, int n_g,
                       int include_diag, int include_couplings,
                       int64_t* indptr, int32_t* indices, double* data,
                       int64_t nnz_cap) {
  if (n_g <= 0 || npts < 5) return -2;
  std::vector<int> ns(n_g);
  std::vector<int64_t> offs(n_g + 1, 0);
  for (int k = 0; k < n_g; k++) {
    ns[k] = grid_n(npts, gids[k]);
    if (ns[k] < 1) return -2;
    offs[k + 1] = offs[k] + int64_t(ns[k]) * ns[k];
  }

  // Composed restriction (scale 1/16) and prolongation (1/4) stencils of
  // every grid pair, indexed by the pair's gap.
  int max_gap = 0;
  for (int k = 1; k < n_g; k++)
    if (gids[k] - gids[0] > max_gap) max_gap = gids[k] - gids[0];
  std::vector<std::vector<double>> res_st(max_gap + 1), pro_st(max_gap + 1);
  std::vector<int> st_size(max_gap + 1, 0);
  for (int gap = 1; gap <= max_gap; gap++) {
    res_st[gap] = composed_stencil(1.0 / 16.0, gap, &st_size[gap]);
    pro_st[gap] = composed_stencil(1.0 / 4.0, gap, &st_size[gap]);
  }

  const bool count_only = indices == nullptr;
  int64_t nnz = 0;
  int64_t row = 0;
  RowAccum acc;
  if (!count_only) indptr[0] = 0;

  for (int k = 0; k < n_g; k++) {
    int n = ns[k];
    for (int i = 0; i < n; i++) {
      double a[5];
      op_a(mesh_type, n, i, a);
      for (int j = 0; j < n; j++, row++) {
        acc.clear();
        if (include_diag) {
          // 5-point block (reference: fillJacobians src/solver.c:185-253;
          // out-of-range neighbors dropped = eliminated Dirichlet).
          int64_t base = offs[k];
          if (i > 0) acc.add(base + int64_t(i - 1) * n + j, a[0]);
          if (j > 0) acc.add(base + int64_t(i) * n + (j - 1), a[1]);
          acc.add(base + int64_t(i) * n + j, a[2]);
          if (j + 1 < n) acc.add(base + int64_t(i) * n + (j + 1), a[3]);
          if (i + 1 < n) acc.add(base + int64_t(i + 1) * n + j, a[4]);
        }
        if (include_couplings) {
          // Restriction portion R*A_f: this row is on grid k; couple to
          // every FINER grid kf < k (reference: fillRestrictionPortion
          // src/solver.c:255-345).
          for (int kf = 0; kf < k; kf++) {
            int gap = gids[k] - gids[kf];
            const int s = st_size[gap];
            const std::vector<double>& res = res_st[gap];
            int nf = ns[kf];
            int fac = 1 << gap;
            int p0 = fac * (i + 1) - 1 - s / 2;
            int q0 = fac * (j + 1) - 1 - s / 2;
            for (int p = p0; p < p0 + s; p++) {
              if (p < 0 || p >= nf) continue;
              double af[5];
              op_a(mesh_type, nf, p, af);
              for (int q = q0; q < q0 + s; q++) {
                if (q < 0 || q >= nf) continue;
                double w = res[(p - p0) * s + (q - q0)];
                if (w == 0.0) continue;
                int64_t base = offs[kf];
                if (p > 0) acc.add(base + int64_t(p - 1) * nf + q, w * af[0]);
                if (q > 0) acc.add(base + int64_t(p) * nf + (q - 1), w * af[1]);
                acc.add(base + int64_t(p) * nf + q, w * af[2]);
                if (q + 1 < nf) acc.add(base + int64_t(p) * nf + (q + 1), w * af[3]);
                if (p + 1 < nf) acc.add(base + int64_t(p + 1) * nf + q, w * af[4]);
              }
            }
          }
          // Prolongation portion A_f*P: this row is on grid k (finer);
          // couple to every COARSER grid kc > k (reference:
          // fillProlongationPortion src/solver.c:347-487 — the 9 edge and
          // corner cases there are subsumed by dropping out-of-range
          // neighbors here).
          for (int kc = k + 1; kc < n_g; kc++) {
            int gap = gids[kc] - gids[k];
            const int s = st_size[gap];
            const std::vector<double>& pro = pro_st[gap];
            int nc = ns[kc];
            int fac = 1 << gap;
            // Row (i,j)'s A_f entries sit at neighbors (ni,nj); each
            // neighbor n receives P weight pro[ni-p0(I), nj-q0(J)] from
            // coarse (I,J) with p0(I) = fac*(I+1)-1-s/2.
            const int di[5] = {-1, 0, 0, 0, 1};
            const int dj[5] = {0, -1, 0, 1, 0};
            for (int t = 0; t < 5; t++) {
              int ni = i + di[t], nj = j + dj[t];
              if (ni < 0 || ni >= n || nj < 0 || nj >= n) continue;
              double av = a[t];
              // Coarse rows I with ni - p0(I) in [0, s):
              // p0(I) = fac*I + fac - 1 - s/2; let u = ni - p0(I) =
              // c - fac*(I + 1) with c = ni + 1 + s/2, so u in [0, s) iff
              // floor((c - s)/fac) <= I <= floor(c/fac) - 1.  Visiting
              // only that range (ascending, as the full scan would) keeps
              // every entry and its order.
              const int ci = ni + 1 + s / 2, cj = nj + 1 + s / 2;
              const int i_lo = std::max(0, floor_div(ci - s, fac));
              const int i_hi = std::min(nc - 1, floor_div(ci, fac) - 1);
              const int j_lo = std::max(0, floor_div(cj - s, fac));
              const int j_hi = std::min(nc - 1, floor_div(cj, fac) - 1);
              for (int I = i_lo; I <= i_hi; I++) {
                int u = ni - (fac * (I + 1) - 1 - s / 2);
                if (u < 0 || u >= s) continue;
                for (int J = j_lo; J <= j_hi; J++) {
                  int v = nj - (fac * (J + 1) - 1 - s / 2);
                  if (v < 0 || v >= s) continue;
                  double w = pro[u * s + v];
                  if (w == 0.0) continue;
                  acc.add(offs[kc] + int64_t(I) * nc + J, av * w);
                }
              }
            }
          }
        }
        if (count_only) {
          nnz += int64_t(acc.cols.size());
          continue;
        }
        if (nnz + int64_t(acc.cols.size()) > nnz_cap) return -1;
        for (size_t t = 0; t < acc.cols.size(); t++) {
          indices[nnz] = int32_t(acc.cols[t]);
          data[nnz] = acc.vals[t];
          nnz++;
        }
        indptr[row + 1] = nnz;
      }
    }
  }
  return nnz;
}

}  // extern "C"
