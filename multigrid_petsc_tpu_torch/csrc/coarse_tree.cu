// Single-launch coarse sub-V-cycle for Hopper (sm_90a), bound through a
// plain C interface (ctypes).
//
// Replaces multigrid_petsc_tpu/ops/pallas/coarse_tree_kernel.py
// (make_coarse_tree_solver): below ~1023^2 the whole remaining hierarchy
// (zero-guess down visits with full-weighting restriction, the dense
// direct coarsest solve, bilinear prolongation + correction + post-smooth)
// runs as ONE cooperative launch instead of ~2 visits x ~8 levels of
// launches.
//
// What bounds it on the H100: latency more than bytes.  From 1023^2 down
// the level arrays total ~25 MB, which fits the 50 MB L2, so after the
// entry read the passes run out of L2; the cost is the number of dependent
// phases.  Design: one persistent grid of co-resident blocks (grid size
// <= occupancy x SMs, checked before launch) walks the levels with
// grid-stride loops; cooperative_groups::this_grid().sync() separates the
// phases.  A Jacobi step writes the new iterate into the level's second
// buffer (ping-pong), so each step costs one grid sync.  The coarsest
// solve is an f32 dot of each row of the host-inverted (f64 -> f32) dense
// operator with the coarsest right-hand side.  All buffers are given by
// the caller in one scratch allocation; the kernel allocates nothing.  The
// levels' (alpha, beta) schedules are one f32 buffer in device memory, so
// the kernel-parameter block bounds no sweep count.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "mg_common.cuh"

namespace cg = cooperative_groups;

namespace {

using mg::prolong_at;

constexpr int MAXL = 12;
constexpr int NTHREADS = 256;

struct TreeLevel {
  int ny, nx, k;
  const float* steps;  // k (alpha, beta) pairs, in device memory
  const float* cs;
  const float* cw;
  const float* cc;
  const float* ce;
  const float* cn;
  const float* b;  // level rhs (entry level: the caller's input)
  float* ua;       // iterate buffers (ping-pong)
  float* ub;
  float* p;        // smoother direction
};

struct TreeParams {
  int L;
  const float* a_inv;  // (N, N) coarsest inverse, or null: smooth instead
  float* rr;           // residual scratch, entry-level size
  TreeLevel lv[MAXL];
};
// The whole parameter block (TreeParams + out) is passed by value: it must
// stay within the 4 KB kernel-parameter limit.
static_assert(sizeof(TreeParams) + sizeof(float*) <= 4096,
              "coarse-tree parameters exceed the kernel-parameter limit");

__device__ __forceinline__ float apply_at(const TreeLevel& v, const float* u,
                                          int y, int x) {
  const int i = y * v.nx + x;
  float s = y > 0 ? u[i - v.nx] : 0.f;
  float n = y < v.ny - 1 ? u[i + v.nx] : 0.f;
  float w = x > 0 ? u[i - 1] : 0.f;
  float e = x < v.nx - 1 ? u[i + 1] : 0.f;
  return v.cc[y] * u[i] + v.cs[y] * s + v.cn[y] * n + v.cw[y] * w +
         v.ce[y] * e;
}

// k smoother steps on level v; returns the buffer that holds the result.
__device__ float* smooth_level(const TreeLevel& v, float* u, bool zero_guess,
                               cg::grid_group& grid, int gtid, int gsz) {
  const int n = v.ny * v.nx;
  float* other = (u == v.ua) ? v.ub : v.ua;
  for (int s = 0; s < v.k; ++s) {
    const float a = v.steps[2 * s], bt = v.steps[2 * s + 1];
    if (zero_guess && s == 0) {
      for (int i = gtid; i < n; i += gsz) {
        float pn = 0.f + a * ((1.f / v.cc[i / v.nx]) * v.b[i]);
        v.p[i] = pn;
        u[i] = pn;
      }
    } else {
      for (int i = gtid; i < n; i += gsz) {
        int y = i / v.nx, x = i - y * v.nx;
        float z = (1.f / v.cc[y]) * (v.b[i] - apply_at(v, u, y, x));
        float pn = (s == 0 ? 0.f : bt * v.p[i]) + a * z;
        v.p[i] = pn;
        other[i] = u[i] + pn;
      }
      float* t = u;
      u = other;
      other = t;
    }
    grid.sync();
  }
  return u;
}

__global__ void __launch_bounds__(NTHREADS)
coarse_tree_kernel(TreeParams P, float* out) {
  cg::grid_group grid = cg::this_grid();
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  const int gsz = gridDim.x * blockDim.x;
  const int L = P.L;
  float* ucur[MAXL];

  // Down leg: zero-guess smooth, residual, full-weighting restriction.
  for (int l = 0; l < L - 1; ++l) {
    const TreeLevel& v = P.lv[l];
    float* u = smooth_level(v, v.ua, true, grid, gtid, gsz);
    ucur[l] = u;
    const int n = v.ny * v.nx;
    for (int i = gtid; i < n; i += gsz) {
      int y = i / v.nx, x = i - y * v.nx;
      P.rr[i] = v.b[i] - apply_at(v, u, y, x);
    }
    grid.sync();
    const TreeLevel& c = P.lv[l + 1];
    float* bc = const_cast<float*>(c.b);
    for (int i = gtid; i < c.ny * c.nx; i += gsz) {
      int I = i / c.nx, J = i - I * c.nx;
      const float* r0 = P.rr + (2 * I) * v.nx + 2 * J;
      float ycol[3];
      for (int d = 0; d < 3; ++d)
        ycol[d] = r0[d] + 2.f * r0[v.nx + d] + r0[2 * v.nx + d];
      bc[i] = 0.0625f * (ycol[0] + 2.f * ycol[1] + ycol[2]);
    }
    grid.sync();
  }

  // Coarsest level: dense direct solve, or zero-guess smoothing.
  {
    const TreeLevel& v = P.lv[L - 1];
    const int N = v.ny * v.nx;
    if (P.a_inv != nullptr) {
      for (int i = gtid; i < N; i += gsz) {
        float acc = 0.f;
        for (int j = 0; j < N; ++j) acc += P.a_inv[i * N + j] * v.b[j];
        v.ua[i] = acc;
      }
      ucur[L - 1] = v.ua;
      grid.sync();
    } else {
      ucur[L - 1] = smooth_level(v, v.ua, true, grid, gtid, gsz);
    }
  }

  // Up leg: correct with the prolonged coarse solution, then post-smooth.
  for (int l = L - 2; l >= 0; --l) {
    const TreeLevel& v = P.lv[l];
    const TreeLevel& c = P.lv[l + 1];
    float* u = ucur[l];
    const float* e = ucur[l + 1];
    for (int i = gtid; i < v.ny * v.nx; i += gsz) {
      int y = i / v.nx, x = i - y * v.nx;
      u[i] = u[i] + prolong_at(e, y, x, c.ny, c.nx);
    }
    grid.sync();
    ucur[l] = smooth_level(v, u, false, grid, gtid, gsz);
  }
  if (ucur[0] != out) {
    const TreeLevel& v = P.lv[0];
    for (int i = gtid; i < v.ny * v.nx; i += gsz) out[i] = ucur[0][i];
  }
}

}  // namespace

extern "C" {

// Launch the sub-V-cycle over L levels.
//   shapes: 2L ints (ny, nx per level); ks: L sweep counts;
//   steps:  device f32, (alpha, beta) pairs of level 0, then level 1, ...
//   ptrs:   host array of 10L device pointers, per level
//           (cs, cw, cc, ce, cn, b, ua, ub, p, unused); level 0's b is the
//           input and its ub must be `out`;
//   a_inv:  device (N, N) coarsest inverse, or null to smooth there.
// Returns a cudaError_t value; cudaErrorCooperativeLaunchTooLarge (or any
// refusal) is returned, never hidden.
int mg_coarse_tree(int L, const int* shapes, const int* ks,
                   const float* steps, const unsigned long long* ptrs,
                   const float* a_inv, float* rr, float* out, void* stream) {
  if (L < 2 || L > MAXL) return (int)cudaErrorInvalidValue;
  TreeParams P;
  P.L = L;
  P.a_inv = a_inv;
  P.rr = rr;
  int off = 0;
  for (int l = 0; l < L; ++l) {
    TreeLevel& v = P.lv[l];
    v.ny = shapes[2 * l];
    v.nx = shapes[2 * l + 1];
    v.k = ks[l];
    if (v.k < 1) return (int)cudaErrorInvalidValue;
    v.steps = steps + off;
    off += 2 * v.k;
    const unsigned long long* q = ptrs + 10 * l;
    v.cs = (const float*)q[0];
    v.cw = (const float*)q[1];
    v.cc = (const float*)q[2];
    v.ce = (const float*)q[3];
    v.cn = (const float*)q[4];
    v.b = (const float*)q[5];
    v.ua = (float*)q[6];
    v.ub = (float*)q[7];
    v.p = (float*)q[8];
  }
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  int err = (int)cudaGetDevice(&dev);
  if (!err) err = (int)cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!err && !coop) return (int)cudaErrorNotSupported;
  if (!err) err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (!err)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, coarse_tree_kernel, NTHREADS, 0);
  if (err) return err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int n0 = P.lv[0].ny * P.lv[0].nx;
  int blocks = per_sm * sms;
  const int needed = (n0 + NTHREADS - 1) / NTHREADS;
  if (blocks > needed) blocks = needed;
  void* args[] = {(void*)&P, (void*)&out};
  err = (int)cudaLaunchCooperativeKernel((void*)coarse_tree_kernel,
                                         dim3(blocks), dim3(NTHREADS), args, 0,
                                         (cudaStream_t)stream);
  if (err) return err;
  return (int)cudaGetLastError();
}

}  // extern "C"
