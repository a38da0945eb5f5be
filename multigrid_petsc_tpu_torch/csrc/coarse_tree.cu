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
// phases, each ended by a barrier, and the instructions and L2 round trips
// of each.  Design:
// - One persistent grid of co-resident blocks of 1024 threads, one a SM
//   (grid size from the plan's occupancy query), walks the large levels
//   with grid-stride loops; cooperative_groups::this_grid().sync()
//   separates their phases (~1.1 us a barrier at 132 blocks:
//   scripts/time_coarse_tree.py's probe; a larger grid's costs more).
// - The small levels (from the plan's tail_from down, ny <= the host's
//   TREE_TAIL_MAX_N) run as one V-cycle inside block 0, with block-stride
//   loops and __syncthreads(), between two grid syncs; a tree whose entry
//   level is small runs in one block with no grid sync at all.  The
//   tail's buffers live in block 0's dynamic shared memory (its entry
//   level's b and solution stay in global memory, where the grid reads
//   them); with one block a SM that costs no co-resident block.
// - Fewer phases: the zero-guess steps 0 and 1 are one phase (step 1 forms
//   step 0's u = alpha_0 D^-1 b at its five points); the residual is
//   formed inside the restriction (each coarse point computes the 3 x 3
//   fine residuals it weighs); the last phase has no barrier.  A level of
//   k steps costs k phases down (2 at k = 1) and k + 1 up, instead of
//   k + 2 and k + 1.  The coarse correction keeps its own phase: formed
//   inside post-smooth step 0 (u + P e at its five points) it measured
//   slower on the main path's tree (PERF.md, K4).  Every expression
//   keeps the term order of the plain version (coarse_tree_plain).
// - Cheap points: D^-1 is a column the plan makes once (torch's 1 / cc,
//   the plain version's), so no step divides; a thread steps its (row,
//   column) through the grid-stride loop with no index division.
// - A Jacobi step writes the new iterate into the level's other buffer
//   (ping-pong): after the down leg the iterate is in buffer (k - 1) & 1,
//   after the up leg (2k - 1 steps) always in ub, which is `out` on the
//   entry level.
// - The host builds the launch plan once per solver (mg_coarse_tree_plan:
//   the TreeParams image with every pointer but the entry level's b and
//   out, the grid size, the tail's shared memory); a call (mg_coarse_tree)
//   only sets those two and launches.  The kernel allocates nothing.  The
//   levels' (alpha, beta) schedules are one f32 buffer in device memory,
//   so the kernel-parameter block bounds no sweep count.
// - bf16 storage (mg_coarse_tree_bf16): only the entry level's b and out
//   are bf16; every level's arithmetic, its buffers (the entry level's
//   iterates too), the tail's shared memory and the coefficient columns
//   are f32 (the plan's f32 copies), as the JAX kernel upcasts its b and
//   coefficients.  b is read as f32 where it is read (TreeLevel::b16);
//   the last post-smoothing step of the entry level rounds its result
//   once into out.  The coarsest inverse is the plan's: rounded to bf16
//   before use, as JAX does, and applied in f32.  The kernel is
//   instantiated per storage type (the teams' BF16), so the f32 one tests
//   for no bf16 pointer.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstring>

#include "mg_common.cuh"

namespace cg = cooperative_groups;

namespace {

using mg::prolong_at;

constexpr int MAXL = 12;
constexpr int NTHREADS = 1024;

struct TreeLevel {
  int ny, nx, k;
  const float* steps;  // k (alpha, beta) pairs, in device memory
  const float* cs;
  const float* cw;
  const float* cc;
  const float* ce;
  const float* cn;
  const float* dinv;  // 1 / cc, made once by the plan
  const float* b;     // level rhs (entry level: the caller's input)
  const __nv_bfloat16* b16;  // or the entry level's rhs in bf16 (b unused)
  float* ua;          // iterate buffers (ping-pong; entry level: ub is out)
  float* ub;
  float* p;           // smoother direction
};

struct TreeParams {
  int L;
  int tail_from;       // first level block 0 runs alone; L: none
  int blocks;          // cooperative grid size
  int smem;            // bytes of the tail's buffers in shared memory
  int bf16;            // the entry level's b and out are bf16
  const float* a_inv;  // (N, N) coarsest inverse, or null: smooth instead
  __nv_bfloat16* out16;  // the bf16 output (entry level's ub is scratch)
  TreeLevel lv[MAXL];
};
// The parameter block is passed by value (__grid_constant__: the kernel
// reads it by reference, with no per-thread copy); it must stay within the
// 4 KB kernel-parameter limit.
static_assert(sizeof(TreeParams) <= 4096,
              "coarse-tree parameters exceed the kernel-parameter limit");

// The levels a team works on: the parameter block's, or the tail's copies
// with their buffers in shared memory.
struct Tree {
  const TreeLevel* lv;
  int L;
  const float* a_inv;
};

// The threads a phase is shared by, and the barrier that ends it; BF16:
// the launch's entry level is bf16 storage.
template <bool BF16_>
struct GridTeam {
  static constexpr bool BF16 = BF16_;
  cg::grid_group g;
  int rank, size;
  __device__ void sync() { g.sync(); }
};

template <bool BF16_>
struct BlockTeam {
  static constexpr bool BF16 = BF16_;
  int rank, size;
  __device__ void sync() { __syncthreads(); }
};

// The level's rhs at point i, in f32.
template <class Team>
__device__ __forceinline__ float rhs(const TreeLevel& v, int i) {
  if constexpr (Team::BF16)
    if (v.b16 != nullptr) return __bfloat162float(v.b16[i]);
  return v.b[i];
}

__device__ __forceinline__ float* buf(const TreeLevel& v, int j) {
  return j ? v.ub : v.ua;
}

// The iterate after the zero-guess down leg: k - 1 ping-pong steps.
__device__ __forceinline__ float* down_result(const TreeLevel& v) {
  return buf(v, (v.k - 1) & 1);
}

// Level l's solution once its up leg (or the coarsest solve) is done.
__device__ __forceinline__ const float* solution(const Tree& tr, int l) {
  const TreeLevel& v = tr.lv[l];
  if (l < tr.L - 1) return v.ub;
  return tr.a_inv != nullptr ? v.ua : down_result(v);
}

// body(i, y, x) for each point i = y * nx + x of the team's share of an
// ny x nx grid; the thread steps its (y, x) with no division per point.
template <class Team, class F>
__device__ __forceinline__ void for_points(const Team& t, int ny, int nx,
                                           F body) {
  const int dy = t.size / nx, dx = t.size - dy * nx;
  int y = t.rank / nx, x = t.rank - y * nx;
  for (int i = t.rank; y < ny; i += t.size) {
    body(i, y, x);
    x += dx;
    y += dy;
    if (x >= nx) {
      x -= nx;
      ++y;
    }
  }
}

// One smoother step on level v into dst (and p): u_at(y, x) is the
// iterate at a point of the domain (outside it reads 0), p_prev(i, u_i)
// the previous direction; `first` starts the direction from 0 (step 0
// from a guess).  Same expressions as the plain version's step.  dst16
// (the entry level's last step in bf16): the new iterate rounded into it
// instead of dst.
template <class Team, class UAt, class PAt>
__device__ __forceinline__ void step_phase(const Team& t, const TreeLevel& v,
                                           float a, float bt, bool first,
                                           UAt u_at, PAt p_prev, float* dst,
                                           __nv_bfloat16* dst16 = nullptr) {
  for_points(
      t, v.ny, v.nx,
      [&](int i, int y, int x) {
        const float uc = u_at(y, x);
        const float s = y > 0 ? u_at(y - 1, x) : 0.f;
        const float n = y < v.ny - 1 ? u_at(y + 1, x) : 0.f;
        const float w = x > 0 ? u_at(y, x - 1) : 0.f;
        const float e = x < v.nx - 1 ? u_at(y, x + 1) : 0.f;
        const float au = v.cc[y] * uc + v.cs[y] * s + v.cn[y] * n +
                         v.cw[y] * w + v.ce[y] * e;
        const float z = v.dinv[y] * (rhs<Team>(v, i) - au);
        const float pn = (first ? 0.f : bt * p_prev(i, uc)) + a * z;
        v.p[i] = pn;
        if (Team::BF16 && dst16 != nullptr)
          dst16[i] = __float2bfloat16_rn(uc + pn);
        else
          dst[i] = uc + pn;
      });
}

// The iterate stored in u.
struct LoadAt {
  const float* u;
  int nx;
  __device__ float operator()(int y, int x) const { return u[y * nx + x]; }
};

// k smoother steps from the zero guess, a barrier after each phase; the
// result in down_result(v).
template <class Team>
__device__ void smooth_from_zero(Team& t, const TreeLevel v) {
  const float* st = v.steps;
  const float a0 = st[0];
  if (v.k == 1) {
    for_points(t, v.ny, v.nx, [&](int i, int y, int) {
      v.ua[i] = a0 * (v.dinv[y] * rhs<Team>(v, i));
    });
    t.sync();
    return;
  }
  // Steps 0 and 1 in one phase: step 0's iterate (and direction) is
  // alpha_0 D^-1 b, formed at each of step 1's five points.
  step_phase(
      t, v, st[2], st[3], false,
      [&](int y, int x) {
        return a0 * (v.dinv[y] * rhs<Team>(v, y * v.nx + x));
      },
      [](int, float u0) { return u0; }, v.ub);
  t.sync();
  for (int s = 2; s < v.k; ++s) {
    step_phase(t, v, st[2 * s], st[2 * s + 1], false,
               LoadAt{buf(v, (s - 1) & 1), v.nx},
               [&](int i, float) { return v.p[i]; }, buf(v, s & 1));
    t.sync();
  }
}

// Down leg on level v: zero-guess smoothing, then the full-weighting
// restriction of its residual into c.b, each coarse point forming the
// 3 x 3 fine residuals b - A u it weighs, a fine row at a time.  The
// levels come by value: held in registers, their fields are not re-read
// after each store (the tail's copies sit in shared memory, which a
// store through a generic pointer could alias).
template <class Team>
__device__ void down_level(Team& t, const TreeLevel v, const TreeLevel c) {
  smooth_from_zero(t, v);
  const float* u = down_result(v);
  float* bc = const_cast<float*>(c.b);
  for_points(
      t, c.ny, c.nx,
      [&](int i, int I, int J) {
        const int y0 = 2 * I, x0 = 2 * J;
        // u on row y, columns x0 - 1 .. x0 + 3 (0 outside the domain); the
        // rows above and below the footprint need x0 .. x0 + 2 only.
        auto row = [&](int y, bool edge, float (&w)[5]) {
          const bool yin = y >= 0 && y < v.ny;
#pragma unroll
          for (int d = 0; d < 5; ++d) {
            const int x = x0 - 1 + d;
            const bool need = !edge || (d >= 1 && d <= 3);
            w[d] = need && yin && x >= 0 && x < v.nx ? u[y * v.nx + x] : 0.f;
          }
        };
        float up[5], mid[5], dn[5], ycol[3];
        row(y0 - 1, true, up);
        row(y0, false, mid);
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const int y = y0 + a;
          row(y + 1, a == 2, dn);
#pragma unroll
          for (int d = 0; d < 3; ++d) {
            const float au = v.cc[y] * mid[d + 1] + v.cs[y] * up[d + 1] +
                             v.cn[y] * dn[d + 1] + v.cw[y] * mid[d] +
                             v.ce[y] * mid[d + 2];
            const float r = rhs<Team>(v, y * v.nx + x0 + d) - au;
            // (r0 + 2 r1) + r2: the y pass of restrict_fw.
            ycol[d] = a == 0 ? r : a == 1 ? ycol[d] + 2.f * r : ycol[d] + r;
          }
#pragma unroll
          for (int d = 0; d < 5; ++d) {
            up[d] = mid[d];
            mid[d] = dn[d];
          }
        }
        bc[i] = 0.0625f * (ycol[0] + 2.f * ycol[1] + ycol[2]);
      });
  t.sync();
}

// Coarsest level: the dense direct solve, or zero-guess smoothing.
template <class Team>
__device__ void coarsest(Team& t, const Tree& tr) {
  const TreeLevel v = tr.lv[tr.L - 1];
  if (tr.a_inv == nullptr) {
    smooth_from_zero(t, v);
    return;
  }
  const int N = v.ny * v.nx;
  for_points(t, v.ny, v.nx, [&](int i, int, int) {
    float acc = 0.f;
    for (int j = 0; j < N; ++j) acc += tr.a_inv[i * N + j] * v.b[j];
    v.ua[i] = acc;
  });
  t.sync();
}

// Up leg on level v: the correction with the prolonged coarse solution
// e, in place, then k steps.  The launch's (or the tail's) last phase
// ends without a barrier (`last`).  out16 (the entry level in bf16): its
// last step's result rounded into it.
template <class Team>
__device__ void up_level(Team& t, const TreeLevel v, const TreeLevel c,
                         const float* e, bool last,
                         __nv_bfloat16* out16 = nullptr) {
  const float* st = v.steps;
  float* u = down_result(v);
  const int d = (v.k - 1) & 1;
  for_points(t, v.ny, v.nx, [&](int i, int y, int x) {
    u[i] = u[i] + prolong_at(e, y, x, c.ny, c.nx);
  });
  t.sync();
  for (int s = 0; s < v.k; ++s) {
    step_phase(t, v, st[2 * s], st[2 * s + 1], s == 0,
               LoadAt{buf(v, (d + s) & 1), v.nx},
               [&](int i, float) { return v.p[i]; }, buf(v, (d + s + 1) & 1),
               s == v.k - 1 ? out16 : nullptr);
    if (!(last && s == v.k - 1)) t.sync();
  }
}

// Levels tail_from .. L - 1 as one V-cycle inside block 0, on copies of
// their levels (in shared memory, `lv`) whose buffers are in shared memory
// too, but for those of the tail's entry level that the grid reads or
// writes: its b and ub (its rhs and solution; or the caller's input and
// out), and its ua too where it is the coarsest level, whose solution may
// be there (mg_coarse_tree_plan counts the same).
template <bool BF16>
__device__ void tail_cycle(const TreeParams& P, TreeLevel* lv, float* smem) {
  BlockTeam<BF16> t{(int)threadIdx.x, (int)blockDim.x};
  const int L = P.L, T = P.tail_from;
  if (threadIdx.x == 0) {
    for (int l = T; l < L; ++l) {
      lv[l] = P.lv[l];
      const int n = lv[l].ny * lv[l].nx;
      if (l > T) {
        lv[l].b = smem;
        lv[l].ub = smem + n;
        smem += 2 * n;
      }
      if (l > T || T < L - 1) {
        lv[l].ua = smem;
        smem += n;
      }
      lv[l].p = smem;
      smem += n;
    }
  }
  __syncthreads();
  const Tree tr{lv, L, P.a_inv};
  for (int l = T; l < L - 1; ++l) down_level(t, lv[l], lv[l + 1]);
  coarsest(t, tr);
  // The tail's last phase is followed by the grid sync or the kernel's end.
  for (int l = L - 2; l >= T; --l)
    up_level(t, lv[l], lv[l + 1], solution(tr, l + 1), l == T,
             l == 0 ? P.out16 : nullptr);
}

template <bool BF16>
__global__ void __launch_bounds__(NTHREADS, 1)
coarse_tree_kernel(const __grid_constant__ TreeParams P) {
  extern __shared__ float tail_smem[];
  __shared__ TreeLevel tail_lv[MAXL];
  GridTeam<BF16> g{cg::this_grid(),
                   (int)(blockIdx.x * blockDim.x + threadIdx.x),
                   (int)(gridDim.x * blockDim.x)};
  const Tree tr{P.lv, P.L, P.a_inv};
  const int L = P.L, T = P.tail_from;
  const int top = T < L - 1 ? T : L - 1;  // grid-wide levels above the tail
  for (int l = 0; l < top; ++l) down_level(g, P.lv[l], P.lv[l + 1]);
  if (T == L) {
    coarsest(g, tr);
  } else {
    if (blockIdx.x == 0) tail_cycle<BF16>(P, tail_lv, tail_smem);
    if (T > 0) g.sync();
  }
  for (int l = top - 1; l >= 0; --l)
    up_level(g, P.lv[l], P.lv[l + 1], solution(tr, l + 1), l == 0,
             l == 0 ? P.out16 : nullptr);
}

// The instantiation a plan launches.
const void* tree_kernel(const TreeParams& P) {
  return P.bf16 ? (const void*)coarse_tree_kernel<true>
                : (const void*)coarse_tree_kernel<false>;
}

}  // namespace

extern "C" {

// Bytes of a launch plan (the TreeParams image the caller keeps).
int mg_coarse_tree_plan_bytes() { return (int)sizeof(TreeParams); }

// Build the launch plan of a sub-V-cycle over L levels into `image`
// (mg_coarse_tree_plan_bytes() bytes) and its grid size into *blocks.
//   shapes:    2L ints (ny, nx per level); ks: L sweep counts;
//   steps:     device f32, (alpha, beta) pairs of level 0, then level 1, ...
//   ptrs:      host array of 10L device pointers, per level
//              (cs, cw, cc, ce, cn, dinv, b, ua, ub, p), all f32; level
//              0's b and ub are set per call (the input and `out`; in
//              bf16, mg_coarse_tree_bf16, b is the bf16 input and ub a
//              scratch buffer), the tail's levels' buffers but its entry
//              level's b and ub are not read;
//   a_inv:     device (N, N) coarsest inverse, or null to smooth there;
//   tail_from: the first level block 0 runs alone (0 .. L; L: none);
//   bf16:      the plan's storage type, bf16 (launched by
//              mg_coarse_tree_bf16) or f32 (mg_coarse_tree).
// Returns a cudaError_t value; a tail whose buffers exceed a block's
// shared memory is cudaErrorInvalidValue.
int mg_coarse_tree_plan(int L, const int* shapes, const int* ks,
                        const float* steps, const unsigned long long* ptrs,
                        const float* a_inv, int tail_from, int bf16,
                        void* image, int* blocks) {
  if (L < 2 || L > MAXL || tail_from < 0 || tail_from > L)
    return (int)cudaErrorInvalidValue;
  TreeParams P;
  std::memset(&P, 0, sizeof P);
  P.L = L;
  P.tail_from = tail_from;
  P.bf16 = bf16 != 0;
  P.a_inv = a_inv;
  int off = 0;
  size_t tail_floats = 0;
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
    v.dinv = (const float*)q[5];
    v.b = (const float*)q[6];
    v.ua = (float*)q[7];
    v.ub = (float*)q[8];
    v.p = (float*)q[9];
    // tail_cycle's layout: (b, ub) past the tail's entry level, ua but on
    // an entry level that is the coarsest, p.
    if (l >= tail_from)
      tail_floats += (size_t)(l > tail_from ? 4 : tail_from < L - 1 ? 2 : 1) *
                     v.ny * v.nx;
  }
  int dev = 0, sms = 0, per_sm = 0, coop = 0, optin = 0;
  int err = (int)cudaGetDevice(&dev);
  if (!err)
    err = (int)cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                      dev);
  if (!err && !coop) return (int)cudaErrorNotSupported;
  if (!err)
    err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev);
  if (!err)
    err = (int)cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err) return err;
  if (tail_floats * sizeof(float) > (size_t)optin)
    return (int)cudaErrorInvalidValue;
  P.smem = (int)(tail_floats * sizeof(float));
  const void* kern = tree_kernel(P);
  cudaFuncAttributes attr;
  err = (int)cudaFuncGetAttributes(&attr, kern);
  if (!err && attr.maxDynamicSharedSizeBytes < P.smem)
    err = (int)cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, P.smem);
  if (!err)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kern, NTHREADS, P.smem);
  if (err) return err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  // The whole tree in block 0: one block.  Else one point per thread on
  // the entry level at most.
  const int n0 = P.lv[0].ny * P.lv[0].nx;
  const int needed = tail_from == 0 ? 1 : (n0 + NTHREADS - 1) / NTHREADS;
  P.blocks = per_sm * sms < needed ? per_sm * sms : needed;
  std::memcpy(image, &P, sizeof P);
  *blocks = P.blocks;
  return 0;
}

// One launch of a plan: b (the entry level's rhs) -> out.  A refused
// cooperative launch (cudaErrorCooperativeLaunchTooLarge or any other) is
// returned, never hidden; so is a plan of the other storage type.
static int launch_tree(TreeParams& P, bool bf16, void* stream) {
  if (P.bf16 != (int)bf16) return (int)cudaErrorInvalidValue;
  void* args[] = {(void*)&P};
  int err = (int)cudaLaunchCooperativeKernel(
      tree_kernel(P), dim3(P.blocks), dim3(NTHREADS), args, (size_t)P.smem,
      (cudaStream_t)stream);
  if (err) return err;
  return (int)cudaGetLastError();
}

int mg_coarse_tree(const void* image, const float* b, float* out,
                   void* stream) {
  TreeParams P;
  std::memcpy(&P, image, sizeof P);
  P.lv[0].b = b;
  P.lv[0].ub = out;
  return launch_tree(P, false, stream);
}

// The same on bf16 storage: b and out bf16, the entry level's ub a scratch
// buffer of the plan (its ptrs[8]).
int mg_coarse_tree_bf16(const void* image, const __nv_bfloat16* b,
                        __nv_bfloat16* out, void* stream) {
  TreeParams P;
  std::memcpy(&P, image, sizeof P);
  P.lv[0].b16 = b;
  P.out16 = out;
  return launch_tree(P, true, stream);
}

}  // extern "C"
