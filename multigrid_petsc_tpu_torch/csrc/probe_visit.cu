// The attribution probes' visit ablations (KP1): visit5_kernel's probe
// modes (visit.cuh Probe5) on the f32 zero-guess rc visit of a whole grid,
// k steps given at run time, for Hopper (sm_90a), bound through a plain C
// interface (ctypes).
//
// Replaces the kernels of benchmarks/probe_visit_vpu.py variant_visit
// (its pallas_call: the zero-guess rc visit with normalised coefficients,
// pltpu.roll shifts or no per-step masks) and benchmarks/probe_mdma_vpu.py
// down_variant (K2b's down visit without the x-restriction, with one
// step, or with no compute).  They split a visit's time into its steps,
// its restriction and its loads and stores; no solve runs them.  The
// unablated visit is the production entry mg_visit (K2b), which the probe
// modules launch as the base mode.
//
// What bounds them: as K2b (visit.cuh), the instructions a step issues
// once the region is in shared memory, and bytes below that; each mode
// drops one part of the body and keeps the rest as K2b has it, so two
// modes' times differ by the part's cost.  They take K2b's region at its
// halo (the short one: H = k + 2 <= V5_SHORT_MAX_H, so k <= 6), and only
// the modes are instantiated here, so this source builds in seconds
// beside visit.cu.

#include "visit.cuh"

namespace {

template <int MODE>
int launch_probe(const Coeffs<float>& c, const VisitIO<float>& io, int ny,
                 int nx, const float* steps, int k, void* stream) {
  using RG = V5Short;
  const int H = halo(EMIT_RC, k);
  if (k < 1 || H > V5_SHORT_MAX_H || !v5_fits<RG>(H) || ny < 3 || nx < 3)
    return (int)cudaErrorInvalidValue;
  auto kern = visit5_kernel<float, false, false, false, EMIT_RC, false, false,
                            RG, MODE>;
  const size_t smem = visit5_smem_bytes<float, RG>();
  int err = (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  kern<<<visit5_grid<RG>(ny, nx, H), RG::NT, smem, (cudaStream_t)stream>>>(
      c, io, whole_grid<float>(ny, nx), nx, H, steps, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One probe visit: mode a Probe5 value other than P_PROD; u_out (ny, nx),
// rc_out (ny - 1) / 2 x (nx - 1) / 2; steps: k (alpha, beta) pairs (f32)
// in device memory.
int mg_visit_probe(const float* cs, const float* cw, const float* cc,
                   const float* ce, const float* cn, const float* b,
                   float* u_out, float* rc_out, int ny, int nx,
                   const float* steps, int k, int mode, void* stream) {
  Coeffs<float> c{cs, cw, cc, ce, cn};
  VisitIO<float> io{b,     nullptr, nullptr, nullptr, nullptr,
                    u_out, nullptr, rc_out,  nullptr, nullptr};
  switch (mode) {
    case P_NORM:
      return launch_probe<P_NORM>(c, io, ny, nx, steps, k, stream);
    case P_NOMASK:
      return launch_probe<P_NOMASK>(c, io, ny, nx, steps, k, stream);
    case P_NORESTRICT:
      return launch_probe<P_NORESTRICT>(c, io, ny, nx, steps, k, stream);
    case P_NOSWEEP:
      return launch_probe<P_NOSWEEP>(c, io, ny, nx, steps, k, stream);
    case P_LOADSTORE:
      return launch_probe<P_LOADSTORE>(c, io, ny, nx, steps, k, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
