// The f32 instantiations of the level-visit and stencil kernels
// (visit.cuh): every entry of MG_VISIT_ENTRIES and MG_VISIT_PART_ENTRIES
// (K17: a row block or a 2-D block of a partitioned level), plus the
// kernels that run in f32 only -- K1 and K11 (the mg-CG direction steps),
// K2a/K10 (the CG flag set of mg_visit) and K8 (the field-coefficient
// stencil).

#include "visit.cuh"

MG_VISIT_ENTRIES(, float)
MG_VISIT_PART_ENTRIES(, float)

extern "C" {

// Number of per-block partials K1 and K11 emit for an (ny, nx) grid.
int mg_visit_blocks(int ny, int nx) {
  dim3 g = visit_grid(ny, nx);
  return (int)(g.x * g.y);
}

// Number of per-block partials a whole-grid 5-point visit with halo h
// emits in a storage type of size bytes (its region follows h and the
// type: 2 is bf16 storage, whose step is visit5p_kernel's where v5_pair
// says so, else f32's).
int mg_visit5_blocks(int ny, int nx, int h, int size) {
  if (size == 2 && v5_pair<__nv_bfloat16>(h))
    return (int)(visit5p_grid(ny, nx, h).x * visit5p_grid(ny, nx, h).y);
  dim3 g = size == 8 ? visit5_grid_for<double>(ny, nx, h)
                     : visit5_grid_for<float>(ny, nx, h);
  return (int)(g.x * g.y);
}

// Number of per-block partials a 9-point visit with halo h emits.
int mg_visit9_blocks(int ny, int nx, int h) {
  dim3 g = visit9_grid(ny, nx, h);
  return (int)(g.x * g.y);
}

// K1: (p', A p', u + alpha_prev p, <p', A p'> partials), p' = z + beta p.
int mg_cg_papply_u(const float* cs, const float* cw, const float* cc,
                   const float* ce, const float* cn, const float* z,
                   const float* p, const float* u, const float* alpha_prev,
                   const float* beta, float* pn, float* ap, float* un,
                   float* part, int ny, int nx, void* stream) {
  Coeffs<float> c{cs, cw, cc, ce, cn};
  return launch_papply<float, true>(c, z, p, u, alpha_prev, beta, pn, ap, un,
                                    part, ny, nx, stream);
}

// K11: (p', A p', <p', A p'> partials), p' = z + beta p.
int mg_cg_papply(const float* cs, const float* cw, const float* cc,
                 const float* ce, const float* cn, const float* z,
                 const float* p, const float* beta, float* pn, float* ap,
                 float* part, int ny, int nx, void* stream) {
  Coeffs<float> c{cs, cw, cc, ce, cn};
  return launch_papply<float, false>(c, z, p, nullptr, nullptr, beta, pn, ap,
                                     nullptr, part, ny, nx, stream);
}

// K8: y = A u (resid == 0) or y = b - A u with five (ny, nx) coefficient
// fields.
int mg_stencil_field(const float* cs, const float* cw, const float* cc,
                     const float* ce, const float* cn, const float* b,
                     const float* u, float* y, int ny, int nx, int resid,
                     void* stream) {
  Fields5<float> c{cs, cw, cc, ce, cn};
  return launch_stencil<float>(c, b, u, y, whole_grid<float>(ny, nx), nx, resid,
                               stream);
}

}  // extern "C"
