// The f32 instantiations of the level-visit and stencil kernels
// (visit.cuh): every entry of MG_VISIT_ENTRIES (their forms on a block of
// a partitioned level, K17, are in visit_rows.cu), of MG_PAPPLY_ENTRIES
// (K1 and K11, the mg-CG direction steps) and of MG_FIELD_ENTRIES (K8,
// the field-coefficient stencil; f32 and bf16).

#include "visit.cuh"

MG_VISIT_ENTRIES(, float)
MG_PAPPLY_ENTRIES(, float)

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

}  // extern "C"

MG_FIELD_ENTRIES(, float)
