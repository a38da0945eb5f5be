// The bf16 instantiations of the level-visit and stencil kernels
// (visit.cuh): mg_visit_bf16 (K2a/K10's CG flag set among its flag
// sets), mg_visit9_bf16, mg_stencil_bf16, mg_stencil9_bf16, K1 / K11
// (mg_cg_papply_u_bf16, mg_cg_papply_bf16) and K8 (mg_stencil_field_bf16:
// the sparse backend's stencil form of a bf16 level), for the levels of
// the bf16 working dtype and of the bf16 preconditioner (bf16 storage, f32
// compute, one rounding per stored output); their row-block forms are in
// visit_rows_bf16.cu and visit9_rows_bf16.cu.  A source of its own, so
// nvcc builds it beside the f32 and f64 ones.

#include "visit.cuh"

MG_VISIT_ENTRIES(_bf16, __nv_bfloat16)
MG_PAPPLY_ENTRIES(_bf16, __nv_bfloat16)
MG_FIELD_ENTRIES(_bf16, __nv_bfloat16)
