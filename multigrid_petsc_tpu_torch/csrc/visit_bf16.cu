// The bf16 instantiations of the level-visit and stencil kernels
// (visit.cuh): mg_visit_bf16, mg_visit9_bf16, mg_stencil_bf16 and
// mg_stencil9_bf16, for the bf16 preconditioner's levels (bf16 storage,
// f32 compute, one rounding per stored output); their row-block forms are
// in visit_rows_bf16.cu and visit9_rows_bf16.cu.  A source of its own, so
// nvcc builds it beside the f32 and f64 ones.

#include "visit.cuh"

MG_VISIT_ENTRIES(_bf16, __nv_bfloat16)
