// The f64 instantiations of the level-visit and stencil kernels
// (visit.cuh): mg_visit_f64, mg_visit9_f64, mg_stencil_f64 and
// mg_stencil9_f64, for 64-bit levels (the f64 working dtype) and the f64
// outer operator of the mixed-precision mg-CG; their forms on a block of
// a partitioned level (K17) are in visit_rows_f64.cu.  A source of its
// own, so nvcc builds it beside the f32 and bf16 ones.

#include "visit.cuh"

MG_VISIT_ENTRIES(_f64, double)
