// The bf16 instantiations of the y-line visit (K15, line.cuh):
// mg_line_sweep_bf16 and mg_line_residual_bf16, for the levels of the bf16
// working dtype (bf16 storage; f32 coefficients, factors, carries and
// arithmetic; one rounding per stored output).  No rank-spanning entries:
// bf16 under a plan is not ported.  A source of its own, so nvcc builds it
// beside the f32 and f64 ones.

#include "line.cuh"

MG_LINE_ENTRIES(_bf16, __nv_bfloat16)
