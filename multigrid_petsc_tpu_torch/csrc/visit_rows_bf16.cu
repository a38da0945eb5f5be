// The bf16 instantiations of K17's entries for a block of a partitioned
// level (visit.cuh MG_VISIT_PART_ENTRIES: mg_visit_part_bf16,
// mg_visit9_part_bf16, mg_stencil_part_bf16, mg_stencil9_part_bf16), for
// the split levels of the bf16 preconditioner, row blocks and 2-D blocks
// (bf16 storage, f32 compute, one rounding per stored output, as JAX's
// dist kernel: dist_kernel.py:204-260).  A source of its own beside
// visit_bf16.cu, so that nvcc builds the two side by side.

#include "visit.cuh"

MG_VISIT_PART_ENTRIES(_bf16, __nv_bfloat16)
