// The bf16 instantiations of K17's 5-point entries for a block of a
// partitioned level (visit.cuh MG_VISIT5_PART_ENTRIES: mg_visit_part_bf16,
// mg_stencil_part_bf16; the 9-point ones are in visit9_rows_bf16.cu), for
// the split levels of the bf16 preconditioner, row blocks and 2-D blocks
// (bf16 storage, f32 compute, one rounding per stored output, as JAX's
// dist kernel: dist_kernel.py:204-260).  A source of its own beside
// visit_bf16.cu, so that nvcc builds them side by side.

#include "visit.cuh"

MG_VISIT5_PART_ENTRIES(_bf16, __nv_bfloat16)
