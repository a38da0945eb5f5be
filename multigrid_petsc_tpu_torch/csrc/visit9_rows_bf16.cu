// The bf16 instantiations of K17's 9-point entries for a block of a
// partitioned level (visit.cuh MG_VISIT9_PART_ENTRIES: mg_visit9_part_bf16,
// mg_stencil9_part_bf16).  A source of its own beside visit_rows_bf16.cu,
// so that nvcc builds the two side by side.

#include "visit.cuh"

MG_VISIT9_PART_ENTRIES(_bf16, __nv_bfloat16)
