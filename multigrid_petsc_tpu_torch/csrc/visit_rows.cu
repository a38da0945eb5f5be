// The f32 instantiations of K17's entries for a block of a partitioned
// level (visit.cuh MG_VISIT_PART_ENTRIES: mg_visit_part, mg_visit9_part,
// mg_stencil_part, mg_stencil9_part), row blocks and 2-D blocks.  A
// source of its own beside visit.cu, so that nvcc builds the two side by
// side.

#include "visit.cuh"

MG_VISIT_PART_ENTRIES(, float)
