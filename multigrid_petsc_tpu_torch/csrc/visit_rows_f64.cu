// The f64 instantiations of K17's entries for a block of a partitioned
// level (visit.cuh MG_VISIT_PART_ENTRIES: mg_visit_part_f64, ...), for
// the split levels of the f64 working dtype and the mixed outer's f64
// operator.  A source of its own beside visit_f64.cu, so that nvcc builds
// the two side by side.

#include "visit.cuh"

MG_VISIT_PART_ENTRIES(_f64, double)
