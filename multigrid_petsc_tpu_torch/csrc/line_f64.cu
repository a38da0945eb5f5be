// The f64 instantiations of the y-line visit (K15, line.cuh):
// mg_line_sweep_f64, mg_line_residual_f64 and the rank-spanning mode's
// mg_line_rows_*_f64, for 64-bit levels.  A source of its own, so nvcc
// builds it beside the f32 one.

#include "line.cuh"

MG_LINE_ENTRIES(_f64, double)
MG_LINE_ROWS_ENTRIES(_f64, double)
