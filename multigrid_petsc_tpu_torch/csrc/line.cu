// The f32 instantiations of the y-line visit (K15, line.cuh): mg_line_sweep,
// mg_line_residual and the rank-spanning mode's mg_line_rows_*, and the
// count of the dot-emitting sweep's partials.

#include "line.cuh"

MG_LINE_ENTRIES(, float)
MG_LINE_ROWS_ENTRIES(, float)

// Number of per-block partials the dot-emitting sweep writes.
extern "C" int mg_line_blocks(int ny, int nx) {
  return ((nx + ST - 1) / ST) * ((ny + SEG - 1) / SEG);
}
