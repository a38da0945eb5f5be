// Grid-sync probe: a cooperative kernel that does nothing but n grid-wide
// barriers (cooperative_groups::this_grid().sync()), launched with K4's
// grid (the plan's blocks x 256 threads), so that the time of an n = 64
// launch less an n = 16 launch, over 48, is the cost of one barrier on
// the card.  Built by scripts/time_coarse_tree.py with nvcc beside the
// package's library, never into it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NTHREADS = 256;  // csrc/coarse_tree.cu NTHREADS

__global__ void __launch_bounds__(NTHREADS) grid_sync_probe_kernel(int n) {
  cg::grid_group g = cg::this_grid();
  for (int i = 0; i < n; ++i) g.sync();
}

}  // namespace

extern "C" int mg_grid_sync_probe(int blocks, int n, void* stream) {
  void* args[] = {(void*)&n};
  int err = (int)cudaLaunchCooperativeKernel(
      (void*)grid_sync_probe_kernel, dim3(blocks), dim3(NTHREADS), args, 0,
      (cudaStream_t)stream);
  if (err) return err;
  return (int)cudaGetLastError();
}
