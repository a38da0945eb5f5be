"""The bf16-preconditioned mg-CG on the CPU: the port's plain path against
the JAX package, the same configuration as chip_smoke.py's phase 8 (c)
(f32 Poisson mg-CG, rtol 1e-5, max_iter 100, a 7^2 coarsest level), and
the f32 preconditioner beside it.  Prints, per preconditioner dtype, one
JSON line: both iteration counts and residual histories (the first entry
after the start is the first step's rise) and the seconds each took.

    JAX_PLATFORMS=cpu python scripts/bf16_precond_cpu.py [npts ...]

npts is 1025, 2049 (the default) or 4097.  A one-off measurement, not a
test: 2049^2 takes ~15 s, 4097^2 ~75 s on 4 threads.
"""

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import torch  # noqa: E402

from multigrid_petsc_tpu.solvers.solve import solve as j_solve  # noqa: E402
from multigrid_petsc_tpu.utils.config import CycleType as JCT  # noqa: E402
from multigrid_petsc_tpu.utils.config import SolverConfig as JC  # noqa: E402
from multigrid_petsc_tpu_torch.solvers.solve import solve  # noqa: E402
from multigrid_petsc_tpu_torch.utils.config import (  # noqa: E402
    CycleType,
    SolverConfig,
)

LEVELS = {1025: 8, 2049: 9, 4097: 10}


def main(sizes) -> None:
    torch.set_num_threads(4)
    for n in sizes:
        for pd in ("bfloat16", None):
            kw = dict(npts=n, grids=LEVELS[n], levels=LEVELS[n],
                      dtype="float32", rtol=1e-5, max_iter=100,
                      precond_dtype=pd)
            t0 = time.perf_counter()
            j = j_solve(JC(cycle=JCT.MGCG, **kw))
            tj = time.perf_counter() - t0
            t0 = time.perf_counter()
            t = solve(SolverConfig(cycle=CycleType.MGCG, **kw), device="cpu")
            tt = time.perf_counter() - t0
            print(json.dumps({
                "npts": n, "precond_dtype": pd,
                "jax_iters": int(j.iters), "port_iters": int(t.iters),
                "jax_rnorm": [float(x) for x in j.rnorm],
                "port_rnorm": [float(x) for x in t.rnorm],
                "jax_s": tj, "port_s": tt}), flush=True)


if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]] or [2049])
