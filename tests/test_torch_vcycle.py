"""The port's V-cycle family (V-cycle, MG-Richardson, FMG, Additive) and
its Chebyshev smoother, solve by solve, against the JAX package's
``solve(..., backend="xla")`` on the CPU.

On the CPU the JAX V-cycle family runs its kernels only one by one in
interpret mode (its solves refuse ``backend="pallas"`` there), so the
reference is the XLA path; the port's wrappers run their plain versions.
f64 tolerances: iterations equal; history rtol 1e-8 with an absolute
floor of 1e-13 ||b|| / ||r_0|| (the true residual b - A u carries f64
roundoff of up to eps ||A|| ||u|| ~ 1.5e-12 ||b|| at 129^2, measured
1.3e-14 ||b||; the history is normalized by its first entry r_0, which
is ||b|| except after FMG's start); solution rtol 1e-10 of its largest
entry.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from multigrid_petsc_tpu.solvers.solve import solve as j_solve
from multigrid_petsc_tpu.utils.config import CycleType as JCT
from multigrid_petsc_tpu.utils.config import SmootherType as JST
from multigrid_petsc_tpu.utils.config import SolverConfig as JC
from multigrid_petsc_tpu_torch.ops.cuda import launches
from multigrid_petsc_tpu_torch.ops.norms import tree_norm2
from multigrid_petsc_tpu_torch.solvers.solve import solve
from multigrid_petsc_tpu_torch.solvers.vcycle import fmg_initial_guess
from multigrid_petsc_tpu_torch.utils.config import (
    CycleType,
    SmootherType,
    SolverConfig,
)

torch.set_num_threads(2)

F64 = dict(npts=129, grids=5, levels=5, dtype="float64", rtol=1e-8,
           max_iter=60)


def _pair(cycle: str, smoother: str, **kw):
    """(JAX result, port result) for one configuration (per-level
    smoothers are given as the port's enum and carried across)."""
    jkw = {k: JST(v.value) if isinstance(v, SmootherType) else v
           for k, v in kw.items()}
    ref = j_solve(JC(cycle=JCT[cycle], smoother=JST(smoother),
                     backend="xla", **jkw))
    got = solve(SolverConfig(cycle=CycleType[cycle],
                             smoother=SmootherType(smoother), **kw),
                device="cpu")
    return ref, got


def _assert_f64_match(ref, got):
    assert got.path == "torch"
    assert got.iters == int(ref.iters)
    assert got.converged == bool(ref.converged)
    ctx, r0_rel = got.ctx, 1.0
    if ctx.config.cycle == CycleType.FMG:
        u0 = fmg_initial_guess(ctx)
        r0_rel = float(tree_norm2(ctx.levels[0].residual(ctx.b0, u0))
                       / tree_norm2(ctx.b0))
    np.testing.assert_allclose(got.rnorm, ref.rnorm, rtol=1e-8,
                               atol=1e-13 / r0_rel)
    np.testing.assert_allclose(got.u_fine, ref.u[0], rtol=1e-10,
                               atol=1e-10 * np.abs(ref.u[0]).max())


@pytest.mark.parametrize("cycle,smoother", [
    ("VCYCLE", "jacobi"), ("PCMG", "jacobi"), ("FMG", "jacobi"),
    ("ADDITIVE", "jacobi"), ("VCYCLE", "chebyshev"), ("MGCG", "chebyshev"),
])
def test_f64_matches_jax(cycle, smoother):
    """129^2 / 5 levels, the direct 7^2 coarsest solve."""
    _assert_f64_match(*_pair(cycle, smoother, **F64))


@pytest.mark.parametrize("cycle,smoother,mesh", [
    ("VCYCLE", "jacobi", 1), ("PCMG", "jacobi", 2),
    ("FMG", "chebyshev", 2), ("ADDITIVE", "chebyshev", 1),
])
def test_f64_stretched_meshes_match_jax(cycle, smoother, mesh):
    _assert_f64_match(*_pair(cycle, smoother, **{**F64, "mesh": mesh}))


@pytest.mark.parametrize("cycle,smoother,extra", [
    ("FMG", "jacobi", dict(level_v=(2, 3, 1, 4, 2))),
    ("VCYCLE", "chebyshev", dict(level_v=(1, 2, 3, 2, 1))),
    ("VCYCLE", "jacobi", dict(grids=3, levels=3, coarse_solver="smooth")),
    ("FMG", "chebyshev", dict(grids=3, levels=3, coarse_solver="smooth")),
    ("VCYCLE", "jacobi", dict(fine_smoother=SmootherType.CHEBYSHEV)),
    ("MGCG", "jacobi", dict(coarse_smoother=SmootherType.CHEBYSHEV)),
    ("VCYCLE", "jacobi", dict(npts=33, grids=1, levels=1)),
])
def test_f64_level_options_match_jax(cycle, smoother, extra):
    """Per-level sweeps, the smoothed coarsest level (no direct solve),
    per-level smoothers, and a 1-level hierarchy."""
    _assert_f64_match(*_pair(cycle, smoother, **{**F64, **extra}))


@pytest.mark.parametrize("cycle,smoother", [("VCYCLE", "jacobi"),
                                            ("MGCG", "chebyshev")])
def test_f32_matches_jax(cycle, smoother):
    """f32 at 513^2 / 7 levels.  The V-cycle's true residual stalls at the
    f32 roundoff floor (~2e-3 relative here) in both packages, so it runs
    a forced 5 cycles; its floor entries agree to rtol 0.05."""
    kw = dict(npts=513, grids=7, levels=7, dtype="float32", rtol=1e-5,
              max_iter=5 if cycle == "VCYCLE" else 30)
    ref, got = _pair(cycle, smoother, **kw)
    assert got.iters == int(ref.iters)
    assert got.converged == bool(ref.converged)
    np.testing.assert_allclose(got.rnorm, ref.rnorm, rtol=0.05)
    err = np.abs(got.u_fine - ref.u[0]).max() / np.abs(ref.u[0]).max()
    assert err < 1e-3


def test_richardson_is_the_vcycle_iteration():
    """MG-preconditioned Richardson is algebraically the V-cycle iteration
    for linear smoothers (the reason the reference keeps both drivers)."""
    kw = dict(npts=65, grids=4, levels=4, dtype="float64", rtol=1e-9)
    v = solve(SolverConfig(cycle=CycleType.VCYCLE, **kw), device="cpu")
    r = solve(SolverConfig(cycle=CycleType.PCMG, **kw), device="cpu")
    assert v.iters == r.iters
    np.testing.assert_allclose(v.rnorm, r.rnorm, rtol=1e-6, atol=1e-13)
    np.testing.assert_allclose(v.u_fine, r.u_fine, rtol=1e-10,
                               atol=1e-10 * np.abs(v.u_fine).max())


def test_additive_needs_two_levels():
    with pytest.raises(ValueError, match="levels >= 2"):
        solve(SolverConfig(npts=17, grids=1, levels=1,
                           cycle=CycleType.ADDITIVE), device="cpu")


def test_cpu_solves_launch_no_kernel():
    """On CPU tensors every wrapper takes its plain version."""
    launches.clear()
    for cycle in (CycleType.VCYCLE, CycleType.FMG, CycleType.ADDITIVE):
        res = solve(SolverConfig(npts=33, grids=3, levels=3, cycle=cycle,
                                 smoother=SmootherType.CHEBYSHEV,
                                 max_iter=3), device="cpu")
        assert res.path == "torch"
    assert not launches
