"""Whole solves of the port's 9-point anisotropic family (point and y-line
smoothers; mg-CG, mg-FGMRES and the V-cycle family) against the JAX
package's ``solve(..., backend="xla")`` on the CPU, its CLI, and what it
still refuses.

f64 tolerances: iterations equal; residual history rtol 1e-9 per entry,
with an absolute floor of 1e-13 (the true residual b - A u of the
stationary cycles carries f64 roundoff of that order relative to ||b||,
see ``test_torch_vcycle.py``); solution within 1e-10 of its largest
entry.  The JAX package routes every one of these through its generic
paths on the CPU (``generic`` PCG, the XLA V-cycle), as the port does.
FMG's history is normalized by the residual after its start, so its
floor scales by ||b|| / ||r_0||.
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

MIXED = (1.0, 1.0, 1.0, 2.0, 0.4)   # variable coefficients + mixed term
STRONG_Y = (1.0, 0.0, 100.0, 0.0, 0.0)  # BASELINE config 4's anisotropy


def _pair(cycle: str, smoother: str = "jacobi", **kw):
    """(JAX result, port result) of one aniso configuration."""
    kw = {"problem": "aniso", "dtype": "float64", **kw}
    ref = j_solve(JC(cycle=JCT[cycle], smoother=JST(smoother),
                     backend="xla", **kw))
    got = solve(SolverConfig(cycle=CycleType[cycle],
                             smoother=SmootherType(smoother), **kw),
                device="cpu")
    return ref, got


def _assert_f64_match(ref, got, path=None):
    assert got.path == "torch"
    if path is not None:
        assert ref.path == path
    assert got.iters == int(ref.iters)
    assert got.converged == bool(ref.converged)
    ctx, r0_rel = got.ctx, 1.0
    if ctx.config.cycle == CycleType.FMG:  # history relative to FMG's start
        r0_rel = float(tree_norm2(ctx.levels[0].residual(
            ctx.b0, fmg_initial_guess(ctx))) / tree_norm2(ctx.b0))
    np.testing.assert_allclose(got.rnorm, ref.rnorm, rtol=1e-9,
                               atol=1e-13 / r0_rel)
    np.testing.assert_allclose(got.u_fine, ref.u[0], rtol=0,
                               atol=1e-10 * np.abs(ref.u[0]).max())


def test_mgcg_jacobi_variable_coefficients_matches_jax():
    """129^2 / 5 levels, the 9-point point-smoothed visits (K14's plain
    version) under the generic PCG loop (A p through K12)."""
    _assert_f64_match(*_pair("MGCG", npts=129, grids=5, levels=5,
                             aniso=MIXED, rtol=1e-8, max_iter=60),
                      path="generic")


def test_mgcg_line_y_matches_jax():
    """257^2 / 5 levels, strong y coupling, y-line smoothing (K15's plain
    version): test_aniso.py's fused-line-visit solve configuration."""
    _assert_f64_match(*_pair("MGCG", "line_y", npts=257, grids=5, levels=5,
                             aniso=STRONG_Y, rtol=1e-8, max_iter=30),
                      path="generic")


@pytest.mark.parametrize("aniso,restart", [((1.0, 0.0, 1.0, 0.0, 0.4), 10),
                                           (MIXED, 3)])
def test_mgfgmres_matches_jax(aniso, restart):
    """FGMRES(m) with a V-cycle as right preconditioner, the mixed-term
    problem at 33^2 / 3 levels (test_aniso.py's), and a short restart
    that needs several blocks."""
    _assert_f64_match(*_pair("MGFGMRES", npts=33, grids=3, levels=3,
                             aniso=aniso, rtol=1e-10, max_iter=60,
                             fgmres_restart=restart))


@pytest.mark.parametrize("cycle,smoother", [("VCYCLE", "jacobi"),
                                            ("VCYCLE", "chebyshev"),
                                            ("FMG", "jacobi"),
                                            ("VCYCLE", "line_y")])
def test_vcycle_family_matches_jax(cycle, smoother):
    """The ported V-cycle family on the 9-point operator (Chebyshev's lmax
    through K12's plain version)."""
    _assert_f64_match(*_pair(cycle, smoother, npts=129, grids=5, levels=5,
                             aniso=MIXED, rtol=1e-8, max_iter=40))


def test_smoothed_coarsest_level_matches_jax():
    """3 levels with coarse_solver="smooth": the coarsest level smooths
    through K13's plain version."""
    _assert_f64_match(*_pair("VCYCLE", npts=65, grids=3, levels=3,
                             aniso=MIXED, coarse_solver="smooth", rtol=1e-8,
                             max_iter=8))


def test_poisson_with_line_y_and_fgmres_matches_jax():
    """The 5-point family takes the new pieces too: a y-line smoother (the
    stencil promoted to 9 points with zero corners) and mg-FGMRES."""
    kw = dict(npts=65, grids=4, levels=4, mesh=2, dtype="float64",
              rtol=1e-8, max_iter=40)
    for cycle, smoother in (("MGCG", "line_y"), ("MGFGMRES", "jacobi")):
        ref = j_solve(JC(cycle=JCT[cycle], smoother=JST(smoother),
                         backend="xla", **kw))
        got = solve(SolverConfig(cycle=CycleType[cycle],
                                 smoother=SmootherType(smoother), **kw),
                    device="cpu")
        _assert_f64_match(ref, got)


def test_baseline_config4_iterations_match_jax():
    """BASELINE config 4 (``cfg4_1025_aniso9_line``): 1025^2 / 8 levels,
    mg-CG, y-line smoother, aniso (1, 0, 100, 0, 0), f64, rtol 1e-7: the
    same iteration count as the JAX package's XLA solve."""
    kw = dict(npts=1025, grids=8, levels=8, aniso=STRONG_Y, max_iter=100)
    ref, got = _pair("MGCG", "line_y", **kw)
    assert got.converged and bool(ref.converged)
    assert got.iters == int(ref.iters)
    np.testing.assert_allclose(got.rnorm, ref.rnorm, rtol=1e-6, atol=1e-13)


def test_cpu_aniso_solves_launch_no_kernel():
    launches.clear()
    for smoother in (SmootherType.JACOBI, SmootherType.LINE_Y):
        res = solve(SolverConfig(npts=33, grids=3, levels=3, problem="aniso",
                                 aniso=MIXED, smoother=smoother,
                                 cycle=CycleType.MGCG), device="cpu")
        assert res.path == "torch" and res.converged
    assert not launches


def test_cli_runs_aniso_line_y_on_cpu(tmp_path, monkeypatch, capsys):
    from multigrid_petsc_tpu_torch.poisson import main

    monkeypatch.chdir(tmp_path)
    rc = main(["-npts", "65", "-grids", "4", "-levels", "4", "-problem",
               "aniso", "-aniso", "1,0,100,0,0", "-smoother", "line_y",
               "-cycle", "101", "-device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert out.startswith("mg-CG (cycle 101) smoother=line_y "
                          "problem=aniso(1,0,100,0,0)")
    assert "iterations: 3  converged: True" in out and "path=torch" in out
    err_line = [l for l in out.splitlines() if l.startswith("error")][0]
    assert 1e-5 < float(err_line.split()[-3]) < 1e-3  # max error ~2.0e-4


@pytest.mark.parametrize("kw", [
    dict(smoother=SmootherType.LINE_X),
    dict(smoother=SmootherType.LINE_XY),
    dict(smoother=SmootherType.RBGS),
    dict(coarse_smoother=SmootherType.LINE_X),
])
def test_other_smoothers_still_raise(kw):
    """The smoothers that raised until they were ported, on the 9-point
    family: RBGS still raises, as JAX's set-up does (5-point only); the
    line smoothers solve as JAX's do (f64: its iterations, its history to
    1e-10)."""
    cfg = SolverConfig(npts=17, grids=2, levels=2, problem="aniso",
                       cycle=CycleType.MGCG, **kw)
    jkw = {k: JST(v.value) for k, v in kw.items()}
    jcfg = JC(npts=17, grids=2, levels=2, problem="aniso", cycle=JCT.MGCG,
              **jkw)
    if kw.get("smoother") == SmootherType.RBGS:
        with pytest.raises(ValueError, match="RBGS is 5-point only"):
            solve(cfg, device="cpu")
        with pytest.raises(AssertionError, match="RBGS is 5-point only"):
            j_solve(jcfg)
        return
    got, ref = solve(cfg, device="cpu"), j_solve(jcfg)
    assert got.converged and got.iters == int(ref.iters)
    np.testing.assert_allclose(got.rnorm, ref.rnorm, rtol=1e-10,
                               atol=1e-13)


def test_aniso_composite_levels_raise_as_in_jax():
    with pytest.raises(ValueError, match="grids == levels"):
        solve(SolverConfig(npts=17, grids=3, levels=2, problem="aniso"),
              device="cpu")


def test_profile_solve_needs_a_card():
    """The profiling tool measures the card only: without one it raises
    instead of timing the CPU."""
    from multigrid_petsc_tpu_torch.profile_solve import main

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["-npts", "17", "-problem", "aniso"])
