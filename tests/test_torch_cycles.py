"""The port's merged-grid levels and cycle zoo against the JAX package on
the CPU, in f64: the multi-gap transfers, the composite operator and
rhs, block Gauss-Seidel, and whole solves of every cycle the reference
has beyond the V-cycle family (I, E, D1, D2, D1PS, Additive2), the
V-cycle and mg-CG over a merged last level, the explicit sparse backend
(mg-CG, V-cycle, the cycle zoo), ``-moreNorm``, the guards and the CLI.

The JAX package runs these solves on its generic (XLA) path here, the
port its plain versions.  Tolerances: iterations equal; history entries
to 1e-10 relative with an absolute floor of 1e-13 (the f64 roundoff of a
true residual b - A u at these sizes: eps ||A|| ||u|| / ||b||, about
1e-13, and the history is normalized by its first entry); every grid of
the solution to 1e-10 of its largest entry.  The I, E and D1 cycles do
not converge within the counts run here, and D1PS's solution is far from
the exact one (ROADMAP Queue 3): the port matches the JAX package, not
convergence.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multigrid_petsc_tpu.ops import composite as jcomp
from multigrid_petsc_tpu.ops import transfer as jtr
from multigrid_petsc_tpu.problems import stencil_coefficients as j_coeffs
from multigrid_petsc_tpu.mesh import MeshType as JMesh
from multigrid_petsc_tpu.solvers import smoothers as jsm
from multigrid_petsc_tpu.solvers.solve import solve as j_solve
from multigrid_petsc_tpu.utils.config import CycleType as JCT
from multigrid_petsc_tpu.utils.config import SmootherType as JST
from multigrid_petsc_tpu.utils.config import SolverConfig as JC
from multigrid_petsc_tpu_torch.mesh import MeshType
from multigrid_petsc_tpu_torch.ops import composite as comp
from multigrid_petsc_tpu_torch.ops import transfer as tr
from multigrid_petsc_tpu_torch.ops.cuda import launches
from multigrid_petsc_tpu_torch.ops.norms import tree_norm2
from multigrid_petsc_tpu_torch.problems import stencil_coefficients
from multigrid_petsc_tpu_torch.solvers import smoothers as sm
from multigrid_petsc_tpu_torch.solvers.solve import solve
from multigrid_petsc_tpu_torch.solvers.vcycle import fmg_initial_guess
from multigrid_petsc_tpu_torch.utils.config import (
    CycleType,
    SmootherType,
    SolverConfig,
)

torch.set_num_threads(2)

F64 = torch.float64


def _close(got, want, rtol=1e-12):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * max(np.abs(want).max(), 1e-300))


def _stencils(npts, mesh, gids):
    shapes = [((npts - 1) // 2**g - 1,) * 2 for g in gids]
    jst = tuple(j_coeffs(JMesh(mesh), ny, nx) for ny, nx in shapes)
    st = tuple(stencil_coefficients(MeshType(mesh), ny, nx, F64, "cpu")
               for ny, nx in shapes)
    return jst, st, shapes


def _random(shapes, seed):
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(s) for s in shapes]
    return tuple(map(jnp.asarray, xs)), tuple(map(torch.as_tensor, xs))


@pytest.mark.parametrize("gap", [1, 2, 3])
def test_multi_gap_transfers_match_jax(gap):
    rng = np.random.default_rng(gap)
    fine = rng.standard_normal((63, 63))
    coarse = rng.standard_normal(((64 >> gap) - 1,) * 2)
    _close(tr.restrict_multi(torch.as_tensor(fine), gap),
           jtr.restrict_multi(jnp.asarray(fine), gap))
    _close(tr.prolong_multi(torch.as_tensor(coarse), gap),
           jtr.prolong_multi(jnp.asarray(coarse), gap))


@pytest.mark.parametrize("variant", [(True, True), (True, False),
                                     (False, True)])
@pytest.mark.parametrize("gids,mesh", [((0, 1), 0), ((0, 1, 2), 2),
                                       ((1, 3), 1)])
def test_composite_apply_and_residual_match_jax(gids, mesh, variant):
    jst, st, shapes = _stencils(33, mesh, gids)
    ju, u = _random(shapes, 1)
    jb, b = _random(shapes, 2)
    kw = dict(include_diag=variant[0], include_couplings=variant[1])
    ops = comp.GridOps(st, gids)
    for g, w in zip(comp.composite_apply(ops, u, **kw),
                    jcomp.composite_apply(jst, gids, ju, **kw)):
        _close(g, w)
    for g, w in zip(comp.composite_residual(ops, b, u, **kw),
                    jcomp.composite_residual(jst, gids, jb, ju, **kw)):
        _close(g, w)


@pytest.mark.parametrize("gids", [(0, 1), (0, 2, 3)])
def test_composite_rhs_matches_jax(gids):
    f = np.random.default_rng(4).standard_normal((31, 31))
    for g, w in zip(comp.composite_rhs(torch.as_tensor(f), gids),
                    jcomp.composite_rhs(jnp.asarray(f), gids)):
        _close(g, w)


@pytest.mark.parametrize("gids,sweeps,inner", [((0, 1), 2, 3),
                                               ((0, 1, 2), 1, 5)])
def test_block_gs_matches_jax(gids, sweeps, inner):
    jst, st, shapes = _stencils(33, 1, gids)
    ju, u = _random(shapes, 5)
    jb, b = _random(shapes, 6)
    want = jsm.composite_block_gs(jst, gids, tuple(1.0 / s.cc for s in jst),
                                  jb, ju, sweeps, inner=inner, omega=0.8)
    got = sm.composite_block_gs(comp.GridOps(st, gids), b, u, sweeps,
                                inner=inner, omega=0.8)
    for g, w in zip(got, want):
        _close(g, w, 1e-10)


def _pair(cycle: str, **kw):
    """(JAX result, port result) of one f64 configuration."""
    jkw = {k: JST(v.value) if isinstance(v, SmootherType) else v
           for k, v in kw.items()}
    ref = j_solve(JC(cycle=JCT[cycle], dtype="float64", **jkw))
    got = solve(SolverConfig(cycle=CycleType[cycle], dtype="float64", **kw),
                device="cpu")
    return ref, got


def _assert_match(ref, got):
    assert got.path == "torch"
    assert got.iters == int(ref.iters)
    assert got.converged == bool(ref.converged)
    ctx, r0_rel = got.ctx, 1.0
    if ctx.config.cycle == CycleType.FMG:  # history normalized by r_0
        r0_rel = float(tree_norm2(ctx.levels[0].residual(
            ctx.b0, fmg_initial_guess(ctx))) / tree_norm2(ctx.b0))
    np.testing.assert_allclose(got.rnorm, ref.rnorm, rtol=1e-10,
                               atol=1e-13 / r0_rel)
    assert len(got.u_grids) == len(ref.u)
    for g, w in zip(got.u_grids, ref.u):
        _close(g, w, 1e-10)


ONE_LEVEL = dict(npts=17, grids=2, levels=1, max_iter=20, rtol=1e-8)


@pytest.mark.parametrize("backend", ["auto", "sparse"])
@pytest.mark.parametrize("cycle", ["ICYCLE", "ECYCLE", "D1CYCLE", "D2CYCLE",
                                   "D1PSCYCLE"])
def test_one_level_cycles_match_jax(cycle, backend):
    """The merged one-level cycles, matrix-free and assembled (I: A with
    block Gauss-Seidel; E: A1 and A2; the delayed cycles: A1 only)."""
    _assert_match(*_pair(cycle, backend=backend, **ONE_LEVEL))


@pytest.mark.parametrize("cycle,extra", [
    ("ECYCLE", dict(omega=0.6, v=(5, 5))),
    ("D2CYCLE", dict(v=(2, 2), mesh=1)),
    ("D1CYCLE", dict(npts=33, grids=3, mesh=2)),
    ("ICYCLE", dict(npts=33, grids=3, mesh=1, v=(2, 2))),
])
def test_one_level_cycle_options_match_jax(cycle, extra):
    """Other damping and sweep counts, three merged grids and the
    stretched meshes.  (The JAX package's E- and delayed cycles with the
    Chebyshev A1 smoother fail to trace there: ``_diag_smoother`` calls
    ``float`` on a traced lmax; the port runs them.)"""
    _assert_match(*_pair(cycle, **{**ONE_LEVEL, **extra}))


@pytest.mark.parametrize("backend", ["auto", "sparse"])
@pytest.mark.parametrize("cycle,kw", [
    ("ADDITIVE2", dict(npts=33, grids=2, levels=2, max_iter=40)),
    ("VCYCLE", dict(npts=33, grids=4, levels=2, max_iter=30)),
    ("MGCG", dict(npts=33, grids=4, levels=2, max_iter=30)),
    ("FMG", dict(npts=33, grids=3, levels=2, max_iter=30)),
    ("ADDITIVE", dict(npts=33, grids=4, levels=3, max_iter=30)),
])
def test_multi_level_cycles_match_jax(cycle, kw, backend):
    """Additive2, and the ported cycles over a merged last level (its
    direct solve densifies the assembled merged operator)."""
    _assert_match(*_pair(cycle, backend=backend, rtol=1e-8, **kw))


@pytest.mark.parametrize("cycle,kw", [
    ("MGCG", dict(npts=65, grids=4, levels=4, mesh=1)),
    ("VCYCLE", dict(npts=65, grids=4, levels=4, mesh=2)),
    ("PCMG", dict(npts=33, grids=3, levels=3)),
    ("MGFGMRES", dict(npts=33, grids=3, levels=3)),
    ("VCYCLE", dict(npts=33, grids=3, levels=3,
                    smoother=SmootherType.CHEBYSHEV)),
])
def test_sparse_backend_matches_jax(cycle, kw):
    """Single-grid levels over assembled matrices: the JAX package's
    generic route (no fused visits), applied through ``SparseLevelOp``."""
    ref, got = _pair(cycle, backend="sparse", rtol=1e-8, max_iter=40, **kw)
    assert all(lc.sparse_full is not None for lc in got.ctx.levels)
    assert not got.ctx.levels[0].point5
    _assert_match(ref, got)


def test_cg_coarse_solver_matches_jax():
    """``coarse_solver="cg"`` on a single-grid coarsest level."""
    _assert_match(*_pair("VCYCLE", npts=33, grids=3, levels=3,
                         coarse_solver="cg", coarse_cg_iters=20, rtol=1e-8,
                         max_iter=30))


def test_cg_coarse_solver_on_a_merged_level_diverges_as_jax():
    """CG on the merged coarsest level (nonsymmetric, its coupling blocks
    R A_f and A_f P are no transposes) blows the V-cycle up at once, in
    the JAX package too: both stop on divtol after one cycle at the same
    ~3e9, to the few digits a diverging CG keeps."""
    ref, got = _pair("VCYCLE", npts=33, grids=4, levels=2,
                     coarse_solver="cg", rtol=1e-8, max_iter=30)
    assert got.iters == int(ref.iters) == 1 and not got.converged
    assert got.rnorm[-1] > 1e8
    np.testing.assert_allclose(got.rnorm, ref.rnorm, rtol=1e-4)


@pytest.mark.parametrize("backend", ["auto", "sparse"])
@pytest.mark.parametrize("cycle", ["ECYCLE", "ICYCLE", "D1CYCLE",
                                   "D1PSCYCLE"])
def test_more_norm_monitors_match_jax(cycle, backend):
    """-moreNorm: the per-grid monitors (I/E: one entry per iteration and
    the initial state, raw; delayed: v + 1 entries per iteration,
    normalized), and monitoring does not change the iteration."""
    kw = dict(ONE_LEVEL, npts=9, max_iter=6, backend=backend)
    ref, got = _pair(cycle, more_norm=True, **kw)
    _assert_match(ref, got)
    n = got.iters * (4 if cycle.startswith("D") else 1) + (
        0 if cycle.startswith("D") else 1)
    assert got.aux["r_global"].shape == (n,)
    assert got.aux["r_grid"].shape == (2, n)
    for key in ("r_global", "r_grid"):
        np.testing.assert_allclose(got.aux[key], ref.aux[key], rtol=1e-10,
                                   atol=1e-13 * np.abs(ref.aux[key]).max())
    plain = solve(SolverConfig(cycle=CycleType[cycle], dtype="float64",
                               **kw), device="cpu")
    assert plain.aux is None
    np.testing.assert_array_equal(plain.rnorm, got.rnorm)


def test_ecycle_norm_plateaus_at_the_restricted_rhs():
    """The E-cycle's own norm ||b - A1 u|| tends to ||R f|| / ||b|| (the
    coarse variables vanish at the merged fixed point), as in the JAX
    package and the reference."""
    res = solve(SolverConfig(npts=9, grids=2, levels=1, max_iter=1500,
                             cycle=CycleType.ECYCLE), device="cpu")
    b = res.ctx.b0
    plateau = float(torch.linalg.norm(b[1])
                    / torch.sqrt(torch.linalg.norm(b[0]) ** 2
                                 + torch.linalg.norm(b[1]) ** 2))
    assert abs(res.rnorm[-1] - plateau) < 1e-6
    assert float(res.u_grids[1].abs().max()) < 1e-5


@pytest.mark.parametrize("cycle", list(CycleType))
@pytest.mark.parametrize("backend", ["auto", "sparse"])
def test_every_cycle_id_runs(cycle, backend):
    """Every cycle id, matrix-free and assembled, on a configuration the
    reference's guards admit."""
    kw = dict(npts=17, grids=2, levels=2, max_iter=3)
    if cycle in (CycleType.ICYCLE, CycleType.ECYCLE, CycleType.D1CYCLE,
                 CycleType.D2CYCLE, CycleType.D1PSCYCLE):
        kw["levels"] = 1
    res = solve(SolverConfig(cycle=cycle, backend=backend, **kw),
                device="cpu")
    assert res.iters >= 1 and np.all(np.isfinite(res.rnorm))
    assert res.u.shape == (15, 15)


@pytest.mark.parametrize("kw,match", [
    (dict(levels=2, cycle=CycleType.D1CYCLE), "levels == 1"),
    (dict(grids=3, levels=3, cycle=CycleType.ADDITIVE2), "Additive2"),
    (dict(grids=2, levels=3), "levels cannot exceed"),
    (dict(backend="sparse", problem="aniso"), "poisson"),
    (dict(grids=1, levels=1, cycle=CycleType.D2CYCLE), "2 merged grids"),
    (dict(grids=3, levels=3, cycle=CycleType.ADDITIVE, coarse_solver="lu"),
     "coarse_solver"),
])
def test_guards(kw, match):
    cfg = dict(npts=17, grids=2, levels=2)
    with pytest.raises(ValueError, match=match):
        solve(SolverConfig(**{**cfg, **kw}), device="cpu")


@pytest.mark.parametrize("args", [
    ["-cycle", "1", "-grids", "2", "-levels", "1", "-iter", "10"],
    ["-cycle", "2", "-grids", "2", "-levels", "1", "-iter", "10"],
    ["-cycle", "3", "-grids", "2", "-levels", "1", "-iter", "10"],
    ["-cycle", "4", "-grids", "2", "-levels", "1", "-iter", "10"],
    ["-cycle", "7", "-grids", "2", "-levels", "1", "-iter", "10"],
    ["-cycle", "10", "-grids", "2", "-levels", "2"],
    ["-cycle", "101", "-grids", "2", "-levels", "2", "-backend", "sparse"],
    ["-cycle", "2", "-grids", "2", "-levels", "1", "-iter", "10",
     "-backend", "sparse", "-moreNorm", "1"],
])
def test_cli_runs_the_cycle_zoo_on_cpu(args, tmp_path, monkeypatch, capsys):
    """The banner names the cycle; the iteration count is the JAX
    package's."""
    from multigrid_petsc_tpu_torch.poisson import CYCLE_NAMES, main

    monkeypatch.chdir(tmp_path)
    rc = main(["-npts", "17", *args, "-device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    opts = dict(zip(args[::2], args[1::2]))
    cycle = CycleType(int(opts["-cycle"]))
    assert out.startswith(f"{CYCLE_NAMES[cycle]} (cycle {cycle.value})")
    ref = j_solve(JC(npts=17, cycle=JCT(cycle.value),
                     grids=int(opts["-grids"]), levels=int(opts["-levels"]),
                     max_iter=int(opts.get("-iter", 100000)),
                     backend=opts.get("-backend", "auto"),
                     more_norm=opts.get("-moreNorm") == "1"))
    assert f"iterations: {int(ref.iters)}  converged: {bool(ref.converged)}" \
        in out
    if "-backend" in opts:
        assert "sparse level forms:" in out
    if "-moreNorm" in opts:
        assert "moreNorm r_grid[1]:" in out


def test_cpu_cycle_zoo_launches_no_kernel():
    launches.clear()
    for cycle in (CycleType.ICYCLE, CycleType.ECYCLE, CycleType.D1CYCLE):
        solve(SolverConfig(npts=17, grids=2, levels=1, cycle=cycle,
                           dtype="float32", max_iter=3, backend="sparse"),
              device="cpu")
    assert not launches
