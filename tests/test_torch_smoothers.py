"""The smoothers the port took over last: red-black Gauss-Seidel (RBGS),
x-line Jacobi (LINE_X) and alternating line Jacobi (LINE_XY), against
the JAX package on the CPU.

* ``sor_redblack_sweeps`` and ``line_jacobi_sweeps_x`` against JAX's in
  f64 to 1e-12 of the largest entry, on the uniform and both stretched
  meshes and on the anisotropic 9-point stencils;
* the card's x-line design (K15 on the transposed level: its collapsed
  stencil, factors over nx, contiguous transposes) through the torch model
  of ``csrc/line.cu`` (``test_torch_line._segmented``) against JAX's
  x-line smoother within TOL_LINE (1e-4 of the largest entry), as
  ``chip_smoke.py`` holds K15;
* whole solves at 129^2 in f64 (V-cycle, mg-CG, FMG with each smoother,
  and the per-level overrides; the alternating smoother on 3 levels,
  whose JAX trace is slow to compile): JAX's iterations, the residual
  history within 1e-10 relative, above the absolute floor of
  test_torch_vcycle.py (1e-13 ||b|| / ||r_0||: the true residual's f64
  roundoff, with r_0 the residual after FMG's start), the solution within
  1e-10 of its largest entry; the mg-CG route and the coarse-tree split
  as JAX's decision makes them;
* JAX's refusals: RBGS on a 9-point level, RBGS and the line smoothers
  on a merged level that is not block-smoothed;
* what these smoothers must not run: a Jacobi schedule, the fused visit
  kernels, the mg-CG kernel routes or the coarse tree over their levels.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigrid_petsc_tpu import problems as jp
from multigrid_petsc_tpu.mesh import MeshType as JMesh
from multigrid_petsc_tpu.ops import stencil as jst
from multigrid_petsc_tpu.solvers import krylov as jkr
from multigrid_petsc_tpu.solvers.context import build_context as j_build
from multigrid_petsc_tpu.solvers.solve import solve as j_solve
from multigrid_petsc_tpu.utils.config import CycleType as JCT
from multigrid_petsc_tpu.utils.config import SmootherType as JST
from multigrid_petsc_tpu.utils.config import SolverConfig as JC
from multigrid_petsc_tpu_torch.mesh import MeshType
from multigrid_petsc_tpu_torch.ops.norms import tree_norm2
from multigrid_petsc_tpu_torch.ops import stencil as tst
from multigrid_petsc_tpu_torch.ops.cuda import line_kernel as tlk
from multigrid_petsc_tpu_torch.problems import stencil_coefficients
from multigrid_petsc_tpu_torch.solvers import krylov as tkr
from multigrid_petsc_tpu_torch.solvers.context import build_context
from multigrid_petsc_tpu_torch.solvers.solve import solve
from multigrid_petsc_tpu_torch.solvers.vcycle import fmg_initial_guess
from multigrid_petsc_tpu_torch.utils.config import (
    CycleType,
    SmootherType,
    SolverConfig,
)
from test_torch_line import _segmented, _within_tol_line

torch.set_num_threads(2)

X_STRONG = (100.0, 0.0, 1.0, 0.0, 0.0)  # config 4's problem, mirrored
MIXED = (1.0, 1.0, 1.0, 2.0, 0.4)


def _fields(rng, shape):
    return rng.standard_normal(shape), rng.standard_normal(shape)


def _close(got, ref, rtol=1e-12):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rtol * np.abs(ref).max())


def _stencils(kind, ny, nx):
    """(JAX stencil, port stencil) of a mesh family (0, 1, 2: 5-point) or
    an anisotropic problem (9-point), f64."""
    if isinstance(kind, tuple):
        j = jp.stencil9_coefficients(jp.AnisoProblem(*kind), ny, nx,
                                     jnp.float64)
        return j, tst.from_numpy_stencil9([np.asarray(c) for c in j], "cpu",
                                          torch.float64)
    j = jp.stencil_coefficients(JMesh(kind), ny, nx, jnp.float64)
    return j, stencil_coefficients(MeshType(kind), ny, nx, torch.float64,
                                   "cpu")


def _promote(j, t):
    """JAX's zero-corner promotion of a 5-point stencil, in both."""
    if isinstance(t, tst.Stencil9):
        return j, t
    zj = jnp.zeros((1, 1), jnp.float64)
    j9 = jst.Stencil9(csw=zj, cs=j.cs, cse=zj, cw=j.cw, cc=j.cc, ce=j.ce,
                      cnw=zj, cn=j.cn, cne=zj)
    zt = torch.zeros((1, 1), dtype=torch.float64)
    t9 = tst.Stencil9(csw=zt, cs=t.cs, cse=zt, cw=t.cw, cc=t.cc, ce=t.ce,
                      cnw=zt, cn=t.cn, cne=zt)
    return j9, t9


@pytest.mark.parametrize("mesh", [0, 1, 2])
@pytest.mark.parametrize("shape,sweeps,omega", [((33, 33), 3, 0.8),
                                                ((31, 17), 2, 1.0)])
def test_sor_redblack_sweeps_matches_jax(mesh, shape, sweeps, omega):
    j, t = _stencils(mesh, *shape)
    b, u = _fields(np.random.default_rng(mesh + sweeps), shape)
    ref = jst.sor_redblack_sweeps(j, jnp.asarray(b), jnp.asarray(u), sweeps,
                                  omega)
    got = tst.sor_redblack_sweeps(t, torch.as_tensor(b), torch.as_tensor(u),
                                  sweeps, omega)
    _close(got, ref)


@pytest.mark.parametrize("kind", [0, 1, 2, X_STRONG, MIXED])
@pytest.mark.parametrize("shape", [(33, 33), (31, 17)])
def test_line_jacobi_sweeps_x_matches_jax(kind, shape):
    j, t = _promote(*_stencils(kind, *shape))
    b, u = _fields(np.random.default_rng(len(str(kind)) + shape[1]), shape)
    ref = jst.line_jacobi_sweeps_x(j, jnp.asarray(b), jnp.asarray(u), 3, 0.9)
    got = tst.line_jacobi_sweeps_x(t, torch.as_tensor(b), torch.as_tensor(u),
                                   3, 0.9)
    _close(got, ref)


@pytest.mark.parametrize("kind", [0, 1, X_STRONG, MIXED])
@pytest.mark.parametrize("shape", [(63, 31), (31, 97)])
def test_card_x_line_design_matches_jax(kind, shape):
    """The x-line solve as the card runs it: K15's algorithm (the model
    of csrc/line.cu) on the collapsed transposed stencil with the
    segmented factors over nx, on contiguous transposes, against JAX's
    x-line sweeps."""
    ny, nx = shape
    j, t = _promote(*_stencils(kind, ny, nx))
    b, u = _fields(np.random.default_rng(ny + nx), shape)
    st_x = tlk.collapse_stencil(tst.transpose_stencil9(t))
    fac = tlk.segment_factor(st_x, nx)
    got = _segmented(st_x, fac, torch.as_tensor(b).T.contiguous(),
                     torch.as_tensor(u).T.contiguous(), 3, 0.9).T
    ref = jst.line_jacobi_sweeps_x(j, jnp.asarray(b), jnp.asarray(u), 3, 0.9)
    _within_tol_line(got, ref)


def _cfg(kw: dict, jax: bool):
    """The same configuration in either package (smoothers by value)."""
    enum = JST if jax else SmootherType
    f = dict(kw)
    for k in ("smoother", "fine_smoother", "levels_smoother",
              "coarse_smoother"):
        if k in f:
            f[k] = enum(f[k])
    if "level_smoothers" in f:
        f["level_smoothers"] = tuple(None if s is None else enum(s)
                                     for s in f["level_smoothers"])
    f["cycle"] = (JCT if jax else CycleType)(f["cycle"])
    return (JC if jax else SolverConfig)(**f)


BASE = dict(npts=129, grids=5, levels=5, max_iter=60)
XY = dict(BASE, grids=3, levels=3)
V, MGCG, FMG = 0, 101, 103
# name -> configuration (the five options that used to raise are the
# first five: rbgs, coarse rbgs, line_x, fine line_x, line_xy).
SOLVES = {
    "rbgs_mgcg": dict(BASE, cycle=MGCG, smoother="rbgs"),
    "coarse_rbgs_mgcg": dict(BASE, cycle=MGCG, coarse_smoother="rbgs",
                             coarse_solver="smooth"),
    "line_x_mgcg": dict(BASE, cycle=MGCG, smoother="line_x",
                        problem="aniso", aniso=X_STRONG),
    "fine_line_x_v": dict(BASE, cycle=V, fine_smoother="line_x", mesh=1),
    "line_xy_v": dict(XY, cycle=V, smoother="line_xy", problem="aniso",
                      aniso=X_STRONG),
    "rbgs_v": dict(BASE, cycle=V, smoother="rbgs", mesh=2),
    "rbgs_fmg": dict(BASE, cycle=FMG, smoother="rbgs"),
    "line_x_v": dict(BASE, cycle=V, smoother="line_x", problem="aniso",
                     aniso=MIXED),
    "line_x_fmg": dict(BASE, cycle=FMG, smoother="line_x", mesh=2),
    "line_xy_mgcg": dict(XY, cycle=MGCG, smoother="line_xy", mesh=1),
    "line_xy_fmg": dict(XY, cycle=FMG, smoother="line_xy", problem="aniso",
                        aniso=MIXED),
    "levels_mixed_mgcg": dict(BASE, cycle=MGCG, level_smoothers=(
        "jacobi", "rbgs", "line_xy", None, "line_x")),
    "coarse_rbgs_v": dict(BASE, cycle=V, coarse_smoother="rbgs",
                          coarse_solver="smooth", v=(3, 20)),
}


@pytest.mark.parametrize("name", list(SOLVES))
def test_solve_matches_jax(name):
    kw = SOLVES[name]
    ref = j_solve(_cfg(kw, True))
    got = solve(_cfg(kw, False), device="cpu")
    assert got.path == "torch" and bool(ref.converged)
    assert got.converged and got.iters == int(ref.iters)
    ctx, r0_rel = got.ctx, 1.0
    if kw["cycle"] == FMG:
        r0_rel = float(tree_norm2(ctx.levels[0].residual(
            ctx.b0, fmg_initial_guess(ctx))) / tree_norm2(ctx.b0))
    np.testing.assert_allclose(got.rnorm, ref.rnorm, rtol=1e-10,
                               atol=1e-13 / r0_rel)
    np.testing.assert_allclose(got.u_fine, ref.u_fine, rtol=0,
                               atol=1e-10 * np.abs(ref.u_fine).max())
    if kw["cycle"] == MGCG:
        # JAX on the CPU takes its generic loop; the port's route is the
        # one JAX's decision gives on its own card (test_torch_fused).
        assert ref.path == "generic" and got.route == "generic"


# (configuration changes at 513^2 / 7 levels, f32 mg-CG; the route; the
# coarse tree's first level, None: no tree)
SPLITS = [
    (dict(), "mdma", 1),
    (dict(coarse_smoother="rbgs"), "mdma", None),
    (dict(fine_smoother="rbgs"), "generic", 1),
    (dict(level_smoothers=("jacobi", "jacobi", "line_x", None, None, None,
                           None)), "mdma", 3),
    (dict(levels_smoother="line_xy"), "mdma", None),
    (dict(smoother="line_x"), "generic", None),
    (dict(smoother="chebyshev", coarse_smoother="rbgs"), "mdma", None),
]


@pytest.mark.parametrize("kw,route,tree", SPLITS)
def test_route_and_coarse_tree_split_match_jax(kw, route, tree):
    """The port's mg-CG route and coarse-tree split, and JAX's: its
    ``build_coarse_tree`` on the same configuration, and its route
    ingredient (level 0 a point-smoothed 5-point level)."""
    kw = dict(npts=513, grids=7, levels=7, cycle=MGCG, dtype="float32", **kw)
    ctx = build_context(_cfg(kw, False), device="cpu")
    jctx = j_build(_cfg(kw, True))
    jtree = jkr.build_coarse_tree(jctx, interpret=True)
    ttree = tkr.build_coarse_tree(ctx)
    assert (None if jtree is None else jtree[0]) == tree
    assert (None if ttree is None else ttree[0]) == tree
    point0 = jctx.config.smoother_at(0, 7) in (JST.JACOBI, JST.CHEBYSHEV)
    assert tkr.mgcg_route(ctx) == route
    assert (route != "generic") == point0


@pytest.mark.parametrize("smoother", ["rbgs", "line_x", "line_xy"])
def test_no_point_schedule_or_fused_route_on_their_levels(smoother,
                                                          monkeypatch):
    """Their levels are not point5 (no mdma/fused route, no coarse tree),
    have no step schedule, and a solve over them calls none of the fused
    visit kernels' wrappers."""
    from multigrid_petsc_tpu_torch.ops.cuda import stencil_kernel as sk

    cfg = SolverConfig(npts=33, grids=3, levels=3, cycle=CycleType.MGCG,
                       dtype="float32", smoother=SmootherType(smoother),
                       coarse_solver="smooth", rtol=1e-5, max_iter=40)
    ctx = build_context(cfg, device="cpu")
    for lc in ctx.levels:
        assert not lc.point5 and lc.composed
        with pytest.raises(ValueError, match="no step schedule"):
            lc.steps_fn(3)
    called = []
    for name in ("fused_level_visit", "smooth_sweeps", "cg_papply",
                 "cg_visit_down"):
        real = getattr(sk, name)
        monkeypatch.setattr(sk, name, lambda *a, _n=name, _r=real, **k: (
            called.append(_n), _r(*a, **k))[1])
    res = solve(cfg, ctx=ctx)
    assert res.route == "generic" and res.converged
    assert not called, called


@pytest.mark.parametrize("kw,match", [
    (dict(smoother="rbgs", problem="aniso", aniso=MIXED),
     "RBGS is 5-point only"),
    (dict(coarse_smoother="rbgs", problem="aniso", aniso=X_STRONG),
     "RBGS is 5-point only"),
    (dict(smoother="rbgs", grids=3, levels=2, composite_smoother="jacobi"),
     "RBGS: 1 grid per level"),
    (dict(smoother="line_xy", grids=3, levels=2,
          composite_smoother="jacobi"), "line smoother: 1 grid per level"),
])
def test_refusals_match_jax(kw, match):
    """The port raises ValueError where JAX's set-up asserts, with its
    reason."""
    kw = dict(dict(npts=33, grids=2, levels=2, cycle=MGCG), **kw)
    with pytest.raises(AssertionError, match=match):
        j_build(_cfg(kw, True))
    with pytest.raises(ValueError, match=match):
        build_context(_cfg(kw, False), device="cpu")
