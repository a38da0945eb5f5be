"""The fused mg-CG route of the port (K10, K11) against the JAX package on
the CPU: the plain versions of K10 and K11 against ``cg_visit_down_pallas``
and ``cg_papply_pallas`` in interpret mode (f64), the fused solve against
JAX's fused path wired onto a CPU context as ``test_pallas.py`` wires it,
and the route table against JAX's decision ingredients.

Tolerances are ``test_pallas.py``'s: arrays to rtol 1e-12 with a floor of
1e-12 of their largest entry (the O(1/h^2) stencil terms reassociate),
dots to 1e-10 relative, the solve's history to rtol 1e-8.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigrid_petsc_tpu.mesh import MeshType as JMesh
from multigrid_petsc_tpu.ops.pallas import mdma_kernel as jmdma
from multigrid_petsc_tpu.ops.pallas import stencil_kernel as jsk
from multigrid_petsc_tpu.ops.stencil import Stencil5 as JStencil5
from multigrid_petsc_tpu.problems import stencil_coefficients as j_coeffs
from multigrid_petsc_tpu.solvers.context import build_context as j_build
from multigrid_petsc_tpu.solvers.krylov import solve_mgcg as j_solve_mgcg
from multigrid_petsc_tpu.utils.config import CycleType as JCT
from multigrid_petsc_tpu.utils.config import SmootherType as JST
from multigrid_petsc_tpu.utils.config import SolverConfig as JC
from multigrid_petsc_tpu_torch.ops.cuda import mdma_kernel as tmdma
from multigrid_petsc_tpu_torch.ops.cuda import stencil_kernel as tsk
from multigrid_petsc_tpu_torch.ops.stencil import from_numpy_stencil
from multigrid_petsc_tpu_torch.solvers import krylov as kr
from multigrid_petsc_tpu_torch.solvers.context import build_context
from multigrid_petsc_tpu_torch.solvers.solve import solve
from multigrid_petsc_tpu_torch.utils.config import (
    CycleType,
    SmootherType,
    SolverConfig,
)

torch.set_num_threads(2)

SHAPES = [(63, 63), (127, 31), (257, 129)]
STEPS = jsk.jacobi_step_coeffs(3, 0.8)


def _setup(shape, seed, mesh=JMesh.NONUNIFORM1):
    ny, nx = shape
    rng = np.random.default_rng(seed)
    a, b = rng.standard_normal((ny, nx)), rng.standard_normal((ny, nx))
    jst = j_coeffs(mesh, ny, nx, jnp.float64)
    tst = from_numpy_stencil([np.asarray(c) for c in jst], "cpu",
                             torch.float64)
    return jst, tst, a, b


def _close(got, ref):
    ref = np.asarray(ref)
    got = got.numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-12,
                               atol=1e-12 * max(np.abs(ref).max(), 1.0))


def _dot_close(got, ref):
    assert abs(float(got) - float(ref)) <= 1e-10 * abs(float(ref))


def _f64(x):
    return torch.tensor(x, dtype=torch.float64)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("beta", [0.0, 0.43])
def test_cg_papply_plain_matches_pallas(shape, beta):
    jst, tst, z, p = _setup(shape, sum(shape))
    ref = jsk.cg_papply_pallas(jst, jnp.asarray(z), jnp.asarray(p), beta,
                               interpret=True)
    got = tsk.cg_papply(tst, torch.as_tensor(z), torch.as_tensor(p),
                        _f64(beta))
    _close(got[0], ref[0])
    _close(got[1], ref[1])
    _dot_close(got[2], ref[2])


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("sweeps", [3, 8])
def test_cg_visit_down_plain_matches_pallas(shape, sweeps):
    """K10: u0, the full restriction rc (JAX's restrict_x_fw of its
    y-restricted output), r' and ||r'||^2."""
    ny, nx = shape
    jst, tst, r, ap = _setup(shape, 3 * sum(shape))
    steps = jsk.jacobi_step_coeffs(sweeps, 0.8)
    ref = jsk.cg_visit_down_pallas(jst, jnp.asarray(r), jnp.asarray(ap),
                                   0.37, steps, interpret=True)
    got = tsk.cg_visit_down(tst, torch.as_tensor(r), torch.as_tensor(ap),
                            _f64(0.37), steps)
    assert got[1].shape == ((ny - 1) // 2, (nx - 1) // 2)
    for g, rf in zip(got[:3], ref[:3]):
        _close(g, rf)
    _dot_close(got[3], ref[3])


def test_k10_is_k2a_on_unpadded_arrays():
    """K10's plain version is K2a's composition (one kernel flag set)."""
    _, tst, r, ap = _setup((63, 63), 5)
    a = tsk.cg_visit_down(tst, torch.as_tensor(r), torch.as_tensor(ap),
                          _f64(0.37), STEPS)
    b = tmdma.cg_visit_down(tst, torch.as_tensor(r), torch.as_tensor(ap),
                            _f64(0.37), STEPS)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_fused_wrappers_refuse_other_devices():
    _, tst, _, _ = _setup((15, 15), 0)
    st = type(tst)(*(c.to("meta") for c in tst))
    x = torch.empty((15, 15), device="meta")
    with pytest.raises(ValueError):
        tsk.cg_papply(st, x, x, x[0, 0])
    with pytest.raises(ValueError):
        tsk.cg_visit_down(st, x, x, x[0, 0], STEPS)


def _jax_fused_ctx(kw):
    """A JAX CPU context with the fused-CG kernels wired in interpret mode
    (tests/test_pallas.py test_mgcg_fused_path_matches_generic)."""
    jctx = j_build(JC(cycle=JCT.MGCG, **kw))
    lvl = jctx.levels[0]
    st0 = lvl.stencils[0]
    steps_fn = (lambda s: jsk.chebyshev_step_coeffs(s, lvl.lmax)
                if kw.get("smoother") == JST.CHEBYSHEV
                else jsk.jacobi_step_coeffs(s, 0.8))

    def visit_down(b, u, sweeps):
        u0, rc1 = jsk.fused_level_visit_pallas(
            st0, b[0], None if u is None else u[0], steps_fn(sweeps),
            emit="rc", interpret=True)
        return (u0,), rc1

    def visit_up_dot(b, u, e_c, sweeps):
        z, dot = jsk.fused_level_visit_pallas(
            st0, b[0], u[0], steps_fn(sweeps), emit="u", e_coarse=e_c,
            emit_dot=True, interpret=True)
        return (z,), dot

    def cg_visit_down(r, ap, alpha, sweeps):
        return jsk.cg_visit_down_pallas(st0, r, ap, alpha, steps_fn(sweeps),
                                        interpret=True)

    lvl.visit_down = visit_down
    lvl.visit_up_dot = visit_up_dot
    lvl.papply = functools.partial(jsk.cg_papply_pallas, st0, interpret=True)
    lvl.cg_visit_down = cg_visit_down
    return jctx


@pytest.mark.parametrize("kw", [
    dict(npts=129, grids=4, levels=4, dtype="float64", rtol=1e-8),
    dict(npts=129, grids=5, levels=5, dtype="float64", rtol=1e-8, mesh=2,
         v=(8, 8)),
], ids=["uniform-v3", "mesh2-v8"])
def test_fused_solve_matches_jax_fused_path(kw):
    """The port's fused route (K11, K10, K3 at level 0) against JAX's
    _solve_mgcg_fused, in f64 on both sides: equal iterations, history to
    rtol 1e-8, solution to 1e-10 (test_pallas.py's tolerances)."""
    jctx = _jax_fused_ctx(kw)
    ref = j_solve_mgcg(jctx)
    assert jctx.solver_path == "fused"
    ctx = build_context(SolverConfig(cycle=CycleType.MGCG, **kw),
                        device="cpu")
    got = kr._solve_mgcg_fused(ctx, ctx.b0)
    n = int(ref.iters)
    assert got.iters == n
    np.testing.assert_allclose(got.rnorm_history[: n + 1].numpy(),
                               np.asarray(ref.rnorm_history)[: n + 1],
                               rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(got.u.numpy(), np.asarray(ref.u[0]),
                               rtol=1e-10, atol=1e-12)


def test_fused_route_f32_solve_matches_jax():
    """-v 8,8 in f32 takes the fused route (past the mdma sweep envelope)
    and lands where JAX's f32 solve lands: equal iterations, the solution
    to f32 roundoff."""
    kw = dict(npts=129, grids=5, levels=5, dtype="float32", rtol=1e-5,
              v=(8, 8), max_iter=50)
    got = solve(SolverConfig(cycle=CycleType.MGCG, **kw), device="cpu")
    from multigrid_petsc_tpu.solvers.solve import solve as j_solve

    ref = j_solve(JC(cycle=JCT.MGCG, **kw))
    assert got.route == "fused" and got.converged
    assert got.iters == ref.iters
    np.testing.assert_allclose(got.u_fine, ref.u_fine, rtol=0,
                               atol=1e-5 * np.abs(ref.u_fine).max())


# (config changes, the port's expected route).  The expected route is also
# derived from JAX's decision ingredients in the test.
ROUTES = [
    (dict(), "mdma"),
    (dict(v=(6, 6)), "mdma"),
    (dict(v=(7, 7)), "fused"),
    (dict(v=(8, 8)), "fused"),
    (dict(level_v=(3, 3, 3, 9)), "fused"),
    (dict(smoother=SmootherType.CHEBYSHEV, v=(7, 7)), "fused"),
    (dict(grids=5, levels=4), "mdma"),
    (dict(dtype="float64"), "generic"),
    (dict(dtype="float64", v=(8, 8)), "generic"),
    (dict(precond_dtype="bfloat16"), "generic"),
    (dict(precond_dtype="bfloat16", v=(8, 8)), "generic"),
    (dict(problem="aniso", aniso=(1.0, 1.0, 1.0, 2.0, 0.4)), "generic"),
    (dict(smoother=SmootherType.LINE_Y), "generic"),
    (dict(smoother=SmootherType.RBGS), "generic"),
    (dict(fine_smoother=SmootherType.LINE_X), "generic"),
    (dict(smoother=SmootherType.LINE_XY), "generic"),
    (dict(coarse_smoother=SmootherType.RBGS), "mdma"),
    (dict(backend="sparse"), "generic"),
    (dict(grids=2, levels=1), "generic"),
    (dict(dtype="bfloat16"), "mdma"),
    (dict(dtype="bfloat16", v=(8, 8)), "fused"),
    (dict(dtype="bfloat16", problem="aniso"), "generic"),
]


def _jax_route(kw) -> str:
    """The route the JAX package takes on the TPU for this config, from
    its own ingredients: level 0 gets the fused CG kernels (a 64-bit
    level keeps the exact XLA path; a single-grid matrix-free 5-point
    level with a point smoother), no preconditioner context, two or more
    levels, then mdma_viable's sweep envelope at the main path's shape."""
    jkw = {k: (JST(v.value) if isinstance(v, SmootherType) else v)
           for k, v in kw.items()}
    jctx = j_build(JC(cycle=JCT.MGCG, **jkw))
    lvl0 = jctx.levels[0]
    cfg = jctx.config
    fused_kernels = (jnp.dtype(jctx.dtype).itemsize < 8
                     and cfg.backend != "sparse"
                     and not lvl0.spec.is_composite
                     and isinstance(lvl0.stencils[0], JStencil5)
                     and cfg.smoother_at(0, len(jctx.levels))
                     in (JST.JACOBI, JST.CHEBYSHEV))
    if not (fused_kernels and jctx.precond_ctx is None
            and len(jctx.levels) > 1):
        return "generic"
    return ("mdma" if jmdma.mdma_viable(8191, 8191, cfg.max_sweeps,
                                        jnp.float32) else "fused")


@pytest.mark.parametrize("kw,want", ROUTES)
def test_route_table_matches_jax_decision(kw, want):
    kw = {**dict(npts=33, grids=4, levels=4, dtype="float32"), **kw}
    ctx = build_context(SolverConfig(cycle=CycleType.MGCG, **kw),
                        device="cpu")
    assert kr.mgcg_route(ctx) == want == _jax_route(kw)


@pytest.mark.parametrize("kw,want", [ROUTES[0], ROUTES[3], ROUTES[7],
                                     ROUTES[9]])
def test_solve_records_route(kw, want):
    kw = {**dict(npts=33, grids=4, levels=4, dtype="float32",
                 max_iter=40), **kw}
    res = solve(SolverConfig(cycle=CycleType.MGCG, **kw), device="cpu")
    assert res.route == res.ctx.route == want
    assert res.converged
    other = solve(SolverConfig(cycle=CycleType.VCYCLE, **kw), device="cpu")
    assert other.route is None
