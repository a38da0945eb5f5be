"""The port's precision paths against the JAX package on the CPU: the bf16
plain kernel versions against the JAX kernels in interpret mode, the
mixed-precision outer (f64 over the f32 V-cycle, and ``float32x2`` mapped
onto it), the bf16 preconditioner, f64 levels on the generic route, and
the ``u0`` warm start.

Tolerances, each with its reason:
  * bf16 kernels, 5-point: where the JAX kernel rounds at the port's
    kernel's stores (upcast, f32 arithmetic, one rounding per output),
    every entry within 1 bf16 ulp of the JAX entry (f32 reassociation can
    flip one rounding).  JAX rounds twice where its transfers straddle an
    XLA op: the restriction's y half is stored in bf16 before its x pass,
    and a correction is prolonged in x in bf16 before the kernel; those
    outputs are held to 2 bf16 ulps of the array's largest entry.
  * bf16 kernels, 9-point: the JAX 9-point kernels compute in the storage
    type (each product and sum rounds to bf16), the port's in f32: 4 bf16
    ulps of the largest entry.
  * the mixed outer: its preconditioner is f32, and torch and XLA round
    the f32 V-cycle differently, so the iterations are equal and the
    normalized history (relative to ||r_0||) agrees to 1e-6 entry by entry
    (5e-6 for the y-line problem, whose nearly singular f32 line solves
    carry more of that noise); the final residual meets rtol.
  * f64 levels: history 1e-11, solution 1e-12 relative (one f64 solve
    against another).
  * bf16 preconditioner: the JAX test's rules (tests/test_vcycle.py):
    converged, at most 4 iterations more than the same solve without it,
    u within rtol 1e-5 of that solve's.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigrid_petsc_tpu import problems as jp
from multigrid_petsc_tpu.mesh import MeshType as JMesh
from multigrid_petsc_tpu.ops.pallas import stencil9_kernel as jsk9
from multigrid_petsc_tpu.ops.pallas import stencil_kernel as jsk
from multigrid_petsc_tpu.solvers import krylov as jkr
from multigrid_petsc_tpu.solvers.solve import solve as j_solve
from multigrid_petsc_tpu.utils.config import CycleType as JCT
from multigrid_petsc_tpu.utils.config import SmootherType as JST
from multigrid_petsc_tpu.utils.config import SolverConfig as JC
from multigrid_petsc_tpu_torch.ops.cuda import mdma_kernel as tmdma
from multigrid_petsc_tpu_torch.ops.cuda import stencil9_kernel as tsk9
from multigrid_petsc_tpu_torch.ops.cuda import stencil_kernel as tsk
from multigrid_petsc_tpu_torch.ops.stencil import (
    from_numpy_stencil,
    from_numpy_stencil9,
)
from multigrid_petsc_tpu_torch.solvers import krylov as kr
from multigrid_petsc_tpu_torch.solvers.solve import solve
from multigrid_petsc_tpu_torch.utils.config import (
    CycleType,
    SmootherType,
    SolverConfig,
)

torch.set_num_threads(2)

BF = jnp.bfloat16
STEPS = jsk.jacobi_step_coeffs(3, 0.8)
CHEB = jsk.chebyshev_step_coeffs(3, 1.9)


# --------------------------------------------------------------------------
# bf16 kernels
# --------------------------------------------------------------------------


def _bf_j(x):
    return jnp.asarray(x, BF)


def _bf_t(x):
    """The same bf16 values as _bf_j, as a torch tensor."""
    return torch.as_tensor(np.array(_bf_j(x).astype(jnp.float32))).to(
        torch.bfloat16)


def _bf_stencil(jst, conv):
    """A JAX bf16 stencil as the port's, the same bf16 values."""
    st = conv([np.asarray(c.astype(jnp.float32)) for c in jst], "cpu",
              torch.float32)
    return type(st)(*(c.to(torch.bfloat16) for c in st))


def _ulp(x):
    """One bf16 ulp at |x| (8 significant bits)."""
    a = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _within_ulps(got, ref, bound):
    """bound "entry": each entry within 1 ulp of itself; a number: within
    that many ulps of the array's largest entry."""
    assert got.dtype == torch.bfloat16
    g, r = _f32(got), _f32(ref)
    assert g.shape == r.shape
    d = np.abs(g - r)
    if bound == "entry":
        assert (d <= _ulp(r)).all(), float((d / _ulp(r)).max())
    else:
        lim = bound * _ulp(np.abs(r).max())
        assert d.max() <= lim, (float(d.max()), lim)


def _setup5(shape, seed):
    ny, nx = shape
    rng = np.random.default_rng(seed)
    b, u = rng.standard_normal((ny, nx)), rng.standard_normal((ny, nx))
    e = rng.standard_normal(((ny - 1) // 2, (nx - 1) // 2))
    jst = jp.stencil_coefficients(JMesh.NONUNIFORM2, ny, nx, BF)
    return jst, _bf_stencil(jst, from_numpy_stencil), b, u, e


# (label, how the two sides are called, the bound of each output).
# Rounding points shared with JAX: "entry"; an extra JAX rounding: 2.
BF16_5PT = [
    ("K6", lambda s, b, u, e: (s.apply_stencil5(u),), ("entry",)),
    ("residual5", lambda s, b, u, e: (s.residual5(b, u),), ("entry",)),
    ("K7 Jacobi", lambda s, b, u, e: (s.smooth(b, u, STEPS),), ("entry",)),
    ("K7 Chebyshev", lambda s, b, u, e: (s.smooth(b, u, CHEB),), ("entry",)),
    ("K9 zero-guess rc", lambda s, b, u, e: s.visit(b, None, "rc"),
     ("entry", 2)),
    ("K9 rc", lambda s, b, u, e: s.visit(b, u, "rc"), ("entry", 2)),
    ("K9 u", lambda s, b, u, e: (s.visit(b, u, "u"),), ("entry",)),
    ("K9 ur", lambda s, b, u, e: s.visit(b, u, "ur"), ("entry", "entry")),
    ("K9 r", lambda s, b, u, e: (s.visit(b, u, "r"),), ("entry",)),
    ("K9 correct + u", lambda s, b, u, e: (s.visit(b, u, "u", e),), (2,)),
    ("K9 correct + ur", lambda s, b, u, e: s.visit(b, u, "ur", e), (2, 2)),
]


class _Side:
    """One package's 5-point kernels behind one interface."""

    def __init__(self, mod, st, jax_side):
        self.m, self.st, self.jax = mod, st, jax_side

    def _kw(self):
        return {"interpret": True} if self.jax else {}

    def apply_stencil5(self, u):
        fn = self.m.apply_stencil5_pallas if self.jax else self.m.apply_stencil5
        return fn(self.st, u, **self._kw())

    def residual5(self, b, u):
        fn = self.m.residual5_pallas if self.jax else self.m.residual5
        return fn(self.st, b, u, **self._kw())

    def smooth(self, b, u, steps):
        fn = self.m.smooth_sweeps_pallas if self.jax else self.m.smooth_sweeps
        return fn(self.st, b, u, steps, **self._kw())

    def visit(self, b, u, emit, e=None):
        fn = (self.m.fused_level_visit_pallas if self.jax
              else self.m.fused_level_visit)
        return fn(self.st, b, u, STEPS, emit=emit, e_coarse=e, **self._kw())


@pytest.mark.parametrize("shape", [(63, 63), (127, 31)])
@pytest.mark.parametrize("label,call,bounds", BF16_5PT,
                         ids=[c[0] for c in BF16_5PT])
def test_bf16_plain_matches_pallas(shape, label, call, bounds):
    jst, tst, b, u, e = _setup5(shape, sum(shape) + len(label))
    ref = call(_Side(jsk, jst, True), _bf_j(b), _bf_j(u), _bf_j(e))
    got = call(_Side(tsk, tst, False), _bf_t(b), _bf_t(u), _bf_t(e))
    ref = ref if isinstance(ref, tuple) else (ref,)
    for g, r, bound in zip(got, ref, bounds):
        _within_ulps(g, r, bound)


def test_bf16_visit_dot_in_f32():
    """The up visit's <b, u> is an f32 sum over the unrounded iterate, as
    JAX's: within the f32 noise of the bf16 rounding of the correction."""
    jst, tst, b, u, e = _setup5((63, 63), 4)
    z, dot = tsk.fused_level_visit(tst, _bf_t(b), _bf_t(u), STEPS, "u",
                                   _bf_t(e), emit_dot=True)
    zr, dr = jsk.fused_level_visit_pallas(jst, _bf_j(b), _bf_j(u), STEPS,
                                          emit="u", e_coarse=_bf_j(e),
                                          emit_dot=True, interpret=True)
    assert dot.dtype == torch.float32
    scale = float(np.abs(_f32(_bf_j(b)) * _f32(zr)).sum())
    assert abs(float(dot) - float(dr)) <= 2 * 2.0**-8 * scale


NINE = [
    ("K12 apply", lambda m, st, b, u, kw: (
        (m.apply_stencil9_pallas if kw else m.apply_stencil9)(st, u, **kw),)),
    ("K12 residual", lambda m, st, b, u, kw: (
        (m.residual9_pallas if kw else m.residual9)(st, b, u, **kw),)),
    ("K13 Jacobi", lambda m, st, b, u, kw: (
        (m.smooth9_sweeps_pallas if kw else m.smooth9_sweeps)(
            st, b, u, STEPS, **kw),)),
    ("K14 zero-guess rc", lambda m, st, b, u, kw: (
        m.fused_level_visit9_pallas if kw else m.fused_level_visit9)(
            st, b, None, STEPS, emit="rc", **kw)),
]


@pytest.mark.parametrize("label,call", NINE, ids=[c[0] for c in NINE])
def test_bf16_plain9_matches_pallas(label, call):
    ny, nx = 63, 63
    rng = np.random.default_rng(len(label))
    b, u = rng.standard_normal((ny, nx)), rng.standard_normal((ny, nx))
    prob = jp.AnisoProblem(1.0, 1.0, 1.0, 2.0, 0.4)
    jst = jp.stencil9_coefficients(prob, ny, nx, BF)
    tst = _bf_stencil(jst, from_numpy_stencil9)
    ref = call(jsk9, jst, _bf_j(b), _bf_j(u), {"interpret": True})
    got = call(tsk9, tst, _bf_t(b), _bf_t(u), {})
    for g, r in zip(got, ref):
        _within_ulps(g, r, 4)


def test_bf16_plain_rounds_once_at_the_store():
    """The bf16 plain version is the f32 one on the upcast inputs, rounded
    once per output (what the kernels do), not rounded after every op."""
    _, tst, b, u, _ = _setup5((63, 63), 2)
    st32 = type(tst)(*(c.float() for c in tst))
    got = tsk.fused_level_visit(tst, _bf_t(b), _bf_t(u), STEPS, "ur")
    want = tsk.fused_level_visit(st32, _bf_t(b).float(), _bf_t(u).float(),
                                 STEPS, "ur")
    for g, w in zip(got, want):
        assert torch.equal(g, w.to(torch.bfloat16))


def test_visit_bounds_per_storage_type():
    """Each storage type's bound on a visit's sweeps: the 5-point visit
    takes 23 steps with emit rc in f64; bf16 visits compute in f32 (43).  The 9-point visit's fixed region holds the anisotropic
    stencil in every type (f64: 131 KB), so its tile bounds it alike
    (29); an f64 visit whose 9 coefficients are all fields does not fit
    at all."""
    aniso9 = ((False, False), (True, False), (False, False), (False, True),
              (True, True), (False, True), (False, False), (True, False),
              (False, False))
    assert tmdma.max_visit_steps(None, "rc", 8) == 23
    assert tmdma.max_visit_steps(aniso9, "rc", 8) == 29
    assert tmdma.max_visit_steps(None, "rc", 4) == 43
    assert tmdma.max_visit_steps(aniso9, "rc", 4) == 29
    assert tmdma.max_visit_steps(((True, True),) * 9, "rc", 8) == 0
    assert tmdma.V5_MAX_HALO[8] == 25
    assert tmdma.visit_fits(None, 25, 8) and not tmdma.visit_fits(None, 26, 8)


def test_storage_type_checks():
    """The kernels' argument checks: a per-kernel set of storage types,
    one type for every array, scalars and schedules in the compute type."""
    dev = torch.device("cpu")
    x = torch.zeros((15, 15))
    for dt in tmdma.VISIT_DTYPES:
        assert tmdma._check_cuda(dev, {"x": (x.to(dt), (15, 15))},
                                 dtypes=tmdma.VISIT_DTYPES) == dt
    with pytest.raises(TypeError):
        tmdma._check_cuda(dev, {"x": (x.double(), (15, 15))})
    with pytest.raises(TypeError):
        tmdma._check_cuda(dev, {"x": (x, (15, 15)),
                                "y": (x.double(), (15, 15))},
                          dtypes=tmdma.VISIT_DTYPES)
    with pytest.raises(TypeError):  # a bf16 kernel's scalar is f32
        tmdma._check_cuda(dev, {"x": (x.bfloat16(), (15, 15))},
                          {"a": torch.zeros((), dtype=torch.bfloat16)},
                          dtypes=tmdma.VISIT_DTYPES)
    assert tmdma.steps_tensor(STEPS, dev, torch.bfloat16).dtype == \
        torch.float32
    assert tmdma.steps_tensor(STEPS, dev, torch.float64).dtype == \
        torch.float64


# --------------------------------------------------------------------------
# Solves
# --------------------------------------------------------------------------


def _both(kw, **port_kw):
    """The same config through the port (CPU) and the JAX package."""
    jkw = {k: (JST(v.value) if isinstance(v, SmootherType)
               else JCT(v.value) if isinstance(v, CycleType) else v)
           for k, v in kw.items()}
    return (solve(SolverConfig(**kw), device="cpu", **port_kw),
            j_solve(JC(**jkw), **{k: ((np.asarray(v),) if k == "u0" else v)
                                  for k, v in port_kw.items()}))


def _jax_true_residual(res):
    ctx = res.ctx
    ny, nx = ctx.levels[0].spec.primary.shape
    apply64, _ = jkr.outer_precision_operator(ctx, jnp.float64)
    if ctx.config.problem == "aniso":
        b = jp.aniso_rhs_grid(ctx.problem, ny, nx, jnp.float64)
    else:
        b = jp.rhs_grid(ctx.problem, JMesh(ctx.config.mesh), ny, nx,
                        jnp.float64)
    r = b - apply64(jnp.asarray(res.u[0], jnp.float64))
    return float(jnp.linalg.norm(r.ravel()) / jnp.linalg.norm(b.ravel()))


MIXED = dict(npts=65, grids=4, levels=4, cycle=CycleType.MGCG,
             dtype="float32", outer_dtype="float64", rtol=1e-8, max_iter=80)
MIXED_CASES = [
    (dict(mesh=0), 1e-6),
    (dict(mesh=1), 1e-6),
    (dict(mesh=2), 1e-6),
    (dict(problem="aniso", aniso=(1.0, 1.0, 1.0, 2.0, 0.4)), 1e-6),
    (dict(problem="aniso", aniso=(1.0, 0.0, 100.0, 0.0, 0.0),
          smoother=SmootherType.LINE_Y), 5e-6),
]


@pytest.mark.parametrize("kw,hist_atol", MIXED_CASES,
                         ids=["mesh0", "mesh1", "mesh2", "aniso",
                              "aniso-line"])
def test_mixed_outer_matches_jax(kw, hist_atol):
    got, ref = _both({**MIXED, **kw})
    assert got.outer_dtype == "float64" and got.route is None
    assert got.iters == ref.iters and got.converged and ref.converged
    assert got.u.dtype == torch.float64
    np.testing.assert_allclose(got.rnorm, ref.rnorm, rtol=0, atol=hist_atol)
    assert got.rnorm[-1] <= MIXED["rtol"]
    assert kr.true_relative_residual(got.ctx, got.u) <= 1e-8


@pytest.mark.parametrize("kw", [dict(mesh=1), dict(
    problem="aniso", aniso=(1.0, 1.0, 1.0, 2.0, 0.4))], ids=["mesh1",
                                                           "aniso"])
def test_float32x2_runs_as_f64(kw):
    """outer_dtype="float32x2" runs the native f64 outer here; against
    JAX's double-single outer: iterations within 1, both true f64
    residuals at or below 1e-8."""
    got, ref = _both({**MIXED, **kw, "outer_dtype": "float32x2"})
    f64, _ = _both({**MIXED, **kw})
    assert got.outer_dtype == "float64"
    assert abs(got.iters - ref.iters) <= 1
    assert got.iters == f64.iters
    assert torch.equal(got.u, f64.u)
    assert kr.true_relative_residual(got.ctx, got.u) <= 1e-8
    assert _jax_true_residual(ref) <= 1e-8


# (cycle, working dtype, rtol, mesh).  mg-FGMRES stops on the true
# residual, whose f32 floor at 65^2 (3.6e-5, the JAX package's too) is
# above any rtol worth testing, so it runs in f64 only.
BF16_PRECOND = [
    (CycleType.MGCG, "float64", 1e-7, 0),
    (CycleType.MGCG, "float32", 1e-5, 0),
    (CycleType.MGFGMRES, "float64", 1e-7, 0),
    (CycleType.MGFGMRES, "float64", 1e-7, 2),
]


@pytest.mark.parametrize("cycle,dtype,rtol,mesh", BF16_PRECOND,
                         ids=["mgcg-f64", "mgcg-f32", "fgmres-f64",
                              "fgmres-f64-mesh2"])
def test_bf16_preconditioner(cycle, dtype, rtol, mesh):
    """precond_dtype="bfloat16" (JAX's test_bf16_preconditioner_mgcg
    rules); the JAX package's own bf16 run converges too."""
    kw = dict(npts=65, grids=4, levels=4, cycle=cycle, dtype=dtype,
              rtol=rtol, max_iter=60, mesh=mesh)
    ref = solve(SolverConfig(**kw), device="cpu")
    res, jres = _both({**kw, "precond_dtype": "bfloat16"})
    pctx = res.ctx.precond_ctx
    assert pctx is not None and pctx.dtype == torch.bfloat16
    assert [l.shapes for l in pctx.levels] == [l.shapes
                                               for l in res.ctx.levels]
    assert res.converged and jres.converged
    assert res.iters <= ref.iters + 4
    np.testing.assert_allclose(res.u_fine, ref.u_fine, rtol=1e-5, atol=1e-9)
    if cycle == CycleType.MGCG:
        assert res.route == "generic"


def test_bf16_preconditioner_mixed_1e8():
    """bf16 preconditioner + f64 outer PCG still certifies 1e-8 (JAX's
    test_bf16_preconditioner_mixed_1e8)."""
    cfg = SolverConfig(npts=129, grids=5, levels=5, cycle=CycleType.MGCG,
                       dtype="float32", outer_dtype="float64", rtol=1e-8,
                       precond_dtype="bfloat16", max_iter=80)
    res = solve(cfg, device="cpu")
    assert res.converged and float(res.rnorm[-1]) <= 1e-8
    assert kr.true_relative_residual(res.ctx, res.u) <= 1e-8


F64_CASES = [
    dict(cycle=CycleType.MGCG, mesh=0),
    dict(cycle=CycleType.MGCG, mesh=1),
    dict(cycle=CycleType.MGCG, mesh=2),
    dict(cycle=CycleType.MGCG, problem="aniso",
         aniso=(1.0, 1.0, 1.0, 2.0, 0.4)),
    dict(cycle=CycleType.MGCG, v=(8, 8)),
]


@pytest.mark.parametrize("kw", F64_CASES,
                         ids=["mesh0", "mesh1", "mesh2", "aniso", "v8"])
def test_f64_levels_match_jax_generic(kw):
    """The default f64 config takes the generic route on both sides (JAX
    keeps 64-bit levels on its exact XLA path): history 1e-11, solution
    1e-12 relative."""
    got, ref = _both(dict(npts=65, grids=4, levels=4, max_iter=60, **kw))
    assert got.route == "generic" and ref.path == "generic"
    assert got.iters == ref.iters and got.converged
    np.testing.assert_allclose(got.rnorm, ref.rnorm, rtol=1e-11, atol=1e-15)
    np.testing.assert_allclose(got.u_fine, ref.u_fine, rtol=0,
                               atol=1e-12 * np.abs(ref.u_fine).max())


@pytest.mark.parametrize("mixed", [False, True], ids=["f64", "mixed"])
def test_warm_start_matches_jax(mixed):
    """u0 (a truncated solve's iterate) warm-starts a solve: as a
    correction solve to the effective rtol, or directly in the mixed
    outer; the same iterations and solution as JAX's."""
    kw = dict(npts=65, grids=4, levels=4, cycle=CycleType.MGCG)
    if mixed:
        kw.update(dtype="float32", outer_dtype="float64", rtol=1e-8)
    part = solve(SolverConfig(**{**kw, "outer_dtype": None, "max_iter": 2}),
                 device="cpu")
    got, ref = _both(kw, u0=part.u)
    assert got.converged and ref.converged
    assert got.iters == ref.iters
    full = solve(SolverConfig(**kw), device="cpu")
    assert got.iters <= full.iters
    tol = 1e-6 if mixed else 1e-12
    np.testing.assert_allclose(got.u_fine, ref.u_fine, rtol=0,
                               atol=tol * np.abs(ref.u_fine).max())
    if mixed:
        assert kr.true_relative_residual(got.ctx, got.u) <= 1e-8
    else:
        assert got.ctx.config.rtol > kw.get("rtol", 1e-7)


@pytest.mark.parametrize("kw", [dict(outer_dtype="float16"),
                                dict(precond_dtype="int8")])
def test_unknown_precision_options_raise(kw):
    cfg = SolverConfig(npts=17, grids=2, levels=2, cycle=CycleType.MGCG,
                       **kw)
    with pytest.raises(ValueError):
        solve(cfg, device="cpu")
