"""The bf16 working dtype with the line smoothers, RBGS and the sparse
backend, against the JAX package on the CPU: the plain versions of K15
(the y-line visit) and K8 (the field stencil) in bf16 against the JAX
kernels in interpret mode and against f64, one LINE_X, LINE_XY and RBGS
step against JAX's functions in f32 on the same bf16 inputs, and whole
bf16 solves against the f64 discrete solution.

bf16 is storage only: inputs upcast exactly, f32 arithmetic, each array
output rounded once where it is stored, dots in f32 (the rounding points:
``ops/cuda/line_kernel.py``'s and ``solvers/context.py``'s docstrings).
Tolerances, each with its reason:
  * K15 against ``line_visit9_pallas`` fed the same bf16 b, u, e_c and
    the bf16-rounded coefficients as an f32 stencil (JAX's kernel
    arithmetic with f32 factors): every entry within one bf16 ulp of
    max|out| (the same PCR recurrence in f32; XLA's FMA contraction can
    flip a rounding), two where a correction comes in (JAX forms u + P e
    in bf16 arithmetic, three roundings; the port once).  With a
    correction, JAX is also run from the iterate the port corrects to,
    bf16(u + P e) formed in f32 by JAX's own prolongation, and held to
    one ulp.  <b, u> (both sides sum over the unrounded f32 u): within
    1e-5 of sum |b u| of JAX's (its f32 PCR factor, formed in f32
    arithmetic, moves the dot by up to 2.7e-6 of it on config 4), and
    within 1e-6 of the f64 visit of the same stored system (the port
    reads 2e-8 to 4.5e-7; the sum over the rounded u, 3e-6 to 7e-6 off
    where a correction makes the dot cancel, fails it).
  * JAX's as-built bf16 K15 (its PCR factor computed in bf16 arithmetic,
    then cast to f32) and the port's plain K15 against an f64 line solve
    of the same bf16-rounded system: printed, and the port held within
    one bf16 ulp of max|u_64|, JAX's at least 10x further (the record
    that the port's side is the right one).
  * K8 against f64 on the same bf16 inputs: one bf16 ulp of each entry,
    or 2^-20 of sum |c u| where cancellation leaves an entry below f32's
    noise; against JAX's bf16 K8 (products and sums rounded to bf16):
    within 4.5 bf16 ulps of sum |c u| at each entry (nine roundings of
    values at most sum |c u|, each half an ulp).
  * LINE_X, LINE_XY, RBGS: one step of the port's plain path against
    JAX's functions in f32 on the bf16-rounded inputs, rounded at the
    port's points: one bf16 ulp of max|out|.  JAX's own bf16 step (XLA on
    the CPU rounds every op to bf16) is printed, not held.
  * solves: max|u - u_64| / max|u_64| against the f64 discrete solution
    (mg-CG to rtol 1e-13), the bounds of tests/test_torch_bf16.py:
    V-cycle 5e-3 and mg-CG 3e-2.  Two V-cycle bounds are wider, from the
    port's readings here.  The composed V-cycles on Poisson (RBGS, sparse
    Jacobi) store u at every half-sweep or sweep and take the residual of
    the stored u: 7.5e-3, that file's bound for PCMG and Additive, 1.41x
    their worst reading (the sparse V-cycle at 257^2, 5.32e-3; RBGS
    5.00e-3 at 129^2).  The x-strong LINE_XY V-cycle: 2e-2, 1.45x its
    1.38e-2 at 257^2.  Its visits are composed too, and A amplifies u's
    rounding by ~4 (1 + 100) / h^2 in the residual (LINE_X's V-cycle
    reads 1.27e-2; the y-strong LINE_Y V-cycle, whose K15 visits emit
    R r of the unrounded u, 2.9e-3).
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigrid_petsc_tpu.ops import stencil as jst
from multigrid_petsc_tpu.ops.pallas import line_kernel as jlk
from multigrid_petsc_tpu.ops.pallas import stencil_kernel as jsk
from multigrid_petsc_tpu_torch import problems as tp
from multigrid_petsc_tpu_torch.ops import sparse as sp
from multigrid_petsc_tpu_torch.ops.cuda import line_kernel as tlk
from multigrid_petsc_tpu_torch.ops.cuda import stencil_kernel as tsk
from multigrid_petsc_tpu_torch.ops.stencil import (
    Stencil5,
    Stencil9,
    off_line_y,
)
from multigrid_petsc_tpu_torch.solvers.context import build_context
from multigrid_petsc_tpu_torch.solvers.solve import solve
from multigrid_petsc_tpu_torch.utils.config import (
    CycleType,
    SmootherType,
    SolverConfig,
)

torch.set_num_threads(2)

BF = jnp.bfloat16
CONFIG4, WEAK_X = (1.0, 0.0, 100.0, 0.0, 0.0), (0.05, 0.0, 1.0, 0.0, 0.3)
X_STRONG = (100.0, 0.0, 1.0, 0.0, 0.0)


def _bf(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32)).to(torch.bfloat16)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.double().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32), np.float64)


def _j(x: torch.Tensor, dtype=BF):
    return jnp.asarray(x.float().numpy(), dtype)


def _ulp(a):
    """One bf16 ulp at |a| (8 significant bits), elementwise."""
    a = np.maximum(np.abs(a), 1e-30)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


def _ulps(got, ref) -> float:
    """max|got - ref| in bf16 ulps of max|ref|."""
    g, r = _np(got), _np(ref)
    assert g.shape == r.shape
    return float(np.abs(g - r).max() / _ulp(np.abs(r).max()))


def _line_stencil(prob, ny, nx) -> Stencil9:
    """The port's bf16 stencil of the (ny, nx) level, collapsed."""
    return tlk.collapse_stencil(tp.stencil9_coefficients(
        tp.AnisoProblem(*prob), ny, nx, torch.bfloat16, "cpu"))


def _rand(shape, seed, k=1):
    rng = np.random.default_rng(seed)
    return [_bf(rng.standard_normal(shape)) for _ in range(k)]


# --------------------------------------------------------------------------
# K15 in bf16
# --------------------------------------------------------------------------

# (guess, emit, correct, emit_dot, sweeps): tests/test_torch_line.py's.
MODES = [(True, "u", False, False, 3), (False, "rc", False, False, 3),
         (True, "u", True, True, 2), (True, "ur", False, False, 2),
         (True, "rc", True, False, 1), (False, "u", False, True, 2)]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape,prob", [((127, 127), CONFIG4),
                                        ((65, 33), WEAK_X)])
def test_k15_bf16_plain_matches_pallas(mode, shape, prob):
    guess, emit, correct, dot, sweeps = mode
    ny, nx = shape
    st = _line_stencil(prob, ny, nx)
    b, u = _rand(shape, sweeps + len(emit), 2)
    (e,) = _rand(((ny - 1) // 2, (nx - 1) // 2), 7)
    st32 = tlk.line_stencil(st)
    jst32 = jst.Stencil9(*(_j(c, jnp.float32) for c in st32))

    def pallas(u0, e0):
        out = jlk.line_visit9_pallas(jst32, _j(b), u0, sweeps, 0.9,
                                     emit=emit, e_coarse=e0, emit_dot=dot,
                                     interpret=True)
        return out if isinstance(out, tuple) else (out,)

    got = tlk.line_visit9(st32, b, u if guess else None, sweeps, 0.9,
                          emit=emit, e_coarse=e if correct else None,
                          emit_dot=dot)
    got = got if isinstance(got, tuple) else (got,)
    if correct:
        # JAX forms u + P e in bf16 arithmetic (three roundings), the
        # port in f32 (one): the arrays within two ulps.
        ref = pallas(_j(u), _j(e))
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            if np.ndim(r) != 0:
                assert _ulps(g, r) <= 2, _ulps(g, r)
        # Then JAX from the iterate the port corrects to: u + P e in f32
        # by JAX's own prolongation, rounded once.
        pe = jlk._prolong_x_vmem(jlk._prolong_y_vmem(_j(e, jnp.float32)))
        u0 = (_j(u, jnp.float32) + pe).astype(BF)
    else:
        u0 = _j(u) if guess else None
    ref = pallas(u0, None)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        if np.ndim(r) == 0:
            # <b, u> over the unrounded f32 u.  JAX's f32 visit (its PCR
            # factor formed in f32 arithmetic) lies up to 2.7e-6 of
            # sum |b u| from the f64 visit of the same stored system on
            # config 4, the port 2e-8: JAX holds the dot to 1e-5 of
            # sum |b u|, the f64 visit to 1e-6, which the sum over the
            # rounded u (3e-6 to 7e-6 off with a correction) misses.
            assert g.dtype == torch.float32 and r.dtype == jnp.float32
            sbu = float(np.abs(_np(b) * _np(got[0])).sum())
            assert abs(float(g) - float(r)) <= 1e-5 * sbu
            u64 = None if u0 is None else torch.as_tensor(
                np.asarray(u0, np.float64))
            _, d64 = tlk.line_visit9(Stencil9(*(c.double() for c in st32)),
                                     b.double(), u64, sweeps, 0.9,
                                     emit_dot=True)
            assert abs(float(g) - float(d64)) <= 1e-6 * sbu
        else:
            assert g.dtype == torch.bfloat16 and r.dtype == BF
            assert _ulps(g, r) <= 1, _ulps(g, r)


def _f64_line_sweep(st: Stencil9, b, u, omega):
    """One y-line Jacobi sweep of the bf16-rounded system in f64: the
    columns' tridiagonal systems solved by a dense f64 solve."""
    ny, nx = b.shape
    st64 = Stencil9(*(c.double() for c in st))
    rhs = (b.double() - off_line_y(st64, u.double())).numpy()
    cs, cc, cn = (np.broadcast_to(c.numpy(), (ny, nx)) for c in
                  (st64.cs, st64.cc, st64.cn))
    out = np.empty((ny, nx))
    for j in range(nx):
        a = (np.diag(cc[:, j]) + np.diag(cs[1:, j], -1)
             + np.diag(cn[:-1, j], 1))
        out[:, j] = np.linalg.solve(a, rhs[:, j])
    return (1.0 - omega) * u.double().numpy() + omega * out


def test_k15_bf16_factors_port_against_jax():
    """Config 4's nearly singular lines at 127^2: JAX's as-built bf16
    visit (its PCR factor in bf16 arithmetic) and the port's (f32 factors
    of the bf16-rounded coefficients), one sweep each, against the f64
    line solve of the same bf16 system; the port within one bf16 ulp of
    max|u_64|, JAX's at least 10x further off."""
    st = _line_stencil(CONFIG4, 127, 127)
    b, u = _rand((127, 127), 11, 2)
    ref = _f64_line_sweep(st, b, u, 0.9)
    port = tlk.line_visit9(tlk.line_stencil(st), b, u, 1, 0.9)
    jax_bf16 = jlk.line_visit9_pallas(
        jst.Stencil9(*(_j(c) for c in st)), _j(b), _j(u), 1, 0.9,
        interpret=True)
    scale = np.abs(ref).max()
    e_port = np.abs(_np(port) - ref).max() / scale
    e_jax = np.abs(_np(jax_bf16) - ref).max() / scale
    print(f"K15 bf16, config 4 at 127^2, one sweep, max|u - u_64| / "
          f"max|u_64|: port {e_port:.3e}, JAX as built {e_jax:.3e}")
    assert e_port <= _ulp(scale) / scale
    assert e_jax >= 10 * e_port


def test_line_stencil_is_the_f32_upcast():
    """A bf16 level's line stencil: collapsed, in f32, equal to the bf16
    coefficients; f32 and f64 stencils pass through collapse alone."""
    st = tp.stencil9_coefficients(tp.AnisoProblem(*CONFIG4), 31, 31,
                                  torch.bfloat16, "cpu")
    ls = tlk.line_stencil(st)
    assert all(c.dtype == torch.float32 for c in ls)
    for c, ref in zip(ls, tlk.collapse_stencil(st)):
        assert torch.equal(c, ref.float())
    st32 = Stencil9(*(c.float() for c in st))
    assert all(torch.equal(a, b) for a, b in
               zip(tlk.line_stencil(st32), tlk.collapse_stencil(st32)))
    fac = tlk.line_factor(st, 31)
    assert fac.dinv.dtype == torch.float32


# --------------------------------------------------------------------------
# K8 in bf16
# --------------------------------------------------------------------------


def _k8_fields(kind: str, n: int) -> Stencil5:
    if kind == "assembled":
        op = sp.SparseLevelOp.assemble(n + 2, 0, (0,), device="cpu",
                                       dtype=torch.bfloat16)
        assert op.form == "stencil" and op.shapes == [(n, n)]
        return op.stencil
    h2 = float(n + 1) ** 2
    rng = np.random.default_rng(5)
    f = [rng.standard_normal((n, n)) for _ in range(5)]
    f[2] = -(4.0 + np.abs(f[2]))
    return Stencil5(*(_bf(h2 * x) for x in f))


def _k8_terms(st: Stencil5, u) -> np.ndarray:
    """sum |c| |u| over the five terms at each point, in f64."""
    c = [np.abs(_np(x)) for x in st]
    p = np.pad(np.abs(_np(u)), 1)
    return (c[2] * p[1:-1, 1:-1] + c[0] * p[:-2, 1:-1] + c[4] * p[2:, 1:-1]
            + c[1] * p[1:-1, :-2] + c[3] * p[1:-1, 2:])


@pytest.mark.parametrize("resid", [False, True])
@pytest.mark.parametrize("kind", ["assembled", "random"])
def test_k8_bf16_plain_matches_f64_and_jax(kind, resid):
    n = 127
    st = _k8_fields(kind, n)
    u, b = _rand((n, n), 3, 2)
    if resid:
        got = tsk.residual5_field(st, b, u)
    else:
        got = tsk.apply_stencil5_field(st, u)
    st64 = Stencil5(*(c.double() for c in st))
    au = tsk.apply_stencil5_field_plain(st64, u.double())
    ref = (b.double() - au if resid else au).numpy()
    terms = _k8_terms(st, u) + (np.abs(_np(b)) if resid else 0.0)
    g = _np(got)
    assert got.dtype == torch.bfloat16
    lim = np.maximum(_ulp(ref), 2.0 ** -20 * terms)
    assert np.all(np.abs(g - ref) <= lim), float((np.abs(g - ref) / lim).max())
    jref = jsk.apply_stencil5_field_pallas(
        jst.Stencil5(*(_j(c) for c in st)), _j(u),
        _j(b) if resid else None, interpret=True)
    assert jref.dtype == BF
    d = np.abs(g - _np(jref)) / _ulp(terms)
    print(f"K8 bf16 ({kind}, resid {resid}) against JAX's bf16 kernel: at "
          f"most {d.max():.2f} bf16 ulps of sum |c u|")
    assert d.max() <= 4.5


def test_sparse_bf16_levels_store_bf16_through_f32():
    """The bf16 level's fields are the f64 CSR values rounded through f32
    (JAX's astype); a DIA form (a merged level's A1) is not ported in
    bf16."""
    csr = sp.assemble_level_csr(65, 1, (0,))
    op = sp.SparseLevelOp(*csr, [(63, 63)], device="cpu",
                          dtype=torch.bfloat16)
    op32 = sp.SparseLevelOp(*csr, [(63, 63)], device="cpu",
                            dtype=torch.float32)
    assert op.form == op32.form == "stencil"
    for c, c32 in zip(op.stencil, op32.stencil):
        assert c.dtype == torch.bfloat16 and torch.equal(c, c32.bfloat16())
    csr2 = sp.assemble_level_csr(65, 0, (0, 1), include_couplings=False)
    with pytest.raises(NotImplementedError, match="bf16 merged grids"):
        sp.SparseLevelOp(*csr2, [(63, 63), (31, 31)], device="cpu",
                         dtype=torch.bfloat16)


# --------------------------------------------------------------------------
# One step of LINE_X, LINE_XY and RBGS against JAX's functions in f32
# --------------------------------------------------------------------------


def _level(smoother, n, problem=None):
    kw = dict(npts=n + 2, grids=2, levels=2, dtype="bfloat16",
              smoother=smoother, omega=0.9 if smoother != SmootherType.RBGS
              else 1.0)
    if problem is not None:
        kw.update(problem="aniso", aniso=problem)
    return build_context(SolverConfig(**kw), device="cpu").levels[0]


def _round(x):
    return jnp.asarray(x, BF).astype(jnp.float32)


@pytest.mark.parametrize("smoother", [SmootherType.LINE_X,
                                      SmootherType.LINE_XY])
def test_line_x_xy_step_matches_jax_f32(smoother):
    n = 63
    lc = _level(smoother, n, X_STRONG)
    b, u = _rand((n, n), 13, 2)
    got = lc.smooth(b, u, 1)
    st = jst.Stencil9(*(_j(c, jnp.float32) for c in
                        Stencil9(*(c.float() for c in lc.stencil))))
    jb, ju = _j(b, jnp.float32), _j(u, jnp.float32)
    if smoother == SmootherType.LINE_X:
        ref = _round(jst.line_jacobi_sweeps_x(st, jb, ju, 1, 0.9))
    else:
        ref = _round(jst.line_jacobi_sweeps_y(st, jb, ju, 1, 0.9))
        ref = _round(jst.line_jacobi_sweeps_x(st, jb, ref, 1, 0.9))
    assert got.dtype == torch.bfloat16
    assert _ulps(got, ref) <= 1, _ulps(got, ref)
    jst_bf = jst.Stencil9(*(_j(c) for c in lc.stencil))
    fn = (jst.line_jacobi_sweeps_x if smoother == SmootherType.LINE_X
          else lambda s, bb, uu, k, w: jst.line_jacobi_sweeps_x(
              s, bb, jst.line_jacobi_sweeps_y(s, bb, uu, k, w), k, w))
    jax_bf = fn(jst_bf, _j(b), _j(u), 1, 0.9)
    print(f"{smoother.name} step: JAX in bf16 on the CPU "
          f"{_ulps(jax_bf, ref):.1f} bf16 ulps from the f32 reference, "
          f"the port {_ulps(got, ref):.1f}")


def test_rbgs_sweep_matches_jax_f32():
    """One RBGS sweep: per colour r = b - A u (JAX's ``residual`` in f32,
    rounded to bf16), then u + d r with the colour's bf16 omega / cc (in
    f32, rounded once)."""
    n = 63
    lc = _level(SmootherType.RBGS, n)
    b, u = _rand((n, n), 17, 2)
    got = lc.smooth(b, u, 1)
    st = jst.Stencil5(*(_j(c, jnp.float32) for c in lc.stencil))
    d = _np(1.0 / lc.stencil.cc)  # omega = 1: the bf16 D^-1
    ii, jj = np.mgrid[0:n, 0:n]
    ref = _j(u, jnp.float32)
    for red in (True, False):
        mask = ((ii + jj) % 2 == 0) == red
        r = _round(jst.residual(st, _j(b, jnp.float32), ref))
        ref = jnp.where(mask, _round(ref + jnp.asarray(d, jnp.float32) * r),
                        ref)
    assert got.dtype == torch.bfloat16
    assert _ulps(got, ref) <= 1, _ulps(got, ref)
    jax_bf = jst.sor_redblack_sweeps(jst.Stencil5(*(_j(c) for c in
                                                    lc.stencil)),
                                     _j(b), _j(u), 1, 1.0)
    print(f"RBGS sweep: JAX in bf16 on the CPU {_ulps(jax_bf, ref):.1f} "
          f"bf16 ulps from the f32 reference, the port "
          f"{_ulps(got, ref):.1f}")


# --------------------------------------------------------------------------
# Solves against the f64 discrete solution
# --------------------------------------------------------------------------

V_BOUND, CG_BOUND = 5e-3, 3e-2
COMPOSED_V_BOUND, XSTRONG_V_BOUND = 7.5e-3, 2e-2
# label: (config changes, problem, max error / max|u_64|)
CASES = {
    "line_y_vcycle": (dict(cycle=CycleType.VCYCLE, max_iter=10,
                           smoother=SmootherType.LINE_Y), CONFIG4, V_BOUND),
    "line_y_mgcg": (dict(cycle=CycleType.MGCG, max_iter=20,
                         smoother=SmootherType.LINE_Y), CONFIG4, CG_BOUND),
    "line_x_mgcg": (dict(cycle=CycleType.MGCG, max_iter=20,
                         smoother=SmootherType.LINE_X), X_STRONG, CG_BOUND),
    "line_xy_vcycle": (dict(cycle=CycleType.VCYCLE, max_iter=10,
                            smoother=SmootherType.LINE_XY), X_STRONG,
                       XSTRONG_V_BOUND),
    "rbgs_vcycle": (dict(cycle=CycleType.VCYCLE, max_iter=10,
                         smoother=SmootherType.RBGS), None,
                    COMPOSED_V_BOUND),
    "rbgs_coarse_mgcg": (dict(cycle=CycleType.MGCG, max_iter=20,
                              coarse_smoother=SmootherType.RBGS), None,
                         CG_BOUND),
    "sparse_vcycle": (dict(cycle=CycleType.VCYCLE, max_iter=10,
                           backend="sparse"), None, COMPOSED_V_BOUND),
    "sparse_mgcg": (dict(cycle=CycleType.MGCG, max_iter=20,
                         backend="sparse"), None, CG_BOUND),
}


def _cfg_kw(n, sparse=False, **kw):
    # The sparse backend's stencil form needs a coarsest level of 3^2 or
    # more (a 1^2 level's offsets +-1 and +-nx coincide, in JAX too).
    levels = int(np.log2(n - 1)) - (1 if sparse else 0)
    return dict(npts=n, grids=levels, levels=levels, **kw)


@functools.cache
def _f64_solution(problem, n: int, sparse: bool) -> np.ndarray:
    extra = {} if problem is None else dict(problem="aniso", aniso=problem)
    cfg = SolverConfig(**_cfg_kw(n, sparse, cycle=CycleType.MGCG,
                                 dtype="float64", rtol=1e-13, max_iter=200),
                       **extra)
    res = solve(cfg, device="cpu")
    assert res.converged
    return res.u_fine


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("n", [129, 257])
def test_bf16_smoother_solve_near_f64_solution(case, n):
    changes, problem, bound = CASES[case]
    sparse = changes.get("backend") == "sparse"
    extra = {} if problem is None else dict(problem="aniso", aniso=problem)
    cfg = SolverConfig(**_cfg_kw(n, sparse, dtype="bfloat16", rtol=0.0,
                                 **changes), **extra)
    res = solve(cfg, device="cpu")
    assert res.u.dtype == torch.bfloat16 and res.iters == cfg.max_iter
    assert res.rnorm.dtype == np.float32 and np.all(np.isfinite(res.rnorm))
    if sparse:
        assert all(lc.sparse_full.form == "stencil"
                   for lc in res.ctx.levels)
    ref = _f64_solution(problem, n, sparse)
    err = np.abs(res.u.float().numpy() - ref).max() / np.abs(ref).max()
    print(f"{case} {n}^2: {err:.3e} (bound {bound})")
    assert err <= bound, (case, n, err)
