"""The bf16 working dtype (``dtype="bfloat16"``) against the JAX package
on the CPU: the plain versions of K1, K2a, K10, K11 and K4 in bf16 against
the JAX kernels' bf16 branches in interpret mode, K4's split and its
rounded coarsest inverse, and whole bf16 solves against the f64 discrete
solution.

bf16 is storage only, in both packages' kernels: inputs upcast exactly,
f32 arithmetic, each array output rounded once where it is stored, dots
in f32.  Tolerances, each with its reason:
  * kernel outputs: within one bf16 ulp of max|out| of the JAX output
    (the same f32 values rounded once; f32 reassociation and XLA's FMA
    contraction can flip a rounding).  K10's rc: 2 ulps, since JAX stores
    its y-restricted half in bf16 and restricts it in x outside the kernel
    (a second rounding); K2a's mdma kernel restricts in-kernel (1 ulp).
  * dots: f32 sums of the same f32 products in another order: rtol 1e-5.
  * solves: max|u - u_64| / max|u_64| against the f64 discrete solution
    (mg-CG to rtol 1e-13), about 1.5x the worst reading of the port on
    the CPU at 129^2 and 257^2: V-cycle (10 forced) and FMG (5) 5e-3;
    PCMG and Additive (10 forced) 7.5e-3; mg-CG on the mdma, fused (-v
    8,8) and generic routes (20 forced) and mg-FGMRES (10 forced) 3e-2.
    bf16 rounds every stored level array to 2^-9 relative, so that is the
    floor (the V-cycle's ~2.5e-3).  The aniso problem is the default one,
    aniso (1, 0, 1, 0, 0), whose 9-point coefficients are powers of two
    and so exact in bf16; variable coefficients rounded to bf16 (the
    mixed-term (1, 1, 1, 2, 0.4)) perturb the operator itself, and the
    solution sits ~5e-2 from the f64 one whatever the cycle.
  * JAX's generic bf16 mg-CG rounds every XLA op on the CPU to bf16 and
    ends 0.9 from the f64 solution at 129^2 (rtol 1e-2, 12 iterations):
    the record that the port's side (the kernels' rounding points) is the
    right one.

JAX's mdma kernels (K1, K2a) take the lane-padded arrays of their
``shape_pad`` and refuse grids their tile geometry cannot cut (33^2 and
65^2: ``mdma_viable``), so K1 and K2a are held at 129^2, K10 and K11
(the same functions on unpadded arrays) at 65^2 and at 33^2 and 129^2,
and K4 on the 33^2 tree.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigrid_petsc_tpu import problems as jp
from multigrid_petsc_tpu.mesh import MeshType as JMesh
from multigrid_petsc_tpu.ops.pallas import coarse_tree_kernel as jctk
from multigrid_petsc_tpu.ops.pallas import mdma_kernel as jmdma
from multigrid_petsc_tpu.ops.pallas import stencil_kernel as jsk
from multigrid_petsc_tpu.solvers.context import build_context as j_build
from multigrid_petsc_tpu.solvers.krylov import build_coarse_tree as j_tree
from multigrid_petsc_tpu.solvers.solve import solve as j_solve
from multigrid_petsc_tpu.utils.config import CycleType as JCT
from multigrid_petsc_tpu.utils.config import SolverConfig as JC
from multigrid_petsc_tpu_torch.ops.cuda import coarse_tree_kernel as tctk
from multigrid_petsc_tpu_torch.ops.cuda import mdma_kernel as tmdma
from multigrid_petsc_tpu_torch.ops.cuda import stencil_kernel as tsk
from multigrid_petsc_tpu_torch.ops.stencil import from_numpy_stencil
from multigrid_petsc_tpu_torch.solvers import krylov as kr
from multigrid_petsc_tpu_torch.solvers.coarse import dense_from_stencil
from multigrid_petsc_tpu_torch.solvers.context import build_context
from multigrid_petsc_tpu_torch.solvers.solve import solve
from multigrid_petsc_tpu_torch.utils.config import (
    CycleType,
    SmootherType,
    SolverConfig,
)

torch.set_num_threads(2)

BF = jnp.bfloat16
STEPS = jsk.jacobi_step_coeffs(3, 0.8)


def _bf_j(x):
    return jnp.asarray(x, BF)


def _bf_t(x):
    """The same bf16 values as _bf_j, as a torch tensor."""
    return torch.as_tensor(np.array(_bf_j(x).astype(jnp.float32))).to(
        torch.bfloat16)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _ulp(a):
    """One bf16 ulp at |a| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(max(abs(a), 1e-30))) - 7)


def _within_ulps(got, ref, ulps=1):
    """Every entry within ``ulps`` bf16 ulps of max|ref|."""
    assert got.dtype == torch.bfloat16
    g, r = _f32(got), _f32(ref)
    assert g.shape == r.shape
    d = float(np.abs(g - r).max())
    lim = ulps * _ulp(np.abs(r).max())
    assert d <= lim, (d, lim)


def _dot_close(got, ref):
    assert got.dtype == torch.float32
    assert abs(float(got) - float(ref)) <= 1e-5 * abs(float(ref))


def _stencils(n):
    jst = jp.stencil_coefficients(JMesh.NONUNIFORM2, n, n, BF)
    st = from_numpy_stencil([np.asarray(c.astype(jnp.float32)) for c in jst],
                            "cpu", torch.float32)
    return jst, type(st)(*(c.to(torch.bfloat16) for c in st))


def _pad(x, ny, nx):
    rp, cp = jmdma.shape_pad(ny, nx)
    return jnp.pad(x, ((0, rp - x.shape[0]), (0, cp - x.shape[1])))


def _rand(k, n, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((n, n)) for _ in range(k)]


# --------------------------------------------------------------------------
# The kernels' plain versions against JAX's bf16 branches
# --------------------------------------------------------------------------


def test_k1_plain_matches_jax():
    """K1 (``cg_papply_u``): p', A p', u' bf16, <p', A p'> f32."""
    n = 129
    jst, tst = _stencils(n)
    z, p, u = _rand(3, n, 1)
    ref = jmdma.cg_papply_u_mdma(
        jst, _pad(_bf_j(z), n, n), _pad(_bf_j(p), n, n),
        _pad(_bf_j(u), n, n), 0.21, 0.43, ny=n, nx=n, interpret=True)
    got = tmdma.cg_papply_u(tst, _bf_t(z), _bf_t(p), _bf_t(u),
                            torch.tensor(0.21), torch.tensor(0.43))
    for g, r in zip(got[:3], ref[:3]):
        _within_ulps(g, r[:n, :n])
    _dot_close(got[3], ref[3])


def test_k2a_plain_matches_jax():
    """K2a (``cg_visit_down``): u0, rc, r' bf16, ||r'||^2 f32."""
    n = 129
    jst, tst = _stencils(n)
    r, ap = _rand(2, n, 2)
    ref = jmdma.cg_visit_down_mdma(jst, _pad(_bf_j(r), n, n),
                                   _pad(_bf_j(ap), n, n), 0.37, STEPS, ny=n,
                                   nx=n, interpret=True)
    got = tmdma.cg_visit_down(tst, _bf_t(r), _bf_t(ap), torch.tensor(0.37),
                              STEPS)
    nc = (n - 1) // 2
    _within_ulps(got[0], ref[0][:n, :n])
    _within_ulps(got[1], ref[1][:nc, :nc])
    _within_ulps(got[2], ref[2][:n, :n])
    _dot_close(got[3], ref[3])


@pytest.mark.parametrize("n", [33, 129])
def test_k11_plain_matches_jax(n):
    """K11 (``cg_papply``): p', A p' bf16, <p', A p'> f32."""
    jst, tst = _stencils(n)
    z, p = _rand(2, n, n)
    ref = jsk.cg_papply_pallas(jst, _bf_j(z), _bf_j(p), 0.43, interpret=True)
    got = tsk.cg_papply(tst, _bf_t(z), _bf_t(p), torch.tensor(0.43))
    _within_ulps(got[0], ref[0])
    _within_ulps(got[1], ref[1])
    _dot_close(got[2], ref[2])


def test_k10_plain_matches_jax():
    """K10 (``cg_visit_down`` of the fused route) at 65^2; rc to 2 ulps
    (JAX's x-restriction rounds its bf16 y half again)."""
    n = 65
    jst, tst = _stencils(n)
    r, ap = _rand(2, n, 3)
    ref = jsk.cg_visit_down_pallas(jst, _bf_j(r), _bf_j(ap), 0.37, STEPS,
                                   interpret=True)
    got = tsk.cg_visit_down(tst, _bf_t(r), _bf_t(ap), torch.tensor(0.37),
                            STEPS)
    _within_ulps(got[0], ref[0])
    _within_ulps(got[1], ref[1], ulps=2)
    _within_ulps(got[2], ref[2])
    _dot_close(got[3], ref[3])


def _cfg_kw(n, **kw):
    levels = int(np.log2(n - 1))
    return dict(npts=n, grids=levels, levels=levels, **kw)


def test_k4_plain_matches_jax():
    """K4 on the trees each package's build_coarse_tree picks for a bf16
    mg-CG context at 33^2 (from level 1: 15^2 -> 1^2, the direct
    coarsest solve): the result bf16 within one ulp of max|out|."""
    kw = _cfg_kw(33, dtype="bfloat16")
    j_lt, j_fn = j_tree(j_build(JC(cycle=JCT.MGCG, **kw)), interpret=True)
    t_lt, t_fn = kr.build_coarse_tree(
        build_context(SolverConfig(cycle=CycleType.MGCG, **kw),
                      device="cpu"))
    assert j_lt == t_lt == 1
    (b,) = _rand(1, 15, 4)
    ref = j_fn(_bf_j(b))
    got = t_fn(_bf_t(b))
    assert ref.dtype == BF
    _within_ulps(got, ref)


@pytest.mark.parametrize("npts,grids,start", [(8193, 11, 3), (513, 7, 1)])
def test_k4_split_matches_jax_rule_in_bf16(npts, grids, start):
    """The tree starts where JAX's rule starts it in bf16: its VMEM model
    counts max(itemsize, 4) bytes a point, so the split is f32's."""
    shapes = [(m, m) for m in ((npts - 1) // 2**g - 1 for g in range(grids))]

    def first(viable):
        for l_t in range(1, grids - 1):
            s = shapes[l_t:]
            if viable(s, False) and viable(s, True):
                return l_t
        return None

    assert first(lambda s, d: tctk.coarse_tree_viable(s, 2, direct=d)) \
        == first(lambda s, d: jctk.coarse_tree_viable(s, BF, direct=d)) \
        == first(lambda s, d: tctk.coarse_tree_viable(s, 4, direct=d)) \
        == start


def test_k4_inverse_rounded_to_bf16():
    """The bf16 tree's coarsest inverse is the f64 host inverse rounded
    (through f32, as JAX's ``astype``) to bf16, and the plain version
    applies that rounded inverse in f32: rounding its result once gives
    exactly the tree's output."""
    kw = _cfg_kw(65, dtype="bfloat16")
    ctx = build_context(SolverConfig(cycle=CycleType.MGCG, **kw),
                        device="cpu")
    l_t, fn = kr.build_coarse_tree(ctx)
    coarsest = ctx.levels[-1]
    inv = np.linalg.inv(dense_from_stencil(coarsest.stencil,
                                           *coarsest.shape))
    assert fn.a_inv.dtype == torch.bfloat16
    assert torch.equal(fn.a_inv,
                       torch.as_tensor(inv.astype(np.float32)).bfloat16())
    sts = [tmdma._up(lv.stencil) for lv in ctx.levels[l_t:]]
    steps = [lv.steps_fn(3) for lv in ctx.levels[l_t:]]
    b = torch.randn(ctx.levels[l_t].shape, generator=torch.Generator()
                    .manual_seed(5)).bfloat16()
    want = tctk.coarse_tree_plain(sts, steps, fn.a_inv.float(), b.float())
    assert torch.equal(fn(b), want.bfloat16())


# --------------------------------------------------------------------------
# Solves against the f64 discrete solution
# --------------------------------------------------------------------------

PROBLEMS = {"poisson": {}, "aniso": {"problem": "aniso"}}
# label: (config changes, max error / max|u_64|, the mg-CG route)
CASES = {
    "vcycle": (dict(cycle=CycleType.VCYCLE, max_iter=10), 5e-3, None),
    "fmg": (dict(cycle=CycleType.FMG, max_iter=5), 5e-3, None),
    "pcmg": (dict(cycle=CycleType.PCMG, max_iter=10), 7.5e-3, None),
    "additive": (dict(cycle=CycleType.ADDITIVE, max_iter=10), 7.5e-3, None),
    "mgcg": (dict(cycle=CycleType.MGCG, max_iter=20), 3e-2, "mdma"),
    "mgcg_fused": (dict(cycle=CycleType.MGCG, max_iter=20, v=(8, 8)), 3e-2,
                   "fused"),
    "mgcg_generic": (dict(cycle=CycleType.MGCG, max_iter=20), 3e-2,
                     "generic"),
    "fgmres": (dict(cycle=CycleType.MGFGMRES, max_iter=10), 3e-2, None),
}


@functools.cache
def _f64_solution(problem: str, n: int) -> np.ndarray:
    cfg = SolverConfig(**_cfg_kw(n, cycle=CycleType.MGCG, dtype="float64",
                                 rtol=1e-13, max_iter=200),
                       **PROBLEMS[problem])
    res = solve(cfg, device="cpu")
    assert res.converged
    return res.u_fine


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("n", [129, 257])
@pytest.mark.parametrize("problem", list(PROBLEMS))
def test_bf16_solve_near_f64_solution(problem, n, case):
    changes, bound, route = CASES[case]
    cfg = SolverConfig(**_cfg_kw(n, dtype="bfloat16", rtol=0.0, **changes),
                       **PROBLEMS[problem])
    if problem == "aniso" and route is not None:
        route = "generic"  # a 9-point level 0 takes the generic loop
    if case == "mgcg_generic" and problem == "poisson":
        # Poisson's route is mdma: the generic loop run on its context.
        ctx = build_context(cfg, device="cpu")
        out = kr._solve_mgcg_generic(ctx, ctx.b0)
        u, iters, hist = out.u, out.iters, out.rnorm_history
    else:
        res = solve(cfg, device="cpu")
        assert res.route == route and res.path == "torch"
        assert res.rnorm.dtype == np.float32
        u, iters, hist = res.u, res.iters, torch.as_tensor(res.rnorm)
    assert u.dtype == torch.bfloat16 and iters == cfg.max_iter
    assert hist.dtype == torch.float32 and bool(torch.isfinite(hist).all())
    ref = _f64_solution(problem, n)
    err = np.abs(u.float().numpy() - ref).max() / np.abs(ref).max()
    assert err <= bound, (problem, n, case, err)


def test_jax_generic_bf16_mgcg_is_the_wrong_side():
    """JAX's generic bf16 mg-CG on the CPU (every XLA op rounded to bf16)
    stops at rtol 1e-2 0.9 from the f64 discrete solution at 129^2; the
    port's bf16 mg-CG (the kernels' rounding points) to the same rtol ends
    within 1e-2 of it."""
    kw = _cfg_kw(129, cycle=CycleType.MGCG, dtype="bfloat16", rtol=1e-2)
    ref = _f64_solution("poisson", 129)
    jres = j_solve(JC(**{**kw, "cycle": JCT.MGCG}))
    assert jres.ctx.solver_path == "generic"
    j_err = np.abs(np.asarray(jres.u_fine, np.float64) - ref).max() \
        / np.abs(ref).max()
    tres = solve(SolverConfig(**kw), device="cpu")
    t_err = np.abs(tres.u_fine - ref).max() / np.abs(ref).max()
    assert tres.converged
    assert j_err > 0.5 and t_err < 1e-2, (j_err, t_err)


def test_chebyshev_bf16_runs_the_mdma_route():
    """The Chebyshev smoother in bf16 (its lmax estimated on the bf16
    level) takes the mdma route and ends as near as Jacobi."""
    cfg = SolverConfig(**_cfg_kw(129, cycle=CycleType.MGCG,
                                 dtype="bfloat16", rtol=0.0, max_iter=20,
                                 smoother=SmootherType.CHEBYSHEV))
    res = solve(cfg, device="cpu")
    ref = _f64_solution("poisson", 129)
    assert res.route == "mdma"
    assert np.abs(res.u_fine - ref).max() / np.abs(ref).max() <= 3e-2
