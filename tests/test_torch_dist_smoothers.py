"""Row-partition distribution of the port against the JAX package on the
CPU, part 4: the smoothers and levels off K17's fused visit under the
plan.  A 4-rank gloo world (``_dist_worker.py``, started once for the
module) solves mg-CG with RBGS, with a fine x-line level, with y-lines on
aniso (1,0,100,0,0), an alternating-line V-cycle on aniso (100,0,1,0,0),
mg-CG -v 8,8 (its 8-row blocks cannot carry the visit's halo: Jacobi
visits in pieces; the Chebyshev steps are a unit case below) and mg-CG on a 9-point level whose centre is no sum of an
x- and a y-profile, each held to JAX's 4-device row-plan solve (129^2, 4
levels, ``min_local=8``, ``backend="pallas"``), which shards the same
levels and runs them through GSPMD where its dist kernels do not take
them; and it runs a sharded level's operators on row blocks ("units"):
RBGS on odd and even blocks, visits in pieces, the block-local transfers
and the line sweeps, each held to the whole-grid function.  In one
process: K17's bf16 plain version against JAX's ``DistLevelOps`` in
interpret mode, a model of ``csrc/line.cuh``'s rank-spanning mode against
``line_jacobi_sweeps_y``, and RBGS's colours on the blocks.

Tolerances: the solves as parts 1 and 2 (iterations equal, rnorm rtol
1e-6 / atol 1e-9, u_fine rtol 1e-6 / atol 1e-12; the aniso y-line
problem's nearly singular lines 5e-6 of the history, as
test_torch_precision.py holds them); the units rtol 1e-12 / atol 1e-12
of the largest entry (the same arithmetic in another order); K17 bf16 as
test_torch_precision.py holds the bf16 kernels (1 bf16 ulp of each entry
where JAX rounds where the port does, 2 ulps of the largest entry where a
JAX transfer rounds once more outside its kernel); the line model 1e-10
of the largest entry (the segmented solve's own rounding, f64).
"""

from __future__ import annotations

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _dist_worker as dw
from multigrid_petsc_tpu import problems as jp
from multigrid_petsc_tpu.mesh import MeshType as JMesh
from multigrid_petsc_tpu.ops import stencil as jst_ops
from multigrid_petsc_tpu.ops.pallas.stencil_kernel import (
    jacobi_step_coeffs as j_jac,
)
from multigrid_petsc_tpu.parallel.device_mesh import make_row_mesh
from multigrid_petsc_tpu.parallel.device_mesh import row_plan as j_row_plan
from multigrid_petsc_tpu.parallel.dist_ops import DistLevelOps as JDist
from multigrid_petsc_tpu.solvers.solve import solve as j_solve
from multigrid_petsc_tpu_torch.mesh import MeshType
from multigrid_petsc_tpu_torch.ops.cuda import dist_kernel as dk
from multigrid_petsc_tpu_torch.ops.cuda import line_kernel as lk
from multigrid_petsc_tpu_torch.ops.cuda import stencil_kernel as sk
from multigrid_petsc_tpu_torch.ops.stencil import (
    from_numpy_stencil,
    line_jacobi_sweeps_y,
    redblack_dinv,
)
from multigrid_petsc_tpu_torch.ops.transfer import prolong_bilinear, restrict_fw
from multigrid_petsc_tpu_torch.parallel import DistLevelOps
from multigrid_petsc_tpu_torch.problems import (
    AnisoProblem,
    stencil9_coefficients,
    stencil_coefficients,
)
from multigrid_petsc_tpu_torch.solvers import smoothers as sm
from test_torch_dist import EMITS, port_visit
from test_torch_dist_cycles import jax_config, sharded_levels
from test_torch_precision import _bf_j, _bf_stencil, _bf_t, _within_ulps

torch.set_num_threads(2)

BASE = dict(npts=129, grids=4, levels=4, max_iter=40)
STRONG_Y = (1.0, 0.0, 100.0, 0.0, 0.0)
STRONG_X = (100.0, 0.0, 1.0, 0.0, 0.0)
CONFIGS = {
    "RBGS": dict(BASE, cycle=101, smoother="rbgs"),
    "LINE_X": dict(BASE, cycle=101, fine_smoother="line_x"),
    "LINE_Y": dict(BASE, cycle=101, problem="aniso", aniso=STRONG_Y,
                   smoother="line_y"),
    "LINE_XY": dict(BASE, cycle=0, problem="aniso", aniso=STRONG_X,
                    smoother="line_xy"),
    "V88": dict(BASE, cycle=101, v=(8, 8)),
    "NONSEP": dict(npts=129, grids=3, levels=3, cycle=101, problem="aniso",
                   aniso=(1.0, 1.0, 1.0, 2.0, 0.4), rtol=1e-8, max_iter=40),
}
HIST_ATOL = {"LINE_Y": 5e-6}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The module's 4-rank gloo world, started with the module's first
    test, so the ranks solve while the JAX references run."""
    out = tmp_path_factory.mktemp("dist_smoothers")
    jobs = {name: {"cfg": f, "min_local": 8, "nonsep": name == "NONSEP"}
            for name, f in CONFIGS.items()}
    jobs["units"] = {}
    procs = dw.spawn(jobs, out)
    state = {"done": False}

    def results():
        if not state["done"]:
            dw.finish(procs)
            state["done"] = True
        return out

    yield results
    for p in procs:
        if p.poll() is None:
            p.kill()


def _nonsep_jax(fn):
    def coefficients(prob, ny, nx, dtype):
        st = fn(prob, ny, nx, dtype)
        return st._replace(cc=st.cc * jnp.asarray(dw.nonsep_factor(ny, nx),
                                                  dtype))

    return coefficients


@pytest.fixture(scope="module")
def jax_refs(world):
    """JAX's 4-device row-plan solves of CONFIGS (the world runs
    meanwhile); NONSEP with JAX's centre multiplied alike."""
    plan = j_row_plan(devices=jax.devices()[:dw.WORLD], min_local=8)
    refs = {}
    for name, f in CONFIGS.items():
        if name != "NONSEP":
            refs[name] = j_solve(jax_config(f), plan=plan)
            continue
        orig = jp.stencil9_coefficients
        jp.stencil9_coefficients = _nonsep_jax(orig)
        try:
            refs[name] = j_solve(jax_config(f), plan=plan)
        finally:
            jp.stencil9_coefficients = orig
    return refs


@pytest.mark.parametrize("name", list(CONFIGS))
def test_smoother_matches_jax_dist(world, jax_refs, name):
    ref = jax_refs[name]
    runs = dw.load(world(), name)
    r0 = runs[0]
    for r in runs[1:]:
        assert int(r["iters"]) == int(r0["iters"])
        np.testing.assert_array_equal(r["u"], r0["u"])
    gathers = json.loads(str(r0["gathers"]))
    assert set(gathers) <= {"agglomerate", "line", "coarsest"}, gathers
    # The y-lines' carries cross the ranks; NONSEP's sharded coarsest
    # level is solved directly, as JAX solves its GSPMD level.
    assert (gathers.get("line", 0) > 0) == (name in ("LINE_Y", "LINE_XY"))
    assert (gathers.get("coarsest", 0) > 0) == (name == "NONSEP")
    assert str(r0["path"]) == "torch"
    assert list(r0["dist"]) == sharded_levels(ref)
    assert any(r0["dist"]), "no level ran sharded"
    assert bool(r0["converged"]) == bool(ref.converged)
    assert int(r0["iters"]) == int(ref.iters)
    np.testing.assert_allclose(r0["rnorm"], ref.rnorm, rtol=1e-6,
                               atol=HIST_ATOL.get(name, 1e-9))
    np.testing.assert_allclose(r0["u"], ref.u_fine, rtol=1e-6, atol=1e-12)


def test_nonsep_level_is_not_separable():
    """The NONSEP centre is what JAX's dist kernels refuse (JAX sends the
    level to GSPMD), and the port runs it on K17."""
    from multigrid_petsc_tpu.ops.pallas.dist_kernel import separable9

    st = _nonsep_jax(jp.stencil9_coefficients)(
        jp.AnisoProblem(1.0, 1.0, 1.0, 2.0, 0.4), 127, 127, jnp.float64)
    assert not separable9(st, 127, 127)
    assert not dk.separable9(dw.nonsep_coefficients(stencil9_coefficients)(
        AnisoProblem(1.0, 1.0, 1.0, 2.0, 0.4), 127, 127, torch.float64,
        "cpu"))


# -- a sharded level's operators on the row blocks (the "units" job) -------


@pytest.fixture(scope="module")
def units(world):
    runs = dw.load(world(), "units")
    for r in runs[1:]:
        for k in runs[0]:
            np.testing.assert_array_equal(r[k], runs[0][k])
    return runs[0]


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())


def _inputs(u, *idx):
    return [u[f"in{i}"] for i in idx]


def _st5(ny):
    return stencil_coefficients(MeshType(1), ny, ny, torch.float64, "cpu")


@pytest.mark.parametrize("ny,first", [(19, 0), (31, 2)],
                         ids=["odd-5-row-blocks", "even-8-row-blocks"])
def test_rbgs_on_blocks_matches_jax(units, ny, first):
    """Two RBGS sweeps (omega 1.2) on the ranks' blocks, colours by the
    global parity: JAX's ``sor_redblack_sweeps`` on the whole grid (R = 5:
    ranks 1 and 3 start on a black row)."""
    b, u = _inputs(units, first, first + 1)
    jst = jp.stencil_coefficients(JMesh(1), ny, ny, jnp.float64)
    want = jst_ops.sor_redblack_sweeps(jst, jnp.asarray(b), jnp.asarray(u),
                                       2, 1.2)
    _close(units[f"rbgs{ny}"], want)


@pytest.mark.parametrize("case", ["rc0", "ur", "cheb"])
def test_visits_in_pieces_match_one_whole_visit(units, case):
    """On 8-row blocks a visit of 8 steps (halo 10) runs as Jacobi visits
    of at most 6 steps, a Chebyshev one a residual per step: each equals
    one whole-grid visit (K9's plain version)."""
    st = _st5(31)
    b, u, e = (torch.as_tensor(x) for x in _inputs(units, 4, 5, 6))
    jac = sm.jacobi_step_coeffs(8, 0.8)
    if case == "rc0":
        want = sk.fused_level_visit_plain(st, b, None, jac, "rc")
    elif case == "ur":
        want = sk.fused_level_visit_plain(st, b, u, jac, "ur", e)
    else:
        want = (sk.smooth_sweeps_plain(st, b, u,
                                       sm.chebyshev_step_coeffs(8, 1.9)),)
    keys = {"rc0": ("rc0_u", "rc0_rc"), "ur": ("ur_u", "ur_r"),
            "cheb": ("cheb",)}[case]
    for k, w in zip(keys, want):
        _close(units[k], w)


@pytest.mark.parametrize("case", ["restrict63", "prolong63", "agglomerate31",
                                  "prolong31"])
def test_block_transfers_match_whole_grid(units, case):
    """Full weighting and bilinear prolongation between the sharded 63^2
    and 31^2 levels on the blocks (one exchanged row), and from the
    sharded 31^2 level to the replicated 15^2 one (the restricted blocks
    gathered; the prolongation cut from the whole coarse grid)."""
    idx = {"restrict63": 7, "prolong63": 8, "agglomerate31": 9,
           "prolong31": 10}[case]
    (x,) = _inputs(units, idx)
    x = torch.as_tensor(x)
    want = restrict_fw(x) if "restrict" in case or "agglom" in case \
        else prolong_bilinear(x)
    _close(units[case], want)


@pytest.mark.parametrize("case", ["line_y", "line_x"])
def test_line_sweeps_on_blocks_match_jax(units, case):
    """Two damped y-line sweeps over the ranks (the line right-hand sides
    gathered, PCR over the whole columns) and two x-line sweeps on the
    blocks, on the aniso (1,1,1,2,0.4) 63^2 level: JAX's
    ``line_jacobi_sweeps_y`` / ``_x`` on the whole grid."""
    b, u = _inputs(units, 11, 12)
    jst = jp.stencil9_coefficients(jp.AnisoProblem(1.0, 1.0, 1.0, 2.0, 0.4),
                                   63, 63, jnp.float64)
    fn = (jst_ops.line_jacobi_sweeps_y if case == "line_y"
          else jst_ops.line_jacobi_sweeps_x)
    _close(units[case], fn(jst, jnp.asarray(b), jnp.asarray(u), 2, 0.8))


# -- single process --------------------------------------------------------


class _Plan:
    """Rank ``rank`` of ``size`` (the block rules need no process group)."""

    def __init__(self, rank, size):
        self.rank, self.size = rank, size


@pytest.mark.parametrize("ny,P", [(19, 4), (14, 3), (31, 4)],
                         ids=["R5", "R5-P3", "R8"])
def test_rbgs_colours_follow_the_global_parity(ny, P):
    """Each block's (red, black) omega / cc are the whole grid's rows of
    them (``redblack_dinv``), its pad row 0, whatever the block's parity."""
    st = _st5(ny)
    whole = redblack_dinv(st, (ny, ny), 1.2)
    for rank in range(P):
        d = DistLevelOps(st, ny, ny, _Plan(rank, P), 3)
        d.setup_rbgs(1.2)
        for got, w in zip(d.rb_dinv, whole):
            np.testing.assert_array_equal(got.numpy(), d.block_of(w).numpy())


def _bf16_visit(emit, seed):
    """K17's plain version on bf16 storage (8 blocks, halos cut from the
    neighbours) and JAX's DistLevelOps in bf16 (interpret mode, the
    conftest's 8-device row mesh), on the same bf16 inputs."""
    ny = nx = 63
    rng = np.random.default_rng(seed)
    pad = lambda x: np.concatenate([x, np.zeros((1, x.shape[1]))])  # noqa
    u = pad(rng.standard_normal((ny, nx)))
    b = pad(rng.standard_normal((ny, nx)))
    e = (pad(rng.standard_normal(((ny - 1) // 2, (nx - 1) // 2)))
         if emit.startswith("correct") else None)
    jst = jp.stencil_coefficients(JMesh.NONUNIFORM2, ny, nx, jnp.bfloat16)
    tst = _bf_stencil(jst, from_numpy_stencil)
    ops = JDist(jst, ny, nx, make_row_mesh(), jnp.bfloat16,
                steps_fn=lambda s: j_jac(s, 0.8), interpret=True)
    ju, jb, je = (None if x is None else _bf_j(x) for x in (u, b, e))
    steps = j_jac(3, 0.8)
    if emit == "a":
        want = ops.apply(ju)
    elif emit == "r":
        want = ops.residual(jb, ju)
    elif emit == "u":
        want = ops.smooth(jb, ju, 3)
    elif emit == "ur":
        fn, cs = ops._fn(steps, "ur", False)
        want = fn(cs, ju, jb)
    elif emit in ("rc", "rc0"):
        want = ops.visit_down(jb, None if emit == "rc0" else ju, 3)
    else:
        want = ops.visit_up(jb, ju, je, 3, emit == "correct_ur")
    want = want if isinstance(want, tuple) else (want,)
    t = {k: None if x is None else _bf_t(x) for k, x in
         (("u", u), ("b", b), ("e", e))}
    got = port_visit(tst, ny, emit, t["u"], t["b"], t["e"], numpy=False)
    return got, want


@pytest.mark.parametrize("emit", EMITS)
def test_k17_bf16_plain_matches_jax(emit):
    """K17 on bf16 storage: upcast, f32 arithmetic, one rounding per
    output, as JAX's dist kernel (``_load_f32`` / ``_store``).  JAX's
    restriction stores its y half in bf16 before its x pass (outside the
    kernel), and prolongs a correction in x in bf16 before it: those
    outputs to 2 bf16 ulps of the largest entry, the rest to 1 ulp of
    each entry."""
    got, want = _bf16_visit(emit, seed=11)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.bfloat16
        assert bool((g[-1] == 0).all())  # the pad row, the coarse pad row
        bound = 2 if (emit.startswith("correct") or i == 1
                      and emit in ("rc", "rc0")) else "entry"
        _within_ulps(g, w, bound)


def _rows_model(st, fac, rhs, P):
    """``csrc/line.cuh``'s rank-spanning solve of every column of ``rhs``
    (ny, nx), as test code: ``fac`` the whole level's segmented factors of
    seg-row segments (``RowLine``'s); each of P blocks forms its segments'
    zero-carry ends from its rows' slices of the factors (launch 1), the
    ends are stacked in rank order (the all-gather), the carries walked
    over every segment with the whole level's factors (launch 2), and
    each block runs Thomas's recurrences from zero carries in its
    segments and fixes them up with its slice of the carries (launch
    3)."""
    ny, nx = rhs.shape
    R = (ny + 1) // P
    seg = math.gcd(R, lk.LINE_SEG)
    nseg = (ny + 1) // seg

    def cut(x):  # (ny, w) -> (nseg, seg, nx), the pad row 0
        x = torch.broadcast_to(x, (ny, nx))
        return torch.cat([x, x.new_zeros((1, nx))]).reshape(nseg, seg, nx)

    r, a, m, cp, above, below, end_w, start_w = (
        cut(t) for t in (rhs, st.cs, fac.m, fac.cp, fac.above, fac.below,
                         fac.end_w, fac.start_w))
    ends, starts = (end_w * r).sum(1), (start_w * r).sum(1)
    gain = torch.broadcast_to(fac.gain, (nseg, nx))
    cin = [torch.zeros(nx, dtype=rhs.dtype)]
    for s in range(nseg - 1):
        cin.append(ends[s] + gain[s] * cin[-1])
    din = [torch.zeros(nx, dtype=rhs.dtype)] * nseg
    for s in range(nseg - 1, 0, -1):
        din[s - 1] = starts[s] + cin[s] * above[s, 0] + din[s] * below[s, 0]
    dp, xl = torch.zeros_like(r), torch.zeros_like(r)
    d = torch.zeros_like(r[:, 0])
    for i in range(seg):
        d = dp[:, i] = (r[:, i] - a[:, i] * d) * m[:, i]
    x = torch.zeros_like(d)
    for i in reversed(range(seg)):
        x = xl[:, i] = dp[:, i] - cp[:, i] * x
    x = xl + torch.stack(cin)[:, None] * above + torch.stack(din)[:, None] \
        * below
    return x.reshape(-1, nx)[:ny]


@pytest.mark.parametrize("ny,P", [(127, 4), (63, 4), (31, 4), (15, 2)],
                         ids=["seg32", "seg16", "seg8", "seg8-P2"])
@pytest.mark.parametrize("prob", [STRONG_Y, (1.0, 1.0, 1.0, 2.0, 0.4)],
                         ids=["table", "fields"])
def test_rank_spanning_line_model_matches_pcr(ny, P, prob):
    """The rank-spanning mode's algorithm on segments of gcd(R, 32) rows
    (32 at R = 32, 16 and 8 on smaller blocks), with the factors
    ``segment_factor`` makes for them, solves the whole columns' line
    systems as PCR does (f64)."""
    st = lk.collapse_stencil(stencil9_coefficients(AnisoProblem(*prob), ny,
                                                   ny, torch.float64, "cpu"))
    R = (ny + 1) // P
    fac = lk.segment_factor(st, ny, math.gcd(R, lk.LINE_SEG))
    rhs = torch.as_tensor(np.random.default_rng(3).standard_normal((ny, ny)))
    got = _rows_model(st, fac, rhs, P)
    want = line_jacobi_sweeps_y(st, rhs, torch.zeros_like(rhs), 1, 1.0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-10 * float(want.abs().max()))
