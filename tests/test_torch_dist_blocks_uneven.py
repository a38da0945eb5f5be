"""The 2-D blocks layout of the port (``-map 0/1``) on any rank count:
uneven blocks on 3, 5, 6 and 7 ranks, against the JAX package's blocks
plan on the CPU.

(a) The block rule in one process (``ShardingPlan.extents`` / ``block``,
    ``device_mesh.block_sides``) on 1x3, 2x3, 3x2, 1x5, 1x7 and 3x4
    meshes at 7^2 ... 1023^2 (square levels and levels 1023 wide), min
    local 8 and 32: the blocks tile ny + 1 and nx + 1 along a split axis
    (the whole extent along the other), every side and origin is even,
    the blocks of consecutive split levels are nested (the coarse blocks
    exactly half the fine ones), the smallest block holds at least
    min_local rounded down to even points (at least 2: the halo of a
    restriction), and the axes split are JAX's spec letter for letter on
    meshes of 3, 5, 6 and 7 of the 8 virtual devices.
(b) A 3-rank (1x3) and a 6-rank (2x3) gloo world (``_dist_worker.py``
    ``uneven_units``, started when the module's first test runs), the
    63^2 level split along x into 24 + 20 + 20 columns (and along y into
    32 + 32 rows on 2x3): ``block_exchange`` at depths 1-4 equals JAX's
    ``halo_pad_local`` (with corners) applied to the whole field on one
    device, cut around each block (rtol 0); ``gather_solution`` of the
    unequal blocks (with and without their pads) is the field, exactly;
    a 31^2 residual restricted block-locally and agglomerated from blocks
    of 12, 10 and 10 columns onto the replicated 15^2 level equals JAX's
    full weighting (1e-14); K17's 2-D visits' plain version on the uneven
    blocks (A u, b - A u, a zero-guess rc visit, a correcting ur visit;
    the NONUNIFORM2 5-point and the aniso (1,1,1,2,0.4) 9-point stencil)
    equal JAX's whole-grid visit in interpret mode (rtol 1e-12 / atol
    1e-12 of the largest entry, as on even blocks).
(c) Solves on those worlds (65^2, ``blocks_plan(min_local=8)``) against
    JAX's solves under ``ShardingPlan(make_device_mesh(jax.devices()[:n]),
    min_local=8)``, n = 3 and 6 (on a (3, 2) mesh for the y-lines): mg-CG,
    a V-cycle, Chebyshev, RBGS, y-line mg-CG on (3, 2) and x-line mg-CG on
    2x3 (aniso), the mixed outer (f32 levels, f64 outer), D1 on 2 grids
    (a merged level whose grids are both split unevenly, forced 6) and a
    checkpoint saved and resumed on 1x3.  Each is held to the bounds of
    its even-mesh twin: f64 iterations equal, rnorm rtol 1e-6 / atol 1e-9,
    u rtol 1e-6 / atol 1e-11 (test_torch_dist_blocks.py); RBGS, the lines
    and the mixed outer by test_torch_dist_blocks_smoothers.py's
    ``TOLS``; D1 by test_torch_dist_blocks_merged.py's (every grid rtol
    1e-6 / atol 1e-12); the checkpoint's resume to the warm start's
    tolerance.  Every rank's results are identical, the port splits each
    level along the axes JAX splits it (no level JAX splits is
    replicated), and the all-gathers inside a cycle are "agglomerate",
    "line" and "coarsest" only.
(d) K15's carry pass over unequal segment counts: the rank-spanning
    sweep on blocks of 3, 5 and 4 segments (and 22, 21, 21 segments of 2
    rows, and five blocks of 2, 1, 3, 1 and 1), its launch-1 outputs
    stacked as one piece as the wrapper stacks them (``line_kernel.
    pack_ends``: every block's ends, then every block's starts, the
    layout ``csrc/line.cuh``'s carry pass reads), the carries by the
    kernel's blocked scan: equal to the serial walk (1e-12 of the largest
    entry in f64, TOL_LINE in f32) and to the plain version
    (``line_rows_end_plain``: PCR over the gathered right-hand sides;
    1e-10 / TOL_LINE).

Each world gives each rank one BLAS thread (``_dist_worker.spawn``).
"""

from __future__ import annotations

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

import _dist_worker as dw
from multigrid_petsc_tpu.mesh import MeshType as JMesh
from multigrid_petsc_tpu.ops import transfer as jtr
from multigrid_petsc_tpu.ops.pallas import stencil9_kernel as jk9
from multigrid_petsc_tpu.ops.pallas import stencil_kernel as jk
from multigrid_petsc_tpu.parallel.device_mesh import ShardingPlan as JPlan
from multigrid_petsc_tpu.parallel.device_mesh import make_device_mesh
from multigrid_petsc_tpu.parallel.halo import halo_pad_local
from multigrid_petsc_tpu.problems import AnisoProblem as JAniso
from multigrid_petsc_tpu.problems import stencil9_coefficients as j_coeffs9
from multigrid_petsc_tpu.problems import stencil_coefficients as j_coeffs
from multigrid_petsc_tpu.solvers.solve import solve as j_solve
from multigrid_petsc_tpu_torch.ops.cuda import line_kernel as tlk
from multigrid_petsc_tpu_torch.ops.cuda.dist_kernel import Halo
from multigrid_petsc_tpu_torch.parallel.block_ops import ring, window
from multigrid_petsc_tpu_torch.parallel.device_mesh import (
    ShardingPlan,
    block_sides,
    mesh_shape,
)
from test_torch_dist_blocks import SIDES, _jax_axes
from test_torch_dist_blocks_smoothers import TOLS as SMOOTHER_TOLS
from test_torch_dist_cycles import F64_TOL, jax_config
from test_torch_dist_merged import F64_TOL as MERGED_TOL
from test_torch_line import (
    CONFIG4,
    TOL_LINE,
    XVAR,
    _carry_inputs,
    _carry_scan,
    _carry_serial,
    _carry_tol,
    _cut_rows,
    _line_stencil,
    _segment_ends,
    _segment_fix,
)

torch.set_num_threads(2)

N = 63
ANISO = (1.0, 1.0, 1.0, 2.0, 0.4)
STEPS = jk.jacobi_step_coeffs(3, 0.8)
SMALL = dict(npts=65, grids=4, levels=4, max_iter=60)
LINES = dict(SMALL, cycle=101, problem="aniso")
# name -> (SolverConfig fields, ranks, mesh) of (c); min_local 8.
SOLVES = {
    "MGCG3": (dict(SMALL, cycle=101), 3, None),
    "V3": (dict(SMALL, cycle=0), 3, None),
    "CHEB3": (dict(SMALL, cycle=0, smoother="chebyshev"), 3, None),
    "RBGS3": (dict(SMALL, cycle=0, smoother="rbgs"), 3, None),
    "MIXED3": (dict(SMALL, cycle=101, dtype="float32",
                    outer_dtype="float64", rtol=1e-8, max_iter=30), 3,
               None),
    "D1_3": (dict(npts=65, grids=2, levels=1, cycle=3, rtol=1e-30,
                  divtol=1e30, max_iter=6), 3, None),
    "MGCG6": (dict(SMALL, cycle=101), 6, None),
    "LINE_Y6": (dict(LINES, aniso=[1.0, 0.0, 100.0, 0.0, 0.0],
                     smoother="line_y"), 6, (3, 2)),
    "LINE_X6": (dict(LINES, aniso=[100.0, 0.0, 1.0, 0.0, 0.0],
                     smoother="line_x"), 6, (2, 3)),
}
# The bounds of each config's even-mesh twin (module docstring).
TWIN_TOLS = {"RBGS3": "RBGS", "MIXED3": "MIXED", "LINE_Y6": "LINE_Y",
             "LINE_X6": "LINE_X"}
CHECKPOINT = dict(SMALL, cycle=101)
UNIT_MESHES = {3: (1, 3), 6: (2, 3)}


def _job(fields, mesh=None, **extra):
    job = dict({"cfg": fields, "min_local": 8, "layout": "blocks"}, **extra)
    if mesh is not None:
        job["mesh"] = list(mesh)
    return job


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The module's gloo worlds (3 ranks on 1x3, 6 ranks on 2x3 and, for
    the y-lines, 3x2), started when the module's first test runs, so the
    ranks solve while the JAX side runs."""
    out = tmp_path_factory.mktemp("blocks_uneven")
    jobs = {n: {"uneven_units": {"mesh": list(m)}}
            for n, m in UNIT_MESHES.items()}
    for name, (f, ranks, mesh) in SOLVES.items():
        jobs[ranks][name] = _job(f, mesh)
    jobs[3]["CHECKPOINT3"] = _job(CHECKPOINT, checkpoint=True)
    for n in jobs:  # each world its own directory (the units' names)
        (out / str(n)).mkdir()
    procs = {n: dw.spawn(j, out / str(n), n) for n, j in jobs.items()}
    done = set()

    def results(world):
        if world not in done:
            dw.finish(procs[world])
            done.add(world)
        return out / str(world)

    yield results
    for ps in procs.values():
        for p in ps:
            if p.poll() is None:
                p.kill()


@pytest.fixture(scope="module", autouse=True)
def _start_worlds(worlds):
    return worlds


# ---------------------------------------------------------------------------
# (a) The block rule.
# ---------------------------------------------------------------------------

class _Plan:
    """The blocks plan's geometry without a process group."""

    layout = "blocks"
    spec = ShardingPlan.spec
    split = ShardingPlan.split
    extents = ShardingPlan.extents
    block = ShardingPlan.block

    def __init__(self, mesh, min_local, coords=(0, 0)):
        self.mesh, self.min_local, self.coords = mesh, min_local, coords


RULE_MESHES = [(1, 3), (2, 3), (3, 2), (1, 5), (1, 7), (3, 4)]


@pytest.mark.parametrize("min_local", [8, 32])
@pytest.mark.parametrize("mesh", RULE_MESHES,
                         ids=[f"{a}x{b}" for a, b in RULE_MESHES])
def test_blocks_tile_even_and_nested(mesh, min_local):
    plan = _Plan(mesh, min_local)
    for ny in SIDES:
        for nx in (ny, SIDES[-1]):
            ext = plan.extents(ny, nx)
            split = plan.split(ny, nx)
            for n, m, s, sides in zip((ny, nx), mesh, split, ext):
                assert len(sides) == m
                if not s:
                    assert sides == (n,) * m
                    continue
                assert sum(sides) == n + 1, (mesh, n, sides)
                origins = np.cumsum((0,) + sides[:-1])
                assert all(e % 2 == 0 for e in sides), sides
                assert all(o % 2 == 0 for o in origins), origins
                assert min(sides) >= max(2, 2 * (min_local // 2)), sides
                nc = (n - 1) // 2
                if nc // m >= min_local:  # the coarse size split too
                    assert block_sides(nc, m, min_local) == tuple(
                        e // 2 for e in sides), (n, sides)
            # Every rank's block from its coords: the extents' own.
            for iy in range(mesh[0]):
                for ix in range(mesh[1]):
                    plan.coords = (iy, ix)
                    blk = plan.block(ny, nx)
                    assert (blk.R, blk.C) == (ext[0][iy], ext[1][ix])
                    assert blk.row0 == (sum(ext[0][:iy]) if split[0] else 0)
                    assert blk.col0 == (sum(ext[1][:ix]) if split[1] else 0)
                    assert blk.split == split
            plan.coords = (0, 0)


def test_block_sides_of_the_main_path_on_three_ranks():
    """8193^2 on 1x3 with min_local 32: the coarsest level split along x
    is 127^2 (128 = 44 + 42 + 42), and level 0 takes 64 times those
    columns (multiples of 64: 32-row line segments on the large
    levels)."""
    assert block_sides(127, 3, 32) == (44, 42, 42)
    assert block_sides(8191, 3, 32) == (2816, 2688, 2688)
    assert math.gcd(*block_sides(8191, 3, 32)) % 64 == 0


@pytest.mark.parametrize("size", [3, 5, 6, 7])
def test_split_axes_are_jax_spec(size):
    """The axes the port splits each level along, and only those, are
    JAX's spec's letters on the mesh axes of two devices or more."""
    mesh = make_device_mesh(jax.devices()[:size])
    my, mx = mesh_shape(size)
    assert (my, mx) == mesh.devices.shape
    for min_local in (8, 32):
        jplan = JPlan(mesh, min_local=min_local)
        plan = _Plan((my, mx), min_local)
        for ny in SIDES:
            for nx in (ny, SIDES[-1]):
                s = tuple(jplan.spec(ny, nx))
                s = s + (None,) * (2 - len(s))
                want = (s[0] == "y" and my > 1, s[1] == "x" and mx > 1)
                assert plan.split(ny, nx) == want, (size, ny, nx)
                for n, m, split, sides in zip((ny, nx), (my, mx), want,
                                              plan.extents(ny, nx)):
                    assert sides == (block_sides(n, m, min_local) if split
                                     else (n,) * m)


# ---------------------------------------------------------------------------
# (b) The exchange, the gathers and K17's visits on uneven blocks.
# ---------------------------------------------------------------------------

def _jax_padded(field, h):
    """JAX's ``halo_pad_local`` (with corners) applied h times to the
    whole field on one device: the field inside h rings of zeros."""
    mesh = make_device_mesh(jax.devices()[:1], shape=(1, 1))

    def pad(u):
        for _ in range(h):
            u = halo_pad_local(u, corners=True)
        return u

    f = shard_map(pad, mesh=mesh, in_specs=P("y", "x"),
                  out_specs=P("y", "x"))
    return np.asarray(f(jnp.asarray(field)))


def _unit_inputs():
    """The inputs ``uneven_units`` makes (seed 11): field, u, b on 63^2,
    e and r on 31^2."""
    rng = np.random.default_rng(11)
    return ([rng.standard_normal((N, N)) for _ in range(3)]
            + [rng.standard_normal((31, 31)) for _ in range(2)])


def _units(worlds, ranks):
    out = worlds(ranks)
    return [dict(np.load(out / f"uneven_units.{r}.npz"))
            for r in range(ranks)]


@pytest.mark.parametrize("ranks", [3, 6])
def test_uneven_blocks_are_the_rule(worlds, ranks):
    """Each rank's extents: 63 columns + 1 pad as 24 + 20 + 20, 31 as
    12 + 10 + 10 (and 32 + 32 / 16 + 16 rows on 2x3); 15^2 whole."""
    runs = _units(worlds, ranks)
    my, mx = UNIT_MESHES[ranks]
    for r, d in enumerate(runs):
        assert tuple(d["coords"]) == divmod(r, mx)
        assert tuple(d["xs63"]) == (24, 20, 20)
        assert tuple(d["xs31"]) == (12, 10, 10)
        assert tuple(d["ys63"]) == ((32, 32) if my == 2 else (63,))
        assert tuple(d["ys15"]) == (15,) * my
        assert tuple(d["xs15"]) == (15,) * mx


@pytest.mark.parametrize("h", [1, 2, 3, 4])
@pytest.mark.parametrize("ranks", [3, 6])
def test_uneven_exchange_matches_jax_halo(worlds, ranks, h):
    """``block_exchange`` of unequal blocks: every part of the ring (the
    corners from blocks of other widths included) is JAX's padded whole
    field cut around the block; the second block of the message is the
    negated field's."""
    field = _unit_inputs()[0]
    padded = torch.from_numpy(_jax_padded(field, h).copy())
    for d in _units(worlds, ranks):
        iy, ix = (int(v) for v in d["coords"])
        ys, xs = tuple(d["ys63"]), tuple(d["xs63"])
        R, C = ys[iy], xs[ix]
        r0 = sum(ys[:iy]) if sum(ys) == N + 1 else 0  # y split on 2x3
        c0 = sum(xs[:ix])
        want = ring(window(padded, r0, r0 + R + 2 * h, c0, c0 + C + 2 * h),
                    h)
        for k, w in want._asdict().items():
            np.testing.assert_array_equal(d[f"ring{h}_{k}"], w.numpy())
            np.testing.assert_array_equal(d[f"neg_ring{h}_{k}"], -w.numpy())


@pytest.mark.parametrize("ranks", [3, 6])
def test_uneven_gathers(worlds, ranks):
    """The solution gather of unequal blocks (pads kept or cut) is the
    field; the agglomeration of unequal coarse blocks onto the whole
    15^2 level is JAX's full weighting of the whole 31^2 residual, one
    gather."""
    field, _, _, _, r31 = _unit_inputs()
    want = np.asarray(jtr.restrict_fw(jnp.asarray(r31)))
    for d in _units(worlds, ranks):
        np.testing.assert_array_equal(d["gathered"], field)
        np.testing.assert_array_equal(d["gathered_real"], field)
        np.testing.assert_allclose(d["agglomerated"], want, rtol=0,
                                   atol=1e-14 * np.abs(want).max())
        assert json.loads(str(d["agglomerate_gathers"])) == {
            "agglomerate": 1}


@pytest.fixture(scope="module")
def jax_visits():
    """JAX's whole-grid visits of (b) (interpret mode): (stencil, emit)
    -> numpy output."""
    _, u, b, e, _ = (jnp.asarray(x) for x in _unit_inputs())
    out = {}
    for name, jst, nine in (
            ("5pt", j_coeffs(JMesh.NONUNIFORM2, N, N, jnp.float64), False),
            ("9pt", j_coeffs9(JAniso(*ANISO), N, N, jnp.float64), True)):
        apply = jk9.apply_stencil9_pallas if nine else None
        if nine:
            out[name, "a"] = apply(jst, u, interpret=True)
            out[name, "r"] = apply(jst, u, b, interpret=True)
        else:
            out[name, "a"] = jk.apply_stencil5_pallas(jst, u, interpret=True)
            out[name, "r"] = jk.residual5_pallas(jst, b, u, interpret=True)
        visit = (jk9.fused_level_visit9_pallas if nine
                 else jk.fused_level_visit_pallas)
        out[name, "rc0_u"], out[name, "rc0_rc"] = visit(
            jst, b, None, STEPS, emit="rc", interpret=True)
        out[name, "ur_u"], out[name, "ur_r"] = visit(
            jst, b, u, STEPS, emit="ur", e_coarse=e, interpret=True)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("emit", ["a", "r", "rc0_u", "rc0_rc", "ur_u",
                                  "ur_r"])
@pytest.mark.parametrize("nine", ["5pt", "9pt"])
@pytest.mark.parametrize("ranks", [3, 6])
def test_uneven_k17_visits_match_jax(worlds, jax_visits, ranks, nine, emit):
    want = jax_visits[nine, emit]
    for d in _units(worlds, ranks):
        got = d[f"{nine}_{emit}"]
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-12,
                                   atol=1e-12 * max(1.0, np.abs(want).max()))


# ---------------------------------------------------------------------------
# (c) The solves.
# ---------------------------------------------------------------------------

def _j_plan(ranks, mesh=None):
    return JPlan(make_device_mesh(jax.devices()[:ranks], shape=mesh),
                 min_local=8)


@pytest.fixture(scope="module")
def jax_refs():
    """JAX's blocks-plan solves of SOLVES and of the checkpoint's config
    on 3 and 6 devices: name -> result."""
    refs = {n: j_solve(jax_config(f), plan=_j_plan(r, m))
            for n, (f, r, m) in SOLVES.items()}
    refs["CHECKPOINT3"] = j_solve(jax_config(CHECKPOINT), plan=_j_plan(3))
    return refs


def _check_ranks(runs):
    r0 = runs[0]
    for r in runs[1:]:
        assert int(r["iters"]) == int(r0["iters"])
        np.testing.assert_array_equal(r["rnorm"], r0["rnorm"])
        np.testing.assert_array_equal(r["u"], r0["u"])
    assert str(r0["path"]) == "torch"
    gathers = json.loads(str(r0["gathers"]))
    assert set(gathers) <= {"agglomerate", "line", "coarsest"}, gathers
    return r0, gathers


@pytest.mark.parametrize("name", list(SOLVES))
def test_uneven_solve_matches_jax(worlds, jax_refs, name):
    fields, ranks, _ = SOLVES[name]
    ref = jax_refs[name]
    r0, gathers = _check_ranks(dw.load(worlds(ranks), name, ranks))
    axes = json.loads(str(r0["axes"]))
    assert axes == _jax_axes(ref), (axes, _jax_axes(ref))
    assert axes[0] != [False, False], "level 0 not split"
    assert bool(r0["converged"]) == bool(ref.converged)
    if name == "D1_3":
        grid_axes = json.loads(str(r0["grid_axes"]))
        assert grid_axes[0] == [[False, True]] * 2, grid_axes
        assert int(r0["iters"]) == int(ref.iters) == fields["max_iter"]
        np.testing.assert_allclose(r0["rnorm"], ref.rnorm,
                                   **MERGED_TOL["hist"])
        for k, want in enumerate(ref.u):
            np.testing.assert_allclose(r0[f"grid{k}"], np.asarray(want),
                                       **MERGED_TOL["u"])
        return
    hist_tol, u_tol, slack = SMOOTHER_TOLS.get(TWIN_TOLS.get(name),
                                               F64_TOL)
    assert abs(int(r0["iters"]) - int(ref.iters)) <= slack
    if hist_tol is not None:
        np.testing.assert_allclose(r0["rnorm"], ref.rnorm, **hist_tol)
    u_ref = np.asarray(ref.u_fine, np.float64)
    if u_tol is None:
        np.testing.assert_allclose(r0["u"], u_ref, rtol=1e-6, atol=1e-11)
    else:
        np.testing.assert_allclose(r0["u"], u_ref, rtol=0.0,
                                   atol=u_tol * np.abs(u_ref).max())
    lines = name.startswith("LINE")
    assert (gathers.get("line", 0) > 0) == lines, gathers
    if not all(all(a) for a in axes):
        assert gathers.get("agglomerate", 0) > 0, gathers


def test_uneven_checkpoint_round_trip(worlds, jax_refs):
    """3 iterations saved under the 1x3 plan, loaded as each rank's
    uneven block (24, 20 or 20 columns and the pad column) and resumed:
    the file holds the partial solve's whole grid, each block is its
    points of it, and the resumed solve reaches JAX's uninterrupted
    solution (the warm start's tolerance)."""
    runs = dw.load(worlds(3), "CHECKPOINT3", 3)
    r0 = runs[0]
    np.testing.assert_array_equal(r0["saved"], r0["part_u"])
    assert int(r0["part_iters"]) == 3
    n = r0["saved"].shape[0]
    padded = np.zeros((n, n + 1))
    padded[:, :n] = r0["saved"]
    c0 = 0
    for rank, r in enumerate(runs):
        C = (24, 20, 20)[rank]
        np.testing.assert_array_equal(r["block"], padded[:, c0:c0 + C])
        np.testing.assert_array_equal(r["u"], r0["u"])
        c0 += C
    assert bool(r0["converged"])
    np.testing.assert_allclose(r0["u"], jax_refs["CHECKPOINT3"].u_fine,
                               rtol=1e-5, atol=1e-11)


# ---------------------------------------------------------------------------
# (d) K15's carry pass over unequal segment counts.
# ---------------------------------------------------------------------------

def _uneven_sweep(st, b, u, blocks, omega, carry):
    """One rank-spanning y-line sweep of (b, u) (ny, nx), its pad row
    appended, cut into row blocks of ``blocks`` rows as the kernel runs
    it: each block's line right-hand sides and its segments' zero-carry
    ends from its rows' slices of the factors (launch 1), the blocks'
    outputs (ends, then starts) stacked as one piece (the all-gather of
    unequal pieces, ``line_kernel.pack_ends``) and read as the carry pass
    reads it (segment s's end on row s, its start on row S + s), the
    carries of every segment by ``carry`` with the whole level's factors,
    each block's slice of them (launch 2), each block's segments fixed up
    and blended (launch 3).  Returns the stitched (ny + 1, nx) sweep, the
    blocks' plain ``RowLine``s, the stacked right-hand sides and the true
    (ends, starts) beside those read back."""
    ny, nx = b.shape
    seg = math.gcd(tlk.LINE_SEG, *blocks)
    fac = tlk.segment_factor(st, ny, seg)
    bp, up = (torch.cat([x, x.new_zeros(1, nx)]) for x in (b, u))
    zero = u.new_zeros(1, nx)
    origins = np.cumsum((0,) + tuple(blocks[:-1]))
    counts = [R // seg for R in blocks]
    offsets = np.cumsum([0] + counts)
    lfs, rhss, cut, pieces, ends, starts = [], [], [], [], [], []
    for R, r0, n in zip(blocks, origins, counts):
        lf = tlk.row_line(st, ny, R, int(r0), blocks=blocks)
        halo = Halo(up[r0 - 1:r0] if r0 else zero,
                    up[r0 + R:r0 + R + 1] if r0 + R <= ny else zero)
        rhs = tlk.line_rows_begin_plain(lf, bp[r0:r0 + R], up[r0:r0 + R],
                                        halo)
        rows = slice(r0, r0 + lf.nyl)
        c = [_cut_rows(torch.broadcast_to(t, (ny, nx))[rows], lf.nyl, n, seg,
                       nx)
             for t in (st.cs, fac.m, fac.cp, fac.above, fac.below,
                       fac.end_w, fac.start_w)]
        e, s = _segment_ends(rhs.reshape(n, seg, nx), *c[5:])
        pieces.append(torch.cat([e, s]))
        ends.append(e)
        starts.append(s)
        lfs.append(lf)
        rhss.append(rhs)
        cut.append(c)
    S = int(offsets[-1])
    packed = tlk.pack_ends(pieces, counts)
    read = (packed[:S], packed[S:])
    cin, din = carry(*read, *_carry_inputs(fac, seg, S, nx), b.dtype)
    outs = []
    for q, (lf, rhs, c) in enumerate(zip(lfs, rhss, cut)):
        own = slice(offsets[q], offsets[q + 1])
        R = blocks[q]
        x = _segment_fix(rhs.reshape(counts[q], seg, nx), *c[:5], cin[own],
                         din[own]).reshape(R, nx)
        out = torch.zeros_like(x)
        nyl, r0 = lf.nyl, origins[q]
        out[:nyl] = (1.0 - omega) * up[r0:r0 + nyl] + omega * x[:nyl]
        outs.append(out)
    return (torch.cat(outs), lfs, torch.cat(rhss),
            (torch.cat(ends), torch.cat(starts)), read)


# Blocks of 3, 5 and 4 segments of 32 rows; 22, 21 and 21 of 2 rows (the
# 127^2 level on 1x3); five blocks of 2, 1, 3, 1 and 1 segments of 32.
UNEVEN_BLOCKS = [(96, 160, 128), (44, 42, 42), (64, 32, 96, 32, 32)]


@pytest.mark.parametrize("blocks", UNEVEN_BLOCKS,
                         ids=["3-5-4", "22-21-21", "2-1-3-1-1"])
@pytest.mark.parametrize("dtype", [pytest.param(torch.float64, id="f64"),
                                   pytest.param(torch.float32, id="f32")])
@pytest.mark.parametrize("prob", [CONFIG4, XVAR], ids=["config4", "xvar"])
def test_carry_over_unequal_segment_counts(prob, dtype, blocks):
    nx = 17
    ny = sum(blocks) - 1
    st = _line_stencil(prob, ny, nx, dtype)
    rng = np.random.default_rng(ny + len(blocks))
    b, u = (torch.as_tensor(rng.standard_normal((ny, nx))).to(dtype)
            for _ in range(2))
    got, lfs, every, true, read = _uneven_sweep(st, b, u, blocks, 0.8,
                                                _carry_scan)
    # The reader finds every segment's own end and start.
    for t, r in zip(true, read):
        assert torch.equal(t, r)
    serial = _uneven_sweep(st, b, u, blocks, 0.8, _carry_serial)[0]
    assert bool((got[ny:] == 0).all())
    np.testing.assert_allclose(got.double().numpy(), serial.double().numpy(),
                               rtol=0, atol=_carry_tol(dtype)
                               * float(serial.abs().max()))
    up = torch.cat([u, u.new_zeros(1, nx)])
    plain = torch.cat([tlk.line_rows_end_plain(lf, up[lf.row0:lf.row0 + lf.R],
                                               every, 0.8) for lf in lfs])
    assert tlk.gathered_rows(lfs[0]) == tuple(blocks)
    tol = 1e-10 if dtype == torch.float64 else TOL_LINE
    np.testing.assert_allclose(got.double().numpy(), plain.double().numpy(),
                               rtol=0, atol=tol * float(plain.abs().max()))
