"""The 2-D blocks layout of the port (``-map 0/1``), part 2: the precision
outers, the checkpoint, RBGS and the line smoothers under
``parallel.blocks_plan``, against the JAX package's blocks plan on the
CPU.

(a) A 4-rank (2x2) gloo world (``_dist_worker.py``, one world for the
    module, started when its first test runs) solves under
    ``blocks_plan(min_local=8)``: at 129^2 the mixed outer (f32
    V-cycle, f64 outer) to 1e-8 and mg-CG with a bf16 preconditioner; at
    65^2 an RBGS V-cycle, mg-CG with an f64 preconditioner, y-line mg-CG
    on aniso (1,0,100,0,0), x-line mg-CG and an alternating-line V-cycle
    on aniso (100,0,1,0,0);
    a 2-rank (1x2) world the y-line mg-CG at 65^2, its levels split along
    x alone (each block holds its y-lines whole).  Each is held to JAX's solve under ``ShardingPlan(
    make_device_mesh(jax.devices()[:n]), min_local=8)`` with
    test_torch_dist_cycles.py's tolerances (``TOLS``): the f64 runs'
    iterations equal, rnorm rtol 1e-6 / atol 1e-9 and u rtol 1e-6 / atol
    1e-11 (the blocks tests' bound); the runs over f32 levels their
    iterations equal, the normalized history to 1e-6 entry by entry, the
    solution to 1e-6 (the f64 outer) or 1e-4 (an f32 solution) of max|u|;
    the bf16-preconditioned run within one iteration and its solution to
    1e-3 of max|u|.  The same levels are split along the same axes as
    JAX's spec, every rank's results are identical, and the all-gathers
    inside a cycle are "agglomerate", "line" (the lines' carries) and
    "coarsest" only.
(b) A checkpoint of a partial solve, saved under the blocks plan (rank 0
    writes the gathered grid) and loaded as each rank's 2-D block, resumes
    to the uninterrupted solve.
(c) ``-map 0 -smoother line_y`` under the 4-rank world prints the
    one-process summary.
(d) In one process: K15's 2-D block mode's plain version
    (``line_rows_begin_plain`` / ``line_rows_end_plain`` on each block and
    its ring, the first halves stacked over the ranks a line spans) on the
    63^2 aniso (1,1,1,2,0.4) level, padded, cut into 2x2 and 2x4 blocks
    (split along y and x), 2x1 (y alone) and 1x2 (x alone), two y- and
    two x-line sweeps, stitched and held to JAX's ``line_jacobi_sweeps_y``
    / ``_x`` at rtol 1e-12 / atol 1e-12 of the largest entry, the pad row
    and column exactly 0; RBGS's colours on 2-D blocks of odd origin
    follow the global parity; K17's 2-D block mode's plain version on
    bf16 storage against JAX's bf16 dist visit (interpret mode), as
    test_torch_dist_smoothers.py holds the row blocks.
"""

from __future__ import annotations

import json
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _dist_worker as dw
from multigrid_petsc_tpu import problems as jp
from multigrid_petsc_tpu.mesh import MeshType as JMesh
from multigrid_petsc_tpu.ops import stencil as jst_ops
from multigrid_petsc_tpu.parallel.device_mesh import ShardingPlan as JPlan
from multigrid_petsc_tpu.parallel.device_mesh import make_device_mesh
from multigrid_petsc_tpu.solvers.solve import solve as j_solve
from multigrid_petsc_tpu_torch import poisson
from multigrid_petsc_tpu_torch.mesh import MeshType
from multigrid_petsc_tpu_torch.ops.cuda import dist_kernel as dk
from multigrid_petsc_tpu_torch.ops.cuda import line_kernel as lk
from multigrid_petsc_tpu_torch.ops.stencil import (
    from_numpy_stencil,
    redblack_dinv,
    transpose_stencil9,
)
from multigrid_petsc_tpu_torch.parallel import BlockLevelOps
from multigrid_petsc_tpu_torch.parallel.block_ops import cut_halo
from multigrid_petsc_tpu_torch.parallel.device_mesh import Block
from multigrid_petsc_tpu_torch.problems import (
    AnisoProblem,
    stencil9_coefficients,
    stencil_coefficients,
)
from multigrid_petsc_tpu_torch.solvers.smoothers import jacobi_step_coeffs
from test_torch_dist import EMITS
from test_torch_dist_blocks import _jax_axes
from test_torch_dist_cycles import F64_TOL, TOLS, jax_config
from test_torch_dist_smoothers import _bf16_visit
from test_torch_precision import _bf_stencil, _bf_t, _within_ulps

torch.set_num_threads(2)

BASE = dict(npts=129, grids=4, levels=4, max_iter=40)
# 65^2 (63 and 31 split) where 129^2 is not needed: JAX's GSPMD solves on
# 4 CPU devices take 5-35 s each at 129^2 (its line sweeps the most).
SMALL = dict(BASE, npts=65)
LINES = dict(SMALL, problem="aniso")
STRONG_Y = [1.0, 0.0, 100.0, 0.0, 0.0]
STRONG_X = [100.0, 0.0, 1.0, 0.0, 0.0]
# name -> (SolverConfig fields, ranks) of (a); every one under min_local 8.
CONFIGS = {
    "RBGS": (dict(SMALL, cycle=0, smoother="rbgs"), 4),
    "LINE_Y": (dict(LINES, cycle=101, aniso=STRONG_Y, smoother="line_y"), 4),
    "LINE_X": (dict(LINES, cycle=101, aniso=STRONG_X, smoother="line_x"), 4),
    "LINE_XY": (dict(LINES, grids=3, levels=3, cycle=0, aniso=STRONG_X,
                     smoother="line_xy"), 4),
    # 5 levels, as test_torch_dist_cycles.py's MIXED.
    "MIXED": (dict(npts=129, grids=5, levels=5, cycle=101, dtype="float32",
                   outer_dtype="float64", rtol=1e-8, max_iter=30), 4),
    "PRECOND_F64": (dict(SMALL, cycle=101, dtype="float32",
                          precond_dtype="float64", rtol=1e-5, max_iter=30),
                    4),
    "PRECOND_BF16": (dict(BASE, cycle=101, dtype="float32",
                          precond_dtype="bfloat16", rtol=1e-5, max_iter=30),
                     4),
    # The 1x2 mesh: the levels split along x alone, each block holding its
    # y-lines whole (no "line" gather).
    "PAIR_LINE_Y": (dict(LINES, cycle=101, aniso=STRONG_Y,
                         smoother="line_y"), 2),
}
CHECKPOINT = dict(SMALL, cycle=101, max_iter=60)
CLI_ARGS = ["-npts", "129", "-grids", "4", "-levels", "4", "-cycle", "101",
            "-problem", "aniso", "-aniso", "1,0,100,0,0", "-smoother",
            "line_y", "-device", "cpu"]


def _job(fields, **extra):
    return dict({"cfg": fields, "min_local": 8, "layout": "blocks"},
                **extra)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The module's gloo worlds (4 ranks: the solves, the checkpoint, the
    CLI; 2 ranks), started when the module's first test runs, so the
    ranks solve while the JAX side runs."""
    out = tmp_path_factory.mktemp("blocks_smoothers")
    jobs = {2: {}, 4: {}}
    for name, (f, ranks) in CONFIGS.items():
        jobs[ranks][name] = _job(f)
    jobs[4]["CHECKPOINT"] = _job(CHECKPOINT, checkpoint=True)
    jobs[4]["cli"] = {"argv": CLI_ARGS + ["-map", "0"]}
    procs = {n: dw.spawn(j, out, n) for n, j in jobs.items()}
    done = set()

    def results(world):
        if world not in done:
            dw.finish(procs[world])
            done.add(world)
        return out

    yield results
    for ps in procs.values():
        for p in ps:
            if p.poll() is None:
                p.kill()


@pytest.fixture(scope="module", autouse=True)
def _start_worlds(worlds):
    return worlds


@pytest.fixture(scope="module")
def jax_refs():
    """JAX's blocks-plan solves of CONFIGS and CHECKPOINT: name ->
    result."""
    def run(fields, devices):
        plan = JPlan(make_device_mesh(jax.devices()[:devices]), min_local=8)
        return j_solve(jax_config(fields), plan=plan)

    refs = {n: run(f, r) for n, (f, r) in CONFIGS.items()}
    refs["CHECKPOINT"] = run(CHECKPOINT, 4)
    return refs


# ---------------------------------------------------------------------------
# (d) In one process (first: the worlds solve meanwhile).
# ---------------------------------------------------------------------------

N = 63
OMEGA = 0.8
ANISO = (1.0, 1.0, 1.0, 2.0, 0.4)
# (my, mx) cuts of the padded 63^2 level: both axes split, y alone, x
# alone.
LINE_MESHES = {"2x2": (2, 2), "2x4": (2, 4), "y": (2, 1), "x": (1, 2)}


def _line_sweeps_on_blocks(st, b, u, my, mx, axis, sweeps):
    """``sweeps`` sweeps of K15's 2-D block mode's plain version on the my
    x mx blocks of (b, u) (an axis of one rank not split: its whole
    extent), each block's ring cut from the stitched iterate, as
    ``BlockLevelOps._line_sweeps`` runs them: y-lines (``axis`` 0) or
    x-lines on the transposed block and ring; the stitched result, its
    pad row and column included."""
    ny, nx = b.shape
    R = (ny + 1) // my if my > 1 else ny
    C = (nx + 1) // mx if mx > 1 else nx
    origins = [(iy * R, ix * C) for iy in range(my) for ix in range(mx)]
    cur = u
    for _ in range(sweeps):
        calls, mine = [], []
        for r0, c0 in origins:
            bb, _ = cut_halo(b, r0, c0, R, C, 1)
            ub, ring = cut_halo(cur, r0, c0, R, C, 1)
            if axis:
                lf = lk.row_line(st, nx, C, c0, r0, min(R, ny - r0))
                bb, ub, ring = (bb.T.contiguous(), ub.T.contiguous(),
                                lk.transpose_ring(ring))
            else:
                lf = lk.row_line(st, ny, R, r0, c0, min(C, nx - c0))
            calls.append((lf, ub))
            mine.append(lk.line_rows_begin_plain(lf, bb, ub, ring))
        rows = []
        for iy in range(my):
            row = []
            for ix in range(mx):
                p = iy * mx + ix
                group = mine[ix::mx] if axis == 0 else mine[iy * mx:
                                                            (iy + 1) * mx]
                lf, ub = calls[p]
                out = lk.line_rows_end_plain(lf, ub, torch.cat(group),
                                             OMEGA)
                row.append(out.T if axis else out)
            rows.append(torch.cat(row, 1))
        whole = torch.cat(rows)
        cur = whole[:ny, :nx]
    return whole


@pytest.mark.parametrize("axis", [0, 1], ids=["y-lines", "x-lines"])
@pytest.mark.parametrize("cut", list(LINE_MESHES))
def test_line_block_mode_plain_matches_jax(cut, axis):
    """Two damped line sweeps of K15's 2-D block mode's plain version on
    the blocks of the 63^2 aniso (1,1,1,2,0.4) level (coefficients that
    vary with x: the line factors are fields, cut to each block's
    columns): JAX's ``line_jacobi_sweeps_y`` / ``_x`` on the whole grid,
    rtol 1e-12 / atol 1e-12 of the largest entry; the pad row and column
    exactly 0."""
    my, mx = LINE_MESHES[cut]
    rng = np.random.default_rng(5 + axis + 3 * my + mx)
    b, u = rng.standard_normal((N, N)), rng.standard_normal((N, N))
    jst = jp.stencil9_coefficients(jp.AnisoProblem(*ANISO), N, N,
                                   jnp.float64)
    fn = jst_ops.line_jacobi_sweeps_x if axis else \
        jst_ops.line_jacobi_sweeps_y
    want = np.asarray(fn(jst, jnp.asarray(b), jnp.asarray(u), 2, OMEGA))
    st9 = stencil9_coefficients(AnisoProblem(*ANISO), N, N, torch.float64,
                                "cpu")
    st = lk.collapse_stencil(transpose_stencil9(st9) if axis else st9)
    got = _line_sweeps_on_blocks(st, torch.as_tensor(b), torch.as_tensor(u),
                                 my, mx, axis, 2).numpy()
    assert got.shape == (N + (my > 1), N + (mx > 1))
    assert np.all(got[N:] == 0.0) and np.all(got[:, N:] == 0.0)
    np.testing.assert_allclose(got[:N, :N], want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())


def _stub_plan(blk: Block):
    """A plan whose every level's block is ``blk`` (the block rules need no
    process group here)."""
    return types.SimpleNamespace(block=lambda ny, nx: blk)


@pytest.mark.parametrize("blk", [Block(5, 7, 5, 3, (True, True)),
                                 Block(6, 5, 15, 16, (True, True))],
                         ids=["odd-origin", "odd-row0-pads"])
def test_rbgs_colours_follow_the_global_parity_on_blocks(blk):
    """Each 2-D block's (red, black) omega / cc are the whole grid's
    points of them (``redblack_dinv``: red where i + j is even), whatever
    the parity of the block's origin; its pad row and column (past the
    19^2 level's edge) 0."""
    ny = nx = 19
    st = stencil_coefficients(MeshType(1), ny, nx, torch.float64, "cpu")
    whole = redblack_dinv(st, (ny, nx), 1.2)
    d = BlockLevelOps(st, ny, nx, _stub_plan(blk), 3)
    d.setup_rbgs(1.2)
    for got, w in zip(d.rb_dinv, whole):
        np.testing.assert_array_equal(got.numpy(), d.block_of(w).numpy())


def _port_bf16_blocks(tst, emit, u, b, e, my=2, mx=2):
    """K17's 2-D block mode's plain version on bf16 storage on the my x mx
    blocks of the inputs padded by a pad row and column, each block's
    ring cut from its neighbours; the stitched outputs."""
    steps = () if emit in ("a", "r") else jacobi_step_coeffs(3, 0.8)
    kind = {"rc0": "rc", "correct_u": "u", "correct_ur": "ur"}.get(emit,
                                                                  emit)
    h = dk.halo_rows(len(steps), kind)
    hc = dk.coarse_halo_rows(h)
    R, C = (N + 1) // my, (N + 1) // mx
    rows = []
    for iy in range(my):
        row = []
        for ix in range(mx):
            r0, c0 = iy * R, ix * C

            def cut(x, hh, d=1):
                if x is None:
                    return None, None
                return cut_halo(x, r0 // d, c0 // d, R // d, C // d, hh)

            ub, uh = cut(u, h)
            bb, bh = cut(b, h)
            eb, eh = cut(e, hc, 2)
            o = dk.block_visit_plain(
                tst, None if emit == "a" else bb,
                None if emit == "rc0" else ub, steps, kind, row0=r0,
                col0=c0, ny=N, nx=N, b_halo=bh, u_halo=uh, e=eb, e_halo=eh)
            row.append(o if isinstance(o, tuple) else (o,))
        rows.append(row)
    return [torch.cat([torch.cat([blk[i] for blk in row], 1)
                       for row in rows]) for i in range(len(rows[0][0]))]


@pytest.mark.parametrize("emit", EMITS)
def test_k17_blocks_bf16_plain_matches_jax(emit):
    """K17's 2-D block mode on bf16 storage (2x2 blocks): upcast, f32
    arithmetic, one rounding per output, as JAX's bf16 dist visit
    (interpret mode; the same inputs as test_torch_dist_smoothers.py's
    row blocks).  As there: the outputs a JAX transfer rounds once more
    outside its kernel (a correction's prolongation, the restriction) to
    2 bf16 ulps of the largest entry, the rest to 1 ulp of each entry;
    the pad row and column exactly 0."""
    _, want = _bf16_visit(emit, seed=11)
    rng = np.random.default_rng(11)
    pad = lambda x: np.pad(x, ((0, 1), (0, 1)))  # noqa: E731
    u = pad(rng.standard_normal((N, N)))
    b = pad(rng.standard_normal((N, N)))
    e = (pad(rng.standard_normal(((N - 1) // 2,) * 2))
         if emit.startswith("correct") else None)
    jst = jp.stencil_coefficients(JMesh.NONUNIFORM2, N, N, jnp.bfloat16)
    tst = _bf_stencil(jst, from_numpy_stencil)
    t = {k: None if x is None else _bf_t(x) for k, x in
         (("u", u), ("b", b), ("e", e))}
    got = _port_bf16_blocks(tst, emit, t["u"], t["b"], t["e"])
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.bfloat16
        n = np.asarray(w).shape[1]
        assert bool((g[-1] == 0).all()) and bool((g[:, n:] == 0).all())
        bound = 2 if (emit.startswith("correct") or i == 1
                      and emit in ("rc", "rc0")) else "entry"
        _within_ulps(g[:, :n].contiguous(), w, bound)


# ---------------------------------------------------------------------------
# (a) - (c) The solves, the checkpoint, the CLI.
# ---------------------------------------------------------------------------

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


@pytest.mark.parametrize("name", list(CONFIGS))
def test_blocks_solve_matches_jax(worlds, jax_refs, name):
    fields, ranks = CONFIGS[name]
    ref = jax_refs[name]
    r0, gathers = _check_ranks(dw.load(worlds(ranks), name, ranks))
    axes = json.loads(str(r0["axes"]))
    assert axes == _jax_axes(ref), (axes, _jax_axes(ref))
    assert any(any(a) for a in axes), "no level ran split"
    # A line's carries cross the ranks where the level is split along it:
    # on the 1x2 mesh the y-lines lie in the blocks.
    lines = fields.get("smoother", "").startswith("line") and ranks == 4
    assert (gathers.get("line", 0) > 0) == lines, gathers
    if ranks == 2:
        assert [a[0] for a in axes] == [False] * len(axes)
    assert bool(r0["converged"]) == bool(ref.converged)
    hist_tol, u_tol, slack = TOLS.get(name, F64_TOL)
    assert abs(int(r0["iters"]) - int(ref.iters)) <= slack
    if hist_tol is not None:
        np.testing.assert_allclose(r0["rnorm"], ref.rnorm, **hist_tol)
    u_ref = np.asarray(ref.u_fine, np.float64)
    if u_tol is None:
        np.testing.assert_allclose(r0["u"], u_ref, rtol=1e-6, atol=1e-11)
    else:
        np.testing.assert_allclose(r0["u"], u_ref, rtol=0.0,
                                   atol=u_tol * np.abs(u_ref).max())


def test_mixed_outer_certifies_under_blocks(worlds, jax_refs):
    """The mixed outer's last history entry is its f64 residual: below
    1e-8, as JAX's."""
    r0, _ = _check_ranks(dw.load(worlds(4), "MIXED", 4))
    assert bool(r0["converged"]) and float(r0["rnorm"][-1]) <= 1e-8
    assert float(jax_refs["MIXED"].rnorm[-1]) <= 1e-8


def test_checkpoint_round_trip_under_blocks(worlds, jax_refs):
    """3 iterations, saved under the blocks plan (rank 0 writes the
    gathered grid), loaded as each rank's 2-D block and resumed: the file
    holds the partial solve's whole grid, each rank's block is its points
    of it (the pad row and column 0), and the resumed solve converges to
    JAX's uninterrupted solution (to the warm start's tolerance, as the
    row plan's checkpoint test holds it)."""
    runs = dw.load(worlds(4), "CHECKPOINT", 4)
    r0 = runs[0]
    np.testing.assert_array_equal(r0["saved"], r0["part_u"])
    assert int(r0["part_iters"]) == 3
    n = r0["saved"].shape[0]
    R = (n + 1) // 2
    padded = np.zeros((n + 1, n + 1))
    padded[:n, :n] = r0["saved"]
    for rank, r in enumerate(runs):
        iy, ix = divmod(rank, 2)
        np.testing.assert_array_equal(
            r["block"], padded[iy * R:(iy + 1) * R, ix * R:(ix + 1) * R])
        np.testing.assert_array_equal(r["u"], r0["u"])
    assert bool(r0["converged"])
    np.testing.assert_allclose(r0["u"], jax_refs["CHECKPOINT"].u_fine,
                               rtol=1e-5, atol=1e-11)


def test_cli_map_0_line_y_prints_the_one_process_summary(worlds, tmp_path,
                                                         monkeypatch,
                                                         capsys):
    out = worlds(4)
    monkeypatch.chdir(tmp_path)
    assert poisson.main(list(CLI_ARGS)) == 0
    one = capsys.readouterr().out.splitlines()

    def summary(lines):
        keep = ("iterations:", "relative residual:", "error (max")
        return [ln for ln in lines if ln.startswith(keep)]

    text = (out / "cli.0.txt").read_text()
    assert summary(text.splitlines()) == summary(one), text
    assert re.search(r"^distributed: ranks=4 mesh=2x2 transport=gloo "
                     r"sharded levels=127$", text, re.M), text
    for r in range(1, 4):  # rank 0 prints
        assert (out / f"cli.{r}.txt").read_text() == ""
