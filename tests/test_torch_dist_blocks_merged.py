"""The 2-D blocks layout of the port (``-map 0/1``), part 3: merged levels
and the merged-grid cycles (I, E, D1, D2, D1PS) under
``parallel.blocks_plan``, each grid of a merged level on its own 2-D
block (``parallel.DistMergedOps`` over ``BlockLevelOps``), against the
JAX package's blocks plan on the CPU.

Two gloo worlds (``_dist_worker.py``, started once for the module, when
its first test runs): 4 ranks on a 2x2 mesh and 8 ranks on a 2x4 mesh.
At 65^2 with ``min_local=4`` the 2x2 mesh splits 63^2, 31^2 and 15^2
along both axes and keeps 7^2 whole; the 2x4 mesh splits 15^2 along y
alone (its blocks 8 x 15, held alike by the 4 ranks of a mesh row), so a
merged level there holds grids split along both axes, along y alone and
not at all.

(a) A merged level's operators on the blocks (grids 0-3 at 65^2, both
    meshes): A u, A1 u, A2 u, b - A u, one block Gauss-Seidel sweep (3
    inner steps), three restrictions from grid 0 to grid 3 and three
    prolongations back, <u, b> and each grid's norm, held to JAX's
    whole-grid ``ops/composite.py`` functions at 1e-12 of the largest
    entry; the couplings gather only "agglomerate" (on the 2x4 mesh along
    x at 15^2, then along y at 7^2).
(b) On 2x2, each against JAX's solve under ``ShardingPlan(make_device_mesh(
    jax.devices()[:4]), min_local=4)`` (``backend="pallas"``): I (also
    ``composite_smoother="jacobi"``), E, D1 (with ``-moreNorm``, its
    monitors compared), D2 and D1PS at grids 4 / levels 1, forced 6;
    mg-CG at grids 5 / levels 3, its merged coarsest level (15^2 split,
    7^2 and 3^2 whole) solved directly with its split grid gathered
    ("coarsest"); at 129^2 with ``min_local=8`` a V-cycle at grids 4 /
    levels 2, forced 6, over the CG-solved merged level 1 (63^2 and 31^2
    split, 15^2 whole).
(c) On 2x4 (8 devices for JAX): D1 and the mg-CG of (b), a merged level
    holding 15^2 split along y alone.
(d) Against the port's own one-process solve (JAX is checked on these by
    test_torch_cycles.py): FMG and Additive over mg-CG's levels,
    mg-FGMRES on the merged level 0, D1 with the Chebyshev A1 smoother.
(e) A partial D1 checkpointed on 2x2 and resumed.
(f) ``-map 0 -npts 129 -grids 4 -levels 1 -cycle 3 -iter 20`` (D1, 127^2
    split) under the 4-rank world prints the one-process summary.

Every rank's results are identical; each grid of each level is split
along the axes of JAX's spec; the only all-gathers inside the iterations
are "agglomerate" and "coarsest".  Tolerances are those of
test_torch_dist_merged.py: iterations equal, rnorm rtol 1e-6 / atol
1e-9, every grid rtol 1e-6 / atol 1e-12, the monitors rtol 1e-6; the
V-cycle over the CG-solved merged level rnorm rtol 2.4e-3 and u atol
2e-9 (5x JAX's own device-count spread of the rows-layout run: 64 CG
iterations of a nonsymmetric operator amplify reduction order).
"""

from __future__ import annotations

import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _dist_worker as dw
from multigrid_petsc_tpu.hierarchy import build_hierarchy as j_hierarchy
from multigrid_petsc_tpu.mesh import MeshType as JMesh
from multigrid_petsc_tpu.ops import composite as jcomp
from multigrid_petsc_tpu.ops import transfer as jtr
from multigrid_petsc_tpu.parallel.device_mesh import ShardingPlan as JPlan
from multigrid_petsc_tpu.parallel.device_mesh import make_device_mesh
from multigrid_petsc_tpu.problems import stencil_coefficients as j_coeffs
from multigrid_petsc_tpu.solvers import smoothers as jsm
from multigrid_petsc_tpu.solvers.solve import solve as j_solve
from multigrid_petsc_tpu_torch import poisson
from multigrid_petsc_tpu_torch.solvers.solve import solve
from test_torch_dist_merged import F64_TOL, TOLS, jax_config

torch.set_num_threads(2)

FORCED = dict(rtol=1e-30, divtol=1e30, max_iter=6)
NPTS = 65
ONE = dict(npts=NPTS, grids=4, levels=1, **FORCED)
MGCG_DIRECT = dict(npts=NPTS, grids=5, levels=3, cycle=101, **FORCED)
MIN_LOCAL = 4
# The two worlds: ranks -> (my, mx).
MESHES = {4: (2, 2), 8: (2, 4)}
# (b), (c): (name, ranks) -> (SolverConfig fields, min_local).
CONFIGS = {
    ("I", 4): (dict(ONE, cycle=1), MIN_LOCAL),
    ("I_JACOBI", 4): (dict(ONE, cycle=1, composite_smoother="jacobi"),
                      MIN_LOCAL),
    ("E", 4): (dict(ONE, cycle=2), MIN_LOCAL),
    ("D1", 4): (dict(ONE, cycle=3, more_norm=True), MIN_LOCAL),
    ("D2", 4): (dict(ONE, cycle=4), MIN_LOCAL),
    ("D1PS", 4): (dict(ONE, cycle=7), MIN_LOCAL),
    ("MGCG_DIRECT", 4): (MGCG_DIRECT, MIN_LOCAL),
    ("V_CG", 4): (dict(npts=129, grids=4, levels=2, cycle=0, **FORCED), 8),
    ("D1", 8): (dict(ONE, cycle=3), MIN_LOCAL),
    ("MGCG_DIRECT", 8): (MGCG_DIRECT, MIN_LOCAL),
}
# (d): held to the port's one-process solve, on 2x2.
ONE_PROCESS = {
    "FMG": dict(MGCG_DIRECT, cycle=103),
    "ADDITIVE": dict(MGCG_DIRECT, cycle=9),
    "FGMRES": dict(ONE, cycle=102, max_iter=2),
    "CHEBYSHEV": dict(ONE, cycle=3, smoother="chebyshev"),
}
# The configs whose merged coarsest level is solved directly.
DIRECT = {"MGCG_DIRECT", "FMG"}
CHECKPOINT = dict(ONE, cycle=3, max_iter=9)
CLI_ARGS = ["-npts", "129", "-grids", "4", "-levels", "1", "-cycle", "3",
            "-iter", "20", "-device", "cpu"]
# The all-gathers a solve may make inside its iterations.
INSIDE = {"agglomerate", "coarsest"}


def _job(fields, min_local=MIN_LOCAL, **extra):
    return dict({"cfg": fields, "min_local": min_local, "layout": "blocks"},
                **extra)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The module's gloo worlds, each writing to its own directory,
    started when the module's first test runs, so the ranks solve while
    the JAX references run."""
    out = tmp_path_factory.mktemp("blocks_merged")
    jobs = {n: {"merged_units": dict(layout="blocks", npts=NPTS,
                                     min_local=MIN_LOCAL)}
            for n in MESHES}
    for (name, ranks), (f, m) in CONFIGS.items():
        jobs[ranks][name] = _job(f, m)
    jobs[4]["MGCG_DIRECT"]["view"] = True
    jobs[4].update({n: _job(f) for n, f in ONE_PROCESS.items()})
    jobs[4]["CHECKPOINT"] = _job(CHECKPOINT, checkpoint=True)
    jobs[4]["cli"] = {"argv": CLI_ARGS + ["-map", "0"]}
    procs = {}
    for n, j in jobs.items():
        (out / str(n)).mkdir()
        procs[n] = dw.spawn(j, out / str(n), n)
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


def j_plan(ranks: int, min_local: int = MIN_LOCAL):
    return JPlan(make_device_mesh(jax.devices()[:ranks]), min_local=min_local)


@pytest.fixture(scope="module")
def jax_refs():
    """JAX's blocks-plan solves of CONFIGS, and of the checkpoint's
    config: 3 iterations, then resumed from that solution."""
    refs = {key: j_solve(jax_config(f), plan=j_plan(key[1], m))
            for key, (f, m) in CONFIGS.items()}
    part = j_solve(jax_config(dict(CHECKPOINT, max_iter=3)), plan=j_plan(4))
    refs["CHECKPOINT"] = j_solve(jax_config(CHECKPOINT), plan=j_plan(4),
                                 u0=part.u)
    refs["CHECKPOINT_PART"] = part
    return refs


def jax_grid_axes(fields: dict, ranks: int, min_local: int) -> list:
    """The axes (y, x) JAX's plan splits each grid of each level along
    (its spec's letters on mesh axes of two devices or more)."""
    plan = j_plan(ranks, min_local)
    my, mx = MESHES[ranks]
    out = []
    for spec in j_hierarchy(fields["npts"], fields["grids"],
                            fields["levels"]):
        axes = []
        for g in spec.grids:
            s = tuple(plan.spec(g.ny, g.nx))
            s = s + (None,) * (2 - len(s))
            axes.append([s[0] == "y" and my > 1, s[1] == "x" and mx > 1])
        out.append(axes)
    return out


def check_ranks(runs) -> dict:
    """Every rank's results identical; the gathers inside the solve."""
    r0 = runs[0]
    for r in runs[1:]:
        assert int(r["iters"]) == int(r0["iters"])
        np.testing.assert_array_equal(r["rnorm"], r0["rnorm"])
        for k in range(5):
            if f"grid{k}" in r0:
                np.testing.assert_array_equal(r[f"grid{k}"], r0[f"grid{k}"])
        if "r_grid" in r0:
            np.testing.assert_array_equal(r["r_grid"], r0["r_grid"])
    assert str(r0["path"]) == "torch"
    gathers = json.loads(str(r0["gathers"]))
    assert set(gathers) <= INSIDE, gathers
    return r0


# ---------------------------------------------------------------------------
# (a) A merged level's operators on the blocks.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def units(worlds):
    """Each world's merged_units results (rank 0's; every rank's checked
    identical) and JAX's whole-grid stencils and inputs of the level."""
    gids = dw.MERGED_GIDS
    jst = tuple(j_coeffs(JMesh(1), *(((NPTS - 1) >> g) - 1,) * 2)
                for g in gids)
    u = tuple(map(jnp.asarray, dw.merged_inputs(1, NPTS)))
    b = tuple(map(jnp.asarray, dw.merged_inputs(2, NPTS)))
    got = {}

    def of(ranks):
        if ranks not in got:
            runs = dw.load(worlds(ranks), "merged_units", ranks)
            for r in runs[1:]:
                for key, val in runs[0].items():
                    np.testing.assert_array_equal(r[key], val)
            got[ranks] = runs[0]
        return got[ranks], jst, gids, u, b

    return of


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-12 * np.abs(want).max())


# The axes each grid of the units level is split along, per world.
UNIT_AXES = {4: [[True, True]] * 3 + [[False, False]],
             8: [[True, True]] * 2 + [[True, False], [False, False]]}


@pytest.mark.parametrize("name", ["A", "A1", "A2", "res", "bgs"])
@pytest.mark.parametrize("ranks", list(MESHES), ids=["2x2", "2x4"])
def test_merged_operators_on_blocks_match_jax(units, ranks, name):
    """A u, A1 u, A2 u, b - A u and one block Gauss-Seidel sweep (3 inner
    Jacobi steps: one K17 visit on a split grid, K7 on the whole one)
    with each grid on its 2-D blocks: their couplings gather only
    "agglomerate"."""
    r, jst, gids, u, b = units(ranks)
    assert r["grid_axes"].tolist() == UNIT_AXES[ranks]
    if name == "bgs":
        want = jsm.composite_block_gs(jst, gids,
                                      tuple(1.0 / s.cc for s in jst), b, u,
                                      1, inner=3, omega=0.8)
    elif name == "res":
        want = jcomp.composite_residual(jst, gids, b, u)
    else:
        kw = {"A1": dict(include_couplings=False),
              "A2": dict(include_diag=False)}.get(name, {})
        want = jcomp.composite_apply(jst, gids, u, **kw)
    for k, w in enumerate(want):
        _close(r[f"{name}{k}"], w)
    gathers = json.loads(str(r[name + "_gathers"]))
    assert set(gathers) <= {"agglomerate"}, gathers
    if name != "A1":  # the couplings restrict onto the whole 7^2 grid
        assert gathers.get("agglomerate", 0) > 0


@pytest.mark.parametrize("ranks", list(MESHES), ids=["2x2", "2x4"])
def test_merged_transfers_dot_and_norms_on_blocks(units, ranks):
    """Three restrictions from grid 0's blocks to the whole grid 3 (on
    2x2: block-local twice, then gathered along both axes; on 2x4: at
    15^2 gathered along x, at 7^2 along y), three prolongations back (cut,
    then block-local; no gather), <u, b> over the level and each grid's
    norm (a grid split along y alone summed over its mesh column only)."""
    r, jst, gids, u, b = units(ranks)
    _close(r["down"], jtr.restrict_multi(u[0], 3))
    _close(r["up"], jtr.prolong_multi(u[3], 3))
    down = json.loads(str(r["down_gathers"]))
    assert down == {"agglomerate": 1 if ranks == 4 else 2}, down
    assert json.loads(str(r["up_gathers"])) == {}
    assert r["contiguous"].all()  # as the card's kernels take them
    want = sum(float(jnp.vdot(x, y)) for x, y in zip(u, b))
    np.testing.assert_allclose(float(r["dot"]), want, rtol=1e-12)
    np.testing.assert_allclose(r["norms"],
                               [float(jnp.linalg.norm(x)) for x in u],
                               rtol=1e-12)


# ---------------------------------------------------------------------------
# (b), (c) The solves against JAX's blocks plan.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,ranks", list(CONFIGS),
                         ids=[f"{n}-{MESHES[r][0]}x{MESHES[r][1]}"
                              for n, r in CONFIGS])
def test_merged_cycle_matches_jax_blocks(worlds, jax_refs, name, ranks):
    fields, min_local = CONFIGS[(name, ranks)]
    ref = jax_refs[(name, ranks)]
    r0 = check_ranks(dw.load(worlds(ranks), name, ranks))
    axes = json.loads(str(r0["grid_axes"]))
    assert axes == jax_grid_axes(fields, ranks, min_local), axes
    merged = [a for a in axes if len(a) > 1][-1]
    assert merged[0] != [False, False], "no grid of the merged level split"
    if ranks == 8:  # a merged level holding a grid split along y alone
        assert [True, False] in merged, merged
    assert int(r0["iters"]) == int(ref.iters)
    assert bool(r0["converged"]) == bool(ref.converged)
    tol = TOLS.get(name, F64_TOL)
    np.testing.assert_allclose(r0["rnorm"], ref.rnorm, **tol["hist"])
    grids = [r0[f"grid{k}"] for k in range(len(axes[0]))]
    assert len(grids) == len(ref.u)
    for got, want in zip(grids, ref.u):
        np.testing.assert_allclose(got, np.asarray(want), **tol["u"])
    gathers = json.loads(str(r0["gathers"]))
    assert ("coarsest" in gathers) == (name in DIRECT), gathers
    assert gathers.get("agglomerate", 0) > 0  # onto a whole grid


def test_more_norm_monitors_match_jax_blocks(worlds, jax_refs):
    """D1's -moreNorm monitors on 2x2 (a split grid's norm summed over
    the ranks, the whole grid's once) against JAX's."""
    ref = jax_refs[("D1", 4)]
    r0 = check_ranks(dw.load(worlds(4), "D1", 4))
    for key in ("r_global", "r_grid"):
        want = np.asarray(ref.aux[key])
        assert r0[key].shape == want.shape
        np.testing.assert_allclose(r0[key], want, rtol=1e-6,
                                   atol=1e-12 * np.abs(want).max())


def test_view_solver_names_each_grids_block(worlds):
    """Every rank's ``view_solver`` of the 2x2 mg-CG: the merged level's
    op token names K17 on the mesh with each split grid's block (the 15^2
    grid's 8x8), and its layout token JAX's spec of its primary grid."""
    out = worlds(4)
    texts = {(out / f"MGCG_DIRECT.{r}.view.txt").read_text()
             for r in range(4)}
    assert len(texts) == 1
    text = texts.pop()
    last = text.splitlines()[-1]
    assert last.startswith("level 2: [g2:15x15, g3:7x7, g4:3x3] "), text
    assert " op=K17(mesh 2x2, block=8x8, pad=1) " in last, last
    assert " layout=('y', 'x') " in last and last.endswith(
        " coarse=auto"), last


# ---------------------------------------------------------------------------
# (d) - (f) The port's one-process solves, the checkpoint, the CLI.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(ONE_PROCESS))
def test_merged_cycle_on_blocks_matches_one_process(worlds, name):
    """ONE_PROCESS's configs on 2x2 against the port's one-process solve,
    to the f64 bounds: iterations, history and every grid."""
    r0 = check_ranks(dw.load(worlds(4), name, 4))
    one = solve(dw.config(ONE_PROCESS[name]), device="cpu")
    assert int(r0["iters"]) == one.iters
    np.testing.assert_allclose(r0["rnorm"], one.rnorm, **F64_TOL["hist"])
    for k, g in enumerate(one.u_grids):
        np.testing.assert_allclose(r0[f"grid{k}"], g.numpy(), **F64_TOL["u"])
    gathers = json.loads(str(r0["gathers"]))
    assert ("coarsest" in gathers) == (name in DIRECT)


def test_merged_checkpoint_round_trip_under_blocks(worlds, jax_refs):
    """3 D1 iterations, saved under the blocks plan (each split grid
    gathered, rank 0 writes every grid), loaded as each rank's 2-D block
    of each split grid (the pad row and column 0; the whole 7^2 grid as
    it is) and resumed: the file holds the partial solve's grids, and
    the resumed solve matches JAX's resume of its own 3 iterations."""
    runs = dw.load(worlds(4), "CHECKPOINT", 4)
    r0 = check_ranks(runs)
    part = jax_refs["CHECKPOINT_PART"]
    assert int(r0["part_iters"]) == 3 and int(r0["n_saved"]) == 4
    np.testing.assert_array_equal(r0["saved"], r0["part_u"])
    np.testing.assert_array_equal(r0["saved_last"], r0["part_last"])
    np.testing.assert_allclose(r0["saved"], np.asarray(part.u[0]),
                               rtol=1e-6, atol=1e-12)
    n = r0["saved"].shape[0]
    R = (n + 1) // 2
    padded = np.zeros((n + 1, n + 1))
    padded[:n, :n] = r0["saved"]
    for rank, r in enumerate(runs):
        iy, ix = divmod(rank, 2)
        np.testing.assert_array_equal(
            r["block"], padded[iy * R:(iy + 1) * R, ix * R:(ix + 1) * R])
        np.testing.assert_array_equal(r["block_last"], r0["saved_last"])
    ref = jax_refs["CHECKPOINT"]
    assert int(r0["iters"]) == int(ref.iters)
    np.testing.assert_allclose(r0["rnorm"], ref.rnorm, rtol=1e-6, atol=1e-9)
    for k, want in enumerate(ref.u):
        np.testing.assert_allclose(r0[f"grid{k}"], np.asarray(want),
                                   rtol=1e-6, atol=1e-12)


def test_cli_map_0_merged_prints_the_one_process_summary(worlds, tmp_path,
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
