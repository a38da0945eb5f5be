"""Row-partition distribution of the port (``multigrid_petsc_tpu_torch.
parallel``, K17) against the JAX package on the CPU, part 1: K17's plain
version on the 5-point stencil against JAX's ``DistLevelOps`` in interpret
mode on the conftest's 8-device row mesh, every emit; a 4-rank gloo world
(``_dist_worker.py``, started once for the module and run beside the
kernel tests) for ``edge_exchange`` / ``allreduce_sum``, what a plan
refuses (the bf16 working dtype, the sparse backend, and what the blocks
layout does not take yet), the device of a plan built without one,
and the V-cycle and mg-CG solves against JAX's 4-device row-plan
solves.

The port's side of a K17 case cuts the grid, padded by its one pad row,
into 8 row blocks in one process, each block's halo rows cut from its
neighbours (zeros at the edges), and stitches the outputs.  Tolerances
are JAX's own (test_dist_pallas.py): rtol 1e-12 with atol 1e-12, rc and
the residual a visit emits atol 1e-14 of their largest entry; the
pad row and the coarse pad row exactly 0.  The solves: iterations equal,
rnorm to rtol 1e-6 / atol 1e-9, u_fine to rtol 1e-6 / atol 1e-12, the
same levels sharded, and every rank's results identical.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _dist_worker as dw
from multigrid_petsc_tpu.mesh import MeshType as JMesh
from multigrid_petsc_tpu.ops.pallas.stencil_kernel import jacobi_step_coeffs
from multigrid_petsc_tpu.parallel.device_mesh import make_row_mesh
from multigrid_petsc_tpu.parallel.device_mesh import row_plan as j_row_plan
from multigrid_petsc_tpu.parallel.dist_ops import DistLevelOps as JDist
from multigrid_petsc_tpu.problems import stencil_coefficients as j_coeffs
from multigrid_petsc_tpu.solvers.solve import solve as j_solve
from multigrid_petsc_tpu.utils.config import CycleType as JCT
from multigrid_petsc_tpu.utils.config import SolverConfig as JC
from multigrid_petsc_tpu_torch.ops.cuda import dist_kernel as dk
from multigrid_petsc_tpu_torch.ops.stencil import from_numpy_stencil
from multigrid_petsc_tpu_torch.parallel.dist_ops import (
    DistLevelOps,
    dist_viable,
)
from multigrid_petsc_tpu_torch.parallel.halo import edge_exchange

torch.set_num_threads(2)

NDEV = 8
STEPS = jacobi_step_coeffs(3, 0.8)
EMITS = ("a", "r", "u", "ur", "rc", "rc0", "correct_u", "correct_ur")


def _pad1(x):
    return np.concatenate([x, np.zeros((1, x.shape[1]))])


def jax_visit(st, ny, nx, emit, u, b, e, tile_cap=None):
    """JAX's distributed visit (interpret mode, 8 devices) on padded
    numpy inputs; its outputs as numpy."""
    ops = JDist(st, ny, nx, make_row_mesh(), jnp.float64,
                steps_fn=lambda s: jacobi_step_coeffs(s, 0.8),
                interpret=True, tile_cap=tile_cap)
    u, b, e = (None if x is None else jnp.asarray(x) for x in (u, b, e))
    if emit == "a":
        out = ops.apply(u)
    elif emit == "r":
        out = ops.residual(b, u)
    elif emit == "u":
        out = ops.smooth(b, u, 3)
    elif emit == "ur":
        fn, cs = ops._fn(STEPS, "ur", False)
        out = fn(cs, u, b)
    elif emit in ("rc", "rc0"):
        out = ops.visit_down(b, None if emit == "rc0" else u, 3)
    else:
        out = ops.visit_up(b, u, e, 3, emit == "correct_ur")
    out = out if isinstance(out, tuple) else (out,)
    return [np.asarray(o) for o in out]


def port_visit(st, ny, emit, u, b, e, P=NDEV, numpy=True):
    """K17's plain version on P row blocks of the padded inputs, halos cut
    from the neighbour blocks; the stitched outputs (as tensors with
    ``numpy=False``)."""
    R = (ny + 1) // P
    steps = () if emit in ("a", "r") else STEPS
    kind = {"rc0": "rc", "correct_u": "u", "correct_ur": "ur"}.get(emit, emit)
    h = dk.halo_rows(len(steps), kind)
    t = {k: None if x is None else torch.as_tensor(x)
         for k, x in (("u", u), ("b", b), ("e", e))}

    def halo(x, p, rows, n):
        if x is None:
            return None
        z = x.new_zeros((n, x.shape[1]))
        ext = torch.cat([z, x, z])
        return dk.Halo(ext[p * rows:p * rows + n],
                       ext[n + (p + 1) * rows:2 * n + (p + 1) * rows])

    outs = []
    for p in range(P):
        def blk(x, rows=R):
            return None if x is None else x[p * rows:(p + 1) * rows]

        e_blk = blk(t["e"], R // 2)
        out = dk.row_visit(
            st, None if emit == "a" else blk(t["b"]),
            None if emit == "rc0" else blk(t["u"]), steps, kind,
            row0=p * R, ny=ny, b_halo=halo(t["b"], p, R, h),
            u_halo=halo(t["u"], p, R, h), e=e_blk,
            e_halo=halo(t["e"], p, R // 2, dk.coarse_halo_rows(h))
            if e_blk is not None else None)
        outs.append(out if isinstance(out, tuple) else (out,))
    outs = [torch.cat([o[i] for o in outs]) for i in range(len(outs[0]))]
    return [o.numpy() for o in outs] if numpy else outs


def check_visit(jst, tst, ny, nx, emit, seed, tile_cap=None, nine=False):
    rng = np.random.default_rng(seed)
    u = _pad1(rng.standard_normal((ny, nx)))
    b = _pad1(rng.standard_normal((ny, nx)))
    e = None
    if emit.startswith("correct"):
        e = _pad1(rng.standard_normal(((ny - 1) // 2, (nx - 1) // 2)))
    want = jax_visit(jst, ny, nx, emit, u, b, e, tile_cap)
    got = port_visit(tst, ny, emit, u, b, e)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape
        assert np.all(g[-1] == 0.0)  # the pad row, or the coarse pad row
        # As JAX holds its own: a visit's second output (rc, or the
        # residual of ur) to 1e-14 of its largest entry; on the 9-point
        # stencil A u, b - A u and the second outputs to 1e-13 of it, and
        # a correcting visit's u to 1e-11.
        scale = float(np.abs(w).max())
        if nine and (i == 1 or emit in ("a", "r")):
            atol = 1e-13 * scale
        elif i == 1:
            atol = 1e-14 * scale
        elif nine and emit.startswith("correct"):
            atol = 1e-11
        else:
            atol = 1e-12
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=atol)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The module's 4-rank gloo world, started when the module's first
    test runs, so the ranks solve while the kernel tests run."""
    out = tmp_path_factory.mktemp("dist")
    base = dict(npts=129, grids=4, levels=4, max_iter=60)
    procs = dw.spawn({"exchange": {}, "refuse": {},
                      "V": {"cfg": dict(base, cycle=0), "min_local": 8},
                      "MGCG": {"cfg": dict(base, cycle=101),
                               "min_local": 8, "view": True}}, out)
    state = {"procs": procs, "done": False}

    def results():
        if not state["done"]:
            dw.finish(procs)
            state["done"] = True
        return out

    yield results
    for p in procs:
        if p.poll() is None:
            p.kill()


@pytest.fixture(scope="module", autouse=True)
def _start_world(world):
    return world


@pytest.mark.parametrize("emit", EMITS)
def test_k17_plain_matches_jax_63(emit):
    """63^2 on the NONUNIFORM2 mesh (JAX's ``_mk_ops``): R = 8 rows per
    block, one row tile per device on the JAX side."""
    jst = j_coeffs(JMesh.NONUNIFORM2, 63, 63, jnp.float64)
    tst = from_numpy_stencil([np.asarray(c) for c in jst], "cpu",
                             torch.float64)
    check_visit(jst, tst, 63, 63, emit, seed=5)


@pytest.mark.parametrize("emit", EMITS)
def test_k17_plain_matches_jax_255_tiles(emit):
    """255^2 with JAX's ``tile_cap=8``: 4 row tiles per device, so the
    JAX side runs its interior/edge two-call split."""
    jst = j_coeffs(JMesh.NONUNIFORM2, 255, 255, jnp.float64)
    tst = from_numpy_stencil([np.asarray(c) for c in jst], "cpu",
                             torch.float64)
    check_visit(jst, tst, 255, 255, emit, seed=9, tile_cap=8)


class _Plan4:
    """Rank 0 of 4 (the block rules need no process group)."""

    size, rank = 4, 0


def test_k17_rejects_a_halo_past_the_block():
    """Rows come from the immediate neighbours only: 5 steps need 5 halo
    rows, which a 4-row block cannot give.  One K17 visit of them raises
    (as its exchange does); the level's operators know the block cannot
    carry them (``viable``), and run such visits in pieces instead
    (test_torch_dist_smoothers.py holds the pieces to one whole visit)."""
    st = from_numpy_stencil([np.ones(15)] * 5, "cpu", torch.float64)
    u = torch.zeros(4, 15, dtype=torch.float64)
    ops = DistLevelOps(st, 15, 15, _Plan4(), 5)
    assert not ops.viable
    with pytest.raises(ValueError, match="exceeds"):
        ops._visit(u, u, jacobi_step_coeffs(5, 0.8), "u")
    with pytest.raises(ValueError, match="exceeds"):
        edge_exchange(u, 5, _Plan4())


def test_dist_viable_matches_jax():
    from multigrid_petsc_tpu.parallel.dist_ops import dist_viable as jv

    for ny in (15, 31, 63, 126, 127, 255, 8191):
        for P in (2, 4, 8):
            for k in (1, 3, 8):
                assert dist_viable(ny, P, k, nx=ny) == jv(ny, P, k, nx=ny)


def test_edge_exchange_and_allreduce(world):
    out = world()
    for r in range(dw.WORLD):
        d = np.load(out / f"exchange.{r}.npz")
        rows = np.arange(8.0)[:, None]
        top = (r - 1) * 100.0 + rows[5:] if r > 0 else 0.0 * rows[:3]
        bot = (r + 1) * 100.0 + rows[:3] if r < dw.WORLD - 1 else \
            0.0 * rows[:3]
        np.testing.assert_array_equal(d["top"], np.broadcast_to(top, (3, 5)))
        np.testing.assert_array_equal(d["bot"], np.broadcast_to(bot, (3, 5)))
        np.testing.assert_array_equal(d["top2"], -d["top"])
        np.testing.assert_array_equal(d["bot2"], -d["bot"])
        assert float(d["total"]) == sum(range(1, dw.WORLD + 1))


@pytest.mark.parametrize("case", list(dw.REFUSALS))
def test_plan_refuses(world, case):
    """What a plan does not take raises NotImplementedError naming
    ROADMAP (the sparse backend: JAX's ValueError), on every rank: the
    bf16 working dtype, and under the blocks layout each item that waits
    (uneven blocks), which name their item."""
    out = world()
    got = {json.loads((out / f"refuse.{r}.json").read_text())[case]
           for r in range(dw.WORLD)}
    assert len(got) == 1, got
    msg = got.pop()
    if case == "sparse":
        assert msg.startswith("ValueError") and "single-device" in msg
    else:
        assert msg.startswith("NotImplementedError") and "ROADMAP" in msg
        item = ("the bf16 working dtype" if case == "bf16" else
                "distribution, blocks: " + dw.BLOCKS_ITEMS[case])
        assert item in msg, msg


def test_plan_without_device_is_on_the_card(world):
    """A plan built without a device puts the rank's data on its card
    (cuda:LOCAL_RANK), never on the CPU: with no card here, a solve under
    it raises."""
    out = world()
    for r in range(dw.WORLD):
        got = json.loads((out / f"refuse.{r}.json").read_text())
        assert got["default_device"] == "cuda:0", got
        assert got["default_solve"].startswith("RuntimeError"), got
        assert "no CUDA device" in got["default_solve"], got


@pytest.fixture(scope="module")
def jax_dist_solves():
    plan = j_row_plan(devices=jax.devices()[:dw.WORLD], min_local=8)
    return {name: j_solve(JC(npts=129, grids=4, levels=4, max_iter=60,
                             cycle=c, backend="pallas"), plan=plan)
            for name, c in (("V", JCT.VCYCLE), ("MGCG", JCT.MGCG))}


def check_solve(runs, ref, dist_ref):
    """Every rank identical; against the JAX reference solve."""
    r0 = runs[0]
    for r in runs[1:]:
        assert int(r["iters"]) == int(r0["iters"])
        np.testing.assert_array_equal(r["rnorm"], r0["rnorm"])
        np.testing.assert_array_equal(r["u"], r0["u"])
    assert str(r0["path"]) == "torch"
    assert bool(r0["converged"]) and bool(ref.converged)
    assert int(r0["iters"]) == int(ref.iters)
    np.testing.assert_allclose(r0["rnorm"], ref.rnorm, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(r0["u"], ref.u_fine, rtol=1e-6, atol=1e-12)
    assert list(r0["dist"]) == dist_ref
    assert any(dist_ref), "no level ran sharded"


@pytest.mark.parametrize("name", ["V", "MGCG"])
def test_solve_matches_jax_dist(world, jax_dist_solves, name):
    ref = jax_dist_solves[name]
    runs = dw.load(world(), name)
    check_solve(runs, ref, [lv.dist is not None for lv in ref.ctx.levels])
    if name == "MGCG":
        assert str(runs[0]["route"]) == "generic"
    # Each rank's block: 32 rows, the last rank's 31 (its pad row cut).
    assert [int(r["block_rows"]) for r in runs] == [32, 32, 32, 31]


def test_view_solver_under_plan_matches_jax(world, jax_dist_solves):
    """Every rank's ``view_solver`` of the 4-rank mg-CG: JAX's dump of its
    4-device row-plan solve but the op= and layout= tokens; a sharded
    level's op names K17 with JAX's rank count, block rows and pad row."""
    import re

    from multigrid_petsc_tpu.utils.views import view_solver as j_view

    out = world()
    texts = {(out / f"MGCG.{r}.view.txt").read_text()
             for r in range(dw.WORLD)}
    assert len(texts) == 1
    got = texts.pop()
    ref = j_view(jax_dist_solves["MGCG"].ctx)

    def strip(text):
        return [re.sub(r" (op=[^ (]+|layout=)(\([^)]*\)|\S*)", "", ln)
                for ln in text.splitlines()]

    assert strip(got) == strip(ref)
    for g, r in zip(got.splitlines()[1:], ref.splitlines()[1:]):
        jd = re.search(r"pallas-dist\(shard_map x(\d+), R=(\d+), pad=(\d+)\)",
                       r)
        if jd:
            assert (f"op=K17(ranks x{jd[1]}, R={jd[2]}, pad={jd[3]}) " in g
                    and g.endswith(("layout=rows", "coarse=auto"))), g
        else:
            assert " op=torch" in g and "layout=replicated" in g, g
