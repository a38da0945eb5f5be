"""One rank of a CPU gloo world for the distributed port's tests
(test_torch_dist.py, test_torch_dist_solve.py, test_torch_dist_cycles.py,
test_torch_dist_smoothers.py, test_torch_dist_merged.py,
test_torch_dist_blocks.py, test_torch_dist_blocks_smoothers.py,
test_torch_dist_blocks_merged.py), and the
helpers that start such a world and
read its results (``spawn``, ``finish``, ``load``).  Not collected by
pytest (no test_ prefix).

    python tests/_dist_worker.py RANK WORLD PORT OUTDIR CONFIGS_JSON

CONFIGS_JSON maps a name to {"cfg": SolverConfig fields (cycle as its
id, smoothers as their values), "min_local": int, "layout": "rows" or
"blocks", "mesh": [my, mx] (blocks), "warm": bool, "view": bool,
"nonsep": bool, "checkpoint": bool}.  Each rank solves every config
under ``row_plan(min_local=...)`` (or ``blocks_plan``) on the CPU and
writes OUTDIR/<name>.<rank>.npz: iterations, converged, the residual
history, the gathered solution (every grid of level 0 as ``grid<k>``),
which levels ran sharded (``dist``; ``split``: each level's grids, as
JSON; ``axes``: the axes (y, x) the plan splits each level along;
``grid_axes``: the axes each grid of each level's operators is split
along), the
-moreNorm monitors where the solve kept them, and the all-gathers the
solve made (``parallel.halo.gathers``, as JSON); with "view" also
OUTDIR/<name>.<rank>.view.txt, the solve's ``view_solver`` dump.
"warm" solves 3 iterations first and restarts from that solution
(``u0``); "checkpoint" does the same through a checkpoint under the plan
(``utils.checkpoint.save`` / ``load``), and records the saved grids and
the loaded blocks; "nonsep" multiplies the 9-point centre by
``nonsep_factor`` (coefficients no sum of an x- and a y-profile gives).
The name "exchange" checks ``edge_exchange`` and ``allreduce_sum``
instead, "block_exchange" ``block_exchange`` (``block_halos``), "refuse"
records what each case of ``REFUSALS`` raises (and the device of a plan
built without one), and
"units" runs ``units``: a sharded level's operators on row blocks, and
"merged_units" runs ``merged_units``: a merged level's operators on
its grids' blocks (its spec may name "layout", "mesh", "npts" and
"min_local"); a config with "argv" runs the CLI (``cli``).
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from multigrid_petsc_tpu_torch.parallel import (  # noqa: E402
    ShardingPlan,
    allreduce_sum,
    block_exchange,
    blocks_plan,
    edge_exchange,
    halo,
    row_plan,
)
from multigrid_petsc_tpu_torch.solvers.solve import solve  # noqa: E402
from multigrid_petsc_tpu_torch.utils import checkpoint  # noqa: E402
from multigrid_petsc_tpu_torch.utils.config import (  # noqa: E402
    CycleType,
    SmootherType,
    SolverConfig,
)
from multigrid_petsc_tpu_torch.utils.views import view_solver  # noqa: E402


WORLD = 4
TIMEOUT = 240  # seconds for a whole world; a deadlocked rank fails the test


def spawn(configs: dict, outdir: Path, world: int = WORLD) -> list:
    """Start one process per rank, each solving ``configs``, each with
    one host thread for its BLAS (as ``torchrun`` sets it: ranks whose
    BLAS threads each take every core spin against each other)."""
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, __file__, str(r), str(world), str(port),
         str(outdir), json.dumps(configs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env)
        for r in range(world)]


def finish(procs: list) -> None:
    """Wait for every rank (TIMEOUT in all); raise with the output of any
    rank that failed, after stopping the others."""
    try:
        outs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise AssertionError("a rank of the gloo world did not finish")
    bad = [f"rank {r}:\n{o}" for r, (p, o) in enumerate(zip(procs, outs))
           if p.returncode != 0]
    assert not bad, "\n".join(bad)


def load(outdir: Path, name: str, world: int = WORLD) -> list:
    """Every rank's results of config ``name``."""
    return [dict(np.load(outdir / f"{name}.{r}.npz")) for r in range(world)]


# What a plan refuses: case -> (SolverConfig fields, plan arguments): the
# row plan's two, then what the blocks layout does not take yet, one case
# per ROADMAP item, in the order it is queued (the uneven blocks: 11 + 1
# points over 4 ranks along x).
REFUSALS = {
    "sparse": (dict(backend="sparse"), {}),
    "bf16": (dict(dtype="bfloat16"), {}),
    "uneven": (dict(npts=13, grids=2, levels=2),
               {"layout": "blocks", "mesh": [1, 4], "min_local": 2}),
}
# The ROADMAP item each blocks refusal names.
BLOCKS_ITEMS = {"uneven": "uneven blocks"}


def nonsep_factor(ny: int, nx: int) -> np.ndarray:
    """1 + 0.25 x y on the uniform (ny, nx) interior grid, f64: a centre
    multiplied by it is no sum of an x- and a y-profile."""
    x = np.arange(1, nx + 1) / (nx + 1)
    y = np.arange(1, ny + 1) / (ny + 1)
    return 1.0 + 0.25 * y[:, None] * x[None, :]


def nonsep_coefficients(fn):
    """``stencil9_coefficients`` with its centre times ``nonsep_factor``."""
    def coefficients(prob, ny, nx, dtype, device):
        st = fn(prob, ny, nx, dtype, device)
        f = torch.as_tensor(nonsep_factor(ny, nx), dtype=dtype, device=device)
        return st._replace(cc=st.cc * f)

    return coefficients


def make_plan(spec: dict, device="cpu"):
    """A job's plan: ``row_plan`` or, with "layout": "blocks",
    ``blocks_plan`` (over "mesh" when given), ``min_local`` (default
    32)."""
    kw = dict(min_local=spec.get("min_local", 32), device=device)
    if spec.get("layout") == "blocks":
        mesh = spec.get("mesh")
        return blocks_plan(shape=None if mesh is None else tuple(mesh), **kw)
    return row_plan(**kw)


def refuse(rank: int, out: Path) -> None:
    """What each case of ``REFUSALS`` raises; and a plan built without a
    device: its device, and what a solve under it raises (no card)."""
    got = {}
    cases = {}
    for case, (fields, plan_kw) in REFUSALS.items():
        cfg = config(dict(dict(npts=129, grids=4, levels=4, cycle=101),
                          **fields))
        cases[case] = lambda cfg=cfg, kw=plan_kw: solve(
            cfg, plan=make_plan(dict(dict(min_local=8), **kw)))
    default = ShardingPlan()
    got["default_device"] = str(default.device)
    cases["default_solve"] = lambda: solve(
        config(dict(npts=17, grids=2, levels=2, cycle=101)), plan=default)
    for case, fn in cases.items():
        try:
            fn()
            got[case] = "no error"
        except Exception as e:  # recorded, judged by the test
            got[case] = f"{type(e).__name__}: {e}"
    (out / f"refuse.{rank}.json").write_text(json.dumps(got))


def config(fields: dict) -> SolverConfig:
    kw = dict(fields)
    if "cycle" in kw:
        kw["cycle"] = CycleType(kw["cycle"])
    for k in ("smoother", "fine_smoother"):
        if k in kw:
            kw[k] = SmootherType(kw[k])
    for k in ("v", "aniso"):
        if k in kw:
            kw[k] = tuple(kw[k])
    return SolverConfig(**kw)


def exchange(rank: int, world: int, plan, out: Path) -> None:
    """Each rank's block holds rank * 100 + row index; 3 halo rows of two
    blocks in one message, and the sum of the ranks."""
    rows = torch.arange(8, dtype=torch.float64)[:, None].expand(8, 5)
    x = rank * 100.0 + rows
    hx, hy = edge_exchange((x, -x), 3, plan)
    total = allreduce_sum(torch.tensor(float(rank + 1), dtype=torch.float64),
                          plan)
    np.savez(out / f"exchange.{rank}.npz", top=hx.top.numpy(),
             bot=hx.bot.numpy(), top2=hy.top.numpy(), bot2=hy.bot.numpy(),
             total=total.numpy())


def block_halos(rank: int, world: int, out: Path) -> None:
    """``block_exchange`` on the 2x2 blocks plan: every rank's (16, 16)
    block of one (32, 32) field (numpy, seed 3) and its halo of depth 1
    and 3 split along both axes, and of depth 3 split along y and along x
    alone (the other axis's extent whole: (16, 32) and (32, 16) blocks of
    the same field); two blocks in one message; written to
    OUTDIR/block_exchange.<rank>.npz."""
    plan = blocks_plan(min_local=4, device="cpu")
    iy, ix = plan.coords
    field = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (32, 32)))
    res = {"coords": np.asarray([iy, ix])}
    blocks = {"yx": (field[16 * iy:16 * iy + 16, 16 * ix:16 * ix + 16],
                     (True, True)),
              "y": (field[16 * iy:16 * iy + 16], (True, False)),
              "x": (field[:, 16 * ix:16 * ix + 16], (False, True))}
    for name, (blk, split) in blocks.items():
        for h in ((1, 3) if name == "yx" else (3,)):
            halos = block_exchange((blk, -blk), h, plan, split)
            for k, hl in zip(("", "neg_"), halos):
                for part, x in hl._asdict().items():
                    res[f"{k}{name}{h}_{part}"] = x.numpy()
    np.savez(out / f"block_exchange.{rank}.npz", **res)


def cli(rank: int, world: int, out: Path, name: str, argv: list) -> None:
    """``poisson.main(argv)`` on this world's process group, in
    OUTDIR/<name>.<rank>/ (the artifact files), its standard output to
    OUTDIR/<name>.<rank>.txt."""
    import contextlib
    import io

    from multigrid_petsc_tpu_torch import poisson

    cwd = out / f"{name}.{rank}"
    cwd.mkdir()
    text = io.StringIO()
    old = os.getcwd()
    os.environ["WORLD_SIZE"] = str(world)
    try:
        os.chdir(cwd)
        with contextlib.redirect_stdout(text):
            assert poisson.main(argv) == 0
    finally:
        os.chdir(old)
    (out / f"{name}.{rank}.txt").write_text(text.getvalue())


def units(rank: int, world: int, out: Path) -> None:
    """A sharded level's operators on the ranks' row blocks, from inputs
    every rank makes alike (numpy, seed 7), gathered and written to
    OUTDIR/units.<rank>.npz beside those inputs, for the tests to hold
    against the whole-grid functions: RBGS (2 sweeps, omega 1.2) on
    blocks of 5 rows (odd: ny = 19) and 8 (ny = 31); Jacobi visits of 8
    steps on 8-row blocks (a zero-guess rc visit, a correcting ur visit
    with the coarse level's blocks, in visits of at most 6 steps) and a
    Chebyshev smooth of 8 steps (one residual per step); the
    restriction and the prolongation between the sharded 63^2 and 31^2
    levels and from the sharded 31^2 level to the replicated 15^2 one;
    two y-line sweeps over the ranks and two x-line sweeps on the blocks
    of the aniso (1,1,1,2,0.4) 63^2 level."""
    from multigrid_petsc_tpu_torch.mesh import MeshType
    from multigrid_petsc_tpu_torch.ops.cuda import line_kernel as lk
    from multigrid_petsc_tpu_torch.ops.stencil import transpose_stencil9
    from multigrid_petsc_tpu_torch.parallel import DistLevelOps
    from multigrid_petsc_tpu_torch.problems import (
        AnisoProblem,
        stencil9_coefficients,
        stencil_coefficients,
    )
    from multigrid_petsc_tpu_torch.solvers import smoothers as sm

    rng = np.random.default_rng(7)
    plan = row_plan(min_local=4, device="cpu")
    res, inputs = {}, []

    def grid(ny):  # an input, saved as in<i> in the order made
        inputs.append(rng.standard_normal((ny, ny)))
        res[f"in{len(inputs) - 1}"] = inputs[-1]
        return torch.as_tensor(inputs[-1])

    def ops(st, ny, k=8):
        return DistLevelOps(st, ny, ny, plan, k)

    def whole(d, x, coarse=False):
        n = (d.ny - 1) // 2 if coarse else d.ny
        return all_gather(x, plan)[:n]

    for ny in (19, 31):
        st = stencil_coefficients(MeshType(1), ny, ny, torch.float64, "cpu")
        d = ops(st, ny)
        d.setup_rbgs(1.2)
        b, u = grid(ny), grid(ny)
        res[f"rbgs{ny}"] = whole(d, d.rbgs(d.block_of(b), d.block_of(u), 2))
    st31 = stencil_coefficients(MeshType(1), 31, 31, torch.float64, "cpu")
    d31 = ops(st31, 31)
    b, u, e = grid(31), grid(31), grid(15)
    e_blk = torch.cat([e, e.new_zeros((1, 15))])[rank * 4:(rank + 1) * 4]
    jac = sm.jacobi_step_coeffs(8, 0.8)
    uo, rc = d31.visit_down(d31.block_of(b), None, jac)
    res["rc0_u"], res["rc0_rc"] = whole(d31, uo), whole(d31, rc, True)
    uo, r = d31.visit_up(d31.block_of(b), d31.block_of(u), e_blk, jac, True)
    res["ur_u"], res["ur_r"] = whole(d31, uo), whole(d31, r)
    cheb = sm.chebyshev_step_coeffs(8, 1.9)
    res["cheb"] = whole(d31, d31.smooth(d31.block_of(b), d31.block_of(u),
                                        cheb))
    st63 = stencil_coefficients(MeshType(1), 63, 63, torch.float64, "cpu")
    d63 = ops(st63, 63, 3)
    r, e = grid(63), grid(31)
    res["restrict63"] = whole(d63, d63.restrict(d63.block_of(r)), True)
    res["prolong63"] = whole(d63, d63.prolong(d31.block_of(e)))
    r, e = grid(31), grid(15)
    res["agglomerate31"] = d31.gather_coarse(d31.restrict(d31.block_of(r)))
    res["prolong31"] = whole(d31, d31.prolong(e))
    st9 = stencil9_coefficients(AnisoProblem(1.0, 1.0, 1.0, 2.0, 0.4), 63, 63,
                                torch.float64, "cpu")
    d9 = ops(st9, 63, 3)
    line = lk.collapse_stencil(st9)
    d9.setup_line_y(line)
    d9.setup_line_x(lk.collapse_stencil(transpose_stencil9(st9)))
    b, u = grid(63), grid(63)
    res["line_y"] = whole(d9, d9.line_y_sweeps(d9.block_of(b),
                                               d9.block_of(u), 2, 0.8))
    res["line_x"] = whole(d9, d9.line_x_sweeps(d9.block_of(b),
                                               d9.block_of(u), 2, 0.8))
    np.savez(out / f"units.{rank}.npz",
             **{k: np.asarray(v) for k, v in res.items()})


def grid_axes(lv) -> list:
    """The axes (y, x) each grid of level ``lv``'s operators is split
    along ([False, False] for a grid held whole; a row block's (True,
    False))."""
    ops = getattr(lv.grid_ops, "ops", (lv.dist,) * len(lv.spec.grids))
    return [[False, False] if d is None
            else list(getattr(d, "split", (True, False))) for d in ops]


def all_gather(x, plan):
    from multigrid_petsc_tpu_torch.parallel.halo import all_gather_rows

    return all_gather_rows(x, plan, "solution")


# merged_units: the merged level of grids 0-3, by default at npts 129
# under row_plan(min_local=8) on 4 ranks (blocks of 32, 16 and 8 rows,
# grid 3 replicated), f64, mesh 1.
MERGED_NPTS, MERGED_GIDS = 129, (0, 1, 2, 3)


def merged_inputs(seed: int, npts: int = MERGED_NPTS) -> tuple:
    """A whole state of the merged_units level from numpy (``seed``)."""
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(((npts - 1) // 2**g - 1,) * 2)
                 for g in MERGED_GIDS)


def merged_units(rank: int, world: int, out: Path, spec: dict) -> None:
    """A merged level's operators on its grids' blocks
    (``DistMergedOps``) under the plan of ``spec`` (``make_plan``; its
    "npts", default MERGED_NPTS, and "min_local", default 8), from whole
    inputs every rank makes alike (``merged_inputs(1)`` u,
    ``merged_inputs(2)`` b), gathered and written to
    OUTDIR/merged_units.<rank>.npz: the axes each grid is split along, A
    u, A1 u, A2 u, b - A u, one block Gauss-Seidel sweep of 3 inner
    steps, the transfers from grid 0 to grid 3 and back (restriction:
    block-local, then gathered where a size stops being split along an
    axis; prolongation: cut, then block-local), <u, b>, each grid's norm,
    and the gathers each made."""
    from multigrid_petsc_tpu_torch.hierarchy import GridSpec, grid_interior
    from multigrid_petsc_tpu_torch.mesh import MeshType
    from multigrid_petsc_tpu_torch.ops import composite as comp
    from multigrid_petsc_tpu_torch.parallel import DistMergedOps
    from multigrid_petsc_tpu_torch.problems import stencil_coefficients
    from multigrid_petsc_tpu_torch.solvers import smoothers as sm

    npts = spec.get("npts", MERGED_NPTS)
    plan = make_plan(dict(spec, min_local=spec.get("min_local", 8)))
    grids = [GridSpec(g, grid_interior(npts, g), grid_interior(npts, g))
             for g in MERGED_GIDS]
    sts = [stencil_coefficients(MeshType(1), g.ny, g.nx, torch.float64,
                                "cpu") for g in grids]
    ops = DistMergedOps(sts, grids, plan, 3)
    u = ops.local(tuple(map(torch.as_tensor, merged_inputs(1, npts))))
    b = ops.local(tuple(map(torch.as_tensor, merged_inputs(2, npts))))

    def whole(state):
        return [np.asarray(d.gather(x, "solution")) if d is not None
                else np.asarray(x) for x, d in zip(state, ops.ops)]

    res = {"sharded": np.asarray(ops.sharded),
           "grid_axes": np.asarray([plan.split(g.ny, g.nx) for g in grids])}
    for name, fn in (
            ("A", lambda: comp.composite_apply(ops, u)),
            ("A1", lambda: comp.composite_apply(ops, u,
                                                include_couplings=False)),
            ("A2", lambda: comp.composite_apply(ops, u, include_diag=False)),
            ("res", lambda: comp.composite_residual(ops, b, u)),
            ("bgs", lambda: sm.composite_block_gs(ops, b, u, 1, inner=3,
                                                  omega=0.8))):
        halo.gathers.clear()
        got = fn()
        res[name + "_gathers"] = json.dumps(dict(halo.gathers))
        for k, x in enumerate(whole(got)):
            res[f"{name}{k}"] = x
    halo.gathers.clear()
    down = ops.restrict(u[0], 0, 3)
    res["down_gathers"] = json.dumps(dict(halo.gathers))
    halo.gathers.clear()
    up = ops.prolong(u[3], 3, 0)
    res["up_gathers"] = json.dumps(dict(halo.gathers))
    res["down"] = np.asarray(down)
    # The kernels take contiguous inputs only: a merged level applies A_f
    # to what a prolongation gives.
    res["contiguous"] = np.asarray([down.is_contiguous(),
                                    up.is_contiguous()])
    res["up"] = whole((up,) + tuple(u[1:]))[0]
    res["dot"] = np.asarray(ops.dot(u, b))
    res["norms"] = np.asarray([ops.grid_norm(k, x) for k, x in enumerate(u)])
    res["norm2"] = res["norms"][2]
    np.savez(out / f"merged_units.{rank}.npz", **res)


def main() -> None:
    rank, world, port = (int(a) for a in sys.argv[1:4])
    out = Path(sys.argv[4])
    configs = json.loads(sys.argv[5])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=120))
    try:
        for name, spec in configs.items():
            if name == "exchange":
                exchange(rank, world, row_plan(device="cpu"), out)
                continue
            if name == "refuse":
                refuse(rank, out)
                continue
            if name == "block_exchange":
                block_halos(rank, world, out)
                continue
            if "argv" in spec:
                cli(rank, world, out, name, spec["argv"])
                continue
            if name == "units":
                units(rank, world, out)
                continue
            if name == "merged_units":
                merged_units(rank, world, out, spec)
                continue
            plan = make_plan(spec)
            cfg = config(spec["cfg"])
            if spec.get("nonsep"):
                import multigrid_petsc_tpu_torch.solvers.context as context

                context.stencil9_coefficients = nonsep_coefficients(
                    context.stencil9_coefficients)
            u0, extra = None, {}
            if spec.get("warm") or spec.get("checkpoint"):
                part = solve(dataclasses.replace(cfg, max_iter=3), plan=plan)
                u0 = part.u_fine
                assert not part.converged
            if spec.get("checkpoint"):
                path = out / f"{name}.ck.npz"
                checkpoint.save(path, cfg, part.u_local, part.rnorm,
                                part.iters, plan=plan)
                dist.barrier()
                u0, rn, its = checkpoint.load(path, cfg, plan=plan)
                with np.load(path) as z:
                    saved = [z[f"u{k}"] for k in range(int(z["n_grids"]))]
                part_grids = [np.asarray(x) for x in part.u_grids]
                extra = dict(saved=saved[0], part_u=part.u_fine,
                             block=u0[0], part_iters=its,
                             n_saved=len(saved), saved_last=saved[-1],
                             part_last=part_grids[-1],
                             block_last=u0[-1])
            halo.gathers.clear()
            res = solve(cfg, plan=plan, u0=u0)
            gathers = json.dumps(dict(halo.gathers))
            if res.aux is not None:
                extra.update(r_global=res.aux["r_global"],
                             r_grid=res.aux["r_grid"])
            extra.update({f"grid{k}": np.asarray(x)
                          for k, x in enumerate(res.u_grids)})
            np.savez(out / f"{name}.{rank}.npz", iters=res.iters,
                     converged=res.converged, rnorm=res.rnorm,
                     u=res.u_fine, path=res.path, route=str(res.route),
                     dist=[lv.sharded for lv in res.ctx.levels],
                     split=json.dumps([list(lv.split)
                                       for lv in res.ctx.levels]),
                     axes=json.dumps([list(plan.split(*lv.shape))
                                      for lv in res.ctx.levels]),
                     grid_axes=json.dumps([grid_axes(lv)
                                           for lv in res.ctx.levels]),
                     block_rows=res.u.shape[0], gathers=gathers, **extra)
            if spec.get("view"):
                (out / f"{name}.{rank}.view.txt").write_text(
                    view_solver(res.ctx))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
