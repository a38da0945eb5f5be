"""One rank of a CPU gloo world for the distributed port's tests
(test_torch_dist.py, test_torch_dist_solve.py), and the helpers that start
such a world and read its results (``spawn``, ``finish``, ``load``).  Not
collected by pytest (no test_ prefix).

    python tests/_dist_worker.py RANK WORLD PORT OUTDIR CONFIGS_JSON

CONFIGS_JSON maps a name to {"cfg": SolverConfig fields (cycle as its
id, smoothers as their values), "min_local": int, "warm": bool, "view":
bool}.  Each rank solves every config under ``row_plan(min_local=...)``
on the CPU and writes OUTDIR/<name>.<rank>.npz: iterations, converged,
the residual history, the gathered solution and which levels ran
sharded; with "view" also OUTDIR/<name>.<rank>.view.txt, the solve's
``view_solver`` dump.  "warm" solves 3 iterations first and restarts from
that solution (``u0``).  The name "exchange" checks ``edge_exchange`` and
``allreduce_sum`` instead, and "refuse" records what each case of
``REFUSALS`` raises, and what a checkpoint under the plan raises.
"""

import dataclasses
import json
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
    edge_exchange,
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
    """Start one process per rank, each solving ``configs``."""
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    return [subprocess.Popen(
        [sys.executable, __file__, str(r), str(world), str(port),
         str(outdir), json.dumps(configs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
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


# What a plan refuses: (case, SolverConfig fields) -> the exception raised.
REFUSALS = {
    "line_y": dict(smoother="line_y", problem="aniso",
                   aniso=(1.0, 0.0, 100.0, 0.0, 0.0)),
    "rbgs": dict(smoother="rbgs"),
    "line_x": dict(fine_smoother="line_x"),
    "mgfgmres": dict(cycle=102),
    "additive": dict(cycle=9),
    "outer_dtype": dict(dtype="float32", outer_dtype="float64"),
    "precond_dtype": dict(dtype="float32", precond_dtype="bfloat16"),
    "sparse": dict(backend="sparse"),
}


def refuse(rank: int, out: Path) -> None:
    got = {}
    cases = {"blocks": lambda: ShardingPlan(layout="blocks"),
             "checkpoint": lambda: checkpoint.save(
                 out / f"ck.{rank}.npz", SolverConfig(),
                 torch.zeros((2, 2)), np.ones(1), 0)}
    for case, fields in REFUSALS.items():
        cfg = config(dict(dict(npts=129, grids=4, levels=4, cycle=101),
                          **fields))
        cases[case] = lambda cfg=cfg: solve(
            cfg, plan=row_plan(min_local=8, device="cpu"))
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
            plan = row_plan(min_local=spec["min_local"], device="cpu")
            cfg = config(spec["cfg"])
            u0 = None
            if spec.get("warm"):
                part = solve(dataclasses.replace(cfg, max_iter=3), plan=plan)
                u0 = part.u_fine
                assert not part.converged
            res = solve(cfg, plan=plan, u0=u0)
            np.savez(out / f"{name}.{rank}.npz", iters=res.iters,
                     converged=res.converged, rnorm=res.rnorm,
                     u=res.u_fine, path=res.path, route=str(res.route),
                     dist=[lv.dist is not None for lv in res.ctx.levels],
                     block_rows=res.u.shape[0])
            if spec.get("view"):
                (out / f"{name}.{rank}.view.txt").write_text(
                    view_solver(res.ctx))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
