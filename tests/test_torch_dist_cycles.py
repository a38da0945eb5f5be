"""Row-partition distribution of the port against the JAX package on the
CPU, part 3: the cycles and precision outers under the plan.  A 4-rank
gloo world (``_dist_worker.py``, started once for the module) solves
Additive, Additive2, mg-FGMRES, the mixed-precision outer (f32 V-cycle,
f64 outer) to 1e-8, mg-CG with an f64 and with a bf16 preconditioner,
and a checkpoint of a partial solve resumed under the plan; each is held
to JAX's 4-device row-plan solve of the same config (129^2, 4 levels,
``min_local=8``, ``backend="pallas"``: its dist kernels in interpret
mode), and to JAX's level split (``plan.spec(ny, nx)[0] == "y"``: the
levels its plan shards, through its dist kernels or through GSPMD).

Tolerances (``TOLS``), every rank's results identical: the f64 runs as
parts 1 and 2 (iterations equal, rnorm rtol 1e-6 / atol 1e-9, u_fine
rtol 1e-6 / atol 1e-12); the runs over f32 levels as
test_torch_precision.py holds the mixed outer against JAX (torch and XLA
round the f32 V-cycle differently): iterations equal, the normalized
history to 1e-6 entry by entry, the solution to 1e-6 (the f64 outer) or
1e-4 (an f32 solution) of max|u|.  The bf16-preconditioned run is held
by convergence (within one iteration of JAX's) and its solution (1e-3 of
max|u|), as ROADMAP's Queue 3 holds bf16 runs: the two packages round
bf16 at other places.  A solve's all-gathers inside its iterations are
only onto the replicated levels ("agglomerate"), never of a sharded
level's own rows.
"""

from __future__ import annotations

import json

import jax
import numpy as np
import pytest
import torch

import _dist_worker as dw
from multigrid_petsc_tpu.parallel.device_mesh import row_plan as j_row_plan
from multigrid_petsc_tpu.solvers.solve import solve as j_solve
from multigrid_petsc_tpu.utils.config import CycleType as JCT
from multigrid_petsc_tpu.utils.config import SmootherType as JST
from multigrid_petsc_tpu.utils.config import SolverConfig as JC

torch.set_num_threads(2)

BASE = dict(npts=129, grids=4, levels=4)
FORCED = dict(rtol=1e-30, divtol=1e30)
# name -> SolverConfig fields (every one under min_local=8); the f32
# runs' solution tolerance.
CONFIGS = {
    "ADDITIVE": dict(BASE, cycle=9, max_iter=8, **FORCED),
    "ADDITIVE2": dict(npts=129, grids=2, levels=2, cycle=10, max_iter=8,
                      **FORCED),
    "MGFGMRES": dict(BASE, cycle=102, max_iter=3),
    # 5 levels: the f64 history crosses 1e-8 by a factor of 2.6 above
    # and 14 below (at 4 levels its 4th entry sits at 0.99e-8, where
    # the two packages' f32 V-cycles may land on either side).
    "MIXED": dict(npts=129, grids=5, levels=5, cycle=101, dtype="float32",
                  outer_dtype="float64", rtol=1e-8, max_iter=30),
    "PRECOND_F64": dict(BASE, cycle=101, dtype="float32",
                        precond_dtype="float64", rtol=1e-5, max_iter=30),
    "PRECOND_BF16": dict(BASE, cycle=101, dtype="float32",
                         precond_dtype="bfloat16", rtol=1e-5, max_iter=30),
}
# name -> (history tolerance, solution tolerance relative to max|u|,
# iterations slack).
F64_TOL = (dict(rtol=1e-6, atol=1e-9), None, 0)
TOLS = {"MIXED": (dict(rtol=0.0, atol=1e-6), 1e-6, 0),
        "PRECOND_F64": (dict(rtol=0.0, atol=1e-6), 1e-4, 0),
        "PRECOND_BF16": (None, 1e-3, 1)}


def jax_config(fields: dict) -> JC:
    f = dict(fields)
    f["cycle"] = JCT(f["cycle"])
    for k in ("smoother", "fine_smoother"):
        if k in f:
            f[k] = JST(f[k])
    for k in ("v", "aniso"):
        if k in f:
            f[k] = tuple(f[k])
    return JC(backend="pallas", **f)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The module's 4-rank gloo world, started with the module's first
    test, so the ranks solve while the JAX references run."""
    out = tmp_path_factory.mktemp("dist_cycles")
    jobs = {name: {"cfg": f, "min_local": 8} for name, f in CONFIGS.items()}
    jobs["CHECKPOINT"] = {"cfg": dict(BASE, cycle=101, max_iter=60),
                          "min_local": 8, "checkpoint": True}
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


@pytest.fixture(scope="module")
def jax_refs(world):
    """JAX's 4-device row-plan solves of CONFIGS and of the checkpoint's
    config (the world runs meanwhile)."""
    plan = j_row_plan(devices=jax.devices()[:dw.WORLD], min_local=8)
    refs = {name: j_solve(jax_config(f), plan=plan)
            for name, f in CONFIGS.items()}
    refs["CHECKPOINT"] = j_solve(jax_config(dict(BASE, cycle=101,
                                                 max_iter=60)), plan=plan)
    return refs


def sharded_levels(ref) -> list:
    """The levels JAX's plan shards (its dist kernels' or GSPMD's)."""
    plan = j_row_plan(devices=jax.devices()[:dw.WORLD], min_local=8)
    return [plan.spec(lv.spec.primary.ny, lv.spec.primary.nx)[0] == "y"
            for lv in ref.ctx.levels]


def check_ranks(runs) -> dict:
    r0 = runs[0]
    for r in runs[1:]:
        assert int(r["iters"]) == int(r0["iters"])
        np.testing.assert_array_equal(r["rnorm"], r0["rnorm"])
        np.testing.assert_array_equal(r["u"], r0["u"])
    assert str(r0["path"]) == "torch"
    gathers = json.loads(str(r0["gathers"]))
    assert set(gathers) <= {"agglomerate"}, gathers
    return r0


@pytest.mark.parametrize("name", list(CONFIGS))
def test_cycle_matches_jax_dist(world, jax_refs, name):
    ref = jax_refs[name]
    r0 = check_ranks(dw.load(world(), name))
    assert list(r0["dist"]) == sharded_levels(ref)
    assert any(r0["dist"]), "no level ran sharded"
    assert bool(r0["converged"]) == bool(ref.converged)
    hist_tol, u_tol, slack = TOLS.get(name, F64_TOL)
    assert abs(int(r0["iters"]) - int(ref.iters)) <= slack
    if hist_tol is not None:
        np.testing.assert_allclose(r0["rnorm"], ref.rnorm, **hist_tol)
    u_ref = np.asarray(ref.u_fine, np.float64)
    if u_tol is None:
        np.testing.assert_allclose(r0["u"], u_ref, rtol=1e-6, atol=1e-12)
    else:
        np.testing.assert_allclose(r0["u"], u_ref, rtol=0.0,
                                   atol=u_tol * np.abs(u_ref).max())


def test_mixed_outer_certifies_under_plan(world, jax_refs):
    """The mixed outer's last history entry is its f64 residual: below
    1e-8, as JAX's."""
    r0 = check_ranks(dw.load(world(), "MIXED"))
    assert bool(r0["converged"]) and float(r0["rnorm"][-1]) <= 1e-8
    assert float(jax_refs["MIXED"].rnorm[-1]) <= 1e-8


def test_checkpoint_round_trip_under_plan(world, jax_refs):
    """3 iterations, saved under the plan (rank 0 writes the gathered
    grid), loaded as each rank's block and resumed: the file holds the
    partial solve's whole grid, each rank's block is its rows of it (the
    last rank's pad row 0), and the resumed solve converges to JAX's
    solution (to the warm start's tolerance, JAX's own test's)."""
    runs = dw.load(world(), "CHECKPOINT")
    r0 = runs[0]
    np.testing.assert_array_equal(r0["saved"], r0["part_u"])
    assert int(r0["part_iters"]) == 3
    R = (r0["saved"].shape[0] + 1) // dw.WORLD
    for rank, r in enumerate(runs):
        want = np.zeros((R, r0["saved"].shape[1]))
        rows = r0["saved"][rank * R:(rank + 1) * R]
        want[:rows.shape[0]] = rows
        np.testing.assert_array_equal(r["block"], want)
        np.testing.assert_array_equal(r["u"], r0["u"])
    assert bool(r0["converged"])
    np.testing.assert_allclose(r0["u"], jax_refs["CHECKPOINT"].u_fine,
                               rtol=1e-5, atol=1e-11)
