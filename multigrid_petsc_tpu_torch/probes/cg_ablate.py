"""Probe ``cg_ablate``: (a) copy chains, fresh against in place; (b) the
mg-CG iteration with parts removed (counterpart of
``benchmarks/probe_cg_ablate.py``).

(a) At 8192^2 f32, chains of 4 and 20 dependent copies o = 1.0001 u,
differenced over the 16 extra copies: K18a with a fresh output each
(``scale_copy``) and KP2 in place (``scale_copy_``), the JAX probe's
``input_output_aliases`` off and on.

(b) At 8193^2 / 11 levels f32 (Poisson, v = 3, 3), one mg-CG iteration's
body in four modes, as ``probe_cg_ablate.py:104-130`` defines them:
  full      the body
  nocoarse  the levels below 0 replaced by e_c = 0.123 rc: level 0's down
            visit, then its up visit on that correction
  noupd     without the solution update
  nopapply  the direction kernel replaced by reusing z (A p := z, <p, A p>
            := <z, z> + 1), the update kept
on two bodies (``cg_step``):
  route fused  the JAX probe's body (``krylov._solve_mgcg_fused``): K11,
               u += alpha p, ``vcycle.mg_apply_cgdown`` (K10, the levels'
               visits, K3)
  route mdma   the main path's (``krylov._solve_mgcg_fused_mdma``): K1
               (with the lagged u update), ``mdma_plan``'s preconditioner
               (K2a, K2b / K3 down to the coarse tree K4, K3); noupd runs
               K11 in place of K1 (no lagged u stream), nopapply keeps the
               lagged update as a PyTorch pass, nocoarse runs K2a, e_c =
               0.123 rc, K3 on level 0 and no level below
Each row: ms per iteration, differenced between k1 = 2 and k2 = 10
iterations (median of 3 pairs), and what the removed part cost (full
less the mode).
"""

from __future__ import annotations

import torch

from multigrid_petsc_tpu_torch.ops.cuda import mdma_kernel as mdma
from multigrid_petsc_tpu_torch.ops.cuda import stencil_kernel as sk
from multigrid_petsc_tpu_torch.ops.cuda import stream_kernel as stk
from multigrid_petsc_tpu_torch.probes import (
    differenced,
    feeding,
    header,
    rate_line,
    stream_rate,
)
from multigrid_petsc_tpu_torch.solvers.context import build_context
from multigrid_petsc_tpu_torch.solvers.krylov import mdma_plan
from multigrid_petsc_tpu_torch.solvers.vcycle import (
    _visit_sweeps,
    mg_apply_cgdown,
    mg_apply_dot,
)
from multigrid_petsc_tpu_torch.utils.config import CycleType, SolverConfig

N_COPY, NPTS = 8192, 8193
MODES = ("full", "nocoarse", "noupd", "nopapply")
ROUTES = ("fused", "mdma")


def cg_start(ctx, route: str, plan=None):
    """The state before the first iteration, as the solver makes it: the
    fused route (u, r, z, p, rz, beta), the mdma route (u, r, z, p, rz,
    beta, alpha_prev; ``plan``: ``krylov.mdma_plan(ctx)``, made here where
    None)."""
    b = ctx.b0
    v0, v1 = ctx.config.v
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    if route == "fused":
        z, rz = mg_apply_dot(ctx, b, v0, v1)
        return (torch.zeros_like(b), b, z, torch.zeros_like(b), rz, zero)
    plan = plan or mdma_plan(ctx)
    z, rz, r, _ = plan["precond"](b, torch.zeros_like(b), zero)
    return (torch.zeros_like(b), r, z, torch.zeros_like(b), rz, zero, zero)


def cg_step(ctx, route: str, mode: str, plan=None):
    """One iteration's body of ``route`` in ``mode``: state -> state
    (``plan`` as ``cg_start``'s)."""
    if mode not in MODES or route not in ROUTES:
        raise ValueError(f"mode in {MODES}, route in {ROUTES}; got "
                         f"{mode!r}, {route!r}")
    lvl0 = ctx.levels[0]
    st = lvl0.stencil
    v0, v1 = ctx.config.v
    k = _visit_sweeps(ctx, 0, v0, v1)
    steps = lvl0.steps_fn(k)
    if route == "mdma":
        plan = plan or mdma_plan(ctx)

    def guard(num, den):
        return torch.where(den != 0, num / den, torch.zeros_like(num))

    def fused(state):
        u, r, z, p, rz, beta = state
        if mode == "nopapply":
            p0, ap, pap = p, z, torch.sum(z * z) + 1.0
        else:
            p0, ap, pap = lvl0.papply(z, p, beta)
        alpha = guard(rz, pap)
        if mode != "noupd":
            u = u + alpha * p0
        if mode == "nocoarse":
            u0, rc, r_new, _ = lvl0.cg_visit_down(r, ap, alpha, k)
            z, rz_new = lvl0.visit_up_dot(r_new, u0, rc * 0.123, k)
        else:
            z, rz_new, r_new, _ = mg_apply_cgdown(ctx, r, ap, alpha, v0, v1)
        return (u, r_new, z, p0, rz_new, guard(rz_new, rz))

    def main_path(state):
        u, r, z, p, rz, beta, alpha_prev = state
        if mode == "noupd":
            p, ap, pap = sk.cg_papply(st, z, p, beta)
        elif mode == "nopapply":
            ap, pap = z, torch.sum(z * z) + 1.0
            u = u + alpha_prev * p
        else:  # full, nocoarse
            p, ap, u, pap = mdma.cg_papply_u(st, z, p, u, alpha_prev, beta)
        alpha = guard(rz, pap)
        if mode == "nocoarse":
            u0, rc, r_new, _ = mdma.cg_visit_down(st, r, ap, alpha, steps)
            z, rz_new = mdma.visit_up(st, r_new, u0, rc * 0.123, steps,
                                      emit_dot=True)
        else:
            z, rz_new, r_new, _ = plan["precond"](r, ap, alpha)
        return (u, r_new, z, p, rz_new, guard(rz_new, rz), alpha)

    return fused if route == "fused" else main_path


def run(device="cuda", n: int | None = None, quick: bool = False):
    """(a) at n^2 (default 8192^2), (b) at npts^2: npts the grid size
    2^m + 1 next above n (default 8193), the levels down to a 7^2
    coarsest grid (8193^2: 11)."""
    device = torch.device(device)
    n_copy = n or N_COPY
    npts = 2 ** (n_copy - 1).bit_length() + 1 if n else NPTS
    levels = (npts - 1).bit_length() - 3
    k1, k2, pairs = (1, 2, 1) if quick else (2, 10, 3)
    rate = stream_rate(device)
    header("cg_ablate", device, rate,
           "(a) chain: ms per copy (GB/s vs 2 n^2 4 B, share of K18a's "
           "rate); (b) route mode: ms per iteration | the removed part",
           n_copy=n_copy, npts=npts, levels=levels, k1=k1, k2=k2,
           pairs=pairs)
    rows = []
    x = torch.ones((n_copy, n_copy), device=device)
    nbytes = 2 * 4 * n_copy * n_copy
    d1, d2 = (1, 2) if quick else (4, 20)
    fresh = feeding(lambda v: stk.scale_copy(v, 1.0001), x)
    for alias, step in ((False, fresh),
                        (True, lambda: stk.scale_copy_(x, 1.0001))):
        s = differenced(step, d1, d2, device, pairs)
        rows.append({"part": "a", "alias": alias, "ms": 1e3 * s,
                     "GBps": nbytes / s / 1e9})
        print(rate_line(f"(a) straight-line copy, alias={alias}", s, nbytes,
                        rate), flush=True)
    del x, fresh
    cfg = SolverConfig(npts=npts, grids=levels, levels=levels,
                       cycle=CycleType.MGCG, dtype="float32")
    ctx = build_context(cfg, device=device)
    plan = mdma_plan(ctx)
    for route in ROUTES:
        full = None
        start = cg_start(ctx, route, plan)
        for mode in MODES:
            body = cg_step(ctx, route, mode, plan)
            box = [start]

            def one(body=body, box=box):
                box[0] = body(box[0])

            def reset(box=box):
                box[0] = start

            s = differenced(one, k1, k2, device, pairs, reset)
            full = s if mode == "full" else full
            rows.append({"part": "b", "route": route, "mode": mode,
                         "ms": 1e3 * s})
            print(f"(b) cg body {route:5s} {mode:9s}: {1e3 * s:.4f} ms per "
                  f"iteration | removed part "
                  + ("-" if mode == "full"
                     else f"{1e3 * (full - s):.4f} ms"), flush=True)
    return rows
