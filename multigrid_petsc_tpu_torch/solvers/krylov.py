"""Krylov outers with one V-cycle as the preconditioner: PCG (mg-CG),
the mixed-precision PCG (f64 outer over the working-dtype V-cycle) and
flexible GMRES (mg-FGMRES).  PyTorch counterpart of ``solve_mgcg``,
``_mg_precond``, ``build_coarse_tree``, ``mdma_plan``,
``_solve_mgcg_fused_mdma``, ``_solve_mgcg_fused``,
``outer_precision_operator``, ``solve_mgcg_mixed`` and ``solve_mgfgmres``
in ``multigrid_petsc_tpu/solvers/krylov.py``; reference analogue: the PCMG
cross-check path, src/solver.c:1884-1989.

mg-CG takes one of three routes (``mgcg_route``), recorded as
``ctx.route``, the JAX package's ``ctx.solver_path``:

  "mdma"     K1 + K2a + K3, the coarse tree (K4) below: two or more
             levels, level 0 matrix-free 5-point point-smoothed
             (``point5``), f32 or bf16 levels (JAX's rule:
             ``mdma_viable`` takes the storage type), no
             reduced-precision preconditioner, and every visit inside
             the JAX manual-DMA kernels' sweep envelope
             (``max_sweeps + 2 <= MDMA_HALO``);
  "fused"    K11 + K10 + K3 at level 0 and the per-level visits below (no
             coarse tree): the same, past the sweep envelope;
  "generic"  the plain PCG loop over the level operations: everything
             else (64-bit levels, ``precond_dtype``, the 9-point, line,
             sparse and merged levels).

The bf16 working dtype's rounding points (the JAX kernels' bf16
branches; bf16 is storage only):
  * every kernel and its plain version (``mdma_kernel.at_stores``)
    upcasts its bf16 inputs exactly, computes in f32 and rounds each
    array output once, where it stores it: K1's p', A p' and u', K2a /
    K10's u0, rc and r', K3's z, K4's result, K11's p' and A p', the
    V-cycle family's and the 9-point visits';
  * dots come out in f32 (the kernels' per-block partials, summed in
    f32; ``ops.norms.tree_dot`` and ``LevelCtx.vnorm`` upcast bf16
    operands), so rz, pap, alpha, beta, ||r|| and the history are f32 on
    every route; a vector update by an f32 scalar outside a kernel (the
    generic loop's u, r and p, the lagged u's flush, the fused route's
    u) runs as PyTorch ops on the bf16 tensors, each rounding its result;
  * K4's coarsest inverse is rounded to bf16 before use and applied in
    f32 (JAX coarse_tree_kernel.py:194); the V-cycle's coarsest direct
    solve multiplies by the inverse stored in bf16, its sums in f32;
  * FGMRES keeps its basis V and Z in bf16 and the small least-squares
    problem (the Hessenberg column, Givens rotations, the triangular
    solve) in f32; u + Z^T y is formed in f32 and rounded once.

The route depends on the configuration only, never on the device, so the
CPU tests and the card take the same one.  Two TPU-only conditions of the
JAX decision do not come over: the ny < 256 cutoff and the mdma tile
geometry; the port's kernels have neither.  The sweep envelope is kept so
the routes compare with JAX's call for call (ROADMAP: kept for parity).

``outer_dtype="float32x2"`` (JAX's double-single outer, which exists
because the TPU only emulates f64) runs as the native f64 outer here: the
H100 has FP64.

Under a plan every inner product and norm goes through level 0
(``LevelCtx.dot`` / ``norm2``: summed over the ranks, the same value on
every rank), so FGMRES's Hessenberg and Givens scalars and every stop
test agree across the ranks; the mixed outer's f64 operator is K17's
f64 instantiation on the rank's block, its right-hand side the rank's
rows.

The standard PCG formulas hold verbatim for the negative-definite
discrete Laplacian (both inner products flip sign, ratios stay positive).
The loops run on the host; scalars (alpha, beta, the inner products,
||r||, FGMRES's Hessenberg column and Givens rotations) stay tensors on
the device, which the kernels read by pointer, so the only host read per
iteration (FGMRES: per restart block) is the stop test.
"""

from __future__ import annotations

import numpy as np
import torch

from multigrid_petsc_tpu_torch.mesh import MeshType
from multigrid_petsc_tpu_torch.ops.cuda import coarse_tree_kernel as ctk
from multigrid_petsc_tpu_torch.ops.cuda import mdma_kernel as mdma
from multigrid_petsc_tpu_torch.ops.cuda import stencil9_kernel as sk9
from multigrid_petsc_tpu_torch.ops.cuda import stencil_kernel as sk
from multigrid_petsc_tpu_torch.ops.norms import (
    flatten,
    tree_map,
    tree_norm2,
    unflatten,
)
from multigrid_petsc_tpu_torch.problems import (
    stencil9_coefficients,
    stencil_coefficients,
)
from multigrid_petsc_tpu_torch.solvers.coarse import dense_from_stencil
from multigrid_petsc_tpu_torch.solvers.context import MGContext, rhs_grid_of
from multigrid_petsc_tpu_torch.solvers.outer import OuterResult, keep_going
from multigrid_petsc_tpu_torch.solvers.vcycle import (
    _cycle,
    _visit_sweeps,
    mg_apply,
    mg_apply_cgdown,
    mg_apply_dot,
)

# The JAX manual-DMA kernels' fixed halo rows (mdma_kernel.py:70): a visit
# fits them when sweeps + 2 <= MDMA_HALO.  Kept for parity with JAX's
# routing; the port's visit kernels have no such cap.
MDMA_HALO = 8


def mgcg_route(ctx: MGContext) -> str:
    """The mg-CG route of ``ctx`` ("mdma", "fused" or "generic"; see the
    module docstring).  A row-sharded level 0 takes the generic route, as
    JAX excludes its fused routes there (krylov.py:156,228)."""
    if (len(ctx.levels) < 2 or not ctx.levels[0].point5
            or ctx.dtype not in (torch.float32, torch.bfloat16)
            or ctx.precond_ctx is not None
            or ctx.levels[0].dist is not None):
        return "generic"
    return "mdma" if ctx.config.max_sweeps + 2 <= MDMA_HALO else "fused"


def mg_precond(ctx: MGContext, v0: int, v1: int):
    """The V-cycle preconditioner r -> M r, through the reduced-precision
    context when cfg.precond_dtype is set: r is cast to its type, and M r
    back to r's (JAX krylov.py:29-43)."""
    pctx = ctx.precond_ctx
    if pctx is None:
        return lambda r: mg_apply(ctx, r, v0, v1)

    def precond(r):
        z = mg_apply(pctx, tree_map(lambda x: x.to(pctx.dtype), r), v0, v1)
        return tree_map(lambda x, r0: x.to(r0.dtype), z, r)

    return precond


def solve_mgcg(ctx: MGContext, b0: torch.Tensor | None = None) -> OuterResult:
    """mg-CG on the route ``mgcg_route`` picks (recorded as
    ``ctx.route``): the mdma plan (``_solve_mgcg_fused_mdma``), the fused
    CG kernels (``_solve_mgcg_fused``) or the generic PCG loop (A p
    through K6, K12 or the level's assembled operator, the V-cycle
    through the levels' visits), as the JAX package routes them."""
    b = ctx.b0 if b0 is None else b0
    ctx.route = mgcg_route(ctx)
    if ctx.route == "mdma":
        return _solve_mgcg_fused_mdma(ctx, b)
    if ctx.route == "fused":
        return _solve_mgcg_fused(ctx, b)
    return _solve_mgcg_generic(ctx, b)


def _solve_mgcg_generic(ctx: MGContext, b: torch.Tensor) -> OuterResult:
    cfg = ctx.config
    v0, v1 = cfg.v
    lvl0 = ctx.levels[0]
    hist_len = cfg.hist_len
    precond = mg_precond(ctx, v0, v1)
    # A reduced-precision preconditioner is only approximately fixed and
    # symmetric; the flexible Polak-Ribiere beta <z, r - r_prev> /
    # <z_prev, r_prev> tolerates that (JAX krylov.py:81-86).
    flexible = ctx.precond_ctx is not None
    # Reductions through the level: over every rank when it is sharded.
    dot, norm = lvl0.dot, lvl0.norm2
    bnorm = float(norm(b))
    u = lvl0.zeros()
    r = lvl0.residual(b, u)
    rn = norm(r)
    z = precond(r)
    p = z
    rz = dot(r, z)
    zero = torch.zeros((), dtype=rz.dtype, device=rz.device)
    hist = torch.zeros(hist_len + 1, dtype=rn.dtype, device=rn.device)
    hist[0] = rn
    i = 0
    while keep_going(cfg, i, float(rn), bnorm):
        ap = lvl0.apply(p)
        # Breakdown guards: once the f32 residual floors, pap/rz can hit
        # exact 0; guarded ratios turn that into a harmless stall.
        pap = dot(p, ap)
        alpha = torch.where(pap != 0, rz / pap, zero)
        u = tree_map(lambda uk, pk: uk + alpha * pk, u, p)
        r_prev = r
        r = tree_map(lambda rk, ak: rk - alpha * ak, r, ap)
        rn = norm(r)
        z = precond(r)
        rz_new = dot(r, z)
        if flexible:
            beta = torch.where(
                rz != 0, torch.clamp((rz_new - dot(r_prev, z)) / rz,
                                     min=0.0), zero)
        else:
            beta = torch.where(rz != 0, rz_new / rz, zero)
        p = tree_map(lambda zk, pk: zk + beta * pk, z, p)
        rz = rz_new
        hist[min(i + 1, hist_len)] = rn
        i += 1
    return OuterResult(u=u, rnorm_history=hist / hist[0], iters=i,
                       converged=float(rn) <= cfg.rtol * bnorm)


def _solve_mgcg_fused(ctx: MGContext, b: torch.Tensor) -> OuterResult:
    """PCG over the fused CG kernels (JAX krylov.py:403-467):
    algebraically the generic loop, with the direction step, A p' and
    <p', A p'> in one kernel (K11), the CG residual update and ||r'||
    folded into the level-0 down visit (K10) and <r', z> emitted by the
    level-0 up visit.  Differences from the generic path are reduction
    order only."""
    cfg = ctx.config
    v0, v1 = cfg.v
    lvl0 = ctx.levels[0]
    hist_len = cfg.hist_len
    bnorm_t = tree_norm2(b)
    bnorm = float(bnorm_t)
    r = b  # u0 = 0 -> r0 = b exactly
    z, rz = mg_apply_dot(ctx, r, v0, v1)
    u = torch.zeros_like(b)
    p = torch.zeros_like(b)  # papply with beta = 0 ignores its value
    # Scalars and history in the dots' type (f32 for bf16 storage).
    zero = torch.zeros((), dtype=rz.dtype, device=rz.device)
    beta = zero
    hist = torch.zeros(hist_len + 1, dtype=rz.dtype, device=b.device)
    hist[0] = bnorm_t
    rn = bnorm
    i = 0
    while keep_going(cfg, i, rn, bnorm):
        p, ap, pap = lvl0.papply(z, p, beta)
        alpha = torch.where(pap != 0, rz / pap, zero)  # breakdown guard
        u = u + alpha * p
        z, rz_new, r, rn2 = mg_apply_cgdown(ctx, r, ap, alpha, v0, v1)
        rn_t = torch.sqrt(rn2)
        beta = torch.where(rz != 0, rz_new / rz, zero)
        hist[min(i + 1, hist_len)] = rn_t
        rz = rz_new
        i += 1
        rn = float(rn_t)  # the stop test: the one host read per iteration
    return OuterResult(u=u, rnorm_history=hist / hist[0], iters=i,
                       converged=rn <= cfg.rtol * bnorm)


def build_coarse_tree(ctx: MGContext):
    """(start_level, solver) for the single-launch coarse-tree kernel, or
    None: the earliest level from which every remaining level passes
    ``coarse_tree_viable`` (the JAX package's rule, so the split matches
    it call for call: level 3 at 8193^2/11 levels, level 1 at 513^2/7)."""
    cfg = ctx.config
    v0, v1 = cfg.v
    L = len(ctx.levels)
    itemsize = torch.empty((), dtype=ctx.dtype).element_size()
    for l_t in range(1, L - 1):
        lv = ctx.levels[l_t:]
        shapes = [l.shape for l in lv]
        if not all(l.point5 for l in lv):
            continue  # the tree runs 5-point point smoothers only
        if not ctk.coarse_tree_viable(shapes, itemsize):
            continue
        steps_list = [l.steps_fn(_visit_sweeps(ctx, l_t + j, v0, v1))
                      for j, l in enumerate(lv)]
        a_inv = None
        if lv[-1].coarse_solve is not None:
            if not ctk.coarse_tree_viable(shapes, itemsize, direct=True):
                continue  # coarsest too large for the in-kernel dense solve
            a_inv = np.linalg.inv(dense_from_stencil(lv[-1].stencil,
                                                     *shapes[-1]))
        fn = ctk.make_coarse_tree_solver([l.stencil for l in lv], shapes,
                                         steps_list, a_inv=a_inv)
        return l_t, fn
    return None


def mdma_plan(ctx: MGContext) -> dict:
    """The fused solve's data plan as named closures.

    ``precond(r, ap, alpha)`` = (z, <r', z>, r', ||r'||^2) with
    r' = r - alpha ap and z = M r': level 0 runs the CG down visit (K2a)
    and the dot-emitting up visit (K3); levels 1.. run the zero-guess
    visits (K2b, K3) down to the coarse tree (K4), which solves the rest.
    """
    cfg = ctx.config
    v0, v1 = cfg.v
    lvl0 = ctx.levels[0]
    st = lvl0.stencil
    steps = lvl0.steps_fn(_visit_sweeps(ctx, 0, v0, v1))
    tree = build_coarse_tree(ctx)

    def coarse_correction(rc):
        """Everything between the level-0 down and up visits."""
        return ctx.prolong_half(
            0, _cycle(ctx, 1, ctx.restrict_rc1(0, rc), None, v0, v1,
                      tree=tree))

    def precond(r, ap, alpha):
        u0, rc, r_new, rn2 = mdma.cg_visit_down(st, r, ap, alpha, steps)
        z, rz = mdma.visit_up(st, r_new, u0, coarse_correction(rc), steps,
                              emit_dot=True)
        return z, rz, r_new, rn2

    return {"precond": precond, "coarse_correction": coarse_correction}


def _solve_mgcg_fused_mdma(ctx: MGContext, b: torch.Tensor) -> OuterResult:
    """PCG over the fused visit kernels.  Algebraically identical to the
    generic loop: the CG residual update rides the level-0 down visit,
    the preconditioner inner product the level-0 up visit, and the
    solution update u += alpha p rides the NEXT iteration's direction
    kernel with the lagged alpha (flushed once after the loop).
    Differences from the generic path are reduction order only."""
    cfg = ctx.config
    st = ctx.levels[0].stencil
    hist_len = cfg.hist_len
    precond = mdma_plan(ctx)["precond"]

    bnorm_t = tree_norm2(b)
    bnorm = float(bnorm_t)
    # Scalars and history in the kernels' dot type (f32 for bf16 storage).
    sdt = mdma.compute_dtype(b.dtype)
    zero = torch.zeros((), dtype=sdt, device=b.device)
    z, rz, r, _ = precond(b, torch.zeros_like(b), zero)
    u = torch.zeros_like(b)
    p = torch.zeros_like(b)
    beta = alpha_prev = zero
    hist = torch.zeros(hist_len + 1, dtype=sdt, device=b.device)
    hist[0] = bnorm_t  # u0 = 0 -> r0 = b exactly
    rn = bnorm
    i = 0
    while keep_going(cfg, i, rn, bnorm):
        p, ap, u, pap = mdma.cg_papply_u(st, z, p, u, alpha_prev, beta)
        alpha = torch.where(pap != 0, rz / pap, zero)  # breakdown guard
        z, rz_new, r, rn2 = precond(r, ap, alpha)
        rn_t = torch.sqrt(rn2)
        beta = torch.where(rz != 0, rz_new / rz, zero)
        hist[min(i + 1, hist_len)] = rn_t
        rz, alpha_prev = rz_new, alpha
        i += 1
        rn = float(rn_t)  # the stop test: the one host read per iteration
    # Flush the lagged update: the last alpha was never applied in-loop.
    u = u + alpha_prev * p
    return OuterResult(u=u, rnorm_history=hist / hist[0], iters=i,
                       converged=rn <= cfg.rtol * bnorm)


def solve_mgfgmres(ctx: MGContext, b0: torch.Tensor | None = None,
                   restart: int | None = None) -> OuterResult:
    """Flexible GMRES(restart) with one V-cycle as the right
    preconditioner, as the JAX package runs it: modified Gram-Schmidt,
    incremental Givens rotations, a guarded back-substitution, and one
    history entry (the true residual) per restart block.  Every block
    runs its ``restart`` Arnoldi steps.  The small dense algebra (the
    Hessenberg column, rotations, the triangular solve, u += Z^T y) runs
    as torch ops on the level's device, as JAX leaves it to XLA; for bf16
    storage in f32 (the basis stays bf16; u + Z^T y is formed in f32 and
    rounded once)."""
    cfg = ctx.config
    v0, v1 = cfg.v
    lvl0 = ctx.levels[0]
    m = restart if restart is not None else cfg.fgmres_restart
    b = flatten(ctx.b0 if b0 is None else b0)
    shapes = lvl0.state_shapes
    dot, norm = lvl0.dot, lvl0.vnorm
    hist_len = cfg.hist_len
    dtype, device = b.dtype, b.device
    sdt = mdma.compute_dtype(dtype)  # the small problem's type

    def apply_flat(x):
        return flatten(lvl0.apply(unflatten(x, shapes)))

    precond = mg_precond(ctx, v0, v1)

    def precond_flat(r):
        return flatten(precond(unflatten(r, shapes)))

    def restart_block(u):
        r = b - apply_flat(u)
        beta = norm(r)
        V = torch.zeros((m + 1, b.numel()), dtype=dtype, device=device)
        V[0] = r / torch.where(beta > 0, beta, 1.0)
        Z = torch.zeros((m, b.numel()), dtype=dtype, device=device)
        R = torch.zeros((m, m), dtype=sdt, device=device)
        cs = torch.zeros(m, dtype=sdt, device=device)
        sn = torch.zeros(m, dtype=sdt, device=device)
        g = torch.zeros(m + 1, dtype=sdt, device=device)
        g[0] = beta
        for j in range(m):
            zj = precond_flat(V[j])
            w = apply_flat(zj)
            hcol = torch.zeros(m + 1, dtype=sdt, device=device)
            for i in range(j + 1):  # modified Gram-Schmidt
                hij = dot(V[i], w)
                w = w - hij * V[i]
                hcol[i] = hij
            hj1 = norm(w)
            hcol[j + 1] = hj1
            V[j + 1] = w / torch.where(hj1 > 0, hj1, 1.0)
            Z[j] = zj
            for i in range(j):  # the previous rotations
                t1 = cs[i] * hcol[i] + sn[i] * hcol[i + 1]
                t2 = -sn[i] * hcol[i] + cs[i] * hcol[i + 1]
                hcol[i], hcol[i + 1] = t1, t2
            # The rotation that annihilates the subdiagonal entry.
            denom = torch.sqrt(hcol[j] ** 2 + hcol[j + 1] ** 2)
            c = torch.where(denom > 0, hcol[j] / denom, 1.0)
            s = torch.where(denom > 0, hcol[j + 1] / denom, 0.0)
            cs[j], sn[j] = c, s
            hcol[j] = c * hcol[j] + s * hcol[j + 1]
            R[:, j] = hcol[:m]
            g[j + 1] = -s * g[j]
            g[j] = c * g[j]
        # R y = g[:m]; a zero diagonal only on exact breakdown (converged,
        # g's tail zero too): guard the division as JAX does.
        diag = torch.diagonal(R)
        rsafe = R + torch.diag(torch.where(diag.abs() > 0, 0.0, 1.0))
        y = torch.linalg.solve_triangular(rsafe, g[:m, None], upper=True)
        if sdt == dtype:
            return u + (Z.T @ y)[:, 0]
        du = u.to(sdt)  # bf16 storage: the update in f32, rounded once
        for j in range(m):
            du = du + y[j, 0] * Z[j].to(sdt)
        return du.to(dtype)

    bnorm = float(norm(b))
    u = torch.zeros_like(b)
    rn_t = norm(b - apply_flat(u))
    hist = torch.zeros(hist_len + 1, dtype=sdt, device=device)
    hist[0] = rn_t
    rn = float(rn_t)
    i = 0
    while keep_going(cfg, i, rn, bnorm):
        u = restart_block(u)
        rn_t = norm(b - apply_flat(u))
        hist[min(i + 1, hist_len)] = rn_t
        i += 1
        rn = float(rn_t)  # the stop test: one host read per restart block
    return OuterResult(u=unflatten(u, shapes), rnorm_history=hist / hist[0],
                       iters=i, converged=rn <= cfg.rtol * bnorm)


def outer_precision_operator(ctx: MGContext, dtype: torch.dtype):
    """(apply_fn, stencil): the level-0 operator of ``ctx``'s own problem
    family in ``dtype`` on ``ctx.device`` (the mixed outer's f64 operator;
    K6 or K12 in f64 on the card, K17's "a" emit in f64 on the rank's
    block under a plan, its row block or, under the blocks layout, its
    2-D block; JAX krylov.py:470-488)."""
    cfg = ctx.config
    lvl0 = ctx.levels[0]
    ny, nx = lvl0.spec.primary.shape
    if cfg.problem == "aniso":
        st = stencil9_coefficients(ctx.problem, ny, nx, dtype, ctx.device)
    else:
        st = stencil_coefficients(MeshType(cfg.mesh), ny, nx, dtype,
                                  ctx.device)
    if lvl0.dist is not None:  # the level's own kind of block
        ops = type(lvl0.dist)(st, ny, nx, ctx.plan, cfg.max_sweeps)
        return ops.apply, ops.st
    if cfg.problem == "aniso":
        return (lambda u: sk9.apply_stencil9(st, u)), st
    return (lambda u: sk.apply_stencil5(st, u)), st


def outer_rhs(ctx: MGContext, dtype: torch.dtype) -> torch.Tensor:
    """The level-0 right-hand side evaluated in ``dtype``: the mixed
    outer's b (an f32 b upcast would bake eps32 * ||b|| into the
    certified residual); under a plan the rank's block of it."""
    lvl0 = ctx.levels[0]
    ny, nx = lvl0.spec.primary.shape
    b = rhs_grid_of(ctx.config, ctx.problem, ny, nx, dtype, ctx.device)
    return b if lvl0.dist is None else lvl0.dist.block_of(b)


def true_relative_residual(ctx: MGContext, u: torch.Tensor) -> float:
    """||b - A u|| / ||b|| in f64 (b and A evaluated in f64): the
    certification oracle of the reduced-precision solves.  Under a plan
    ``u`` is the rank's block (``SolveResult.u``, its real rows and
    columns) and the norms are summed over the ranks (a collective)."""
    lvl0 = ctx.levels[0]
    apply64, _ = outer_precision_operator(ctx, torch.float64)
    b = outer_rhs(ctx, torch.float64)
    u = u.to(torch.float64)
    # The block's pad row and column (the last mesh row's, column's) back.
    u = torch.nn.functional.pad(u, (0, b.shape[1] - u.shape[1], 0,
                                    b.shape[0] - u.shape[0]))
    r = b - apply64(u)
    return float(lvl0.vnorm(r) / lvl0.vnorm(b))


def solve_mgcg_mixed(ctx: MGContext, b0: torch.Tensor,
                     u0: torch.Tensor | None = None) -> OuterResult:
    """Mixed-precision mg-CG (JAX krylov.py:594-685): the CG iteration
    (operator applies, vector updates, inner products) in f64, the
    V-cycle preconditioner in the working dtype (or ``precond_dtype``).
    A low-precision preconditioner only shapes the rate; the attainable
    residual follows the f64 operator, so this certifies 1e-8 where f32
    alone floors.  ``b0`` must be evaluated in f64 (``outer_rhs``);
    ``u0`` warm-starts the iteration.  ``outer_dtype="float32x2"`` runs
    here too: the card has native FP64, so JAX's double-single emulation
    is not needed (``SolveResult.outer_dtype`` records "float64")."""
    cfg = ctx.config
    v0, v1 = cfg.v
    odt = torch.float64
    if ctx.levels[0].merged:
        raise ValueError("mixed outer: single-grid level 0 only")
    apply64, _ = outer_precision_operator(ctx, odt)
    inner = mg_precond(ctx, v0, v1)
    dot, norm = ctx.levels[0].dot, ctx.levels[0].vnorm

    def precond(r64):
        return inner(r64.to(ctx.dtype)).to(odt)

    b = b0.to(odt)
    bnorm = float(norm(b))
    hist_len = cfg.hist_len
    flexible = ctx.precond_ctx is not None  # see _solve_mgcg_generic
    u = torch.zeros_like(b) if u0 is None else u0.to(odt)
    r = b - apply64(u)
    rn = norm(r)
    z = precond(r)
    p = z
    rz = dot(r, z)
    hist = torch.zeros(hist_len + 1, dtype=odt, device=b.device)
    hist[0] = rn
    i = 0
    while keep_going(cfg, i, float(rn), bnorm):
        ap = apply64(p)
        alpha = rz / dot(p, ap)
        u = u + alpha * p
        r_new = r - alpha * ap
        rn = norm(r_new)
        z = precond(r_new)
        rz_new = dot(r_new, z)
        if flexible:
            beta = torch.clamp((rz_new - dot(r, z)) / rz, min=0.0)
        else:
            beta = rz_new / rz
        p = z + beta * p
        r, rz = r_new, rz_new
        hist[min(i + 1, hist_len)] = rn
        i += 1
    return OuterResult(u=u, rnorm_history=hist / hist[0], iters=i,
                       converged=float(rn) <= cfg.rtol * bnorm)
