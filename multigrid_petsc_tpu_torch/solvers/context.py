"""Solver setup: the per-level operator context built from a config.

PyTorch counterpart of ``multigrid_petsc_tpu/solvers/context.py``
(reference: src/poisson.c:85-118 set-up + assembly): stencil
coefficients per grid (the 5-point Poisson family or the 9-point
anisotropic one), the level operator (matrix-free, or assembled with
``backend="sparse"``), each level's smoother (Jacobi or Chebyshev, with
its lmax and step schedule, red-black Gauss-Seidel, y-, x- or
alternating line Jacobi, or block Gauss-Seidel on a merged level), the
level visits, the inter-level transfers and the coarsest solve (direct
or CG).

A level is single-grid (its state one (ny, nx) tensor) or, the last level
when ``grids > levels``, merged: several grids in one coupled system (its
state a tuple of per-grid tensors, finest first).  The JAX package
routes each level through a web of flags (``use_pallas_apply``,
``mdma_ok``, ``papply``...).  Here a single-grid matrix-free level has
one dispatch, on the tensor's device, inside the kernel wrappers of
``ops.cuda``: CPU tensors run the plain PyTorch versions, CUDA tensors
the hand-written kernels, so every level operation on the card launches
one.  Sparse and merged levels take the JAX package's generic route:
operator applications (K8, K16 or the ELL gather for an assembled one;
K6 per grid for a merged matrix-free one), smoothers over them, and
visits composed of smooth, residual and transfer.  So do the levels
whose smoother has no fused visit kernel (RBGS, LINE_X, LINE_XY; JAX
runs them as XLA ops): their smoothers run over the level's residual and
line kernels (``residual5``, K15), and they take no Jacobi schedule, no
mg-CG kernel route and no coarse tree (``LevelCtx.point5``).

Precision: the working ``dtype`` is f32, f64 (64-bit levels run the
kernels' f64 instantiations on the card) or bf16 (storage only: every
kernel and plain version computes in f32 and rounds once where it
stores; dots and the Krylov scalars are f32; one card, a single grid per
level, every smoother, matrix-free or sparse; ``_BF16_REFUSALS``).  A
bf16 level's line smoothers run K15 on the f32 upcast of its line
stencil with f32 factors (``line_kernel.line_stencil``); RBGS's
half-sweep is ``residual5`` (r rounded once) and one ``torch.addcmul``
with the colour's masked D^-1 in bf16 (u rounded once: addcmul computes
u + d r in f32 on bf16 tensors, on the CPU and the card); the composed
visits' transfers (``restrict_fw`` after the residual, ``prolong_bilinear``
and the add before smoothing) are PyTorch ops on the bf16 tensors, each
rounding its result, the generic route's rule (``solvers/krylov.py``);
``precond_dtype`` builds a second context, ``precond_ctx``, whose levels
carry the Krylov outers' V-cycle preconditioner in that type, as the JAX
package does.  What is not ported raises ``NotImplementedError`` naming
its ROADMAP item.

Distribution (``plan=``, a ``parallel.ShardingPlan`` over a
``torch.distributed`` group; JAX context.py:350-414, 945-961): each rank
builds the whole hierarchy.  A level the plan shards runs on this rank's
block through ``LevelCtx.dist`` (K17, one pad row: ``pad_rows``): under
the rows layout (``-map 2``) its row block (``parallel.DistLevelOps``),
under the 2-D blocks layout (``-map 0/1``) its block of the (my, mx) rank
mesh (``parallel.BlockLevelOps``, K17's 2-D block mode, a pad row and a
pad column along each split axis); the others are replicated, every rank
holding them whole.  A level the plan shards stays sharded whatever its
smoother (JAX shards it too, through GSPMD where its dist kernels do not
take it): point smoothers run K17 visits (in pieces where the block is
too small for the halo); RBGS, the line smoothers and non-separable
9-point coefficients run on the block as well (``DistLevelOps``,
``BlockLevelOps``: the y-lines across the ranks of the mesh column, the
x-lines across the mesh row, on K15's rank-spanning mode).  Reductions
go through the level (``LevelCtx.dot``): a sharded level's are summed
over the ranks that hold distinct blocks, a replicated level's are not.
The level transitions: sharded -> sharded, the visits' rc block IS the
coarse block and the whole transfers are block-local; to a level split
along fewer axes (or replicated), the rc blocks are all-gathered along
the axes that stop being split; the up visit cuts its block of a coarse
correction held whole along an axis.  Inside a cycle nothing else is
gathered but the lines' carries and a sharded coarsest level that JAX
solves directly (``parallel.halo.gathers``).  A merged level is split
grid by grid, each grid along the axes the plan splits it on, as JAX
splits it (``ShardingPlan.shards`` / ``split``): its operator set
(``LevelCtx.grid_ops``, ``parallel.DistMergedOps``) runs each sharded
grid on its block through K17 (under the rows layout its row block, under
the blocks layout its 2-D block) and each replicated grid whole through
K6 and K7, its couplings one transfer gap at a time in each grid's layout
(block-local between two sharded sizes), and its inner product sums each
sharded grid's dots over the ranks that hold its distinct blocks and adds
the replicated grids' once.  Every cycle, the merged-grid ones included,
every smoother and both precision outers run under either layout (the
preconditioner context under the same plan), on any rank count (the
blocks layout cuts an axis the ranks do not divide into nested even
blocks of unequal size, ``ShardingPlan.extents``).  The sparse backend
raises under any plan.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable

import torch

from multigrid_petsc_tpu_torch.hierarchy import LevelSpec, build_hierarchy
from multigrid_petsc_tpu_torch.mesh import MeshType
from multigrid_petsc_tpu_torch.ops.cuda import line_kernel as lk
from multigrid_petsc_tpu_torch.ops.cuda import stencil9_kernel as sk9
from multigrid_petsc_tpu_torch.ops.cuda import stencil_kernel as sk
from multigrid_petsc_tpu_torch.ops.composite import (
    GridOps,
    composite_apply,
    composite_residual,
    composite_rhs,
)
from multigrid_petsc_tpu_torch.ops.cuda.dist_kernel import separable9
from multigrid_petsc_tpu_torch.ops.norms import tree_dot
from multigrid_petsc_tpu_torch.ops.sparse import SparseLevelOp, assemble_level_csr
from multigrid_petsc_tpu_torch.ops.stencil import (
    PCRFactor,
    Stencil5,
    Stencil9,
    redblack_dinv,
    sor_redblack_sweeps,
    transpose_stencil9,
)
from multigrid_petsc_tpu_torch.ops.transfer import (
    prolong_bilinear,
    prolong_multi,
    restrict_fw,
)
from multigrid_petsc_tpu_torch.parallel.block_ops import BlockLevelOps
from multigrid_petsc_tpu_torch.parallel.dist_ops import (
    DistLevelOps,
    DistMergedOps,
    prolong_steps,
    restrict_steps,
)
from multigrid_petsc_tpu_torch.problems import (
    AnisoProblem,
    Problem,
    aniso_rhs_grid,
    poisson_sin_problem,
    rhs_grid,
    stencil9_coefficients,
    stencil_coefficients,
)
from multigrid_petsc_tpu_torch.solvers import smoothers as sm
from multigrid_petsc_tpu_torch.solvers.coarse import (
    build_cg_solver,
    build_direct_solver,
    dense_from_csr,
    dense_solver,
)
from multigrid_petsc_tpu_torch.utils.config import (
    CycleType,
    SmootherType,
    SolverConfig,
    not_ported,
)

_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "bfloat16": torch.bfloat16}
_OUTER_DTYPES = ("float64", "float32x2")
# Smoothers with a static (alpha, beta) step schedule: what the fused
# visit kernels, the mg-CG kernel routes and the coarse tree run.
POINT_SMOOTHERS = (SmootherType.JACOBI, SmootherType.CHEBYSHEV)
# What the bf16 working dtype does not take yet: (what, its ROADMAP item).
_MERGED_CYCLES = (CycleType.ICYCLE, CycleType.ECYCLE, CycleType.D1CYCLE,
                  CycleType.D2CYCLE, CycleType.D1PSCYCLE, CycleType.ADDITIVE2)
_BF16_REFUSALS = {
    "plan": ("under a plan (-map)", "precision, bf16 under a plan"),
    "merged": ("with merged grids (grids != levels; the I, E, D1, D2, D1PS "
               "and Additive2 cycles)", "precision, bf16 merged grids"),
    "outer": ("with outer_dtype or precond_dtype",
              "precision, bf16 with outer_dtype / precond_dtype"),
}
# Smoothers whose level visits are composed of smooth, residual and
# restriction (JAX's generic visits).
_COMPOSED_SMOOTHERS = (SmootherType.RBGS, SmootherType.LINE_X,
                       SmootherType.LINE_XY)


def primary(state) -> torch.Tensor:
    """A state's primary (finest) grid."""
    return state if isinstance(state, torch.Tensor) else state[0]


@dataclass
class LevelCtx:
    """One level: its spec, stencils, smoother and solver closures.

    A single-grid matrix-free level dispatches every operation to the
    5-point kernels (K6, K7, K9) or the 9-point ones (K12, K13, K14) by
    the stencil's type, and to the y-line visit (K15) when its smoother
    is LINE_Y.  An RBGS level smooths by masked half-sweeps over
    ``residual5``, a LINE_X level by K15 on the transposed level, LINE_XY
    by one of each per sweep; their visits are composed.  A sparse level
    (``backend="sparse"``) applies its assembled operators
    (``sparse_full``: A, ``sparse_diag``: A1, ``sparse_coup``: A2;
    single-grid levels keep A only, which is A1).  A
    merged level (``spec.is_composite``) applies ``composite_apply`` over
    its operator set (``grid_ops``) unless it is sparse; its smoother is
    block Gauss-Seidel (``block_gs``), matrix-free even when sparse, as in
    the JAX package."""

    spec: LevelSpec
    stencil: Stencil5 | Stencil9  # the primary grid's
    dinv: torch.Tensor | tuple    # 1 / cc, per grid on a merged level
    smoother: SmootherType
    omega: float
    # Chebyshev: lmax of D^-1 A, set up once (of D^-1 A1 under the E and
    # delayed cycles, whose smoother runs A1: ``cycles._diag_smoother``).
    lmax: float | None = None
    coarse_solve: Callable | None = None
    # LINE_Y, LINE_XY: the stencil as a collapsed Stencil9 and its line
    # factors (``line_kernel.line_factor``), set up once; LINE_X, LINE_XY:
    # the same of the transposed stencil (its lines run along x).
    line_st: Stencil9 | None = None
    line_fac: PCRFactor | lk.SegmentFactor | None = None
    line_st_x: Stencil9 | None = None
    line_fac_x: PCRFactor | lk.SegmentFactor | None = None
    # RBGS: omega / cc masked to each colour (``redblack_dinv``).
    rb_dinv: tuple | None = None
    stencils: tuple = ()  # every grid's stencil (stencils[0] is stencil)
    block_gs: bool = False  # merged level: block Gauss-Seidel smoother
    block_gs_inner: int = 3
    sparse: bool = False
    sparse_full: SparseLevelOp | None = None
    sparse_diag: SparseLevelOp | None = None
    sparse_coup: SparseLevelOp | None = None
    # A sharded level (under a plan): its state is this rank's block, (R,
    # nx) of the ny + pad_rows rows under the rows layout (DistLevelOps),
    # (R, C) under the blocks layout (BlockLevelOps), every operation one
    # K17 visit.
    dist: DistLevelOps | BlockLevelOps | None = None
    pad_rows: int = 0
    # A merged level's per-grid operators (GridOps; DistMergedOps when
    # the plan shards its primary grid: each sharded grid's block, in the
    # plan's layout).
    grid_ops: GridOps | None = None

    @property
    def shape(self) -> tuple[int, int]:
        return self.spec.primary.shape

    @property
    def state_shape(self) -> tuple[int, int]:
        """The primary grid's state on this rank: its block when sharded."""
        if self.dist is not None:
            return self.dist.block_shape
        return self.shape

    @property
    def shapes(self) -> list[tuple[int, int]]:
        return [g.shape for g in self.spec.grids]

    @property
    def state_shapes(self) -> list[tuple[int, int]]:
        """Every grid's state on this rank (the block when sharded)."""
        if isinstance(self.grid_ops, DistMergedOps):
            return self.grid_ops.state_shapes
        return [self.state_shape] if self.dist is not None else self.shapes

    @property
    def split(self) -> tuple[bool, ...]:
        """Which of the level's grids run sharded on this rank (on their
        row or 2-D blocks)."""
        if self.grid_ops is not None:
            return self.grid_ops.sharded
        return (self.dist is not None,)

    @property
    def sharded(self) -> bool:
        return any(self.split)

    @property
    def merged(self) -> bool:
        return self.spec.is_composite

    @property
    def generic(self) -> bool:
        """Sparse and merged levels: no fused visit kernels (the JAX
        package's ``use_pallas_apply`` is False there)."""
        return self.sparse or self.merged

    @property
    def nine(self) -> bool:
        return isinstance(self.stencil, Stencil9)

    @property
    def composed(self) -> bool:
        """Visits composed of smooth, residual and restriction: the
        generic levels, the smoothers with no fused visit kernel, and any
        smoother but a point one on a sharded level (K17 fuses those)."""
        if self.dist is not None:
            return self.smoother not in POINT_SMOOTHERS
        return self.generic or self.smoother in _COMPOSED_SMOOTHERS

    @property
    def point5(self) -> bool:
        """A matrix-free single-grid 5-point level with a point smoother
        (Jacobi or Chebyshev): what the fused mg-CG kernels (K1-K4) and
        the coarse tree take."""
        return (not self.nine and self.smoother in POINT_SMOOTHERS
                and not self.generic)

    def _op(self, name: str) -> SparseLevelOp:
        op = getattr(self, name)
        if op is None:
            raise RuntimeError(f"{name} is not assembled: this cycle does "
                               f"not read it")
        return op

    def dot(self, x, y) -> torch.Tensor:
        """<x, y> over the level's whole state: a sharded level's local
        dots summed over the ranks; a replicated level's as they are; a
        merged level's through its operator set (each sharded grid's over
        the ranks, each replicated grid's once)."""
        if self.grid_ops is not None:
            return self.grid_ops.dot(x, y)
        d = tree_dot(x, y)
        return d if self.dist is None else self.dist.sum(d)

    def norm2(self, x) -> torch.Tensor:
        return torch.sqrt(self.dot(x, x))

    def grid_norm(self, k: int, x: torch.Tensor) -> torch.Tensor:
        """||x|| of grid k's part of a state (-moreNorm's per-grid norm)."""
        if self.grid_ops is not None:
            return self.grid_ops.grid_norm(k, x)
        return self.norm2(x)

    def vnorm(self, x: torch.Tensor) -> torch.Tensor:
        """||x|| of one tensor: as ``torch.linalg.vector_norm`` computes it
        on one device (the Krylov outers' norm; in f32 for bf16 storage),
        over the ranks (``norm2``) when the level is sharded."""
        if self.sharded:
            return self.norm2(x)
        return torch.linalg.vector_norm(
            x, dtype=torch.float32 if x.dtype == torch.bfloat16 else None)

    def local(self, state):
        """This rank's part of a whole level state (a part kept)."""
        if self.grid_ops is not None:
            return self.grid_ops.local(state)
        if (self.dist is not None
                and tuple(state.shape) != self.dist.block_shape):
            return self.dist.block_of(state)
        return state

    def real_rows(self, state):
        """The state without its pad rows: each block's rows inside its
        grid."""
        if self.grid_ops is not None:
            return self.grid_ops.real_rows(state)
        return state if self.dist is None else self.dist.real(state)

    def apply(self, u):
        if self.dist is not None:
            return self.dist.apply(u)
        if self.sparse:
            return self._op("sparse_full").apply(u)
        if self.merged:
            return composite_apply(self.grid_ops, u)
        if self.nine:
            return sk9.apply_stencil9(self.stencil, u)
        return sk.apply_stencil5(self.stencil, u)

    def residual(self, b, u):
        if self.dist is not None:
            return self.dist.residual(b, u)
        if self.sparse:
            return self._op("sparse_full").residual(b, u)
        if self.merged:
            return composite_residual(self.grid_ops, b, u)
        if self.nine:
            return sk9.residual9(self.stencil, b, u)
        return sk.residual5(self.stencil, b, u)

    def apply_diag(self, u):
        """A1 u: the grid-diagonal blocks only (A itself on one grid)."""
        if not self.merged:
            return self.apply(u)
        if self.sparse:
            return self._op("sparse_diag").apply(u)
        return composite_apply(self.grid_ops, u, include_couplings=False)

    def apply_couplings(self, u):
        """A2 u: the coupling blocks only (zero on one grid)."""
        if not self.merged:
            return torch.zeros_like(u)
        if self.sparse:
            return self._op("sparse_coup").apply(u)
        return composite_apply(self.grid_ops, u, include_diag=False)

    def zeros(self):
        cc = self.stencil.cc
        z = tuple(torch.zeros(s, dtype=cc.dtype, device=cc.device)
                  for s in self.state_shapes)
        return z if self.merged else z[0]

    def steps_fn(self, sweeps: int):
        """The point smoother's static (alpha, beta) schedule."""
        if self.smoother == SmootherType.CHEBYSHEV:
            return sm.chebyshev_step_coeffs(sweeps, self.lmax)
        if self.smoother == SmootherType.JACOBI:
            return sm.jacobi_step_coeffs(sweeps, self.omega)
        raise ValueError(f"the {self.smoother.value} smoother has no step "
                         f"schedule")

    def _line(self, b, u, sweeps: int, emit: str, e_c=None):
        return lk.line_visit9(self.line_st, b, u, sweeps, self.omega,
                              emit=emit, e_coarse=e_c, fac=self.line_fac)

    def _line_x(self, b, u, sweeps: int):
        """x-line sweeps: the y-line visit (K15) of the transposed level,
        on contiguous transposes of b and u."""
        return lk.line_visit9(self.line_st_x, b.T.contiguous(),
                              u.T.contiguous(), sweeps, self.omega,
                              fac=self.line_fac_x).T.contiguous()

    def _smooth_dist(self, b, u, sweeps: int):
        d = self.dist
        if self.smoother == SmootherType.RBGS:
            return d.rbgs(b, u, sweeps)
        if self.smoother == SmootherType.LINE_Y:
            return d.line_y_sweeps(b, u, sweeps, self.omega)
        if self.smoother == SmootherType.LINE_X:
            return d.line_x_sweeps(b, u, sweeps, self.omega)
        if self.smoother == SmootherType.LINE_XY:
            for _ in range(sweeps):  # one y-sweep, then one x-sweep
                u = d.line_x_sweeps(b, d.line_y_sweeps(b, u, 1, self.omega),
                                    1, self.omega)
            return u
        return d.smooth(b, u, self.steps_fn(sweeps))

    def smooth(self, b, u, sweeps: int):
        if self.dist is not None:
            return self._smooth_dist(b, u, sweeps)
        if self.block_gs:
            return sm.composite_block_gs(self.grid_ops, b, u, sweeps,
                                         inner=self.block_gs_inner,
                                         omega=self.omega)
        if self.smoother == SmootherType.RBGS:
            return sor_redblack_sweeps(self.stencil, b, u, sweeps,
                                       self.omega, sk.residual5,
                                       self.rb_dinv)
        if self.smoother == SmootherType.LINE_X:
            return self._line_x(b, u, sweeps)
        if self.smoother == SmootherType.LINE_XY:
            for _ in range(sweeps):  # one y-sweep, then one x-sweep
                u = self._line_x(b, self._line(b, u, 1, "u"), 1)
            return u
        if self.smoother == SmootherType.LINE_Y:
            return self._line(b, u, sweeps, "u")
        if self.generic:
            if self.smoother == SmootherType.CHEBYSHEV:
                return sm.chebyshev(self.apply, self.dinv, b, u, sweeps,
                                    self.lmax)
            return sm.jacobi(self.apply, self.dinv, b, u, sweeps, self.omega)
        fn = sk9.smooth9_sweeps if self.nine else sk.smooth_sweeps
        return fn(self.stencil, b, u, self.steps_fn(sweeps))

    def _prolong(self, e_c):
        """P e_c on the primary grid (the block when sharded)."""
        if self.dist is not None:
            return self.dist.prolong(e_c)
        return prolong_bilinear(e_c)

    def visit_down(self, b, u, sweeps: int):
        """(u', rc): smooth from u (None: the zero guess) + the restricted
        residual of the primary grid (the coarse block when sharded)."""
        if self.composed:
            u = self.smooth(b, self.zeros() if u is None else u, sweeps)
            r = primary(self.residual(b, u))
            return u, (restrict_fw(r) if self.dist is None
                       else self.dist.restrict(r))
        if self.dist is not None:
            return self.dist.visit_down(b, u, self.steps_fn(sweeps))
        if self.line_st is not None:
            return self._line(b, u, sweeps, "rc")
        fn = sk9.fused_level_visit9 if self.nine else sk.fused_level_visit
        return fn(self.stencil, b, u, self.steps_fn(sweeps), emit="rc")

    def visit_up(self, b, u, e_c, sweeps: int, emit_r: bool = False):
        """smooth_k(b, u + P e_c) [, its residual]; the correction goes to
        the primary grid (on a sharded level: the coarse level's block,
        or the whole coarse grid when that level is replicated)."""
        if self.composed:
            u0 = primary(u) + self._prolong(e_c)
            u = u0 if isinstance(u, torch.Tensor) else (u0,) + tuple(u[1:])
            u = self.smooth(b, u, sweeps)
            return (u, self.residual(b, u)) if emit_r else u
        if self.dist is not None:
            return self.dist.visit_up(b, u, e_c, self.steps_fn(sweeps),
                                      emit_r)
        emit = "ur" if emit_r else "u"
        if self.line_st is not None:
            return self._line(b, u, sweeps, emit, e_c)
        fn = sk9.fused_level_visit9 if self.nine else sk.fused_level_visit
        return fn(self.stencil, b, u, self.steps_fn(sweeps), emit=emit,
                  e_coarse=e_c)

    # The fused mg-CG route's level-0 operations (``point5`` levels only;
    # ``krylov._solve_mgcg_fused``), as the JAX package's LevelCtx
    # closures of the same names.
    def visit_up_dot(self, b, u, e_c, sweeps: int):
        """(z, <b, z>) with z = smooth_k(b, u + P e_c) (K9's correcting
        u visit with its dot, launched as K3)."""
        return sk.fused_level_visit(self.stencil, b, u, self.steps_fn(sweeps),
                                    emit="u", e_coarse=e_c, emit_dot=True)

    def papply(self, z, p, beta):
        """(p', A p', <p', A p'>) with p' = z + beta p (K11)."""
        return sk.cg_papply(self.stencil, z, p, beta)

    def cg_visit_down(self, r, ap, alpha, sweeps: int):
        """(u0, rc, r', ||r'||^2), r' = r - alpha ap (K10)."""
        return sk.cg_visit_down(self.stencil, r, ap, alpha,
                                self.steps_fn(sweeps))


@dataclass
class MGContext:
    """All levels + the level-0 right-hand side."""

    config: SolverConfig
    problem: Problem | AnisoProblem
    levels: list[LevelCtx]
    b0: torch.Tensor
    dtype: torch.dtype
    device: torch.device
    # The Krylov outers' preconditioner levels in cfg.precond_dtype (None:
    # the preconditioner runs on these levels).
    precond_ctx: "MGContext | None" = None
    # The mg-CG route the last solve took ("mdma", "fused", "generic"; the
    # JAX package's ctx.solver_path), set by krylov.solve_mgcg.
    route: str | None = None
    # The distribution plan (parallel.ShardingPlan), None on one device.
    plan: object | None = None

    # The visits restrict and prolong one gap on the primary grids; these
    # finish the transfer to a merged next level (its grids one or more
    # gaps further).  Between single-grid levels the visit kernels' rc
    # output IS the next level's rhs and the next level's solution IS the
    # up visit's coarse correction; from a sharded level to a replicated
    # one the rc blocks are gathered first, and the sharded level's up
    # visit takes the whole replicated correction.  The further gaps to a
    # merged next level go one at a time in each grid's layout
    # (``restrict_steps``, ``prolong_steps``: block-local between sharded
    # sizes, gathered at the first replicated one).
    def _gaps(self, l: int, extra: int):
        g0 = self.levels[l].spec.primary.g
        return [g.g - g0 - extra for g in self.levels[l + 1].spec.grids]

    def _down_grids(self, l: int, x):
        """``x`` on level l+1's primary grid, then its successive
        restrictions onto the level's coarser grids."""
        out = [x]
        for g in self.levels[l + 1].spec.grids[:-1]:
            out.append(restrict_steps(out[-1], g.ny, g.nx, 1, self.plan))
        return tuple(out)

    def restrict_rc1(self, l: int, rc1: torch.Tensor):
        cur, nxt = self.levels[l], self.levels[l + 1]
        if cur.dist is not None:
            rc1 = cur.dist.to_coarse(rc1)
        return self._down_grids(l, rc1) if nxt.merged else rc1

    def prolong_half(self, l: int, u_next) -> torch.Tensor:
        nxt = self.levels[l + 1]
        if not nxt.merged:
            return u_next
        return _sum(prolong_steps(ug, g.ny, g.nx, gap, self.plan)
                    for ug, g, gap in zip(u_next, nxt.spec.grids,
                                          self._gaps(l, 1)))

    # Whole transfers (FMG, the Additive cycles): plain PyTorch, as the
    # JAX package computes them outside its kernels.  Between two sharded
    # levels they are block-local (one exchanged row); from a sharded
    # level to a replicated one the restricted blocks are gathered (the
    # agglomeration), and the prolongation back cuts the block's rows of
    # the replicated correction.  A coarser level is sharded only if its
    # finer one is.
    def restrict_to_next(self, l: int, r: torch.Tensor):
        """Level l's primary-grid residual onto every grid of level l+1."""
        cur = self.levels[l]
        if cur.dist is not None:
            return self.restrict_rc1(l, cur.dist.restrict(r))
        g = cur.spec.primary
        rc = restrict_steps(r, g.ny, g.nx, 1, self.plan)
        return self._down_grids(l, rc) if self.levels[l + 1].merged else rc

    def prolong_from_next(self, l: int, u_next) -> torch.Tensor:
        """Every grid of level l+1 onto level l's primary grid, summed."""
        cur, nxt = self.levels[l], self.levels[l + 1]
        if cur.dist is None:
            if not nxt.merged:
                return prolong_bilinear(u_next)
            return _sum(prolong_multi(ug, gap)
                        for ug, gap in zip(u_next, self._gaps(l, 0)))
        return cur.dist.prolong(self.prolong_half(l, u_next))


def _sum(terms):
    out = None
    for t in terms:
        out = t if out is None else out + t
    return out


# Cycles that read only a merged level's grid-diagonal A1 (the delayed
# cycles; reference src/solver.c:1167-1168) or A1 and A2 (the E-cycle):
# they smooth with their own A1 smoother, never with the levels'.
_SPLIT_CYCLES = (CycleType.D1CYCLE, CycleType.D2CYCLE, CycleType.D1PSCYCLE,
                 CycleType.ECYCLE)


def _bf16_refusal(cfg: SolverConfig, plan) -> str | None:
    """The key of ``_BF16_REFUSALS`` a bf16 config falls under, or None
    (the bf16 slice runs it)."""
    if plan is not None:
        return "plan"
    if cfg.grids != cfg.levels or cfg.cycle in _MERGED_CYCLES:
        return "merged"
    if cfg.outer_dtype is not None or cfg.precond_dtype is not None:
        return "outer"
    return None


def _check_supported(cfg: SolverConfig, plan) -> None:
    if cfg.dtype == "bfloat16":
        key = _bf16_refusal(cfg, plan)
        if key is not None:
            what, item = _BF16_REFUSALS[key]
            raise not_ported("the bf16 working dtype (dtype='bfloat16') "
                             + what, item)
    if plan is not None:
        if cfg.backend == "sparse":
            raise ValueError(
                "backend='sparse' is the single-device explicit-operator "
                "path; use backend='auto'/'pallas' for distributed runs")
    if cfg.problem not in ("poisson", "aniso"):
        raise ValueError(f"unknown problem {cfg.problem!r}")
    if cfg.problem == "aniso" and cfg.grids != cfg.levels:
        raise ValueError("aniso (9-pt) problem: composite levels "
                         "unsupported; use grids == levels")
    if cfg.backend == "sparse" and cfg.problem != "poisson":
        raise ValueError("backend='sparse': poisson problem family only")
    if cfg.dtype not in _DTYPES:
        raise ValueError(f"unknown dtype {cfg.dtype!r}")
    if cfg.outer_dtype not in (None, *_OUTER_DTYPES):
        raise ValueError(f"unknown outer_dtype {cfg.outer_dtype!r}")
    if cfg.precond_dtype not in (None, *_DTYPES):
        raise ValueError(f"unknown precond_dtype {cfg.precond_dtype!r}")
    if cfg.coarse_solver not in ("auto", "direct", "cg", "smooth"):
        raise ValueError(f"unknown coarse_solver {cfg.coarse_solver}")


def rhs_grid_of(cfg: SolverConfig, problem, ny: int, nx: int,
                dtype: torch.dtype, device) -> torch.Tensor:
    """f at the interior points of an (ny, nx) grid of ``cfg``'s problem
    family, evaluated in ``dtype``."""
    if cfg.problem == "aniso":
        return aniso_rhs_grid(problem, ny, nx, dtype, device)
    return rhs_grid(problem, MeshType(cfg.mesh), ny, nx, dtype, device)


def _promote9(st: Stencil5 | Stencil9) -> Stencil9:
    """The stencil the line smoothers run on: a 5-point one promoted to 9
    points with zero corners, as the JAX package does."""
    if isinstance(st, Stencil5):
        z = torch.zeros((1, 1), dtype=st.cc.dtype, device=st.cc.device)
        st = Stencil9(csw=z, cs=st.cs, cse=z, cw=st.cw, cc=st.cc, ce=st.ce,
                      cnw=z, cn=st.cn, cne=z)
    return st


def _check_smoother(lc: LevelCtx) -> None:
    """JAX's refusals (context.py:563-596): RBGS needs one grid and a
    5-point stencil, a line smoother one grid."""
    if lc.smoother == SmootherType.RBGS:
        if lc.merged:
            raise ValueError("RBGS: 1 grid per level")
        if lc.nine:
            raise ValueError(
                "RBGS is 5-point only (corner couplings break the two-color "
                "independence); use line smoothers for 9-point operators")
    elif lc.smoother not in POINT_SMOOTHERS and lc.merged:
        raise ValueError("line smoother: 1 grid per level")


def _setup_smoother(lc: LevelCtx, factors: bool = True) -> None:
    """What the level's smoother needs, made once: Chebyshev's lmax, RBGS's
    masked D^-1, the line smoothers' collapsed stencils in the compute type
    (``line_kernel.line_stencil``: f32 on a bf16 level) and (``factors``;
    a level about to be sharded makes its block's) their factors (the
    y-lines over ny points, the x-lines of the transposed stencil over
    nx)."""
    s = lc.smoother
    ny, nx = lc.shape
    if s == SmootherType.CHEBYSHEV:
        lc.lmax = sm.estimate_dinv_a_lmax(
            lc.apply, lc.dinv, lc.shapes if lc.merged else lc.shape)
    elif s == SmootherType.RBGS:
        if factors:
            lc.rb_dinv = redblack_dinv(lc.stencil, lc.shape, lc.omega)
    elif s != SmootherType.JACOBI:
        st9 = _promote9(lc.stencil)
        if s in (SmootherType.LINE_Y, SmootherType.LINE_XY):
            lc.line_st = lk.line_stencil(st9)
            if factors:
                lc.line_fac = lk.line_factor(lc.line_st, ny)
        if s in (SmootherType.LINE_X, SmootherType.LINE_XY):
            lc.line_st_x = lk.line_stencil(transpose_stencil9(st9))
            if factors:
                lc.line_fac_x = lk.line_factor(lc.line_st_x, nx)


def _plan_device(device, plan) -> torch.device:
    """The solve's device: ``device`` (None: the card), or under a plan
    the plan's device, which a named ``device`` must agree with."""
    if plan is None:
        return torch.device("cuda" if device is None else device)
    if device is not None and torch.device(device).type != plan.device.type:
        raise ValueError(f"device {device} differs from the plan's "
                         f"{plan.device}")
    return plan.device


def build_context(cfg: SolverConfig, problem: Problem | None = None,
                  plan=None, *,
                  device: torch.device | str | None = None) -> MGContext:
    """Build every level on ``device`` (None: the card; the CPU only when
    the caller names it; ``cuda`` without a card is an error), under
    ``plan`` on the plan's device.  ``problem="aniso"`` builds the 9-point
    family of ``AnisoProblem(*cfg.aniso)`` (``problem`` is then not used),
    as the JAX package does.  With ``cfg.precond_dtype`` and a Krylov
    cycle (mg-CG, mg-FGMRES) the preconditioner's levels are built again
    in that type (``MGContext.precond_ctx``; JAX context.py:1062-1074)."""
    _check_supported(cfg, plan)
    device = _plan_device(device, plan)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' requested but no CUDA device "
                               "is available")
        # The coarsest solve is a dense matmul: keep f32 products in full
        # f32 and bf16 products' sums in f32.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = (
            False)
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    ctx = _build(cfg, problem, device, plan)
    if cfg.precond_dtype is not None and cfg.cycle in (CycleType.MGCG,
                                                       CycleType.MGFGMRES):
        pcfg = dataclasses.replace(cfg, dtype=cfg.precond_dtype,
                                   precond_dtype=None, outer_dtype=None)
        ctx.precond_ctx = _build(pcfg, problem, device, plan)
        assert ([l.shapes for l in ctx.precond_ctx.levels]
                == [l.shapes for l in ctx.levels]), \
            "precond context level shapes must match"
    return ctx


def _use_dist(lc: LevelCtx, plan) -> bool:
    """Does ``lc`` run sharded under ``plan``?  Where the plan shards it
    (``ShardingPlan.spec``; a world of one rank shards nothing), as JAX
    shards it: under the rows layout its dist kernels where they take the
    level, GSPMD where they do not (another smoother than Jacobi or
    Chebyshev, non-separable 9-point coefficients, a block too small for
    the halo); under the blocks layout GSPMD.  The port runs all of these
    on the rank's block (K17 ships every coefficient as it is; ROADMAP:
    kept for parity).  A merged level runs sharded where its primary grid
    is, each of its grids split as the plan splits it (``_shard``)."""
    g = lc.spec.primary
    return plan is not None and plan.shards(g.ny, g.nx)


def _jax_dist_kernels(lc: LevelCtx, whole_stencil) -> bool:
    """Would JAX run the sharded level ``lc`` through its dist kernels
    (context.py:350-414: a point smoother, a 5-point or separable 9-point
    stencil, a block that carries the largest halo) rather than GSPMD?
    Only the coarsest level's solver reads it: JAX iterates CG on the
    former and solves the latter directly.  Under the blocks layout JAX
    runs every level through GSPMD."""
    return (isinstance(lc.dist, DistLevelOps)
            and lc.smoother in POINT_SMOOTHERS and lc.dist.viable
            and (not lc.nine or separable9(whole_stencil)))


def _shard(lc: LevelCtx, cfg: SolverConfig, plan) -> None:
    """Put ``lc`` on this rank's block (JAX context.py:945-961): under
    the rows layout its row block, under the blocks layout its 2-D block
    (``BlockLevelOps``), with its smoother's set-up (RBGS's colours by
    the global parity, the line smoothers' stencils and factors of the
    block); a merged level grid by grid (``DistMergedOps``: the sharded
    grids' blocks in the plan's layout, the replicated grids whole)."""
    lc.pad_rows = 1
    if lc.merged:
        ops = lc.grid_ops = DistMergedOps(lc.stencils, lc.spec.grids, plan,
                                          cfg.max_sweeps)
        lc.stencils, lc.dinv = ops.stencils, ops.dinv
        lc.stencil = ops.stencils[0]
        return
    g = lc.spec.primary
    ops = BlockLevelOps if plan.layout == "blocks" else DistLevelOps
    d = lc.dist = ops(lc.stencil, g.ny, g.nx, plan, cfg.max_sweeps)
    lc.dinv = d.dinv
    if lc.smoother == SmootherType.RBGS:
        d.setup_rbgs(lc.omega)
    if lc.line_st is not None:
        d.setup_line_y(lc.line_st)
    if lc.line_st_x is not None:
        d.setup_line_x(lc.line_st_x)
    lc.line_st = lc.line_st_x = None  # the block's own replace them
    # The points of the coefficients this rank reads (a 9-point field's,
    # cut to the block and its halo; the 5-point columns whole).
    lc.stencil = d.st
    lc.stencils = (d.st,)


def _build(cfg: SolverConfig, problem: Problem | None,
           device: torch.device, plan) -> MGContext:
    aniso = cfg.problem == "aniso"
    problem = (AnisoProblem(*cfg.aniso) if aniso
               else problem or poisson_sin_problem())
    dtype = _DTYPES[cfg.dtype]
    mesh_type = MeshType(cfg.mesh)
    sparse = cfg.backend == "sparse"
    levels = []
    for l, spec in enumerate(build_hierarchy(cfg.npts, cfg.grids,
                                             cfg.levels)):
        sts = tuple(
            stencil9_coefficients(problem, g.ny, g.nx, dtype, device)
            if aniso else
            stencil_coefficients(mesh_type, g.ny, g.nx, dtype, device)
            for g in spec.grids)
        dinv = tuple(1.0 / st.cc for st in sts)
        lc = LevelCtx(spec=spec, stencil=sts[0],
                      dinv=dinv if spec.is_composite else dinv[0],
                      smoother=cfg.smoother_at(l, cfg.levels),
                      omega=cfg.omega, stencils=sts, sparse=sparse,
                      block_gs=(spec.is_composite
                                and cfg.composite_smoother == "block_gs"),
                      block_gs_inner=cfg.v[0],
                      grid_ops=(GridOps(sts, spec.gids) if spec.is_composite
                                else None))
        if sparse:
            _assemble(lc, cfg, device, dtype)
        shard = _use_dist(lc, plan)
        if not lc.block_gs:
            _check_smoother(lc)
            if cfg.cycle not in _SPLIT_CYCLES:
                _setup_smoother(lc, factors=not shard)
        if (l == 0 and cfg.cycle in _SPLIT_CYCLES
                and cfg.smoother == SmootherType.CHEBYSHEV):
            lc.lmax = sm.estimate_dinv_a_lmax(  # of D^-1 A1, whole
                lc.apply_diag, lc.dinv, lc.shapes if lc.merged else lc.shape)
        whole_stencil = lc.stencil  # the coarsest level's direct solve's
        if shard:  # after lmax, which JAX estimates on the whole grid
            _shard(lc, cfg, plan)
        levels.append(lc)

    if len(levels) >= 2 and cfg.coarse_solver != "smooth":
        last = levels[-1]
        mode = cfg.coarse_solver
        if mode == "auto":
            n = sum(ny * nx for ny, nx in last.shapes)
            mode = "direct" if n <= cfg.max_direct_size else "cg"
        if mode == "cg" or (last.dist is not None
                            and _jax_dist_kernels(last, whole_stencil)):
            # A coarsest level on JAX's dist kernels iterates CG, as in
            # JAX (its direct solve densifies the whole operator); a
            # merged one takes JAX's rule unchanged (its merged levels
            # carry no pad rows).
            last.coarse_solve = build_cg_solver(
                last.apply, last.state_shapes, cfg.coarse_cg_iters,
                dot=last.dot if last.sharded else None)
        elif last.dist is not None:
            # One JAX shards through GSPMD is solved directly, densified
            # whole: its rows are gathered for the solve.
            last.coarse_solve = last.dist.gathered(
                build_direct_solver(whole_stencil, last.shape))
        elif last.merged:
            # The merged operator, couplings included, from its CSR; under
            # a plan its sharded grids gathered for the solve.
            dense = dense_from_csr(*assemble_level_csr(
                cfg.npts, cfg.mesh, last.spec.gids))
            last.coarse_solve = last.grid_ops.gathered(
                dense_solver(dense, last.shapes, dtype, device))
        else:
            last.coarse_solve = build_direct_solver(last.stencil, last.shape)

    # Level-0 rhs: f on the primary grid, its composed restrictions on the
    # coarser grids of a merged level 0 (src/solver.c:558-620).
    g0 = levels[0].spec.primary
    b0 = rhs_grid_of(cfg, problem, g0.ny, g0.nx, dtype, device)
    if levels[0].merged:
        b0 = composite_rhs(b0, levels[0].spec.gids)
    b0 = levels[0].local(b0)
    return MGContext(config=cfg, problem=problem, levels=levels, b0=b0,
                     dtype=dtype, device=device, plan=plan)


def _assemble(lc: LevelCtx, cfg: SolverConfig, device, dtype) -> None:
    """The level's assembled operators: only those its cycle reads.  A
    single-grid level keeps A (= A1; A2 = 0).  On a merged level the
    delayed cycles read A1 only (reference src/solver.c:1167-1168), the
    E-cycle A1 and A2 (src/solver.c:512-556), every other cycle A."""
    def op(**kw):
        return SparseLevelOp.assemble(cfg.npts, cfg.mesh, lc.spec.gids,
                                      device=device, dtype=dtype, **kw)

    if not lc.merged or cfg.cycle not in _SPLIT_CYCLES:
        lc.sparse_full = op()
        return
    lc.sparse_diag = op(include_couplings=False)
    if cfg.cycle == CycleType.ECYCLE:
        lc.sparse_coup = op(include_diag=False)
