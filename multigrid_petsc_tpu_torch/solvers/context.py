"""Solver setup: the per-level operator context built from a config.

PyTorch counterpart of the single-grid slice of
``multigrid_petsc_tpu/solvers/context.py`` (reference: src/poisson.c:85-118
set-up + assembly): stencil coefficients per grid (the 5-point Poisson
family or the 9-point anisotropic one), the matrix-free apply and
residual, each level's smoother (Jacobi or Chebyshev, with its lmax and
step schedule, or y-line Jacobi), the fused level visits, the
inter-level transfers and the coarsest direct solve.

The JAX package routes each level through a web of flags
(``use_pallas_apply``, ``mdma_ok``, ``papply``...).  Here there is one
dispatch per level, on the tensor's device, inside the kernel wrappers of
``ops.cuda``: CPU tensors run the plain PyTorch versions, CUDA tensors the
hand-written kernels, so every level operation on the card launches one.
Everything this slice does not port raises ``NotImplementedError`` naming
the ROADMAP item that will bring it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from multigrid_petsc_tpu_torch.hierarchy import LevelSpec, build_hierarchy
from multigrid_petsc_tpu_torch.mesh import MeshType
from multigrid_petsc_tpu_torch.ops.cuda import line_kernel as lk
from multigrid_petsc_tpu_torch.ops.cuda import stencil9_kernel as sk9
from multigrid_petsc_tpu_torch.ops.cuda import stencil_kernel as sk
from multigrid_petsc_tpu_torch.ops.stencil import PCRFactor, Stencil5, Stencil9
from multigrid_petsc_tpu_torch.ops.transfer import prolong_bilinear, restrict_fw
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
from multigrid_petsc_tpu_torch.solvers.coarse import build_direct_solver
from multigrid_petsc_tpu_torch.utils.config import SmootherType, SolverConfig

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, modules left behind: {item})")


@dataclass
class LevelCtx:
    """One single-grid level: its spec, stencil, smoother and solver
    closures.  Every operation dispatches to the 5-point kernels (K6, K7,
    K9) or the 9-point ones (K12, K13, K14) by the stencil's type, and to
    the y-line visit (K15) when the level's smoother is LINE_Y."""

    spec: LevelSpec
    stencil: Stencil5 | Stencil9
    dinv: torch.Tensor
    smoother: SmootherType  # JACOBI, CHEBYSHEV or LINE_Y
    omega: float
    lmax: float | None = None  # Chebyshev: lmax of D^-1 A, set up once
    coarse_solve: Callable[[torch.Tensor], torch.Tensor] | None = None
    # LINE_Y: the stencil as a collapsed Stencil9 and its line factors
    # (``line_kernel.line_factor``), set up once.
    line_st: Stencil9 | None = None
    line_fac: PCRFactor | lk.LineFactor | None = None

    @property
    def shape(self) -> tuple[int, int]:
        return self.spec.primary.shape

    @property
    def nine(self) -> bool:
        return isinstance(self.stencil, Stencil9)

    @property
    def point5(self) -> bool:
        """A 5-point level with a point smoother: what the fused mg-CG
        kernels (K1-K4) take."""
        return not self.nine and self.line_st is None

    def apply(self, u: torch.Tensor) -> torch.Tensor:
        if self.nine:
            return sk9.apply_stencil9(self.stencil, u)
        return sk.apply_stencil5(self.stencil, u)

    def residual(self, b: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        if self.nine:
            return sk9.residual9(self.stencil, b, u)
        return sk.residual5(self.stencil, b, u)

    def zeros(self) -> torch.Tensor:
        return torch.zeros(self.shape, dtype=self.dinv.dtype,
                           device=self.dinv.device)

    def steps_fn(self, sweeps: int):
        """The point smoother's static (alpha, beta) schedule."""
        if self.smoother == SmootherType.CHEBYSHEV:
            return sm.chebyshev_step_coeffs(sweeps, self.lmax)
        return sm.jacobi_step_coeffs(sweeps, self.omega)

    def _line(self, b, u, sweeps: int, emit: str, e_c=None):
        return lk.line_visit9(self.line_st, b, u, sweeps, self.omega,
                              emit=emit, e_coarse=e_c, fac=self.line_fac)

    def smooth(self, b: torch.Tensor, u: torch.Tensor, sweeps: int):
        if self.line_st is not None:
            return self._line(b, u, sweeps, "u")
        fn = sk9.smooth9_sweeps if self.nine else sk.smooth_sweeps
        return fn(self.stencil, b, u, self.steps_fn(sweeps))

    def visit_down(self, b: torch.Tensor, u: torch.Tensor | None,
                   sweeps: int):
        """(u', rc): smooth from u (None: the zero guess) + the fully
        restricted residual."""
        if self.line_st is not None:
            return self._line(b, u, sweeps, "rc")
        fn = sk9.fused_level_visit9 if self.nine else sk.fused_level_visit
        return fn(self.stencil, b, u, self.steps_fn(sweeps), emit="rc")

    def visit_up(self, b, u, e_c, sweeps: int, emit_r: bool = False):
        """smooth_k(b, u + P e_c) [, its residual]."""
        emit = "ur" if emit_r else "u"
        if self.line_st is not None:
            return self._line(b, u, sweeps, emit, e_c)
        fn = sk9.fused_level_visit9 if self.nine else sk.fused_level_visit
        return fn(self.stencil, b, u, self.steps_fn(sweeps), emit=emit,
                  e_coarse=e_c)


@dataclass
class MGContext:
    """All levels + the level-0 right-hand side."""

    config: SolverConfig
    problem: Problem | AnisoProblem
    levels: list[LevelCtx]
    b0: torch.Tensor
    dtype: torch.dtype
    device: torch.device

    # One coarsening gap between adjacent single-grid levels: the visit
    # kernels' rc output IS the next level's rhs and the next level's
    # solution IS the up visit's coarse correction.
    def restrict_rc1(self, l: int, rc1: torch.Tensor) -> torch.Tensor:
        return rc1

    def prolong_half(self, l: int, u_next: torch.Tensor) -> torch.Tensor:
        return u_next

    # Whole transfers (FMG, the Additive cycle): plain PyTorch, as the JAX
    # package computes them outside its kernels.
    def restrict_to_next(self, l: int, r: torch.Tensor) -> torch.Tensor:
        return restrict_fw(r)

    def prolong_from_next(self, l: int, u_next: torch.Tensor) -> torch.Tensor:
        return prolong_bilinear(u_next)


def _check_supported(cfg: SolverConfig, plan) -> None:
    if plan is not None:
        raise _not_ported("distribution (plan=)", "distribution")
    if cfg.problem not in ("poisson", "aniso"):
        raise ValueError(f"unknown problem {cfg.problem!r}")
    if cfg.problem == "aniso" and cfg.grids != cfg.levels:
        raise ValueError("aniso (9-pt) problem: composite levels "
                         "unsupported; use grids == levels")
    if cfg.backend == "sparse":
        raise _not_ported("backend='sparse'", "sparse")
    if cfg.grids != cfg.levels:
        raise _not_ported("composite (merged-grid) levels", "the cycle zoo")
    if cfg.dtype not in _DTYPES:
        raise _not_ported(f"dtype {cfg.dtype!r}", "precision")
    if cfg.outer_dtype is not None or cfg.precond_dtype is not None:
        raise _not_ported("outer_dtype / precond_dtype", "precision")
    for l in range(cfg.levels):
        s = cfg.smoother_at(l, cfg.levels)
        if s not in (SmootherType.JACOBI, SmootherType.CHEBYSHEV,
                     SmootherType.LINE_Y):
            raise _not_ported(f"smoother {s.value!r}", "the other smoothers")
    if cfg.coarse_solver not in ("auto", "direct", "smooth"):
        raise _not_ported(f"coarse_solver {cfg.coarse_solver!r}",
                          "the cycle zoo")


def _line_stencil(st: Stencil5 | Stencil9) -> Stencil9:
    """The stencil the y-line smoother runs on: a 5-point one promoted to
    9 points with zero corners (as the JAX package does), collapsed to
    compact coefficient shapes."""
    if isinstance(st, Stencil5):
        z = torch.zeros((1, 1), dtype=st.cc.dtype, device=st.cc.device)
        st = Stencil9(csw=z, cs=st.cs, cse=z, cw=st.cw, cc=st.cc, ce=st.ce,
                      cnw=z, cn=st.cn, cne=z)
    return lk.collapse_stencil(st)


def build_context(cfg: SolverConfig, problem: Problem | None = None,
                  plan=None, *,
                  device: torch.device | str = "cuda") -> MGContext:
    """Build every level on ``device`` (the card unless the caller names
    the CPU; ``cuda`` without a card is an error).  ``problem="aniso"``
    builds the 9-point family of ``AnisoProblem(*cfg.aniso)`` (``problem``
    is then not used), as the JAX package does."""
    _check_supported(cfg, plan)
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' requested but no CUDA device "
                               "is available")
        # The coarsest solve is a float32 matmul; keep it in full f32.
        torch.backends.cuda.matmul.allow_tf32 = False
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    aniso = cfg.problem == "aniso"
    problem = (AnisoProblem(*cfg.aniso) if aniso
               else problem or poisson_sin_problem())
    dtype = _DTYPES[cfg.dtype]
    mesh_type = MeshType(cfg.mesh)
    levels = []
    for l, spec in enumerate(build_hierarchy(cfg.npts, cfg.grids,
                                             cfg.levels)):
        g = spec.primary
        st = (stencil9_coefficients(problem, g.ny, g.nx, dtype, device)
              if aniso else
              stencil_coefficients(mesh_type, g.ny, g.nx, dtype, device))
        lc = LevelCtx(spec=spec, stencil=st, dinv=1.0 / st.cc,
                      smoother=cfg.smoother_at(l, cfg.levels),
                      omega=cfg.omega)
        if lc.smoother == SmootherType.CHEBYSHEV:
            lc.lmax = sm.estimate_dinv_a_lmax(lc.apply, lc.dinv, g.shape)
        elif lc.smoother == SmootherType.LINE_Y:
            lc.line_st = _line_stencil(st)
            lc.line_fac = lk.line_factor(lc.line_st, g.ny)
        levels.append(lc)

    if len(levels) >= 2 and cfg.coarse_solver != "smooth":
        last = levels[-1]
        mode = cfg.coarse_solver
        if mode == "auto":
            n = last.shape[0] * last.shape[1]
            mode = "direct" if n <= cfg.max_direct_size else "cg"
        if mode != "direct":
            raise _not_ported("the CG coarse solver", "the cycle zoo")
        last.coarse_solve = build_direct_solver(last.stencil, last.shape)

    g0 = levels[0].spec.primary
    b0 = (aniso_rhs_grid(problem, g0.ny, g0.nx, dtype, device) if aniso
          else rhs_grid(problem, mesh_type, g0.ny, g0.nx, dtype, device))
    return MGContext(config=cfg, problem=problem, levels=levels, b0=b0,
                     dtype=dtype, device=device)
