"""Configuration: solver flags + poisson.in-style option parsing.

Pure-Python copy of ``multigrid_petsc_tpu/utils/config.py`` (the port
must run without JAX).  Reference: src/poisson.c:51-59 reads -npts -mesh
-iter -grids -levels -cycle -map -v -moreNorm from the PETSc options DB
seeded by poisson.in; unsupported-combination guards at
src/poisson.c:61-71.  Cycle numbering keeps the reference's values
(poisson.in:8) and adds the framework's extensions above 100.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, replace
from pathlib import Path


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error for a capability of the JAX package the port does not
    have yet, naming its ROADMAP item."""
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, modules left behind: {item})")


class CycleType(enum.Enum):
    # Reference cycle ids (reference: poisson.in:8, src/poisson.c:106-114).
    VCYCLE = 0
    ICYCLE = 1
    ECYCLE = 2
    D1CYCLE = 3
    D2CYCLE = 4
    D1PSCYCLE = 7
    PCMG = 8  # reference: PETSc PCMG cross-check; here: MG-preconditioned Richardson
    ADDITIVE = 9
    ADDITIVE2 = 10
    # Framework extensions.
    MGCG = 101      # CG outer, V-cycle preconditioner (BASELINE mg-CG target)
    MGFGMRES = 102  # flexible GMRES outer, V-cycle preconditioner
    FMG = 103       # full-multigrid start + V-cycles


class SmootherType(enum.Enum):
    JACOBI = "jacobi"
    CHEBYSHEV = "chebyshev"
    RBGS = "rbgs"        # red-black Gauss-Seidel (two masked half-sweeps)
    LINE_Y = "line_y"    # y-line Jacobi (tridiagonal in the strong direction)
    LINE_X = "line_x"
    LINE_XY = "line_xy"  # alternating x/y line sweeps


@dataclass(frozen=True)
class SolverConfig:
    """All solver knobs (defaults match the reference's poisson.in)."""

    npts: int = 17            # points per dimension incl. boundary (-npts)
    mesh: int = 0             # 0 uniform, 1 cosine-y, 2 exp-y (-mesh)
    max_iter: int = 100_000   # outer iteration cap (-iter)
    grids: int = 2            # total coarsened grids (-grids)
    levels: int = 2           # solver levels (-levels)
    cycle: CycleType = CycleType.VCYCLE  # (-cycle)
    map_style: int = 2        # distributed layout (-map): 2 (reference
    # default, local-grid-after-grid) -> 1-D row partition + fused
    # distributed kernels; 0/1 -> 2-D block GSPMD plan (see poisson.py)
    v: tuple[int, int] = (3, 3)  # (fine/mid sweeps, coarsest sweeps) (-v)
    more_norm: bool = False   # per-grid inner residual monitors (-moreNorm)
    view_solver: bool = False  # per-level solver dump after the solve
    # (-view; the reference's always-on KSPView, src/solver.c:1560-1564)

    # TPU-framework knobs (no reference equivalent).
    problem: str = "poisson"  # "poisson" (5-pt, mesh metrics) | "aniso" (9-pt)
    aniso: tuple = (1.0, 0.0, 1.0, 0.0, 0.0)  # (ax0, ax2, cy0, cy2, b)
    smoother: SmootherType = SmootherType.JACOBI
    # Per-level smoother/sweep configuration — the reference's capability
    # of giving each level tier its own KSP/PC options via the ``fine_``/
    # ``levels_``/``coarse_`` option prefixes (reference:
    # src/solver.c:1476,1492,1509,1624-1648 KSPSetFromOptions per tier).
    # Tier overrides (None -> fall back to ``smoother``):
    fine_smoother: SmootherType | None = None    # level 0
    levels_smoother: SmootherType | None = None  # mid levels 1..L-2
    coarse_smoother: SmootherType | None = None  # coarsest level L-1
    # Explicit per-level override (len == levels; entries None fall back
    # to the tier/global resolution).  Wins over the tier fields.
    level_smoothers: tuple | None = None
    # Per-level sweep counts for the V-cycle family (len == levels);
    # None -> the reference's (v0 fine/mid, v1 coarsest) semantics.
    level_v: tuple | None = None
    composite_smoother: str = "block_gs"  # smoother on merged-grid levels
    backend: str = "auto"  # auto | xla | pallas (matrix-free kernel choice)
    # | sparse (explicit assembled CSR->DIA/ELL operator per level — the
    # reference's always-explicit matrix form, src/solver.c:489-556)
    coarse_solver: str = "auto"  # auto | direct | cg | smooth
    max_direct_size: int = 4096  # densify coarsest op up to this many unknowns
    coarse_cg_iters: int = 64
    omega: float = 0.8        # damped-Jacobi weight
    rtol: float = 1.0e-7      # relative-residual stop (src/solver.c:1530)
    divtol: float = 1.0e8     # divergence guard (src/solver.c:1530)
    dtype: str = "float64"    # "float32" | "float64" | "bfloat16"
    outer_dtype: str | None = None  # "float64" | "float32x2" over f32:
    # mixed-precision defect-correction outer loop (residuals/corrections
    # in outer_dtype, MG preconditioner in dtype) — certifies 1e-8
    # residuals on TPU where f32 alone hits its roundoff floor.
    # "float32x2" = double-single arithmetic (ops/twofloat.py): ~2^-47
    # precision at f32 bandwidth, ~40x faster per outer iteration than
    # emulated f64 on TPU; good up to ~8193^2 at rtol 1e-8
    history_len: int | None = None  # residual-history capacity (default: max_iter)
    fgmres_restart: int = 10  # FGMRES(m) restart length (memory: ~2m+1
    # fine-grid vectors live; lower it for very large grids)
    precond_dtype: str | None = None  # e.g. "bfloat16": run the MG V-cycle
    # preconditioner of the Krylov outers (mg-CG/FGMRES, incl. the mixed
    # f64 outer) in this dtype — halves the preconditioner's HBM traffic;
    # the outer Krylov iteration keeps full accuracy (a preconditioner
    # only shapes the rate)

    def validate(self) -> "SolverConfig":
        # Reference guards (src/poisson.c:61-71).
        if self.levels > 1 and self.cycle in (
            CycleType.D1CYCLE, CycleType.D2CYCLE, CycleType.D1PSCYCLE
        ):
            raise ValueError("delayed cycles (D1/D2/D1PS) require levels == 1")
        if (
            self.cycle == CycleType.ADDITIVE2
            and (self.grids > 2 or self.levels > 2)
        ):
            raise ValueError("Additive2 requires grids <= 2 and levels <= 2")
        if self.levels > self.grids:
            raise ValueError("levels cannot exceed grids")
        if self.history_len is not None and self.history_len < 1:
            raise ValueError("history_len must be >= 1")
        if (self.level_smoothers is not None
                and len(self.level_smoothers) != self.levels):
            raise ValueError("level_smoothers must have one entry per level")
        if self.level_v is not None:
            if len(self.level_v) != self.levels:
                raise ValueError("level_v must have one entry per level")
            if any(int(s) < 1 for s in self.level_v):
                raise ValueError("level_v entries must be >= 1")
        return self

    @property
    def hist_len(self) -> int:
        """Residual-history capacity (entries 0..hist_len)."""
        return self.history_len if self.history_len is not None else self.max_iter

    def smoother_at(self, l: int, n_levels: int) -> SmootherType:
        """Effective smoother for level ``l`` of ``n_levels``: explicit
        per-level entry, else tier override (fine_/levels_/coarse_), else
        the global ``smoother``."""
        if self.level_smoothers is not None:
            s = self.level_smoothers[l]
            if s is not None:
                return SmootherType(s)
        if l == 0 and self.fine_smoother is not None:
            return SmootherType(self.fine_smoother)
        if l == n_levels - 1 and n_levels > 1 and self.coarse_smoother is not None:
            return SmootherType(self.coarse_smoother)
        if 0 < l < n_levels - 1 and self.levels_smoother is not None:
            return SmootherType(self.levels_smoother)
        return self.smoother

    def sweeps_at(self, l: int, n_levels: int) -> int:
        """Effective sweep count for level ``l``'s visits: ``level_v[l]``
        when set, else the reference's (v0 fine/mid, v1 coarsest) rule."""
        if self.level_v is not None:
            return int(self.level_v[l])
        return self.v[1] if (l == n_levels - 1 and n_levels > 1) else self.v[0]

    @property
    def max_sweeps(self) -> int:
        """Largest sweep count any level visit can request (halo-carry
        viability checks for the fused kernels)."""
        m = max(self.v)
        if self.level_v is not None:
            m = max(m, max(int(s) for s in self.level_v))
        return m


_KEY_MAP = {
    "npts": ("npts", int),
    "mesh": ("mesh", int),
    "iter": ("max_iter", int),
    "grids": ("grids", int),
    "levels": ("levels", int),
    "map": ("map_style", int),
    "moreNorm": ("more_norm", lambda s: bool(int(s))),
    "view": ("view_solver", lambda s: bool(int(s))),
}


def parse_options_file(path: str | Path, base: SolverConfig | None = None) -> SolverConfig:
    """Parse a poisson.in-style options file: lines of ``-key value``,
    ``#`` comments (reference: poisson.in:1-14)."""
    return parse_options(Path(path).read_text().splitlines(), base)


def parse_options(lines, base: SolverConfig | None = None) -> SolverConfig:
    """Apply ``-key value`` lines (``#`` comments, unknown keys ignored)
    to ``base`` and validate the result."""
    cfg = base or SolverConfig()
    updates = {}
    for raw in lines:
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        if len(parts) < 2 or not parts[0].startswith("-"):
            continue
        key, val = parts[0][1:], parts[1]
        if key == "cycle":
            updates["cycle"] = CycleType(int(val))
        elif key == "v":
            nums = [int(x) for x in val.split(",")]
            updates["v"] = (nums[0], nums[1] if len(nums) > 1 else nums[0])
        elif key == "smoother":
            updates["smoother"] = SmootherType(val)
        elif key in ("fine_smoother", "levels_smoother", "coarse_smoother"):
            # Reference analogue: the fine_/levels_/coarse_ KSP option
            # prefixes (src/solver.c:1624-1648).
            updates[key] = SmootherType(val)
        elif key == "level_smoothers":
            updates["level_smoothers"] = tuple(
                None if s in ("", "-") else SmootherType(s)
                for s in val.split(",")
            )
        elif key == "level_v":
            updates["level_v"] = tuple(int(x) for x in val.split(","))
        elif key == "omega":
            updates["omega"] = float(val)
        elif key == "rtol":
            updates["rtol"] = float(val)
        elif key == "dtype":
            updates["dtype"] = val
        elif key == "outer_dtype":
            updates["outer_dtype"] = val
        elif key == "backend":
            updates["backend"] = val
        elif key == "coarse":
            updates["coarse_solver"] = val
        elif key == "problem":
            updates["problem"] = val
        elif key == "aniso":
            updates["aniso"] = tuple(float(x) for x in val.split(","))
        elif key in _KEY_MAP:
            name, conv = _KEY_MAP[key]
            updates[name] = conv(val)
        # Unknown keys are ignored, like unconsumed PETSc options.
    return replace(cfg, **updates).validate()
