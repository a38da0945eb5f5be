"""Grid hierarchy and level structure.

PyTorch-package counterpart of ``multigrid_petsc_tpu/hierarchy.py``
(reference: src/matbuild.c:27-105): ``total_grids`` coarsened grids are
distributed over ``levels`` solver levels, one grid per level with all
leftover grids merged into the last level.  Grid g has
(npts-1)/2^g - 1 interior points per dimension.
"""

from __future__ import annotations

from dataclasses import dataclass

COARSENING_FACTOR = 2  # reference: src/poisson.c:91


@dataclass(frozen=True)
class GridSpec:
    """One grid of the hierarchy (g = 0 is finest)."""

    g: int
    ny: int
    nx: int

    @property
    def hx(self) -> float:
        return 1.0 / (self.nx + 1)

    @property
    def hy(self) -> float:
        return 1.0 / (self.ny + 1)

    @property
    def shape(self):
        return (self.ny, self.nx)


@dataclass(frozen=True)
class LevelSpec:
    """A solver level: one or more grids merged into one coupled system,
    ordered finest first (src/matbuild.c:40-46)."""

    grids: tuple[GridSpec, ...]

    @property
    def gids(self) -> tuple[int, ...]:
        return tuple(g.g for g in self.grids)

    @property
    def primary(self) -> GridSpec:
        """The level's finest grid (src/solver.c:1037)."""
        return self.grids[0]

    @property
    def is_composite(self) -> bool:
        return len(self.grids) > 1


def grid_interior(npts: int, g: int) -> int:
    """Interior points per dimension of grid g (src/matbuild.c:64-67)."""
    return (npts - 1) // (COARSENING_FACTOR**g) - 1


def build_hierarchy(npts: int, total_grids: int, levels: int) -> list[LevelSpec]:
    """Grid l on level l, leftovers on the last level
    (src/matbuild.c:27-47 GridId)."""
    if levels > total_grids:
        raise ValueError(
            f"levels ({levels}) cannot exceed total grids ({total_grids})"
        )
    for g in range(total_grids):
        n = grid_interior(npts, g)
        if n < 1 or (npts - 1) % (COARSENING_FACTOR**g) != 0:
            raise ValueError(
                f"npts={npts} cannot support grid {g}: need (npts-1) divisible "
                f"by {COARSENING_FACTOR**g} with at least 1 interior point"
            )

    out: list[LevelSpec] = []
    gid = 0
    for l in range(levels):
        count = 1 if l < levels - 1 else total_grids - (levels - 1)
        grids = tuple(
            GridSpec(g=gid + k, ny=grid_interior(npts, gid + k),
                     nx=grid_interior(npts, gid + k))
            for k in range(count)
        )
        gid += count
        out.append(LevelSpec(grids=grids))
    return out
