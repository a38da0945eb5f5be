"""The operators of one row-sharded level: K17 on this rank's row block,
halo rows from the neighbours (PyTorch counterpart of
``multigrid_petsc_tpu/parallel/dist_ops.py``: ``dist_viable`` :37-47,
``DistLevelOps`` :50-167; reference: every MatMult a halo exchange on the
row partition, src/solver.c:1516,1535,1540).

State convention: a sharded level has ny + 1 rows (one pad row, the last
rank's last row, always 0); each rank holds its (R, nx) block of global
rows [row0, row0 + R), R = (ny + 1) / P.  Every operation exchanges the
rows its visit needs (``halo_rows``) and launches one K17 visit
(``ops.cuda.dist_kernel.row_visit``), so the smoother's k sweeps, the
residual and the transfer gap ride one exchange and one kernel.  The
coarse correction of an up visit is the coarse level's block (its halo
exchanged) or, under a replicated coarse level, the whole coarse grid, of
which this rank cuts its rows and their halo without an exchange.
"""

from __future__ import annotations

import torch

from multigrid_petsc_tpu_torch.ops.cuda.dist_kernel import (
    Halo,
    coarse_halo_rows,
    halo_rows,
    pick_tile,
    row_visit,
)
from multigrid_petsc_tpu_torch.ops.stencil import Stencil9
from multigrid_petsc_tpu_torch.parallel.halo import (
    all_gather_rows,
    edge_exchange,
)


def dist_viable(ny: int, n_ranks: int, max_sweeps: int,
                nx: int | None = None) -> bool:
    """Can a (ny, nx) level run the row-block path on ``n_ranks``?  ny + 1
    divisible by the rank count, an even block, and JAX's row tile for the
    largest halo (max_sweeps + 2 rows); the tile's VMEM budget term never
    binds at <= 8191 columns and is kept so the level split matches
    JAX's (ROADMAP: kept for parity)."""
    if (ny + 1) % n_ranks:
        return False
    R = (ny + 1) // n_ranks
    if R % 2:
        return False
    return pick_tile(R, halo_rows(max_sweeps, "rc"), nx=nx) is not None


def _rows(x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Rows [lo, hi) of x, zeros where they fall outside it."""
    out = x.new_zeros((hi - lo, x.shape[1]))
    a, b = max(lo, 0), min(hi, x.shape[0])
    if a < b:
        out[a - lo:b - lo] = x[a:b]
    return out


class DistLevelOps:
    """K17 operator set of one single-grid row-sharded level on this
    rank.  ``st`` is the level's whole stencil; a 9-point stencil keeps
    only the rows of its coefficients that vary with y which this rank's
    visits read (the block and ``max_sweeps + 2`` rows on each side)."""

    def __init__(self, st, ny: int, nx: int, plan, max_sweeps: int):
        self.ny, self.nx = ny, nx
        self.plan = plan
        self.P = plan.size
        self.R = (ny + 1) // self.P
        self.row0 = plan.rank * self.R
        self.coeff_row0 = 0
        if isinstance(st, Stencil9):
            m = max_sweeps + 2
            lo = max(0, self.row0 - m)
            hi = min(ny, self.row0 + self.R + m)
            st = Stencil9(*(c if c.shape[0] == 1 else c[lo:hi].contiguous()
                            for c in st))
            self.coeff_row0 = lo
        self.st = st

    # -- layout ---------------------------------------------------------

    def block_of(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's (R, w) rows of a whole (ny, w) grid, the pad row 0."""
        return _rows(x, self.row0, self.row0 + self.R).contiguous()

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The whole (ny, nx) grid from every rank's block (collective)."""
        return all_gather_rows(x, self.plan)[:self.ny]

    def gather_coarse(self, rc: torch.Tensor) -> torch.Tensor:
        """The whole coarse grid ((ny - 1) / 2 rows) from every rank's
        (R / 2)-row coarse block, the coarse pad row dropped
        (collective)."""
        return all_gather_rows(rc, self.plan)[:(self.ny - 1) // 2]

    # -- the visit --------------------------------------------------------

    def _visit(self, b, u, steps, emit, e=None):
        h = halo_rows(len(steps), emit)
        if h > self.R:
            raise ValueError(f"a halo of {h} rows exceeds the {self.R}-row "
                             f"block")
        b_halo = u_halo = e_halo = None
        if emit in ("a", "r"):
            u_halo = edge_exchange(u, h, self.plan)
        elif u is None:
            b_halo = edge_exchange(b, h, self.plan)
        else:
            u_halo, b_halo = edge_exchange((u, b), h, self.plan)
        if e is not None:
            hc = coarse_halo_rows(h)
            Rc = self.R // 2
            if e.shape[0] == Rc:  # the coarse level's block
                e_halo = edge_exchange(e, hc, self.plan)
            else:  # the whole replicated coarse grid: cut, no exchange
                c0 = self.row0 // 2
                e_halo = Halo(_rows(e, c0 - hc, c0), _rows(e, c0 + Rc,
                                                           c0 + Rc + hc))
                e = _rows(e, c0, c0 + Rc)
        return row_visit(self.st, b, u, steps, emit, row0=self.row0,
                         ny=self.ny, b_halo=b_halo, u_halo=u_halo, e=e,
                         e_halo=e_halo, coeff_row0=self.coeff_row0)

    # -- level operators (JAX dist_ops.py:142-167) ------------------------

    def apply(self, u):
        return self._visit(None, u, (), "a")

    def residual(self, b, u):
        return self._visit(b, u, (), "r")

    def smooth(self, b, u, steps):
        return self._visit(b, u, steps, "u")

    def visit_down(self, b, u, steps):
        """(u', R(b - A u')) from u (None: the zero guess)."""
        return self._visit(b, u, steps, "rc")

    def visit_up(self, b, u, e, steps, emit_r: bool = False):
        """u += P e -> smooth [-> residual]."""
        return self._visit(b, u, steps, "ur" if emit_r else "u", e)
