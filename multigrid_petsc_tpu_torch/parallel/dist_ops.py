"""The operators of one row-sharded level: K17 on this rank's row block,
halo rows from the neighbours (PyTorch counterpart of
``multigrid_petsc_tpu/parallel/dist_ops.py``: ``dist_viable`` :37-47,
``DistLevelOps`` :50-167; reference: every MatMult a halo exchange on the
row partition, src/solver.c:1516,1535,1540).

State convention: a sharded level has ny + 1 rows (one pad row, the last
rank's last row, always 0); each rank holds its (R, nx) block of global
rows [row0, row0 + R), R = (ny + 1) / P.  Every operation exchanges the
rows its visit needs (``halo_rows``) and runs one K17 visit
(``ops.cuda.dist_kernel.row_visit_split``), so the smoother's k sweeps,
the residual and the transfer gap ride one exchange.  As JAX runs it,
where JAX's row tile t cuts the block into R / t >= 3 tiles the visit is
three launches: the interior rows [t, R - t) while the exchange is in
flight, then the edge rows [0, t) and [R - t, R), which read the
exchanged rows; a block of fewer tiles waits for the exchange and runs
one launch.  The
coarse correction of an up visit is the coarse level's block (its halo
exchanged) or, under a replicated coarse level, the whole coarse grid, of
which this rank cuts its rows and their halo without an exchange.

A level whose block cannot carry a visit's halo (``dist_viable`` false:
JAX sends such a level to GSPMD) stays sharded: a Jacobi schedule runs as
visits of at most R - 2 steps, one exchange each (``_visit_steps``); a
schedule with momentum (Chebyshev: beta != 0, which a visit does not
carry across its end) runs one residual emit per step.  The smoothers
without a fused visit run on the block too (JAX's GSPMD arithmetic on
the rank's rows): red-black Gauss-Seidel as masked half-sweeps over the
residual emit, its colours by the global parity row0 + i + j; x-line
Jacobi as K15 on the transposed block and its two neighbour rows (the
lines lie in the block); y-line Jacobi, whose lines cross the ranks, as
K15's rank-spanning mode (``line_kernel.line_rows_*``), one all-gather of
the segment carries per sweep.  The transfers between two sharded levels
are block-local (``restrict``, ``prolong``: one exchanged row).

A merged level under a plan (``DistMergedOps``) holds one operator set
per grid the plan shards, in the plan's layout (``DistLevelOps`` under
rows, ``block_ops.BlockLevelOps`` under blocks), and keeps the others
whole: A_f and the Jacobi steps of a sharded grid are K17 visits on its
block, those of a replicated grid K6 and K7.  Its multi-gap transfers
(``restrict_steps``, ``prolong_steps``) go one gap at a time, each in the
layout of the size it lands on: between two sharded sizes block-local
(one exchanged row; under blocks a row, a column and their corner), onto
a size sharded along fewer axes (rows: replicated) the restricted blocks
gathered along what is lost ("agglomerate"), and into a sharded size the
block cut from what the rank holds of the coarse size.  A one-gap step
over a block and its halo computes the entries of the whole-grid step,
operation for operation.
"""

from __future__ import annotations

import torch

from multigrid_petsc_tpu_torch.ops.cuda import line_kernel as lk
from multigrid_petsc_tpu_torch.ops.cuda.dist_kernel import (
    Halo,
    coarse_halo_rows,
    halo_rows,
    pick_tile,
    row_visit_split,
)
from multigrid_petsc_tpu_torch.ops.composite import GridOps
from multigrid_petsc_tpu_torch.ops.norms import unflatten
from multigrid_petsc_tpu_torch.ops.stencil import Stencil9
from multigrid_petsc_tpu_torch.ops.transfer import prolong_bilinear, restrict_fw
from multigrid_petsc_tpu_torch.parallel.block_ops import (
    BlockLevelOps,
    block_prolong,
    block_restrict,
)
from multigrid_petsc_tpu_torch.parallel.halo import (
    all_gather_lines,
    all_gather_rows,
    allreduce_sum,
    edge_exchange,
    edge_exchange_start,
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


def _cut_rows(st, lo: int, hi: int):
    """The stencil's coefficients that vary with y cut to rows [lo, hi)."""
    return type(st)(*(c if c.shape[0] == 1 else c[lo:hi].contiguous()
                      for c in st))


def _restrict_block(r: torch.Tensor, ny: int, plan) -> torch.Tensor:
    """One full weighting of the row block ``r`` of a sharded grid of
    ``ny`` rows: the (R / 2)-row coarse block from the block and the next
    rank's first row, the coarse pad row 0."""
    R = (ny + 1) // plan.size
    if R % 2:
        raise ValueError(f"an odd block of {R} rows has no coarse block")
    nxt = edge_exchange(r, 1, plan).bot
    rc = restrict_fw(torch.cat([r, nxt]))
    c_real = (ny - 1) // 2 - plan.rank * R // 2
    if c_real < rc.shape[0]:
        rc[max(c_real, 0):] = 0.0
    return rc


def _prolong_block(e: torch.Tensor, ny: int, plan,
                   coarse_block: bool) -> torch.Tensor:
    """One bilinear prolongation onto the row block of a sharded grid of
    ``ny`` rows, from the coarse grid's block (``coarse_block``: its row
    above exchanged) or from the whole coarse grid (its rows cut, no
    exchange); the pad row 0."""
    R = (ny + 1) // plan.size
    row0 = plan.rank * R
    c0, Rc = row0 // 2, R // 2
    nyc = (ny - 1) // 2
    if coarse_block:
        ext = torch.cat([edge_exchange(e, 1, plan).top, e])
        if c0 + Rc > nyc:  # the coarse pad row counts as 0
            ext = ext.clone()
            ext[1 + max(nyc - c0, 0):] = 0.0
    else:
        ext = _rows(e, c0 - 1, c0 + Rc)
    pe = prolong_bilinear(ext)[2:R + 2]
    nyl = min(R, ny - row0)
    if nyl < R:
        pe[nyl:] = 0.0
    return pe


def _shards(plan, ny: int, nx: int) -> bool:
    return plan is not None and plan.shards(ny, nx)


def restrict_steps(x: torch.Tensor, ny: int, nx: int, gap: int,
                   plan) -> torch.Tensor:
    """``gap`` full weightings of ``x``, which lies on an (ny, nx) grid:
    its block where ``plan`` (None: one device) shards that grid, else
    the whole grid; the result in the layout of the size it lands on.  A
    step from a sharded size is block-local, and the coarse blocks are
    gathered along what the next size stops being split on
    ("agglomerate"): under the rows layout at the first replicated size,
    under the blocks layout along each axis it loses
    (``block_ops.block_restrict``); below that the steps run whole
    (``restrict_multi``)."""
    for _ in range(gap):
        nyc, nxc = (ny - 1) // 2, (nx - 1) // 2
        if not _shards(plan, ny, nx):
            x = restrict_fw(x)
        elif plan.layout == "blocks":
            x = block_restrict(x, ny, nx, plan)
        else:
            x = _restrict_block(x, ny, plan)
            if not _shards(plan, nyc, nxc):
                x = all_gather_rows(x, plan, "agglomerate")[:nyc]
        ny, nx = nyc, nxc
    return x


def prolong_steps(x: torch.Tensor, ny: int, nx: int, gap: int,
                  plan) -> torch.Tensor:
    """``gap`` bilinear prolongations of ``x`` from an (ny, nx) grid, in
    the layout ``restrict_steps`` reads: into a size the plan shards the
    block (cut from what the rank holds of the coarse size, exchanged only
    along the axes that size is split on), into a replicated size the
    whole grid (``prolong_multi``)."""
    for _ in range(gap):
        nyf, nxf = 2 * ny + 1, 2 * nx + 1
        if not _shards(plan, nyf, nxf):
            x = prolong_bilinear(x)
        elif plan.layout == "blocks":
            x = block_prolong(x, nyf, nxf, plan)
        else:
            x = _prolong_block(x, nyf, plan, _shards(plan, ny, nx))
        ny, nx = nyf, nxf
    return x


class DistLevelOps:
    """K17 operator set of one single-grid row-sharded level on this
    rank.  ``st`` is the level's whole stencil; a 9-point stencil keeps
    only the rows of its coefficients that vary with y which this rank's
    visits read (the block and ``max_sweeps + 2`` rows on each side)."""

    def __init__(self, st, ny: int, nx: int, plan, max_sweeps: int,
                 tile_cap: int | None = None):
        self.ny, self.nx = ny, nx
        # JAX's row tile cap (its tests force small tiles, and so the
        # split, with it); None: JAX's 256.
        self.tile_cap = tile_cap
        self._launches = {}  # K17's launch arguments, per piece
        self.plan = plan
        self.P = plan.size
        self.R = (ny + 1) // self.P
        self.row0 = plan.rank * self.R
        # The rows of the block inside the domain (the pad row is not).
        self.nyl = min(self.R, ny - self.row0)
        self.viable = dist_viable(ny, self.P, max_sweeps, nx=nx)
        # The centre coefficient on the block, the pad row the identity,
        # as JAX pads its Jacobi diagonal.
        cc = st.cc.expand(ny, -1)
        self.cc = self.block_of(torch.cat([cc, torch.ones_like(cc[:1])]))
        self.dinv = 1.0 / self.cc
        self.coeff_row0 = 0
        if isinstance(st, Stencil9):
            m = max_sweeps + 2
            lo = max(0, self.row0 - m)
            st = _cut_rows(st, lo, min(ny, self.row0 + self.R + m))
            self.coeff_row0 = lo
        self.st = st
        self.rb_dinv = None      # RBGS: (red, black) omega / cc on the block
        self.line_y = None       # LINE_Y: lk.RowLine
        self.line_x = None       # LINE_X: (stencil, factor, rows lo, hi)

    # -- layout ---------------------------------------------------------

    @property
    def block_shape(self) -> tuple[int, int]:
        return (self.R, self.nx)

    def block_of(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's (R, w) rows of a whole (ny, w) grid, the pad row 0."""
        return _rows(x, self.row0, self.row0 + self.R).contiguous()

    def real(self, x: torch.Tensor) -> torch.Tensor:
        """The block's rows inside the domain (the pad row cut)."""
        return x[:self.nyl]

    # Every rank holds distinct rows: sums run over the plan's group.
    sum_group = None

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the ranks."""
        return allreduce_sum(x, self.plan)

    def gather(self, x: torch.Tensor, what: str) -> torch.Tensor:
        """The whole grid from every rank's rows, on every rank
        (collective; counted under ``what``)."""
        return all_gather_rows(x, self.plan, what)[:self.ny]

    def gathered(self, solve):
        """``solve`` of the whole level run on this rank's block: the
        blocks gathered ("coarsest"), the solve, this rank's rows of it
        (a coarsest level JAX shards through GSPMD and solves directly;
        collective)."""
        return lambda b: self.block_of(solve(self.gather(b, "coarsest")))

    def gather_coarse(self, rc: torch.Tensor) -> torch.Tensor:
        """The whole coarse grid ((ny - 1) / 2 rows) from every rank's
        (R / 2)-row coarse block, the coarse pad row dropped: the rows of
        the replicated level below (collective)."""
        return all_gather_rows(rc, self.plan,
                               "agglomerate")[:(self.ny - 1) // 2]

    def to_coarse(self, rc: torch.Tensor) -> torch.Tensor:
        """The coarse level's part of ``rc``: the coarse block where the
        plan shards the coarse level, else the gathered whole grid."""
        if self.plan.shards((self.ny - 1) // 2, (self.nx - 1) // 2):
            return rc
        return self.gather_coarse(rc)

    # -- the visit --------------------------------------------------------

    def _visit(self, b, u, steps, emit, e=None):
        """One K17 visit as JAX runs it: the exchanges started, then, where
        JAX's tile cuts the block into g >= 3 tiles, the interior launch,
        the exchanges' wait and the edge launches; else the wait and one
        launch (``dist_kernel.row_visit_split``).  A visit JAX's rule
        finds no tile for (a chunk of a level that cannot carry its
        halo) runs whole."""
        h = halo_rows(len(steps), emit)
        if h > self.R:
            raise ValueError(f"a halo of {h} rows exceeds the {self.R}-row "
                             f"block")
        blk = u if b is None else b
        t = pick_tile(self.R, h, nx=self.nx, itemsize=blk.element_size(),
                      cap=self.tile_cap or 256)
        if emit in ("a", "r"):
            names, xs = ("u",), u
        elif u is None:
            names, xs = ("b",), b
        else:
            names, xs = ("u", "b"), (u, b)
        pending = [(names, edge_exchange_start(xs, h, self.plan))]
        e_halo = None
        if e is not None:
            hc = coarse_halo_rows(h)
            Rc = self.R // 2
            if e.shape[0] == Rc:  # the coarse level's block
                pending.append((("e",), edge_exchange_start(e, hc,
                                                            self.plan)))
            else:  # the whole replicated coarse grid: cut, no exchange
                c0 = self.row0 // 2
                e_halo = Halo(_rows(e, c0 - hc, c0), _rows(e, c0 + Rc,
                                                           c0 + Rc + hc))
                e = _rows(e, c0, c0 + Rc)

        def halos():
            got = {} if e_halo is None else {"e": e_halo}
            for nms, p in pending:
                hs = p.wait()
                got.update(zip(nms, hs if isinstance(hs, list) else [hs]))
            return got

        return row_visit_split(self.st, b, u, steps, emit, row0=self.row0,
                               ny=self.ny, t=t, halos=halos, e=e,
                               coeff_row0=self.coeff_row0,
                               prepared=self._launches)

    def _visit_steps(self, b, u, steps, emit, e=None):
        """A visit of ``steps``: one K17 visit where the block carries its
        halo (``viable``); else Jacobi's in visits of at most R - 2 steps
        (the last one emitting), a schedule with momentum one residual
        emit per step."""
        if self.viable:
            return self._visit(b, u, steps, emit, e)
        c = self.R - 2
        if c >= 1 and all(bt == 0 for _, bt in steps):
            parts = [steps[i:i + c] for i in range(0, len(steps), c)]
            for part in parts[:-1]:
                u, e = self._visit(b, u, part, "u", e), None
            return self._visit(b, u, parts[-1], emit, e)
        u = self.zeros() if u is None else u
        if e is not None:
            u = u + self.prolong(e)
        p = None
        for a, bt in steps:
            z = self.dinv * self.residual(b, u)
            p = a * z if p is None else bt * p + a * z
            u = u + p
        if emit == "u":
            return u
        r = self.residual(b, u)
        return (u, r) if emit == "ur" else (u, self.restrict(r))

    def zeros(self) -> torch.Tensor:
        return self.dinv.new_zeros((self.R, self.nx))

    # -- level operators (JAX dist_ops.py:142-167) ------------------------

    def apply(self, u):
        return self._visit(None, u, (), "a")

    def residual(self, b, u):
        return self._visit(b, u, (), "r")

    def smooth(self, b, u, steps):
        return self._visit_steps(b, u, steps, "u")

    def visit_down(self, b, u, steps):
        """(u', R(b - A u')) from u (None: the zero guess)."""
        return self._visit_steps(b, u, steps, "rc")

    def visit_up(self, b, u, e, steps, emit_r: bool = False):
        """u += P e -> smooth [-> residual]."""
        return self._visit_steps(b, u, steps, "ur" if emit_r else "u", e)

    # -- block-local transfers ---------------------------------------------

    def restrict(self, r: torch.Tensor) -> torch.Tensor:
        """The (R / 2, (nx - 1) / 2) coarse block of R r (full weighting):
        the block and the next rank's first row; the coarse pad row 0."""
        return _restrict_block(r, self.ny, self.plan)

    def prolong(self, e: torch.Tensor) -> torch.Tensor:
        """P e on the block (bilinear): ``e`` the coarse level's (R / 2)-row
        block (its row above exchanged) or the whole replicated coarse
        grid (cut, no exchange); the pad row 0."""
        return _prolong_block(e, self.ny, self.plan,
                              e.shape[0] == self.R // 2)

    # -- the smoothers without a fused visit -------------------------------

    def setup_rbgs(self, omega: float) -> None:
        """RBGS's masked omega / cc on the block: red where the global
        parity row0 + i + j is even; 0 on the pad row."""
        ii = torch.arange(self.R, device=self.dinv.device)[:, None]
        jj = torch.arange(self.nx, device=self.dinv.device)[None, :]
        red = (self.row0 + ii + jj) % 2 == 0
        d = (omega / self.cc).expand(self.R, self.nx).clone()
        d[self.nyl:] = 0.0
        zero = torch.zeros((), dtype=d.dtype, device=d.device)
        self.rb_dinv = (torch.where(red, d, zero), torch.where(red, zero, d))

    def rbgs(self, b, u, sweeps: int):
        """Red-black Gauss-Seidel, JAX ``sor_redblack_sweeps``: per
        half-sweep the residual emit and u + (omega / cc) r on one
        colour."""
        for _ in range(sweeps):
            for d in self.rb_dinv:
                u = torch.addcmul(u, d, self.residual(b, u))
        return u

    def setup_line_y(self, line_st: Stencil9) -> None:
        """The rank-spanning y-lines of the level's collapsed whole-grid
        line stencil."""
        self.line_y = lk.row_line(line_st, self.ny, self.R, self.row0)

    def line_y_sweeps(self, b, u, sweeps: int, omega: float):
        """Damped y-line Jacobi (JAX ``line_jacobi_sweeps_y``) over the
        whole columns: per sweep the iterate's neighbour rows, one
        all-gather of what ``line_rows_begin`` gives, and the block's
        update."""
        lf = self.line_y
        for _ in range(sweeps):
            halo = edge_exchange(u, 1, self.plan)
            mine = lk.line_rows_begin(lf, b, u, halo)
            every = lk.stack_lines(lf, all_gather_lines(
                mine, self.plan, lk.gathered_rows(lf))).to(u.device)
            u = lk.line_rows_end(lf, b, u, halo, every, omega)
        return u

    def setup_line_x(self, line_st_x: Stencil9) -> None:
        """x-line Jacobi's transposed stencil and factors on the block's
        real rows and the neighbour rows inside the domain, [lo, hi) (the
        columns of the transposed block)."""
        lo = max(self.row0 - 1, 0)
        hi = min(self.row0 + self.R + 1, self.ny)
        st = Stencil9(*(c if c.shape[1] == 1 else c[:, lo:hi].contiguous()
                        for c in line_st_x))
        self.line_x = (st, lk.line_factor(st, self.nx), lo, hi)

    def line_x_sweeps(self, b, u, sweeps: int, omega: float):
        """Damped x-line Jacobi (JAX ``line_jacobi_sweeps_x``): its lines
        lie in the block, so a sweep is one exchanged row on each side and
        K15 on the transposed block with those rows (whose own lines are
        solved and dropped)."""
        st, fac, lo, hi = self.line_x
        r0, nyl = self.row0, self.nyl
        bt = torch.zeros((hi - lo, self.nx), dtype=b.dtype, device=b.device)
        bt[r0 - lo:r0 - lo + nyl] = b[:nyl]
        bt = bt.T.contiguous()
        for _ in range(sweeps):
            top, bot = edge_exchange(u, 1, self.plan)
            ext = torch.cat([top[:r0 - lo], u[:nyl],
                             bot[:hi - r0 - nyl]]).T.contiguous()
            out = lk.line_visit9(st, bt, ext, 1, omega, fac=fac)
            u = torch.zeros_like(u)
            u[:nyl] = out.T[r0 - lo:r0 - lo + nyl]
        return u


class DistMergedOps(GridOps):
    """The per-grid operators of a merged level under a plan, each grid
    in the plan's layout (``ops[k]``): a ``DistLevelOps`` (rows) or
    ``BlockLevelOps`` (blocks) for each grid the plan shards, None for a
    replicated grid, held whole on every rank; the transfers
    ``restrict_steps`` / ``prolong_steps``; and the level's inner
    product: each sharded grid's local dot summed over the ranks that
    hold its distinct blocks, the replicated grids' added once."""

    def __init__(self, stencils, grids, plan, max_sweeps: int):
        super().__init__(stencils, tuple(g.g for g in grids))
        self.plan = plan
        self.grids = tuple(grids)
        level_ops = BlockLevelOps if plan.layout == "blocks" else DistLevelOps
        self.ops = tuple(
            level_ops(st, g.ny, g.nx, plan, max_sweeps)
            if plan.shards(g.ny, g.nx) else None
            for st, g in zip(stencils, grids))
        self.stencils = tuple(st if d is None else d.st
                              for st, d in zip(stencils, self.ops))
        self.dinv = tuple(1.0 / st.cc if d is None else d.dinv
                          for st, d in zip(self.stencils, self.ops))

    @property
    def sharded(self) -> tuple[bool, ...]:
        return tuple(d is not None for d in self.ops)

    @property
    def state_shapes(self) -> list[tuple[int, int]]:
        return [g.shape if d is None else d.block_shape
                for g, d in zip(self.grids, self.ops)]

    def apply(self, k: int, x):
        d = self.ops[k]
        return super().apply(k, x) if d is None else d.apply(x)

    def smooth(self, k: int, b, x, steps):
        d = self.ops[k]
        return super().smooth(k, b, x, steps) if d is None \
            else d.smooth(b, x, steps)

    def restrict(self, x, kf: int, kc: int):
        g = self.grids[kf]
        return restrict_steps(x, g.ny, g.nx, self.grids[kc].g - g.g,
                              self.plan)

    def prolong(self, x, kc: int, kf: int):
        g = self.grids[kc]
        return prolong_steps(x, g.ny, g.nx, g.g - self.grids[kf].g,
                             self.plan)

    def _dots(self, pairs, ops):
        """The sum of the grids' dots: the sharded ones' local dots summed
        by the group over which each grid's blocks are distinct
        (``sum_group``: under rows the world, one all-reduce; under blocks
        also a mesh column or row), one all-reduce per group in the order
        the grids first name it; the replicated ones' as they are."""
        groups, rep = {}, None
        for (x, y), d in zip(pairs, ops):
            v = torch.dot(x.reshape(-1), y.reshape(-1))
            if d is None:
                rep = v if rep is None else rep + v
            else:
                key = id(d.sum_group)
                g = groups.setdefault(key, [d, None])
                g[1] = v if g[1] is None else g[1] + v
        loc = None
        for d, v in groups.values():
            v = d.sum(v)
            loc = v if loc is None else loc + v
        return loc if rep is None else (rep if loc is None else loc + rep)

    def dot(self, x, y):
        if isinstance(x, torch.Tensor):  # a flat state (FGMRES's vectors)
            x, y = (unflatten(v, self.state_shapes) for v in (x, y))
        return self._dots(zip(x, y), self.ops)

    def grid_norm(self, k: int, x):
        return torch.sqrt(self._dots([(x, x)], [self.ops[k]]))

    def local(self, state) -> tuple:
        """This rank's part of a whole state: each sharded grid's block
        (a grid already cut to its block kept), each replicated grid."""
        return tuple(x if d is None or tuple(x.shape) == d.block_shape
                     else d.block_of(x) for x, d in zip(state, self.ops))

    def real_rows(self, state) -> tuple:
        """The state without the pads: each block's points inside its
        grid."""
        return tuple(x if d is None else d.real(x)
                     for x, d in zip(state, self.ops))

    def gathered(self, solve):
        """``solve`` of the whole level run on this rank's part: the
        sharded grids gathered ("coarsest"), the solve, this rank's part
        of it (a merged coarsest level solved directly; collective)."""
        def run(b):
            whole = tuple(x if d is None else d.gather(x, "coarsest")
                          for x, d in zip(b, self.ops))
            return self.local(solve(whole))

        return run
