"""The operators of one level under the 2-D blocks layout: K17's 2-D block
mode on this rank's block, its halo from the mesh neighbours (PyTorch
counterpart of the GSPMD levels of the JAX package's blocks plan,
``parallel/device_mesh.py`` ``ShardingPlan.spec`` :76-93 and
``parallel/halo.py`` ``halo_pad_local`` / ``apply_stencil5_local``
:31-74).

JAX runs every level of a blocks plan as plain ``jnp`` ops under GSPMD,
which inserts the halo collectives itself, and keeps its Pallas kernels
off any level split over more than one device (``solvers/context.py``
``_use_pallas`` :318, ``_use_dist`` :360).  The port runs a level the
plan splits on its rank's block through K17's 2-D block mode
(``ops.cuda.dist_kernel.block_visit``), so the smoother's k sweeps, the
residual and the transfer gap of a visit ride one halo exchange and one
kernel, as under the rows layout (``parallel.dist_ops.DistLevelOps``,
whose interface this class keeps).

State convention: a level split along y keeps ny + 1 rows (one pad row,
the last mesh row's last row, always 0), split along x nx + 1 columns;
each rank holds its (R, C) block from the global point (row0, col0), R
its mesh row's share of the ny + 1 rows along a split y axis (the nested
even blocks of ``device_mesh.block_sides``: on any rank count, the
blocks of one axis may differ by whole pairs of points) and ny along one
that is not (the block then spans every row, and the ranks of a mesh
column hold the same block), likewise C.  Every operation exchanges the
ring its visit needs (``parallel.halo.block_exchange``: the corners
travel, a fused k-sweep visit reads them) and launches one K17 visit.  The coarse correction of
an up visit is the coarse level's block (its ring exchanged) or, where
the coarse level is split along fewer axes, the coarse block of this
block and its ring cut from what the rank holds (no exchange along an
axis the coarse level keeps whole).

A level whose blocks cannot carry a visit's halo runs Jacobi as visits of
at most (the smallest split extent of any rank's block - 2) steps, one
exchange each (every rank takes the same schedule); a schedule with
momentum (Chebyshev) one residual emit per step.  The
transfers between two split levels are block-local (``restrict_local``,
``block_prolong``: one exchanged row, one column and their corner); from
a level to one split along fewer axes, the restricted blocks are gathered
along the axes that stop being split (``agglomerate``).  These need only
the geometry ``plan.block`` gives, so a merged level's multi-gap
couplings and transfers (``dist_ops.restrict_steps`` / ``prolong_steps``)
run them one gap at a time, in each grid's own layout.

The smoothers without a fused visit run on the block too (JAX's GSPMD
arithmetic on the rank's points), with ``DistLevelOps``'s interface:
red-black Gauss-Seidel as masked half-sweeps over K17's residual emit,
its colours by the global parity row0 + col0 + i + j; y-line Jacobi as
K15's 2-D block mode (``line_kernel.line_rows_*`` with the block's ring),
its lines across the mesh column, one all-gather of the segment ends over
the mesh column per sweep; x-line Jacobi as the same mode on the
transposed block and ring, gathered over the mesh row.  A level not
split along a line's axis holds its lines whole: the same mode over a
group of one rank, no gather.
"""

from __future__ import annotations

import torch

from multigrid_petsc_tpu_torch.ops.cuda import line_kernel as lk
from multigrid_petsc_tpu_torch.ops.cuda.dist_kernel import (
    Halo2,
    block_visit,
    coarse_halo_rows,
    halo_rows,
)
from multigrid_petsc_tpu_torch.ops.stencil import Stencil9
from multigrid_petsc_tpu_torch.ops.transfer import prolong_bilinear, restrict_fw
from multigrid_petsc_tpu_torch.parallel.halo import (
    all_gather_blocks,
    all_gather_lines,
    allreduce_sum,
    block_exchange,
)


def window(x: torch.Tensor, r0: int, r1: int, c0: int,
           c1: int) -> torch.Tensor:
    """x's points on rows [r0, r1) and columns [c0, c1), zeros outside
    it."""
    out = x.new_zeros((r1 - r0, c1 - c0))
    a, b = max(r0, 0), min(r1, x.shape[0])
    c, d = max(c0, 0), min(c1, x.shape[1])
    if a < b and c < d:
        out[a - r0:b - r0, c - c0:d - c0] = x[a:b, c:d]
    return out


def extend(x: torch.Tensor, halo: Halo2) -> torch.Tensor:
    """The block ``x`` inside its ring: [top; left | x | right; bot]."""
    mid = torch.cat([halo.left, x, halo.right], 1)
    return torch.cat([halo.top, mid, halo.bot])


def ring(ext: torch.Tensor, h: int) -> Halo2:
    """The depth-``h`` ring of an extended block, as ``Halo2``
    (contiguous pieces, as an exchange delivers them)."""
    R, C = ext.shape[0] - 2 * h, ext.shape[1] - 2 * h
    return Halo2(ext[:h].contiguous(), ext[h + R:].contiguous(),
                 ext[h:h + R, :h].contiguous(),
                 ext[h:h + R, h + C:].contiguous())


def cut_halo(x: torch.Tensor, r0: int, c0: int, R: int, C: int,
             h: int) -> tuple[torch.Tensor, Halo2]:
    """The (R, C) block of ``x`` from (r0, c0) and its depth-``h`` ring,
    cut from ``x`` (zeros outside it), in the layout ``block_exchange``
    delivers: a block and its halo without an exchange."""
    ext = window(x, r0 - h, r0 + R + h, c0 - h, c0 + C + h)
    return ext[h:h + R, h:h + C].contiguous(), ring(ext, h)


def least(plan, ny: int, nx: int) -> tuple[int, int]:
    """The smallest block's (rows, columns) of an (ny, nx) level: what a
    halo from the neighbours must fit (``block_exchange``'s ``least``)."""
    return tuple(map(min, plan.extents(ny, nx)))


def _cut_coeffs(st: Stencil9, r0: int, r1: int, c0: int, c1: int):
    """The coefficients that vary with y cut to rows [r0, r1), those that
    vary with x to columns [c0, c1)."""
    def cut(c):
        if c.shape[0] > 1:
            c = c[r0:r1]
        if c.shape[1] > 1:
            c = c[:, c0:c1]
        return c.contiguous()

    return Stencil9(*map(cut, st))


def restrict_local(r: torch.Tensor, ny: int, nx: int,
                   plan) -> torch.Tensor:
    """One full weighting of this rank's block ``r`` of an (ny, nx) grid
    the blocks plan splits: this block's coarse block from the block and,
    along a split axis, the next block's first row (column) and their
    corner; the coarse pad row and column 0."""
    R, C, row0, col0, split = plan.block(ny, nx)
    ext = extend(r, block_exchange(r, 1, plan, split))
    # An even (split) extent reads one row (column) past the block, an
    # odd one holds its whole extent.
    ext = ext[1:R + 2 - R % 2, 1:C + 2 - C % 2]
    rc = restrict_fw(ext)
    nyc, nxc = (ny - 1) // 2, (nx - 1) // 2
    rc[max(nyc - row0 // 2, 0):] = 0.0
    rc[:, max(nxc - col0 // 2, 0):] = 0.0
    return rc


def agglomerate(rc: torch.Tensor, ny: int, nx: int, plan) -> torch.Tensor:
    """The coarse grid's part of ``rc``, this block's coarse block of an
    (ny, nx) grid: the coarse blocks gathered along the axes the coarse
    grid stops being split on ("agglomerate"), the coarse pads there cut
    (collective along those axes)."""
    nyc, nxc = (ny - 1) // 2, (nx - 1) // 2
    axes = tuple(f and not c for f, c in zip(plan.split(ny, nx),
                                             plan.split(nyc, nxc)))
    if not any(axes):
        return rc
    # The coarse blocks of the fine blocks: half their sides.
    halves = tuple(tuple(e // 2 for e in ext)
                   for ext in plan.extents(ny, nx))
    whole = all_gather_blocks(rc, plan, "agglomerate", axes, halves)
    return whole[:nyc if axes[0] else None,
                 :nxc if axes[1] else None].contiguous()


def block_restrict(r: torch.Tensor, ny: int, nx: int, plan) -> torch.Tensor:
    """One full weighting from this rank's block of a split (ny, nx) grid
    into the coarse grid's layout: block-local, then gathered along the
    axes the coarse grid is not split on."""
    return agglomerate(restrict_local(r, ny, nx, plan), ny, nx, plan)


def coarse_in(e: torch.Tensor, ny: int, nx: int, plan, hc: int):
    """The coarse correction ``e`` of a split (ny, nx) grid, held as the
    coarse grid is held, as this block's coarse block (R / 2, C / 2) and
    its depth-``hc`` ring: exchanged along the axes the coarse grid is
    split on, cut along the others."""
    R, C, row0, col0, split = plan.block(ny, nx)
    nyc, nxc = (ny - 1) // 2, (nx - 1) // 2
    cb = plan.block(nyc, nxc)
    ring_c = block_exchange(e, hc, plan, cb.split, least(plan, nyc, nxc))
    if cb.split == split:  # the coarse grid's block is this one's
        return e, ring_c
    ext = extend(e, ring_c)
    r0 = row0 // 2 - cb.row0
    c0 = col0 // 2 - cb.col0
    Rc, Cc = R // 2, C // 2
    win = window(ext, r0, r0 + Rc + 2 * hc, c0, c0 + Cc + 2 * hc)
    return win[hc:hc + Rc, hc:hc + Cc].contiguous(), ring(win, hc)


def block_prolong(e: torch.Tensor, ny: int, nx: int, plan) -> torch.Tensor:
    """One bilinear prolongation onto this rank's block of a split (ny,
    nx) grid: ``e`` held as the coarse grid is held (its block, or whole
    along an axis it is not split on), of which this block's coarse block
    and the row above, the column left and their corner are read; the pad
    row and column 0.  The result is contiguous, as the kernels take their
    inputs (a merged level applies A_f to it)."""
    R, C, row0, col0, _ = plan.block(ny, nx)
    ec, halo = coarse_in(e, ny, nx, plan, 1)
    ext = extend(ec, halo)[:-1, :-1]
    nyc, nxc = (ny - 1) // 2, (nx - 1) // 2
    c0, d0 = row0 // 2 - 1, col0 // 2 - 1
    ext[max(nyc - c0, 0):] = 0.0  # the coarse pad row and column
    ext[:, max(nxc - d0, 0):] = 0.0
    pe = prolong_bilinear(ext)[2:R + 2, 2:C + 2].contiguous()
    pe[min(R, ny - row0):] = 0.0
    pe[:, min(C, nx - col0):] = 0.0
    return pe


class BlockLevelOps:
    """K17 operator set of one single-grid level the blocks plan splits,
    on this rank's block (``DistLevelOps``'s interface).  ``st`` is the
    level's whole stencil; a 9-point stencil keeps only the rows and
    columns of its coefficients this rank's visits read (the block and
    ``max_sweeps + 2`` more on each side)."""

    def __init__(self, st, ny: int, nx: int, plan, max_sweeps: int):
        self.ny, self.nx = ny, nx
        self.plan = plan
        self.R, self.C, self.row0, self.col0, self.split = plan.block(ny, nx)
        # Every rank's block sides (rows by mesh row, columns by mesh
        # column) and the smallest of them.
        self.extents = plan.extents(ny, nx)
        self.least = least(plan, ny, nx)
        # The points of the block inside the domain (the pad row and
        # column are not).
        self.nyl = min(self.R, ny - self.row0)
        self.nxl = min(self.C, nx - self.col0)
        # The largest halo the neighbours can give: the smallest split
        # extent of any rank's block, so that every rank takes the same
        # schedule of exchanges.
        self.cap = min(n for n, s in zip(self.least, self.split) if s)
        # The ranks that hold distinct blocks: the world when the level is
        # split along both axes, the mesh column (row) when along y (x)
        # alone; the ranks of the other axis hold the same blocks.
        sy, sx = self.split
        self.sum_group = (None if sy and sx else
                          plan.col_group if sy else plan.row_group)
        self.viable = (
            halo_rows(max_sweeps, "rc") <= self.cap
            and coarse_halo_rows(halo_rows(max_sweeps, "ur")) <= self.cap // 2)
        # The centre coefficient on the block, the pad row and column the
        # identity, as JAX pads its Jacobi diagonal.
        cc = torch.ones((self.R, self.C), dtype=st.cc.dtype,
                        device=st.cc.device)
        r1, c1 = self.row0 + self.nyl, self.col0 + self.nxl
        c = st.cc
        c = c[self.row0:r1] if c.shape[0] > 1 else c
        cc[:self.nyl, :self.nxl] = c[:, self.col0:c1] if c.shape[1] > 1 else c
        self.cc = cc
        self.dinv = 1.0 / cc
        self.coeff_row0 = self.coeff_col0 = 0
        if isinstance(st, Stencil9):
            m = max_sweeps + 2
            self.coeff_row0 = max(0, self.row0 - m)
            self.coeff_col0 = max(0, self.col0 - m)
            st = _cut_coeffs(st, self.coeff_row0,
                             min(ny, self.row0 + self.R + m),
                             self.coeff_col0, min(nx, self.col0 + self.C + m))
        self.st = st
        self.rb_dinv = None  # RBGS: (red, black) omega / cc on the block
        self.line_y = None   # LINE_Y: lk.RowLine of the block
        self.line_x = None   # LINE_X: lk.RowLine of the transposed block

    @property
    def block_shape(self) -> tuple[int, int]:
        return (self.R, self.C)

    # -- layout ---------------------------------------------------------

    def block_of(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's (R, C) block of a whole (ny, nx) grid, the pad row
        and column 0."""
        return window(x, self.row0, self.row0 + self.R, self.col0,
                      self.col0 + self.C).contiguous()

    def real(self, x: torch.Tensor) -> torch.Tensor:
        """The block's points inside the domain (the pads cut)."""
        return x[:self.nyl, :self.nxl]

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the ranks that hold distinct blocks
        (``sum_group``)."""
        return allreduce_sum(x, self.plan, self.sum_group)

    def gather(self, x: torch.Tensor, what: str) -> torch.Tensor:
        """The whole (ny, nx) grid from every rank's block, on every rank
        (collective; counted under ``what``)."""
        return all_gather_blocks(x, self.plan, what, self.split,
                                 self.extents)[
            :self.ny, :self.nx].contiguous()

    def gathered(self, solve):
        """``solve`` of the whole level run on this rank's block: the
        blocks gathered ("coarsest"), the solve, this rank's block of it
        (a coarsest level JAX solves directly; collective)."""
        return lambda b: self.block_of(solve(self.gather(b, "coarsest")))

    def to_coarse(self, rc: torch.Tensor) -> torch.Tensor:
        """The coarse level's part of ``rc`` (``agglomerate``)."""
        return agglomerate(rc, self.ny, self.nx, self.plan)

    # -- the visit --------------------------------------------------------

    def exchange(self, x, h: int):
        """The depth-``h`` ring of the block ``x`` (or of a tuple of
        blocks; ``block_exchange``)."""
        return block_exchange(x, h, self.plan, self.split, self.least)

    def _visit(self, b, u, steps, emit, e=None):
        h = halo_rows(len(steps), emit)
        if h > self.cap:
            raise ValueError(f"a halo of {h} exceeds the smallest block, "
                             f"{self.least[0]} x {self.least[1]}")
        b_halo = u_halo = e_halo = None
        if emit in ("a", "r"):
            u_halo = self.exchange(u, h)
        elif u is None:
            b_halo = self.exchange(b, h)
        else:
            u_halo, b_halo = self.exchange((u, b), h)
        if e is not None:
            e, e_halo = coarse_in(e, self.ny, self.nx, self.plan,
                                  coarse_halo_rows(h))
        return block_visit(self.st, b, u, steps, emit, row0=self.row0,
                           col0=self.col0, ny=self.ny, nx=self.nx,
                           b_halo=b_halo, u_halo=u_halo, e=e, e_halo=e_halo,
                           coeff_row0=self.coeff_row0,
                           coeff_col0=self.coeff_col0)

    def _visit_steps(self, b, u, steps, emit, e=None):
        """A visit of ``steps``: one K17 visit where the block carries its
        halo (``viable``); else Jacobi's in visits of at most cap - 2
        steps (the last one emitting), a schedule with momentum one
        residual emit per step."""
        if self.viable:
            return self._visit(b, u, steps, emit, e)
        c = self.cap - 2
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
        return self.dinv.new_zeros((self.R, self.C))

    # -- level operators (DistLevelOps's) ---------------------------------

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
        """This block's coarse block of R r (``restrict_local``)."""
        return restrict_local(r, self.ny, self.nx, self.plan)

    def prolong(self, e: torch.Tensor) -> torch.Tensor:
        """P e on the block (``block_prolong``): ``e`` held as the coarse
        level holds it."""
        return block_prolong(e, self.ny, self.nx, self.plan)

    # -- the smoothers without a fused visit -------------------------------

    def setup_rbgs(self, omega: float) -> None:
        """RBGS's masked omega / cc on the block: red where the global
        parity row0 + col0 + i + j is even; 0 on the pad row and column."""
        dev = self.dinv.device
        ii = torch.arange(self.R, device=dev)[:, None]
        jj = torch.arange(self.C, device=dev)[None, :]
        red = (self.row0 + self.col0 + ii + jj) % 2 == 0
        d = omega / self.cc
        d[self.nyl:] = 0.0
        d[:, self.nxl:] = 0.0
        zero = torch.zeros((), dtype=d.dtype, device=dev)
        self.rb_dinv = (torch.where(red, d, zero), torch.where(red, zero, d))

    def rbgs(self, b, u, sweeps: int):
        """Red-black Gauss-Seidel, JAX ``sor_redblack_sweeps``: per
        half-sweep K17's residual emit and u + (omega / cc) r on one
        colour."""
        for _ in range(sweeps):
            for d in self.rb_dinv:
                u = torch.addcmul(u, d, self.residual(b, u))
        return u

    def setup_line_y(self, line_st) -> None:
        """The y-lines of the level's collapsed whole-grid line stencil on
        the block: its rows across the mesh column, its real columns."""
        self.line_y = lk.row_line(line_st, self.ny, self.R, self.row0,
                                  self.col0, self.nxl,
                                  blocks=self._line_blocks(0))

    def setup_line_x(self, line_st_x) -> None:
        """The x-lines: the y-lines of the transposed level's collapsed
        line stencil on the transposed block (its rows the block's
        columns, across the mesh row)."""
        self.line_x = lk.row_line(line_st_x, self.nx, self.C, self.col0,
                                  self.row0, self.nyl,
                                  blocks=self._line_blocks(1))

    def _line_blocks(self, axis: int):
        """The blocks a line along ``axis`` spans: every rank's extent
        along it, in mesh order (one block, the whole line, where the level
        is not split along it)."""
        return self.extents[axis] if self.split[axis] else None

    def _line_sweeps(self, lf, axis: int, b, u, sweeps: int, omega: float):
        """Damped line Jacobi along ``axis`` (0: y-lines, 1: x-lines on the
        transposed block): per sweep the block's depth-1 ring, K15's 2-D
        block mode's first half, the gather over the ranks the lines span
        (none where the level is not split along them), the second half."""
        if axis:
            b = b.T.contiguous()
        for _ in range(sweeps):
            ring = self.exchange(u, 1)
            if axis:
                u, ring = u.T.contiguous(), lk.transpose_ring(ring)
            mine = lk.line_rows_begin(lf, b, u, ring)
            every = (lk.stack_lines(lf, all_gather_lines(
                mine, self.plan, lk.gathered_rows(lf), axis)).to(u.device)
                if self.split[axis] else mine)
            u = lk.line_rows_end(lf, b, u, ring, every, omega)
            if axis:
                u = u.T.contiguous()
        return u

    def line_y_sweeps(self, b, u, sweeps: int, omega: float):
        """Damped y-line Jacobi (JAX ``line_jacobi_sweeps_y``) over the
        whole columns."""
        return self._line_sweeps(self.line_y, 0, b, u, sweeps, omega)

    def line_x_sweeps(self, b, u, sweeps: int, omega: float):
        """Damped x-line Jacobi (JAX ``line_jacobi_sweeps_x``) over the
        whole rows."""
        return self._line_sweeps(self.line_x, 1, b, u, sweeps, omega)
