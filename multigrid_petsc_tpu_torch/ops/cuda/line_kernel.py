"""The y-line smoother's level visit (K15).

Counterpart of ``multigrid_petsc_tpu/ops/pallas/line_kernel.py``:

  line_visit9   K15: [u += P e_c] -> k damped y-line Jacobi sweeps ->
                u | (u, r) | (u, R r) [, <b, u>]; ``u=None`` is the zero
                guess
  collapse_stencil  coefficient fields constant along an axis -> their
                compact broadcast shape (so the line coefficients of a
                tensor-product operator become (ny, 1) columns)

The TPU kernel holds the whole level in VMEM and solves the line systems
by parallel cyclic reduction; it is viable up to ~1023^2 and for (ny, 1)
line coefficients only.  The CUDA kernels (``csrc/line.cuh``) have no size
cap and take line coefficients that vary with x as well: Thomas's
recurrence with per-row factors made once per level in f64,
cut into segments of ``LINE_SEG`` rows run by one thread each and joined
by a carry pass over the segments, a blocked scan of the carries' affine
maps (``segment_factor`` makes the segments' carry responses beside
Thomas's factors), three launches per sweep (one on a level of one
segment), then one launch for the residual or its restriction.  The
plain version is the JAX package's composition: ``line_jacobi_sweeps_y``
(PCR) with the library transfers, so on the card the kernel and its
oracle differ by the rounding of the two tridiagonal solves.

A row-sharded level's y-lines cross the ranks (``RowLine``,
``line_rows_begin`` / ``line_rows_end``): each sweep is two halves around
one all-gather the caller makes.  On the card the halves are the CUDA
sweep's launches split at its carry pass (``csrc/line.cuh``, the
rank-spanning mode): each rank's segment ends (launch 1) are gathered,
every rank runs the carry pass over all the segments, reading the
gathered ends in place as one piece (``stack_lines``: every rank's ends,
then every rank's starts; the ranks' blocks may hold unequal segment
counts) and keeping its own segments' carries (``line_rows_carry``),
then fixes its own (launch 3,
``line_rows_fix``, which writes the block's pad row and column as 0); a
``RowLine`` holds its launch arguments, checked once (``RowLaunch``); on
the CPU the plain version gathers the ranks' line right-hand sides and
solves the whole columns by PCR (``line_jacobi_sweeps_y``'s arithmetic),
the oracle.

Under the 2-D blocks layout the same functions take a rank's (R, C) block
and its depth-1 ring (``Halo2``: the rows above and below with the
corners, the columns left and right), the 2-D block mode: the lines span
the mesh column, the caller gathers over it, and a ``RowLine`` made with
the block's column origin and real columns (``col0``, ``nxl``) keeps the
coefficients and line factors of those columns; an x-line is a y-line of
the transposed block and ring (``transpose_ring``), gathered over the
mesh row.  A block that holds its lines whole runs the same mode over a
group of one rank (no gather).  Its launches are counted as
``line_visit9_blocks``, the rows mode's as ``line_visit9_rows``.

Storage types: ``line_visit9`` runs f32, f64 and bf16 levels
(``mg_line_*``, ``mg_line_*_f64``, ``mg_line_*_bf16``); the rank-spanning
mode f32 and f64 (bf16 under a plan is not ported).  bf16 is storage
only, as the JAX kernel's bf16 branch: the line stencil comes in the
compute type (f32: ``line_stencil``, the upcast of the bf16-rounded
coefficients), the line factors are f32 (``segment_factor`` makes them
in f64; the plain version's PCR factor comes from the f32
stencil), and the rounding points, the kernel's and the plain version's
alike, are:
  * u + P e_c is formed in f32 from the bf16 u and e_c and rounded once
    (JAX forms it in bf16 arithmetic: a bound in the tests);
  * the k sweeps run in f32 from the f32 upcast of b, the iterate kept in
    f32 between sweeps (the kernel's intermediate buffers are f32);
  * the visit's u is rounded once; r or R r is formed in f32 from the
    unrounded u and rounded once; <b, u> is the f32 sum over the
    unrounded u.
The wrapper runs the plain version when the data lies on the CPU,
launches the kernels when it lies on a CUDA device (one of those storage
types, contiguous; anything else raises), and never falls back from one
to the other.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from multigrid_petsc_tpu_torch.ops.cuda import count_launch
from multigrid_petsc_tpu_torch.ops.cuda._build import check, load_library
from multigrid_petsc_tpu_torch.ops.cuda.dist_kernel import Halo2
from multigrid_petsc_tpu_torch.ops.cuda.mdma_kernel import (
    _ENTRY_SUFFIX,
    Coeff9Args,
    _check_cuda,
    _odd_shape,
    _on_cpu,
    _stream,
    coeff9_args,
    compute_dtype,
    entry,
)
from multigrid_petsc_tpu_torch.ops.stencil import (
    PCRFactor,
    Stencil9,
    apply_stencil9,
    line_jacobi_sweeps_y,
    pcr_factor,
    pcr_solve,
)
from multigrid_petsc_tpu_torch.ops.transfer import prolong_bilinear, restrict_fw

_EMITS = ("u", "ur", "rc")
# The storage types of the one-card visit (csrc/line.cu, line_f64.cu,
# line_bf16.cu) and of the rank-spanning mode.
LINE_DTYPES = (torch.float32, torch.float64, torch.bfloat16)
ROW_DTYPES = (torch.float32, torch.float64)
# Rows per segment of the CUDA line solve (csrc/line.cuh SEG; the C entry
# refuses factors made for another length).
LINE_SEG = 32
# A row of the packed per-row table (csrc/line.cuh LineRows, R_*), then 3
# zeros: 16 values a row.
TABLE_COLUMNS = ("cw", "ce", "csw", "cse", "cnw", "cne", "cs", "m", "cp",
                 "above", "below", "end_w", "start_w")
TABLE_WIDTH = 16


def line_stencil(st: Stencil9) -> Stencil9:
    """The line smoothers' stencil of a level: ``collapse_stencil`` of
    ``st`` in its compute type (a bf16 level's as the exact f32 upcast of
    its bf16-rounded coefficients, as the JAX kernel takes them)."""
    return _in_compute(collapse_stencil(st))


def _in_compute(st: Stencil9) -> Stencil9:
    cdt = compute_dtype(st.cc.dtype)
    return st if st.cc.dtype == cdt else Stencil9(*(c.to(cdt) for c in st))


def collapse_stencil(st: Stencil9) -> Stencil9:
    """Each (ny, nx)-shaped coefficient that is constant along an axis,
    cut to its compact shape ((1, nx), (ny, 1) or (1, 1)), as the JAX
    package's ``collapse_stencil`` does before its line kernel."""
    out = []
    for c in st:
        if c.dim() == 2:
            if c.shape[0] > 1 and bool((c == c[:1]).all()):
                c = c[:1]
            if c.shape[1] > 1 and bool((c == c[:, :1]).all()):
                c = c[:, :1]
        out.append(c.contiguous())
    return Stencil9(*out)


class SegmentFactor(NamedTuple):
    """What the CUDA line visit runs on, once per level: Thomas's factors
    of the line systems (cs, cc, cn) down each column, ``m`` (m_i = 1 /
    (cc_i - cs_i cp_{i-1})) and ``cp`` (cp_i = cn_i m_i, cp_{ny-1} = 0),
    and, for its segments of ``LINE_SEG`` rows, a
    segment's responses to a unit forward carry from the row above
    (``above``: x_i when dp just above the segment is 1) and to a unit
    value on the row below (``below``), per row, the forward carry's
    multiplier across each segment (``gain``, one row per segment), and
    the weights that give a segment's zero-carry dp at its last row
    (``end_w``) and x at its first (``start_w``) as sums over its rows'
    right-hand sides; columns (width 1) or fields (width nx), in the
    stencil's compute type (f32 for bf16).  ``table``: when the line
    stencil and so every factor is constant along x (BASELINE config 4),
    every per-row value the kernels read, packed one row per grid row
    (``TABLE_COLUMNS``, padded to 16), else None."""

    m: torch.Tensor
    cp: torch.Tensor
    above: torch.Tensor
    below: torch.Tensor
    gain: torch.Tensor
    end_w: torch.Tensor
    start_w: torch.Tensor
    table: torch.Tensor | None


def _host(c: torch.Tensor) -> np.ndarray:
    return np.asarray(c.detach().cpu().numpy(), np.float64)


def _thomas_host(st: Stencil9, ny: int):
    """(a, m, cp): the sub-diagonal cs and Thomas's factors of ``st``'s
    y-lines, f64 numpy arrays of shape (ny, w), w = 1 or nx."""
    a, d, c = _host(st.cs), _host(st.cc), _host(st.cn)
    w = max(x.shape[1] if x.ndim == 2 else 1 for x in (a, d, c))
    a, d, c = (np.broadcast_to(x, (ny, w)) for x in (a, d, c))
    m = np.empty((ny, w))
    cp = np.empty((ny, w))
    prev = np.zeros(w)
    for i in range(ny):
        m[i] = 1.0 / (d[i] - (a[i] * prev if i > 0 else 0.0))
        prev = cp[i] = (c[i] if i < ny - 1 else 0.0) * m[i]
    return a, m, cp


def segment_spikes(a, m, cp, seg: int = LINE_SEG):
    """(above, below, gain, end_w, start_w) of the segmented Thomas solve
    from the (ny, w) sub-diagonal and Thomas factors, f64 tensors, on
    their device.  The forward
    recurrence dp_i = (rhs_i - a_i dp_{i-1}) m_i carries dp with the
    multiplier f_i = -a_i m_i, the backward x_i = dp_i - cp_i x_{i+1}
    carries x with h_i = -cp_i; for a segment of rows s0..s1:
      F_i = f_s0 ... f_i             (dp_i's response to dp_{s0-1})
      above_i = F_i + h_i above_{i+1}, above_s1 = F_s1
      below_i = h_i ... h_s1         (x_i's response to x_{s1+1})
      gain = F_s1
      end_w_i = m_i f_{i+1} ... f_s1 (dp_s1 from zero carries, per rhs_i)
      start_w_i = m_i g_i, g_i = h_s0 ... h_{i-1} + f_{i+1} g_{i+1}
                                     (x_s0 from zero carries, per rhs_i).
    The last segment's rows past ny count as absent (cp_{ny-1} = 0, so
    nothing below the last row reaches it)."""
    ny, w = m.shape
    nseg = -(-ny // seg)
    pad = m.new_zeros((nseg * seg - ny, w))

    def cut(x):
        return torch.cat([x, pad.to(x.dtype)]).reshape(nseg, seg, w)

    f, h, mm = cut(-a * m), cut(-cp), cut(m)
    real = cut(torch.ones_like(m)) > 0
    last = real & ~torch.cat([real[:, 1:], torch.zeros_like(real[:, :1])],
                             dim=1)
    F = torch.cumprod(f, dim=1)
    hpre = torch.cumprod(torch.cat([torch.ones_like(h[:, :1]), h[:, :-1]],
                                   dim=1), dim=1)
    above, below = torch.empty_like(F), torch.empty_like(F)
    end_w, g = torch.empty_like(F), torch.empty_like(F)
    above[:, -1], below[:, -1] = F[:, -1], h[:, -1]
    end_w[:, -1], g[:, -1] = 1.0, hpre[:, -1]
    for i in range(seg - 2, -1, -1):
        above[:, i] = F[:, i] + h[:, i] * above[:, i + 1]
        below[:, i] = h[:, i] * below[:, i + 1]
        end_w[:, i] = torch.where(last[:, i], 1.0,
                                  f[:, i + 1] * end_w[:, i + 1])
        g[:, i] = hpre[:, i] + f[:, i + 1] * g[:, i + 1]
    end_w *= mm

    def rows(x):
        return x.reshape(-1, w)[:ny]

    return (rows(above), rows(below), F[:, -1].clone(), rows(end_w),
            rows(mm * g))


def segment_factor(st: Stencil9, ny: int,
                   seg: int = LINE_SEG) -> SegmentFactor:
    """Thomas's factors and the carry responses of ``st``'s y-lines cut
    into segments of ``seg`` rows (``segment_spikes``), in f64: Thomas's
    row recurrence on the host, the responses on the stencil's device;
    stored in the stencil's compute type (f32 for a bf16 stencil), with
    the packed per-row table when the kernels' per-row values are all
    constant along x."""
    dev = st.cc.device
    a, m, cp = (torch.as_tensor(np.ascontiguousarray(x), device=dev)
                for x in _thomas_host(st, ny))
    names = SegmentFactor._fields[:-1]
    f64 = dict(zip(names, (m, cp, *segment_spikes(a, m, cp, seg))))
    table = None
    if m.shape[1] == 1 and all(getattr(st, k).shape[1] == 1
                               for k in TABLE_COLUMNS[:7]):
        f64.update((k, getattr(st, k).to(torch.float64).expand(ny, 1))
                   for k in TABLE_COLUMNS[:7])
        table = m.new_zeros((ny, TABLE_WIDTH))
        table[:, :len(TABLE_COLUMNS)] = torch.cat(
            [f64[k] for k in TABLE_COLUMNS], dim=1)
    cdt = compute_dtype(st.cc.dtype)
    return SegmentFactor(*(f64[k].to(cdt).contiguous() for k in names),
                         None if table is None else table.to(cdt))


def line_factor(st: Stencil9, ny: int):
    """What ``line_visit9`` needs of the ny-point line systems, once per
    level, in the stencil's compute type: the PCR factor for CPU tensors
    (the plain version), the segmented Thomas factors for CUDA tensors."""
    if _on_cpu(st.cc):
        st = _in_compute(st)
        return pcr_factor(st.cs, st.cc, st.cn, ny)
    return segment_factor(st, ny)


def _check_line(u, emit, e_coarse, emit_dot, sweeps) -> None:
    if emit not in _EMITS:
        raise ValueError(f"emit must be one of {_EMITS}, got {emit!r}")
    if emit_dot and emit != "u":
        raise ValueError("emit_dot goes with emit='u' only")
    if u is None and e_coarse is not None:
        raise ValueError("a zero-guess visit cannot take a correction")
    if sweeps < 1:
        raise ValueError("a line visit takes at least one sweep")


def line_visit9_plain(st: Stencil9, b, u, sweeps: int, omega: float = 1.0,
                      emit: str = "u", e_coarse=None, emit_dot: bool = False,
                      fac: PCRFactor | None = None):
    """The visit as the JAX package composes it: ``line_jacobi_sweeps_y``
    (PCR) from u [+ P e_c], then the emits; on bf16 storage in f32 from
    the upcast inputs, rounded where the kernel stores (the module
    docstring)."""
    _check_line(u, emit, e_coarse, emit_dot, sweeps)
    store = b.dtype
    cdt = compute_dtype(store)
    st, b = _in_compute(st), b.to(cdt)
    u = torch.zeros_like(b) if u is None else u.to(cdt)
    if e_coarse is not None:
        u = (u + prolong_bilinear(e_coarse.to(cdt))).to(store).to(cdt)
    u = line_jacobi_sweeps_y(st, b, u, sweeps, omega, fac=fac)
    if emit == "u":
        return (u.to(store), torch.sum(b * u)) if emit_dot else u.to(store)
    r = b - apply_stencil9(st, u)
    out = r if emit == "ur" else restrict_fw(r)
    return u.to(store), out.to(store)


def line_visit9(st: Stencil9, b, u, sweeps: int, omega: float = 1.0,
                emit: str = "u", e_coarse=None, emit_dot: bool = False,
                fac=None):
    """One y-line visit (K15), with the JAX function's contract: returns u
    (or (u, <b, u>) with ``emit_dot``), (u, r) or (u, R r).  ``fac`` is
    ``line_factor(st, ny)``, computed here when not given."""
    if _on_cpu(b):
        return line_visit9_plain(st, b, u, sweeps, omega, emit, e_coarse,
                                 emit_dot, fac)
    _check_line(u, emit, e_coarse, emit_dot, sweeps)
    transfer = emit == "rc" or e_coarse is not None
    ny, nx = _odd_shape(b) if transfer else b.shape
    nyc, nxc = (ny - 1) // 2, (nx - 1) // 2
    st = _in_compute(st)
    fac = segment_factor(st, ny) if fac is None else fac
    c9 = coeff9_args(st, ny, nx)
    w = fac.m.shape[1]
    if w not in (1, nx):
        raise ValueError(f"line factors of width {w} for {nx} columns")
    nseg = -(-ny // LINE_SEG)
    shapes = {"gain": (nseg, w), "table": (ny, TABLE_WIDTH)}
    fields = {"b": (b, (ny, nx))}
    if u is not None:
        fields["u"] = (u, (ny, nx))
    if e_coarse is not None:
        fields["e_c"] = (e_coarse, (nyc, nxc))
    dtype = _check_cuda(b.device, fields, dtypes=LINE_DTYPES)
    cdt = compute_dtype(dtype)
    _check_cuda(b.device, {**c9.fields,
                           **{f"fac.{k}": (t, shapes.get(k, (ny, w)))
                              for k, t in fac._asdict().items()
                              if t is not None}}, dtypes=(cdt,))
    lib = load_library()
    sweep = entry(lib, "mg_line_sweep", dtype)
    residual = entry(lib, "mg_line_residual", dtype)
    stream = _stream(b.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    # A bf16 visit keeps its iterate in f32 between sweeps: every sweep
    # but the one that stores the visit's u writes an f32 buffer, which
    # the next sweep (or the residual launch) reads.  A sweep reads the
    # previous iterate at neighbouring columns while writing its own, so
    # it never writes its input: each writes a new buffer.
    keep = dtype != cdt
    part = (torch.empty(lib.mg_line_blocks(ny, nx), dtype=cdt,
                        device=b.device) if emit_dot else None)
    # Per segment and column: the zero-carry ends, then the carries.
    scratch = (torch.empty(4 * nseg * nx, dtype=cdt, device=b.device)
               if nseg > 1 else None)
    # u + P e_c, formed by the first sweep's first launch for its last.
    u_corr = torch.empty_like(b) if e_coarse is not None else None
    fptrs = np.asarray([0 if t is None else t.data_ptr() for t in fac],
                       np.uint64)
    cur, cur_c = u, False
    for s in range(sweeps):
        last = s == sweeps - 1
        out_c = keep and not (last and emit == "u")
        out = torch.empty((ny, nx), dtype=cdt if out_c else dtype,
                          device=b.device)
        err = sweep(
            c9.ptrs.ctypes.data, c9.strides.ctypes.data, fptrs.ctypes.data,
            int(w > 1), LINE_SEG, b.data_ptr(), ptr(cur), int(cur_c),
            ptr(e_coarse if s == 0 else None), out.data_ptr(), int(out_c),
            ptr(part if last else None), ptr(scratch),
            ptr(u_corr if s == 0 else None), ny, nx, omega, 1.0 - omega,
            stream)
        check(err, "line sweep launch")
        cur, cur_c = out, out_c
    if emit == "u":
        count_launch("line_visit9", dtype)
        return (cur, part.sum()) if emit_dot else cur
    out = torch.empty((nyc, nxc) if emit == "rc" else (ny, nx),
                      dtype=dtype, device=b.device)
    u_out = torch.empty_like(b) if cur_c else cur
    err = residual(c9.ptrs.ctypes.data, c9.strides.ctypes.data, b.data_ptr(),
                   cur.data_ptr(), int(cur_c), out.data_ptr(),
                   ptr(u_out if cur_c else None), ny, nx, int(emit == "rc"),
                   stream)
    check(err, "line residual launch")
    count_launch("line_visit9", dtype)
    return u_out, out


# --------------------------------------------------------------------------
# The rank-spanning mode: a row-sharded level's y-lines.
# --------------------------------------------------------------------------


class RowLaunch(NamedTuple):
    """A kernel ``RowLine``'s launch arguments, made and checked once: the
    block's coefficients as the C entries take them, the device pointers
    of its rows' line factors (launches 1 and 3) and of the whole columns'
    (launch 2), whether the factors are fields (``fsx``), the coefficients'
    width (1, or the block's real columns), the storage type, the entries'
    suffix and the device."""

    c9: Coeff9Args
    fptrs: np.ndarray
    gptrs: np.ndarray
    fsx: int
    width: int
    dtype: torch.dtype
    sfx: str
    device: torch.device


class RowLine(NamedTuple):
    """A rank's y-line smoother on its block of a partitioned level, made
    once: the line stencil on the block's real rows [row0, row0 + nyl)
    (the coefficients that vary with y cut to them) and, in the 2-D block
    mode, its real columns [col0, col0 + nxl) (those that vary with x cut
    to them; ``nxl`` None: the rows mode, every column), the whole
    columns' line factor of those columns (the PCR factor for CPU
    tensors; on the card the segmented factors of ``seg``-row segments,
    ``seg`` the largest power of two <= ``LINE_SEG`` dividing every block
    the lines span, so the segments tile the blocks, or ``LINE_SEG`` where
    the block holds its columns whole) and, on the card, its slices of the
    block's rows and the launch arguments (``RowLaunch``).  ``blocks``:
    the rows of every block the lines span, in the order of their rows
    (this one among them; unequal under the blocks layout on any rank
    count)."""

    st: Stencil9
    fac: PCRFactor | SegmentFactor
    fac_rows: SegmentFactor | None
    seg: int
    row0: int
    R: int
    ny: int
    col0: int = 0
    nxl: int | None = None
    launch: RowLaunch | None = None
    blocks: tuple[int, ...] = ()

    @property
    def nyl(self) -> int:
        return min(self.R, self.ny - self.row0)

    @property
    def nseg(self) -> int:
        """The block's segments (the last one cut by the domain's edge
        where the block holds its columns whole)."""
        return -(-self.R // self.seg)

    @property
    def counts(self) -> tuple[int, ...]:
        """Every block's segments, in the order of their rows."""
        return tuple(-(-r // self.seg) for r in self.blocks)


def gathered_rows(lf: RowLine) -> tuple[int, ...]:
    """The rows of each block's ``line_rows_begin`` output, in the order
    of their rows: its line right-hand sides (the plain version) or its
    segments' ends and starts (the kernel)."""
    return (lf.blocks if lf.launch is None
            else tuple(2 * c for c in lf.counts))


def stack_lines(lf: RowLine, pieces) -> torch.Tensor:
    """Every block's ``line_rows_begin`` output (``pieces``, in the order
    of their rows) stacked as ``line_rows_end`` takes it: the plain
    version's right-hand sides one under another; the kernel's as one
    piece, the segment ends of every block, then their starts
    (``pack_ends``), which the carry pass reads in place."""
    if lf.launch is None:
        return torch.cat(pieces)
    return pack_ends(pieces, lf.counts)


def pack_ends(pieces, counts) -> torch.Tensor:
    """[every block's ends; every block's starts] from the blocks'
    launch-1 outputs (``pieces``: (2 n, w) each, its n = ``counts[q]``
    segments' ends, then their starts)."""
    return torch.cat([p[:n] for p, n in zip(pieces, counts)]
                     + [p[n:] for p, n in zip(pieces, counts)])


def _line_blocks(ny: int, R: int, row0: int, blocks) -> tuple[int, ...]:
    """The blocks the lines of an ny-row level span (``blocks`` None:
    equal blocks of R rows, one where R == ny), checked to tile the level
    (its pad row counted) with this one's R rows at row0."""
    if blocks is None:
        blocks = (R,) if R == ny else (R,) * ((ny + 1) // R)
    blocks = tuple(int(r) for r in blocks)
    starts = [sum(blocks[:i]) for i in range(len(blocks))]
    if (sum(blocks) not in (ny, ny + 1) or row0 not in starts
            or blocks[starts.index(row0)] != R):
        raise ValueError(f"blocks {blocks} do not tile {ny} rows with "
                         f"{R} from row {row0}")
    return blocks


def _cut_columns(st, col0: int, nxl: int | None):
    """The coefficients that vary with x cut to columns [col0, col0 +
    nxl) (``nxl`` None: kept whole)."""
    if nxl is None:
        return st
    return type(st)(*(c if c.shape[1] == 1
                      else c[:, col0:col0 + nxl].contiguous() for c in st))


def _pointers(fac: SegmentFactor) -> np.ndarray:
    return np.asarray([0 if t is None else t.data_ptr() for t in fac],
                      np.uint64)


def _row_launch(st_rows: Stencil9, fac: SegmentFactor,
                rows: SegmentFactor, nyl: int, nxl: int | None) -> RowLaunch:
    """``RowLaunch`` of a kernel ``RowLine``: every coefficient and factor
    checked (device, storage type, shape, contiguity) once."""
    width = nxl or max(t.shape[1] for t in (*st_rows, fac.m))
    c9 = coeff9_args(st_rows, nyl, width)
    w = fac.m.shape[1]
    if w not in (1, width):
        raise ValueError(f"line factors of width {w} for {width} columns")
    fields = {**c9.fields,
              **{f"fac_rows.{k}": (t, (nyl, TABLE_WIDTH) if k == "table"
                                   else (nyl, w))
                 for k, t in rows._asdict().items()
                 if t is not None and k != "gain"},
              **{f"fac.{k}": (t, t.shape) for k, t in fac._asdict().items()
                 if t is not None}}
    device = st_rows.cc.device
    dtype = _check_cuda(device, fields, dtypes=ROW_DTYPES)
    return RowLaunch(c9, _pointers(rows), _pointers(fac), int(w > 1), width,
                     dtype, _ENTRY_SUFFIX[dtype], device)


def row_line(st: Stencil9, ny: int, R: int, row0: int, col0: int = 0,
             nxl: int | None = None, plain: bool | None = None,
             blocks=None) -> RowLine:
    """``RowLine`` of the block of global rows [row0, row0 + R) (and, in
    the 2-D block mode, of the ``nxl`` real columns from ``col0``) of a
    level of ny real rows whose line stencil (``collapse_stencil``) is
    ``st``: the plain version's (a PCR factor; ``plain`` None: where the
    stencil lies on the CPU) or the kernel's.  ``blocks``: the rows of
    every block the lines span, in order (None: equal blocks of R)."""
    blocks = _line_blocks(ny, R, row0, blocks)
    st = _cut_columns(st, col0, nxl)
    nyl = min(R, ny - row0)
    st_rows = Stencil9(*(c if c.shape[0] == 1 else c[row0:row0 + nyl]
                         for c in st))
    if _on_cpu(st.cc) if plain is None else plain:
        return RowLine(st_rows, pcr_factor(st.cs, st.cc, st.cn, ny), None,
                       1, row0, R, ny, col0, nxl, blocks=blocks)
    # One seg for every block of the lines (the carry pass lays the
    # segments on the global rows).
    seg = LINE_SEG if len(blocks) == 1 else math.gcd(LINE_SEG, *blocks)
    fac = segment_factor(st, ny, seg)
    rows = SegmentFactor(*(
        t if t is None or k == "gain" else t[row0:row0 + nyl]
        for k, t in fac._asdict().items()))
    return RowLine(st_rows, fac, rows, seg, row0, R, ny, col0, nxl,
                   _row_launch(st_rows, fac, rows, nyl, nxl), blocks)


def transpose_ring(ring: Halo2) -> Halo2:
    """The depth-1 ring of the transposed block: its rows above and below
    (the columns left and right with their corners) and its columns left
    and right (the rows above and below without theirs), contiguous."""
    top, bot, left, right = ring
    return Halo2(
        torch.cat([top[:, :1], left, bot[:, :1]]).T.contiguous(),
        torch.cat([top[:, -1:], right, bot[:, -1:]]).T.contiguous(),
        top[:, 1:-1].T.contiguous(), bot[:, 1:-1].T.contiguous())


def _extended(u, u_halo) -> torch.Tensor:
    """u inside its ring: [top; left | u | right; bot] (2-D block mode),
    or its halo rows with a zero column on each side (rows mode)."""
    if isinstance(u_halo, Halo2):
        top, bot, left, right = u_halo
        return torch.cat([top, torch.cat([left, u, right], 1), bot])
    top, bot = u_halo
    return F.pad(torch.cat([top, u, bot]), (1, 1))


def _line_rows_cuda(lf: RowLine, b, u, u_halo):
    """The per-call checks and arguments of a split sweep's launches 1 and
    3 (b, u and the halo or ring; the rest was checked when ``lf`` was
    made): (``lf.launch``, the halo's pointers (top, bot, left, right;
    left and right None in the rows mode), the real columns, the row
    stride)."""
    la = lf.launch
    if la is None:
        raise ValueError("a plain RowLine on a CUDA tensor: make the line "
                         "with row_line(..., plain=False)")
    R, C = b.shape
    nxl = C if lf.nxl is None else lf.nxl
    sides = isinstance(u_halo, Halo2)
    if sides != (lf.nxl is not None):
        raise ValueError("a 2-D block's line takes its ring (Halo2), a row "
                         "block's its halo rows")
    if la.width not in (1, nxl):
        raise ValueError(f"a line of {la.width} columns on a block of "
                         f"{nxl}")
    if R % lf.seg and R != lf.ny:
        raise ValueError(f"{lf.seg}-row segments do not tile a {R}-row "
                         f"block")
    fields = {"b": (b, (R, C)), "u": (u, (R, C))}
    if sides:
        fields.update(u_top=(u_halo.top, (1, C + 2)),
                      u_bot=(u_halo.bot, (1, C + 2)),
                      u_left=(u_halo.left, (R, 1)),
                      u_right=(u_halo.right, (R, 1)))
    else:
        fields.update(u_top=(u_halo.top, (1, C)), u_bot=(u_halo.bot, (1, C)))
    if b.device != la.device:
        raise ValueError(f"b is on {b.device}, the line on {la.device}")
    _check_cuda(b.device, fields, dtypes=(la.dtype,))
    halo = [u_halo.top.data_ptr(), u_halo.bot.data_ptr(),
            *((u_halo.left.data_ptr(), u_halo.right.data_ptr()) if sides
              else (None, None))]
    return la, halo, nxl, C


def line_rows_begin_plain(lf: RowLine, b, u, u_halo) -> torch.Tensor:
    """The plain version of ``line_rows_begin`` (any device; ``lf`` a
    plain ``RowLine``): the block's line right-hand sides b - (the
    off-line terms of u, its halo or ring included), 0 on the pad row and
    column."""
    nyl, st = lf.nyl, lf.st
    nxl = b.shape[1] if lf.nxl is None else lf.nxl
    p = _extended(u, u_halo)
    s_, o_, n_ = p[0:nyl], p[1:nyl + 1], p[2:nyl + 2]
    w, e = slice(0, nxl), slice(2, nxl + 2)
    off = (st.cw * o_[:, w] + st.ce * o_[:, e]
           + st.csw * s_[:, w] + st.cse * s_[:, e]
           + st.cnw * n_[:, w] + st.cne * n_[:, e])
    rhs = torch.zeros_like(b)
    rhs[:nyl, :nxl] = b[:nyl, :nxl] - off
    return rhs


def line_rows_end_plain(lf: RowLine, u, gathered: torch.Tensor,
                        omega: float) -> torch.Tensor:
    """The plain version of ``line_rows_end`` (any device; ``lf`` a plain
    ``RowLine``): the whole columns' PCR solve of the gathered right-hand
    sides, this block's rows of it blended into u; the pad row and column
    0."""
    nyl = lf.nyl
    nxl = u.shape[1] if lf.nxl is None else lf.nxl
    out = torch.zeros_like(u)
    u_line = pcr_solve(lf.fac, gathered[:lf.ny, :nxl])[lf.row0:lf.row0 + nyl]
    out[:nyl, :nxl] = (1.0 - omega) * u[:nyl, :nxl] + omega * u_line
    return out


def line_rows_begin(lf: RowLine, b, u, u_halo) -> torch.Tensor:
    """The first half of a rank-spanning y-line sweep of this rank's block
    ``u`` (right-hand side ``b``; ``u_halo``: its rows above and below,
    one each (``Halo``), or in the 2-D block mode its depth-1 ring
    (``Halo2``)): what the rank contributes to the sweep's all-gather.  On
    the card: launch 1, the (2 nseg, nxl) segment ends and starts of its
    segments (nxl: the real columns); on the CPU: its block's line
    right-hand sides (``line_rows_begin_plain``)."""
    if _on_cpu(b):
        return line_rows_begin_plain(lf, b, u, u_halo)
    la, halo, nxl, ld = _line_rows_cuda(lf, b, u, u_halo)
    nseg = lf.nseg
    out = torch.empty((2 * nseg, nxl), dtype=la.dtype, device=b.device)
    err = getattr(load_library(), "mg_line_rows_ends" + la.sfx)(
        la.c9.ptrs.ctypes.data, la.c9.strides.ctypes.data,
        la.fptrs.ctypes.data, la.fsx, lf.seg, b.data_ptr(), u.data_ptr(),
        *halo, out.data_ptr(), out[nseg:].data_ptr(), nseg, lf.nyl, nxl, ld,
        _stream(b.device))
    check(err, "line rows ends launch")
    return out


def line_rows_carry(lf: RowLine, gathered: torch.Tensor) -> torch.Tensor:
    """Launch 2 of a split sweep alone (the card only): the carries of
    this rank's segments, (2, nseg, nxl), cin then din, by the blocked
    scan over every segment of the lines, from ``gathered`` (as
    ``line_rows_end`` takes it: ``stack_lines``' one piece), read in
    place."""
    la = lf.launch
    nseg = lf.nseg
    nxl = gathered.shape[1]
    S = sum(lf.counts)
    if la is None or la.width not in (1, nxl):
        raise ValueError("line_rows_carry takes a kernel RowLine of the "
                         "gathered columns")
    _check_cuda(la.device, {"gathered": (gathered, (2 * S, nxl))},
                dtypes=(la.dtype,))
    carries = torch.empty((2, nseg, nxl), dtype=la.dtype, device=la.device)
    err = getattr(load_library(), "mg_line_rows_carry" + la.sfx)(
        la.gptrs.ctypes.data, la.fsx, lf.seg, gathered.data_ptr(), S,
        carries[0].data_ptr(), carries[1].data_ptr(), lf.row0 // lf.seg,
        nseg, lf.ny, nxl, _stream(la.device))
    check(err, "line rows carry launch")
    return carries


def line_rows_fix(lf: RowLine, b, u, u_halo, carries: torch.Tensor,
                  omega: float) -> torch.Tensor:
    """Launch 3 of a split sweep alone (the card only): the swept block
    from this rank's carries (``line_rows_carry``), its pad row and
    column stored as 0 by the kernel."""
    la, halo, nxl, ld = _line_rows_cuda(lf, b, u, u_halo)
    _check_cuda(b.device, {"carries": (carries, (2, lf.nseg, nxl))},
                dtypes=(la.dtype,))
    out = torch.empty_like(u)
    err = getattr(load_library(), "mg_line_rows_fix" + la.sfx)(
        la.c9.ptrs.ctypes.data, la.c9.strides.ctypes.data,
        la.fptrs.ctypes.data, la.fsx, lf.seg, b.data_ptr(), u.data_ptr(),
        *halo, carries[0].data_ptr(), carries[1].data_ptr(), out.data_ptr(),
        lf.nseg, lf.nyl, b.shape[0], nxl, ld, omega, 1.0 - omega,
        _stream(b.device))
    check(err, "line rows fix launch")
    return out


def line_rows_end(lf: RowLine, b, u, u_halo, gathered: torch.Tensor,
                  omega: float) -> torch.Tensor:
    """The second half: the swept block from ``gathered``, every rank's
    ``line_rows_begin`` stacked by ``stack_lines`` (the ranks the lines
    span; this rank's own where the block holds its columns whole).
    On the card: the carry pass over all the level's segments (launch 2,
    on every rank, ``line_rows_carry``) and launch 3 on this rank's
    (``line_rows_fix``); on the CPU: the whole columns' PCR solve, this
    rank's rows of it blended into u (``line_rows_end_plain``).  The pad
    row and column are 0."""
    if _on_cpu(b):
        return line_rows_end_plain(lf, u, gathered, omega)
    out = line_rows_fix(lf, b, u, u_halo, line_rows_carry(lf, gathered),
                        omega)
    count_launch("line_visit9_rows" if lf.nxl is None
                 else "line_visit9_blocks", out.dtype)
    return out
