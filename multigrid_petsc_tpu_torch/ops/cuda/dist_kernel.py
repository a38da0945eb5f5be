"""K17: one fused level visit on one rank's block of a partitioned level:
a row block of the rows layout, or a 2-D block of the blocks layout.

Counterpart of ``multigrid_petsc_tpu/ops/pallas/dist_kernel.py``
(``dist_level_visit_local``, its ``pallas_call`` at :524 through
``build_call`` :465, bodies ``_make_dist_kernel`` :275 and
``_make_dist9_kernel`` :184), which serves the rows layout; under the
blocks layout JAX runs its levels as XLA ops through GSPMD, and the port
runs them on the same kernel's 2-D block mode:

  row_visit    [u += P e] -> k steps -> u | A u | b - A u | (u, r) | (u, R r)
               on the (R, nx) block of global rows [row0, row0 + R)
  block_visit  the same on the (R, C) block from the global point (row0,
               col0)

A partitioned level carries one pad row (ny + 1 rows, R = (ny + 1) / P per
rank; the pad row is the last rank's last row), and under the blocks
layout one pad column along a split x axis too, so every split extent is
even and the coarse level's block is the (R / 2, C / 2) points under it
(an axis the blocks layout does not split holds its whole odd extent, and
its coarse extent is the floor of half).  The points past the block
arrive as halo buffers of h = ``halo_rows(k, emit)`` points
(``parallel.halo.edge_exchange``: h rows above and below;
``parallel.halo.block_exchange``: ``Halo2``, the h columns left and right
and the h rows above and below the column-extended block, corners
included; zeros at the global edges), those of a coarse correction as
``coarse_halo_rows(h)`` points; the halo may not exceed a split extent
(points come from the immediate neighbours only).

The TPU kernel ships per-slab coefficient windows with the pad and phantom
rows encoded as absorbing identity rows.  On the card the visit is a mode
of the whole-grid visit kernel
(``csrc/visit.cuh`` Block, entries ``mg_visit_part`` /
``mg_visit9_part``; emits a and r ``mg_stencil_part``, the
one-point-halo tile kernel, and ``mg_stencil9_part``, K12's strip kernel;
a row block is a block with no side buffers): b, u and e are read in place, the points past the block from
the halo buffers, and the Dirichlet mask, the coefficients and the
prolongation go by the global point, so the global pad row and column of
every output and the global coarse pad row and column of rc are written
as 0.  Coefficients are indexed by global point: the 5-point (ny, 1)
columns are whole on every rank; the 9-point coefficients that vary with
y hold the rows from ``coeff_row0`` on, those that vary with x the
columns from ``coeff_col0`` on (``parallel.dist_ops.DistLevelOps`` and
``parallel.block_ops.BlockLevelOps`` keep the block's rows and columns
and ``max_sweeps + 2`` more on each side).  What bounds it: bytes, as the
whole-grid visit; the halo adds 2h rows (and 2h columns) of reads per
block.

Under the rows layout a visit runs as JAX's does (dist_kernel.py:419-428,
its split :566-613): where JAX's row tile t (``pick_tile``) cuts the
block into g = R / t >= 3 tiles, one launch on the interior rows [t, R -
t), whose halo rows are the block's own, is queued while the exchange is
in flight, then two on the edge rows [0, t) and [R - t, R), which read
the exchanged rows past the block's edges (``row_visit_split``; the
reference's scatter-begin / local SpMV / scatter-end, src/solver.c:1516,
1535,1540).  A piece is a row block of the same kernel whose halo buffers
point into the rank's own rows, writing its rows of one output of the
whole block; the pieces' outputs are the whole block's, bit for bit.
With g < 3 the exchange ends first and one launch runs, as in JAX.  The
blocks layout runs its exchange first (JAX runs those levels through
GSPMD, with no kernel to split).

Storage types: f32, f64 and bf16, for row blocks and 2-D blocks
(``visit.cu``, ``visit_f64.cu``, ``visit_rows_bf16.cu``; the bf16
preconditioner's split levels; bf16 is storage only, as JAX's
dist kernel runs it (dist_kernel.py:204-260): every input read into f32,
f32 arithmetic, each output rounded to bf16 once where it is stored,
which ``row_visit_plain`` follows through ``at_stores``).  Each wrapper
runs its plain PyTorch version (``row_visit_plain``,
``block_visit_plain``) when the data lies on the CPU, launches the kernel
when it lies on a CUDA device (anything else raises), and never falls
back from one to the other; it counts each launch as
``dist_level_visit`` (2-D blocks: ``dist_level_visit.blocks``; with the
suffix ``.f64``, ``.bf16``), and beside that total, in ``emits``, the
launches of each emit (``"a"``, ``"r"``, ``"rc"``..., 2-D blocks'
``"rc.blocks"``..., with the same suffix); a split visit is three
launches.  ``row_visits`` counts the row layout's visits by level, split
or whole.

``halo_rows``, ``pick_tile`` and ``separable9`` keep the JAX module's
rules, which decide the level split (``parallel.dist_ops.dist_viable``,
``solvers.context``) and where a row visit splits (``split_pieces``); the
port's kernel has no row tile and no VMEM budget and ships every
coefficient as it is.  Kept for parity (ROADMAP).
"""

from __future__ import annotations

from collections import Counter
from typing import NamedTuple

import numpy as np
import torch

from multigrid_petsc_tpu_torch.ops import stencil as _st
from multigrid_petsc_tpu_torch.ops.cuda import _SUFFIX, count_launch
from multigrid_petsc_tpu_torch.ops.cuda._build import check, load_library
from multigrid_petsc_tpu_torch.ops.cuda.mdma_kernel import (
    _EMIT_SHIFT,
    _EMITS,
    _F_CORRECT,
    _F_GUESS,
    _check_cuda,
    _on_cpu,
    _stencil_fields,
    _stream,
    at_stores,
    coeff9_args,
    compute_dtype,
    entry,
    max_visit_steps,
    steps_tensor,
    visit_fits,
)
from multigrid_petsc_tpu_torch.ops.stencil import Stencil5, Stencil9
from multigrid_petsc_tpu_torch.ops.transfer import prolong_bilinear, restrict_fw

ROW_DTYPES = (torch.float32, torch.float64, torch.bfloat16)
# The 2-D block mode's storage types, and the name its launches are
# counted under (``ops.cuda.launches``: "dist_level_visit.blocks",
# "dist_level_visit.blocks.f64", "dist_level_visit.blocks.bf16").
BLOCK_DTYPES = (torch.float32, torch.float64, torch.bfloat16)
BLOCKS = "dist_level_visit.blocks"

# Extra halo rows beyond the smoothing steps, per emit (JAX
# dist_kernel.py:64): the trailing residual costs one row, the restriction
# window one more.
_EXTRA_H = {"u": 0, "a": 1, "r": 1, "ur": 1, "rc": 2}
# K17's launches per emit (and storage type), beside the total that
# ``ops.cuda.launches`` keeps; cleared by the caller as that one is.
emits: Counter = Counter()
# The row layout's visits (``row_visit_split``) by level and kind: "<ny>
# split" (the interior and edge launches) or "<ny> whole" (one launch);
# cleared by the caller as ``emits``.
row_visits: Counter = Counter()


def halo_rows(sweeps: int, emit: str) -> int:
    return sweeps + _EXTRA_H[emit]


def coarse_halo_rows(h: int) -> int:
    """Coarse-correction halo rows on each side for fine halo ``h``: the
    prolongation onto fine rows [row0 - h, row0 + R + h) reads coarse rows
    [row0 / 2 - (h // 2 + 1), row0 / 2 + R / 2 + h // 2 + 1)."""
    return h // 2 + 1


def _e_halo_rows(h: int) -> tuple[int, int]:
    """JAX's (top, bottom) coarse halo rows for fine halo ``h``."""
    th = h // 2 + 1 if h % 2 == 0 else (h + 1) // 2
    return th, h + 1 - th


def pick_tile(R: int, h: int, nx: int | None = None, itemsize: int = 4,
              cap: int = 256) -> int | None:
    """JAX's row tile (dist_kernel.py:78-96): the largest even divisor of
    ``R`` that is <= cap, carries the halo (h < t, coarse halo <= t / 2)
    and fits the TPU kernel's VMEM budget; None if there is none.  It
    decides which levels shard (``dist_viable``) and where a row visit
    splits (``split_pieces``)."""
    if nx is not None:
        budget = 80 * 2**20
        max_t2 = budget // (13 * max(nx, 1) * itemsize)
        cap = max(2, min(cap, max_t2 - 2 * h))
    th, bh = _e_halo_rows(h)
    for t in range(min(R, cap), 1, -1):
        if R % t == 0 and t % 2 == 0 and t > h and t // 2 >= max(th, bh):
            return t
    return None


def _split_additive(a: torch.Tensor) -> bool:
    """Is ``a`` additively separable, col[:, None] + row[None, :], to its
    dtype's roundoff (JAX dist_kernel.py:125-140)?  A scalar, a row or a
    column is; an (ny, nx) field is checked where it lies."""
    if a.shape[0] == 1 or a.shape[1] == 1:
        return True
    eps = 1e-12 if a.element_size() >= 8 else 1e-6
    a = a.detach().double()
    approx = (a[:, :1] - a[:1, :1]) + a[:1, :]
    scale = float(a.abs().max()) or 1.0
    return bool(((approx - a).abs() <= eps * scale).all())


def separable9(st: Stencil9) -> bool:
    """JAX's eligibility rule for a 9-point level on the distributed path:
    every coefficient additively separable (true of every problem family
    of the repo)."""
    return all(map(_split_additive, st))


class Halo(NamedTuple):
    """The rows just above (top) and below (bot) a block, from its
    neighbours: (h, w) each."""

    top: torch.Tensor
    bot: torch.Tensor


class Halo2(NamedTuple):
    """The ring of depth h around an (R, C) block of the blocks layout:
    the rows above (top) and below (bot) the column-extended block, (h, C
    + 2h) each, corners included, and the columns left and right of the
    block, (R, h) each."""

    top: torch.Tensor
    bot: torch.Tensor
    left: torch.Tensor
    right: torch.Tensor


# --------------------------------------------------------------------------
# Plain PyTorch version (the CPU path and the kernel's oracle).
# --------------------------------------------------------------------------


def _coeff_rows(st, grow: torch.Tensor, ny: int, coeff_row0: int):
    """The stencil on the global rows ``grow`` (clamped into the domain;
    rows outside it are masked by the caller): each coefficient that
    varies with y indexed by its stored rows."""
    idx = grow.clamp(0, ny - 1) - coeff_row0

    def rows(c):
        if c.shape[0] == 1:
            return c
        if int(idx.min()) < 0 or int(idx.max()) >= c.shape[0]:
            raise ValueError("the coefficients do not hold the rows this "
                             "visit reads")
        return c[idx]

    return type(st)(*map(rows, st))


def _extend(x, halo: Halo | None, h: int, inside):
    """[top; x; bot] masked to the domain's rows."""
    if halo is None:
        raise ValueError("this visit needs the halo rows of its operand")
    return torch.where(inside, torch.cat([halo.top, x, halo.bot]), 0.0)


def _sweep(ste, be, ue, inside, steps):
    """The step recurrence on an extended region (p = 0 outside the
    domain); ``ue=None`` is the zero guess."""
    dinv = 1.0 / ste.cc
    p = None
    for s, (a, bt) in enumerate(steps):
        if s == 0 and ue is None:
            p = torch.where(inside, a * (dinv * be), 0.0)
            ue = p
            continue
        z = dinv * (be - _st.apply_stencil(ste, ue))
        p = a * z if s == 0 else bt * p + a * z
        p = torch.where(inside, p, 0.0)
        ue = ue + p
    return torch.zeros_like(be) if ue is None else ue


@at_stores
def row_visit_plain(st, b, u, steps, emit: str, *, row0: int, ny: int,
                    b_halo: Halo | None = None, u_halo: Halo | None = None,
                    e=None, e_halo: Halo | None = None,
                    coeff_row0: int = 0):
    """The row-block visit's composition on the extended rows [row0 - h,
    row0 + R + h): the global-row mask, [u + P e], the step recurrence
    (p = 0 at masked rows), the emits, cropped to the block; the pad row
    and the coarse pad row come out 0.  ``u=None`` is the zero guess.  On
    bf16 storage the arithmetic runs in f32 and each output is rounded
    once (``at_stores``)."""
    blk = u if b is None else b
    R, nx = blk.shape
    k = len(steps)
    h = halo_rows(k, emit)
    grow = torch.arange(row0 - h, row0 + R + h, device=blk.device)
    inside = ((grow >= 0) & (grow < ny))[:, None]
    ste = _coeff_rows(st, grow, ny, coeff_row0)
    if emit in ("a", "r"):
        au = _st.apply_stencil(ste, _extend(u, u_halo, h, inside))[h:h + R]
        out = au if emit == "a" else b - au
        return torch.where(inside[h:h + R], out, 0.0)
    be = _extend(b, b_halo, h, inside)
    ue = None if u is None else _extend(u, u_halo, h, inside)
    if e is not None:
        hc = coarse_halo_rows(h)
        ce = torch.cat([e_halo.top, e, e_halo.bot])
        crow = torch.arange(row0 // 2 - hc, row0 // 2 - hc + ce.shape[0],
                            device=blk.device)
        ce = torch.where(((crow >= 0) & (crow < (ny - 1) // 2))[:, None],
                         ce, 0.0)
        # Fine row f of the prolongation is global row row0 - 2 hc + f.
        pe = prolong_bilinear(ce)[2 * hc - h:2 * hc - h + R + 2 * h]
        ue = ue + torch.where(inside, pe, 0.0)
    ue = _sweep(ste, be, ue, inside, steps)
    u_out = ue[h:h + R]
    if emit == "u":
        return u_out
    r = torch.where(inside, be - _st.apply_stencil(ste, ue), 0.0)
    if emit == "ur":
        return u_out, r[h:h + R]
    rc = restrict_fw(r[h:h + R + 1])
    crow = torch.arange(row0 // 2, row0 // 2 + R // 2, device=blk.device)
    return u_out, torch.where((crow < (ny - 1) // 2)[:, None], rc, 0.0)


def _coeff_block(st, grow: torch.Tensor, gcol: torch.Tensor, ny: int,
                 nx: int, coeff_row0: int, coeff_col0: int):
    """The stencil on the global rows ``grow`` and columns ``gcol``
    (clamped into the domain; points outside it are masked by the caller):
    each coefficient that varies with y (x) indexed by its stored rows
    (columns)."""
    ri = grow.clamp(0, ny - 1) - coeff_row0
    ci = gcol.clamp(0, nx - 1) - coeff_col0

    def cut(c):
        for axis, idx in ((0, ri), (1, ci)):
            if c.shape[axis] == 1:
                continue
            if int(idx.min()) < 0 or int(idx.max()) >= c.shape[axis]:
                raise ValueError("the coefficients do not hold the points "
                                 "this visit reads")
            c = c[idx] if axis == 0 else c[:, idx]
        return c

    return type(st)(*map(cut, st))


def _extend2(x, halo: Halo2 | None, inside):
    """[top; left | x | right; bot] masked to the domain."""
    if halo is None:
        raise ValueError("this visit needs the halo of its operand")
    mid = torch.cat([halo.left, x, halo.right], 1)
    return torch.where(inside, torch.cat([halo.top, mid, halo.bot]), 0.0)


def _inside(lo_y, n_y, ny, lo_x, n_x, nx, device):
    gy = torch.arange(lo_y, lo_y + n_y, device=device)
    gx = torch.arange(lo_x, lo_x + n_x, device=device)
    return ((gy >= 0) & (gy < ny))[:, None] & ((gx >= 0) & (gx < nx))[None]


@at_stores
def block_visit_plain(st, b, u, steps, emit: str, *, row0: int, col0: int,
                      ny: int, nx: int, b_halo: Halo2 | None = None,
                      u_halo: Halo2 | None = None, e=None,
                      e_halo: Halo2 | None = None, coeff_row0: int = 0,
                      coeff_col0: int = 0):
    """K17's 2-D block mode, composed on the extended block [row0 - h,
    row0 + R + h) x [col0 - h, col0 + C + h): the global mask, [u + P e],
    the step recurrence (p = 0 outside the domain), the emits, cropped to
    the block; the pad row and column and the coarse pad row and column
    come out 0.  ``u=None`` is the zero guess.  The CPU path of
    ``block_visit`` and its kernel's oracle; on bf16 storage the
    arithmetic runs in f32 and each output is rounded once
    (``at_stores``)."""
    blk = u if b is None else b
    R, C = blk.shape
    dev = blk.device
    h = halo_rows(len(steps), emit)
    inside = _inside(row0 - h, R + 2 * h, ny, col0 - h, C + 2 * h, nx, dev)
    ste = _coeff_block(st, torch.arange(row0 - h, row0 + R + h, device=dev),
                       torch.arange(col0 - h, col0 + C + h, device=dev), ny,
                       nx, coeff_row0, coeff_col0)
    def crop(x):  # the block's points, contiguous as the kernel's
        return x[h:h + R, h:h + C].contiguous()

    if emit in ("a", "r"):
        au = crop(_st.apply_stencil(ste, _extend2(u, u_halo, inside)))
        out = au if emit == "a" else b - au
        return torch.where(crop(inside), out, 0.0)
    be = _extend2(b, b_halo, inside)
    ue = None if u is None else _extend2(u, u_halo, inside)
    nyc, nxc = (ny - 1) // 2, (nx - 1) // 2
    if e is not None:
        hc = coarse_halo_rows(h)
        rc0, cc0 = row0 // 2 - hc, col0 // 2 - hc
        ce = _extend2(e, e_halo, _inside(rc0, e.shape[0] + 2 * hc, nyc, cc0,
                                         e.shape[1] + 2 * hc, nxc, dev))
        # Fine point f of the prolongation is global point 2 (rc0, cc0) + f.
        o = 2 * hc - h
        pe = prolong_bilinear(ce)[o:o + R + 2 * h, o:o + C + 2 * h]
        ue = ue + torch.where(inside, pe, 0.0)
    ue = _sweep(ste, be, ue, inside, steps)
    u_out = crop(ue)
    if emit == "u":
        return u_out
    r = torch.where(inside, be - _st.apply_stencil(ste, ue), 0.0)
    if emit == "ur":
        return u_out, crop(r)
    # An even (split) extent reads the next block's first row or column;
    # an odd one (an axis not split) holds the whole extent.
    rc = restrict_fw(r[h:h + R + 1 - R % 2, h:h + C + 1 - C % 2])
    keep = _inside(row0 // 2, R // 2, nyc, col0 // 2, C // 2, nxc, dev)
    return u_out, torch.where(keep, rc, 0.0)


# --------------------------------------------------------------------------
# Kernel wrapper.
# --------------------------------------------------------------------------


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_steps(emit: str, k: int) -> None:
    if emit not in _EXTRA_H:
        raise ValueError(f"emit must be one of {tuple(_EXTRA_H)}, got "
                         f"{emit!r}")
    if emit in ("a", "r") and k:
        raise ValueError("emits a and r take no smoother steps")
    if emit not in ("a", "r") and k < 1:
        raise ValueError("the visit kernel takes at least one step")


class _Launch:
    """K17's launch arguments for one (R, C) block from (row0, col0) of an
    (ny, nx) level, made and checked once (the block entries
    ``mg_visit_part`` ...): the coefficients as the entries take them, the
    geometry, the flags, the schedule in device memory and the entry.  A
    call checks its operands (b, u, e and their halos by name: top, bot
    and, with ``sides`` (the 2-D mode), left, right; a row block is the
    block with no side buffers, C = nx, col0 = 0) and launches into new
    tensors; ``go`` launches on device addresses its caller has checked
    (a row visit's pieces, ``_RowPieces``).  Counted under ``name``."""

    def __init__(self, st, steps, emit: str, *, R: int, C: int, row0: int,
                 col0: int, ny: int, nx: int, guess: bool, correct: bool,
                 coeff_row0: int, coeff_col0: int, sides: bool,
                 dtype: torch.dtype, device: torch.device, dtypes,
                 name: str):
        k = len(steps)
        h = halo_rows(k, emit)
        self.stencil = stencil = emit in ("a", "r")
        nine = isinstance(st, Stencil9)
        Rc, Cc = R // 2, C // 2
        hc = coarse_halo_rows(h) if correct else 0
        hx, hcx = (h, hc) if sides else (0, 0)
        if nine:
            m = max(c.shape[0] for c in st)
            w = max(c.shape[1] for c in st)
            self.c9 = c9 = coeff9_args(st, m, w)
            fields = dict(c9.fields)
            for what, lo, n, off, ext, dom in (
                    ("rows", row0, R, coeff_row0, m, ny),
                    ("columns", col0, C, coeff_col0, w, nx)):
                if ext > 1 and (off > max(0, lo - h)
                                or off + ext < min(dom, lo + n + h)):
                    raise ValueError(f"the coefficients do not hold the "
                                     f"{what} this visit reads")
            kinds = c9.kinds
            self.coeffs = (c9.ptrs.ctypes.data, c9.strides.ctypes.data,
                           coeff_row0, coeff_col0)
        else:
            fields = _stencil_fields(st, ny)
            kinds = None
            self.coeffs = tuple(c.data_ptr() for c in st)
        if dtype not in dtypes:
            raise TypeError(f"this CUDA kernel is built for "
                            f"{', '.join(map(str, dtypes))}, got {dtype}")
        _check_cuda(device, fields, dtypes=(dtype,))
        size = torch.finfo(compute_dtype(dtype)).bits // 8
        if not stencil and not visit_fits(kinds, h, size):
            raise ValueError(
                f"a {9 if nine else 5}-point {dtype} visit with emit "
                f"{emit!r} takes at most "
                f"{max_visit_steps(kinds, emit, size)} steps; got {k}")
        # Per operand: name, wanted, with its halo, shape, the top and
        # bottom halo's shape, the side halo's.
        self.operands = tuple(
            (nm, want, with_halo, shape, (hh, shape[1] + 2 * hs),
             (shape[0], hh))
            for nm, want, with_halo, shape, hh, hs in (
                ("b", emit != "a", not stencil, (R, C), h, hx),
                ("u", stencil or guess, True, (R, C), h, hx),
                ("e", correct, True, (Rc, Cc), hc, hcx)))
        self.sides, self.emit, self.name = sides, emit, name
        self.dtype, self.device = dtype, device
        self.out_shapes = {"a": ((R, C),), "r": ((R, C),), "u": ((R, C),),
                           "ur": ((R, C), (R, C)),
                           "rc": ((R, C), (Rc, Cc))}[emit]
        self.geom = np.asarray([R, row0, ny, h, Rc, hc, C, col0, nx, hx, Cc,
                                hcx], np.int32)
        self.C = C
        if stencil:
            self.fn = entry(load_library(), "mg_stencil9_part" if nine
                            else "mg_stencil_part", dtype)
        else:
            self.fn = entry(load_library(), "mg_visit9_part" if nine
                            else "mg_visit_part", dtype)
            self.flags = ((_F_GUESS if guess else 0)
                          | (_F_CORRECT if correct else 0)
                          | _EMITS[emit] << _EMIT_SHIFT)
            self.steps_d = steps_tensor(steps, device, dtype)
            self.steps_ptr = self.steps_d.data_ptr()
            self.k = k
        self.count = emit + (".blocks" if sides else "") + _SUFFIX[dtype]

    def __call__(self, b, u, e, halos: dict):
        fields, ends, side_ptrs = {}, [], []
        for (nm, want, with_halo, shape, ring, side), x in zip(
                self.operands, (b, u, e)):
            tb, lr = (0, 0), (0, 0)
            if want:
                halo = halos.get(nm)
                if x is None or (with_halo and halo is None):
                    raise ValueError(f"{nm} and its halo are required here")
                fields[nm] = (x, shape)
                if with_halo:
                    fields[nm + "_top"] = (halo.top, ring)
                    fields[nm + "_bot"] = (halo.bot, ring)
                    tb = (halo.top.data_ptr(), halo.bot.data_ptr())
                    if self.sides:
                        fields[nm + "_left"] = (halo.left, side)
                        fields[nm + "_right"] = (halo.right, side)
                        lr = (halo.left.data_ptr(), halo.right.data_ptr())
            ends += tb
            side_ptrs += lr
        _check_cuda(self.device, fields, dtypes=(self.dtype,))
        outs = tuple(torch.empty(s, dtype=self.dtype, device=self.device)
                     for s in self.out_shapes)
        self.go(_ptr(b), _ptr(u), _ptr(e), [o.data_ptr() for o in outs],
                ends + side_ptrs, _stream(self.device))
        return outs if len(outs) > 1 else outs[0]

    def go(self, b, u, e, outs, ends, stream) -> None:
        """The launch itself, on device addresses the caller has checked:
        b, u, e (None: not read), the outputs', the halo buffers' (b, u, e
        top and bottom, then the side buffers; 0 where not read)."""
        ptrs = np.asarray(ends, np.uint64)
        if self.stencil:
            err = self.fn(*self.coeffs, b if self.emit == "r" else None, u,
                          outs[0], self.geom.ctypes.data, ptrs.ctypes.data,
                          self.C, int(self.emit == "r"), stream)
        else:
            second = outs[1] if len(outs) > 1 else None
            err = self.fn(*self.coeffs, b, u, e, outs[0],
                          second if self.emit == "ur" else None,
                          second if self.emit == "rc" else None,
                          self.geom.ctypes.data, ptrs.ctypes.data, self.C,
                          self.steps_ptr, self.k, self.flags, stream)
        check(err, f"{self.name} launch (emit {self.emit})")
        count_launch(self.name, self.dtype)
        emits[self.count] += 1


def row_visit(st, b, u, steps, emit: str, *, row0: int, ny: int,
              b_halo: Halo | None = None, u_halo: Halo | None = None,
              e=None, e_halo: Halo | None = None, coeff_row0: int = 0):
    """One row-block visit (K17) of the block of global rows [row0, row0 +
    R) of a level with ``ny`` real rows, for a Stencil5 or a Stencil9.
    Emits "a" (A u) and "r" (b - A u) take no steps and u's halo only;
    "u", "ur" and "rc" take at least one step, b's halo, u's (None: the
    zero guess) and, to correct, the local coarse block ``e`` (R / 2,
    (nx - 1) / 2) with its halo.  Halo buffers hold ``halo_rows(len(steps),
    emit)`` rows (``coarse_halo_rows`` of them for e).  Returns u', A u,
    b - A u, (u', r) or (u', R r), R r the (R / 2, (nx - 1) / 2) coarse
    block.  One launch on the whole block (``row_visit_split`` without a
    tile)."""
    halos = dict(b=b_halo, u=u_halo, e=e_halo)
    return row_visit_split(st, b, u, steps, emit, row0=row0, ny=ny, t=None,
                           halos=lambda: halos, e=e, coeff_row0=coeff_row0)


def _check_rows(R: int, h: int, row0: int, ny: int) -> None:
    if R % 2 or h > R or row0 % 2 or (ny + 1) % R:
        raise ValueError(f"a row block of {R} rows from row {row0} cannot "
                         f"carry halo {h} (even blocks, h <= R)")


def split_pieces(R: int, t: int | None) -> tuple:
    """The row ranges [lo, hi) of a block of ``R`` rows that a visit
    launches on, in the order it launches them, with whether each reads
    the exchanged rows: JAX's split (dist_kernel.py:566-613) where the
    tile ``t`` cuts the block into g = R / t >= 3 tiles, the interior
    tiles 1..g-2 first (their halo rows are the block's own), then the
    edge tiles 0 and g - 1; else the whole block, as JAX runs g < 3
    (:541-564)."""
    if t is None or R // t < 3:
        return ((0, R, True),)
    return ((t, R - t, False), (0, t, True), (R - t, R, True))


def _piece_halo(x, lo: int, hi: int, n: int,
                halo: Halo | None) -> Halo | None:
    """The ``n`` rows of ``x`` above and below its rows [lo, hi): its own
    rows inside the block, the exchanged ``halo`` past its edges (None
    where that is needed and not given)."""
    if halo is None and (lo == 0 or hi == x.shape[0]):
        return None
    top = halo.top if lo == 0 else x[lo - n:lo]
    bot = halo.bot if hi == x.shape[0] else x[hi:hi + n]
    return Halo(top, bot)


def _fast_check(device: torch.device, dtype: torch.dtype,
                fields: dict) -> None:
    """``_check_cuda``'s checks of storage type, device, shape and
    contiguity in a few attribute reads a field; a field that fails goes
    to ``_check_cuda`` for its message."""
    idx = device.index
    for name, (t, shp) in fields.items():
        if not (t.dtype is dtype and t.is_cuda and t.get_device() == idx
                and t.shape == shp and t.is_contiguous()):
            _check_cuda(device, {name: (t, shp)}, dtypes=(dtype,))
            raise ValueError(f"{name} is on {t.device}, expected {device}")


class _RowPieces:
    """One row-block visit's operands on the card, checked once, and the
    launches of its pieces on device addresses: a piece's rows of b, u,
    e and of the outputs, and its halo rows, are the block's own rows at
    an offset, or the exchanged rows past the block's edges
    (``take_halos``), so a piece slices no tensor and checks nothing
    again.  Each piece's launch arguments (``_Launch``) are kept in
    ``prepared`` per schedule, emit, operands, type and piece."""

    def __init__(self, st, b, u, e, steps, emit: str, *, row0: int,
                 ny: int, coeff_row0: int, prepared: dict | None,
                 outs: tuple):
        blk = u if b is None else b
        self.dtype, self.device = blk.dtype, blk.device
        if self.dtype not in ROW_DTYPES:
            raise TypeError(f"this CUDA kernel is built for "
                            f"{', '.join(map(str, ROW_DTYPES))}, got "
                            f"{self.dtype}")
        R, nx = blk.shape
        isz = blk.element_size()
        h = halo_rows(len(steps), emit)
        stencil = emit in ("a", "r")
        self.R, self.nx = R, nx
        fields = {}
        # name, operand, rows, row bytes, halo rows, row scale, read with
        # its halo
        self.ops = []
        for nm, x, rows, w, n, want, with_halo in (
                ("b", b, R, nx, h, emit != "a", not stencil),
                ("u", u, R, nx, h, stencil or u is not None, True),
                ("e", e, R // 2, (nx - 1) // 2, coarse_halo_rows(h),
                 e is not None, True)):
            if want and x is None:
                raise ValueError(f"{nm} is required here")
            if x is not None:
                fields[nm] = (x, (rows, w))
            self.ops.append((nm, None if x is None else x.data_ptr(), rows,
                             w * isz, n, 2 if nm == "e" else 1,
                             want and with_halo, w))
        _fast_check(self.device, self.dtype, fields)
        self.outs = [(o.data_ptr(), o.shape[1] * o.element_size(),
                      2 if emit == "rc" and i == 1 else 1)
                     for i, o in enumerate(outs)]
        self.remote = {}
        self.st, self.steps, self.emit = st, steps, emit
        self.row0, self.ny, self.coeff_row0 = row0, ny, coeff_row0
        self.prepared = {} if prepared is None else prepared
        self.key = (tuple(steps), emit, u is not None, e is not None,
                    self.dtype)
        self.stream = _stream(self.device)

    def take_halos(self, halos: dict) -> None:
        """The exchanged rows past the block's edges, by name, checked."""
        fields = {}
        for nm, base, rows, rb, n, _, with_halo, w in self.ops:
            if not with_halo:
                continue
            halo = halos.get(nm)
            if halo is None:
                raise ValueError(f"{nm}'s halo is required here")
            fields[nm + "_top"] = (halo.top, (n, w))
            fields[nm + "_bot"] = (halo.bot, (n, w))
            self.remote[nm] = (halo.top.data_ptr(), halo.bot.data_ptr())
        _fast_check(self.device, self.dtype, fields)

    def piece(self, lo: int, hi: int) -> None:
        """The launch on the block's rows [lo, hi)."""
        launch = self.prepared.get(self.key + (lo, hi))
        if launch is None:
            launch = self.prepared[self.key + (lo, hi)] = _Launch(
                self.st, self.steps, self.emit, R=hi - lo, C=self.nx,
                row0=self.row0 + lo, col0=0, ny=self.ny, nx=self.nx,
                guess=self.key[2], correct=self.key[3],
                coeff_row0=self.coeff_row0, coeff_col0=0, sides=False,
                dtype=self.dtype, device=self.device, dtypes=ROW_DTYPES,
                name="dist_level_visit")
        at, ends = [], []
        for nm, base, rows, rb, n, sc, with_halo, _ in self.ops:
            lo_, hi_ = lo // sc, hi // sc
            at.append(None if base is None else base + lo_ * rb)
            if not with_halo:
                ends += (0, 0)
                continue
            if (lo_ == 0 or hi_ == rows) and nm not in self.remote:
                raise ValueError(f"the rows [{lo}, {hi}) read {nm}'s "
                                 f"exchanged rows")
            top = self.remote[nm][0] if lo_ == 0 else base + (lo_ - n) * rb
            bot = self.remote[nm][1] if hi_ == rows else base + hi_ * rb
            ends += (top, bot)
        outs = [p + (lo // sc) * rb for p, rb, sc in self.outs]
        launch.go(*at, outs, ends + [0] * 6, self.stream)


def row_visit_split(st, b, u, steps, emit: str, *, row0: int, ny: int,
                    t: int | None, halos, e=None, coeff_row0: int = 0,
                    prepared: dict | None = None):
    """One row-block visit (K17; the emits, steps and returns of
    ``row_visit``) launched on the pieces of ``split_pieces(R, t)``: with
    g = R / t >= 3 tiles the interior rows [t, R - t) first, then
    ``halos()``, the exchange's wait, which gives the exchanged halo rows
    by name ({"b": Halo, "u": ..., "e": ...}, as ``row_visit`` takes
    them), then the edge rows [0, t) and [R - t, R); with fewer tiles
    ``halos()`` and one launch on the whole block.  Every piece writes
    its rows of one output of the whole block (rc: the coarse rows [lo /
    2, hi / 2)) and reads the rows past it from the block itself, the
    exchanged rows past the block's edges only; each point's steps are
    the whole block's, on the same inputs, so the pieces' outputs are the
    whole block's.  ``e`` is the block's coarse correction (R / 2 rows).
    CPU tensors run ``row_visit_plain`` on the pieces; CUDA tensors the
    kernel, the operands checked once a visit and each piece launched on
    device addresses (``_RowPieces``), its launch arguments kept in
    ``prepared`` (a dict the caller holds across visits; None: made
    anew).  Counted in ``row_visits`` as one visit of a level of ``ny``
    rows, split or whole."""
    blk = u if b is None else b
    R = blk.shape[0]
    k = len(steps)
    _check_steps(emit, k)
    h = halo_rows(k, emit)
    cpu = _on_cpu(blk)
    if not cpu:
        _check_rows(R, h, row0, ny)
    pieces = split_pieces(R, t)
    if len(pieces) > 1:
        hc = coarse_halo_rows(h) if e is not None else 0
        if R % t or t % 2 or t <= h or 2 * hc > t:
            raise ValueError(f"a tile of {t} rows cannot split a block of "
                             f"{R} rows with halo {h}")
    outs = row_outputs(blk, emit)
    run = None if cpu else _RowPieces(
        st, b, u, e, steps, emit, row0=row0, ny=ny, coeff_row0=coeff_row0,
        prepared=prepared, outs=outs)
    rem = None
    for lo, hi, edge in pieces:
        if edge and rem is None:
            rem = halos()
            if run is not None:
                run.take_halos(rem)
        if run is not None:
            run.piece(lo, hi)
        else:
            _plain_piece(st, b, u, steps, emit, row0=row0, ny=ny, lo=lo,
                         hi=hi, halos=rem or {}, out=outs, e=e,
                         coeff_row0=coeff_row0)
    row_visits[f"{ny} {'split' if len(pieces) > 1 else 'whole'}"] += 1
    return outs if len(outs) > 1 else outs[0]


def row_outputs(blk: torch.Tensor, emit: str) -> tuple:
    """A row block's outputs of ``emit``, empty: (u' or A u or b - A u,)
    and r or the (R / 2, (nx - 1) / 2) coarse block R r."""
    R, nx = blk.shape
    shapes = {"ur": ((R, nx), (R, nx)),
              "rc": ((R, nx), (R // 2, (nx - 1) // 2))}.get(emit,
                                                           ((R, nx),))
    return tuple(torch.empty(s, dtype=blk.dtype, device=blk.device)
                 for s in shapes)


def row_visit_piece(st, b, u, steps, emit: str, *, row0: int, ny: int,
                    lo: int, hi: int, halos: dict, out: tuple, e=None,
                    coeff_row0: int = 0, prepared: dict | None = None):
    """K17 on the rows [lo, hi) of the row block [row0, row0 + R) (``b``,
    ``u``, ``e`` the whole block's operands, as ``row_visit_split`` takes
    them): the rows past the piece read from the block, past the block
    from ``halos`` (by name; needed only where the piece reaches the
    block's edge), its rows written into ``out``, the whole block's
    outputs (``row_outputs``).  CPU tensors run ``row_visit_plain`` on the
    piece, CUDA tensors one launch (its arguments kept in ``prepared``
    where given)."""
    blk = u if b is None else b
    if _on_cpu(blk):
        _plain_piece(st, b, u, steps, emit, row0=row0, ny=ny, lo=lo, hi=hi,
                     halos=halos, out=out, e=e, coeff_row0=coeff_row0)
        return
    run = _RowPieces(st, b, u, e, steps, emit, row0=row0, ny=ny,
                     coeff_row0=coeff_row0, prepared=prepared, outs=out)
    if lo == 0 or hi == blk.shape[0]:
        run.take_halos(halos)
    run.piece(lo, hi)


def _plain_piece(st, b, u, steps, emit: str, *, row0: int, ny: int, lo: int,
                 hi: int, halos: dict, out: tuple, e, coeff_row0: int):
    """``row_visit_piece`` on the CPU: ``row_visit_plain`` on the piece's
    rows and halo rows, copied into its rows of ``out``."""
    h = halo_rows(len(steps), emit)
    ops = {"b": b, "u": u, "e": e}
    need = ("u",) if emit in ("a", "r") else tuple(
        nm for nm in ("b", "u", "e") if ops[nm] is not None)
    ph = {nm: _piece_halo(ops[nm], lo, hi, h, halos.get(nm)) if nm != "e"
          else _piece_halo(e, lo // 2, hi // 2, coarse_halo_rows(h),
                           halos.get("e"))
          for nm in need}
    pb, pu = (None if x is None else x[lo:hi] for x in (b, u))
    pe = None if e is None else e[lo // 2:hi // 2]
    got = row_visit_plain(st, pb, pu, steps, emit, row0=row0 + lo, ny=ny,
                          b_halo=ph.get("b"), u_halo=ph.get("u"), e=pe,
                          e_halo=ph.get("e"), coeff_row0=coeff_row0)
    views = (o[lo:hi] if i == 0 or emit == "ur" else o[lo // 2:hi // 2]
             for i, o in enumerate(out))
    for v, g in zip(views, got if isinstance(got, tuple) else (got,)):
        v.copy_(g)


def block_visit(st, b, u, steps, emit: str, *, row0: int, col0: int, ny: int,
                nx: int, b_halo: Halo2 | None = None,
                u_halo: Halo2 | None = None, e=None,
                e_halo: Halo2 | None = None, coeff_row0: int = 0,
                coeff_col0: int = 0):
    """One visit of K17's 2-D block mode on the (R, C) block from the
    global point (row0, col0) of an (ny, nx) level, for a Stencil5 or a
    Stencil9 (the blocks layout; the emits and steps of ``row_visit``).
    Halo buffers (``Halo2``) hold ``halo_rows(len(steps), emit)`` points
    around b and u (``coarse_halo_rows`` of them around e, the (R / 2, C
    / 2) coarse block; an axis not split has an odd extent and its coarse
    block is the floor of half).  A 9-point stencil's coefficients that
    vary with y hold the rows from ``coeff_row0``, those that vary with x
    the columns from ``coeff_col0``; the 5-point (ny, 1) columns are
    whole.  Returns u', A u, b - A u, (u', r) or (u', R r).  CPU tensors
    run ``block_visit_plain``, CUDA tensors the kernel (f32, f64, bf16);
    anything else raises."""
    blk = u if b is None else b
    if _on_cpu(blk):
        return block_visit_plain(st, b, u, steps, emit, row0=row0,
                                 col0=col0, ny=ny, nx=nx, b_halo=b_halo,
                                 u_halo=u_halo, e=e, e_halo=e_halo,
                                 coeff_row0=coeff_row0,
                                 coeff_col0=coeff_col0)
    _check_steps(emit, len(steps))
    if row0 % 2 or col0 % 2:
        raise ValueError(f"a block from ({row0}, {col0}): its origin must "
                         f"be even")
    R, C = blk.shape
    return _Launch(st, steps, emit, R=R, C=C, row0=row0, col0=col0, ny=ny,
                   nx=nx, guess=u is not None, correct=e is not None,
                   coeff_row0=coeff_row0, coeff_col0=coeff_col0, sides=True,
                   dtype=blk.dtype, device=blk.device, dtypes=BLOCK_DTYPES,
                   name=BLOCKS)(b, u, e, dict(b=b_halo, u=u_halo, e=e_halo))
