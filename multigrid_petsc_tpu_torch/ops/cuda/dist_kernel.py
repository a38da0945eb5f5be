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
rows encoded as absorbing identity rows, and splits each visit into an
interior and an edge call so that the exchange overlaps the interior.  On
the card the visit is a mode of the whole-grid visit kernel
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
and ``max_sweeps + 2`` more on each side).  The exchange runs before the
kernel (overlap is later work).  What bounds it: bytes, as the
whole-grid visit; the halo adds 2h rows (and 2h columns) of reads per
block.

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
``"rc.blocks"``..., with the same suffix).

``halo_rows``, ``pick_tile`` and ``separable9`` keep the JAX module's
rules, which decide the level split (``parallel.dist_ops.dist_viable``,
``solvers.context``); the port's kernel has no row tile and no VMEM budget
and ships every coefficient as it is.  Kept for parity (ROADMAP).
"""

from __future__ import annotations

import functools
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
    and fits the TPU kernel's VMEM budget; None if there is none.  Only
    ``dist_viable`` reads it: it decides which levels shard."""
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


def _launch(st, b, u, steps, emit: str, *, row0: int, col0: int, ny: int,
            nx: int, halos: dict, e, coeff_row0: int, coeff_col0: int,
            sides: bool, dtypes, name: str):
    """One launch of K17's kernel through the block entries
    (``mg_visit_part`` ...): on the (R, C) block from (row0, col0) of an
    (ny, nx) level, the halos of b, u and e by name (top, bot and, with
    ``sides`` (the 2-D mode), left, right); a row block is the block with
    no side buffers (C = nx, col0 = 0).  Counted under ``name``."""
    blk = u if b is None else b
    R, C = blk.shape
    k = len(steps)
    h = halo_rows(k, emit)
    stencil = emit in ("a", "r")
    nine = isinstance(st, Stencil9)
    Rc, Cc = R // 2, C // 2
    hc = coarse_halo_rows(h) if e is not None else 0
    hx, hcx = (h, hc) if sides else (0, 0)
    if nine:
        m = max(c.shape[0] for c in st)
        w = max(c.shape[1] for c in st)
        c9 = coeff9_args(st, m, w)
        fields = dict(c9.fields)
        for what, lo, n, off, ext, dom in (
                ("rows", row0, R, coeff_row0, m, ny),
                ("columns", col0, C, coeff_col0, w, nx)):
            if ext > 1 and (off > max(0, lo - h)
                            or off + ext < min(dom, lo + n + h)):
                raise ValueError(f"the coefficients do not hold the {what} "
                                 f"this visit reads")
        kinds = c9.kinds
    else:
        fields = _stencil_fields(st, ny)
        kinds = None
    need_u = stencil or u is not None
    ends, side_ptrs = [], []
    for nm, x, shape, hh, hs, want, with_halo in (
            ("b", b, (R, C), h, hx, emit != "a", not stencil),
            ("u", u, (R, C), h, hx, need_u, True),
            ("e", e, (Rc, Cc), hc, hcx, e is not None, True)):
        tb, lr = (0, 0), (0, 0)
        halo = halos.get(nm)
        if want:
            if x is None or (with_halo and halo is None):
                raise ValueError(f"{nm} and its halo are required here")
            fields[nm] = (x, shape)
            if with_halo:
                ring = (hh, shape[1] + 2 * hs)
                fields[nm + "_top"] = (halo.top, ring)
                fields[nm + "_bot"] = (halo.bot, ring)
                tb = (halo.top.data_ptr(), halo.bot.data_ptr())
                if sides:
                    fields[nm + "_left"] = (halo.left, (shape[0], hh))
                    fields[nm + "_right"] = (halo.right, (shape[0], hh))
                    lr = (halo.left.data_ptr(), halo.right.data_ptr())
        ends += tb
        side_ptrs += lr
    dtype = _check_cuda(blk.device, fields, dtypes=dtypes)
    size = torch.finfo(compute_dtype(dtype)).bits // 8
    if not stencil and not visit_fits(kinds, h, size):
        raise ValueError(
            f"a {9 if nine else 5}-point {dtype} visit with emit {emit!r} "
            f"takes at most {max_visit_steps(kinds, emit, size)} steps; got "
            f"{k}")
    lib = load_library()
    geom = np.asarray([R, row0, ny, h, Rc, hc, C, col0, nx, hx, Cc, hcx],
                      np.int32)
    ptrs = np.asarray(ends + side_ptrs, np.uint64)
    stream = _stream(blk.device)
    coeffs = ((c9.ptrs.ctypes.data, c9.strides.ctypes.data, coeff_row0,
               coeff_col0) if nine else tuple(c.data_ptr() for c in st))
    new = functools.partial(torch.empty, dtype=dtype, device=blk.device)
    if stencil:
        out = new((R, C))
        err = entry(lib, "mg_stencil9_part" if nine else "mg_stencil_part",
                    dtype)(
            *coeffs, _ptr(b if emit == "r" else None), u.data_ptr(),
            out.data_ptr(), geom.ctypes.data, ptrs.ctypes.data, C,
            int(emit == "r"), stream)
    else:
        u_out = new((R, C))
        r_out = new((R, C)) if emit == "ur" else None
        rc_out = new((Rc, Cc)) if emit == "rc" else None
        flags = ((_F_GUESS if u is not None else 0)
                 | (_F_CORRECT if e is not None else 0)
                 | _EMITS[emit] << _EMIT_SHIFT)
        steps_d = steps_tensor(steps, blk.device, dtype)
        err = entry(lib, "mg_visit9_part" if nine else "mg_visit_part",
                    dtype)(
            *coeffs, b.data_ptr(), _ptr(u), _ptr(e), u_out.data_ptr(),
            _ptr(r_out), _ptr(rc_out), geom.ctypes.data, ptrs.ctypes.data,
            C, steps_d.data_ptr(), k, flags, stream)
        out = {"u": u_out, "ur": (u_out, r_out), "rc": (u_out, rc_out)}[emit]
    check(err, f"{name} launch (emit {emit})")
    count_launch(name, dtype)
    emits[emit + (".blocks" if sides else "") + _SUFFIX[dtype]] += 1
    return out


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
    block."""
    blk = u if b is None else b
    if _on_cpu(blk):
        return row_visit_plain(st, b, u, steps, emit, row0=row0, ny=ny,
                               b_halo=b_halo, u_halo=u_halo, e=e,
                               e_halo=e_halo, coeff_row0=coeff_row0)
    _check_steps(emit, len(steps))
    R, nx = blk.shape
    h = halo_rows(len(steps), emit)
    if R % 2 or h > R or row0 % 2 or (ny + 1) % R:
        raise ValueError(f"a row block of {R} rows from row {row0} cannot "
                         f"carry halo {h} (even blocks, h <= R)")
    return _launch(st, b, u, steps, emit, row0=row0, col0=0, ny=ny, nx=nx,
                   halos=dict(b=b_halo, u=u_halo, e=e_halo), e=e,
                   coeff_row0=coeff_row0, coeff_col0=0, sides=False,
                   dtypes=ROW_DTYPES, name="dist_level_visit")


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
    return _launch(st, b, u, steps, emit, row0=row0, col0=col0, ny=ny,
                   nx=nx, halos=dict(b=b_halo, u=u_halo, e=e_halo), e=e,
                   coeff_row0=coeff_row0, coeff_col0=coeff_col0, sides=True,
                   dtypes=BLOCK_DTYPES, name=BLOCKS)
