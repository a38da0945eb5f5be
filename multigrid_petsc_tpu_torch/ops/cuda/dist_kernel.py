"""K17: one fused level visit on one rank's row block of a row-partitioned
level.

Counterpart of ``multigrid_petsc_tpu/ops/pallas/dist_kernel.py``
(``dist_level_visit_local``, its ``pallas_call`` at :524 through
``build_call`` :465, bodies ``_make_dist_kernel`` :275 and
``_make_dist9_kernel`` :184):

  row_visit  [u += P e] -> k steps -> u | A u | b - A u | (u, r) | (u, R r)
             on the (R, nx) block of global rows [row0, row0 + R)

A row-partitioned level carries one pad row (ny + 1 rows, R = (ny + 1) /
P per rank; the pad row is the last rank's last row), so every block is
even and the coarse level's block is the (R / 2, nxc) rows under it.  The
rows past the block arrive as halo buffers of h = ``halo_rows(k, emit)``
rows each (``parallel.halo.edge_exchange``: zeros at the global edges),
those of a coarse correction as ``coarse_halo_rows(h)`` rows; the halo may
not exceed the block (rows come from the immediate neighbours only).

The TPU kernel ships per-slab coefficient windows with the pad and phantom
rows encoded as absorbing identity rows, and splits each visit into an
interior and an edge call so that the exchange overlaps the interior.  On
the card the visit is a mode of the whole-grid visit kernel
(``csrc/visit.cuh`` RowBlock, entries ``mg_visit_rows`` /
``mg_visit9_rows``; emits a and r ``mg_stencil_rows``, the one-point-halo
tile kernel, and ``mg_stencil9_rows``, K12's strip kernel): b, u and e
are read in place, the rows past the block from the halo buffers, and
the Dirichlet mask, the coefficients and the prolongation go by the
global row, so the global pad row of every output and the global coarse
pad row of rc are written as 0.  Coefficients
are indexed by global row: the 5-point (ny, 1) columns are whole on every
rank; the 9-point coefficients that vary with y hold the rows from
``coeff_row0`` on (``parallel.dist_ops.DistLevelOps`` keeps the block's
rows and ``max_sweeps + 2`` more on each side).  The exchange runs before
the kernel (overlap is later work).  What bounds it: bytes, as the
whole-grid visit; the halo adds 2h rows of reads per block.

Storage types: f32 and f64 (``visit.cu``, ``visit_f64.cu``).  The wrapper
runs the plain PyTorch version (``row_visit_plain``) when the data lies on
the CPU, launches the kernel when it lies on a CUDA device (anything else
raises), and never falls back from one to the other; it counts each launch
as ``dist_level_visit`` (``.f64``), and beside that total, in ``emits``,
the launches of each emit (``"a"``, ``"r"``, ``"rc"``... with the same
suffix).

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
    coeff9_args,
    entry,
    max_visit_steps,
    steps_tensor,
    visit_fits,
)
from multigrid_petsc_tpu_torch.ops.stencil import Stencil5, Stencil9
from multigrid_petsc_tpu_torch.ops.transfer import prolong_bilinear, restrict_fw

ROW_DTYPES = (torch.float32, torch.float64)

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


def row_visit_plain(st, b, u, steps, emit: str, *, row0: int, ny: int,
                    b_halo: Halo | None = None, u_halo: Halo | None = None,
                    e=None, e_halo: Halo | None = None,
                    coeff_row0: int = 0):
    """The row-block visit's composition on the extended rows [row0 - h,
    row0 + R + h): the global-row mask, [u + P e], the step recurrence
    (p = 0 at masked rows), the emits, cropped to the block; the pad row
    and the coarse pad row come out 0.  ``u=None`` is the zero guess."""
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
    if ue is None:
        ue = torch.zeros_like(be)
    u_out = ue[h:h + R]
    if emit == "u":
        return u_out
    r = torch.where(inside, be - _st.apply_stencil(ste, ue), 0.0)
    if emit == "ur":
        return u_out, r[h:h + R]
    rc = restrict_fw(r[h:h + R + 1])
    crow = torch.arange(row0 // 2, row0 // 2 + R // 2, device=blk.device)
    return u_out, torch.where((crow < (ny - 1) // 2)[:, None], rc, 0.0)


# --------------------------------------------------------------------------
# Kernel wrapper.
# --------------------------------------------------------------------------


def _ptr(t):
    return None if t is None else t.data_ptr()


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
    if emit not in _EXTRA_H:
        raise ValueError(f"emit must be one of {tuple(_EXTRA_H)}, got "
                         f"{emit!r}")
    R, nx = blk.shape
    k = len(steps)
    h = halo_rows(k, emit)
    stencil = emit in ("a", "r")
    if stencil and k:
        raise ValueError("emits a and r take no smoother steps")
    if not stencil and k < 1:
        raise ValueError("the visit kernel takes at least one step")
    if R % 2 or h > R or row0 % 2 or (ny + 1) % R:
        raise ValueError(f"a row block of {R} rows from row {row0} cannot "
                         f"carry halo {h} (even blocks, h <= R)")
    nine = isinstance(st, Stencil9)
    Rc, nxc = R // 2, (nx - 1) // 2
    hc = coarse_halo_rows(h) if e is not None else 0
    if nine:
        m = max(c.shape[0] for c in st)
        c9 = coeff9_args(st, m, nx)
        fields = dict(c9.fields)
        if m > 1 and (coeff_row0 > max(0, row0 - h)
                      or coeff_row0 + m < min(ny, row0 + R + h)):
            raise ValueError("the coefficients do not hold the rows this "
                             "visit reads")
        kinds = c9.kinds
    else:
        fields = _stencil_fields(st, ny)
        kinds = None
    need_u = stencil or u is not None
    halo_ptrs = []
    for name, x, halo, shape, hh, want, with_halo in (
            ("b", b, b_halo, (R, nx), h, emit != "a", not stencil),
            ("u", u, u_halo, (R, nx), h, need_u, True),
            ("e", e, e_halo, (Rc, nxc), hc, e is not None, True)):
        ptrs = (0, 0)
        if want:
            if x is None or (with_halo and halo is None):
                raise ValueError(f"{name} and its halo are required here")
            fields[name] = (x, shape)
            if with_halo:
                fields[name + "_top"] = (halo.top, (hh, shape[1]))
                fields[name + "_bot"] = (halo.bot, (hh, shape[1]))
                ptrs = (halo.top.data_ptr(), halo.bot.data_ptr())
        halo_ptrs += ptrs
    dtype = _check_cuda(blk.device, fields, dtypes=ROW_DTYPES)
    size = torch.finfo(dtype).bits // 8
    if not stencil and not visit_fits(kinds, h, size):
        raise ValueError(
            f"a {9 if nine else 5}-point {dtype} visit with emit {emit!r} "
            f"takes at most {max_visit_steps(kinds, emit, size)} steps; got "
            f"{k}")
    lib = load_library()
    geom = np.asarray([R, row0, ny, h, Rc, hc], np.int32)
    halos = np.asarray(halo_ptrs, np.uint64)
    stream = _stream(blk.device)
    coeffs = ((c9.ptrs.ctypes.data, c9.strides.ctypes.data, coeff_row0)
              if nine else tuple(c.data_ptr() for c in st))
    new = functools.partial(torch.empty, dtype=dtype, device=blk.device)
    if stencil:
        out = new((R, nx))
        err = entry(lib, "mg_stencil9_rows" if nine else "mg_stencil_rows",
                    dtype)(
            *coeffs, _ptr(b if emit == "r" else None), u.data_ptr(),
            out.data_ptr(), geom.ctypes.data, halos.ctypes.data, nx,
            int(emit == "r"), stream)
    else:
        u_out = new((R, nx))
        r_out = new((R, nx)) if emit == "ur" else None
        rc_out = new((Rc, nxc)) if emit == "rc" else None
        flags = ((_F_GUESS if u is not None else 0)
                 | (_F_CORRECT if e is not None else 0)
                 | _EMITS[emit] << _EMIT_SHIFT)
        steps_d = steps_tensor(steps, blk.device, dtype)
        err = entry(lib, "mg_visit9_rows" if nine else "mg_visit_rows",
                    dtype)(
            *coeffs, b.data_ptr(), _ptr(u), _ptr(e), u_out.data_ptr(),
            _ptr(r_out), _ptr(rc_out), None, geom.ctypes.data,
            halos.ctypes.data, nx, steps_d.data_ptr(), k, flags, stream)
        out = {"u": u_out, "ur": (u_out, r_out), "rc": (u_out, rc_out)}[emit]
    check(err, f"row-block visit launch (emit {emit})")
    count_launch("dist_level_visit", dtype)
    emits[emit + _SUFFIX[dtype]] += 1
    return out
