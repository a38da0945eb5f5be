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
line coefficients only.  The CUDA kernels (``csrc/line.cu``) have no size
cap and take line coefficients that vary with x as well: one launch per
sweep, one thread per column running Thomas's recurrence with per-row
factors computed once per level on the host in f64 (``thomas_factor``),
then one launch for the residual or its restriction.  The plain version
is the JAX package's composition: ``line_jacobi_sweeps_y`` (PCR) with the
library transfers, so on the card the kernel and its oracle differ by the
rounding of the two tridiagonal solves.

Storage types: f32 and f64 (``mg_line_*`` and ``mg_line_*_f64``); bf16
line visits raise (no path runs them).  The wrapper runs the plain
version when the data lies on the CPU, launches the kernels when it lies
on a CUDA device (f32 or f64, contiguous; anything else raises), and
never falls back from one to the other.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from multigrid_petsc_tpu_torch.ops.cuda import count_launch
from multigrid_petsc_tpu_torch.ops.cuda._build import check, load_library
from multigrid_petsc_tpu_torch.ops.cuda.mdma_kernel import (
    _check_cuda,
    _odd_shape,
    _on_cpu,
    _stream,
    coeff9_args,
)
from multigrid_petsc_tpu_torch.ops.stencil import (
    PCRFactor,
    Stencil9,
    apply_stencil9,
    line_jacobi_sweeps_y,
    pcr_factor,
)
from multigrid_petsc_tpu_torch.ops.transfer import prolong_bilinear, restrict_fw

_EMITS = ("u", "ur", "rc")
LINE_DTYPES = (torch.float32, torch.float64)


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


class LineFactor(NamedTuple):
    """Thomas factors of the line systems (cs, cc, cn) down each column:
    m_i = 1 / (cc_i - cs_i cp_{i-1}) and cp_i = cn_i m_i (cp_{ny-1} = 0);
    (ny, 1) columns, or (ny, nx) fields when a line coefficient varies
    with x."""

    m: torch.Tensor
    cp: torch.Tensor


def thomas_factor(st: Stencil9, ny: int) -> LineFactor:
    """The Thomas factors of ``st``'s y-lines, computed on the host in f64
    and stored in the stencil's dtype on its device."""
    def host(c):
        return np.asarray(c.detach().cpu().numpy(), np.float64)

    a, d, c = host(st.cs), host(st.cc), host(st.cn)
    w = max(x.shape[1] if x.ndim == 2 else 1 for x in (a, d, c))
    a, d, c = (np.broadcast_to(x, (ny, w)) for x in (a, d, c))
    m = np.empty((ny, w))
    cp = np.empty((ny, w))
    prev = np.zeros(w)
    for i in range(ny):
        m[i] = 1.0 / (d[i] - (a[i] * prev if i > 0 else 0.0))
        prev = cp[i] = (c[i] if i < ny - 1 else 0.0) * m[i]
    return LineFactor(*(torch.as_tensor(x, dtype=st.cc.dtype,
                                        device=st.cc.device)
                        for x in (m, cp)))


def line_factor(st: Stencil9, ny: int):
    """What ``line_visit9`` needs of the ny-point line systems, once per
    level: the PCR factor for CPU tensors (the plain version), the Thomas
    factors for CUDA tensors."""
    if _on_cpu(st.cc):
        return pcr_factor(st.cs, st.cc, st.cn, ny)
    return thomas_factor(st, ny)


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
    (PCR) from u [+ P e_c], then the emits."""
    _check_line(u, emit, e_coarse, emit_dot, sweeps)
    u = torch.zeros_like(b) if u is None else u
    if e_coarse is not None:
        u = u + prolong_bilinear(e_coarse)
    u = line_jacobi_sweeps_y(st, b, u, sweeps, omega, fac=fac)
    if emit == "u":
        return (u, torch.sum(b * u)) if emit_dot else u
    r = b - apply_stencil9(st, u)
    return (u, r) if emit == "ur" else (u, restrict_fw(r))


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
    fac = thomas_factor(st, ny) if fac is None else fac
    c9 = coeff9_args(st, ny, nx)
    w = fac.m.shape[1]
    if w not in (1, nx):
        raise ValueError(f"line factors of width {w} for {nx} columns")
    fields = {"b": (b, (ny, nx)), "fac.m": (fac.m, (ny, w)),
              "fac.cp": (fac.cp, (ny, w)), **c9.fields}
    if u is not None:
        fields["u"] = (u, (ny, nx))
    if e_coarse is not None:
        fields["e_c"] = (e_coarse, (nyc, nxc))
    dtype = _check_cuda(b.device, fields, dtypes=LINE_DTYPES)
    lib = load_library()
    sfx = "_f64" if dtype == torch.float64 else ""
    sweep = getattr(lib, "mg_line_sweep" + sfx)
    residual = getattr(lib, "mg_line_residual" + sfx)
    stream = _stream(b.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    # Ping-pong: a sweep reads the previous iterate at neighbouring
    # columns while writing its own, so it never writes its input.
    bufs = [torch.empty_like(b) for _ in range(min(sweeps, 2))]
    part = (torch.empty(lib.mg_line_blocks(nx), dtype=b.dtype,
                        device=b.device) if emit_dot else None)
    cur = u
    for s in range(sweeps):
        out = bufs[s % 2]
        err = sweep(
            c9.ptrs.ctypes.data, c9.strides.ctypes.data, fac.m.data_ptr(),
            fac.cp.data_ptr(), int(w > 1), b.data_ptr(), ptr(cur),
            ptr(e_coarse if s == 0 else None), out.data_ptr(),
            ptr(part if s == sweeps - 1 else None), ny, nx, omega,
            1.0 - omega, stream)
        check(err, "line sweep launch")
        cur = out
    if emit == "u":
        count_launch("line_visit9", dtype)
        return (cur, part.sum()) if emit_dot else cur
    out = torch.empty((nyc, nxc) if emit == "rc" else (ny, nx),
                      dtype=b.dtype, device=b.device)
    err = residual(c9.ptrs.ctypes.data, c9.strides.ctypes.data, b.data_ptr(),
                   cur.data_ptr(), out.data_ptr(), ny, nx, int(emit == "rc"),
                   stream)
    check(err, "line residual launch")
    count_launch("line_visit9", dtype)
    return cur, out
