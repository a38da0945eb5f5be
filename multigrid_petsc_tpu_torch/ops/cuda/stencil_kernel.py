"""Stencil, smoother and level-visit kernels of the V-cycle family.

Counterpart of ``multigrid_petsc_tpu/ops/pallas/stencil_kernel.py``:

  apply_stencil5     K6: y = A u
  smooth_sweeps      K7: k static (alpha, beta) smoother steps on (b, u);
                     ``jacobi_sweeps`` / ``chebyshev_sweeps`` pick the
                     schedule
  fused_level_visit  K9: [u += P e_c] -> k steps -> u | (u, r) | r |
                     (u, R r) [, <b, u>]; ``u=None`` is the zero guess
  residual5          K9 with no steps: r = b - A u
  apply_stencil5_field / residual5_field
                     K8: A u / b - A u with five (ny, nx) coefficient
                     fields (the explicit backend's stencil form,
                     ``ops/sparse.py``)
  cg_papply          K11: p' = z + beta p; A p'; <p', A p'> (the fused
                     mg-CG route's direction step)
  cg_visit_down      K10: r' = r - alpha ap; ||r'||^2; u0 = k zero-guess
                     steps on r'; rc = R(r' - A u0) (the fused route's
                     level-0 down visit)

The TPU kernels stream row slabs through VMEM with gathered halo windows
and alias u -> u'.  Here K7 and K9 are flag sets of the one 5-point
strip visit kernel of ``csrc/visit.cuh`` (launched by
``mdma_kernel.launch_visit``), and K6
and ``residual5`` a one-point-halo tile kernel of the same file; every
output is a fresh tensor, since CUDA blocks run concurrently and read
each other's halo.  The zero-guess ``rc`` visit is K2b and the
correcting ``u`` visit K3: ``fused_level_visit`` hands those to the
``mdma_kernel`` wrappers, whose counters they bump.  K11 is K1's kernel
without the lagged u stream and K10 is K2a's flag set of the visit
kernel; each has its own wrapper and counter (``cg_papply``,
``fused_cg_visit_down``).

Storage types: K6, ``residual5``, K7 and K9 run in f32, f64 and bf16
(bf16 storage, f32 arithmetic, one rounding per stored output; the plain
versions round where the kernels store, ``mdma_kernel.at_stores``); K10
and K11 in f32 and bf16 (their scalars and dots f32); K8 in f32 and bf16
(``FIELD_DTYPES``: five bf16 fields, bf16 u and b, f32 sums, the output
rounded once; JAX's bf16 K8 computes in bf16, a bound in the tests).
Each wrapper runs its plain PyTorch version
(``*_plain``) when the data lies on the CPU, launches its kernel when it
lies on a CUDA device (a storage type of its kernel, contiguous; anything
else raises), and never falls back from one to the other.
"""

from __future__ import annotations

import torch

from multigrid_petsc_tpu_torch.ops import stencil as _st
from multigrid_petsc_tpu_torch.ops.cuda import count_launch
from multigrid_petsc_tpu_torch.ops.cuda import mdma_kernel as mdma
from multigrid_petsc_tpu_torch.ops.cuda._build import check, load_library
from multigrid_petsc_tpu_torch.ops.cuda.mdma_kernel import (
    _EMITS,
    VISIT_DTYPES,
    _check_cuda,
    _on_cpu,
    _stencil_fields,
    _stream,
    at_stores,
    entry,
    smooth_steps,
)
from multigrid_petsc_tpu_torch.ops.stencil import Stencil5
from multigrid_petsc_tpu_torch.ops.transfer import prolong_bilinear, restrict_fw
from multigrid_petsc_tpu_torch.solvers.smoothers import (
    chebyshev_step_coeffs,
    jacobi_step_coeffs,
)


# --------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path and the kernels' oracle).
# --------------------------------------------------------------------------


# The storage types of K8 (csrc/visit.cu, visit_bf16.cu MG_FIELD_ENTRIES).
FIELD_DTYPES = (torch.float32, torch.bfloat16)


@at_stores
def apply_stencil5_plain(st: Stencil5, u: torch.Tensor) -> torch.Tensor:
    return _st.apply_stencil5(st, u)


@at_stores
def residual5_plain(st: Stencil5, b, u) -> torch.Tensor:
    return _st.residual(st, b, u)


@at_stores
def smooth_sweeps_plain(st: Stencil5, b, u, steps) -> torch.Tensor:
    return smooth_steps(st, b, u, steps)


@at_stores
def cg_papply_plain(st: Stencil5, z, p, beta):
    pn = z + beta * p
    ap = _st.apply_stencil5(st, pn)
    return pn, ap, torch.sum(pn * ap)


# K10 computes K2a's function on the same (unpadded) arrays.
cg_visit_down_plain = mdma.cg_visit_down_plain


def _check_visit(u, emit, e_coarse, emit_dot) -> None:
    """The argument rules of the JAX ``fused_level_visit_pallas``."""
    if emit not in _EMITS:
        raise ValueError(f"emit must be one of {tuple(_EMITS)}, "
                         f"got {emit!r}")
    if emit_dot and emit != "u":
        raise ValueError("emit_dot goes with emit='u' only")
    if u is None and e_coarse is not None:
        raise ValueError("a zero-guess visit cannot take a correction")


@at_stores
def fused_level_visit_plain(st, b, u, steps, emit: str = "u",
                            e_coarse=None, emit_dot: bool = False):
    """The visit's composition for a Stencil5 or a Stencil9: [u + P e_c],
    the step recurrence, then the emits."""
    _check_visit(u, emit, e_coarse, emit_dot)
    if e_coarse is not None:
        u = u + prolong_bilinear(e_coarse)
    u = smooth_steps(st, b, u, steps)
    if u is None:  # zero guess, no steps
        u = torch.zeros_like(b)
    if emit == "u":
        return (u, torch.sum(b * u)) if emit_dot else u
    r = _st.residual(st, b, u)
    if emit == "ur":
        return u, r
    if emit == "r":
        return r
    return u, restrict_fw(r)


# --------------------------------------------------------------------------
# Kernel wrappers.
# --------------------------------------------------------------------------


def _launch_stencil(st: Stencil5, b, u, resid: bool) -> torch.Tensor:
    ny, nx = u.shape
    fields = {"u": (u, (ny, nx)), **_stencil_fields(st, ny)}
    if resid:
        fields["b"] = (b, (ny, nx))
    dtype = _check_cuda(u.device, fields, dtypes=VISIT_DTYPES)
    lib = load_library()
    y = torch.empty_like(u)
    err = entry(lib, "mg_stencil", dtype)(
        *(c.data_ptr() for c in st), b.data_ptr() if resid else None,
        u.data_ptr(), y.data_ptr(), ny, nx, int(resid), _stream(u.device))
    check(err, "stencil launch")
    return y


def apply_stencil5(st: Stencil5, u: torch.Tensor) -> torch.Tensor:
    """y = A u (K6)."""
    if _on_cpu(u):
        return apply_stencil5_plain(st, u)
    y = _launch_stencil(st, None, u, resid=False)
    count_launch("apply_stencil5", u.dtype)
    return y


def residual5(st: Stencil5, b, u) -> torch.Tensor:
    """r = b - A u (K9's no-step residual)."""
    if _on_cpu(u):
        return residual5_plain(st, b, u)
    r = _launch_stencil(st, b, u, resid=True)
    count_launch("residual5", u.dtype)
    return r


@at_stores
def apply_stencil5_field_plain(st: Stencil5, u: torch.Tensor) -> torch.Tensor:
    return _st.apply_stencil5(st, u)


@at_stores
def residual5_field_plain(st: Stencil5, b, u) -> torch.Tensor:
    return b - _st.apply_stencil5(st, u)


def _launch_field(st: Stencil5, b, u, resid: bool) -> torch.Tensor:
    ny, nx = u.shape
    fields = {"u": (u, (ny, nx)),
              **{f"st.{n}": (c, (ny, nx))
                 for n, c in zip(Stencil5._fields, st)}}
    if resid:
        fields["b"] = (b, (ny, nx))
    dtype = _check_cuda(u.device, fields, dtypes=FIELD_DTYPES)
    lib = load_library()
    y = torch.empty_like(u)
    err = entry(lib, "mg_stencil_field", dtype)(
        *(c.data_ptr() for c in st), b.data_ptr() if resid else None,
        u.data_ptr(), y.data_ptr(), ny, nx, int(resid), _stream(u.device))
    check(err, "field stencil launch")
    return y


def apply_stencil5_field(st: Stencil5, u: torch.Tensor) -> torch.Tensor:
    """y = A u with five (ny, nx) coefficient fields (K8): the stencil form
    of an assembled level matrix."""
    if _on_cpu(u):
        return apply_stencil5_field_plain(st, u)
    y = _launch_field(st, None, u, resid=False)
    count_launch("apply_stencil5_field", u.dtype)
    return y


def residual5_field(st: Stencil5, b, u) -> torch.Tensor:
    """r = b - A u with five (ny, nx) coefficient fields (K8 with b)."""
    if _on_cpu(u):
        return residual5_field_plain(st, b, u)
    r = _launch_field(st, b, u, resid=True)
    count_launch("residual5_field", u.dtype)
    return r


def smooth_sweeps(st: Stencil5, b, u, steps) -> torch.Tensor:
    """k = len(steps) smoother steps from u (K7)."""
    if _on_cpu(b):
        return smooth_sweeps_plain(st, b, u, steps)
    out = mdma.launch_visit(st, b, steps, emit="u", u=u).u
    count_launch("smooth_sweeps", b.dtype)
    return out


def jacobi_sweeps(st: Stencil5, b, u, sweeps: int, omega: float = 0.8):
    return smooth_sweeps(st, b, u, jacobi_step_coeffs(sweeps, omega))


def chebyshev_sweeps(st: Stencil5, b, u, sweeps: int, lmax: float):
    return smooth_sweeps(st, b, u, chebyshev_step_coeffs(sweeps, lmax))


def fused_level_visit(st: Stencil5, b, u, steps, emit: str = "u",
                      e_coarse=None, emit_dot: bool = False):
    """One level visit (K9), with the JAX function's contract: returns u
    (or (u, <b, u>) with ``emit_dot``), (u, r), r or (u, R r)."""
    if _on_cpu(b):
        return fused_level_visit_plain(st, b, u, steps, emit, e_coarse,
                                       emit_dot)
    _check_visit(u, emit, e_coarse, emit_dot)
    if not steps and emit == "r" and u is not None and e_coarse is None:
        return residual5(st, b, u)
    if u is None and emit == "rc":
        return mdma.visit_down(st, b, steps)
    if e_coarse is not None and emit == "u":
        return mdma.visit_up(st, b, u, e_coarse, steps, emit_dot)
    o = mdma.launch_visit(st, b, steps, emit=emit, u=u, e_c=e_coarse,
                          emit_dot=emit_dot)
    count_launch("fused_level_visit", b.dtype)
    if emit == "u":
        return (o.u, o.dot) if emit_dot else o.u
    return {"ur": (o.u, o.r), "r": o.r, "rc": (o.u, o.rc)}[emit]


def cg_papply(st: Stencil5, z, p, beta):
    """(p', A p', <p', A p'>) with p' = z + beta p (K11); ``beta`` a 0-d
    tensor on the data's device.  The first CG iteration passes beta = 0
    with any same-shape ``p``."""
    if _on_cpu(z):
        return cg_papply_plain(st, z, p, beta)
    ny, nx = z.shape
    dtype = _check_cuda(z.device, {"z": (z, (ny, nx)), "p": (p, (ny, nx)),
                                   **_stencil_fields(st, ny)},
                        {"beta": beta}, mdma.CG_DTYPES)
    lib = load_library()
    pn, ap = torch.empty_like(z), torch.empty_like(z)
    part = torch.empty(lib.mg_visit_blocks(ny, nx),
                       dtype=mdma.compute_dtype(dtype), device=z.device)
    err = entry(lib, "mg_cg_papply", dtype)(
        *(c.data_ptr() for c in st), z.data_ptr(), p.data_ptr(),
        beta.data_ptr(), pn.data_ptr(), ap.data_ptr(), part.data_ptr(), ny,
        nx, _stream(z.device))
    check(err, "cg_papply launch")
    count_launch("cg_papply", z.dtype)
    return pn, ap, part.sum()


def cg_visit_down(st: Stencil5, r, ap, alpha, steps):
    """(u0, rc, r', ||r'||^2) with r' = r - alpha ap and (u0, rc) the
    zero-guess down visit on r' (K10); rc is the full restriction, the
    next level's right-hand side."""
    if _on_cpu(r):
        return cg_visit_down_plain(st, r, ap, alpha, steps)
    o = mdma.launch_visit(st, r, steps, emit="rc", ap=ap, alpha=alpha)
    count_launch("fused_cg_visit_down", r.dtype)
    return o.u, o.rc, o.r_new, o.dot
