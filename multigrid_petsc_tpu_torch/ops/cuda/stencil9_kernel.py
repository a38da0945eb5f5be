"""Stencil, smoother and level-visit kernels of the 9-point family.

Counterpart of ``multigrid_petsc_tpu/ops/pallas/stencil9_kernel.py``:

  apply_stencil9      K12: y = A u
  residual9           K12: r = b - A u
  smooth9_sweeps      K13: k static (alpha, beta) smoother steps on (b, u);
                      ``jacobi9_sweeps`` / ``chebyshev9_sweeps`` pick the
                      schedule
  fused_level_visit9  K14: [u += P e_c] -> k steps -> u | (u, r) | r |
                      (u, R r) [, <b, u>]; ``u=None`` is the zero guess

The coefficients keep their broadcast shape, (1, 1), (1, nx), (ny, 1) or
(ny, nx), as the JAX package ships them.  K12 is the strip kernel of
``csrc/visit.cuh`` (``apply9_kernel``: a thread walks a column strip with
a 3 x 3 window of u; nothing staged) and K13/K14 are flag sets of the
9-point visit kernel (``mdma_kernel.launch_visit`` takes either stencil);
every output is a fresh tensor.

Storage types: f32, f64 and bf16 (bf16 storage, f32 arithmetic, one
rounding per stored output; the plain versions round where the kernels
store, ``mdma_kernel.at_stores``).  Each wrapper runs its plain PyTorch
version (``*_plain``) when the data lies on the CPU, launches its kernel
when it lies on a CUDA device (one of those types, contiguous; anything
else raises), and never falls back from one to the other.
"""

from __future__ import annotations

import torch

from multigrid_petsc_tpu_torch.ops import stencil as _st
from multigrid_petsc_tpu_torch.ops.cuda import count_launch
from multigrid_petsc_tpu_torch.ops.cuda import mdma_kernel as mdma
from multigrid_petsc_tpu_torch.ops.cuda._build import check, load_library
from multigrid_petsc_tpu_torch.ops.cuda.mdma_kernel import (
    VISIT_DTYPES,
    _check_cuda,
    _on_cpu,
    _stream,
    at_stores,
    coeff9_args,
    entry,
    smooth_steps,
)
from multigrid_petsc_tpu_torch.ops.cuda.stencil_kernel import (
    _check_visit,
    fused_level_visit_plain,
)
from multigrid_petsc_tpu_torch.ops.stencil import Stencil9
from multigrid_petsc_tpu_torch.solvers.smoothers import (
    chebyshev_step_coeffs,
    jacobi_step_coeffs,
)


# --------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path and the kernels' oracle).
# --------------------------------------------------------------------------


@at_stores
def apply_stencil9_plain(st: Stencil9, u: torch.Tensor) -> torch.Tensor:
    return _st.apply_stencil9(st, u)


@at_stores
def residual9_plain(st: Stencil9, b, u) -> torch.Tensor:
    return b - _st.apply_stencil9(st, u)


@at_stores
def smooth9_sweeps_plain(st: Stencil9, b, u, steps) -> torch.Tensor:
    return smooth_steps(st, b, u, steps)


def fused_level_visit9_plain(st: Stencil9, b, u, steps, emit: str = "u",
                             e_coarse=None, emit_dot: bool = False):
    """The 5-point visit's composition (``fused_level_visit_plain``) on
    the 9-point operator."""
    return fused_level_visit_plain(st, b, u, steps, emit, e_coarse, emit_dot)


# --------------------------------------------------------------------------
# Kernel wrappers.
# --------------------------------------------------------------------------


def _launch_stencil9(st: Stencil9, b, u, resid: bool) -> torch.Tensor:
    ny, nx = u.shape
    c9 = coeff9_args(st, ny, nx)
    fields = {"u": (u, (ny, nx)), **c9.fields}
    if resid:
        fields["b"] = (b, (ny, nx))
    dtype = _check_cuda(u.device, fields, dtypes=VISIT_DTYPES)
    lib = load_library()
    y = torch.empty_like(u)
    err = entry(lib, "mg_stencil9", dtype)(
        c9.ptrs.ctypes.data, c9.strides.ctypes.data,
        b.data_ptr() if resid else None, u.data_ptr(), y.data_ptr(), ny, nx,
        int(resid), _stream(u.device))
    check(err, "stencil9 launch")
    return y


def apply_stencil9(st: Stencil9, u: torch.Tensor) -> torch.Tensor:
    """y = A u (K12)."""
    if _on_cpu(u):
        return apply_stencil9_plain(st, u)
    y = _launch_stencil9(st, None, u, resid=False)
    count_launch("apply_stencil9", u.dtype)
    return y


def residual9(st: Stencil9, b, u) -> torch.Tensor:
    """r = b - A u (K12)."""
    if _on_cpu(u):
        return residual9_plain(st, b, u)
    r = _launch_stencil9(st, b, u, resid=True)
    count_launch("residual9", u.dtype)
    return r


def smooth9_sweeps(st: Stencil9, b, u, steps) -> torch.Tensor:
    """k = len(steps) smoother steps from u (K13)."""
    if _on_cpu(b):
        return smooth9_sweeps_plain(st, b, u, steps)
    out = mdma.launch_visit(st, b, steps, emit="u", u=u).u
    count_launch("smooth9_sweeps", b.dtype)
    return out


def jacobi9_sweeps(st: Stencil9, b, u, sweeps: int, omega: float = 0.8):
    return smooth9_sweeps(st, b, u, jacobi_step_coeffs(sweeps, omega))


def chebyshev9_sweeps(st: Stencil9, b, u, sweeps: int, lmax: float):
    return smooth9_sweeps(st, b, u, chebyshev_step_coeffs(sweeps, lmax))


def fused_level_visit9(st: Stencil9, b, u, steps, emit: str = "u",
                       e_coarse=None, emit_dot: bool = False):
    """One 9-point level visit (K14), with the JAX function's contract:
    returns u (or (u, <b, u>) with ``emit_dot``), (u, r), r or (u, R r);
    with no steps, emit r is K12's residual."""
    if _on_cpu(b):
        return fused_level_visit9_plain(st, b, u, steps, emit, e_coarse,
                                        emit_dot)
    _check_visit(u, emit, e_coarse, emit_dot)
    if not steps and emit == "r" and u is not None and e_coarse is None:
        return residual9(st, b, u)
    o = mdma.launch_visit(st, b, steps, emit=emit, u=u, e_c=e_coarse,
                          emit_dot=emit_dot)
    count_launch("fused_level_visit9", b.dtype)
    if emit == "u":
        return (o.u, o.dot) if emit_dot else o.u
    return {"ur": (o.u, o.r), "r": o.r, "rc": (o.u, o.rc)}[emit]
