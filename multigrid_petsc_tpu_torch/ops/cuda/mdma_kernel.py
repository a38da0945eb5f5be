"""Fused fine-level visit kernels of the mg-CG preconditioner.

Counterpart of ``multigrid_petsc_tpu/ops/pallas/mdma_kernel.py``.  The
TPU kernels stream lane-padded row windows through manually scheduled
DMA; here the arrays keep their real (ny, nx) shape and each CUDA block
stages a 2-D tile with its halo in shared memory (``csrc/visit.cu``).

  cg_papply_u    K1: p' = z + beta p; A p'; u' = u + alpha_prev p; <p', A p'>
  cg_visit_down  K2a: r' = r - alpha ap; ||r'||^2; u0 = k zero-guess steps
                 on r'; rc = R(r' - A u0)
  visit_down     K2b: u0 = k zero-guess steps on b; rc = R(b - A u0)
  visit_up       K3: z = k steps on b from u + P e_c; optionally <b, z>

R is full weighting [1,2,1]x[1,2,1]/16 and P bilinear prolongation: rc
and e_c have the next coarser level's shape ((ny-1)/2, (nx-1)/2).  The
smoother is the static (alpha_s, beta_s) schedule of
``solvers.smoothers``.  Scalars (alpha, alpha_prev, beta) are 0-d tensors
on the data's device; dots come back as 0-d tensors there.

Each wrapper runs its plain PyTorch version (``*_plain``, below) when the
data lies on the CPU, launches its kernel when it lies on a CUDA device
(f32, contiguous; anything else raises), and never falls back from one to
the other.  Every output is a fresh tensor.
"""

from __future__ import annotations

import numpy as np
import torch

from multigrid_petsc_tpu_torch.ops.cuda import launches
from multigrid_petsc_tpu_torch.ops.cuda._build import check, load_library
from multigrid_petsc_tpu_torch.ops.stencil import Stencil5, apply_stencil5
from multigrid_petsc_tpu_torch.ops.transfer import prolong_bilinear, restrict_fw

MAX_STEPS = 6  # csrc/visit.cu: halo k + 2 <= 8 rows in shared memory


# --------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path and the kernels' oracle).
# --------------------------------------------------------------------------


def smooth_steps(st: Stencil5, b: torch.Tensor, u: torch.Tensor | None,
                 steps) -> torch.Tensor:
    """The kernels' step body: z = D^-1 (b - A u); p = beta p + alpha z;
    u += p.  ``u=None`` is the zero guess, whose first step is
    z = D^-1 b."""
    dinv = 1.0 / st.cc
    p = None
    for s, (a, bt) in enumerate(steps):
        if s == 0 and u is None:
            p = a * (dinv * b)
            u = p
            continue
        z = dinv * (b - apply_stencil5(st, u))
        p = a * z if s == 0 else bt * p + a * z
        u = u + p
    return u


def cg_papply_u_plain(st, z, p, u, alpha_prev, beta):
    pn = z + beta * p
    ap = apply_stencil5(st, pn)
    return pn, ap, u + alpha_prev * p, torch.sum(pn * ap)


def cg_visit_down_plain(st, r, ap, alpha, steps):
    b = r - alpha * ap
    u0 = smooth_steps(st, b, None, steps)
    rc = restrict_fw(b - apply_stencil5(st, u0))
    return u0, rc, b, torch.sum(b * b)


def visit_down_plain(st, b, steps):
    u0 = smooth_steps(st, b, None, steps)
    return u0, restrict_fw(b - apply_stencil5(st, u0))


def visit_up_plain(st, b, u, e_c, steps, emit_dot=True):
    z = smooth_steps(st, b, u + prolong_bilinear(e_c), steps)
    return (z, torch.sum(b * z)) if emit_dot else z


# --------------------------------------------------------------------------
# Kernel wrappers.
# --------------------------------------------------------------------------


def _on_cpu(x: torch.Tensor) -> bool:
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    return False


def _check_cuda(device: torch.device, fields: dict,
                scalars: dict | None = None) -> None:
    """Device, dtype, shape and contiguity the kernels take (f32 only)."""
    for name, (t, shp) in fields.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the CUDA kernels take float32, "
                            f"got {t.dtype}")
        if tuple(t.shape) != tuple(shp):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, "
                             f"expected {tuple(shp)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (scalars or {}).items():
        if not (isinstance(t, torch.Tensor) and t.device == device
                and t.dtype == torch.float32 and t.numel() == 1):
            raise TypeError(f"{name} must be a 1-element float32 tensor "
                            f"on {device}")


def _stencil_fields(st: Stencil5, ny: int) -> dict:
    return {f"st.{n}": (c, (ny, 1)) for n, c in zip(Stencil5._fields, st)}


def _steps_array(steps) -> np.ndarray:
    k = len(steps)
    if not 1 <= k <= MAX_STEPS:
        raise ValueError(f"the visit kernels take 1..{MAX_STEPS} steps, "
                         f"got {k}")
    return np.ascontiguousarray(np.asarray(steps, np.float64).reshape(-1))


def _odd_shape(x: torch.Tensor) -> tuple[int, int]:
    ny, nx = x.shape
    if ny % 2 == 0 or nx % 2 == 0 or ny < 3 or nx < 3:
        raise ValueError(f"visit kernels need odd sizes >= 3, got {(ny, nx)}")
    return ny, nx


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def cg_papply_u(st: Stencil5, z, p, u, alpha_prev, beta):
    """(p', A p', u + alpha_prev p, <p', A p'>) with p' = z + beta p."""
    if _on_cpu(z):
        return cg_papply_u_plain(st, z, p, u, alpha_prev, beta)
    ny, nx = z.shape
    _check_cuda(z.device,
                {"z": (z, (ny, nx)), "p": (p, (ny, nx)), "u": (u, (ny, nx)),
                 **_stencil_fields(st, ny)},
                {"alpha_prev": alpha_prev, "beta": beta})
    lib = load_library()
    pn, ap, un = (torch.empty_like(z) for _ in range(3))
    part = torch.empty(lib.mg_visit_blocks(ny, nx), dtype=z.dtype,
                       device=z.device)
    err = lib.mg_cg_papply_u(*(c.data_ptr() for c in st), z.data_ptr(),
                             p.data_ptr(), u.data_ptr(),
                             alpha_prev.data_ptr(), beta.data_ptr(),
                             pn.data_ptr(), ap.data_ptr(), un.data_ptr(),
                             part.data_ptr(), ny, nx, _stream(z.device))
    check(err, "cg_papply_u launch")
    launches["cg_papply_u"] += 1
    return pn, ap, un, part.sum()


def _visit_down_launch(st, r, ap, alpha, steps, cg: bool):
    ny, nx = _odd_shape(r)
    fields = {"r": (r, (ny, nx)), **_stencil_fields(st, ny)}
    scalars = {}
    if cg:
        fields["ap"] = (ap, (ny, nx))
        scalars["alpha"] = alpha
    _check_cuda(r.device, fields, scalars)
    steps_h = _steps_array(steps)
    lib = load_library()
    nyc, nxc = (ny - 1) // 2, (nx - 1) // 2
    u0 = torch.empty_like(r)
    rc = torch.empty((nyc, nxc), dtype=r.dtype, device=r.device)
    r_new = torch.empty_like(r) if cg else None
    part = (torch.empty(lib.mg_visit_blocks(ny, nx), dtype=r.dtype,
                        device=r.device) if cg else None)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = lib.mg_visit_down(*(c.data_ptr() for c in st), r.data_ptr(),
                            ptr(ap), ptr(alpha), u0.data_ptr(),
                            rc.data_ptr(), ptr(r_new), ptr(part), ny, nx,
                            steps_h.ctypes.data, len(steps), int(cg),
                            _stream(r.device))
    check(err, "visit_down launch")
    return u0, rc, r_new, part


def cg_visit_down(st: Stencil5, r, ap, alpha, steps):
    """(u0, rc, r', ||r'||^2) with r' = r - alpha ap (K2a)."""
    if _on_cpu(r):
        return cg_visit_down_plain(st, r, ap, alpha, steps)
    u0, rc, r_new, part = _visit_down_launch(st, r, ap, alpha, steps, True)
    launches["cg_visit_down"] += 1
    return u0, rc, r_new, part.sum()


def visit_down(st: Stencil5, b, steps):
    """(u0, rc): the zero-guess down visit (K2b)."""
    if _on_cpu(b):
        return visit_down_plain(st, b, steps)
    u0, rc, _, _ = _visit_down_launch(st, b, None, None, steps, False)
    launches["visit_down"] += 1
    return u0, rc


def visit_up(st: Stencil5, b, u, e_c, steps, emit_dot: bool = True):
    """z = smooth_k(b, u + P e_c) [, <b, z>] (K3)."""
    if _on_cpu(b):
        return visit_up_plain(st, b, u, e_c, steps, emit_dot)
    ny, nx = _odd_shape(b)
    nyc, nxc = (ny - 1) // 2, (nx - 1) // 2
    _check_cuda(b.device,
                {"b": (b, (ny, nx)), "u": (u, (ny, nx)),
                 "e_c": (e_c, (nyc, nxc)), **_stencil_fields(st, ny)})
    steps_h = _steps_array(steps)
    lib = load_library()
    z = torch.empty_like(b)
    part = (torch.empty(lib.mg_visit_blocks(ny, nx), dtype=b.dtype,
                        device=b.device) if emit_dot else None)
    err = lib.mg_visit_up(*(c.data_ptr() for c in st), b.data_ptr(),
                          u.data_ptr(), e_c.data_ptr(), z.data_ptr(),
                          None if part is None else part.data_ptr(), ny, nx,
                          steps_h.ctypes.data, len(steps), int(emit_dot),
                          _stream(b.device))
    check(err, "visit_up launch")
    launches["visit_up"] += 1
    return (z, part.sum()) if emit_dot else z
