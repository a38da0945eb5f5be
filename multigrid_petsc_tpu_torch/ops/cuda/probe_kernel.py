"""KP1: the attribution probes' visit ablations.

Counterpart of the kernels of ``benchmarks/probe_visit_vpu.py``
``variant_visit`` (its ``pallas_call`` at :182) and
``benchmarks/probe_mdma_vpu.py`` ``down_variant`` (built into a
``pallas_call`` at :207): the f32 zero-guess ``rc`` visit (k smoother steps
from u = 0, the residual, full-weighting restriction; K2b, K9) with one
part of its body changed or taken out, so that the difference of two
modes' times is that part's cost.  No solve runs them.  The modes
(``visit_ablate(st, b, steps, mode)`` returns (u, rc)):

  base        the production visit: K2b's kernel (``mdma_kernel.visit_down``'s
              launch), counted here
  norm        normalised coefficients (cs / cc, cw / cc, ce / cc, cn / cc,
              1 / cc), bd = D^-1 b once, each step z = bd - u - cs' u_s -
              cn' u_n - cw' u_w - ce' u_e, the residual r = cc z(u)
  nomask      no per-point column mask in the steps (the JAX probe's
              absorbing coefficient rows): a column outside the domain
              steps with alpha = 0, rows by their zero D^-1, so u stays 0
              there; the base visit's function
  norestrict  rc = the y-restricted residual rows r[2I] + 2 r[2I+1] +
              r[2I+2] of the first (nx - 1) / 2 fine columns, no x pass
  nosweep     the first of the k steps only (the halo and tiles stay k's)
  loadstore   no steps: u = b and rc = b[2I+1, 2J+1]

and three names of the JAX probes: ``full`` (``down_variant``'s production
body) is ``base``; ``dmaonly`` is ``loadstore``, whose rc the port defines
(the TPU kernel writes whatever its VMEM scratch held, which no port can
be held to); ``roll`` is ``base``: ``variant_visit``'s roll mode swaps the
concatenated sublane shifts for ``pltpu.roll`` and keeps the raw
coefficients and ``dinv (b - A u)`` (its ``use_norm`` is the norm mode's
alone; on a TPU it equals base bit for bit), and a CUDA step reads its
neighbours from shared memory, where a shift costs nothing to swap.

The five modes other than base are ``visit5_kernel``'s probe modes
(``csrc/visit.cuh`` Probe5), instantiated in ``csrc/probe_visit.cu`` for
f32 whole grids on the production visit's region at its halo k + 2 <= 8
(k <= 6).  ``visit_ablate`` runs ``visit_ablate_plain`` for CPU tensors and
launches the kernel for CUDA tensors (anything else raises), never falling
back, and counts each launch as ``visit_ablate.<mode>``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from multigrid_petsc_tpu_torch.ops.cuda import count_launch
from multigrid_petsc_tpu_torch.ops.cuda import mdma_kernel as mdma
from multigrid_petsc_tpu_torch.ops.cuda._build import check, load_library
from multigrid_petsc_tpu_torch.ops.cuda.mdma_kernel import (
    _check_cuda,
    _odd_shape,
    _on_cpu,
    _stencil_fields,
    _stream,
    steps_tensor,
)
from multigrid_petsc_tpu_torch.ops.cuda.stencil_kernel import (
    fused_level_visit_plain,
)
from multigrid_petsc_tpu_torch.ops.stencil import Stencil5
from multigrid_petsc_tpu_torch.ops.transfer import restrict_fw

# The kernel modes (csrc/visit.cuh Probe5) and the JAX probes' names.
MODES = {"base": 0, "norm": 1, "nomask": 2, "norestrict": 3, "nosweep": 4,
         "loadstore": 5}
ALIASES = {"full": "base", "roll": "base", "dmaonly": "loadstore"}
# visit_probe's largest sweep count: the production region's halo k + 2
# up to V5_SHORT_MAX_H.
MAX_PROBE_STEPS = mdma.V5_SHORT_MAX_H - 2


def mode_of(mode: str) -> str:
    """The kernel mode a name of the port or of a JAX probe runs."""
    m = ALIASES.get(mode, mode)
    if m not in MODES:
        raise ValueError(f"mode must be one of "
                         f"{tuple(MODES) + tuple(ALIASES)}, got {mode!r}")
    return m


def _shift_s(u):  # u[i - 1, j], zero at the first row
    return F.pad(u[:-1], (0, 0, 1, 0))


def _shift_n(u):  # u[i + 1, j]
    return F.pad(u[1:], (0, 0, 0, 1))


def _shift_w(u):  # u[i, j - 1]
    return F.pad(u[:, :-1], (1, 0))


def _shift_e(u):  # u[i, j + 1]
    return F.pad(u[:, 1:], (0, 1))


def _norm_visit(st: Stencil5, b, steps):
    """The norm mode's arithmetic, term for term as the JAX probe's."""
    cc = st.cc
    cs, cw, ce, cn = st.cs / cc, st.cw / cc, st.ce / cc, st.cn / cc
    bd = b * (1.0 / cc)

    def z_of(u):
        return (bd - u - cs * _shift_s(u) - cn * _shift_n(u)
                - cw * _shift_w(u) - ce * _shift_e(u))

    u = torch.zeros_like(b)
    p = None
    for s, (a, bt) in enumerate(steps):
        if s == 0:
            p = a * bd
            u = p
            continue
        p = bt * p + a * z_of(u)
        u = u + p
    return u, restrict_fw(cc * z_of(u))


def visit_ablate_plain(st: Stencil5, b: torch.Tensor, steps, mode: str):
    """(u, rc) of a probe mode, in plain PyTorch."""
    m = mode_of(mode)
    if m == "loadstore":
        nyc, nxc = (b.shape[0] - 1) // 2, (b.shape[1] - 1) // 2
        return b.clone(), b[1:2 * nyc:2, 1:2 * nxc:2].clone()
    if m == "norm":
        return _norm_visit(st, b, steps)
    if m == "nosweep":
        steps = steps[:1]
    if m != "norestrict":  # base, nomask, nosweep
        return fused_level_visit_plain(st, b, None, steps, "rc")
    u, r = fused_level_visit_plain(st, b, None, steps, "ur")
    nxc = (b.shape[1] - 1) // 2
    return u, (r[0:-2:2] + 2.0 * r[1::2] + r[2::2])[:, :nxc]


def visit_ablate(st: Stencil5, b: torch.Tensor, steps, mode: str):
    """(u, rc): one zero-guess rc visit of mode ``mode`` (KP1)."""
    if _on_cpu(b):
        return visit_ablate_plain(st, b, steps, mode)
    m = mode_of(mode)
    if m == "base":
        o = mdma.launch_visit(st, b, steps, emit="rc")
        count_launch("visit_ablate.base", b.dtype)
        return o.u, o.rc
    if not 1 <= len(steps) <= MAX_PROBE_STEPS:
        raise ValueError(f"a probe visit takes 1 to {MAX_PROBE_STEPS} steps "
                         f"(the production region's halo), got "
                         f"{len(steps)}")
    ny, nx = _odd_shape(b)
    _check_cuda(b.device, {"b": (b, (ny, nx)), **_stencil_fields(st, ny)})
    u = torch.empty_like(b)
    rc = torch.empty(((ny - 1) // 2, (nx - 1) // 2), dtype=b.dtype,
                     device=b.device)
    err = load_library().mg_visit_probe(
        *(c.data_ptr() for c in st), b.data_ptr(), u.data_ptr(),
        rc.data_ptr(), ny, nx, steps_tensor(steps, b.device).data_ptr(),
        len(steps), MODES[m], _stream(b.device))
    check(err, f"visit probe launch ({m})")
    count_launch(f"visit_ablate.{m}", b.dtype)
    return u, rc
