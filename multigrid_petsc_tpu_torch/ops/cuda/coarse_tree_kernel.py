"""Single-launch coarse sub-V-cycle (K4).

Counterpart of ``multigrid_petsc_tpu/ops/pallas/coarse_tree_kernel.py``:
every level from the entry level down to the coarsest runs as one
cooperative CUDA launch (``csrc/coarse_tree.cu``) — zero-guess down
visits, full-weighting restriction, the dense direct coarsest solve with
the host-inverted operator, then prolongation + correction + post-smooth
on the way up.  ``coarse_tree_viable`` keeps the JAX package's selection
rule (its VMEM budget and the ``ny_L <= 8`` cap of the dense solve), so
the level split matches the TPU path call for call.
"""

from __future__ import annotations

import numpy as np
import torch

from multigrid_petsc_tpu_torch.ops.cuda import launches
from multigrid_petsc_tpu_torch.ops.cuda._build import check, load_library
from multigrid_petsc_tpu_torch.ops.cuda.mdma_kernel import (
    _check_cuda,
    _on_cpu,
    _stencil_fields,
    _stream,
    smooth_steps,
    steps_tensor,
)
from multigrid_petsc_tpu_torch.ops.stencil import apply_stencil5
from multigrid_petsc_tpu_torch.ops.transfer import prolong_bilinear, restrict_fw

MAX_LEVELS = 12  # csrc/coarse_tree.cu MAXL


def tree_vmem_bytes(shapes, itemsize: int) -> int:
    """The JAX package's budget model: ~8 live temporaries per level
    during its visit + the persistent (b, u) pair per level."""
    per_level = [ny * nx * itemsize for ny, nx in shapes]
    return 8 * max(per_level) + 3 * sum(per_level)


def coarse_tree_viable(shapes, itemsize: int, budget: int = 80 * 2**20,
                       direct: bool = False) -> bool:
    """The JAX package's rule, kept for call-for-call parity of the level
    split (its caps come from TPU VMEM, not from this kernel)."""
    if len(shapes) < 2 or len(shapes) > MAX_LEVELS:
        return False
    if tree_vmem_bytes(shapes, max(itemsize, 4)) > budget:
        return False
    for (ny, nx), (nyc, nxc) in zip(shapes[:-1], shapes[1:]):
        if nyc != (ny - 1) // 2 or nxc != (nx - 1) // 2:
            return False  # gap-1 chain only
    if direct and shapes[-1][0] > 8:
        return False
    return True


def coarse_tree_plain(stencils, steps_list, a_inv, b):
    """The sub-V-cycle in plain PyTorch (``a_inv`` None: the coarsest
    level smooths from zero with its own steps)."""
    L = len(stencils)
    bs, us = [b], []
    for l in range(L - 1):
        u = smooth_steps(stencils[l], bs[l], None, steps_list[l])
        us.append(u)
        bs.append(restrict_fw(bs[l] - apply_stencil5(stencils[l], u)))
    if a_inv is not None:
        u = (a_inv @ bs[-1].reshape(-1)).reshape(bs[-1].shape)
    else:
        u = smooth_steps(stencils[-1], bs[-1], None, steps_list[-1])
    for l in range(L - 2, -1, -1):
        u = smooth_steps(stencils[l], bs[l], us[l] + prolong_bilinear(u),
                         steps_list[l])
    return u


def make_coarse_tree_solver(stencils, shapes, steps_list, a_inv=None):
    """b (entry shape) -> u: the whole sub-V-cycle.

    ``stencils`` are the levels' Stencil5 on one device, ``steps_list``
    the static (alpha, beta) schedule per level, ``a_inv`` the f64 host
    inverse of the coarsest operator (numpy) or None."""
    shapes = [tuple(s) for s in shapes]
    L = len(shapes)
    if not 2 <= L <= MAX_LEVELS:
        raise ValueError(f"coarse tree takes 2..{MAX_LEVELS} levels, got {L}")
    cc0 = stencils[0].cc
    a_inv_t = None
    if a_inv is not None:
        a_inv_t = torch.as_tensor(np.asarray(a_inv), dtype=cc0.dtype,
                                  device=cc0.device)
    ks = np.asarray([len(s) for s in steps_list], np.int32)
    if ks.min() < 1:
        raise ValueError("every level of the coarse tree takes >= 1 step")
    shapes_h = np.asarray(shapes, np.int32).reshape(-1)

    def solve(b: torch.Tensor) -> torch.Tensor:
        if _on_cpu(b):
            return coarse_tree_plain(stencils, steps_list, a_inv_t, b)
        fields = {"b": (b, shapes[0])}
        for l, (st, (ny, _nx)) in enumerate(zip(stencils, shapes)):
            fields.update({f"level{l}.{k}": v
                           for k, v in _stencil_fields(st, ny).items()})
        if a_inv_t is not None:
            n_l = shapes[-1][0] * shapes[-1][1]
            fields["a_inv"] = (a_inv_t, (n_l, n_l))
        _check_cuda(b.device, fields)
        # Every level's schedule, concatenated: one f32 buffer on the card.
        steps_d = steps_tensor(sum(map(tuple, steps_list), ()), b.device)
        lib = load_library()
        # One scratch allocation: per level (b, ua, ub, p), except that the
        # entry level's b is the input and its ub is the output; plus the
        # entry-size residual buffer.
        sizes = [ny * nx for ny, nx in shapes]
        counts = [2] + [4] * (L - 1)
        scratch = torch.empty(sum(c * n for c, n in zip(counts, sizes))
                              + sizes[0], dtype=b.dtype, device=b.device)
        out = torch.empty_like(b)
        ptrs = np.zeros(10 * L, np.uint64)
        base, off = scratch.data_ptr(), 0
        isz = scratch.element_size()

        def take(n):
            nonlocal off
            p = base + off * isz
            off += n
            return p

        for l, (st, n) in enumerate(zip(stencils, sizes)):
            ptrs[10 * l: 10 * l + 5] = [c.data_ptr() for c in st]
            if l == 0:
                ptrs[10 * l + 5] = b.data_ptr()
                ptrs[10 * l + 6] = take(n)
                ptrs[10 * l + 7] = out.data_ptr()
            else:
                ptrs[10 * l + 5] = take(n)
                ptrs[10 * l + 6] = take(n)
                ptrs[10 * l + 7] = take(n)
            ptrs[10 * l + 8] = take(n)
        rr = take(sizes[0])
        err = lib.mg_coarse_tree(
            L, shapes_h.ctypes.data, ks.ctypes.data, steps_d.data_ptr(),
            ptrs.ctypes.data,
            None if a_inv_t is None else a_inv_t.data_ptr(), rr,
            out.data_ptr(), _stream(b.device))
        check(err, "coarse_tree cooperative launch")
        launches["coarse_tree"] += 1
        return out

    return solve
