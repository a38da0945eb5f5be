"""Single-launch coarse sub-V-cycle (K4).

Counterpart of ``multigrid_petsc_tpu/ops/pallas/coarse_tree_kernel.py``:
every level from the entry level down to the coarsest runs as one
cooperative CUDA launch (``csrc/coarse_tree.cu``) — zero-guess down
visits, full-weighting restriction, the dense direct coarsest solve with
the host-inverted operator, then prolongation + correction + post-smooth
on the way up.  The levels of at most ``TREE_TAIL_MAX_N`` rows run as one
V-cycle inside the launch's first block (``tail_from``); the launch plan
is built once per solver (``TreePlan``).  ``coarse_tree_viable`` keeps
the JAX package's selection rule (its VMEM budget and the ``ny_L <= 8``
cap of the dense solve), so the level split matches the TPU path call
for call.

Storage types: f32 and bf16.  On bf16 storage, as the JAX kernel's bf16
branch: b and the result are bf16 (the result rounded once, where it is
stored); every level's arithmetic, buffers and coefficients are f32; the
coarsest inverse is rounded to bf16 before use and applied in f32.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from multigrid_petsc_tpu_torch.ops.cuda import count_launch
from multigrid_petsc_tpu_torch.ops.cuda._build import check, load_library
from multigrid_petsc_tpu_torch.ops.cuda.mdma_kernel import (
    CG_DTYPES,
    _check_cuda,
    _on_cpu,
    _stencil_fields,
    _stream,
    _up,
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
    level smooths from zero with its own steps).  On bf16 storage, as the
    kernel: f32 arithmetic on the upcast b, stencils and (bf16-rounded)
    inverse, the result rounded to bf16 once."""
    if b.dtype == torch.bfloat16:
        return coarse_tree_plain(
            [_up(st) for st in stencils], steps_list,
            None if a_inv is None else a_inv.float(), b.float()).to(b.dtype)
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


TREE_TAIL_MAX_N = 63  # the largest ny of a level that block 0 runs alone


def tail_from(shapes, tail_max_n: int | None = None) -> int:
    """The first level of the tree that block 0 runs alone: the first
    whose ny is at most ``tail_max_n`` (``TREE_TAIL_MAX_N``), or
    ``len(shapes)`` (none) if no level is that small."""
    n = TREE_TAIL_MAX_N if tail_max_n is None else tail_max_n
    return next((l for l, (ny, _nx) in enumerate(shapes) if ny <= n),
                len(shapes))


def grid_syncs(shapes, ks, direct: bool,
               tail_max_n: int | None = None) -> int:
    """Grid-wide barriers of one launch, by ``csrc/coarse_tree.cu``'s
    schedule: a level above the tail takes k down (2 at k = 1) and k + 1
    up; then one after the tail, or the coarsest's own (1 for the direct
    solve, k - 1 for zero-guess smoothing, 1 at k = 1); the last phase
    takes none.  A tree that block 0 runs whole takes none."""
    L = len(shapes)
    t = tail_from(shapes, tail_max_n)
    if t == 0:
        return 0
    top = min(t, L - 1)
    mid = 1 if t < L or direct else max(ks[-1] - 1, 1)
    return sum(max(k, 2) + k + 1 for k in ks[:top]) + mid - 1


def _check_tree(device: torch.device, stencils, shapes,
                a_inv_t) -> torch.dtype:
    """What the kernel takes, checked once per solver: every level's
    coefficient columns and ``a_inv`` of one storage type (f32 or bf16),
    contiguous, of their shapes, on ``device``.  Returns the type."""
    fields = {}
    for l, (st, (ny, _nx)) in enumerate(zip(stencils, shapes)):
        fields.update({f"level{l}.{k}": v
                       for k, v in _stencil_fields(st, ny).items()})
    if a_inv_t is not None:
        n_l = shapes[-1][0] * shapes[-1][1]
        fields["a_inv"] = (a_inv_t, (n_l, n_l))
    return _check_cuda(device, fields, dtypes=CG_DTYPES)


class TreePlan:
    """One solver's launch plan, built once: the checks of the stencils,
    the scratch buffers, the device schedule and the kernel's parameter
    image (``mg_coarse_tree_plan``), which only the entry level's b and
    ``out`` complete per call.  It holds every buffer its pointers name,
    so it is valid as long as the solver that made it.  On bf16 storage it
    holds f32 copies of the coefficient columns and of the (bf16-rounded)
    inverse, and an f32 scratch buffer for the entry level's result
    before its rounding."""

    def __init__(self, stencils, shapes, steps_list, a_inv_t):
        device = stencils[0].cc.device
        self.dtype = _check_tree(device, stencils, shapes, a_inv_t)
        bf16 = self.dtype == torch.bfloat16
        if bf16:  # the kernel's arithmetic type (exact upcasts)
            stencils = [_up(st) for st in stencils]
            a_inv_t = None if a_inv_t is None else a_inv_t.float()
        self._stencils = stencils
        L = len(shapes)
        ks = [len(s) for s in steps_list]
        self.device, self.shape = device, shapes[0]
        self.tail_from = tail_from(shapes)
        self.grid_syncs = grid_syncs(shapes, ks, a_inv_t is not None)
        # Every level's schedule, concatenated: one f32 buffer on the card.
        self._steps = steps_tensor(sum(map(tuple, steps_list), ()), device)
        # One scratch allocation: per level (b, ua, ub, p), except that the
        # entry level's b is the input and (f32) its ub the output.
        sizes = [ny * nx for ny, nx in shapes]
        own = [(7, 8, 9) if bf16 else (7, 9)] + [(6, 7, 8, 9)] * (L - 1)
        self._scratch = torch.empty(
            sum(n * len(j) for j, n in zip(own, sizes)),
            dtype=torch.float32, device=device)
        self._a_inv = a_inv_t
        # D^-1 per level, as the plain version forms it: the kernel's steps
        # multiply by it and divide nowhere.
        self._dinv = [1.0 / st.cc for st in stencils]
        ptrs = np.zeros(10 * L, np.uint64)
        base, isz, off = self._scratch.data_ptr(), 4, 0
        for l, (st, dinv, n) in enumerate(zip(stencils, self._dinv, sizes)):
            ptrs[10 * l: 10 * l + 6] = [c.data_ptr() for c in (*st, dinv)]
            for j in own[l]:
                ptrs[10 * l + j] = base + off * isz
                off += n
        self._lib = lib = load_library()
        self._image = ctypes.create_string_buffer(
            lib.mg_coarse_tree_plan_bytes())
        blocks = ctypes.c_int(0)
        check(lib.mg_coarse_tree_plan(
            L, np.asarray(shapes, np.int32).ctypes.data,
            np.asarray(ks, np.int32).ctypes.data, self._steps.data_ptr(),
            ptrs.ctypes.data,
            None if a_inv_t is None else a_inv_t.data_ptr(), self.tail_from,
            int(bf16), ctypes.addressof(self._image),
            ctypes.addressof(blocks)),
            "coarse_tree plan")
        self.blocks = blocks.value

    def __call__(self, b: torch.Tensor) -> torch.Tensor:
        _check_cuda(self.device, {"b": (b, self.shape)}, dtypes=(self.dtype,))
        out = torch.empty_like(b)
        lib = self._lib
        launch = (lib.mg_coarse_tree_bf16 if self.dtype == torch.bfloat16
                  else lib.mg_coarse_tree)
        check(launch(ctypes.addressof(self._image), b.data_ptr(),
                     out.data_ptr(), _stream(b.device)),
              "coarse_tree cooperative launch")
        count_launch("coarse_tree", b.dtype)
        return out


def make_coarse_tree_solver(stencils, shapes, steps_list, a_inv=None):
    """b (entry shape) -> u: the whole sub-V-cycle.

    ``stencils`` are the levels' Stencil5 on one device, ``steps_list``
    the static (alpha, beta) schedule per level, ``a_inv`` the f64 host
    inverse of the coarsest operator (numpy) or None, stored in the
    stencils' type (bf16: rounded through f32, as JAX's ``astype``;
    ``solve.a_inv``).  On the card the launch plan (``TreePlan``,
    ``solve.plan``) is built here, once; on the CPU there is none: the
    plain version needs no plan."""
    shapes = [tuple(s) for s in shapes]
    L = len(shapes)
    if not 2 <= L <= MAX_LEVELS:
        raise ValueError(f"coarse tree takes 2..{MAX_LEVELS} levels, got {L}")
    cc0 = stencils[0].cc
    a_inv_t = None
    if a_inv is not None:
        a_inv_t = torch.as_tensor(np.asarray(a_inv, np.float32)
                                  if cc0.dtype == torch.bfloat16
                                  else np.asarray(a_inv),
                                  device=cc0.device).to(cc0.dtype)
    if min(len(s) for s in steps_list) < 1:
        raise ValueError("every level of the coarse tree takes >= 1 step")
    plan = None if _on_cpu(cc0) else TreePlan(stencils, shapes, steps_list,
                                              a_inv_t)

    def solve(b: torch.Tensor) -> torch.Tensor:
        if _on_cpu(b):
            return coarse_tree_plain(stencils, steps_list, a_inv_t, b)
        if plan is None:
            raise ValueError(f"b is on {b.device}; the solver was built "
                             f"for the CPU")
        return plan(b)

    solve.plan = plan
    solve.a_inv = a_inv_t
    return solve
