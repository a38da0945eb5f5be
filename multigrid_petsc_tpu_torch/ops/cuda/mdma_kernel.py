"""Fused fine-level visit kernels of the mg-CG preconditioner.

Counterpart of ``multigrid_petsc_tpu/ops/pallas/mdma_kernel.py``.  The
TPU kernels stream lane-padded row windows through manually scheduled
DMA; here the arrays keep their real (ny, nx) shape and each CUDA block
of a visit owns a 2-D region (its output tile plus the halo) in shared
memory, a thread per strip of it (``csrc/visit.cuh``).

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

K2a, K2b and K3 are flag sets of the one visit kernel of
``csrc/visit.cu``; ``launch_visit`` launches any flag set of it, for a
Stencil5 or a Stencil9, and is shared with the V-cycle family's and the
9-point family's wrappers (``ops/cuda/stencil_kernel.py``,
``ops/cuda/stencil9_kernel.py``).  The smoother's (alpha, beta) schedule
goes to the kernel as a small f32 buffer in device memory
(``steps_tensor``), so no parameter block bounds a visit's sweep count:
the 5-point visit keeps a fixed largest halo (``V5_MAX_HALO``), the
9-point visit its fixed region (``max_visit_steps``).

Storage types: K1 and K2a run in f32 and bf16 (``CG_DTYPES``: the mdma
route's working dtypes); the visit kernel family behind ``launch_visit``
(K2b, K3 and the V-cycle and 9-point families' visits) is built for f32,
f64 and bf16 (``VISIT_DTYPES``).  bf16 is storage only: the kernels
compute in f32 and round each output once, where they store it, and the
plain versions do the same (``at_stores``); their scalars (alpha,
alpha_prev, beta) and dots are f32.

Each wrapper runs its plain PyTorch version (``*_plain``, below) when the
data lies on the CPU, launches its kernel when it lies on a CUDA device
(a storage type of its kernel, contiguous; anything else raises), and
never falls back from one to the other.  Every output is a fresh tensor.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from multigrid_petsc_tpu_torch.ops.cuda import count_launch
from multigrid_petsc_tpu_torch.ops.cuda._build import check, load_library
from multigrid_petsc_tpu_torch.ops.stencil import (
    Stencil5,
    Stencil9,
    apply_stencil,
    apply_stencil5,
)
from multigrid_petsc_tpu_torch.ops.transfer import prolong_bilinear, restrict_fw

# csrc/visit.cuh: a block's shared memory; the 9-point visit's fixed
# region (tile + halo, V9_SH x V9_SW) and threads.
MAX_SMEM = 232448
REGION9_Y, REGION9_X, THREADS9 = 64, 64, 256
# csrc/visit.cuh Region5: the 5-point visit's regions (rows, columns) and
# the rule on the halo h that picks one (V5_SHORT_MAX_H: the tall region
# past it, for the f32 compute type only).
REGION5_SHORT, REGION5_TALL, V5_SHORT_MAX_H = (64, 128), (128, 128), 8
STRIPS5 = 4  # strips down a 5-point region's column (Region5 GY)
# csrc/visit.cuh Region5P: the bf16 step's region (rows, columns), the
# columns a thread owns (V5P_NC; a warp takes 32 * V5P_NC), the strips down
# a column group (V5P_GY), and the rule on h that sends a bf16-storage
# visit (a block's or a whole grid's) to it (V5_PAIR_MAX_H).
REGION5_PAIR, COLS5_PAIR, STRIPS5_PAIR = (64, 128), 4, 16
V5_PAIR_MAX_H = 8
# The 5-point visit's largest halo by the compute type's item size: the
# wrappers' sweep bound, a contract the tests pin (with emit rc 43 steps in
# f32 and bf16, 23 in f64; emit u 45 and 25).  It is the bound of the first
# 5-point visit, whose tile + halo of b, u and p sat in shared memory; the
# strip kernel's regions hold every halo up to it.
V5_MAX_HALO = {4: 45, 8: 25}
# K12's strip kernel (apply9_kernel): rows a thread walks, and a block's
# tile (rows, columns).
A9_ROWS, A9_TILE = 16, (64, 64)

F32 = (torch.float32,)
# The storage types the visit-family kernels are built for, and the C
# entries' suffix for each (csrc/visit.cu, visit_f64.cu, visit_bf16.cu).
VISIT_DTYPES = (torch.float32, torch.float64, torch.bfloat16)
# The storage types of the mg-CG kernels K1, K2a/K10 and K11.
CG_DTYPES = (torch.float32, torch.bfloat16)
_ENTRY_SUFFIX = {torch.float32: "", torch.float64: "_f64",
                 torch.bfloat16: "_bf16"}


def compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """The kernels' arithmetic type for a storage type: f32 for bf16
    (the JAX kernels' ``_compute_dtype``), else the type itself."""
    return torch.float32 if dtype == torch.bfloat16 else dtype


# --------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path and the kernels' oracle).
# --------------------------------------------------------------------------


def _has_bf16(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.dtype == torch.bfloat16
    return isinstance(x, tuple) and hasattr(x, "_fields") and any(
        map(_has_bf16, x))


def _up(x):
    if isinstance(x, torch.Tensor):
        return x.float() if x.dtype == torch.bfloat16 else x
    if isinstance(x, tuple) and hasattr(x, "_fields"):  # a stencil
        return type(x)(*map(_up, x))
    return x


def _round(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.bfloat16) if x.dim() else x
    if isinstance(x, tuple):
        return tuple(map(_round, x))
    return x


def at_stores(plain):
    """A plain version as the kernel runs it on bf16 storage: every input
    upcast to f32 (exact), the arithmetic in f32, and each array output
    rounded to bf16 once, where the kernel stores it; dots stay f32.
    Rounding after every operation instead would drift from the kernels
    far beyond f32 noise.  Other storage types pass through."""

    @functools.wraps(plain)
    def run(*args, **kw):
        if not any(map(_has_bf16, (*args, *kw.values()))):
            return plain(*args, **kw)
        return _round(plain(*map(_up, args),
                            **{k: _up(v) for k, v in kw.items()}))

    return run


def smooth_steps(st, b: torch.Tensor, u: torch.Tensor | None,
                 steps) -> torch.Tensor:
    """The kernels' step body: z = D^-1 (b - A u); p = beta p + alpha z;
    u += p, for a Stencil5 or a Stencil9.  ``u=None`` is the zero guess,
    whose first step is z = D^-1 b."""
    dinv = 1.0 / st.cc
    p = None
    for s, (a, bt) in enumerate(steps):
        if s == 0 and u is None:
            p = a * (dinv * b)
            u = p
            continue
        z = dinv * (b - apply_stencil(st, u))
        p = a * z if s == 0 else bt * p + a * z
        u = u + p
    return u


@at_stores
def cg_papply_u_plain(st, z, p, u, alpha_prev, beta):
    pn = z + beta * p
    ap = apply_stencil5(st, pn)
    return pn, ap, u + alpha_prev * p, torch.sum(pn * ap)


@at_stores
def cg_visit_down_plain(st, r, ap, alpha, steps):
    b = r - alpha * ap
    u0 = smooth_steps(st, b, None, steps)
    rc = restrict_fw(b - apply_stencil5(st, u0))
    return u0, rc, b, torch.sum(b * b)


@at_stores
def visit_down_plain(st, b, steps):
    u0 = smooth_steps(st, b, None, steps)
    return u0, restrict_fw(b - apply_stencil5(st, u0))


@at_stores
def visit_up_plain(st, b, u, e_c, steps, emit_dot=True):
    z = smooth_steps(st, b, u + prolong_bilinear(e_c), steps)
    return (z, torch.sum(b * z)) if emit_dot else z


# --------------------------------------------------------------------------
# Kernel wrappers.
# --------------------------------------------------------------------------


# The helpers below run on every launch: a CUDA tensor is told apart, and
# its device compared, by ``is_cuda`` and the device index alone (reading
# ``Tensor.device`` builds a torch.device object, and ``torch.device.type``
# a string); only a failing check, or a device that is not a CUDA one,
# compares torch.device objects.


def _on_cpu(x: torch.Tensor) -> bool:
    if x.is_cuda:
        return False
    if x.device.type == "cpu":
        return True
    raise ValueError(f"no kernel for device {x.device}")


_CUDA_INDEX: dict = {}  # torch.device -> its CUDA index, else None


def _cuda_index(device: torch.device):
    try:
        return _CUDA_INDEX[device]
    except KeyError:
        index = device.index if device.type == "cuda" else None
        _CUDA_INDEX[device] = index
        return index


def _check_cuda(device: torch.device, fields: dict,
                scalars: dict | None = None, dtypes=F32) -> torch.dtype:
    """Device, dtype, shape and contiguity a kernel takes: every field of
    one storage type from ``dtypes`` (the kernel's instantiations; f32
    only by default), every scalar a 1-element tensor of its compute
    type.  Returns the storage type.  A field that passes the quick test
    (on a CUDA device by index, of the type, the shape, contiguous) is
    not looked at again; one that fails it goes through the checks one by
    one, which raise."""
    dtype = next(iter(fields.values()))[0].dtype if fields else dtypes[0]
    if dtype not in dtypes:
        raise TypeError(f"this CUDA kernel is built for "
                        f"{', '.join(map(str, dtypes))}, got {dtype}")
    index = _cuda_index(device)
    for name, (t, shp) in fields.items():
        if (index is not None and t.is_cuda and t.get_device() == index
                and t.dtype == dtype and t.shape == shp
                and t.is_contiguous()):
            continue
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {t.dtype}, the other operands "
                            f"{dtype}")
        if tuple(t.shape) != tuple(shp):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, "
                             f"expected {tuple(shp)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if scalars:
        cdt = compute_dtype(dtype)
        for name, t in scalars.items():
            if not (isinstance(t, torch.Tensor) and t.dtype == cdt
                    and t.numel() == 1 and (
                        t.get_device() == index if index is not None
                        and t.is_cuda else t.device == device)):
                raise TypeError(f"{name} must be a 1-element {cdt} tensor "
                                f"on {device}")
    return dtype


def entry(lib, name: str, dtype: torch.dtype):
    """The C entry ``name`` of the visit family for storage ``dtype``."""
    return getattr(lib, name + _ENTRY_SUFFIX[dtype])


def _stencil_fields(st: Stencil5, ny: int) -> dict:
    return {f"st.{n}": (c, (ny, 1)) for n, c in zip(Stencil5._fields, st)}


class Coeff9Args(NamedTuple):
    """A Stencil9 as the C entries take it (csrc/mg_common.cuh Coeffs9)."""

    ptrs: np.ndarray     # 9 device pointers (uint64)
    strides: np.ndarray  # 9 y-strides, then 9 x-strides (int32)
    kinds: tuple         # per coefficient: (varies with y, varies with x)
    fields: dict         # for _check_cuda


def coeff9_args(st: Stencil9, ny: int, nx: int) -> Coeff9Args:
    """Each coefficient in its own broadcast shape, (1, 1), (ny, 1),
    (1, nx) or (ny, nx), with the strides that address it."""
    ptrs, sy, sx, kinds, fields = [], [], [], [], {}
    for name, c in zip(Stencil9._fields, st):
        if c.dim() != 2 or c.shape[0] not in (1, ny) or c.shape[1] not in (
                1, nx):
            raise ValueError(f"st.{name}: shape {tuple(c.shape)} is not one "
                             f"of (1, 1), ({ny}, 1), (1, {nx}), ({ny}, {nx})")
        fields[f"st.{name}"] = (c, tuple(c.shape))
        ky, kx = c.shape[0] > 1, c.shape[1] > 1
        kinds.append((ky, kx))
        ptrs.append(c.data_ptr())
        sy.append(c.shape[1] if ky else 0)
        sx.append(1 if kx else 0)
    return Coeff9Args(np.asarray(ptrs, np.uint64),
                      np.asarray(sy + sx, np.int32), tuple(kinds), fields)


def _coeff_floats(kinds, sh: int, sw: int) -> int:
    """Shared-memory floats of a 9-point tile's staged coefficients
    (visit.cu coeff_floats): per coefficient (and cc's inverse) its own
    shape."""

    def size(ky, kx):
        return (sh if ky else 1) * (sw if kx else 1)

    return size(*kinds[4]) + sum(size(*k) for k in kinds)


def visit_smem_bytes(kinds, h: int, itemsize: int = 4) -> int:
    """Shared memory of a 9-point visit block in bytes of
    ``itemsize``-byte values, the compute type's (visit.cuh
    visit9_smem_bytes): two u buffers on its fixed region, whatever the
    halo h."""
    ring = (REGION9_Y + 2) * (REGION9_X + 2)  # a u buffer and its zero ring
    return itemsize * (2 * ring + _coeff_floats(kinds, REGION9_Y, REGION9_X)
                       + THREADS9 // 32)


def visit_fits(kinds, h: int, itemsize: int = 4) -> bool:
    """Whether a visit with halo h runs (visit.cuh launch_visit,
    visit9_fits, v5_fits): a 5-point visit's h is within
    ``V5_MAX_HALO``, a 9-point visit's block fits its shared memory, and
    the tile keeps at least 2 rows and columns inside its region."""
    if kinds is None:
        if h > V5_MAX_HALO[itemsize]:
            return False
        sh, sw = visit5_region(h, itemsize)
    elif visit_smem_bytes(kinds, h, itemsize) > MAX_SMEM:
        return False
    else:
        sh, sw = REGION9_Y, REGION9_X
    return 2 * h <= min(sh, sw) - 2


def visit5_pairs(h: int, itemsize: int) -> bool:
    """Whether a 5-point visit of halo h takes the bf16 step (visit.cuh
    v5_pair): bf16 storage (``itemsize`` 2) and h <= V5_PAIR_MAX_H."""
    return itemsize == 2 and 1 <= h <= V5_PAIR_MAX_H


def visit5_xhalo(h: int, itemsize: int) -> int:
    """The columns a 5-point region keeps at each side of its tile: h, or
    on the bf16 step h rounded up to even (visit.cuh v5p_xhalo), so that
    a thread's column pairs start at even global columns."""
    return h + (h & 1) if visit5_pairs(h, itemsize) else h


def visit5_region(h: int, itemsize: int = 4) -> tuple[int, int]:
    """The (rows, columns) region a 5-point visit of halo h takes for a
    storage type of ``itemsize`` bytes (visit.cuh v5_pair, v5_tall): the
    bf16 step's region where ``visit5_pairs`` says so; else the short
    region up to h = V5_SHORT_MAX_H and the tall one past it (f32 compute:
    f32 and bf16 storage; an f64 visit keeps the short one: the tall
    one's two f64 buffers exceed a block's shared memory)."""
    if visit5_pairs(h, itemsize):
        return REGION5_PAIR
    tall = itemsize <= 4 and h > V5_SHORT_MAX_H
    return REGION5_TALL if tall else REGION5_SHORT


def visit5_grid(R: int, nx: int, h: int,
                itemsize: int = 4) -> tuple[int, int, int, int]:
    """A 5-point visit's launch over R rows and nx columns (visit.cuh
    visit5_grid, visit5p_grid) for a storage type of ``itemsize`` bytes:
    (blocks along x, blocks along y, tile rows, tile columns); block (bx,
    by) writes the tile from local row by * tile rows and column bx *
    tile columns."""
    sh, sw = visit5_region(h, itemsize)
    ty, tx = sh - 2 * h, sw - 2 * visit5_xhalo(h, itemsize)
    return -(-nx // tx), -(-R // ty), ty, tx


def _halo(emit: str, k: int) -> int:
    return k + {"u": 0, "ur": 1, "r": 1, "rc": 2}[emit]


def max_visit_steps(kinds, emit: str, itemsize: int = 4) -> int:
    """The most smoother steps a visit takes (``visit_fits``): with emit
    rc 43 for the 5-point visit in f32 and bf16 (23 in f64, the bound of
    ``V5_MAX_HALO``) and 29 for the 9-point visit of the
    anisotropic stencil in every storage type (bound by its region)."""
    k = 0
    while visit_fits(kinds, _halo(emit, k + 1), itemsize):
        k += 1
    return k


def visit_partials(lib, kinds, ny: int, nx: int, h: int,
                   itemsize: int = 4) -> int:
    """Number of per-block dot partials a whole-grid visit launch writes
    (its blocks; the 5-point visit's region follows h and the storage
    type's ``itemsize``: 2 is bf16 storage, ``visit5_region``)."""
    if kinds is None:
        return lib.mg_visit5_blocks(ny, nx, h, itemsize)
    return lib.mg_visit9_blocks(ny, nx, h)


@functools.lru_cache(maxsize=256)
def _steps_on(steps: tuple, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    return torch.tensor(steps, dtype=dtype, device=device).reshape(-1)


def steps_tensor(steps, device: torch.device,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The (alpha, beta) schedule as pairs of the compute type of storage
    ``dtype`` in device memory, made once per (schedule, type, device)
    (the kernels read it by pointer)."""
    if len(steps) < 1:
        raise ValueError("the visit kernels take at least one step")
    return _steps_on(tuple((float(a), float(bt)) for a, bt in steps),
                     compute_dtype(dtype), torch.device(device))


def _odd_shape(x: torch.Tensor) -> tuple[int, int]:
    ny, nx = x.shape
    if ny % 2 == 0 or nx % 2 == 0 or ny < 3 or nx < 3:
        raise ValueError(f"visit kernels need odd sizes >= 3, got {(ny, nx)}")
    return ny, nx


def _stream(device: torch.device) -> int:
    """The handle of ``device``'s current stream (no Stream object)."""
    index = device.index
    return torch._C._cuda_getCurrentRawStream(
        torch.cuda.current_device() if index is None else index)


def cg_papply_u(st: Stencil5, z, p, u, alpha_prev, beta):
    """(p', A p', u + alpha_prev p, <p', A p'>) with p' = z + beta p."""
    if _on_cpu(z):
        return cg_papply_u_plain(st, z, p, u, alpha_prev, beta)
    ny, nx = z.shape
    dtype = _check_cuda(z.device,
                        {"z": (z, (ny, nx)), "p": (p, (ny, nx)),
                         "u": (u, (ny, nx)), **_stencil_fields(st, ny)},
                        {"alpha_prev": alpha_prev, "beta": beta}, CG_DTYPES)
    lib = load_library()
    pn, ap, un = (torch.empty_like(z) for _ in range(3))
    part = torch.empty(lib.mg_visit_blocks(ny, nx),
                       dtype=compute_dtype(dtype), device=z.device)
    err = entry(lib, "mg_cg_papply_u", dtype)(
        *(c.data_ptr() for c in st), z.data_ptr(), p.data_ptr(),
        u.data_ptr(), alpha_prev.data_ptr(), beta.data_ptr(), pn.data_ptr(),
        ap.data_ptr(), un.data_ptr(), part.data_ptr(), ny, nx,
        _stream(z.device))
    check(err, "cg_papply_u launch")
    count_launch("cg_papply_u", z.dtype)
    return pn, ap, un, part.sum()


# Flag bits of the C entry mg_visit (csrc/visit.cu).
_F_CG, _F_GUESS, _F_CORRECT, _F_DOT, _EMIT_SHIFT = 1, 2, 4, 8, 4
_EMITS = {"u": 0, "ur": 1, "r": 2, "rc": 3}


class VisitOut(NamedTuple):
    u: torch.Tensor | None      # every emit but "r"
    r: torch.Tensor | None      # "ur", "r": b - A u
    rc: torch.Tensor | None     # "rc": R (b - A u)
    r_new: torch.Tensor | None  # CG: r - alpha ap
    dot: torch.Tensor | None    # CG: ||r'||^2; emit_dot: <b, u>


def launch_visit(st, b, steps, *, emit: str, u=None, e_c=None, ap=None,
                 alpha=None, emit_dot: bool = False) -> VisitOut:
    """One launch of the visit kernel family on CUDA tensors (f32, f64 or
    bf16; the CG flag set f32 and bf16), for a Stencil5 or a Stencil9: the CG
    residual update when ``ap`` is given (5-point only), the guess ``u``
    (None: zero), the correction ``e_c``, then ``len(steps)`` smoother
    steps and the ``emit`` outputs.  Checks every argument; raises
    ValueError on a combination the family lacks or a sweep count past
    the shared-memory bound of the storage type's compute type.  The
    caller counts the launch."""
    cg = ap is not None
    nine = isinstance(st, Stencil9)
    transfer = emit == "rc" or e_c is not None
    ny, nx = _odd_shape(b) if transfer else b.shape
    nyc, nxc = (ny - 1) // 2, (nx - 1) // 2
    if nine:
        if cg:
            raise ValueError("the CG visit is 5-point only")
        c9 = coeff9_args(st, ny, nx)
        fields = {"b": (b, (ny, nx)), **c9.fields}
    else:
        fields = {"b": (b, (ny, nx)), **_stencil_fields(st, ny)}
    kinds = c9.kinds if nine else None
    size = torch.finfo(compute_dtype(b.dtype)).bits // 8
    h = _halo(emit, len(steps))
    if not visit_fits(kinds, h, size):
        why = (f"its block must fit the {MAX_SMEM} B of shared memory, its "
               "tile its region" if nine
               else f"its halo at most {V5_MAX_HALO[size]}")
        raise ValueError(
            f"a {9 if nine else 5}-point {b.dtype} visit with emit {emit!r} "
            f"takes at most {max_visit_steps(kinds, emit, size)} steps "
            f"({why}); got {len(steps)}")
    scalars = {}
    if cg:
        fields["ap"] = (ap, (ny, nx))
        scalars["alpha"] = alpha
    if u is not None:
        fields["u"] = (u, (ny, nx))
    if e_c is not None:
        fields["e_c"] = (e_c, (nyc, nxc))
    dtype = _check_cuda(b.device, fields, scalars,
                        CG_DTYPES if cg else VISIT_DTYPES)
    steps_d = steps_tensor(steps, b.device, dtype)
    lib = load_library()

    def new(shape, want, dt=dtype):
        return (torch.empty(shape, dtype=dt, device=b.device)
                if want else None)

    out = VisitOut(u=new((ny, nx), emit != "r"),
                   r=new((ny, nx), emit in ("ur", "r")),
                   rc=new((nyc, nxc), emit == "rc"),
                   r_new=new((ny, nx), cg),
                   dot=new((visit_partials(lib, kinds, ny, nx, h,
                                           dtype.itemsize),),
                           cg or emit_dot, compute_dtype(dtype)))
    flags = ((_F_CG if cg else 0) | (_F_GUESS if u is not None else 0)
             | (_F_CORRECT if e_c is not None else 0)
             | (_F_DOT if emit_dot else 0) | _EMITS[emit] << _EMIT_SHIFT)

    def ptr(t):
        return None if t is None else t.data_ptr()

    if nine:
        err = entry(lib, "mg_visit9", dtype)(
            c9.ptrs.ctypes.data, c9.strides.ctypes.data, b.data_ptr(),
            ptr(u), ptr(e_c), ptr(out.u), ptr(out.r), ptr(out.rc),
            ptr(out.dot), ny, nx, steps_d.data_ptr(), len(steps), flags,
            _stream(b.device))
    else:
        err = entry(lib, "mg_visit", dtype)(
            *(c.data_ptr() for c in st), b.data_ptr(), ptr(ap), ptr(alpha),
            ptr(u), ptr(e_c), *map(ptr, out), ny, nx, steps_d.data_ptr(),
            len(steps), flags, _stream(b.device))
    check(err, f"visit launch (flags {flags})")
    return out if out.dot is None else out._replace(dot=out.dot.sum())


def cg_visit_down(st: Stencil5, r, ap, alpha, steps):
    """(u0, rc, r', ||r'||^2) with r' = r - alpha ap (K2a)."""
    if _on_cpu(r):
        return cg_visit_down_plain(st, r, ap, alpha, steps)
    o = launch_visit(st, r, steps, emit="rc", ap=ap, alpha=alpha)
    count_launch("cg_visit_down", r.dtype)
    return o.u, o.rc, o.r_new, o.dot


def visit_down(st: Stencil5, b, steps):
    """(u0, rc): the zero-guess down visit (K2b)."""
    if _on_cpu(b):
        return visit_down_plain(st, b, steps)
    o = launch_visit(st, b, steps, emit="rc")
    count_launch("visit_down", b.dtype)
    return o.u, o.rc


def visit_up(st: Stencil5, b, u, e_c, steps, emit_dot: bool = True):
    """z = smooth_k(b, u + P e_c) [, <b, z>] (K3)."""
    if _on_cpu(b):
        return visit_up_plain(st, b, u, e_c, steps, emit_dot)
    o = launch_visit(st, b, steps, emit="u", u=u, e_c=e_c, emit_dot=emit_dot)
    count_launch("visit_up", b.dtype)
    return (o.u, o.dot) if emit_dot else o.u
