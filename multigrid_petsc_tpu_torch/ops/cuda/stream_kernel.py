"""K18a: the blocked copy o = a u, and the stream rate it reaches.

Counterpart of the kernel of ``benchmarks/baseline_configs.py``
``measured_pallas_bandwidth`` (its ``pallas_call`` at :177: ``o = u *
1.0001`` over an n x n array in (256, n) tiles, loop-differenced between
k = 2 and k = 18 chained calls): the rate at which a hand-written kernel
streams device memory, the yardstick the other kernels' byte bounds are
read against.  No solve runs it.  The kernel is ``csrc/stream.cu`` (a
block a tile of ``UNROLL`` x ``THREADS`` vectors, 16 bytes a load where
the pointers allow, evict-first loads and stores).

``scale_copy`` runs its plain version for CPU tensors and launches the
kernel for CUDA tensors (f32, f64, bf16, contiguous; anything else
raises), never falling back from one to the other, and counts each launch
as ``scale_copy`` (``.f64``, ``.bf16``) in ``ops.cuda.launches``.  As the
TPU kernel casts 1.0001 to its dtype, the scalar is rounded to the
storage type first; the product is formed in the compute type (f32 for
bf16, exactly) and rounded to the storage type once.

KP2, ``scale_copy_``: the same copy in place, u <- a u (its own kernel
instantiation: one pointer is never passed as both the input and the
output of ``scale_copy``'s), counterpart of the aliased copies of
``benchmarks/probe_dma.py`` ``probe_b`` (:78) and
``benchmarks/probe_cg_ablate.py`` ``_copy_chain`` (:55, with
``input_output_aliases``); counted as ``scale_copy_``.
"""

from __future__ import annotations

import math
import statistics
import time

import torch

from multigrid_petsc_tpu_torch.ops.cuda import count_launch
from multigrid_petsc_tpu_torch.ops.cuda._build import check, load_library
from multigrid_petsc_tpu_torch.ops.cuda.mdma_kernel import (
    _check_cuda,
    _on_cpu,
    _stream,
    compute_dtype,
    entry,
)

DTYPES = (torch.float32, torch.float64, torch.bfloat16)
# csrc/stream.cu NTHREADS, UNROLL: a block's tile is UNROLL x THREADS
# 16-byte vectors.
THREADS, UNROLL = 256, 4
# The H100 SXM data sheet's device-memory rate, B/s: no sample of a card
# of that kind can stream faster.
SPEC_BYTES_PER_S = 3.35e12


_SCALARS: dict = {}  # (a, its sign, dtype) -> _scalar(a, dtype)


def _scalar(a: float, dtype: torch.dtype) -> float:
    """``a`` rounded to the storage type, as a compute-type value: made
    once by a tensor round trip and kept per (a, its sign, storage type),
    the sign apart because 0.0 and -0.0 compare equal (at most 1024
    entries; a NaN, equal to no key, is rounded anew each call)."""
    key = (a, math.copysign(1.0, a), dtype)
    s = _SCALARS.get(key)
    if s is None:
        s = float(torch.tensor(a, dtype=dtype).to(compute_dtype(dtype)))
        if len(_SCALARS) < 1024:
            _SCALARS[key] = s
    return s


def scale_copy_plain(u: torch.Tensor, a: float) -> torch.Tensor:
    """a u: the product of u and a (rounded to u's type) in the compute
    type, rounded to u's type once."""
    c = compute_dtype(u.dtype)
    s = torch.tensor(_scalar(a, u.dtype), dtype=c, device=u.device)
    return (u.to(c) * s).to(u.dtype)


def scale_copy(u: torch.Tensor, a: float, out: torch.Tensor | None = None):
    """o = a u over a 2-D tensor, into ``out`` where given."""
    if _on_cpu(u):
        o = scale_copy_plain(u, a)
        return o if out is None else out.copy_(o)
    if u.dim() != 2:
        raise ValueError(f"scale_copy takes a 2-D tensor, got {u.dim()}-D")
    o = torch.empty_like(u) if out is None else out
    dev, shp = u.device, u.shape
    dtype = _check_cuda(dev, {"u": (u, shp), "out": (o, shp)}, dtypes=DTYPES)
    err = entry(load_library(), "mg_scale_copy", dtype)(
        u.data_ptr(), o.data_ptr(), u.numel(), _scalar(a, dtype),
        _stream(dev))
    check(err, "scale_copy launch")
    count_launch("scale_copy", dtype)
    return o


def scale_copy_plain_(u: torch.Tensor, a: float) -> torch.Tensor:
    """u <- a u in place: ``scale_copy_plain``'s product, written back."""
    return u.copy_(scale_copy_plain(u, a))


def scale_copy_(u: torch.Tensor, a: float) -> torch.Tensor:
    """u <- a u in place over a 2-D tensor (KP2); returns u."""
    if _on_cpu(u):
        return scale_copy_plain_(u, a)
    if u.dim() != 2:
        raise ValueError(f"scale_copy_ takes a 2-D tensor, got {u.dim()}-D")
    dev = u.device
    dtype = _check_cuda(dev, {"u": (u, u.shape)}, dtypes=DTYPES)
    err = entry(load_library(), "mg_scale_copy_inplace", dtype)(
        u.data_ptr(), u.numel(), _scalar(a, dtype), _stream(dev))
    check(err, "scale_copy_ launch")
    count_launch("scale_copy_", dtype)
    return u


def measured_kernel_bandwidth(n: int = 8192, dtype=torch.float32,
                              device=None, samples: int = 3) -> dict:
    """The stream rate through K18a, loop-differenced as
    ``measured_pallas_bandwidth``: k = 2 and k = 18 chained launches of o
    = 1.0001 u on an n x n array (each launch's input the last one's
    output), timed on the host clock around a synchronised run, their
    difference over 16 launches of n^2 2 itemsize bytes (one read, one
    write).  ``samples`` such pairs; the rate is the median of the samples
    at or under 1.02 of the data sheet's rate (all of them where none
    is), held to that rate (``clamped_to_spec``), as
    ``measured_bandwidth_info`` keeps its evidence.  ``device`` None is
    the card; on the CPU the plain version runs and no data-sheet rate
    applies (a CPU rate is no device metric)."""
    dev = torch.device("cuda" if device is None else device)
    cuda = dev.type == "cuda"
    x = torch.ones((n, n), dtype=dtype, device=dev)
    y = torch.empty_like(x)

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def chain(k):
        a, b = x, y
        for _ in range(k):
            scale_copy(a, 1.0001, out=b)
            a, b = b, a

    def timed(k):
        chain(k)  # warm
        sync()
        t0 = time.perf_counter()
        chain(k)
        sync()
        return time.perf_counter() - t0

    k1, k2 = 2, 18
    nbytes = n * n * 2 * x.element_size()
    raw = []
    for _ in range(max(samples, 1)):
        dt = (timed(k2) - timed(k1)) / (k2 - k1)
        raw.append(nbytes / max(dt, 1e-12))
    spec = SPEC_BYTES_PER_S if cuda else None
    ok = [r for r in raw if spec is None or r <= 1.02 * spec]
    rate = statistics.median(ok or raw)
    clamped = not ok
    if spec is not None and rate > spec:
        rate, clamped = spec, True
    return {"bytes_per_s": rate,
            "samples_GBps": [r / 1e9 for r in raw],
            "above_spec": [spec is not None and r > spec for r in raw],
            "spec_GBps": None if spec is None else spec / 1e9,
            "clamped_to_spec": clamped, "n": n,
            "dtype": str(dtype).replace("torch.", ""),
            "bytes_per_launch": nbytes,
            "device": torch.cuda.get_device_name(dev) if cuda else "cpu"}
