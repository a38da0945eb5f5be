"""KP3: the staged copy pipeline (``csrc/pipeline.cu``).

Counterpart of the kernels of ``benchmarks/probe_dma.py`` ``probe_c`` (its
``pallas_call`` at :132 and :154: an n x n f32 array copied k times in one
kernel, (256, n) tiles double-buffered through VMEM by manual DMA) and
``benchmarks/probe_dma_parts.py`` ``variant`` (:157: the compute-free
visit pipeline).  Both stream data through shared memory with the card's
asynchronous copy engine (1-D ``cp.async.bulk`` global to shared on an
mbarrier): the copy through a ring of ``STAGES`` buffers a block,
``LOOKAHEAD`` loads in flight, the chunks dealt in rounds and the last
round in equal shares; the pipeline through a ring of row stages a
block, one producer warp issuing every load (its lanes a row each) and
``PIPE_WARPS`` consumer warps filling, gathering and storing, the carried
halo rows kept in place in the ring, each column strip cut into bands
dealt band-major, round robin, to the persistent blocks.
What they stream is read beside K18a's plain loads (``stream_kernel``).
No solve runs them.

  staged_copy(u, k)         a copy of u, made k times over in one launch
                            (chunks of 8192 f32, 32 KB)
  staged_visit_pipeline(b, t, mode)
                            u = b and, where the mode has an rc stream, rc =
                            b's odd-odd points, through tiles of t rows x
                            256 columns with H = 8 halo rows above and below
                            (a band of a column strip walked down by one
                            block); the modes of the JAX probe:
      v_full     halo rows carried from the tile above, u staged, rc
      v_norc     carried, staged, no rc
      v_nocarry  halo rows re-read, staged, rc
      v_direct   carried, u written from the ring, rc
      v_bare     re-read, direct, no rc

The JAX probe's ``v_nocarry`` skips its carry copy and leaves the halo
rows as garbage; here a tile without the carry reads its halo rows again,
so ``carry`` against ``nocarry`` is what keeping them saves
(``pipe_bytes`` counts the re-read rows).  Its rc stream writes whatever
its scratch held; here rc is b's odd-odd points (b[1::2, 1::2] of its
(ny - 1) / 2 x (nx - 1) / 2 points).  Both functions copy: their plain
versions (``*_plain``) are exact, and the kernels are held to them bit
for bit.

Each wrapper runs its plain version for CPU tensors and launches the
kernel for CUDA tensors (f32, contiguous; anything else raises), never
falling back, and counts each launch as ``staged_copy`` or
``staged_visit_pipeline``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from multigrid_petsc_tpu_torch.ops.cuda import count_launch
from multigrid_petsc_tpu_torch.ops.cuda._build import check, load_library
from multigrid_petsc_tpu_torch.ops.cuda.mdma_kernel import (
    MAX_SMEM,
    _check_cuda,
    _on_cpu,
    _stream,
)

CHUNK = 8192  # f32 entries a staged_copy chunk (csrc/pipeline.cu)
STAGES = 3  # staged_copy's shared buffers a block (pipeline.cu STAGES)
LOOKAHEAD = 2  # its bulk loads in flight (pipeline.cu LOOKAHEAD)
BLOCKS_PER_SM = 2  # its one-warp blocks an SM (pipeline.cu BLOCKS_PER_SM)
TILE_COLS = 256  # columns of a visit-pipeline tile (csrc/pipeline.cu TW)
HALO = 8  # halo rows, the TPU kernel's H (pipeline.cu HALO)
PIPE_WARPS = 8  # consumer warps of a pipeline block (pipeline.cu PIPE_WARPS)
PIPE_THREADS = 288  # and its producer warp (pipeline.cu PIPE_THREADS)
PIPE_STAGES = 6  # most tiles of its ring (pipeline.cu PIPE_STAGES)
PIPE_MIN_STAGES = 3  # fewest: two loads in flight (PIPE_MIN_STAGES)
# mode: (carry the halo rows, stage u, write rc)
PIPE_MODES = {"v_full": (True, True, True), "v_norc": (True, True, False),
              "v_nocarry": (False, True, True),
              "v_direct": (True, False, True),
              "v_bare": (False, False, False)}


def staged_copy_plain(u: torch.Tensor, k: int = 1) -> torch.Tensor:
    """A copy of u (k passes copy the same values)."""
    return u.clone()


def staged_copy(u: torch.Tensor, k: int = 1) -> torch.Tensor:
    """A copy of u, made k times over in one launch of the staged copy."""
    if _on_cpu(u):
        return staged_copy_plain(u, k)
    if k < 1:
        raise ValueError(f"staged_copy takes k >= 1 passes, got {k}")
    dev, ptr = u.device, u.data_ptr()
    _check_cuda(dev, {"u": (u, u.shape)})
    if ptr % 4:
        raise ValueError("staged_copy needs u 4-byte aligned")
    # o shares u's address mod 16, so one chunking stages both (a fresh
    # tensor starts 16-byte aligned: only an offset u needs the slack).
    off = (ptr % 16) // 4
    if off == 0:
        o = torch.empty_like(u)
    else:
        o = torch.empty(u.numel() + 3, dtype=u.dtype, device=dev)
        o = o[off:off + u.numel()].view(u.shape)
    err = load_library().mg_staged_copy(ptr, o.data_ptr(), u.numel(), k,
                                        _stream(dev))
    check(err, "staged_copy launch")
    count_launch("staged_copy", u.dtype)
    return o


def ring_rows(t: int, mode: str, stages: int) -> int:
    """Rows of the pipeline's ring: ``stages`` tiles of t rows below 2 H
    carried ones, or ``stages`` whole windows without the carry
    (``csrc/pipeline.cu`` ``ring_rows``)."""
    carry = PIPE_MODES[mode][0]
    return stages * t + 2 * HALO if carry else stages * (t + 2 * HALO)


def pipe_smem_bytes(t: int, mode: str, stages: int | None = None) -> int:
    """Shared memory of a visit-pipeline block (``csrc/pipeline.cu``
    ``pipe_smem``): the ring, the staged u rows and the ring's full and
    empty barriers.  ``stages``: the wrapper's choice (``pipe_stages``),
    or its fewest where none fits."""
    staging = PIPE_MODES[mode][1]
    if stages is None:
        stages = pipe_stages(t, mode) or PIPE_MIN_STAGES
    rw = TILE_COLS + 4
    return 4 * rw * (ring_rows(t, mode, stages) + (t if staging else 0)) + (
        16 * PIPE_STAGES)


@functools.lru_cache(maxsize=None)
def pipe_stages(t: int, mode: str) -> int | None:
    """The ring's stages at tile rows t: the most (up to ``PIPE_STAGES``)
    whose block fits ``MAX_SMEM``; None where not even
    ``PIPE_MIN_STAGES`` fit (the wrapper refuses such a t)."""
    for stages in range(PIPE_STAGES, PIPE_MIN_STAGES - 1, -1):
        if pipe_smem_bytes(t, mode, stages) <= MAX_SMEM:
            return stages
    return None


def pipe_bytes(ny: int, nx: int, t: int, mode: str, bands: int) -> dict:
    """Bytes the pipeline moves on an ny x nx f32 grid whose column strips
    are cut into ``bands`` bands (``pipe_plan`` on the card): ``read``
    (b's rows as loaded, the halo rows each band or tile loads again
    included), ``written`` (u and rc), ``moved`` (both), ``bound`` (b read
    once, u and rc written once) and ``reread`` (read less b's bytes).
    Band k of a strip holds the row pairs [k pp / bands, (k + 1) pp /
    bands) (pp = (ny + 1) / 2 a strip); a band carries its halo rows from
    tile to tile (its window's rows loaded once) or, without the carry,
    loads each tile's whole window."""
    carry, _, rc = PIPE_MODES[mode]
    pp = (ny + 1) // 2
    rows = 0  # b's rows loaded in one strip
    for k in range(bands):
        r0, r1 = 2 * (k * pp // bands), min(ny, 2 * ((k + 1) * pp // bands))
        tops = [r0] if carry else range(r0, r1, t)
        rows += sum(min(ny, (r1 if carry else min(r1, a + t)) + HALO)
                    - max(0, a - HALO) for a in tops)
    read = rows * nx  # every strip the same rows, its own width
    nyc, nxc = (ny - 1) // 2, (nx - 1) // 2
    out = ny * nx + (nyc * nxc if rc else 0)
    return {"read": 4 * read, "written": 4 * out, "moved": 4 * (read + out),
            "bound": 4 * (ny * nx + out), "reread": 4 * (read - ny * nx)}


def pipe_plan(shape, t: int, mode: str) -> tuple[int, int]:
    """(blocks, bands): the grid the pipeline launches on this card for a
    grid of ``shape`` and the bands of each column strip
    (``csrc/pipeline.cu`` ``mg_staged_pipe_plan``)."""
    carry, staging, _ = PIPE_MODES[mode]
    plan = (ctypes.c_int * 2)()
    err = load_library().mg_staged_pipe_plan(
        shape[0], shape[1], t, pipe_stages(t, mode) or 0, int(carry),
        int(staging), ctypes.addressof(plan))
    check(err, f"staged_visit_pipeline plan ({mode}, t = {t})")
    return plan[0], plan[1]


def staged_visit_pipeline_plain(b: torch.Tensor, t: int, mode: str):
    """(u, rc): u = b, rc = b's odd-odd points (None without rc)."""
    _, _, rc_on = PIPE_MODES[mode]
    nyc, nxc = (b.shape[0] - 1) // 2, (b.shape[1] - 1) // 2
    rc = b[1:2 * nyc:2, 1:2 * nxc:2].clone() if rc_on else None
    return b.clone(), rc


def staged_visit_pipeline(b: torch.Tensor, t: int, mode: str):
    """(u, rc) of the compute-free visit pipeline in mode ``mode`` with
    tiles of t rows (even, at least 2 H); on the card through a ring of
    ``pipe_stages(t, mode)`` tiles."""
    if mode not in PIPE_MODES:
        raise ValueError(f"mode must be one of {tuple(PIPE_MODES)}, "
                         f"got {mode!r}")
    if t < 2 * HALO or t % 2:
        raise ValueError(f"tile rows must be even and >= {2 * HALO}, "
                         f"got {t}")
    if _on_cpu(b):
        return staged_visit_pipeline_plain(b, t, mode)
    carry, staging, rc_on = PIPE_MODES[mode]
    stages = pipe_stages(t, mode)
    if stages is None:
        raise ValueError(f"t = {t} in {mode} takes {pipe_smem_bytes(t, mode)}"
                         f" B of shared memory with {PIPE_MIN_STAGES} stages,"
                         f" more than {MAX_SMEM}")
    if b.dim() != 2 or min(b.shape) < 3:
        raise ValueError(f"b must be 2-D, at least 3 x 3, got "
                         f"{tuple(b.shape)}")
    ny, nx = b.shape
    _check_cuda(b.device, {"b": (b, (ny, nx))})
    if b.data_ptr() % 16:
        raise ValueError("staged_visit_pipeline needs b 16-byte aligned")
    u = torch.empty_like(b)
    rc = (torch.empty(((ny - 1) // 2, (nx - 1) // 2), dtype=b.dtype,
                      device=b.device) if rc_on else None)
    err = load_library().mg_staged_pipe(
        b.data_ptr(), u.data_ptr(), None if rc is None else rc.data_ptr(),
        ny, nx, t, stages, int(carry), int(staging), _stream(b.device))
    check(err, f"staged_visit_pipeline launch ({mode}, t = {t})")
    count_launch("staged_visit_pipeline", b.dtype)
    return u, rc
