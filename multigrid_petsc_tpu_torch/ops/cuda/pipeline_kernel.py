"""KP3: the staged copy pipeline (``csrc/pipeline.cu``).

Counterpart of the kernels of ``benchmarks/probe_dma.py`` ``probe_c`` (its
``pallas_call`` at :132 and :154: an n x n f32 array copied k times in one
kernel, (256, n) tiles double-buffered through VMEM by manual DMA) and
``benchmarks/probe_dma_parts.py`` ``variant`` (:157: the compute-free
visit pipeline).  Both stream data through shared memory with the card's
asynchronous copy engine (1-D ``cp.async.bulk`` global to shared on an
mbarrier, shared to global in bulk groups): the copy through a ring of
``STAGES`` buffers a block, ``LOOKAHEAD`` loads in flight, the chunks
dealt in rounds and the last round in equal shares; the pipeline through
two buffers a persistent block.  What they stream is read beside K18a's
plain loads (``stream_kernel``).  No solve runs them.

  staged_copy(u, k)         a copy of u, made k times over in one launch
                            (chunks of 8192 f32, 32 KB)
  staged_visit_pipeline(b, t, mode)
                            u = b and, where the mode has an rc stream, rc =
                            b's odd-odd points, through tiles of t rows x
                            256 columns with H = 8 halo rows above and below
                            (``SEG`` tiles walked down a column strip by one
                            block); the modes of the JAX probe:
      v_full     halo rows carried from the tile above, u staged, rc
      v_norc     carried, staged, no rc
      v_nocarry  halo rows re-read, staged, rc
      v_direct   carried, u written from the input buffer, rc
      v_bare     re-read, direct, no rc

The JAX probe's ``v_nocarry`` skips its carry copy and leaves the halo
rows as garbage; here a tile without the carry reads its halo rows again,
so ``carry`` against ``nocarry`` is what keeping them saves.  Its rc
stream writes whatever its scratch held; here rc is b's odd-odd points
(b[1::2, 1::2] of its (ny - 1) / 2 x (nx - 1) / 2 points).  Both
functions copy: their plain versions (``*_plain``) are exact, and the
kernels are held to them bit for bit.

Each wrapper runs its plain version for CPU tensors and launches the
kernel for CUDA tensors (f32, contiguous; anything else raises), never
falling back, and counts each launch as ``staged_copy`` or
``staged_visit_pipeline``.
"""

from __future__ import annotations

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
SEG = 8  # tiles a unit, one block's walk down a strip (pipeline.cu SEG)
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


def pipe_smem_bytes(t: int, mode: str) -> int:
    """Shared memory of a visit-pipeline block (``csrc/pipeline.cu``
    ``pipe_smem``)."""
    _, staging, rc = PIPE_MODES[mode]
    rw, rwc = TILE_COLS + 4, TILE_COLS // 2 + 4
    return 4 * (2 * (t + 2 * HALO) * rw + (2 * t * rw if staging else 0)
                + (2 * (t // 2) * rwc if rc else 0)) + 16


def staged_visit_pipeline_plain(b: torch.Tensor, t: int, mode: str):
    """(u, rc): u = b, rc = b's odd-odd points (None without rc)."""
    _, _, rc_on = PIPE_MODES[mode]
    nyc, nxc = (b.shape[0] - 1) // 2, (b.shape[1] - 1) // 2
    rc = b[1:2 * nyc:2, 1:2 * nxc:2].clone() if rc_on else None
    return b.clone(), rc


def staged_visit_pipeline(b: torch.Tensor, t: int, mode: str):
    """(u, rc) of the compute-free visit pipeline in mode ``mode`` with
    tiles of t rows (even)."""
    if mode not in PIPE_MODES:
        raise ValueError(f"mode must be one of {tuple(PIPE_MODES)}, "
                         f"got {mode!r}")
    if t < 2 or t % 2:
        raise ValueError(f"tile rows must be even and >= 2, got {t}")
    if _on_cpu(b):
        return staged_visit_pipeline_plain(b, t, mode)
    carry, staging, rc_on = PIPE_MODES[mode]
    if pipe_smem_bytes(t, mode) > MAX_SMEM:
        raise ValueError(f"t = {t} in {mode} takes {pipe_smem_bytes(t, mode)}"
                         f" B of shared memory, more than {MAX_SMEM}")
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
        ny, nx, t, int(carry), int(staging), _stream(b.device))
    check(err, f"staged_visit_pipeline launch ({mode}, t = {t})")
    count_launch("staged_visit_pipeline", b.dtype)
    return u, rc
