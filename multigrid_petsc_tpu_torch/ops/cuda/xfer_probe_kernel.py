"""K18b-W, K18b-R, K18b-P: the halo-window extraction and the x-transfer
passes on a resident slab (``csrc/probe_xfer.cu``).

Counterparts of the last three TPU kernels of the attribution probes:

  halo_windows(x, stride, g, top, bot)
      ``benchmarks/probe_windows_ab.py`` ``halo_windows_pallas`` (its
      ``pallas_call`` at :72): the (tails, heads) windows of x's row
      blocks of ``stride`` rows, (g, top, nx) and (g, bot, nx):
      tails[i, j] = x[i stride - top + j] for i >= 1, heads[i, j] =
      x[(i + 1) stride + j], tails[0] and every row at or past n zero
      (1 <= top, bot <= stride).  ``stencil_kernel._halo_windows`` where
      top = bot.  A masked row copy: each output row is one input row or
      zeros.
  xfer_restrict(x, mode, G)
      ``benchmarks/probe_transpose.py`` ``make`` (:109): out = the sum
      over passes i < G, in order, of op(x s_i), s_i = f32(1 + 1e-7 i)
      (``pass_scales``), x (rows, nxp) -> out (rows, nxp / 2); the
      modes (v = x s_i, nxcp = nxp / 2):
        noop     v[:, :nxcp]
        arith    v[j] + 2 v[j + 1] + v[j + 2], j < nxcp (no compaction)
        shuffle  the first nxcp columns de-interleaved: out[:, j] =
                 v[:, 2j], out[:, nxcp / 2 + j] = v[:, 2j + 1]
        full     ``mdma_kernel._restrict_x_pad``: 0.0625 (v[2J] +
                 2 v[2J + 1] + v[2J + 2]) for J < nxcp - 1, the last
                 column 0
        apply8   r = v[:, :nxcp], then 8 times r = 0.99 r + 0.01 (r[j - 1]
                 + r[j + 1]), cyclic on nxcp columns
  xfer_prolong(e, G)
      ``probe_transpose.py`` ``make_prolong`` (:139): the same sum of
      ``mdma_kernel._prolong_x_pad`` of e s_i, e (rows, nxcp) -> (rows,
      2 nxcp): out[:, 2J + 1] = v[:, J] and out[:, 2J] = 0.5 (v[:, J] +
      v[:, J - 1]) with v[:, -1] = v[:, nxcp - 1] = 0 (e's last column is
      pad, never read), the last column 0.

The TPU kernels run the x-transfers of its down and up visits alone on a
VMEM-resident slab, G grid steps over one block; the card's x-restriction
is a pass over shared memory at stride 2 inside the visit kernel, so the
card's kernels hold the slab's tiles in shared memory and run the G
passes from there (``csrc/probe_xfer.cu`` says how).  The JAX kernels'
order of operations is kept in every mode, so the kernels and their
plain versions agree bit for bit.  No solve runs them.

Each wrapper runs its plain version (``*_plain``) for CPU tensors and
launches its kernel for CUDA tensors (f32; anything else raises), never
falling back, and counts each launch as ``halo_windows``,
``xfer_restrict`` or ``xfer_prolong``.
"""

from __future__ import annotations

import functools

import torch

from multigrid_petsc_tpu_torch.ops.cuda import count_launch
from multigrid_petsc_tpu_torch.ops.cuda._build import check, load_library
from multigrid_petsc_tpu_torch.ops.cuda.mdma_kernel import (
    _check_cuda,
    _on_cpu,
    _stream,
)

# The modes' numbers in csrc/probe_xfer.cu (XferMode).
RESTRICT_MODES = {"noop": 0, "arith": 1, "shuffle": 2, "full": 3,
                  "apply8": 4}
PROLONG = 5
APPLY_STEPS = 8  # apply8's smoothing steps (probe_xfer.cu APPLY_STEPS)
# The kernels' column unit: nxp must be a multiple of it, so that every
# mode's tiles fit whole (probe_xfer.cu XFER_UNIT).
XFER_UNIT = 512
MAX_PASSES = 8192  # the scales live in shared memory (probe_xfer.cu)
# mode: (floats a lane's window reads a pass, input columns it takes)
# (probe_xfer.cu Window<MODE>); the lanes tile half the fine width, full
# the whole of it.
WINDOWS = {"noop": (4, 4), "arith": (8, 4), "shuffle": (4, 4),
           "full": (12, 8), "apply8": (24, 8), "prolong": (8, 4)}
# Operations a pass makes per output of the JAX function (not of the
# kernel's windows): x s_i on each input column it takes, the mode's
# arithmetic, the running sum's add (prolong: an even output 2 and an odd
# one none; an input column scaled per 2 outputs).  For the bound.
OPS_PER_OUTPUT = {"noop": 2, "arith": 5, "shuffle": 2, "full": 7,
                  "apply8": 2 + 4 * APPLY_STEPS, "prolong": 2.5}


def pass_scales(G: int) -> torch.Tensor:
    """The passes' scales s_i = 1 + 1e-7 i, formed in f64 and rounded to
    f32 once, as JAX forms them with 64-bit types on (``1e-7 *
    program_id`` is a weak f64 value, cast to f32 by the product)."""
    return torch.tensor([1.0 + 1e-7 * i for i in range(G)],
                        dtype=torch.float64).float()


# ---- K18b-W: the halo windows.


def halo_windows_plain(x: torch.Tensor, stride: int, g: int, top: int,
                       bot: int):
    """(tails, heads) built by strided slices, as
    ``stencil_kernel._halo_windows`` builds them: one slice a window row."""
    _check_windows(x, stride, g, top, bot)
    nx = x.shape[1]
    tails = x.new_zeros((g, top, nx))
    heads = x.new_zeros((g, bot, nx))
    for j in range(top):
        src = x[stride - top + j::stride]
        m = min(src.shape[0], g - 1)
        tails[1:1 + m, j] = src[:m]
    for j in range(bot):
        src = x[stride + j::stride]
        m = min(src.shape[0], g)
        heads[:m, j] = src[:m]
    return tails, heads


def _check_windows(x, stride, g, top, bot):
    if x.dim() != 2:
        raise ValueError(f"x must be 2-D, got {x.dim()}-D")
    if not (1 <= top <= stride and 1 <= bot <= stride and g >= 1):
        raise ValueError(f"need 1 <= top, bot <= stride and g >= 1, got "
                         f"stride {stride}, g {g}, top {top}, bot {bot}")


def halo_windows(x: torch.Tensor, stride: int, g: int, top: int, bot: int):
    """(tails (g, top, nx), heads (g, bot, nx)) of x's blocks of
    ``stride`` rows in one launch.  x may be a view whose rows are
    contiguous (any row pitch, any offset)."""
    if _on_cpu(x):
        return halo_windows_plain(x, stride, g, top, bot)
    _check_windows(x, stride, g, top, bot)
    n, nx = x.shape
    if x.dtype != torch.float32:
        raise TypeError(f"halo_windows is built for torch.float32, got "
                        f"{x.dtype}")
    if x.stride(1) != 1 or x.stride(0) < nx:
        raise ValueError("halo_windows needs x's rows contiguous")
    tails = torch.empty((g, top, nx), dtype=x.dtype, device=x.device)
    heads = torch.empty((g, bot, nx), dtype=x.dtype, device=x.device)
    err = load_library().mg_halo_windows(
        x.data_ptr(), x.stride(0), n, nx, stride, g, top, bot,
        tails.data_ptr(), heads.data_ptr(), _stream(x.device))
    check(err, "halo_windows launch")
    count_launch("halo_windows", x.dtype)
    return tails, heads


def windows_bytes(n: int, nx: int, stride: int, g: int, top: int,
                  bot: int) -> int:
    """The bytes ``halo_windows`` must move: every window row written
    once, every row of x it copies read once."""
    read = sum(1 for i in range(1, g) for j in range(top)
               if i * stride - top + j < n)
    read += sum(1 for i in range(g) for j in range(bot)
                if (i + 1) * stride + j < n)
    return 4 * nx * (g * (top + bot) + read)


# ---- K18b-R and K18b-P: the x-transfer passes.


def _roll_left(v: torch.Tensor, k: int) -> torch.Tensor:
    """pltpu.roll(v, n - k, 1): out[:, j] = v[:, (j + k) mod n]."""
    return torch.roll(v, -k, 1)


def xfer_restrict_plain(x: torch.Tensor, mode: str, G: int):
    """The G passes of ``mode`` on x (rows, nxp), summed in order."""
    _check_xfer(x, mode, G)
    nxcp = x.shape[1] // 2
    out = x.new_zeros((x.shape[0], nxcp))
    for s in pass_scales(G).to(x.device):
        v = x * s
        if mode == "noop":
            r = v[:, :nxcp]
        elif mode == "arith":
            r = (v + 2.0 * _roll_left(v, 1) + _roll_left(v, 2))[:, :nxcp]
        elif mode == "shuffle":
            r = torch.cat([v[:, 0:nxcp:2], v[:, 1:nxcp:2]], 1)
        elif mode == "full":
            t = v + 2.0 * _roll_left(v, 1) + _roll_left(v, 2)
            r = torch.cat([0.0625 * t[:, 0:2 * (nxcp - 1):2],
                           v.new_zeros((v.shape[0], 1))], 1)
        else:  # apply8
            r = v[:, :nxcp]
            for _ in range(APPLY_STEPS):
                r = 0.99 * r + 0.01 * (torch.roll(r, 1, 1)
                                       + torch.roll(r, -1, 1))
        out = out + r
    return out


def xfer_prolong_plain(e: torch.Tensor, G: int):
    """The G passes of the x-prolongation on e (rows, nxcp), summed in
    order: (rows, 2 nxcp)."""
    _check_xfer(e, None, G)
    rows, nxcp = e.shape
    z = e.new_zeros((rows, 1))
    out = e.new_zeros((rows, 2 * nxcp))
    for s in pass_scales(G).to(e.device):
        v = (e * s)[:, :nxcp - 1]
        right = torch.cat([v, z], 1)  # v[J], 0 at J = nxcp - 1
        left = torch.cat([z, v], 1)   # v[J - 1], 0 at J = 0
        r = torch.empty_like(out)
        r[:, 0::2] = 0.5 * (right + left)
        r[:, 1::2] = right
        out = out + r
    return out


def _check_xfer(x, mode, G):
    if mode is not None and mode not in RESTRICT_MODES:
        raise ValueError(f"mode must be one of {tuple(RESTRICT_MODES)}, "
                         f"got {mode!r}")
    if x.dim() != 2 or x.shape[1] < 4 or x.shape[1] % 2:
        raise ValueError(f"the slab must be 2-D with an even number of "
                         f"columns >= 4, got {tuple(x.shape)}")
    if G < 1:
        raise ValueError(f"G >= 1 passes, got {G}")


@functools.lru_cache(maxsize=None)
def _device_scales(G: int, device: torch.device) -> torch.Tensor:
    """``pass_scales(G)`` on the card, copied there once (a copy from
    host memory waits for the card, which a timed run must not)."""
    return pass_scales(G).to(device)


def _launch_xfer(x, mode_id, out_cols, G, name):
    rows, cols = x.shape
    nxp = cols if mode_id != PROLONG else 2 * cols
    if nxp % XFER_UNIT or G > MAX_PASSES:
        raise ValueError(f"{name} needs the fine width a multiple of "
                         f"{XFER_UNIT} and G <= {MAX_PASSES}, got {nxp} "
                         f"and {G}")
    _check_cuda(x.device, {"x": (x, x.shape)})
    out = torch.empty((rows, out_cols), dtype=x.dtype, device=x.device)
    scales = _device_scales(G, x.device)
    err = load_library().mg_xfer_pass(x.data_ptr(), out.data_ptr(),
                                      scales.data_ptr(), rows, nxp, G,
                                      mode_id, _stream(x.device))
    check(err, f"{name} launch")
    count_launch(name, x.dtype)
    return out


def xfer_restrict(x: torch.Tensor, mode: str, G: int) -> torch.Tensor:
    """The G passes of ``mode`` on x (rows, nxp) in one launch: (rows,
    nxp / 2)."""
    if _on_cpu(x):
        return xfer_restrict_plain(x, mode, G)
    _check_xfer(x, mode, G)
    return _launch_xfer(x, RESTRICT_MODES[mode], x.shape[1] // 2, G,
                        "xfer_restrict")


def xfer_prolong(e: torch.Tensor, G: int) -> torch.Tensor:
    """The G passes of the x-prolongation on e (rows, nxcp) in one
    launch: (rows, 2 nxcp)."""
    if _on_cpu(e):
        return xfer_prolong_plain(e, G)
    _check_xfer(e, None, G)
    return _launch_xfer(e, PROLONG, 2 * e.shape[1], G, "xfer_prolong")


def smem_read_bytes(mode: str, rows: int, nxp: int, G: int) -> int:
    """Bytes the kernel of ``mode`` (a restriction mode or "prolong")
    reads from shared memory over its G passes on ``rows`` rows of fine
    width nxp: every lane's window a pass (the scales aside).  The
    shared-memory floor is these bytes over 128 B a clock an SM."""
    nw, u = WINDOWS[mode]
    cols = nxp if mode == "full" else nxp // 2
    return 4 * G * rows * cols // u * nw
