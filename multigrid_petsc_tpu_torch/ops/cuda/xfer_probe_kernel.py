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
is a pass over shared memory inside the visit kernel, so the card's
kernels hold the slab's spans in shared memory, a warp's span at a time,
and run the G passes from there with no barrier (``csrc/probe_xfer.cu``
says how; ``TILING`` and ``xfer_lanes`` mirror its tiling).  The JAX
kernels' order of operations is kept in every mode, so the kernels and
their plain versions agree bit for bit.  No solve runs them.
``xfer_bound`` gives a mode's yardstick from the JAX function's own work;
``smem_read_bytes`` what the kernel's design reads from shared memory.

Each wrapper runs its plain version (``*_plain``) for CPU tensors and
launches its kernel for CUDA tensors (f32; anything else raises), never
falling back, and counts each launch as ``halo_windows``,
``xfer_restrict`` or ``xfer_prolong``.
"""

from __future__ import annotations

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
# nxp must be a multiple of it (probe_xfer.cu XFER_UNIT).
XFER_UNIT = 512
MAX_PASSES = 8192  # passes a launch takes (probe_xfer.cu)
MAX_WARPS = 16  # warps a block (probe_xfer.cu)
SMEM_A_BLOCK = 48 * 1024  # shared bytes a block at most (probe_xfer.cu)
# mode: (K, P, EDGE, OVER) (probe_xfer.cu Tiling<MODE>): a lane takes K
# 16-byte units, 4 K consecutive input columns, a warp 128 K; a turn of
# the pass loop loads P passes' windows; the warp's edge lane reads EDGE
# floats of a halo unit (arith, full: the columns after the span;
# prolong: the one before it); apply8's spans overlap by OVER columns a
# side.  The warps tile half the fine width, full the whole of it.
TILING = {"noop": (1, 4, 0, 0), "arith": (1, 2, 2, 0),
          "shuffle": (2, 4, 0, 0), "full": (2, 2, 1, 0),
          "apply8": (2, 2, 0, APPLY_STEPS), "prolong": (2, 4, 1, 0)}
# Operations a pass makes per output of the JAX function (not of the
# kernel's tiling): x s_i on each input column it takes, the mode's
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


def _launch_xfer(x, mode_id, out_cols, G, name):
    rows, cols = x.shape
    nxp = cols if mode_id != PROLONG else 2 * cols
    if nxp % XFER_UNIT or G > MAX_PASSES:
        raise ValueError(f"{name} needs the fine width a multiple of "
                         f"{XFER_UNIT} and G <= {MAX_PASSES}, got {nxp} "
                         f"and {G}")
    _check_cuda(x.device, {"x": (x, x.shape)})
    out = torch.empty((rows, out_cols), dtype=x.dtype, device=x.device)
    err = load_library().mg_xfer_pass(x.data_ptr(), out.data_ptr(), rows,
                                      nxp, G, mode_id, _stream(x.device))
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


def bound_columns(mode: str, nxp: int) -> int:
    """Input columns of a slab row that a pass of the JAX function reads:
    noop, shuffle and apply8 nxcp, arith nxcp + 2 (its [1, 2, 1] reaches
    two past), full nxp, prolong nxcp - 1 (e's last column is pad)."""
    nxcp = nxp // 2
    return {"noop": nxcp, "shuffle": nxcp, "apply8": nxcp, "arith": nxcp + 2,
            "full": nxp, "prolong": nxcp - 1}[mode]


def xfer_bound(mode: str, rows: int, nxp: int, G: int, rate: float) -> dict:
    """The least time the card could take for ``mode`` (a restriction
    mode or "prolong") over G passes on ``rows`` rows of fine width nxp,
    from the JAX function's own work: the larger of its operations
    (``OPS_PER_OUTPUT`` x outputs x G), one FP32 instruction each (each
    product and sum rounded on its own, none fused), at 128 a clock an SM,
    and the slab's input columns (``bound_columns``) read once a pass from
    shared memory at 128 B a clock an SM.  ``rate``: SMs x 128 x the SM
    clock (``probes.smem_rate``), instructions or bytes a second alike."""
    outputs = rows * (nxp if mode == "prolong" else nxp // 2)
    ops = int(OPS_PER_OUTPUT[mode] * outputs * G)
    nbytes = 4 * rows * bound_columns(mode, nxp) * G
    ops_ms, smem_ms = 1e3 * ops / rate, 1e3 * nbytes / rate
    return {"ops": ops, "bytes": nbytes, "ops_ms": ops_ms,
            "smem_ms": smem_ms, "bound_ms": max(ops_ms, smem_ms),
            "bound_by": ("operations" if ops_ms >= smem_ms
                         else "shared memory")}


def xfer_spans(mode: str, nxp: int) -> tuple[int, int, int]:
    """(spans a row, columns from one span's start to the next, columns a
    span takes) of the kernel's tiling of a row of fine width nxp."""
    k, _, _, over = TILING[mode]
    span = 128 * k
    step = span - 2 * over
    tiled = nxp if mode == "full" else nxp // 2
    return -(-tiled // step), step, span


def lane_outputs(mode: str) -> int:
    """The sums a lane keeps (probe_xfer.cu lane_outputs): one a column
    (noop, arith, apply8; shuffle's evens then odds), one a column pair
    (full), two a column (prolong)."""
    u = 4 * TILING[mode][0]
    return u // 2 if mode == "full" else 2 * u if mode == "prolong" else u


def warp_floats(mode: str) -> int:
    """A warp's shared memory in floats (probe_xfer.cu warp_floats): its
    span and halo unit, or its outputs staged for the stores if more."""
    k, _, edge, _ = TILING[mode]
    return max(128 * k + (4 if edge else 0), 32 * lane_outputs(mode))


def xfer_grid(mode: str, rows: int, nxp: int, sms: int):
    """(blocks, warps a block, warps) of a launch on a card of ``sms`` SMs:
    a warp a span, about one block an SM, at most MAX_WARPS and
    SMEM_A_BLOCK bytes a block (``launch_xfer``)."""
    warps = rows * xfer_spans(mode, nxp)[0]
    cap = min(MAX_WARPS, SMEM_A_BLOCK // (4 * warp_floats(mode)))
    wb = min(max(-(-warps // sms), 1), cap)
    return -(-warps // wb), wb, warps


def xfer_lanes(mode: str, rows: int, nxp: int, sms: int = 132):
    """The kernel's tiling, warp by warp: (block, warp in the block, row,
    a, lanes), a the span's first input column (apply8's may lie before
    the row: its columns wrap on nxcp), lanes[l] a dict of
      units    [(column, slot)]: the lane's K 16-byte units, 4 K
               consecutive input columns from a + 4 K l, and the slot of
               the warp's tile each sits in (lane l's c-th at 32 c + l, so
               that a pass's c-th LDS.128 reads slots 32 c .. 32 c + 31)
      edge     the input columns the lane reads from the halo unit a pass
               (the warp's edge lane; the others take theirs by shuffle)
      shuffle  the input columns it takes from other lanes a pass
      outputs  the output columns whose sums it makes, in its order (not
               apply8's overlap, which the warp does not store)
      stores   the output columns it writes: after the sums are staged in
               the tile in the row's order, a run's (shuffle: the even
               columns' and the odd ones'; one run else) 16-byte units
               32 j + l, j < the units of the run a lane."""
    k, _, edge, over = TILING[mode]
    spans, step, span = xfer_spans(mode, nxp)
    _, wb, warps = xfer_grid(mode, rows, nxp, sms)
    u = 4 * k
    nxcp = nxp // 2
    out_cols = nxp if mode == "prolong" else nxcp
    runs = 2 if mode == "shuffle" else 1
    q = lane_outputs(mode) // 4 // runs  # 16-byte units of a run a lane
    for g in range(warps):
        row, a = g // spans, (g % spans) * step - over
        lanes = []
        for lane in range(32):
            j0 = a + u * lane
            units = [(j0 + 4 * c, 32 * c + lane) for c in range(k)]
            after = [a + span + e for e in range(edge)]  # the next columns
            lane_edge, shuffle = [], []
            if mode in ("arith", "full"):
                if lane == 31:
                    lane_edge = after
                else:
                    shuffle = [j0 + u + e for e in range(edge)]
            elif mode == "prolong":
                if lane == 0:
                    lane_edge = [a - 1]
                else:
                    shuffle = [j0 - 1]
            elif mode == "apply8":  # a column a step, each side
                shuffle = [j0 - 1, j0 + u]
            outputs = []
            for c in range(k):
                col = j0 + 4 * c
                if mode in ("noop", "arith") and col < nxcp:
                    outputs += range(col, col + 4)
                elif mode == "shuffle" and col < nxcp:
                    outputs += [col // 2, col // 2 + 1]
                elif mode == "full" and col < nxp:
                    outputs += [col // 2, col // 2 + 1]
                elif (mode == "apply8" and over <= u * lane + 4 * c
                      < span - over and col < nxcp):
                    outputs += range(col, col + 4)
                elif mode == "prolong" and col < nxcp:
                    outputs += range(2 * col, 2 * col + 8)
            if mode == "shuffle":
                outputs += [nxcp // 2 + o for o in outputs]
            stores = []
            for r in range(runs):
                o0 = {"shuffle": r * nxcp // 2 + a // 2, "full": a // 2,
                      "prolong": 2 * a}.get(mode, a)
                end = (r + 1) * nxcp // 2 if mode == "shuffle" else out_cols
                for j in range(q):
                    unit = 32 * j + lane
                    o = o0 + 4 * unit
                    if o + 4 <= end and (mode != "apply8" or over <= 4 * unit
                                         < span - over):
                        stores += range(o, o + 4)
            lanes.append({"units": units, "edge": lane_edge,
                          "shuffle": shuffle, "outputs": outputs,
                          "stores": stores})
        yield g // wb, g % wb, row, a, lanes


def window_loads(mode: str) -> int:
    """Shared-memory loads a pass of the kernel makes: K LDS.128 and, where
    the mode has a halo, one load of its edge floats."""
    k, _, edge, _ = TILING[mode]
    return k + (1 if edge else 0)


def smem_read_bytes(mode: str, rows: int, nxp: int, G: int) -> int:
    """Bytes the kernel's design reads from shared memory over its G
    passes on ``rows`` rows of fine width nxp: every warp's span and its
    edge floats a pass.  A readout of the design, not the bound
    (``xfer_bound``): apply8's overlapping spans read more, and a
    design that read the slab in another way would read other bytes."""
    k, _, edge, _ = TILING[mode]
    warps = rows * xfer_spans(mode, nxp)[0]
    return G * warps * (512 * k + 4 * edge)
