"""The last three attribution-probe kernels (K18b-W, K18b-R, K18b-P) against
the JAX probes' Pallas kernels on the CPU: each plain version against the
probe's kernel run in interpret mode on the same inputs (numpy, from a
seed).

  K18b-W  ``xfer_probe_kernel.halo_windows_plain`` against
          ``probe_windows_ab.halo_windows_pallas(..., interpret=True)``
          on 255^2 and 383 x 130 inputs, top = bot and not, g above and
          below cdiv(n, stride); and against ``stencil_kernel.
          _halo_windows`` where top = bot and g = cdiv(n, stride), as the
          fused visits call it (``_halo_windows`` leaves its last bottom
          window zero: the rows past the last block)
  K18b-R  ``xfer_restrict_plain`` in every mode against
          ``probe_transpose.make(mode)``
  K18b-P  ``xfer_prolong_plain`` against ``probe_transpose.make_prolong()``

The transfer kernels are built inside ``pltpu.force_tpu_interpret_mode()``
(``make`` takes no interpret flag) with the module's constants cut to
(TH, NXP, NXC, NXCP, G, T2) = (8, 256, 127, 128, 4, 16) and (16, 1024,
511, 512, 3, 16), restored afterwards, and fed numpy inputs in place of
their ``ones``.  Tolerances: the windows are copies, held bit for bit;
full and prolong bit for bit; noop, arith, shuffle and apply8 within 1e-6
of max|JAX|: XLA's CPU compiler contracts a pass's product into the
running sum there (for noop, summing fma(x, s_i, o) reproduces JAX bit
for bit), while the plain versions, like the kernels, round each product
and sum on their own.  The scales: JAX forms 1 + 1e-7 i in f64 with
64-bit types on (as here) and rounds it to f32 once (``pass_scales``).
Then the bound helper's counts against the JAX probe's own shapes, the
kernels' tiling (``xfer_lanes``: every output once, every column read
from shared memory once a pass, the design's bytes) at the probe's shapes
and the smallest width, and a span-level model of the kernels' dataflow
held to the plain versions bit for bit.  Last, the wrappers' constants
against ``csrc/probe_xfer.cu``.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from multigrid_petsc_tpu.ops.pallas import stencil_kernel as jsk
from multigrid_petsc_tpu_torch.ops.cuda import launches
from multigrid_petsc_tpu_torch.ops.cuda import xfer_probe_kernel as xk

torch.set_num_threads(2)

BENCH = Path(__file__).resolve().parents[1] / "benchmarks"


def _load(name: str):
    """``benchmarks/<name>.py`` as a module, its import's side effects on
    JAX's cache settings and on ``sys.argv`` undone."""
    cache = jax.config.jax_compilation_cache_dir
    secs = jax.config.jax_persistent_cache_min_compile_time_secs
    argv = sys.argv
    sys.argv = argv[:1]
    try:
        spec = importlib.util.spec_from_file_location(
            f"_jax_{name}", BENCH / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.argv = argv
        jax.config.update("jax_compilation_cache_dir", cache)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", secs)
    return mod


@pytest.fixture(scope="module")
def jp():
    """The two JAX probes, loaded once."""
    return {n: _load(n) for n in ("probe_windows_ab", "probe_transpose")}


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


SHAPES = [(255, 255), (383, 130)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("case", [(32, 8, 3, 3), (32, 8, 5, 2),
                                  (48, 12, 2, 4), (16, 3, 4, 4)])
def test_halo_windows_plain_matches_pallas(jp, shape, case):
    """(stride, g, top, bot): g above cdiv(n, stride) in (48, 12, ...)
    (the JAX kernel clamps its input block and masks by the unclamped
    row), below it in (16, 3, ...) and at 383 rows in (32, 8, ...)."""
    x = _x(shape, shape[0] + case[0])
    jt, jh = jp["probe_windows_ab"].halo_windows_pallas(
        jnp.asarray(x), *case, interpret=True)
    launches.clear()
    tails, heads = xk.halo_windows(torch.from_numpy(x), *case)
    assert not launches  # the plain version on the CPU
    stride, g, top, bot = case
    assert tails.shape == (g, top, shape[1])
    assert heads.shape == (g, bot, shape[1])
    np.testing.assert_array_equal(tails.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(heads.numpy(), np.asarray(jh))
    nbytes = xk.windows_bytes(*shape, *case)
    nonzero = int((tails.abs().sum(-1) > 0).sum() + (heads.abs().sum(-1)
                                                     > 0).sum())
    assert nbytes == 4 * shape[1] * (g * (top + bot) + nonzero)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("stride, h", [(32, 3), (48, 5)])
def test_halo_windows_plain_matches_visit_windows(shape, stride, h):
    x = _x(shape, 3 * stride + h)
    g = -(-shape[0] // stride)
    jt, jh = jsk._halo_windows(jnp.asarray(x), stride, g, h)
    tails, heads = xk.halo_windows_plain(torch.from_numpy(x), stride, g, h,
                                         h)
    np.testing.assert_array_equal(tails.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(heads.numpy(), np.asarray(jh))


def test_halo_windows_refuses_bad_windows():
    with pytest.raises(ValueError, match="top, bot <= stride"):
        xk.halo_windows(torch.zeros(16, 8), 4, 4, 5, 2)
    with pytest.raises(ValueError, match="mode must be one of"):
        xk.xfer_restrict(torch.zeros(4, 8), "fast", 2)


CUTS = {
    "narrow": dict(TH=8, NXP=256, NXC=127, NXCP=128, G=4, T2=16),
    "wide": dict(TH=16, NXP=1024, NXC=511, NXCP=512, G=3, T2=16),
}
EXACT = {"full", "prolong"}  # else 1e-6 of max|JAX| (see the docstring)


def _built(pt, cut: dict, mode: str | None, seed: int):
    """(JAX's output, the input) of ``make(mode)`` (None:
    ``make_prolong()``) built in interpret mode with the constants cut,
    restored afterwards."""
    old = {k: getattr(pt, k) for k in cut}
    try:
        for k, v in cut.items():
            setattr(pt, k, v)
        with pltpu.force_tpu_interpret_mode():
            call, x0 = pt.make(mode) if mode else pt.make_prolong()
            x = _x(x0.shape, seed)
            out = np.asarray(call(jnp.asarray(x)))
    finally:
        for k, v in old.items():
            setattr(pt, k, v)
    return out, x


def _held(got: torch.Tensor, want: np.ndarray, exact: bool):
    assert got.shape == want.shape
    if exact:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("cut", list(CUTS))
@pytest.mark.parametrize("mode", list(xk.RESTRICT_MODES) + ["prolong"])
def test_xfer_plain_matches_probe_transpose(jp, cut, mode):
    c = CUTS[cut]
    pt = jp["probe_transpose"]
    want, x = _built(pt, c, None if mode == "prolong" else mode,
                     len(mode) + c["NXP"])
    launches.clear()
    if mode == "prolong":
        assert x.shape == (c["T2"] // 2 + 1, c["NXCP"])
        got = xk.xfer_prolong(torch.from_numpy(x), c["G"])
    else:
        assert x.shape == (c["TH"], c["NXP"])
        got = xk.xfer_restrict(torch.from_numpy(x), mode, c["G"])
    assert not launches  # the plain versions on the CPU
    _held(got, want, mode in EXACT)
    assert pt.TH == 48 and pt.NXP == 8192 and pt.G == 86  # restored


def test_jax_noop_sums_by_fma(jp):
    """Why noop is held within 1e-6 and not bit for bit: JAX's CPU run of
    ``make("noop")`` equals the sum formed as o = fma(x, s_i, o) (the
    product exact in f64, one rounding to f32 a pass), not the plain
    version's rounded product added to o."""
    c = CUTS["narrow"]
    want, x = _built(jp["probe_transpose"], c, "noop", 7)
    o = np.zeros((c["TH"], c["NXCP"]), np.float32)
    for s in xk.pass_scales(c["G"]).numpy():
        o = (o.astype(np.float64)
             + x[:, :c["NXCP"]].astype(np.float64) * np.float64(s)
             ).astype(np.float32)
    np.testing.assert_array_equal(o, want)


def test_pass_scales_are_jax_s():
    """s_i = f32(1 + 1e-7 i) formed in f64: at the probe's 86 passes the
    f32-formed 1 + 1e-7 i is the same number."""
    s = xk.pass_scales(86).numpy()
    i = np.arange(86, dtype=np.float32)
    np.testing.assert_array_equal(s, np.float32(1.0) + np.float32(1e-7) * i)
    assert s[0] == 1.0 and s.dtype == np.float32


def test_pass_scales_integer_form():
    """The kernels form s_i in integers (probe_xfer.cu pass_scale): its
    f32 bits are 1.0f's plus round(65536 i / 78125) = (131072 i + 78125)
    // 156250, which one 64-bit product gives, (i M + 2^31) >> 32 with M
    = round(2^32 65536 / 78125); for every i < MAX_PASSES bit for bit
    ``pass_scales``."""
    m = round(2**32 * 65536 / 78125)
    assert m == 3602879702 and m < 2**32
    i = np.arange(xk.MAX_PASSES, dtype=np.uint64)
    k = (i * np.uint64(m) + np.uint64(2**31)) >> np.uint64(32)
    np.testing.assert_array_equal(k, (131072 * i + 78125) // 156250)
    np.testing.assert_array_equal(
        xk.pass_scales(xk.MAX_PASSES).numpy().view(np.uint32),
        np.uint32(0x3F800000) + k.astype(np.uint32))
    cu = (Path(xk.__file__).resolve().parents[2] / "csrc" /
          "probe_xfer.cu").read_text()
    assert ("((unsigned long long)i * 3602879702ull + 2147483648ull) >> 32"
            in cu)


def test_smem_bytes_and_the_probe_shapes():
    """The shared-memory bytes the design reads at the probe's full mode:
    1536 warps of 64 lanes' columns (two 16-byte units a lane) and one
    edge float a pass (135.8 MB over 86 passes, against the 135.3 MB of
    the slab's columns once a pass); the kernels' tiling needs the fine
    width a multiple of XFER_UNIT, 8192 is."""
    assert xk.smem_read_bytes("full", 48, 8192, 86) == (
        86 * 48 * 32 * (512 * 2 + 4))
    assert 8192 % xk.XFER_UNIT == 0
    for mode, (k, p, edge, over) in xk.TILING.items():
        assert k in (1, 2, 4, 8) and p in (1, 2, 3, 4), mode
        assert edge == {"arith": 2, "full": 1, "prolong": 1}.get(mode, 0)
        assert over == (xk.APPLY_STEPS if mode == "apply8" else 0), mode
        # every mode's spans fit the smallest width's slab whole or cut
        assert xk.xfer_spans(mode, xk.XFER_UNIT)[0] >= 1, mode


def test_mirrors_match_the_sources():
    """The wrapper's copies of the kernels' constants are
    ``csrc/probe_xfer.cu``'s: the mode numbers (XferMode), apply8's
    steps, the column unit, the pass cap, the warps a block and each
    mode's tiling (Tiling<MODE>)."""
    cu = (Path(xk.__file__).resolve().parents[2] / "csrc" /
          "probe_xfer.cu").read_text()
    names = {"noop": "NOOP", "arith": "ARITH", "shuffle": "SHUFFLE",
             "full": "FULL", "apply8": "APPLY8", "prolong": "PROLONG"}
    for mode, k in {**xk.RESTRICT_MODES, "prolong": xk.PROLONG}.items():
        assert f"{names[mode]} = {k}" in cu, mode
        kk, p, edge, over = xk.TILING[mode]
        over_txt = "APPLY_STEPS" if mode == "apply8" else str(over)
        assert (f"template <> struct Tiling<{names[mode]}> {{\n"
                f"  static constexpr int K = {kk}, P = {p}, EDGE = {edge}, "
                f"OVER = {over_txt};") in cu, mode
    assert f"constexpr int APPLY_STEPS = {xk.APPLY_STEPS};" in cu
    assert f"constexpr int XFER_UNIT = {xk.XFER_UNIT};" in cu
    assert f"constexpr int MAX_PASSES = {xk.MAX_PASSES};" in cu
    assert f"constexpr int MAX_WARPS = {xk.MAX_WARPS};" in cu
    assert f"constexpr int SMEM_A_BLOCK = {xk.SMEM_A_BLOCK // 1024} * 1024;" \
        in cu
    assert "const int tiled = MODE == FULL ? nxp : nxp / 2;" in cu
    assert "constexpr int SPAN = 128 * T::K, STEP = SPAN - 2 * T::OVER;" in cu
    assert "tile[32 * (u % K) + u / K]" in cu  # unit u's slot


# ---- the bound and the kernels' tiling


@pytest.mark.parametrize("mode", list(xk.RESTRICT_MODES) + ["prolong"])
def test_bound_counts_the_probe_functions_work(jp, mode):
    """``xfer_bound``'s operations and bytes, worked out from the JAX
    probe's own shapes: (TH, NXP) restricted to (TH, NXCP), prolong's
    (T2 / 2 + 1, NXCP) to (T2 / 2 + 1, NXP), G passes; each output's
    operations (a scale per input column it takes, the mode's products
    and sums, the running sum's add), the input columns read once a
    pass.  At 132 SMs and 1.98 GHz: noop, shuffle and full bind by shared
    memory, arith, apply8 and prolong by operations."""
    pt = jp["probe_transpose"]
    th, nxp, nxcp, g = pt.TH, pt.NXP, pt.NXCP, pt.G
    assert nxcp == nxp // 2
    rows = pt.T2 // 2 + 1 if mode == "prolong" else th
    outputs = rows * (nxp if mode == "prolong" else nxcp)
    per_output = {"noop": 1 + 1, "shuffle": 1 + 1,
                  "arith": 1 + 3 + 1,            # v + 2 v1 + v2
                  "full": 2 + 4 + 1,             # 0.0625 (v + 2 v1 + v2)
                  "apply8": 1 + 4 * 8 + 1,       # 8 x (0.99 r + 0.01 (l + r))
                  "prolong": 0.5 + 1 + 1}[mode]  # (an even 2, an odd 0) / 2
    cols = {"noop": nxcp, "shuffle": nxcp, "apply8": nxcp,
            "arith": nxcp + 2, "full": nxp, "prolong": nxcp - 1}[mode]
    rate = 132 * 128 * 1.98e9
    b = xk.xfer_bound(mode, rows, nxp, g, rate)
    assert b["ops"] == per_output * outputs * g
    assert b["bytes"] == 4 * rows * cols * g
    assert b["bound_ms"] == max(b["ops_ms"], b["smem_ms"])
    assert b["ops_ms"] == pytest.approx(1e3 * b["ops"] / rate)
    assert b["bound_by"] == ("shared memory" if mode in ("noop", "shuffle",
                                                         "full")
                             else "operations")
    assert xk.bound_columns(mode, nxp) == cols


SHAPES_XFER = [("probe", None), ("one row", (1, xk.XFER_UNIT)),
               ("5 rows", (5, xk.XFER_UNIT)), ("57 x 1024", (57, 1024))]


def _shape(jp, mode, shape):
    """(rows, nxp) of a case: the probe's own, or the one given."""
    if shape is not None:
        return shape
    pt = jp["probe_transpose"]
    return (pt.T2 // 2 + 1 if mode == "prolong" else pt.TH), pt.NXP


@pytest.mark.parametrize("case", [s for s, _ in SHAPES_XFER])
@pytest.mark.parametrize("mode", list(xk.RESTRICT_MODES) + ["prolong"])
def test_tiling_makes_each_output_once(jp, mode, case):
    """``xfer_lanes`` at the probe's shapes and at the smallest width the
    wrapper takes: every output made exactly once; each warp's K units
    a lane are its span's columns, each read once a pass, lane l's c-th
    unit in slot 32 c + l (a pass's c-th LDS.128 reads 512 contiguous
    bytes); a lane's shuffled columns are other lanes' of its warp, its
    edge columns the halo unit's; every input column the function reads
    is read from shared memory a pass; every output is stored once, by
    the warp that makes it, a run's 16-byte unit n by lane n mod 32
    (coalesced); the design's bytes are ``smem_read_bytes`` (what the
    probe prints); about one block an SM, within 48 KB."""
    rows, nxp = _shape(jp, mode, dict(SHAPES_XFER)[case])
    nxcp = nxp // 2
    k, p, edge, over = xk.TILING[mode]
    span = 128 * k
    out_cols = nxp if mode == "prolong" else nxcp
    made = np.zeros((rows, out_cols), np.int64)
    written = np.zeros((rows, out_cols), np.int64)
    read = np.zeros((rows, nxp + 8), bool)  # columns read a pass, wrapped
    nbytes, warps = 0, set()
    blocks, wb, nwarps = xk.xfer_grid(mode, rows, nxp, 132)
    for block, w, row, a, lanes in xk.xfer_lanes(mode, rows, nxp):
        warps.add((block, w))
        cols, slots = [], []
        for lane in lanes:
            for col, slot in lane["units"]:
                cols += range(col, col + 4)
                slots.append(slot)
        assert cols == list(range(a, a + span))  # the span, once, in order
        assert sorted(slots) == list(range(32 * k))
        for c in range(k):  # the c-th load: slots 32 c .. 32 c + 31
            assert [ln["units"][c][1] for ln in lanes] == list(
                range(32 * c, 32 * c + 32))
        owned = set(cols)
        for i, lane in enumerate(lanes):
            if mode != "apply8":
                assert set(lane["shuffle"]) <= owned
            assert bool(lane["edge"]) == (
                edge > 0 and i == (0 if mode == "prolong" else 31))
            for col in lane["outputs"]:
                made[row, col] += 1
            if mode == "apply8":  # stored outputs clear of the edge lanes
                stored = [col for col, _ in lane["units"]
                          if a + over <= col < a + span - over]
                assert len(lane["outputs"]) == 4 * len(
                    [c for c in stored if c < nxcp])
        mine = {c for ln in lanes for c in ln["outputs"]}
        writes = [(c, i) for i, ln in enumerate(lanes) for c in ln["stores"]]
        assert sorted(c for c, _ in writes) == sorted(mine)
        # a run's units, in the row's order, from its first (apply8: the
        # span's first, its overlap unstored) by consecutive lanes
        runs = ([(a // 2, 0), (nxcp // 2 + a // 2, nxcp // 2)]
                if mode == "shuffle" else [({"full": a // 2,
                                             "prolong": 2 * a}.get(mode, a),
                                            0)])
        for c, i in writes:
            written[row, c] += 1
            o0 = max(o for o, lo in runs if c >= lo)
            assert (c - o0) // 4 % 32 == i
        edges = [c for ln in lanes for c in ln["edge"]]
        for c in cols + edges:
            if mode == "apply8":
                read[row, c % nxcp] = True
            elif 0 <= c < nxp + 8:
                read[row, c] = True
        nbytes += 16 * k * 32 + 4 * len(edges)
    assert (made == 1).all() and (written == 1).all()
    assert read[:, :xk.bound_columns(mode, nxp)].all()
    assert len(warps) == nwarps and blocks == -(-nwarps // wb)
    assert wb <= xk.MAX_WARPS and blocks <= 132
    assert 4 * wb * xk.warp_floats(mode) <= xk.SMEM_A_BLOCK
    assert 86 * nbytes == xk.smem_read_bytes(mode, rows, nxp, 86)
    assert xk.window_loads(mode) == k + (edge > 0)


def _fill(mode, row, col, nxp):
    """Column ``col`` of a slab row as the kernel's fill reads it."""
    nxcp = nxp // 2
    if mode == "apply8":
        return row[col % nxcp]
    if mode == "prolong":
        return row[col] if 0 <= col < nxcp - 1 else 0.0
    return row[col] if 0 <= col < nxp else 0.0


def _model(x: torch.Tensor, mode: str, G: int):
    """The kernel's dataflow, warp by warp (``xfer_lanes``'s spans): the
    span gathered by the fill's rules, the mode's arithmetic on each
    lane's 4 K columns with its neighbours' as the shuffles give them
    (an edge lane's from the halo unit; for apply8, the edge lanes' own
    other end, as __shfl_up / __shfl_down return it), the sums in pass
    order and the stores' predicates.  Returns the output and each lane's
    stored columns, in order."""
    nxp = x.shape[1] * (2 if mode == "prolong" else 1)
    nxcp = nxp // 2
    k, _, _, over = xk.TILING[mode]
    u, span = 4 * k, 128 * k
    out = torch.full((x.shape[0], nxp if mode == "prolong" else nxcp),
                     float("nan"))
    stored = []
    for _, _, r, a, _ in xk.xfer_lanes(mode, x.shape[0], nxp):
        row = x[r].tolist()
        raw = torch.tensor([_fill(mode, row, a + m, nxp)
                            for m in range(span)])
        after = torch.tensor([_fill(mode, row, a + span + e, nxp)
                              for e in range(2)])
        before = torch.tensor(_fill(mode, row, a - 1, nxp))
        acc = None
        for s in xk.pass_scales(G):
            v = (raw * s).view(32, u)
            if mode == "noop":
                o = v
            elif mode == "shuffle":
                o = torch.cat([v[:, 0::2], v[:, 1::2]], 1)
            elif mode in ("arith", "full"):
                nxt = torch.cat([v[1:, :2], (after * s)[None]], 0)
                t = torch.cat([v, nxt], 1)
                o = t[:, :u] + 2.0 * t[:, 1:u + 1] + t[:, 2:u + 2]
                if mode == "full":
                    o = 0.0625 * o[:, 0::2]
            elif mode == "apply8":
                o = v.clone()
                for _ in range(xk.APPLY_STEPS):
                    prev = torch.cat([o[:1, -1], o[:-1, -1]])[:, None]
                    right = torch.cat([o[1:, 0], o[-1:, 0]])[:, None]
                    ext = torch.cat([prev, o, right], 1)
                    o = 0.99 * o + 0.01 * (ext[:, :-2] + ext[:, 2:])
            else:  # prolong
                p = torch.cat([(before * s)[None], v[:-1, -1]])[:, None]
                t = torch.cat([p, v], 1)
                o = torch.stack([0.5 * (v + t[:, :u]), v], 2).reshape(32,
                                                                     2 * u)
            acc = o if acc is None else acc + o
        for lane in range(32):
            cols, odd = [], []
            for c in range(k):
                col, m = a + u * lane + 4 * c, u * lane + 4 * c
                vals, at = None, None
                if mode in ("noop", "arith") and col < nxcp:
                    at, vals = range(col, col + 4), acc[lane, 4 * c:4 * c + 4]
                elif mode == "shuffle" and col < nxcp:
                    at = [col // 2, col // 2 + 1]
                    vals = acc[lane, 2 * c:2 * c + 2]
                    odd.append((nxcp // 2 + col // 2,
                                acc[lane, u // 2 + 2 * c:u // 2 + 2 * c + 2]))
                elif mode == "full" and col < nxp:
                    at = [col // 2, col // 2 + 1]
                    vals = acc[lane, 2 * c:2 * c + 2].clone()
                    if col == nxp - 4:
                        vals[1] = 0.0
                elif (mode == "apply8" and over <= m < span - over
                      and col < nxcp):
                    at, vals = range(col, col + 4), acc[lane, 4 * c:4 * c + 4]
                elif mode == "prolong" and col < nxcp:
                    at = range(2 * col, 2 * col + 8)
                    vals = acc[lane, 8 * c:8 * c + 8]
                if at is not None:
                    out[r, list(at)] = vals
                    cols += list(at)
            for o, vals in odd:  # shuffle's odd columns after its even ones
                out[r, o:o + 2] = vals
                cols += [o, o + 1]
            stored.append(cols)
    return out, stored


@pytest.mark.parametrize("rows, nxp, G", [(1, 512, 1), (5, 512, 3),
                                          (3, 2048, 2)])
@pytest.mark.parametrize("mode", list(xk.RESTRICT_MODES) + ["prolong"])
def test_tiling_model_is_the_plain_version(mode, rows, nxp, G):
    """The kernel's tiling computes the plain version bit for bit: the
    span-level model of its dataflow (``_model``) at the smallest width,
    on 5 rows, and at a width of several spans (apply8's wrap across
    three overlapping spans, the last one cut), against
    ``xfer_restrict_plain`` / ``xfer_prolong_plain``; each lane's stored
    columns are ``xfer_lanes``'s."""
    x = torch.from_numpy(_x((rows, nxp // 2 if mode == "prolong" else nxp),
                            rows + nxp + len(mode)))
    got, stored = _model(x, mode, G)
    want = (xk.xfer_prolong_plain(x, G) if mode == "prolong"
            else xk.xfer_restrict_plain(x, mode, G))
    assert torch.equal(got, want)
    lanes = [ln["outputs"] for *_, lns in xk.xfer_lanes(mode, rows, nxp)
             for ln in lns]
    assert lanes == stored
