"""The launch geometry of the 5-point strip visit and of K12's strip
kernel (``csrc/visit.cuh`` visit5_kernel, apply9_kernel), mirrored in
Python from the kernels' index arithmetic: which region a visit of halo
H takes, its tile and blocks, which points each thread of a block owns,
and which outputs and coarse points it writes.  The mirror is held to
cover every output point and every coarse point of the restriction
exactly once, on ragged shapes and for every sweep count up to each
storage type's bound, and every path's sweep count to fit its region.
No card is needed: the mirror runs on the CPU with numpy.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from multigrid_petsc_tpu_torch.ops.cuda import mdma_kernel as tmdma

torch.set_num_threads(2)

RAGGED = ((1025, 1025), (8191, 1025), (33, 33), (31, 31), (7, 7))
EMITS = ("u", "ur", "r", "rc")


def threads(sh: int, sw: int):
    """(column, first strip row) of each thread of a block, as the kernel
    forms them from its warp and lane: sx = (wid % GX) * 32 + lane,
    r0 = (wid / GX) * RS."""
    gx, rs = sw // 32, sh // tmdma.STRIPS5
    for wid in range(gx * tmdma.STRIPS5):
        for lane in range(32):
            yield (wid % gx) * 32 + lane, (wid // gx) * rs


def visit5_cover(R: int, nx: int, h: int, itemsize: int, Rc=None):
    """Times each output row / column and each coarse row / column is
    written by a 5-point visit of halo h over R x nx with Rc coarse rows
    ((R - 1) / 2 for a whole grid).  The kernel's
    conditions are a row test and a column test (xt and ty in range), so
    each axis is counted on its own; the coarse points come from the
    restriction's warp x lane loops."""
    sh, sw = tmdma.visit5_region(h, itemsize)
    nbx, nby, ty_n, tx_n = tmdma.visit5_grid(R, nx, h, itemsize)
    rs = sh // tmdma.STRIPS5
    cols, rows = np.zeros(nx, int), np.zeros(R, int)
    ccols = np.zeros((nx - 1) // 2, int)
    crows = np.zeros((R - 1) // 2 if Rc is None else Rc, int)
    owned = sorted(threads(sh, sw))
    # Every region point belongs to exactly one thread.
    pts = [(r0 + i, sx) for sx, r0 in owned for i in range(rs)]
    assert len(pts) == len(set(pts)) == sh * sw
    nt = len(owned)
    for bx in range(nbx):
        x0 = bx * tx_n
        for sx in sorted({sx for sx, _ in owned}):
            tx = sx - h
            if 0 <= tx < tx_n and x0 + tx < nx:
                cols[x0 + tx] += 1
        for cx in range(tx_n // 2):  # lanes, then 32 apart
            J = x0 // 2 + cx
            if J < len(ccols):
                ccols[J] += 1
                # The footprint (fine 2cx .. 2cx + 2 of the tile) was
                # written: columns tx in [0, tx_n].
                assert 2 * cx + 2 <= tx_n
    for by in range(nby):
        y0 = by * ty_n
        for sy in range(sh):
            ty = sy - h
            if 0 <= ty < ty_n and y0 + ty < R:
                rows[y0 + ty] += 1
        for wid in range(nt // 32):
            for cy in range(wid, ty_n // 2, nt // 32):
                I = y0 // 2 + cy
                if I < len(crows):
                    crows[I] += 1
                    assert 2 * cy + 2 <= ty_n
    return cols, rows, ccols, crows


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("shape", RAGGED)
def test_visit5_covers_each_point_once(shape, itemsize):
    """Every output point and every coarse point once, for every emit and
    every sweep count up to the bound of the compute type's size (f32 and
    bf16: 4 bytes; f64: 8)."""
    ny, nx = shape
    for emit in EMITS:
        for k in range(1, tmdma.max_visit_steps(None, emit, itemsize) + 1):
            h = tmdma._halo(emit, k)
            cols, rows, ccols, crows = visit5_cover(ny, nx, h, itemsize)
            assert (cols == 1).all() and (rows == 1).all(), (emit, k)
            assert (ccols == 1).all() and (crows == 1).all(), (emit, k)


@pytest.mark.parametrize("R", [2048, 1026, 34, 8])
def test_visit5_row_blocks_cover_once(R):
    """K17's row blocks (R local rows, the pad row among them): each of
    the block's rows and coarse rows once, at every halo a block of R rows
    carries (h <= R)."""
    for emit in ("u", "ur", "rc"):
        for k in range(1, tmdma.max_visit_steps(None, emit, 4) + 1):
            h = tmdma._halo(emit, k)
            if h > R:
                break
            _, rows, _, crows = visit5_cover(R, 33, h, 4, Rc=R // 2)
            assert (rows == 1).all(), (emit, k)
            # The block's R / 2 coarse rows (the kernel writes I < Rc).
            assert (crows == 1).all(), (emit, k)


def test_visit5_region_rule():
    """The region follows h alone (and the compute type): short up to
    V5_SHORT_MAX_H, tall past it in f32; f64 always short.  Each region's
    tile keeps at least 2 rows and columns at every halo its type
    admits, and its partials are its blocks."""
    short, tall = tmdma.REGION5_SHORT, tmdma.REGION5_TALL
    edge = tmdma.V5_SHORT_MAX_H
    assert tmdma.visit5_region(edge, 4) == short
    assert tmdma.visit5_region(edge + 1, 4) == tall
    assert tmdma.visit5_region(edge + 1, 8) == short
    for size in (4, 8):
        hmax = tmdma._halo("u", tmdma.max_visit_steps(None, "u", size))
        for h in range(1, hmax + 1):
            sh, sw = tmdma.visit5_region(h, size)
            assert min(sh, sw) - 2 * h >= 2, (size, h)
            nbx, nby, ty, tx = tmdma.visit5_grid(8191, 8191, h, size)
            assert (ty, tx) == (sh - 2 * h, sw - 2 * h)
            assert nbx * tx >= 8191 > (nbx - 1) * tx
            assert nby * ty >= 8191 > (nby - 1) * ty


class _Lib:
    """The library's partial-count entries, recording how they are asked."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return len(self.calls)
        return entry


@pytest.mark.parametrize("size", [4, 8])
def test_visit_partials_route(size):
    """A 5-point visit's dot partials are counted by its own entry, asked
    with the halo and the compute type's size (its region follows both),
    not by K1's tile (mg_visit_blocks); a 9-point visit's by its own."""
    lib = _Lib()
    for h in (3, 5, 12, 13, 25):
        tmdma.visit_partials(lib, None, 1025, 1023, h, size)
    tmdma.visit_partials(lib, ((False, False),) * 9, 9, 7, 3)
    assert lib.calls == [("mg_visit5_blocks", (1025, 1023, h, size))
                         for h in (3, 5, 12, 13, 25)] + [
        ("mg_visit9_blocks", (9, 7, 3))]


def _cuh_int(text: str, pattern: str) -> tuple[int, ...]:
    m = re.search(pattern, text)
    assert m is not None, pattern
    return tuple(int(g) for g in m.groups())


@pytest.mark.parametrize("name", ["short", "tall", "rule", "apply9"])
def test_mirror_matches_visit_cuh(name):
    """The mirror's constants are the kernels': read from the source the
    card builds (Region5<GX, GY, RS> gives a region of RS * GY rows and
    32 * GX columns; apply9_kernel's tile is A9_RS * A9_GY rows and
    32 * A9_GX columns)."""
    text = (Path(tmdma.__file__).resolve().parents[2] / "csrc"
            / "visit.cuh").read_text()
    if name in ("short", "tall"):
        alias = "V5Short" if name == "short" else "V5Tall"
        gx, gy, rs = _cuh_int(
            text, rf"using {alias} = Region5<(\d+), (\d+), (\d+)>;")
        want = tmdma.REGION5_SHORT if name == "short" else tmdma.REGION5_TALL
        assert (rs * gy, 32 * gx) == want
        assert gy == tmdma.STRIPS5
    elif name == "rule":
        assert _cuh_int(text, r"constexpr int V5_SHORT_MAX_H = (\d+);") == (
            tmdma.V5_SHORT_MAX_H,)
        assert "sizeof(C) == 4 && H > V5_SHORT_MAX_H" in text
    else:
        (rs,) = _cuh_int(text, r"constexpr int A9_RS = (\d+);")
        (gx,) = _cuh_int(text, r"constexpr int A9_GX = (\d+);")
        (gy,) = _cuh_int(text, r"constexpr int A9_GY = (\d+);")
        assert rs == tmdma.A9_ROWS
        assert (rs * gy, 32 * gx) == tmdma.A9_TILE


@pytest.mark.parametrize("size", [4, 8])
@pytest.mark.parametrize("emit", EMITS)
def test_every_path_sweep_count_fits(emit, size):
    """The sweep counts the paths give a 5-point visit (v = (3, 3) and
    Chebyshev's 3, v = (8, 8) on the fused route and -v 8,8, K17's blocks,
    phase 2's k = 32 in f32) are admitted by the bound and run in a region
    whose tile holds their halo."""
    most = tmdma.max_visit_steps(None, emit, size)
    for k in (1, 3, 8, 32 if size == 4 else 23):
        if k > most:
            assert size == 8 and emit != "rc", (emit, size, k)
            continue
        h = tmdma._halo(emit, k)
        assert tmdma.visit_fits(None, h, size)
        sh, sw = tmdma.visit5_region(h, size)
        assert sh - 2 * h >= 2 and sw - 2 * h >= 2


def apply9_cover(R: int, nx: int):
    """Times each point is written by K12's strip kernel: a warp per 32
    columns, a thread per A9_ROWS rows of its column (the last strip cut
    at R)."""
    ty, tx = tmdma.A9_TILE
    gx, gy = tx // 32, ty // tmdma.A9_ROWS
    out = np.zeros((R, nx), int)
    for by in range(-(-R // ty)):
        for bx in range(-(-nx // tx)):
            for wid in range(gx * gy):
                xw = bx * tx + (wid % gx) * 32
                ly0 = by * ty + (wid // gx) * tmdma.A9_ROWS
                if xw >= nx or ly0 >= R:
                    continue
                n = min(tmdma.A9_ROWS, R - ly0)
                cols = [xw + lane for lane in range(32) if xw + lane < nx]
                out[ly0:ly0 + n, cols] += 1
    return out


@pytest.mark.parametrize("shape", RAGGED[:1] + RAGGED[2:] + ((2048, 1025),))
def test_apply9_covers_each_point_once(shape):
    assert (apply9_cover(*shape) == 1).all()
