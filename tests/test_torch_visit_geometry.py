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


def pair_threads(sh: int, sw: int):
    """(first column, first strip row) of each thread of a block of the
    bf16 step (visit5p_kernel), which owns NC columns from sx: sx =
    (wid % GX) * 32 NC + NC lane, r0 = (wid / GX) * RS, GX = sw / 32 NC."""
    nc = tmdma.COLS5_PAIR
    gx, rs = sw // (32 * nc), sh // tmdma.STRIPS5_PAIR
    for wid in range(gx * tmdma.STRIPS5_PAIR):
        for lane in range(32):
            yield (wid % gx) * 32 * nc + nc * lane, (wid // gx) * rs


def visit5_cover(R: int, nx: int, h: int, itemsize: int, Rc=None,
                 Cc=None):
    """Times each output row / column and each coarse row / column is
    written by a 5-point visit of halo h over R x nx with Rc coarse rows
    ((R - 1) / 2 for a whole grid; Cc coarse columns likewise) in a
    storage type of ``itemsize`` bytes (2: bf16, whose step owns groups
    of columns).  The kernel's
    conditions are a row test and a column test (xt and ty in range), so
    each axis is counted on its own; the coarse points come from the
    restriction's warp x lane loops."""
    sh, sw = tmdma.visit5_region(h, itemsize)
    nbx, nby, ty_n, tx_n = tmdma.visit5_grid(R, nx, h, itemsize)
    hl = tmdma.visit5_xhalo(h, itemsize)
    pairs = tmdma.visit5_pairs(h, itemsize)
    rs = sh // (tmdma.STRIPS5_PAIR if pairs else tmdma.STRIPS5)
    cols, rows = np.zeros(nx, int), np.zeros(R, int)
    ccols = np.zeros((nx - 1) // 2 if Cc is None else Cc, int)
    crows = np.zeros((R - 1) // 2 if Rc is None else Rc, int)
    if pairs:
        starts = sorted(pair_threads(sh, sw))
        owned = sorted((sx + j, r0) for sx, r0 in starts
                       for j in range(tmdma.COLS5_PAIR))
        # A group's pairs start at even region columns and, the x-halo
        # and the tile being even, lie wholly in or out of the tile.
        assert hl % 2 == 0 and tx_n % 2 == 0
        assert all(sx % 2 == 0 for sx, _ in starts)
    else:
        starts = owned = sorted(threads(sh, sw))
    # Every region point belongs to exactly one thread.
    pts = [(r0 + i, sx) for sx, r0 in owned for i in range(rs)]
    assert len(pts) == len(set(pts)) == sh * sw
    nt = len(starts)
    for bx in range(nbx):
        x0 = bx * tx_n
        for sx in sorted({sx for sx, _ in owned}):
            tx = sx - hl
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


@pytest.mark.parametrize("shape", RAGGED)
def test_visit5_bf16_covers_each_point_once(shape):
    """bf16 storage on a whole grid (a thread per group of columns up to
    V5_PAIR_MAX_H, f32's regions past it): every output point and every
    coarse point once, for every emit and every sweep count up to bf16's
    bound (f32's: 43 steps with emit rc)."""
    ny, nx = shape
    for emit in EMITS:
        for k in range(1, tmdma.max_visit_steps(None, emit, 4) + 1):
            h = tmdma._halo(emit, k)
            cols, rows, ccols, crows = visit5_cover(ny, nx, h, 2)
            assert (cols == 1).all() and (rows == 1).all(), (emit, k)
            assert (ccols == 1).all() and (crows == 1).all(), (emit, k)


# K17's bf16 blocks (R, C): row blocks (C = nxg, odd: every level is
# 2^m - 1 wide) and 2-D blocks of 2x2, 2x1 (an odd row stride) and 1x2
# (an odd row count) cuts.
BF16_BLOCKS = ((2048, 8191), (280, 1119), (32, 63), (8, 33), (4096, 4096),
               (4096, 8191), (8191, 4096), (64, 127), (127, 64))


@pytest.mark.parametrize("block", BF16_BLOCKS)
def test_visit5_bf16_blocks_cover_once(block):
    """K17's bf16 blocks: each of a block's rows, columns, coarse rows and
    coarse columns (R / 2, C / 2: the floor on an axis not split) once,
    for every emit and every sweep count up to bf16's bound whose halo
    the block carries (h <= R and C)."""
    R, C = block
    for emit in ("u", "ur", "r", "rc"):
        for k in range(1, tmdma.max_visit_steps(None, emit, 4) + 1):
            h = tmdma._halo(emit, k)
            if h > min(R, C):
                break
            cols, rows, ccols, crows = visit5_cover(
                R, C, h, 2, Rc=R // 2, Cc=C // 2)
            assert (cols == 1).all() and (rows == 1).all(), (emit, k)
            assert (ccols == 1).all() and (crows == 1).all(), (emit, k)
            if tmdma.visit5_pairs(h, 2):
                # The restriction's footprint pair at tile column TX (TX
                # and TX + 1) lies inside the region.
                sw = tmdma.visit5_region(h, 2)[1]
                hl = tmdma.visit5_xhalo(h, 2)
                assert sw - 2 * hl + 1 + hl <= sw - 1


def block_point(ly: int, lx: int, R: int, C: int, hn: int, hx: int):
    """(buffer, row, column) that holds a block's local point (ly, lx), as
    the kernel's Column / block_at find it, or None past the halos: the
    block (C wide), the left and right buffers (hx wide), the top and
    bottom buffers (C + 2 hx wide, the corners included)."""
    if 0 <= ly < R:
        if 0 <= lx < C:
            return "mid", ly, lx
        if -hx <= lx < 0:
            return "left", ly, lx + hx
        if C <= lx < C + hx:
            return "right", ly, lx - C
        return None
    if -hx <= lx < C + hx:
        if -hn <= ly < 0:
            return "top", ly + hn, lx + hx
        if R <= ly < R + hn:
            return "bot", ly - R, lx + hx
    return None


def pair_loads(R, C, row0, col0, nyg, nxg, hx, h, bases):
    """The loads of b a bf16 K17 visit of halo h makes (visit5p_kernel),
    CUDA block by CUDA block: ((by, bx), buffer, element address, width)
    with each buffer's first element at ``bases[buffer]``.  A thread's
    group of columns loads pair by pair: a pair (both columns inside the
    domain and in one buffer) is one 2-wide load where its address is
    even (4-byte aligned), else two 1-wide loads; any other pair loads
    each of its columns on its own."""
    widths = {"mid": C, "left": hx, "right": hx, "top": C + 2 * hx,
              "bot": C + 2 * hx}
    sh, sw = tmdma.visit5_region(h, 2)
    hl = tmdma.visit5_xhalo(h, 2)
    nbx, nby, ty, tx = tmdma.visit5_grid(R, C, h, 2)
    rs = sh // tmdma.STRIPS5_PAIR
    loads = []
    for by in range(nby):
        for bx in range(nbx):
            y0, x0 = by * ty, bx * tx
            # Each pair of each thread's group of columns.
            for sx, r0 in ((s0 + j, r) for s0, r in pair_threads(sh, sw)
                           for j in range(0, tmdma.COLS5_PAIR, 2)):
                lx = x0 - hl + sx
                gx = col0 + lx
                in1 = 0 <= gx and gx + 1 < nxg
                pair = in1 and (0 <= lx and lx + 1 < C
                                or -hx <= lx and lx + 1 < 0
                                or C <= lx and lx + 1 < C + hx)
                for i in range(rs):
                    ly = y0 - h + r0 + i
                    if not 0 <= row0 + ly < nyg:
                        continue
                    for j in ((0,) if pair else (0, 1)):
                        if not 0 <= gx + j < nxg:
                            continue
                        pt = block_point(ly, lx + j, R, C, h, hx)
                        if pt is None:
                            continue
                        buf, row, col = pt
                        a = bases[buf] + row * widths[buf] + col
                        if pair and a % 2 == 0:
                            loads.append(((by, bx), buf, a, 2))
                        elif pair:
                            loads += [((by, bx), buf, a, 1),
                                      ((by, bx), buf, a + 1, 1)]
                        else:
                            loads.append(((by, bx), buf, a, 1))
    return loads, widths


# (R, C, row0, col0, nyg, nxg, 2-D): row blocks of odd width (63^2 on 2
# blocks, 255^2 on 4), and 2-D blocks: 2x2 of 63^2, a 2x1 cut of 127^2
# (an odd row stride), a 1x2 cut of 127^2.
PAIR_CUTS = ((32, 63, 32, 0, 63, 63, False), (64, 255, 128, 0, 255, 255,
                                              False),
             (32, 32, 32, 0, 63, 63, True), (32, 32, 0, 32, 63, 63, True),
             (64, 127, 64, 0, 127, 127, True), (127, 64, 0, 64, 127, 127,
                                                True))


@pytest.mark.parametrize("odd", [False, True])
@pytest.mark.parametrize("cut", PAIR_CUTS)
def test_bf16_pair_loads_aligned_and_once(cut, odd):
    """The bf16 step's loads of b, mirrored from its rule: each point the
    region reads (inside the domain and the halo buffers) is read exactly
    once in each CUDA block; every 2-wide (__nv_bfloat162) load is 4-byte
    aligned and holds two neighbouring points of one buffer row, with the
    buffers' first elements aligned or not (``odd``: a view at an odd
    element offset), at every halo the bf16 step takes."""
    R, C, row0, col0, nyg, nxg, two_d = cut
    bases = {name: (2 * i + 1 if odd else 2 * i) * 10**6
             for i, name in enumerate(("mid", "left", "right", "top",
                                       "bot"))}
    for h in range(1, tmdma.V5_PAIR_MAX_H + 1):
        if h > min(R, C):
            break
        hx = h if two_d else 0
        loads, widths = pair_loads(R, C, row0, col0, nyg, nxg, hx, h, bases)
        seen = {}
        for blk, buf, a, w in loads:
            if w == 2:
                assert a % 2 == 0, (h, buf, a)
                # Both values in one row of the buffer.
                assert (a - bases[buf]) % widths[buf] + 1 < widths[buf]
            for x in range(a, a + w):
                seen[(blk, buf, x)] = seen.get((blk, buf, x), 0) + 1
        assert max(seen.values()) == 1, h
        # The points each CUDA block needs: its region's points inside the
        # domain and the buffers.
        sh, sw = tmdma.visit5_region(h, 2)
        hl = tmdma.visit5_xhalo(h, 2)
        nbx, nby, ty, tx = tmdma.visit5_grid(R, C, h, 2)
        want = set()
        for by in range(nby):
            for bx in range(nbx):
                for ly in range(by * ty - h, by * ty - h + sh):
                    for lx in range(bx * tx - hl, bx * tx - hl + sw):
                        pt = block_point(ly, lx, R, C, h, hx)
                        if (pt is None or not 0 <= row0 + ly < nyg
                                or not 0 <= col0 + lx < nxg):
                            continue
                        buf, row, col = pt
                        want.add(((by, bx), buf,
                                  bases[buf] + row * widths[buf] + col))
        assert set(seen) == want, h


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


@pytest.mark.parametrize("name", ["short", "tall", "rule", "apply9",
                                  "pair"])
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
    elif name == "pair":
        # Region5P<W / (32 NC), GY, RS, NC>: RS * GY rows, W columns, NC
        # a thread; the rule on H and the even x-halo.
        nc, gy, rs = _cuh_int(
            text, r"constexpr int V5P_NC = (\d+), V5P_GY = (\d+), "
                  r"V5P_RS = (\d+);")
        (w,) = _cuh_int(text, r"using V5Pair = Region5P<(\d+) / \(32 \* "
                              r"V5P_NC\), V5P_GY, V5P_RS, V5P_NC>;")
        assert (rs * gy, w) == tmdma.REGION5_PAIR
        assert (nc, gy) == (tmdma.COLS5_PAIR, tmdma.STRIPS5_PAIR)
        assert _cuh_int(text, r"constexpr int V5_PAIR_MAX_H = (\d+);") == (
            tmdma.V5_PAIR_MAX_H,)
        assert "return H + (H & 1);" in text
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
