"""The plain version of the port's y-line visit (K15) against the JAX
package's ``line_visit9_pallas`` in interpret mode (f64, CPU), in the
modes ``test_aniso.py`` checks (emit u; the zero-guess rc visit; a
correction with <b, u>; u with its residual), and with x-varying line
coefficients (cc varies with x, where the JAX kernel is not viable)
against ``line_jacobi_sweeps_y`` composed with the transfers.

Tolerance: 1e-12 of the reference's largest entry (the same PCR
recurrence and blend; the residual's O(1/h^2) terms reassociate), dots
1e-10 relative.

The CUDA kernel's segmented Thomas solve (``csrc/line.cu``) cannot run
here; its host-side factors are held to f64 band solves of the same
tridiagonal systems, and a torch model of its algorithm (``_segmented``,
test code) that runs on those factors is held to the plain version and
to the Pallas kernel within TOL_LINE (1e-4 of the largest entry, as
``chip_smoke.py`` holds the kernel on the card), on config 4's nearly
singular lines and on x-varying line coefficients, for levels shorter
than a segment, a multiple of it and not a multiple of it.  The model's
carry pass is the kernel's blocked scan over the segments; it is held to
the serial walk it replaced (1e-12 of the largest carry in f64, TOL_LINE
in f32) on segment counts that do and do not fill the scan's warps, and,
in the rank-spanning layout (row blocks, each with its slice of the
factors and of the carries), to the serial walk and to the plain split
sweep (``line_rows_end_plain``: PCR over the gathered columns).
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigrid_petsc_tpu import problems as jp
from multigrid_petsc_tpu.ops import stencil as jst
from multigrid_petsc_tpu.ops import transfer as jtr
from multigrid_petsc_tpu.ops.pallas import line_kernel as jlk
from multigrid_petsc_tpu_torch import problems as tp
from multigrid_petsc_tpu_torch.ops.cuda import line_kernel as tlk
from multigrid_petsc_tpu_torch.ops.cuda.dist_kernel import Halo
from multigrid_petsc_tpu_torch.ops.stencil import (
    apply_stencil9,
    from_numpy_stencil9,
    off_line_y,
)
from multigrid_petsc_tpu_torch.ops.transfer import prolong_bilinear, restrict_fw

torch.set_num_threads(2)

TOL_LINE = 1e-4
CONFIG4, XVAR = (1.0, 0.0, 100.0, 0.0, 0.0), (1.0, 1.0, 1.0, 2.0, 0.4)


def _setup(shape, prob, seed):
    ny, nx = shape
    j = jlk.collapse_stencil(jp.stencil9_coefficients(
        jp.AnisoProblem(*prob), ny, nx, jnp.float64))
    t = from_numpy_stencil9([np.asarray(c) for c in j], "cpu", torch.float64)
    rng = np.random.default_rng(seed)
    b, u = rng.standard_normal(shape), rng.standard_normal(shape)
    e = rng.standard_normal(((ny - 1) // 2, (nx - 1) // 2))
    return j, t, b, u, e


def _close(got, ref, rtol=1e-12):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rtol * np.abs(ref).max())


def _t(x):
    return None if x is None else torch.as_tensor(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


def _compare(got, ref):
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        if np.ndim(r) == 0:
            assert abs(float(g) - float(r)) <= 1e-10 * abs(float(r))
        else:
            _close(g, r)


# (guess, emit, correct, emit_dot, sweeps): test_aniso.py's modes and more.
MODES = [(True, "u", False, False, 3), (False, "rc", False, False, 3),
         (True, "u", True, True, 2), (True, "ur", False, False, 2),
         (True, "rc", True, False, 1), (False, "u", False, True, 2)]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape,prob", [
    ((127, 127), (1.0, 0.0, 100.0, 0.0, 0.0)),
    ((65, 33), (0.05, 0.0, 1.0, 0.0, 0.3))])
def test_line_visit9_plain_matches_pallas(mode, shape, prob):
    guess, emit, correct, dot, sweeps = mode
    j, t, b, u, e = _setup(shape, prob, sweeps + len(emit))
    assert jlk.line_visit_viable(*shape, jnp.float64, j)
    ref = jlk.line_visit9_pallas(
        j, _j(b), _j(u) if guess else None, sweeps, 0.9, emit=emit,
        e_coarse=_j(e) if correct else None, emit_dot=dot, interpret=True)
    got = tlk.line_visit9(
        t, _t(b), _t(u) if guess else None, sweeps, 0.9, emit=emit,
        e_coarse=_t(e) if correct else None, emit_dot=dot)
    _compare(got, ref)


@pytest.mark.parametrize("emit,correct", [("u", False), ("rc", False),
                                          ("ur", True)])
def test_line_visit9_x_varying_cc_matches_jax_composition(emit, correct):
    """cc varies with x (ax2 != 0): (ny, nx) line coefficients, the case
    the JAX package runs in XLA (``line_jacobi_sweeps_y``)."""
    j, t, b, u, e = _setup((63, 31), (1.0, 1.0, 1.0, 2.0, 0.4), 7)
    assert t.cc.shape == (63, 31)
    assert not jlk.line_visit_viable(63, 31, jnp.float64, j)
    u0 = jnp.asarray(u) + (jtr.prolong_bilinear(jnp.asarray(e)) if correct
                           else 0.0)
    uj = jst.line_jacobi_sweeps_y(j, jnp.asarray(b), u0, 3, 0.8)
    r = jnp.asarray(b) - jst.apply_stencil9(j, uj)
    ref = {"u": uj, "rc": (uj, jtr.restrict_fw(r)), "ur": (uj, r)}[emit]
    got = tlk.line_visit9(t, _t(b), _t(u), 3, 0.8, emit=emit,
                          e_coarse=_t(e) if correct else None)
    _compare(got, ref)


def test_line_factor_on_the_cpu_is_the_pcr_factor():
    """The plain version takes the level's PCR factor, made once; the
    results are those of a factor made per call."""
    _, t, b, u, _ = _setup((65, 33), (1.0, 0.0, 100.0, 0.0, 0.0), 3)
    fac = tlk.line_factor(t, 65)
    assert len(fac.alphas) == 7
    torch.testing.assert_close(
        tlk.line_visit9(t, _t(b), _t(u), 2, 0.8, fac=fac),
        tlk.line_visit9(t, _t(b), _t(u), 2, 0.8), rtol=0, atol=0)


def test_line_visit9_refuses_what_it_lacks():
    _, t, b, u, e = _setup((65, 33), (1.0, 0.0, 100.0, 0.0, 0.0), 0)
    for kw in (dict(emit="r"), dict(emit="rc", emit_dot=True),
               dict(u=None, e_coarse=_t(e)), dict(sweeps=0)):
        args = {"u": _t(u), "sweeps": 2, **kw}
        with pytest.raises(ValueError):
            tlk.line_visit9(t, _t(b), args.pop("u"), args.pop("sweeps"),
                            0.8, **args)
    st = type(t)(*(c.to("meta") for c in t))
    x = torch.empty((65, 33), device="meta")
    with pytest.raises(ValueError):
        tlk.line_visit9(st, x, x, 2, 0.8)


# --------------------------------------------------------------------------
# The CUDA kernel's segmented solve: its factors and a model of it.
# --------------------------------------------------------------------------


def _line_stencil(prob, ny, nx, dtype=torch.float64):
    return tlk.collapse_stencil(tp.stencil9_coefficients(
        tp.AnisoProblem(*prob), ny, nx, dtype, "cpu"))


def _band(a, d, c):
    """The assembled tridiagonal matrix of one line: sub-diagonal a[1:],
    diagonal d, super-diagonal c[:-1]."""
    return np.diag(d) + np.diag(a[1:], -1) + np.diag(c[:-1], 1)


@pytest.mark.parametrize("ny", [7, 63, 64, 1023])
@pytest.mark.parametrize("prob", [CONFIG4, XVAR])
def test_segment_factors_match_band_solves(prob, ny):
    """A segment's responses are solves of its own tridiagonal block,
    whose first pivot is the whole column's (Thomas's elimination of the
    rows above): ``above`` answers the forward carry, entering as
    -a_s0 on the first row, ``below`` the value under the segment,
    entering as -c_s1 on its last; ``end_w`` and ``start_w`` are the last
    and first rows of the block's inverse (solves with its transpose).
    The whole segmented solve (weighted ends, carries with ``gain``,
    fix-up) is the band solve of the column."""
    nx = 33
    st = _line_stencil(prob, ny, nx)
    fac = tlk.segment_factor(st, ny)
    w = fac.m.shape[1]
    assert w == (nx if prob == XVAR else 1)
    seg, nseg = tlk.LINE_SEG, -(-ny // tlk.LINE_SEG)
    assert fac.above.shape == fac.below.shape == (ny, w)
    assert fac.gain.shape == (nseg, w)
    a, d, c = (np.broadcast_to(x.numpy(), (ny, w)) for x in
               (st.cs, st.cc, st.cn))
    m, above, below, end_w, start_w = (x.numpy() for x in (
        fac.m, fac.above, fac.below, fac.end_w, fac.start_w))
    for j in range(w):
        for s in range(nseg):
            s0, s1 = s * seg, min(ny, (s + 1) * seg)
            blk = _band(a[s0:s1, j], d[s0:s1, j], c[s0:s1, j])
            blk[0, 0] = 1.0 / m[s0, j]  # the column's pivot, f64
            n = s1 - s0
            e0, e1 = np.eye(n)[0], np.eye(n)[-1]
            np.testing.assert_allclose(
                above[s0:s1, j], np.linalg.solve(blk, -a[s0, j] * e0),
                rtol=0, atol=1e-13)
            below_ref = (np.linalg.solve(blk, -c[s1 - 1, j] * e1)
                         if s1 < ny else np.zeros(n))
            np.testing.assert_allclose(below[s0:s1, j], below_ref, rtol=0,
                                       atol=1e-13)
            for w_, e in ((end_w, e1), (start_w, e0)):
                np.testing.assert_allclose(
                    w_[s0:s1, j], np.linalg.solve(blk.T, e), rtol=0,
                    atol=1e-13 * np.abs(w_[s0:s1, j]).max())
    # Config 4's line stencil is constant along x: the kernels read every
    # per-row value from one packed row; the x-varying one has no table.
    if prob == CONFIG4:
        assert fac.table.shape == (ny, tlk.TABLE_WIDTH)
        for i, k in enumerate(tlk.TABLE_COLUMNS):
            src = getattr(fac, k, None)
            src = getattr(st, k) if src is None else src
            np.testing.assert_array_equal(
                fac.table[:, i].numpy(),
                torch.broadcast_to(src, (ny, 1))[:, 0].numpy())
        assert not fac.table[:, len(tlk.TABLE_COLUMNS):].any()
    else:
        assert fac.table is None
    rhs = np.random.default_rng(ny).standard_normal((ny, w))
    got = _segmented_solve(torch.as_tensor(rhs), st.cs, fac).numpy()
    for j in range(w):
        ref = np.linalg.solve(_band(a[:, j], d[:, j], c[:, j]), rhs[:, j])
        np.testing.assert_allclose(got[:, j], ref, rtol=0,
                                   atol=1e-10 * np.abs(ref).max())


# csrc/line.cuh's carry launch: warps per block (CW) and segments a thread
# loads at once (CB).
CARRY_WARPS, CARRY_BATCH = 8, 8


def _cut_rows(x, n, nseg, seg, nx):
    """(n, w) rows -> (nseg, seg, nx), zeros past row n."""
    x = torch.broadcast_to(x, (n, nx))
    return torch.cat([x, x.new_zeros(nseg * seg - n, nx)]).reshape(
        nseg, seg, nx)


def _carry_inputs(fac, seg, S, nx):
    """Launch 2's per-segment factors in f64, (S, nx) each: gain, and the
    responses above and below at each segment's first row (0 for a
    segment past the level's rows)."""
    ny = fac.m.shape[0]

    def first_rows(x):
        x = torch.broadcast_to(x, (ny, nx)).double()
        out = x.new_zeros(S, nx)
        real = [s for s in range(S) if s * seg < ny]
        out[real] = x[[s * seg for s in real]]
        return out

    gain = torch.broadcast_to(fac.gain, (fac.gain.shape[0], nx)).double()
    gain = torch.cat([gain, gain.new_zeros(S - gain.shape[0], nx)])[:S]
    return gain, first_rows(fac.above), first_rows(fac.below)


def _carry_serial(ends, starts, gain, above, below, dtype):
    """Launch 2 as the serial walk down each column: C_0 = 0, C_{s+1} =
    ends_s + gain_s C_s, then D_{S-1} = 0, D_{s-1} = starts_s + C_s
    above_s + below_s D_s, in f64 with C_s and D_s stored (and C_s read
    back) rounded to the working type."""
    S, nx = ends.shape
    e, x = ends.double(), starts.double()
    cin = torch.zeros(S, nx, dtype=torch.float64)
    c = torch.zeros(nx, dtype=torch.float64)
    for s in range(S - 1):
        c = e[s] + gain[s] * c
        cin[s + 1] = c.to(dtype).double()
    din = torch.zeros(S, nx, dtype=torch.float64)
    d = torch.zeros(nx, dtype=torch.float64)
    for s in range(S - 1, 0, -1):
        d = x[s] + cin[s] * above[s] + below[s] * d
        din[s - 1] = d
    return cin.to(dtype), din.to(dtype)


def _carry_scan(ends, starts, gain, above, below, dtype, W=CARRY_WARPS):
    """Launch 2 as the kernel's blocked scan (csrc/line.cuh
    ``line_carry_kernel``): W chunks of K segments (K a multiple of the
    load batch, W K >= S; the last chunks may be empty), each composed
    into one affine map (G, E), the chunk maps folded in order to give
    each chunk its true incoming C, each chunk replayed from it -- storing
    C_s rounded to the working type and composing its backward maps
    upwards -- then the backward chunk maps folded from the top to give
    each chunk its true D below, and each chunk replayed down, in f64.
    Returns (cin, din) of every segment."""
    S, nx = ends.shape
    CB = CARRY_BATCH
    K = CB * -(-S // (W * CB))
    chunks = [(min(S, w * K), min(S, w * K + K)) for w in range(W)]
    e, x = ends.double(), starts.double()
    one, zero = torch.ones(nx, dtype=torch.float64), torch.zeros(
        nx, dtype=torch.float64)
    fwd = []
    for a, b in chunks:
        G, E = one, zero
        for s in range(a, min(b, S - 1)):
            E, G = gain[s] * E + e[s], gain[s] * G
        fwd.append((G, E))
    cin = torch.zeros(S, nx, dtype=torch.float64)
    bwd = []
    for w, (a, b) in enumerate(chunks):
        c = zero
        for G, E in fwd[:w]:
            c = G * c + E
        G, E = one, zero
        for s in range(a, b):
            cin[s] = c.to(dtype).double()
            if s >= 1:
                E, G = G * (cin[s] * above[s] + x[s]) + E, G * below[s]
            if s < S - 1:
                c = gain[s] * c + e[s]
        bwd.append((G, E))
    din = torch.zeros(S, nx, dtype=torch.float64)
    for w, (a, b) in enumerate(chunks):
        d = zero
        for G, E in reversed(bwd[w + 1:]):
            d = G * d + E
        for s in range(b - 1, a - 1, -1):
            din[s] = d
            if s >= 1:
                d = below[s] * d + (cin[s] * above[s] + x[s])
    return cin.to(dtype), din.to(dtype)


def _segment_ends(r, end_w, start_w):
    """Launch 1: each segment's zero-carry ends, weighted sums of its
    rows' right-hand sides, (nseg, nx) each."""
    return (end_w * r).sum(1), (start_w * r).sum(1)


def _segment_fix(r, a, m, cp, above, below, cin, din):
    """Launch 3: Thomas's recurrences from zero carries in each segment,
    then x = xl + C above + D below; (nseg, seg, nx) in and out."""
    seg = r.shape[1]
    dp, xl = torch.zeros_like(r), torch.zeros_like(r)
    d = torch.zeros_like(r[:, 0])
    for i in range(seg):
        d = dp[:, i] = (r[:, i] - a[:, i] * d) * m[:, i]
    x = torch.zeros_like(d)
    for i in reversed(range(seg)):
        x = xl[:, i] = dp[:, i] - cp[:, i] * x
    return xl + cin[:, None] * above + din[:, None] * below


def _segmented_solve(rhs, cs, fac, carry=_carry_scan):
    """csrc/line.cu's line solve of every column of rhs (ny, w), as test
    code: each segment's zero-carry ends as weighted sums of its rows
    (launch 1), the carries C (the true dp above each segment) and D (the
    true x below it) by ``carry`` (the kernel's blocked scan, or the
    serial walk), stored in the working type (launch 2), then Thomas's
    recurrences from zero carries in each segment of LINE_SEG rows and
    x = xl + C above + D below (launch 3)."""
    ny, nx = rhs.shape
    seg = tlk.LINE_SEG
    nseg = -(-ny // seg)
    r, a, m, cp, above, below, end_w, start_w = (
        _cut_rows(t, ny, nseg, seg, nx) for t in (
            rhs, cs, fac.m, fac.cp, fac.above, fac.below, fac.end_w,
            fac.start_w))
    ends, starts = _segment_ends(r, end_w, start_w)
    cin, din = carry(ends, starts, *_carry_inputs(fac, seg, nseg, nx),
                     rhs.dtype)
    x = _segment_fix(r, a, m, cp, above, below, cin, din)
    return x.reshape(-1, nx)[:ny]


def _segmented(st, fac, b, u, sweeps, omega, emit="u", e=None, dot=False):
    """A model of the CUDA line visit: the sweeps by ``_segmented_solve``
    on the kernel's factors, then the emits."""
    u = torch.zeros_like(b) if u is None else u
    if e is not None:
        u = u + prolong_bilinear(e)
    for _ in range(sweeps):
        x = _segmented_solve(b - off_line_y(st, u), st.cs, fac)
        u = (1.0 - omega) * u + omega * x
    if emit == "u":
        return (u, torch.sum(b * u)) if dot else u
    r = b - apply_stencil9(st, u)
    return (u, r) if emit == "ur" else (u, restrict_fw(r))


def _within_tol_line(got, ref):
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        g, r = np.asarray(g, np.float64), np.asarray(r, np.float64)
        assert g.shape == r.shape
        if r.ndim == 0:
            assert abs(g - r) <= TOL_LINE * abs(r)
        else:
            np.testing.assert_allclose(g, r, rtol=0,
                                       atol=TOL_LINE * np.abs(r).max())


# (guess, emit, correct, emit_dot, sweeps)
SEG_MODES = [(True, "u", False, False, 3), (False, "rc", False, False, 3),
             (True, "u", True, True, 2), (True, "ur", False, False, 2)]


# Levels shorter than a segment, not a multiple of it, and a multiple of
# it (64 rows: even, so without the transfers, which need odd sizes).
SEG_CASES = [(shape, mode) for shape in ((7, 7), (63, 31), (64, 33),
                                         (1023, 33))
             for mode in SEG_MODES
             if shape[0] % 2 or not (mode[1] == "rc" or mode[2])]


@pytest.mark.parametrize("shape,mode", SEG_CASES)
@pytest.mark.parametrize("prob", [CONFIG4, XVAR])
def test_segmented_model_matches_plain_and_pallas(prob, shape, mode):
    """The model of the kernel's algorithm against ``line_visit9_plain``
    (PCR) and, where the JAX kernel is viable ((ny, 1) line
    coefficients), ``line_visit9_pallas`` in interpret mode."""
    guess, emit, correct, dot, sweeps = mode
    ny, nx = shape
    j, t, b, u, e = _setup((ny, nx), prob, ny + sweeps)
    args = (_t(u) if guess else None, sweeps, 0.9)
    kw = dict(emit=emit, e_coarse=_t(e) if correct else None, emit_dot=dot)
    got = _segmented(t, tlk.segment_factor(t, ny), _t(b), args[0], sweeps,
                     0.9, emit, kw["e_coarse"], dot)
    _within_tol_line(got, tlk.line_visit9_plain(t, _t(b), *args, **kw))
    if jlk.line_visit_viable(ny, nx, jnp.float64, j):
        assert prob == CONFIG4
        ref = jlk.line_visit9_pallas(
            j, _j(b), _j(u) if guess else None, sweeps, 0.9, emit=emit,
            e_coarse=_j(e) if correct else None, emit_dot=dot,
            interpret=True)
        _within_tol_line(got, ref)


@pytest.mark.parametrize("ny,nx", [(63, 31), (1023, 33)])
@pytest.mark.parametrize("prob", [CONFIG4, XVAR])
def test_segmented_solve_is_as_accurate_as_thomas_in_f32(prob, ny, nx):
    """In f32 the segmented solve stays as accurate as the serial Thomas
    recurrence it replaces, on config 4's nearly singular lines too: one
    sweep's error against the f64 sweep, within 2x of Thomas's or of f32
    resolution (1e-6 of the largest entry)."""
    _, t, b, u, _ = _setup((ny, nx), prob, 5)
    t32 = type(t)(*(c.float() for c in t))
    b32, u32 = _t(b).float(), _t(u).float()
    ref = tlk.line_visit9_plain(t, _t(b), _t(u), 1, 0.8)
    seg = _segmented(t32, tlk.segment_factor(t32, ny), b32, u32, 1, 0.8)
    tf = tlk.segment_factor(t32, ny)
    rhs = b32 - off_line_y(t32, u32)
    a, m, cp = (torch.broadcast_to(x, (ny, nx)) for x in (t32.cs, tf.m,
                                                          tf.cp))
    dp, x = torch.zeros_like(rhs), torch.zeros_like(rhs)
    for i in range(ny):
        dp[i] = (rhs[i] - (a[i] * dp[i - 1] if i else 0.0)) * m[i]
    for i in range(ny - 1, -1, -1):
        x[i] = dp[i] - (cp[i] * x[i + 1] if i < ny - 1 else 0.0)
    thomas = 0.2 * u32 + 0.8 * x
    scale = float(ref.abs().max())

    def err(v):
        return float((v.double() - ref).abs().max()) / scale

    assert err(seg) <= max(2 * err(thomas), 1e-6), (err(seg), err(thomas))


# Segment counts of the scan's tests: one segment, two, one chunk short of
# the warps and one past them, and counts whose last chunks are part full
# or empty.
SCAN_SEGMENTS = [1, 2, CARRY_WARPS - 1, CARRY_WARPS + 1, 35, 129]
DTYPES = [pytest.param(torch.float64, id="f64"),
          pytest.param(torch.float32, id="f32")]


def _carry_tol(dtype):
    return 1e-12 if dtype == torch.float64 else TOL_LINE


@pytest.mark.parametrize("S", SCAN_SEGMENTS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("prob", [CONFIG4, XVAR], ids=["config4", "xvar"])
def test_carry_scan_matches_serial_walk(prob, dtype, S):
    """The kernel's carry pass, a blocked scan of affine maps
    (``_carry_scan``), against the serial walk down each column
    (``_carry_serial``) on the segment ends of a level of S segments: the
    scan reorders the f64 roundings only, so its carries are the walk's
    to 1e-12 of the largest in f64, and within TOL_LINE in f32 (a carry
    stored in f32 may round the other way)."""
    seg, nx = tlk.LINE_SEG, 17
    ny = max(1, S * seg - 5)
    st = _line_stencil(prob, ny, nx, dtype)
    fac = tlk.segment_factor(st, ny)
    rng = np.random.default_rng(S)
    rhs = torch.as_tensor(rng.standard_normal((ny, nx))).to(dtype)
    r, end_w, start_w = (_cut_rows(t, ny, S, seg, nx) for t in (
        rhs, fac.end_w, fac.start_w))
    ends, starts = _segment_ends(r, end_w, start_w)
    inputs = (ends, starts, *_carry_inputs(fac, seg, S, nx), dtype)
    for got, want in zip(_carry_scan(*inputs), _carry_serial(*inputs)):
        assert got.dtype == want.dtype == dtype
        np.testing.assert_allclose(
            got.double().numpy(), want.double().numpy(), rtol=0,
            atol=_carry_tol(dtype) * float(want.abs().max()))


def _split_sweep(st, b, u, P, omega, carry):
    """One rank-spanning y-line sweep of (b, u) (ny, nx), its pad row
    appended, cut into P row blocks as the kernel runs it, as test code:
    each block's line right-hand sides (``line_rows_begin_plain``) and
    its segments' zero-carry ends from its rows' slices of the factors
    (launch 1), the ends stacked in rank order (the all-gather), the
    carries of every segment by ``carry`` with the whole level's factors,
    each block's slice of them (launch 2), each block's segments fixed up
    and blended (launch 3).  Returns the stitched (ny + 1, nx) sweep, the
    blocks' plain ``RowLine``s and right-hand sides."""
    ny, nx = b.shape
    R = (ny + 1) // P
    seg = math.gcd(R, tlk.LINE_SEG)
    nseg = R // seg
    fac = tlk.segment_factor(st, ny, seg)
    bp, up = (torch.cat([x, x.new_zeros(1, nx)]) for x in (b, u))
    zero = u.new_zeros(1, nx)
    lfs, rhss, cut = [], [], []
    for p in range(P):
        lf = tlk.row_line(st, ny, R, p * R)
        halo = Halo(up[p * R - 1:p * R] if p else zero,
                    up[(p + 1) * R:(p + 1) * R + 1] if p < P - 1 else zero)
        rhs = tlk.line_rows_begin_plain(lf, bp[p * R:(p + 1) * R],
                                        up[p * R:(p + 1) * R], halo)
        rows = slice(p * R, p * R + lf.nyl)
        cut.append([_cut_rows(torch.broadcast_to(t, (ny, nx))[rows],
                              lf.nyl, nseg, seg, nx)
                    for t in (st.cs, fac.m, fac.cp, fac.above, fac.below,
                              fac.end_w, fac.start_w)])
        lfs.append(lf)
        rhss.append(rhs)
    ends, starts = zip(*(_segment_ends(rhs.reshape(nseg, seg, nx), *c[5:])
                         for rhs, c in zip(rhss, cut)))
    S = P * nseg
    cin, din = carry(torch.cat(ends), torch.cat(starts),
                     *_carry_inputs(fac, seg, S, nx), b.dtype)
    outs = []
    for p, (lf, rhs, c) in enumerate(zip(lfs, rhss, cut)):
        own = slice(p * nseg, (p + 1) * nseg)
        x = _segment_fix(rhs.reshape(nseg, seg, nx), *c[:5], cin[own],
                         din[own]).reshape(R, nx)
        out = torch.zeros_like(x)
        nyl = lf.nyl
        out[:nyl] = (1.0 - omega) * up[p * R:p * R + nyl] + omega * x[:nyl]
        outs.append(out)
    return torch.cat(outs), lfs, rhss


@pytest.mark.parametrize("ny,P", [(63, 2), (127, 4), (255, 2), (1119, 4)],
                         ids=["S2", "S4", "S8", "S140"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("prob", [CONFIG4, XVAR], ids=["config4", "xvar"])
def test_split_carry_scan_matches_serial_walk_and_plain(prob, dtype, ny, P):
    """The rank-spanning layout (P row blocks, each scanning every segment
    of the lines and keeping its own slice of the carries) with the
    kernel's scan: the stitched sweep equals the serial walk's (1e-12 of
    the largest entry in f64, TOL_LINE in f32) and the plain split sweep,
    PCR over the gathered right-hand sides (1e-10 in f64, TOL_LINE in
    f32); the pad row 0."""
    nx = 17
    st = _line_stencil(prob, ny, nx, dtype)
    rng = np.random.default_rng(ny + P)
    b, u = (torch.as_tensor(rng.standard_normal((ny, nx))).to(dtype)
            for _ in range(2))
    got, lfs, rhss = _split_sweep(st, b, u, P, 0.8, _carry_scan)
    serial, _, _ = _split_sweep(st, b, u, P, 0.8, _carry_serial)
    assert bool((got[ny:] == 0).all())
    np.testing.assert_allclose(got.double().numpy(), serial.double().numpy(),
                               rtol=0, atol=_carry_tol(dtype)
                               * float(serial.abs().max()))
    every = torch.cat(rhss)
    R = (ny + 1) // P
    up = torch.cat([u, u.new_zeros(1, nx)])
    plain = torch.cat([tlk.line_rows_end_plain(lf, up[p * R:(p + 1) * R],
                                               every, 0.8)
                       for p, lf in enumerate(lfs)])
    tol = 1e-10 if dtype == torch.float64 else TOL_LINE
    np.testing.assert_allclose(got.double().numpy(), plain.double().numpy(),
                               rtol=0, atol=tol * float(plain.abs().max()))
