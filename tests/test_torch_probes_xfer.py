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
Last, the wrappers' constants against ``csrc/probe_xfer.cu``.
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


def test_smem_bytes_and_the_probe_shapes():
    """The shared-memory bytes of the probe's full mode: 12 floats a lane
    a pass for 4 outputs (203 MB over 86 passes); the kernels' tiling
    needs the fine width a multiple of XFER_UNIT, 8192 is."""
    assert xk.smem_read_bytes("full", 48, 8192, 86) == 4 * 86 * 48 * 1024 * 12
    assert 8192 % xk.XFER_UNIT == 0
    for mode, (nw, u) in xk.WINDOWS.items():
        assert nw % 4 == 0 and u in (4, 8), mode


def test_mirrors_match_the_sources():
    """The wrapper's copies of the kernels' constants are
    ``csrc/probe_xfer.cu``'s: the mode numbers (XferMode), apply8's
    steps, the column unit, the pass cap and each mode's window."""
    cu = (Path(xk.__file__).resolve().parents[2] / "csrc" /
          "probe_xfer.cu").read_text()
    names = {"noop": "NOOP", "arith": "ARITH", "shuffle": "SHUFFLE",
             "full": "FULL", "apply8": "APPLY8", "prolong": "PROLONG"}
    for mode, k in {**xk.RESTRICT_MODES, "prolong": xk.PROLONG}.items():
        assert f"{names[mode]} = {k}" in cu, mode
        nw, u = xk.WINDOWS[mode]
        assert (f"template <> struct Window<{names[mode]}> {{\n"
                f"  static constexpr int U = {u}, NW = {nw},") in cu, mode
    assert f"constexpr int APPLY_STEPS = {xk.APPLY_STEPS};" in cu
    assert f"constexpr int XFER_UNIT = {xk.XFER_UNIT};" in cu
    assert f"constexpr int MAX_PASSES = {xk.MAX_PASSES};" in cu
    assert "const int tiled = MODE == FULL ? nxp : nxp / 2;" in cu
