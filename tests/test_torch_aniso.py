"""The port's anisotropic 9-point family against the JAX package (f64,
CPU): the problem and its stencil, the 9-point apply, the PCR line solve
and the y-line smoother, ``collapse_stencil``, the carry-over of a
Stencil9, the 9-point dense coarsest operator, and the host-side Thomas
factors that the CUDA line kernel (K15) runs on.

Tolerance: 1e-12 of the reference's largest entry (the O(1/h^2) terms
reassociate; the coefficients themselves match bit for bit).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigrid_petsc_tpu import problems as jp
from multigrid_petsc_tpu.ops import stencil as jst
from multigrid_petsc_tpu.ops.pallas import line_kernel as jlk
from multigrid_petsc_tpu.solvers import coarse as jcoarse
from multigrid_petsc_tpu_torch import problems as tp
from multigrid_petsc_tpu_torch.ops import stencil as tst
from multigrid_petsc_tpu_torch.ops.cuda import line_kernel as tlk
from multigrid_petsc_tpu_torch.solvers import coarse as tcoarse

torch.set_num_threads(2)

PROBS = [(1.0, 0.0, 100.0, 0.0, 0.0), (1.0, 1.0, 1.0, 2.0, 0.4),
         (0.05, 0.0, 1.0, 0.0, 0.0), (1.0, 0.5, 100.0, 0.0, 0.3)]
SHAPES = [(31, 17), (63, 63)]


def _close(got, ref, rtol=1e-12):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rtol * max(np.abs(ref).max(), 1e-300))


def _pair(prob, shape):
    """(JAX Stencil9, port Stencil9) of one problem and grid (f64)."""
    ny, nx = shape
    return (jp.stencil9_coefficients(jp.AnisoProblem(*prob), ny, nx,
                                     jnp.float64),
            tp.stencil9_coefficients(tp.AnisoProblem(*prob), ny, nx,
                                     torch.float64, "cpu"))


@pytest.mark.parametrize("prob", PROBS)
@pytest.mark.parametrize("shape", SHAPES)
def test_stencil9_coefficients_match_jax_bit_for_bit(prob, shape):
    """Every coefficient keeps its broadcast shape: corners (1, 1), cw/ce
    (1, nx), cs/cn (ny, 1), cc a genuine (ny, nx) field."""
    ny, nx = shape
    j, t = _pair(prob, shape)
    want = {"csw": (1, 1), "cs": (ny, 1), "cse": (1, 1), "cw": (1, nx),
            "cc": (ny, nx), "ce": (1, nx), "cnw": (1, 1), "cn": (ny, 1),
            "cne": (1, 1)}
    for name, a, b in zip(tst.Stencil9._fields, j, t):
        assert tuple(b.shape) == want[name] == np.shape(a), name
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("prob", PROBS)
def test_aniso_rhs_and_exact_match_jax(prob):
    ny, nx = 31, 17
    jpb, tpb = jp.AnisoProblem(*prob), tp.AnisoProblem(*prob)
    _close(tp.aniso_rhs_grid(tpb, ny, nx, torch.float64, "cpu"),
           jp.aniso_rhs_grid(jpb, ny, nx, jnp.float64))
    _close(tp.aniso_exact_grid(tpb, ny, nx, torch.float64, "cpu"),
           jp.aniso_exact_grid(jpb, ny, nx, jnp.float64))
    x = np.linspace(0.05, 0.95, 7)
    _close(tpb.f(torch.as_tensor(x[None, :]), torch.as_tensor(x[:, None])),
           jpb.f(jnp.asarray(x[None, :]), jnp.asarray(x[:, None])))


@pytest.mark.parametrize("prob", PROBS)
@pytest.mark.parametrize("shape", SHAPES)
def test_apply_stencil9_matches_jax(prob, shape):
    j, t = _pair(prob, shape)
    u = np.random.default_rng(sum(shape)).standard_normal(shape)
    _close(tst.apply_stencil9(t, torch.as_tensor(u)),
           jst.apply_stencil9(j, jnp.asarray(u)))


def test_from_numpy_stencil9_round_trip():
    """The nine JAX arrays carried across keep their shapes and values,
    scalars becoming (1, 1)."""
    j, _ = _pair(PROBS[1], (31, 17))
    j = j._replace(csw=jnp.float64(0.25))
    t = tst.from_numpy_stencil9([np.asarray(c) for c in j], "cpu",
                                torch.float64)
    for a, b in zip(j, t):
        assert b.dtype == torch.float64 and b.dim() == 2
        np.testing.assert_array_equal(b.numpy(), np.array(a, ndmin=2))


@pytest.mark.parametrize("n", [2, 3, 17, 64, 127])
@pytest.mark.parametrize("width", [1, 5])
def test_pcr_matches_jax(n, width):
    rng = np.random.default_rng(n + width)
    d = rng.uniform(3, 4, (n, width))
    dl, du = rng.standard_normal((n, width)), rng.standard_normal((n, width))
    rhs = rng.standard_normal((n, 5))
    ref = jst.pcr_solve(jst.pcr_factor(jnp.asarray(dl), jnp.asarray(d),
                                       jnp.asarray(du), n), jnp.asarray(rhs))
    fac = tst.pcr_factor(*map(torch.as_tensor, (dl, d, du)), n)
    assert len(fac.alphas) == int(np.ceil(np.log2(n)))
    _close(tst.pcr_solve(fac, torch.as_tensor(rhs)), ref, 1e-11)


@pytest.mark.parametrize("prob", PROBS)
@pytest.mark.parametrize("sweeps,omega", [(1, 1.0), (3, 0.8)])
def test_line_jacobi_sweeps_y_matches_jax(prob, sweeps, omega):
    shape = (63, 31)
    j, t = _pair(prob, shape)
    rng = np.random.default_rng(sweeps)
    b, u = rng.standard_normal(shape), rng.standard_normal(shape)
    _close(tst.line_jacobi_sweeps_y(t, torch.as_tensor(b),
                                    torch.as_tensor(u), sweeps, omega),
           jst.line_jacobi_sweeps_y(j, jnp.asarray(b), jnp.asarray(u),
                                    sweeps, omega))


@pytest.mark.parametrize("prob", PROBS)
def test_collapse_stencil_matches_jax(prob):
    j, t = _pair(prob, (31, 17))
    jc, tc = jlk.collapse_stencil(j), tlk.collapse_stencil(t)
    for a, b in zip(jc, tc):
        assert tuple(b.shape) == np.shape(a)
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("prob", [PROBS[0], PROBS[3]])
def test_dense_from_stencil9_matches_jax(prob):
    """The coarsest 7 x 7 level of a 9-point hierarchy: the same dense
    operator, so the same host-f64 direct solve."""
    j, t = _pair(prob, (7, 7))
    a = tcoarse.dense_from_stencil(t, 7, 7)
    np.testing.assert_array_equal(a, jcoarse.dense_from_stencil(j, 7, 7))
    u = np.random.default_rng(0).standard_normal((7, 7))
    np.testing.assert_allclose(a @ u.ravel(), np.asarray(
        jst.apply_stencil9(j, jnp.asarray(u))).ravel(), rtol=1e-12,
        atol=1e-12 * np.abs(a).max())


@pytest.mark.parametrize("prob", [PROBS[0], PROBS[1]])
def test_thomas_factors_solve_the_line_systems(prob):
    """The host-side factors of K15 (columns for (ny, 1) line
    coefficients, fields when cc varies with x): Thomas's recurrence on
    them solves what PCR solves."""
    ny, nx = 63, 31
    _, t = _pair(prob, (ny, nx))
    st = tlk.collapse_stencil(t)
    fac = tlk.segment_factor(st, ny)
    assert fac.m.shape == fac.cp.shape == (
        (ny, 1) if st.cc.shape[1] == 1 else (ny, nx))
    rhs = np.random.default_rng(1).standard_normal((ny, nx))
    m, cp = (np.broadcast_to(x.numpy(), (ny, nx)) for x in (fac.m, fac.cp))
    a = np.broadcast_to(st.cs.numpy(), (ny, nx))
    dp, x = np.zeros((ny, nx)), np.zeros((ny, nx))
    for i in range(ny):
        dp[i] = (rhs[i] - (a[i] * dp[i - 1] if i else 0.0)) * m[i]
    for i in range(ny - 1, -1, -1):
        x[i] = dp[i] - (cp[i] * x[i + 1] if i < ny - 1 else 0.0)
    ref = tst.pcr_solve(tst.pcr_factor(st.cs, st.cc, st.cn, ny),
                        torch.as_tensor(rhs))
    _close(x, ref, 1e-12)
