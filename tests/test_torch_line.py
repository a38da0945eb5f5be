"""The plain version of the port's y-line visit (K15) against the JAX
package's ``line_visit9_pallas`` in interpret mode (f64, CPU), in the
modes ``test_aniso.py`` checks (emit u; the zero-guess rc visit; a
correction with <b, u>; u with its residual), and with x-varying line
coefficients (cc varies with x, where the JAX kernel is not viable)
against ``line_jacobi_sweeps_y`` composed with the transfers.

Tolerance: 1e-12 of the reference's largest entry (the same PCR
recurrence and blend; the residual's O(1/h^2) terms reassociate), dots
1e-10 relative.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigrid_petsc_tpu import problems as jp
from multigrid_petsc_tpu.ops import stencil as jst
from multigrid_petsc_tpu.ops import transfer as jtr
from multigrid_petsc_tpu.ops.pallas import line_kernel as jlk
from multigrid_petsc_tpu_torch.ops.cuda import line_kernel as tlk
from multigrid_petsc_tpu_torch.ops.stencil import from_numpy_stencil9

torch.set_num_threads(2)


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
