"""Plain PyTorch versions of the port's K12, K13 and K14 against the JAX
package's 9-point Pallas kernels in interpret mode (f64, CPU).

The port's wrappers run their plain versions on CPU tensors, so calling
them here exercises exactly what the CUDA kernels are held against on
the card.  Two stencils: the anisotropic problem's (corners (1, 1), cw/ce
(1, nx), cs/cn (ny, 1), cc an (ny, nx) field) and a random one with every
coefficient kind present (scalars, rows, columns and random full
fields, a dominant cc).  Odd shapes, since the transfer modes need them.
Tolerance: 1e-10 of the reference's largest entry (the JAX kernels run
f64 in interpret mode; the O(1/h^2) terms reassociate), dots 1e-10
relative.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigrid_petsc_tpu import problems as jp
from multigrid_petsc_tpu.ops.pallas import stencil9_kernel as jk9
from multigrid_petsc_tpu.ops.pallas import stencil_kernel as jsk
from multigrid_petsc_tpu.ops.stencil import Stencil9 as JStencil9
from multigrid_petsc_tpu_torch.ops.cuda import stencil9_kernel as tk9
from multigrid_petsc_tpu_torch.ops.stencil import from_numpy_stencil9

torch.set_num_threads(2)

SHAPES = [(65, 63), (129, 129)]
STEPS = {"jacobi": jsk.jacobi_step_coeffs(3, 0.8),
         "chebyshev": jsk.chebyshev_step_coeffs(3, 1.9)}


def _all_kinds(ny, nx, rng):
    """Every coefficient kind: (1, 1), (1, nx), (ny, 1), (ny, nx)."""
    shapes = [(1, 1), (ny, 1), (1, nx), (ny, nx), None, (1, nx), (ny, 1),
              (1, 1), (ny, nx)]
    arrs = [rng.standard_normal(s) if s else None for s in shapes]
    arrs[4] = -(12.0 + 4.0 * rng.random((ny, nx)))
    return JStencil9(*map(jnp.asarray, arrs))


def _setup(shape, kind, seed):
    ny, nx = shape
    rng = np.random.default_rng(seed)
    if kind == "aniso":
        jst = jp.stencil9_coefficients(jp.AnisoProblem(1.0, 0.5, 100.0, 2.0,
                                                       0.3), ny, nx,
                                       jnp.float64)
    else:
        jst = _all_kinds(ny, nx, rng)
    tst = from_numpy_stencil9([np.asarray(c) for c in jst], "cpu",
                              torch.float64)
    b, u = rng.standard_normal(shape), rng.standard_normal(shape)
    e = rng.standard_normal(((ny - 1) // 2, (nx - 1) // 2))
    return jst, tst, b, u, e


def _close(got, ref):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-10 * np.abs(ref).max())


def _t(x):
    return None if x is None else torch.as_tensor(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind", ["aniso", "all_kinds"])
def test_apply_stencil9_plain_matches_pallas(shape, kind):
    jst, tst, _, u, _ = _setup(shape, kind, 1)
    _close(tk9.apply_stencil9(tst, _t(u)),
           jk9.apply_stencil9_pallas(jst, _j(u), interpret=True))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind", ["aniso", "all_kinds"])
def test_residual9_plain_matches_pallas(shape, kind):
    jst, tst, b, u, _ = _setup(shape, kind, 2)
    _close(tk9.residual9(tst, _t(b), _t(u)),
           jk9.residual9_pallas(jst, _j(b), _j(u), interpret=True))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind", ["aniso", "all_kinds"])
@pytest.mark.parametrize("sched", ["jacobi", "chebyshev"])
def test_smooth9_sweeps_plain_matches_pallas(shape, kind, sched):
    jst, tst, b, u, _ = _setup(shape, kind, 3)
    steps = STEPS[sched]
    _close(tk9.smooth9_sweeps(tst, _t(b), _t(u), steps),
           jk9.smooth9_sweeps_pallas(jst, _j(b), _j(u), steps,
                                     interpret=True))


def test_jacobi9_and_chebyshev9_sweeps_take_their_schedules():
    _, tst, b, u, _ = _setup((65, 63), "aniso", 4)
    for got, steps in (
            (tk9.jacobi9_sweeps(tst, _t(b), _t(u), 3, 0.8), STEPS["jacobi"]),
            (tk9.chebyshev9_sweeps(tst, _t(b), _t(u), 3, 1.9),
             STEPS["chebyshev"])):
        torch.testing.assert_close(
            got, tk9.smooth9_sweeps_plain(tst, _t(b), _t(u), steps),
            rtol=0, atol=0)


# Every argument combination fused_level_visit9_pallas accepts:
# (guess, correct, emit, emit_dot).
VISITS = [(g, c, e, d)
          for g in (False, True) for c in ((False, True) if g else (False,))
          for e in ("u", "ur", "r", "rc") for d in ((False, True)
                                                    if e == "u" else (False,))]


@pytest.mark.parametrize("visit", VISITS)
@pytest.mark.parametrize("kind,sched,shape", [
    ("aniso", "jacobi", (65, 63)), ("all_kinds", "chebyshev", (129, 129))])
def test_fused_level_visit9_plain_matches_pallas(visit, kind, sched, shape):
    guess, correct, emit, dot = visit
    jst, tst, b, u, e = _setup(shape, kind, sum(shape) + len(emit))
    steps = STEPS[sched]
    ref = jk9.fused_level_visit9_pallas(
        jst, _j(b), _j(u) if guess else None, steps, emit=emit,
        e_coarse=_j(e) if correct else None, emit_dot=dot, interpret=True)
    got = tk9.fused_level_visit9(
        tst, _t(b), _t(u) if guess else None, steps, emit=emit,
        e_coarse=_t(e) if correct else None, emit_dot=dot)
    if emit == "r" or (emit == "u" and not dot):
        ref, got = (ref,), (got,)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        if np.ndim(r) == 0:
            assert abs(float(g) - float(r)) <= 1e-10 * abs(float(r))
        else:
            _close(g, r)


def test_fused_level_visit9_refuses_what_jax_refuses():
    _, tst, b, u, e = _setup((65, 63), "aniso", 9)
    steps = STEPS["jacobi"]
    with pytest.raises(ValueError):
        tk9.fused_level_visit9(tst, _t(b), None, steps, e_coarse=_t(e))
    with pytest.raises(ValueError):
        tk9.fused_level_visit9(tst, _t(b), _t(u), steps, emit="rc",
                               emit_dot=True)
    with pytest.raises(ValueError):
        tk9.fused_level_visit9(tst, _t(b), _t(u), steps, emit="uu")


def test_new_wrappers_refuse_other_devices():
    _, tst, _, _, _ = _setup((15, 15), "aniso", 0)
    st = type(tst)(*(c.to("meta") for c in tst))
    x = torch.empty((15, 15), device="meta")
    steps = STEPS["jacobi"]
    for call in (lambda: tk9.apply_stencil9(st, x),
                 lambda: tk9.residual9(st, x, x),
                 lambda: tk9.smooth9_sweeps(st, x, x, steps),
                 lambda: tk9.fused_level_visit9(st, x, x, steps, emit="ur")):
        with pytest.raises(ValueError):
            call()
