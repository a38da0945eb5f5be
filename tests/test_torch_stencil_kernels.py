"""Plain PyTorch versions of the port's K6, K7 and K9 against the JAX
package's Pallas kernels in interpret mode (f64, CPU), plus the Chebyshev
set-up (``estimate_dinv_a_lmax``, the step schedule) and smoother.

The port's wrappers run their plain versions on CPU tensors, so calling
them here exercises exactly what the CUDA kernels are held against on
the card.  Shapes are ``test_pallas.py``'s; the transfer modes (emit
``rc``, a coarse correction) need odd sizes.  The stencils are the JAX
package's, carried across with ``from_numpy_stencil``.  Tolerances are
``test_pallas.py``'s: rtol 1e-12 with an absolute floor of 1e-12 of the
array's largest entry (the O(1/h^2) stencil terms reassociate).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigrid_petsc_tpu.mesh import MeshType as JMesh
from multigrid_petsc_tpu.ops.pallas import stencil_kernel as jsk
from multigrid_petsc_tpu.ops.stencil import apply_stencil5 as j_apply
from multigrid_petsc_tpu.problems import stencil_coefficients as j_coeffs
from multigrid_petsc_tpu.solvers import smoothers as jsm
from multigrid_petsc_tpu_torch.ops.cuda import mdma_kernel as tmdma
from multigrid_petsc_tpu_torch.ops.cuda import stencil_kernel as tsk
from multigrid_petsc_tpu_torch.ops.stencil import from_numpy_stencil
from multigrid_petsc_tpu_torch.solvers import smoothers as tsm

torch.set_num_threads(2)

SHAPES = [(63, 63), (100, 63), (127, 31), (257, 129)]
ODD = [s for s in SHAPES if s[0] % 2 and s[1] % 2]
STEPS = jsk.jacobi_step_coeffs(3, 0.8)


def _setup(shape, seed, mesh=JMesh.NONUNIFORM2):
    ny, nx = shape
    rng = np.random.default_rng(seed)
    b, u = rng.standard_normal((ny, nx)), rng.standard_normal((ny, nx))
    e = rng.standard_normal(((ny - 1) // 2, (nx - 1) // 2))
    jst = j_coeffs(mesh, ny, nx, jnp.float64)
    tst = from_numpy_stencil([np.asarray(c) for c in jst], "cpu",
                             torch.float64)
    return jst, tst, b, u, e


def _close(got, ref):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-12,
                               atol=1e-12 * max(np.abs(ref).max(), 1.0))


def _t(x):
    return None if x is None else torch.as_tensor(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("shape", SHAPES)
def test_apply_stencil5_plain_matches_pallas(shape):
    jst, tst, _, u, _ = _setup(shape, 1)
    _close(tsk.apply_stencil5(tst, _t(u)),
           jsk.apply_stencil5_pallas(jst, _j(u), interpret=True))


@pytest.mark.parametrize("shape", SHAPES)
def test_residual5_plain_matches_pallas(shape):
    jst, tst, b, u, _ = _setup(shape, 2, JMesh.NONUNIFORM1)
    _close(tsk.residual5(tst, _t(b), _t(u)),
           jsk.residual5_pallas(jst, _j(b), _j(u), interpret=True))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("sweeps", [1, 4])
def test_jacobi_sweeps_plain_matches_pallas(shape, sweeps):
    jst, tst, b, u, _ = _setup(shape, 3 + sweeps, JMesh.NONUNIFORM1)
    _close(tsk.jacobi_sweeps(tst, _t(b), _t(u), sweeps, 0.8),
           jsk.jacobi_sweeps_pallas(jst, _j(b), _j(u), sweeps, 0.8,
                                    interpret=True))


@pytest.mark.parametrize("shape", [(63, 63), (100, 63)])
@pytest.mark.parametrize("sweeps", [1, 4])
def test_chebyshev_sweeps_plain_matches_pallas(shape, sweeps):
    jst, tst, b, u, _ = _setup(shape, 5 + sweeps)
    _close(tsk.chebyshev_sweeps(tst, _t(b), _t(u), sweeps, 1.9),
           jsk.chebyshev_sweeps_pallas(jst, _j(b), _j(u), sweeps, 1.9,
                                       interpret=True))


# Every argument combination fused_level_visit_pallas accepts:
# (guess, correct, emit, emit_dot).  A correction needs a guess; emit_dot
# goes with emit "u" only.
VISITS = [(g, c, e, d)
          for g in (False, True) for c in ((False, True) if g else (False,))
          for e in ("u", "ur", "r", "rc") for d in ((False, True)
                                                    if e == "u" else (False,))]
CASES = [(shape, v) for v in VISITS
         for shape in (ODD if (v[1] or v[2] == "rc") else SHAPES)]


@pytest.mark.parametrize("shape,visit", CASES)
def test_fused_level_visit_plain_matches_pallas(shape, visit):
    guess, correct, emit, dot = visit
    jst, tst, b, u, e = _setup(shape, sum(shape) + len(emit))
    steps = (jsk.chebyshev_step_coeffs(2, 1.9) if correct
             else STEPS)
    ref = jsk.fused_level_visit_pallas(
        jst, _j(b), _j(u) if guess else None, steps, emit=emit,
        e_coarse=_j(e) if correct else None, emit_dot=dot, interpret=True)
    got = tsk.fused_level_visit(
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


def test_fused_level_visit_refuses_what_jax_refuses():
    _, tst, b, u, e = _setup((63, 63), 9)
    with pytest.raises(ValueError):
        tsk.fused_level_visit(tst, _t(b), None, STEPS, e_coarse=_t(e))
    with pytest.raises(ValueError):
        tsk.fused_level_visit(tst, _t(b), _t(u), STEPS, emit="rc",
                              emit_dot=True)
    with pytest.raises(ValueError):
        tsk.fused_level_visit(tst, _t(b), _t(u), STEPS, emit="uu")


@pytest.mark.parametrize("mesh", [0, 1, 2])
@pytest.mark.parametrize("shape", [(63, 63), (31, 17)])
def test_estimate_dinv_a_lmax_matches_jax(mesh, shape):
    jst, tst, _, _, _ = _setup(shape, 0, JMesh(mesh))
    ref = float(jsm.estimate_dinv_a_lmax(
        lambda v: (j_apply(jst, v[0]),), (1.0 / jst.cc,), [shape],
        dtype=jnp.float64))
    got = tsm.estimate_dinv_a_lmax(lambda v: tsk.apply_stencil5(tst, v),
                                   1.0 / tst.cc, shape)
    assert isinstance(got, float)
    assert abs(got - ref) <= 1e-12 * ref
    # The schedules built from it agree to the same precision.
    np.testing.assert_allclose(tsm.chebyshev_step_coeffs(3, got),
                               jsk.chebyshev_step_coeffs(3, ref),
                               rtol=1e-12, atol=0)


@pytest.mark.parametrize("sweeps", [1, 3])
def test_chebyshev_smoother_matches_jax(sweeps):
    """The port's Chebyshev smoother is its static schedule run by K7 (the
    plain version here): the JAX package's recurrence, step by step."""
    jst, tst, b, u, _ = _setup((31, 17), 10, JMesh.NONUNIFORM1)
    ref = jsm.chebyshev(lambda v: (j_apply(jst, v[0]),), (1.0 / jst.cc,),
                        (_j(b),), (_j(u),), sweeps, 1.9)[0]
    _close(tsk.chebyshev_sweeps(tst, _t(b), _t(u), sweeps, 1.9), ref)


ANISO9 = ((False, False), (True, False), (False, False), (False, True),
          (True, True), (False, True), (False, False), (True, False),
          (False, False))
# Every coefficient an (ny, nx) field: the most shared memory a 9-point
# visit stages.
FIELDS9 = ((True, True),) * 9


def test_steps_cap_is_the_kernels():
    """The visit kernels' own bounds cap their steps (the schedules live
    in device memory, so no parameter block caps them): the 5-point
    visit's largest halo, 43 steps with emit rc, 45 with emit u;
    the 9-point visit's region is fixed (64 x 64, its shared memory does
    not grow with the halo), so its tile bounds it: 29 steps with emit
    rc, 31 with emit u, for any coefficient layout that fits; at least
    1."""
    assert tmdma.max_visit_steps(None, "rc") == 43
    assert tmdma.max_visit_steps(None, "u") == 45
    assert tmdma.max_visit_steps(ANISO9, "rc") == 29
    assert tmdma.max_visit_steps(ANISO9, "u") == 31
    assert tmdma.max_visit_steps(FIELDS9, "rc") == 29
    assert tmdma.visit_smem_bytes(ANISO9, 3) == tmdma.visit_smem_bytes(
        ANISO9, 31) == 4 * (2 * 66 * 66 + 2 * 64 * 64 + 2 * 64 + 2 * 64 + 4
                            + 8)
    assert tmdma.visit_fits(ANISO9, 31) and not tmdma.visit_fits(ANISO9, 32)
    k = tmdma.max_visit_steps(None, "rc")
    assert k + 2 == tmdma.V5_MAX_HALO[4]
    assert tmdma.visit_fits(None, k + 2) and not tmdma.visit_fits(None, k + 3)
    arr = tmdma.steps_tensor(jsk.jacobi_step_coeffs(32, 0.8), "cpu")
    assert arr.shape == (64,) and arr.dtype == torch.float32
    with pytest.raises(ValueError):
        tmdma.steps_tensor((), "cpu")


@pytest.mark.parametrize("stencil", ["5-point", "9-point"])
def test_steps_cap_covers_every_path(stencil):
    """The bound covers the most steps a path gives a visit: v = (8, 8)
    (the fused route and -v 8,8 runs: 8 steps in a visit, emit rc or u),
    phase 2's k = 32 5-point visit, K17's row blocks at k + 2 rows of
    halo, in every storage type's compute type."""
    kinds = None if stencil == "5-point" else ANISO9
    most = 32 if stencil == "5-point" else 8
    for size in (4, 8):  # f32 and bf16 tiles; f64
        for emit in ("u", "ur", "r", "rc"):
            k = tmdma.max_visit_steps(kinds, emit, size)
            assert k >= (8 if size == 8 else most), (emit, size, k)
            assert tmdma.visit_fits(kinds, tmdma._halo(emit, k), size)
            assert not tmdma.visit_fits(kinds, tmdma._halo(emit, k + 1), size)


def test_new_wrappers_refuse_other_devices():
    _, tst, _, _, _ = _setup((15, 15), 0)
    st = type(tst)(*(c.to("meta") for c in tst))
    x = torch.empty((15, 15), device="meta")
    for call in (lambda: tsk.apply_stencil5(st, x),
                 lambda: tsk.residual5(st, x, x),
                 lambda: tsk.smooth_sweeps(st, x, x, STEPS),
                 lambda: tsk.fused_level_visit(st, x, x, STEPS, emit="ur")):
        with pytest.raises(ValueError):
            call()
