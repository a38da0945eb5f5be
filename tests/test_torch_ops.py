"""The PyTorch port's operators, transfers, norms, coarse solve and
smoother schedules against the JAX package, in f64 on the CPU."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigrid_petsc_tpu.mesh import MeshType as JMesh
from multigrid_petsc_tpu.ops import norms as jn
from multigrid_petsc_tpu.ops import stencil as js
from multigrid_petsc_tpu.ops import transfer as jt
from multigrid_petsc_tpu.ops.pallas import stencil_kernel as jsk
from multigrid_petsc_tpu.problems import stencil_coefficients as j_coeffs
from multigrid_petsc_tpu.solvers import coarse as jcoarse
from multigrid_petsc_tpu_torch.mesh import MeshType as TMesh
from multigrid_petsc_tpu_torch.ops import norms as tn
from multigrid_petsc_tpu_torch.ops import stencil as ts
from multigrid_petsc_tpu_torch.ops import transfer as tt
from multigrid_petsc_tpu_torch.problems import stencil_coefficients as t_coeffs
from multigrid_petsc_tpu_torch.solvers import coarse as tcoarse
from multigrid_petsc_tpu_torch.solvers import smoothers as tsm

torch.set_num_threads(2)

# Stencil terms are O(1/h^2); 1e-13 relative to the largest entry covers
# f64 roundoff of either summation order.
TOL = 1e-13


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape)


def _close(got, ref, tol=TOL):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=tol,
                               atol=tol * np.abs(ref).max())


@pytest.mark.parametrize("mesh", [0, 1, 2])
def test_apply_stencil5_and_residual_match_jax(mesh):
    ny, nx = 31, 17
    jst = j_coeffs(JMesh(mesh), ny, nx, jnp.float64)
    tst = t_coeffs(TMesh(mesh), ny, nx, torch.float64, "cpu")
    u, b = _rand((ny, nx), 1), _rand((ny, nx), 2)
    _close(ts.apply_stencil5(tst, torch.as_tensor(u)).numpy(),
           js.apply_stencil5(jst, jnp.asarray(u)))
    _close(ts.residual(tst, torch.as_tensor(b), torch.as_tensor(u)).numpy(),
           js.residual(jst, jnp.asarray(b), jnp.asarray(u)))


def test_from_numpy_stencil_carries_jax_coefficients():
    jst = j_coeffs(JMesh.NONUNIFORM2, 15, 15, jnp.float64)
    st = ts.from_numpy_stencil([np.asarray(c) for c in jst], "cpu",
                               torch.float64)
    ref = t_coeffs(TMesh.NONUNIFORM2, 15, 15, torch.float64, "cpu")
    for a, b in zip(st, ref):
        assert a.shape == (15, 1)
        _close(a.numpy(), b.numpy())


@pytest.mark.parametrize("shape", [(31, 31), (15, 63)])
def test_restrict_fw_matches_jax(shape):
    r = _rand(shape, 3)
    _close(tt.restrict_fw(torch.as_tensor(r)).numpy(),
           jt.restrict_fw(jnp.asarray(r)))


@pytest.mark.parametrize("shape", [(15, 15), (7, 31)])
def test_prolong_bilinear_matches_jax(shape):
    e = _rand(shape, 4)
    got = tt.prolong_bilinear(torch.as_tensor(e)).numpy()
    assert got.shape == (2 * shape[0] + 1, 2 * shape[1] + 1)
    _close(got, jt.prolong_bilinear(jnp.asarray(e)))


def test_norms_match_jax():
    x, y = _rand((33, 17), 5), _rand((33, 17), 6)
    _close(float(tn.tree_dot(torch.as_tensor(x), torch.as_tensor(y))),
           float(jn.tree_dot((jnp.asarray(x),), (jnp.asarray(y),))))
    _close(float(tn.tree_norm2(torch.as_tensor(x))),
           float(jn.tree_norm2((jnp.asarray(x),))))


@pytest.mark.parametrize("mesh", [0, 1])
def test_dense_from_stencil_matches_jax_exactly(mesh):
    jst = j_coeffs(JMesh(mesh), 7, 5, jnp.float64)
    tst = t_coeffs(TMesh(mesh), 7, 5, torch.float64, "cpu")
    ref = jcoarse.dense_from_stencil(jst, 7, 5)
    # Built from the port's own coefficients and from the JAX ones.
    assert np.array_equal(tcoarse.dense_from_stencil(
        ts.from_numpy_stencil([np.asarray(c) for c in jst], "cpu",
                              torch.float64), 7, 5), ref)
    np.testing.assert_allclose(tcoarse.dense_from_stencil(tst, 7, 5), ref,
                               rtol=1e-14, atol=0)


def test_direct_solve_matches_jax():
    ny = nx = 7
    jst = j_coeffs(JMesh.UNIFORM, ny, nx, jnp.float64)
    tst = t_coeffs(TMesh.UNIFORM, ny, nx, torch.float64, "cpu")
    jsolve = jcoarse.build_direct_solver(
        lambda u: (js.apply_stencil5(jst, u[0]),), [(ny, nx)], jnp.float64,
        stencils=(jst,))
    tsolve = tcoarse.build_direct_solver(tst, (ny, nx))
    b = _rand((ny, nx), 7)
    ref = np.asarray(jsolve((jnp.asarray(b),))[0])
    got = tsolve(torch.as_tensor(b)).numpy()
    _close(got, ref, tol=1e-12)
    # And it solves: A x = b.
    _close(ts.apply_stencil5(tst, torch.as_tensor(got)).numpy(), b, tol=1e-12)


@pytest.mark.parametrize("sweeps", [1, 3, 6])
def test_step_coefficients_match_jax_exactly(sweeps):
    assert tsm.jacobi_step_coeffs(sweeps, 0.8) == jsk.jacobi_step_coeffs(
        sweeps, 0.8)
    assert tsm.chebyshev_step_coeffs(sweeps, 1.9) == \
        jsk.chebyshev_step_coeffs(sweeps, 1.9)


def test_jacobi_smoother_matches_jax():
    """The port's smoother is the (omega, 0) schedule run by K7 (its plain
    version on the CPU): the JAX package's damped Jacobi."""
    from multigrid_petsc_tpu.solvers import smoothers as jsm
    from multigrid_petsc_tpu_torch.ops.cuda import stencil_kernel as tsk

    jst = j_coeffs(JMesh.NONUNIFORM1, 15, 15, jnp.float64)
    tst = t_coeffs(TMesh.NONUNIFORM1, 15, 15, torch.float64, "cpu")
    b, u = _rand((15, 15), 8), _rand((15, 15), 9)
    ref = jsm.jacobi(lambda v: (js.apply_stencil5(jst, v[0]),),
                     (1.0 / jst.cc,), (jnp.asarray(b),), (jnp.asarray(u),),
                     3, 0.8)[0]
    got = tsk.jacobi_sweeps(tst, torch.as_tensor(b), torch.as_tensor(u), 3,
                            0.8)
    _close(got.numpy(), ref)
