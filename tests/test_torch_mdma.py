"""Plain PyTorch versions of the port's four kernels against the JAX
package's Pallas kernels in interpret mode (f64, CPU).

The port's wrappers run their plain versions on CPU tensors, so calling
them here exercises exactly what the CUDA kernels are held against on
the card.  Geometry: 511^2 (the ``test_mdma.py`` grid) and 337x255, whose
last CUDA tile (32 x 64) is short in both axes.  Tolerances are those of
``test_mdma.py``: rtol 1e-12 / atol 1e-13 on arrays, atol 1e-8 on A p'
(O(1/h^2) stencil terms), 1e-10 relative on dots.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigrid_petsc_tpu.mesh import MeshType as JMesh
from multigrid_petsc_tpu.ops.pallas import mdma_kernel as jmdma
from multigrid_petsc_tpu.problems import stencil_coefficients as j_coeffs
from multigrid_petsc_tpu_torch.mesh import MeshType as TMesh
from multigrid_petsc_tpu_torch.ops.cuda import coarse_tree_kernel as tctk
from multigrid_petsc_tpu_torch.ops.cuda import mdma_kernel as tmdma
from multigrid_petsc_tpu_torch.problems import stencil_coefficients as t_coeffs
from multigrid_petsc_tpu_torch.solvers.smoothers import jacobi_step_coeffs

torch.set_num_threads(2)

STEPS = jacobi_step_coeffs(3, 0.8)
SHAPES = [(511, 511), (337, 255)]


def _pad(x, ny, nx):
    rp, cp = jmdma.shape_pad(ny, nx)
    x = jnp.asarray(x)
    return jnp.pad(x, ((0, rp - x.shape[0]), (0, cp - x.shape[1])))


def _unpad(x, ny, nx):
    return np.asarray(x)[:ny, :nx]


def _close(got, ref, atol=1e-13):
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=atol)


def _dot_close(got, ref):
    ref = float(ref)
    assert abs(float(got) - ref) <= 1e-10 * abs(ref)


def _setup(shape, seed):
    ny, nx = shape
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((ny, nx)) for _ in range(3)]
    e_c = rng.standard_normal(((ny - 1) // 2, (nx - 1) // 2))
    jst = j_coeffs(JMesh.UNIFORM, ny, nx, jnp.float64)
    tst = t_coeffs(TMesh.UNIFORM, ny, nx, torch.float64, "cpu")
    return jst, tst, arrs, e_c


def _t(x):
    return torch.as_tensor(x)


@pytest.mark.parametrize("shape", SHAPES)
def test_cg_papply_u_plain_matches_jax(shape):
    ny, nx = shape
    jst, tst, (z, p, u), _ = _setup(shape, 13)
    a_prev, beta = 0.21, 0.43
    ref = jmdma.cg_papply_u_mdma(jst, _pad(z, ny, nx), _pad(p, ny, nx),
                                 _pad(u, ny, nx), a_prev, beta, ny=ny, nx=nx,
                                 interpret=True)
    pn, ap, un, dot = tmdma.cg_papply_u(
        tst, _t(z), _t(p), _t(u), torch.tensor(a_prev, dtype=torch.float64),
        torch.tensor(beta, dtype=torch.float64))
    _close(pn, _unpad(ref[0], ny, nx))
    _close(ap, _unpad(ref[1], ny, nx), atol=1e-8)
    _close(un, _unpad(ref[2], ny, nx))
    _dot_close(dot, ref[3])


@pytest.mark.parametrize("shape", SHAPES)
def test_cg_visit_down_plain_matches_jax(shape):
    ny, nx = shape
    nyc, nxc = (ny - 1) // 2, (nx - 1) // 2
    jst, tst, (r, ap, _), _ = _setup(shape, 7)
    alpha = 0.37
    ref = jmdma.cg_visit_down_mdma(jst, _pad(r, ny, nx), _pad(ap, ny, nx),
                                   alpha, STEPS, ny=ny, nx=nx, interpret=True)
    u0, rc, r_new, rn2 = tmdma.cg_visit_down(
        tst, _t(r), _t(ap), torch.tensor(alpha, dtype=torch.float64), STEPS)
    _close(u0, _unpad(ref[0], ny, nx))
    assert rc.shape == (nyc, nxc)
    _close(rc, _unpad(ref[1], nyc, nxc), atol=1e-10)
    _close(r_new, _unpad(ref[2], ny, nx))
    _dot_close(rn2, ref[3])


@pytest.mark.parametrize("shape", SHAPES)
def test_visit_down_plain_matches_jax(shape):
    ny, nx = shape
    nyc, nxc = (ny - 1) // 2, (nx - 1) // 2
    jst, tst, (b, _, _), _ = _setup(shape, 11)
    ref = jmdma.visit_down_mdma(jst, _pad(b, ny, nx), STEPS, ny=ny, nx=nx,
                                interpret=True)
    u0, rc = tmdma.visit_down(tst, _t(b), STEPS)
    _close(u0, _unpad(ref[0], ny, nx))
    _close(rc, _unpad(ref[1], nyc, nxc), atol=1e-10)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("emit_dot", [True, False])
def test_visit_up_plain_matches_jax(shape, emit_dot):
    ny, nx = shape
    nyc, nxc = (ny - 1) // 2, (nx - 1) // 2
    jst, tst, (b, u, _), e_c = _setup(shape, 17)
    ref = jmdma.visit_up_mdma(jst, _pad(b, ny, nx), _pad(u, ny, nx),
                              _pad(e_c, nyc, nxc), STEPS, ny=ny, nx=nx,
                              emit_dot=emit_dot, interpret=True)
    got = tmdma.visit_up(tst, _t(b), _t(u), _t(e_c), STEPS, emit_dot)
    if emit_dot:
        _close(got[0], _unpad(ref[0], ny, nx))
        _dot_close(got[1], ref[1])
    else:
        _close(got, _unpad(ref, ny, nx))


def test_coarse_tree_plain_matches_jax():
    """The plain K4 against make_coarse_tree_solver(interpret=True) on the
    257^2 / 6-level chain (255^2 -> 7^2), Jacobi, direct coarsest solve;
    the level split is chosen by each package's build_coarse_tree."""
    from multigrid_petsc_tpu.solvers.context import build_context as j_build
    from multigrid_petsc_tpu.solvers.krylov import build_coarse_tree as j_tree
    from multigrid_petsc_tpu.utils.config import CycleType as JCT
    from multigrid_petsc_tpu.utils.config import SolverConfig as JC
    from multigrid_petsc_tpu_torch.solvers.context import build_context
    from multigrid_petsc_tpu_torch.solvers.krylov import build_coarse_tree
    from multigrid_petsc_tpu_torch.utils.config import CycleType, SolverConfig

    kw = dict(npts=257, grids=6, levels=6, dtype="float64")
    j_lt, j_fn = j_tree(j_build(JC(cycle=JCT.MGCG, **kw)), interpret=True)
    t_lt, t_fn = build_coarse_tree(
        build_context(SolverConfig(cycle=CycleType.MGCG, **kw), device="cpu"))
    assert j_lt == t_lt == 1
    b = np.random.default_rng(3).standard_normal((127, 127))
    ref = np.asarray(j_fn(jnp.asarray(b)))
    got = t_fn(torch.as_tensor(b)).numpy()
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12 * scale)


@pytest.mark.parametrize("npts,grids,start", [(8193, 11, 3), (513, 7, 1),
                                              (1025, 8, 1), (17, 2, None)])
def test_coarse_tree_split_matches_jax_rule(npts, grids, start):
    """The port keeps the JAX package's selection rule, so the tree starts
    at the same level (level 3 on the 8193^2 main path)."""
    from multigrid_petsc_tpu.ops.pallas import coarse_tree_kernel as jctk

    shapes = [(n, n) for n in ((npts - 1) // 2**g - 1 for g in range(grids))]

    def first(viable):
        for l_t in range(1, grids - 1):
            s = shapes[l_t:]
            if viable(s, False) and viable(s, True):
                return l_t
        return None

    assert first(lambda s, d: tctk.coarse_tree_viable(s, 4, direct=d)) \
        == first(lambda s, d: jctk.coarse_tree_viable(s, jnp.float32,
                                                       direct=d)) == start


def test_wrappers_refuse_other_devices():
    st = t_coeffs(TMesh.UNIFORM, 15, 15, torch.float32, "meta")
    b = torch.empty((15, 15), device="meta")
    with pytest.raises(ValueError):
        tmdma.visit_down(st, b, STEPS)
    with pytest.raises(ValueError):
        tmdma.cg_papply_u(st, b, b, b, b[0, 0], b[0, 0])


def test_cuda_argument_checks():
    """The checks a CUDA launch runs first refuse f64, wrong shapes and
    non-contiguous tensors (exercised here on CPU tensors)."""
    dev = torch.device("cpu")
    x32 = torch.zeros((15, 15))
    with pytest.raises(TypeError):
        tmdma._check_cuda(dev, {"x": (x32.double(), (15, 15))})
    with pytest.raises(ValueError):
        tmdma._check_cuda(dev, {"x": (x32, (15, 17))})
    with pytest.raises(ValueError):
        tmdma._check_cuda(dev, {"x": (x32.t()[:, :7], (15, 7))})
    with pytest.raises(TypeError):
        tmdma._check_cuda(dev, {}, {"alpha": 0.5})
    with pytest.raises(ValueError):
        tmdma.steps_tensor((), dev)
    with pytest.raises(ValueError):
        tmdma._odd_shape(torch.zeros((16, 15)))
