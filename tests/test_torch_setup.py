"""The PyTorch port's set-up modules (config, mesh, problems, hierarchy)
against the JAX package, in f64 on the CPU."""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigrid_petsc_tpu import hierarchy as jh
from multigrid_petsc_tpu import problems as jp
from multigrid_petsc_tpu.mesh import MeshType as JMesh
from multigrid_petsc_tpu.utils import config as jc
from multigrid_petsc_tpu_torch import hierarchy as th
from multigrid_petsc_tpu_torch import problems as tp
from multigrid_petsc_tpu_torch.mesh import MeshType as TMesh
from multigrid_petsc_tpu_torch.utils import config as tc

torch.set_num_threads(2)

RTOL = 1e-14  # same f64 formulas on both sides; libm ulps only
SHAPES = [(15, 15), (31, 17)]


@pytest.mark.parametrize("mesh", [0, 1, 2])
@pytest.mark.parametrize("shape", SHAPES)
def test_stencil_coefficients_match_jax(mesh, shape):
    ny, nx = shape
    ref = jp.stencil_coefficients(JMesh(mesh), ny, nx, jnp.float64)
    got = tp.stencil_coefficients(TMesh(mesh), ny, nx, torch.float64, "cpu")
    for name in ("cs", "cw", "cc", "ce", "cn"):
        g = getattr(got, name)
        assert g.shape == (ny, 1) and g.dtype == torch.float64
        r = np.broadcast_to(np.asarray(getattr(ref, name)), (ny, 1))
        np.testing.assert_allclose(g.numpy(), r, rtol=RTOL, atol=0)


@pytest.mark.parametrize("mesh", [0, 1, 2])
@pytest.mark.parametrize("shape", SHAPES)
def test_rhs_and_exact_grid_match_jax(mesh, shape):
    ny, nx = shape
    jprob, tprob = jp.poisson_sin_problem(), tp.poisson_sin_problem()
    for jf, tf in ((jp.rhs_grid, tp.rhs_grid), (jp.exact_grid, tp.exact_grid)):
        ref = np.asarray(jf(jprob, JMesh(mesh), ny, nx, jnp.float64))
        got = tf(tprob, TMesh(mesh), ny, nx, torch.float64, "cpu").numpy()
        assert got.shape == (ny, nx)
        np.testing.assert_allclose(got, ref, rtol=RTOL,
                                   atol=RTOL * np.abs(ref).max())


@pytest.mark.parametrize("npts,grids,levels",
                         [(17, 2, 2), (65, 5, 3), (513, 7, 7), (8193, 11, 11)])
def test_build_hierarchy_matches_jax(npts, grids, levels):
    def flat(specs):
        return [[(g.g, g.ny, g.nx) for g in s.grids] for s in specs]

    assert flat(th.build_hierarchy(npts, grids, levels)) == flat(
        jh.build_hierarchy(npts, grids, levels))


@pytest.mark.parametrize("npts,grids,levels", [(18, 2, 2), (17, 5, 2),
                                               (17, 2, 3)])
def test_build_hierarchy_guards_match_jax(npts, grids, levels):
    with pytest.raises(ValueError):
        jh.build_hierarchy(npts, grids, levels)
    with pytest.raises(ValueError):
        th.build_hierarchy(npts, grids, levels)


def _as_plain(cfg):
    return {k: (v.value if hasattr(v, "value") else v)
            for k, v in dataclasses.asdict(cfg).items()}


def test_parse_options_file_matches_jax(tmp_path):
    path = tmp_path / "poisson.in"
    path.write_text(
        "# comment line\n-npts 33\n-mesh 1\n-iter 50\n-grids 4\n"
        "-levels 3\n-cycle 101\n-v 2,4\n-omega 0.7\n-rtol 1e-6\n"
        "-dtype float32\n-unknown 5\n  # indented comment\n-moreNorm 1\n")
    ref = jc.parse_options_file(path)
    got = tc.parse_options_file(path)
    assert _as_plain(got) == _as_plain(ref)
    assert got.cycle == tc.CycleType.MGCG and got.v == (2, 4)


@pytest.mark.parametrize("opts", [
    "-grids 2\n-levels 3\n",                      # levels > grids
    "-grids 3\n-levels 2\n-cycle 3\n",            # delayed cycle, levels > 1
    "-grids 3\n-levels 3\n-cycle 10\n",           # Additive2, > 2 levels
])
def test_validate_guards_match_jax(tmp_path, opts):
    path = tmp_path / "bad.in"
    path.write_text(opts)
    with pytest.raises(ValueError):
        jc.parse_options_file(path)
    with pytest.raises(ValueError):
        tc.parse_options_file(path)
