"""The port's explicit sparse backend against the JAX package's, on the
CPU: the CSR assembly (the port's own copy of the C++ engine), its DIA
and ELL conversions, the plain versions of K8 (the field-coefficient
stencil) and K16 (the DIA SpMV) against the JAX kernels in interpret
mode, and ``SparseLevelOp`` (apply and route) on the same matrices.

Sizes stay at or below 65^2: the JAX package's own assembly loops over
every coarse point for every fine row.  Tolerances: the CSR triples are
equal exactly (same arithmetic, same order); the conversions are exact
copies; the f64 applies differ in summation order only (1e-12 relative
to the largest entry).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multigrid_petsc_tpu.ops import sparse as jsp
from multigrid_petsc_tpu.ops.pallas.spmv_dia import dia_from_csr as j_dia
from multigrid_petsc_tpu.ops.pallas.spmv_dia import dia_spmv_pallas
from multigrid_petsc_tpu.ops.pallas.stencil_kernel import (
    apply_stencil5_field_pallas,
)
from multigrid_petsc_tpu.ops.stencil import Stencil5 as JStencil5
from multigrid_petsc_tpu_torch.ops import sparse as sp
from multigrid_petsc_tpu_torch.ops.cuda import launches
from multigrid_petsc_tpu_torch.ops.cuda import spmv_dia_kernel as dk
from multigrid_petsc_tpu_torch.ops.cuda import stencil_kernel as sk
from multigrid_petsc_tpu_torch.ops.stencil import Stencil5

torch.set_num_threads(2)

F64 = torch.float64
VARIANTS = {"A": (True, True), "A1": (True, False), "A2": (False, True)}


def _close(got, want, rtol=1e-12):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    scale = max(np.abs(want).max(), 1e-300)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("mesh", [0, 1, 2])
@pytest.mark.parametrize("gids", [(0,), (0, 1), (0, 1, 2), (1, 3)])
def test_csr_equals_jax_assembly(gids, mesh, variant):
    """Every entry and its place in its row: the bounded prolongation
    loops and the hoisted stencils change nothing."""
    want = jsp.assemble_level_csr(33, mesh, gids, *VARIANTS[variant])
    got = sp.assemble_level_csr(33, mesh, gids, *VARIANTS[variant])
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("gids,variant", [((0,), "A"), ((0, 1), "A1"),
                                          ((0, 1, 2), "A1")])
def test_dia_from_csr_matches_jax(gids, variant):
    csr = jsp.assemble_level_csr(33, 1, gids, *VARIANTS[variant])
    offs_j, vals_j = j_dia(*csr)
    offs, vals = sp.dia_from_csr(*csr)
    assert offs == offs_j
    np.testing.assert_array_equal(vals.numpy(), vals_j)


def test_dia_from_csr_refuses_coupled_levels_as_jax():
    csr = jsp.assemble_level_csr(33, 0, (0, 1))
    with pytest.raises(ValueError):
        j_dia(*csr)
    with pytest.raises(ValueError, match="not DIA-shaped"):
        sp.dia_from_csr(*csr)


@pytest.mark.parametrize("gids,variant", [((0,), "A"), ((0, 1), "A"),
                                          ((0, 1, 2), "A2")])
def test_csr_to_ell_matches_jax(gids, variant):
    csr = jsp.assemble_level_csr(33, 2, gids, *VARIANTS[variant])
    vals_j, cols_j = jsp.csr_to_ell(*csr)
    vals, cols = sp.csr_to_ell(*csr)
    np.testing.assert_array_equal(cols.numpy(), np.asarray(cols_j))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(vals_j))


def test_k16_plain_matches_pallas_on_random_bands():
    """Offsets past +-512 (the TPU kernel's lane rows), a ragged end and
    values where a column would fall outside [0, n)."""
    rng = np.random.default_rng(7)
    n = 2 * 512 + 137
    offsets = (-515, -1, 0, 2, 512)
    vals = rng.standard_normal((len(offsets), n))
    x = rng.standard_normal(n)
    want = dia_spmv_pallas(offsets, jnp.asarray(vals), jnp.asarray(x),
                           interpret=True)
    got = dk.dia_spmv(offsets, torch.as_tensor(vals), torch.as_tensor(x))
    _close(got, want)


@pytest.mark.parametrize("gids", [(0, 1), (0, 1, 2)])
def test_k16_plain_matches_pallas_on_merged_a1(gids):
    """The grid-diagonal A1 of a merged level: 5 + 2(G - 1) diagonals."""
    csr = jsp.assemble_level_csr(33, 1, gids, True, False)
    offs, vals = j_dia(*csr)
    assert len(offs) == 5 + 2 * (len(gids) - 1)
    x = np.random.default_rng(3).standard_normal(len(csr[0]) - 1)
    want = dia_spmv_pallas(offs, jnp.asarray(vals), jnp.asarray(x),
                           interpret=True)
    got = dk.dia_spmv(offs, torch.as_tensor(vals), torch.as_tensor(x))
    _close(got, want)


@pytest.mark.parametrize("mesh", [0, 2])
@pytest.mark.parametrize("resid", [False, True])
def test_k8_plain_matches_pallas(mesh, resid):
    """The stencil form of an assembled level (fields from its DIA rows),
    A u and b - A u, against the JAX field kernel in interpret mode."""
    n = 31
    offs, vals = j_dia(*jsp.assemble_level_csr(n + 2, mesh, (0,)))
    names = {-n: "cs", -1: "cw", 0: "cc", 1: "ce", n: "cn"}
    fields = {names[d]: vals[k].reshape(n, n) for k, d in enumerate(offs)}
    rng = np.random.default_rng(11)
    u, b = rng.standard_normal((n, n)), rng.standard_normal((n, n))
    jst = JStencil5(**{k: jnp.asarray(v) for k, v in fields.items()})
    st = Stencil5(**{k: torch.as_tensor(v) for k, v in fields.items()})
    if resid:
        want = apply_stencil5_field_pallas(jst, jnp.asarray(u),
                                           jnp.asarray(b), interpret=True)
        got = sk.residual5_field(st, torch.as_tensor(b), torch.as_tensor(u))
    else:
        want = apply_stencil5_field_pallas(jst, jnp.asarray(u),
                                           interpret=True)
        got = sk.apply_stencil5_field(st, torch.as_tensor(u))
    _close(got, want)


def _jax_route(op: jsp.SparseLevelOp) -> str:
    """The route the JAX package takes for a 32-bit level on the TPU
    (``SparseLevelOp.apply``)."""
    if op.dia is None:
        return "ell"
    return "stencil" if op.stencil_form is not None else "dia"


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("gids", [(0,), (1,), (0, 1), (0, 1, 2)])
def test_form_matches_jax_route(gids, variant):
    """f32 takes the JAX package's TPU route; f64 is ELL (the CUDA
    kernels take f32 only, and the JAX package applies f64 as ELL)."""
    jop = jsp.SparseLevelOp(33, 1, gids, dtype=np.float32,
                            include_diag=VARIANTS[variant][0],
                            include_couplings=VARIANTS[variant][1])
    kw = dict(include_diag=VARIANTS[variant][0],
              include_couplings=VARIANTS[variant][1])
    op32 = sp.SparseLevelOp.assemble(33, 1, gids, device="cpu",
                                     dtype=torch.float32, **kw)
    op64 = sp.SparseLevelOp.assemble(33, 1, gids, device="cpu", dtype=F64,
                                     **kw)
    assert op32.form == _jax_route(jop)
    assert op64.form == "ell"
    assert op32.nnz == op64.nnz == jop.nnz


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("gids", [(0,), (0, 1), (1, 3)])
def test_apply_from_jax_csr_matches_jax_f64(gids, variant):
    """``from_csr`` on the JAX package's CSR: the port applies the JAX
    matrix (ELL in f64) and matches its ``apply``."""
    inc = VARIANTS[variant]
    jop = jsp.SparseLevelOp(33, 2, gids, include_diag=inc[0],
                            include_couplings=inc[1])
    csr = jsp.assemble_level_csr(33, 2, gids, *inc)
    op = sp.SparseLevelOp.from_csr(*csr, jop.shapes, "cpu", F64)
    rng = np.random.default_rng(5)
    u = tuple(rng.standard_normal(s) for s in jop.shapes)
    want = jop.apply(tuple(jnp.asarray(x) for x in u))
    state = (torch.as_tensor(u[0]) if len(u) == 1
             else tuple(torch.as_tensor(x) for x in u))
    got = op.apply(state)
    got = (got,) if isinstance(got, torch.Tensor) else got
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("gids", [(0,), (0, 1)])
def test_f32_forms_match_f64_apply(gids):
    """The stencil / DIA forms (f32) apply the same matrix as ELL (f64),
    and the residual mode is b - A u."""
    op32 = sp.SparseLevelOp.assemble(33, 2, gids, device="cpu",
                                     dtype=torch.float32,
                                     include_couplings=False)
    op64 = sp.SparseLevelOp.assemble(33, 2, gids, device="cpu", dtype=F64,
                                     include_couplings=False)
    assert op32.form == ("stencil" if len(gids) == 1 else "dia")
    rng = np.random.default_rng(9)
    u = [rng.standard_normal(s) for s in op32.shapes]
    b = [rng.standard_normal(s) for s in op32.shapes]

    def state(xs, dt):
        ts = tuple(torch.as_tensor(x, dtype=dt) for x in xs)
        return ts[0] if len(ts) == 1 else ts

    for fn in ("apply", "residual"):
        args32 = [state(u, torch.float32)]
        args64 = [state(u, F64)]
        if fn == "residual":
            args32.insert(0, state(b, torch.float32))
            args64.insert(0, state(b, F64))
        got = getattr(op32, fn)(*args32)
        want = getattr(op64, fn)(*args64)
        got = (got,) if isinstance(got, torch.Tensor) else got
        want = (want,) if isinstance(want, torch.Tensor) else want
        for g, w in zip(got, want):
            _close(g.to(F64), w, rtol=1e-5)


def test_cpu_sparse_ops_launch_no_kernel():
    launches.clear()
    op = sp.SparseLevelOp.assemble(17, 0, (0, 1), device="cpu",
                                   dtype=torch.float32,
                                   include_couplings=False)
    op.apply((torch.ones(15, 15), torch.ones(7, 7)))
    assert op.form == "dia" and not launches
