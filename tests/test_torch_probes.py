"""The attribution probes' kernels (KP1-KP3) and the port's probes against
the JAX package's attribution probes (``benchmarks/probe_*.py``) on the
CPU: each plain version against the probe's Pallas kernel run in
interpret mode on the same inputs (numpy, from a seed), on 255^2 and
383^2 grids (one to three of the kernels' row tiles).

  KP1  ``probe_kernel.visit_ablate_plain`` against ``variant_visit``
       (``probe_visit_vpu.py``, every mode) and ``down_variant``
       (``probe_mdma_vpu.py``, built into its ``pallas_call`` as the probe
       builds it; ``dmaonly``: u only, its rc is uninitialised scratch)
  KP2  ``scale_copy`` / ``scale_copy_`` chains against ``_copy_chain``
       (``probe_cg_ablate.py``, alias off and on)
  KP3  ``staged_visit_pipeline_plain`` against ``probe_dma_parts.variant``
       (u where the probe defines it: without the carry the first H rows
       of every tile but the first are whatever its buffer held; its rc is
       never written)

Tolerances: the production body (``base``, ``roll``, ``full``) and the
copies bit for bit; the other modes 1e-5 of the largest entry (f32: the
port's plain versions order each sum as the kernels do, and the JAX
``nomask`` rounds its absorbing rows otherwise).  Then the mg-CG loop
ablation (``probes/cg_ablate.py``) at 129^2 / 5 levels: ``full`` equals
the solver's own iterations bit for bit on both routes, and the fused
route's four modes equal JAX's ``probe_cg_ablate.py:104-130`` body, run
here on a JAX CPU context with its fused kernels in interpret mode, after
3 iterations, to 1e-8 of each array's largest entry, and the mdma
route's four modes equal the fused route's bit for bit.  Those comparisons
run in f64: in f32 the state after three iterations sits at the roundoff
floor (<r, z> is a cancellation whose last digits the two packages' sums
order differently, 4e-4 apart after one iteration, which moves r by 3%).
Last, every probe's CPU run prints its schema.

Importing the JAX probes has side effects, undone here: each sets JAX's
persistent compilation cache, and ``probe_mdma_vpu.py`` reads
``sys.argv[1]`` as its grid size.
"""

from __future__ import annotations

import functools
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from multigrid_petsc_tpu.mesh import MeshType as JMesh
from multigrid_petsc_tpu.ops.pallas import mdma_kernel as jmdma
from multigrid_petsc_tpu.ops.pallas import stencil_kernel as jsk
from multigrid_petsc_tpu.problems import stencil_coefficients as j_coeffs
from multigrid_petsc_tpu.solvers.context import build_context as j_build
from multigrid_petsc_tpu.solvers.vcycle import mg_apply_cgdown as j_cgdown
from multigrid_petsc_tpu.solvers.vcycle import mg_apply_dot as j_apply_dot
from multigrid_petsc_tpu.utils.config import CycleType as JCT
from multigrid_petsc_tpu.utils.config import SolverConfig as JC
from multigrid_petsc_tpu_torch.ops.cuda import launches
from multigrid_petsc_tpu_torch.ops.cuda import pipeline_kernel as plk
from multigrid_petsc_tpu_torch.ops.cuda import probe_kernel as pk
from multigrid_petsc_tpu_torch.ops.cuda import stream_kernel as sk
from multigrid_petsc_tpu_torch.ops.stencil import from_numpy_stencil
from multigrid_petsc_tpu_torch.probes import PROBES
from multigrid_petsc_tpu_torch.probes import cg_ablate as ca
from multigrid_petsc_tpu_torch.solvers import krylov as kr
from multigrid_petsc_tpu_torch.solvers.context import build_context
from multigrid_petsc_tpu_torch.utils.config import CycleType, SolverConfig

torch.set_num_threads(2)

BENCH = Path(__file__).resolve().parents[1] / "benchmarks"
STEPS = jsk.jacobi_step_coeffs(3, 0.8)
F32 = jnp.float32


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
    """The JAX probes, loaded once."""
    return {n: _load(n) for n in ("probe_visit_vpu", "probe_mdma_vpu",
                                  "probe_cg_ablate", "probe_dma_parts")}


def _problem(n: int, seed: int):
    """(JAX stencil, port stencil, b as numpy) of the uniform n^2 f32
    Poisson level."""
    jst = j_coeffs(JMesh.UNIFORM, n, n, F32)
    tst = from_numpy_stencil([np.asarray(c) for c in jst], "cpu",
                             torch.float32)
    b = np.random.default_rng(seed).standard_normal((n, n)).astype(np.float32)
    return jst, tst, b


def _same(got: torch.Tensor, want, exact: bool, tol: float = 1e-5):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=tol * np.abs(want).max())


def test_modes_and_aliases():
    assert pk.mode_of("full") == pk.mode_of("roll") == "base"
    assert pk.mode_of("dmaonly") == "loadstore"
    assert set(pk.MODES) == {"base", "norm", "nomask", "norestrict",
                             "nosweep", "loadstore"}
    with pytest.raises(ValueError, match="mode must be one of"):
        pk.mode_of("fast")
    with pytest.raises(ValueError, match="mode must be one of"):
        plk.staged_visit_pipeline(torch.zeros(7, 7), 32, "v_fast")


@pytest.mark.parametrize("mode, n", [
    (m, n) for m in ("base", "norm", "roll", "nomask") for n in (255, 383)
] + [("base", 511), ("roll", 511)])
def test_visit_ablate_plain_matches_variant_visit(jp, mode, n):
    """255^2: one of the probe's 256-row tiles; 383^2: two, the last
    ragged; 511^2: two whole ones."""
    pv = jp["probe_visit_vpu"]
    jst, tst, b = _problem(n, n)
    cols_raw = jnp.concatenate(
        [c.reshape(1, -1) for c in pv._coeff_cols(jst, n, F32)], axis=0)
    cc = cols_raw[2:3]
    cols_norm = jnp.concatenate(
        [cols_raw[0:1] / cc, cols_raw[1:2] / cc, 1.0 / cc,
         cols_raw[3:4] / cc, cols_raw[4:5] / cc, cc], axis=0)
    t = pv._pick_tile(n, F32, bufs=12, cap=256)
    g = pl.cdiv(n, t)
    slabs = pv._build_slabs(cols_norm if mode == "norm" else cols_raw, n, t,
                            g, 3 + 2, absorbing=(mode == "nomask"))
    with pltpu.force_tpu_interpret_mode():
        ju, jrc = pv.variant_visit(slabs, jnp.asarray(b), STEPS, mode)
    u, rc = pk.visit_ablate(tst, torch.from_numpy(b), STEPS, mode)
    # With a ragged last tile (383^2) the interpreted kernel (and JAX's
    # production visit, which it equals there) rounds apart from the plain
    # version on every row, by about an f32 ulp of the largest entry
    # (9.1e-13 on u, whose entries reach 9.3e-6; 1.8e-7 on rc, up to
    # 0.89), so the production body is held bit for bit on whole tiles
    # and to 1e-6 of the largest entry there.
    exact = mode in ("base", "roll") and n % 256 in (0, 255)
    tol = 1e-6 if mode in ("base", "roll") else 1e-5
    _same(u, ju, exact, tol)
    _same(rc, jrc, exact, tol)


def _down_variant(pm, n: int, mode: str, b: np.ndarray):
    """``probe_mdma_vpu.py``'s pallas_call of ``down_variant`` (:206-226)
    at n^2, in interpret mode; returns (u, rc) cut to the real points."""
    nyp, nxp = jmdma.shape_pad(n, n)
    nyc = (n - 1) // 2
    nycp, nxcp = jmdma.shape_pad(nyc, nyc)
    jst = j_coeffs(JMesh.UNIFORM, n, n, F32)
    t, g = jmdma._tile_geometry(n, nxp, 4)
    slabs = pm._coeff_slabs(jst, n, t, g, jsk._compute_dtype(F32))
    t2 = t + 2 * pm.H
    coeff = pl.BlockSpec((1, 5, t2, 1), lambda i: (i, 0, 0, 0),
                         memory_space=pltpu.VMEM)
    any_spec = pl.BlockSpec(memory_space=pl.ANY)
    call = pl.pallas_call(
        pm.down_variant(n, n, nxp, t, g, STEPS, nyc, nyc, nxcp, mode),
        grid=(g,), in_specs=[coeff, any_spec],
        out_specs=[any_spec, any_spec],
        out_shape=[jax.ShapeDtypeStruct((nyp, nxp), F32),
                   jax.ShapeDtypeStruct((nycp, nxcp), F32)],
        scratch_shapes=[pltpu.VMEM((2, t2, nxp), F32),
                        pltpu.VMEM((2, t, nxp), F32),
                        pltpu.VMEM((2, t // 2, nxcp), F32),
                        pltpu.SemaphoreType.DMA((2, 1)),
                        pltpu.SemaphoreType.DMA((2, 2))],
        interpret=True)
    bp = jnp.zeros((nyp, nxp), F32).at[:n, :n].set(jnp.asarray(b))
    u, rc = call(slabs, bp)
    return np.asarray(u)[:n, :n], np.asarray(rc)[:nyc, :nyc], g


@pytest.mark.parametrize("mode", ["full", "norestrict", "nosweep",
                                  "dmaonly"])
def test_visit_ablate_plain_matches_down_variant(jp, mode):
    n = 255
    _, tst, b = _problem(n, 7)
    ju, jrc, g = _down_variant(jp["probe_mdma_vpu"], n, mode, b)
    assert g == 3  # three row tiles
    u, rc = pk.visit_ablate(tst, torch.from_numpy(b), STEPS, mode)
    exact = mode == "full"
    _same(u, ju, exact or mode == "dmaonly")
    if mode != "dmaonly":  # the TPU kernel's rc is its scratch's
        _same(rc, jrc, exact)


@pytest.mark.parametrize("alias", [False, True])
def test_copy_chains_match_copy_chain(jp, alias):
    n = 512  # two of the probe's 256-row tiles
    x = np.random.default_rng(11).standard_normal((n, n)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jp["probe_cg_ablate"]._copy_chain(n, 3, alias)(
            jnp.asarray(x)))
    u = torch.from_numpy(x.copy())
    launches.clear()
    for _ in range(3):
        u = sk.scale_copy_(u, 1.0001) if alias else sk.scale_copy(u, 1.0001)
    assert not launches  # the plain versions on the CPU
    np.testing.assert_array_equal(u.numpy(), want)
    v = torch.from_numpy(x.copy())
    assert sk.scale_copy_(v, 1.0001) is v  # in place


@pytest.mark.parametrize("mode", list(plk.PIPE_MODES))
def test_pipeline_plain_matches_dma_parts_variant(jp, mode):
    n, t = 255, 96
    pdp = jp["probe_dma_parts"]
    H = jp["probe_mdma_vpu"].H
    nyp, nxp = jmdma.shape_pad(n, n)
    nyc = (n - 1) // 2
    nycp, nxcp = jmdma.shape_pad(nyc, nyc)
    g = pl.cdiv(n, t)
    kern, rc_on = pdp.variant(n, nxp, t, g, nyc, nxcp, mode)
    any_spec = pl.BlockSpec(memory_space=pl.ANY)
    call = pl.pallas_call(
        kern, grid=(g,), in_specs=[any_spec],
        out_specs=[any_spec, any_spec],
        out_shape=[jax.ShapeDtypeStruct((nyp, nxp), F32),
                   jax.ShapeDtypeStruct((nycp, nxcp), F32)],
        scratch_shapes=[pltpu.VMEM((2, t + 2 * H, nxp), F32),
                        pltpu.VMEM((2, t, nxp), F32),
                        pltpu.VMEM((2, t // 2, nxcp), F32),
                        pltpu.SemaphoreType.DMA((2, 1)),
                        pltpu.SemaphoreType.DMA((2, 2))],
        interpret=True)
    b = np.random.default_rng(13).standard_normal((n, n)).astype(np.float32)
    bp = jnp.zeros((nyp, nxp), F32).at[:n, :n].set(jnp.asarray(b))
    ju = np.asarray(call(bp)[0])[:n, :n]
    u, rc = plk.staged_visit_pipeline(torch.from_numpy(b), 32, mode)
    assert rc_on == (rc is not None)
    carried = plk.PIPE_MODES[mode][0]
    rows = np.ones(n, bool)  # where the probe defines u
    if not carried:
        for i in range(1, g):
            rows[i * t:i * t + H] = False
    np.testing.assert_array_equal(u.numpy()[rows], ju[rows])
    if rc is not None:
        np.testing.assert_array_equal(rc.numpy(), b[1::2, 1::2])


CG_KW = dict(npts=129, grids=5, levels=5, dtype="float32")
CG_KW64 = dict(CG_KW, dtype="float64")


@pytest.mark.parametrize("route", ca.ROUTES)
def test_cg_ablate_full_equals_the_solver(route):
    """Three iterations of the probe's ``full`` body are the solver's
    first three, bit for bit (the mdma route's lagged update flushed)."""
    cfg = SolverConfig(cycle=CycleType.MGCG, rtol=1e-30, max_iter=3,
                       **CG_KW)
    ctx = build_context(cfg, device="cpu")
    solver = (kr._solve_mgcg_fused if route == "fused"
              else kr._solve_mgcg_fused_mdma)
    ref = solver(ctx, ctx.b0)
    assert ref.iters == 3
    step = ca.cg_step(ctx, route, "full")
    state = ca.cg_start(ctx, route)
    for _ in range(3):
        state = step(state)
    u = state[0] if route == "fused" else state[0] + state[6] * state[3]
    np.testing.assert_array_equal(u.numpy(), ref.u.numpy())


def _jax_fused_ctx():
    """JAX's f32 CPU context with level 0's fused CG kernels wired in
    interpret mode, as the TPU context wires them (the probe's body calls
    them)."""
    jctx = j_build(JC(cycle=JCT.MGCG, **CG_KW64))
    lvl = jctx.levels[0]
    st0 = lvl.stencils[0]

    def visit_down(b, u, sweeps):
        u0, rc1 = jsk.fused_level_visit_pallas(
            st0, b[0], None if u is None else u[0],
            jsk.jacobi_step_coeffs(sweeps, 0.8), emit="rc", interpret=True)
        return (u0,), rc1

    def visit_up_dot(b, u, e_c, sweeps):
        z, dot = jsk.fused_level_visit_pallas(
            st0, b[0], u[0], jsk.jacobi_step_coeffs(sweeps, 0.8), emit="u",
            e_coarse=e_c, emit_dot=True, interpret=True)
        return (z,), dot

    def cg_visit_down(r, ap, alpha, sweeps):
        return jsk.cg_visit_down_pallas(st0, r, ap, alpha,
                                        jsk.jacobi_step_coeffs(sweeps, 0.8),
                                        interpret=True)

    lvl.visit_down = visit_down
    lvl.visit_up_dot = visit_up_dot
    lvl.papply = functools.partial(jsk.cg_papply_pallas, st0, interpret=True)
    lvl.cg_visit_down = cg_visit_down
    return jctx


def _jax_body(ctx, mode: str):
    """``probe_cg_ablate.py:104-130``'s loop body, as the probe writes it."""
    lvl0 = ctx.levels[0]
    v0, v1 = ctx.config.v
    nyc = (CG_KW["npts"] - 2 - 1) // 2

    def one(c):
        u, r, z, p, rz, beta = c
        if mode == "nopapply":
            p0, ap, pap = p, z, jnp.sum(z * z) + 1.0
        else:
            p0, ap, pap = lvl0.papply(z, p, beta)
        alpha = rz / pap
        if mode != "noupd":
            u = u + alpha * p0
        if mode == "nocoarse":
            u0, rc1, r_new, rn2 = lvl0.cg_visit_down(r, ap, alpha, v0)
            e_c = rc1[:, :nyc] * 0.123
            zz, rzn = lvl0.visit_up_dot((r_new,), (u0,), e_c, v0)
            z, rz_new = zz[0], rzn
        else:
            zt, rz_new, r_new, rn2 = j_cgdown(ctx, r, ap, alpha, v0, v1)
            z = zt[0]
        beta = rz_new / rz
        return (u, r_new, z, p0, rz_new, beta)

    return jax.jit(one)


@pytest.fixture(scope="module")
def jax_cg():
    """JAX's wired f64 context, the probe's start state (from
    ``mg_apply_dot``) and the port's context on JAX's right-hand side (the
    two packages' right-hand sides differ by an ulp on ~1% of points)."""
    jctx = _jax_fused_ctx()
    v0, v1 = jctx.config.v
    b = jctx.b0[0]
    z0, rz0 = jax.jit(lambda r: j_apply_dot(jctx, (r,), v0, v1))(b)
    start = (jnp.zeros_like(b), b, z0[0], jnp.zeros_like(b), rz0,
             jnp.asarray(0.0, rz0.dtype))
    ctx = build_context(SolverConfig(cycle=CycleType.MGCG, **CG_KW64),
                        device="cpu")
    ctx.b0 = torch.from_numpy(np.array(b))
    return jctx, start, ctx


@pytest.mark.parametrize("mode", ca.MODES)
def test_cg_ablate_fused_modes_match_jax_body(jax_cg, mode):
    jctx, state, ctx = jax_cg
    body = _jax_body(jctx, mode)
    for _ in range(3):
        state = body(state)
    step = ca.cg_step(ctx, "fused", mode)
    got = ca.cg_start(ctx, "fused")
    for _ in range(3):
        got = step(got)
    for name, g, w in zip(("u", "r", "z", "p"), got, state):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-8 * np.abs(w).max(),
                                   err_msg=f"{mode} {name}")


@pytest.mark.parametrize("mode", ca.MODES)
def test_cg_ablate_mdma_modes_match_the_fused_modes(jax_cg, mode):
    """The main path's body in each mode equals the fused route's (held to
    JAX's above) bit for bit: both compute the same preconditioner, and in
    each mode the same A p and <p, A p>.  Both start from the state after
    one ``full`` iteration, so that p is not 0 and the mdma route has a
    lagged update pending; u is compared once that is flushed (noupd: u is
    each route's start, the pending update never applied)."""
    _, _, ctx = jax_cg
    plan = kr.mdma_plan(ctx)
    f0 = ca.cg_step(ctx, "fused", "full")(ca.cg_start(ctx, "fused"))
    m0 = ca.cg_step(ctx, "mdma", "full", plan)(ca.cg_start(ctx, "mdma",
                                                           plan))
    f, m = f0, m0
    fused, main = (ca.cg_step(ctx, "fused", mode),
                   ca.cg_step(ctx, "mdma", mode, plan))
    for _ in range(3):
        f, m = fused(f), main(m)
    if mode == "noupd":
        assert torch.equal(f[0], f0[0]) and torch.equal(m[0], m0[0])
    else:
        np.testing.assert_array_equal((m[0] + m[6] * m[3]).numpy(),
                                      f[0].numpy(), err_msg=f"{mode} u")
    for name, g, w in zip(("r", "z", "p", "rz"), m[1:5], f[1:5]):
        np.testing.assert_array_equal(g.numpy(), w.numpy(),
                                      err_msg=f"{mode} {name}")


PROBE_ROWS = {
    "visit_vpu": ["base", "norm", "roll", "nomask"],
    "mdma_vpu": ["full", "norestrict", "nosweep", "dmaonly"],
    "halo_cost": ["halo_wins", "gather_e", "restrict_fw",
                  "prolong_bilinear", "kernel_only"],
    "cg_ablate": ["(a) straight-line copy, alias=False",
                  "(a) straight-line copy, alias=True"]
    + [f"(b) cg body {r:5s} {m:9s}" for r in ca.ROUTES for m in ca.MODES],
    "dma": ["D library triad", "A K18a copy", "B KP2 copy in place",
            "C KP3 staged copy", "C1 KP3 staged copy"],
    "dma_parts": ["v_full    t= 32", "v_norc    t= 32", "v_nocarry t= 32",
                  "v_direct  t= 32", "v_bare    t= 32"],
    "windows_ab": ["round 0: apply"],
    "transpose": ["noop    :", "apply8  :", "arith   :", "shuffle :",
                  "full    :", "prolong :"],
}


@pytest.mark.parametrize("name", PROBES)
def test_probe_cpu_run_prints_its_schema(name, capsys):
    """``python -m multigrid_petsc_tpu_torch.probes <name> --device cpu``
    at a small n: the header (what ran where, K18a's rate not measured,
    the columns) and one line a row, in the JAX probe's order."""
    from multigrid_petsc_tpu_torch.probes.__main__ import main

    argv = [name, "--device", "cpu", "--n", "64" if name == "cg_ablate"
            else "63", "--quick"]
    launches.clear()
    assert main(argv) == 0
    assert not launches  # plain versions only
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"probe {name} on cpu: plain versions")
    assert out[1] == "K18a stream rate: not measured (cpu)"
    assert out[2].startswith("columns: ")
    rows = out[3:]
    assert len(rows) == len(PROBE_ROWS[name])
    for line, label in zip(rows, PROBE_ROWS[name]):
        assert line.startswith(label), (line, label)
        assert "none --" in line or " ms" in line


def test_mirrors_match_the_sources():
    """The wrappers' copies of the kernels' constants are the sources':
    KP1's mode numbers (visit.cuh Probe5), KP3's tile columns, chunk, unit
    and halo (pipeline.cu TW, CHUNK, SEG, HALO)."""
    csrc = Path(pk.__file__).resolve().parents[2] / "csrc"
    cuh = (csrc / "visit.cuh").read_text()
    for mode, k in pk.MODES.items():
        if mode != "base":
            assert f"P_{mode.upper()} = {k}," in cuh or (
                f"P_{mode.upper()} = {k}\n" in cuh), mode
    assert "P_PROD = 0," in cuh
    cu = (csrc / "pipeline.cu").read_text()
    assert f"constexpr int TW = {plk.TILE_COLS};" in cu
    assert f"constexpr int CHUNK = {plk.CHUNK};" in cu
    assert f"constexpr int SEG = {plk.SEG};" in cu
    assert f"constexpr int HALO = {plk.HALO};" in cu
    assert pk.MAX_PROBE_STEPS == 6  # halo k + 2 <= V5_SHORT_MAX_H = 8
