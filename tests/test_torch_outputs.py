"""The port's CLI outputs against the JAX package's on the CPU: the
artifact files (``postprocess.write_artifacts``), the run banner
(``utils.logging.print_info``), the diagnostic views (``utils.views``),
the checkpoint (``utils.checkpoint``) and the phase profiler
(``utils.profiling``, ``solve(profile_phases=True)``).

* Both writers, given one array, write byte-identical files (``-moreNorm``
  files included), in f64 and f32, on every mesh; the port's process pool
  writes what its single process writes.
* Both CLIs at 17^2 in f64 write the same files with the same layout: the
  grid files byte for byte, the solution within 1e-12 of its largest
  entry, the history and error norms within 1e-10 relative.
* ``print_info`` given the same numbers prints JAX's lines but
  ``Devices:``; the views print JAX's text (``view_solver`` but its
  ``op=`` tokens; the 4-rank row plan's is in test_torch_dist.py).
* The checkpoint fingerprint is JAX's; either package loads the other's
  checkpoint; a resumed port solve matches JAX's resumed solve in f64
  (iterations equal, history within 1e-10).
"""

from __future__ import annotations

import re
import types

import jax
import numpy as np
import pytest
import torch

from multigrid_petsc_tpu import postprocess as jpost
from multigrid_petsc_tpu.hierarchy import build_hierarchy as j_hierarchy
from multigrid_petsc_tpu.mesh import MeshType as JMesh
from multigrid_petsc_tpu.poisson import main as j_main
from multigrid_petsc_tpu.solvers.solve import solve as j_solve
from multigrid_petsc_tpu.utils import checkpoint as jck
from multigrid_petsc_tpu.utils import logging as jlog
from multigrid_petsc_tpu.utils import views as jviews
from multigrid_petsc_tpu.utils.config import CycleType as JCT
from multigrid_petsc_tpu.utils.config import SmootherType as JST
from multigrid_petsc_tpu.utils.config import SolverConfig as JC
from multigrid_petsc_tpu_torch import postprocess as tpost
from multigrid_petsc_tpu_torch.hierarchy import build_hierarchy
from multigrid_petsc_tpu_torch.mesh import MeshType
from multigrid_petsc_tpu_torch.poisson import main
from multigrid_petsc_tpu_torch.solvers.context import build_context
from multigrid_petsc_tpu_torch.solvers.solve import solve
from multigrid_petsc_tpu_torch.utils import checkpoint as tck
from multigrid_petsc_tpu_torch.utils import logging as tlog
from multigrid_petsc_tpu_torch.utils import profiling as tprof
from multigrid_petsc_tpu_torch.utils import views as tviews
from multigrid_petsc_tpu_torch.utils.config import (
    CycleType,
    SmootherType,
    SolverConfig,
)

torch.set_num_threads(2)

FILES = ("uData.dat", "rData.dat", "eData.dat", "XgridData.dat",
         "YgridData.dat")


def _both(kw: dict):
    """(JAX config, port config) of the same fields (enums by value)."""
    def conv(jax):
        sm, cyc, cls = ((JST, JCT, JC) if jax else
                        (SmootherType, CycleType, SolverConfig))
        f = dict(kw)
        for k in ("smoother", "fine_smoother", "levels_smoother",
                  "coarse_smoother"):
            if k in f:
                f[k] = sm(f[k])
        if "level_smoothers" in f:
            f["level_smoothers"] = tuple(None if s is None else sm(s)
                                         for s in f["level_smoothers"])
        if "cycle" in f:
            f["cycle"] = cyc(f["cycle"])
        return cls(**f)

    return conv(True), conv(False)


def _artifacts(rng, dtype, shape=(23, 17)):
    u = (rng.standard_normal(shape) * 10.0 ** rng.integers(-3, 3, shape)
         ).astype(dtype)
    u[0, 0], u[1, 1] = 0.0, -0.0
    rnorm = np.abs(rng.standard_normal(6)).astype(dtype)
    errs = tuple(float(x) for x in np.abs(rng.standard_normal(3)))
    r_global = np.abs(rng.standard_normal(5))
    r_grid = {0: np.abs(rng.standard_normal(5)),
              1: np.abs(rng.standard_normal(5)).astype(np.float32)}
    return u, rnorm, errs, r_global, r_grid


@pytest.mark.parametrize("mesh", [0, 1, 2])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_write_artifacts_byte_identical(tmp_path, mesh, dtype):
    u, rnorm, errs, r_global, r_grid = _artifacts(
        np.random.default_rng(mesh), dtype)
    jpost.write_artifacts(tmp_path / "jax", JMesh(mesh), u, rnorm, errs,
                          r_global=r_global, r_grid=r_grid)
    tpost.write_artifacts(tmp_path / "port", MeshType(mesh),
                          torch.as_tensor(u), rnorm, errs,
                          r_global=r_global, r_grid=r_grid)
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert set(FILES) | {"rGlobal.dat", "rGrid0.dat", "rGrid1.dat"} == set(
        names)
    for name in names:
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes()), name


def test_write_artifacts_pool_writes_what_one_process_writes(
        tmp_path, monkeypatch):
    """A grid below the pool's size, then the same grid through a pool of
    two processes."""
    u, rnorm, errs, _, _ = _artifacts(np.random.default_rng(7), np.float32,
                                      shape=(3 * tpost.ROWS_PER_BLOCK + 5,
                                             41))
    tpost.write_artifacts(tmp_path / "one", MeshType(1), u, rnorm, errs)
    monkeypatch.setattr(tpost, "PARALLEL_MIN_VALUES", 0)
    monkeypatch.setattr(tpost, "MAX_WORKERS", 2)
    tpost.write_artifacts(tmp_path / "pool", MeshType(1), u, rnorm, errs)
    for name in FILES:
        assert ((tmp_path / "pool" / name).read_bytes()
                == (tmp_path / "one" / name).read_bytes()), name


def _layout(text: str) -> str:
    return re.sub(r"\d", "d", text)


@pytest.mark.parametrize("args", [
    ["-cycle", "0", "-v", "3,3"],
    ["-cycle", "101", "-mesh", "1"],
    ["-cycle", "1", "-grids", "2", "-levels", "1", "-iter", "10",
     "-moreNorm", "1"],
])
def test_cli_writes_jax_cli_files(tmp_path, monkeypatch, capsys, args):
    """Both CLIs at 17^2 in f64 (the reference's default type): the same
    files, the grid files byte for byte, the rest with JAX's layout and
    its values.  Both print the banner; the JAX CLI, which sees the test
    harness's 8 CPU devices, solves under its row plan."""
    args = ["-npts", "17", "-grids", "2", "-levels", "2", *args]
    for name, run in (("jax", lambda: j_main(args)),
                      ("port", lambda: main(args + ["-device", "cpu"]))):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        assert run() == 0
        out = capsys.readouterr().out
        assert out.count("=" * 65) == 2 and "Devices:" in out
    jd, td = tmp_path / "jax", tmp_path / "port"
    names = sorted(p.name for p in jd.iterdir())
    assert names == sorted(p.name for p in td.iterdir())
    assert set(FILES) <= set(names)
    if "-moreNorm" in args:
        assert {"rGlobal.dat", "rGrid0.dat", "rGrid1.dat"} <= set(names)
    for name in ("XgridData.dat", "YgridData.dat"):
        assert (td / name).read_bytes() == (jd / name).read_bytes()
    for name in names:
        jt, tt = (jd / name).read_text(), (td / name).read_text()
        assert _layout(tt) == _layout(jt), name
        jv, tv = (np.array(t.split(), dtype=np.float64) for t in (jt, tt))
        if name == "uData.dat":
            assert tt.count("\n") == 15 and tt.splitlines()[0].count(
                "    ") == 15
            np.testing.assert_allclose(tv, jv, rtol=0,
                                       atol=1e-12 * np.abs(jv).max())
        else:
            np.testing.assert_allclose(tv, jv, rtol=1e-10, atol=1e-15)


def _result(ctx, rng):
    return types.SimpleNamespace(
        rnorm=np.abs(rng.standard_normal(4)), iters=3, converged=True,
        cpu_time=0.125, wall_time=0.0625, ctx=ctx)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(npts=33, grids=4, levels=3, mesh=1, cycle=101,
         smoother="chebyshev", v=(2, 4)),
    dict(npts=33, grids=3, levels=3, mesh=2, coarse_smoother="rbgs"),
    dict(npts=33, grids=3, levels=3, level_v=(2, 3, 4),
         level_smoothers=("line_x", None, "rbgs")),
])
def test_print_info_matches_jax(capsys, kw):
    """The same numbers through both banners: JAX's lines, but Devices."""
    jcfg, tcfg = _both(kw)
    ctx = build_context(tcfg, device="cpu")
    errs = (1.25e-3, 0.5, 3.0e-2)
    rng = np.random.default_rng(3)
    jlog.print_info(jcfg, _result(None, rng), errs)
    jout = capsys.readouterr().out.splitlines()
    tlog.print_info(tcfg, _result(ctx, np.random.default_rng(3)), errs)
    tout = capsys.readouterr().out.splitlines()
    assert len(tout) == len(jout) == 18
    for j, t in zip(jout, tout):
        if j.startswith("Devices:"):
            assert j == f"Devices:                   {jax.device_count()} x cpu"
            assert t == "Devices:                   1 x cpu"
        else:
            assert t == j


@pytest.mark.parametrize("mesh", [0, 1, 2])
@pytest.mark.parametrize("npts", [9, 33])
def test_view_mesh_matches_jax(mesh, npts):
    assert tviews.view_mesh(MeshType(mesh), npts) == jviews.view_mesh(
        JMesh(mesh), npts)


@pytest.mark.parametrize("npts,grids,levels", [(33, 4, 3), (65, 5, 5),
                                               (17, 3, 1)])
def test_view_hierarchy_matches_jax(npts, grids, levels):
    assert (tviews.view_hierarchy(build_hierarchy(npts, grids, levels))
            == jviews.view_hierarchy(j_hierarchy(npts, grids, levels)))


@pytest.mark.parametrize("max_gap", [1, 3, 4])
def test_view_transfer_operators_matches_jax(max_gap):
    assert (tviews.view_transfer_operators(max_gap)
            == jviews.view_transfer_operators(max_gap))


@pytest.mark.parametrize("mesh,level", [(0, 0), (2, 0), (1, 2)])
def test_view_operator_matches_jax(mesh, level):
    """Level 2 of 33^2 / 4 grids / 3 levels merges two grids."""
    jcfg, tcfg = _both(dict(npts=33, grids=4, levels=3, mesh=mesh))
    jctx = types.SimpleNamespace(
        config=jcfg, levels=[types.SimpleNamespace(spec=s) for s in
                             j_hierarchy(33, 4, 3)])
    assert (tviews.view_operator(build_context(tcfg, device="cpu"), level)
            == jviews.view_operator(jctx, level))


OP = r" op=([^ (]+(\([^)]*\))?)"


def _without_op(text: str) -> list[str]:
    return [re.sub(OP, "", ln) for ln in text.splitlines()]


@pytest.mark.parametrize("kw", [
    dict(npts=33, grids=3, levels=3, cycle=0),
    dict(npts=33, grids=3, levels=3, cycle=101, smoother="chebyshev"),
    dict(npts=33, grids=4, levels=3, cycle=0, mesh=1),
    dict(npts=33, grids=3, levels=3, cycle=101, backend="sparse"),
    dict(npts=33, grids=3, levels=3, cycle=0, coarse_solver="smooth",
         coarse_smoother="rbgs", v=(3, 20)),
    dict(npts=33, grids=3, levels=3, cycle=103, smoother="line_xy",
         problem="aniso", aniso=(100.0, 0.0, 1.0, 0.0, 0.0)),
])
def test_view_solver_matches_jax(kw):
    """Matrix-free, merged and sparse contexts after a solve: JAX's text
    but the op= tokens, which name the port's operators."""
    jcfg, tcfg = _both(dict(kw, rtol=1e-8, max_iter=60))
    ref = jviews.view_solver(j_solve(jcfg).ctx)
    res = solve(tcfg, device="cpu")
    got = tviews.view_solver(res.ctx)
    assert _without_op(got) == _without_op(ref)
    ops = [m.group(1) for m in re.finditer(OP, got)]
    assert len(ops) == kw["levels"]
    if kw.get("backend") == "sparse":
        assert all(o.startswith("sparse(") for o in ops)
        assert "op=sparse(" in ref
    else:
        assert ops[0] == ("torch" if res.route is None
                          else f"torch({res.route})")
        assert set(ops[1:]) == {"torch"}


# Configurations whose fingerprints must agree (JAX's config fields).
PRINTS = [
    dict(),
    dict(npts=65, grids=4, levels=4, cycle=101, dtype="float32",
         rtol=1e-5, smoother="chebyshev"),
    dict(problem="aniso", aniso=(1.0, 0.0, 100.0, 0.0, 0.0),
         smoother="line_y", level_v=(2, 3)),
    dict(npts=33, grids=3, levels=3, level_smoothers=("rbgs", None,
                                                      "line_xy"),
         coarse_smoother="line_x", outer_dtype="float64"),
]


@pytest.mark.parametrize("kw", PRINTS)
def test_checkpoint_fingerprint_is_jax(kw):
    jcfg, tcfg = _both(kw)
    assert tck._fingerprint(tcfg) == jck._fingerprint(jcfg)


def test_checkpoints_load_across_packages(tmp_path):
    jcfg, tcfg = _both(dict(npts=33, grids=3, levels=3, cycle=101))
    rng = np.random.default_rng(5)
    u, rnorm = (rng.standard_normal((31, 31)),), np.abs(rng.standard_normal(3))
    jck.save(tmp_path / "jax.npz", jcfg, u, rnorm, 2)
    tck.save(tmp_path / "port.npz", tcfg, torch.as_tensor(u[0]), rnorm, 2)
    for path in ("jax.npz", "port.npz"):
        for load, cfg in ((tck.load, tcfg), (jck.load, jcfg)):
            got_u, got_r, it = load(tmp_path / path, cfg)
            assert it == 2 and len(got_u) == 1
            np.testing.assert_array_equal(got_u[0], u[0])
            np.testing.assert_array_equal(got_r, rnorm)
    other = SolverConfig(npts=33, grids=3, levels=3, cycle=CycleType.VCYCLE)
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        tck.load(tmp_path / "jax.npz", other)


@pytest.mark.parametrize("kw", [
    dict(npts=129, grids=5, levels=5, cycle=101),
    dict(npts=129, grids=5, levels=5, cycle=0, smoother="rbgs", mesh=1),
])
def test_resume_from_checkpoint_matches_jax(tmp_path, kw):
    """2 iterations, a checkpoint, and the solve resumed from it in both
    packages (f64): JAX's iterations, its history within 1e-10 relative
    (1e-13 absolute: the true residual's roundoff relative to ||b||), its
    solution; each package resumes from the other's checkpoint."""
    jcfg, tcfg = _both(dict(kw, rtol=1e-8, max_iter=60))
    import dataclasses

    jpart = j_solve(dataclasses.replace(jcfg, max_iter=2))
    tpart = solve(dataclasses.replace(tcfg, max_iter=2), device="cpu")
    jck.save(tmp_path / "jax.npz", jcfg, jpart.u, jpart.rnorm, jpart.iters)
    tck.save(tmp_path / "port.npz", tcfg, tpart.u_grids, tpart.rnorm,
             tpart.iters)
    ju0, _, jit = jck.load(tmp_path / "port.npz", jcfg)
    tu0, _, tit = tck.load(tmp_path / "jax.npz", tcfg)
    assert jit == tit == 2
    ref = j_solve(jcfg, u0=ju0)
    got = solve(tcfg, device="cpu", u0=tu0)
    assert got.converged and bool(ref.converged)
    assert got.iters == int(ref.iters)
    np.testing.assert_allclose(got.rnorm, ref.rnorm, rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(got.u_fine, ref.u_fine, rtol=0,
                               atol=1e-10 * np.abs(ref.u_fine).max())


def test_profile_phases_has_jax_keys(tmp_path):
    cfg = SolverConfig(npts=33, grids=3, levels=3, max_iter=30)
    res = solve(cfg, device="cpu", profile_phases=True)
    jres = j_solve(JC(npts=33, grids=3, levels=3, max_iter=30),
                   profile_phases=True)
    keys = {"smooth_v", "residual", "restrict", "prolong", "norm"}
    assert keys | {"solve"} == set(res.phases)
    assert keys | {"solve", "compile"} == set(jres.phases)
    assert all(v > 0 for v in res.phases.values())
    assert set(tprof.phase_breakdown(res.ctx, v=1, reps=2)) == keys
    with tprof.trace(tmp_path / "trace") as logdir:
        solve(cfg, device="cpu")
    assert (logdir / "trace.json").stat().st_size > 0
