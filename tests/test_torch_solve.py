"""The PyTorch port's mg-CG solve end to end against the JAX package
(CPU), its CLI (its artifact files, and ``-view 1`` against JAX's solver
dump), and its boundaries: no JAX import, no silent CPU run of a CUDA
request, and a clear refusal of what is not ported yet.  The V-cycle
family's solves are held against JAX in test_torch_vcycle.py, the CLI's
outputs in test_torch_outputs.py."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from multigrid_petsc_tpu.solvers.solve import solve as j_solve
from multigrid_petsc_tpu.utils.config import CycleType as JCT
from multigrid_petsc_tpu.utils.config import SmootherType as JST
from multigrid_petsc_tpu.utils.config import SolverConfig as JC
from multigrid_petsc_tpu_torch.solvers.solve import solve
from multigrid_petsc_tpu_torch.utils.config import (
    CycleType,
    SmootherType,
    SolverConfig,
)

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
BASE = dict(npts=513, grids=7, levels=7, rtol=1e-5, max_iter=30)


def test_mgcg_f32_matches_jax_mdma_path():
    """f32 against the JAX mdma path (its Pallas kernels in interpret
    mode; tree from level 1).  Tolerances of test_mdma.py:196-203: f32
    noise compounds through the recursion."""
    ref = j_solve(JC(cycle=JCT.MGCG, dtype="float32", backend="pallas",
                     **BASE))
    got = solve(SolverConfig(cycle=CycleType.MGCG, dtype="float32", **BASE),
                device="cpu")
    assert ref.path == "mdma" and got.path == "torch"
    assert got.converged and got.iters == int(ref.iters)
    np.testing.assert_allclose(got.rnorm, ref.rnorm, rtol=0.05)
    err = np.abs(got.u_fine - ref.u[0]).max() / np.abs(ref.u[0]).max()
    assert err < 1e-3


def test_mgcg_f64_matches_jax_generic_path():
    """f64 against the JAX generic PCG loop: the paths differ in reduction
    order (and the lagged solution update) only."""
    ref = j_solve(JC(cycle=JCT.MGCG, dtype="float64", backend="xla", **BASE))
    got = solve(SolverConfig(cycle=CycleType.MGCG, dtype="float64", **BASE),
                device="cpu")
    assert ref.path == "generic"
    assert got.converged and got.iters == int(ref.iters)
    np.testing.assert_allclose(got.rnorm, ref.rnorm, rtol=1e-8)
    err = np.abs(got.u_fine - ref.u[0]).max() / np.abs(ref.u[0]).max()
    assert err < 1e-10


@pytest.mark.parametrize("mesh,grids", [(0, 1), (1, 3), (2, 4)])
def test_mgcg_f64_matches_jax_on_other_hierarchies(mesh, grids):
    """A 1-level hierarchy (the generic loop), a 3-level one without a
    coarse tree, and a stretched-mesh 4-level one."""
    kw = dict(npts=33, mesh=mesh, grids=grids, levels=grids, rtol=1e-8,
              max_iter=100, dtype="float64")
    ref = j_solve(JC(cycle=JCT.MGCG, backend="xla", **kw))
    got = solve(SolverConfig(cycle=CycleType.MGCG, **kw), device="cpu")
    assert got.iters == int(ref.iters) and got.converged == bool(
        ref.converged)
    np.testing.assert_allclose(got.rnorm, ref.rnorm, rtol=1e-8, atol=1e-14)
    np.testing.assert_allclose(got.u_fine, ref.u[0], rtol=1e-10,
                               atol=1e-10 * np.abs(ref.u[0]).max())


def test_timed_rerun_reproduces_the_solve():
    cfg = SolverConfig(npts=65, grids=4, levels=4, cycle=CycleType.MGCG,
                       dtype="float64", rtol=1e-8)
    once = solve(cfg, device="cpu")
    twice = solve(cfg, device="cpu", timed=True)
    assert once.iters == twice.iters and twice.wall_time > 0
    np.testing.assert_array_equal(once.u_fine, twice.u_fine)


def test_cli_runs_on_cpu(tmp_path, monkeypatch, capsys):
    from multigrid_petsc_tpu_torch.poisson import main

    monkeypatch.chdir(tmp_path)
    rc = main(["-npts", "17", "-grids", "2", "-levels", "2", "-cycle", "101",
               "-device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "converged: True" in out and "path=torch" in out
    err_line = [l for l in out.splitlines() if l.startswith("error")][0]
    assert 1e-4 < float(err_line.split()[-3]) < 1e-2  # max error ~3e-3
    # The JAX CLI's banner ends the output, and its artifact files are
    # written to the working directory.
    assert out.splitlines()[-1] == "=" * 65
    assert "Devices:                   1 x cpu" in out
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        ["XgridData.dat", "YgridData.dat", "eData.dat", "rData.dat",
         "uData.dat"])
    assert (tmp_path / "uData.dat").read_text().count("\n") == 15


def test_cli_runs_vcycle_on_cpu(tmp_path, monkeypatch, capsys):
    """The reference's default cycle (-cycle 0, v = 3,3): the banner names
    it, and it converges like the JAX package's (5 iterations at 17^2)."""
    from multigrid_petsc_tpu_torch.poisson import main

    monkeypatch.chdir(tmp_path)
    rc = main(["-npts", "17", "-grids", "2", "-levels", "2", "-cycle", "0",
               "-v", "3,3", "-device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert out.startswith("V-cycle (cycle 0) smoother=jacobi")
    assert "iterations: 5  converged: True" in out and "path=torch" in out
    err_line = [l for l in out.splitlines() if l.startswith("error")][0]
    assert 1e-4 < float(err_line.split()[-3]) < 1e-2  # max error ~3e-3


def test_cli_requires_device(tmp_path, monkeypatch):
    """With no ``-device`` the CLI targets the card: without one it fails
    with the "no CUDA device" error (the CPU runs only on request)."""
    from multigrid_petsc_tpu_torch.poisson import main

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["-npts", "17", "-cycle", "101"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        solve(SolverConfig(npts=17, cycle=CycleType.MGCG))


def test_cli_view_raises(tmp_path, monkeypatch, capsys):
    """-view 1 (which raised until the views were ported) prints the
    per-level solver dump after the banner: JAX's view_solver of the same
    solve, but the op= tokens, which name the port's operators."""
    from multigrid_petsc_tpu.utils.views import view_solver as j_view
    from multigrid_petsc_tpu_torch.poisson import main

    monkeypatch.chdir(tmp_path)
    rc = main(["-npts", "17", "-grids", "2", "-levels", "2", "-cycle",
               "101", "-view", "1", "-device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert rc == 0
    ref = j_view(j_solve(JC(npts=17, grids=2, levels=2,
                            cycle=JCT.MGCG)).ctx).splitlines()
    got = out[out.index("=" * 65, out.index("=" * 65) + 1) + 1:]
    assert len(got) == len(ref) == 3
    assert got[1].split(" op=torch(generic) ") == ref[1].split(" op=xla ")
    assert got[2].split(" op=torch ") == ref[2].split(" op=xla ")
    assert got[0] == ref[0]


def test_port_never_imports_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import multigrid_petsc_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "from multigrid_petsc_tpu_torch.solvers.solve import solve\n"
        "from multigrid_petsc_tpu_torch.utils.config import SolverConfig, CycleType\n"
        "solve(SolverConfig(cycle=CycleType.MGCG), device='cpu')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'multigrid_petsc_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_cuda_request_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = SolverConfig(npts=17, cycle=CycleType.MGCG)
    with pytest.raises(RuntimeError, match="CUDA"):
        solve(cfg, device="cuda")


# The bf16 working dtype's refusals (ROADMAP Queue 1), one case each:
# (config changes, the item the message names; "plan": under a plan).
BF16_REFUSALS = [
    (dict(plan=True), "bf16 under a plan"),
    (dict(grids=3, levels=2), "bf16 merged grids"),
    (dict(precond_dtype="bfloat16"),
     "bf16 with outer_dtype / precond_dtype"),
]
# What the bf16 working dtype refused until the line smoothers, RBGS and
# the sparse backend were ported: (config changes, the item it was).
BF16_RUNS = [
    (dict(smoother=SmootherType.LINE_Y), "bf16 with the line smoothers"),
    (dict(coarse_smoother=SmootherType.RBGS), "bf16 with RBGS"),
    (dict(backend="sparse"), "bf16 with the sparse backend"),
]


@pytest.mark.parametrize("kw,item", BF16_REFUSALS,
                         ids=[c[1] for c in BF16_REFUSALS])
def test_unported_options_raise(kw, item):
    """A bf16 combination the port leaves out raises NotImplementedError
    naming its ROADMAP item, before anything is built (so the stand-in
    plan is never read)."""
    kw = dict(kw)
    plan = object() if kw.pop("plan", False) else None
    cfg = SolverConfig(**{**dict(npts=17, grids=2, levels=2,
                                 cycle=CycleType.MGCG, dtype="bfloat16"),
                          **kw})
    with pytest.raises(NotImplementedError, match="ROADMAP") as err:
        solve(cfg, device="cpu", plan=plan)
    assert f"precision, {item})" in str(err.value)


@pytest.mark.parametrize("kw,item", BF16_RUNS, ids=[c[1] for c in BF16_RUNS])
def test_bf16_ported_options_run(kw, item):
    """A bf16 combination the port once refused solves at 33^2: mg-CG
    converges to rtol 1e-2 in bf16 storage, with f32 residual norms."""
    cfg = SolverConfig(npts=33, grids=3, levels=3, cycle=CycleType.MGCG,
                       dtype="bfloat16", rtol=1e-2, max_iter=30, **kw)
    res = solve(cfg, device="cpu")
    assert res.converged and res.u.dtype == torch.bfloat16, item
    assert res.rnorm.dtype == np.float32


def test_jax_smoother_enum_values_match():
    assert [s.value for s in SmootherType] == [s.value for s in JST]
    assert [c.value for c in CycleType] == [c.value for c in JCT]
