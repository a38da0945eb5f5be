"""Row-partition distribution of the port against the JAX package on the
CPU, part 2: K17's plain version on the 9-point (1, 0.5, 100, 0.3, 0.2)
stencil, whose centre is an (ny, nx) field, against JAX's ``DistLevelOps``
in interpret mode, every emit; a 4-rank gloo world (``_dist_worker.py``,
started once for the module) solving MG-Richardson, FMG, Chebyshev mg-CG,
the stretched mesh, a merged last level the plan replicates, a warm
start and the anisotropic mg-CG, each held to JAX's single-device solve
(``backend="xla"``, which JAX's own tests hold to its distributed one at
1e-6) and to JAX's level split under a 4-device ``row_plan``
(``build_context`` without a solve); the CLI under ``torchrun``; the CSR
assembler's library name.

Tolerances as part 1 (test_torch_dist.py), with JAX's 9-point ones for
the 9-point visit; the warm start as JAX's test holds its own (u_fine to
rtol 1e-5 / atol 1e-11).
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _dist_worker as dw
from multigrid_petsc_tpu.parallel.device_mesh import row_plan as j_row_plan
from multigrid_petsc_tpu.problems import AnisoProblem as JAniso
from multigrid_petsc_tpu.problems import stencil9_coefficients as j_coeffs9
from multigrid_petsc_tpu.solvers.context import build_context as j_build
from multigrid_petsc_tpu.solvers.solve import solve as j_solve
from multigrid_petsc_tpu.utils.config import CycleType as JCT
from multigrid_petsc_tpu.utils.config import SmootherType as JST
from multigrid_petsc_tpu.utils.config import SolverConfig as JC
from multigrid_petsc_tpu_torch.ops.cuda import _build
from multigrid_petsc_tpu_torch.ops.stencil import from_numpy_stencil9
from test_torch_dist import EMITS, check_visit

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
BASE = dict(npts=129, grids=4, levels=4)
# name -> (SolverConfig fields, min_local, warm start)
CONFIGS = {
    "PCMG": (dict(BASE, cycle=8, max_iter=60), 8, False),
    "FMG": (dict(BASE, cycle=103, max_iter=60), 8, False),
    "CHEB": (dict(BASE, cycle=101, smoother="chebyshev", max_iter=60), 8,
             False),
    "MESH2": (dict(BASE, cycle=0, mesh=2, max_iter=80), 8, False),
    "MERGED": (dict(npts=129, grids=5, levels=3, cycle=0, max_iter=80), 16,
               False),
    "WARM": (dict(BASE, cycle=0, max_iter=60), 8, True),
    "ANISO": (dict(npts=129, grids=3, levels=3, cycle=101, problem="aniso",
                   aniso=(1.0, 0.0, 100.0, 0.0, 0.0), smoother="jacobi",
                   rtol=1e-8, max_iter=40), 8, False),
}


def jax_config(fields: dict, **kw) -> JC:
    f = dict(fields, **kw)
    f["cycle"] = JCT(f["cycle"])
    if "smoother" in f:
        f["smoother"] = JST(f["smoother"])
    return JC(**f)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The module's 4-rank gloo world, started with the module's first
    test, so the ranks solve while the kernel tests run."""
    out = tmp_path_factory.mktemp("dist")
    procs = dw.spawn({name: {"cfg": f, "min_local": m, "warm": w}
                      for name, (f, m, w) in CONFIGS.items()}, out)
    state = {"done": False}

    def results():
        if not state["done"]:
            dw.finish(procs)
            state["done"] = True
        return out

    yield results
    for p in procs:
        if p.poll() is None:
            p.kill()


@pytest.fixture(scope="module", autouse=True)
def _start_world(world):
    return world


@pytest.mark.parametrize("emit", EMITS)
def test_k17_plain_matches_jax_9pt(emit):
    """The 9-point visit on the (1, 0.5, 100, 0.3, 0.2) stencil at 255^2
    (x-profiles, y-profiles, scalars and an (ny, nx) centre), JAX's
    ``tile_cap=8`` (its two-call split)."""
    jst = j_coeffs9(JAniso(1.0, 0.5, 100.0, 0.3, 0.2), 255, 255,
                    jnp.float64)
    assert np.asarray(jst.cc).shape == (255, 255)
    tst = from_numpy_stencil9([np.asarray(c) for c in jst], "cpu",
                              torch.float64)
    check_visit(jst, tst, 255, 255, emit, seed=21, tile_cap=8, nine=True)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_solve_matches_jax(world, name):
    fields, min_local, warm = CONFIGS[name]
    runs = dw.load(world(), name)
    r0 = runs[0]
    for r in runs[1:]:  # every rank holds the same result
        assert int(r["iters"]) == int(r0["iters"])
        np.testing.assert_array_equal(r["rnorm"], r0["rnorm"])
        np.testing.assert_array_equal(r["u"], r0["u"])
    plan = j_row_plan(devices=jax.devices()[:dw.WORLD], min_local=min_local)
    split = [lv.dist is not None for lv in j_build(
        jax_config(fields, backend="pallas"), plan=plan).levels]
    assert list(r0["dist"]) == split
    assert any(split), "no level ran sharded"
    ref = j_solve(jax_config(fields, backend="xla"))
    assert bool(r0["converged"]) and bool(ref.converged)
    if warm:
        np.testing.assert_allclose(r0["u"], ref.u_fine, rtol=1e-5,
                                   atol=1e-11)
        return
    assert int(r0["iters"]) == int(ref.iters)
    np.testing.assert_allclose(r0["rnorm"], ref.rnorm, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(r0["u"], ref.u_fine, rtol=1e-6, atol=1e-12)


def _cli(*args, cwd, nproc=None, timeout=240):
    """The CLI in a process (under torchrun with ``nproc``) in ``cwd``,
    where it writes its artifact files."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    cmd = [sys.executable]
    if nproc:
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            port = sk.getsockname()[1]
        cmd += ["-m", "torch.distributed.run", "--nproc_per_node",
                str(nproc), "--master_port", str(port)]
    cmd += ["-m", "multigrid_petsc_tpu_torch.poisson", *args]
    return subprocess.run(cmd, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=timeout)


def test_cli_two_ranks_matches_one(tmp_path):
    """-map 2 under torchrun: one banner (rank 0), the plan's line, and
    the one-process run's iterations and residual; rank 0 writes the
    artifact files from the gathered solution, the one-process run's up
    to the reduction order."""
    args = ("-npts", "129", "-grids", "4", "-levels", "4", "-cycle", "101",
            "-map", "2", "-device", "cpu")
    (tmp_path / "two").mkdir()
    (tmp_path / "one").mkdir()
    two = _cli(*args, cwd=tmp_path / "two", nproc=2)
    one = _cli(*args, cwd=tmp_path / "one")
    assert two.returncode == 0, two.stderr
    assert one.returncode == 0, one.stderr
    assert two.stdout.count("mg-CG (cycle 101)") == 1
    assert two.stdout.count("Devices:                   2 ranks x cpu "
                            "(transport gloo)") == 1
    assert "ranks=2 transport=gloo sharded levels=127,63" in two.stdout

    def lines(out, key):
        return [ln for ln in out.splitlines() if ln.startswith(key)]

    for key in ("iterations:", "relative residual:"):
        assert lines(two.stdout, key) == lines(one.stdout, key)
    for name in ("uData.dat", "XgridData.dat", "YgridData.dat"):
        got, want = ((tmp_path / d / name).read_text() for d in ("two",
                                                                 "one"))
        if name == "uData.dat":
            np.testing.assert_allclose(np.array(got.split(), float),
                                       np.array(want.split(), float),
                                       rtol=1e-6, atol=1e-12)
        else:
            assert got == want


def test_cli_blocks_layout_raises(tmp_path, monkeypatch, capsys):
    """``-map 0`` under torchrun on 3 ranks, which the blocks layout
    refused until it split any rank count (a 1x3 mesh splits the 127^2
    level along x, 127 // 3 >= 32, in blocks of 44, 42 and 42 columns):
    it runs, prints the one-process run's summary (iterations, residual,
    error norms) and the banner JAX's CLI prints for the same run under
    its blocks plan (the iterations line equal, the residual and error
    norms within 1e-6)."""
    from multigrid_petsc_tpu.poisson import main as j_main

    args = ("-npts", "129", "-grids", "4", "-levels", "4", "-cycle", "101",
            "-map", "0")
    (tmp_path / "three").mkdir()
    (tmp_path / "one").mkdir()
    (tmp_path / "jax").mkdir()
    three = _cli(*args, "-device", "cpu", cwd=tmp_path / "three", nproc=3)
    one = _cli(*args, "-device", "cpu", cwd=tmp_path / "one")
    assert three.returncode == 0, three.stderr
    assert one.returncode == 0, one.stderr
    assert ("distributed: ranks=3 mesh=1x3 transport=gloo sharded "
            "levels=127") in three.stdout

    def lines(out, keys):
        return [ln for ln in out.splitlines() if ln.startswith(keys)]

    keys = ("iterations:", "relative residual:", "error (max")
    assert lines(three.stdout, keys) == lines(one.stdout, keys)
    monkeypatch.chdir(tmp_path / "jax")
    assert j_main(list(args)) == 0
    banner = ("Iterations =", "Relative residual =", "error[")
    want, got = lines(capsys.readouterr().out, banner), lines(three.stdout,
                                                              banner)
    assert len(got) == len(want) == 5, (got, want)
    assert got[-1] == want[-1]  # Iterations = N (converged: True)
    for g, w in zip(got[:-1], want[:-1]):
        assert g.split("=")[0] == w.split("=")[0]
        np.testing.assert_allclose(float(g.split("=")[1]),
                                   float(w.split("=")[1]), rtol=1e-6)


@pytest.mark.parametrize("compiler,machine", [
    ("c++ (Debian 12.2.0-14) 12.2.0", "aarch64"),
    ("c++ (GCC) 11.4.0", "x86_64"),
])
def test_csr_library_keyed_on_compiler_and_machine(compiler, machine):
    """A library built by another compiler or for another machine has
    another name, so it is never loaded here."""
    here = ("c++ (Debian 12.2.0-14) 12.2.0", "x86_64")
    assert _build.assembler_path(*here) == _build.assembler_path(*here)
    assert _build.assembler_path(compiler, machine) != \
        _build.assembler_path(*here)
    assert _build.assembler_path(compiler, machine).name.startswith(
        "libmgcsr_")
