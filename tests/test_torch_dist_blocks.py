"""The 2-D blocks layout of the port (``-map 0/1``: ``parallel.blocks_plan``,
``parallel.BlockLevelOps``, K17's 2-D block mode) against the JAX
package's blocks plan on the CPU.

(a) ``mesh_shape`` and the blocks ``spec`` equal JAX's ``make_device_mesh``
    and ``ShardingPlan.spec`` for 2, 4 and 8 ranks at 7^2 ... 1025^2 and
    min_local 8, 16, 32.
(b) ``block_exchange`` on a 4-rank (2x2) gloo world (``_dist_worker.py``,
    one world for the module, started when its first test runs): at
    depth 1 equal to JAX's ``halo_pad_local`` under ``shard_map`` on a
    (2, 2) mesh (the 5-point exchange's edges, and the corners of its
    second pass); at depth 3 equal to the neighbours' cut rows and
    columns, split along both axes, along y alone and along x alone;
    zeros at the global edges; rtol 1e-12.
(c) K17's 2-D block mode's plain version (``block_visit_plain``) on the
    63^2 level (padded to 64^2) cut into 2x2 and 2x4 blocks in one
    process, every emit, the 5-point (NONUNIFORM2) and the aniso
    (1,1,1,2,0.4) 9-point stencil, f64, stitched and held to JAX's
    whole-grid visit of the same emit, its Pallas kernels in interpret
    mode, to rtol 1e-12 / atol 1e-12 of the output's largest entry (A u
    on the stretched mesh reaches 1e5, whose rounding is 1e-11); the pad
    row and column exactly 0.
(d) The solves on the 4-rank world under ``blocks_plan(min_local=8)``
    (65^2 - 129^2, f64): V-cycle, mg-CG, FMG, MG-Richardson, Chebyshev V,
    Additive, Additive2, mg-FGMRES, aniso (1,1,1,2,0.4) mg-CG Jacobi, a
    directly solved sharded coarsest level, and -v 8,8 under min_local 4
    (K17 visits in pieces on 8 x 8 blocks), each against JAX's solve under
    ``ShardingPlan(make_device_mesh(jax.devices()[:4]), min_local=...)``:
    iterations equal, rnorm rtol 1e-6 and u rtol 1e-6 / atol 1e-11 (JAX's
    own bounds, test_parallel.py:80-84), rnorm with the row-plan tests'
    atol 1e-9 beside it (FMG's last residual norm differs by 1e-6
    relative between JAX's own one- and four-device solves, mg-FGMRES's
    lies at the 1e-13 roundoff floor), the same levels split along the
    same axes, and every rank's results identical.
(e) An 8-rank (2x4) world solves JAX's agglomeration case (129^2 / 5
    levels, min_local 16: the 63^2 level split along y alone); a 2-rank
    (1x2) world an mg-CG.
(f) ``-map 0`` and ``-map 1`` under the 4-rank world print the
    one-process summary (iterations, residual, error norms).
(g) The all-gathers inside a cycle are "agglomerate" and "coarsest" only.
"""

from __future__ import annotations

import json
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

import _dist_worker as dw
from multigrid_petsc_tpu.mesh import MeshType as JMesh
from multigrid_petsc_tpu.ops.pallas import stencil9_kernel as jk9
from multigrid_petsc_tpu.ops.pallas import stencil_kernel as jk
from multigrid_petsc_tpu.parallel.device_mesh import ShardingPlan as JPlan
from multigrid_petsc_tpu.parallel.device_mesh import make_device_mesh
from multigrid_petsc_tpu.parallel.halo import halo_pad_local
from multigrid_petsc_tpu.problems import AnisoProblem as JAniso
from multigrid_petsc_tpu.problems import stencil9_coefficients as j_coeffs9
from multigrid_petsc_tpu.problems import stencil_coefficients as j_coeffs
from multigrid_petsc_tpu.solvers.solve import solve as j_solve
from multigrid_petsc_tpu.utils.config import CycleType as JCT
from multigrid_petsc_tpu.utils.config import SmootherType as JST
from multigrid_petsc_tpu.utils.config import SolverConfig as JC
from multigrid_petsc_tpu_torch import poisson
from multigrid_petsc_tpu_torch.ops.cuda import dist_kernel as dk
from multigrid_petsc_tpu_torch.ops.stencil import (
    from_numpy_stencil,
    from_numpy_stencil9,
)
from multigrid_petsc_tpu_torch.parallel.block_ops import _cut_coeffs, cut_halo
from multigrid_petsc_tpu_torch.parallel.device_mesh import (
    ShardingPlan,
    mesh_shape,
)

torch.set_num_threads(2)

ANISO = (1.0, 1.0, 1.0, 2.0, 0.4)
# name -> (SolverConfig fields, min_local) of (d), every one in f64.
BASE = dict(npts=129, grids=4, levels=4, max_iter=60)
CONFIGS = {
    "V": (dict(BASE, cycle=0), 8),
    "MGCG": (dict(BASE, cycle=101), 8),
    "FMG": (dict(BASE, cycle=103), 8),
    "PCMG": (dict(BASE, cycle=8), 8),
    "CHEB": (dict(BASE, cycle=0, smoother="chebyshev"), 8),
    "ADD": (dict(BASE, cycle=9, max_iter=10), 8),
    "ADD2": (dict(BASE, grids=2, levels=2, cycle=10, max_iter=10), 8),
    "FGMRES": (dict(BASE, cycle=102), 8),
    "ANISO": (dict(BASE, npts=65, cycle=101, problem="aniso",
                   aniso=list(ANISO)), 8),
    # The 31^2 coarsest level split and solved directly (gathered).
    "DIRECT": (dict(BASE, grids=3, levels=3, cycle=101), 8),
    # 8 x 8 blocks of the 15^2 level: -v 8,8's visits in pieces.
    "V88": (dict(BASE, npts=65, cycle=101, v=[8, 8]), 4),
}
# (e): the 8-rank agglomeration case and the 2-rank mg-CG.
AGGLOMERATE = dict(npts=129, grids=5, levels=5, cycle=101, max_iter=30)
PAIR = dict(npts=65, grids=4, levels=4, cycle=101, max_iter=60)
CLI_ARGS = ["-npts", "129", "-grids", "4", "-levels", "4", "-cycle", "101",
            "-device", "cpu"]


def _jax_cfg(fields: dict) -> JC:
    f = dict(fields)
    f["cycle"] = JCT(f["cycle"])
    if "smoother" in f:
        f["smoother"] = JST(f["smoother"])
    for k in ("v", "aniso"):
        if k in f:
            f[k] = tuple(f[k])
    return JC(**f)


def _blocks(cfg, min_local=8, mesh=None):
    job = {"cfg": cfg, "min_local": min_local, "layout": "blocks"}
    if mesh is not None:
        job["mesh"] = list(mesh)
    return job


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The module's gloo worlds (4 ranks: the exchange, the solves and
    the CLI; 8 ranks; 2 ranks), started when the module's first test
    runs, so the ranks solve while the JAX side runs."""
    out = tmp_path_factory.mktemp("blocks")
    jobs4 = {"block_exchange": {}}
    jobs4.update({n: _blocks(f, m) for n, (f, m) in CONFIGS.items()})
    jobs4["MGCG"]["view"] = True
    jobs4.update({f"cli{m}": {"argv": CLI_ARGS + ["-map", str(m)]}
                  for m in (0, 1)})
    procs = {4: dw.spawn(jobs4, out, 4),
             8: dw.spawn({"AGG": _blocks(AGGLOMERATE, 16)}, out, 8),
             2: dw.spawn({"PAIR": _blocks(PAIR)}, out, 2)}
    done = set()

    def results(world):
        if world not in done:
            dw.finish(procs[world])
            done.add(world)
        return out

    yield results
    for ps in procs.values():
        for p in ps:
            if p.poll() is None:
                p.kill()


@pytest.fixture(scope="module", autouse=True)
def _start_worlds(worlds):
    return worlds


# ---------------------------------------------------------------------------
# (a) The splits.
# ---------------------------------------------------------------------------

SIDES = (7, 15, 31, 63, 127, 255, 511, 1023)


@pytest.mark.parametrize("size", [2, 4, 8])
def test_mesh_and_spec_match_jax(size):
    mesh = make_device_mesh(jax.devices()[:size])
    assert mesh_shape(size) == mesh.devices.shape
    for min_local in (8, 16, 32):
        jplan = JPlan(mesh, min_local=min_local)
        plan = types.SimpleNamespace(layout="blocks", min_local=min_local,
                                     mesh=mesh_shape(size))
        for ny in SIDES:
            for nx in (ny, SIDES[-1]):
                assert ShardingPlan.spec(plan, ny, nx) == tuple(
                    jplan.spec(ny, nx)), (size, min_local, ny, nx)


# ---------------------------------------------------------------------------
# (c) K17's 2-D block mode (plain version) against JAX's whole-grid visit.
# ---------------------------------------------------------------------------

N = 63
STEPS = jk.jacobi_step_coeffs(3, 0.8)
EMITS = ("a", "r", "u", "ur", "rc", "rc0", "correct_u", "correct_ur")


def _jax_whole(jst, nine, emit, u, b, e):
    """JAX's whole-grid visit of ``emit`` (interpret mode), as numpy."""
    ju, jb, je = (None if x is None else jnp.asarray(x) for x in (u, b, e))
    if emit == "a":
        out = (jk9.apply_stencil9_pallas(jst, ju, interpret=True) if nine
               else jk.apply_stencil5_pallas(jst, ju, interpret=True))
    elif emit == "r":
        out = (jk9.apply_stencil9_pallas(jst, ju, jb, interpret=True)
               if nine else jk.residual5_pallas(jst, jb, ju, interpret=True))
    else:
        kind = {"rc0": "rc", "correct_u": "u", "correct_ur": "ur"}.get(
            emit, emit)
        fn = (jk9.fused_level_visit9_pallas if nine
              else jk.fused_level_visit_pallas)
        out = fn(jst, jb, None if emit == "rc0" else ju, STEPS, emit=kind,
                 e_coarse=je, interpret=True)
    out = out if isinstance(out, tuple) else (out,)
    return [np.asarray(o) for o in out]


def _port_blocks(tst, nine, emit, u, b, e, my, mx):
    """``block_visit_plain`` on the my x mx blocks of the padded level,
    each block's halo cut from its neighbours; the stitched outputs."""
    R, C = (N + 1) // my, (N + 1) // mx
    steps = () if emit in ("a", "r") else STEPS
    kind = {"rc0": "rc", "correct_u": "u", "correct_ur": "ur"}.get(emit,
                                                                  emit)
    h = dk.halo_rows(len(steps), kind)
    hc = dk.coarse_halo_rows(h)
    t = {k: None if x is None else torch.as_tensor(x)
         for k, x in (("u", u), ("b", b), ("e", e))}
    rows = []
    for iy in range(my):
        row = []
        for ix in range(mx):
            r0, c0 = iy * R, ix * C

            def cut(x, hh, coarse=False):
                if x is None:
                    return None, None
                d = 2 if coarse else 1
                return cut_halo(x, r0 // d, c0 // d, R // d, C // d, hh)

            ub, uh = cut(t["u"], h)
            bb, bh = cut(t["b"], h)
            eb, eh = cut(t["e"], hc, True)
            st, cr0, cc0 = tst, 0, 0
            if nine:  # the coefficients a rank keeps (BlockLevelOps)
                m = len(STEPS) + 2
                cr0, cc0 = max(0, r0 - m), max(0, c0 - m)
                st = _cut_coeffs(tst, cr0, min(N, r0 + R + m), cc0,
                                 min(N, c0 + C + m))
            o = dk.block_visit_plain(
                st, None if emit == "a" else bb,
                None if emit == "rc0" else ub, steps, kind, row0=r0,
                col0=c0, ny=N, nx=N, b_halo=bh, u_halo=uh, e=eb, e_halo=eh,
                coeff_row0=cr0, coeff_col0=cc0)
            row.append(o if isinstance(o, tuple) else (o,))
        rows.append(row)
    return [torch.cat([torch.cat([blk[i] for blk in row], 1)
                       for row in rows]).numpy()
            for i in range(len(rows[0][0]))]


@pytest.mark.parametrize("mesh", [(2, 2), (2, 4)])
@pytest.mark.parametrize("nine", [False, True], ids=["5pt", "9pt"])
@pytest.mark.parametrize("emit", EMITS)
def test_block_visit_plain_matches_jax(emit, nine, mesh):
    if nine:
        jst = j_coeffs9(JAniso(*ANISO), N, N, jnp.float64)
        tst = from_numpy_stencil9([np.asarray(c) for c in jst], "cpu",
                                  torch.float64)
    else:
        jst = j_coeffs(JMesh.NONUNIFORM2, N, N, jnp.float64)
        tst = from_numpy_stencil([np.asarray(c) for c in jst], "cpu",
                                 torch.float64)
    rng = np.random.default_rng(len(emit) + 10 * nine + mesh[1])
    u = rng.standard_normal((N, N))
    b = rng.standard_normal((N, N))
    e = (rng.standard_normal(((N - 1) // 2,) * 2)
         if emit.startswith("correct") else None)
    want = _jax_whole(jst, nine, emit, u, b, e)
    got = _port_blocks(tst, nine, emit, u, b, e, *mesh)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        n = w.shape[0]
        assert g.shape == (n + 1, n + 1)
        # The pad row and column (the coarse ones of rc), exactly 0.
        assert np.all(g[n] == 0.0) and np.all(g[:, n] == 0.0)
        np.testing.assert_allclose(g[:n, :n], w, rtol=1e-12,
                                   atol=1e-12 * max(1.0, np.abs(w).max()))


# ---------------------------------------------------------------------------
# (b) The exchange.
# ---------------------------------------------------------------------------

def _jax_halo(field, corners):
    """JAX's depth-1 halo on the (2, 2) mesh: each device's (18, 18)
    padded block, by (iy, ix)."""
    mesh = make_device_mesh(jax.devices()[:4], shape=(2, 2))
    f = shard_map(lambda u: halo_pad_local(u, corners=corners), mesh=mesh,
                  in_specs=P("y", "x"), out_specs=P("y", "x"))
    got = np.asarray(f(jnp.asarray(field)))
    return {(iy, ix): got[18 * iy:18 * iy + 18, 18 * ix:18 * ix + 18]
            for iy in range(2) for ix in range(2)}


def test_block_exchange_matches_jax_halo(worlds):
    out = worlds(4)
    field = np.random.default_rng(3).standard_normal((32, 32))
    with_corners, edges = _jax_halo(field, True), _jax_halo(field, False)
    for r in range(4):
        d = np.load(out / f"block_exchange.{r}.npz")
        iy, ix = d["coords"]
        assert (iy, ix) == divmod(r, 2)
        jp = with_corners[iy, ix]
        for pre, sign in (("", 1.0), ("neg_", -1.0)):
            got = {k: d[f"{pre}yx1_{k}"] for k in ("top", "bot", "left",
                                                   "right")}
            want = {"top": jp[:1], "bot": jp[-1:], "left": jp[1:-1, :1],
                    "right": jp[1:-1, -1:]}
            for k in got:
                np.testing.assert_allclose(got[k], sign * want[k],
                                           rtol=1e-12, atol=0)
            # The 5-point exchange's edges (its corners are zero-padded).
            je = edges[iy, ix]
            np.testing.assert_allclose(got["top"][:, 1:-1],
                                       sign * je[:1, 1:-1], rtol=1e-12)
            np.testing.assert_allclose(got["left"], sign * je[1:-1, :1],
                                       rtol=1e-12)


@pytest.mark.parametrize("axes", ["yx", "y", "x"])
def test_block_exchange_depth_is_the_neighbours_points(worlds, axes):
    """Depth 3: the halo is the field's points around the block, cut from
    the neighbours (corners included), zeros past the global edges and
    along an axis not split."""
    out = worlds(4)
    field = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (32, 32)))
    for r in range(4):
        d = np.load(out / f"block_exchange.{r}.npz")
        iy, ix = (int(v) for v in d["coords"])
        r0, R = (16 * iy, 16) if "y" in axes else (0, 32)
        c0, C = (16 * ix, 16) if "x" in axes else (0, 32)
        _, want = cut_halo(field, r0, c0, R, C, 3)
        for k, w in want._asdict().items():
            np.testing.assert_allclose(d[f"{axes}3_{k}"], w.numpy(),
                                       rtol=1e-12, atol=0)
            np.testing.assert_allclose(d[f"neg_{axes}3_{k}"], -w.numpy(),
                                       rtol=1e-12, atol=0)


# ---------------------------------------------------------------------------
# (d) - (g) The solves, the CLI, the gathers.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_solves():
    """JAX's blocks-plan solves of (d) (4 devices) and (e) (8 and 2
    devices): name -> result."""
    def run(fields, devices, min_local):
        plan = JPlan(make_device_mesh(jax.devices()[:devices]),
                     min_local=min_local)
        return j_solve(_jax_cfg(fields), plan=plan)

    out = {n: run(f, 4, m) for n, (f, m) in CONFIGS.items()}
    out["AGG"] = run(AGGLOMERATE, 8, 16)
    out["PAIR"] = run(PAIR, 2, 8)
    return out


def _jax_axes(res):
    """The axes JAX splits each level along (its spec's letters on mesh
    axes of two devices or more)."""
    out = []
    for lvl in res.ctx.levels:
        sh = lvl.shardings[0]
        my, mx = sh.mesh.devices.shape
        spec = tuple(sh.spec) + (None,) * (2 - len(tuple(sh.spec)))
        out.append([spec[0] == "y" and my > 1, spec[1] == "x" and mx > 1])
    return out


def check_blocks_solve(runs, ref):
    r0 = runs[0]
    for r in runs[1:]:
        assert int(r["iters"]) == int(r0["iters"])
        np.testing.assert_array_equal(r["rnorm"], r0["rnorm"])
        np.testing.assert_array_equal(r["u"], r0["u"])
    assert str(r0["path"]) == "torch"
    assert bool(r0["converged"]) == bool(ref.converged)
    assert int(r0["iters"]) == int(ref.iters)
    np.testing.assert_allclose(r0["rnorm"], ref.rnorm, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(r0["u"], ref.u_fine, rtol=1e-6, atol=1e-11)
    axes = json.loads(str(r0["axes"]))
    assert axes == _jax_axes(ref), (axes, _jax_axes(ref))
    assert any(any(a) for a in axes), "no level ran split"
    # (g) Inside a cycle: onto coarser levels and the coarsest solve only.
    gathers = json.loads(str(r0["gathers"]))
    assert set(gathers) <= {"agglomerate", "coarsest"}, gathers
    return axes, gathers


@pytest.mark.parametrize("name", list(CONFIGS))
def test_blocks_solve_matches_jax(worlds, jax_solves, name):
    axes, gathers = check_blocks_solve(dw.load(worlds(4), name, 4),
                                       jax_solves[name])
    if name == "DIRECT":  # the split 31^2 coarsest level, gathered
        assert axes[-1] == [True, True] and gathers.get("coarsest", 0) > 0
    elif not all(all(a) for a in axes):  # onto the replicated coarsest
        assert gathers.get("agglomerate", 0) > 0


def test_view_solver_prints_jax_layout(worlds, jax_solves):
    """Every rank's ``view_solver`` of the 4-rank mg-CG: JAX's dump of its
    4-device blocks solve but the op= token, the layout= token JAX's
    letter for letter (``('y', 'x')``, ``(None, None)``); a split level's
    op names K17 on its 2-D block."""
    from multigrid_petsc_tpu.utils.views import view_solver as j_view

    out = worlds(4)
    texts = {(out / f"MGCG.{r}.view.txt").read_text() for r in range(4)}
    assert len(texts) == 1
    got = texts.pop()
    ref = j_view(jax_solves["MGCG"].ctx)

    def strip(text):
        return [re.sub(r" op=[^ (]+(\([^)]*\))?", "", ln)
                for ln in text.splitlines()]

    assert strip(got) == strip(ref)
    assert "layout=('y', 'x')" in got and "layout=(None, None)" in got
    assert " op=K17(mesh 2x2, block=64x64, pad=1) " in got, got


def test_agglomeration_on_a_2x4_world(worlds, jax_solves):
    """JAX's agglomeration case on 8 ranks: 127^2 split along both axes,
    63^2 along y alone (its rc blocks gathered along x), the rest
    replicated."""
    axes, gathers = check_blocks_solve(dw.load(worlds(8), "AGG", 8),
                                       jax_solves["AGG"])
    assert axes == [[True, True], [True, False]] + [[False, False]] * 3
    assert gathers.get("agglomerate", 0) > 0


def test_mgcg_on_a_1x2_world(worlds, jax_solves):
    axes, _ = check_blocks_solve(dw.load(worlds(2), "PAIR", 2),
                                 jax_solves["PAIR"])
    assert [a[0] for a in axes] == [False] * len(axes)  # my = 1


def test_cli_map_0_and_1_print_the_one_process_summary(worlds, tmp_path,
                                                       monkeypatch, capsys):
    out = worlds(4)
    monkeypatch.chdir(tmp_path)
    assert poisson.main(list(CLI_ARGS)) == 0
    one = capsys.readouterr().out.splitlines()

    def summary(lines):
        keep = ("iterations:", "relative residual:", "error (max")
        return [ln for ln in lines if ln.startswith(keep)]

    for m in (0, 1):
        text = (out / f"cli{m}.0.txt").read_text()
        assert summary(text.splitlines()) == summary(one), text
        assert re.search(r"^distributed: ranks=4 mesh=2x2 transport=gloo "
                         r"sharded levels=127$", text, re.M), text
        for r in range(1, 4):  # rank 0 prints
            assert (out / f"cli{m}.{r}.txt").read_text() == ""


def test_block_visit_refuses_other_devices():
    """The 2-D block mode runs its plain version on CPU tensors and its
    kernel on CUDA ones; any other device raises (no fallback)."""
    st = from_numpy_stencil([np.ones((15, 1))] * 5, "meta", torch.float32)
    x = torch.empty((8, 8), device="meta")
    ring = dk.Halo2(*(torch.empty(s, device="meta")
                      for s in ((3, 14), (3, 14), (8, 3), (8, 3))))
    for emit, steps in (("a", ()), ("u", STEPS)):
        with pytest.raises(ValueError, match="no kernel for device"):
            dk.block_visit(st, x, x, steps, emit, row0=0, col0=0, ny=15,
                           nx=15, b_halo=ring, u_halo=ring)
