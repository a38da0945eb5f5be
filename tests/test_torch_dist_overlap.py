"""The rows layout's split visit (``dist_kernel.row_visit_split``, run by
``DistLevelOps._visit``): where JAX's row tile t cuts a block into g = R /
t >= 3 tiles, K17 runs on the interior rows [t, R - t) while the exchange
is in flight, then on the edge rows [0, t) and [R - t, R) (JAX's
two-call split, multigrid_petsc_tpu/ops/pallas/dist_kernel.py:566-613).

(a) The pieces through the plain version equal one plain visit of the
    whole block bit for bit: every emit, with and without a guess and a
    coarse correction, 5- and 9-point, f32, f64 and bf16, at g = 3 and 4,
    on a first, a middle and a last (pad-row) block.
(b) The pieces, one process, on the 2 row blocks of the 127^2 level with
    t = 8 (g = 8), against JAX's ``DistLevelOps(tile_cap=8)`` on a 2-device
    row mesh in interpret mode (its split path), at JAX's own tolerances
    (test_dist_pallas.py: rtol 1e-12 with atol 1e-12, a visit's second
    output atol 1e-14 of its largest entry); the pad rows exactly 0.
(c) A 2-rank gloo world (``_dist_worker.overlap_units``): ``DistLevelOps``
    with ``tile_cap=8`` on the same level and inputs, apply, residual,
    visit_down (zero and nonzero guess) and visit_up (correcting by the
    coarse level's block and by a replicated coarse grid): every visit
    counted split, each output equal bit for bit to the same world's
    unsplit visit (a tile cap past the block: one launch, counted whole),
    and held to JAX's outputs of (b).
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _dist_worker as dw
from multigrid_petsc_tpu.mesh import MeshType as JMesh
from multigrid_petsc_tpu.ops.pallas.stencil_kernel import jacobi_step_coeffs
from multigrid_petsc_tpu.parallel.device_mesh import make_row_mesh
from multigrid_petsc_tpu.parallel.dist_ops import DistLevelOps as JDist
from multigrid_petsc_tpu.problems import stencil_coefficients as j_coeffs
from multigrid_petsc_tpu_torch.mesh import MeshType
from multigrid_petsc_tpu_torch.ops.cuda import dist_kernel as dk
from multigrid_petsc_tpu_torch.ops.stencil import from_numpy_stencil
from multigrid_petsc_tpu_torch.problems import (
    AnisoProblem,
    stencil9_coefficients,
    stencil_coefficients,
)
from multigrid_petsc_tpu_torch.solvers.smoothers import jacobi_step_coeffs as jac

torch.set_num_threads(2)

STEPS = jac(3, 0.8)
# label: (emit, guess, correct)
MODES = {"a": ("a", True, False), "r": ("r", True, False),
         "u": ("u", True, False), "u0": ("u", False, False),
         "ur": ("ur", True, False), "rc": ("rc", True, False),
         "rc0": ("rc", False, False), "correct_u": ("u", True, True),
         "correct_ur": ("ur", True, True), "correct_rc": ("rc", True, True)}
DTYPES = {"f32": torch.float32, "f64": torch.float64,
          "bf16": torch.bfloat16}
N, TILE, RANKS = dw.OVERLAP_N, dw.OVERLAP_TILE, 2
# The emits JAX is run for here, and the world's visits held to them.
JAX_MODES = ("a", "r", "rc", "correct_ur")
WORLD_JAX = {"a": "a", "r": "r", "rc": "rc", "correct_ur": "correct_ur",
             "replicated_ur": "correct_ur"}


def _tuple(x):
    return x if isinstance(x, tuple) else (x,)


def _same(got, want):
    """Bit for bit, NaN where NaN."""
    return (torch.equal(torch.isnan(got), torch.isnan(want))
            and torch.equal(got.nan_to_num(), want.nan_to_num()))


@pytest.mark.parametrize("g", [3, 4])
@pytest.mark.parametrize("nine", [False, True], ids=["5pt", "9pt"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_split_pieces_equal_whole_block(dtype, nine, g):
    dt = DTYPES[dtype]
    t = 8 if g == 3 else 16
    P, R, nx = 4, g * t, 37
    ny = P * R - 1
    st = (stencil9_coefficients(AnisoProblem(1.0, 1.0, 1.0, 2.0, 0.4), ny,
                                nx, dt, "cpu") if nine else
          stencil_coefficients(MeshType.UNIFORM, ny, nx, dt, "cpu"))
    rng = np.random.default_rng(3 + g)
    dk.row_visits.clear()
    visits = 0
    for label, (emit, guess, correct) in MODES.items():
        steps = () if emit in ("a", "r") else STEPS
        h = dk.halo_rows(len(steps), emit)
        hc = dk.coarse_halo_rows(h)
        for p in (0, 1, P - 1):
            def mk(*shape):
                return torch.as_tensor(rng.standard_normal(shape)).to(dt)

            b, u = mk(R, nx), mk(R, nx)
            if p == P - 1:  # the pad row
                b[-1], u[-1] = 0.0, 0.0
            e = mk(R // 2, (nx - 1) // 2) if correct else None
            halos = dict(b=dk.Halo(mk(h, nx), mk(h, nx)),
                         u=dk.Halo(mk(h, nx), mk(h, nx)),
                         e=dk.Halo(mk(hc, (nx - 1) // 2),
                                   mk(hc, (nx - 1) // 2))
                         if correct else None)
            args = (st, None if emit == "a" else b, u if guess else None,
                    steps, emit)
            want = dk.row_visit_plain(*args, row0=p * R, ny=ny,
                                      b_halo=halos["b"], u_halo=halos["u"],
                                      e=e, e_halo=halos["e"])
            waited = []
            got = dk.row_visit_split(
                *args, row0=p * R, ny=ny, t=t, e=e,
                halos=lambda: waited.append(1) or halos)
            assert waited == [1]
            visits += 1
            for i, (gv, wv) in enumerate(zip(_tuple(got), _tuple(want))):
                assert gv.dtype == dt and gv.shape == wv.shape
                assert _same(gv, wv), (label, p, i)
    assert dk.row_visits == {f"{ny} split": visits}


def test_split_pieces_follow_jax_tile_rule():
    """Fewer than 3 tiles: one launch on the whole block after the wait;
    else the interior first, then the two edge tiles."""
    assert dk.split_pieces(64, 32) == ((0, 64, True),)
    assert dk.split_pieces(64, None) == ((0, 64, True),)
    assert dk.split_pieces(48, 16) == ((16, 32, False), (0, 16, True),
                                       (32, 48, True))
    assert dk.pick_tile(64, 5, nx=127, cap=8) == 8
    st = stencil_coefficients(MeshType.UNIFORM, 95, 37, torch.float64,
                              "cpu")
    u = torch.zeros((24, 37), dtype=torch.float64)
    with pytest.raises(ValueError, match="tile of 2 rows"):  # h = 3
        dk.row_visit_split(st, u, u, STEPS, "u", row0=24, ny=95, t=2,
                           halos=dict)


def _padded():
    u, b, e = dw.overlap_inputs()
    pad = (lambda x: np.concatenate([x, np.zeros((1, x.shape[1]))]))
    return pad(u), pad(b), pad(e)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The module's 2-rank gloo world, started when the module's first
    test that needs it runs, so that it runs beside JAX."""
    out = tmp_path_factory.mktemp("overlap")
    procs = dw.spawn({"overlap_units": {}}, out, RANKS)
    state = {"done": False}

    def results():
        if not state["done"]:
            dw.finish(procs)
            state["done"] = True
        return [dict(np.load(out / f"overlap_units.{r}.npz"))
                for r in range(RANKS)]

    yield results
    for p in procs:
        if p.poll() is None:
            p.kill()


@pytest.fixture(scope="module")
def jax_visits(world):
    """JAX's split visits (interpret mode, 2 devices, tile cap 8) of the
    overlap inputs, by mode, as numpy."""
    jst = j_coeffs(JMesh.NONUNIFORM2, N, N, jnp.float64)
    ops = JDist(jst, N, N, make_row_mesh(jax.devices()[:RANKS]),
                jnp.float64, steps_fn=lambda s: jacobi_step_coeffs(s, 0.8),
                interpret=True, tile_cap=TILE)
    u, b, e = (jnp.asarray(x) for x in _padded())
    runs = {"a": lambda: ops.apply(u), "r": lambda: ops.residual(b, u),
            "rc": lambda: ops.visit_down(b, u, 3),
            "correct_ur": lambda: ops.visit_up(b, u, e, 3, True)}
    return jst, {m: [np.asarray(o) for o in _tuple(runs[m]())]
                 for m in JAX_MODES}


def _check_jax(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape
        assert np.all(g[-1] == 0.0)  # the pad row, or the coarse pad row
        atol = 1e-14 * float(np.abs(w).max()) if i == 1 else 1e-12
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=atol)


@pytest.mark.parametrize("mode", JAX_MODES)
def test_split_pieces_match_jax_split(jax_visits, mode):
    jst, want = jax_visits
    tst = from_numpy_stencil([np.asarray(c) for c in jst], "cpu",
                             torch.float64)
    emit, guess, correct = MODES[mode]
    steps = () if emit in ("a", "r") else STEPS
    h = dk.halo_rows(len(steps), emit)
    hc = dk.coarse_halo_rows(h)
    u, b, e = (torch.as_tensor(x) for x in _padded())
    R = (N + 1) // RANKS
    assert dk.pick_tile(R, h, nx=N, itemsize=8, cap=TILE) == TILE

    def halo(x, p, rows, n):
        z = x.new_zeros((n, x.shape[1]))
        ext = torch.cat([z, x, z])
        return dk.Halo(ext[p * rows:p * rows + n],
                       ext[n + (p + 1) * rows:2 * n + (p + 1) * rows])

    outs = []
    for p in range(RANKS):
        rem = dict(b=halo(b, p, R, h), u=halo(u, p, R, h),
                   e=halo(e, p, R // 2, hc) if correct else None)
        out = dk.row_visit_split(
            tst, None if emit == "a" else b[p * R:(p + 1) * R],
            u[p * R:(p + 1) * R] if guess else None, steps, emit,
            row0=p * R, ny=N, t=TILE, halos=lambda: rem,
            e=e[p * R // 2:(p + 1) * R // 2] if correct else None)
        outs.append(_tuple(out))
    got = [torch.cat([o[i] for o in outs]).numpy()
           for i in range(len(outs[0]))]
    _check_jax(got, want[mode])


WORLD_OPS = ("a", "r", "rc", "rc0", "correct_u", "correct_ur",
             "replicated_ur")


@pytest.mark.parametrize("name", WORLD_OPS)
def test_dist_level_ops_split_matches_whole_and_jax(world, jax_visits,
                                                    name):
    runs = world()
    r0 = runs[0]
    for r in runs[1:]:  # every rank gathered the same grids
        for k in r0:
            if k.startswith(("split_", "whole_")) and k.startswith(
                    ("split_" + name + "_", "whole_" + name + "_")):
                np.testing.assert_array_equal(r[k], r0[k])
    outs = sorted(k for k in r0 if k.startswith(f"split_{name}_")
                  and not k.endswith("_visits"))
    assert outs, name
    for k in outs:  # the split equals one launch on the whole block
        whole = r0["whole" + k[len("split"):]]
        assert r0[k].shape == whole.shape
        np.testing.assert_array_equal(r0[k], whole)
    for r in runs:
        split = json.loads(str(r[f"split_{name}_visits"]))
        whole = json.loads(str(r[f"whole_{name}_visits"]))
        assert split == {f"{N} split": 1}, split
        assert whole == {f"{N} whole": 1}, whole
    if name in WORLD_JAX:
        _check_jax([r0[k] for k in outs], jax_visits[1][WORLD_JAX[name]])
