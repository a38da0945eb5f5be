"""K4's launch plan and fused schedule on the CPU.

``coarse_tree_kernel.TreePlan`` is built once per solver on the card;
what it decides from shapes alone (where block 0's tail starts, how many
grid-wide barriers a launch makes) and the checks it runs once are held
here, as is a plain-PyTorch model of ``csrc/coarse_tree.cu``'s fused
schedule (the zero-guess steps 0 and 1 in one phase, the residual formed
inside the restriction, the correction in place, the ping-pong buffers)
against ``coarse_tree_plain`` in f64 to 1e-12 of
max|u|.  The kernel itself is held to ``coarse_tree_plain`` on the card
by ``chip_smoke.py`` and ``scripts/time_coarse_tree.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from multigrid_petsc_tpu_torch.mesh import MeshType
from multigrid_petsc_tpu_torch.ops.cuda import coarse_tree_kernel as ctk
from multigrid_petsc_tpu_torch.ops.stencil import Stencil5, apply_stencil5
from multigrid_petsc_tpu_torch.ops.transfer import prolong_bilinear, restrict_fw
from multigrid_petsc_tpu_torch.problems import stencil_coefficients
from multigrid_petsc_tpu_torch.solvers.coarse import dense_from_stencil
from multigrid_petsc_tpu_torch.solvers.smoothers import jacobi_step_coeffs

torch.set_num_threads(2)


def _chain(n0: int, nl: int) -> list[tuple[int, int]]:
    shapes = [(n0, n0)]
    while shapes[-1][0] > nl:
        n = (shapes[-1][0] - 1) // 2
        shapes.append((n, n))
    return shapes


def _tree(n0, nl, ks, direct, dtype=torch.float64, mesh=MeshType.NONUNIFORM1):
    shapes = _chain(n0, nl)
    sts = [stencil_coefficients(mesh, ny, nx, dtype, "cpu")
           for ny, nx in shapes]
    steps_list = [jacobi_step_coeffs(k, 0.8) for k in ks]
    a_inv = (np.linalg.inv(dense_from_stencil(sts[-1], *shapes[-1]))
             if direct else None)
    return sts, shapes, steps_list, a_inv


def _split_shapes(npts: int, grids: int, start: int):
    return [(n, n) for n in ((npts - 1) // 2**g - 1
                             for g in range(start, grids))]


def test_solver_reused_matches_plain():
    """One solver, two right-hand sides: each call equals the plain
    sub-V-cycle (the CPU builds no plan)."""
    sts, shapes, steps_list, a_inv = _tree(127, 7, [3] * 5, True)
    solve = ctk.make_coarse_tree_solver(sts, shapes, steps_list, a_inv)
    assert solve.plan is None
    a_inv_t = torch.as_tensor(a_inv)
    rng = np.random.default_rng(11)
    outs = []
    for _ in range(2):
        b = torch.as_tensor(rng.standard_normal(shapes[0]))
        got = solve(b)
        assert torch.equal(got, ctk.coarse_tree_plain(sts, steps_list,
                                                      a_inv_t, b))
        outs.append(got)
    assert not torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("shapes,ks,direct,tail_max_n,tail,syncs", [
    # The 8193^2 / 11-level main path's split (levels 3..10: 1023 -> 7).
    (_split_shapes(8193, 11, 3), [3] * 8, True, 63, 4, 28),
    (_split_shapes(8193, 11, 3), [3] * 8, True, 127, 3, 21),
    (_split_shapes(8193, 11, 3), [3] * 8, True, 31, 5, 35),
    (_split_shapes(8193, 11, 3), [1] * 8, True, 63, 4, 16),
    # The 513^2 / 7-level split (levels 1..6: 255 -> 7).
    (_split_shapes(513, 7, 1), [3] * 6, True, 63, 2, 14),
    # Entry level in the tail: the whole tree in block 0.
    (_chain(63, 7), [3] * 4, True, 63, 0, 0),
    # No level in the tail: the coarsest smooths grid-wide (k - 1 phases).
    (_chain(1023, 127), [3] * 4, False, 63, 4, 22),
    (_chain(1023, 127), [1] * 4, False, 63, 4, 12),
])
def test_plan_tail_and_grid_syncs(shapes, ks, direct, tail_max_n, tail,
                                  syncs):
    assert ctk.tail_from(shapes, tail_max_n) == tail
    assert ctk.grid_syncs(shapes, ks, direct, tail_max_n) == syncs


def test_plan_default_tail_constant():
    """The main path's tree at the module's constant: under half of the
    64 grid syncs of one barrier per unfused phase."""
    shapes = _split_shapes(8193, 11, 3)
    assert ctk.TREE_TAIL_MAX_N == 63
    assert ctk.tail_from(shapes) == 4
    assert ctk.grid_syncs(shapes, [3] * 8, True) == 28 < 64 // 2


def test_tree_checks_refuse():
    """The checks a plan runs once, on CPU tensors: mixed dtypes, a
    coefficient column of the wrong shape, a non-contiguous tensor, an
    inverse of the wrong shape; then devices the kernel has no launch
    for."""
    dev = torch.device("cpu")
    sts, shapes, _steps, a_inv = _tree(63, 7, [3] * 4, True,
                                       dtype=torch.float32)
    a_inv_t = torch.as_tensor(a_inv, dtype=torch.float32)
    ctk._check_tree(dev, sts, shapes, a_inv_t)
    with pytest.raises(TypeError):
        ctk._check_tree(dev, sts[:-1] + [Stencil5(*(
            c.double() for c in sts[-1]))], shapes, a_inv_t)
    with pytest.raises(TypeError):
        ctk._check_tree(dev, sts, shapes, a_inv_t.double())
    with pytest.raises(ValueError):
        ctk._check_tree(dev, [sts[0]._replace(cc=sts[0].cc[:-1])] + sts[1:],
                        shapes, a_inv_t)
    with pytest.raises(ValueError):
        ctk._check_tree(dev, sts, shapes, a_inv_t[:-1])
    wide = torch.zeros((shapes[1][0], 2))
    with pytest.raises(ValueError):
        ctk._check_tree(dev, [sts[0], sts[1]._replace(cw=wide[:, :1])]
                        + sts[2:], shapes, a_inv_t)
    with pytest.raises(ValueError):
        ctk._check_tree(dev, sts, shapes, a_inv_t.t())


def test_tree_refuses_other_devices():
    sts, shapes, steps_list, a_inv = _tree(15, 7, [3, 3], True,
                                           dtype=torch.float32)
    solve = ctk.make_coarse_tree_solver(sts, shapes, steps_list, a_inv)
    with pytest.raises(ValueError):
        solve(torch.empty(shapes[0], device="meta"))
    meta = [Stencil5(*(c.to("meta") for c in st)) for st in sts]
    with pytest.raises(ValueError):
        ctk.make_coarse_tree_solver(meta, shapes, steps_list, None)


def _fused_tree(stencils, shapes, steps_list, a_inv, b, tail):
    """``csrc/coarse_tree.cu``'s schedule in plain PyTorch: the same
    phases, buffers and barriers (a phase on a level above the tail ends
    in a grid sync).  Returns (u, grid syncs).  Buffers start as NaN, so
    a read of one the schedule did not write shows."""
    L = len(stencils)
    lv = [{"b": b if l == 0 else None,
           **{k: torch.full(shape, torch.nan, dtype=b.dtype)
              for k in ("ua", "ub", "p")}}
          for l, shape in enumerate(shapes)]
    syncs = 0

    def phase(l, barrier=True):
        nonlocal syncs
        syncs += int(barrier and l < tail)

    def buf(j):
        return "ub" if j & 1 else "ua"

    def step(l, a, bt, first, u, p_prev, dst):
        st, v = stencils[l], lv[l]
        z = (1.0 / st.cc) * (v["b"] - apply_stencil5(st, u))
        pn = (0.0 if first else bt * p_prev) + a * z
        v["p"], v[dst] = pn, u + pn

    def smooth_from_zero(l):
        st, v, s = stencils[l], lv[l], steps_list[l]
        if len(s) == 1:
            v["ua"] = s[0][0] * ((1.0 / st.cc) * v["b"])
            return phase(l)
        u0 = s[0][0] * ((1.0 / st.cc) * v["b"])
        step(l, *s[1], False, u0, u0, "ub")
        phase(l)
        for j in range(2, len(s)):
            step(l, *s[j], False, v[buf(j - 1)], v["p"], buf(j))
            phase(l)

    def down_result(l):
        return lv[l][buf(len(steps_list[l]) - 1)]

    def solution(l):
        if l < L - 1:
            return lv[l]["ub"]
        return lv[l]["ua"] if a_inv is not None else down_result(l)

    def down_level(l):
        smooth_from_zero(l)
        st, v = stencils[l], lv[l]
        lv[l + 1]["b"] = restrict_fw(v["b"] - apply_stencil5(
            st, down_result(l)))
        phase(l)

    def coarsest():
        v = lv[L - 1]
        if a_inv is None:
            return smooth_from_zero(L - 1)
        v["ua"] = (a_inv @ v["b"].reshape(-1)).reshape(v["b"].shape)
        phase(L - 1)

    def up_level(l, last):
        s, k = steps_list[l], len(steps_list[l])
        d = (k - 1) & 1
        lv[l][buf(d)] = down_result(l) + prolong_bilinear(solution(l + 1))
        phase(l)
        for j in range(k):
            step(l, *s[j], j == 0, lv[l][buf(d + j)], lv[l]["p"],
                 buf(d + j + 1))
            phase(l, not (last and j == k - 1))

    top = min(tail, L - 1)
    for l in range(top):
        down_level(l)
    if tail == L:
        coarsest()
    else:
        for l in range(tail, L - 1):
            down_level(l)
        coarsest()
        for l in range(L - 2, tail - 1, -1):
            up_level(l, l == tail)
        syncs += int(tail > 0)
    for l in range(top - 1, -1, -1):
        up_level(l, l == 0)
    return lv[0]["ub"], syncs


@pytest.mark.parametrize("n0,nl,ks,direct", [
    (255, 7, [3] * 6, True),
    (255, 7, [1] * 6, True),
    (255, 7, [2, 1, 3, 2, 1, 3], True),
    (127, 15, [3] * 4, False),
    (127, 15, [2, 3, 1, 2], False),
    (127, 31, [3, 2, 1], False),
])
@pytest.mark.parametrize("tail_max_n", [0, 31, 63, 127, 255])
def test_fused_schedule_matches_plain(n0, nl, ks, direct, tail_max_n):
    sts, shapes, steps_list, a_inv = _tree(n0, nl, ks, direct)
    a_inv_t = None if a_inv is None else torch.as_tensor(a_inv)
    b = torch.as_tensor(np.random.default_rng(5).standard_normal(shapes[0]))
    want = ctk.coarse_tree_plain(sts, steps_list, a_inv_t, b)
    tail = ctk.tail_from(shapes, tail_max_n)
    got, syncs = _fused_tree(sts, shapes, steps_list, a_inv_t, b, tail)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-12 * scale
    assert syncs == ctk.grid_syncs(shapes, ks, direct, tail_max_n)
