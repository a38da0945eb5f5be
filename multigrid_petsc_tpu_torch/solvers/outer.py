"""Shared outer-iteration driver with residual history (PyTorch
counterpart of ``multigrid_petsc_tpu/solvers/outer.py``; reference:
src/solver.c:1530-1557).

Iterate while

    iter < max_iter  AND  divtol * ||b|| > ||r||  AND  ||r|| > rtol * ||b||

recording ||r|| per outer iteration on the device, and normalise the
history by its first entry.  The loop runs on the host; the only host
read per iteration is the stop test.  ``monitor`` is the per-iteration
hook of ``-moreNorm`` (the KSPMonitor analogue, reference:
src/solver.c:1382-1412): it records iteration i (0: the initial state)
into its own device arrays, which ``OuterResult.aux`` carries out.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from multigrid_petsc_tpu_torch.ops.norms import tree_norm2


class OuterResult(NamedTuple):
    u: torch.Tensor | tuple  # a tuple on a merged level 0
    rnorm_history: torch.Tensor  # normalized by entry 0; length hist_len+1
    iters: int
    converged: bool
    aux: dict | None = None  # driver extras (the moreNorm monitors)


def keep_going(cfg, i: int, rn: float, bnorm: float) -> bool:
    return i < cfg.max_iter and cfg.divtol * bnorm > rn and rn > cfg.rtol * bnorm


def outer_iterate(step: Callable, residual: Callable, b, u0, cfg,
                  step_emits_residual: bool = False,
                  monitor=None, norm: Callable = tree_norm2) -> OuterResult:
    """``step(b, u)`` is one cycle; with ``step_emits_residual`` it
    returns (u, b - A u), computed inside its last level visit, so the
    stop test costs no extra operator application.  ``monitor(i, u, rn)``
    (with ``monitor.aux()``), if given, sees every iterate.  ``norm`` is
    the level's (``LevelCtx.norm2``: over the ranks of a sharded level,
    so each rank reads the same stop test)."""
    hist_len = min(cfg.hist_len, cfg.max_iter)
    bnorm = float(norm(b))
    rn_t = norm(residual(b, u0))
    hist = torch.zeros(hist_len + 1, dtype=rn_t.dtype, device=rn_t.device)
    hist[0] = rn_t
    rn = float(rn_t)
    u, i = u0, 0
    if monitor is not None:
        monitor(0, u, rn_t)
    while keep_going(cfg, i, rn, bnorm):
        if step_emits_residual:
            u, r = step(b, u)
        else:
            u = step(b, u)
            r = residual(b, u)
        rn_t = norm(r)
        hist[min(i + 1, hist_len)] = rn_t
        if monitor is not None:
            monitor(i + 1, u, rn_t)
        i += 1
        rn = float(rn_t)  # the stop test: the one host read per iteration
    return OuterResult(u=u, rnorm_history=hist / hist[0], iters=i,
                       converged=rn <= cfg.rtol * bnorm,
                       aux=None if monitor is None else monitor.aux())
