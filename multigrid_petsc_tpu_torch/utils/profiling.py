"""Profiling: per-phase timing of the fine level's building blocks, and a
device trace (PyTorch counterpart of
``multigrid_petsc_tpu/utils/profiling.py``; reference: the PETSc log
stages around the solve, src/solver.c:1526-1553, and -log_view).

  * ``phase_breakdown``: each building block of a context's level 0
    (smooth, residual, restrict, prolong, norm), the median of ``reps``
    runs after one warm-up run: timed with CUDA events on the card, with
    ``time.perf_counter`` on the CPU.
  * ``trace``: a context manager around ``torch.profiler`` that writes a
    Chrome trace (``trace.json``, viewable in Perfetto).
"""

from __future__ import annotations

import contextlib
import statistics
import time
from pathlib import Path

import torch



def _time_op(fn, device: torch.device, reps: int) -> float:
    """Median seconds of ``fn()`` over ``reps`` runs, after one."""
    fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) * 1e-3)
        else:
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
    return statistics.median(times)


def phase_breakdown(ctx, v: int | None = None, reps: int = 5) -> dict:
    """Seconds of each level-0 building block: ``smooth_v`` (``v`` sweeps
    from the zero guess; None: cfg.v[0]), ``residual``, ``restrict`` and
    ``prolong`` (with two or more levels) and ``norm``, the JAX package's
    keys."""
    v = ctx.config.v[0] if v is None else v
    lvl0 = ctx.levels[0]
    b = ctx.b0
    u = lvl0.zeros()
    dev = ctx.device
    out = {
        "smooth_v": _time_op(lambda: lvl0.smooth(b, u, v), dev, reps),
        "residual": _time_op(lambda: lvl0.residual(b, u), dev, reps),
    }
    if len(ctx.levels) > 1:
        r0 = b if isinstance(b, torch.Tensor) else b[0]
        out["restrict"] = _time_op(lambda: ctx.restrict_to_next(0, r0), dev,
                                   reps)
        un = ctx.levels[1].zeros()
        out["prolong"] = _time_op(lambda: ctx.prolong_from_next(0, un), dev,
                                  reps)
    out["norm"] = _time_op(lambda: lvl0.norm2(b), dev, reps)
    return out


@contextlib.contextmanager
def trace(logdir: str | Path = "torch_trace"):
    """Capture a trace of the host and, with a card, the device:
    ``with profiling.trace(dir): solve(...)`` writes ``dir/trace.json``."""
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield logdir
    prof.export_chrome_trace(str(logdir / "trace.json"))
