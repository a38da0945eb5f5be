"""Probe ``visit_vpu``: what a leaner step body buys in the zero-guess rc
visit (counterpart of ``benchmarks/probe_visit_vpu.py``).

At 8191^2 f32, k = 3 Jacobi steps (omega 0.8), each mode of KP1
(``ops/cuda/probe_kernel.py``) against the production visit (K2b): base,
norm (normalised coefficients), roll (the JAX probe's roll mode, whose
function and, on the card, kernel are base's) and nomask (no per-point
column mask).  Each row: ms per visit differenced between k1 = 2 and k2 =
10 visits (median of 3 pairs), GB/s against the bytes a visit must move
(b in, u and rc out), the share of K18a's stream rate, parity against the
production visit (rel |du|, rel |drc|; "another function" for a mode
that computes another) and against the mode's plain version.
"""

from __future__ import annotations

import torch

from multigrid_petsc_tpu_torch.mesh import MeshType
from multigrid_petsc_tpu_torch.ops.cuda import mdma_kernel as mdma
from multigrid_petsc_tpu_torch.ops.cuda import probe_kernel as pk
from multigrid_petsc_tpu_torch.probes import (
    differenced,
    header,
    rate_line,
    rel_diff,
    stream_rate,
)
from multigrid_petsc_tpu_torch.problems import stencil_coefficients
from multigrid_petsc_tpu_torch.solvers.smoothers import jacobi_step_coeffs

N, K, OMEGA = 8191, 3, 0.8
MODES = ("base", "norm", "roll", "nomask")


def ablation_rows(name: str, modes, device, n: int, k1: int, k2: int,
                  pairs: int, extra: dict | None = None) -> list[dict]:
    """The visit ablation table of ``modes`` at n^2 (shared with
    ``mdma_vpu``)."""
    st = stencil_coefficients(MeshType.UNIFORM, n, n, torch.float32, device)
    steps = jacobi_step_coeffs(K, OMEGA)
    gen = torch.Generator(device=device).manual_seed(0)
    b = torch.randn((n, n), generator=gen, device=device)
    nyc = (n - 1) // 2
    nbytes = 4 * (2 * n * n + nyc * nyc)
    rate = stream_rate(device)
    header(name, device, rate,
           "mode: ms per visit (GB/s vs the bytes b in + u, rc out, share of "
           "K18a's rate) | rel|du| rel|drc| vs the production visit | "
           "max rel|kernel - plain|",
           n=n, k=K, omega=OMEGA, k1=k1, k2=k2, pairs=pairs, **(extra or {}))
    u_ref, rc_ref = mdma.visit_down(st, b, steps)
    rows = []
    for mode in modes:
        u, rc = pk.visit_ablate(st, b, steps, mode)
        pu, prc = pk.visit_ablate_plain(st, b, steps, mode)
        same = pk.mode_of(mode) in ("base", "norm", "nomask")
        du = rel_diff(u, u_ref) if same else None
        drc = rel_diff(rc, rc_ref) if same else None
        err = max(rel_diff(u, pu), rel_diff(rc, prc))
        del u, rc, pu, prc
        s = differenced(lambda m=mode: pk.visit_ablate(st, b, steps, m),
                        k1, k2, device, pairs)
        rows.append({"mode": mode, "ms": 1e3 * s,
                     "GBps": nbytes / s / 1e9, "rel_du": du, "rel_drc": drc,
                     "vs_plain": err})
        vs = (f"rel|du|={du:.2e} rel|drc|={drc:.2e}" if same
              else "another function")
        print(f"{rate_line(f'{mode:10s}', s, nbytes, rate)} | {vs} | vs "
              f"plain {err:.2e}", flush=True)
    return rows


def run(device="cuda", n: int | None = None, quick: bool = False):
    device = torch.device(device)
    k1, k2, pairs = (1, 2, 1) if quick else (2, 10, 3)
    return ablation_rows("visit_vpu", MODES, device, n or N, k1, k2, pairs)
