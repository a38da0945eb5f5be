"""The attribution probes of the port: ``python -m
multigrid_petsc_tpu_torch.probes <name>`` (``probes/__main__.py``).

Counterparts of the JAX package's attribution probes under
``benchmarks/`` (``probe_visit_vpu.py``, ``probe_mdma_vpu.py``,
``probe_halo_cost.py``, ``probe_cg_ablate.py``, ``probe_dma.py``,
``probe_dma_parts.py``), run on the card at their full sizes.  Each
splits a time into its parts: a visit's steps, restriction and loads
(``visit_vpu``, ``mdma_vpu``: KP1's modes), the visit kernel alone beside
the transfers (``halo_cost``), an mg-CG iteration's parts and the copy
chains (``cg_ablate``: KP2), the stream rates of plain, in-place and
staged copies (``dma``: KP2, KP3) and the compute-free visit pipeline
(``dma_parts``: KP3).  Every rate is printed beside K18a's stream rate
(``stream_kernel.measured_kernel_bandwidth``) and the card's name and
power limit.  With ``--device cpu`` the plain versions run at a small
``--n`` (their times are the host's, no device metric).

This module holds what the six share: the differenced timer, the rate
line and the card line.  No module of the port imports the probes.
"""

from __future__ import annotations

import statistics
import subprocess
import time

import torch

PROBES = ("visit_vpu", "mdma_vpu", "halo_cost", "cg_ablate", "dma",
          "dma_parts")


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def differenced(step, k1: int, k2: int, device: torch.device,
                pairs: int = 3, reset=None) -> float:
    """Seconds per call of ``step``, as the JAX probes time their loops: k
    calls run between two synchronisations on the host clock (each k run
    once to warm), (t(k2) - t(k1)) / (k2 - k1), the median of ``pairs``
    such pairs.  The difference cancels what a run pays once.
    ``reset()``, where given, runs before each run, untimed (the JAX
    probes start every run from the same state)."""

    def timed(k):
        if reset is not None:
            reset()
        sync(device)
        t0 = time.perf_counter()
        for _ in range(k):
            step()
        sync(device)
        return time.perf_counter() - t0

    timed(k1)
    timed(k2)
    return statistics.median((timed(k2) - timed(k1)) / (k2 - k1)
                             for _ in range(max(pairs, 1)))


def feeding(fn, x):
    """A step that calls ``fn`` on the last call's output (x first)."""
    box = [x]

    def step():
        box[0] = fn(box[0])

    return step


def card_line(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    if device.type != "cuda":
        return "cpu: plain versions, host clock (no device metric)"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def stream_rate(device: torch.device) -> float | None:
    """K18a's stream rate on the card (B/s), None on the CPU."""
    if device.type != "cuda":
        return None
    from multigrid_petsc_tpu_torch.ops.cuda import stream_kernel

    return stream_kernel.measured_kernel_bandwidth(
        device=device)["bytes_per_s"]


def rate_line(label: str, seconds: float, nbytes: float,
              rate: float | None) -> str:
    """``label: ms (GB/s vs the bytes, share of K18a's rate)``."""
    gbs = nbytes / max(seconds, 1e-12) / 1e9
    share = ("K18a's rate not measured" if rate is None else
             f"{100 * gbs * 1e9 / rate:.1f}% of K18a's {rate / 1e9:.1f} GB/s")
    return (f"{label}: {1e3 * seconds:.4f} ms ({gbs:.1f} GB/s vs "
            f"{nbytes / 1e6:.2f} MB, {share})")


def header(name: str, device: torch.device, rate: float | None,
           columns: str, **sizes) -> None:
    """The probe's first lines: what ran where, and its columns."""
    what = ", ".join(f"{k}={v}" for k, v in sizes.items())
    print(f"probe {name} on {card_line(device)}; {what}")
    print(f"K18a stream rate: "
          + ("not measured (cpu)" if rate is None
             else f"{rate / 1e9:.1f} GB/s"))
    print(f"columns: {columns}", flush=True)


def rel_diff(got: torch.Tensor, want: torch.Tensor) -> float:
    """max|got - want| / max|want|."""
    scale = float(want.abs().max().clamp_min(1e-30))
    return float((got.double() - want.double()).abs().max()) / scale
