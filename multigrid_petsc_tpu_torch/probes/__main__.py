"""``python -m multigrid_petsc_tpu_torch.probes <name> [--device cuda|cpu]
[--n N] [--quick]``: one attribution probe (or ``all``), on the card by
default, at its full size unless ``--n`` cuts it (``cg_ablate``: the
copies at n^2, the mg-CG at (n + 1)^2).
``--quick`` runs each table once at the fewest calls (a check that the
path runs, not a measurement)."""

from __future__ import annotations

import argparse
import importlib

from multigrid_petsc_tpu_torch.probes import PROBES


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m multigrid_petsc_tpu_torch"
                                      ".probes")
    ap.add_argument("name", choices=PROBES + ("all",))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=None)
    ap.add_argument("--quick", action="store_true")
    a = ap.parse_args(argv)
    for name in PROBES if a.name == "all" else (a.name,):
        mod = importlib.import_module(f"multigrid_petsc_tpu_torch.probes."
                                      f"{name}")
        mod.run(a.device, a.n, a.quick)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
