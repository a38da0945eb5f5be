"""Time K18b-R / K18b-P (``csrc/probe_xfer.cu``, the x-transfer passes on
a resident slab) on one card; with --ab, a parent tree against this
checkout in turns; with --trials, trial tilings of this checkout's source
in turns.

    python scripts/time_xfer.py [--label L] [--lib PATH]
    python scripts/time_xfer.py --ab [PARENT]
    python scripts/time_xfer.py --trials

The package is imported from PYTHONPATH where it is set (so --ab times
another tree by the same cases), else from this checkout.
``probe_xfer.cu`` is built alone (one nvcc, a plain C interface: seconds,
not the whole library's minutes) and bound in place of the package's
library, with the tree's own argument types.  At the transpose probe's
shapes (noop, apply8, arith, shuffle and full on a (48, 8192) f32 slab,
prolong on (57, 4096)), each mode is first held to its plain version bit
for bit, then timed: device ms at G = 86 and at G = 1
(``chip_smoke.device_ms``: 20 launches queued behind a sleeping kernel),
the time a pass (t86 - t1) / 85, and the share of the mode's bound
(``xfer_probe_kernel.xfer_bound`` of this checkout, at the card's SM count
and clocks.max.sm); beside them an empty launch's device ms
(``torch.cuda._sleep(1)``, one thread), the floor under a launch's fixed
cost.  Prints one JSON line, the card's name and power limit included.

--ab builds PARENT's ``probe_xfer.cu`` (default ``_archive/parent``, a
parent commit unpacked there with ``git archive``) and this checkout's
side by side, runs the two in the order parent, change, change, parent
(one process a run) and prints one JSON line with every run.

--trials builds this checkout's source and each of ``TRIALS`` (the source
with a few lines replaced: another K or P for one mode, one warp a block;
shuffle and full take an even K, a lane's sums whole 16-byte units)
and times them in one process in turns, the list and then the list
reversed; each build's every mode is held to the plain version first.
Builds and logs go to ``_archive/time_xfer/``, which git ignores.  Exits
non-zero if a kernel disagrees with its plain version.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.append(str(REPO))  # after PYTHONPATH: another tree may be timed

OUT = REPO / "_archive" / "time_xfer"
TH, NXP, G, T2 = 48, 8192, 86, 112  # the transpose probe's shapes
MODES = ("noop", "apply8", "arith", "shuffle", "full", "prolong")
NAMES = {"noop": "NOOP", "arith": "ARITH", "shuffle": "SHUFFLE",
         "full": "FULL", "apply8": "APPLY8", "prolong": "PROLONG"}


def smoke():
    """``chip_smoke.py`` as a module, by path (its timers)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tiling(mode: str, k: int, p: int) -> list[tuple[str, str]]:
    """The substitution that gives ``mode`` K units a lane and P passes a
    turn in this checkout's source."""
    from multigrid_petsc_tpu_torch.ops.cuda.xfer_probe_kernel import TILING
    k0, p0, _, _ = TILING[mode]
    head = f"template <> struct Tiling<{NAMES[mode]}> {{\n  static " \
           f"constexpr int "
    return [(head + f"K = {k0}, P = {p0},", head + f"K = {k}, P = {p},")]


# name: substitutions in csrc/probe_xfer.cu (each must occur once).
TRIALS = {
    "noop K2": lambda: tiling("noop", 2, 4),
    "noop P2": lambda: tiling("noop", 1, 2),
    "shuffle K4": lambda: tiling("shuffle", 4, 4),
    "shuffle P2": lambda: tiling("shuffle", 2, 2),
    "arith K2": lambda: tiling("arith", 2, 4),
    "arith P4": lambda: tiling("arith", 1, 4),
    "full P4": lambda: tiling("full", 2, 4),
    "full K4": lambda: tiling("full", 4, 2),
    "apply8 K1": lambda: tiling("apply8", 1, 2),
    "apply8 K4": lambda: tiling("apply8", 4, 2),
    "apply8 P4": lambda: tiling("apply8", 2, 4),
    "prolong K1": lambda: tiling("prolong", 1, 4),
    "prolong K4": lambda: tiling("prolong", 4, 4),
    "prolong P2": lambda: tiling("prolong", 2, 2),
    "two warps a block": lambda: [(
        "long long wb = (warps + sms - 1) / sms;", "long long wb = 2;")],
    "four warps a block": lambda: [(
        "long long wb = (warps + sms - 1) / sms;", "long long wb = 4;")],
    # every warp a block of its own: the hardware spreads them
    "one warp a block": lambda: [(
        "long long wb = (warps + sms - 1) / sms;", "long long wb = 1;")],
}


def build(csrc: Path, out: Path, subs=()) -> tuple[Path, subprocess.Popen]:
    """``csrc/probe_xfer.cu`` with ``subs`` applied, built alone into
    out/libxfer.so (started, not waited for)."""
    from multigrid_petsc_tpu_torch.ops.cuda import _build
    if out.exists():
        shutil.rmtree(out)
    out.mkdir(parents=True)
    text = (csrc / "probe_xfer.cu").read_text()
    for old, new in subs:
        if text.count(old) != 1:
            raise SystemExit(f"{out.name}: {old!r} not once in the source")
        text = text.replace(old, new)
    (out / "probe_xfer.cu").write_text(text)
    lib = out / "libxfer.so"
    return lib, subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib),
         str(out / "probe_xfer.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def wait(builds: dict) -> dict:
    """{name: library path} once every build has ended; exits on a failed
    one.  Each build's log goes beside its library."""
    libs = {}
    for name, (lib, proc) in builds.items():
        log = proc.communicate()[0]
        (lib.parent / "build.log").write_text(log)
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        libs[name] = lib
    return libs


def bind(xk, lib: Path):
    """The wrapper module ``xk`` launching from ``lib`` (the tree's own
    argument types)."""
    from multigrid_petsc_tpu_torch.ops.cuda import _build
    cdll = ctypes.CDLL(str(lib))
    cdll.mg_xfer_pass.argtypes = _build._SIGNATURES["mg_xfer_pass"]
    cdll.mg_xfer_pass.restype = ctypes.c_int
    xk.load_library = lambda: cdll


def measure(torch, sm, xk, x, e) -> tuple[dict, bool]:
    """Every mode held to its plain version, then its device ms at G = 86
    and G = 1 and the time a pass; and an empty launch's device ms."""
    ok = True
    res = {"empty_launch": sm.device_ms(torch, lambda: torch.cuda._sleep(1))}

    def call(mode, g):
        return (xk.xfer_prolong(e, g) if mode == "prolong"
                else xk.xfer_restrict(x, mode, g))

    for mode in MODES:
        want = (xk.xfer_prolong_plain(e, G) if mode == "prolong"
                else xk.xfer_restrict_plain(x, mode, G))
        exact = bool(torch.equal(call(mode, G), want))
        ok &= exact
        t86 = sm.device_ms(torch, lambda: call(mode, G))
        t1 = sm.device_ms(torch, lambda: call(mode, 1))
        res[mode] = {"bit_for_bit": exact, "device_ms": t86,
                     "device_ms_g1": t1, "pass_ms": (t86 - t1) / (G - 1)}
    return res, ok


def shares(runs: list[dict], rate: float) -> None:
    """Each run's share of this checkout's bound, added in place."""
    from multigrid_petsc_tpu_torch.ops.cuda import xfer_probe_kernel as xk
    for run in runs:
        for mode, r in run["modes"].items():
            if mode == "empty_launch":
                continue
            rows = T2 // 2 + 1 if mode == "prolong" else TH
            b = xk.xfer_bound(mode, rows, NXP, G, rate)
            r.update(bound_ms=b["bound_ms"], bound_by=b["bound_by"],
                     share=b["bound_ms"] / r["device_ms"])


def line(label: str, run: dict) -> str:
    modes = run["modes"]
    return f"{label}: " + ", ".join(
        f"{m} {r['device_ms']:.4f} ms (G = 1 {r['device_ms_g1']:.4f}, a "
        f"pass {1e3 * r['pass_ms']:.4f} us"
        + (f", {100 * r['share']:.1f}% of the bound" if "share" in r else "")
        + ("" if r["bit_for_bit"] else ", NOT bit for bit") + ")"
        for m, r in modes.items() if m != "empty_launch") + (
        f"; an empty launch {modes['empty_launch']:.4f} ms")


def inputs(torch):
    gen = torch.Generator(device="cuda").manual_seed(25)
    x = torch.randn((TH, NXP), generator=gen, device="cuda")
    e = torch.randn((T2 // 2 + 1, NXP // 2), generator=gen, device="cuda")
    return x, e


def run(args) -> int:
    """One tree: the package on PYTHONPATH, its probe_xfer.cu built alone
    (or ``--lib``)."""
    import torch

    from multigrid_petsc_tpu_torch.ops.cuda import xfer_probe_kernel as xk
    from multigrid_petsc_tpu_torch.probes import smem_rate
    sm = smoke()
    pkg = Path(xk.__file__).resolve().parents[2]
    lib = (Path(args.lib) if args.lib else
           wait({"tree": build(pkg / "csrc", OUT / "tree")})["tree"])
    bind(xk, lib)
    x, e = inputs(torch)
    modes, ok = measure(torch, sm, xk, x, e)
    out = {"label": args.label, "tree": str(pkg), "card": sm.nvidia_smi_line(),
           "rate": smem_rate(torch.device("cuda")), "modes": modes, "ok": ok}
    if hasattr(xk, "xfer_bound"):
        shares([out], out["rate"])
    print(line(args.label or "tree", out))
    print(json.dumps(out))
    return 0 if ok else 1


def ab(parent: Path) -> int:
    """PARENT's probe_xfer.cu and this checkout's built side by side, then
    run in turns, one process a run."""
    trees = {"parent": parent.resolve(), "change": REPO}
    libs = wait({name: build(t / "multigrid_petsc_tpu_torch" / "csrc",
                             OUT / name) for name, t in trees.items()})
    runs, ok = [], True
    for i, name in enumerate(("parent", "change", "change", "parent")):
        res = subprocess.run(
            [sys.executable, __file__, "--label", f"{i}_{name}", "--lib",
             str(libs[name])],
            env=dict(os.environ, PYTHONPATH=str(trees[name])),
            capture_output=True, text=True)
        (OUT / f"run_{i}_{name}.log").write_text(res.stdout + res.stderr)
        if res.returncode not in (0, 1) or not res.stdout.strip():
            print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
            return 1
        r = json.loads(res.stdout.strip().splitlines()[-1])
        ok &= r["ok"]
        runs.append(r)
    shares(runs, runs[0]["rate"])
    for r in runs:
        print(line(r["label"], r))
    print(json.dumps({"card": runs[0]["card"], "runs": runs, "ok": ok}))
    return 0 if ok else 1


def trials() -> int:
    """This checkout's source and each trial, in turns, in one process."""
    import torch

    from multigrid_petsc_tpu_torch.ops.cuda import xfer_probe_kernel as xk
    from multigrid_petsc_tpu_torch.probes import smem_rate
    sm = smoke()
    csrc = REPO / "multigrid_petsc_tpu_torch" / "csrc"
    names = ["source", *TRIALS]
    libs = wait({name: build(csrc, OUT / f"trial_{i}",
                             TRIALS[name]() if name in TRIALS else ())
                 for i, name in enumerate(names)})
    x, e = inputs(torch)
    runs, ok = [], True
    for turn, name in enumerate(names + names[::-1]):
        bind(xk, libs[name])
        modes, good = measure(torch, sm, xk, x, e)
        ok &= good
        runs.append({"label": f"{turn}_{name}", "modes": modes})
    shares(runs, smem_rate(torch.device("cuda")))
    for r in runs:
        print(line(r["label"], r))
    print(json.dumps({"card": sm.nvidia_smi_line(), "runs": runs, "ok": ok}))
    return 0 if ok else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--label", default="")
    ap.add_argument("--lib", default=None)
    ap.add_argument("--ab", nargs="?", const="_archive/parent", default=None,
                    metavar="PARENT")
    ap.add_argument("--trials", action="store_true")
    args = ap.parse_args()
    if args.ab is not None:
        return ab(REPO / args.ab)
    if args.trials:
        return trials()
    return run(args)


if __name__ == "__main__":
    sys.exit(main())
