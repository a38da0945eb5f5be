"""Show that K18b-R / K18b-P's passes read shared memory on every pass,
with no barrier in the pass loop.

Builds ``csrc/probe_xfer.cu`` alone into a cubin (the package's nvcc
flags, under ``multigrid_petsc_tpu_torch/_build/xfer_sass/``),
disassembles it with ``cuobjdump -sass`` and, for each instantiation of
``xfer_pass_kernel<MODE>``, finds its loops (a branch back to an earlier
address) and counts in each the shared-memory loads (LDS*), the barriers
(BAR*) and the instructions.  The pass loop is the loop with the most
loads: its body must hold P x the mode's window loads (K LDS.128 and, for
arith, full and prolong, one load of the edge floats;
``xfer_probe_kernel.TILING`` / ``window_loads``: each pass's window is
loaded again P passes ahead) and no barrier, and the function no barrier
at all.  Loads the compiler had hoisted out of the loop would be missing
from its body.  The loads outside it (the first P windows, the staged
sums read back for the stores) are printed.  Prints one line a mode and a
JSON line; exits non-zero where a count is not the expected one.  Needs
the CUDA toolkit (the card's machine):

    PYTHONPATH=<checkout> python scripts/xfer_sass.py
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess

from multigrid_petsc_tpu_torch.ops.cuda import _build
from multigrid_petsc_tpu_torch.ops.cuda.xfer_probe_kernel import (
    PROLONG,
    RESTRICT_MODES,
    TILING,
    window_loads,
)

NAMES = {**{v: k for k, v in RESTRICT_MODES.items()}, PROLONG: "prolong"}
INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)"
                   r"([^;]*);")
LABEL = re.compile(r"^\s*(\.L_x_\d+):")


def cubin() -> str:
    """``probe_xfer.cu`` built alone into a cubin; its path."""
    out = _build.BUILD_DIR / "xfer_sass"
    out.mkdir(parents=True, exist_ok=True)
    path = out / "probe_xfer.cubin"
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xcompiler",
                                                       "-fPIC")]
    subprocess.run([_build._nvcc(), *flags, "-cubin", "-o", str(path),
                    str(_build.CSRC_DIR / "probe_xfer.cu")], check=True,
                   capture_output=True, text=True, timeout=600)
    return str(path)


def loops(body: str) -> list[dict]:
    """Each backward branch's loop in a function's SASS: its first and
    last address, its instructions, LDS* and BAR* counts."""
    ins, labels, pending = [], {}, []
    for line in body.splitlines():
        m = LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = INSTR.search(line)
        if m:
            addr = int(m.group(1), 16)
            for name in pending:
                labels[name] = addr
            pending = []
            ins.append((addr, m.group(2), m.group(3)))
    found = []
    for addr, op, args in ins:
        if not op.startswith("BRA"):
            continue
        t = re.search(r"0x([0-9a-f]+)", args)
        lab = re.search(r"(\.L_x_\d+)", args)
        target = (int(t.group(1), 16) if t else
                  labels.get(lab.group(1)) if lab else None)
        if target is None or target >= addr:
            continue
        inside = [o for a, o, _ in ins if target <= a <= addr]
        found.append({
            "from": target, "to": addr, "instructions": len(inside),
            "lds": sum(o.startswith("LDS") for o in inside),
            "bar": sum(o.startswith("BAR") for o in inside),
            "fp32": sum(o.split(".")[0] in ("FMUL", "FADD", "FFMA")
                        for o in inside),
            "shfl": sum(o.startswith("SHFL") for o in inside)})
    return found


def main() -> int:
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", cubin()], capture_output=True,
                          text=True, check=True, timeout=600).stdout
    out, ok = {}, True
    for name, body in re.findall(
            r"Function : (\S+)\n(.*?)(?=\n\s*Function : |\Z)", sass, re.S):
        m = re.search(r"xfer_pass_kernelILi(\d)E", name)
        if not m:
            continue
        mode = NAMES[int(m.group(1))]
        p = TILING[mode][1]
        win = window_loads(mode)
        found = loops(body)
        ops = INSTR.findall(body)
        bars = sum(op.startswith("BAR") for _, op, _ in ops)
        lds = sum(op.startswith("LDS") for _, op, _ in ops)
        main_loop = max(found, key=lambda lp: lp["lds"], default=None)
        good = (main_loop is not None and main_loop["lds"] == p * win
                and bars == 0)
        ok &= good
        out[mode] = {"P": p, "window_loads": win, "loops": found,
                     "pass_loop_lds": main_loop and main_loop["lds"],
                     "lds_outside": lds - (main_loop["lds"] if main_loop
                                           else 0),
                     "bar_in_loops": sum(lp["bar"] for lp in found),
                     "bar_in_function": bars, "instructions": len(ops),
                     "ok": good}
        per = ("" if main_loop is None else
               f"; a pass {main_loop['instructions'] / p:.1f} instructions "
               f"({main_loop['fp32'] / p:.1f} FP32, "
               f"{main_loop['shfl'] / p:.1f} SHFL)")
        print(f"{mode:8s}: pass loop {out[mode]['pass_loop_lds']} LDS "
              f"(P {p} x {win} = {p * win} expected), outside it "
              f"{out[mode]['lds_outside']}; BAR in the loop "
              f"{out[mode]['bar_in_loops']}, in the function {bars} (0 "
              f"expected){per}: {'ok' if good else 'NOT AS EXPECTED'}")
    print(json.dumps(out))
    return 0 if ok and len(out) == len(NAMES) else 1


if __name__ == "__main__":
    raise SystemExit(main())
