"""Show that K18b-R / K18b-P's passes read shared memory on every pass.

Builds (or loads) the package's CUDA library, disassembles it with
``cuobjdump -sass`` and, for each instantiation of ``csrc/probe_xfer.cu``'s
``xfer_pass_kernel<MODE>``, counts the barriers (BAR.SYNC) and the
shared-memory loads (LDS*) that follow each barrier up to the next one.
The pass loop starts each pass with ``__syncthreads()``: where the window
loads were hoisted out of the loop, the segments after the loop's
barriers would hold one LDS (the pass's scale) and nothing else.  Prints
one line a mode and a JSON line.  Needs the CUDA toolkit (the card's
machine):

    PYTHONPATH=<checkout> python scripts/xfer_sass.py
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess

from multigrid_petsc_tpu_torch.ops.cuda._build import load_library
from multigrid_petsc_tpu_torch.ops.cuda.xfer_probe_kernel import (
    PROLONG,
    RESTRICT_MODES,
    WINDOWS,
)

NAMES = {**{v: k for k, v in RESTRICT_MODES.items()}, PROLONG: "prolong"}


def main() -> int:
    lib = load_library()._name
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True, timeout=600).stdout
    out = {}
    for name, body in re.findall(
            r"Function : (\S+)\n(.*?)(?=\n\s*Function : |\Z)", sass, re.S):
        m = re.search(r"xfer_pass_kernelILi(\d)E", name)
        if not m:
            continue
        mode = NAMES[int(m.group(1))]
        ops = re.findall(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)", body)
        segs, cur = [], None
        for op in ops:
            if op.startswith("BAR.SYNC"):
                cur = 0
                segs.append(cur)
            elif op.startswith("LDS") and cur is not None:
                segs[-1] += 1
        window = WINDOWS[mode][0] // 4
        out[mode] = {"instructions": len(ops), "barriers": len(segs),
                     "lds_after_each_barrier": segs,
                     "window_lds_a_pass": window}
        print(f"{mode:8s}: {len(ops)} instructions, {len(segs)} BAR.SYNC, "
              f"LDS after each: {segs} (a pass's window: {window} LDS.128 "
              f"+ 1 for its scale)")
    print(json.dumps(out))
    return 0 if len(out) == len(NAMES) else 1


if __name__ == "__main__":
    raise SystemExit(main())
