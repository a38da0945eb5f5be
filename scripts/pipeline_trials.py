"""Trial builds of KP3's visit pipeline (``csrc/pipeline.cu``), timed in
turns against the source as it stands, on one card.

    python scripts/pipeline_trials.py

Each trial is the source with a few lines replaced (TRIALS): the heads
and tails of unaligned rows by plain loads in the producer (the lanes
then wait a memory latency a value), the evict-first hint on the
consumers' stores, 4 or 16 consumer warps, bands of 4 or 16 tiles.  Each
is built alone with the package's nvcc flags into the package's build
directory and called through its C entry at 8191^2 f32 in every mode at
t = 32 and 16, with the wrapper's ring (``pipe_stages``); the source as
it stands also with every stage count that fits (3-6).  Every output is
first held to the plain version bit for bit; then device ms
(``chip_smoke.device_ms``) in turns, the list and the list reversed.
Prints one line a case and, last, one JSON line with the card's name and
power limit.  Exits non-zero if a case disagrees with its plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.append(str(REPO))

from time_copies import smoke  # noqa: E402

N = 8191
TS = (32, 16)
# name -> ((old, new) line replacements of csrc/pipeline.cu)
TRIALS = {
    "heads and tails by plain loads": (
        ("for (int j = 0; j < s.head; ++j) async_load4(row + j, P.b + g + j);",
         "for (int j = 0; j < s.head; ++j) row[j] = P.b[g + j];"),
        ("      async_load4(row + j, P.b + g + j);",
         "      row[j] = P.b[g + j];"),
        ("  async_arrive(full);", "  mbar_arrive(full);")),
    "evict-first stores": (
        ("dv[m] = sv[m];", "__stcs(dv + m, sv[m]);"),
        ("    dst[e] = src[s.pad + e];", "    __stcs(dst + e, src[s.pad + e]);"),
        ("P.rc[g + j] = pick(row, e0 + 2 * j);",
         "__stcs(P.rc + g + j, pick(row, e0 + 2 * j));")),
    "4 consumer warps": (
        ("constexpr int PIPE_WARPS = 8;", "constexpr int PIPE_WARPS = 4;"),
        ("constexpr int PIPE_THREADS = 288;",
         "constexpr int PIPE_THREADS = 160;")),
    "16 consumer warps": (
        ("constexpr int PIPE_WARPS = 8;", "constexpr int PIPE_WARPS = 16;"),
        ("constexpr int PIPE_THREADS = 288;",
         "constexpr int PIPE_THREADS = 544;")),
    "bands of 4 tiles": (
        ("constexpr int BAND_TILES = 8;", "constexpr int BAND_TILES = 4;"),),
    "bands of 16 tiles": (
        ("constexpr int BAND_TILES = 8;", "constexpr int BAND_TILES = 16;"),),
}


def build(name: str, text: str):
    """``text`` built alone into the package's build directory (keyed on
    the text and the flags), its entry typed."""
    from multigrid_petsc_tpu_torch.ops.cuda._build import (
        BUILD_DIR,
        NVCC_FLAGS,
        _nvcc,
    )

    key = hashlib.sha256(" ".join(NVCC_FLAGS).encode() + text.encode())
    lib = BUILD_DIR / f"libpipetrial_{key.hexdigest()[:16]}.so"
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src = lib.with_suffix(".cu")
        src.write_text(text)
        out = subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(lib),
                              str(src)], capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{out.stderr}")
    cdll = ctypes.CDLL(str(lib))
    P, I = ctypes.c_void_p, ctypes.c_int
    cdll.mg_staged_pipe.argtypes = [P] * 3 + [I] * 6 + [P]
    cdll.mg_staged_pipe.restype = I
    return cdll


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from multigrid_petsc_tpu_torch.ops.cuda import pipeline_kernel as plk
    from multigrid_petsc_tpu_torch.ops.cuda._build import check

    sm = smoke()
    base = (REPO / "multigrid_petsc_tpu_torch" / "csrc" / "pipeline.cu"
            ).read_text()
    libs = {"as built": build("as built", base)}
    for name, edits in TRIALS.items():
        text = base
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: no line {old!r} in pipeline.cu")
            text = text.replace(old, new)
        libs[name] = build(name, text)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(24)
    b = torch.randn((N, N), generator=gen, device=dev)
    u = torch.empty_like(b)
    rc = torch.empty(((N - 1) // 2,) * 2, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    cases, ok = {}, True
    for name, lib in libs.items():
        for mode, (carry, staging, rc_on) in plk.PIPE_MODES.items():
            want = plk.staged_visit_pipeline_plain(b, 32, mode)
            for t in TS:
                chosen = plk.pipe_stages(t, mode)
                every = range(plk.PIPE_MIN_STAGES, plk.PIPE_STAGES + 1)
                for stages in every if name == "as built" else (chosen,):
                    if plk.pipe_smem_bytes(t, mode, stages) > plk.MAX_SMEM:
                        continue
                    call = (lambda f=lib.mg_staged_pipe, tt=t, st=stages,
                            c=carry, s=staging, r=rc_on: check(f(
                                b.data_ptr(), u.data_ptr(),
                                rc.data_ptr() if r else None, N, N, tt, st,
                                int(c), int(s), stream), "trial"))
                    u.zero_()
                    rc.zero_()
                    call()
                    torch.cuda.synchronize()
                    ok &= torch.equal(u, want[0]) and (
                        not rc_on or torch.equal(rc, want[1]))
                    cases[f"{name}: {mode} t={t} S{stages}"] = call
    times = {k: [] for k in cases}
    for k in list(cases) + list(cases)[::-1]:
        times[k].append(sm.device_ms(torch, cases[k]))
    for k, v in times.items():
        print(f"{k}: device {v[0]:.4f} / {v[1]:.4f} ms")
    print(json.dumps({"card": sm.nvidia_smi_line(), "device_ms": times,
                      "bit_for_bit": bool(ok)}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
