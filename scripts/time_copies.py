"""Time K18a (the blocked copy o = a u), KP2 (the same in place) and KP3's
staged copy beside the one PyTorch call that computes the same function,
and KP3's visit pipeline in every mode, on one card; with --ab, a parent
tree against this checkout in turns.

    python scripts/time_copies.py [--label L] [--variants] [--out DIR]
    python scripts/time_copies.py --ab [PARENT]

The package is imported from PYTHONPATH where it is set (so --ab times
another tree by the same cases), else from this checkout.  At 8192^2
f32 (a = 1.0001), each kernel first held to its plain version bit for
bit, it prints:

(a) device ms, ``chip_smoke.device_ms``'s method (20 calls queued behind
    a sleeping kernel), and ms a call (CUDA events around one call,
    ``chip_smoke.time_ms``) of ``scale_copy`` (K18a) against
    ``torch.mul(x, a, out=y)``, ``scale_copy_`` (KP2) against
    ``y.mul_(a)`` and ``staged_copy`` (KP3, k = 1) against
    ``y.copy_(x)``;
(b) host us a call: HOST_CALLS calls enqueued behind ``torch.cuda._sleep``
    (the queue never drains), timed on the host clock, median of
    HOST_RUNS, for the three wrappers, their library calls, the bare C
    entry with its launch, and the main path's ``visit_down`` (K2b) and
    ``visit_up`` (K3) at 8191^2, k = 3 (for the record); and each
    wrapper's steps apart, timed alone on the host clock: the device
    test (``_on_cpu``), the checks (``_check_cuda``), the scalar
    (``_scalar``), the stream handle (``_stream``), the output's
    allocation (``torch.empty_like``; KP3's parent allocated n + 3
    entries and sliced them: ``alloc_slack``), and each wrapper's Python
    work alone (its library stood in for by entries that launch nothing);
(c) the loop-differenced K18a rate (``measured_kernel_bandwidth``: k = 18
    less k = 2 chained launches on the host clock) beside ``y.copy_(x)``
    taken the same way, then both again under ``torch.profiler``: each
    kernel's device time, the gaps between launches inside a chain and
    the rate the kernels' own span gives (k = 18 less k = 2).  The
    traces go to DIR (default ``_archive/time_copies/``, which git
    ignores);
(d) KP3's visit pipeline (``staged_visit_pipeline``) at 8191^2 in every
    mode at t = 32, 16 and 48 (where the tree takes them), each first
    held to its plain version bit for bit: device ms, ms a call and host
    us a call (as in (b)), beside ``u.copy_(b)``'s device ms.

--variants also builds ``scripts/copy_variants.cu`` (trial designs of
K18a and of KP3's ring, f32) and times each in turns (the list, then the
list reversed): device ms and the loop-differenced rate, each held to
``torch.mul`` / the input bit for bit first, beside the package's
kernels and the library calls.

--ab builds PARENT's package (default ``_archive/parent``, a parent commit
unpacked there with ``git archive``) and this checkout's side by side,
runs the two in the order parent, change, change, parent (one process a
run, --variants off) and prints one JSON line with every run and the
card's name and power limit.  Each run's output goes to DIR.  Exits
non-zero if a kernel disagrees with its plain version.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.append(str(REPO))  # after PYTHONPATH: another tree may be timed

N = 8192
A = 1.0001
HOST_CALLS = 100
HOST_RUNS = 5


def smoke():
    """``chip_smoke.py`` as a module, by path (its timers)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def host_us(fn, calls: int = 2000) -> float:
    """Host us a call of ``fn`` (no device work), median of 5 runs."""
    fn()
    runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        runs.append(1e6 * (time.perf_counter() - t0) / calls)
    return statistics.median(runs)


def enqueue_us(torch, fn) -> float:
    """Host us a call of ``fn``: HOST_CALLS calls enqueued behind a
    sleeping kernel, so that no call waits for the device, median of
    HOST_RUNS runs.  A run the sleep did not cover is not kept, and the
    next sleeps twice as long."""
    fn()
    torch.cuda.synchronize()
    probe = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    probe[0].record()
    torch.cuda._sleep(10**6)
    probe[1].record()
    probe[1].synchronize()
    cycles_per_ms = 10**6 / probe[0].elapsed_time(probe[1])
    cover, runs = 0.2 * HOST_CALLS + 5.0, []
    slept = torch.cuda.Event()
    while len(runs) < HOST_RUNS:
        torch.cuda._sleep(int(cycles_per_ms * cover))
        slept.record()
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            fn()
        ms = 1e3 * (time.perf_counter() - t0)
        covered = not slept.query()  # still sleeping: nothing waited
        torch.cuda.synchronize()
        if covered:
            runs.append(1e3 * ms / HOST_CALLS)
        else:
            cover *= 2
            if cover > 64 * (0.2 * HOST_CALLS + 5.0):
                raise RuntimeError("the sleep did not cover the queue")
    return statistics.median(runs)


def kernel_spans(path: Path, match) -> dict:
    """From a chrome trace: the device kernels and copies whose name
    ``match`` accepts, in launch order, cut into the runs of a
    loop-differenced sample (k = 18 warm, 18 timed, 2 warm, 2 timed);
    each kernel's us, the gaps between launches inside a run and between
    runs (a synchronisation and the host's return), and the rate the timed
    runs' own device spans give, k = 18 less k = 2."""
    ev = json.loads(path.read_text())
    ev = ev.get("traceEvents", ev)
    ks = sorted((e for e in ev if e.get("cat") in ("kernel", "gpu_memcpy")
                 and match(e.get("name", ""))), key=lambda e: e["ts"])
    pattern = (18, 18, 2, 2)
    if not ks or len(ks) % sum(pattern):
        return {"kernels": len(ks), "names": sorted({e["name"][:80]
                                                     for e in ks})}
    runs, i = [], 0
    while i < len(ks):
        for k in pattern:
            runs.append(ks[i:i + k])
            i += k
    inside = [b["ts"] - (a["ts"] + a["dur"])
              for r in runs for a, b in zip(r, r[1:])]
    between = [b[0]["ts"] - (a[-1]["ts"] + a[-1]["dur"])
               for a, b in zip(runs, runs[1:])]
    span = {18: [], 2: []}
    for j, r in enumerate(runs):
        if j % 2:  # the timed runs
            span[len(r)].append(r[-1]["ts"] + r[-1]["dur"] - r[0]["ts"])
    return {"kernels": len(ks), "names": sorted({e["name"][:80] for e in ks}),
            "kernel_us": statistics.median(e["dur"] for e in ks),
            "gap_us_median": statistics.median(inside),
            "gap_us_max": max(inside),
            "between_runs_us_median": statistics.median(between),
            "span_diff_us": (statistics.median(span[18])
                             - statistics.median(span[2])) / 16}


def profiled_rates(torch, sm, sk, dev, out_dir: Path, label: str) -> dict:
    """(c): the loop-differenced rates, then both again under the
    profiler."""
    from torch.profiler import ProfilerActivity, profile

    nbytes = 2 * 4 * N * N
    res = {}
    info = sk.measured_kernel_bandwidth(N, torch.float32, dev)
    x = torch.ones((N, N), device=dev)
    y = torch.empty_like(x)
    copies = sm.differenced_rate(torch, lambda: y.copy_(x), nbytes)
    res["k18a_GBps"] = info["bytes_per_s"] / 1e9
    res["k18a_samples_GBps"] = info["samples_GBps"]
    res["copy_GBps"] = statistics.median(copies) / 1e9
    res["copy_samples_GBps"] = [c / 1e9 for c in copies]
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    out_dir.mkdir(parents=True, exist_ok=True)
    for key, run, match in (
            ("k18a", lambda: sk.measured_kernel_bandwidth(
                N, torch.float32, dev), lambda s: "scale_copy" in s),
            ("copy", lambda: sm.differenced_rate(
                torch, lambda: y.copy_(x), nbytes),
             lambda s: "copy" in s.lower() or "memcpy" in s.lower())):
        with profile(activities=acts) as prof:
            host = run()
        path = out_dir / f"time_copies_{label or 'run'}_{key}.trace.json"
        prof.export_chrome_trace(str(path))
        spans = kernel_spans(path, match)
        rate = host["bytes_per_s"] if isinstance(host, dict) else (
            statistics.median(host))
        spans["host_differenced_GBps_profiled"] = rate / 1e9
        if spans.get("span_diff_us"):
            spans["span_GBps"] = nbytes / spans["span_diff_us"] / 1e3
        if spans.get("kernel_us"):
            spans["kernel_GBps"] = nbytes / spans["kernel_us"] / 1e3
        res[f"{key}_profiled"] = spans
    return res


def load_variants():
    """Build (if needed) and load ``copy_variants.cu`` into the package's
    build directory, keyed on its source and the flags."""
    from multigrid_petsc_tpu_torch.ops.cuda._build import (
        BUILD_DIR,
        NVCC_FLAGS,
        _nvcc,
    )

    src = Path(__file__).with_name("copy_variants.cu")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode() + src.read_bytes())
    lib = BUILD_DIR / f"libcopyvariants_{h.hexdigest()[:16]}.so"
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        out = subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", "-o",
                              str(tmp), str(src)], capture_output=True,
                             text=True)
        print("\n".join(ln for ln in (out.stdout + out.stderr).splitlines()
                        if "registers" in ln or "error" in ln))
        if out.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{out.stdout}{out.stderr}")
        os.replace(tmp, lib)
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    cdll = ctypes.CDLL(str(lib))
    for name, args in (("tv_tile", [I, I, I, P, P, L, ctypes.c_float, P]),
                       ("tv_tile_inplace", [I, P, L, ctypes.c_float, P]),
                       ("tv_span", [I, I, I, P, P, L, ctypes.c_float, I, P]),
                       ("tv_ring", [I, P, P, L, I, I, P])):
        getattr(cdll, name).argtypes = args
        getattr(cdll, name).restype = I
    return cdll


# The trial designs: name -> (entry, arguments before the pointers).
K18_TRIALS = {
    "tile": ("tv_tile", (0, 1, 4)), "tile cs": ("tv_tile", (1, 1, 4)),
    "tile nc": ("tv_tile", (2, 1, 4)), "tile cs u2": ("tv_tile", (1, 1, 2)),
    "tile cs u8": ("tv_tile", (1, 1, 8)),
    "tile 32B cs": ("tv_tile", (1, 2, 2)),
    "span cs": ("tv_span", (1, 1, 4)),
}
KP2_TRIALS = {"inplace tile": 0, "inplace tile cs": 1}
# name -> (design of tv_ring, blocks an SM); spans: each block its own
# contiguous span; rounds: chunk b of each round, the last round shared;
# ef: an evict-first L2 policy on the bulk copies.
RING_TRIALS = {
    "spans S4 P3 16K x3": (0, 3), "rounds S2 P2 32K x3": (1, 3),
    "rounds S4 P3 16K x3": (2, 3), "rounds S4 P4 16K x3": (3, 3),
    "rounds S3 P3 32K x2": (4, 2), "rounds S6 P5 16K x2": (5, 2),
    "rounds S4 P3 32K x1": (6, 1), "rounds S2 P2 16K x6": (7, 6),
    "rounds S3 P2 32K x2": (8, 2), "rounds S3 P2 32K x2 ef": (9, 2),
    "rounds S4 P3 16K x3 ef": (10, 3),
}
# The staged copy's halves: its bulk loads alone and its bulk stores alone
# (each moves half the copy's bytes), beside a read-bound and a write-bound
# library call.
RING_HALVES = {"S3 P2 32K x2 loads only": (11, 2),
               "S3 P2 32K x2 stores only": (12, 2)}


def run_variants(torch, sm, sk, plk, dev) -> dict:
    """Every trial design, held to its reference bit for bit, then timed
    in turns with the package's kernels and the library calls."""
    from multigrid_petsc_tpu_torch.ops.cuda._build import check

    lib = load_variants()
    x = torch.randn((N, N), device=dev)
    y = torch.empty_like(x)
    n, st = x.numel(), torch.cuda.current_stream().cuda_stream
    nbytes = 8 * n
    z = x.clone()
    cases = {"package scale_copy": lambda: sk.scale_copy(x, A, out=y),
             "torch.mul(out=)": lambda: torch.mul(x, A, out=y),
             "package scale_copy_": lambda: sk.scale_copy_(z, A),
             "z.mul_(a)": lambda: z.mul_(A),
             "package staged_copy": lambda: plk.staged_copy(x, 1),
             "y.copy_(x)": lambda: y.copy_(x)}
    want = torch.mul(x, A)
    for name, (fn, pre) in K18_TRIALS.items():
        per_sm = (0,) if fn == "tv_span" else ()
        call = (lambda f=getattr(lib, fn), p=pre, q=per_sm: check(
            f(*p, x.data_ptr(), y.data_ptr(), n, A, *q, st), name))
        y.zero_()
        call()
        torch.cuda.synchronize()
        assert torch.equal(y, want), f"K18a trial {name}: not bit for bit"
        cases[name] = call
    for name, hint in KP2_TRIALS.items():
        w = x.clone()
        check(lib.tv_tile_inplace(hint, w.data_ptr(), n, A, st), name)
        torch.cuda.synchronize()
        assert torch.equal(w, want), f"KP2 trial {name}: not bit for bit"
        cases[name] = (lambda h=hint: check(lib.tv_tile_inplace(
            h, z.data_ptr(), n, A, st), "inplace"))
    for name, (d, per_sm) in RING_TRIALS.items():
        for k in (1, 2, 3):
            y.zero_()
            check(lib.tv_ring(d, x.data_ptr(), y.data_ptr(), n, k, per_sm,
                              st), name)
            torch.cuda.synchronize()
            assert torch.equal(y, x), f"KP3 trial {name} k = {k}"
        cases[name] = (lambda d=d, p=per_sm: check(lib.tv_ring(
            d, x.data_ptr(), y.data_ptr(), n, 1, p, st), "ring"))
    for name, (d, per_sm) in RING_HALVES.items():
        check(lib.tv_ring(d, x.data_ptr(), y.data_ptr(), n, 1, per_sm, st),
              name)
        cases[name] = (lambda d=d, p=per_sm: check(lib.tv_ring(
            d, x.data_ptr(), y.data_ptr(), n, 1, p, st), "ring half"))
    s = torch.empty((), device=dev)
    cases["torch.sum(x, out=s)"] = lambda: torch.sum(x, dim=None, out=s)
    cases["y.zero_()"] = lambda: y.zero_()
    order = list(cases) + list(cases)[::-1]
    res = {name: {"device_ms": [], "diff_GBps": []} for name in cases}
    for name in order:
        res[name]["device_ms"].append(sm.device_ms(torch, cases[name]))
        res[name]["diff_GBps"].append(statistics.median(
            sm.differenced_rate(torch, cases[name], nbytes)) / 1e9)
    for name, r in res.items():
        print(f"  variant {name}: device ms {r['device_ms'][0]:.4f} / "
              f"{r['device_ms'][1]:.4f}, differenced "
              f"{r['diff_GBps'][0]:.1f} / {r['diff_GBps'][1]:.1f} GB/s")
    return res


PIPE_N = 8191
PIPE_TS = (32, 16, 48)


def run_pipeline(torch, sm, plk, dev) -> tuple[dict, bool]:
    """(d): the visit pipeline in every mode at the tile rows PIPE_TS."""
    gen = torch.Generator(device=dev).manual_seed(24)
    b = torch.randn((PIPE_N, PIPE_N), generator=gen, device=dev)
    ok, res = True, {"modes": {}}
    for mode in plk.PIPE_MODES:
        want = plk.staged_visit_pipeline_plain(b, 32, mode)
        for t in PIPE_TS:
            if plk.pipe_smem_bytes(t, mode) > plk.MAX_SMEM:
                continue  # the tree takes no such t in this mode
            got = plk.staged_visit_pipeline(b, t, mode)
            ok &= all((g is None and w is None) or torch.equal(g, w)
                      for g, w in zip(got, want))
            fn = (lambda m=mode, tt=t: plk.staged_visit_pipeline(b, tt, m))
            res["modes"][f"{mode} t={t}"] = r = {
                "device_ms": sm.device_ms(torch, fn),
                "ms": sm.time_ms(torch, fn), "host_us": enqueue_us(torch, fn)}
            print(f"(d) {mode} t = {t}: device {r['device_ms']:.4f} ms, a "
                  f"call {r['ms']:.4f} ms, host {r['host_us']:.2f} us")
    u = torch.empty_like(b)
    res["copy_device_ms"] = sm.device_ms(torch, lambda: u.copy_(b))
    print(f"(d) u.copy_(b) at 8191^2: device {res['copy_device_ms']:.4f} ms")
    del b, u
    torch.cuda.empty_cache()
    return res, ok


def run(args) -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from multigrid_petsc_tpu_torch.mesh import MeshType
    from multigrid_petsc_tpu_torch.ops.cuda import mdma_kernel as mk
    from multigrid_petsc_tpu_torch.ops.cuda import pipeline_kernel as plk
    from multigrid_petsc_tpu_torch.ops.cuda import stream_kernel as sk
    from multigrid_petsc_tpu_torch.ops.cuda._build import load_library
    from multigrid_petsc_tpu_torch.problems import stencil_coefficients
    from multigrid_petsc_tpu_torch.solvers.smoothers import jacobi_step_coeffs

    sm = smoke()
    dev = torch.device("cuda")
    f32 = torch.float32
    lib = load_library()
    out = {"label": args.label, "card": sm.nvidia_smi_line(),
           "package": str(Path(sk.__file__).resolve().parents[2]),
           "torch": torch.__version__, "cuda": torch.version.cuda}
    gen = torch.Generator(device=dev).manual_seed(23)
    x = torch.randn((N, N), generator=gen, device=dev)
    y = torch.empty_like(x)
    ok = True
    # Bit for bit first, every type, a tensor and a view one entry in.
    for dt in sk.DTYPES:
        u = x.to(dt)
        v = u.view(-1)[1:1 + (N - 1) ** 2].view(N - 1, N - 1)
        for w in (u, v):
            ok &= torch.equal(sk.scale_copy(w, A), sk.scale_copy_plain(w, A))
            ok &= torch.equal(sk.scale_copy_(w.clone(), A),
                              sk.scale_copy_plain_(w.clone(), A))
    for k in (1, 2, 3):
        ok &= torch.equal(plk.staged_copy(x, k), x)
    out["bit_for_bit"] = bool(ok)
    # (a) device ms and ms a call, kernel against library.
    z = x.clone()
    pairs = {"scale_copy": (lambda: sk.scale_copy(x, A, out=y),
                            lambda: torch.mul(x, A, out=y)),
             "scale_copy_": (lambda: sk.scale_copy_(z, A),
                             lambda: z.mul_(A)),
             "staged_copy": (lambda: plk.staged_copy(x, 1),
                             lambda: y.copy_(x))}
    dev_rec = {}
    for name, (kern, libc) in pairs.items():
        dev_rec[name] = {
            "device_ms": sm.device_ms(torch, kern),
            "library_device_ms": sm.device_ms(torch, libc),
            "ms": sm.time_ms(torch, kern),
            "library_ms": sm.time_ms(torch, libc)}
        r = dev_rec[name]
        print(f"(a) {name}: device {r['device_ms']:.4f} ms (library "
              f"{r['library_device_ms']:.4f}), a call {r['ms']:.4f} ms "
              f"(library {r['library_ms']:.4f})")
    out["device"] = dev_rec
    # (b) host us a call, enqueued behind a sleep, and the steps alone.
    st_h = mk._stream(x.device)
    n = x.numel()
    raw = {
        "scale_copy": lambda: lib.mg_scale_copy(
            x.data_ptr(), y.data_ptr(), n, A, st_h),
        "scale_copy_": lambda: lib.mg_scale_copy_inplace(
            z.data_ptr(), n, A, st_h),
        "staged_copy": lambda: lib.mg_staged_copy(
            x.data_ptr(), y.data_ptr(), n, 1, st_h)}
    host = {}
    for name, (kern, libc) in pairs.items():
        host[name] = {"wrapper_us": enqueue_us(torch, kern),
                      "library_us": enqueue_us(torch, libc),
                      "c_entry_us": enqueue_us(torch, raw[name])}
    both = {"u": (x, x.shape), "out": (y, x.shape)}
    steps = {
        "on_cpu": lambda: mk._on_cpu(x),
        "checks": lambda: mk._check_cuda(x.device, both, dtypes=sk.DTYPES),
        "checks_one": lambda: mk._check_cuda(x.device, {"u": (x, x.shape)}),
        "scalar": lambda: sk._scalar(A, f32),
        "stream": lambda: mk._stream(x.device),
        "alloc": lambda: torch.empty_like(x),
        "alloc_slack": lambda: torch.empty(n + 3, device=x.device)[
            1:1 + n].view(x.shape),
        "data_ptrs": lambda: (x.data_ptr(), y.data_ptr(), x.numel()),
        "device_attr": lambda: x.device,
        "get_device": lambda: x.get_device(),
        "raw_stream": lambda: torch._C._cuda_getCurrentRawStream(
            x.get_device()),
    }
    host["steps_us"] = {k: host_us(fn) for k, fn in steps.items()}
    # The wrappers' Python work alone: their library stood in for by one
    # whose entries return 0 and launch nothing.
    nolaunch = type("NoLaunch", (), {"__getattr__": lambda self, name: (
        lambda *args: 0)})()
    for mod in (sk, plk):
        mod.load_library = lambda: nolaunch
    for name, (kern, _) in pairs.items():
        host[name]["python_us"] = host_us(kern)
    for mod in (sk, plk):
        mod.load_library = load_library
    m = N - 1
    stc = stencil_coefficients(MeshType.UNIFORM, m, m, f32, dev)
    jac = jacobi_step_coeffs(3, 0.8)
    b = torch.randn((m, m), generator=gen, device=dev)
    e_c = torch.randn(((m - 1) // 2,) * 2, generator=gen, device=dev)
    u0 = torch.randn((m, m), generator=gen, device=dev)
    host["visit_down_us"] = enqueue_us(torch, lambda: mk.visit_down(stc, b,
                                                                    jac))
    host["visit_up_us"] = enqueue_us(
        torch, lambda: mk.visit_up(stc, b, u0, e_c, jac))
    del b, e_c, u0, stc
    for name in pairs:
        h = host[name]
        print(f"(b) {name}: wrapper {h['wrapper_us']:.2f} us a call (its "
              f"Python alone {h['python_us']:.2f}), its C entry "
              f"{h['c_entry_us']:.2f}, library {h['library_us']:.2f}")
    print("(b) steps (us): " + ", ".join(
        f"{k} {v:.2f}" for k, v in host["steps_us"].items()))
    print(f"(b) visit_down {host['visit_down_us']:.2f} us, visit_up "
          f"{host['visit_up_us']:.2f} us a call (8191^2, k = 3)")
    out["host"] = host
    del x, y, z
    torch.cuda.empty_cache()
    # (c) the loop-differenced rates, plain and profiled.
    out["rates"] = profiled_rates(torch, sm, sk, dev, Path(args.out),
                                  args.label)
    r = out["rates"]
    print(f"(c) K18a {r['k18a_GBps']:.1f} GB/s {r['k18a_samples_GBps']}, "
          f"y.copy_(x) {r['copy_GBps']:.1f} GB/s; profiled: "
          f"{json.dumps(r['k18a_profiled'])} / "
          f"{json.dumps(r['copy_profiled'])}")
    out["pipeline"], pipe_ok = run_pipeline(torch, sm, plk, dev)
    ok &= pipe_ok
    if args.variants:
        out["variants"] = run_variants(torch, sm, sk, plk, dev)
    out["ok"] = bool(ok)
    print(json.dumps(out))
    return 0 if ok else 1


def ab(parent: Path, out_dir: Path) -> int:
    """PARENT and this checkout built side by side, then run in turns."""
    sm = smoke()
    trees = {"parent": parent.resolve(), "change": REPO}
    build = {name: subprocess.Popen(
        [sys.executable, "-c", "from multigrid_petsc_tpu_torch.ops.cuda."
         "_build import load_library; load_library()"],
        env=dict(os.environ, PYTHONPATH=str(t)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for name, t in trees.items()}
    for name, p in build.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            print(f"{name}: build failed\n{log}", file=sys.stderr)
            return 1
    out_dir.mkdir(parents=True, exist_ok=True)
    runs, ok = [], True
    for i, name in enumerate(("parent", "change", "change", "parent")):
        res = subprocess.run(
            [sys.executable, __file__, "--label", f"{i}_{name}", "--out",
             str(out_dir)],
            env=dict(os.environ, PYTHONPATH=str(trees[name])),
            capture_output=True, text=True)
        (out_dir / f"time_copies_{i}_{name}.log").write_text(
            res.stdout + res.stderr)
        if res.returncode not in (0, 1) or not res.stdout.strip():
            print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
            return 1
        print("\n".join(ln for ln in res.stdout.splitlines()
                        if ln.startswith("(")))
        line = json.loads(res.stdout.strip().splitlines()[-1])
        ok &= line["ok"]
        runs.append(line)
    print(json.dumps({"card": sm.nvidia_smi_line(), "runs": runs, "ok": ok}))
    return 0 if ok else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--label", default="")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--ab", nargs="?", const="_archive/parent", default=None,
                    metavar="PARENT")
    ap.add_argument("--out", default=str(REPO / "_archive" / "time_copies"))
    args = ap.parse_args()
    if args.ab is not None:
        return ab(REPO / args.ab, Path(args.out))
    return run(args)


if __name__ == "__main__":
    sys.exit(main())
