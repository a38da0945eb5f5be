"""Build and load the package's CUDA kernels (and its host CSR assembler,
``load_assembler``).

At first use, every ``csrc/*.cu`` source of the package is compiled with
``nvcc`` for Hopper (``sm_90a``), one ``nvcc`` per source, all started
together (the visit kernels' and the line visit's f32, f64 and bf16
instantiations and the visit kernels' entries for a block of a
partitioned level are sources of their own, the bf16 block entries two,
so that they build side by side), and the
objects are linked into one shared library with a plain
C interface under ``multigrid_petsc_tpu_torch/_build/`` (not tracked by
git), which is loaded with ``ctypes``.  The build log (``build.log``)
ends with each source's compile seconds (``nvcc <source>: <s> s``).  The library name carries a hash of the
sources, their shared header(s) ``csrc/*.cuh`` and the flags, so an edited
source rebuilds.  Nothing here runs at
import time: the CPU-only test tier imports every module without a
compiler or a card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points (csrc/*.cu) and their argument types: every pointer and
# the stream as c_void_p, so no 64-bit value is cut to a C int.
_F = ctypes.c_float
_D = ctypes.c_double
# The visit-family entries (csrc/visit.cuh MG_VISIT_ENTRIES) exist once per
# storage type: mg_visit (f32), mg_visit_f64, mg_visit_bf16, ...
_PER_DTYPE = {
    "mg_visit": [_P] * 5 + [_P] * 10 + [_I, _I, _P, _I, _I, _P],
    "mg_visit9": [_P, _P] + [_P] * 7 + [_I, _I, _P, _I, _I, _P],
    "mg_stencil": [_P] * 5 + [_P] * 3 + [_I, _I, _I, _P],
    "mg_stencil9": [_P, _P] + [_P] * 3 + [_I, _I, _I, _P],
}
# K17's entries for a block of a partitioned level (MG_VISIT_PART_ENTRIES:
# a row block or a 2-D block), f32, f64 and bf16.
_PART = {
    "mg_visit_part": [_P] * 5 + [_P] * 6 + [_P, _P, _I, _P, _I, _I, _P],
    "mg_visit9_part": [_P, _P, _I, _I] + [_P] * 6
    + [_P, _P, _I, _P, _I, _I, _P],
    "mg_stencil_part": [_P] * 5 + [_P] * 3 + [_P, _P, _I, _I, _P],
    "mg_stencil9_part": [_P, _P, _I, _I] + [_P] * 3 + [_P, _P, _I, _I, _P],
}
# K15's entries per storage type: (suffix, omega's C type).
_LINE = (("", _F), ("_f64", _D), ("_bf16", _F))
_SIGNATURES = {
    **{name + sfx: argtypes for name, argtypes in _PER_DTYPE.items()
       for sfx in ("", "_f64", "_bf16")},
    **{name + sfx: argtypes for name, argtypes in _PART.items()
       for sfx in ("", "_f64", "_bf16")},
    # K15 (csrc/line.cuh; omega in the compute type): one sweep and the
    # residual launch (MG_LINE_ENTRIES: f32, f64, bf16), the rank-spanning
    # mode and its 2-D block mode (MG_LINE_ROWS_ENTRIES: f32, f64).
    **{"mg_line_sweep" + sfx: [_P, _P, _P, _I, _I, _P, _P, _I, _P, _P, _I]
       + [_P] * 3 + [_I, _I, t, t, _P] for sfx, t in _LINE},
    **{"mg_line_residual" + sfx: [_P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _P]
       for sfx, _ in _LINE},
    **{"mg_line_rows_ends" + sfx: [_P, _P, _P, _I, _I] + [_P] * 8
       + [_I] * 4 + [_P] for sfx, _ in _LINE[:2]},
    **{"mg_line_rows_carry" + sfx: [_P, _I, _I, _P, _I, _P, _P]
       + [_I] * 4 + [_P] for sfx, _ in _LINE[:2]},
    **{"mg_line_rows_fix" + sfx: [_P, _P, _P, _I, _I] + [_P] * 9
       + [_I] * 5 + [t, t, _P] for sfx, t in _LINE[:2]},
    "mg_visit_blocks": [_I, _I],
    "mg_visit5_blocks": [_I, _I, _I, _I],
    "mg_visit9_blocks": [_I, _I, _I],
    # K1 and K11 (MG_PAPPLY_ENTRIES), f32 and bf16.
    **{"mg_cg_papply_u" + sfx: [_P] * 5 + [_P] * 9 + [_I, _I, _P]
       for sfx in ("", "_bf16")},
    **{"mg_cg_papply" + sfx: [_P] * 5 + [_P] * 6 + [_I, _I, _P]
       for sfx in ("", "_bf16")},
    # K8 (MG_FIELD_ENTRIES), f32 and bf16.
    **{"mg_stencil_field" + sfx: [_P] * 5 + [_P] * 3 + [_I, _I, _I, _P]
       for sfx in ("", "_bf16")},
    "mg_dia_spmv": [_P, _P, _P, ctypes.c_longlong, _P, _I, _P],
    # K18a, the blocked copy (csrc/stream.cu), per storage type, and KP2,
    # the same in place.
    **{"mg_scale_copy" + sfx: [_P, _P, ctypes.c_longlong, _D, _P]
       for sfx in ("", "_f64", "_bf16")},
    **{"mg_scale_copy_inplace" + sfx: [_P, ctypes.c_longlong, _D, _P]
       for sfx in ("", "_f64", "_bf16")},
    # KP1, the visit ablations (csrc/probe_visit.cu), and KP3, the staged
    # copy pipeline (csrc/pipeline.cu).
    "mg_visit_probe": [_P] * 5 + [_P] * 3 + [_I, _I, _P, _I, _I, _P],
    "mg_staged_copy": [_P, _P, ctypes.c_longlong, _I, _P],
    "mg_staged_pipe": [_P] * 3 + [_I] * 6 + [_P],
    "mg_staged_pipe_plan": [_I] * 6 + [_P],
    # K18b-W, the halo windows, and K18b-R / K18b-P, the x-transfer passes
    # on a resident slab (csrc/probe_xfer.cu).
    "mg_halo_windows": [_P, ctypes.c_longlong] + [_I] * 6 + [_P, _P, _P],
    "mg_xfer_pass": [_P] * 2 + [_I] * 4 + [_P],
    "mg_coarse_tree_plan_bytes": [],
    "mg_coarse_tree_plan": [_I, _P, _P, _P, _P, _P, _I, _I, _P, _P],
    "mg_coarse_tree": [_P, _P, _P, _P],
    "mg_coarse_tree_bf16": [_P, _P, _P, _P],
    "mg_line_blocks": [_I, _I],
}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and Path("/usr/local/cuda/bin/nvcc").exists():
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit at first use")
    return path


@functools.cache
def load_library() -> ctypes.CDLL:
    """Compile (if needed) and load the kernels' shared library."""
    sources = sorted(CSRC_DIR.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    lib = BUILD_DIR / f"libmgtorch_{h.hexdigest()[:16]}.so"
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        nvcc = _nvcc()
        objs = [tmp.with_suffix(f".{s.stem}.o") for s in sources]
        outs = [o.with_suffix(".log") for o in objs]
        t0 = time.perf_counter()
        procs = []
        for s, o, out in zip(sources, objs, outs):
            with open(out, "w") as f:
                procs.append(subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)],
                    stdout=f, stderr=subprocess.STDOUT))
        secs = {}
        while len(secs) < len(procs):  # each source's compile seconds
            for s, p in zip(sources, procs):
                if s.name not in secs and p.poll() is not None:
                    secs[s.name] = time.perf_counter() - t0
            time.sleep(0.1)
        log = "".join(out.read_text() for out in outs)
        ok = all(p.returncode == 0 for p in procs)
        if ok:
            link = subprocess.run(
                [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                 *map(str, objs)], capture_output=True, text=True)
            log += link.stdout + link.stderr
            ok = link.returncode == 0
        for o in objs + outs:
            o.unlink(missing_ok=True)
        log += "".join(f"nvcc {name}: {t:.1f} s\n"
                       for name, t in sorted(secs.items(),
                                             key=lambda kv: -kv[1]))
        (BUILD_DIR / "build.log").write_text(log)
        if not ok:
            raise RuntimeError(f"nvcc failed:\n{log}")
        os.replace(tmp, lib)
    cdll = ctypes.CDLL(str(lib))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(cdll, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return cdll


CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]


def compiler_identity(cxx: str) -> str:
    """The first line of ``<cxx> --version`` (compiler and version)."""
    out = subprocess.run([cxx, "--version"], capture_output=True, text=True,
                         timeout=60)
    return (out.stdout.splitlines() or [""])[0].strip()


def assembler_path(compiler: str, machine: str) -> Path:
    """The CSR assembler's library: ``libmgcsr_<hash>.so`` under
    ``_build/``, the hash over the flags, the source, the compiler's
    identity and the machine's architecture."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update((CSRC_DIR / "csr_assemble.cpp").read_bytes())
    h.update(compiler.encode() + b"\0" + machine.encode())
    return BUILD_DIR / f"libmgcsr_{h.hexdigest()[:16]}.so"


@functools.cache
def load_assembler() -> ctypes.CDLL:
    """Compile (if needed) and load the host CSR assembler
    (``csrc/csr_assemble.cpp``) with the host C++ compiler: the explicit
    sparse backend's set-up runs on the CPU, so this library builds
    wherever the package runs, with or without a CUDA toolkit.  The
    library's name is keyed on the flags, the source, the compiler's
    identity and the machine (``assembler_path``), so a build made on
    another host is never loaded."""
    src = CSRC_DIR / "csr_assemble.cpp"
    cxx = shutil.which(os.environ.get("CXX", "c++")) or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no host C++ compiler (c++ or g++) to build "
                           "the CSR assembler")
    lib = assembler_path(compiler_identity(cxx), platform.machine())
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        out = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(src)],
                             capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"{cxx} failed:\n{out.stdout}{out.stderr}")
        os.replace(tmp, lib)
    cdll = ctypes.CDLL(str(lib))
    cdll.level_rows.restype = ctypes.c_int64
    cdll.level_rows.argtypes = [_I, ctypes.POINTER(_I), _I]
    cdll.assemble_level.restype = ctypes.c_int64
    cdll.assemble_level.argtypes = [_I, _I, ctypes.POINTER(_I), _I, _I, _I,
                                    _P, _P, _P, ctypes.c_int64]
    return cdll


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a non-zero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
