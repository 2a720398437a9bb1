"""Build and load the port's CUDA kernels (route: nvcc → shared library → ctypes).

Each source under ``repro_torch/csrc/`` compiles on its own, with a plain C
interface, into ``lib<name>-<digest>.so`` in the build directory
(``<repo>/build/kernels``, or ``$REPRO_TORCH_BUILD_DIR``).  The digest covers
the source, the shared header and the flags, so an edited kernel is never
served from a stale library.  Nothing is built when this module is imported:
:func:`build` runs ``nvcc`` for every missing library at once (one process per
source, all started together) and :func:`lib` builds on first use.

Only a machine with a CUDA device and ``nvcc`` builds anything; elsewhere
:func:`lib` raises, so a kernel wrapper handed a CUDA tensor never falls back
to its plain version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
HEADER = CSRC / "rt_common.cuh"

#: library name → source file
SOURCES = {
    "accumulate": "accumulate.cu",
    "intrinsic": "intrinsic.cu",
    "rma_put": "rma_put.cu",
    "ring_allreduce": "ring_allreduce.cu",
    "put_signal": "put_signal.cu",
    "flash_attention": "flash_attention.cu",
    "ssd_scan": "ssd_scan.cu",
    "ssd_pass": "ssd_pass.cu",
    # chip_smoke.py's launch-floor, graph and host-link probes; no port
    # module loads it
    "probes": "probes.cu",
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I64, _I, _F = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
_U32P = ctypes.POINTER(ctypes.c_uint32)

#: the C entry points of each library: symbol → argtypes (the first is the
#: library's main entry point)
SIGNATURES = {
    "accumulate": {"rt_accumulate":
                   (_P, _I64, _P, _I64, _I64, _I64, _I, _I, _P)},
    "intrinsic": {"rt_ring_accumulate":
                  (_P, _I64, _I64, _I64, _I64, _P, _I64, _P, _I64, _I, _I,
                   _P, _I64, _P, _P, _I, _P, _P)},
    "rma_put": {"rt_put": (_P, _I64, _P, _I64, _I64, _I64, _I64, _I64, _P,
                           _I64, _P, _I64, _P, _P, _I, _P, _I, _P, _I, _I,
                           _I, _P),
                "rt_put_wait": (_P, _I64, _I, _I, _U32P, _P, _I, _P),
                "rt_host_device_pointer": (_P, _P)},
    "ring_allreduce": {"rt_ring_all_reduce":
                       (_P, _I64, _I64, _I64, _P, _I64, _P)},
    "put_signal": {
        "rt_put_signal": (_P, _I64, _P, _I64, _I64, _P, _P, _I64, _I64, _I,
                          _P, _I64, _P, _I64, _I64, _I64, _I, _I, _P, _P, _I,
                          _I, _I, _I, _P, _P, _P, _P),
        "rt_accumulate_signal": (_P, _I64, _P, _I64, _I64, _P, _P, _I64, _I64,
                                 _I, _I, _P, _I64, _P, _I64, _I64, _I64, _I,
                                 _I, _P, _P, _I, _I, _I, _I, _P, _P)},
    "flash_attention": {
        "rt_flash_attention": (_P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64,
                               _I64, _F, _I, _P),
        "rt_flash_attention_bf16": (_P, _P, _P, _P, _P, _I64, _I64, _I64,
                                    _I64, _I64, _I64, _F, _I, _P),
        "rt_flash_attention_bf16_smem": (_I64,)},
    "ssd_scan": {"rt_ssd_intra_chunk":
                 (_P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64,
                  _I64, _I64, _I64, _I, _P)},
    "ssd_pass": {"rt_ssd_pass":
                 (_P, _P, _P, _P, _P, _I, _P, _P, _I64, _I64, _I64, _I64,
                  _I64, _I64, _I64, _I, _P)},
    "probes": {"rt_empty": (_I, _P), "rt_graph_programmatic_edges": (_P,),
               "rt_chase": (_P, _I64, _I64, _I, _P, _P),
               "rt_copy_loop": (_P, _P, _I64, _I, _I, _P)},
}

_loaded: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def build_dir() -> Path:
    override = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if override:
        return Path(override)
    return _HERE.parent.parent / "build" / "kernels"


def nvcc() -> str:
    """Path of the CUDA compiler, or raise if this machine has none."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels cannot be built on this machine, and a kernel wrapper "
        "given CUDA tensors does not fall back to its plain version")


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for part in ((CSRC / SOURCES[name]).read_bytes(), HEADER.read_bytes(),
                 " ".join(NVCC_FLAGS).encode()):
        h.update(part)
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict[str, Path]:
    """Compile every missing library in ``names`` (default: all), one
    ``nvcc`` per source, all running at once.  Returns name → library path."""
    names = list(SOURCES) if names is None else list(names)
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    todo = [n for n in names if not paths[n].exists()]
    if not todo:
        return paths
    compiler = nvcc()
    procs = {}
    for n in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out)
        os.close(fd)
        cmd = [compiler, *NVCC_FLAGS, "-o", tmp, str(CSRC / SOURCES[n])]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exit {proc.returncode}\n{log}")
            Path(tmp).unlink(missing_ok=True)
        else:
            Path(f"{paths[n]}.log").write_text(log)   # ptxas -v: registers, spills
            os.replace(tmp, paths[n])   # atomic: no half-written library
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def ptxas_report(name: str, kernel: str) -> list[str]:
    """What ``ptxas -v`` said of each entry function of library ``name``
    whose mangled name contains ``kernel``: one line each with its
    registers, spill bytes, barriers and static shared memory."""
    log = Path(f"{library_path(name)}.log").read_text().splitlines()
    out, entry = [], None
    for line in log:
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if kernel in line else None
        elif entry and ("spill" in line or "Used" in line):
            out.append(f"{entry}: {line.split(':', 1)[-1].strip()}"
                       if "Used" in line else f"{entry}: {line.strip()}")
    return out


def lib(name: str, symbol: str | None = None):
    """The loaded C entry point ``symbol`` (default: the library's main one)
    of library ``name``, built on first use."""
    symbol = symbol or next(iter(SIGNATURES[name]))
    fn = _loaded.get((name, symbol))
    if fn is not None:
        return fn
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError(
            f"kernel library {name!r} needs a CUDA device; this process has "
            "none (a CUDA tensor reached a kernel wrapper without one)")
    path = build([name])[name]
    fn = getattr(ctypes.CDLL(str(path)), symbol)
    fn.argtypes = SIGNATURES[name][symbol]
    fn.restype = ctypes.c_int
    _loaded[(name, symbol)] = fn
    return fn


__all__ = ["SOURCES", "NVCC_FLAGS", "build", "build_dir", "lib",
           "library_path", "nvcc", "ptxas_report"]
