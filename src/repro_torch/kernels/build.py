"""Build the CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
with ``nvcc`` into ``build/kernels/<name>-<hash>.so`` at the root of the
checkout; the hash covers the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source builds anew and an
unchanged one loads at once.  ``build()`` starts one
``nvcc`` per source, all together, and waits for them.  Nothing is built
when the module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("flash_attention", "decode_attention", "flash_attention_bwd",
           "router_assign", "ssd_scan", "ssd_scan_bwd", "moe_gmm")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict = {}     # name -> ctypes.CDLL, loaded once per process
# ``load`` builds and opens each library once, whichever thread asks first
_load_lock = threading.Lock()
# the wrappers' launch counters are bumped from every thread that trains
_count_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict:
    """Compile every named source whose library is missing, in parallel.

    Returns {name: ptxas report} for the sources compiled now (an empty
    report for those already built).  Raises with nvcc's output if any
    compile fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, reports = {}, {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            reports[name] = ""
            continue
        # one name per process and thread: two builders never share a file
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu (rc {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)    # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


# what csrc/hopper.cuh returns when a TMA tensor map cannot be encoded:
# this alone when libcuda lacks cuTensorMapEncodeTiled, else plus the
# CUresult it returned
ERR_TENSOR_MAP = 10000
# what it returns for an input whose base address is not 16-byte
# aligned, which TMA cannot load
ERR_MISALIGNED = 9000


def check_rc(rc: int, name: str) -> None:
    """Raise unless a kernel's C entry point returned 0."""
    if rc == ERR_MISALIGNED:
        raise RuntimeError(f"{name}: an input's base address is not "
                           f"16-byte aligned, which TMA needs (pass a "
                           f"copy, not a view that starts inside a row)")
    if rc == ERR_TENSOR_MAP:
        raise RuntimeError(f"{name}: TMA tensor-map encode failed "
                           f"(no cuTensorMapEncodeTiled in libcuda)")
    if rc > ERR_TENSOR_MAP:
        raise RuntimeError(f"{name}: TMA tensor-map encode failed "
                           f"(CUresult {rc - ERR_TENSOR_MAP})")
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches`` (a kernel was launched)."""
    with _count_lock:
        wrapper.launches += 1


def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built if missing; built and
    opened once however many threads ask for it at the same time."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _load_lock:
        lib = _loaded.get(name)
        if lib is None:
            path = lib_path(name)
            if not path.exists():
                build((name,))
            lib = _loaded[name] = ctypes.CDLL(str(path))
    return lib
