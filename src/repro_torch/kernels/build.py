"""Build and load the hand-written CUDA kernels (``repro_torch/csrc``).

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface, loaded with ``ctypes``. Libraries go under ``build/``
at the repository root (listed in ``.gitignore``), named by a digest of the
source, so an edited source rebuilds and an unchanged one is reused.
Nothing builds at import: the first :func:`load` of a kernel builds it, and
:func:`build` starts several ``nvcc`` processes at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

#: kernel name -> source file under csrc/
SOURCES: Dict[str, str] = {
    "af_gemm": "af_gemm.cu",
    "fx_gemm": "fx_gemm.cu",
    "int8_gemm": "int8_gemm.cu",
    "flash_attention_sm90": "flash_attention_sm90.cu",
}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
#: per kernel, the compiler's resource report (``-Xptxas -v``) of its build,
#: kept beside the library and read back when the library is reused
PTXAS_REPORT: Dict[str, str] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    return str(Path(home) / "bin" / "nvcc")


def sass(name: str) -> str:
    """The SASS of kernel ``name``'s built library (``cuobjdump -sass``,
    beside ``nvcc``), to show which instructions the compiler emitted."""
    tool = Path(nvcc()).parent / "cuobjdump"
    return subprocess.run([str(tool), "-sass", str(lib_path(name))], capture_output=True,
                          text=True, check=True).stdout


def lib_path(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    digest = hashlib.blake2b(src + " ".join(NVCC_FLAGS).encode(), digest_size=6).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """Compile the named kernels (default: all) that are not built yet,
    one ``nvcc`` per source, all started together. Returns the wall-clock
    seconds of each build (0.0 for a library already present); raises with
    the compiler's output if one fails."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = lib_path(name)
        if out.exists():
            report = out.with_suffix(".ptxas.txt")
            if report.exists():
                PTXAS_REPORT[name] = report.read_text()
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, out)
    seconds = {n: 0.0 for n in names}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        PTXAS_REPORT[name] = text
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{text}")
            tmp.unlink(missing_ok=True)
            continue
        out.with_suffix(".ptxas.txt").write_text(text)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = lib_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            _LIBS[name] = lib
        return lib
