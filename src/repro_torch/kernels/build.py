"""Build the hand-written CUDA kernels at first use, and load them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, loaded with ``ctypes``.
Nothing here includes PyTorch's headers, so a build takes seconds. The
libraries go to ``_build/`` beside this file (listed in ``.gitignore``),
named by a hash of the source and the flags: an edited source builds
anew, an unchanged one is loaded as it is. ``build`` starts one ``nvcc``
per missing library, all at once.
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

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("distance_argmin", "distance_argmin_hamming", "flash_attention",
           "minhash_buckets")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: what ptxas reported for each library built by this process
#: (registers, shared memory, spills per kernel)
ptxas_log: dict[str, str] = {}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "first use and need the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` goes, keyed by content."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> float:
    """Compile every named source whose library is missing, all ``nvcc``
    processes started together. Returns the wall seconds it took; raises
    with the compiler's output when one fails."""
    t0 = time.perf_counter()
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = {}
    for name in todo:
        tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT,
                                             text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        ptxas_log[name] = out
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (rc {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if missing."""
    with _lock:
        if name not in _libs:
            build((name,))
            _libs[name] = ctypes.CDLL(str(library_path(name)))
        return _libs[name]


def check(err: int, what: str) -> None:
    """Raise when a C entry returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def sass(lib, function: str) -> str:
    """The SASS of the kernels of the library ``lib`` whose mangled name
    contains ``function`` (``cuobjdump -sass``, beside ``nvcc``); raises
    when no kernel matches."""
    exe = os.path.join(os.path.dirname(nvcc()), "cuobjdump")
    text = subprocess.run([exe, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    parts = [p for p in text.split("Function : ")[1:]
             if function in p.split("\n", 1)[0]]
    if not parts:
        raise RuntimeError(f"no kernel named like {function} in {lib}")
    return "".join(parts)


def sass_counts(lib, function: str, opcodes) -> dict:
    """{opcode: count} in ``sass(lib, function)``."""
    text = sass(lib, function)
    return {op: text.count(f" {op}") for op in opcodes}
