"""Builds the port's CUDA kernels at first use.

Each ``deepspeed_tpu_torch/csrc/<name>.cu`` compiles with ``nvcc`` into its
own shared library with a plain C interface, loaded through ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas=-v -o lib<name>-<hash>.so <name>.cu

No source includes PyTorch's headers, so a build takes seconds, not the
minutes ``torch.utils.cpp_extension.load`` needs. The library name carries
a hash of the sources (the ``.cu`` file and every ``.cuh`` header in
``csrc/``) and the flags, so an edited source rebuilds and an unchanged
one loads the library already in :data:`BUILD_DIR` (listed in
``.gitignore``). :func:`build` starts one ``nvcc`` per missing library,
all at once, and waits for them together.

Sources come only from the repository. A missing ``nvcc`` or a failed
build raises; nothing falls back to another implementation. Each build,
and each first load of a library already built, is reported to the
kernel-build watch (``telemetry/compile_watch.py``) with its seconds.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Optional

from deepspeed_tpu_torch.telemetry import compile_watch

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc")
BUILD_DIR = os.path.join(CSRC_DIR, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
# compiler output (ptxas register / spill lines) of the builds this
# process ran, by kernel source name
build_logs: Dict[str, str] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(found):
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin): the port's CUDA kernels "
            "build from deepspeed_tpu_torch/csrc at first use")
    return found


def _source(name: str) -> str:
    path = os.path.join(CSRC_DIR, f"{name}.cu")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no kernel source {path}")
    return path


def library_path(name: str) -> str:
    """Where ``name``'s library lives: keyed by a hash of its source, the
    shared headers and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for path in [_source(name)] + [os.path.join(CSRC_DIR, f)
                                   for f in headers]:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every library of ``names`` that is not built yet, one
    ``nvcc`` per source, all started together. Returns name -> path."""
    paths = {n: library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not os.path.exists(p)}
    if not todo:
        return paths
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    start = time.perf_counter()
    procs = {}
    for name, path in todo.items():
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC_DIR, "-o", tmp, _source(name)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path)
    failed = []
    for name, (proc, tmp, path) in procs.items():
        out, _ = proc.communicate()
        build_logs[name] = out
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (exit {proc.returncode})\n{out}")
            continue
        os.replace(tmp, path)  # atomic: concurrent builders never see half
        compile_watch.record_build(name, time.perf_counter() - start)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str, signatures: Optional[dict] = None) -> ctypes.CDLL:
    """The loaded library of kernel source ``name`` (built on first use).
    ``signatures`` maps each exported C function to ``(argtypes,
    restype)``, applied once at load."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if os.path.exists(library_path(name)):
                compile_watch.record_build(name, 0.0, cache_hit=True)
            lib = ctypes.CDLL(build([name])[name])
            for fn, (argtypes, restype) in (signatures or {}).items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _libs[name] = lib
        return lib
