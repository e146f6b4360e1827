"""Build and load the port's hand-written CUDA kernels (`csrc/*.cu`).

Each source compiles with nvcc into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), which ctypes
loads.  Libraries go to `mixgantts_tpu_torch/_build/`, named by a hash of
the source, the shared headers (`csrc/*.cuh`) and the flags, so a changed
source or header rebuilds and an unchanged one is reused.  Nothing here
runs at import: the first kernel call builds.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
SOURCES = ("denoiser_stack", "mrf_stack", "mrf_stack_streamed")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded = {}


def nvcc():
    """Path of nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, then $PATH."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels need the CUDA toolkit "
            "(set CUDA_HOME)")
    return found


def library_path(name):
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(n for n in os.listdir(CSRC_DIR) if n.endswith(".cuh"))
    for src in (name + ".cu", *headers):
        with open(os.path.join(CSRC_DIR, src), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build(names=SOURCES):
    """Compile every named source that has no current library, one nvcc
    process per source, all started together, and keep nvcc's output
    (ptxas's registers and spills per kernel) beside each library as
    `<library>.log`.  Raises if any compile fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = {}
    for name in names:
        so = library_path(name)
        if os.path.isfile(so):
            continue
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, name + ".cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, so)
    failures = []
    for name, (proc, tmp, so) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}.cu: nvcc exited {proc.returncode}\n{out}")
            continue
        with open(so[:-3] + ".log", "w") as f:
            f.write(out)
        os.replace(tmp, so)  # atomic: concurrent builders never see half a file
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))


def library(name):
    """The loaded ctypes library for csrc/<name>.cu, built if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(library_path(name))
            _loaded[name] = lib
        return lib


def check(lib, prefix, err):
    """Raise if a kernel entry point returned a CUDA error."""
    if err != 0:
        fn = getattr(lib, prefix + "_error_string")
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(
            f"{prefix} CUDA kernel failed: error {err} "
            f"({fn(err).decode()})")
