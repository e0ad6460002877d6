"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` is compiled by `nvcc` for Hopper (`sm_90a`) into one
shared library with a plain C interface, `build/repro_torch_kernels/
libkernels.so` under the checkout, and loaded with `ctypes`. The sources
compile in parallel, one `nvcc` each, then link. The build runs at the
first kernel launch of a process and again only when a source changes
(a hash of the sources and flags is kept beside the library). Nothing
here runs at import time, and nothing falls back: a missing `nvcc` or a
failed compile raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def find_nvcc() -> str:
    """Path of `nvcc`: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    raise KernelBuildError(
        "nvcc not found (looked on PATH, in $CUDA_HOME/bin and "
        "/usr/local/cuda/bin): the CUDA kernels of repro_torch are compiled "
        "at first use and need the CUDA toolkit")


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(sources: list[pathlib.Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()


def build(verbose: bool = False) -> pathlib.Path:
    """Compile every source into `libkernels.so` unless it is up to date;
    returns its path. nvcc's output for each source, with ptxas'
    register, spill and shared-memory report of each kernel, is kept in
    `report(stem)`; `verbose` prints it too."""
    nvcc = find_nvcc()
    sources = _sources()
    lib = BUILD_DIR / "libkernels.so"
    stamp = BUILD_DIR / "libkernels.sha256"
    digest = _digest(sources)
    if lib.exists() and stamp.exists() and stamp.read_text() == digest:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in sources:
        obj = BUILD_DIR / (src.stem + ".o")
        procs.append((src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src.name} (exit {proc.returncode}):\n{out}")
            continue
        report(src.stem).write_text(out)
        if verbose:
            print(f"[nvcc {src.name}]\n{out}", flush=True)
    if failed:
        raise KernelBuildError("nvcc failed:\n" + "\n".join(failed))
    tmp = BUILD_DIR / f"libkernels.{os.getpid()}.so"
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
         *(str(BUILD_DIR / (s.stem + ".o")) for s in sources)],
        capture_output=True, text=True)
    if link.returncode != 0:
        raise KernelBuildError(
            f"nvcc link failed (exit {link.returncode}):\n"
            f"{link.stdout}{link.stderr}")
    os.replace(tmp, lib)
    stamp.write_text(digest)
    return lib


def report(stem: str) -> pathlib.Path:
    """Where the build keeps nvcc's output (ptxas' `-v` report of each
    kernel: registers, spills, static shared memory) for `csrc/<stem>.cu`."""
    return BUILD_DIR / f"{stem}.ptxas.txt"


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.repro_sigmoid_grad_f32.argtypes = [p, p, p, p, ll, i, p]
    lib.repro_sigmoid_grad_f32.restype = i
    lib.repro_sigmoid_grad_floor.argtypes = [p, p, ll, i, p]
    lib.repro_sigmoid_grad_floor.restype = i
    lib.repro_segment_sum_tile_size.argtypes = []
    lib.repro_segment_sum_tile_size.restype = i
    lib.repro_segment_sum_sorted_f32.argtypes = [p, p, p, p, p, i, ll, p]
    lib.repro_segment_sum_sorted_f32.restype = i
    lib.repro_segment_sum_zero_state.argtypes = [p, ll]
    lib.repro_segment_sum_zero_state.restype = i
    for name in ("tile_size", "radix", "cluster_size"):
        getattr(lib, f"repro_select_pack_{name}").argtypes = []
        getattr(lib, f"repro_select_pack_{name}").restype = i
    lib.repro_select_pack_cluster_smem.argtypes = [i, i]
    lib.repro_select_pack_cluster_smem.restype = ll
    lib.repro_select_pack_uses_cluster.argtypes = [i, i]
    lib.repro_select_pack_uses_cluster.restype = i
    lib.repro_select_pack_max_clusters.argtypes = [i, i]
    lib.repro_select_pack_max_clusters.restype = i
    lib.repro_select_pack_f32.argtypes = [p] * 12 + [i, i, i, p]
    lib.repro_select_pack_f32.restype = i
    lib.repro_flash_attention_bf16.argtypes = [
        p, p, p, p, i, i, i, i, i, i, ctypes.POINTER(ll), ctypes.c_float, i,
        p]
    lib.repro_flash_attention_bf16.restype = i
    lib.repro_flash_attention_smem_bytes.argtypes = [i]
    lib.repro_flash_attention_smem_bytes.restype = i
    f = ctypes.c_float
    lib.repro_row_update_f32.argtypes = [p, p, ll, ll, ll, p, p, p, f, f, i,
                                         p]
    lib.repro_row_update_f32.restype = i
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(build())))
        return _lib


def check(status: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {status}")
