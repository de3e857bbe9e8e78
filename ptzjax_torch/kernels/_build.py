"""Build and load the port's hand-written CUDA kernels.

All ``csrc/*.cu`` files are compiled in parallel (one ``nvcc -c`` each) and
linked into one shared library with a plain C interface, at first use, in
``build/ptzjax_torch/`` at the root of the checkout. The file name carries a
hash of the sources and the flags, so an edit to either rebuilds and an
unchanged tree reuses the library. The library is loaded with ``ctypes``: pointers and the stream go
in as ``c_void_p``, and each entry point returns ``cudaGetLastError()``.

Nothing here falls back: a missing ``nvcc``, a failed build or a non-zero
error code raises, with nvcc's stderr in the message.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = (
    "harris_nms.cu", "gather_windows.cu", "match.cu", "cholesky.cu", "lk_flow.cu", "describe.cu",
    "graph_cond.cu",
)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ptzjax_torch"
# -fmad=false: no multiply-add contraction, so the detection kernel and the
# matcher's gate round once per operation like the plain torch versions (see
# csrc/harris_nms.cu); where a kernel wants an FMA it writes __fmaf_rn
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-fmad=false",
)

_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for root in ([home] if home else []) + ["/usr/local/cuda"]:
        cand = Path(root) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "ptzjax_torch CUDA kernels cannot be built"
    )


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        digest.update(name.encode())
        digest.update((_CSRC / name).read_bytes())
    return BUILD_DIR / f"libptzjax_torch_{digest.hexdigest()[:16]}.so"


def _run(cmd: list[str]) -> None:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with code {proc.returncode}: {' '.join(cmd)}\n"
            f"{proc.stderr}"
        )


def build() -> Path:
    """Compile the kernels unless a library for these sources exists: one
    ``nvcc -c`` per source, all started together, then one link."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = _nvcc()
    objs = [BUILD_DIR / f"{tag}.{Path(name).stem}.o" for name in SOURCES]
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        list(pool.map(
            _run,
            [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(_CSRC / name)]
             for name, o in zip(SOURCES, objs)],
        ))
    tmp = out.with_name(f"{tag}.so.tmp")
    _run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)])
    for o in objs:
        o.unlink()
    os.replace(tmp, out)   # atomic: a concurrent loader never sees half a file
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.ptz_harris_nms.argtypes = [vp] * 7 + [ci] * 3 + [cf, cf, ci, vp]
        lib.ptz_harris_nms.restype = ci
        lib.ptz_gather_windows.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, vp]
        lib.ptz_gather_windows.restype = ci
        lib.ptz_match.argtypes = [vp] * 6 + [cf] + [ci] * 6 + [vp] * 9 + [ci, vp]
        lib.ptz_match.restype = ci
        lib.ptz_cholesky.argtypes = [vp, vp, vp, vp, ci, ci, ci, vp]
        lib.ptz_cholesky.restype = ci
        vpp, cip = ctypes.POINTER(vp), ctypes.POINTER(ci)
        lib.ptz_lk_flow.argtypes = [vpp, vpp, cip, cip, ci] + [vp] * 5 + [ci] * 4 + [cf] * 6 + [ci, ci, vp]
        lib.ptz_lk_flow.restype = ci
        lib.ptz_pyramid.argtypes = [vpp, vpp, cip, cip, ci, ci, ci, vp]
        lib.ptz_pyramid.restype = ci
        lib.ptz_describe.argtypes = [vp, ci, ci] + [vp] * 4 + [ci, ci, vp]
        lib.ptz_describe.restype = ci
        ull = ctypes.c_ulonglong
        for name, args in (
            ("ptz_graph_create", [vpp]),
            ("ptz_graph_handle", [vp, ctypes.POINTER(ull)]),
            ("ptz_graph_add_set", [vp, vpp, ull, ull, ci, vp]),
            ("ptz_graph_add_if", [vp, vpp, ull, vpp]),
            ("ptz_graph_add_child", [vp, vpp, vp]),
            ("ptz_graph_add_stamp", [vp, vpp, ci, vp]),
            ("ptz_stamp", [ci, vp, vp]),
            ("ptz_graph_instantiate", [vp, vpp, cip, cip, ci]),
            ("ptz_graph_launch", [vp, ci, vp]),
            ("ptz_graph_destroy", [vp, vp]),
            ("ptz_capture_status", [vp, cip]),
        ):
            getattr(lib, name).argtypes = args
            getattr(lib, name).restype = ci
        lib.ptz_smem_optin.argtypes = [ci]
        lib.ptz_smem_optin.restype = ci
        lib.ptz_error_string.argtypes = [ci]
        lib.ptz_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = load().ptz_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")
