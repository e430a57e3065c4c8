"""The port's CUDA kernels as one shared library, built and bound once.

Every csrc/*.cu is compiled by its own nvcc for sm_90a, all at once, and
the objects are linked into one shared library under
shoulder_tpu_torch/_build/.  The library's name carries a hash over the
build flags and every csrc/*.cu and csrc/*.cuh, so editing any source or
header rebuilds it.  It is bound through ctypes (a plain C interface, no
PyTorch headers: nvcc takes seconds).  Nothing here runs at import.

The compiler's output, including `-Xptxas -v` (registers, spills and
shared memory of each kernel), is kept beside the library as a .log file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from shoulder_tpu_torch.utils import trace

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
# -fmad=false: no FMA contraction, so float expressions round as PyTorch's
# separate elementwise kernels do (csrc/slice_stack.cu, "Numerics")
COMPILE_FLAGS = [*_ARCH, "-std=c++17", "-O3", "-fmad=false", "-Xptxas", "-v",
                 "-Xcompiler", "-fPIC", "-c"]
LINK_FLAGS = [*_ARCH, "-shared"]

_lib = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(home) / "bin" / "nvcc")


def build_key(src_dir: Path = CSRC) -> str:
    """Hash over the flags and the name and bytes of every source and
    header in `src_dir`."""
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for p in sorted([*src_dir.glob("*.cu"), *src_dir.glob("*.cuh")]):
        h.update(p.name.encode() + b"\0" + p.read_bytes() + b"\0")
    return h.hexdigest()[:16]


def _run(cmd: list[str], what: str) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out = f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to {what} (rc {proc.returncode}):\n"
                           f"{out}")
    return out


def build(src_dir: Path = CSRC, build_dir: Path = BUILD_DIR) -> Path:
    """Compile the sources of `src_dir` into one shared library in
    `build_dir` (once per build key) and return its path.  A failed
    build raises.  Each build counts one `kernels.builds` (utils/trace.py)
    and is one span `kernels.build`."""
    so = build_dir / f"kernels_{build_key(src_dir)}.so"
    if so.exists():
        return so
    trace.count("kernels.builds")
    with trace.span("kernels.build"):
        build_dir.mkdir(parents=True, exist_ok=True)
        work = Path(tempfile.mkdtemp(prefix=so.stem + ".", dir=build_dir))
        try:
            sources = sorted(src_dir.glob("*.cu"))
            objs = [work / (src.stem + ".o") for src in sources]

            def compile_one(src, obj):
                return _run([_nvcc(), *COMPILE_FLAGS, "-o", str(obj),
                             str(src)], f"compile {src.name}")

            # one nvcc per source, all started together
            with ThreadPoolExecutor(max(1, len(sources))) as pool:
                logs = list(pool.map(compile_one, sources, objs))
            tmp = work / so.name
            logs.append(_run([_nvcc(), *LINK_FLAGS, "-o", str(tmp),
                              *map(str, objs)], "link the kernels"))
            so.with_suffix(".log").write_text("\n".join(logs))
            os.replace(tmp, so)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        return so


def build_log() -> str:
    """The compiler output of the current build (ptxas resource usage)."""
    return build().with_suffix(".log").read_text()


def library():
    """The built library, loaded once per process, with every entry
    point's argument types set."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.chain_walk_launch.argtypes = [ptr] * 5 + [i32] * 3 + [ptr]
        lib.chain_walk_launch.restype = i32
        lib.chain_walk_max_k.argtypes = []
        lib.chain_walk_max_k.restype = i32
        lib.slice_stack_launch.argtypes = [ptr] * 12 + [i32] * 7 + [ptr]
        lib.slice_stack_launch.restype = i32
        lib.slice_stack_launch_timed.argtypes = [ptr] * 15 + [i32] * 7 + [ptr]
        lib.slice_stack_launch_timed.restype = i32
        lib.slice_stack_smem_bytes.argtypes = [i32, i32]
        lib.slice_stack_smem_bytes.restype = ctypes.c_longlong
        lib.slice_stack_blocks_per_sm.argtypes = [i32, i32, i32]
        lib.slice_stack_blocks_per_sm.restype = i32
        lib.slice_raw_launch.argtypes = [ptr] * 11 + [i32] * 7 + [ptr]
        lib.slice_raw_launch.restype = i32
        lib.slice_raw_launch_timed.argtypes = [ptr] * 12 + [i32] * 7 + [ptr]
        lib.slice_raw_launch_timed.restype = i32
        lib.slice_raw_smem_bytes.argtypes = [i32, i32, i32]
        lib.slice_raw_smem_bytes.restype = ctypes.c_longlong
        f32, i64 = ctypes.c_float, ctypes.c_longlong
        lib.sphere_score_launch.argtypes = ([ptr] * 5 + [f32] + [ptr] * 3
                                            + [i32] * 4 + [ptr])
        lib.sphere_score_launch.restype = i32
        lib.sphere_fit_launch.argtypes = ([ptr, ptr, i64] + [ptr] * 3
                                          + [f32, i32, i32] + [ptr] * 5
                                          + [i32] * 3 + [ptr])
        lib.sphere_fit_launch.restype = i32
        for name in ("sphere_score_tile", "sphere_score_max_hyp",
                     "sphere_fit_tile", "sphere_fit_partials"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = i32
        _lib = lib
    return _lib
