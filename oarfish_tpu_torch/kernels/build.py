"""Builds the package's native libraries at first use.

Two kinds of library come out of here, both with a plain C interface and
both loaded with `ctypes`:

* CUDA kernels: `oarfish_tpu_torch/csrc/*.cu`, compiled by `nvcc` for
  `sm_90a` (`cuda_library`). A failed build raises: a caller holding CUDA
  tensors has no other way to run the kernel.
* Host helpers: the repository's shared `csrc/*.cpp` (BAM decoder, line
  formatter, coverage passes), compiled by `g++` (`host_library`). These
  return `None` when the toolchain or a system library is missing, and
  the callers keep their NumPy/pure-Python paths.

Everything lands in `oarfish_tpu_torch/_build/` (git-ignored), never next
to the sources, so a checkout builds for the machine it runs on.
Importing the package builds nothing.
"""

from __future__ import annotations

import ctypes
import logging
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

log = logging.getLogger("oarfish_tpu_torch")

PACKAGE_DIR = Path(__file__).resolve().parent.parent
BUILD_DIR = PACKAGE_DIR / "_build"
CUDA_SRC_DIR = PACKAGE_DIR / "csrc"
HOST_SRC_DIR = PACKAGE_DIR.parent / "csrc"

# no fused multiply-add and no fast-math: the kernels are held bit for bit
# against their plain PyTorch versions
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

CUDA_KERNELS = ("sorted_gather", "tile_permute", "route_stage",
                "route_middle", "row_sums")

# name -> seconds the build took in this process (0.0 = found up to date)
build_seconds: Dict[str, float] = {}

_cuda_libs: Dict[str, ctypes.CDLL] = {}


def _up_to_date(lib: Path, src: Path) -> bool:
    """The library is newer than its source and, for a kernel, than every
    header beside it."""
    deps = [src]
    if src.suffix == ".cu":
        deps += list(src.parent.glob("*.cuh"))
    try:
        built = lib.stat().st_mtime
        return all(built >= d.stat().st_mtime for d in deps)
    except OSError:
        return False


def _compile(
    cmd: Sequence[str], lib: Path, timeout: int, tail: Sequence[str] = ()
) -> None:
    """Run the compiler into a private temporary name, then rename: two
    processes building the same library never load a half-written file.
    `tail` follows the output name (-l options, which the linker resolves
    in order)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(
            [*cmd, "-o", str(tmp), *tail], check=True, capture_output=True,
            timeout=timeout, text=True,
        )
        os.replace(tmp, lib)
    finally:
        tmp.unlink(missing_ok=True)


def find_nvcc() -> Optional[str]:
    for cand in (
        os.environ.get("NVCC"),
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    return None


def cuda_library(name: str) -> ctypes.CDLL:
    """Compile `csrc/<name>.cu` (if needed) and load it. Raises when
    `nvcc` is missing or the build fails."""
    if name in _cuda_libs:
        return _cuda_libs[name]
    src = CUDA_SRC_DIR / f"{name}.cu"
    lib = BUILD_DIR / f"lib{name}.so"
    if not _up_to_date(lib, src):
        nvcc = find_nvcc()
        if nvcc is None:
            raise RuntimeError(
                f"nvcc not found: cannot build the CUDA kernel {src}"
            )
        t0 = time.time()
        try:
            _compile([nvcc, *NVCC_FLAGS, str(src)], lib, timeout=600)
        except subprocess.CalledProcessError as e:
            raise RuntimeError(
                f"nvcc failed on {src}:\n{e.stderr}"
            ) from e
        build_seconds[name] = time.time() - t0
        log.info("built %s in %.1fs", lib.name, build_seconds[name])
    else:
        build_seconds.setdefault(name, 0.0)
    _cuda_libs[name] = ctypes.CDLL(str(lib))
    return _cuda_libs[name]


def build_cuda_libraries(names: Sequence[str] = CUDA_KERNELS) -> None:
    """Build (if needed) and load several kernels at once: one `nvcc` per
    source, all started together. Raises what `cuda_library` raises."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max(len(names), 1)) as pool:
        for _lib in pool.map(cuda_library, names):
            pass


def host_library(
    name: str, source: str, flags: Sequence[str] = (),
    libs: Sequence[str] = (), native_arch: bool = False,
) -> Optional[ctypes.CDLL]:
    """Compile the shared host source `csrc/<source>` (if needed) into
    `_build/lib<name>.so` and load it; `None` when that is not possible
    (no g++, a missing system library, no source). `native_arch` builds
    with `-march=native`, and without it where the compiler refuses it."""
    if native_arch:
        return (host_library(name, source, ["-march=native", *flags], libs)
                or host_library(name, source, flags, libs))
    src = HOST_SRC_DIR / source
    lib = BUILD_DIR / f"lib{name}.so"
    if not src.exists():
        return None

    def build() -> bool:
        cmd = ["g++", "-O3", "-std=c++17", *flags, "-shared", "-fPIC",
               str(src)]
        t0 = time.time()
        try:
            _compile(cmd, lib, timeout=300, tail=[*libs, "-pthread"])
        except Exception as e:  # noqa: BLE001 - callers keep the NumPy path
            detail = getattr(e, "stderr", "") or ""
            log.warning("could not build %s from %s: %s %s",
                        lib.name, src.name, e, detail[-500:])
            return False
        build_seconds[name] = time.time() - t0
        return True

    def load() -> Optional[ctypes.CDLL]:
        try:
            return ctypes.CDLL(str(lib))
        except OSError as e:
            log.warning("could not load %s: %s", lib.name, e)
            return None

    if not _up_to_date(lib, src):
        return load() if build() else None
    # a library that is up to date but does not load was built on another
    # machine (or against other libraries): build it again, once
    return load() or (load() if build() else None)
