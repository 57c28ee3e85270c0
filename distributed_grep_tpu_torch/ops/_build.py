"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on first use into
``distributed_grep_tpu_torch/_build/lib<name>-<hash>.so`` (the directory is
git-ignored), where the hash covers the source text, every header of
``csrc/`` (``*.cuh``, which the sources include) and the compiler flags,
so an edited source or header rebuilds and an unchanged one loads at
once.  nvcc's output (ptxas's register use and warnings) is kept beside
each library as ``lib<name>-<hash>.log`` (``saved_log``); a library
without its log is built again.
The sources expose a plain C interface: no PyTorch headers, so a build
takes seconds.  ``build_all`` starts one nvcc per source, all at once.

A missing nvcc or a failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG_ROOT = Path(__file__).resolve().parents[1]
CSRC = PKG_ROOT / "csrc"
BUILD_DIR = PKG_ROOT / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
SOURCES = ("shift_and", "nfa", "fdr", "pairset", "approx", "shift_and_swar",
           "probe_narrow", "mxu_dot")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The nvcc binary: $CUDA_HOME/bin, then PATH, then /usr/local/cuda."""
    candidates = []
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            candidates.append(Path(os.environ[env]) / "bin" / "nvcc")
    which = shutil.which("nvcc")
    if which:
        candidates.append(Path(which))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels of distributed_grep_tpu_torch build from source on first use"
    )


def source_hash(src: bytes) -> str:
    """The build hash of a source text: it, the headers of csrc/ and the
    compiler flags."""
    h = hashlib.sha256(src)
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:12]


def nvcc_command(src: Path, out: Path) -> list[str]:
    """nvcc's command line for a source (csrc/ on the include path)."""
    return [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(out),
            str(src)]


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    return BUILD_DIR / f"lib{name}-{source_hash(src)}.so"


def saved_log(name: str) -> str:
    """nvcc's output for the current build of ``csrc/<name>.cu``.  Raises
    FileNotFoundError if that build has not been made."""
    return _target(name).with_suffix(".log").read_text()


def _start(name: str) -> tuple[Path, Path, subprocess.Popen] | None:
    out = _target(name)
    if out.exists() and out.with_suffix(".log").exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.Popen(nvcc_command(CSRC / f"{name}.cu", tmp),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return out, tmp, proc


def _finish(name: str, job) -> None:
    out, tmp, proc = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    tmp_log = tmp.with_suffix(".log")
    tmp_log.write_text(log)
    os.replace(tmp_log, out.with_suffix(".log"))
    os.replace(tmp, out)


def build_all(names: tuple[str, ...] = SOURCES) -> None:
    """Compile every named source that has no current build, one nvcc
    process per source, all started together."""
    with _lock:
        jobs = {n: _start(n) for n in names}
        try:
            for n, job in jobs.items():
                if job is not None:
                    _finish(n, job)
        finally:
            for job in jobs.values():
                if job is not None and job[2].poll() is None:
                    job[2].kill()
                    job[2].wait()


def unbuilt(names, device) -> list[str]:
    """The named sources that a launch on ``device`` would first have to
    compile: none on the CPU (the plain versions need no build), and on
    the card those with no current build on disk."""
    if device.type != "cuda":
        return []
    return [n for n in names if n not in _libs and not (
        _target(n).exists() and _target(n).with_suffix(".log").exists())]


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all((name,))
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_target(name)))
            _libs[name] = lib
    return lib
