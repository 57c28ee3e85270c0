"""Build the package's sources and load them with ctypes: the CUDA
kernels with nvcc, the host library ``csrc/dgrep.cpp`` with g++.

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

The host library (``HOST_SOURCES``) builds the same way with g++
(``build_host``, ``load_host``; the flags ``GXX_FLAGS``): its hash also
covers the compiler's version and the target that ``-march=native``
resolves to, so a checkout moved to another CPU or compiler rebuilds.
The CPU path uses it too, so ``unbuilt`` names it on either device.

A missing compiler or a failed build raises; nothing falls back.
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
           "probe_narrow", "mxu_dot", "dfa")
GXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-Wall", "-Wextra", "-Werror",
             "-std=c++17", "-shared")
HOST_SOURCES = ("dgrep",)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_gxx: tuple[str, str] | None = None  # (path, version and resolved target)


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


def gxx() -> tuple[str, str]:
    """(g++ on PATH, its version and the target -march=native resolves
    to), asked once a process.  Raises when PATH holds no g++."""
    global _gxx
    if _gxx is None:
        path = shutil.which("g++")
        if path is None:
            raise RuntimeError(
                "g++ not found on PATH: the host library of "
                "distributed_grep_tpu_torch (csrc/dgrep.cpp) builds from "
                "source on first use")
        version = subprocess.run([path, "--version"], capture_output=True,
                                 text=True, check=True).stdout
        target = subprocess.run(
            [path, "-march=native", "-Q", "--help=target"],
            capture_output=True, text=True, check=True).stdout
        _gxx = (path, version + target)
    return _gxx


def source_hash(src: bytes) -> str:
    """The build hash of a source text: it, the headers of csrc/ and the
    compiler flags."""
    h = hashlib.sha256(src)
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:12]


def host_source_hash(src: bytes) -> str:
    """The build hash of a host source: it, the g++ flags, and g++'s
    version and resolved target."""
    h = hashlib.sha256(src)
    h.update(" ".join(GXX_FLAGS).encode())
    h.update(gxx()[1].encode())
    return h.hexdigest()[:12]


def nvcc_command(src: Path, out: Path) -> list[str]:
    """nvcc's command line for a source (csrc/ on the include path)."""
    return [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(out),
            str(src)]


def gxx_command(src: Path, out: Path) -> list[str]:
    """g++'s command line for a host source."""
    return [gxx()[0], *GXX_FLAGS, "-o", str(out), str(src), "-lpthread"]


def _source(name: str) -> Path:
    return CSRC / (f"{name}.cpp" if name in HOST_SOURCES else f"{name}.cu")


def _target(name: str) -> Path:
    src = _source(name).read_bytes()
    digest = (host_source_hash(src) if name in HOST_SOURCES
              else source_hash(src))
    return BUILD_DIR / f"lib{name}-{digest}.so"


def saved_log(name: str) -> str:
    """The compiler's output for the current build of source ``name``.
    Raises FileNotFoundError if that build has not been made."""
    return _target(name).with_suffix(".log").read_text()


def _start(name: str) -> tuple[Path, Path, subprocess.Popen] | None:
    out = _target(name)
    if out.exists() and out.with_suffix(".log").exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    command = gxx_command if name in HOST_SOURCES else nvcc_command
    proc = subprocess.Popen(command(_source(name), tmp),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return out, tmp, proc


def _finish(name: str, job) -> None:
    out, tmp, proc = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"{proc.args[0]} failed for csrc/{_source(name).name}:\n{log}")
    tmp_log = tmp.with_suffix(".log")
    tmp_log.write_text(log)
    os.replace(tmp_log, out.with_suffix(".log"))
    os.replace(tmp, out)


def build_all(names: tuple[str, ...] = SOURCES) -> None:
    """Compile every named source that has no current build, one nvcc
    process per source, all started together."""
    _compile(names)


def build_host(names: tuple[str, ...] = HOST_SOURCES) -> None:
    """``build_all`` for the host sources: one g++ process each."""
    _compile(names)


def _compile(names: tuple[str, ...]) -> None:
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
    """The named sources that a call on ``device`` would first have to
    compile, those with no current build on disk: the host sources on
    either device, the CUDA sources only on the card (on the CPU their
    plain versions need no build)."""
    return [n for n in names
            if (n in HOST_SOURCES or device.type == "cuda")
            and n not in _libs and not (
                _target(n).exists() and _target(n).with_suffix(".log").exists())]


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all((name,))
    return _open(name)


def load_host(name: str = "dgrep") -> ctypes.CDLL:
    """``load`` for a host source: built with ``build_host`` if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_host((name,))
    return _open(name)


def _open(name: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_target(name)))
            _libs[name] = lib
    return lib
