"""Build the port's C++ runtime core (`_tbt_core_torch`) at first use.

The sources are the port's copy of the C++ core,
`torchbeast_tpu_torch/csrc/native/` (`pymodule.cc` and its headers). The
host C++ compiler builds them with the flags `setup.py` gives csrc/'s
`_tbt_core` (`-std=c++17 -O2 -Wall -pthread -fPIC -shared`, the Python
and numpy include paths, `-lrt`) into
`build/torch_native/_tbt_core_torch_<hash>.so` at the repo root. The hash
covers the sources, the flags, the Python version, the numpy include
path and the compiler's version, so an edited source, another
interpreter or another toolchain rebuilds and an unchanged one loads
from disk. Concurrent builders (test workers, spawned
env servers) serialize on a lock file and build once.

The module is loaded under the name `_tbt_core_torch` through
`importlib.machinery.ExtensionFileLoader`. A missing compiler, a missing
`Python.h` or a failed compile raises `NativeBuildError` with the
compiler's output.
"""

import fcntl
import hashlib
import importlib.machinery
import importlib.util
import os
import shutil
import subprocess
import sys
import sysconfig
import threading

MODULE_NAME = "_tbt_core_torch"
_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE_DIR = os.path.join(_PKG_DIR, "csrc", "native")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_native")

CXX_FLAGS = ("-std=c++17", "-O2", "-Wall", "-pthread", "-fPIC", "-shared")
# shm_open/shm_unlink live in librt on older glibcs (an empty librt on
# newer ones, so linking it is portable both ways).
LIBS = ("-lrt",)

_lock = threading.Lock()
_module = None


class NativeBuildError(RuntimeError):
    """The core could not be built or loaded; the message says why."""


def sources():
    """The core's sources (`.cc` compiled, `.h` hashed), sorted."""
    return sorted(
        os.path.join(SOURCE_DIR, f)
        for f in os.listdir(SOURCE_DIR)
        if f.endswith((".h", ".cc"))
    )


def _include_dirs():
    import numpy

    return sysconfig.get_paths()["include"], numpy.get_include()


def _compiler_identity() -> str:
    """The compiler's path and `--version` line; empty without one (the
    build then raises before the hash names a file)."""
    try:
        cxx = find_compiler()
        out = subprocess.run([cxx, "--version"], capture_output=True,
                             text=True, timeout=60).stdout
    except (NativeBuildError, OSError, subprocess.SubprocessError):
        return ""
    return cxx + "\n" + (out.splitlines() or [""])[0]


def source_hash() -> str:
    python_include, numpy_include = _include_dirs()
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(sys.version.encode())
    h.update(numpy_include.encode())
    h.update(_compiler_identity().encode())
    for path in sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def library_path() -> str:
    return os.path.join(BUILD_DIR, f"{MODULE_NAME}_{source_hash()}.so")


def find_compiler() -> str:
    """$CXX, else c++ or g++ on $PATH."""
    candidates = [os.environ.get("CXX"), shutil.which("c++"),
                  shutil.which("g++")]
    for c in candidates:
        if c and (os.path.isfile(c) or shutil.which(c)):
            return c
    raise NativeBuildError(
        "no C++ compiler found ($CXX, c++ or g++ on $PATH): the port's "
        f"runtime core is built from {SOURCE_DIR} at first use"
    )


def check_toolchain() -> None:
    """Raise NativeBuildError unless a compiler and Python.h are found."""
    find_compiler()
    python_include, _ = _include_dirs()
    if not os.path.isfile(os.path.join(python_include, "Python.h")):
        raise NativeBuildError(
            f"Python.h not found in {python_include}: the port's runtime "
            "core needs the interpreter's development headers"
        )


def build() -> str:
    """Compile the core unless it is already on disk; return its path."""
    target = library_path()
    if os.path.exists(target):
        return target
    check_toolchain()
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(target):
            return target
        python_include, numpy_include = _include_dirs()
        tmp = f"{target}.{os.getpid()}.tmp"
        cmd = [find_compiler(), *CXX_FLAGS, "-I", SOURCE_DIR,
               "-I", python_include, "-I", numpy_include,
               os.path.join(SOURCE_DIR, "pymodule.cc"), "-o", tmp, *LIBS]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise NativeBuildError(
                "runtime core build failed:\n$ " + " ".join(cmd) + "\n"
                + proc.stdout)
        os.replace(tmp, target)
    return target


def load():
    """Build (if needed) and import the core; the same module on every
    call."""
    global _module
    with _lock:
        if _module is None:
            path = build()
            loader = importlib.machinery.ExtensionFileLoader(MODULE_NAME,
                                                             path)
            spec = importlib.util.spec_from_file_location(
                MODULE_NAME, path, loader=loader)
            try:
                module = importlib.util.module_from_spec(spec)
                loader.exec_module(module)
            except ImportError as e:
                raise NativeBuildError(f"loading {path} failed: {e}") from e
            sys.modules[MODULE_NAME] = module
            _module = module
        return _module
