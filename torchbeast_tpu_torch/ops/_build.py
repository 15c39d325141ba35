"""Build the port's CUDA kernels into one shared library, at first use.

Every `.cu` under `torchbeast_tpu_torch/csrc/` is compiled by `nvcc` for
Hopper (`sm_90a`) into an object, all sources in parallel, and the objects
are linked into `build/torch_kernels/libtbt_kernels_<hash>.so` at the repo
root. The hash covers every `.cu`/`.cuh` source and the compiler flags, so
an edited kernel rebuilds and an unchanged one loads from disk. The
library has a plain C interface and is loaded with `ctypes`: pointers and
the CUDA stream cross as `c_void_p`, sizes as `c_int`/`c_longlong`, and
every entry point returns `cudaGetLastError()` after its launches.

No PyTorch headers are compiled (a `cpp_extension` build of one file with
torch headers takes minutes; this one takes seconds). A missing `nvcc` or
a failed compile raises with the compiler's output.
"""

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-Xcompiler", "-fPIC",
)
# Printed register/spill counts only; kept out of the source hash.
_PTXAS_VERBOSE = ("-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C entry point -> argtypes. Each returns cudaGetLastError() as an int.
SIGNATURES = {
    # a, deltas, pgrho, rewards, discounts, values, boot, vs, pg, T, B, stream
    "tbt_vtrace_targets": [_P] * 9 + [_I, _I, _P],
    # x, y, g, gx, strides (host array of 16), N, H, W, C, Ho, Wo, bf16,
    # vectorized (host int out), stream
    "tbt_pool_bwd": [_P] * 5 + [_I] * 7 + [_P, _P],
    # params, grads, nus, moms, masters (host arrays of device pointers),
    # numels, n_leaves, partials, n_partials, sumsq, lr (device f32),
    # alpha, one_minus_alpha, eps, momentum, max_norm, clip, has_mom,
    # param_bf16, nu_bf16, stream
    "tbt_rmsprop_tail": [_P] * 6 + [_I, _P, _I, _P, _P] + [_F] * 5
    + [_I] * 4 + [_P],
    # q, k, v, seg, valid, nodone, bias, out, lse, B, T, H, D, M, bf16,
    # bias_bf16, stream
    "tbt_attention_fwd": [_P] * 9 + [_I] * 7 + [_P],
    # q, k, v, seg, valid, nodone, bias, out, lse, dout, dq, dk, dv,
    # dbias, partials, tickets, work, B, T, H, D, M, bf16, bias_bf16,
    # stream
    "tbt_attention_bwd": [_P] * 17 + [_I] * 7 + [_P],
    # index, slots, acc, thresholds, fold (host ints, or NULL), stream
    "tbt_mark_launch": [_I] + [_P] * 5,
    # region (0..3), enter (1) or leave (0), slots, stream
    "tbt_region_launch": [_I, _I, _P, _P],
    # x_proj, notdone, h0, c0, w, h_seq, c_seq, gates, h_last, c_last, T,
    # B, H, stream
    "tbt_lstm_fwd": [_P] * 10 + [_I] * 3 + [_P],
    # notdone, w, gates, c_seq, c0, dy, dh_last, dc, dgates, T, B, H,
    # stream
    "tbt_lstm_bwd": [_P] * 9 + [_I] * 3 + [_P],
}


def sources():
    """Every kernel source (`.cu` compiled, `.cuh` hashed), sorted."""
    return sorted(
        os.path.join(CSRC_DIR, f)
        for f in os.listdir(CSRC_DIR)
        if f.endswith((".cu", ".cuh"))
    )


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def library_path() -> str:
    return os.path.join(BUILD_DIR, f"libtbt_kernels_{source_hash()}.so")


def find_nvcc() -> str:
    candidates = []
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            candidates.append(os.path.join(os.environ[var], "bin", "nvcc"))
    candidates.append(shutil.which("nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, $PATH and "
        "/usr/local/cuda/bin): the port's CUDA kernels are built from "
        f"{CSRC_DIR} at first use and need the CUDA toolkit"
    )


def _run_all(commands):
    """Run the commands concurrently; raise with the output of any that
    failed. Returns the combined compiler output."""
    procs = [
        subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        for cmd in commands
    ]
    outputs, failed = [], []
    for cmd, proc in zip(commands, procs):
        out, _ = proc.communicate()
        outputs.append(out)
        if proc.returncode != 0:
            failed.append(f"$ {' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return "".join(outputs)


def build() -> str:
    """Compile and link the library unless it is already on disk; return
    its path. Concurrent builders serialize on a lock file."""
    target = library_path()
    if os.path.exists(target):
        return target
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(target):
            return target
        nvcc = find_nvcc()
        stem = target[: -len(".so")]
        cu = [s for s in sources() if s.endswith(".cu")]
        objs = [f"{stem}_{os.path.basename(s)[:-3]}.o" for s in cu]
        log = _run_all([
            [nvcc, *NVCC_FLAGS, *_PTXAS_VERBOSE, "-I", CSRC_DIR,
             "-c", src, "-o", obj]
            for src, obj in zip(cu, objs)
        ])
        tmp = f"{target}.{os.getpid()}.tmp"
        log += _run_all([[nvcc, *NVCC_FLAGS, "-shared", *objs, "-o", tmp]])
        with open(f"{stem}.log", "w") as f:
            f.write(log)
        os.replace(tmp, target)
        for obj in objs:
            os.remove(obj)
    return target


def build_log() -> str:
    """The compiler output (ptxas register and spill counts) of the build
    on disk, or "" when none was kept."""
    path = library_path()[: -len(".so")] + ".log"
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


_lock = threading.Lock()
_loaded = {}


def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed), with argtypes
    and restype set for every entry point in SIGNATURES."""
    with _lock:
        lib = _loaded.get("lib")
        if lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.tbt_error_string.argtypes = [_I]
            lib.tbt_error_string.restype = ctypes.c_char_p
            _loaded["lib"] = lib
        return lib


def check(status: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if status != 0:
        what = library().tbt_error_string(status).decode()
        raise RuntimeError(
            f"{name}: CUDA error {status} ({what}) at launch "
            "(cudaGetLastError after the kernel launch)"
        )
