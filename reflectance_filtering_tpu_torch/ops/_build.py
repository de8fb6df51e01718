"""Build and load the port's CUDA kernels (``csrc/*.cu``).

At first use, ``nvcc`` compiles every source in ``csrc/`` for Hopper
(``sm_90a``), one compiler process per source, all started together (one
nvcc given several sources compiles them one after another), and links
the objects into one shared library with a plain C interface, which
is loaded with ctypes — the same build-at-first-use pattern as the JAX
package's native IO loader (data/native_loader.py).  The library lands in
``build/torch_kernels/<hash>/`` under the repository root (listed in
.gitignore); the hash covers the sources and the flags, so an edited
source is rebuilt and an unchanged one is loaded as it is.  The compiler's
register/shared-memory report (``-Xptxas -v``) is kept beside it as
``build.log``.

Nothing here runs at import time, and nothing here runs on a CPU-only
machine: only a wrapper that was handed a CUDA tensor calls ``lib()``.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = _ARCH + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                      "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float
# every exported entry point: argtypes (pointers and the stream as
# c_void_p, so 64-bit addresses are never cut); each returns its
# cudaError_t as an int
_SIGNATURES = {
    # x, weights, out, batch, hw, srgb_input, stream
    "rf_cnn_fwd": [_P, _P, _P, _L, _L, _I, _P],
    # x, out, tables, n, h, w, u8, radius, g2, gsc, stream
    "rf_bilateral_gray_self": [_P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _P],
    # plane, y1, x1, y2, x2, l1, l2, b, h, w, k, stream
    "rf_whdr_gather": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # x, out, tmp, scratch, b, h, w, radius, reflect101, normalize, mode,
    # band, stream
    "rf_box_filter": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # guide, src, out, mom, ab, n, c, h, w, radius, eps, mode, band, stream
    "rf_guided_filter": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I,
                         _P],
    # guide, stats, mom, n, h, w, radius, eps, stream
    "rf_guide_stats": [_P, _P, _P, _I, _I, _I, _I, _F, _P],
    # stats, guide, src, out, mom, ab, n, c, h, w, radius, stream
    "rf_guided_apply_cached": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                               _P],
    # pass, seg, stats, guide, src, out, mom, ab, n, c, h, w, radius, eps,
    # stream
    "rf_guided_chain_pass": [_I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                             _I, _F, _P],
    # pass, c, n, h, w, radius, seg, plan[8] (no stream: a host-side query)
    "rf_guided_chain_plan": [_I, _I, _I, _I, _I, _I, _I, _P],
    # joint, src, out, tables, n, cj, cs, h, w, self_guided, u8, radius,
    # gcc, gsc, stream
    "rf_bilateral_joint": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                           _F, _F, _P],
    # y1, x1, y2, x2, g1, g2, dplane, b, h, w, k, stream
    "rf_whdr_scatter": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "rf_whdr_scatter_quadratic": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                  _P],
    # n, ci, f, cout, p, out[2] (no stream: a host-side query)
    "rf_cnn_train_plan": [_I, _I, _I, _I, _L, _P],
    # x, w, pre, n, ci, f, cout, p, stream
    "rf_cnn_train_fwd": [_P, _P, _P, _I, _I, _I, _I, _L, _P],
    # x, g, w, grad, dx, work, n, ci, f, cout, p, blocks, stream
    "rf_cnn_train_bwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _I,
                         _P],
    # x, g, w, grad, work, n, ci, f, cout, p, blocks, mask, sum_only, stream
    "rf_cnn_train_bwd_variant": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _I,
                                 _I, _I, _P],
}

_lib = None
_fns = {}              # entry point name -> its ctypes function, set by lib()
_current_device = None  # () -> the current CUDA device's index, set by lib()
_current_stream = None  # device index -> its current stream's handle, ditto
_lock = threading.Lock()
build_seconds = None  # wall time of the last build in this process


def _sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu"))
                  + glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def _digest(paths) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in paths:
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.isfile(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "reflectance_filtering_tpu_torch need the CUDA "
                           "toolkit to build")
    return path


def _build(out_dir: str, so_path: str) -> None:
    global build_seconds
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _nvcc()
    tag = "{}.tmp".format(os.getpid())
    cmds = [[nvcc, *NVCC_FLAGS, "-c", src, "-o", os.path.join(
        out_dir, "{}.{}.o".format(os.path.basename(src), tag))]
        for src in _sources() if src.endswith(".cu")]
    tmp = "{}.{}".format(so_path, tag)
    link = [nvcc, *_ARCH, "-shared", "-o", tmp] + [c[-1] for c in cmds]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    logs = [(cmd, proc.communicate()[0], proc.returncode)
            for cmd, proc in zip(cmds, procs)]
    if all(rc == 0 for _, _, rc in logs):
        proc = subprocess.run(link, capture_output=True, text=True)
        logs.append((link, proc.stdout + proc.stderr, proc.returncode))
    build_seconds = time.perf_counter() - t0
    with open(os.path.join(out_dir, "build.log"), "w") as f:
        for cmd, out, _ in logs:
            f.write(" ".join(cmd) + "\n" + out)
    for cmd, _, _ in logs[:len(cmds)]:
        if os.path.exists(cmd[-1]):
            os.remove(cmd[-1])
    failed = [(cmd, out, rc) for cmd, out, rc in logs if rc != 0]
    if failed:
        cmd, out, rc = failed[0]
        raise RuntimeError("nvcc failed (exit {}) on {}:\n{}".format(
            rc, os.path.basename(cmd[-1]), out[-4000:]))
    os.replace(tmp, so_path)  # atomic: a concurrent loader sees all or none


def build_dir() -> str:
    """Where the library of the current sources (and its build.log) lives."""
    return os.path.join(BUILD_ROOT, _digest(_sources()))


def lib() -> ctypes.CDLL:
    """The kernel library, built on first use; argtypes set for every
    entry point, each resolved once into the table ``launch`` reads."""
    global _lib, _current_device, _current_stream
    with _lock:
        if _lib is None:
            out_dir = build_dir()
            so_path = os.path.join(out_dir, "librf_kernels.so")
            if not os.path.isfile(so_path):
                _build(out_dir, so_path)
            handle = ctypes.CDLL(so_path)
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                _fns[name] = fn
            handle.rf_error_string.argtypes = [ctypes.c_int]
            handle.rf_error_string.restype = ctypes.c_char_p
            # the raw forms of torch.cuda.current_device() and
            # torch.cuda.current_stream(i).cuda_stream: the same values,
            # without a Stream object per call
            _current_device = torch._C._cuda_getDevice
            _current_stream = torch._C._cuda_getCurrentRawStream
            _lib = handle
        return _lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call entry point ``name`` on ``device`` with ``args`` followed by
    that device's current stream, and raise if the launch reported an
    error.  The device is made current only when it is not already (the
    entry points launch on the current device)."""
    if _lib is None:
        lib()
    index = device.index
    if index is None:
        index = _current_device()
    if index == _current_device():
        rc = _fns[name](*args, _current_stream(index))
    else:
        with torch.cuda.device(device):
            rc = _fns[name](*args, _current_stream(index))
    if rc != 0:
        raise RuntimeError("{} failed: CUDA error {} ({})".format(
            name, rc, _lib.rf_error_string(rc).decode()))


# the tallies of the captures that record_launches() has open, innermost last
_tallies = []


def _capturing() -> bool:
    """Whether the current CUDA stream is capturing a graph."""
    return (torch.cuda.is_initialized()
            and torch.cuda.is_current_stream_capturing())


def count(fn, attr: str = "launches", n: int = 1) -> None:
    """Count ``n`` launches of a wrapper's kernel on ``fn.<attr>``, where
    the wrapper launches it.  A launch inside a CUDA graph capture runs
    nothing: it goes into the tally of the innermost open
    :func:`record_launches`, if any, and the graph's replays count it
    (:func:`count_replays`)."""
    if _capturing():
        if _tallies:
            _tallies[-1][fn, attr] += n
        return
    setattr(fn, attr, getattr(fn, attr) + n)


@contextlib.contextmanager
def record_launches():
    """Around a CUDA graph capture: yields the tally of the launches
    captured, {(fn, attr): n}."""
    tally = collections.Counter()
    _tallies.append(tally)
    try:
        yield tally
    finally:
        _tallies.remove(tally)


def count_replays(tally, replays: int) -> None:
    """Count ``replays`` replays of a graph whose capture recorded
    ``tally``."""
    for (fn, attr), n in tally.items():
        setattr(fn, attr, getattr(fn, attr) + n * replays)


def check_tensor(t: torch.Tensor, name: str, dtype: torch.dtype,
                 ndim: int) -> None:
    """Raise unless ``t`` has the dtype, rank and contiguity a kernel
    takes (the device is checked by each wrapper's dispatch)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError("{} must be a torch.Tensor, got {}".format(
            name, type(t).__name__))
    if t.dtype != dtype:
        raise TypeError("{} must be {}, got {}".format(name, dtype, t.dtype))
    if t.dim() != ndim:
        raise ValueError("{} must have {} dimensions, got shape {}".format(
            name, ndim, tuple(t.shape)))
    if not t.is_contiguous():
        raise ValueError("{} must be contiguous".format(name))


def target_device(device) -> torch.device:
    """``device`` as a torch.device.  Raises RuntimeError when it names
    CUDA and torch sees no GPU: the entry points that take a ``device``
    default to the card and never drop to the CPU quietly."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device '{}': CUDA is not available here; pass "
                           "device='cpu' to run the plain versions on the "
                           "CPU".format(device))
    return device


def require_cuda(t: torch.Tensor, wrapper: str) -> None:
    """Raise unless ``t`` lies on a CUDA device (the wrappers' only other
    accepted device is the CPU, which takes the plain version)."""
    if t.device.type != "cuda":
        raise ValueError("{}: tensors must be on the CPU (plain version) or "
                         "a CUDA device (kernel), got {}".format(
                             wrapper, t.device))
