"""Build the CUDA sources of ``vitx_torch/kernels/csrc`` and load them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared library
with a plain C interface, loaded with ``ctypes``. The library lands in
``build/vitx_torch/`` at the repository root, under a name that carries a
hash of the source, of the shared headers and of the flags, so an edited
source is rebuilt at its first use and an unchanged one is loaded as is.
Nothing is built at import time: the first call on a CUDA tensor builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "vitx_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# the dtype argument of every entry point that takes one
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# each C entry point: its source (csrc/<source>.cu), symbol and argument
# types
SIGNATURES = {
    # (dtype, route, ...): the route bits of csrc/mha_block.cu's Route
    "mha_block": ("mha_block", "vitx_mha_block",
                  [_I, _I] + [_P] * 11 + [_I, _I, _I, _I, _F, _P]),
    "mha_block_mean_probs": ("mha_block", "vitx_mha_block_mean_probs",
                             [_I, _I] + [_P] * 12 + [_I, _I, _I, _I, _F,
                                                     _P]),
    "mha_block_tome": ("mha_block", "vitx_mha_block_tome",
                       [_I, _I] + [_P] * 13 + [_I, _I, _I, _I, _F, _P]),
    "mlp_block": ("mlp_block", "vitx_mlp_block",
                  [_I, _I] + [_P] * 11 + [_I, _I, _I, _I, _F, _P]),
    "flash_attention_fwd": ("flash_attention_fwd", "vitx_attention_fwd",
                            [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                             _P]),
    "flash_attention_bwd": ("flash_attention_bwd", "vitx_attention_bwd",
                            [_I, _P, _P, _P, _P, _P, _P, _P, _P,
                             _I, _I, _I, _P]),
    # (q, k, v, o, stats, views, B, H, T, D, stream)
    "flash_attention_fwd_sm90": ("flash_attention_sm90",
                                 "vitx_attention_fwd_sm90",
                                 [_P] * 6 + [_I] * 4 + [_P]),
    # (q, k, v, o, stats, probs, mode, B, H, T, D, stream)
    "flash_attention_fwd_probs_sm90": ("flash_attention_sm90",
                                       "vitx_attention_fwd_probs_sm90",
                                       [_P] * 6 + [_I] * 5 + [_P]),
    # (q, k, v, do, o, dq, dk, dv, stats, delta, views, B, H, T, D, stream)
    "attention_bwd_sm90": ("attention_bwd_sm90", "vitx_attention_bwd_sm90",
                           [_P] * 11 + [_I] * 4 + [_P]),
    # (dtype, route, ...): the route of csrc/layer_norm_bwd.cu
    "layer_norm_bwd": ("layer_norm_bwd", "vitx_ln_bwd",
                       [_I, _I] + [_P] * 8 + [_I, _I, _I, _I, _F, _P]),
    # (dtype, route, ...): the route of csrc/layer_norm_fwd.cu
    "layer_norm_fwd": ("layer_norm_fwd", "vitx_ln_fwd",
                       [_I, _I] + [_P] * 6 + [_I, _I, _I, _I, _F, _P]),
    "adamw": ("adamw", "vitx_adamw",
              [_I, _P, _P, _P, _P, _L] + [_F] * 9 + [_P]),
    "adamw_multi": ("adamw", "vitx_adamw_multi",
                    [_I, _I, _P, _P] + [_F] * 9 + [_P]),
}
SOURCES = sorted({source for source, _, _ in SIGNATURES.values()})

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}        # source -> its loaded library
_loaded: dict[str, ctypes._CFuncPtr] = {}
build_log: dict[str, dict] = {}   # source -> {"seconds", "ptxas"} of this process


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (Path(home) / "bin" / "nvcc", shutil.which("nvcc")):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin and PATH): the vitx_torch CUDA "
                       "kernels are built from source at first use")


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library exists; returns
    (target, process or None, start time)."""
    so = _target(name)
    if so.exists():
        return so, None, time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return so, proc, time.perf_counter()


def _finish(name: str, so: Path, proc, t0: float) -> None:
    if proc is None:
        return
    out, _ = proc.communicate()
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, so)
    build_log[name] = {"seconds": time.perf_counter() - t0, "ptxas": out}


def build_all() -> None:
    """Build every source at once, one nvcc process each."""
    with _lock:
        started = [(n, *_start(n)) for n in SOURCES if n not in _libs]
        errors = []
        for n, so, proc, t0 in started:   # wait for every nvcc, then raise
            try:
                _finish(n, so, proc, t0)
            except RuntimeError as e:
                errors.append(e)
        if errors:
            raise errors[0]


def entry(name: str):
    """The C entry point ``name`` of ``SIGNATURES``, its source built on
    first use."""
    with _lock:
        fn = _loaded.get(name)
        if fn is not None:
            return fn
        source, symbol, argtypes = SIGNATURES[name]
        lib = _libs.get(source)
        if lib is None:
            so, proc, t0 = _start(source)
            _finish(source, so, proc, t0)
            lib = _libs[source] = ctypes.CDLL(str(so))
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[name] = fn
        return fn


# the entry points' own error codes (csrc/sm90.cuh), beyond cudaError_t's
ERR_NO_ENCODE, ERR_TENSOR_MAP, ERR_ROUTE = 10000, 20000, 30000


GEMM_SM90_MAX_LN_K = 4096   # csrc/gemm_sm90.cuh G9_MAX_LN_K


def gemm_sm90(dtype, dims, tensors=(), ln_k: int = 0) -> bool:
    """Whether a product takes ``csrc/gemm_sm90.cuh`` (wgmma fed by TMA):
    bf16, every K and N in ``dims`` a multiple of 8 (16-byte rows, what
    TMA addresses), the operands ``tensors`` 16-byte aligned, and the K of
    a LayerNorm prologue, ``ln_k``, at most ``GEMM_SM90_MAX_LN_K`` (its g
    and b sit in shared memory). Otherwise it takes ``common.cuh``'s
    ``gemm_kernel``, which fp32 needs."""
    return (dtype == torch.bfloat16 and all(d % 8 == 0 for d in dims)
            and all(t.data_ptr() % 16 == 0 for t in tensors)
            and ln_k <= GEMM_SM90_MAX_LN_K)


def aligned(*ts):
    """``ts``, each copied where its data does not start on a 16-byte
    boundary (a view at an odd element offset): the kernels read rows from
    the base pointer in 16-byte vectors or through TMA maps, which fault on
    such a base."""
    return [t.clone() if t.data_ptr() % 16 else t for t in ts]


def needs_grad(*ts) -> bool:
    """Whether autograd records a call on ``ts``: the wrappers skip their
    ``torch.autograd.Function`` when it does not."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def tracing() -> bool:
    """Whether a ``torch.export`` (or ``torch.compile``) trace is running:
    the inference wrappers then call their ``torch.library`` ops
    (``kernels/ops.py``), whose fake versions take tensors without data,
    so that the kernels are nodes of the traced graph."""
    return torch.compiler.is_compiling()


def check(name: str, err: int) -> None:
    """Raise if a kernel's C entry point reported an error."""
    if err == 0:
        return
    if err == ERR_ROUTE:
        raise RuntimeError(f"{name}: the kernel refused the route it was "
                           f"asked for (the inputs cannot take it)")
    if err == ERR_NO_ENCODE:
        raise RuntimeError(f"{name}: cuTensorMapEncodeTiled not found in "
                           f"the loaded libcuda")
    if ERR_TENSOR_MAP <= err < ERR_ROUTE:
        raise RuntimeError(f"{name}: cuTensorMapEncodeTiled failed with "
                           f"CUresult {err - ERR_TENSOR_MAP}")
    raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")
