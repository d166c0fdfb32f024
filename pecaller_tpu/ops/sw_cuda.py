"""SW align scorer for NVIDIA Hopper: the CUDA kernel in sw_cuda.cu,
called through ``jax.ffi``.

Same contract as ``sw2.sw_align_x`` (xcode inputs; score x36, plane k,
ref row i, tie flag).  The kernel keeps one alignment's three DP planes
in one warp's registers for the whole row loop; the XLA scan of
``sw2.sw_align_x`` instead reads and writes those (B, M+1) int32 planes
through device memory once per reference row.  The DP is int32 and
exact, so the two agree element for element.

The shared library is built from sw_cuda.cu with ``nvcc`` at first use,
into ``<checkout>/.build/`` (git-ignored), keyed by a hash of the source.
A missing ``nvcc`` or a failed build is an error: on the GPU there is no
fall-back to the XLA scan.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

import jax
import jax.numpy as jnp
import numpy as np

from . import sw2

TARGET = "pecaller_sw_align_x"
BLOCK = 8                    # alignments per thread block (kWarpsPerBlock)
_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "sw_cuda.cu")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), ".build")


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (needed to build the GPU SW "
                           "kernel); put the CUDA toolkit on PATH")
    return path


def build_library() -> str:
    """Compile sw_cuda.cu for sm_90a (once per source hash); returns the
    shared library's path."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    lib = os.path.join(_BUILD_DIR, f"sw_cuda_{digest}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-I", jax.ffi.include_dir(), "-o", tmp, _SRC]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed building {_SRC}:\n{res.stderr}")
    os.replace(tmp, lib)
    return lib


@functools.cache
def _register() -> None:
    lib = ctypes.cdll.LoadLibrary(build_library())
    jax.ffi.register_ffi_target(
        TARGET, jax.ffi.pycapsule(lib.PecallerSwAlignX), platform="CUDA")


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def ffi_align(refs, blens, reads, rlens, bisulfite: bool, n_rows: int):
    """The kernel on B-padded inputs -> (4, B) int32 [score, k, i, tie]."""
    _register()
    out = jax.ShapeDtypeStruct((4, refs.shape[0]), jnp.int32)
    return jax.ffi.ffi_call(TARGET, out)(
        refs, blens, reads, rlens, bisulfite=np.int32(bisulfite),
        n_rows=np.int32(n_rows))


def xla_align(refs, blens, reads, rlens, bisulfite: bool, n_rows: int):
    """``ffi_align``'s contract computed by the XLA scan (sw2): the
    wrapper's CPU-testable stand-in for the kernel."""
    s, k, i, tie = sw2.sw_align_x(refs, blens, reads, rlens,
                                  bisulfite=bisulfite, n_rows=n_rows)
    return jnp.stack([s, k, i, tie.astype(jnp.int32)])


def align_padded(call, refs, blens, reads, rlens, bisulfite: bool = False,
                 n_rows: int | None = None):
    """Pad the batch to a multiple of BLOCK, run ``call`` on it, and
    unpack the first B results in sw2.sw_align_x's form.  Pad lanes get
    zero reference rows, so the kernel leaves them after the set-up."""
    B, N = refs.shape
    n_rows = N if n_rows is None else n_rows
    if not 0 <= n_rows <= N:
        raise ValueError(f"n_rows={n_rows} outside [0, {N}]")
    pad = _round_up(B, BLOCK) - B
    refs = jnp.pad(refs.astype(jnp.uint8), ((0, pad), (0, 0)))
    reads = jnp.pad(reads.astype(jnp.uint8), ((0, pad), (0, 0)))
    blens = jnp.pad(blens.astype(jnp.int32), (0, pad))
    rlens = jnp.pad(rlens.astype(jnp.int32), (0, pad), constant_values=1)
    out = call(refs, blens, reads, rlens, bisulfite, n_rows)
    return out[0, :B], out[1, :B], out[2, :B], out[3, :B] != 0


@functools.partial(jax.jit, static_argnames=("bisulfite", "n_rows"))
def sw_align_x_cuda(refs_x, blens, reads_x, rlens, bisulfite: bool = False,
                    n_rows: int | None = None):
    """sw2.sw_align_x on the Hopper kernel (GPU backend only)."""
    return align_padded(ffi_align, refs_x, blens, reads_x, rlens,
                        bisulfite=bisulfite, n_rows=n_rows)
