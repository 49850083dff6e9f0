"""Build, load and call the CUDA banded Smith–Waterman kernel
(``banded_sw.cu``) through the XLA FFI.

The shared library is compiled from the repository's source with
``nvcc`` at first use, into ``<this package>/_libbanded_sw-<hash>.so``
(the hash covers the source and the flags, so an edited source is
rebuilt); the build is set-up time.  Nothing here runs on a machine
without a CUDA GPU: :func:`banded_sw_cuda` is only chosen by
``ops.extend.banded_sw`` when JAX's backend is ``"gpu"``, and the CPU
tests cover the arithmetic through ``banded_sw_jnp``, the reference
this kernel must match bit for bit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

_HERE = Path(__file__).parent
_SRC = _HERE / "banded_sw.cu"
_TARGET = "monica_banded_sw"
BANDS = (32, 64, 128)  # W = 32 * cells per lane; see banded_sw.cu pick()
_ARCH = "sm_90a"
_lock = threading.Lock()
_registered = False


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: the CUDA banded-SW kernel cannot be built")
    return found


def _command(dest: Path) -> list[str]:
    return [
        _nvcc(), f"-gencode=arch=compute_{_ARCH[3:]},code={_ARCH}",
        "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
        "-I", jax.ffi.include_dir(), "-o", str(dest), str(_SRC),
    ]


def library_path() -> Path:
    key = hashlib.sha256(_SRC.read_bytes() + _ARCH.encode()).hexdigest()[:12]
    return _HERE / f"_libbanded_sw-{key}.so"


def build() -> Path:
    """Compile the kernel library unless an up-to-date one exists."""
    dest = library_path()
    if dest.exists():
        return dest
    tmp = dest.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(_command(tmp), capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stderr[-4000:]}")
    os.replace(tmp, dest)
    return dest


def register() -> None:
    """Build (if needed), load and register the FFI target once."""
    global _registered
    with _lock:
        if _registered:
            return
        lib = ctypes.cdll.LoadLibrary(str(build()))
        jax.ffi.register_ffi_target(
            _TARGET, jax.ffi.pycapsule(lib.BandedSw), platform="CUDA"
        )
        _registered = True


def supports(band: int) -> bool:
    return band in BANDS


def banded_sw_cuda(q, refwin, lengths, p, mbits: int, npass: int):
    """(B, L) uint8 reads, (B, L+W) uint8 windows, (B,) int32 lengths
    -> (score, mlen) int32 (B,).  ``mbits`` > 0 selects the packed DP
    (ops/extend.py packed_mbits), 0 the pair DP; ``npass`` is the number
    of horizontal prefix-max passes."""
    if not supports(p.band):
        raise ValueError(f"CUDA banded SW supports bands {BANDS}, not {p.band}")
    register()
    B = q.shape[0]
    out = jax.ShapeDtypeStruct((B,), jnp.int32)
    return jax.ffi.ffi_call(_TARGET, (out, out), vmap_method="broadcast_all")(
        q.astype(jnp.uint8),
        refwin.astype(jnp.uint8),
        lengths.astype(jnp.int32),
        match=np.int32(p.match),
        mismatch=np.int32(p.mismatch),
        gap=np.int32(p.gap),
        npass=np.int32(npass),
        mbits=np.int32(mbits),
    )
