"""Build, load and launch the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` on its own into a shared
library with a plain C interface, loaded with ``ctypes`` — no PyTorch
headers, so a build takes seconds. Builds happen at first use, go to
``build/kernels/`` at the repository root, and are cached by a hash of the
sources and flags. :func:`build` starts one ``nvcc`` per source, all at
once. Nothing here runs at import: this module imports on machines with
no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = (
    "decode_utf8", "fused_vocab", "fused_xform", "fused_decode_vocab", "fused_decode_xform",
    "vocab", "dense_xform", "embedding_bag", "flash_attention",
)
# No --use_fast_math: it would replace log1pf, and the dense outputs are
# held to rtol 1e-6.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libraries: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else
    ``/usr/local/cuda/bin/nvcc``, else ``nvcc`` on ``PATH``."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.is_file():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the port's CUDA kernels are "
            "built from kernels/csrc at first use"
        )
    return found


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives for the current
    sources: the file name carries a hash of every source and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, Path]:
    """Compile every library of ``names`` not yet built, one ``nvcc`` per
    source, all started together. Returns name → library path. Each
    library's compiler output (register and shared-memory use) is kept
    beside it as ``<library>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: library_path(name) for name in names}
    running = []
    for name, path in paths.items():
        if path.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        running.append((name, path, tmp, proc))
    failures = []
    for name, path, tmp, proc in running:
        out, _ = proc.communicate()
        Path(f"{path}.log").write_text(out)
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, path)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libraries.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build((name,))[name]))
            lib.error_string.argtypes = [ctypes.c_int]
            lib.error_string.restype = ctypes.c_char_p
            _libraries[name] = lib
        return lib


PTR = ctypes.c_void_p
INT = ctypes.c_int
INT64 = ctypes.c_int64


class Kernel:
    """One C entry point of a kernel library, and the count of its launches.

    ``launches`` grows by one each time :meth:`launch` launches the kernel,
    and nowhere else; a run resets it to 0 to count its own launches.
    """

    def __init__(self, source: str, symbol: str, argtypes: list):
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def launch(self, device: torch.device, *args) -> None:
        """Launch on ``device``'s current stream (passed as the last C
        argument); raise if the launch failed."""
        if self._fn is None:
            fn = getattr(library(self.source), self.symbol)
            fn.argtypes = [*self.argtypes, PTR]
            fn.restype = INT
            self._fn = fn
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = self._fn(*args, stream)
        if err != 0:
            msg = library(self.source).error_string(err).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {err} ({msg})")
        self.launches += 1


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape=None, device=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` (and of
    ``shape`` and on ``device`` where given)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t).__name__}")
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got one on {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def decode_scratch(source: str, n: int, cap: int, device: torch.device) -> torch.Tensor:
    """The int32 scratch of one call of a bytes-in kernel
    (fused_decode_vocab.cu, fused_decode_xform.cu), which runs the shared
    decode passes of csrc/decode_passes.cuh over ``n`` bytes, keeping the
    positions of the first ``cap`` delimiters."""
    fn = library(source).decode_scratch_ints
    fn.argtypes = [INT64, INT64]
    fn.restype = INT64
    return torch.empty(fn(n, cap), dtype=torch.int32, device=device)


def check_bytes(byte_buf: torch.Tensor) -> int:
    """Raise unless ``byte_buf`` is a contiguous 1-D uint8 CUDA tensor of
    fewer than 2**31 bytes; return its length."""
    check(byte_buf, "byte_buf", torch.uint8)
    if byte_buf.dim() != 1:
        raise ValueError(f"byte_buf: expected 1-D, got shape {tuple(byte_buf.shape)}")
    n = int(byte_buf.shape[0])
    if n >= 2**31:
        raise ValueError(f"byte_buf: {n} bytes; the kernel takes fewer than 2**31")
    return n
