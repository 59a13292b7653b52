"""Build and load the port's CUDA kernels at first use.

All sources under ``csrc/`` are compiled in one
``torch.utils.cpp_extension.load`` call for ``sm_90a`` into
``build/torch_kernels/`` at the repository root (listed in
``.gitignore``).  The sources include no PyTorch header: the library
exports a plain C interface (``csrc/bindings.cpp``) that is bound with
``ctypes``, which keeps the build to seconds.  Nothing is built when the
module is imported, and a failed build raises.
"""

from __future__ import annotations

import ctypes
import os
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
SOURCES = ("chol_solve_sample.cu", "chol_solve_sample_wide.cu",
           "gram_accumulate.cu", "gram_accumulate_wide.cu", "bindings.cpp")
CUDA_FLAGS = ("-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a")

_lib = None


def _declare(lib):
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.ptg_error_string.argtypes = [I]
    lib.ptg_error_string.restype = ctypes.c_char_p
    lib.ptg_chol_solve_sample.argtypes = [I, P, P, P, P, P, P, P, P, I, I,
                                          D, P, P]
    lib.ptg_chol_solve_sample.restype = I
    lib.ptg_gram_accumulate.argtypes = [P, P, P, P, I, I, I, I, I, I, I,
                                        P, P]
    lib.ptg_gram_accumulate.restype = I
    lib.ptg_chol_solve_sample_wide.argtypes = [I, P, P, P, P, P, P, P, P, P,
                                               I, I, D, P, P]
    lib.ptg_chol_solve_sample_wide.restype = I
    lib.ptg_gram_accumulate_wide.argtypes = [P, P, P, P, I, I, I, I, I, I,
                                             I, P, P]
    lib.ptg_gram_accumulate_wide.restype = I
    lib.ptg_wide_config.argtypes = [I, I, I, I, P]
    lib.ptg_wide_config.restype = I
    return lib


def library(verbose: bool = False):
    """The loaded kernel library (built on the first call)."""
    global _lib
    if _lib is None:
        from torch.utils.cpp_extension import load

        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        path = load(
            name="ptg_torch_kernels",
            sources=[str(_CSRC / s) for s in SOURCES],
            extra_cflags=["-O3"],
            extra_cuda_cflags=list(CUDA_FLAGS)
            + (["-Xptxas=-v"] if verbose else []),
            extra_include_paths=[str(_CSRC)],
            build_directory=str(BUILD_DIR),
            is_python_module=False,
            verbose=verbose)
        _lib = _declare(ctypes.CDLL(os.fspath(path)))
    return _lib


def check(code: int, what: str):
    """Raise if a launcher returned a CUDA error code."""
    if code != 0:
        msg = library().ptg_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA launch failed ({code}: {msg})")
