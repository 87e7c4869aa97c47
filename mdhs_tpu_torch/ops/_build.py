"""Build the port's CUDA kernels with nvcc and bind them through ctypes.

All ``csrc/*.cu`` sources compile into one shared library with a plain C
interface: one nvcc per source, all started together, then one link::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC \\
         -c csrc/<source>.cu -o <source>.o                    (each source at once)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o build/libmdhs_kernels_<hash>.so *.o

The build runs at first use, into ``mdhs_tpu_torch/build/`` (git-ignored),
keyed on a hash of the sources and flags, so a checkout builds everything
from its own sources. Nothing here runs at import time, and nothing falls
back: a missing nvcc or a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
SOURCES = ("bf16_gemm.cu", "attention_block.cu", "ffn_block.cu", "int8_gemm.cu", "int8_ffn_block.cu",
           "int8_attention_block.cu", "fused_attention.cu", "shear.cu", "bn_stats.cu", "selective_scan.cu",
           "kan_spline.cu", "flash_attention.cu", "attention_ablate.cu")
HEADERS = ("common.cuh", "attention_sm90.cuh", "attention_bwd_sm90.cuh", "gemm_sm90.cuh", "epi_sm90.cuh")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-lineinfo", "-Xptxas=-v", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # x, wqkv, bqkv, wo, bo, gamma, beta, bias, qkv, ctx, work, out, B, L, HD, heads, scale, eps,
    # the two products' plans (width, splits, cluster), stream
    "attention_block_forward": [_P] * 12 + [_I] * 4 + [_F, _F] + [_I] * 6 + [_P],
    # x, w1, b1, w2, b2, gamma, beta, h, work, out, N, H, Di, eps, act, the two plans, stream
    "ffn_block_forward": [_P] * 10 + [_I] * 3 + [_F, _I] + [_I] * 6 + [_P],
    # A, W, bias, C, work, M, N, K, act, width, splits, cluster, stream
    "bf16_tile_gemm_forward": [_P] * 5 + [_I] * 7 + [_P],
    # A, W, bias, resid, gamma, beta, out, work, M, H, K, eps, width, splits, cluster, stream
    "bf16_ln_gemm_forward": [_P] * 8 + [_I] * 3 + [_F] + [_I] * 3 + [_P],
    # x, w1, s1, b1, w2, s2, b2, gamma, beta, x_q, sx, part, h_q, sh, out, N, H, Di, eps, act, stream
    "int8_ffn_block_forward": [_P] * 15 + [_I] * 3 + [_F, _I, _P],
    # x, wqkv, sqkv, bqkv, wo, so, bo, gamma, beta, bias, x_q, sx, qkv, ctx, c_q, sc, out,
    # B, L, HD, heads, scale, eps, stream
    "int8_attention_block_forward": [_P] * 17 + [_I] * 4 + [_F, _F, _P],
    # q, k, v, bias, ctx, B, L, HD, heads, scale, stream
    "fused_attention_forward": [_P] * 5 + [_I] * 4 + [_F, _P],
    # x, d, out, B, C, S, L, pad, stream
    "shear_sublane_forward": [_P] * 3 + [_I] * 5 + [_P],
    # x, dtype, ws, counters, out, R, C, the plan (vec, col_groups, cols, row_groups, rows), stream
    "bn_stats_forward": [_P, _I] + [_P] * 3 + [_I] * 7 + [_P],
    # x, dtype, mean, dmean, dvar, dx, R, C, sms, stream
    "bn_stats_backward": [_P, _I] + [_P] * 4 + [_I] * 3 + [_P],
    # x, dt, A, B, C, D, y, batch, L, D, N, stream
    "selective_scan_forward": [_P] * 7 + [_I] * 4 + [_P],
    # x, grid, base_w, spline_w, y, ws, counters, E, B, IN, OUT, ldb, x_shared, bn, splits, per, stream
    "kan_forward": [_P] * 7 + [_I] * 11 + [_P],
    # q, k, v, bias, ctx, B, L, HD, heads, scale, mode, stream
    "attention_ablate_forward": [_P] * 5 + [_I] * 4 + [_F, _I, _P],
    # q, k, v, seg, out, m, l, B, L, HD, heads, scale, stream
    "flash_attention_forward": [_P] * 7 + [_I] * 4 + [_F, _P],
    # q, k, v, seg, m, l, dout, di, dk, dv, B, L, HD, heads, scale, stream
    "flash_attention_bwd_dkv": [_P] * 10 + [_I] * 4 + [_F, _P],
    # q, k, v, seg, o, m, l, dout, dq, di, B, L, HD, heads, scale, stream
    "flash_attention_bwd_dq": [_P] * 10 + [_I] * 4 + [_F, _P],
}


def _find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").is_file():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): cannot build the CUDA kernels")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    return BUILD_DIR / f"libmdhs_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile the library if it is not built yet; return (path, seconds spent).

    Each source compiles in its own nvcc process, all at once; the compiler's
    output (``-Xptxas=-v``: registers, shared memory, spills of every kernel)
    is kept beside the library as ``<lib>.log``.
    """
    lib = library_path()
    if lib.is_file():
        return lib, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _find_nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (Path(s).stem + ".o") for s in SOURCES]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", str(CSRC_DIR / s), "-o", str(o)] for s, o in zip(SOURCES, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for c in cmds]
        logs = [p.communicate()[0] for p in procs]  # waits for every process, failed or not
        for cmd, proc, log in zip(cmds, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
        tmp_lib = Path(tmp) / lib.name
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
        Path(str(lib) + ".log").write_text("".join(logs) + proc.stdout + proc.stderr)
        os.replace(tmp_lib, lib)  # atomic: a concurrent process never loads a partial file
    return lib, time.perf_counter() - t0


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, then load the library once per process."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.mdhs_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mdhs_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check_launch(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.mdhs_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def require(t: torch.Tensor, name: str, shape: tuple, dtype: torch.dtype, device: torch.device) -> None:
    """Check an operand before its pointer goes to a kernel."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % 16 != 0:
        raise ValueError(f"{name}: data pointer not 16-byte aligned")


def stream_of(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
