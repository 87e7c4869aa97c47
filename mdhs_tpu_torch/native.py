"""ctypes binding of the repository's native host code (``native/*.cpp``).

Counterpart of ``mdhs_tpu/native/__init__.py``, with a build of its own:
``native/imageops.cpp`` and ``native/wordpiece.cpp`` are compiled with g++
(the flags of ``native/Makefile``) at first use into
``mdhs_tpu_torch/build/native/``, under a name that carries a hash of the
sources, so an edited source builds anew and ``native/`` is never written.
The build goes to a temporary file renamed into place, so processes that
build at once do not read a half-written library.

Provides:
- ``resize_center_square(img_u8, size)``: the antialiased shortest-side
  resize + center crop of the host canvas (a triangle filter, PIL BILINEAR's
  weights); None when the library is unavailable, as in JAX, so the caller
  takes PIL. Its calls are counted in ``resize_center_square.calls``.
- ``NativeWordPiece``: a vocab.txt WordPiece tokenizer, the Python one for
  texts outside the code points the C tokenizer is known to handle.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

log = logging.getLogger(__name__)

_SOURCE_DIR = Path(__file__).resolve().parent.parent / "native"
_SOURCES = ("imageops.cpp", "wordpiece.cpp")
_BUILD_DIR = Path(__file__).resolve().parent / "build" / "native"
_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")
_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> Path | None:
    """Compile the sources unless this version is built; the library's path, or
    None where the sources or g++ are missing or the build fails."""
    sources = [_SOURCE_DIR / s for s in _SOURCES]
    if not all(s.is_file() for s in sources):
        return None
    digest = hashlib.sha256(b"".join(s.read_bytes() for s in sources) + " ".join(_FLAGS).encode())
    lib = _BUILD_DIR / f"libmdhs_native-{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *_FLAGS, "-o", str(tmp), *map(str, sources)], check=True, capture_output=True,
                       timeout=300)
    except (OSError, subprocess.SubprocessError) as exc:
        log.info("native build skipped: %s", exc)
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, lib)
    return lib


def get_lib():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = _build()
        if path is None:
            return None
        lib = ctypes.CDLL(str(path))
        lib.resize_center_square_u8.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
        ]
        lib.resize_center_square_u8.restype = None
        lib.wp_create.restype = ctypes.c_void_p
        lib.wp_create.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.wp_free.argtypes = [ctypes.c_void_p]
        lib.wp_free.restype = None
        lib.wp_vocab_size.argtypes = [ctypes.c_void_p]
        lib.wp_vocab_size.restype = ctypes.c_int
        lib.wp_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        lib.wp_encode.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def resize_center_square(img: np.ndarray, size: int) -> np.ndarray | None:
    """uint8 HWC (or HW) image -> (size, size[, C]). None if the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    out = np.empty((size, size, c), np.uint8)
    lib.resize_center_square_u8(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w, c,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), size,
    )
    resize_center_square.calls += 1
    return out[..., 0] if squeeze else out


resize_center_square.calls = 0

# Code points the C BasicTokenizer handles with HF semantics (ASCII,
# Latin-1, Latin Ext-A, combining marks, Zs spaces, common typographic
# punctuation, HF's CJK ideograph ranges). A text holding anything else goes
# to the Python tokenizer, so the native path never diverges from it.
_SAFE_SINGLES = frozenset(
    {0xA0, 0x1680, 0x2013, 0x2014, 0x2018, 0x2019, 0x201C, 0x201D,
     0x2026, 0x202F, 0x205F, 0x3000, 0x3001, 0x3002}
    | set(range(0x300C, 0x3010))
)


def _native_tokenizer_safe(text: str) -> bool:
    for ch in text:
        cp = ord(ch)
        # µ (0xB5) and ſ (0x17F) lowercase across blocks in Python (µ -> μ, ſ -> s);
        # the C table keeps them in their block
        if cp == 0xB5 or cp == 0x17F:
            return False
        if cp < 0x180 or 0x300 <= cp <= 0x36F or 0x2000 <= cp <= 0x200A:
            continue
        if (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
                or 0xF900 <= cp <= 0xFAFF or 0x20000 <= cp <= 0x2A6DF):
            continue
        if cp not in _SAFE_SINGLES:
            return False
    return True


class NativeWordPiece:
    """``encode`` / ``encode_batch`` as ``data/tokenizer.py::WordPieceTokenizer``'s."""

    def __init__(self, vocab_path: str, lowercase: bool = True):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._h = lib.wp_create(vocab_path.encode(), int(lowercase))
        if not self._h:
            raise FileNotFoundError(vocab_path)
        self.vocab_size = lib.wp_vocab_size(self._h)
        self.pad_id = 0
        self._vocab_path = vocab_path
        self._lowercase = lowercase
        self._py = None

    def _python_tokenizer(self):
        if self._py is None:
            from .data.tokenizer import WordPieceTokenizer

            self._py = WordPieceTokenizer.from_vocab_file(self._vocab_path, self._lowercase)
        return self._py

    def encode(self, text: str, max_length: int = 128):
        if text and not _native_tokenizer_safe(text):
            return self._python_tokenizer().encode(text, max_length)
        ids = np.empty(max_length, np.int32)
        mask = np.empty(max_length, np.int32)
        # a NUL would end the C string; HF's _clean_text removes NULs anyway
        self._lib.wp_encode(
            self._h, (text or "").replace("\x00", "").encode("utf-8", errors="ignore"), max_length,
            ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            mask.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        )
        return ids, mask

    def encode_batch(self, texts, max_length: int = 128):
        pairs = [self.encode(t, max_length) for t in texts]
        return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.wp_free(self._h)
            self._h = None
