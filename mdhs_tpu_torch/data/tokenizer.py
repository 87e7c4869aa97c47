"""Host-side WordPiece tokenizer (BERT-compatible, offline).

Counterpart of ``mdhs_tpu/data/tokenizer.py``: HF's BasicTokenizer +
WordPiece over a ``vocab.txt`` (lowercasing, accent stripping, CJK
isolation, punctuation splitting, greedy longest-match-first subwords,
[CLS]/[SEP] framing, truncation and padding to ``max_length``), or, with no
vocab file, the deterministic synthetic vocabulary that hashes each word
into a fixed id range. ``load_tokenizer`` takes the native C++ WordPiece
(``mdhs_tpu_torch/native.py``) for a vocab file where it builds.
"""

from __future__ import annotations

import os
import unicodedata
import zlib
from typing import Iterable, Optional

import numpy as np

PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF or 0xF900 <= cp <= 0xFAFF)


def basic_tokenize(text: str, lowercase: bool = True) -> list[str]:
    text = unicodedata.normalize("NFC", text or "")
    out = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or unicodedata.category(ch).startswith("C") and ch not in "\t\n\r":
            continue
        if _is_cjk(cp):
            out.append(f" {ch} ")
        elif ch in "\t\n\r" or unicodedata.category(ch) == "Zs":
            out.append(" ")
        else:
            out.append(ch)
    tokens = []
    for tok in "".join(out).split():
        if lowercase:
            tok = tok.lower()
            tok = "".join(c for c in unicodedata.normalize("NFD", tok) if unicodedata.category(c) != "Mn")
        cur = []
        for ch in tok:  # split on punctuation
            if _is_punctuation(ch):
                if cur:
                    tokens.append("".join(cur))
                    cur = []
                tokens.append(ch)
            else:
                cur.append(ch)
        if cur:
            tokens.append("".join(cur))
    return tokens


class WordPieceTokenizer:
    def __init__(self, vocab: dict[str, int], lowercase: bool = True, max_chars_per_word: int = 100):
        self.vocab = vocab
        self.lowercase = lowercase
        self.max_chars_per_word = max_chars_per_word
        self.pad_id = vocab.get(PAD, 0)
        self.unk_id = vocab.get(UNK, 1)
        self.cls_id = vocab.get(CLS, 2)
        self.sep_id = vocab.get(SEP, 3)
        self.vocab_size = max(vocab.values()) + 1
        self._hashed = False

    @classmethod
    def from_vocab_file(cls, path: str, lowercase: bool = True) -> "WordPieceTokenizer":
        vocab = {}
        with open(path, "r", encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab[line.rstrip("\n")] = i
        return cls(vocab, lowercase)

    @classmethod
    def synthetic(cls, vocab_size: int = 512) -> "WordPieceTokenizer":
        """Deterministic hashed-word vocab for synthetic data and tests."""
        tok = cls({PAD: 0, UNK: 1, CLS: 2, SEP: 3, MASK: 4}, lowercase=True)
        tok.vocab_size = vocab_size
        tok._hashed = True
        return tok

    def _wordpiece(self, word: str) -> list[int]:
        if self._hashed:
            # crc32, not hash(): str hashes are salted per process
            return [5 + (zlib.crc32(word.encode("utf-8")) % (self.vocab_size - 5))]
        if len(word) > self.max_chars_per_word:
            return [self.unk_id]
        ids = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = self.vocab[sub]
                    break
                end -= 1
            if cur is None:
                return [self.unk_id]
            ids.append(cur)
            start = end
        return ids

    def encode(self, text: str, max_length: int = 128):
        """(input_ids, attention_mask), int32 arrays of max_length: [CLS] ... [SEP], padded."""
        ids = [self.cls_id]
        for word in basic_tokenize(text, self.lowercase):
            ids.extend(self._wordpiece(word))
            if len(ids) >= max_length - 1:
                break
        ids = ids[: max_length - 1]
        ids.append(self.sep_id)
        mask = [1] * len(ids)
        ids += [self.pad_id] * (max_length - len(ids))
        mask += [0] * (max_length - len(mask))
        return np.asarray(ids, np.int32), np.asarray(mask, np.int32)

    def encode_batch(self, texts: Iterable[str], max_length: int = 128):
        pairs = [self.encode(t, max_length) for t in texts]
        return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])


def load_tokenizer(model_name_or_path: Optional[str], vocab_size: int = 30522, lowercase: bool = True,
                   prefer_native: bool = True):
    """A local vocab.txt (the file, or a directory holding it), through the
    native WordPiece where it builds; else the synthetic vocabulary."""
    if model_name_or_path:
        path = model_name_or_path
        vocab_file = None
        if os.path.isdir(path):
            cand = os.path.join(path, "vocab.txt")
            if os.path.exists(cand):
                vocab_file = cand
        elif os.path.isfile(path):
            vocab_file = path
        if vocab_file:
            if prefer_native:
                from .. import native

                if native.available():
                    return native.NativeWordPiece(vocab_file, lowercase)
            return WordPieceTokenizer.from_vocab_file(vocab_file, lowercase)
    return WordPieceTokenizer.synthetic(vocab_size)
