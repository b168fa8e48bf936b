"""AAC Huffman decoding: flat-LUT multi-bit decode.

Replaces the reference's per-codeword linear scan (huffman.js:1426-1439,
SURVEY.md §3 "hot loops") with a table-driven decoder: each codebook is
compiled once into a full 2^maxlen lookup table mapping a peeked bit window
directly to (symbol index, codeword length).  One peek + one advance per
codeword instead of an O(book) scan with bit-by-bit reads.

Spectral semantics reproduced from huffman.js:1441-1490:
  - books 1-4 decode 4 values, books 5-11 decode 2,
  - unsigned books (3,4,7,8,9,10,11) emit sign bits for nonzero values,
  - book 11 escape: |v| == 16 expands to a unary-prefixed escape value.

Codebook data: aacjax/host/huffman_books.npz (ISO/IEC 14496-3 tables
4.A.2-4.A.13; see tools/gen_huffman.py for provenance).
"""
from __future__ import annotations

import pathlib

import numpy as np

from portbench.reference.bitio import BitReader, BitstreamError

_BOOKS_PATH = pathlib.Path(__file__).parent / "huffman_books.npz"

# Which spectral books store absolute values with separate sign bits
# (huffman.js:1421; book index is 1-based).
UNSIGNED = (False, False, True, True, False, False, True, True, True, True, True)
QUAD_BOOKS = frozenset((1, 2, 3, 4))
ESC_BOOK = 11
ESC_FLAG = 16


class HuffmanTable:
    """One codebook compiled to a flat LUT."""

    __slots__ = ("name", "maxlen", "lens", "values", "lut")

    def __init__(self, name: str, rows: np.ndarray):
        self.name = name
        lens = rows[:, 0].astype(np.int64)
        codes = rows[:, 1].astype(np.int64)
        self.maxlen = int(lens.max())
        self.lens = lens.astype(np.uint8)
        self.values = np.ascontiguousarray(rows[:, 2:], dtype=np.int32)
        # Flat LUT: every maxlen-bit window starting with codeword i maps to i.
        lut = np.full(1 << self.maxlen, -1, dtype=np.int32)
        for i in range(len(rows)):
            shift = self.maxlen - int(lens[i])
            base = int(codes[i]) << shift
            lut[base: base + (1 << shift)] = i
        self.lut = lut

    def decode(self, stream: BitReader) -> int:
        """Decode one codeword, returning the symbol index."""
        window = stream.peek_padded(self.maxlen)
        idx = int(self.lut[window])
        if idx < 0:
            raise ValueError(f"invalid {self.name} codeword")
        stream.advance(int(self.lens[idx]))
        return idx


def _load() -> tuple[list[HuffmanTable], HuffmanTable]:
    data = np.load(_BOOKS_PATH)
    spectral = [HuffmanTable(f"HCB{i}", data[f"HCB{i}"]) for i in range(1, 12)]
    sf = HuffmanTable("HCB_SF", data["HCB_SF"])
    return spectral, sf


SPECTRAL_BOOKS, SF_BOOK = _load()


def decode_scalefactor(stream: BitReader) -> int:
    """Decode one scalefactor delta symbol (0..120; caller subtracts 60)."""
    idx = SF_BOOK.decode(stream)
    return int(SF_BOOK.values[idx, 0])


def _escape(stream: BitReader, sign: int) -> int:
    """Book-11 escape sequence (huffman.js:1448-1455).

    The unary prefix is capped at the same bound as the native parser
    (aacparse.cc "escape too long") so both paths reject identical corrupt
    streams — the reference's loop is unbounded."""
    n = 4
    while stream.read(1):
        n += 1
        if n > 24:
            raise BitstreamError("escape too long")
    value = stream.read(n) | (1 << n)
    return -value if sign < 0 else value


def decode_spectral(stream: BitReader, book: int, out: list[int]) -> None:
    """Decode one codeword of spectral data into out[0:2 or 0:4]."""
    table = SPECTRAL_BOOKS[book - 1]
    idx = table.decode(stream)
    vals = table.values[idx]
    n = 4 if book in QUAD_BOOKS else 2
    for j in range(n):
        out[j] = int(vals[j])
    if book < ESC_BOOK:
        if UNSIGNED[book - 1]:
            for j in range(n):
                if out[j] and stream.read(1):
                    out[j] = -out[j]
    elif book == ESC_BOOK:
        for j in range(2):
            if out[j] and stream.read(1):
                out[j] = -out[j]
        for j in range(2):
            if abs(out[j]) == ESC_FLAG:
                out[j] = _escape(stream, out[j])
    else:
        raise ValueError(f"unknown spectral codebook: {book}")
