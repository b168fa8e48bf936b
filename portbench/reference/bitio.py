"""MSB-first bit reader over byte buffers.

Equivalent surface to the `av` package's AV.Bitstream that the reference
decoder consumes (decoder.js:125-216 reads via stream.read/peek/advance/
align).  This Python implementation is the correctness/reference path; the
production parse path is native (see native/ and aacjax.host.native).
"""
from __future__ import annotations


class BitstreamError(Exception):
    """Raised on malformed bitstream data."""


class BitstreamUnderflow(BitstreamError):
    """Raised on reads past the end of the buffer — distinguishes 'need
    more data' from 'corrupt data' for streaming callers (the analog of
    Aurora's AV.UnderflowError that the reference relies on)."""


class BitReader:
    """Reads up to 32 bits at a time, MSB first, from a bytes-like object."""

    __slots__ = ("_data", "_nbytes", "_byte", "_cache", "_ncached")

    def __init__(self, data: bytes | bytearray | memoryview):
        self._data = bytes(data)
        self._nbytes = len(self._data)
        self._byte = 0       # next byte index to refill from
        self._cache = 0      # bit cache, top bits are next to read
        self._ncached = 0    # number of valid bits in cache

    # -- position ---------------------------------------------------------
    @property
    def bit_position(self) -> int:
        return self._byte * 8 - self._ncached

    @property
    def bits_left(self) -> int:
        return self._nbytes * 8 - self.bit_position

    def seek_bits(self, bitpos: int) -> None:
        if not 0 <= bitpos <= self._nbytes * 8:
            raise BitstreamError(f"seek out of range: {bitpos}")
        self._byte = bitpos >> 3
        self._cache = 0
        self._ncached = 0
        rem = bitpos & 7
        if rem:
            # load the byte containing bitpos and drop its top `rem` bits
            b = self._data[self._byte]
            self._byte += 1
            self._ncached = 8 - rem
            self._cache = b & ((1 << self._ncached) - 1)

    # -- core -------------------------------------------------------------
    def _fill(self, need: int) -> None:
        while self._ncached < need:
            if self._byte >= self._nbytes:
                raise BitstreamUnderflow("read past end of bitstream")
            self._cache = (self._cache << 8) | self._data[self._byte]
            self._byte += 1
            self._ncached += 8

    def read(self, n: int) -> int:
        """Read n bits (0 <= n <= 32), MSB first."""
        if n == 0:
            return 0
        self._fill(n)
        self._ncached -= n
        val = self._cache >> self._ncached
        self._cache &= (1 << self._ncached) - 1
        return val

    def peek(self, n: int) -> int:
        if n == 0:
            return 0
        self._fill(n)
        return self._cache >> (self._ncached - n)

    def peek_padded(self, n: int) -> int:
        """Peek n bits; bits past the end of the buffer read as zero.

        Used by LUT-based Huffman decode, which peeks the maximum codeword
        length even when the actual codeword (always fully inside the
        buffer) is shorter than the remaining bits.
        """
        avail = self.bits_left
        if avail >= n:
            return self.peek(n)
        if avail <= 0:
            return 0
        return self.peek(avail) << (n - avail)

    def advance(self, n: int) -> None:
        """Skip n bits (n may exceed 32)."""
        target = self.bit_position + n
        if target > self._nbytes * 8:
            raise BitstreamUnderflow("advance past end of bitstream")
        if n <= self._ncached:
            self._ncached -= n
            self._cache &= (1 << self._ncached) - 1
        else:
            self.seek_bits(target)

    def align(self) -> None:
        """Advance to the next byte boundary (stream.align())."""
        rem = self.bit_position & 7
        if rem:
            self.advance(8 - rem)
