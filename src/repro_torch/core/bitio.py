"""Bit-level I/O used by the ToaD memory layout (paper Sec. 3.2.1).

Pure numpy, MSB-first within the stream.  The writer produces a ``uint8``
byte array whose length (in bits) is exactly the number of bits written —
the paper's memory accounting is derived from this stream, so there is no
hidden padding other than the final partial byte.

Reads are bounds-checked: any field that would extend past the declared
stream length raises :class:`StreamBoundsError` instead of wrapping or
reading the zero padding of the final byte as data.  The declared length
itself is validated against the backing buffer at construction, so a lying
``n_bits`` cannot make the reader index past the array.

A copy of ``repro.core.bitio`` (the JAX package's module is numpy-only but
its package imports JAX); both must write identical bytes.
"""

from __future__ import annotations

import numpy as np


class StreamBoundsError(EOFError):
    """A read would extend past the end of the bit stream.

    Subclasses :class:`EOFError` so callers that catch the generic error
    keep working; ``pos`` and ``width`` locate the offending read.
    """

    def __init__(self, message: str, pos: int = -1, width: int = -1):
        super().__init__(message)
        self.pos = pos
        self.width = width


class BitWriter:
    def __init__(self) -> None:
        self._bits: list[int] = []

    @property
    def n_bits(self) -> int:
        return len(self._bits)

    def write(self, value: int, width: int) -> None:
        """Write ``value`` as ``width`` bits, MSB first."""
        if width < 0:
            raise ValueError("width must be >= 0")
        value = int(value)
        if value < 0 or (width < 64 and value >= (1 << width)):
            raise ValueError(f"value {value} does not fit in {width} bits")
        for i in range(width - 1, -1, -1):
            self._bits.append((value >> i) & 1)

    def write_f32(self, value: float) -> None:
        self.write(int(np.float32(value).view(np.uint32)), 32)

    def write_f16(self, value: float) -> None:
        self.write(int(np.float16(value).view(np.uint16)), 16)

    def getvalue(self) -> np.ndarray:
        """The stream as a uint8 array (final byte zero-padded)."""
        n = len(self._bits)
        out = np.zeros((n + 7) // 8, dtype=np.uint8)
        for i, b in enumerate(self._bits):
            if b:
                out[i // 8] |= 1 << (7 - (i % 8))
        return out


class BitReader:
    def __init__(self, data: np.ndarray, n_bits: int | None = None) -> None:
        self._data = np.asarray(data, dtype=np.uint8)
        self._pos = 0
        self._n_bits = 8 * len(self._data) if n_bits is None else int(n_bits)
        # validate the declared length against the backing buffer up front:
        # a caller-supplied n_bits larger than the data would otherwise only
        # fail (with an opaque IndexError) once a read crosses the real end
        if self._n_bits < 0 or self._n_bits > 8 * len(self._data):
            raise StreamBoundsError(
                f"declared stream length {self._n_bits} bits exceeds the "
                f"{8 * len(self._data)}-bit backing buffer",
                pos=0,
                width=self._n_bits,
            )
        self._unpacked: np.ndarray | None = None  # lazy np.unpackbits cache

    @property
    def pos(self) -> int:
        return self._pos

    @property
    def remaining(self) -> int:
        return self._n_bits - self._pos

    def _bounds(self, width: int) -> None:
        if width < 0:
            raise ValueError("width must be >= 0")
        if width > self.remaining:
            raise StreamBoundsError(
                f"requested {width} bits at bit {self._pos}, "
                f"{self.remaining} remain",
                pos=self._pos,
                width=width,
            )

    def read(self, width: int) -> int:
        self._bounds(width)
        value = 0
        for _ in range(width):
            byte = self._data[self._pos // 8]
            bit = (int(byte) >> (7 - (self._pos % 8))) & 1
            value = (value << 1) | bit
            self._pos += 1
        return value

    def read_array(self, width: int, count: int) -> np.ndarray:
        """Read ``count`` consecutive ``width``-bit fields, vectorized.

        Returns a uint64 array of length ``count``.  Equivalent to ``count``
        calls to :meth:`read` but unpacks the stream once (cached) and folds
        each field with one matmul.
        """
        if width == 0:
            return np.zeros(count, np.uint64)
        self._bounds(width * count)
        if width > 63:
            raise ValueError("read_array supports widths up to 63 bits")
        if self._unpacked is None:
            self._unpacked = np.unpackbits(self._data)
        bits = self._unpacked[self._pos : self._pos + width * count]
        weights = (np.uint64(1) << np.arange(width - 1, -1, -1, dtype=np.uint64))
        out = bits.reshape(count, width).astype(np.uint64) @ weights
        self._pos += width * count
        return out

    def seek(self, bit_pos: int) -> None:
        """Reposition the cursor to an absolute bit offset.

        Bounds-checked against the declared stream length, so a seek can
        never place the cursor where a subsequent read would index past the
        backing buffer.  Seeking exactly to ``n_bits`` is allowed (the
        "end of stream" position, mirroring ``remaining == 0``).
        """
        bit_pos = int(bit_pos)
        if bit_pos < 0 or bit_pos > self._n_bits:
            raise StreamBoundsError(
                f"seek to bit {bit_pos} outside the {self._n_bits}-bit "
                f"stream", pos=bit_pos, width=0,
            )
        self._pos = bit_pos

    def subreader(self, start_bit: int, n_bits: int) -> "BitReader":
        """A bounded reader over bits ``[start_bit, start_bit + n_bits)``.

        Shares the backing buffer (no copy): the view's cursor starts at
        ``start_bit`` and its declared length ends the window, so reads are
        bounds-checked against the window, not the whole stream.  ``pos``
        on the view reports *absolute* stream offsets, which keeps
        diagnostics from per-block decoders anchored in the parent stream.
        """
        start_bit = int(start_bit)
        n_bits = int(n_bits)
        if n_bits < 0:
            raise ValueError("n_bits must be >= 0")
        if start_bit < 0 or start_bit + n_bits > self._n_bits:
            raise StreamBoundsError(
                f"subreader [{start_bit}, {start_bit + n_bits}) outside the "
                f"{self._n_bits}-bit stream", pos=start_bit, width=n_bits,
            )
        sub = BitReader(self._data, start_bit + n_bits)
        sub._pos = start_bit
        sub._unpacked = self._unpacked  # share the lazy bit cache if built
        return sub

    def read_f32(self) -> float:
        return float(np.uint32(self.read(32)).view(np.float32))

    def read_f16(self) -> float:
        return float(np.uint16(self.read(16)).view(np.float16))

    def read_f32_array(self, count: int) -> np.ndarray:
        """Read ``count`` consecutive f32 values (vectorized)."""
        return self.read_array(32, count).astype(np.uint32).view(np.float32)


def bits_for(n: int) -> int:
    """⌈log2(n)⌉ with the convention bits_for(0) = bits_for(1) = 1.

    The paper indexes ``n`` distinct items; one item still needs a 1-bit
    field so the decoder has a well-defined stride.
    """
    if n <= 1:
        return 1
    return int(np.ceil(np.log2(n)))
