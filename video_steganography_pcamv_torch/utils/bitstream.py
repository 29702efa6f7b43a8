"""Host-side bitstream writer: MSB-first bit writer, Exp-Golomb codes, and
NAL packaging with emulation prevention.

Functional equivalent of the reference's bit writer (`common/bs.h:74-274`)
and NAL escape (`common/common.c:658`), re-designed for a Python/C++ host:
the writer accumulates into a bytearray; the hot entropy path has a C++
twin in `native/` used when built.
"""

from __future__ import annotations


class BitWriter:
    """MSB-first bit writer (reference: upstream common/bs.h:74-245)."""

    __slots__ = ("_buf", "_acc", "_nbits")

    def __init__(self) -> None:
        self._buf = bytearray()
        self._acc = 0  # bit accumulator, MSB-aligned conceptually
        self._nbits = 0  # number of valid bits in _acc

    def write(self, n_bits: int, value: int) -> None:
        """Write ``n_bits`` of ``value`` (MSB first)."""
        # coerce numpy scalars: an np.int16 n_bits contaminates _acc /
        # _nbits with fixed-width ints that silently WRAP on a later
        # (acc << n) once past 2^15 — a real corruption observed when
        # entropy writers passed numpy level values through
        n_bits = int(n_bits)
        value = int(value)
        if n_bits == 0:
            return
        assert 0 <= value < (1 << n_bits), (n_bits, value)
        self._acc = (self._acc << n_bits) | value
        self._nbits += n_bits
        while self._nbits >= 8:
            self._nbits -= 8
            self._buf.append((self._acc >> self._nbits) & 0xFF)
        self._acc &= (1 << self._nbits) - 1

    def write1(self, bit: int) -> None:
        self.write(1, bit & 1)

    def write_ue(self, value: int) -> None:
        """Unsigned Exp-Golomb (reference: common/bs.h:214)."""
        assert value >= 0
        v = value + 1
        n = v.bit_length()
        self.write(2 * n - 1, v)

    def write_se(self, value: int) -> None:
        """Signed Exp-Golomb (reference: common/bs.h:219).

        Mapping: 0->0, 1->1, -1->2, 2->3, -2->4, ...
        """
        if value <= 0:
            self.write_ue(-2 * value)
        else:
            self.write_ue(2 * value - 1)

    def write_te(self, x: int, value: int) -> None:
        """Truncated Exp-Golomb: 1-bit inverted flag when range is [0,1]."""
        if x == 1:
            self.write1(1 - value)
        else:
            self.write_ue(value)

    def rbsp_trailing(self) -> None:
        """Stop bit + zero padding to byte boundary (common/bs.h:240)."""
        self.write1(1)
        if self._nbits:
            self.write(8 - self._nbits, 0)

    def bit_length(self) -> int:
        return 8 * len(self._buf) + self._nbits

    def byte_aligned(self) -> bool:
        return self._nbits == 0

    def get_bytes(self) -> bytes:
        assert self._nbits == 0, "bitstream not byte-aligned; call rbsp_trailing()"
        return bytes(self._buf)

    def partial_bytes(self) -> tuple[bytes, int]:
        """(bytes incl. zero-padded partial byte, exact bit count) — for
        handing a prefix to the native writer."""
        total = self.bit_length()
        buf = bytes(self._buf)
        if self._nbits:
            buf += bytes([(self._acc << (8 - self._nbits)) & 0xFF])
        return buf, total


def nal_escape(rbsp: bytes) -> bytes:
    """Insert emulation-prevention bytes (0x03) after any 0x0000 pair that
    would be followed by a byte <= 0x03 (reference: common/common.c:658).
    """
    out = bytearray()
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def nal_unescape(data: bytes) -> bytes:
    """Remove emulation-prevention bytes (decoder side)."""
    out = bytearray()
    zeros = 0
    i = 0
    n = len(data)
    while i < n:
        b = data[i]
        if zeros >= 2 and b == 3 and i + 1 < n and data[i + 1] <= 3:
            zeros = 0
            i += 1
            continue
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
        i += 1
    return bytes(out)


# NAL unit types (subset we emit)
NAL_SLICE = 1
NAL_SLICE_IDR = 5
NAL_SPS = 7
NAL_PPS = 8

# nal_ref_idc
NAL_PRIORITY_HIGHEST = 3
NAL_PRIORITY_HIGH = 2
NAL_PRIORITY_DISPOSABLE = 0


def nal_unit(nal_type: int, nal_ref_idc: int, rbsp: bytes,
             long_startcode: bool = True) -> bytes:
    """Package an RBSP into an Annex-B NAL unit with start code."""
    start = b"\x00\x00\x00\x01" if long_startcode else b"\x00\x00\x01"
    header = bytes([(nal_ref_idc << 5) | nal_type])
    return start + header + nal_escape(rbsp)


class BitReader:
    """MSB-first bit reader for the verification decoder."""

    __slots__ = ("_data", "_pos")

    def __init__(self, data: bytes) -> None:
        self._data = data
        self._pos = 0  # bit position

    def read(self, n_bits: int) -> int:
        v = 0
        for _ in range(n_bits):
            byte = self._data[self._pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self._pos & 7))) & 1)
            self._pos += 1
        return v

    def bit_position(self) -> int:
        return self._pos

    def read1(self) -> int:
        byte = self._data[self._pos >> 3]
        bit = (byte >> (7 - (self._pos & 7))) & 1
        self._pos += 1
        return bit

    def read_ue(self) -> int:
        zeros = 0
        while self.read1() == 0:
            zeros += 1
            assert zeros < 32, "corrupt exp-golomb"
        if zeros == 0:
            return 0
        return (1 << zeros) - 1 + self.read(zeros)

    def read_se(self) -> int:
        ue = self.read_ue()
        if ue & 1:
            return (ue + 1) >> 1
        return -(ue >> 1)

    def read_te(self, x: int) -> int:
        if x == 1:
            return 1 - self.read1()
        return self.read_ue()

    def byte_aligned(self) -> bool:
        return (self._pos & 7) == 0

    def more_rbsp_data(self) -> bool:
        """True if there is data beyond the rbsp_stop_one_bit."""
        total = 8 * len(self._data)
        if self._pos >= total:
            return False
        # find last set bit in the stream (the stop bit)
        last = total - 1
        while last >= 0:
            byte = self._data[last >> 3]
            if (byte >> (7 - (last & 7))) & 1:
                break
            last -= 1
        return self._pos < last

    @property
    def bit_pos(self) -> int:
        return self._pos
