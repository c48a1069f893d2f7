"""Dual-ended bitstream reader/writer.

LC3 frames are written from both ends: side info as bits from the last byte
backwards, arithmetic-coder bytes from byte 0 forwards, meeting in the
middle (reference decoder/buffer_reader.rs, encoder/buffer_writer.rs).
"""

from __future__ import annotations


class BitstreamError(Exception):
    pass


class BufferReader:
    """Big-endian dual-cursor reader (decoder/buffer_reader.rs:11-115)."""

    def __init__(self, head_byte_cursor: int = 0, tail_bit_cursor: int = 0):
        self.head = head_byte_cursor
        self.tail = tail_bit_cursor

    def read_head_byte(self, buf: bytes) -> int:
        if self.head >= len(buf):
            raise BitstreamError(f"head byte read out of bounds at {self.head}")
        b = buf[self.head]
        self.head += 1
        return b

    def read_head_u24(self, buf: bytes) -> int:
        if self.head + 2 >= len(buf):
            raise BitstreamError(f"head u24 read out of bounds at {self.head}")
        v = (buf[self.head] << 16) | (buf[self.head + 1] << 8) | buf[self.head + 2]
        self.head += 3
        return v

    def read_tail_uint(self, buf: bytes, num_bits: int) -> int:
        byte_index, bit_index = divmod(self.tail, 8)
        bits_left = 8 - bit_index
        add_bytes = 2 if (num_bits > bits_left and num_bits < 8) else 1
        num_bytes = num_bits // 8 + add_bytes
        if len(buf) - self.head - byte_index - num_bytes < 0:
            raise BitstreamError(f"tail read of {num_bits} bits out of range")
        start = len(buf) - byte_index - num_bytes
        value = int.from_bytes(buf[start : start + num_bytes], "big")
        value >>= bit_index
        value &= (1 << num_bits) - 1
        self.tail += num_bits
        return value

    def read_tail_bool(self, buf: bytes) -> bool:
        byte_index, bit_index = divmod(self.tail, 8)
        if len(buf) - self.head - byte_index + 2 < 0:
            raise BitstreamError("tail bool read out of range")
        byte = buf[len(buf) - byte_index - 1]
        self.tail += 1
        return (byte >> bit_index) & 1 == 1


class BufferWriter:
    """Mirror writer: tail bits backward + head bytes forward
    (encoder/buffer_writer.rs:19-66)."""

    def __init__(self, nbytes: int):
        self.buf = bytearray(nbytes)
        self.head = 0
        self.tail = 0

    def write_tail_uint(self, value: int, num_bits: int) -> None:
        for _ in range(num_bits):
            self.write_tail_bool(value & 1)
            value >>= 1

    def write_tail_bool(self, bit: int | bool) -> None:
        byte_index, bit_index = divmod(self.tail, 8)
        pos = len(self.buf) - byte_index - 1
        if bit:
            self.buf[pos] |= 1 << bit_index
        self.tail += 1

    def write_head_byte(self, byte: int) -> None:
        self.buf[self.head] = byte & 0xFF
        self.head += 1

    def write_byte_at(self, pos: int, byte: int) -> None:
        self.buf[pos] = byte & 0xFF
