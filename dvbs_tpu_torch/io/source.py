"""IQ sample sources: file (cf32/cs16/cs8) and UDP."""
from __future__ import annotations

import socket
import numpy as np


def read_iq_file(path: str, fmt: str = "cf32", count: int = -1,
                 offset: int = 0) -> np.ndarray:
    """Load interleaved IQ. fmt: cf32 | cs16 | cs8 | cu8."""
    if fmt == "cf32":
        raw = np.fromfile(path, np.float32, count * 2 if count > 0 else -1,
                          offset=offset * 8)
        return (raw[0::2] + 1j * raw[1::2]).astype(np.complex64)
    if fmt == "cs16":
        raw = np.fromfile(path, np.int16, count * 2 if count > 0 else -1,
                          offset=offset * 4)
        return ((raw[0::2] + 1j * raw[1::2]) / 32768.0).astype(np.complex64)
    if fmt == "cs8":
        raw = np.fromfile(path, np.int8, count * 2 if count > 0 else -1,
                          offset=offset * 2)
        return ((raw[0::2] + 1j * raw[1::2]) / 128.0).astype(np.complex64)
    if fmt == "cu8":
        raw = np.fromfile(path, np.uint8, count * 2 if count > 0 else -1,
                          offset=offset * 2).astype(np.float32) - 127.5
        return ((raw[0::2] + 1j * raw[1::2]) / 128.0).astype(np.complex64)
    raise ValueError(f"unknown IQ format {fmt}")


def write_iq_file(path: str, samples: np.ndarray, fmt: str = "cf32"):
    s = np.asarray(samples, np.complex64)
    if fmt == "cf32":
        out = np.empty(2 * len(s), np.float32)
        out[0::2], out[1::2] = s.real, s.imag
        out.tofile(path)
    else:
        raise ValueError(f"unsupported write format {fmt}")


def decode_iq_bytes(data: bytes, fmt: str = "cf32") -> np.ndarray:
    """Interleaved IQ bytes -> complex64 (same formats as read_iq_file)."""
    if fmt == "cf32":
        raw = np.frombuffer(data, np.float32)
        return (raw[0::2] + 1j * raw[1::2]).astype(np.complex64)
    if fmt == "cs16":
        raw = np.frombuffer(data, np.int16)
        return ((raw[0::2] + 1j * raw[1::2]) / 32768.0).astype(np.complex64)
    if fmt == "cs8":
        raw = np.frombuffer(data, np.int8)
        return ((raw[0::2] + 1j * raw[1::2]) / 128.0).astype(np.complex64)
    if fmt == "cu8":
        raw = np.frombuffer(data, np.uint8).astype(np.float32) - 127.5
        return ((raw[0::2] + 1j * raw[1::2]) / 128.0).astype(np.complex64)
    raise ValueError(f"unknown IQ format {fmt}")


class UDPSource:
    """Receive interleaved-IQ datagrams (live ingest — the framework's
    stand-in for the reference's SDR++ VFO stream).

    read() returns one datagram's samples, or None after `timeout`
    seconds of silence (None timeout = block forever)."""

    def __init__(self, port: int, host: str = "0.0.0.0",
                 fmt: str = "cf32", timeout: float | None = None):
        self.fmt = fmt
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        # a block decode can take a while (first block compiles) —
        # absorb the live stream in the kernel buffer meanwhile
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF,
                             16 << 20)
        self.sock.bind((host, port))
        if timeout is not None:
            self.sock.settimeout(timeout)

    def read(self, max_bytes: int = 65536) -> np.ndarray | None:
        try:
            data, _ = self.sock.recvfrom(max_bytes)
        except socket.timeout:
            return None
        return decode_iq_bytes(data, self.fmt)

    def close(self):
        self.sock.close()
