"""Output sinks: UDP sender with the reference's chunking, file sink.

UDP semantics follow main.cpp:532-558: DVB-S sends raw TS bytes as
produced; DVB-S2 sends TS in 1880-byte (10-packet) chunks and forwards
GSE/GRE output as-is (one datagram per parser emission).
"""
from __future__ import annotations

import socket


class UDPSink:
    def __init__(self, hostname: str, port: int):
        self.addr = (hostname, port)
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._pending = bytearray()

    def send_raw(self, data: bytes):
        """DVB-S path: forward as-is (main.cpp:534-536)."""
        if data:
            self.sock.sendto(data, self.addr)

    def send_ts_chunked(self, data: bytes, chunk: int = 1880):
        """DVB-S2 TS path: accumulate and emit fixed 10-packet datagrams
        (main.cpp:541-549)."""
        self._pending.extend(data)
        while len(self._pending) >= chunk:
            self.sock.sendto(bytes(self._pending[:chunk]), self.addr)
            del self._pending[:chunk]

    def close(self):
        self.sock.close()


class FileSink:
    def __init__(self, path: str):
        self.f = open(path, "wb")

    def send_raw(self, data: bytes):
        self.f.write(data)

    send_ts_chunked = send_raw

    def close(self):
        self.f.close()
