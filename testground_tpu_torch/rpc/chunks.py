"""Chunk framing + writer/parser (a copy of ``testground_tpu/rpc/chunks.py``;
reference pkg/rpc/chunk.go:6-20,
writer.go:18-273, client-side parsers client.go:310-515).

Frame types, one JSON object per line:
  {"t": "p", "m": "<log line>"}     progress (human log output)
  {"t": "b", "d": "<base64>"}       binary payload fragment
  {"t": "r", "r": <json>}           result — exactly one per response
  {"t": "e", "e": "<message>"}      error  — exactly one, mutually exclusive
"""

from __future__ import annotations

import base64
import json
import threading
from dataclasses import dataclass
from typing import Any, Callable, Iterator, Optional

PROGRESS = "p"
BINARY = "b"
RESULT = "r"
ERROR = "e"


class RPCError(RuntimeError):
    """An error chunk received from the daemon."""


@dataclass
class Chunk:
    type: str
    payload: Any

    def encode(self) -> bytes:
        key = {PROGRESS: "m", BINARY: "d", RESULT: "r", ERROR: "e"}[self.type]
        payload = self.payload
        if self.type == BINARY:
            payload = base64.b64encode(payload).decode("ascii")
        return (json.dumps({"t": self.type, key: payload}) + "\n").encode()

    @classmethod
    def decode(cls, line: bytes | str) -> "Chunk":
        d = json.loads(line)
        t = d["t"]
        payload = d.get({PROGRESS: "m", BINARY: "d", RESULT: "r", ERROR: "e"}[t])
        if t == BINARY:
            payload = base64.b64decode(payload)
        return cls(t, payload)


class OutputWriter:
    """Multiplexes progress lines + binary fragments + one result/error onto
    a byte stream (reference writer.go:18-101,206-273). Thread-safe: engine
    workers and the handler may interleave writes.

    Also callable — ``ow("msg")`` — so it can stand in for the plain logging
    callables the engine passes around (``log(msg)``)."""

    def __init__(self, stream, also: Optional[Callable[[str], None]] = None):
        self._stream = stream
        self._also = also
        self._lock = threading.Lock()
        self._terminated = False

    def __call__(self, msg: str) -> None:
        self.info(msg)

    def _emit(self, chunk: Chunk) -> None:
        with self._lock:
            if self._terminated and chunk.type in (RESULT, ERROR):
                return  # exactly-one contract (writer.go:233-246)
            try:
                self._stream.write(chunk.encode())
                if hasattr(self._stream, "flush"):
                    self._stream.flush()
            except (BrokenPipeError, ConnectionError, OSError):
                return  # client went away; engine keeps running
            if chunk.type in (RESULT, ERROR):
                self._terminated = True

    def info(self, msg: str) -> None:
        if self._also is not None:
            self._also(msg)
        self._emit(Chunk(PROGRESS, msg))

    def binary(self, data: bytes) -> None:
        self._emit(Chunk(BINARY, data))

    def result(self, obj: Any) -> None:
        self._emit(Chunk(RESULT, obj))

    def error(self, msg: str) -> None:
        self._emit(Chunk(ERROR, msg))

    @property
    def terminated(self) -> bool:
        return self._terminated


class BinaryChunkWriter:
    """File-like that frames every write() as a binary chunk — lets
    ``tarfile`` stream an archive straight into the chunk protocol
    (reference common.go:42-113 → writer.go binary path)."""

    def __init__(self, ow: OutputWriter, chunk_size: int = 1 << 16):
        self._ow = ow
        self._buf = bytearray()
        self._chunk_size = chunk_size

    def write(self, data: bytes) -> int:
        self._buf.extend(data)
        while len(self._buf) >= self._chunk_size:
            self._ow.binary(bytes(self._buf[: self._chunk_size]))
            del self._buf[: self._chunk_size]
        return len(data)

    def flush(self) -> None:
        if self._buf:
            self._ow.binary(bytes(self._buf))
            self._buf.clear()


def parse_chunks(stream) -> Iterator[Chunk]:
    """Yields chunks from a readable byte stream (client side)."""
    for line in stream:
        line = line.strip()
        if line:
            yield Chunk.decode(line)


def read_response(
    stream,
    on_progress: Optional[Callable[[str], None]] = None,
    binary_sink=None,
) -> Any:
    """Consumes a chunk stream to completion; returns the result payload.
    Raises RPCError on an error chunk (reference ParseRunResponse et al.,
    client.go:310-515)."""
    result = None
    saw_result = False
    for c in parse_chunks(stream):
        if c.type == PROGRESS:
            if on_progress is not None:
                on_progress(c.payload)
        elif c.type == BINARY:
            if binary_sink is not None:
                binary_sink.write(c.payload)
        elif c.type == RESULT:
            result, saw_result = c.payload, True
        elif c.type == ERROR:
            raise RPCError(c.payload)
    if not saw_result:
        raise RPCError("stream ended without a result chunk")
    return result
