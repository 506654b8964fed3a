"""Chunked daemon→client streaming protocol (a copy of
``testground_tpu.rpc``; reference pkg/rpc/).

The reference multiplexes a log stream, binary payloads, and exactly one
result (or error) over a single HTTP response as JSON frames
``Chunk{t: p|b|r|e}`` (pkg/rpc/chunk.go:6-20, writer.go:18-101). We keep
the same frame alphabet over newline-delimited JSON, which HTTP chunked
transfer carries natively.
"""

from .chunks import (
    Chunk,
    OutputWriter,
    RPCError,
    parse_chunks,
    read_response,
)

__all__ = [
    "Chunk",
    "OutputWriter",
    "RPCError",
    "parse_chunks",
    "read_response",
]
