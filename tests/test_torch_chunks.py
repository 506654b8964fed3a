"""The port's chunked RPC frames (testground_tpu_torch/rpc/chunks.py)
against the JAX package's, across both packages' writers and readers:
every frame type round-trips, a tar.gz streamed through
``BinaryChunkWriter`` comes back byte for byte, the exactly-one-result
contract holds, an error frame raises with its message and a stream cut
before its result raises."""

import _torch_threads  # noqa: F401  (caps torch's CPU threads)
import io
import tarfile

import pytest

from testground_tpu.rpc import chunks as jchunks
from testground_tpu_torch.rpc import chunks as tchunks

PKGS = {"jax": jchunks, "port": tchunks}
PAIRS = [(w, r) for w in PKGS for r in PKGS]


def _stream(writer_pkg, write):
    buf = io.BytesIO()
    write(PKGS[writer_pkg].OutputWriter(buf))
    buf.seek(0)
    return buf


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_every_frame_round_trips(writer, reader):
    def write(ow):
        ow.info("hello")
        ow("via call")
        ow.binary(b"\x00\x01\xff")
        ow.binary(b"")
        ow.result({"x": 1, "nested": [1, "two", None]})

    buf = _stream(writer, write)
    raw = buf.getvalue()
    # the same bytes from either writer
    assert raw == _stream("jax", write).getvalue()
    frames = [PKGS[reader].Chunk.decode(line) for line in buf if line.strip()]
    assert [c.type for c in frames] == ["p", "p", "b", "b", "r"]
    assert frames[2].payload == b"\x00\x01\xff"
    buf.seek(0)
    progress, sink = [], io.BytesIO()
    got = PKGS[reader].read_response(buf, on_progress=progress.append,
                                     binary_sink=sink)
    assert got == {"x": 1, "nested": [1, "two", None]}
    assert progress == ["hello", "via call"]
    assert sink.getvalue() == b"\x00\x01\xff"


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_a_tarball_streams_through_binary_frames(writer, reader, tmp_path):
    (tmp_path / "run").mkdir()
    (tmp_path / "run" / "results.out").write_bytes(bytes(range(256)) * 900)
    buf = io.BytesIO()
    ow = PKGS[writer].OutputWriter(buf)
    w = PKGS[writer].BinaryChunkWriter(ow, chunk_size=4096)
    with tarfile.open(fileobj=w, mode="w|gz") as tf:
        tf.add(str(tmp_path / "run"), arcname="run")
    w.flush()
    ow.result({"exists": True})
    buf.seek(0)
    sink = io.BytesIO()
    assert PKGS[reader].read_response(buf, binary_sink=sink) == {
        "exists": True}
    sink.seek(0)
    with tarfile.open(fileobj=sink, mode="r:gz") as tf:
        data = tf.extractfile("run/results.out").read()
    assert data == bytes(range(256)) * 900


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_exactly_one_result_and_errors(writer, reader):
    def two_results(ow):
        ow.result({"first": True})
        ow.result({"second": True})
        ow.error("late error")
        assert ow.terminated

    assert PKGS[reader].read_response(_stream(writer, two_results)) == {
        "first": True}

    def error(ow):
        ow.info("working...")
        ow.error("boom")

    progress = []
    with pytest.raises(PKGS[reader].RPCError, match="boom"):
        PKGS[reader].read_response(_stream(writer, error),
                                   on_progress=progress.append)
    assert progress == ["working..."]

    def cut(ow):
        ow.info("only progress, no result")

    with pytest.raises(PKGS[reader].RPCError,
                       match="stream ended without a result chunk"):
        PKGS[reader].read_response(_stream(writer, cut))
