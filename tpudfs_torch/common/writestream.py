"""Sub-block frame protocol for streaming chain writes — the client half of
``tpudfs/common/writestream.py``, the port's own copy.

A replicated block of at least :data:`MIN_STREAM_BYTES` is cut into
:data:`FRAME_SIZE` frames and pipelined through the chain over the first
hop's blockport, so network receive, CRC, disk append and forwarding
overlap at frame granularity. The wire format (over the blockport framing
of :mod:`tpudfs_torch.common.blocknet`):

1. begin (client -> hop): ``{"m": "WriteStream", "block_id", "size",
   "frame_size", "expected_crc32c", "master_term", "master_shard",
   "next_servers", "next_data_ports"}``, no payload; ``_db`` and ``_tn``
   ride as on any blockport request.
2. ready (hop -> client): ``{"ok": True, "ready": 1}``. An error frame here
   leaves the connection in sync; the client falls back to the
   whole-block path.
3. frames (client -> hop): ``ceil(size / frame_size)`` data frames with
   header ``{"q": seq, "c": crc32c(frame)}``, pipelined without waiting
   for acks.
4. watermark acks (hop -> client): ``{"ok": True, "w": n}``, MAX-merged.
5. final (hop -> client): ``{"ok": True, "final": 1, "success",
   "error_message", "replicas_written"}``, once the block is durable down
   the whole chain.

An error frame after any data frame means the stream cannot resync: the
connection is closed. The hop's relay leg (``ForwardStream``) is server
code and not here.
"""

from __future__ import annotations

import asyncio

from tpudfs_torch.common.blocknet import (
    _drain_backpressure,
    _error_from_header,
    _pack_frame,
    _read_frame,
)
from tpudfs_torch.common.checksum import crc32c
from tpudfs_torch.common.rpc import RpcError

#: Frame payload size.
FRAME_SIZE = 256 * 1024

#: Blocks below this ride the whole-block path: a 2-frame stream pays the
#: begin/ready round trip without overlapping anything.
MIN_STREAM_BYTES = 2 * FRAME_SIZE

#: Streamed-block ceiling (each frame is bounded by frame_size instead of
#: the 100 MiB message cap).
MAX_STREAM_BYTES = 1 << 30


def frame_count(size: int, frame_size: int = FRAME_SIZE) -> int:
    return max(1, (size + frame_size - 1) // frame_size)


def begin_header(block_id: str, size: int, *, expected_crc32c: int,
                 master_term: int, master_shard: str,
                 next_servers: list[str], next_data_ports: list[int],
                 frame_size: int = FRAME_SIZE) -> dict:
    return {
        "m": "WriteStream",
        "block_id": block_id,
        "size": size,
        "frame_size": frame_size,
        "expected_crc32c": expected_crc32c,
        "master_term": master_term,
        "master_shard": master_shard,
        "next_servers": next_servers,
        "next_data_ports": next_data_ports,
    }


async def send_block_stream(r: asyncio.StreamReader, w: asyncio.StreamWriter,
                            begin: dict, data) -> dict:
    """The client's sender over an open blockport connection: begin, wait
    for ready, pipeline the frames while a reader task folds watermark acks
    (max-merge), return the final response (with the observed watermark as
    ``_watermark``). Protocol errors raise RpcError whose ``stream_clean``
    says whether the connection is still in sync."""
    size = int(begin["size"])
    frame_size = int(begin["frame_size"])
    nframes = frame_count(size, frame_size)
    w.writelines(_pack_frame(dict(begin), None))
    await w.drain()
    try:
        h, _ = await _read_frame(r)
    except (asyncio.IncompleteReadError, ConnectionError) as e:
        raise ConnectionError(f"write stream begin failed: {e!r}") from None
    if not h.pop("ok", False):
        err = _error_from_header(h)
        err.stream_clean = True  # no data frames sent: conn in sync
        raise err
    if not h.get("ready"):
        raise ConnectionError("write stream peer sent no ready ack")

    watermark = 0

    async def _read_acks() -> dict:
        nonlocal watermark
        while True:
            hh, _ = await _read_frame(r)
            if not hh.pop("ok", False):
                raise _error_from_header(hh)
            if hh.get("final"):
                return hh
            watermark = max(watermark, int(hh.get("w") or 0))

    mv = memoryview(data)
    sent_any = False
    reader = asyncio.create_task(_read_acks())
    try:
        for seq in range(nframes):
            if reader.done():
                # Early error or final from the hop: stop pushing frames.
                break
            frame = mv[seq * frame_size:min((seq + 1) * frame_size, size)]
            w.writelines(_pack_frame({"q": seq, "c": crc32c(frame)}, frame))
            sent_any = True
            await _drain_backpressure(w)
        await w.drain()
        final = await reader
    except RpcError as e:
        e.stream_clean = not sent_any
        raise
    except (ConnectionError, OSError, asyncio.IncompleteReadError):
        # The hop tore the connection mid-stream; if its error frame got
        # through first, surface that instead of the transport failure.
        if not reader.done():
            reader.cancel()
        try:
            final = await reader
        except RpcError as e:
            e.stream_clean = False
            raise
        except (Exception, asyncio.CancelledError):
            raise ConnectionError("write stream torn mid-frame") from None
    finally:
        reader.cancel()
    final["_watermark"] = max(watermark, int(final.get("w") or 0))
    return final
