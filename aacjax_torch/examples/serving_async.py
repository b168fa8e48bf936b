#!/usr/bin/env python3
"""Asyncio AAC decode server on aacjax_torch (counterpart of
examples/serving_async.py): many concurrent TCP clients multiplexed
onto ONE BatchDecoder, with live join/leave via deferred slot recycling
(`request_reset`) while the 3-stage decode pipeline stays in flight.

Protocol (per connection):
    client -> server:  raw ADTS bytes, streamed; half-close (EOF on the
                       write side) when done
    server -> client:  b"AACS" + u32 sample_rate + u8 channels, then per
                       decoded chunk u32 byte-count + interleaved int16
                       PCM; connection closes after the tail flush

Serving model (the part a real deployment copies):
  - one decode thread runs `BatchDecoder.decode_pipelined` over a
    blocking chunk queue — parse, H2D+dispatch and D2H overlap across
    chunks exactly as in the bench path;
  - an asyncio tick assembles each chunk from whatever frames clients
    have buffered (0..T per slot).  Idle slots ride as `None`: the
    device-side validity mask freezes their overlap state
    (kernels/pipeline.py `last_valid`), so a slow client resumes
    mid-stream without a glitch;
  - a join takes a free slot and `request_reset(slot)` — applied by the
    pipeline at the next chunk boundary, so chunks already in flight
    decode with the old state and the newcomer starts exactly like a
    fresh decoder (tests/test_runtime.py::test_request_reset_mid_pipeline).

    python -m aacjax_torch.examples.serving_async --port 9471  # serve
    python -m aacjax_torch.examples.serving_async --selftest   # demo clients
    (add --device cpu to run without CUDA)
"""
from __future__ import annotations

import argparse
import asyncio
import queue
import struct
import threading

import numpy as np

from aacjax_torch.host import adts
from aacjax_torch.host.asc import StreamConfig, make_asc, parse_asc
from aacjax_torch.runtime.batch import BatchDecoder

MAGIC = b"AACS"


class _Slot:
    __slots__ = ("active", "draining", "buf", "frames", "out_q", "fresh",
                 "pending")

    def __init__(self):
        self.active = False
        self.draining = False     # client EOF'd; flush remaining frames
        self.buf = bytearray()    # undelimited ADTS bytes
        self.frames = []          # complete raw_data_block payloads
        self.out_q: asyncio.Queue | None = None
        self.fresh = False        # joined since the last chunk
        self.pending = 0          # chunks in flight carrying our frames


class AsyncAACServer:
    """One BatchDecoder serving up to n_slots concurrent clients."""

    def __init__(self, config: StreamConfig | None = None,
                 n_slots: int = 8, chunk_frames: int = 8,
                 tick_s: float = 0.02, device: str = "cuda"):
        self.config = config or parse_asc(make_asc(2, 4, 2))
        self.n_slots = n_slots
        self.T = chunk_frames
        self.tick_s = tick_s
        self.device = device
        self.dec = BatchDecoder([self.config] * n_slots,
                                chunk_frames=chunk_frames, device=device)
        self.slots = [_Slot() for _ in range(n_slots)]
        self._in_q: queue.Queue = queue.Queue(maxsize=4)
        self._meta: list[list[int]] = []   # frames fed per slot, FIFO
        self._meta_lock = threading.Lock()
        self._loop: asyncio.AbstractEventLoop | None = None
        self._decode_thread: threading.Thread | None = None
        self._stopped = False

    # -- decode thread -------------------------------------------------------
    def _chunk_source(self):
        while True:
            item = self._in_q.get()
            if item is None:
                return
            yield item

    def _decode_loop(self):
        ch = self.config.channels
        for pcm in self.dec.decode_pipelined(self._chunk_source(),
                                             out_int16=True):
            with self._meta_lock:
                counts = self._meta.pop(0)
            arr = np.asarray(pcm)     # [slots, T, frame] int16
            arr = arr.reshape(arr.shape[0], -1)
            blocks: list[bytes | None] = []
            for i, n_frames in enumerate(counts):
                if n_frames <= 0:
                    blocks.append(None)
                    continue
                base = self.dec.streams[i].base_slot
                n = n_frames * self.config.frame_length
                blocks.append(np.ascontiguousarray(
                    arr[base:base + ch, :n].T).tobytes())  # interleaved
            if self._loop is not None and not self._stopped:
                try:
                    self._loop.call_soon_threadsafe(self._deliver, blocks)
                except RuntimeError:
                    return  # loop closed during shutdown

    def _deliver(self, blocks: list[bytes | None]) -> None:
        """Runs on the event loop: hand each slot its chunk's PCM and
        close out slots whose tail has fully flushed."""
        for i, data in enumerate(blocks):
            slot = self.slots[i]
            if data is None:
                continue
            slot.pending -= 1
            if slot.out_q is not None:
                slot.out_q.put_nowait(data)
            self._maybe_close(i)

    def _maybe_close(self, i: int) -> None:
        slot = self.slots[i]
        if (slot.active and slot.draining and not slot.frames
                and not slot.buf and slot.pending == 0):
            slot.active = False
            slot.draining = False
            if slot.out_q is not None:
                slot.out_q.put_nowait(None)   # tail delivered — close

    # -- chunk assembly ------------------------------------------------------
    def _assemble_tick(self):
        """Build one chunk from buffered frames if anyone has work."""
        if self._in_q.full():
            return
        payloads: list[list[bytes] | None] = []
        counts = []
        any_work = False
        for i, slot in enumerate(self.slots):
            if slot.active and slot.fresh:
                # newcomer: clear the recycled slot's decoder state at
                # the next chunk boundary
                self.dec.request_reset(i)
                slot.fresh = False
            take = min(len(slot.frames), self.T) if slot.active else 0
            if take:
                payloads.append(slot.frames[:take])
                del slot.frames[:take]
                slot.pending += 1
                any_work = True
            else:
                payloads.append(None)
                self._maybe_close(i)   # EOF with nothing left in flight
            counts.append(take)
        if not any_work:
            # the 3-stage pipeline holds 2 chunks in flight and only
            # yields when a newer chunk is pulled — push all-idle chunks
            # through while deliveries are outstanding so tails drain
            if not any(sl.pending > 0 for sl in self.slots):
                return
        with self._meta_lock:
            self._meta.append(counts)
        self._in_q.put(payloads)

    async def _ticker(self):
        while not self._stopped:
            self._assemble_tick()
            await asyncio.sleep(self.tick_s)

    # -- connections ---------------------------------------------------------
    def _alloc_slot(self) -> int | None:
        for i, s in enumerate(self.slots):
            # pending==0: an abruptly-dropped client's in-flight chunks
            # must land (and be discarded) before the slot is reused
            if not s.active and s.out_q is None and s.pending == 0:
                s.active = True
                s.draining = False
                s.buf = bytearray()
                s.frames = []
                s.out_q = asyncio.Queue()
                s.fresh = True
                return i
        return None

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter):
        idx = self._alloc_slot()
        if idx is None:
            writer.close()
            return
        slot = self.slots[idx]
        writer.write(MAGIC + struct.pack(
            "<IB", self.config.sample_rate, self.config.channels))

        async def pump_out():
            q = slot.out_q
            while True:
                data = await q.get()
                if data is None:
                    break
                writer.write(struct.pack("<I", len(data)) + data)
                await writer.drain()

        out_task = asyncio.ensure_future(pump_out())
        try:
            while True:
                data = await reader.read(65536)
                if not data:
                    slot.draining = True
                    break
                slot.buf.extend(data)
                ranges = adts.split_frames(bytes(slot.buf))
                if ranges:
                    slot.frames.extend(
                        bytes(slot.buf[s:e]) for _, s, e in ranges)
                    del slot.buf[: ranges[-1][2]]
            await out_task
        finally:
            out_task.cancel()
            slot.active = False
            slot.draining = False
            slot.frames = []
            slot.buf = bytearray()
            slot.out_q = None
            writer.close()

    # -- lifecycle -----------------------------------------------------------
    async def start(self, host: str = "127.0.0.1", port: int = 0):
        self._loop = asyncio.get_running_loop()
        self._decode_thread = threading.Thread(target=self._decode_loop,
                                               daemon=True)
        self._decode_thread.start()
        self._tick_task = asyncio.ensure_future(self._ticker())
        self.server = await asyncio.start_server(self._handle, host, port)
        return self.server.sockets[0].getsockname()[1]

    async def stop(self):
        self._stopped = True
        self._tick_task.cancel()
        self.server.close()
        await self.server.wait_closed()
        self._in_q.put(None)
        await asyncio.get_running_loop().run_in_executor(
            None, self._decode_thread.join, 30)


# -- demo / selftest ---------------------------------------------------------
async def _client(port: int, stream: bytes, delay_s: float = 0.0
                  ) -> np.ndarray:
    """Send one ADTS stream, return the decoded interleaved int16 PCM."""
    if delay_s:
        await asyncio.sleep(delay_s)
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    hdr = await reader.readexactly(9)
    assert hdr[:4] == MAGIC
    ch = hdr[8]

    async def send():
        for off in range(0, len(stream), 4096):
            writer.write(stream[off:off + 4096])
            await writer.drain()
            await asyncio.sleep(0.001)
        writer.write_eof()

    send_task = asyncio.ensure_future(send())
    blocks = []
    while True:
        try:
            n = struct.unpack("<I", await reader.readexactly(4))[0]
        except asyncio.IncompleteReadError:
            break
        blocks.append(await reader.readexactly(n))
    await send_task
    writer.close()
    pcm = np.frombuffer(b"".join(blocks), np.int16)
    return pcm.reshape(-1, ch)


def _demo_stream(f0: float, seconds: float, config) -> bytes:
    from aacjax_torch.testing.encoder import encode_pcm
    sr = config.sample_rate
    t = np.arange(int(seconds * sr) // 1024 * 1024) / sr
    x = 8000 * np.sin(2 * np.pi * f0 * t)
    return encode_pcm(np.stack([x, 0.8 * x], axis=1), config,
                      target_sf=130)


async def _selftest(device: str) -> int:
    server = AsyncAACServer(n_slots=4, chunk_frames=4, device=device)
    port = await server.start()
    cfg = server.config
    streams = [_demo_stream(f0, 1.5, cfg) for f0 in (440, 660, 880)]
    # two clients live concurrently; the third joins later and lands on
    # a recycled slot mid-pipeline
    a, b = await asyncio.gather(
        _client(port, streams[0]), _client(port, streams[1]))
    c = await _client(port, streams[2])
    await server.stop()
    for name, pcm, stream in (("a", a, streams[0]), ("b", b, streams[1]),
                              ("c", c, streams[2])):
        solo = BatchDecoder([cfg], chunk_frames=4, device=device)
        frames = [stream[s:e] for _, s, e in adts.split_frames(stream)]
        want = []
        for i in range(0, len(frames), 4):
            out = np.asarray(solo.step_raw([frames[i:i + 4]],
                                           out_int16=True))
            out = out.reshape(out.shape[0], -1)   # [slots, T*F]
            want.append(out[:2, :len(frames[i:i + 4]) * 1024])
        want = np.concatenate(want, axis=1).T
        got = pcm[: want.shape[0]]
        err = np.abs(got.astype(np.int32) - want.astype(np.int32)).max()
        print(f"client {name}: {pcm.shape[0]} samples, "
              f"max abs int16 err vs solo decode = {err}")
        # on the card each frame's PCM is computed alone, so the client's
        # PCM must equal the solo decode bit for bit; the CPU's plain
        # dense IMDCT product sums in an order that depends on the batch's
        # row count, so there the reference's 1-LSB rule holds
        limit = 0 if server.dec.device.type == "cuda" else 1
        if got.shape != want.shape or err > limit:
            raise SystemExit(f"client {name}: PCM differs from its solo "
                             f"decode (shape {got.shape} vs {want.shape}, "
                             f"max err {err} > {limit})")
    print("asyncio serving selftest OK")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=9471)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--selftest", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device to decode on (cuda or cpu)")
    args = ap.parse_args()
    if args.selftest:
        return asyncio.run(_selftest(args.device))

    async def serve():
        server = AsyncAACServer(n_slots=args.slots, device=args.device)
        port = await server.start(port=args.port)
        print(f"serving {args.slots} slots on 127.0.0.1:{port}")
        await asyncio.Event().wait()

    asyncio.run(serve())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
