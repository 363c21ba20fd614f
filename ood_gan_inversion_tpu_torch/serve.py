"""Micro-batching inference server around the InversionEngine (counterpart
of serve.py), asyncio and the standard library only:

  * POST /invert with a raw float32 (H, W, 3) [0, 1] image body and its
    shape in an `x-shape` header (JSON "[H, W, 3]" or bare "H,W,3"); the
    reply body is the inverted image, then the mask, framed by the
    `x-shape`, `x-mask-shape` and `x-dtype` headers (`x-dtype: float16` in
    the request halves the reply bytes); GET /stats returns the counters;
  * a collector coalesces up to `max_batch` requests, or what arrives within
    `max_wait_ms` of the first, pads the group to a power of two and runs
    one batched per-seed forward (`InversionEngine._dispatch_perkey`) in a
    worker thread, with up to `max_inflight` batches in flight.

Every request carries the fixed seed 0, so a reply's noise, and with it the
reply, does not depend on the batch it landed in: the batched forward is
bit for bit the lone request's (infer.py's module docstring).

On the card, each batch is queued under one lock: its forward, then the
copy of its outputs into pinned host memory, then a completion event. A
second batch's work therefore sits behind the first's copy on the stream,
and a reply waits for its own event only, never for the batch queued after
it. A bfloat16 engine's replies cross the link in bfloat16 and are upcast
to float32 on the host: the same values, half the bytes.
"""

import asyncio
import json
import threading
import time

import numpy as np
import torch

from .utils.img_util import img2input


def _round_pow2(n):
    p = 1
    while p < n:
        p *= 2
    return p


class BatchingServer:
    # the reply is the inverted image and the OOD mask; the engine returns
    # only those outputs
    OUTPUTS = ("image", "mask")

    def __init__(self, engine, max_batch: int = 8, max_wait_ms: float = 5.0,
                 mesh=None, split_below: int = 0, fetch: str = "full",
                 staged_input=None, max_inflight: int = 1):
        """`split_below`: if > 1, a coalesced group of 2 .. split_below - 1
        requests is decoded one request at a time (the engine's split
        path, no padding) instead of as one padded batch: worth it where a
        batch of n costs more than n lone requests (run_serve.py derives its
        default from the card's batch curve, PERF.md).

        `fetch`: "full" replies carry the image and mask; "probe" replies
        carry a 1x1 probe (the corner pixel and its mask value), packed on
        the device into one (b, 4) float32 array: a measurement mode that
        runs the real collector, batching and split logic without the reply
        bytes.

        `staged_input`: one (H, W, 3) [0, 1] image put on the device once;
        every batch is then built from it on the device and request bodies
        are ignored. A measurement mode, with fetch="probe": neither request
        nor reply crosses the host link.

        `max_inflight`: coalesced batches in flight at once. 1 is lockstep
        (form, dispatch, await, repeat); 2 queues batch k + 1 while batch k
        runs, so the host's work on k + 1 (its input upload and the
        forward's launches) overlaps k's device time.

        `mesh`: sharding a batch over several devices is not ported."""
        if mesh is not None:
            raise NotImplementedError("mesh-sharded serving is not ported")
        if fetch not in ("full", "probe"):
            raise ValueError(f"fetch {fetch!r} not in ('full', 'probe')")
        self.engine = engine
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self.split_below = split_below
        self.fetch = fetch
        self._staged = None
        if staged_input is not None:
            self._staged = torch.from_numpy(
                img2input(staged_input, engine.out_size)).to(engine.device)
        self.max_inflight = max(1, int(max_inflight))
        self._dispatch_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._stats = {"requests": 0, "batches": 0, "padded": 0, "split": 0}
        self._queue = None
        self._collector_task = None

    # ------------------------------------------------------------- dispatch
    def _count(self, key, n):
        with self._stats_lock:
            self._stats[key] = self._stats.get(key, 0) + n

    def _batch_size_for(self, n):
        return min(_round_pow2(n), self.max_batch)

    def _inputs(self, imgs, b):
        """The (b, S, S, 3) batch on the engine's device: the staged image
        b times, or the request images."""
        if self._staged is not None:
            return self._staged.expand(b, -1, -1, -1).contiguous()
        return self.engine.input_batch(imgs)

    def _to_host(self, out):
        """Queues the copy of a dispatch's outputs to the host; returns
        (host tensors, completion event or None on the CPU)."""
        if self.fetch == "probe":
            img, msk = out["image"], out["mask"]
            parts = [img[:, 0, 0, :3].float()]
            if msk is not None:
                parts.append(msk[:, 0, 0].reshape(-1, 1).float())
            out = {"probe": torch.cat(parts, -1)}
        if self.engine.device.type != "cuda":
            return out, None
        host = {}
        for k, v in out.items():
            if v is not None:
                host[k] = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                host[k].copy_(v, non_blocking=True)
            else:
                host[k] = None
        done = torch.cuda.Event()
        done.record()
        return host, done

    def _reply_arrays(self, host):
        """Host tensors -> (image, mask) float32 numpy arrays."""
        def f32(t):
            return None if t is None else t.float().numpy()
        if self.fetch == "probe":
            p = f32(host["probe"])
            return (p[:, :3].reshape(-1, 1, 1, 3),
                    p[:, 3].reshape(-1, 1, 1) if p.shape[1] > 3 else None)
        return f32(host["image"]), f32(host["mask"])

    def _run_batch(self, imgs):
        """One coalesced group -> ((image, mask) arrays, group size). Runs in
        a worker thread."""
        n = len(imgs)
        split = 1 < n < self.split_below
        b = n if split else self._batch_size_for(n)
        with self._dispatch_lock:
            x = self._inputs(list(imgs) + list(imgs[-1:]) * (b - n), b)
            seeds = [0] * b
            if split:
                out = self.engine._dispatch_perkey_split(x, seeds, self.OUTPUTS)
            else:
                out = self.engine._dispatch_perkey(x, seeds, self.OUTPUTS)
            host, done = self._to_host(out)
        if done is not None:
            done.synchronize()
        if split:
            self._count("split", n)
        elif b > n:
            self._count("padded", b - n)
        return self._reply_arrays(host), n

    def warmup(self):
        """Runs every batch shape the server can dispatch once, on a blank
        image: the first call of a shape selects cuDNN's algorithms and
        grows the allocator's pools, and the first call at all builds the
        kernels. Returns the sizes. Safe to skip: the kernel build is
        locked, so concurrent first batches wait for one build."""
        size = self.engine.out_size
        dummy = np.zeros((size, size, 3), np.float32)
        sizes = {self._batch_size_for(n) for n in range(1, self.max_batch + 1)}
        if self.split_below > 2:
            sizes |= set(range(2, min(self.split_below, self.max_batch + 1)))
        sizes = sorted(sizes)
        for b in sizes:
            self._run_batch([dummy] * b)
        return sizes

    async def _complete(self, dispatch, batch, sem):
        """Awaits one in-flight dispatch and resolves its batch's futures."""
        try:
            (image, mask), n = await dispatch
        except Exception as e:
            # a bad request (shape mismatch, out of memory, ...) must not
            # kill the collector: fail this batch's futures, keep serving
            self._count("errors", len(batch))
            for _, fut in batch:
                if not fut.done():
                    fut.set_exception(RuntimeError(f"batch dispatch failed: {e!r}"))
            return
        finally:
            sem.release()
        self._count("requests", n)
        self._count("batches", 1)
        for i, (_, fut) in enumerate(batch):
            if not fut.done():
                fut.set_result((image[i], mask[i] if mask is not None else None))

    async def _collector(self):
        loop = asyncio.get_running_loop()
        sem = asyncio.Semaphore(self.max_inflight)
        pending = set()
        stopping = False
        while not stopping:
            first = await self._queue.get()
            if first is None:
                break
            batch = [first]
            deadline = time.monotonic() + self.max_wait_ms / 1000.0
            while len(batch) < self.max_batch:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    item = await asyncio.wait_for(self._queue.get(), timeout)
                except asyncio.TimeoutError:
                    break
                if item is None:
                    stopping = True   # answer this batch, then leave
                    break
                batch.append(item)
            # at most max_inflight dispatches; the next batch keeps
            # coalescing while earlier ones run
            await sem.acquire()
            dispatch = loop.run_in_executor(None, self._run_batch, [r[0] for r in batch])
            task = asyncio.ensure_future(self._complete(dispatch, batch, sem))
            pending.add(task)
            task.add_done_callback(pending.discard)
        if pending:
            await asyncio.gather(*list(pending))

    async def start(self):
        """Starts the collector on the running event loop, with a queue of
        its own (asyncio objects belong to the loop that first awaits
        them, so a server restarted under a new loop needs a new queue)."""
        if self._collector_task is not None and not self._collector_task.done():
            raise RuntimeError("server already started")
        self._queue = asyncio.Queue()
        self._collector_task = asyncio.create_task(self._collector())

    async def stop(self):
        """Answers what was queued, then stops the collector."""
        if self._collector_task is None:
            return
        await self._queue.put(None)
        task, self._collector_task = self._collector_task, None
        await task

    async def invert(self, img01: np.ndarray):
        """Submits one (H, W, 3) [0, 1] image; returns (image, mask) as
        float32 arrays. Raises unless the server was started (a request
        queued before start() would never be answered)."""
        if self._collector_task is None or self._collector_task.done():
            raise RuntimeError("BatchingServer.invert before start()")
        fut = asyncio.get_running_loop().create_future()
        await self._queue.put((img01, fut))
        return await fut

    @property
    def stats(self):
        with self._stats_lock:
            return dict(self._stats)

    # ------------------------------------------------------------------ http
    async def serve_http(self, host="127.0.0.1", port=8471):
        async def read_headers(reader):
            headers = {}
            while True:
                h = (await reader.readline()).decode().strip()
                if not h:
                    return headers
                k, _, v = h.partition(":")
                headers[k.strip().lower()] = v.strip()

        async def handle(reader, writer):
            try:
                line = await reader.readline()
                headers = await read_headers(reader)
                extra = b""
                if line.split()[0] == b"GET":
                    body = json.dumps(self.stats).encode()
                else:
                    hs = headers["x-shape"].strip()
                    shape = tuple(json.loads(hs) if hs.startswith("[")
                                  else (int(t) for t in hs.split(",")))
                    raw = await reader.readexactly(int(headers["content-length"]))
                    img = np.frombuffer(raw, np.float32).reshape(shape)
                    image, mask = await self.invert(img)
                    # only float16 and float32 replies: echoing another
                    # requested dtype over a float32 body would make a
                    # conforming client misread it
                    rdt = "float16" if headers.get("x-dtype") == "float16" else "float32"
                    image = image.astype(rdt)
                    mask = mask.astype(rdt) if mask is not None else None
                    body = image.tobytes() + (mask.tobytes() if mask is not None else b"")
                    extra = (b"x-shape: " + json.dumps(list(image.shape)).encode()
                             + b"\r\nx-dtype: " + rdt.encode() + b"\r\nx-mask-shape: "
                             + json.dumps(list(mask.shape) if mask is not None
                                          else None).encode() + b"\r\n")
                writer.write(b"HTTP/1.1 200 OK\r\n" + extra + b"content-length: "
                             + str(len(body)).encode() + b"\r\n\r\n" + body)
                await writer.drain()
            except Exception as e:  # the transport boundary: report, keep serving
                msg = repr(e).encode()
                try:
                    writer.write(b"HTTP/1.1 500 ERR\r\ncontent-length: "
                                 + str(len(msg)).encode() + b"\r\n\r\n" + msg)
                    await writer.drain()
                except ConnectionError:
                    pass
            finally:
                writer.close()

        await self.start()
        server = await asyncio.start_server(handle, host, port)
        try:
            async with server:
                await server.serve_forever()
        finally:
            await self.stop()
