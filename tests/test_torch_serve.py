"""The port's serving surface on the CPU: the batched per-seed decode of
InversionEngine and the micro-batching BatchingServer (serve.py), case by
case as tests/test_serve.py and tests/test_infer.py hold the JAX package's.

The engine is tests/test_serve.py's config without `n_mlp` (the port has no
style MLP), with the 4-unit IR-SE trunk and a quarter of the generator's
widths, so that a CPU forward takes about half a second. Replies are
compared with the engine's direct per-seed inversion of the same image bit
for bit, from a batched forward too: the port computes every op whose sums
depend on the batch size sample by sample (ops/batch_invariant.py), which
is stricter than JAX's bound for the contract (1e-5 of max|ref|)."""

import asyncio
import json
import socket
import sys
import threading

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torch_slots import batch_dependent_ops

from ood_gan_inversion_tpu_torch.infer import InversionEngine
from ood_gan_inversion_tpu_torch.nn.stylegan2 import NoiseInjection
from ood_gan_inversion_tpu_torch.ops import batch_invariant as bi
from ood_gan_inversion_tpu_torch.ops import cuda_call
from ood_gan_inversion_tpu_torch.serve import BatchingServer, _round_pow2

OPT = {"network_g": {
    "type": "ood_faceGAN_e4e", "out_size": 64, "style_dim": 512,
    "channel_multiplier": 1, "narrow": 0.25, "enable_modulation": True,
    "encoder_num_layers": 4,
    "modulation_type": "NOISE", "warp_scale": 0.08, "cycle_align": 1,
    "blend_with_gen": True, "ModSize": 32,
}}


@pytest.fixture(scope="module")
def engine():
    eng = InversionEngine(OPT, device="cpu")
    for m in eng.net.modules():        # make the noise matter
        if isinstance(m, NoiseInjection):
            m.weight.data.fill_(0.3)
    return eng


def images(n, seed):
    rs = np.random.RandomState(seed)
    return [rs.rand(64, 64, 3).astype(np.float32) for _ in range(n)]


def direct(engine, img):
    """The engine's direct per-seed inversion at the server's seed, 0."""
    return engine.invert(img, seed=0)


def assert_reply(reply, engine, img):
    image, mask = reply
    ref = direct(engine, img)
    want_img, want_mask = ref["image"][0].numpy(), ref["mask"][0].numpy()
    assert image.dtype == np.float32 and image.shape == want_img.shape
    np.testing.assert_array_equal(image, want_img)
    np.testing.assert_array_equal(mask, want_mask)


def serve(srv, imgs):
    async def run():
        await srv.start()
        outs = await asyncio.gather(*[srv.invert(im) for im in imgs])
        await srv.stop()
        return outs
    return asyncio.run(run())


# ------------------------------------------------------------ the engine

def test_invert_batch_perkey_slot_independent(engine):
    """A request's reply does not depend on its slot or on the batch size
    (tests/test_infer.py's case, with the port's seeds)."""
    a, b = images(2, 0)
    solo = engine.invert_batch_perkey([a], [0])
    quad = engine.invert_batch_perkey([b, b, b, a], [0, 0, 0, 0])
    for k in ("image", "gen_image", "mask", "lats"):
        assert torch.equal(quad[k][3], solo[k][0]), k
    # a lone request through invert_batch_perkey is invert itself
    assert torch.equal(solo["image"], engine.invert(a, seed=0)["image"])


def test_batched_equals_split(engine):
    """One batched forward against the requests decoded one by one: the same
    per-seed noise and batch-invariant ops, so the same replies bit for bit;
    the split path is the lone requests bit for bit."""
    imgs, seeds = images(3, 1), [5, 6, 7]
    batched = engine.invert_batch_perkey(imgs, seeds)
    split = engine.invert_batch_perkey_split(imgs, seeds)
    assert set(batched) == set(split)
    for k in ("image", "gen_image", "mask", "lats"):
        assert batched[k].shape == split[k].shape == (3,) + batched[k].shape[1:]
        assert torch.equal(batched[k], split[k]), k
    for i, (im, s) in enumerate(zip(imgs, seeds)):
        alone = engine.invert(im, seed=s)
        assert torch.equal(split["image"][i], alone["image"][0])
        assert torch.equal(split["aligns"][1][i], alone["aligns"][1][0])


@pytest.mark.parametrize("op", ["conv2d", "mean_hw", "sum_hw", "matmul"])
def test_batch_invariant_ops(op):
    """Each sample-by-sample op gives the plain op's values, and each row of
    a batch the bits of that row computed alone."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(5, 8, 12, 12, generator=g)
    w = torch.randn(6, 8, 3, 3, generator=g)
    m = torch.randn(12, 7, generator=g)
    fns = {"conv2d": (lambda v: bi.conv2d(v, w, padding=1),
                      lambda v: F.conv2d(v, w, padding=1)),
           "mean_hw": (lambda v: bi.mean_hw(v, keepdim=True),
                       lambda v: v.mean(dim=(2, 3), keepdim=True)),
           "sum_hw": (bi.sum_hw, lambda v: v.sum(dim=(2, 3))),
           "matmul": (lambda v: bi.matmul(v, m), lambda v: v @ m)}
    ours, plain = fns[op]
    out = ours(x)
    torch.testing.assert_close(out, plain(x), rtol=1e-5, atol=1e-5)
    for i in range(x.shape[0]):
        assert torch.equal(out[i:i + 1], ours(x[i:i + 1])), i
        assert torch.equal(out[i:i + 1], plain(x[i:i + 1])), i


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batched_forward_has_no_batch_dependent_op(dtype):
    """Every op of a batched per-seed forward gives each sample the bits of
    that sample computed alone (tests/torch_slots.py), in both dtypes."""
    eng = InversionEngine({"network_g": dict(OPT["network_g"], dtype=dtype)}, device="cpu")
    assert batch_dependent_ops(eng) == {}


def test_per_sample_slices_every_operand():
    a, b = torch.arange(6.0).reshape(3, 2), torch.arange(3.0).reshape(3, 1)
    calls = []

    def fn(u, v):
        calls.append(u.shape[0])
        return u * v

    assert torch.equal(bi.per_sample(fn, a, b), a * b)
    assert calls == [1, 1, 1]
    assert torch.equal(bi.per_sample(fn, a[:1], b[:1]), a[:1] * b[:1])


def test_outputs_subset_without_image(engine):
    imgs = images(2, 2)
    for fn in (engine.invert_batch_perkey, engine.invert_batch_perkey_split):
        out = fn(imgs, [1, 2], outputs=("mask",))
        assert set(out) == {"mask"} and out["mask"].shape == (2, 64, 64, 1)


def test_invert_batch_one_noise_stream(engine):
    """invert_batch draws one noise stream for the whole batch (JAX's one
    key): equal images in two slots get different noise, hence different
    replies; at batch 1 it is the per-seed path."""
    img = images(1, 3)[0]
    out = engine.invert_batch([img, img], seed=4)
    assert not torch.equal(out["image"][0], out["image"][1])
    one = engine.invert_batch([img], seed=4)
    assert torch.equal(one["image"], engine.invert(img, seed=4)["image"])


def test_launch_count_is_thread_safe():
    """The kernel wrappers' launch counts, incremented from several threads
    at a short switch interval, lose no update."""
    counter = type("Counter", (), {"launches": 0})
    n_threads, per_thread = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [cuda_call.count_launch(counter)
                                                    for _ in range(per_thread)])
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert counter.launches == n_threads * per_thread


# ------------------------------------------------------------ the server

def test_round_pow2():
    assert [_round_pow2(n) for n in (1, 2, 3, 4, 5, 8)] == [1, 2, 4, 4, 8, 8]


def test_concurrent_requests_are_batched(engine):
    srv = BatchingServer(engine, max_batch=4, max_wait_ms=50.0)
    imgs = images(5, 10)
    outs = serve(srv, imgs)
    assert len(outs) == 5
    # coalesced: 5 requests in at most 3 dispatches
    assert srv.stats["requests"] == 5
    assert srv.stats["batches"] <= 3
    for im, reply in zip(imgs, outs):
        assert_reply(reply, engine, im)


def test_invert_before_start_fails_fast(engine):
    """A request before start() (or after stop()) is refused at once; it
    would otherwise sit in a queue that no collector reads."""
    srv = BatchingServer(engine, max_batch=2)
    img = images(1, 11)[0]

    async def run():
        with pytest.raises(RuntimeError, match="before start"):
            await asyncio.wait_for(srv.invert(img), timeout=5)
        await srv.start()
        reply = await asyncio.wait_for(srv.invert(img), timeout=120)
        await srv.stop()
        with pytest.raises(RuntimeError, match="before start"):
            await asyncio.wait_for(srv.invert(img), timeout=5)
        return reply

    assert_reply(asyncio.run(run()), engine, img)


def test_dispatch_error_does_not_kill_collector(engine):
    srv = BatchingServer(engine, max_batch=2, max_wait_ms=5.0)
    good = images(1, 12)[0]
    bad = np.zeros((64, 64, 1), np.float32)  # wrong channel count

    async def run():
        await srv.start()
        with pytest.raises(RuntimeError, match="batch dispatch failed"):
            await srv.invert(bad)
        # the collector must still be alive and serve the next request
        image, _ = await asyncio.wait_for(srv.invert(good), timeout=120)
        await asyncio.wait_for(srv.stop(), timeout=30)
        return image

    image = asyncio.run(run())
    assert np.isfinite(image).all()
    assert srv.stats["errors"] == 1


def test_stop_during_coalesce_window_terminates(engine):
    # the shutdown sentinel must not be swallowed by the batch-collection
    # inner loop: stop() while a request is being coalesced must return
    srv = BatchingServer(engine, max_batch=4, max_wait_ms=2000.0)
    img = images(1, 13)[0]

    async def run():
        await srv.start()
        req = asyncio.create_task(srv.invert(img))
        await asyncio.sleep(0.1)  # the collector is inside the wait window
        await asyncio.wait_for(srv.stop(), timeout=120)
        return await req

    image, _ = asyncio.run(run())
    assert np.isfinite(image).all()


def test_warmup_runs_every_batch_shape(engine, monkeypatch):
    """warmup() runs each dispatchable batch size once; live traffic then
    dispatches only sizes it ran."""
    srv = BatchingServer(engine, max_batch=4, max_wait_ms=5.0)
    sizes_run = []
    real = engine._dispatch_perkey

    def spy(x, seeds, outputs=None):
        sizes_run.append(x.shape[0])
        return real(x, seeds, outputs)

    monkeypatch.setattr(engine, "_dispatch_perkey", spy)
    assert srv.warmup() == [1, 2, 4]
    assert sizes_run == [1, 2, 4]
    img = images(1, 14)[0]
    (image, _), = serve(srv, [img])
    assert np.isfinite(image).all()
    assert set(sizes_run) == {1, 2, 4}


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


async def http_invert(port, img, x_shape, dtype=None):
    """One POST /invert; returns (reply headers, image, mask)."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    body = img.tobytes()
    writer.write(b"POST /invert HTTP/1.1\r\nx-shape: " + x_shape.encode() + b"\r\n"
                 + (b"x-dtype: " + dtype.encode() + b"\r\n" if dtype else b"")
                 + b"content-length: " + str(len(body)).encode() + b"\r\n\r\n" + body)
    await writer.drain()
    assert b"200" in await reader.readline()
    hdrs = await read_headers(reader)
    dt = np.dtype(hdrs["x-dtype"])
    ishape = tuple(json.loads(hdrs["x-shape"]))
    mshape = json.loads(hdrs["x-mask-shape"])
    nb_img = int(np.prod(ishape)) * dt.itemsize
    image = np.frombuffer(await reader.readexactly(nb_img), dt).reshape(ishape)
    mask = None
    if mshape is not None:
        rest = int(hdrs["content-length"]) - nb_img
        mask = np.frombuffer(await reader.readexactly(rest), dt).reshape(tuple(mshape))
    writer.close()
    return hdrs, image, mask


async def read_headers(reader):
    hdrs = {}
    while True:
        h = (await reader.readline()).decode().strip()
        if not h:
            return hdrs
        k, _, v = h.partition(":")
        hdrs[k.strip().lower()] = v.strip()


def test_http_transport(engine):
    srv = BatchingServer(engine, max_batch=2, max_wait_ms=5.0)
    port = free_port()
    img = images(1, 15)[0]

    async def run():
        task = asyncio.create_task(srv.serve_http(port=port))
        await asyncio.sleep(0.3)
        hdrs, image, mask = await http_invert(port, img, json.dumps(list(img.shape)))
        assert hdrs["x-dtype"] == "float32"
        # stats endpoint
        r2, w2 = await asyncio.open_connection("127.0.0.1", port)
        w2.write(b"GET /stats HTTP/1.1\r\n\r\n")
        await w2.drain()
        assert b"200" in await r2.readline()
        h2 = await read_headers(r2)
        stats = json.loads(await r2.readexactly(int(h2["content-length"])))
        w2.close()
        # the bare comma x-shape form ("64,64,3") is accepted too
        _, image_c, _ = await http_invert(port, img, ",".join(map(str, img.shape)))
        # x-dtype: float16 reply negotiation (half the reply bytes)
        h16, img16, mask16 = await http_invert(port, img, json.dumps(list(img.shape)),
                                               "float16")
        assert h16["x-dtype"] == "float16" and img16.dtype == np.float16
        task.cancel()
        try:
            await task
        except asyncio.CancelledError:
            pass
        return image, mask, stats, image_c, img16, mask16

    image, mask, stats, image_c, img16, mask16 = asyncio.run(run())
    assert_reply((image, mask), engine, img)
    np.testing.assert_array_equal(image_c, image)
    # the float16 reply is the float32 reply rounded to float16
    np.testing.assert_array_equal(img16, image.astype(np.float16))
    np.testing.assert_array_equal(mask16, mask.astype(np.float16))
    assert stats["requests"] >= 1


def test_split_small_batches_matches_batched(engine):
    """split_below decodes 2 .. split_below - 1 coalesced requests one by one;
    its replies, and the batched policy's, equal the lone requests bit for
    bit."""
    srv_split = BatchingServer(engine, max_batch=4, max_wait_ms=30.0, split_below=4)
    srv_plain = BatchingServer(engine, max_batch=4, max_wait_ms=30.0)
    imgs = images(2, 16)
    outs_s = serve(srv_split, imgs)
    outs_p = serve(srv_plain, imgs)
    assert srv_split.stats["split"] == 2
    assert srv_plain.stats["split"] == 0
    for im, rs, rp in zip(imgs, outs_s, outs_p):
        assert_reply(rs, engine, im)
        assert_reply(rp, engine, im)


def test_probe_fetch_mode(engine):
    """fetch="probe" replies with 1x1 probes equal to the full reply's
    corner pixel and mask value, on the batched and the split paths."""
    imgs = images(3, 17)
    srv = BatchingServer(engine, max_batch=4, max_wait_ms=50.0, fetch="probe",
                         split_below=4)
    outs = serve(srv, imgs)
    assert srv.stats["split"] >= 2   # the split path ran at least once
    for im, (image, mask) in zip(imgs, outs):
        assert image.shape == (1, 1, 3) and mask.shape == (1, 1)
        ref = direct(engine, im)
        np.testing.assert_array_equal(image[0, 0], ref["image"][0, 0, 0].numpy())
        np.testing.assert_array_equal(mask[0, 0], ref["mask"][0, 0, 0, 0].numpy())


def test_staged_input_matches_upload_path(engine):
    """staged_input (one image put on the device once) gives the replies of
    uploading that image per request, on the batched and the split paths."""
    img = images(1, 18)[0]
    srv = BatchingServer(engine, max_batch=4, max_wait_ms=50.0, split_below=4,
                         staged_input=img)
    for n in (1, 2):                  # batched b=1 path, then split path
        for reply in serve(srv, [np.zeros((1, 1, 3), np.float32)] * n):
            assert_reply(reply, engine, img)
    assert srv.stats["split"] == 2


def test_pipelined_collector_matches_lockstep(engine):
    """max_inflight=2 overlaps dispatches; every reply still equals the
    direct per-seed inversion and the collector drains on stop."""
    imgs = images(4, 19)
    srv = BatchingServer(engine, max_batch=1, max_wait_ms=1.0, max_inflight=2)
    outs = serve(srv, imgs)
    assert srv.stats["batches"] == 4 and srv.stats["requests"] == 4
    for im, reply in zip(imgs, outs):
        assert_reply(reply, engine, im)


def test_mesh_is_not_ported(engine):
    with pytest.raises(NotImplementedError):
        BatchingServer(engine, mesh=object())
