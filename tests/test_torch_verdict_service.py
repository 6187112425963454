"""The port's network verdict service (``verdict_service.py``) against
the JAX package's, over loopback on the CPU.

Both services (their native rings built with g++) serve engines loaded
with the same policy (``build_config1`` at 40 rules x 8 endpoints); the
same frames sent to each must get equal responses (tolerance 0).  Also
small frames answered in order, a frame larger than ``max_batch`` split
into several launches and reassembled, a protocol error dropping the
connection, and peer authentication.
"""

import socket
import struct
import threading

import numpy as np
import pytest
import torch

from cilium_tpu import verdict_service as ref_vs

from cilium_tpu_torch import native, verdict_service as vs

from test_torch_serving import chunk, load_pair, _SPORT


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def pair():
    ref, port, prefixes = load_pair()
    yield ref, port, prefixes
    for dp in (ref, port):
        if dp._serving is not None:
            dp._serving.close()


def records(c):
    n = len(c["sport"])
    recs = np.zeros(n, native.PKT_HEADER_DTYPE)
    for f in native.PKT_HEADER_DTYPE.names:
        recs[f] = c[f].view(np.uint32) if f in ("saddr", "daddr") \
            else c[f]
    return recs


def frames(seed, sizes, prefixes):
    """Record frames with source ports unique across the module; the
    same seed gives the same frames."""
    rng = np.random.default_rng(seed)
    return [records(chunk(rng, n, prefixes)) for n in sizes]


def serve_both(pair, fn, **svc_kw):
    """``fn(service)`` against the JAX package's service and the port's;
    returns both results."""
    out = []
    base = _SPORT[0]
    for mod, dp in ((ref_vs, pair[0]), (vs, pair[1])):
        _SPORT[0] = base
        svc = mod.VerdictService(dp, **svc_kw).start()
        try:
            out.append(fn(mod, svc))
        finally:
            svc.shutdown()
    return out


def test_struct_alignment_and_ring():
    native.check_struct_alignment()
    ring = native.PacketRing(capacity=64)
    try:
        recs = frames(1, [40], None)[0]
        assert ring.push(recs) == 40 and len(ring) == 40
        assert ring.push(recs) == 24 and ring.dropped == 16
        soa, n = ring.pop_batch(48)
        assert n == 48
        np.testing.assert_array_equal(soa["sport"][:40],
                                      recs["sport"].astype(np.int32))
        assert all(a.dtype == np.int32 for a in soa.values())
    finally:
        ring.close()


def test_responses_equal_reference(pair):
    def run(mod, svc):
        client = mod.VerdictClient("127.0.0.1", svc.port)
        try:
            return [client.classify(f)
                    for f in frames(3, (16, 1, 9, 16, 5), pair[2])]
        finally:
            client.close()

    got_ref, got = serve_both(pair, run)
    for (rv, ri), (v, i) in zip(got_ref, got):
        np.testing.assert_array_equal(v, rv)
        np.testing.assert_array_equal(i, ri)
    assert any((v >= 0).any() for v, _i in got)
    assert any((v < 0).any() for v, _i in got)


def test_small_frames_coalesce_and_answer_in_order(pair):
    """30 one-record frames from one client, and 4 clients of 10 frames
    from threads: every frame answered, in order, as the reference."""
    def run(mod, svc):
        client = mod.VerdictClient("127.0.0.1", svc.port)
        try:
            out = [client.classify(f)
                   for f in frames(5, [1] * 30, pair[2])]
        finally:
            client.close()
        per_thread = {}
        fs = {k: frames(50 + k, [1] * 10, pair[2]) for k in range(4)}

        def worker(k):
            c = mod.VerdictClient("127.0.0.1", svc.port)
            try:
                per_thread[k] = [c.classify(f) for f in fs[k]]
            finally:
                c.close()

        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        return out, [per_thread[k] for k in range(4)], svc.frames_served

    (ref_single, ref_multi, ref_served), (single, multi, served) = \
        serve_both(pair, run)
    assert served == ref_served == 70
    for a, b in zip(ref_single + sum(ref_multi, []),
                    single + sum(multi, [])):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])


def test_frame_larger_than_max_batch_splits_and_reassembles(pair):
    def run(mod, svc):
        client = mod.VerdictClient("127.0.0.1", svc.port)
        try:
            v, i = client.classify(frames(7, [200], pair[2])[0])
        finally:
            client.close()
        return v, i, svc.batches_dispatched

    (rv, ri, rb), (v, i, b) = serve_both(pair, run, max_batch=32)
    assert len(v) == 200 and b > 1 and rb > 1
    np.testing.assert_array_equal(v, rv)
    np.testing.assert_array_equal(i, ri)


def test_protocol_error_drops_the_connection(pair):
    """A bad magic, and a zero count, close the connection without a
    response, on both services."""
    def run(mod, svc):
        closed = []
        for head in (struct.pack(">III", 0xDEADBEEF, 1, 4),
                     struct.pack(">III", vs.MAGIC_REQ, 1, 0)):
            sock = socket.create_connection(("127.0.0.1", svc.port),
                                            timeout=10)
            try:
                sock.sendall(head + b"\0" * 96)
                closed.append(sock.recv(12) == b"")
            finally:
                sock.close()
        return closed

    assert serve_both(pair, run) == [[True, True], [True, True]]


def test_peer_authentication(pair):
    secret = b"shared-secret"

    def run(mod, svc):
        good = mod.VerdictClient("127.0.0.1", svc.port, secret=secret)
        try:
            v, i = good.classify(frames(9, [4], pair[2])[0])
        finally:
            good.close()
        with pytest.raises(mod.VerdictServiceError):
            mod.VerdictClient("127.0.0.1", svc.port, secret=b"wrong")
        return v, i

    (rv, ri), (v, i) = serve_both(pair, run, secret=secret)
    np.testing.assert_array_equal(v, rv)
    np.testing.assert_array_equal(i, ri)
    with pytest.raises(ValueError, match="requires a shared secret"):
        vs.VerdictService(pair[1], host="0.0.0.0")
    with pytest.raises(ValueError, match="non-empty"):
        vs.VerdictService(pair[1], secret=b"")
