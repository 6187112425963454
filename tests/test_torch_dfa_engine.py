"""The quantized, depth-reduced DFA engine: JAX package vs port.

``DFAEngine`` of both packages, built with the same ``prefer``,
``dtype``, ``stride_budget`` and ``on_accel``, must select the same
strategy, stride and dtype, and give the same bits (tolerance 0) through
``match``, ``encode`` -> ``match_encoded`` and a chunked ``scan``, on
ragged, row-padded, mid-row negative and overlong rows.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cilium_tpu.compiler import regexc as ref_rx
from cilium_tpu.ops import dfa_engine as ref_eng
from cilium_tpu.ops import dfa_ops as ref_ops

from cilium_tpu_torch.compiler import regexc as rx
from cilium_tpu_torch.ops import dfa_engine as eng
from cilium_tpu_torch.ops import dfa_ops as ops

PATTERNS = ["GET", "/public/.*", "/api/v[0-9]+/users/[0-9]+",
            ".*admin.*", "POST|PUT", "a{2,4}b*", "[^/]+/[^/]+"]
TEXTS = ["GET", "POST", "/public/index.html", "/public/",
         "/api/v2/users/42", "/api/vX/users/1", "xadminy", "admin",
         "aab", "aaaaab", "ab", "foo/bar", "a/b/c", "", "x" * 200,
         "GET /", "aa", "aaaa"]
LENGTH = 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def compiled():
    return rx.compile_regex_set(PATTERNS), ref_rx.compile_regex_set(PATTERNS)


@pytest.fixture(scope="module")
def block():
    """Ragged and overlong rows padded to 32 by ``bucket_rows``, with
    negative bytes in the middle of two rows."""
    data = ops.bucket_rows(ops.encode_strings(TEXTS, LENGTH), 32)
    data[0, 1] = -1
    data[4, 3] = -1
    return data


def _pair(compiled, **kw):
    got_c, want_c = compiled
    return (eng.DFAEngine(got_c, device="cpu", **kw),
            ref_eng.DFAEngine(want_c, **kw))


def _same_selection(port, ref):
    assert port.describe() == ref.describe()
    assert (port.strategy, port.k) == (ref.strategy, ref.k)


@pytest.mark.parametrize("budget", [1, 4 << 20])
@pytest.mark.parametrize("dtype", [np.int8, np.int16, np.int32])
@pytest.mark.parametrize("prefer", ["stride", "compose", "assoc"])
def test_engine_matches_reference(compiled, block, prefer, dtype, budget):
    port, ref = _pair(compiled, max_len=LENGTH, prefer=prefer, dtype=dtype,
                      stride_budget=budget, on_accel=True)
    _same_selection(port, ref)
    want = np.asarray(ref.match(block))
    np.testing.assert_array_equal(port.match(block).numpy(), want)
    np.testing.assert_array_equal(
        port.match(torch.as_tensor(block)).numpy(), want)
    packed = port.encode(block)
    ref_packed = ref.encode(block)
    assert packed.packed == ref_packed.packed == (prefer == "stride")
    np.testing.assert_array_equal(packed.idx, ref_packed.idx)
    np.testing.assert_array_equal(packed.overlong, ref_packed.overlong)
    np.testing.assert_array_equal(port.match_encoded(packed).numpy(), want)
    np.testing.assert_array_equal(
        port.match_encoded(packed.to("cpu")).numpy(), want)
    np.testing.assert_array_equal(port.match(packed).numpy(), want)
    # the reference against Python's re, on the rows left whole
    for ti, t in enumerate(TEXTS):
        if ti in (0, 4):
            continue
        for pi, p in enumerate(PATTERNS):
            exp = len(t) <= LENGTH and rx.oracle_match(p, t.encode())
            assert bool(want[ti, pi]) == exp, (t, p)
    assert not want[len(TEXTS):].any()


def test_stride_widths_vary_like_reference(compiled):
    ks = set()
    for budget in (1, 2_000, 200_000, 16 << 20):
        for on_accel in (False, True):
            port, ref = _pair(compiled, max_len=LENGTH, prefer="stride",
                              stride_budget=budget, on_accel=on_accel)
            _same_selection(port, ref)
            ks.add(port.k)
    assert len(ks) >= 3, ks


@pytest.mark.parametrize("on_accel", [False, True])
def test_automatic_selection_matches_reference(on_accel):
    """The reference's selection rules (assoc for long payloads on a
    card, compose for rich alphabets, else stride) over table sizes,
    payload lengths and batch hints, with ``on_accel`` fixed."""
    sets = [PATTERNS,
            ["[a-z]{1,6}[0-9]{1,4}(x|y|z){2}" + c for c in
             "abcdefghijklmnopqrstuvwxyz0123456789"],
            # 129 byte classes: too rich to precompose a stride of 2
            [f"\\x{b:02x}\\x{(b * 7) % 256:02x}" for b in range(1, 250, 2)]]
    seen = set()
    for pats in sets:
        got_c = rx.compile_regex_set(pats)
        want_c = ref_rx.compile_regex_set(pats)
        for max_len in (32, 64, 255, 512, 1024):
            for hint in (16, 2048, 32768, 1 << 20):
                port = eng.DFAEngine(got_c, max_len, batch_hint=hint,
                                     on_accel=on_accel, device="cpu")
                _same_selection(port, ref_eng.DFAEngine(
                    want_c, max_len, batch_hint=hint, on_accel=on_accel))
                seen.add(port.strategy)
    assert seen == ({"stride", "compose", "assoc"} if on_accel
                    else {"stride", "compose"})


def test_default_selection_follows_the_device(compiled):
    got_c, _ = compiled
    cpu = eng.DFAEngine(got_c, 512, device="cpu")
    assert not cpu.on_accel and cpu.describe()["dtype"] == "int32"
    accel = eng.DFAEngine(got_c, 512, device="cpu", on_accel=True)
    assert accel.describe()["dtype"] == "int8"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eng.DFAEngine(got_c, 512)


@pytest.mark.parametrize("prefer", ["stride", "compose", "assoc"])
def test_chunked_scan_carries_state(compiled, prefer):
    """16-column chunks (no multiple of k = 3) carried through ``scan``,
    plain and with the in-place carry, equal the reference's one-shot
    ``dfa_scan`` and its own chunked scan."""
    data = ops.encode_strings(TEXTS, LENGTH)
    data[2, 5] = -1
    port, ref = _pair(compiled, max_len=LENGTH, prefer=prefer,
                      stride_budget=200_000)
    _, want_c = compiled
    starts = np.broadcast_to(want_c.starts[None, :],
                             (len(TEXTS), len(want_c.starts))).astype(
                                 np.int32)
    want = np.asarray(ref_ops.dfa_scan(jnp.asarray(want_c.table),
                                       jnp.asarray(starts),
                                       jnp.asarray(data)))
    st = torch.as_tensor(starts.copy())
    carry = torch.as_tensor(starts.copy())
    ref_st = jnp.asarray(starts)
    for c in range(0, LENGTH, 16):
        st = port.scan(st, data[:, c:c + 16])
        out = port.scan(carry, data[:, c:c + 16], donate=True)
        assert out is carry
        ref_st = ref.scan(ref_st, data[:, c:c + 16])
    assert st.dtype == torch.int32
    np.testing.assert_array_equal(st.numpy(), want)
    np.testing.assert_array_equal(carry.numpy(), want)
    np.testing.assert_array_equal(np.asarray(ref_st), want)


def test_overlong_poison_never_matches(compiled):
    port, ref = _pair(compiled, max_len=8)
    data = ops.encode_strings(["x" * 100, "GET", "aab"], 8)
    assert (data[0] == -2).all()
    got = port.match(data).numpy()
    assert not got[0].any() and got[1, 0] and got[2, 5]
    packed = port.encode(data)
    assert packed.overlong.tolist() == [True, False, False]
    np.testing.assert_array_equal(port.match_encoded(packed).numpy(), got)
    np.testing.assert_array_equal(got, np.asarray(ref.match(data)))


def test_refusals_and_report(compiled):
    got_c, _ = compiled
    with pytest.raises(ValueError):
        eng.DFAEngine(got_c, LENGTH, prefer="warp", device="cpu")
    big = rx.compile_regex_set(["[a-z]{1,200}"])
    assert big.num_states > 127
    with pytest.raises(ValueError, match="cannot hold"):
        eng.DFAEngine(big, LENGTH, dtype=np.int8, device="cpu")
    assert eng.quantize_dtype(127) == ref_eng.quantize_dtype(127) == np.int8
    assert eng.quantize_dtype(128) == ref_eng.quantize_dtype(128) == \
        np.int16
    assert eng.quantize_dtype(1 << 15) == np.int32
    d = eng.DFAEngine(got_c, 512, device="cpu").describe()
    for key in ("strategy", "k", "dtype", "states", "classes",
                "depth_at_max_len", "resident_bytes", "tag"):
        assert key in d
