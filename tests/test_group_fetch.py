"""Frame-level single fetch (encoder._FetchGroup / group_fetch_payloads):
one combined device buffer + one read must be a pure transport
change -- per-payload (aux, words) identical to the individual
fetch_packed_payload protocol, anomalies cascade to the individual
path, and end-to-end bytes never change.

Reference contrast: the reference's one-frame mode accumulates all
groups and flushes once (encoder.c:752-1003); the group fetch is the
device-transfer analogue of that single flush.
"""

import os

import numpy as np
import pytest

from hydrium_tpu.config import ImageMetadata, SampleFormat
from hydrium_tpu.encoder import (Encoder, fetch_packed_payload,
                                 group_fetch_payloads)
from hydrium_tpu.jxl import native


def _mk_payload(seed: int, buf: int = 256):
    """One real combined packed payload on a [buf, buf] buffer."""
    import jax.numpy as jnp

    from hydrium_tpu.jxl.tokcode import TokenCodec
    from hydrium_tpu.ops import tables
    from hydrium_tpu.ops.pipeline import encode_lfg_packed

    rng = np.random.default_rng(seed)
    base = 90 + 60 * np.sin(np.arange(buf) / (17.0 + seed))
    img = np.clip(base[None, :, None] + rng.normal(0, 4 + 3 * seed,
                                                   (buf, buf, 3)),
                  0, 255).astype(np.uint8)
    lens, codes, _ = TokenCodec().tables()
    g = (buf >> 8) * (buf >> 8)
    out = encode_lfg_packed(
        jnp.asarray(img), buf, buf, jnp.zeros((g,), jnp.int32),
        jnp.asarray(tables.hf_cluster_map(1)), jnp.asarray(lens),
        jnp.asarray(codes), buf_h=buf, buf_w=buf, linear_light=False,
        num_clusters=9, sample_kind="uint8")
    return out["combined"]


@pytest.mark.parametrize("hint", [64, 1 << 20])
def test_group_fetch_matches_individual(hint):
    """(aux, words) from the combined single fetch == the individual
    two-phase protocol, for both a too-small hint (ranged top-up) and a
    covering hint (one round trip)."""
    outs = [_mk_payload(0), _mk_payload(1), _mk_payload(2)]
    shapes = [(256, 256)] * 3
    got = group_fetch_payloads(outs, shapes, [hint] * 3)
    assert len(got) == 3
    for o, r in zip(outs, got):
        assert r is not None
        aux, words = r
        ref_aux, ref_words = fetch_packed_payload(o, 256, 256)
        np.testing.assert_array_equal(aux, ref_aux)
        assert int(aux[0]) == 1
        # the trailing +1 safety word is reader slack, never decoded: in
        # the combined buffer it holds the NEXT payload's first word
        used = ref_words.shape[0] - 1
        assert words.shape[0] >= used + 1
        np.testing.assert_array_equal(words[:used], ref_words[:used])


def test_group_fetch_corrupt_aux_cascades(monkeypatch):
    """A corrupt aux makes its own AND every subsequent payload
    unfetchable from the combined buffer (their offsets depend on the
    corrupt length) -- those entries must come back None."""
    import hydrium_tpu.encoder as E

    outs = [_mk_payload(3), _mk_payload(4), _mk_payload(5)]
    shapes = [(256, 256)] * 3
    A = 651          # packed_aux_len(256, 256)
    real = E._fetch_prefix

    def corrupting(arr, nwords):
        first = real(arr, nwords)
        first = first.copy()
        first[A + 4] ^= 0x40            # aux_1's checksum word
        return first

    monkeypatch.setattr(E, "_fetch_prefix", corrupting)
    got = group_fetch_payloads(outs, shapes, [1 << 20] * 3)
    monkeypatch.undo()
    assert got[0] is not None
    assert got[1] is None and got[2] is None
    aux0, words0 = got[0]
    ref_aux, ref_words = fetch_packed_payload(outs[0], 256, 256)
    np.testing.assert_array_equal(aux0, ref_aux)
    used = ref_words.shape[0] - 1
    np.testing.assert_array_equal(words0[:used], ref_words[:used])


@pytest.mark.skipif(not native.available(), reason="native plane required")
def test_group_fetch_e2e_byte_equality(monkeypatch):
    """A multi-LFG one-frame encode with the frame fetch group engaged
    must produce exactly the bytes of the per-LFG fetch path, and the
    group must actually fire once codec/hints are warm."""
    rng = np.random.default_rng(7)
    w, h = 6200, 300
    base = 120 + 80 * np.sin(np.arange(w) / 311.0)
    img = np.clip(base[None, :, None] + rng.normal(0, 6, (h, w, 3)),
                  0, 255).astype(np.uint8)
    meta = ImageMetadata(width=w, height=h)

    def run():
        enc = Encoder(meta, backend="jax", streaming=True)
        for tx in range(3):
            enc.send_tile(img[:, tx * 2048:(tx + 1) * 2048], tx, 0,
                          sample_fmt=SampleFormat.UINT8)
        enc.send_tile(img[:, 3 * 2048:], 3, 0,
                      sample_fmt=SampleFormat.UINT8)
        return enc.take_output(), enc.stats

    monkeypatch.setenv("HYDRIUM_GROUP_FETCH", "0")
    run()                                # warm codec + NEED_HINT
    ref, _ = run()
    monkeypatch.setenv("HYDRIUM_GROUP_FETCH", "1")
    got, stats = run()
    assert got == ref
    assert stats.counters.get("group_fetches", 0) >= 1
    assert stats.counters.get("group_members", 0) >= 2
    assert stats.counters.get("lfg_packed", 0) == 4


def test_warm_hints_roundtrip(tmp_path, monkeypatch):
    """Fetch-sizing hints persist with the warm codec state, so a fresh
    process's FIRST encode can take the frame-level single fetch and
    the wide executable (hints affect scheduling only, never bytes)."""
    import hydrium_tpu.encoder as E

    monkeypatch.setattr(E, "_WARM_CACHE", str(tmp_path / "warm.npz"))
    saved_need = dict(E._JaxDispatch._NEED_HINT)
    saved_wide = dict(E._JaxDispatch._WIDE_HINT)
    try:
        E._JaxDispatch._NEED_HINT[(512, 2048)] = 1234
        E._JaxDispatch._WIDE_HINT[(512, 2048, "uint8")] = True
        E._save_warm_state()
        E._JaxDispatch._NEED_HINT.clear()
        E._JaxDispatch._WIDE_HINT.clear()
        E._load_warm_hints()
        assert E._JaxDispatch._NEED_HINT[(512, 2048)] == 1234
        assert E._JaxDispatch._WIDE_HINT[(512, 2048, "uint8")] is True
    finally:
        E._JaxDispatch._NEED_HINT.clear()
        E._JaxDispatch._NEED_HINT.update(saved_need)
        E._JaxDispatch._WIDE_HINT.clear()
        E._JaxDispatch._WIDE_HINT.update(saved_wide)


def test_group_force_arm_timeout(monkeypatch):
    """A group whose frame never completes (slow caller) must still
    fetch: the drain-side ensure() force-arms after the bounded wait
    with whatever members registered, and the result matches the
    individual protocol."""
    import hydrium_tpu.encoder as E

    monkeypatch.setattr(E, "_GROUP_FETCH_WAIT_S", 0.05)
    out = _mk_payload(9)

    class H:
        buf_h = buf_w = 256
        _aux = None
        _words = None
        _pf_ran = False
        _hist_folded = False
        _codec = None

        def join_prepare(self):
            pass

    h = H()
    h.out = {"combined": out}
    E._JaxDispatch._NEED_HINT.setdefault((256, 256), 64)
    g = E._FetchGroup(None)
    assert g.register(h)
    # nobody ever arms; ensure() must force-arm and complete
    g.ensure(h)
    assert h._pf_ran and h._aux is not None
    ref_aux, _ = fetch_packed_payload(out, 256, 256)
    np.testing.assert_array_equal(h._aux, ref_aux)
