"""API contract and edge-case tests mirroring the reference's error
discipline (libhydrium.c:46-203) and exercising unusual content."""

import numpy as np
import pytest

import ref_hydrium
from hydrium_tpu import encode_image
from hydrium_tpu.config import ImageMetadata, SampleFormat
from hydrium_tpu.encoder import Encoder
from hydrium_tpu.utils import djxl


def test_metadata_validation():
    with pytest.raises(ValueError):
        ImageMetadata(width=0, height=10).validate()
    with pytest.raises(ValueError):
        ImageMetadata(width=(1 << 30) + 1, height=10).validate()
    with pytest.raises(ValueError):
        ImageMetadata(width=1 << 30, height=1 << 30).validate()  # > 2^40 px
    with pytest.raises(ValueError):
        ImageMetadata(width=10, height=10, tile_size_shift_x=4).validate()
    ImageMetadata(width=1 << 20, height=1 << 20).validate()


def test_tile_out_of_bounds():
    enc = Encoder(ImageMetadata(width=100, height=100))
    with pytest.raises(ValueError):
        enc.send_tile(np.zeros((100, 100, 3), np.uint8), 1, 0)


def test_duplicate_tile_rejected():
    enc = Encoder(ImageMetadata(width=4100, height=100))
    enc.send_tile(np.zeros((100, 2048, 3), np.uint8), 0, 0)
    with pytest.raises(ValueError):
        enc.send_tile(np.zeros((100, 2048, 3), np.uint8), 0, 0)


def test_send_after_last_rejected():
    enc = Encoder(ImageMetadata(width=100, height=100))
    enc.send_tile(np.zeros((100, 100, 3), np.uint8), 0, 0)
    assert enc.finished
    with pytest.raises(RuntimeError):
        enc.send_tile(np.zeros((100, 100, 3), np.uint8), 0, 0)


def test_unsent_tiles_zero_filled():
    """Any tile except the last may be left unsent (libhydrium.h:240)."""
    enc = Encoder(ImageMetadata(width=4100, height=100))
    tile = np.full((100, 2048 - 2048 + 4100 - 2048, 3), 200, np.uint8)
    enc.send_tile(tile, 1, 0, is_last=1)   # only the last tile
    data = enc.take_output()
    dec = djxl.decode(data)
    assert dec.shape == (100, 4100, 3)
    # unsent region decodes near zero-XYB mid-gray-ish; just check the
    # sent region is bright and the unsent one is dark
    assert dec[:, 2048:2100].mean() > dec[:, :100].mean()


def test_out_of_order_tiles_match_reference():
    """Arrival permutation / permuted TOC parity with the reference is
    covered for raster order by e2e; here just check OOO decodes."""
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (200, 4100, 3), dtype=np.uint8)
    enc = Encoder(ImageMetadata(width=4100, height=200))
    enc.send_tile(img[:, 2048:4100], 1, 0, is_last=0)
    enc.send_tile(img[:, 0:2048], 0, 0, is_last=1)
    dec = djxl.decode(enc.take_output())
    assert dec.shape == img.shape
    p = djxl.psnr(img / 255.0, dec)
    assert p > 15


@pytest.mark.parametrize("value", [0, 128, 255])
def test_flat_images_parity(value):
    img = np.full((256, 256, 3), value, np.uint8)
    ref = ref_hydrium.encode(img, tile_size_shift=-1)
    mine = encode_image(img, tile_size_shift=-1)
    assert mine == ref
    djxl.decode(mine)


def test_gradient_parity():
    yy, xx = np.mgrid[0:300, 0:300]
    img = np.stack([xx * 255 // 300, yy * 255 // 300,
                    (xx + yy) * 255 // 600], -1).astype(np.uint8)
    ref = ref_hydrium.encode(img, tile_size_shift=0)
    mine = encode_image(img, tile_size_shift=0)
    assert mine == ref


def test_asymmetric_tile_shifts():
    """tile_size_shift_x != y (the reference supports it via metadata)."""
    rng = np.random.default_rng(1)
    img = rng.integers(0, 255, (600, 700, 3), dtype=np.uint8)
    meta = ImageMetadata(width=700, height=600, tile_size_shift_x=1,
                         tile_size_shift_y=0)
    enc = Encoder(meta)
    th, tw = meta.tile_height, meta.tile_width
    for ty in range((600 + th - 1) // th):
        for tx in range((700 + tw - 1) // tw):
            enc.send_tile(img[ty * th:(ty + 1) * th, tx * tw:(tx + 1) * tw],
                          tx, ty)
    dec = djxl.decode(enc.take_output())
    assert dec.shape == img.shape


def test_level10_container_decodes():
    """Level-10 ISOBMFF prefix (encoder.c:23-30, libhydrium.c:67)."""
    from hydrium_tpu.jxl import headers
    from hydrium_tpu.jxl.bitwriter import BitWriter

    bw = BitWriter()
    headers.write_image_header(bw, 32, 32, level10=True)
    data = bw.finalize()
    assert data[:12] == bytes([0, 0, 0, 0x0C]) + b"JXL \r\n\x87\n"
    assert b"jxll" in data and b"jxlc" in data


def test_wide_lfg_parity():
    """Full-width 2048 LF group geometry (stride, group grid) parity."""
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:300, 0:2300]
    img = np.clip(128 + 80 * np.sin(xx / 37.0)[..., None]
                  * np.cos(np.stack([yy / 23.0] * 3, -1))
                  + rng.normal(0, 6, (300, 2300, 3)), 0, 255).astype(np.uint8)
    ref = ref_hydrium.encode(img, tile_size_shift=-1)
    mine = encode_image(img, tile_size_shift=-1)
    assert mine == ref


def test_planar_input_matches_packed():
    rng = np.random.default_rng(6)
    img = rng.integers(0, 255, (100, 120, 3), dtype=np.uint8)
    a = Encoder(ImageMetadata(width=120, height=100))
    a.send_tile(img, 0, 0)
    b = Encoder(ImageMetadata(width=120, height=100))
    b.send_tile((img[..., 0], img[..., 1], img[..., 2]), 0, 0)
    assert a.take_output() == b.take_output()


def test_strided_view_input_matches_contiguous():
    """Non-contiguous numpy views (the row_stride/pixel_stride cases of
    hyd_send_tile, libhydrium.h) must encode byte-identically to
    contiguous input."""
    rng = np.random.default_rng(16)
    big = rng.integers(0, 255, (240, 300, 7), dtype=np.uint8)
    view = big[10:110, 40:160, 2:5]          # strided in all three axes
    assert not view.flags.c_contiguous
    a = Encoder(ImageMetadata(width=120, height=100))
    a.send_tile(np.ascontiguousarray(view), 0, 0)
    b = Encoder(ImageMetadata(width=120, height=100))
    b.send_tile(view, 0, 0)
    assert a.take_output() == b.take_output()


def test_mixed_sample_formats_across_tiles():
    """The reference allows the sample format to vary tile to tile
    (libhydrium.h hyd_send_tile docs).  u16 = u8 * 257 represents the
    exact same sample values (v/255 == 257v/65535), so a mixed-format
    encode must match the all-u8 encode byte for byte on the float
    (jax) backend."""
    rng = np.random.default_rng(17)
    img = rng.integers(0, 255, (100, 4100, 3), dtype=np.uint8)  # 2 LFGs
    meta = ImageMetadata(width=4100, height=100)

    a = Encoder(meta, backend="jax")
    a.send_tile(img[:, :2048], 0, 0, sample_fmt=SampleFormat.UINT8)
    a.send_tile(img[:, 2048:], 1, 0, sample_fmt=SampleFormat.UINT8)

    b = Encoder(meta, backend="jax")
    b.send_tile(img[:, :2048], 0, 0, sample_fmt=SampleFormat.UINT8)
    b.send_tile((img[:, 2048:].astype(np.uint16) * 257), 1, 0,
                sample_fmt=SampleFormat.UINT16)
    assert a.take_output() == b.take_output()


def test_bucket_words_bounds():
    """Fetch buckets must cover n, never exceed cap, and over-read at
    most ~6.3% past n (worst just above a power of two)."""
    from hydrium_tpu.encoder import _bucket_words

    cap = 1 << 22
    for n in list(range(1, 200)) + [255, 256, 1000, 4097, 65535, 1 << 20,
                                    cap - 1, cap, cap + 5]:
        b = _bucket_words(n, cap)
        assert b >= min(n, cap)
        assert b <= cap
        if n <= cap and n > 32:
            assert b < n * 1.063, (n, b)


def test_buffered_encoder_push_model():
    """BufferedEncoder restores the reference's caller-owned buffer-swap
    output contract (hyd_provide_output_buffer / HYD_NEED_MORE_OUTPUT /
    hyd_release_output_buffer, libhydrium.c:114-166): same bytes as the
    pull model, delivered only through small caller buffers, suspending
    whenever one fills."""
    from hydrium_tpu.encoder import BufferedEncoder, NEED_MORE_OUTPUT, OK

    rng = np.random.default_rng(8)
    img = rng.integers(0, 255, (300, 520, 3), dtype=np.uint8)
    want = encode_image(img, tile_size_shift=-1)

    be = BufferedEncoder(Encoder(ImageMetadata(width=520, height=300)))
    buf = bytearray(4096)       # far smaller than the ~150 KB output
    got = bytearray()
    swaps = 0
    be.provide_output_buffer(buf)
    st = be.send_tile(img, 0, 0)
    while st == NEED_MORE_OUTPUT:
        swaps += 1
        n = be.release_output_buffer()
        assert n == len(buf)    # suspended exactly on a full buffer
        got.extend(buf[:n])
        be.provide_output_buffer(buf)
        st = be.pump()
    assert st == OK
    got.extend(buf[:be.release_output_buffer()])
    assert swaps >= 2
    assert be.finished
    assert bytes(got) == want

    # contract errors: double-provide, pump without a buffer, and the
    # reference's 64-byte minimum (hyd_provide_output_buffer rejects
    # smaller buffers, libhydrium.c)
    be2 = BufferedEncoder(Encoder(ImageMetadata(width=64, height=64)))
    be2.provide_output_buffer(bytearray(64))
    with pytest.raises(RuntimeError):
        be2.provide_output_buffer(bytearray(64))
    be2.release_output_buffer()
    with pytest.raises(RuntimeError):
        be2.pump()
    with pytest.raises(ValueError):
        be2.provide_output_buffer(bytearray(0))
    with pytest.raises(ValueError):
        be2.provide_output_buffer(bytearray(63))


def test_buffered_encoder_tiny_buffer_multi_lfg():
    """Adversarial 65-byte caller buffer through a MULTI-LFG streaming
    jax-backend encode: thousands of suspend/swap cycles must deliver
    exactly the pull-model bytes, and the adapter's internal backlog
    must follow the caller's buffer size (sub-chunk pull granularity --
    the memory-bound contract of libhydrium.c:114-166), not the 4 MB
    iter_output default."""
    from hydrium_tpu.encoder import BufferedEncoder, NEED_MORE_OUTPUT, OK

    rng = np.random.default_rng(11)
    w, h = 2600, 300
    img = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
    meta = ImageMetadata(width=w, height=h)

    ref_enc = Encoder(ImageMetadata(width=w, height=h), backend="jax",
                      streaming=True)
    ref_enc.send_tile(img[:, :2048], 0, 0)
    ref_enc.send_tile(img[:, 2048:], 1, 0)
    want = ref_enc.take_output()

    be = BufferedEncoder(Encoder(meta, backend="jax", streaming=True))
    buf = bytearray(65)
    got = bytearray()
    swaps = 0
    max_backlog = 0

    def drive(st):
        nonlocal swaps, max_backlog
        while st == NEED_MORE_OUTPUT:
            swaps += 1
            max_backlog = max(
                max_backlog,
                sum(len(c) - off for c, off in be._chunks))
            n = be.release_output_buffer()
            got.extend(buf[:n])
            be.provide_output_buffer(buf)
            st = be.pump()
        assert st == OK

    be.provide_output_buffer(buf)
    drive(be.send_tile(img[:, :2048], 0, 0))
    drive(be.send_tile(img[:, 2048:], 1, 0))
    got.extend(buf[:be.release_output_buffer()])
    assert be.finished
    assert bytes(got) == want
    assert swaps > 1000             # genuinely suspended mid-everything
    # backlog bounded near the spool read unit, never a 4 MB chunk
    assert max_backlog < 1 << 17


def test_tiled_batch_deferred_ordering_parity():
    """send_tile_batch keeps stacked chunks in flight across calls and
    serializes per-tile frames on a worker pool; the output bytes must
    still exactly equal the strictly-sequential send_tile path, for
    every mix of batch sizes, edge tiles, and interleaved single
    sends."""
    rng = np.random.default_rng(7)
    img = rng.integers(0, 255, (520, 1230, 3), dtype=np.uint8)  # clipped edges
    th = tw = 256

    def tiles():
        for ty in range((img.shape[0] + th - 1) // th):
            for tx in range((img.shape[1] + tw - 1) // tw):
                yield (img[ty*th:(ty+1)*th, tx*tw:(tx+1)*tw], tx, ty)

    meta = ImageMetadata(width=img.shape[1], height=img.shape[0],
                         tile_size_shift_x=0, tile_size_shift_y=0)
    ref_enc = Encoder(meta, backend="jax")
    ref_out = bytearray()
    for pixels, tx, ty in tiles():
        ref_enc.send_tile(pixels, tx, ty, sample_fmt=SampleFormat.UINT8)
        ref_out.extend(ref_enc.take_output())

    # per-row batches (full rows + a clipped-edge row)
    meta2 = ImageMetadata(width=img.shape[1], height=img.shape[0],
                          tile_size_shift_x=0, tile_size_shift_y=0)
    enc2 = Encoder(meta2, backend="jax")
    out2 = bytearray()
    rows = {}
    for e in tiles():
        rows.setdefault(e[2], []).append(e)
    for ty in sorted(rows):
        enc2.send_tile_batch(rows[ty], sample_fmt=SampleFormat.UINT8)
        out2.extend(enc2.take_output())
    assert bytes(out2) == bytes(ref_out)

    # batch call interleaved with a single send_tile (forces the
    # deferred-unit flush) and an odd split mid-row
    meta3 = ImageMetadata(width=img.shape[1], height=img.shape[0],
                          tile_size_shift_x=0, tile_size_shift_y=0)
    enc3 = Encoder(meta3, backend="jax")
    out3 = bytearray()
    all_tiles = list(tiles())
    enc3.send_tile_batch(all_tiles[:3], sample_fmt=SampleFormat.UINT8)
    px, tx, ty = all_tiles[3]
    enc3.send_tile(px, tx, ty, sample_fmt=SampleFormat.UINT8)
    enc3.send_tile_batch(all_tiles[4:], sample_fmt=SampleFormat.UINT8)
    out3.extend(enc3.take_output())
    assert bytes(out3) == bytes(ref_out)

    dec = djxl.decode(bytes(ref_out))
    assert dec.shape == img.shape


def test_tiled_batch_rejects_tiles_after_last():
    """Frames after the is_last frame would make the stream invalid;
    the batch path must raise exactly like the per-tile path."""
    rng = np.random.default_rng(8)
    img = rng.integers(0, 255, (256, 512, 3), dtype=np.uint8)
    meta = ImageMetadata(width=512, height=256,
                         tile_size_shift_x=0, tile_size_shift_y=0)
    enc = Encoder(meta, backend="jax")
    # bottom-right (last) tile FIRST, then another tile in one batch
    entries = [(img[:, 256:512], 1, 0), (img[:, 0:256], 0, 0)]
    with pytest.raises(RuntimeError):
        enc.send_tile_batch(entries, sample_fmt=SampleFormat.UINT8)


def test_tiled_batch_fetch_failure_falls_back_per_tile(monkeypatch):
    """A chunk whose payload fetch fails its checksums (the fetch and its
    one refetch both corrupt) must transparently fall back to the
    per-tile path with identical output bytes."""
    import hydrium_tpu.encoder as enc_mod

    rng = np.random.default_rng(9)
    img = rng.integers(0, 255, (256, 1024, 3), dtype=np.uint8)

    meta = ImageMetadata(width=1024, height=256,
                         tile_size_shift_x=0, tile_size_shift_y=0)
    ref_enc = Encoder(meta, backend="jax")
    ref_out = bytearray()
    for tx in range(4):
        ref_enc.send_tile(img[:, tx*256:(tx+1)*256], tx, 0,
                          sample_fmt=SampleFormat.UINT8)
        ref_out.extend(ref_enc.take_output())

    real_fetch = enc_mod.fetch_packed_payload
    calls = {"n": 0}

    def flaky(combined, bh, bw, stats=None, hint_words=0):
        aux, words = real_fetch(combined, bh, bw, stats=stats,
                                hint_words=hint_words)
        if bh > 256 and words is not None:   # the stacked-chunk fetches
            calls["n"] += 1
            words = words.copy()
            words[0] ^= 1                    # break the LF checksum
        return aux, words

    monkeypatch.setattr(enc_mod, "fetch_packed_payload", flaky)
    meta2 = ImageMetadata(width=1024, height=256,
                          tile_size_shift_x=0, tile_size_shift_y=0)
    enc2 = Encoder(meta2, backend="jax")
    enc2.send_tile_batch([(img[:, tx*256:(tx+1)*256], tx, 0)
                          for tx in range(4)],
                         sample_fmt=SampleFormat.UINT8)
    out2 = enc2.take_output()
    assert calls["n"] == 2
    assert enc2.stats.counters.get("checksum_errors", 0) >= 1
    assert enc2.stats.counters.get("lfg_fallback", 0) >= 1
    assert bytes(out2) == bytes(ref_out)


def test_tiled_batch_fetch_exception_propagates(monkeypatch):
    """An exception in a stacked chunk's fetch thread is a fault, not a
    reason to re-encode: it must reach the caller."""
    import hydrium_tpu.encoder as enc_mod

    img = np.random.default_rng(9).integers(0, 255, (256, 1024, 3),
                                            dtype=np.uint8)

    def broken(combined, bh, bw, stats=None, hint_words=0):
        raise RuntimeError("injected fetch failure")

    monkeypatch.setattr(enc_mod, "fetch_packed_payload", broken)
    meta = ImageMetadata(width=1024, height=256,
                         tile_size_shift_x=0, tile_size_shift_y=0)
    enc = Encoder(meta, backend="jax")
    with pytest.raises(RuntimeError, match="injected fetch failure"):
        enc.send_tile_batch([(img[:, tx*256:(tx+1)*256], tx, 0)
                             for tx in range(4)],
                            sample_fmt=SampleFormat.UINT8)


def test_one_frame_fetch_exception_propagates(monkeypatch):
    """The one-frame prefetch thread re-raises its error at drain time
    instead of silently re-encoding the LF group unpacked."""
    import hydrium_tpu.encoder as enc_mod

    img = np.random.default_rng(10).integers(0, 255, (300, 520, 3),
                                             dtype=np.uint8)

    def broken(*a, **k):
        raise RuntimeError("injected prefix failure")

    monkeypatch.setattr(enc_mod, "_fetch_prefix", broken)
    with pytest.raises(RuntimeError, match="injected prefix failure"):
        enc_mod.encode_image(img, tile_size_shift=-1, backend="jax")


def test_tiled_batch_wide_retry_reuses_packed_upload(monkeypatch):
    """An injected ok=2 on a stacked chunk must re-dispatch the WIDE
    executable from the packed upload already on device (not re-upload
    raw pixels), set the sticky wide hint, and produce identical bytes."""
    import hydrium_tpu.encoder as enc_mod

    rng = np.random.default_rng(12)
    xx = np.arange(1024, dtype=np.float32)[None, :, None]
    img = np.clip(128 + 90 * np.sin(xx / 41.0)
                  + rng.normal(0, 6, (256, 1024, 3)), 0,
                  255).astype(np.uint8)

    meta = ImageMetadata(width=1024, height=256,
                         tile_size_shift_x=0, tile_size_shift_y=0)
    ref_enc = Encoder(meta, backend="jax")
    ref_enc.send_tile_batch([(img[:, tx*256:(tx+1)*256], tx, 0)
                             for tx in range(4)],
                            sample_fmt=SampleFormat.UINT8)
    ref_out = ref_enc.take_output()

    real_fetch = enc_mod.fetch_packed_payload
    forced = {"n": 0}

    def inject(combined, bh, bw, stats=None, hint_words=0):
        aux, words = real_fetch(combined, bh, bw, stats=stats,
                                hint_words=hint_words)
        if forced["n"] == 0 and bh > 256 and aux is not None:
            forced["n"] = 1
            aux = aux.copy()
            aux[0] = 2          # "retry with wide_residues"
            return aux, None
        return aux, words

    monkeypatch.setattr(enc_mod, "fetch_packed_payload", inject)
    monkeypatch.setattr(enc_mod._JaxDispatch, "_WIDE_HINT", {})
    meta2 = ImageMetadata(width=1024, height=256,
                          tile_size_shift_x=0, tile_size_shift_y=0)
    enc2 = Encoder(meta2, backend="jax")
    enc2.send_tile_batch([(img[:, tx*256:(tx+1)*256], tx, 0)
                          for tx in range(4)],
                         sample_fmt=SampleFormat.UINT8)
    out2 = enc2.take_output()
    assert forced["n"] == 1
    assert enc2.stats.counters.get("wide_retries", 0) == 1
    # the chunk content packs, so the retry must have reused the
    # packed upload (counter unchanged between ref and injected runs)
    assert enc2.stats.counters.get("pxpack_lfgs", 0) \
        == ref_enc.stats.counters.get("pxpack_lfgs", 0) > 0
    assert enc_mod._JaxDispatch._WIDE_HINT  # sticky hint recorded
    assert bytes(out2) == bytes(ref_out)


def test_tiled_batch_pending_run_format_change():
    """A pending cross-call stacked run must flush under ITS OWN sample
    format when the next batch call switches formats -- dispatching it
    under the new format would encode the held tiles wrongly (u16
    pixels read as u8).  The per-tile path with the SAME per-tile
    formats is the oracle."""
    rng = np.random.default_rng(13)
    img8 = rng.integers(0, 256, (512, 512, 3)).astype(np.uint8)
    img16 = img8.astype(np.uint16) * 257
    meta = ImageMetadata(width=512, height=512,
                         tile_size_shift_x=0, tile_size_shift_y=0)

    ref_enc = Encoder(meta, backend="jax")
    for tx in range(2):
        ref_enc.send_tile(img16[:256, tx*256:(tx+1)*256], tx, 0,
                          sample_fmt=SampleFormat.UINT16)
    for tx in range(2):
        ref_enc.send_tile(img8[256:, tx*256:(tx+1)*256], tx, 1,
                          sample_fmt=SampleFormat.UINT8)
    want = ref_enc.take_output()

    enc = Encoder(meta, backend="jax")
    # row 0 as UINT16 (pending run persists: 2 tiles < K_stack)
    enc.send_tile_batch(
        [(img16[:256, tx*256:(tx+1)*256], tx, 0) for tx in range(2)],
        sample_fmt=SampleFormat.UINT16)
    # row 1 as UINT8: the format change must flush row 0 as UINT16
    enc.send_tile_batch(
        [(img8[256:, tx*256:(tx+1)*256], tx, 1) for tx in range(2)],
        sample_fmt=SampleFormat.UINT8)
    got = enc.take_output()
    assert got == want
