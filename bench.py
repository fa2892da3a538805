"""Throughput benchmark: 4K RGB8 encode, end-to-end (pixels in RAM -> .jxl
bytes on host), one-frame mode, jax backend + native serializer.

One process on one GPU; fails when JAX finds no GPU.  Prints the device
(platform, kind, nvidia-smi name and power limit) to stderr and, after
each metric, ONE cumulative JSON line {"metric", "value", "unit",
"vs_baseline", ...} to stdout.  Baseline: reference hydrium measured at
3.19 Mpixels/s on 4K noisy content, 1 CPU core (BASELINE.md).  A
per-stage breakdown goes to stderr.

  python bench.py [iters]          end-to-end cells
  python bench.py --device-plane   jitted packed pipeline alone"""

import json
import os
import sys
import time

import numpy as np

BASELINE_MPPS = 3.19         # reference, 4K noisy, 1 core (BASELINE.md)
BASELINE_SMOOTH_MPPS = 11.0  # reference, 4K smooth, 1 core (BASELINE.md)
# The primary vs_baseline ratios above deliberately compare against the
# reference's FASTEST mode (tiled).  The reference's own one-frame mode
# measures ~6x slower (BASELINE.md: 0.49 noisy / 1.28 smooth Mpix/s),
# so the *_vs_ref_same_mode fields give the mode-for-mode comparison.
BASELINE_1F_MPPS = 0.49          # reference, 4K noisy, ONE-FRAME mode
BASELINE_1F_SMOOTH_MPPS = 1.28   # reference, 4K smooth, ONE-FRAME mode
# reference on make_4k_photo (1/f^2 statistics), best mode: one-frame
# 10.58 / tiled 8.74 Mpix/s, measured 2026-08-20 on the survey rig
# (same libhydrium gcc -O2 build, 64 MB output buffer, fresh process
# per run -- repeated in-process encodes corrupt the reference's heap)
BASELINE_PHOTO_MPPS = 10.58


def make_4k_noisy(seed=0):
    rng = np.random.default_rng(seed)
    h, w = 2160, 3840
    yy = np.arange(h, dtype=np.float32)[:, None, None]
    xx = np.arange(w, dtype=np.float32)[None, :, None]
    phase = np.array([0.0, 1.3, 2.1], np.float32)
    base = 128 + 80 * np.sin(xx / 97.0 + phase) * np.cos(yy / 53.0 - phase)
    noise = rng.normal(0, 24, (h, w, 3)).astype(np.float32)
    return np.clip(base + noise, 0, 255).astype(np.uint8)


def make_4k_smooth():
    """Smooth gradient content (the reference's fast case: few nonzero
    HF coefficients, 11.0 Mpix/s on 1 core -- BASELINE.md)."""
    h, w = 2160, 3840
    yy = np.arange(h, dtype=np.float32)[:, None, None]
    xx = np.arange(w, dtype=np.float32)[None, :, None]
    phase = np.array([0.0, 1.3, 2.1], np.float32)
    base = 128 + 80 * np.sin(xx / 971.0 + phase) * np.cos(yy / 533.0 - phase)
    return np.clip(base, 0, 255).astype(np.uint8)


def make_4k_photo(seed=3):
    return make_photo(2160, 3840, seed)


def make_photo(h, w, seed=3, dtype=np.uint8):
    """Photographic-statistics content: ~1/f^2 luminance power spectrum
    (the classic natural-image model), correlated low-amplitude chroma,
    and hard region edges from a thresholded low-frequency field.  The
    reference's operating regime is photographic PNGs (reference
    hydrium.c:407-443); the noise/smooth synthetic extremes are both
    degenerate for transport decisions (entropy floor / near-zero
    payload), so this is the fixture PXPACK's pack-vs-decline heuristic
    and the headline numbers are validated on.

    dtype uint8 / uint16 quantize to the full range; float32 returns
    the unquantized 0..1 image."""
    rng = np.random.default_rng(seed)

    def pink(exponent):
        fy = np.fft.fftfreq(h)[:, None]
        fx = np.fft.rfftfreq(w)[None, :]
        f = np.sqrt(fy * fy + fx * fx)
        f[0, 0] = 1.0
        spec = (rng.normal(size=(h, w // 2 + 1))
                + 1j * rng.normal(size=(h, w // 2 + 1))) / f ** exponent
        x = np.fft.irfft2(spec, s=(h, w))
        x -= x.mean()
        return x / (np.abs(x).std() + 1e-9)

    luma = pink(1.1)
    # hard edges: a thresholded very-low-frequency field shifts regions
    edges = np.where(pink(1.8) > 0.3, 0.9, 0.0)
    c1, c2 = pink(1.3), pink(1.3)
    img = np.stack([luma + 0.25 * c1 + edges,
                    luma + edges,
                    luma + 0.25 * c2 + edges], axis=-1)
    img = (img - img.min()) / (img.max() - img.min())
    if dtype == np.float32:
        return img.astype(np.float32)
    top = float(np.iinfo(dtype).max)
    return np.clip(img * top + rng.normal(0, 1.2 * top / 255.0, img.shape),
                   0, top).astype(dtype)


def _device() -> dict:
    from hydrium_tpu.utils.device import nvidia_smi_line, require_gpu

    dev = require_gpu()
    print(f"bench: device {dev} | {nvidia_smi_line()}", file=sys.stderr,
          flush=True)
    return dev


def device_plane(iters: int = 50) -> dict:
    """Time the jitted pipeline alone -- no host transfers, inputs
    pre-staged on device -- packed and unpacked.

    The iteration loop runs ON DEVICE -- one jitted lax.fori_loop whose
    carry forces each pipeline iteration to depend on the last -- and
    the wall time of one dispatch + one scalar readback is divided by
    the trip count, with the readback latency measured separately and
    subtracted."""
    import jax
    import jax.numpy as jnp

    dev = _device()
    from hydrium_tpu.jxl.tokcode import TokenCodec
    from hydrium_tpu.ops import tables
    from hydrium_tpu.ops.pipeline import encode_lfg_packed

    img = make_4k_noisy()[:2048, :2048]
    cm = tables.hf_cluster_map(1)
    lens, codes, _lut = TokenCodec().tables()
    px = jnp.asarray(img)
    presets = jnp.zeros(64, jnp.int32)
    cm_d, lens_d, codes_d = (jnp.asarray(cm), jnp.asarray(lens),
                             jnp.asarray(codes))
    out = {"metric": "device-plane packed pipeline, 2048^2 LFG",
           "unit": "Mpixels/s", "device": dev, "iters": iters}
    from hydrium_tpu.ops.pipeline import encode_lfg

    for name, packed in (("packed", True), ("unpacked", False)):
        kw = dict(buf_h=2048, buf_w=2048, linear_light=False,
                  num_clusters=9, sample_kind="uint8")

        @jax.jit
        def loop(px, presets, cm, lens, codes, n):
            # dynamic trip count: one executable serves n=1 and n=iters
            def body(_i, carry):
                if packed:
                    r = encode_lfg_packed(px, 2048 + carry, 2048, presets,
                                          cm, lens, codes, **kw)
                    probe = r["combined"][0]
                else:
                    r = encode_lfg(px, 2048 + carry, 2048, presets, cm,
                                   **kw)
                    probe = r["valid_len"][0].astype(jnp.uint32)
                # always tiny but NOT constant-foldable, so the
                # loop-carried dependency survives optimization
                return (probe >> jnp.uint32(31)).astype(jnp.int32)
            return jax.lax.fori_loop(0, n, body, jnp.int32(0))

        # warm: compile on a 1-iter run
        assert int(np.asarray(loop(px, presets, cm_d, lens_d, codes_d,
                                   n=1))) == 0

        def t(n):
            t0 = time.perf_counter()
            assert int(np.asarray(loop(px, presets, cm_d, lens_d,
                                       codes_d, n=n))) == 0
            return time.perf_counter() - t0

        # min-of-3 on BOTH terms: one slow readback otherwise
        # contaminates the subtraction
        overhead = min(t(1) for _ in range(3))
        total = min(t(iters) for _ in range(3))
        dt = max(total - overhead, 1e-9) / max(iters - 1, 1)
        out[name + "_mpix_s"] = round(2048 * 2048 / dt / 1e6, 1)
        out[name + "_ms_per_lfg"] = round(dt * 1e3, 3)
        out[name + "_dispatch_readback_ms"] = round(overhead * 1e3, 1)

        # cross-check without the while-loop: N independent dispatches
        # queue serially on the device; fetching one word of the LAST
        # result must wait for the whole queue, so wall ~= N * compute
        probe = jax.jit(lambda a: a[:1])
        if packed:
            run1 = lambda: encode_lfg_packed(px, 2048, 2048, presets, cm_d,
                                             lens_d, codes_d,
                                             **kw)["combined"]
        else:
            run1 = lambda: encode_lfg(px, 2048, 2048, presets, cm_d,
                                      **kw)["valid_len"]
        np.asarray(probe(run1()))          # warm probe path
        nq = max(iters // 5, 2)
        t0 = time.perf_counter()
        r = None
        for _ in range(nq):
            r = run1()
        np.asarray(probe(r))
        qt = (time.perf_counter() - t0) / nq
        out[name + "_queued_ms_per_lfg"] = round(qt * 1e3, 3)
    print(json.dumps(out))
    return out


def _measure(img, iters, label, tile_shift=-1):
    """Best-of-iters encode (one-frame by default, tiled for
    tile_shift >= 0); returns (mpix_s, stats)."""
    from hydrium_tpu.config import ImageMetadata, SampleFormat
    from hydrium_tpu.encoder import Encoder

    pixels = img.shape[0] * img.shape[1]
    best = float("inf")
    data = b""
    stats = None
    for i in range(iters):
        meta = ImageMetadata(width=img.shape[1], height=img.shape[0],
                             tile_size_shift_x=tile_shift,
                             tile_size_shift_y=tile_shift)
        ts = 2048 if tile_shift < 0 else meta.tile_width
        enc = Encoder(meta, backend="jax")
        if os.environ.get("HYDRIUM_BENCH_TIMELINE", "0") == "1":
            # per-event cross-thread timeline on stderr
            enc.stats.enable_timeline()
        t0 = time.perf_counter()
        out = bytearray()
        for ty in range((img.shape[0] + ts - 1) // ts):
            if tile_shift < 0:
                for tx in range((img.shape[1] + ts - 1) // ts):
                    enc.send_tile(img[ty * ts:(ty + 1) * ts,
                                      tx * ts:(tx + 1) * ts], tx, ty,
                                  sample_fmt=SampleFormat.UINT8)
                    out.extend(enc.take_output())
            else:
                entries = [(img[ty * ts:(ty + 1) * ts,
                                tx * ts:(tx + 1) * ts], tx, ty)
                           for tx in range((img.shape[1] + ts - 1) // ts)]
                enc.send_tile_batch(entries,
                                    sample_fmt=SampleFormat.UINT8)
                out.extend(enc.take_output())
        dt = time.perf_counter() - t0
        print(f"bench[{label}]: iter {i}: {dt:.2f}s "
              f"({pixels/dt/1e6:.2f} Mpix/s)", file=sys.stderr, flush=True)
        if dt < best:
            best = dt
            data = bytes(out)
            stats = enc.stats
    assert data[:2] == b"\xff\x0a" or data[4:8] == b"JXL ", data[:8].hex()
    print(f"bench[{label}]: stage breakdown (best iter):\n"
          + stats.summary(), file=sys.stderr, flush=True)
    if os.environ.get("HYDRIUM_BENCH_TIMELINE", "0") == "1":
        print(f"bench[{label}]: timeline (best iter):\n"
              + stats.timeline(), file=sys.stderr, flush=True)
    return pixels / best / 1e6, stats


def _wire_bpp(stats, pixels: int) -> float:
    """Total bits moved between host and device per pixel on the best
    iteration (h2d packed words + packed meta + raw uploads, plus d2h
    fetched payload words)."""
    c = stats.counters
    wire = (4 * c.get("pxpack_words", 0) + 4 * c.get("pxpack_meta_words", 0)
            + c.get("h2d_raw_bytes", 0) + 4 * c.get("fetched_words", 0))
    return round(8.0 * wire / pixels, 2)


def main():
    from hydrium_tpu import encode_image

    iters = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    dev = _device()
    img = make_4k_noisy()
    smooth = make_4k_smooth()

    # Cumulative result, re-emitted as a JSON line after each metric
    # completes.
    result = {"metric": "4K RGB8 one-frame encode throughput",
              "value": 0.0, "unit": "Mpixels/s", "vs_baseline": 0.0,
              "device": dev}

    # warmup: encode BOTH content kinds once -- the two contents
    # exercise different executables (raw-pixel vs packed-pixel upload
    # path) and different fetch buckets.
    print("bench: warmup/compile...", file=sys.stderr, flush=True)
    encode_image(img, tile_size_shift=-1, backend="jax")
    encode_image(smooth, tile_size_shift=-1, backend="jax")

    # measure smooth right after its warmup (the adaptive transport
    # codec is smooth-trained at this point, as it would be in any
    # steady smooth workload)
    smooth_mpps, s_st = _measure(smooth, max(3, iters // 2 + 1), "smooth")
    result["smooth_mpix_s"] = round(smooth_mpps, 3)
    result["smooth_wire_bpp"] = _wire_bpp(
        s_st, smooth.shape[0] * smooth.shape[1])
    result["smooth_vs_baseline"] = round(smooth_mpps / BASELINE_SMOOTH_MPPS,
                                         2)
    result["smooth_vs_ref_same_mode"] = round(
        smooth_mpps / BASELINE_1F_SMOOTH_MPPS, 2)
    print(json.dumps(result), flush=True)

    # one throwaway noisy encode re-adapts the codec and loads the
    # noisy-size fetch buckets before the measured run
    encode_image(img, tile_size_shift=-1, backend="jax")
    mpps, n_st = _measure(img, iters, "noisy")
    result["value"] = round(mpps, 3)
    result["wire_bpp"] = _wire_bpp(n_st, img.shape[0] * img.shape[1])
    result["vs_baseline"] = round(mpps / BASELINE_MPPS, 2)
    result["vs_ref_same_mode"] = round(mpps / BASELINE_1F_MPPS, 2)
    print(json.dumps(result), flush=True)

    # tiled mode (256^2 tiles-as-frames): the reference's DEFAULT and
    # fastest mode, so this is the apples-to-apples headline row
    encode_image(img, tile_size_shift=0, backend="jax")
    tiled_mpps, _ = _measure(img, max(2, iters // 2), "tiled",
                             tile_shift=0)
    result["tiled_mpix_s"] = round(tiled_mpps, 3)
    result["tiled_vs_baseline"] = round(tiled_mpps / BASELINE_MPPS, 2)
    print(json.dumps(result), flush=True)

    # photographic-statistics content (1/f^2): the regime real users
    # hit; validates PXPACK's pack-vs-decline heuristic outside the two
    # degenerate synthetic extremes
    photo = make_4k_photo()
    encode_image(photo, tile_size_shift=-1, backend="jax")
    photo_mpps, p_st = _measure(photo, max(2, iters // 2), "photo")
    result["photo_mpix_s"] = round(photo_mpps, 3)
    result["photo_wire_bpp"] = _wire_bpp(
        p_st, photo.shape[0] * photo.shape[1])
    result["photo_vs_baseline"] = round(photo_mpps / BASELINE_PHOTO_MPPS,
                                        2)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    if "--device-plane" in sys.argv:
        device_plane()
    else:
        main()
