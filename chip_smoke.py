"""Smoke test of the JAX encoder on the GPU: the quickest proof that the
system's main path starts and is right on the card.

  python chip_smoke.py          phases 0-3 on one card
  python chip_smoke.py --four   only the 4-card sharded encode and its
                                one-card comparison
  --save DIR                    also write each encoded .jxl to DIR, for
                                scripts/check_chip_outputs.py where the
                                card's machine has no libjxl

Phase 0, device: the first JAX device must be a GPU (there is no CPU
  fallback) and the native serialization plane must load.
Phase 1, parity: one full 2048x2048 LF group of u8 noise and of u8
  photo-like content: the packed payload verifies, walks to HF sections
  byte-identical to the unpacked tensors', its LF stream decodes to the
  unpacked LF residuals, and the PXPACK upload gives the raw upload's
  payload bit for bit.
Phase 2, reference: the card's quantized LF/HF integers against the
  plain numpy pipeline (ops/reference.py) on the same group.
Phase 3, end to end: 4K photo and noise one-frame (encode_image), 1080p
  tiled (Encoder), 8K u16 one-frame, 1080p f32 linear-light PFM (CLI);
  libjxl decodes each output at a PSNR no worse than the numpy
  backend's minus 0.05 dB.

Every phase prints its result and seconds.  Only when every phase passed
does the last line of stdout read {"ok": true, "device": {...}}; any
failure exits nonzero.  One process drives the card(s)."""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from functools import partial

import numpy as np

_REPO = os.path.dirname(os.path.abspath(__file__))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

PSNR_SLACK_DB = 0.05      # tests/test_e2e.py: jax vs numpy backend
LF_DIFF1_MAX_RATE = 0.02  # tests/test_pipeline_jax.py quantized agreement


class PhaseError(AssertionError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def say(phase: str, msg: str, t0: float) -> None:
    print(f"[{phase}] {msg} ({time.perf_counter() - t0:.2f} s)",
          flush=True)


def noise_u8(h: int, w: int, seed: int = 7) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                                dtype=np.uint8)


def photo(h: int, w: int, dtype=np.uint8, seed: int = 3) -> np.ndarray:
    from bench import make_photo

    return make_photo(h, w, seed=seed, dtype=dtype)


# -- phase 0 ----------------------------------------------------------------

def phase_device() -> dict:
    import jax

    from hydrium_tpu.jxl import native
    from hydrium_tpu.utils import jaxcfg
    from hydrium_tpu.utils.device import nvidia_smi_line, require_gpu

    t0 = time.perf_counter()
    dev = require_gpu()
    print(f"device_kind: {dev['kind']} (count {dev['count']})")
    print(f"nvidia-smi: {nvidia_smi_line()}")
    print(f"jax {jax.__version__}; compile cache {jaxcfg.cache_dir()}")
    check(native.available(), f"native plane did not load: "
                              f"{native._load_error}")
    say("0 device", "ok", t0)
    return dev


# -- phase 1 ----------------------------------------------------------------

def lfg_parity(img: np.ndarray, linear_light: bool = False) -> dict:
    """Same-device exact invariants of one square LF group (u8, u16 or
    f32; side a multiple of 256, at most 2048): packed vs unpacked
    device paths and, for integer samples, raw vs PXPACK upload.  The
    format's own wide-residue retry (ok=2) is allowed once; an unpacked
    fallback is not."""
    import jax.numpy as jnp

    from hydrium_tpu.encoder import _parse_packed, packed_verify
    from hydrium_tpu.jxl import native
    from hydrium_tpu.jxl.frame import HFStream, LFGroupGeometry
    from hydrium_tpu.jxl.tokcode import LF_CLASS, TokenCodec
    from hydrium_tpu.ops import pipeline, tables

    buf = img.shape[0]
    check(img.shape == (buf, buf, 3) and buf % 256 == 0 and buf <= 2048,
          f"bad LF group shape {img.shape}")
    gc = buf >> 8
    G = gc * gc
    cm = jnp.asarray(tables.hf_cluster_map(1))
    lens, codes, lut = TokenCodec().tables()
    lens, codes = jnp.asarray(lens), jnp.asarray(codes)
    presets = jnp.zeros((G,), jnp.int32)
    px = jnp.asarray(img)
    kind = {np.dtype(np.uint8): "uint8", np.dtype(np.uint16): "uint16",
            np.dtype(np.float32): "float32"}[img.dtype]
    kw = dict(buf_h=buf, buf_w=buf, linear_light=linear_light,
              num_clusters=9, sample_kind=kind, tok_classes=9)

    def packed(wide):
        return np.asarray(pipeline.encode_lfg_packed(
            px, buf, buf, presets, cm, lens, codes, wide_residues=wide,
            **kw)["combined"])

    wide = False
    combined = packed(False)
    if int(combined[0]) == 2:
        wide = True
        combined = packed(True)
    ok_word = int(combined[0])
    check(ok_word == 1, f"packed ok word {ok_word} (wide={wide})")
    A = pipeline.packed_aux_len(buf, buf)
    aux = np.ascontiguousarray(combined[:A]).view(np.int32)
    check(packed_verify(aux, combined[A:], buf, buf),
          "payload checksum mismatch")
    geom = LFGroupGeometry(x=0, y=0, width=buf, height=buf,
                           tile_count_x=gc, tile_count_y=gc)
    parsed = _parse_packed(aux, combined[A:], buf, buf, geom, lut[LF_CLASS])
    check(parsed is not None, "packed LF stream did not decode")

    out_u = pipeline.encode_lfg(px, buf, buf, presets, cm,
                                clusters_per_preset=9,
                                **{k: v for k, v in kw.items()
                                   if k != "tok_classes"})
    vb = buf >> 3
    check(np.array_equal(parsed["lf_res"],
                         np.asarray(out_u["lf_res"])[:vb, :vb]),
          "packed LF residuals differ from the unpacked path")

    hf_a = HFStream(1)
    hf_a.add_lfg_packed(parsed["tok_words"], parsed["res_words"], lut[:9],
                        0, (gc, gc), (vb, vb), parsed["tok_off"],
                        parsed["res_off"], parsed["gs"])
    hf_a.encode_group_sections()
    hf_b = HFStream(1)
    arrs = [np.asarray(out_u[k]).reshape(G, 1024, 3, 64)
            for k in ("tokens", "clusters", "residues", "residue_bits")]
    valid_len = np.asarray(out_u["valid_len"]).reshape(G, 1024, 3)
    for gi in range(G):
        hf_b.add_group_padded(*(a[gi] for a in arrs), valid_len[gi], 0)
    hf_b.encode_group_sections()
    sec_a = [w.finalize() for w in hf_a.group_sections]
    sec_b = [w.finalize() for w in hf_b.group_sections]
    check(sec_a == sec_b, "walked packed HF sections differ from the "
                          "unpacked tensors' sections")

    upload = None
    if kind != "float32":
        pxp = native.px_pack2(img, cap_ratio=100.0)
        check(pxp is not None, "px_pack2 declined a forced pack")
        upload = pxp[0]

        def padded(a):
            out = np.zeros(a.size + 16, np.uint32)
            out[:a.size] = a
            return jnp.asarray(out)

        if upload == "px2":
            _, words, hdr2, base2, words2, meta_h, meta_w = pxp
            combined_px = pipeline.encode_lfg_packed_px2(
                padded(words), jnp.asarray(hdr2), jnp.asarray(base2),
                padded(words2), buf, buf, presets, cm, lens, codes,
                ubuf_h=buf, ubuf_w=buf, meta_h=meta_h, meta_w=meta_w,
                wide_residues=wide, **kw)["combined"]
        else:
            _, words, hdr, base = pxp
            combined_px = pipeline.encode_lfg_packed_px(
                padded(words), jnp.asarray(hdr), jnp.asarray(base), buf,
                buf, presets, cm, lens, codes, ubuf_h=buf, ubuf_w=buf,
                wide_residues=wide, **kw)["combined"]
        check(np.array_equal(np.asarray(combined_px), combined),
              f"PXPACK {upload} upload payload differs from the raw "
              f"upload's")
    return {"ok_word": ok_word, "wide": wide, "upload": upload,
            "symbols": int(parsed["gs"].sum()),
            "payload_words": int(A + parsed["need_words"]),
            "hf_section_bytes": sum(len(s) for s in sec_a)}


def phase_parity(size: int = 2048) -> None:
    for label, img in (("noise", noise_u8(size, size)),
                       ("photo", photo(size, size))):
        t0 = time.perf_counter()
        r = lfg_parity(img)
        check(r["upload"] == "px2", f"{label}: PXPACK took the "
                                    f"{r['upload']} form, not px2")
        say("1 parity", f"{size}x{size} u8 {label}: {json.dumps(r)}", t0)


# -- phase 2 ----------------------------------------------------------------

def reference_agreement(img: np.ndarray, precision=None) -> dict:
    """Quantized LF and HF integers of the device frontend against the
    plain numpy pipeline (ops/reference.py) on a u8 image."""
    import jax
    import jax.numpy as jnp

    from hydrium_tpu.ops import pipeline
    from hydrium_tpu.ops import reference as ref

    h, w = img.shape[:2]
    front = jax.jit(partial(
        pipeline.quantize_frontend, linear_light=False, sample_kind="uint8",
        precision=pipeline.DCT_PRECISION if precision is None
        else precision))
    lf_q, q = (np.asarray(a) for a in front(jnp.asarray(img), h, w))
    xyb = ref.pad_to_blocks(ref.pixels_to_xyb(img, "uint8", False), h, w)
    coeffs = ref.forward_dct(xyb)
    hf_q, _nz = ref.quantize_hf(ref.zigzag_gather(coeffs))
    lf_ref = ref.quantize_lf(coeffs[:, :, 0, 0, :])
    # [vh, vw, 64, storage channel] -> emission order [vh, vw, Y/X/B, 64]
    hf_ref = hf_q.transpose(0, 1, 3, 2)[:, :, [1, 0, 2], :]
    d = np.abs(lf_q.astype(np.int64) - lf_ref)
    return {"lf_max_abs_diff": int(d.max()),
            "lf_diff1_rate": float(np.mean(d == 1)),
            "hf_mismatch_rate": float(np.mean(q != hf_ref))}


def phase_reference(size: int = 2048) -> dict:
    import jax

    from hydrium_tpu.ops import pipeline

    img = photo(size, size)
    t0 = time.perf_counter()
    r = reference_agreement(img)
    check(r["lf_max_abs_diff"] <= 1 and
          r["lf_diff1_rate"] < LF_DIFF1_MAX_RATE,
          f"LF disagreement with ops/reference.py: {r}")
    say("2 reference", f"{size}x{size} u8 photo, DCT precision "
        f"{pipeline.DCT_PRECISION.name}: {json.dumps(r)}", t0)
    t0 = time.perf_counter()
    d = reference_agreement(img, jax.lax.Precision.DEFAULT)
    say("2 reference", f"(for the record) DCT precision DEFAULT: "
        f"{json.dumps(d)}", t0)
    return r


# -- phase 3 ----------------------------------------------------------------

def _signal(img: np.ndarray, linear_light: bool = False) -> np.ndarray:
    """The input in the sRGB-encoded 0..1 space libjxl decodes to."""
    if img.dtype == np.uint8:
        return img / 255.0
    if img.dtype == np.uint16:
        return img / 65535.0
    if not linear_light:
        return img
    x = np.clip(img.astype(np.float64), 0.0, 1.0)
    return np.where(x <= 0.0031308, 12.92 * x,
                    1.055 * np.power(x, 1 / 2.4) - 0.055)


def encode(mode: str, img: np.ndarray, backend: str, stats=None,
           tmpdir: str = ".") -> bytes:
    """One encode through a public entry point: 'api' = encode_image in
    one-frame mode, 'tiled' = Encoder at tile_size_shift 0 fed a tile
    row at a time, 'cli-pfm' = the CLI on a PFM file with --linear."""
    from hydrium_tpu import Encoder, ImageMetadata, SampleFormat, encode_image

    if mode == "api":
        return encode_image(img, tile_size_shift=-1, backend=backend,
                            stats=stats)
    if mode == "tiled":
        h, w = img.shape[:2]
        meta = ImageMetadata(width=w, height=h, tile_size_shift_x=0,
                             tile_size_shift_y=0)
        enc = Encoder(meta, backend=backend)
        if stats is not None:
            enc.stats = stats
        fmt = SampleFormat.UINT8 if img.dtype == np.uint8 else (
            SampleFormat.UINT16 if img.dtype == np.uint16
            else SampleFormat.FLOAT32)
        out = bytearray()
        for ty in range((h + 255) // 256):
            enc.send_tile_batch(
                [(img[ty * 256:(ty + 1) * 256, tx * 256:(tx + 1) * 256],
                  tx, ty) for tx in range((w + 255) // 256)],
                sample_fmt=fmt)
            out.extend(enc.take_output())
        return bytes(out)
    if mode == "cli-pfm":
        from hydrium_tpu import cli
        from hydrium_tpu.utils.pfm import write_pfm

        src = os.path.join(tmpdir, "in.pfm")
        dst = os.path.join(tmpdir, f"out-{backend}.jxl")
        write_pfm(src, img)
        rc = cli.main([src, dst, "--pfm", "--linear", "--backend", backend],
                      stats=stats)
        check(rc == 0, f"CLI exit code {rc}")
        with open(dst, "rb") as f:
            return f.read()
    raise ValueError(mode)


def libjxl_error():
    """None when libjxl loads, else why it does not."""
    from hydrium_tpu.utils import djxl

    try:
        djxl._load()
    except OSError as e:
        return str(e)
    return None


def slug(name: str) -> str:
    return "".join(c if c.isalnum() else "_" for c in name)


def psnr_vs_numpy(name: str, img: np.ndarray, mode: str, data: bytes,
                  tmpdir: str) -> dict:
    """Decode a jax-backend output with libjxl and hold its PSNR to the
    numpy backend's on the same input, minus PSNR_SLACK_DB."""
    from hydrium_tpu.utils import djxl

    sig = _signal(img, linear_light=mode == "cli-pfm")
    r = {"psnr_jax": round(djxl.psnr(sig, djxl.decode(data)), 4)}
    ref = encode(mode, img, "numpy", None, tmpdir)
    r["psnr_numpy"] = round(djxl.psnr(sig, djxl.decode(ref)), 4)
    check(r["psnr_jax"] >= r["psnr_numpy"] - PSNR_SLACK_DB,
          f"{name}: PSNR {r['psnr_jax']} below numpy "
          f"{r['psnr_numpy']} - {PSNR_SLACK_DB}")
    return r


def e2e_case(name: str, img: np.ndarray, mode: str, card: str,
             tmpdir: str, decode: bool = True,
             save_dir: str = None) -> dict:
    from hydrium_tpu.utils.stats import EncodeStats

    seconds = []
    for _ in range(2):                  # cold (compiles), then warm
        stats = EncodeStats()
        t0 = time.perf_counter()
        data = encode(mode, img, "jax", stats, tmpdir)
        seconds.append(time.perf_counter() - t0)
    check(data[:2] == b"\xff\x0a" or data[4:8] == b"JXL ",
          f"{name}: no JPEG XL signature ({data[:8].hex()})")
    c = stats.counters
    check(c.get("prefetch_errors", 0) == 0 and
          c.get("checksum_errors", 0) == 0,
          f"{name}: transfer errors {dict(c)}")
    r = {"bytes": len(data), "lfg_packed": c.get("lfg_packed", 0),
         "lfg_fallback": c.get("lfg_fallback", 0),
         "cold_s": round(seconds[0], 3), "warm_s": round(seconds[1], 3),
         "card": card,
         # stage timers of the warm encode (threads overlap: the stages
         # need not sum to warm_s)
         "warm_stages_s": {k: round(v, 3) for k, v in
                           sorted(stats.stage_seconds.items())}}
    if save_dir:
        with open(os.path.join(save_dir, slug(name) + ".jxl"), "wb") as f:
            f.write(data)
    if decode:
        r.update(psnr_vs_numpy(name, img, mode, data, tmpdir))
    return r


def e2e_cases(scale: int = 1):
    """(name, image, mode) at the real sizes; scale > 1 divides every
    side for a small rehearsal."""
    from bench import make_4k_noisy

    def px(h, w, dtype=np.uint8, seed=3):
        return photo(h // scale, w // scale, dtype, seed)

    return [
        ("3840x2160 u8 photo one-frame", px(2160, 3840), "api"),
        ("3840x2160 u8 noise one-frame",
         make_4k_noisy()[:2160 // scale, :3840 // scale], "api"),
        ("1920x1080 u8 photo tiled shift 0", px(1080, 1920, seed=5),
         "tiled"),
        ("7680x4320 u16 photo one-frame", px(4320, 7680, np.uint16, 6),
         "api"),
        ("1920x1080 f32 linear PFM via CLI",
         px(1080, 1920, np.float32, 8), "cli-pfm"),
    ]


def phase_e2e(card: str, scale: int = 1, save_dir: str = None) -> None:
    err = libjxl_error()
    if err is not None:
        print(f"libjxl not loadable ({err}): no decode or PSNR checks; "
              f"phases 1-2 carry correctness", flush=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as td:
        for name, img, mode in e2e_cases(scale):
            t0 = time.perf_counter()
            r = e2e_case(name, img, mode, card, td, decode=err is None,
                         save_dir=save_dir)
            say("3 e2e", f"{name}: {json.dumps(r)}", t0)


# -- --four -----------------------------------------------------------------

FOUR_CASE = "8192x8192 u8 photo sharded over 4 cards"


def four_card(devices, size: int = 8192, save_dir: str = None) -> dict:
    """The sharded one-frame encode (parallel/driver.py) over a flat mesh
    of `devices` against the one-card Encoder on the same image."""
    from hydrium_tpu import encode_image
    from hydrium_tpu.parallel import shard
    from hydrium_tpu.parallel.driver import encode_image_sharded
    from hydrium_tpu.utils import djxl

    img = photo(size, size)
    mesh = shard.make_mesh(devices=devices)
    seconds = []
    for _ in range(2):                  # cold (compiles), then warm
        t0 = time.perf_counter()
        sharded = encode_image_sharded(img, mesh=mesh)
        seconds.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    single = encode_image(img, tile_size_shift=-1, backend="jax")
    r = {"devices": len(devices), "bytes": len(sharded),
         "identical": sharded == single,
         "sharded_cold_s": round(seconds[0], 3),
         "sharded_warm_s": round(seconds[1], 3),
         "single_s": round(time.perf_counter() - t0, 3)}
    if save_dir:
        with open(os.path.join(save_dir, slug(FOUR_CASE) + ".jxl"),
                  "wb") as f:
            f.write(sharded)
        if sharded != single:
            with open(os.path.join(save_dir, slug(FOUR_CASE)
                                   + "_single.jxl"), "wb") as f:
                f.write(single)
    if not r["identical"]:
        n = min(len(sharded), len(single))
        a = np.frombuffer(sharded[:n], np.uint8)
        b = np.frombuffer(single[:n], np.uint8)
        r["differing_bytes"] = int(np.sum(a != b)) + abs(len(sharded)
                                                         - len(single))
    if libjxl_error() is None:
        sig = _signal(img)
        r["psnr_sharded"] = round(djxl.psnr(sig, djxl.decode(sharded)), 4)
        if not r["identical"]:
            r["psnr_single"] = round(djxl.psnr(sig, djxl.decode(single)),
                                     4)
            check(abs(r["psnr_sharded"] - r["psnr_single"])
                  <= PSNR_SLACK_DB, f"sharded PSNR off: {r}")
    else:
        check(r["identical"], f"sharded bytes differ and libjxl is "
                              f"not loadable: {r}")
    return r


# -- main -------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-card sharded encode and its "
                         "one-card comparison")
    ap.add_argument("--save", metavar="DIR", default=None,
                    help="also write each encoded .jxl to DIR")
    args = ap.parse_args(argv)

    import jax

    if jax.devices()[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX runs on "
              f"{jax.devices()[0].platform})", file=sys.stderr)
        return 2
    t_all = time.perf_counter()
    try:
        dev = phase_device()
        from hydrium_tpu.utils.device import nvidia_smi_line

        card = nvidia_smi_line()
        if args.save:
            os.makedirs(args.save, exist_ok=True)
        if args.four:
            check(dev["count"] >= 4, f"--four needs 4 GPUs, found "
                                     f"{dev['count']}")
            t0 = time.perf_counter()
            r = four_card(jax.devices()[:4], save_dir=args.save)
            say("four", f"{FOUR_CASE}: {json.dumps(r)}; {card}", t0)
        else:
            phase_parity()
            phase_reference()
            phase_e2e(card, save_dir=args.save)
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(f"all phases passed in {time.perf_counter() - t_all:.1f} s; "
          f"{card}", flush=True)
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
