"""Streaming JPEG XL encoder orchestration.

Preserves the reference's streaming API contract (libhydrium.h:165-314):
metadata first, then tiles in any order (`send_tile`), encoded bytes
drained incrementally (`take_output`).  Two modes, as in the reference:

- tiled mode (tile_size_shift >= 0): every tile is an independent
  cropped frame (kSkipProgressive except the last); constant memory.
- one-frame mode (shift = -1): the whole image is a single frame of
  2048x2048 LF groups; tiles may arrive in any order and the TOC is
  permuted to match arrival (encoder.c:241-325).

The math backend is pluggable: "numpy" (exact float32 parity with the
reference, used by differential tests) or "jax" (the device pipeline
of ops/pipeline.py).  Deviation from the reference, by design: in
one-frame mode all per-group ANS sections are encoded at finalize time
with the final log_alphabet_size, instead of per-preset mid-stream.
The reference encodes each preset batch with the log_alphabet_size
known *so far* (entropy.c:1073) while the shared histogram header is
written last with the final value (encoder.c:965); if a later tile
enlarges the token alphabet past a power of two, its earlier sections
become undecodable.
Encoding at finalize produces identical bytes whenever the reference's
output is self-consistent, and correct output always.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from .config import ImageMetadata, SampleFormat
from .jxl.bitwriter import BitWriter
from .jxl import headers
from .jxl.frame import (FrameGeometry, HFStream, LFGroupGeometry,
                        StreamingHFStream, TOC_TABLE, new_bitwriter,
                        write_frame_header, write_lf_global, write_lf_group)
from .ops import reference as np_ops
from .ops.hf_tokens import tokenize_group
from .utils.stats import EncodeStats


def _lfg_numpy(pixels, sample_fmt, linear_light, lfg, preset, hf,
               codec=None, stats=None):
    """Numpy conformance backend: computes, tokenizes, and feeds the HF
    stream; returns (lf_q, lf_res_packed_or_None)."""
    xyb = np_ops.pixels_to_xyb(pixels, sample_fmt, linear_light)
    xyb = np_ops.pad_to_blocks(xyb, lfg.height, lfg.width)
    coeffs = np_ops.forward_dct(xyb)
    zz = np_ops.zigzag_gather(coeffs)
    hf_q, nz = np_ops.quantize_hf(zz)
    lf_q = np_ops.quantize_lf(coeffs[:, :, 0, 0, :])
    for gy, gx, gh, gw in lfg.groups():
        gb = (slice(gy * 32, gy * 32 + ((gh + 7) >> 3)),
              slice(gx * 32, gx * 32 + ((gw + 7) >> 3)))
        tok = tokenize_group(hf_q[gb], nz[gb], preset, hf.cluster_map)
        hf.add_group_padded(tok.tokens, tok.clusters, tok.residues,
                            tok.residue_bits, tok.valid_len, preset)
    return lf_q, None


_SLICERS: dict = {}


def tables_hf_cluster_map_1():
    from .ops import tables

    return tables.hf_cluster_map(1)


_SHARED_CODEC = None
_WARM_CACHE = os.path.expanduser("~/.cache/hydrium_tpu/warm.npz")


def _shared_codec():
    """One adaptive transport codec per process, shared across Encoders:
    the code never affects output bytes, only transfer size, and a warm
    code saves ~1 bit/symbol over the generic prior on the first LF
    groups of every subsequent encode.  State persists across processes
    (~/.cache/hydrium_tpu) -- stale state costs compression until
    adaptation catches up, never correctness."""
    global _SHARED_CODEC
    if _SHARED_CODEC is None:
        from .jxl.tokcode import TokenCodec

        _SHARED_CODEC = TokenCodec(cache_path=_WARM_CACHE)
        _load_warm_hints()
    return _SHARED_CODEC


def _save_warm_state() -> None:
    """Persist the codec and the fetch-sizing hints (best effort,
    called at encode finalize).  The hints only affect transfer
    scheduling -- a stale hint costs one ranged top-up or a skipped
    group fetch, never correctness -- and persisting them lets a fresh
    process (a one-shot CLI encode) take the frame-level single fetch
    and the wide residue executable on its FIRST encode."""
    try:
        if _SHARED_CODEC is not None and not _SHARED_CODEC.cold:
            _SHARED_CODEC.save(_WARM_CACHE)
        import json as _json

        hints = {
            "need": {f"{h}x{w}": v for (h, w), v in
                     _JaxDispatch._NEED_HINT.items()},
            "wide": [f"{h}x{w}x{f}" for (h, w, f), v in
                     _JaxDispatch._WIDE_HINT.items() if v],
        }
        with open(_WARM_CACHE + ".hints.json", "w") as f:
            _json.dump(hints, f)
    except Exception:
        pass


def _load_warm_hints() -> None:
    try:
        import json as _json

        with open(_WARM_CACHE + ".hints.json") as f:
            hints = _json.load(f)
        for k, v in hints.get("need", {}).items():
            h, w = k.split("x")
            _JaxDispatch._NEED_HINT.setdefault((int(h), int(w)), int(v))
        for k in hints.get("wide", []):
            h, w, fmt = k.split("x")
            _JaxDispatch._WIDE_HINT.setdefault((int(h), int(w), fmt),
                                               True)
    except Exception:
        pass


def _bucket_words(n: int, cap: int) -> int:
    """Smallest m * 2^k >= n with m in 16..32: bounds fetch over-read to
    ~3% while keeping the set of compiled slicers bounded (16/octave,
    cached persistently)."""
    if n >= cap:
        return cap
    if n <= 32:
        return n
    k = (n - 1).bit_length() - 5
    return min((((n + (1 << k) - 1) >> k) << k), cap)


_FETCH_DEBUG = os.environ.get("HYDRIUM_FETCH_DEBUG") == "1"


def _slice_once(arr, start: int, n: int) -> np.ndarray:
    """One device->host slice read: dynamic start, bucketed static
    length (so each buffer size compiles a handful of slicers)."""
    import jax

    b = _bucket_words(n, arr.shape[0])
    key = ("rng", int(arr.shape[0]), b, str(arr.dtype))
    f = _SLICERS.get(key)
    if f is None:
        f = jax.jit(lambda a, s0, _b=b: jax.lax.dynamic_slice(a, (s0,), (_b,)))
        _SLICERS[key] = f
    s0 = min(start, arr.shape[0] - b)
    off = start - s0
    if _FETCH_DEBUG:
        import sys
        import time

        t0 = time.perf_counter()
        dev = f(arr, s0)
        t1 = time.perf_counter()
        out = np.asarray(dev)
        t2 = time.perf_counter()
        print(f"  stripe s0={s0} n={n} b={b}: exec {1e3*(t1-t0):.1f}ms "
              f"d2h {1e3*(t2-t1):.1f}ms ({4*b/1e6/(t2-t1):.1f} MB/s)",
              file=sys.stderr, flush=True)
        return out[off:off + n]
    return np.asarray(f(arr, s0))[off:off + n]


# Large fetches are striped across a small thread pool of parallel
# slice reads.  256K words (1 MB) per stripe keeps the slicer cache tiny
# (every interior stripe shares one executable).
_STRIPE_WORDS = 256 * 1024
_FETCH_POOL = None


def _fetch_pool():
    global _FETCH_POOL
    if _FETCH_POOL is None:
        from concurrent.futures import ThreadPoolExecutor

        _FETCH_POOL = ThreadPoolExecutor(max_workers=8,
                                         thread_name_prefix="hyd-fetch")
    return _FETCH_POOL


# Large pixel uploads are striped the same way: concurrent device_puts
# of 2 MB row chunks, reassembled on device by a per-shape jitted concat
# (cached, and tiny next to the pipeline executable each buffer shape
# already compiles).
_H2D_POOL = None
_H2D_STRIPE_BYTES = 2 << 20
_CONCATS: dict = {}


def _h2d_pool():
    global _H2D_POOL
    if _H2D_POOL is None:
        from concurrent.futures import ThreadPoolExecutor

        _H2D_POOL = ThreadPoolExecutor(max_workers=8,
                                       thread_name_prefix="hyd-h2d")
    return _H2D_POOL


# dispatch-preparation pool (pxpack + upload + pipeline dispatch per LF
# group, see _JaxDispatch._prepare).  Separate from _H2D_POOL: _prepare
# blocks on futures it submits THERE, so sharing one pool could starve.
_PREP_POOL = None


def _prep_pool():
    global _PREP_POOL
    if _PREP_POOL is None:
        from concurrent.futures import ThreadPoolExecutor

        _PREP_POOL = ThreadPoolExecutor(max_workers=2,
                                        thread_name_prefix="hyd-prep")
    return _PREP_POOL


def _upload_pixels(px: np.ndarray):
    """Transfer an [H, W, 3] host array to the device, striping rows
    across concurrent puts when large enough to benefit."""
    import jax
    import jax.numpy as jnp

    if px.nbytes <= 2 * _H2D_STRIPE_BYTES:
        return jnp.asarray(px)
    row_bytes = px.nbytes // px.shape[0]
    # 32-row multiples keep the chunking deterministic per buffer shape
    # (one concat executable per (shape, dtype))
    rows = max(32, ((_H2D_STRIPE_BYTES // row_bytes) >> 5) << 5)
    starts = list(range(0, px.shape[0], rows))
    futs = [_h2d_pool().submit(jax.device_put, px[s:s + rows])
            for s in starts]
    chunks = [f.result() for f in futs]
    key = (px.shape, str(px.dtype), rows)
    f = _CONCATS.get(key)
    if f is None:
        f = jax.jit(lambda *cs: jnp.concatenate(cs, axis=0))
        _CONCATS[key] = f
    return f(*chunks)


def _pxpack_on() -> bool:
    """PXPACK v1 packed pixel uploads (HYDRIUM_PXPACK=0 disables): the
    host bitpacks u8/u16 pixels (cpp hyd_px_pack) and the device unpacks
    (ops/pipeline._unpack_px_planes), cutting h2d bytes ~2-4x on real
    content; noisy content that would not shrink below 85% of raw
    automatically falls back to the raw upload per LF group."""
    return os.environ.get("HYDRIUM_PXPACK", "1") != "0"


def _bucket_pxwords(n: int, floor: int = 1 << 16) -> int:
    """Pad packed-pixel word counts to {2^k, 1.5*2^k} buckets: each
    bucket is one compiled executable of the whole pipeline, and the
    padded tail of zeros is cheap to upload.  The level-2 meta stream
    (px_pack2) uses a smaller floor -- it is ~20-50x smaller than the
    pixel planes."""
    b = floor
    while b < n:
        if n <= (b * 3) >> 1:
            return (b * 3) >> 1
        b <<= 1
    return b


def _upload_flat(a: np.ndarray):
    """Striped upload of a 1-D array (the packed-pixel word stream),
    mirroring _upload_pixels' row striping + cached device concat."""
    import jax
    import jax.numpy as jnp

    if a.nbytes <= 2 * _H2D_STRIPE_BYTES:
        return jnp.asarray(a)
    elems = max(1 << 16, ((_H2D_STRIPE_BYTES // a.itemsize) >> 10) << 10)
    starts = list(range(0, a.shape[0], elems))
    futs = [_h2d_pool().submit(jax.device_put, a[s:s + elems])
            for s in starts]
    chunks = [f.result() for f in futs]
    key = (a.shape, str(a.dtype), elems)
    f = _CONCATS.get(key)
    if f is None:
        f = jax.jit(lambda *cs: jnp.concatenate(cs, axis=0))
        _CONCATS[key] = f
    return f(*chunks)


def _fetch_range(arr, start: int, length: int) -> np.ndarray:
    """Fetch arr[start:start+length(+1)], striped into concurrent slice
    reads when large enough to benefit."""
    n = min(length + 1, arr.shape[0] - start)
    if n <= 2 * _STRIPE_WORDS:
        return _slice_once(arr, start, n)
    starts = list(range(0, n - _STRIPE_WORDS + 1, _STRIPE_WORDS))
    tail = n - (starts[-1] + _STRIPE_WORDS)
    futs = [_fetch_pool().submit(_slice_once, arr, start + s, _STRIPE_WORDS)
            for s in starts]
    if tail:
        futs.append(_fetch_pool().submit(_slice_once, arr,
                                         start + n - tail, tail))
    return np.concatenate([f.result() for f in futs])


def _fetch_prefix(arr, nwords: int) -> np.ndarray:
    """Fetch arr[:nwords] (+1 safety word)."""
    return _fetch_range(arr, 0, min(nwords, arr.shape[0] - 1))


def _parse_packed(aux: np.ndarray, words, buf_h: int, buf_w: int, lfg,
                  lf_lut=None):
    """Decode one packed v4 aux payload (+ fetched stream words) into
    the pieces the serializer needs; None when the ok flag is unset or
    the LF stream fails to decode.

    lf_lut: u16[4096] class-9 transport decode LUT snapshotted from the
    dispatch that packed this payload (jxl/tokcode.py LF_CLASS row);
    required when `words` is given (the LF residual stream is hybrid-
    uint transport-coded in format v4).

    Layout contract: ops/pipeline.py encode_lfg_packed (see its module
    comment), cpp/serializer.cc hyd_hf_add_lfg_packed / hyd_lf_decode,
    and parallel/driver.py change together with this function."""
    if not bool(aux[0] & 1):
        return None
    G = (buf_h >> 8) * (buf_w >> 8)
    vbh, vbw = buf_h >> 3, buf_w >> 3
    vh, vw = (lfg.height + 7) >> 3, (lfg.width + 7) >> 3
    tok_total, res_total, lf_total = int(aux[1]), int(aux[2]), int(aux[3])
    S = 8  # pipeline.AUX_SCALARS
    hist = aux[S:S + 640]        # [10, 64] per-class transport histogram
    o = S + 640
    gs = aux[o:o + G].astype(np.int64)
    gr = aux[o + G:o + 2 * G].astype(np.int64)
    gt = aux[o + 2 * G:o + 3 * G].astype(np.int64)
    lf_n = vbh * vbw * 3
    lf_used = (lf_total + 31) >> 5
    tok_used = (tok_total + 31) >> 5
    res_used = (res_total + 31) >> 5
    out = {
        "hist": hist, "gs": gs, "gr": gr,
        "tok_off": np.cumsum(gt) - gt, "res_off": np.cumsum(gr) - gr,
        "need_words": lf_used + tok_used + res_used,
        "lf_res": None, "tok_words": None, "res_words": None,
    }
    if words is not None:
        from .jxl import native

        lf_flat = native.lf_decode(words, lf_lut, lf_n, lf_total)
        if lf_flat is None:
            return None
        out["lf_res"] = lf_flat.reshape(vbh, vbw, 3)[:vh, :vw]
        out["tok_words"] = words[lf_used:lf_used + tok_used + 1]
        out["res_words"] = np.ascontiguousarray(
            words[lf_used + tok_used:])
    return out


def packed_need_words(aux: np.ndarray, buf_h: int, buf_w: int) -> int:
    """Stream word count (past the aux prefix) for a v4 aux payload."""
    return (((int(aux[3]) + 31) >> 5) + ((int(aux[1]) + 31) >> 5)
            + ((int(aux[2]) + 31) >> 5))


def packed_verify(aux: np.ndarray, words, buf_h: int, buf_w: int) -> bool:
    """Check the device-computed wrap-sum checksums of a v4 payload: the
    aux tail always, and the three stream sections when `words` (the
    region past the aux prefix) is given.  Guards against transfer
    corruption (the LF section otherwise has no
    self-consistency check at all)."""
    u = aux.view(np.uint32)
    if int(np.sum(u[8:], dtype=np.uint32)) != int(u[4]):
        return False
    if words is None or not bool(aux[0] & 1):
        return True
    wu = words.view(np.uint32)
    lf_used = (int(aux[3]) + 31) >> 5
    tok_used = (int(aux[1]) + 31) >> 5
    res_used = (int(aux[2]) + 31) >> 5
    if int(np.sum(wu[:lf_used], dtype=np.uint32)) != int(u[5]):
        return False
    if int(np.sum(wu[lf_used:lf_used + tok_used],
                  dtype=np.uint32)) != int(u[6]):
        return False
    if int(np.sum(wu[lf_used + tok_used:lf_used + tok_used + res_used],
                  dtype=np.uint32)) != int(u[7]):
        return False
    return True


# cap on speculative over-read: a wrong small-payload hint costs at most
# this many extra words (256 KB) fetched
_SPEC_CAP_WORDS = 64 * 1024

# frame-level single fetch (see _FetchGroup): how long a forced arm
# (the drain worker needing a member) waits for more members to
# register before fetching with what it has.  Also the deadlock safety
# net: a group ALWAYS arms within this bound.
_GROUP_FETCH_WAIT_S = float(os.environ.get(
    "HYDRIUM_GROUP_FETCH_WAIT_MS", "250")) / 1e3


def _group_fetch_on() -> bool:
    return os.environ.get("HYDRIUM_GROUP_FETCH", "1") != "0"


def fetch_packed_payload(combined, buf_h: int, buf_w: int, stats=None,
                         hint_words: int = 0):
    """Fetch one combined packed payload from a device array ->
    (aux, words_or_None).

    Exact two-phase protocol: a tiny aux-prefix read (~3 KB) yields the
    exact stream length, then ONE ranged fetch pulls exactly that many
    words (a hint-sized prefix fetch would over-fetch by megabytes
    whenever content statistics shift between LF groups).

    Small-payload shortcut: when `hint_words` (the previous LF group's
    stream length) is small, the first read speculatively covers
    aux + min(bucketed hint, _SPEC_CAP_WORDS) and the ranged fetch only
    tops up the (rare) shortfall -- one read per LF group on smooth
    content, exact fetch on noisy.

    `combined` may be any 1-D device array (a single-device output or
    one shard's device-local data).  words is None when the aux is
    corrupt or the ok flag is unset."""
    from .ops.pipeline import packed_aux_len

    A = packed_aux_len(buf_h, buf_w)
    spec = min(int(hint_words), _SPEC_CAP_WORDS,
               combined.shape[0] - A - 1) if hint_words > 0 else 0
    first = _fetch_prefix(combined, A + spec)
    aux = np.ascontiguousarray(first[:A]).view(np.int32)
    words = None
    if not packed_verify(aux, None, buf_h, buf_w):
        # corrupt aux: do not trust its stream sizes (a garbage length
        # would trigger a giant range fetch)
        return aux, None
    if bool(aux[0] & 1):
        need = packed_need_words(aux, buf_h, buf_w)
        have = first.shape[0] - A
        if have >= need + 1:
            words = first[A:A + need + 1]
        elif have > 0 and need - have >= 0:
            top = _fetch_range(combined, A + have, need - have)
            words = np.concatenate([first[A:], top])
        else:
            words = _fetch_range(combined, A, need)
        if stats is not None:
            stats.count("fetched_words", A + max(spec, need) + 1)
            stats.count("lf_words", (int(aux[3]) + 31) >> 5)
            stats.count("tok_words", (int(aux[1]) + 31) >> 5)
            stats.count("res_words", (int(aux[2]) + 31) >> 5)
    return aux, words


# ---------------------------------------------------------------------------
# frame-level single fetch: collapse the per-LFG payload reads
# ---------------------------------------------------------------------------
#
# When every in-flight payload is expected small (the same hint
# threshold that already lets small fetches skip the fetch semaphore),
# the frame's payloads are compacted into ONE device buffer and pulled
# with ONE speculative read:
#
#   [aux_0 | aux_1 | .. | aux_{K-1} | streams_0 | streams_1 | ..]
#
# Aux prefixes sit at static offsets (their lengths depend only on each
# LF group's buffer shape); each payload's stream section is placed at
# A_total + cumsum(used_words) by ascending dynamic_update_slice writes,
# where used is computed ON DEVICE from the payload's own aux totals
# (min-clamped to the cap region so an overflowed ok=0/2 payload cannot
# shift its successors; the host applies the identical clamp).  Writing
# in ascending offset order means each payload's used region is written
# last by its own full-cap-window update, so inter-payload garbage can
# never land inside another payload's used region.
#
# Reference contrast: the reference's one-frame mode accumulates all
# groups and flushes once (encoder.c:752-1003); this is the device
# analogue -- one device->host read per frame instead of per LF group.

_FRAME_COMBINE: dict = {}


def _frame_combine(outs, A_list):
    """Device-concat K combined packed payloads (see comment above).
    outs: list of 1-D u32 device arrays; A_list: per-payload aux length.
    Returns the combined device array of length sum(len(out))."""
    import jax
    import jax.numpy as jnp

    key = tuple(A_list)
    fn = _FRAME_COMBINE.get(key)
    if fn is None:
        def combine(*cs):
            A_total = sum(A_list)
            total = sum(c.shape[0] for c in cs)
            out = jnp.zeros((total,), jnp.uint32)
            aoff = 0
            off = jnp.int32(A_total)
            for c, A in zip(cs, A_list):
                used = (((c[1] + 31) >> 5) + ((c[2] + 31) >> 5)
                        + ((c[3] + 31) >> 5))
                used = jnp.minimum(
                    used, jnp.uint32(c.shape[0] - A)).astype(jnp.int32)
                out = jax.lax.dynamic_update_slice(out, c[:A], (aoff,))
                out = jax.lax.dynamic_update_slice(out, c[A:], (off,))
                aoff += A
                off = off + used
            return out

        fn = jax.jit(combine)
        _FRAME_COMBINE[key] = fn
    return fn(*outs)


def group_fetch_payloads(outs, shapes, hints, stats=None):
    """Fetch K compacted packed payloads in one read.

    outs: list of combined device arrays; shapes: [(buf_h, buf_w)];
    hints: per-payload expected stream words (>0).  Returns a list of
    (aux, words_or_None) the same length as `outs`: entries are None
    (not a tuple) from the first anomaly onward -- a corrupt aux means
    its used-length cannot be trusted, so every SUBSEQUENT payload's
    offset is unknowable and the caller must refetch those individually
    (their own device buffers are still live)."""
    from .ops.pipeline import packed_aux_len

    A_list = [packed_aux_len(bh, bw) for bh, bw in shapes]
    A_total = sum(A_list)
    caps = [int(o.shape[0]) - a for o, a in zip(outs, A_list)]
    dev = _frame_combine(outs, A_list)
    spec = sum(min(int(h), _SPEC_CAP_WORDS) for h in hints)
    first = _fetch_prefix(dev, A_total + spec)
    results: list = []
    auxes = []
    aoff = 0
    for a in A_list:
        auxes.append(np.ascontiguousarray(
            first[aoff:aoff + a]).view(np.int32))
        aoff += a
    # host-side offsets mirror the device's clamped arithmetic exactly
    used = []
    ok_upto = len(outs)
    for k, aux in enumerate(auxes):
        if first.shape[0] < A_total or not packed_verify(
                aux, None, shapes[k][0], shapes[k][1]):
            ok_upto = k
            break
        used.append(min(packed_need_words(aux, *shapes[k]), caps[k]))
    need = A_total + sum(used)
    if ok_upto > 0 and first.shape[0] < need + 1:
        top = _fetch_range(dev, first.shape[0],
                           need + 1 - first.shape[0])
        first = np.concatenate([first, top])
    if stats is not None:
        stats.count("fetched_words", max(first.shape[0], need + 1))
    off = A_total
    for k in range(len(outs)):
        if k >= ok_upto:
            results.append(None)
            continue
        aux = auxes[k]
        words = None
        if bool(aux[0] & 1):
            words = first[off:off + used[k] + 1]
            if stats is not None:
                stats.count("lf_words", (int(aux[3]) + 31) >> 5)
                stats.count("tok_words", (int(aux[1]) + 31) >> 5)
                stats.count("res_words", (int(aux[2]) + 31) >> 5)
        results.append((aux, words))
        off += used[k]
    return results


def _feed_hf_packed(hf, parsed, lfg, buf_w: int, buf_h: int, preset: int,
                    tok_lut) -> None:
    """Feed a parsed packed payload into an HF stream (bulk-threaded C++
    walk; the walker handles partial grids itself)."""
    hf.add_lfg_packed(parsed["tok_words"], parsed["res_words"], tok_lut,
                      preset, (buf_h >> 8, buf_w >> 8),
                      (lfg.varblock_height, lfg.varblock_width),
                      parsed["tok_off"], parsed["res_off"], parsed["gs"])


def _pxp_pack_upload(px: np.ndarray, sample_fmt: str, stats=None,
                     ev=None, tag: str = ""):
    """Host-bitpack a pixel buffer (PXPACK v2, px1 fallback) and upload
    the packed streams; returns the tagged device tuple _dispatch_px
    consumes, or None when the content should upload raw.  Shared by
    the one-frame _JaxDispatch path and the tiled stacked-chunk path."""
    import contextlib

    import jax.numpy as jnp

    if not _pxpack_on() or sample_fmt not in ("uint8", "uint16"):
        return None
    from .jxl import native as _native

    ev = ev or (lambda _n: contextlib.nullcontext())
    with ev(f"pxpack[{tag}]"):
        pxp = _native.px_pack2(px)
    if pxp is None:
        return None
    if pxp[0] == "px2":
        _, words, hdr2, base2, words2, meta_h, meta_w = pxp
        nw = _bucket_pxwords(max(words.size, 1))
        wpad = np.zeros(nw, np.uint32)
        wpad[:words.size] = words
        nw2 = _bucket_pxwords(max(words2.size, 1), floor=1 << 12)
        w2pad = np.zeros(nw2, np.uint32)
        w2pad[:words2.size] = words2
        with ev(f"h2d[{tag}]"):
            dev = ("px2", _upload_flat(wpad), jnp.asarray(hdr2),
                   jnp.asarray(base2), jnp.asarray(w2pad), meta_h, meta_w)
        if stats is not None:
            stats.count("pxpack_lfgs")
            stats.count("pxpack_words", int(words.size))
            stats.count("pxpack_meta_words",
                        int(words2.size) + (hdr2.size * 3 + 3) // 4)
        return dev
    _, words, hdr, basearr = pxp
    nw = _bucket_pxwords(max(words.size, 1))
    wpad = np.zeros(nw, np.uint32)
    wpad[:words.size] = words
    with ev(f"h2d[{tag}]"):
        dev = ("px1", _upload_flat(wpad), jnp.asarray(hdr),
               jnp.asarray(basearr))
    if stats is not None:
        stats.count("pxpack_lfgs")
        stats.count("pxpack_words", int(words.size))
        stats.count("pxpack_meta_words",
                    (hdr.nbytes + basearr.nbytes + 3) // 4)
    return dev


def _dispatch_px(pxp_dev, height, width, presets_dev, cm_dev, lens, codes,
                 *, ubuf_h: int, ubuf_w: int, wide: bool, kwargs: dict):
    """Dispatch the packed-pixel pipeline for an uploaded _pxp_pack_upload
    tuple (px2 or px1 form)."""
    import jax.numpy as jnp
    from .ops.pipeline import encode_lfg_packed_px, encode_lfg_packed_px2

    if pxp_dev[0] == "px2":
        _, words, hdr2, base2, words2, meta_h, meta_w = pxp_dev
        return encode_lfg_packed_px2(
            words, hdr2, base2, words2, height, width, presets_dev, cm_dev,
            jnp.asarray(lens), jnp.asarray(codes), ubuf_h=ubuf_h,
            ubuf_w=ubuf_w, meta_h=meta_h, meta_w=meta_w,
            wide_residues=wide, **kwargs)
    _, words, hdr, basearr = pxp_dev
    return encode_lfg_packed_px(
        words, hdr, basearr, height, width, presets_dev, cm_dev,
        jnp.asarray(lens), jnp.asarray(codes), ubuf_h=ubuf_h,
        ubuf_w=ubuf_w, wide_residues=wide, **kwargs)


class _JaxDispatch:
    """An in-flight LF group on the device (packed-payload path)."""

    __slots__ = ("out", "lfg", "preset", "buf_h", "buf_w", "kwargs",
                 "presets_dev", "cm_dev", "px", "_aux", "_words",
                 "_pf_thread", "_pf_ran", "_hist_folded", "tok_lut",
                 "lf_lut", "_codec", "stats", "_wide", "_tag", "_future",
                 "_px_host", "_pxp_dev", "_ubuf", "will_pack",
                 "_sample_fmt", "_cm_host", "_prep_future", "_group",
                 "_pf_error")

    # shapes whose content needed the wide residue executable
    _WIDE_HINT: dict = {}
    # last stream length per buffer shape: feeds the bounded speculative
    # first read of fetch_packed_payload (one read per LF group on small
    # payloads instead of aux-then-range)
    _NEED_HINT: dict = {}

    def __init__(self, pixels, sample_fmt, linear_light, lfg, preset, hf,
                 codec=None, stats=None):
        import jax.numpy as jnp
        from .ops.pipeline import encode_lfg_packed

        h, w = lfg.height, lfg.width
        # bucket the device buffer to 256-multiples of the true extent:
        # edge LF groups stop paying full-buffer compute/payload
        buf_h = min(lfg.tile_count_y << 8, ((h + 255) >> 8) << 8)
        buf_w = min(lfg.tile_count_x << 8, ((w + 255) >> 8) << 8)
        # ...and upload only a 32-bucketed extent (padded to the group
        # buffer on device): the skipped rows/cols are zeros by contract
        ubuf_h = min(buf_h, ((h + 31) >> 5) << 5)
        ubuf_w = min(buf_w, ((w + 31) >> 5) << 5)
        px = np.zeros((ubuf_h, ubuf_w, 3), dtype=np.asarray(pixels).dtype)
        px[:h, :w] = pixels[:h, :w]
        self.lfg = lfg
        self._tag = f"{lfg.y},{lfg.x}"
        self.preset = preset
        self.stats = stats
        self.buf_h, self.buf_w = buf_h, buf_w
        # sticky per-(shape, format) wideness: once one LF group needed
        # the wide (24 b/slot) residue executable, later LF groups skip
        # the doomed narrow dispatch (wide output is always valid, just
        # a little slower to pack)
        self._wide = _JaxDispatch._WIDE_HINT.get(
            (buf_h, buf_w, sample_fmt), False)
        bgcy, bgcx = buf_h >> 8, buf_w >> 8
        num_clusters = int(hf.cluster_map.max()) + 1
        self.kwargs = dict(buf_h=buf_h, buf_w=buf_w,
                           linear_light=linear_light,
                           num_clusters=num_clusters, sample_kind=sample_fmt,
                           tok_classes=num_clusters // hf.num_presets)
        # cluster map snapshot (host); device consts upload in _prepare
        self._cm_host = hf.cluster_map
        self.presets_dev = None
        self.cm_dev = None
        ev = (stats.event if stats is not None
              else (lambda _n: __import__("contextlib").nullcontext()))
        self._ubuf = (ubuf_h, ubuf_w)
        self._px_host = px
        self._pxp_dev = None
        self.px = None
        self.out = None
        self.will_pack = bool(hf.use_native)
        self._sample_fmt = sample_fmt
        if hf.use_native:
            from .jxl.tokcode import TokenCodec

            if codec is None:
                codec = TokenCodec()
            self._codec = codec
        else:
            self._codec = None
            self.tok_lut = None
            self.lf_lut = None
        self._aux = None
        self._words = None
        self._pf_thread = None
        self._pf_ran = False
        self._pf_error = None
        self._hist_folded = False
        self._group = None
        # pxpack + upload + pipeline dispatch run on a worker so the
        # main thread returns in ~ms and the FIRST LF group's payload
        # fetch is not delayed behind later groups' host bitpacking.
        # The host pixel copy above stays synchronous: callers may
        # reuse their strip buffer right after send_tile returns.
        self._prep_future = _prep_pool().submit(self._prepare, ev)

    def _prepare(self, ev) -> None:
        """Runs on the prep pool: bitpack pixels (or not), upload, and
        dispatch the packed pipeline.  prefetch()/drain() join this
        via join_prepare() before touching self.out/self.px."""
        import jax.numpy as jnp

        bgcy, bgcx = self.buf_h >> 8, self.buf_w >> 8
        self.presets_dev = jnp.full((bgcy * bgcx,), self.preset, jnp.int32)
        self.cm_dev = jnp.asarray(self._cm_host)
        px = self._px_host
        if self.will_pack:
            self._pxp_dev = _pxp_pack_upload(px, self._sample_fmt,
                                             stats=self.stats, ev=ev,
                                             tag=self._tag)
        if self._pxp_dev is None:
            with ev(f"h2d[{self._tag}]"):
                self.px = _upload_pixels(px)
            if self.stats is not None:
                self.stats.count("h2d_raw_bytes", px.nbytes)
        if self.will_pack:
            # dispatch is async (jax returns futures); transfers start at
            # prefetch/drain time
            with ev(f"dispatch[{self._tag}]"):
                self._dispatch()

    def join_prepare(self) -> None:
        if self._prep_future is not None:
            self._prep_future.result()
            self._prep_future = None

    def _dispatch(self) -> None:
        """(Re)dispatch the packed pipeline with a snapshot of the
        codec's current transport code: the walker must decode with
        exactly the table the device packed with, even though the codec
        adapts between dispatches."""
        import jax.numpy as jnp
        from .ops.pipeline import encode_lfg_packed

        from .jxl.tokcode import LF_CLASS

        lens, codes, lut = self._codec.tables()
        # slice the LUT to this frame's class count so the walker's
        # class = cluster %% (lut.size/4096) matches the device's
        # class = cluster %% tok_classes exactly; the LF residual
        # stream decodes with the LF_CLASS row of the SAME snapshot
        self.tok_lut = lut[:self.kwargs["tok_classes"]]
        self.lf_lut = lut[LF_CLASS]
        if self._pxp_dev is not None:
            self.out = _dispatch_px(
                self._pxp_dev, self.lfg.height, self.lfg.width,
                self.presets_dev, self.cm_dev, lens, codes,
                ubuf_h=self._ubuf[0], ubuf_w=self._ubuf[1],
                wide=self._wide, kwargs=self.kwargs)
        else:
            self.out = encode_lfg_packed(
                self.px, self.lfg.height, self.lfg.width, self.presets_dev,
                self.cm_dev, jnp.asarray(lens), jnp.asarray(codes),
                wide_residues=self._wide, **self.kwargs)

    def start_prefetch(self, sem) -> None:
        """Run prefetch() on a daemon thread; `sem` serializes large
        payload fetches across in-flight handles.  An exception on the
        thread is re-raised by join_prefetch()."""
        import contextlib
        import threading

        ev = (self.stats.event if self.stats is not None
              else (lambda _n: contextlib.nullcontext()))

        def fetch():
            self.join_prepare()
            # the semaphore keeps CONCURRENT multi-MB payload fetches
            # from dividing the transfer bandwidth; payloads expected
            # small (hint <= the speculative cap, 256 KB) are
            # latency-bound, so they fetch concurrently
            hint = _JaxDispatch._NEED_HINT.get((self.buf_h, self.buf_w), 0)
            if 0 < hint <= _SPEC_CAP_WORDS:
                with ev(f"prefetch_io[{self._tag}]"):
                    self.prefetch()
                return
            with ev(f"sem_wait[{self._tag}]"):
                sem.acquire()
            try:
                with ev(f"prefetch_io[{self._tag}]"):
                    self.prefetch()
            finally:
                sem.release()

        def run():
            try:
                fetch()
            except BaseException as e:  # re-raised in join_prefetch
                self._pf_error = e

        t = threading.Thread(target=run, daemon=True)
        self._pf_thread = t
        t.start()

    def join_prefetch(self) -> None:
        g = self._group
        if g is not None:
            self._group = None
            g.ensure(self)
        if self._pf_thread is not None:
            self._pf_thread.join()
            self._pf_thread = None
        if self._pf_error is not None:
            raise self._pf_error

    def _fetch_once(self):
        """One fetch attempt -> (aux, words_or_None)."""
        hint = _JaxDispatch._NEED_HINT.get((self.buf_h, self.buf_w), 0)
        aux, words = fetch_packed_payload(self.out["combined"], self.buf_h,
                                          self.buf_w, stats=self.stats,
                                          hint_words=hint)
        if words is not None:
            _JaxDispatch._NEED_HINT[(self.buf_h, self.buf_w)] = \
                packed_need_words(aux, self.buf_h, self.buf_w)
        return aux, words

    def prefetch(self) -> None:
        """Pull the combined payload to the host (run on a worker thread
        so transfers overlap the previous LF group's walk/serialize).

        One bucketed fetch sized by the previous LF group's stream
        length; a ranged top-up only when the guess was short.  Payload
        checksums are verified; a corrupt transfer is refetched (three
        attempts in all), then surrendered to the unpacked fallback.
        Any other error propagates."""
        self._pf_ran = True
        if self._codec is not None and self._codec.cold:
            # cold-start bootstrap: the generic prior costs ~1 b/sym
            # on real content, so pull only the tiny aux prefix (the
            # per-class histogram), warm the codec, and re-dispatch
            # this LF group with the adapted code before the big
            # stream fetch (device recompute is ~ms; the savings are
            # MBs of transfer)
            from .ops.pipeline import packed_aux_len

            A = packed_aux_len(self.buf_h, self.buf_w)
            first = _fetch_prefix(self.out["combined"], A)
            aux0 = np.ascontiguousarray(first[:A]).view(np.int32)
            if packed_verify(aux0, None, self.buf_h, self.buf_w):
                self._codec.update(aux0[8:648])
                self._hist_folded = True
                if not self._codec.cold:
                    self._dispatch()
                    if self.stats is not None:
                        self.stats.count("codec_bootstraps")
        for attempt in range(3):
            aux, words = self._fetch_once()
            if packed_verify(aux, words, self.buf_h, self.buf_w):
                if int(aux[0]) == 2 and not self._wide:
                    # residue chunk exceeded the fast 12 b/slot
                    # packing budget; re-dispatch the wide (24 b/slot)
                    # executable rather than surrendering to the
                    # far slower unpacked fallback
                    self._wide = True
                    key = (self.buf_h, self.buf_w,
                           self.kwargs["sample_kind"])
                    _JaxDispatch._WIDE_HINT[key] = True
                    self._dispatch()
                    if self.stats is not None:
                        self.stats.count("wide_retries")
                    continue
                self._aux = aux
                self._words = words
                if self._codec is not None and not self._hist_folded:
                    # (the cold-start bootstrap already folded this
                    # LF group's histogram in)
                    self._codec.update(aux[8:648])
                return
            if self.stats is not None:
                self.stats.count("checksum_errors")
                self.stats.last_error = "packed payload checksum mismatch"
        self._aux = None
        self._words = None

    def drain(self, hf, stats=None):
        """Fetch, walk, and feed the HF stream; returns (lf_q, lf_res)
        (either may be None; write_lf_group accepts any combination)."""
        import contextlib

        stats = stats or self.stats
        stage = stats.stage if stats else (lambda _n: contextlib.nullcontext())
        self.join_prepare()
        lfg = self.lfg
        bgcx = self.buf_w >> 8
        G = (self.buf_h >> 8) * bgcx
        vh, vw = (lfg.height + 7) >> 3, (lfg.width + 7) >> 3

        if self.out is not None:
            if self._aux is None and not self._pf_ran:
                with stage("fetch_aux"):
                    self.prefetch()
            aux = self._aux
            parsed = None
            if aux is not None and bool(aux[0] & 1):
                parsed = _parse_packed(aux, self._words, self.buf_h,
                                       self.buf_w, lfg, self.lf_lut)
            if parsed is not None:
                ev = (stats.event if stats is not None
                      else (lambda _n: contextlib.nullcontext()))
                with stage("walk"), ev(f"walk[{self._tag}]"):
                    _feed_hf_packed(hf, parsed, lfg, self.buf_w, self.buf_h,
                                    self.preset, self.tok_lut)
                if stats is not None:
                    stats.count("lfg_packed")
                return None, parsed["lf_res"]
            # fall through to the unpacked path on overflow
            if stats is not None:
                stats.count("lfg_fallback")

        from .ops.pipeline import encode_lfg

        kw = {("clusters_per_preset" if k == "tok_classes" else k): v
              for k, v in self.kwargs.items()}
        if self.px is None:
            # the raw pixels were never uploaded (packed-pixel upload
            # path); the unpacked fallback needs them
            self.px = _upload_pixels(self._px_host)
            if stats is not None:
                stats.count("h2d_raw_bytes", self._px_host.nbytes)
        out = encode_lfg(self.px, lfg.height, lfg.width, self.presets_dev,
                         self.cm_dev, **kw)
        lf_q = np.asarray(out["lf_q"])[:vh, :vw]
        lf_res = np.asarray(out["lf_res"])[:vh, :vw]
        tokens = np.asarray(out["tokens"]).reshape(G, 1024, 3, 64)
        clusters = np.asarray(out["clusters"]).reshape(tokens.shape)
        residues = np.asarray(out["residues"]).reshape(tokens.shape)
        residue_bits = np.asarray(out["residue_bits"]).reshape(tokens.shape)
        valid_len = np.asarray(out["valid_len"]).reshape(G, 1024, 3)
        for gy in range(lfg.group_count_y):
            for gx in range(lfg.group_count_x):
                gi = gy * bgcx + gx
                hf.add_group_padded(tokens[gi], clusters[gi], residues[gi],
                                    residue_bits[gi], valid_len[gi],
                                    self.preset)
        return lf_q, lf_res


class _FetchGroup:
    """Deferred frame-level fetch of several small packed payloads (see
    the single-fetch comment above group_fetch_payloads).

    Handles register as they dispatch; the group arms (fires its one
    combined fetch) when the encoder says the frame is complete, when
    membership hits the in-flight cap, or -- the safety net -- when the
    drain worker needs a member and the natural arm has not come within
    _GROUP_FETCH_WAIT_S.  Any member the combined fetch cannot cleanly
    satisfy (corrupt aux cascade, checksum mismatch, wide retry) is left
    untouched and drains through its ordinary individual path; its
    device buffer is still live.  An exception in the fetch is re-raised
    to every member's ensure()."""

    def __init__(self, stats):
        import threading

        self._handles: list = []
        self._stats = stats
        self._lock = threading.Lock()
        self._armed = threading.Event()
        self._done = threading.Event()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def __len__(self) -> int:
        with self._lock:
            return len(self._handles)

    def register(self, handle) -> bool:
        with self._lock:
            if self._armed.is_set():
                return False
            self._handles.append(handle)
            handle._group = self
            return True

    def arm(self) -> None:
        self._armed.set()

    def ensure(self, handle) -> None:
        """Block until the group's fetch has run.  Called from
        join_prefetch on the drain worker; waits a bounded time for a
        natural arm (more members may still be registering on the main
        thread) before force-arming with the current membership."""
        if not self._armed.is_set():
            self._armed.wait(_GROUP_FETCH_WAIT_S)
            self.arm()
        self._done.wait()
        if self._error is not None:
            raise self._error

    def _run(self) -> None:
        self._armed.wait()
        try:
            with self._lock:
                handles = list(self._handles)
            for h in handles:
                h.join_prepare()
            ev = (self._stats.event if self._stats is not None
                  else (lambda _n: __import__("contextlib").nullcontext()))
            with ev("group_fetch"):
                res = group_fetch_payloads(
                    [h.out["combined"] for h in handles],
                    [(h.buf_h, h.buf_w) for h in handles],
                    [_JaxDispatch._NEED_HINT.get((h.buf_h, h.buf_w), 1)
                     for h in handles],
                    stats=self._stats)
            for h, r in zip(handles, res):
                if r is None:
                    continue          # individual refetch in drain()
                aux, words = r
                if int(aux[0]) == 2:
                    continue          # wide retry via the individual path
                if (bool(aux[0] & 1)
                        and not packed_verify(aux, words, h.buf_h,
                                              h.buf_w)):
                    if self._stats is not None:
                        self._stats.count("checksum_errors")
                    continue          # stream corrupt: refetch individually
                h._aux = aux
                h._words = words
                h._pf_ran = True
                if words is not None:
                    _JaxDispatch._NEED_HINT[(h.buf_h, h.buf_w)] = \
                        packed_need_words(aux, h.buf_h, h.buf_w)
                if h._codec is not None:
                    h._codec.update(aux[8:648])
                    h._hist_folded = True
            if self._stats is not None:
                self._stats.count("group_fetches")
                self._stats.count("group_members", len(handles))
        except BaseException as e:   # re-raised by ensure()
            self._error = e
        finally:
            self._done.set()


def _lfg_jax(pixels, sample_fmt, linear_light, lfg, preset, hf,
             codec=None, stats=None):
    """JAX device backend: dispatch + immediate drain (the one-frame
    encoder path uses the dispatch/drain split directly for overlap)."""
    return _JaxDispatch(pixels, sample_fmt, linear_light, lfg, preset,
                        hf, codec=codec, stats=stats).drain(hf, stats)


_BACKENDS = {
    "numpy": _lfg_numpy,
    "jax": _lfg_jax,
}


class _SectionSpool:
    """Raw (unpadded) frame sections, optionally spooled to disk, for
    the streaming finalize path: only section *sizes* stay in RAM, the
    bytes stream back out at emission time.

    Each spool owns a unique temp subdirectory of spool_dir (removed by
    close() once the finalize stream has been emitted, with a
    weakref.finalize backstop for GC/crash/interpreter exit), so
    concurrent encoders -- e.g. multi-host processes pointed at one
    shared scratch dir -- can never overwrite each other's section
    files (that collision silently corrupted output before)."""

    def __init__(self, spool_dir: Optional[str]) -> None:
        self.dir = None
        self._cleanup = None
        if spool_dir is not None:
            import shutil
            import tempfile
            import weakref

            self.dir = tempfile.mkdtemp(prefix="hydspool-", dir=spool_dir)
            # weakref.finalize (not __del__): runs at GC, at interpreter
            # exit via its atexit hook, and survives reference cycles;
            # close() triggers it explicitly once the finalize stream
            # has been emitted (ADVICE r3)
            self._cleanup = weakref.finalize(self, shutil.rmtree,
                                             self.dir, True)
        self._count = 0
        self.items: List = []    # (data|path, tail_val, tail_bits, nbytes)

    def close(self) -> None:
        """Remove the spool directory now (idempotent; otherwise runs
        via weakref.finalize at GC or interpreter exit)."""
        if self._cleanup is not None:
            self._cleanup()

    def add_raw(self, raw) -> None:
        data, tail_val, tail_bits = raw
        if self.dir is not None:
            import os as _os

            path = _os.path.join(self.dir, f"lfsec{self._count}.bin")
            self._count += 1
            with open(path, "wb") as f:
                f.write(data)
            self.items.append((path, tail_val, tail_bits, len(data)))
        else:
            self.items.append((data, tail_val, tail_bits, len(data)))

    def padded_size(self, i: int) -> int:
        _, _, tail_bits, nbytes = self.items[i]
        return nbytes + (1 if tail_bits else 0)

    def emit(self, i: int, chunk: int = 1 << 22):
        src, tail_val, tail_bits, _ = self.items[i]
        if isinstance(src, str):
            with open(src, "rb") as f:
                while True:
                    b = f.read(chunk)
                    if not b:
                        break
                    yield b
        else:
            yield src
        if tail_bits:
            yield bytes([tail_val & 0xFF])


class _FrameAssembler:
    """Section buffer + TOC bookkeeping for a single frame
    (mirrors working_writer/section_endpos, internal.h:56-67)."""

    def __init__(self, multi_section: bool) -> None:
        self.working = new_bitwriter()
        self.multi_section = multi_section
        self.section_endpos: List[int] = []

    def end_section(self) -> None:
        if self.multi_section:
            self.working.zero_pad()
            self.section_endpos.append(len(self.working))

    def write_toc_sizes(self, bw: BitWriter) -> None:
        bw.zero_pad()
        if self.multi_section:
            last = 0
            for pos in self.section_endpos:
                bw.write_u32(TOC_TABLE, pos - last)
                last = pos
        else:
            self.working.zero_pad()
            bw.write_u32(TOC_TABLE, len(self.working))
        bw.zero_pad()


class Encoder:
    """Streaming encoder with hydrium's tile contract."""

    # one-frame encodes with at least this many LF groups switch to the
    # memory-bounded streaming HF path (per-preset eager ANS encoding)
    STREAMING_LFG_THRESHOLD = int(
        os.environ.get("HYDRIUM_STREAMING_THRESHOLD", "17"))

    def __init__(self, metadata: ImageMetadata, backend: str = "numpy",
                 streaming: Optional[bool] = None,
                 spool_dir: Optional[str] = None,
                 profile=None) -> None:
        metadata.validate()
        if profile is not None:
            from .models import get_profile

            if isinstance(profile, str):
                profile = get_profile(profile)
            backend = profile.backend
        self.metadata = metadata
        self.backend = backend
        self.spool_dir = spool_dir
        self.stats = EncodeStats()
        self._out = bytearray()
        self._emit_iter = None
        self._wrote_header = False
        self._finished = False
        self._tb_units = []          # tiled-mode in-flight batch units
        self._tb_run = []            # pending cross-call stacked run
        self._tb_run_fmt = None      # the pending run's sample format
        self._tb_flush_pending = False
        self._codec = None
        if backend == "jax":
            import threading
            from concurrent.futures import ThreadPoolExecutor

            self._codec = _shared_codec()
            self._fetch_sem = threading.Semaphore(1)
            self._fetch_group: Optional[_FetchGroup] = None
            # single ordered worker: joins each LF group's prefetch, runs
            # the C++ walk (ctypes releases the GIL) and, in streaming
            # mode, the per-preset ANS encode -- all off the main thread,
            # so serialization of LFG i overlaps the device fetch of
            # LFG i+1.  One worker => hf is mutated in strict dispatch
            # order, exactly as the previous main-thread drain did.
            self._drain_exec = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="drain")
            # eager: _tb_submit_renders calls _tb_pool() from unit
            # fetch threads, and the lazy check-then-set raced there
            # (threads only spawn on first submit, so this is free)
            self._tb_pool_ = ThreadPoolExecutor(
                max_workers=4, thread_name_prefix="hyd-tile")

        m = metadata
        from .jxl import native as _native
        # jax backend: ALWAYS stream one-frame encodes -- per-preset
        # eager ANS runs on the drain worker and overlaps the next LF
        # group's device fetch, where the at-finalize scheme serializes
        # the whole frame's ANS after the last fetch.  numpy backend
        # keeps the at-finalize scheme below the threshold: it is the
        # byte-parity conformance twin of the reference encoder.
        # (single-group frames -- both dims <= 256 -- use a 1-entry TOC
        # with all sections concatenated, which only the at-finalize
        # assembler writes; they are too small for streaming to matter)
        multi_group = ((m.width + 255) // 256) * ((m.height + 255) // 256) > 1
        self.streaming = (bool(streaming) and multi_group
                          if streaming is not None
                          else (m.one_frame and _native.available()
                                and multi_group
                                and (backend == "jax"
                                     or m.lfg_per_frame
                                     >= self.STREAMING_LFG_THRESHOLD)))
        if m.one_frame:
            self._lfgs = [
                LFGroupGeometry(
                    x=x, y=y,
                    width=min(2048, m.width - x * 2048),
                    height=min(2048, m.height - y * 2048),
                    tile_count_x=8, tile_count_y=8)
                for y in range(m.lfg_count_y) for x in range(m.lfg_count_x)
            ]
            self._geo = FrameGeometry(
                image_width=m.width, image_height=m.height, one_frame=True,
                lfg_count_x=m.lfg_count_x, lf_groups=self._lfgs,
                lfg_arrival=[])
            self._assembler: Optional[_FrameAssembler] = None
            self._lf_spool: Optional[_SectionSpool] = None
            self._hf: Optional[HFStream] = None
            self._sent = set()

    # -- public API -----------------------------------------------------

    def send_tile(self, pixels, tile_x: int = 0, tile_y: int = 0,
                  is_last: int = -1,
                  sample_fmt: SampleFormat = SampleFormat.UINT8) -> None:
        """Encode one tile.  `pixels` is [tile_h, tile_w, 3] in the tile's
        actual (possibly clipped) dimensions, or a (r, g, b) tuple of
        planar [tile_h, tile_w] arrays (the reference accepts planar or
        packed buffers via strides; libhydrium.h:208-218).  Strided numpy
        views are accepted either way."""
        if self._finished:
            raise RuntimeError("tile sent after the last tile")
        if isinstance(pixels, (tuple, list)):
            pixels = np.stack([np.asarray(p) for p in pixels], axis=-1)
        fmt = sample_fmt.value
        if self.metadata.one_frame:
            self._send_tile_one_frame(pixels, tile_x, tile_y, is_last, fmt)
        else:
            # deferred batch units must serialize BEFORE this tile
            self._tb_drain_all(fmt)
            self._send_tile_tiled(pixels, tile_x, tile_y, is_last, fmt)

    def take_output(self) -> bytes:
        """Drain every pending output byte (materializes the finalize
        stream; use iter_output for bounded-memory draining)."""
        if self._emit_iter is not None:
            for chunk in self._emit_iter:
                self._out.extend(chunk)
            self._emit_iter = None
        out = bytes(self._out)
        self._out.clear()
        self.stats.bytes_out += len(out)
        return out

    def iter_output(self, chunk_size: int = 1 << 22):
        """Yield pending output in bounded chunks.  In streaming mode
        the finalize emission reads spooled sections incrementally, so
        host memory stays bounded even when the encoded image does not
        fit in RAM (the pull-model counterpart of the reference's
        HYD_NEED_MORE_OUTPUT buffer-swap protocol, libhydrium.c:114-166;
        see README for the contract delta)."""
        if self._out:
            out = bytes(self._out)
            self._out.clear()
            self.stats.bytes_out += len(out)
            yield out
        if self._emit_iter is not None:
            buf = bytearray()
            for chunk in self._emit_iter:
                buf.extend(chunk)
                if len(buf) >= chunk_size:
                    self.stats.bytes_out += len(buf)
                    yield bytes(buf)
                    buf.clear()
            self._emit_iter = None
            if buf:
                self.stats.bytes_out += len(buf)
                yield bytes(buf)

    @property
    def finished(self) -> bool:
        return self._finished

    def close(self) -> None:
        """Drop spool-backed temp files immediately.  For ABANDONED
        encodes: a drained `iter_output`/`take_output` already cleans
        up, and weakref.finalize covers GC/interpreter exit.  Pending
        undelivered output becomes unreadable after this."""
        spool = getattr(self, "_lf_spool", None)
        if spool is not None:
            spool.close()
        hf = getattr(self, "_hf", None)
        if hf is not None and hasattr(hf, "close"):
            hf.close()

    # -- common ---------------------------------------------------------

    def _image_header(self, bw: BitWriter) -> None:
        headers.write_image_header(
            bw, self.metadata.width, self.metadata.height,
            self.metadata.level10, getattr(self, "_icc_payload", None))
        self._wrote_header = True

    def set_suggested_icc_profile(self, icc_data: Optional[bytes]) -> None:
        """libhydrium.c:242-305 (one-frame mode only, before first tile)."""
        if icc_data is None:
            self._icc_payload = None
            return
        if not self.metadata.one_frame:
            raise ValueError("one-frame mode required for ICC tagging")
        if self._wrote_header:
            raise RuntimeError("ICC must be set before the first tile")
        self._icc_payload = headers.mangle_icc_profile(icc_data)

    def _tile_is_last(self, tile_x: int, tile_y: int, tile_w: int,
                      tile_h: int, is_last: int) -> bool:
        if is_last >= 0:
            return bool(is_last)
        return ((tile_x + 1) * tile_w >= self.metadata.width
                and (tile_y + 1) * tile_h >= self.metadata.height)

    # -- tiled mode -----------------------------------------------------

    def _tile_geometry(self, tile_x: int, tile_y: int) -> LFGroupGeometry:
        m = self.metadata
        tw, th = m.tile_width, m.tile_height
        if tile_x >= (m.width + tw - 1) // tw or \
                tile_y >= (m.height + th - 1) // th:
            raise ValueError("tile out of bounds")
        return LFGroupGeometry(
            x=tile_x, y=tile_y,
            width=min(tw, m.width - tile_x * tw),
            height=min(th, m.height - tile_y * th),
            tile_count_x=1 << m.tile_size_shift_x,
            tile_count_y=1 << m.tile_size_shift_y)

    def _render_tiled_frame(self, lfg: LFGroupGeometry, last: bool,
                            lf_q, lf_res, hf,
                            include_header: bool) -> bytes:
        """Serialize one tile-frame (header, LF sections, HF sections,
        TOC) from an already-fed HF stream; returns the frame bytes.
        Pure function of its arguments -- safe to run on a worker
        thread (the per-frame ANS encode releases the GIL in C++)."""
        m = self.metadata
        geo = FrameGeometry(
            image_width=m.width, image_height=m.height, one_frame=False,
            lfg_count_x=1, lf_groups=[lfg], lfg_arrival=[0])
        main = new_bitwriter()
        if include_header:
            # write WITHOUT mutating self._wrote_header: this runs on
            # render pool threads, and a straggler render must never
            # race the fallback path's header re-arm (the claim sites
            # own the flag)
            headers.write_image_header(
                main, self.metadata.width, self.metadata.height,
                self.metadata.level10, getattr(self, "_icc_payload",
                                               None))
        write_frame_header(main, geo, last)
        asm = _FrameAssembler(geo.num_frame_groups > 1)
        with self.stats.stage("lf_sections"):
            write_lf_global(asm.working)
            asm.end_section()
            write_lf_group(asm.working, lf_q, lf_res)
            asm.end_section()
        with self.stats.stage("ans_encode"):
            hf.encode_group_sections()
        hf.write_hf_global(asm.working, geo.num_frame_groups)
        asm.end_section()
        for gbw in hf.group_sections:
            asm.working.append_writer(gbw)
            asm.end_section()
        asm.write_toc_sizes(main)
        return bytes(main.finalize()) + bytes(asm.working.finalize())

    def _emit_tiled_frame(self, lfg: LFGroupGeometry, last: bool,
                          lf_q, lf_res, hf,
                          include_header: Optional[bool] = None) -> None:
        if include_header is None:
            include_header = not self._wrote_header
        if include_header:
            self._wrote_header = True
        data = self._render_tiled_frame(lfg, last, lf_q, lf_res, hf,
                                        include_header)
        self._out.extend(data)
        if last:
            self._finished = True
            if self.backend == "jax":
                _save_warm_state()

    def _send_tile_tiled(self, pixels, tile_x, tile_y, is_last, fmt) -> None:
        m = self.metadata
        lfg = self._tile_geometry(tile_x, tile_y)
        last = self._tile_is_last(tile_x, tile_y, m.tile_width,
                                  m.tile_height, is_last)
        hf = HFStream(1)
        self.stats.pixels += lfg.height * lfg.width
        with self.stats.stage("pipeline+transfer"):
            lf_q, lf_res = _BACKENDS[self.backend](
                pixels, fmt, m.linear_light, lfg, 0, hf,
                codec=self._codec, stats=self.stats)
        self._emit_tiled_frame(lfg, last, lf_q, lf_res, hf)

    def send_tile_batch(self, entries,
                        sample_fmt: SampleFormat = SampleFormat.UINT8) -> None:
        """Encode several tiled-mode tiles with one device dispatch and
        two host fetches per batch (an extension: the reference is
        strictly one tile at a time, libhydrium.h:196+).

        Full-size tiles are STACKED vertically into a single buffer and
        run through the ordinary packed pipeline -- each 256x256 group of
        the stacked image belongs to exactly one tile and groups never
        interact, so the per-group streams come back cleanly separable.
        Edge (clipped) tiles run individually.  entries: list of
        (pixels, tile_x, tile_y)."""
        if self._finished:
            raise RuntimeError("tile sent after the last tile")
        m = self.metadata
        fmt = sample_fmt.value
        from .jxl import native as _native

        if (m.one_frame or self.backend != "jax"
                or not _native.available()):
            for pixels, tx, ty in entries:
                self.send_tile(pixels, tx, ty, sample_fmt=sample_fmt)
            return

        import jax.numpy as jnp
        from .ops.pipeline import encode_lfg_packed

        tw, th = m.tile_width, m.tile_height
        # stacked-chunk height: more tiles per chunk = fewer dispatches
        # and fetches and bigger serialization batches, at the cost of a
        # taller compiled buffer shape (cross-call run accumulation
        # fills these chunks fully); HYDRIUM_TB_STACK_PX overrides.
        K_stack = max(1, int(os.environ.get("HYDRIUM_TB_STACK_PX",
                                            "4096")) // th)
        gcx = tw >> 8
        gpt = (th >> 8) * gcx            # groups per full tile
        cm = tables_hf_cluster_map_1()
        cm_dev = jnp.asarray(cm)
        kwargs = dict(buf_h=K_stack * th, buf_w=tw,
                      linear_light=m.linear_light, num_clusters=9,
                      sample_kind=fmt,
                      tok_classes=9,
                      # stacked tiles are independent frames: LF
                      # prediction restarts at every tile boundary
                      lf_seg_vb=th >> 3)

        # Order-preserving unit pipeline, kept in flight ACROSS calls
        # (self._tb_units): consecutive runs of full-size tiles stack
        # into chunk units (one dispatch + one threaded fetch each);
        # clipped edge tiles become per-tile _JaxDispatch units whose
        # small payloads fetch concurrently.  Each call drains all but
        # a couple of trailing units, so strip r+1's upload/compute
        # overlaps strip r's fetch/serialize -- the serialization order
        # still exactly matches the send order (byte parity with the
        # one-tile-at-a-time path).
        import threading

        def dispatch_chunk(part):
            """part: list of (pixels, tx, ty, lfg), all full-size.
            Dispatches the stacked pipeline and starts a fetch worker."""
            px = np.zeros((K_stack * th, tw, 3),
                          dtype=np.asarray(part[0][0]).dtype)
            for j, (pixels, _tx, _ty, _g) in enumerate(part):
                px[j * th:(j + 1) * th] = pixels[:th, :tw]
            lens, codes, lut = self._codec.tables()
            bh = K_stack * th
            # packed pixel upload (same as the one-frame path; the
            # stacked chunk is its own ubuf: full-size tiles, no pad)
            pxp_dev = _pxp_pack_upload(px, fmt, stats=self.stats,
                                       ev=self.stats.event, tag="tb")
            # sticky per-(shape, format) wideness, same policy as
            # _JaxDispatch: once one chunk needed wide residues, later
            # chunks skip the doomed narrow dispatch
            wide = _JaxDispatch._WIDE_HINT.get((bh, tw, fmt), False)
            with self.stats.stage("dispatch"):
                if pxp_dev is not None:
                    out = _dispatch_px(
                        pxp_dev, bh, tw,
                        jnp.zeros(((bh >> 8) * gcx,), jnp.int32),
                        cm_dev, lens, codes, ubuf_h=bh, ubuf_w=tw,
                        wide=wide, kwargs=kwargs)
                else:
                    self.stats.count("h2d_raw_bytes", px.nbytes)
                    out = encode_lfg_packed(
                        _upload_pixels(px), bh, tw,
                        jnp.zeros(((bh >> 8) * gcx,), jnp.int32),
                        cm_dev, jnp.asarray(lens), jnp.asarray(codes),
                        wide_residues=wide, **kwargs)
            # the image-header claim is decided at unit CREATION (main
            # thread, strict send order) so per-tile serialization can
            # start the moment the unit's fetch completes instead of at
            # drain time; a failed unit re-arms the claim for its
            # per-tile fallback (_tb_drain_unit)
            include_header = not self._wrote_header
            self._wrote_header = True
            unit = {"kind": "chunk", "px": px, "result": None,
                    # metas only -- the caller's pixel views are already
                    # copied into px; retaining them would pin whole
                    # input strips for the unit's deferred lifetime
                    "metas": [(tx, ty, lfg) for _p, tx, ty, lfg in part],
                    "tok_classes": kwargs["tok_classes"],
                    "include_header": include_header, "futs": None,
                    "error": None}

            def fetch_unit():
                from .jxl.tokcode import LF_CLASS

                nonlocal out
                # the fetch semaphore serializes multi-MB payload
                # fetches (a stacked chunk is well above the small-
                # payload threshold); mirrors _JaxDispatch.prefetch
                with self._fetch_sem:
                    hint = _JaxDispatch._NEED_HINT.get((bh, tw), 0)
                    with self.stats.event("tb_fetch"):
                        aux, words = fetch_packed_payload(
                            out["combined"], bh, tw, stats=self.stats,
                            hint_words=hint)
                    if aux is not None and int(aux[0]) == 2:
                        # dense residues: one retry on the wide
                        # executable, reusing the packed upload
                        # already on device
                        _JaxDispatch._WIDE_HINT[(bh, tw, fmt)] = True
                        with self.stats.stage("dispatch"):
                            if pxp_dev is not None:
                                out = _dispatch_px(
                                    pxp_dev, bh, tw,
                                    jnp.zeros(((bh >> 8) * gcx,),
                                              jnp.int32),
                                    cm_dev, lens, codes, ubuf_h=bh,
                                    ubuf_w=tw, wide=True,
                                    kwargs=kwargs)
                            else:
                                # count the raw re-upload with the
                                # other host->device bytes
                                self.stats.count("h2d_raw_bytes",
                                                 px.nbytes)
                                out = encode_lfg_packed(
                                    jnp.asarray(px), bh, tw,
                                    jnp.zeros(((bh >> 8) * gcx,),
                                              jnp.int32),
                                    cm_dev, jnp.asarray(lens),
                                    jnp.asarray(codes),
                                    wide_residues=True, **kwargs)
                        self.stats.count("wide_retries")
                        with self.stats.event("tb_fetch"):
                            aux, words = fetch_packed_payload(
                                out["combined"], bh, tw,
                                stats=self.stats)
                    if (aux is not None and words is not None
                            and bool(aux[0] & 1)
                            and not packed_verify(aux, words, bh, tw)):
                        # corrupt transfer: one refetch before the
                        # per-tile fallback (same policy as
                        # _JaxDispatch.prefetch)
                        self.stats.count("checksum_errors")
                        with self.stats.event("tb_fetch"):
                            aux, words = fetch_packed_payload(
                                out["combined"], bh, tw,
                                stats=self.stats)
                if (aux is None or words is None
                        or not bool(aux[0] & 1)
                        or not packed_verify(aux, words, bh, tw)):
                    self.stats.count("lfg_fallback")
                    return
                if words is not None:
                    _JaxDispatch._NEED_HINT[(bh, tw)] = \
                        packed_need_words(aux, bh, tw)
                self._codec.update(aux[8:648])
                stacked_geom = LFGroupGeometry(
                    x=0, y=0, width=tw, height=bh,
                    tile_count_x=gcx, tile_count_y=bh >> 8)
                parsed = _parse_packed(aux, words, bh, tw,
                                       stacked_geom, lut[LF_CLASS])
                if parsed is None:
                    self.stats.count("checksum_errors")
                    return
                self.stats.count("lfg_packed")
                # per-tile walk + ANS + frame serialization start NOW
                # (4-worker pool, GIL released in C++), overlapping
                # the remaining units' fetches; _tb_drain_unit only
                # collects results in send order (and falls back
                # per-tile if futs stayed None because this
                # submission failed mid-way)
                unit["result"] = (parsed, lut)
                self._tb_submit_renders(unit)

            def fetch():
                try:
                    fetch_unit()
                except BaseException as e:  # re-raised by _tb_drain_unit
                    unit["error"] = e

            t = threading.Thread(target=fetch, daemon=True)
            unit["thread"] = t
            t.start()
            return unit

        # partial runs PERSIST across send_tile_batch calls (pixel data
        # is copied on append, so the caller's strip buffer stays
        # reusable the moment this call returns): row-at-a-time callers
        # -- the CLI and the bench -- otherwise cap every chunk at one
        # row's tile count and pay a dispatch + fetch per row.  A pending
        # run flushes on an edge tile, a full chunk, the last tile, a
        # single-tile send (_tb_drain_all), or a SAMPLE-FORMAT change --
        # dispatch_chunk closes over THIS call's fmt, so a held run must
        # never cross formats (it would encode the old tiles under the
        # new format).
        if (getattr(self, "_tb_run", None)
                and self._tb_run_fmt != fmt):
            old_fmt = self._tb_run_fmt
            self._tb_flush_pending = True
            try:
                self.send_tile_batch([], sample_fmt=SampleFormat(old_fmt))
            finally:
                self._tb_flush_pending = False
        run = getattr(self, "_tb_run", None) or []
        self._tb_run = []
        for pixels, tx, ty in entries:
            lfg = self._tile_geometry(tx, ty)
            self.stats.pixels += lfg.height * lfg.width
            if lfg.height == th and lfg.width == tw:
                run.append((np.array(pixels[:th, :tw], copy=True),
                            tx, ty, lfg))
                if len(run) == K_stack:
                    self._tb_units.append(dispatch_chunk(run))
                    run = []
            else:
                if run:
                    self._tb_units.append(dispatch_chunk(run))
                    run = []
                hf = HFStream(1)
                handle = _JaxDispatch(pixels, fmt, m.linear_light, lfg,
                                      0, hf, codec=self._codec,
                                      stats=self.stats)
                if handle.will_pack:
                    handle.start_prefetch(self._fetch_sem)
                include_header = not self._wrote_header
                self._wrote_header = True
                self._tb_units.append({"kind": "edge", "handle": handle,
                                       "hf": hf, "lfg": lfg,
                                       "tx": tx, "ty": ty,
                                       "include_header": include_header})

        contains_last = any(self._tile_is_last(tx, ty, tw, th, -1)
                            for _p, tx, ty in entries)
        if run:
            if contains_last or self._tb_flush_pending:
                self._tb_units.append(dispatch_chunk(run))
            else:
                self._tb_run = run
                self._tb_run_fmt = fmt
        keep = 0 if contains_last else 2
        while len(self._tb_units) > keep:
            self._tb_drain_unit(self._tb_units.pop(0), fmt)

    def _tb_submit_renders(self, unit) -> None:
        """Submit a fetched chunk unit's per-tile walk + ANS + frame
        serialization to the 4-worker pool (called from the unit's
        fetch thread the moment its payload parses; the walker and ANS
        encoder release the GIL in C++).  Results are collected strictly
        in send order by _tb_drain_unit."""
        m = self.metadata
        tw, th = m.tile_width, m.tile_height
        gpt = (th >> 8) * (tw >> 8)
        parsed, lut = unit["result"]

        def render(j, lfg, last, include_header):
            g0, g1 = j * gpt, (j + 1) * gpt
            lf0 = j * (th >> 3)
            hf = HFStream(1)
            with self.stats.stage("walk"):
                # HF walker rows only: the class modulus is derived
                # from the LUT row count and must equal the dispatch's
                # tok_classes (CLAUDE.md LUT-slicing invariant)
                hf.add_lfg_packed(parsed["tok_words"], parsed["res_words"],
                                  lut[:unit["tok_classes"]], 0,
                                  (th >> 8, tw >> 8),
                                  (th >> 3, tw >> 3),
                                  parsed["tok_off"][g0:g1],
                                  parsed["res_off"][g0:g1],
                                  parsed["gs"][g0:g1])
            return self._render_tiled_frame(
                lfg, last, None, parsed["lf_res"][lf0:lf0 + (th >> 3)],
                hf, include_header)

        pool = self._tb_pool()
        futs = []
        for j, (tx, ty, lfg) in enumerate(unit["metas"]):
            last = self._tile_is_last(tx, ty, tw, th, -1)
            futs.append((pool.submit(render, j, lfg, last,
                                     unit["include_header"] and j == 0),
                         last))
        unit["futs"] = futs

    def _tb_drain_unit(self, unit, fmt: str) -> None:
        """Serialize one tiled-mode unit (tiles emit in send order)."""
        m = self.metadata
        tw, th = m.tile_width, m.tile_height
        if unit["kind"] == "edge":
            if self._finished:
                raise RuntimeError("tile sent after the last tile")
            handle, hf, lfg = unit["handle"], unit["hf"], unit["lfg"]
            last = self._tile_is_last(unit["tx"], unit["ty"], tw, th, -1)
            # join the prefetch daemon BEFORE drain (exactly like the
            # one-frame _drain_work): drain() racing a mid-flight
            # prefetch could double-run the cold-codec bootstrap or see
            # _aux published before _words
            handle.join_prefetch()
            with self.stats.stage("pipeline+transfer"):
                lf_q, lf_res = handle.drain(hf, self.stats)
            self._emit_tiled_frame(lfg, last, lf_q, lf_res, hf,
                                   include_header=unit["include_header"])
            return
        unit["thread"].join()
        if unit["error"] is not None:
            raise unit["error"]
        px = unit["px"]
        if unit["result"] is None or unit["futs"] is None:
            # overflow / corrupt payload (or the early-render
            # submission itself failed): per-tile fallback.
            # Re-arm this unit's header claim so its first fallback
            # frame writes the image header the claim reserved.
            if unit["include_header"]:
                self._wrote_header = False
            for j, (tx, ty, _g) in enumerate(unit["metas"]):
                if self._finished:
                    raise RuntimeError("tile sent after the last tile")
                self._send_tile_tiled(px[j * th:(j + 1) * th], tx, ty,
                                      -1, fmt)
            return
        for f, last in unit["futs"]:
            if self._finished:
                raise RuntimeError("tile sent after the last tile")
            self._out.extend(f.result())
            if last:
                self._finished = True
                if self.backend == "jax":
                    _save_warm_state()

    def _tb_pool(self):
        if getattr(self, "_tb_pool_", None) is None:
            from concurrent.futures import ThreadPoolExecutor

            self._tb_pool_ = ThreadPoolExecutor(
                max_workers=4, thread_name_prefix="hyd-tile")
        return self._tb_pool_

    def _tb_drain_all(self, fmt: str) -> None:
        if getattr(self, "_tb_run", None):
            # dispatch the pending cross-call run first -- nothing may
            # emit ahead of tiles already accepted (send order); the
            # run flushes under ITS OWN sample format, not the new
            # tile's
            self._tb_flush_pending = True
            try:
                self.send_tile_batch(
                    [], sample_fmt=SampleFormat(self._tb_run_fmt))
            finally:
                self._tb_flush_pending = False
        while self._tb_units:
            self._tb_drain_unit(self._tb_units.pop(0), fmt)

    # -- one-frame mode -------------------------------------------------

    def _send_tile_one_frame(self, pixels, tile_x, tile_y, is_last,
                             fmt) -> None:
        m = self.metadata
        if tile_x >= m.lfg_count_x or tile_y >= m.lfg_count_y:
            raise ValueError("tile out of bounds")
        lfid = tile_y * m.lfg_count_x + tile_x
        if lfid in self._sent:
            raise ValueError("tile already sent")
        last = self._tile_is_last(tile_x, tile_y, 2048, 2048, is_last)

        if self._assembler is None and self._lf_spool is None:
            if self.streaming:
                geo = self._geo
                counts = [0] * geo.num_presets
                for _id in range(geo.lfg_per_frame):
                    counts[_id // geo.lfg_per_preset] += 1
                self._hf = StreamingHFStream(geo.num_presets, counts,
                                             spool_dir=self.spool_dir)
                # bounded-output: LF sections spool next to HF sections;
                # nothing accumulates in a RAM working writer
                self._lf_spool = _SectionSpool(self.spool_dir)
                bw = new_bitwriter()
                write_lf_global(bw)
                self._lf_spool.add_raw(bw.export_raw())
            else:
                self._assembler = _FrameAssembler(self._geo.toc_size > 1)
                self._hf = HFStream(self._geo.num_presets)
                write_lf_global(self._assembler.working)
                self._assembler.end_section()
            self._pending = []

        self.stats.pixels += self._lfgs[lfid].height * self._lfgs[lfid].width
        self._process_lfg(pixels, lfid, fmt)

        if last:
            for missing in range(len(self._lfgs)):
                if missing not in self._sent:
                    lfg = self._lfgs[missing]
                    zeros = np.zeros((lfg.height, lfg.width, 3),
                                     dtype=np.uint8 if fmt == "uint8"
                                     else np.uint16 if fmt == "uint16"
                                     else np.float32)
                    self._process_lfg(zeros, missing, fmt)
            while self._pending:
                self._drain_one()
            self._finalize_one_frame()

    # keep up to this many LF groups in flight on the device so compute
    # and transfers overlap with host serialization
    MAX_INFLIGHT = int(os.environ.get("HYDRIUM_INFLIGHT", "3"))

    def _process_lfg(self, pixels, lfid: int, fmt: str) -> None:
        lfg = self._lfgs[lfid]
        self._sent.add(lfid)
        self._geo.lfg_arrival.append(lfid)
        preset = lfid // self._geo.lfg_per_preset
        if self.backend == "jax":
            with self.stats.stage("dispatch"):
                handle = _JaxDispatch(pixels, fmt,
                                      self.metadata.linear_light, lfg,
                                      preset, self._hf, codec=self._codec,
                                      stats=self.stats)
            self._pending.append(handle)
            # start pulling this payload immediately on the fetch worker
            # (a semaphore serializes large fetches across handles), so
            # device->host transfer of LFG i overlaps walk/serialize of
            # LFG i-1 and dispatch of LFG i+1.  Small expected payloads
            # instead register in the frame-level fetch group -- ONE
            # combined read per frame
            if handle.will_pack and not self._try_group_register(handle):
                handle.start_prefetch(self._fetch_sem)
            if (self._fetch_group is not None
                    and len(self._sent) == len(self._lfgs)):
                self._fetch_group.arm()
            # queue the walk (+ streaming ANS) on the ordered drain
            # worker: serialization of this LF group overlaps the NEXT
            # LF group's device fetch instead of blocking the main thread
            handle._future = self._drain_exec.submit(
                self._drain_work, handle)
            if (len(self._pending) > self.MAX_INFLIGHT
                    and self._fetch_group is not None):
                # about to block in _drain_one: no further members can
                # register while we wait, so arm now instead of making
                # the drain worker's ensure() burn its force-arm wait
                self._fetch_group.arm()
            while len(self._pending) > self.MAX_INFLIGHT:
                self._drain_one()
        else:
            with self.stats.stage("pipeline+transfer"):
                lf_q, lf_res = _BACKENDS[self.backend](
                    pixels, fmt, self.metadata.linear_light, lfg, preset,
                    self._hf, codec=self._codec, stats=self.stats)
            self._write_lf(lf_q, lf_res)
            if self.streaming:
                with self.stats.stage("ans_encode"):
                    self._hf.finish_lfg(preset)

    def _try_group_register(self, handle) -> bool:
        """Register a small-payload handle in the frame fetch group
        (creating/rotating groups as needed); False -> caller should
        start the ordinary individual prefetch."""
        if (not _group_fetch_on() or self._codec is None
                or self._codec.cold or len(self._lfgs) <= 1):
            return False
        hint = _JaxDispatch._NEED_HINT.get((handle.buf_h, handle.buf_w), 0)
        if not (0 < hint <= _SPEC_CAP_WORDS):
            return False
        g = self._fetch_group
        if g is None or not g.register(handle):
            g = _FetchGroup(self.stats)
            self._fetch_group = g
            g.register(handle)
        # cap membership at the in-flight window: _process_lfg blocks on
        # _drain_one once MAX_INFLIGHT+1 handles are pending, and the
        # drained handle's group must already be armed by then (the
        # ensure() timeout would otherwise stall every window)
        if len(g) > self.MAX_INFLIGHT:
            g.arm()
        return True

    def _drain_work(self, handle):
        """Runs on the single drain worker thread, in dispatch order:
        join the prefetch, walk the payload into the HF stream (or run
        the unpacked fallback), and in streaming mode finish the
        preset's ANS sections.  hf is only ever touched from this
        thread until finalize."""
        with self.stats.event(f"join[{handle._tag}]"):
            handle.join_prefetch()
        with self.stats.stage("pipeline+transfer"):
            lf_q, lf_res = handle.drain(self._hf, self.stats)
        if self.streaming:
            with self.stats.stage("ans_encode"):
                self._hf.finish_lfg(handle.preset)
        return lf_q, lf_res

    def _drain_one(self) -> None:
        handle = self._pending.pop(0)
        with self.stats.stage("fetch_wait"):
            lf_q, lf_res = handle._future.result()
        self._write_lf(lf_q, lf_res)

    def _write_lf(self, lf_q, lf_res) -> None:
        with self.stats.stage("lf_sections"):
            if self.streaming:
                bw = new_bitwriter()
                write_lf_group(bw, lf_q, lf_res)
                self._lf_spool.add_raw(bw.export_raw())
            else:
                asm = self._assembler
                write_lf_group(asm.working, lf_q, lf_res)
                asm.end_section()

    def _finalize_one_frame(self) -> None:
        hf = self._hf
        geo = self._geo
        with self.stats.stage("ans_encode"):
            hf.encode_group_sections()

        if self.streaming:
            # bounded-output finalize: compute section sizes (bytes stay
            # spooled), write headers + TOC, then stream everything out
            hfg = new_bitwriter()
            hf.write_hf_global(hfg, geo.num_frame_groups)
            hfg_raw = hfg.export_raw()
            hf_items = list(hf.iter_section_meta())
            spool = self._lf_spool
            sizes = [spool.padded_size(i) for i in range(len(spool.items))]
            sizes.append(len(hfg_raw[0]) + (1 if hfg_raw[2] else 0))
            sizes.extend(n + (1 if tb else 0) for _, tb, n in hf_items)

            main = new_bitwriter()
            if not self._wrote_header:
                self._image_header(main)
            write_frame_header(main, geo, True)
            main.zero_pad()
            for s in sizes:
                main.write_u32(TOC_TABLE, s)
            main.zero_pad()

            def emit():
                yield main.finalize()
                for i in range(len(spool.items)):
                    yield from spool.emit(i)
                yield hfg_raw[0]
                if hfg_raw[2]:
                    yield bytes([hfg_raw[1] & 0xFF])
                for data, tail_val, tail_bits in hf.iter_sections():
                    yield data
                    if tail_bits:
                        yield bytes([tail_val & 0xFF])
                # everything spooled has been emitted: drop the temp
                # dirs now instead of waiting for GC (their
                # weakref.finalize remains the crash/abandon backstop)
                spool.close()
                hf.close()

            self._emit_iter = emit()
            self._finished = True
            if self.backend == "jax":
                _save_warm_state()
            return

        asm = self._assembler
        hf.write_hf_global(asm.working, geo.num_frame_groups)
        asm.end_section()
        for gbw in hf.group_sections:
            asm.working.append_writer(gbw)
            asm.end_section()

        main = new_bitwriter()
        if not self._wrote_header:
            self._image_header(main)
        write_frame_header(main, geo, True)
        asm.write_toc_sizes(main)
        self._out.extend(main.finalize())
        self._out.extend(asm.working.finalize())
        self._finished = True
        if self.backend == "jax":
            _save_warm_state()


# BufferedEncoder.send_tile / pump status values (reference HYD_OK /
# HYD_NEED_MORE_OUTPUT, libhydrium.h)
OK = "ok"
NEED_MORE_OUTPUT = "need-more-output"


class BufferedEncoder:
    """Push-model (caller-owned output buffer) adapter over `Encoder`.

    Reference parity for the buffer-swap output contract:
    hyd_provide_output_buffer / HYD_NEED_MORE_OUTPUT /
    hyd_release_output_buffer (libhydrium.c:114-166, bitwriter.c:42-73).
    The core Encoder is pull-model (`iter_output`; STATUS deviation 4);
    this adapter restores the reference surface: output lands only in
    buffers the CALLER owns, `send_tile` suspends with NEED_MORE_OUTPUT
    when one fills mid-drain, and encoding resumes after
    release_output_buffer + provide_output_buffer + pump -- the
    reference's swap-and-recall loop.  Host memory stays bounded by the
    spool exactly as in the pull model.

        buf = bytearray(1 << 20)
        be = BufferedEncoder(Encoder(meta))
        be.provide_output_buffer(buf)
        st = be.send_tile(px, 0, 0)
        while st == NEED_MORE_OUTPUT:
            n = be.release_output_buffer()
            sink.write(buf[:n])
            be.provide_output_buffer(buf)
            st = be.pump()
    """

    def __init__(self, encoder: Encoder) -> None:
        from collections import deque

        self.encoder = encoder
        self._buf: Optional[memoryview] = None
        self._pos = 0
        self._chunks = deque()      # (bytes, consumed-offset) backlog
        self._emit = None           # live iter_output generator

    def provide_output_buffer(self, buf) -> None:
        """Hand the encoder a writable caller-owned byte buffer
        (bytearray / writable memoryview; libhydrium.c:114-136)."""
        if self._buf is not None:
            raise RuntimeError("release the current output buffer first")
        view = memoryview(buf).cast("B")
        if view.readonly:
            raise ValueError("output buffer must be writable")
        if len(view) < 64:
            # reference parity: hyd_provide_output_buffer rejects
            # buffers under 64 bytes (libhydrium.c); tiny buffers would
            # also degenerate _drain into a byte-at-a-time loop
            raise ValueError("output buffer must be at least 64 bytes")
        self._buf = view
        self._pos = 0

    def release_output_buffer(self) -> int:
        """Reclaim the current buffer; returns the bytes written into it
        (libhydrium.c:138-151).  The encoder holds no reference to the
        buffer afterwards."""
        if self._buf is None:
            raise RuntimeError("no output buffer provided")
        n = self._pos
        self._buf.release()
        self._buf = None
        self._pos = 0
        return n

    def send_tile(self, pixels, tile_x: int = 0, tile_y: int = 0,
                  is_last: int = -1,
                  sample_fmt: SampleFormat = SampleFormat.UINT8) -> str:
        """Encode one tile, draining its output into the provided
        buffer.  Returns NEED_MORE_OUTPUT when the buffer filled first:
        release/swap buffers and `pump()` until OK before sending the
        next tile.  If called while output is still pending it resumes
        the drain without re-encoding (the reference tolerates the same
        re-call after a swap)."""
        if self._drain() == NEED_MORE_OUTPUT:
            return NEED_MORE_OUTPUT
        self.encoder.send_tile(pixels, tile_x, tile_y, is_last, sample_fmt)
        return self._drain()

    def pump(self) -> str:
        """Continue copying pending output after a buffer swap; OK means
        everything produced so far has been delivered."""
        return self._drain()

    @property
    def finished(self) -> bool:
        """True once the last tile was encoded AND fully delivered."""
        return (self.encoder.finished and not self._chunks
                and self._emit is None and not self.encoder._out
                and self.encoder._emit_iter is None)

    def _drain(self) -> str:
        if self._buf is None:
            raise RuntimeError("no output buffer provided")
        while True:
            if not self._chunks:
                nxt = self._next_chunk()
                if nxt is None:
                    return OK
                self._chunks.append((nxt, 0))
            chunk, off = self._chunks[0]
            room = len(self._buf) - self._pos
            take = min(room, len(chunk) - off)
            self._buf[self._pos:self._pos + take] = chunk[off:off + take]
            self._pos += take
            if off + take < len(chunk):
                self._chunks[0] = (chunk, off + take)
                return NEED_MORE_OUTPUT
            self._chunks.popleft()

    def _next_chunk(self) -> Optional[bytes]:
        # A paused iter_output generator only exists while this adapter
        # reports NEED_MORE_OUTPUT (send_tile refuses to encode then),
        # so the encoder never adds output behind a live generator's
        # back; when one ends, the next call starts a fresh one.
        # The pull granularity follows the CALLER's buffer size, so the
        # adapter's internal backlog stays ~one buffer's worth -- the
        # memory-bound the reference achieves by suspending mid-section
        # (libhydrium.c:114-166); a tiny 64-byte buffer holds the
        # backlog near the spool read unit instead of a 4 MB chunk.
        if self._emit is None:
            cs = max(64, len(self._buf)) if self._buf is not None \
                else 1 << 16
            self._emit = self.encoder.iter_output(chunk_size=cs)
        for c in self._emit:
            if c:
                return c
        self._emit = None
        return None


def encode_image(image: np.ndarray, tile_size_shift: int = -1,
                 linear_light: bool = False,
                 sample_fmt: Optional[SampleFormat] = None,
                 backend: str = "numpy",
                 stats: Optional[EncodeStats] = None) -> bytes:
    """One-shot encode of an [H, W, 3] array to .jxl bytes.  `stats`,
    when given, collects the encode's counters and stage times."""
    if sample_fmt is None:
        if image.dtype == np.uint8:
            sample_fmt = SampleFormat.UINT8
        elif image.dtype == np.uint16:
            sample_fmt = SampleFormat.UINT16
        else:
            sample_fmt = SampleFormat.FLOAT32
    h, w = image.shape[:2]
    meta = ImageMetadata(width=w, height=h, linear_light=linear_light,
                         tile_size_shift_x=tile_size_shift,
                         tile_size_shift_y=tile_size_shift)
    enc = Encoder(meta, backend=backend)
    if stats is not None:
        enc.stats = stats
    out = bytearray()
    if meta.one_frame:
        tile = 2048
        for ty in range((h + tile - 1) // tile):
            for tx in range((w + tile - 1) // tile):
                y0, x0 = ty * tile, tx * tile
                enc.send_tile(image[y0:y0 + tile, x0:x0 + tile], tx, ty,
                              sample_fmt=sample_fmt)
                out.extend(enc.take_output())
        return bytes(out)
    tw, th = meta.tile_width, meta.tile_height
    entries = [
        (image[ty * th:(ty + 1) * th, tx * tw:(tx + 1) * tw], tx, ty)
        for ty in range((h + th - 1) // th)
        for tx in range((w + tw - 1) // tw)
    ]
    batch = 16
    for i in range(0, len(entries), batch):
        enc.send_tile_batch(entries[i:i + batch], sample_fmt=sample_fmt)
        out.extend(enc.take_output())
    return bytes(out)
