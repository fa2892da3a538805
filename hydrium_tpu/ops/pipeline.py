"""JAX device pipeline.

One jitted function carries pixels of an LF group all the way to
serializer-ready integer arrays, batched over every 256x256 group at
once (the reference processes one 8x8 block at a time; SURVEY.md section
7 maps its per-tile loops onto this batched design):

  pixels [H, W, 3]
    -> XYB (color rotation + biased cube root)
    -> 8x8 DCT via two matmul passes (float32, HIGHEST precision)
    -> LF quantization + clamped-gradient residuals
    -> fused zig-zag + channel-reorder gather
    -> HF quantization (dead zone)
    -> nonzero counts, context ids, analytic cluster map
    -> hybrid-uint tokens/residues
    -> per-cluster histograms (scatter-add)

Everything is plain jax.numpy / lax left to XLA; there is no per-platform
branch, so the CPU test backend runs exactly the code the GPU runs.

Layout: everything after the DCT lives in a flat [N = groups*1024*3, 64]
block-channel layout in emission order (group, block-raster, channel
Y/X/B, zig-zag slot).  That is exactly the byte layout the native
serializer consumes, so host-side reshapes are free views.

Shapes are *static buffers with dynamic valid dims*: callers pad pixels
to a fixed buffer (e.g. 2048x2048) and pass the true height/width as
traced scalars, so every LF group of an image -- interior or edge --
reuses one compiled executable.

Numerics: the device path uses direct float math (polynomial sRGB
linearization, exact cube root) instead of the reference's fixed-point
LUTs and bit-hack cbrt (format.c:21-56).  Validated by decode +
equal-or-better PSNR rather than byte equality (BASELINE.json); the DCT
uses the reference's rounded basis constants (tables.COSINE_LUT) so
quantization decisions stay aligned.
"""

from __future__ import annotations

import os
from functools import partial
from typing import Dict, Tuple

from ..utils import jaxcfg

jaxcfg.ensure()

import jax
import jax.numpy as jnp
import numpy as np

from . import tables

# emission channel order Y, X, B -> storage index (internal.h channel order)
_EMIT_TO_STORE = np.array([1, 0, 2], dtype=np.int32)

# Fused gather index: emission (channel c, zig-zag j) -> flat offset into
# the [8, 8, 3] coefficient block (ky, kx, storage channel).
_ZZ_GATHER = (tables.ZIGZAG_KY[None, :] * 24 + tables.ZIGZAG_KX[None, :] * 3
              + _EMIT_TO_STORE[:, None]).reshape(-1)  # [192]

# HF quant weights in emission order [3, 64]
_HF_W_EMIT = tables.HF_QUANT_WEIGHTS[_EMIT_TO_STORE].astype(np.float32)


def _linearize(x: jnp.ndarray) -> jnp.ndarray:
    """sRGB EOTF cubic approximation (format.c:15-19)."""
    lo = 0.07739938080495357 * x
    hi = 0.003094300919832 + x * (
        -0.009982599 + x * (0.72007737769 + 0.2852804880 * x))
    return jnp.where(x <= 0.0404482362771082, lo, hi)


def _bias_cbrt(x: jnp.ndarray) -> jnp.ndarray:
    """cbrt(x + bias) - 0.155954 (format.c:29-31), exact cube root."""
    return jnp.cbrt(x + 0.0037930732552754493) - 0.155954


def rgb_to_xyb(rgb: jnp.ndarray, linear_light: bool) -> jnp.ndarray:
    """[..., 3] float32 RGB in 0..1 -> XYB (format.c:38-46)."""
    if not linear_light:
        rgb = _linearize(rgb)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    lgamma = _bias_cbrt(0.3 * r + 0.622 * g + 0.078 * b)
    mgamma = _bias_cbrt(0.23 * r + 0.692 * g + 0.078 * b)
    sgamma = _bias_cbrt(0.243423 * r + 0.204767 * g + 0.55181 * b)
    y = (lgamma + mgamma) * 0.5
    x = y - mgamma
    bb = sgamma - y
    return jnp.stack([x, y, bb], axis=-1)


# DCT-II basis with the reference's rounded constants: row 0 is the DC
# mean row (0.125), rows 1..7 the cosine rows (encoder.c:32-40,:639-658).
_DCT_BASIS = np.concatenate(
    [np.full((1, 8), 0.125, np.float32), tables.COSINE_LUT], axis=0)

# Full float32 products in the DCT.  Without it a GPU may run the
# float32 einsums in TF32 (about three decimal digits), which moves
# near-dead-zone quantization decisions away from the reference's.
DCT_PRECISION = jax.lax.Precision.HIGHEST


def forward_dct(xyb: jnp.ndarray,
                precision=DCT_PRECISION) -> jnp.ndarray:
    """[vh*8, vw*8, 3] -> [vh, vw, 8(ky), 8(kx), 3] via two matmuls."""
    h, w, c = xyb.shape
    vh, vw = h // 8, w // 8
    basis = jnp.asarray(_DCT_BASIS)
    blocks = xyb.reshape(vh, 8, vw, 8, c).transpose(0, 2, 1, 3, 4)
    t = jnp.einsum("abyxc,kx->abykc", blocks, basis, precision=precision,
                   preferred_element_type=jnp.float32)
    f = jnp.einsum("abykc,my->abmkc", t, basis, precision=precision,
                   preferred_element_type=jnp.float32)
    return f


def quantize_lf(dc: jnp.ndarray) -> jnp.ndarray:
    return (dc * jnp.asarray(tables.LF_SHIFT)).astype(jnp.int32)


def quantize_frontend(pixels: jnp.ndarray, height, width, *,
                      linear_light: bool, sample_kind: str,
                      precision=DCT_PRECISION):
    """Colour transform, DCT and quantization of a [buf_h, buf_w, 3]
    pixel buffer whose true extent is height x width (traced scalars;
    everything beyond it is zeroed, format.c:182-191).

    Returns (lf_q [vbh, vbw, 3] i32, q [vbh, vbw, 3, 64] i32): the
    quantized LF and the quantized HF coefficients in emission order
    (channel Y/X/B, zig-zag slot; slot 0 is zero)."""
    buf_h, buf_w = pixels.shape[0], pixels.shape[1]
    vbh, vbw = buf_h >> 3, buf_w >> 3
    if sample_kind == "uint8":
        rgb = pixels.astype(jnp.float32) * np.float32(1.0 / 255.0)
    elif sample_kind == "uint16":
        rgb = pixels.astype(jnp.float32) * np.float32(1.0 / 65535.0)
    else:
        rgb = pixels.astype(jnp.float32)
    xyb = rgb_to_xyb(rgb, linear_light)
    row_ok = jnp.arange(buf_h)[:, None, None] < height
    col_ok = jnp.arange(buf_w)[None, :, None] < width
    xyb = jnp.where(row_ok & col_ok, xyb, 0.0)

    coeffs = forward_dct(xyb, precision)     # [vbh, vbw, 8, 8, 3]
    lf_q = quantize_lf(coeffs[:, :, 0, 0, :])

    # fused zig-zag + emission-channel reorder: -> [vbh, vbw, 3, 64]
    zz = coeffs.reshape(vbh, vbw, 192)[:, :, jnp.asarray(_ZZ_GATHER)]
    zz = zz.reshape(vbh, vbw, 3, 64)
    w_emit = jnp.asarray(_HF_W_EMIT)
    q = ((zz * w_emit) * np.float32(tables.HF_MULT)).astype(jnp.int32)
    q = jnp.where(jnp.abs(q) < 2, 0, q)
    q = q.at[..., 0].set(0)
    return lf_q, q


def lf_residuals(lf_q: jnp.ndarray, seg_vb: int = 0) -> jnp.ndarray:
    """Clamped-gradient prediction residuals (encoder.c:583-591).
    [vh, vw, 3] int32 -> packed uint32 residual symbols.

    seg_vb > 0 restarts prediction every seg_vb varblock rows: the
    tiled-mode batch path STACKS independent tiles vertically into one
    buffer, and each tile-frame's LF prediction must not see the tile
    above it."""
    v = lf_q
    left = jnp.pad(v[:, :-1], ((0, 0), (1, 0), (0, 0)))
    up = jnp.pad(v[:-1], ((1, 0), (0, 0), (0, 0)))
    upleft = jnp.pad(v[:-1, :-1], ((1, 0), (1, 0), (0, 0)))
    vh, vw, _ = v.shape
    rows = jnp.arange(vh)
    if seg_vb > 0:
        rows = rows % seg_vb
    has_x = jnp.arange(vw)[None, :, None] > 0
    has_y = rows[:, None, None] > 0
    w = jnp.where(has_x, left, jnp.where(has_y, up, 0))
    n = jnp.where(has_y, up, w)
    nw = jnp.where(has_x & has_y, upleft, w)
    pred = jnp.clip(w + n - nw, jnp.minimum(w, n), jnp.maximum(w, n))
    return pack_signed(v - pred)


def pack_signed(v: jnp.ndarray) -> jnp.ndarray:
    return jnp.where(v >= 0, v << 1, (-v << 1) - 1).astype(jnp.uint32)


def _fllog2_u32(x: jnp.ndarray) -> jnp.ndarray:
    return 31 - jax.lax.clz(x.astype(jnp.int32))


def hybridize(values: jnp.ndarray):
    """Vectorized hybrid-uint, config (4,1,0) (entropy.c:427-444)."""
    v = values.astype(jnp.int32)
    small = v < 16
    x = jnp.maximum(v, 16)
    n = _fllog2_u32(x) - 1
    residue_bits = jnp.where(small, 0, n).astype(jnp.uint8)
    residue = jnp.where(small, 0, x & ((1 << n) - 1)).astype(jnp.uint32)
    high = (x >> n) & 1
    token = jnp.where(small, v, 16 + (high | ((n - 3) << 1)))
    return token.astype(jnp.uint16), residue, residue_bits


def predicted_nonzeroes(nz: jnp.ndarray) -> jnp.ndarray:
    """[G, 32, 32, 3] per-group neighbor prediction (encoder.c:670-678)."""
    above = jnp.pad(nz[:, :-1], ((0, 0), (1, 0), (0, 0), (0, 0)))
    left = jnp.pad(nz[:, :, :-1], ((0, 0), (0, 0), (1, 0), (0, 0)))
    pred = (above + left + 1) >> 1
    gbh, gbw = nz.shape[1], nz.shape[2]
    row0 = jnp.arange(gbh)[None, :, None, None] == 0
    col0 = jnp.arange(gbw)[None, None, :, None] == 0
    first_col_prev_row = jnp.pad(nz[:, :-1, :1],
                                 ((0, 0), (1, 0), (0, 0), (0, 0)))
    pred = jnp.where(row0, left, pred)
    pred = jnp.where(col0, jnp.broadcast_to(first_col_prev_row, pred.shape),
                     pred)
    pred = jnp.where(row0 & col0, 32, pred)
    return pred


def _staircase(x: jnp.ndarray, table: np.ndarray) -> jnp.ndarray:
    """Evaluate table[x] for a small host-known integer `table` as a sum
    of step functions -- one vector compare + add per value change, all
    elementwise work that fuses into its neighbours."""
    t = np.asarray(table, np.int64)
    acc = jnp.full(x.shape, int(t[0]), jnp.int32)
    for r in range(1, len(t)):
        d = int(t[r] - t[r - 1])
        if d:
            acc = acc + jnp.where(x >= r, jnp.int32(d), jnp.int32(0))
    return acc


def tokenize_flat(q: jnp.ndarray, nz_flat: jnp.ndarray,
                  preset_flat: jnp.ndarray, blockctx_flat: jnp.ndarray,
                  clusters_per_preset: int):
    """HF context modeling + tokenization on the flat layout.

    q:        [N, 64] int32 quantized coefficients, emission order, slot 0
              unused (DC)
    nz_flat:  [N] nonzero AC count per block-channel
    preset_flat: [N] histogram preset index
    blockctx_flat: [N] emission channel index 0..2
    clusters_per_preset: 9/3/2/1 (the tables.hf_cluster_map rule)
    Returns (tokens u16 [N,64], clusters u8, residues u32, rbits u8,
             valid_len i32 [N]).  encoder.c:689-750.

    The context->cluster map is evaluated ANALYTICALLY instead of
    gathering from the 1485*presets-entry table: tables.hf_cluster_map
    is `j % 3` over nonzero-count contexts and `3 + (j - 111) % 6` over
    coefficient contexts (per preset; 9-cluster rule), which with
    COEFF_CONTEXTS_PER_BLOCK_CTX % 6 == 2 collapses to
        cluster0     = blockctx
        cluster[1:]  = 3 + 2*((blockctx + cnzc[r] + cfc[k]) % 3) + prev
    (and constants for the 3/2/1-cluster rules); verified exhaustively
    against the gather in tests/test_pipeline_jax.py."""
    nonzero = (q[:, 1:] != 0).astype(jnp.int32)
    cum = jnp.cumsum(nonzero, axis=-1)
    remaining = nz_flat[:, None] - jnp.pad(cum[:, :-1], ((0, 0), (1, 0)))
    prev = jnp.concatenate(
        [(nz_flat <= 4).astype(jnp.int32)[:, None], nonzero[:, :-1]], axis=-1)

    per = clusters_per_preset
    if per == 9:
        cnzc3 = np.asarray(tables.COEFF_NUM_NONZERO_CONTEXT) % 3
        cfc3 = jnp.asarray(np.asarray(tables.COEFF_FREQ_CONTEXT[1:]) % 3,
                           jnp.int32)
        m3 = _staircase(jnp.clip(remaining, 0, 63), cnzc3)
        m = (blockctx_flat[:, None] + m3 + cfc3[None, :]) % 3
        cls_coeff = 3 + 2 * m + prev
        cls0 = blockctx_flat
    elif per == 3:
        cls_coeff = 1 + prev
        cls0 = jnp.zeros_like(blockctx_flat)
    elif per == 2:
        cls_coeff = jnp.broadcast_to(jnp.int32(1), prev.shape)
        cls0 = jnp.zeros_like(blockctx_flat)
    else:
        cls_coeff = jnp.zeros_like(prev)
        cls0 = jnp.zeros_like(blockctx_flat)
    clusters = (per * preset_flat[:, None]
                + jnp.concatenate([cls0[:, None], cls_coeff], axis=-1)
                ).astype(jnp.uint8)

    j_idx = jnp.arange(1, 64)
    last_nz = jnp.max(jnp.where(nonzero > 0, j_idx[None, :], 0), axis=-1)
    valid_len = (1 + last_nz).astype(jnp.int32)

    values = jnp.concatenate(
        [nz_flat[:, None].astype(jnp.uint32), pack_signed(q[:, 1:])], axis=-1)

    tokens, residues, residue_bits = hybridize(values)
    return tokens, clusters, residues, residue_bits, valid_len


@partial(jax.jit, static_argnames=("buf_h", "buf_w", "linear_light",
                                   "num_clusters", "sample_kind",
                                   "lf_seg_vb", "clusters_per_preset"))
def encode_lfg(pixels: jnp.ndarray, height, width, presets: jnp.ndarray,
               cluster_map: jnp.ndarray, *, buf_h: int, buf_w: int,
               linear_light: bool, num_clusters: int,
               sample_kind: str,
               lf_seg_vb: int = 0,
               clusters_per_preset: int = 0) -> Dict[str, jnp.ndarray]:
    """Full device pipeline for one LF group (or one tile-frame).

    pixels: [uh <= buf_h, uw <= buf_w, 3] buffer; `height`/`width` are
    the true dims (traced scalars) so one executable serves every LFG
    shape.  Undersized pixel buffers are zero-padded ON DEVICE to
    [buf_h, buf_w], so edge LF groups upload only about their true
    extent (the padding rows are zeros by contract anyway).
    presets: [G_buf] preset per group (raster over the buffer's group
    grid).  Returns device arrays; the host slices valid regions."""
    uh, uw = pixels.shape[0], pixels.shape[1]
    if uh != buf_h or uw != buf_w:
        pixels = jnp.pad(pixels, ((0, buf_h - uh), (0, buf_w - uw), (0, 0)))
    gcy, gcx = buf_h >> 8, buf_w >> 8          # buffer group grid
    height = jnp.asarray(height, jnp.int32)
    width = jnp.asarray(width, jnp.int32)
    vh = (height + 7) >> 3
    vw = (width + 7) >> 3

    # -> grouped layout [G, 32, 32, 3(, 64)] -> flat [N(, 64)]
    def group_flat(x):
        g = x.reshape((gcy, 32, gcx, 32) + x.shape[2:])
        perm = (0, 2, 1, 3) + tuple(range(4, g.ndim))
        return g.transpose(perm).reshape((gcy * gcx * 1024 * 3,)
                                         + x.shape[3:])

    lf_q, q = quantize_frontend(pixels, height, width,
                                linear_light=linear_light,
                                sample_kind=sample_kind)
    lf_res = lf_residuals(lf_q, lf_seg_vb)
    q_flat = group_flat(q)                     # [N, 64]

    nz_flat = jnp.sum((q_flat != 0).astype(jnp.int32), axis=-1)
    preset_flat = jnp.repeat(presets, 1024 * 3,
                             total_repeat_length=gcy * gcx * 1024 * 3)
    blockctx_flat = jnp.tile(jnp.arange(3, dtype=jnp.int32),
                             gcy * gcx * 1024)

    # `cluster_map` is accepted for interface stability but the map is
    # evaluated analytically (see tokenize_flat); the caller's map must
    # be tables.hf_cluster_map(num_presets), which is the only map this
    # framework (like the reference, encoder.c:855-901) ever builds.
    del cluster_map
    per = clusters_per_preset if clusters_per_preset else num_clusters
    tokens, clusters, residues, residue_bits, valid_len = tokenize_flat(
        q_flat, nz_flat, preset_flat, blockctx_flat, per)

    # blocks beyond each group's true varblock extent emit nothing
    gbh = jnp.clip(vh - jnp.arange(gcy) * 32, 0, 32)     # [gcy]
    gbw = jnp.clip(vw - jnp.arange(gcx) * 32, 0, 32)     # [gcx]
    by = jnp.arange(32)
    bx = jnp.arange(32)
    ok = ((by[None, :, None, None] < gbh[:, None, None, None])
          & (bx[None, None, None, :] < gbw[None, None, :, None]))
    # ok: [gcy, 32, gcx, 32] -> grouped [G, 32, 32] -> flat with channel
    ok = ok.transpose(0, 2, 1, 3).reshape(gcy * gcx, 32, 32)
    ok_flat = jnp.repeat(ok.reshape(-1), 3, total_repeat_length=valid_len.size)
    valid_len = jnp.where(ok_flat, valid_len, 0)

    hist = jnp.zeros((num_clusters, 128), jnp.int32)
    mask = (jnp.arange(64)[None, :] < valid_len[:, None]).astype(jnp.int32)
    hist = hist.at[clusters.astype(jnp.int32),
                   jnp.minimum(tokens, 127).astype(jnp.int32)].add(mask)

    return {
        "lf_q": lf_q, "lf_res": lf_res, "hist": hist,
        "tokens": tokens, "clusters": clusters, "residues": residues,
        "residue_bits": residue_bits, "valid_len": valid_len,
    }


# ---------------------------------------------------------------------------
# packed-payload variant: near-entropy device->host transfer (format v4)
# ---------------------------------------------------------------------------
#
# Payload layout (u32 words), shared with encoder._parse_packed,
# parallel/driver.py and the C++ walker (cpp/serializer.cc) -- the four
# must change together:
#
#   aux (fixed A = 8 + 640 + 3*G words):
#     [0]        ok word: bit 0 = payload valid; value 2 = invalid but
#                retryable with wide_residues=True (a residue chunk
#                exceeded the fast packing budget -- ~12 b/slot
#                aggregate or RES_CAP_FAST bits in one field -- or an
#                LF field exceeded 32 bits; the wide executable packs
#                the format's full ~24 b/slot, 30 b/field residue and
#                42 b/field LF budgets); 0 -> caller falls back unpacked
#     [1]        total token bits
#     [2]        total residue bits
#     [3]        total LF-residual stream bits (format v4)
#     [4]        checksum (u32 wrap-sum) of aux[8:A]
#     [5]        checksum of the LF word section
#     [6]        checksum of the token word section
#     [7]        checksum of the residue word section
#                (the host verifies every fetched section and refetches
#                 once on a mismatch)
#     [8:648]    per-class transport-symbol histogram (10 x 64 bins:
#                rows 0..8 = HF classes, row 9 = LF hybrid tokens;
#                feeds the NEXT dispatch's transport code,
#                jxl/tokcode.py).  HF rows are block-sampled and
#                HS-scaled (HIST_SAMPLE_STRIDE) -- adaptive-code input,
#                not exact counts
#     [..+G]     per-group symbol counts
#     [..+G]     per-group residue bit counts
#     [..+G]     per-group token bit counts
#   then, at dynamic word offsets:
#     LF residuals (format v4): per value one field = transport Huffman
#     code of the hybrid-uint token (class 9) followed by the raw
#     residue bits, bit-contiguous over the full buffer varblock grid
#     (decoded host-side by cpp/serializer.cc hyd_lf_decode);
#     Huffman-coded HF tokens (transport code; <= 12 bits/token); raw
#     residue bits.
#
# Tokens are transport-Huffman-coded with host-supplied per-cluster
# codes (9 classes, selected by the same within-preset context
# clustering the final ANS stream uses -- both sides know a symbol's
# cluster before decoding it); the walker reconstructs each
# block-channel's symbol count from the decoded nonzero count, exactly
# as a JXL decoder does (encoder.c:689-750).
#
# Word-aligned chunks (format v3): the token and residue streams are
# sequences of CHUNKS of TOK_CHUNK=4096 / RES_CHUNK=2048 slot-fields,
# each chunk's bits starting at a 32-bit word boundary (<= 31 pad-zero
# bits between chunks, ~36 KB per 2048^2 LF group).  Chunk boundaries
# fall every 64 (tokens) / 32 (residues) block-channels in flat group
# order and therefore NEVER straddle a group (3072 block-channels per
# group), so the reader needs no side table: it rounds its bit cursor
# up to the next word boundary whenever the block-channel counter
# crosses a chunk boundary.  The per-group bit counts in aux are the
# PADDED (word-aligned) totals, so per-group offsets remain plain
# cumulative sums.


def _bitpack(values: jnp.ndarray, nbits: jnp.ndarray,
             num_words: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Scatter variable-width fields into a little-endian u32 word array.

    values: [M] uint32 (must be < 2**nbits, 0 where nbits==0)
    nbits:  [M] int32 (<= 32)
    Returns (words [num_words] u32, total_bits scalar).  Fields occupy
    disjoint bits, so the scatter-ADD of their shifted halves is an OR."""
    # int32 suffices: <= 12.6M slots * 24 bits < 2^31 total bits
    nb = nbits.astype(jnp.int32)
    off = jnp.cumsum(nb) - nb
    total = off[-1] + nb[-1] if nb.size else jnp.int32(0)
    return _bitpack_at(values, off, num_words), total.astype(jnp.int32)


def _bitpack64(lo_vals: jnp.ndarray, hi_vals: jnp.ndarray,
               nbits: jnp.ndarray,
               num_words: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """_bitpack for fields up to 64 bits, split as (lo 32, hi rest)
    u32 lanes (jax runs without x64): three scatter contributions per
    field."""
    nb = nbits.astype(jnp.int32)
    off = jnp.cumsum(nb) - nb
    total = off[-1] + nb[-1] if nb.size else jnp.int32(0)
    word = (off >> 5).astype(jnp.int32)
    shift = (off & 31).astype(jnp.uint32)
    lo = lo_vals.astype(jnp.uint32)
    hi = hi_vals.astype(jnp.uint32)
    inv = jnp.uint32(32) - shift
    c0 = lo << shift
    c1 = jnp.where(shift > 0, lo >> inv, 0) | (hi << shift)
    c2 = jnp.where(shift > 0, hi >> inv, 0)
    words = jnp.zeros((num_words,), jnp.uint32)
    words = words.at[word].add(c0, mode="drop")
    words = words.at[jnp.minimum(word + 1, num_words - 1)].add(
        c1, mode="drop")
    words = words.at[jnp.minimum(word + 2, num_words - 1)].add(
        c2, mode="drop")
    return words, total.astype(jnp.int32)


# Transport-histogram block sampling: the aux histogram only feeds the
# ADAPTIVE transport code (jxl/tokcode.py TokenCodec.update), where
# approximation costs a little compression but never correctness, so
# every HIST_SAMPLE_STRIDE-th block-channel row is counted and the
# counts are scaled back up.  Stride 1 restores exact counts
# (HYDRIUM_HIST_SAMPLE_STRIDE, read at import).
HIST_SAMPLE_STRIDE = max(1, int(os.environ.get(
    "HYDRIUM_HIST_SAMPLE_STRIDE", "4")))


# format-v3 chunk geometry: slots per chunk, and the residue chunks'
# word budgets.  Token chunks can never overflow (12-bit transport codes
# at most).  Residue chunks are budgeted at ~12 (fast) / ~24 (wide
# retry) bits per slot on average: a chunk may hold
# (RES_OW_* - RES_LANES_*) words, and any single field is capped at
# RES_CAP_* bits (real content's quantized HF residues are <= 10 bits).
# These budgets are format semantics: they decide the ok word.
TOK_CHUNK = 4096
TOK_MAX_LEN = 12   # jxl/tokcode.py MAX_LEN
RES_CHUNK, RES_OW_FAST, RES_OW_WIDE = 2048, 784, 1552
RES_CAP_FAST, RES_LANES_FAST = 15, 2
RES_CAP_WIDE, RES_LANES_WIDE = 30, 4


def _chunk_layout(nbits: jnp.ndarray, ch: int):
    """Field bit offsets for format v3's word-aligned chunking.

    nbits [F] i32 (F % ch == 0).  Returns (off [F] absolute bit offset
    of each field, nw [R] words per chunk, chunk_bits [R]); chunk r
    starts at word sum(nw[:r])."""
    F = nbits.shape[0]
    R = F // ch
    nb = nbits.reshape(R, ch).astype(jnp.int32)
    inc = jnp.cumsum(nb, axis=1)
    chunk_bits = inc[:, -1]
    nw = (chunk_bits + 31) >> 5
    wstart = jnp.cumsum(nw) - nw
    off = (wstart[:, None] * 32 + (inc - nb)).reshape(F)
    return off, nw, chunk_bits


def _bitpack_at(values: jnp.ndarray, off: jnp.ndarray,
                num_words: int) -> jnp.ndarray:
    """Scatter variable-width (<= 32-bit) fields at caller-supplied
    absolute bit offsets into a u32 word array.  A field spans at most
    two words; fields never overlap, so the scatter-add of the two
    shifted halves is a bitwise OR.  Fields past num_words are
    dropped."""
    word = (off >> 5).astype(jnp.int32)
    shift = (off & 31).astype(jnp.uint32)
    v = values.astype(jnp.uint32)
    lo = v << shift
    hi = jnp.where(shift > 0, v >> (jnp.uint32(32) - shift), 0)
    words = jnp.zeros((num_words,), jnp.uint32)
    words = words.at[word].add(lo, mode="drop")
    words = words.at[jnp.minimum(word + 1, num_words - 1)].add(
        hi, mode="drop")
    return words


def _bitpack_v3(values: jnp.ndarray, nbits: jnp.ndarray, ch: int,
                num_words: int):
    """Pack single fields into format v3's word-aligned chunk stream.

    Returns (words [num_words], nw [R] words per chunk, chunk_bits [R]).
    When any chunk's bits exceed its budget the words are garbage --
    the caller checks chunk_bits and falls back / retries wide."""
    off, nw, chunk_bits = _chunk_layout(nbits, ch)
    return _bitpack_at(values, off, num_words), nw, chunk_bits


def _hf_transport_streams(out, tok_len: jnp.ndarray, tok_code: jnp.ndarray,
                          tok_classes: int):
    """Stage 1 of the packed tail: flatten HF tokens/residues, look up
    each slot's transport code, and build the sampled per-class
    histogram.  Returns (t_flat, t_bits, hist64, r_flat, r_bits,
    tok_ok)."""
    tokens = out["tokens"]            # [N, 64] u16
    residues = out["residues"]        # [N, 64] u32
    residue_bits = out["residue_bits"]
    valid_len = out["valid_len"]      # [N]
    N = valid_len.shape[0]
    M = N * 64

    valid = (jnp.arange(64)[None, :] < valid_len[:, None])
    tok_ok = jnp.all(jnp.where(valid, tokens, 0) < 64)

    t_idx = jnp.where(valid, jnp.minimum(tokens, 63), 0).astype(
        jnp.int32).reshape(M)
    mask_i32 = valid.astype(jnp.int32).reshape(M)
    # transport class = within-preset cluster id, known to the walker
    # before each token is decoded
    cls = (out["clusters"].astype(jnp.int32) % tok_classes).reshape(M)
    r_flat = jnp.where(valid, residues, 0).reshape(M)
    r_bits = jnp.where(valid, residue_bits.astype(jnp.int32), 0).reshape(M)

    # code/length lookup: one gather from the [classes*64] tables
    ct_idx = cls * 64 + t_idx
    t_flat = jnp.where(mask_i32 > 0, tok_code[ct_idx].astype(jnp.uint32), 0)
    t_bits = tok_len[ct_idx].astype(jnp.int32) * mask_i32

    # histogram sampling: every HS-th block-channel ROW (all 64 zigzag
    # positions of the sampled blocks -- a positionally unbiased sample,
    # unlike striding the flat slot array), counts scaled back by HS
    HS = HIST_SAMPLE_STRIDE if N % HIST_SAMPLE_STRIDE == 0 else 1
    t_h = t_idx.reshape(N, 64)[::HS].reshape(-1)
    c_h = cls.reshape(N, 64)[::HS].reshape(-1)
    m_h = mask_i32.reshape(N, 64)[::HS].reshape(-1)
    hist64 = jnp.zeros((9 * 64,), jnp.int32).at[c_h * 64 + t_h].add(
        m_h) * HS
    return t_flat, t_bits, hist64, r_flat, r_bits, tok_ok


def _hf_pack_streams(t_flat, t_bits, r_flat, r_bits, M: int,
                     wide_residues: bool):
    """Stage 2 of the packed tail: format-v3 chunk packing of the HF
    token/residue streams.  Returns (tok_words, tok_nw, res_words,
    res_nw, res_cb, tok_total, res_total, res_okc, tok_cap_words,
    res_cap_words)."""
    # Residue chunks are budgeted at ~12 bits/slot average and
    # RES_CAP_FAST bits/field -- plenty for real content (noise packs
    # ~1-7 b/slot, fields <= ~10 bits) -- and denser content sets ok=2
    # ("retry with wide_residues=True", a second cached executable at
    # the format's full ~24 b/slot, 30 b/field budget) instead of 1.
    res_ow = RES_OW_WIDE if wide_residues else RES_OW_FAST
    res_cap = RES_CAP_WIDE if wide_residues else RES_CAP_FAST
    res_lanes = RES_LANES_WIDE if wide_residues else RES_LANES_FAST
    tok_cap_words = (M // TOK_CHUNK) * ((TOK_MAX_LEN * TOK_CHUNK) >> 5)
    res_cap_words = (M // RES_CHUNK) * (res_ow - res_lanes)
    tok_words, tok_nw, _tok_cb = _bitpack_v3(t_flat, t_bits, TOK_CHUNK,
                                             tok_cap_words)
    res_words, res_nw, res_cb = _bitpack_v3(r_flat, r_bits, RES_CHUNK,
                                            res_cap_words)
    tok_total = 32 * jnp.sum(tok_nw)
    res_total = 32 * jnp.sum(res_nw)
    res_fit = jnp.all(r_bits <= res_cap)
    res_okc = jnp.all(res_cb <= (res_ow - res_lanes) * 32) & res_fit
    return (tok_words, tok_nw, res_words, res_nw, res_cb, tok_total,
            res_total, res_okc, tok_cap_words, res_cap_words)


def _lf_pack_stream(out, tok_len: jnp.ndarray, tok_code: jnp.ndarray,
                    wide_residues: bool):
    """Stage 3 of the packed tail: the format-v4 LF residual stream.
    Returns (lf_words, lf_total, hist_lf, lf_tok_ok, lf_fit_fast,
    lf_fit_wide, lf_cap_words)."""
    # LF residuals (format v4): hybrid-uint tokens under transport class
    # 9 + raw residue bits, one contiguous field per value (code first);
    # decoded host-side by cpp/serializer.cc hyd_lf_decode.
    lf_res = out["lf_res"].reshape(-1).astype(jnp.uint32)
    lf_n = lf_res.shape[0]
    lf_tok, lf_residue, lf_rbits8 = hybridize(lf_res)
    lf_rbits = lf_rbits8.astype(jnp.int32)
    lf_tok_ok = jnp.all(lf_tok < 64)
    lf_t = jnp.minimum(lf_tok, 63).astype(jnp.int32)
    lf_code = tok_code[9 * 64 + lf_t].astype(jnp.uint32)
    lf_len = tok_len[9 * 64 + lf_t].astype(jnp.int32)
    hist_lf = jnp.zeros((64,), jnp.int32).at[lf_t].add(1)
    lf_nbits = lf_len + lf_rbits
    lf_lenu = lf_len.astype(jnp.uint32)
    lf_lo = lf_code | (lf_residue << lf_lenu)
    lf_fit_fast = jnp.all(lf_nbits <= 32)
    lf_fit_wide = jnp.all(lf_rbits <= 30)    # len <= 12 -> field <= 42
    lf_cap_words = lf_n + lf_n // 2          # 42 bits/value worst case
    if wide_residues:
        lf_hi = jnp.where(lf_lenu > 0,
                          lf_residue >> (jnp.uint32(32) - lf_lenu), 0)
        lf_words, lf_total = _bitpack64(lf_lo, lf_hi, lf_nbits,
                                        lf_cap_words)
    else:
        # fast executable: single-lane fields (<= 32 bits); denser LF
        # content retries wide via ok=2
        lf_words, lf_total = _bitpack(
            lf_lo, jnp.where(lf_nbits <= 32, lf_nbits, 0), lf_cap_words)
    return (lf_words, lf_total, hist_lf, lf_tok_ok, lf_fit_fast,
            lf_fit_wide, lf_cap_words)


@partial(jax.jit, static_argnames=("buf_h", "buf_w", "linear_light",
                                   "num_clusters", "sample_kind",
                                   "lf_seg_vb", "tok_classes",
                                   "wide_residues"))
def encode_lfg_packed(pixels: jnp.ndarray, height, width, presets: jnp.ndarray,
                      cluster_map: jnp.ndarray, tok_len: jnp.ndarray,
                      tok_code: jnp.ndarray, *, buf_h: int, buf_w: int,
                      linear_light: bool, num_clusters: int,
                      sample_kind: str,
                      lf_seg_vb: int = 0,
                      tok_classes: int = 9,
                      wide_residues: bool = False) -> Dict[str, jnp.ndarray]:
    """encode_lfg + on-device stream packing, so the device->host
    transfer carries near-entropy bit streams instead of arrays (payload
    format v4, see the module comment above).

    tok_len[9*64]/tok_code[9*64]: per-cluster transport Huffman codes
    for the token stream (jxl/tokcode.py), LSB-first codewords, lengths
    1..12, indexed class*64+token where class = cluster % tok_classes
    (the within-preset cluster id; tok_classes = clusters per preset,
    9/3/2/1 per tables.hf_cluster_map).  ok=2 asks for a wide retry (a
    residue chunk denser than the fast aggregate budget, or any field
    wider than RES_CAP_FAST); ok drops to 0 (-> unpacked fallback) only
    when a token exceeds the 64-symbol transport alphabet or residues
    overflow even the wide budget."""
    out = encode_lfg(pixels, height, width, presets, cluster_map,
                     buf_h=buf_h, buf_w=buf_w, linear_light=linear_light,
                     num_clusters=num_clusters, sample_kind=sample_kind,
                     lf_seg_vb=lf_seg_vb, clusters_per_preset=tok_classes)
    valid_len = out["valid_len"]      # [N]
    N = valid_len.shape[0]
    G = N // (1024 * 3)
    M = N * 64

    t_flat, t_bits, hist64, r_flat, r_bits, tok_ok = \
        _hf_transport_streams(out, tok_len, tok_code, tok_classes)
    (tok_words, tok_nw, res_words, res_nw, res_cb, tok_total, res_total,
     res_okc, tok_cap_words, res_cap_words) = _hf_pack_streams(
        t_flat, t_bits, r_flat, r_bits, M, wide_residues)

    per_group_syms = valid_len.reshape(G, -1).sum(axis=1).astype(jnp.int32)
    # per-group PADDED totals (multiples of 32) so host offsets stay
    # plain cumulative sums; chunks never straddle a group
    per_group_rbits = 32 * res_nw.reshape(G, -1).sum(axis=1).astype(jnp.int32)
    per_group_tbits = 32 * tok_nw.reshape(G, -1).sum(axis=1).astype(jnp.int32)

    (lf_words, lf_total, hist_lf, lf_tok_ok, lf_fit_fast, lf_fit_wide,
     lf_cap_words) = _lf_pack_stream(out, tok_len, tok_code, wide_residues)

    lf_ok = lf_tok_ok & (lf_fit_wide if wide_residues else lf_fit_fast)
    ok_full = tok_ok & res_okc & lf_ok
    if wide_residues:
        retryable = jnp.bool_(False)
    else:
        retryable = (tok_ok & lf_tok_ok & lf_fit_wide
                     & jnp.all(res_cb <= (RES_OW_WIDE - RES_LANES_WIDE)
                               * 32)
                     & ~(res_okc & lf_fit_fast))
    ok_word = jnp.where(ok_full, jnp.int32(1),
                        jnp.where(retryable, jnp.int32(2), jnp.int32(0)))

    tail = jnp.concatenate([hist64, hist_lf, per_group_syms,
                            per_group_rbits, per_group_tbits])
    _i32 = lambda x: jax.lax.bitcast_convert_type(x, jnp.int32)
    aux_ck = _i32(jnp.sum(tail.astype(jnp.uint32)))
    lf_ck = _i32(jnp.sum(lf_words))
    tok_ck = _i32(jnp.sum(tok_words))
    res_ck = _i32(jnp.sum(res_words))
    aux = jnp.concatenate([
        jnp.stack([ok_word, tok_total, res_total,
                   lf_total.astype(jnp.int32),
                   aux_ck, lf_ck, tok_ck, res_ck]),
        tail,
    ])
    lf_used = (lf_total + 31) >> 5
    tok_used = (tok_total + 31) >> 5
    # ONE combined buffer: [aux | LF words | token words | residue words]
    # so the host usually needs a single read per LF group (it sizes the
    # fetch from the previous LF group's stream length and tops up with
    # a ranged fetch only when the guess was short).
    A = aux.shape[0]
    combined = jnp.zeros((A + lf_cap_words + tok_cap_words + res_cap_words,),
                         jnp.uint32)
    combined = jax.lax.dynamic_update_slice(
        combined, jax.lax.bitcast_convert_type(aux, jnp.uint32), (0,))
    combined = jax.lax.dynamic_update_slice(combined, lf_words, (A,))
    combined = jax.lax.dynamic_update_slice(combined, tok_words,
                                            (A + lf_used,))
    combined = jax.lax.dynamic_update_slice(combined, res_words,
                                            (A + lf_used + tok_used,))

    # NOTE: no per-cluster "hist" here -- the native walker recounts
    # exact frequencies host-side, and XLA dead-code-eliminates the
    # unpacked path's histogram scatter when its output is unused.
    return {"combined": combined}


# ---------------------------------------------------------------------------
# PXPACK: packed pixel *upload* (the host->device mirror of the payload)
# ---------------------------------------------------------------------------
#
# The host packs u8/u16 pixel buffers into per-block bit planes
# (cpp/serializer.cc hyd_px_pack; format documented there -- the two
# sides must change together) and the device unpacks them here with
# vectorized shifts/masks before running the normal pipeline.  Gradient
# content drops from 24 to a few bits/px.  Lossless: tests pin
# byte-identical encodes vs the raw-upload path.


def _unpack_px_planes(words: jnp.ndarray, hdr: jnp.ndarray,
                      base: jnp.ndarray, ubuf_h: int, ubuf_w: int,
                      is16: bool) -> jnp.ndarray:
    """[nwords] u32 + per-block hdr/base -> planar [3, ubuf_h, ubuf_w]
    int32 pixels.  Blocks are 32 px along a row in channel-planar raster
    order; hdr bits 0..4 = bit width, bit 7 = delta mode; plane word j
    holds bit j of all 32 coded values."""
    wb = ubuf_w >> 5
    nb = 3 * ubuf_h * wb
    width = (hdr & 31).astype(jnp.int32)                    # [nb]
    is_delta = (hdr >> 7) > 0                               # [nb]
    off = jnp.cumsum(width) - width                         # [nb]
    wmax = 16 if is16 else 8
    n = words.shape[0]
    # the one gather of the unpack: each block's (up to) wmax plane
    # words; unused lanes are masked by `width` below, so the clamped
    # over-read is harmless
    idx = off[:, None] + jnp.arange(wmax, dtype=jnp.int32)[None, :]
    planes = words[jnp.minimum(idx, n - 1)]                 # [nb, wmax]
    k = jnp.arange(32, dtype=jnp.uint32)[None, :]
    v = jnp.zeros((nb, 32), jnp.uint32)
    for j in range(wmax):
        bit = (planes[:, j:j + 1] >> k) & jnp.uint32(1)
        v = v | jnp.where(j < width[:, None], bit << j, jnp.uint32(0))
    # delta blocks: unzigzag + running sum from base (coded value 0 of a
    # delta block is always 0, so rec[0] == base == first pixel)
    d = (v >> 1).astype(jnp.int32) ^ -((v & 1).astype(jnp.int32))
    b32 = base.astype(jnp.int32)[:, None]
    rec = jnp.where(is_delta[:, None], b32 + jnp.cumsum(d, axis=1),
                    b32 + v.astype(jnp.int32))              # [nb, 32]
    return rec.reshape(3, ubuf_h, ubuf_w)


@partial(jax.jit, static_argnames=("ubuf_h", "ubuf_w", "buf_h", "buf_w",
                                   "linear_light", "num_clusters",
                                   "sample_kind", "lf_seg_vb",
                                   "tok_classes", "wide_residues"))
def encode_lfg_packed_px(words: jnp.ndarray, hdr: jnp.ndarray,
                         base: jnp.ndarray, height, width,
                         presets: jnp.ndarray, cluster_map: jnp.ndarray,
                         tok_len: jnp.ndarray, tok_code: jnp.ndarray, *,
                         ubuf_h: int, ubuf_w: int, buf_h: int, buf_w: int,
                         linear_light: bool, num_clusters: int,
                         sample_kind: str, lf_seg_vb: int = 0,
                         tok_classes: int = 9,
                         wide_residues: bool = False):
    """encode_lfg_packed fed by a PXPACK v1 upload instead of raw pixels.
    `words` arrives bucket-padded (the tail zeros are masked by hdr), so
    a handful of executables serve every packed size."""
    planar = _unpack_px_planes(words, hdr, base, ubuf_h, ubuf_w,
                               sample_kind == "uint16")
    dt = jnp.uint16 if sample_kind == "uint16" else jnp.uint8
    pixels = jnp.stack([planar[0], planar[1], planar[2]],
                       axis=-1).astype(dt)
    return encode_lfg_packed(pixels, height, width, presets, cluster_map,
                             tok_len, tok_code, buf_h=buf_h, buf_w=buf_w,
                             linear_light=linear_light,
                             num_clusters=num_clusters,
                             sample_kind=sample_kind, lf_seg_vb=lf_seg_vb,
                             tok_classes=tok_classes,
                             wide_residues=wide_residues)


@partial(jax.jit, static_argnames=("ubuf_h", "ubuf_w", "meta_h", "meta_w",
                                   "buf_h", "buf_w", "linear_light",
                                   "num_clusters", "sample_kind",
                                   "lf_seg_vb", "tok_classes",
                                   "wide_residues"))
def encode_lfg_packed_px2(words: jnp.ndarray, hdr2: jnp.ndarray,
                          base2: jnp.ndarray, words2: jnp.ndarray,
                          height, width, presets: jnp.ndarray,
                          cluster_map: jnp.ndarray, tok_len: jnp.ndarray,
                          tok_code: jnp.ndarray, *, ubuf_h: int, ubuf_w: int,
                          meta_h: int, meta_w: int, buf_h: int, buf_w: int,
                          linear_light: bool, num_clusters: int,
                          sample_kind: str, lf_seg_vb: int = 0,
                          tok_classes: int = 9,
                          wide_residues: bool = False):
    """PXPACK v2 upload: the level-1 (hdr, base) arrays arrive packed as
    a [meta_h, meta_w, 3] meta image (jxl/native.py px_pack2 -- shared
    layout, change both together) and are unpacked with the SAME plane
    decoder before the pixel planes.  Meta channels: 0 = width,
    1 = base_lo, 2 = base_hi<<1 | delta_mode."""
    is16 = sample_kind == "uint16"
    m = _unpack_px_planes(words2, hdr2, base2, meta_h, meta_w, is16)
    w1 = m[0].reshape(-1)
    lo = m[1].reshape(-1)
    him = m[2].reshape(-1)
    hdr1 = w1 | ((him & 1) << 7)
    base1 = lo | ((him >> 1) << 8)
    planar = _unpack_px_planes(words, hdr1, base1, ubuf_h, ubuf_w, is16)
    dt = jnp.uint16 if is16 else jnp.uint8
    pixels = jnp.stack([planar[0], planar[1], planar[2]],
                       axis=-1).astype(dt)
    return encode_lfg_packed(pixels, height, width, presets, cluster_map,
                             tok_len, tok_code, buf_h=buf_h, buf_w=buf_w,
                             linear_light=linear_light,
                             num_clusters=num_clusters,
                             sample_kind=sample_kind, lf_seg_vb=lf_seg_vb,
                             tok_classes=tok_classes,
                             wide_residues=wide_residues)


# aux layout constants (format v4); see the module comment above
AUX_SCALARS = 8
AUX_HIST_ROWS = 10      # 9 HF classes + 1 LF class
AUX_HIST = slice(8, 8 + AUX_HIST_ROWS * 64)


def packed_aux_len(buf_h: int, buf_w: int) -> int:
    """Length (in 32-bit words) of the fixed aux prefix of the combined
    packed payload for a given buffer shape (format v4)."""
    G = (buf_h >> 8) * (buf_w >> 8)
    return AUX_SCALARS + AUX_HIST_ROWS * 64 + 3 * G


def packed_lf_len(aux3_lf_bits: int) -> int:
    """Word count of the LF residual section (aux[3] = total bits)."""
    return (int(aux3_lf_bits) + 31) >> 5


# Tiled-mode batching STACKS same-size tiles vertically into one buffer
# and reuses these very executables: a 256x256 group of the stacked
# image IS one tile's group, and groups never interact (encoder.py
# send_tile_batch).
