"""Device (JAX) pipeline vs numpy conformance pipeline.

The device path uses direct float math instead of the reference's LUTs,
so quantized integers may differ on a tiny fraction of coefficients; the
tests check (a) near-total agreement of quantized ints, (b) exact
agreement of all context/token machinery when fed the same ints, (c)
histogram correctness, (d) dynamic-valid-dims masking on the fixed-size
buffer."""

import numpy as np
import pytest

import jax.numpy as jnp

from hydrium_tpu.ops import pipeline, reference as np_ops, tables
from hydrium_tpu.ops.hf_tokens import tokenize_group


def make_image(h, w, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack(
        [128 + 90 * np.sin(xx / 17.0) * np.cos(yy / 9.0),
         120 + 90 * np.cos(xx / 5.0) * np.sin(yy / 21.0),
         128 + 90 * np.sin((xx + yy) / 13.0)], axis=-1)
    img += rng.normal(0, 10, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def run_jax(img, buf=None):
    h, w = img.shape[:2]
    buf_h = buf or ((h + 255) >> 8) << 8
    buf_w = buf or ((w + 255) >> 8) << 8
    px = np.zeros((buf_h, buf_w, 3), np.uint8)
    px[:h, :w] = img
    cm = tables.hf_cluster_map(1)
    g = (buf_h >> 8) * (buf_w >> 8)
    out = pipeline.encode_lfg(
        jnp.asarray(px), h, w, jnp.zeros(g, jnp.int32), jnp.asarray(cm),
        buf_h=buf_h, buf_w=buf_w, linear_light=False, num_clusters=9,
        sample_kind="uint8")
    return {k: np.array(v) for k, v in out.items()}


def run_numpy(img):
    h, w = img.shape[:2]
    xyb = np_ops.pixels_to_xyb(img, "uint8", False)
    xyb = np_ops.pad_to_blocks(xyb, h, w)
    coeffs = np_ops.forward_dct(xyb)
    zz = np_ops.zigzag_gather(coeffs)
    hf_q, nz = np_ops.quantize_hf(zz)
    lf_q = np_ops.quantize_lf(coeffs[:, :, 0, 0, :])
    return lf_q, hf_q, nz


def test_quantized_agreement():
    img = make_image(256, 256)
    out = run_jax(img)
    lf_q, hf_q, nz = run_numpy(img)
    diff = np.abs(out["lf_q"].astype(np.int64) - lf_q)
    assert np.mean(diff > 1) == 0.0
    assert np.mean(diff == 1) < 0.02, f"LF mismatch rate {np.mean(diff==1)}"


def test_token_machinery_matches_numpy():
    """Feed the same quantized ints through jax tokenize_flat and the
    numpy tokenizer; streams must agree exactly."""
    img = make_image(300, 520, seed=2)
    h, w = img.shape[:2]
    lf_q, hf_q, nz = run_numpy(img)
    cm = tables.hf_cluster_map(1)
    vh, vw = (h + 7) >> 3, (w + 7) >> 3
    gcy, gcx = (h + 255) >> 8, (w + 255) >> 8

    # arrange numpy ints into the flat emission layout the device uses
    bq = np.zeros((gcy * 32, gcx * 32, 3, 64), np.int32)
    bnz = np.zeros((gcy * 32, gcx * 32, 3), np.int32)
    bq[:vh, :vw] = hf_q.transpose(0, 1, 3, 2)[:, :, [1, 0, 2], :]
    bnz[:vh, :vw] = nz[:, :, [1, 0, 2]]
    qg = bq.reshape(gcy, 32, gcx, 32, 3, 64).transpose(0, 2, 1, 3, 4, 5)
    q_flat = jnp.asarray(qg.reshape(-1, 64))
    nzg = bnz.reshape(gcy, 32, gcx, 32, 3).transpose(0, 2, 1, 3, 4)
    nz_grouped = jnp.asarray(nzg.reshape(gcy * gcx, 32, 32, 3))
    N = gcy * gcx * 1024 * 3
    toks = pipeline.tokenize_flat(
        q_flat, nz_grouped.reshape(-1),
        jnp.zeros(N, jnp.int32),
        jnp.tile(jnp.arange(3, dtype=jnp.int32), gcy * gcx * 1024),
        9)
    tokens, clusters, residues, rbits, valid_len = [np.array(t) for t in toks]
    tokens = tokens.reshape(gcy * gcx, 1024, 3, 64)
    clusters = clusters.reshape(tokens.shape)
    residues = residues.reshape(tokens.shape)
    rbits = rbits.reshape(tokens.shape)
    valid_len = valid_len.reshape(gcy * gcx, 1024, 3)

    for gy in range(gcy):
        for gx in range(gcx):
            gi = gy * gcx + gx
            gbh = min(32, vh - gy * 32)
            gbw = min(32, vw - gx * 32)
            ref_tok = tokenize_group(
                hf_q[gy * 32:gy * 32 + gbh, gx * 32:gx * 32 + gbw],
                nz[gy * 32:gy * 32 + gbh, gx * 32:gx * 32 + gbw], 0, cm)
            rt, rc, rr, rb = ref_tok.flatten()
            vl = valid_len[gi].reshape(32, 32, 3).copy()
            vl[gbh:, :] = 0
            vl[:, gbw:] = 0
            mask = (np.arange(64)[None, None, None, :]
                    < vl[..., None])
            t4 = tokens[gi].reshape(32, 32, 3, 64)
            c4 = clusters[gi].reshape(32, 32, 3, 64)
            r4 = residues[gi].reshape(32, 32, 3, 64)
            b4 = rbits[gi].reshape(32, 32, 3, 64)
            assert np.array_equal(t4[mask], rt), (gy, gx)
            assert np.array_equal(c4[mask], rc)
            assert np.array_equal(r4[mask], rr)
            assert np.array_equal(b4[mask], rb)


def test_valid_len_masks_buffer_padding():
    """With a buffer bigger than the image, out-of-extent blocks must
    emit nothing and in-extent results must be unchanged."""
    img = make_image(100, 70, seed=5)
    small = run_jax(img)                # 256x256 buffer
    big = run_jax(img, buf=512)         # 512x512 buffer, 4 groups
    vl_small = small["valid_len"].reshape(1024, 3)
    vl_big = big["valid_len"].reshape(4, 1024, 3)
    # same total symbols; groups 1..3 all empty
    assert vl_big[1:].sum() == 0
    assert vl_big[0].sum() == vl_small.sum()
    assert np.array_equal(big["hist"], small["hist"])


def test_histogram_matches_manual():
    img = make_image(256, 256, seed=3)
    out = run_jax(img)
    mask = np.arange(64)[None, :] < out["valid_len"][:, None]
    c = out["clusters"][mask]
    t = out["tokens"][mask]
    manual = np.zeros((9, 128), np.int64)
    np.add.at(manual, (c.astype(int), t.astype(int)), 1)
    assert np.array_equal(out["hist"].astype(np.int64), manual)


def test_lf_residuals_match():
    img = make_image(300, 520, seed=4)
    out = run_jax(img)
    vh, vw = (300 + 7) >> 3, (520 + 7) >> 3
    lf_q = out["lf_q"][:vh, :vw]
    res = np_ops.pack_signed(np_ops.lf_predict_residuals(lf_q))
    assert np.array_equal(out["lf_res"][:vh, :vw], res)


def test_packed_walk_class_count_contract():
    """Frames with >= 29 presets use 3 clusters per preset, so the
    transport-code class modulus is 3, not 9 -- the device packs with
    class = cluster % 3 and the walker must select tables the same way
    (it derives the modulus from the LUT slice it is given).  Regression
    test for the round-2 review finding: with a warmed codec whose 9
    class tables differ, a preset not divisible by 3 walks garbage if
    the contract is broken."""
    import jax.numpy as jnp

    from hydrium_tpu.jxl import native
    from hydrium_tpu.jxl.frame import HFStream, LFGroupGeometry
    from hydrium_tpu.jxl.tokcode import TokenCodec
    from hydrium_tpu.ops import pipeline, tables

    if not native.available():
        import pytest

        pytest.skip("native plane required")

    num_presets = 32
    cm = tables.hf_cluster_map(num_presets)
    num_clusters = int(cm.max()) + 1
    per = num_clusters // num_presets
    assert per == 3

    codec = TokenCodec()
    h = np.zeros((10, 64), np.int64)   # 9 HF classes + the LF class
    h[0, 0] = 100000
    h[1, 5] = 100000
    h[2, 17] = 50000
    h[9, 1] = 80000
    codec.update(h)          # class tables now differ strongly
    lens, codes, lut = codec.tables()

    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (256, 256, 3), dtype=np.uint8)
    preset = 17              # 17 % 3 != 0: exercises the modulus
    kwargs = dict(buf_h=256, buf_w=256, linear_light=False,
                  num_clusters=num_clusters, sample_kind="uint8")

    out_p = pipeline.encode_lfg_packed(
        jnp.asarray(img), 256, 256, jnp.full((1,), preset, jnp.int32),
        jnp.asarray(cm), jnp.asarray(lens), jnp.asarray(codes),
        tok_classes=per, **kwargs)
    combined = np.asarray(out_p["combined"])
    from hydrium_tpu.encoder import _parse_packed, packed_verify

    A = pipeline.packed_aux_len(256, 256)
    aux = np.ascontiguousarray(combined[:A]).view(np.int32)
    assert bool(aux[0]) and packed_verify(aux, combined[A:], 256, 256)
    geom = LFGroupGeometry(x=0, y=0, width=256, height=256,
                           tile_count_x=1, tile_count_y=1)
    from hydrium_tpu.jxl.tokcode import LF_CLASS

    parsed = _parse_packed(aux, combined[A:], 256, 256, geom, lut[LF_CLASS])
    assert parsed is not None

    hf_a = HFStream(num_presets)
    hf_a.add_lfg_packed(parsed["tok_words"], parsed["res_words"],
                        lut[:per], preset, (1, 1), (32, 32),
                        parsed["tok_off"], parsed["res_off"], parsed["gs"])
    hf_a.encode_group_sections()

    out_u = pipeline.encode_lfg(
        jnp.asarray(img), 256, 256, jnp.full((1,), preset, jnp.int32),
        jnp.asarray(cm), clusters_per_preset=per, **kwargs)
    hf_b = HFStream(num_presets)
    hf_b.add_group_padded(np.asarray(out_u["tokens"]).reshape(1024, 3, 64),
                          np.asarray(out_u["clusters"]).reshape(1024, 3, 64),
                          np.asarray(out_u["residues"]).reshape(1024, 3, 64),
                          np.asarray(out_u["residue_bits"]).reshape(1024, 3, 64),
                          np.asarray(out_u["valid_len"]).reshape(1024, 3),
                          preset)
    hf_b.encode_group_sections()

    a = [w.finalize() for w in hf_a.group_sections]
    b = [w.finalize() for w in hf_b.group_sections]
    assert a == b


@pytest.mark.parametrize("num_presets", [1, 28, 29, 86, 129])
def test_analytic_clusters_match_gather(num_presets):
    """tokenize_flat evaluates the context->cluster map analytically
    (no device gather); it must equal cluster_map[contexts] exactly for
    every hf_cluster_map variant (9/3/2/1 clusters per preset), every
    preset, both prev values, on random coefficient data."""
    cm = tables.hf_cluster_map(num_presets)
    num_clusters = int(cm.max()) + 1
    per = num_clusters // num_presets
    rng = np.random.default_rng(num_presets)
    N = 3 * 256
    q = rng.integers(-40, 40, (N, 64), dtype=np.int64).astype(np.int32)
    q[rng.random((N, 64)) < 0.7] = 0
    q[:, 0] = 0
    nz = (q != 0).sum(axis=1).astype(np.int32)
    presets = rng.integers(0, num_presets, N).astype(np.int32)
    bc = np.tile(np.arange(3, dtype=np.int32), N // 3)

    toks = pipeline.tokenize_flat(jnp.asarray(q), jnp.asarray(nz),
                                  jnp.asarray(presets), jnp.asarray(bc),
                                  per)
    clusters = np.asarray(toks[1])

    # reference: the straight gather (encoder.c:689-750 context ids)
    cnzc = np.asarray(tables.COEFF_NUM_NONZERO_CONTEXT)
    cfc = np.asarray(tables.COEFF_FREQ_CONTEXT[1:])
    nonzero = (q[:, 1:] != 0).astype(np.int32)
    cum = np.cumsum(nonzero, axis=-1)
    remaining = nz[:, None] - np.pad(cum[:, :-1], ((0, 0), (1, 0)))
    prev = np.concatenate([(nz <= 4).astype(np.int32)[:, None],
                           nonzero[:, :-1]], axis=-1)
    base = presets * tables.CONTEXTS_PER_PRESET
    p64 = np.minimum(nz, 64)     # count ctx uses predicted; cluster is
    nz_ctx = np.where(nz < 8, nz, 4 + (p64 >> 1))  # pred-independent
    count_ctx = base + 3 * nz_ctx + bc
    hist = base + tables.COEFF_CONTEXTS_PER_BLOCK_CTX * bc + 111
    coeff_ctx = (hist[:, None] + prev
                 + ((cnzc[np.clip(remaining, 0, 63)] + cfc[None, :]) << 1))
    ctx = np.concatenate([count_ctx[:, None], coeff_ctx], axis=-1)
    expect = cm[np.minimum(ctx, cm.size - 1)]
    assert (clusters == expect).all()


def test_packed_payload_wide_retry():
    """A residue stream denser than the fast 12 b/slot budget must set
    the retryable ok word (2) on the narrow executable and pack validly
    on the wide one; so must a single residue field wider than
    RES_CAP_FAST bits even when the aggregate chunk budget is fine."""
    from hydrium_tpu.jxl.tokcode import TokenCodec

    cm = tables.hf_cluster_map(1)
    lens, codes, _ = TokenCodec().tables()
    kw = dict(buf_h=256, buf_w=256, linear_light=False, num_clusters=9,
              sample_kind="float32", tok_classes=9)

    def call(img, **extra):
        return np.asarray(pipeline.encode_lfg_packed(
            jnp.asarray(img), 256, 256, jnp.zeros(1, jnp.int32),
            jnp.asarray(cm), jnp.asarray(lens), jnp.asarray(codes),
            **kw, **extra)["combined"])

    rng = np.random.default_rng(7)
    base = rng.random((256, 256, 3)).astype(np.float32) * 2 - 1
    mild = base * 100.0          # ~8 b/slot residues: fits the budget
    dense = base * 1e4           # ~14 b/slot: needs the wide executable

    assert call(mild)[0] == 1
    assert call(dense)[0] == 2
    assert call(dense, wide_residues=True)[0] == 1

    spike = mild.copy()
    spike[0:8, 0:8, :] = 0.0
    spike[0, 0, 0] = 2.0e5           # one huge DCT coeff -> ~18b residue
    assert call(spike)[0] == 2
    assert call(spike, wide_residues=True)[0] == 1
