"""Sharded one-frame encoding: LF groups data-parallel over a device
mesh, bitstream assembled host-side.

This is the scaling story mandated by SURVEY.md sections 2/5: 2048x2048
LF groups are the shard unit (no halo exchange is needed -- LF prediction
and nz prediction never cross LFG/group boundaries), histogram presets
align with shard boundaries (so there is no cross-shard reduction), and
the variable-length group sections are gathered on the host.

Output bytes are identical to the single-device Encoder for the same
image (same math path, same serialization)."""

from __future__ import annotations

from functools import partial
from typing import Optional

import numpy as np

from ..config import ImageMetadata
from ..jxl.frame import (FrameGeometry, LFGroupGeometry, StreamingHFStream,
                         TOC_TABLE, write_frame_header, write_lf_global,
                         write_lf_group)
from ..jxl import headers
from ..encoder import _SectionSpool, new_bitwriter
from ..ops import tables


def _lfg_unpacked_fallback(hf, lf_spool, image, g, preset, linear_light,
                           sample_fmt, cm_dev, num_clusters,
                           clusters_per_preset) -> None:
    """Re-run one LF group through the unpacked pipeline (packed
    transport overflow) and feed padded arrays to the HF stream."""
    import jax.numpy as jnp
    from ..ops import pipeline

    px = np.zeros((2048, 2048, 3), image.dtype)
    px[:g.height, :g.width] = image[
        g.y * 2048:g.y * 2048 + g.height, g.x * 2048:g.x * 2048 + g.width]
    out = pipeline.encode_lfg(
        jnp.asarray(px), g.height, g.width,
        jnp.full((64,), preset, jnp.int32), cm_dev, buf_h=2048, buf_w=2048,
        linear_light=linear_light, num_clusters=num_clusters,
        sample_kind=sample_fmt, clusters_per_preset=clusters_per_preset)
    vh, vw = g.varblock_height, g.varblock_width
    bw = new_bitwriter()
    write_lf_group(bw, np.asarray(out["lf_q"])[:vh, :vw],
                   np.asarray(out["lf_res"])[:vh, :vw])
    lf_spool.add_raw(bw.export_raw())
    tokens = np.asarray(out["tokens"]).reshape(64, 1024, 3, 64)
    clusters = np.asarray(out["clusters"]).reshape(tokens.shape)
    residues = np.asarray(out["residues"]).reshape(tokens.shape)
    residue_bits = np.asarray(out["residue_bits"]).reshape(tokens.shape)
    valid_len = np.asarray(out["valid_len"]).reshape(64, 1024, 3)
    for gy in range(g.group_count_y):
        for gx in range(g.group_count_x):
            gi = gy * 8 + gx
            hf.add_group_padded(tokens[gi], clusters[gi], residues[gi],
                                residue_bits[gi], valid_len[gi], preset)


def encode_image_sharded(image: np.ndarray, mesh=None,
                         linear_light: bool = False,
                         sample_fmt: str = "uint8",
                         stats=None) -> bytes:
    """Encode [H, W, 3] as a one-frame .jxl with LFGs sharded over a mesh.

    Processes ceil(n_lfgs / mesh_size) batches; each batch runs the
    packed device pipeline under shard_map (one LFG per device); the
    host walks every shard's payload and writes the shared ANS header
    from its own recount (presets align with shards)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from . import shard
    from ..ops import pipeline

    h, w = image.shape[:2]
    if h <= 256 and w <= 256:
        # single-group frame: 1-entry TOC, nothing to shard -- use the
        # regular encoder (same bytes; it picks the at-finalize assembler)
        from ..config import SampleFormat
        from ..encoder import encode_image

        return encode_image(image, tile_size_shift=-1, backend="jax",
                            linear_light=linear_light,
                            sample_fmt=SampleFormat(sample_fmt))
    meta = ImageMetadata(width=w, height=h, linear_light=linear_light)
    if mesh is None:
        mesh = shard.make_mesh()
    n_dev = mesh.devices.size

    lfgs = [
        LFGroupGeometry(x=x, y=y,
                        width=min(2048, w - x * 2048),
                        height=min(2048, h - y * 2048),
                        tile_count_x=8, tile_count_y=8)
        for y in range(meta.lfg_count_y) for x in range(meta.lfg_count_x)
    ]
    geo = FrameGeometry(image_width=w, image_height=h, one_frame=True,
                        lfg_count_x=meta.lfg_count_x, lf_groups=lfgs,
                        lfg_arrival=list(range(len(lfgs))))

    # streaming-format assembly (fixed-las per-preset sections), byte-
    # identical to the jax-backend Encoder's one-frame output
    counts = [0] * geo.num_presets
    for _id in range(geo.lfg_per_frame):
        counts[_id // geo.lfg_per_preset] += 1
    hf = StreamingHFStream(geo.num_presets, counts)
    num_clusters = int(hf.cluster_map.max()) + 1
    cm_dev = jnp.asarray(hf.cluster_map)

    from ..jxl.tokcode import LF_CLASS, TokenCodec

    codec = TokenCodec()
    lens, codes, full_lut = codec.tables()
    tok_lut = full_lut[:num_clusters // geo.num_presets]  # match device classes
    lf_lut = full_lut[LF_CLASS]       # LF residual stream decode row
    lens_dev, codes_dev = jnp.asarray(lens), jnp.asarray(codes)

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P("groups"), P("groups"), P("groups"), P("groups")),
             out_specs=P("groups"))
    def step(pixels, heights, widths, presets):
        def one(px, hh, ww, pr):
            return pipeline.encode_lfg_packed(
                px, hh, ww, jnp.full((64,), pr, jnp.int32), cm_dev,
                lens_dev, codes_dev,
                buf_h=2048, buf_w=2048, linear_light=linear_light,
                num_clusters=num_clusters, sample_kind=sample_fmt,
                tok_classes=num_clusters // geo.num_presets)
        return jax.vmap(one)(pixels, heights, widths, presets)

    step = jax.jit(step)

    lf_spool = _SectionSpool(None)
    bw = new_bitwriter()
    write_lf_global(bw)
    lf_spool.add_raw(bw.export_raw())

    dtype = image.dtype
    n = len(lfgs)
    for batch0 in range(0, n, n_dev):
        ids = list(range(batch0, min(batch0 + n_dev, n)))
        pad = n_dev - len(ids)
        px = np.zeros((n_dev, 2048, 2048, 3), dtype)
        hh = np.zeros(n_dev, np.int32)
        ww = np.zeros(n_dev, np.int32)
        pr = np.zeros(n_dev, np.int32)
        for j, lfid in enumerate(ids):
            g = lfgs[lfid]
            px[j, :g.height, :g.width] = image[
                g.y * 2048:g.y * 2048 + g.height,
                g.x * 2048:g.x * 2048 + g.width]
            hh[j], ww[j] = g.height, g.width
            pr[j] = lfid // geo.lfg_per_preset
        hh[len(ids):] = 256  # harmless dummy extent for padding shards
        ww[len(ids):] = 256
        out = step(jnp.asarray(px), jnp.asarray(hh), jnp.asarray(ww),
                   jnp.asarray(pr))

        from ..encoder import _parse_packed, fetch_packed_payload

        # per-shard prefix fetch: each device's combined payload is
        # pulled with the same hint-sized-prefix + ranged-top-up
        # protocol as the single-device path, instead of materializing
        # the whole (worst-case-sized) combined buffer for every shard
        # -- that full fetch is ~45+ MB per 2048^2 LFG
        shard_rows = {}
        for s in out["combined"].addressable_shards:
            j0 = s.index[0].start or 0
            rows = s.data.shape[0]
            for r in range(rows):
                shard_rows[j0 + r] = s.data[r]

        hint = 0
        for j, lfid in enumerate(ids):
            g = lfgs[lfid]
            preset = lfid // geo.lfg_per_preset
            from ..encoder import packed_need_words, packed_verify

            aux, words = fetch_packed_payload(shard_rows[j], 2048, 2048,
                                              stats=stats, hint_words=hint)
            if words is not None:
                hint = packed_need_words(aux, 2048, 2048)
            if words is not None and not packed_verify(aux, words, 2048,
                                                       2048):
                # one refetch on a corrupt transfer, then surrender
                aux, words = fetch_packed_payload(shard_rows[j], 2048,
                                                  2048, stats=stats)
                if words is not None and not packed_verify(aux, words,
                                                           2048, 2048):
                    words = None
            parsed = (None if words is None
                      else _parse_packed(aux, words, 2048, 2048, g, lf_lut))
            if parsed is None:
                # transport overflow (token beyond the 64-symbol
                # alphabet, or aux[0]==2: a residue chunk past the fast
                # packing budget -- this demo driver recomputes unpacked
                # rather than re-running the whole sharded step wide):
                # recompute this LF group unpacked on the
                # default device, same as the Encoder's fallback
                _lfg_unpacked_fallback(hf, lf_spool, image, g, preset,
                                       linear_light, sample_fmt, cm_dev,
                                       num_clusters,
                                       num_clusters // geo.num_presets)
                hf.finish_lfg(preset)
                continue
            bw = new_bitwriter()
            write_lf_group(bw, None, parsed["lf_res"])
            lf_spool.add_raw(bw.export_raw())
            hf.add_lfg_packed(parsed["tok_words"], parsed["res_words"],
                              tok_lut, preset, (8, 8),
                              (g.varblock_height, g.varblock_width),
                              parsed["tok_off"], parsed["res_off"],
                              parsed["gs"])
            hf.finish_lfg(preset)

    hf.encode_group_sections()   # asserts every preset flushed
    hfg = new_bitwriter()
    hf.write_hf_global(hfg, geo.num_frame_groups)
    hfg_raw = hfg.export_raw()
    hf_items = list(hf.iter_section_meta())
    sizes = [lf_spool.padded_size(i) for i in range(len(lf_spool.items))]
    sizes.append(len(hfg_raw[0]) + (1 if hfg_raw[2] else 0))
    sizes.extend(n_ + (1 if tb else 0) for _, tb, n_ in hf_items)

    main = new_bitwriter()
    headers.write_image_header(main, w, h, meta.level10)
    write_frame_header(main, geo, True)
    main.zero_pad()
    for s in sizes:
        main.write_u32(TOC_TABLE, s)
    main.zero_pad()

    out_parts = [main.finalize()]
    for i in range(len(lf_spool.items)):
        out_parts.extend(lf_spool.emit(i))
    out_parts.append(hfg_raw[0])
    if hfg_raw[2]:
        out_parts.append(bytes([hfg_raw[1] & 0xFF]))
    for data, tail_val, tail_bits in hf.iter_sections():
        out_parts.append(data)
        if tail_bits:
            out_parts.append(bytes([tail_val & 0xFF]))
    return b"".join(out_parts)
