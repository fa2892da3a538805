"""Multi-host encoding: jax.distributed glue + cross-host bitstream
gather + per-shard failure recovery.

SURVEY.md sections 2/5 map hydrium's structural decompositions onto a
cluster: LF groups scatter across hosts (the network for input pixels,
the device interconnect for collectives), per-preset histograms are the
only cross-shard reduction, and the variable-length per-group sections
gather to process 0, ordered by the TOC permutation.  Groups are
idempotent -- any shard's sections can be recomputed from its input
tiles, which is the whole failure-recovery story (`with_retry`)."""

from __future__ import annotations

import time
from typing import Callable, Optional, Sequence

import numpy as np


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Bring up jax.distributed (no-op when single-process)."""
    import jax

    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def with_retry(fn: Callable, attempts: int = 3, backoff: float = 0.5):
    """Idempotent-shard retry wrapper: group/LFG encoding has no side
    effects until its sections are appended, so transient device
    failures are recoverable by recomputation (the analog of the
    reference's defensive status-code discipline, SURVEY.md section 5)."""

    def wrapped(*args, **kwargs):
        last = None
        for i in range(attempts):
            try:
                return fn(*args, **kwargs)
            except Exception as e:  # noqa: BLE001 - deliberate broad retry
                last = e
                if i + 1 < attempts:
                    time.sleep(backoff * (2 ** i))
        raise last

    return wrapped


def gather_bytes_to_host0(payload: bytes) -> Optional[list]:
    """All-gather variable-length byte strings across processes; returns
    the list on process 0, None elsewhere.  Uses a fixed-width padded
    u8 array + length vector over the global mesh."""
    import jax

    if jax.process_count() == 1:
        return [payload]
    from jax.experimental import multihost_utils

    n = jax.process_count()
    lengths = multihost_utils.process_allgather(
        np.array([len(payload)], np.int64))
    cap = int(lengths.max())
    buf = np.zeros(cap, np.uint8)
    buf[:len(payload)] = np.frombuffer(payload, np.uint8)
    gathered = multihost_utils.process_allgather(buf)
    if jax.process_index() != 0:
        return None
    return [bytes(gathered[i][:int(lengths[i][0])].tobytes())
            for i in range(n)]


def _pack_sections(lf_secs, hf_secs, freqs: dict) -> bytes:
    """Length-prefixed binary framing for the cross-host section gather
    (no pickle: the one payload that crosses machine boundaries must not
    be a code-execution vector, even between trusted peers).

    Layout (little-endian):
      u32 magic 'HSEC', u32 n_lf, u32 n_hf, u32 n_freq
      n_lf  x  (i64 lfid, u32 tail_val, u32 tail_bits, u64 len, bytes)
      n_hf  x  (i64 lfid, i64 j, u32 tail_val, u32 tail_bits,
                u64 len, bytes)
      n_freq x (i64 cluster, u64 count, count x u32)"""
    import struct

    parts = [struct.pack("<4sIII", b"HSEC", len(lf_secs), len(hf_secs),
                         len(freqs))]
    for lfid, (data, tv, tb) in lf_secs:
        parts.append(struct.pack("<qIIQ", lfid, tv, tb, len(data)))
        parts.append(data)
    for (lfid, j), (data, tv, tb) in hf_secs:
        parts.append(struct.pack("<qqIIQ", lfid, j, tv, tb, len(data)))
        parts.append(data)
    for c, f in freqs.items():
        a = np.ascontiguousarray(f, np.uint32)
        parts.append(struct.pack("<qQ", c, a.size))
        parts.append(a.tobytes())
    return b"".join(parts)


def _unpack_sections(blob: bytes):
    """Inverse of _pack_sections -> (lf dict, hf dict, freqs dict);
    raises ValueError on malformed framing (lengths validated against
    the buffer before every slice)."""
    import struct

    mv = memoryview(blob)
    pos = 0

    def take(fmt):
        nonlocal pos
        size = struct.calcsize(fmt)
        if pos + size > len(mv):
            raise ValueError("truncated section payload")
        vals = struct.unpack_from(fmt, mv, pos)
        pos += size
        return vals

    def take_bytes(n):
        nonlocal pos
        if n > len(mv) - pos:
            raise ValueError("section length past payload end")
        b = bytes(mv[pos:pos + n])
        pos += n
        return b

    magic, n_lf, n_hf, n_freq = take("<4sIII")
    if magic != b"HSEC":
        raise ValueError("bad section payload magic")
    lf = {}
    for _ in range(n_lf):
        lfid, tv, tb, ln = take("<qIIQ")
        lf[lfid] = (take_bytes(ln), tv, tb)
    hf = {}
    for _ in range(n_hf):
        lfid, j, tv, tb, ln = take("<qqIIQ")
        hf[(lfid, j)] = (take_bytes(ln), tv, tb)
    freqs = {}
    for _ in range(n_freq):
        c, count = take("<qQ")
        freqs[c] = np.frombuffer(take_bytes(count * 4), np.uint32)
    if pos != len(mv):
        raise ValueError("trailing bytes in section payload")
    return lf, hf, freqs


def _assign_presets(num_presets: int, n_proc: int, pid: int) -> range:
    """Contiguous preset partition: every histogram preset (and hence
    every LF group of that preset) lives wholly on one process, so HF
    sections and cluster frequencies never need cross-host symbol
    exchange -- only the final byte gather (SURVEY.md section 5: presets
    align with shard boundaries)."""
    per = (num_presets + n_proc - 1) // n_proc
    return range(min(pid * per, num_presets),
                 min((pid + 1) * per, num_presets))


def encode_image_multihost(image: np.ndarray, *, linear_light: bool = False,
                           sample_fmt: str = "uint8",
                           spool_dir: Optional[str] = None,
                           attempts: int = 3) -> Optional[bytes]:
    """One-frame encode with LF groups sharded across jax processes.

    Every process passes the full-image array (or a memory-mapped view;
    only its own LF groups' pixels are read) and runs the packed
    single-device pipeline (encoder._JaxDispatch: per-shard prefix
    fetches, transport-Huffman tokens) on its preset-aligned slice of LF
    groups, serializing LF + HF sections locally with the fixed-las
    streaming scheme (jxl/frame.py StreamingHFStream).  Process 0
    gathers sections + cluster frequencies across processes
    (gather_bytes_to_host0) and assembles headers/TOC; other processes
    return None.  Each LF group step is wrapped in `with_retry` --
    groups are idempotent, so transient device failures recompute
    (transient failures surface during dispatch/transfer, before any
    symbols are fed to the local HF stream).

    Output is byte-identical to the single-process
    `Encoder(meta, backend="jax", streaming=True)` for the same image
    (same math, same fixed-las sections, raster arrival; verified by
    tests/test_multihost.py with a real 2-process jax.distributed run).
    The reference analog is the one-frame out-of-order section
    accumulation this generalizes (encoder.c:241-268, internal.h:56-67)."""
    import jax

    from ..config import ImageMetadata
    from ..encoder import _FrameAssembler, _JaxDispatch
    from ..jxl import headers, native
    from ..jxl.frame import (FrameGeometry, LFGroupGeometry,
                             StreamingHFStream, new_bitwriter,
                             write_frame_header, write_hf_global_fixed_las,
                             write_lf_global, write_lf_group)
    from ..jxl.entropy import cllog2
    from ..jxl.tokcode import TokenCodec

    assert native.available(), "multi-host encode needs the native plane"
    n_proc = jax.process_count()
    pid = jax.process_index()
    h, w = image.shape[:2]
    meta = ImageMetadata(width=w, height=h, linear_light=linear_light)
    lfgs = [
        LFGroupGeometry(x=x, y=y,
                        width=min(2048, w - x * 2048),
                        height=min(2048, h - y * 2048),
                        tile_count_x=8, tile_count_y=8)
        for y in range(meta.lfg_count_y) for x in range(meta.lfg_count_x)
    ]
    n = len(lfgs)
    geo = FrameGeometry(image_width=w, image_height=h, one_frame=True,
                        lfg_count_x=meta.lfg_count_x, lf_groups=lfgs,
                        lfg_arrival=list(range(n)))
    num_presets = geo.num_presets
    lpp = geo.lfg_per_preset
    my_presets = _assign_presets(num_presets, n_proc, pid)
    my_lfids = [i for p in my_presets
                for i in range(p * lpp, min((p + 1) * lpp, n))]

    counts = [0] * num_presets
    for i in range(n):
        counts[i // lpp] += 1
    hf = StreamingHFStream(num_presets, counts, spool_dir=spool_dir)
    codec = TokenCodec()

    lf_secs = []     # (lfid, (bytes, tail_val, tail_bits))

    def one_lfg(lfid: int):
        lfg = lfgs[lfid]
        preset = lfid // lpp
        pixels = image[lfg.y * 2048:lfg.y * 2048 + lfg.height,
                       lfg.x * 2048:lfg.x * 2048 + lfg.width]
        handle = _JaxDispatch(pixels, sample_fmt, linear_light, lfg,
                              preset, hf, codec=codec)
        return handle.drain(hf), preset

    step = with_retry(one_lfg, attempts=attempts)
    for lfid in my_lfids:
        (lf_q, lf_res), preset = step(lfid)
        bw = new_bitwriter()
        write_lf_group(bw, lf_q, lf_res)
        lf_secs.append((lfid, bw.export_raw()))
        hf.finish_lfg(preset)
    hf.encode_group_sections()   # asserts all local presets flushed

    hf_keys = [(lfid, j) for lfid in my_lfids
               for j in range(lfgs[lfid].group_count)]
    hf_secs = list(zip(hf_keys, hf.iter_sections()))
    assert len(hf_secs) == len(hf_keys)
    my_freqs = {c: hf._freqs[c] for p in my_presets
                for c in range((hf._num_clusters // num_presets) * p,
                               (hf._num_clusters // num_presets) * (p + 1))}
    hf.close()   # sections fully materialized above; drop the spool now

    payload = _pack_sections(lf_secs, hf_secs, my_freqs)
    gathered = gather_bytes_to_host0(payload)
    if gathered is None:
        return None

    # -- process 0: assemble ------------------------------------------------
    all_lf: dict = {}
    all_hf: dict = {}
    freqs = [None] * hf._num_clusters
    for blob in gathered:
        part_lf, part_hf, part_freqs = _unpack_sections(blob)
        all_lf.update(part_lf)
        all_hf.update(part_hf)
        for c, f in part_freqs.items():
            freqs[c] = f
    assert len(all_lf) == n, f"missing LF sections: {sorted(all_lf)}"

    main = new_bitwriter()
    headers.write_image_header(main, w, h, meta.level10)
    write_frame_header(main, geo, True)
    asm = _FrameAssembler(geo.toc_size > 1)
    write_lf_global(asm.working)
    asm.end_section()
    for lfid in range(n):
        data, tail_val, tail_bits = all_lf[lfid]
        asm.working.append_bytes(data)
        asm.working.write(tail_val, tail_bits)
        asm.end_section()
    write_hf_global_fixed_las(asm.working, hf.cluster_map,
                              hf._num_clusters, num_presets, freqs,
                              geo.num_frame_groups,
                              StreamingHFStream.FIXED_LAS)
    asm.end_section()
    for key in sorted(all_hf):
        data, tail_val, tail_bits = all_hf[key]
        asm.working.append_bytes(data)
        asm.working.write(tail_val, tail_bits)
        asm.end_section()
    asm.write_toc_sizes(main)
    return main.finalize() + asm.working.finalize()
