"""ctypes bindings for the native serialization plane (cpp/serializer.cc).

Auto-builds build/libhydtpu.so with g++ on first use (no pip installs in
this environment; pybind11 unavailable, hence plain C ABI + ctypes).
Every class here duck-types its pure-Python twin in bitwriter.py /
entropy.py so the header/frame code runs unchanged on either plane;
differential tests assert byte equality between the two.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import List, Optional, Sequence

import numpy as np

from .bitwriter import U32Table, ENUM_TABLE

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SO_PATH = os.path.join(_REPO_ROOT, "build", "libhydtpu.so")
_SRC_PATH = os.path.join(_REPO_ROOT, "cpp", "serializer.cc")

_lib = None
_load_error: Optional[str] = None


def _build() -> None:
    os.makedirs(os.path.dirname(_SO_PATH), exist_ok=True)
    subprocess.run(
        ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-pthread",
         _SRC_PATH, "-o", _SO_PATH + ".tmp"],
        check=True, capture_output=True)
    os.replace(_SO_PATH + ".tmp", _SO_PATH)


def _load():
    global _lib, _load_error
    if _lib is not None or _load_error is not None:
        return _lib
    try:
        if (not os.path.exists(_SO_PATH)
                or os.path.getmtime(_SO_PATH) < os.path.getmtime(_SRC_PATH)):
            _build()
        lib = ctypes.CDLL(_SO_PATH)
        P = ctypes.c_void_p
        lib.hyd_writer_new.restype = P
        lib.hyd_writer_free.argtypes = [P]
        lib.hyd_writer_bit_size.restype = ctypes.c_long
        lib.hyd_writer_bit_size.argtypes = [P]
        lib.hyd_writer_write.argtypes = [P, ctypes.c_uint64, ctypes.c_int]
        lib.hyd_writer_zero_pad.argtypes = [P]
        lib.hyd_writer_copy.restype = ctypes.c_long
        lib.hyd_writer_copy.argtypes = [
            P, P, ctypes.c_long, ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_int)]
        lib.hyd_writer_append.argtypes = [P, P]
        lib.hyd_writer_append_bytes.argtypes = [P, ctypes.c_char_p,
                                                ctypes.c_long]
        lib.hyd_stream_new.restype = P
        lib.hyd_stream_new.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_uint32, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.hyd_stream_free.argtypes = [P]
        lib.hyd_stream_send.argtypes = [P, ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.c_long]
        lib.hyd_stream_send_mono.argtypes = [P, ctypes.c_uint32,
                                             ctypes.c_void_p, ctypes.c_long]
        lib.hyd_stream_prefix_finalize.restype = ctypes.c_int
        lib.hyd_stream_prefix_finalize.argtypes = [P, P]
        lib.hyd_hf_new.restype = P
        lib.hyd_hf_new.argtypes = [ctypes.c_long]
        lib.hyd_hf_free.argtypes = [P]
        lib.hyd_hf_add_group.argtypes = [P] + [ctypes.c_void_p] * 5 + [
            ctypes.c_long, ctypes.c_uint32]
        lib.hyd_hf_add_lfg_packed.restype = ctypes.c_int
        lib.hyd_hf_add_lfg_packed.argtypes = [
            P, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_uint32, ctypes.c_long,
            ctypes.c_long, ctypes.c_long, ctypes.c_long, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
        lib.hyd_hf_prepare.restype = ctypes.c_int
        lib.hyd_hf_prepare.argtypes = [P]
        lib.hyd_hf_encode_all.restype = ctypes.c_int
        lib.hyd_hf_encode_all.argtypes = [P, ctypes.c_int,
                                          ctypes.POINTER(ctypes.c_void_p),
                                          ctypes.c_int]
        lib.hyd_hf_write_header.restype = ctypes.c_int
        lib.hyd_hf_write_header.argtypes = [P, ctypes.c_char_p,
                                            ctypes.c_long, P]
        lib.hyd_hf_num_groups.restype = ctypes.c_long
        lib.hyd_hf_num_groups.argtypes = [P]
        lib.hyd_hf_force_las.argtypes = [P, ctypes.c_int]
        lib.hyd_hf_las.restype = ctypes.c_int
        lib.hyd_hf_las.argtypes = [P]
        lib.hyd_hf_frequencies.restype = ctypes.c_long
        lib.hyd_hf_frequencies.argtypes = [P, ctypes.c_long, ctypes.c_void_p,
                                           ctypes.c_long]
        lib.hyd_lf_decode.restype = ctypes.c_long
        lib.hyd_lf_decode.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_long, ctypes.c_long,
                                      ctypes.c_void_p]
        lib.hyd_png_unfilter.restype = ctypes.c_int
        lib.hyd_png_unfilter.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                         ctypes.c_long, ctypes.c_int,
                                         ctypes.c_int]
        lib.hyd_px_pack.restype = ctypes.c_long
        lib.hyd_px_pack.argtypes = [ctypes.c_void_p, ctypes.c_long,
                                    ctypes.c_long, ctypes.c_int,
                                    ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_void_p, ctypes.c_long,
                                    ctypes.c_int]
        _lib = lib
    except Exception as e:  # pragma: no cover
        _load_error = str(e)
    return _lib


def available() -> bool:
    return _load() is not None


def lf_decode(words: np.ndarray, lf_lut: np.ndarray, lf_n: int,
              total_bits: int) -> Optional[np.ndarray]:
    """Decode the format-v4 LF residual stream (bit-contiguous hybrid-
    uint fields under the class-9 transport code) into lf_n pack_signed
    residuals.  words must extend at least one word past the stream
    (fetches carry +1 slack).  lf_lut: u16[4096] decode LUT
    (jxl/tokcode.py row LF_CLASS).  None when the decoded stream does
    not land exactly on total_bits (corrupt payload)."""
    lib = _load()
    w = np.ascontiguousarray(words, np.uint32)
    lut = np.ascontiguousarray(lf_lut, np.uint16)
    assert lut.size == 4096
    out = np.empty(lf_n, np.uint32)
    end = lib.hyd_lf_decode(w.ctypes.data, lut.ctypes.data, lf_n,
                            total_bits, out.ctypes.data)
    if end != total_bits:
        return None
    return out


def _px_pack_raw(px: np.ndarray, words_cap: int,
                 n_threads: int) -> Optional[tuple]:
    """One hyd_px_pack call on a contiguous [h, w, 3] u8/u16 buffer with
    an explicit word cap; (hdr, base, words) or None past the cap."""
    lib = _load()
    if lib is None:
        return None
    if px.ndim != 3 or px.shape[2] != 3:
        # the kernel reads exactly 3 interleaved channels; anything else
        # would read out of bounds
        return None
    h, w, _c = px.shape
    if w % 32 or px.dtype not in (np.uint8, np.uint16):
        return None
    px = np.ascontiguousarray(px)
    nb = 3 * h * (w >> 5)
    if words_cap <= 0:
        return None
    hdr = np.empty(nb, np.uint8)
    base = np.empty(nb, np.uint16)
    words = np.empty(words_cap, np.uint32)
    n = lib.hyd_px_pack(px.ctypes.data, h, w,
                        1 if px.dtype == np.uint16 else 0,
                        hdr.ctypes.data, base.ctypes.data,
                        words.ctypes.data, words_cap, n_threads)
    if n < 0:
        return None
    return hdr, base, words[:n]


def px_pack(px: np.ndarray, cap_ratio: float = 0.85,
            n_threads: int = 3) -> Optional[tuple]:
    """PXPACK v1 (cpp/serializer.cc hyd_px_pack): bitpack an interleaved
    [h, w, 3] u8/u16 pixel buffer (w % 32 == 0) into per-block bit
    planes for a cheap host->device transfer; the device unpacks with
    ops/pipeline._unpack_px_planes.  Returns (hdr u8[nb], base u16[nb],
    words u32[nwords]) or None when the packed form would not be
    meaningfully smaller than raw (cap_ratio of the raw byte size --
    e.g. saturated-noise content) or the native library is unavailable."""
    if px.dtype not in (np.uint8, np.uint16):
        return None
    nb = 3 * px.shape[0] * (px.shape[1] >> 5)
    # budget: headers (hdr + base = 3 bytes/block = 0.75 bits/px) count
    # against the raw size too, so cap the words at ratio*raw - headers
    return _px_pack_raw(px, int((px.nbytes * cap_ratio - nb * 3) // 4),
                        n_threads)


def wire_raw_estimate(px: np.ndarray, stride: int = 64) -> int:
    """Run-coverage estimate of the cost of a RAW upload of `px`, used
    by px_pack2 to tighten its packing budget.

    Model: coverage = fraction of sampled bytes inside identical-byte
    runs of >= 8 (a distance-1 byte-RLE view of the buffer; adjacent
    bytes of smooth interleaved RGB cycle r,g,b and never repeat, so
    only flat or zero regions count); est_ratio = clamp(1 - 0.55 *
    coverage, 0.5, 1).  Pure numpy on a strided row sample.
    HYDRIUM_PXPACK_WIRE_EST=0 turns the estimate off."""
    sample = np.ascontiguousarray(px[::stride])
    if sample.nbytes == 0:
        return px.nbytes
    b = sample.reshape(-1).view(np.uint8)
    m = np.concatenate([[False], b[1:] == b[:-1], [False]])
    d = np.diff(m.astype(np.int8))
    starts = np.flatnonzero(d == 1)
    ends = np.flatnonzero(d == -1)
    lens = ends - starts
    cov = float(lens[lens >= 8].sum()) / b.size
    ratio = min(1.0, max(0.5, 1.0 - 0.55 * cov))
    return int(px.nbytes * ratio)


def _px2_meta_w(nb: int) -> int:
    """Level-2 meta image row width: the largest power of two <= 1024
    dividing nb.  nb = 3*h*(w/32) of a 32-row-aligned buffer (the
    encoder's ubuf is 32-aligned both ways) is a multiple of 32; odd
    test shapes can land below hyd_px_pack's 32-column minimum, which
    px_pack2 turns into a px1 fallback."""
    w = 1024
    while nb % w:
        w >>= 1
    return w


def px_pack2(px: np.ndarray, cap_ratio: float = 0.97,
             n_threads: int = 3) -> Optional[tuple]:
    """PXPACK v2: two-level packed pixel upload.  Level 1 bitpacks the
    pixels (hyd_px_pack); level 2 re-packs level 1's (hdr, base) arrays
    -- 3 bytes per 32-pixel block, which DOMINATE the upload on smooth
    content -- through the same kernel, viewed as a [nb/W, W, 3] meta
    image (W = _px2_meta_w(nb), usually 1024) with channels
    (width, base_lo, base_hi<<1|delta_mode).
    The mode bit rides base_hi's low bit (not hdr bit 7) so mixed-mode
    regions stay compressible.  The device reverses both levels in
    ops/pipeline.encode_lfg_packed_px2 -- the two sides share this
    layout; change both together.

    Returns, in preference order:
      ("px2", words, hdr2, base2, words2, meta_h, meta_w)  both packed
      ("px1", words, hdr, base)                    meta would not shrink
      None                                         upload raw instead

    cap_ratio bounds the TOTAL packed bytes (planes + packed meta)
    against raw: on a transfer-bound path any byte saved is won, so the
    default only rejects content where packing is truly pointless."""
    if px.dtype not in (np.uint8, np.uint16):
        return None
    raw_bytes = px.nbytes
    # the budget packing must beat: the face-value cap AND (unless
    # disabled) the run-coverage estimate of the raw upload's cost
    budget = raw_bytes * cap_ratio
    # cap_ratio > 1 means "force packing" (tests/smoke); the estimate
    # only tightens the normal policy
    if (cap_ratio <= 1.0
            and os.environ.get("HYDRIUM_PXPACK_WIRE_EST", "1") != "0"):
        budget = min(budget, wire_raw_estimate(px))
    l1 = _px_pack_raw(px, int(budget) // 4, n_threads)
    if l1 is None:
        return None
    hdr, base, words = l1
    nb = hdr.size
    meta_w = _px2_meta_w(nb)
    if meta_w < 32:
        if words.nbytes + nb * 3 <= budget:
            return ("px1", words, hdr, base)
        return None
    meta_h = nb // meta_w
    dt = px.dtype
    meta = np.empty((meta_h, meta_w, 3), dt)
    meta[..., 0] = (hdr & 31).reshape(meta_h, meta_w)
    meta[..., 1] = (base & 255).astype(dt).reshape(meta_h, meta_w)
    meta[..., 2] = (((base >> 8) << 1).astype(dt)
                    | (hdr >> 7)).reshape(meta_h, meta_w)
    # level 2 must at least beat raw meta (3 B/block) to be worth the
    # extra unpack stage; otherwise ship level 1 as-is
    l2 = _px_pack_raw(meta, nb * 3 // 4, n_threads)
    if l2 is not None:
        hdr2, base2, words2 = l2
        meta_bytes = hdr2.nbytes + base2.nbytes + words2.nbytes
        if meta_bytes < nb * 3 \
                and words.nbytes + meta_bytes <= budget:
            return ("px2", words, hdr2, base2, words2, meta_h, meta_w)
    if words.nbytes + nb * 3 <= budget:
        return ("px1", words, hdr, base)
    return None


class NativeBitWriter:
    """Drop-in replacement for jxl.bitwriter.BitWriter backed by C++."""

    __slots__ = ("_h", "_lib")

    def __init__(self) -> None:
        self._lib = _load()
        self._h = self._lib.hyd_writer_new()

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.hyd_writer_free(self._h)
            self._h = None

    def write(self, value: int, bits: int) -> None:
        if bits <= 0:
            return
        while bits > 56:
            self._lib.hyd_writer_write(self._h, value & (1 << 56) - 1, 56)
            value >>= 56
            bits -= 56
        self._lib.hyd_writer_write(self._h, value, bits)

    def write_bool(self, flag: bool) -> None:
        self._lib.hyd_writer_write(self._h, 1 if flag else 0, 1)

    def write_u32(self, table: U32Table, value: int) -> None:
        for i in range(4):
            vmc = value - table.cpos[i]
            if 0 <= vmc <= (1 << table.upos[i]) - 1:
                self.write((vmc << 2) | i, table.upos[i] + 2)
                return
        raise ValueError(f"value {value} not encodable")

    def write_enum(self, value: int) -> None:
        self.write_u32(ENUM_TABLE, value)

    def write_u64(self, value: int) -> None:
        if value == 0:
            self.write(0, 2)
            return
        if value < 17:
            self.write(((value - 1) << 2) | 1, 6)
            return
        if value < 273:
            self.write(((value - 17) << 2) | 2, 10)
            return
        self.write(((value & 0xFFF) << 2) | 3, 14)
        shift = 12
        while True:
            svalue = value >> shift
            if svalue == 0:
                self.write(0, 1)
                return
            if shift == 60:
                self.write(((svalue & 0xF) << 1) | 1, 5)
                return
            self.write(((svalue & 0xFF) << 1) | 1, 9)
            shift += 8

    def write_icc_varint(self, value: int) -> None:
        while value > 0x7F:
            self.write((value & 0x7F) | 0x80, 8)
            value >>= 7
        self.write(value & 0x7F, 8)

    def zero_pad(self) -> None:
        self._lib.hyd_writer_zero_pad(self._h)

    @property
    def bit_position(self) -> int:
        return self._lib.hyd_writer_bit_size(self._h)

    def __len__(self) -> int:
        return self.bit_position // 8

    def append_bytes(self, data: bytes) -> None:
        self._lib.hyd_writer_append_bytes(self._h, data, len(data))

    def append_writer(self, other: "NativeBitWriter") -> None:
        self._lib.hyd_writer_append(self._h, other._h)

    def finalize(self) -> bytes:
        self.zero_pad()
        n = len(self)
        buf = ctypes.create_string_buffer(n)
        tail_val = ctypes.c_uint32(0)
        tail_bits = ctypes.c_int(0)
        got = self._lib.hyd_writer_copy(self._h, buf, n,
                                        ctypes.byref(tail_val),
                                        ctypes.byref(tail_bits))
        assert got == n and tail_bits.value == 0
        return buf.raw

    def export_raw(self):
        """(whole_bytes, tail_value, tail_bits) without padding -- for
        spooling unaligned sections to disk."""
        n = len(self)
        buf = ctypes.create_string_buffer(max(n, 1))
        tail_val = ctypes.c_uint32(0)
        tail_bits = ctypes.c_int(0)
        got = self._lib.hyd_writer_copy(self._h, buf, n,
                                        ctypes.byref(tail_val),
                                        ctypes.byref(tail_bits))
        assert got == n
        return buf.raw[:n], tail_val.value, tail_bits.value


class NativeStream:
    """Send-based entropy stream (prefix path) backed by C++."""

    __slots__ = ("_h", "_lib")

    def __init__(self, cluster_map: Sequence[int], num_dists: int,
                 custom_config=None, lz77_min_symbol: int = 0,
                 modular: bool = False) -> None:
        self._lib = _load()
        cm = bytes(cluster_map[:num_dists])
        cfg = custom_config or (0, 0, 0)
        self._h = self._lib.hyd_stream_new(
            cm, num_dists, lz77_min_symbol, 1 if modular else 0,
            1 if custom_config else 0, cfg[0], cfg[1], cfg[2])

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.hyd_stream_free(self._h)
            self._h = None

    def send_mono(self, dist: int, symbols: np.ndarray) -> None:
        symbols = np.ascontiguousarray(symbols, dtype=np.uint32)
        self._lib.hyd_stream_send_mono(self._h, dist, symbols.ctypes.data,
                                       len(symbols))

    def send(self, dists: np.ndarray, symbols: np.ndarray) -> None:
        dists = np.ascontiguousarray(dists, dtype=np.uint32)
        symbols = np.ascontiguousarray(symbols, dtype=np.uint32)
        self._lib.hyd_stream_send(self._h, dists.ctypes.data,
                                  symbols.ctypes.data, len(symbols))

    def prefix_finalize(self, bw: NativeBitWriter) -> None:
        ret = self._lib.hyd_stream_prefix_finalize(self._h, bw._h)
        if ret != 0:
            raise RuntimeError("native prefix finalize failed")


class NativeHF:
    """HF ANS batch encoder backed by C++ (threaded across groups)."""

    __slots__ = ("_h", "_lib", "_keepalive")

    def __init__(self, num_clusters: int) -> None:
        self._lib = _load()
        self._h = self._lib.hyd_hf_new(num_clusters)
        self._keepalive: List[np.ndarray] = []

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.hyd_hf_free(self._h)
            self._h = None

    def add_group(self, tokens: np.ndarray, clusters: np.ndarray,
                  residues: np.ndarray, residue_bits: np.ndarray,
                  valid_len: np.ndarray, preset: int) -> None:
        """Arrays shaped [n_blocks, 3, 64] (+ valid_len [n_blocks, 3])."""
        t = np.ascontiguousarray(tokens, np.uint16)
        c = np.ascontiguousarray(clusters, np.uint8)
        r = np.ascontiguousarray(residues, np.uint32)
        b = np.ascontiguousarray(residue_bits, np.uint8)
        v = np.ascontiguousarray(valid_len, np.int32)
        n_blocks = t.size // (3 * 64)
        self._lib.hyd_hf_add_group(self._h, t.ctypes.data, c.ctypes.data,
                                   r.ctypes.data, b.ctypes.data,
                                   v.ctypes.data, n_blocks, preset)

    def add_lfg_packed(self, tok_words: np.ndarray, res_words: np.ndarray,
                       tok_lut: np.ndarray, cluster_map: np.ndarray,
                       preset: int, grid, extent,
                       tok_bit_offs: np.ndarray, res_bit_offs: np.ndarray,
                       sym_counts: np.ndarray, n_threads: int = 0) -> None:
        """Walk every group of one LF group in parallel (payload format
        v3/v4; threads write disjoint symbol ranges sized by the device's
        per-group counts).  grid = (gcy, gcx) buffer group grid; extent
        = (vh, vw) true varblock extent.  tok_lut: u16[n_classes, 4096]
        per-cluster transport-Huffman decode LUTs (jxl/tokcode.py);
        class = cluster % n_classes."""
        t = np.ascontiguousarray(tok_words, np.uint32)
        r = np.ascontiguousarray(res_words, np.uint32)
        lut = np.ascontiguousarray(tok_lut, np.uint16)
        tok_classes = lut.size // 4096
        cm = np.ascontiguousarray(cluster_map, np.uint8)
        to = np.ascontiguousarray(tok_bit_offs, np.int64)
        ro = np.ascontiguousarray(res_bit_offs, np.int64)
        sc = np.ascontiguousarray(sym_counts, np.int64)
        gcy, gcx = grid
        vh, vw = extent
        assert len(sc) == gcy * gcx
        if n_threads <= 0:
            n_threads = min(os.cpu_count() or 1, 8)
        ret = self._lib.hyd_hf_add_lfg_packed(
            self._h, t.ctypes.data, r.ctypes.data, lut.ctypes.data,
            tok_classes, cm.ctypes.data, preset, gcy, gcx, vh, vw,
            to.ctypes.data, ro.ctypes.data, sc.ctypes.data, n_threads)
        if ret != 0:
            # the C++ side rolls its symbol array back on failure, so
            # this HydHF remains usable and the caller may retry
            raise RuntimeError(
                "packed walk failed (symbol-count mismatch / corrupt stream)")

    def prepare(self) -> None:
        if self._lib.hyd_hf_prepare(self._h) != 0:
            raise RuntimeError("native hf prepare failed")

    def encode_all(self, preset_bits: int,
                   n_threads: int = 0) -> List[NativeBitWriter]:
        n = self._lib.hyd_hf_num_groups(self._h)
        writers = [NativeBitWriter() for _ in range(n)]
        arr = (ctypes.c_void_p * n)(*[w._h for w in writers])
        if n_threads <= 0:
            n_threads = min(os.cpu_count() or 1, 16)
        if self._lib.hyd_hf_encode_all(self._h, preset_bits, arr,
                                       n_threads) != 0:
            raise RuntimeError("native hf encode failed")
        return writers

    def write_header(self, cluster_map: np.ndarray,
                     bw: NativeBitWriter) -> None:
        cm = np.ascontiguousarray(cluster_map, np.uint8).tobytes()
        if self._lib.hyd_hf_write_header(self._h, cm, len(cm), bw._h) != 0:
            raise RuntimeError("native hf header failed")

    def force_las(self, las: int) -> None:
        self._lib.hyd_hf_force_las(self._h, las)

    @property
    def las(self) -> int:
        return self._lib.hyd_hf_las(self._h)

    def frequencies(self, cluster: int, cap: int = 512) -> np.ndarray:
        out = np.zeros(cap, np.uint32)
        n = self._lib.hyd_hf_frequencies(self._h, cluster, out.ctypes.data,
                                         cap)
        if n < 0:
            raise RuntimeError("frequencies buffer too small")
        return out[:n]
