"""Transport prefix code for the device->host token stream.

The device pipeline ships HF hybrid-uint tokens (alphabet 0..63 under
config (4,1,0)) over the interconnect.  Shipping them as flat 6-bit
fields costs ~2x their entropy on real content, so the packed payload
(ops/pipeline.py encode_lfg_packed) Huffman-codes them with a *transport*
code that never appears in the .jxl bitstream.

The code is CONTEXT-SPLIT: each symbol's table is selected by its
within-preset cluster id (0..8 -- the same 9-way context clustering the
final ANS stream uses, encoder.c:855-901).  Both sides know the cluster
before the token is decoded (contexts depend only on previously decoded
symbols -- that is exactly how the C++ walker reconstructs clusters), so
per-cluster tables cost nothing in decodability and close most of the
gap between a single global Huffman table and the context-modeled ANS
size (~30% on noisy 4K content).

The host picks code lengths from the previous LF group's per-class token
histogram (shipped back in the aux payload), sends the 10x64 codeword
table to the device with the next dispatch, and the C++ walker decodes
with one 4096-entry LUT per class.  Decodability is unconditional --
every symbol always has a code in every class (add-one smoothing), so a
distribution mismatch only costs compression, never correctness.

Table row 9 (LF_CLASS) codes the LF-residual hybrid tokens: format v4
ships LF residuals hybrid-uint-coded under their own transport class
instead of fixed-width fields (~45% smaller on real content); the HF
walker never sees that row (its LUT slice stays [:tok_classes]).

Reuses the depth-limited Huffman + canonical bit-reversed code
construction already validated byte-exactly against the reference
(jxl/entropy.py, entropy.c:592-707)."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .entropy import build_prefix_table

ALPHABET = 64
NCLASS = 9            # within-preset clusters (tables.hf_cluster_map)
LF_CLASS = 9          # transport class for LF-residual hybrid tokens
NROWS = 10            # 9 HF classes + the LF class
# 12-bit cap (format v4; was 8): each decode LUT grows to 4096 entries,
# but depth-12 package-merge sits within ~0.07 b/sym of entropy on real
# token distributions where depth 8 left ~0.3 b/sym in the transfer
# (~0.6 MB per noisy 4K).
MAX_LEN = 12
LUT_BITS = 12


def package_merge_lengths(freqs, max_len: int):
    """Optimal length-limited prefix code lengths (package-merge).

    The reference's in-array depth-limited Huffman (entropy.c:592-662,
    kept bit-exact in jxl/entropy.py for the .jxl streams) over-
    constrains at small depth caps; the transport code never appears in
    the bitstream, so it is free to use the optimal algorithm."""
    A = len(freqs)
    assert all(f > 0 for f in freqs)
    singles = sorted((int(f), (i,)) for i, f in enumerate(freqs))
    packages: list = []
    for _level in range(max_len - 1):
        merged = sorted(singles + packages)
        packages = [
            (merged[k][0] + merged[k + 1][0],
             merged[k][1] + merged[k + 1][1])
            for k in range(0, len(merged) - 1, 2)
        ]
    # the optimal solution takes the 2A-2 cheapest items of the last
    # merged list; a symbol's code length = its occurrence count there
    lengths = [0] * A
    for _w, syms in sorted(singles + packages)[:2 * (A - 1)]:
        for s in syms:
            lengths[s] += 1
    return lengths


def _default_prior() -> np.ndarray:
    """Generic skewed-to-zero token prior for the first LF group (real
    content concentrates mass on small tokens; entropy.c hybridize).
    Row LF_CLASS seeds the LF-residual code; LF hybrid tokens spread
    wider than HF's, so its prior decays more slowly."""
    t = np.arange(ALPHABET, dtype=np.float64)
    f = np.maximum(1, (4000.0 * 0.72 ** t)).astype(np.int64)
    rows = np.tile(f, (NROWS, 1))
    rows[LF_CLASS] = np.maximum(1, (4000.0 * 0.85 ** t)).astype(np.int64)
    return rows


def build_tables(freqs: np.ndarray) -> Tuple[np.ndarray, np.ndarray,
                                             np.ndarray]:
    """freqs[NROWS, 64] -> (lengths i32[NROWS*64],
    codewords u32[NROWS*64] LSB-first, decode LUTs u16[NROWS, 4096]
    with entry = symbol | (length << 8)); index = class*64 + token.
    Rows 0..8 are the HF classes, row 9 (LF_CLASS) the LF residuals."""
    freqs = np.asarray(freqs, np.int64).reshape(NROWS, ALPHABET)
    lens = np.zeros(NROWS * ALPHABET, np.int32)
    codes = np.zeros(NROWS * ALPHABET, np.uint32)
    lut = np.zeros((NROWS, 1 << LUT_BITS), np.uint16)
    for k in range(NROWS):
        smoothed = freqs[k] + 1
        lengths = package_merge_lengths([int(v) for v in smoothed],
                                        MAX_LEN)
        table = build_prefix_table(lengths, ALPHABET)
        for sym, (cw, ln) in enumerate(table):
            assert 1 <= ln <= MAX_LEN, (k, sym, ln)
            lens[k * ALPHABET + sym] = ln
            codes[k * ALPHABET + sym] = cw
            idx = cw + (np.arange(1 << (LUT_BITS - ln),
                                  dtype=np.uint32) << ln)
            lut[k, idx] = sym | (ln << 8)
    return lens, codes, lut


class TokenCodec:
    """Adaptive transport code: updated from each LF group's device-side
    per-class token histogram, applied to the next dispatch.

    `cold` is True until the first real histogram arrives; a cold codec
    only has the generic prior, which costs ~1 b/sym on real content --
    cold dispatches therefore bootstrap with a cheap aux-only fetch
    (encoder._JaxDispatch.prefetch) before pulling the big payload.

    State optionally persists across processes (load/save): a stale code
    only costs compression until adaptation catches up, never
    correctness, so warm-starting fresh CLI/bench processes is free."""

    __slots__ = ("freqs", "_tables", "cold", "_lock")

    def __init__(self, cache_path=None) -> None:
        import threading

        # prefetch daemons and tiled-batch fetch threads both feed the
        # process-shared codec; an unguarded read-modify-write on freqs
        # silently dropped concurrent histogram updates (ADVICE r3)
        self._lock = threading.Lock()
        self.freqs = _default_prior()
        self._tables = None
        self.cold = True
        if cache_path:
            self.load(cache_path)

    def load(self, path) -> None:
        try:
            import os

            if os.path.exists(path):
                f = np.load(path)["freqs"]
                # reject warm state from older formats (e.g. 9-row v3)
                if f.shape == (NROWS, ALPHABET) and f.sum() > 0:
                    self.freqs = f.astype(np.int64)
                    self._tables = None
                    self.cold = False
        except Exception:
            pass

    def save(self, path) -> None:
        try:
            import os

            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                np.savez(f, freqs=self.freqs)
            os.replace(tmp, path)
        except Exception:
            pass

    def update(self, hist: np.ndarray) -> None:
        """Fold in one LF group's exact [NROWS, 64] transport-symbol
        histogram (aux payload; rows 0..8 HF classes, row 9 LF tokens).
        Exponential decay keeps the code tracking content changes.
        Thread-safe: concurrent callers serialize on the codec lock."""
        h = np.asarray(hist, np.int64).reshape(NROWS, ALPHABET)
        if h.sum() <= 0:
            return
        with self._lock:
            self.freqs = self.freqs // 2 + h
            self._tables = None
            self.cold = False

    def tables(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        # fast path without the lock: _tables is only ever swapped
        # atomically (None or a complete tuple), so a stale read costs
        # at most one adaptation step, never a torn table
        t = self._tables
        if t is None:
            with self._lock:
                freqs = self.freqs
            t = build_tables(freqs)
            self._tables = t
        return t
