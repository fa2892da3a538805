"""Command-line interface: PNG/PFM in, .jxl out.

Flag-compatible with the reference CLI (src/hydrium.c:27-43):
  --one-frame, --tile-size=N, --pfm, --png, --linear, --tag-icc-from=F
plus extensions: --backend {jax,numpy}, --verify (decode the output
with libjxl and report PSNR), --stats.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


class _ArrayRows:
    """Row-reader facade over an in-memory array (PFM / PIL fallback)."""

    def __init__(self, arr: np.ndarray, fmt: str) -> None:
        self.arr = arr
        self.fmt = fmt
        self.height, self.width = arr.shape[:2]
        self._r = 0

    def read_rows(self, n: int) -> np.ndarray:
        out = self.arr[self._r:self._r + n]
        self._r += len(out)
        return out


def _pil_reader(fobj) -> _ArrayRows:
    from PIL import Image

    im = Image.open(fobj)
    if im.mode in ("I;16", "I;16B", "I"):
        arr = np.asarray(im, dtype=np.uint16)
        fmt = "uint16"
    else:
        im = im.convert("RGB")
        arr = np.asarray(im, dtype=np.uint8)
        fmt = "uint8"
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    if arr.shape[-1] == 4:
        arr = arr[..., :3]
    return _ArrayRows(arr, fmt)


def _open_input(path: str, is_pfm: bool):
    """Returns a row reader with .width/.height/.fmt/.read_rows(n).

    PNG inputs stream row-by-row (utils/pngio.py) so only one tile-row
    strip is ever resident -- the reference CLI's bounded-memory input
    story (hydrium.c:407-422).  PFM and exotic PNGs (interlaced etc.)
    fall back to a whole-image read."""
    if is_pfm:
        from .utils.pfm import PFMRowReader, read_pfm

        if path != "-":
            return PFMRowReader(path)     # strip-at-a-time via seeks
        return _ArrayRows(read_pfm(sys.stdin.buffer), "float32")
    fobj = sys.stdin.buffer if path == "-" else open(path, "rb")
    try:
        from .utils.pngio import PNGReader

        return PNGReader(fobj)
    except Exception:
        # unsupported/malformed-for-us PNG (interlaced, exotic header,
        # truncated chunk): let PIL try from the start
        if path == "-":
            raise
        fobj.seek(0)
        return _pil_reader(fobj)


def _peak_rss_mb() -> float:
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmHWM:"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    return 0.0


def _cap_malloc_arenas(n: int = 2) -> None:
    """Cap glibc's per-thread malloc arenas (mallopt M_ARENA_MAX).

    The threaded walker/fetch pool churns ~100 MB+ transients; with the
    default arena-per-thread policy glibc retains each thread's high
    water mark (measured ~200 MB extra peak RSS on an 8192^2 encode).
    A process-wide policy change, so applied by the CLI entry point
    only, never by library import."""
    try:
        import ctypes

        ctypes.CDLL("libc.so.6", use_errno=True).mallopt(-8, n)  # M_ARENA_MAX
    except Exception:
        pass


def main(argv=None, stats=None) -> int:
    """CLI entry point; `stats` (an EncodeStats), when given, collects
    the encode's counters and stage times."""
    _cap_malloc_arenas()
    p = argparse.ArgumentParser(
        prog="hydrium-tpu",
        description="streaming JPEG XL encoder (JAX device pipeline)")
    p.add_argument("input", help="input .png or .pfm ('-' for stdin PFM)")
    p.add_argument("output", help="output .jxl ('-' for stdout)")
    p.add_argument("--one-frame", action="store_true", default=False,
                   help="use one frame (default unless --tile-size given)")
    p.add_argument("--tile-size", type=int, default=None, metavar="N",
                   help="tile size shift 0-3 (tiles are 256*2^N)")
    p.add_argument("--pfm", action="store_true", help="input is PFM")
    p.add_argument("--png", action="store_true", help="input is PNG")
    p.add_argument("--linear", action="store_true",
                   help="input is linear light (default: sRGB)")
    p.add_argument("--tag-icc-from", metavar="FILE.icc", default=None,
                   help="tag output with this ICC profile (one-frame only)")
    p.add_argument("--backend", choices=("jax", "numpy"), default=None,
                   help="math backend (overrides --profile)")
    p.add_argument("--profile", choices=("fast", "conformance"),
                   default="fast",
                   help="encoder profile (default: fast, the jax backend)")
    p.add_argument("--verify", action="store_true",
                   help="decode the output with libjxl and report PSNR")
    p.add_argument("--stats", action="store_true",
                   help="print per-encode statistics to stderr")
    args = p.parse_args(argv)

    if args.tile_size is not None and args.one_frame:
        p.error("--one-frame and --tile-size are incompatible")
    if args.tile_size is not None and not 0 <= args.tile_size <= 3:
        p.error("tile size must be 0-3")
    tile_shift = args.tile_size if args.tile_size is not None else -1
    if args.tag_icc_from and tile_shift >= 0:
        p.error("--tag-icc-from requires one-frame mode")

    is_pfm = args.pfm or (not args.png and args.input.endswith(".pfm"))
    reader = _open_input(args.input, is_pfm)
    fmt = "float32" if is_pfm else reader.fmt
    h, w = reader.height, reader.width

    from .config import ImageMetadata, SampleFormat
    from .encoder import Encoder

    meta = ImageMetadata(width=w, height=h, linear_light=args.linear,
                         tile_size_shift_x=tile_shift,
                         tile_size_shift_y=tile_shift)
    # multi-LFG one-frame encodes spool finished sections to disk so
    # host memory stays bounded end to end (input strips + spooled
    # sections).  Spooling from 4 LF groups up: without it the finalize
    # phase holds every ANS section plus the assembled output in RAM at
    # once (measured +340 MB on an 8192^2 encode whose 16 LFGs sat just
    # under the old >= 17 threshold); the spool costs one temp file of
    # ~output size.
    spool_ctx = None
    spool_dir = None
    if meta.one_frame and meta.lfg_per_frame >= 4:
        import tempfile

        spool_ctx = tempfile.TemporaryDirectory(prefix="hydrium_spool_")
        spool_dir = spool_ctx.name
    enc = Encoder(meta, backend=args.backend or "jax",
                  profile=None if args.backend else args.profile,
                  spool_dir=spool_dir)
    if stats is not None:
        enc.stats = stats
    if args.tag_icc_from:
        with open(args.tag_icc_from, "rb") as f:
            enc.set_suggested_icc_profile(f.read())

    out = (sys.stdout.buffer if args.output == "-"
           else open(args.output, "wb"))
    captured = bytearray() if args.verify else None
    strips = [] if args.verify else None
    t0 = time.perf_counter()
    tile = 2048 if meta.one_frame else meta.tile_width
    total = 0
    sample_fmt = SampleFormat(fmt)
    # stream one tile-row strip at a time: peak pixel residency is
    # tile * width * 3 samples regardless of image height
    for ty in range((h + tile - 1) // tile):
        strip = reader.read_rows(min(tile, h - ty * tile))
        if strips is not None:
            strips.append(strip)
        if meta.one_frame:
            for tx in range((w + tile - 1) // tile):
                enc.send_tile(strip[:, tx * tile:(tx + 1) * tile], tx, ty,
                              sample_fmt=sample_fmt)
        else:
            # batched path: one device dispatch + fetch per strip chunk
            entries = [(strip[:, tx * tile:(tx + 1) * tile], tx, ty)
                       for tx in range((w + tile - 1) // tile)]
            enc.send_tile_batch(entries, sample_fmt=sample_fmt)
        for chunk in enc.iter_output():
            out.write(chunk)
            if captured is not None:
                captured.extend(chunk)
            total += len(chunk)
    dt = time.perf_counter() - t0
    if out is not sys.stdout.buffer:
        out.close()
    if spool_ctx is not None:
        spool_ctx.cleanup()

    if args.stats:
        print(f"{w}x{h} -> {total} bytes "
              f"({8.0 * total / (w * h):.3f} bpp) in {dt:.2f}s "
              f"({w * h / dt / 1e6:.2f} Mpixels/s), "
              f"peak RSS {_peak_rss_mb():.0f} MB", file=sys.stderr)
        print(enc.stats.summary(), file=sys.stderr)

    if args.verify:
        from .utils import djxl

        img = np.concatenate(strips, axis=0)
        dec = djxl.decode(bytes(captured))
        if fmt == "uint8":
            ref = img / 255.0
        elif fmt == "uint16":
            ref = img / 65535.0
        else:
            ref = img
        p_ = djxl.psnr(ref, dec)
        print(f"verify: decoded {dec.shape[1]}x{dec.shape[0]}, "
              f"PSNR {p_:.2f} dB", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
