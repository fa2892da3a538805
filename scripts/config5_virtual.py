"""BASELINE config 5 on the virtual mesh (VERDICT round-2 item 5):
encode a >= 16384^2 synthetic image through encode_image_multihost with
a REAL 2-process jax.distributed CPU cluster (multiple LF groups per
preset per process), byte-compare against the single-process streaming
Encoder, and record wall time + peak RSS per process.

The image is synthesized lazily per 2048-row strip (SyntheticImage) so
neither path ever holds the full frame in RAM -- peak RSS measures the
encoder, not the test harness.

Usage:
  python scripts/config5_virtual.py [--size 16384] [--out config5.json]
  python scripts/config5_virtual.py --child <port> <pid> <n> <size> <out>
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)


class SyntheticImage:
    """Lazy [size, size, 3] uint8 image: smooth band-limited base +
    deterministic per-strip noise, computed on slice access.  Quacks
    like the ndarray encode_image_multihost/Encoder need (shape, dtype,
    2-D slicing) without ever materializing the frame."""

    def __init__(self, size: int) -> None:
        self.shape = (size, size, 3)
        self.dtype = np.dtype(np.uint8)

    def __getitem__(self, key):
        ys, xs = key[0], key[1]
        y0, y1, _ = ys.indices(self.shape[0])
        x0, x1, _ = xs.indices(self.shape[1])
        yy = np.arange(y0, y1, dtype=np.float32)[:, None, None]
        xx = np.arange(x0, x1, dtype=np.float32)[None, :, None]
        phase = np.array([0.0, 1.3, 2.1], np.float32)
        base = 128 + 80 * np.sin(xx / 97.0 + phase) * np.cos(yy / 53.0)
        # coordinate-hashed noise: deterministic for any slice geometry
        # without generating anything outside the requested window
        yu = np.arange(y0, y1, dtype=np.uint32)[:, None, None]
        xu = np.arange(x0, x1, dtype=np.uint32)[None, :, None]
        cu = np.arange(3, dtype=np.uint32)[None, None, :]
        h = (yu * np.uint32(2654435761) ^ xu * np.uint32(0x9E3779B9)
             ^ cu * np.uint32(0x85EBCA6B))
        h ^= h >> np.uint32(15)
        h *= np.uint32(0x2C1B3C6D)
        h ^= h >> np.uint32(12)
        noise = ((h >> np.uint32(8)) & np.uint32(31)).astype(np.float32) - 16.0
        return np.clip(base + noise, 0, 255).astype(np.uint8)


def _peak_rss_mb() -> float:
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def child(port: str, pid: str, n: str, size: str, outpath: str) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                               num_processes=int(n), process_id=int(pid))
    from hydrium_tpu.parallel.multihost import encode_image_multihost

    t0 = time.time()
    data = encode_image_multihost(SyntheticImage(int(size)),
                                  spool_dir=os.path.dirname(outpath) or ".")
    dt = time.time() - t0
    stats = {"pid": int(pid), "wall_s": round(dt, 1),
             "peak_rss_mb": round(_peak_rss_mb(), 1),
             "bytes": len(data) if data is not None else 0}
    with open(f"{outpath}.p{pid}.json", "w") as f:
        json.dump(stats, f)
    if data is not None:
        with open(outpath, "wb") as f:
            f.write(data)
    jax.distributed.shutdown()


def single_process(size: int, outpath: str) -> dict:
    """Reference: the single-process streaming Encoder, tile strips fed
    from the same synthesizer, output drained incrementally to disk."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from hydrium_tpu.config import ImageMetadata, SampleFormat
    from hydrium_tpu.encoder import Encoder

    img = SyntheticImage(size)
    meta = ImageMetadata(width=size, height=size)
    enc = Encoder(meta, backend="jax", streaming=True,
                  spool_dir=os.path.dirname(outpath) or ".")
    t0 = time.time()
    n = (size + 2047) // 2048
    with open(outpath, "wb") as f:
        for ty in range(n):
            strip = img[ty * 2048:(ty + 1) * 2048, 0:size]
            for tx in range(n):
                enc.send_tile(strip[:, tx * 2048:(tx + 1) * 2048], tx, ty,
                              sample_fmt=SampleFormat.UINT8)
            for chunk in enc.iter_output():
                f.write(chunk)
    dt = time.time() - t0
    return {"wall_s": round(dt, 1), "peak_rss_mb": round(_peak_rss_mb(), 1),
            "bytes": os.path.getsize(outpath),
            "mpix_s": round(size * size / dt / 1e6, 3)}


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--child":
        child(*sys.argv[2:7])
        return 0
    import argparse
    import hashlib
    import socket
    import tempfile

    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=16384)
    ap.add_argument("--out", default="config5_virtual.json")
    ap.add_argument("--timeout", type=int, default=7200)
    ap.add_argument("--decode", action="store_true",
                    help="libjxl-decode the multi-host output and PSNR "
                         "it against sampled synthesized strips")
    args = ap.parse_args()

    with tempfile.TemporaryDirectory(prefix="hyd_c5_") as td:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        multi_path = os.path.join(td, "multi.jxl")
        env = dict(os.environ)
        env.pop("XLA_FLAGS", None)
        # CPU workers: they must never open (and reserve) a GPU
        env["JAX_PLATFORMS"] = "cpu"
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--child",
             str(port), str(i), "2", str(args.size), multi_path],
            env=env) for i in range(2)]
        rc = [p.wait(timeout=args.timeout) for p in procs]
        assert rc == [0, 0], f"child exit codes {rc}"
        pstats = []
        for i in range(2):
            with open(f"{multi_path}.p{i}.json") as f:
                pstats.append(json.load(f))

        single_path = os.path.join(td, "single.jxl")
        sstats = single_process(args.size, single_path)

        h_multi = hashlib.sha256(open(multi_path, "rb").read()).hexdigest()
        h_single = hashlib.sha256(open(single_path, "rb").read()).hexdigest()
        with open(multi_path, "rb") as f:
            sig = f.read(12)
        # the level-10 ISOBMFF container prefix (headers.LEVEL10_HEADER,
        # reference encoder.c:23-30) replaces the bare ff0a codestream
        # signature; 32768^2 = 2^30 px > the 2^28 area threshold
        # (libhydrium.c:67) triggers it ORGANICALLY
        level10 = sig[:2] != b"\xff\x0a" and sig[4:8] == b"JXL "
        result = {
            "config": "baseline-5-virtual",
            "size": args.size,
            "processes": 2,
            "byte_identical": h_multi == h_single,
            "level10_container": level10,
            "multi": pstats,
            "single": sstats,
            "note": ("2-process jax.distributed CPU cluster, "
                     "lazy strip input, spooled sections; wall times are "
                     "CPU times, the point is scale + byte equality + "
                     "bounded RSS"),
        }
        if args.decode:
            # round-trip through the reference decoder (libjxl): decode
            # the full image, PSNR sampled strips against re-synthesized
            # truth (never holds a full float reference)
            from hydrium_tpu.utils import djxl

            t0 = time.time()
            dec = djxl.decode(open(multi_path, "rb").read())
            img = SyntheticImage(args.size)
            sse, cnt = 0.0, 0
            rows = 256
            for y0 in range(0, args.size, max(rows, args.size // 8)):
                ref = img[y0:y0 + rows, 0:args.size].astype(np.float32)
                d = np.asarray(dec[y0:y0 + rows], np.float32)
                if d.max() <= 1.5:      # float decode is [0,1]
                    d = d * 255.0
                sse += float(((ref - d) ** 2).sum())
                cnt += ref.size
            mse = sse / max(cnt, 1)
            result["decode_seconds"] = round(time.time() - t0, 1)
            result["decoded_shape"] = list(dec.shape)
            result["psnr_db_sampled_strips"] = round(
                10 * np.log10(255.0 ** 2 / max(mse, 1e-12)), 2)
            del dec
        print(json.dumps(result, indent=1))
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
        assert result["byte_identical"], "multi-host bytes differ!"
    return 0


if __name__ == "__main__":
    sys.exit(main())
