"""The device plane's single (gather/scatter) path against plain numpy
oracles, the chip smoke test's phase functions at small sizes on the
CPU, and the process-level rules: compile-cache location, no GPU -> no
result."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import chip_smoke
from hydrium_tpu.ops import pipeline
from hydrium_tpu.utils import jaxcfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- bit packing against a numpy bit writer ----------------------------------

def _np_write(values, nbits, offsets, num_words):
    """Plain bit writer: field i (LSB-first) at absolute bit offsets[i]."""
    out = np.zeros(num_words * 32 + 64, np.uint8)
    for v, n, o in zip(values, nbits, offsets):
        for b in range(int(n)):
            out[int(o) + b] = (int(v) >> b) & 1
    bits = out[:num_words * 32].reshape(num_words, 32).astype(np.uint64)
    return (bits << np.arange(32, dtype=np.uint64)).sum(axis=1).astype(
        np.uint32)


def _fields(rng, F, max_bits, zero_share=0.3):
    nbits = rng.integers(0, max_bits + 1, F).astype(np.int32)
    nbits[rng.random(F) < zero_share] = 0
    nbits[0] = max_bits
    vals = rng.integers(0, 1 << 62, F, dtype=np.uint64) & (
        (np.uint64(1) << nbits.astype(np.uint64)) - np.uint64(1))
    return vals, nbits


@pytest.mark.parametrize("ch,max_bits", [
    (pipeline.TOK_CHUNK, pipeline.TOK_MAX_LEN),      # token stream
    (pipeline.RES_CHUNK, pipeline.RES_CAP_FAST),     # residues, fast
    (pipeline.RES_CHUNK, pipeline.RES_CAP_WIDE),     # residues, wide
])
def test_chunk_pack_matches_numpy_writer(ch, max_bits):
    """Format v3: each chunk of `ch` fields starts on a word boundary."""
    rng = np.random.default_rng(ch + max_bits)
    F = 2 * ch
    vals, nbits = _fields(rng, F, max_bits)
    nbits[ch - 1] = max_bits                 # chunk-boundary bait
    vals = vals.astype(np.uint32)
    words, nw, cbits = pipeline._bitpack_v3(
        jnp.asarray(vals), jnp.asarray(nbits), ch,
        int(nbits.sum() // 32) + 2 * (F // ch) + 2)
    want_cbits = nbits.reshape(-1, ch).sum(axis=1)
    want_nw = (want_cbits + 31) // 32
    np.testing.assert_array_equal(np.asarray(cbits), want_cbits)
    np.testing.assert_array_equal(np.asarray(nw), want_nw)
    starts = np.repeat(np.concatenate([[0], np.cumsum(want_nw)[:-1]]) * 32,
                       ch)
    within = (np.cumsum(nbits.reshape(-1, ch), axis=1)
              - nbits.reshape(-1, ch)).reshape(-1)
    want = _np_write(vals, nbits, starts + within, int(want_nw.sum()))
    np.testing.assert_array_equal(np.asarray(words)[:want.size], want)


@pytest.mark.parametrize("wide", [False, True])
def test_lf_pack_matches_numpy_writer(wide):
    """The LF stream is bit-contiguous: <= 32-bit fields on the fast
    executable, <= 42-bit fields split in two lanes on the wide one."""
    rng = np.random.default_rng(5 + wide)
    F = 1500
    vals, nbits = _fields(rng, F, 42 if wide else 32)
    offs = np.cumsum(nbits) - nbits
    cap = int(nbits.sum() // 32) + 2
    lo = (vals & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    if wide:
        hi = (vals >> np.uint64(32)).astype(np.uint32)
        words, total = pipeline._bitpack64(jnp.asarray(lo), jnp.asarray(hi),
                                           jnp.asarray(nbits), cap)
    else:
        words, total = pipeline._bitpack(jnp.asarray(lo),
                                         jnp.asarray(nbits), cap)
    assert int(total) == int(nbits.sum())
    np.testing.assert_array_equal(np.asarray(words),
                                  _np_write(vals, nbits, offs, cap))


def test_bitpack_at_drops_fields_past_the_buffer():
    vals = np.array([0xF, 0x3, 0x1], np.uint32)
    offs = np.array([0, 30, 64], np.int32)       # last field past 2 words
    words = np.asarray(pipeline._bitpack_at(jnp.asarray(vals),
                                            jnp.asarray(offs), 2))
    np.testing.assert_array_equal(words, [0xF | (0x3 << 30), 0])


@pytest.mark.parametrize("tok_classes", [9, 3])
def test_transport_streams_match_numpy(tok_classes):
    """Per-slot code lookup (one gather) and the block-sampled class
    histogram (one scatter-add) against a numpy loop."""
    rng = np.random.default_rng(tok_classes)
    N = 3 * 64
    tokens = rng.integers(0, 40, (N, 64)).astype(np.uint16)
    clusters = rng.integers(0, 9, (N, 64)).astype(np.uint8)
    residues = rng.integers(0, 1 << 10, (N, 64)).astype(np.uint32)
    rbits = rng.integers(0, 11, (N, 64)).astype(np.uint8)
    valid_len = rng.integers(0, 65, N).astype(np.int32)
    code = rng.integers(0, 1 << 12, 10 * 64).astype(np.uint32)
    length = rng.integers(1, 13, 10 * 64).astype(np.int32)
    out = {"tokens": jnp.asarray(tokens), "clusters": jnp.asarray(clusters),
           "residues": jnp.asarray(residues),
           "residue_bits": jnp.asarray(rbits),
           "valid_len": jnp.asarray(valid_len)}
    t_flat, t_bits, hist, r_flat, r_bits, ok = (
        np.asarray(a) for a in pipeline._hf_transport_streams(
            out, jnp.asarray(length), jnp.asarray(code), tok_classes))
    valid = np.arange(64)[None, :] < valid_len[:, None]
    idx = (clusters.astype(int) % tok_classes) * 64 + tokens
    np.testing.assert_array_equal(t_flat, np.where(valid, code[idx], 0)
                                  .reshape(-1))
    np.testing.assert_array_equal(t_bits, np.where(valid, length[idx], 0)
                                  .reshape(-1))
    np.testing.assert_array_equal(r_flat, np.where(valid, residues, 0)
                                  .reshape(-1))
    np.testing.assert_array_equal(r_bits, np.where(valid, rbits, 0)
                                  .reshape(-1))
    hs = pipeline.HIST_SAMPLE_STRIDE
    want = np.zeros(9 * 64, np.int64)
    sv = valid[::hs]
    np.add.at(want, idx[::hs][sv], hs)
    np.testing.assert_array_equal(hist, want)
    assert bool(ok)


# -- DCT precision -----------------------------------------------------------

def test_forward_dct_highest_matches_float64():
    assert pipeline.DCT_PRECISION == jax.lax.Precision.HIGHEST
    rng = np.random.default_rng(11)
    xyb = rng.normal(0, 0.3, (64, 96, 3)).astype(np.float32)
    got = np.asarray(pipeline.forward_dct(jnp.asarray(xyb)))
    basis = pipeline._DCT_BASIS.astype(np.float64)
    blocks = xyb.astype(np.float64).reshape(8, 8, 12, 8, 3).transpose(
        0, 2, 1, 3, 4)
    want = np.einsum("my,abyxc,kx->abmkc", basis, blocks, basis)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


# -- packed vs unpacked walk parity (chip_smoke phase 1 at small size) -------

def _image(kind, buf, seed):
    rng = np.random.default_rng(seed)
    base = chip_smoke.photo(buf, buf, np.float32, seed)
    if kind == "uint8":
        return np.clip(base * 255 + rng.normal(0, 4, base.shape), 0,
                       255).astype(np.uint8)
    if kind == "uint16":
        return np.clip(base * 65535 + rng.normal(0, 900, base.shape), 0,
                       65535).astype(np.uint16)
    return base


@pytest.mark.parametrize("buf", [256, 512])
@pytest.mark.parametrize("linear", [False, True])
@pytest.mark.parametrize("kind", ["uint8", "uint16", "float32"])
def test_packed_walk_parity(kind, linear, buf):
    r = chip_smoke.lfg_parity(_image(kind, buf, buf + linear), linear)
    assert r["ok_word"] == 1 and r["symbols"] > 0
    if kind == "float32":
        assert r["upload"] is None
    else:
        assert r["upload"] in ("px1", "px2")


# -- chip_smoke's other phases on the CPU ------------------------------------

def test_smoke_reference_agreement_small():
    r = chip_smoke.reference_agreement(chip_smoke.photo(256, 256))
    assert r["lf_max_abs_diff"] <= 1
    assert r["lf_diff1_rate"] < chip_smoke.LF_DIFF1_MAX_RATE
    assert r["hf_mismatch_rate"] < 0.01


@pytest.mark.parametrize("case", range(5))
def test_smoke_e2e_case_small(case, tmp_path):
    name, img, mode = chip_smoke.e2e_cases(scale=16)[case]
    r = chip_smoke.e2e_case(name, img, mode, "cpu", str(tmp_path))
    assert r["lfg_fallback"] == 0 and r["lfg_packed"] >= 1
    assert r["psnr_jax"] >= r["psnr_numpy"] - chip_smoke.PSNR_SLACK_DB


def test_smoke_main_fails_without_gpu(capsys):
    assert chip_smoke.main([]) != 0
    assert '"ok"' not in capsys.readouterr().out


def test_smoke_alone_fails(tmp_path):
    """Copied out of the repository, the script prints no result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_bench_fails_without_gpu():
    r = subprocess.run([sys.executable, "bench.py", "1"], cwd=REPO,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode != 0
    assert "no GPU" in r.stderr and "{" not in r.stdout


@pytest.fixture
def gpu_card():
    """Skips unless a GPU is attached (decided here, never at import)."""
    if shutil.which("nvidia-smi") is None or subprocess.run(
            ["nvidia-smi", "-L"], capture_output=True).returncode != 0:
        pytest.skip("no GPU attached")


@pytest.mark.gpu
def test_chip_smoke_on_card(gpu_card):
    """The whole smoke test in its own process (the test process itself
    is held to the CPU)."""
    env = {k: v for k, v in os.environ.items() if k not in
           ("JAX_PLATFORMS", "XLA_FLAGS")}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                       capture_output=True, text=True, timeout=1200, env=env)
    assert r.returncode == 0, r.stderr[-4000:]
    assert '"ok": true' in r.stdout.splitlines()[-1]


# -- process-level rules -----------------------------------------------------

def test_cache_dir_honours_env():
    assert jaxcfg.cache_dir({"JAX_COMPILATION_CACHE_DIR": "/x/y"}) == "/x/y"


def test_cache_dir_default_is_fixed_in_checkout():
    a, b = jaxcfg.cache_dir({}), jaxcfg.cache_dir({})
    assert a == b == os.path.join(REPO, ".jax_cache")
    assert jaxcfg.cache_dir({"HYDRIUM_JAX_CACHE": "/elsewhere"}) == a


def test_cache_dir_in_use():
    """This process (no env override in the test run) caches in the
    checkout, or wherever JAX_COMPILATION_CACHE_DIR says."""
    jaxcfg.ensure()
    assert jax.config.jax_compilation_cache_dir == jaxcfg.cache_dir()


def test_dryrun_names_its_devices(capsys):
    import __graft_entry__ as g

    g.dryrun_multichip(2)
    out = capsys.readouterr().out
    assert "ok on 2 virtual cpu devices" in out


def test_no_platform_branch_or_removed_knob_left():
    """No Pallas kernel, no branch on the platform and none of the
    removed knobs remain in the program."""
    banned = ("experimental.pallas", "default_backend()", "HYDRIUM_PALLAS",
              "HYDRIUM_PLPACK", "HYDRIUM_PLPREP",
              "HYDRIUM_TRANSPORT_BARRIER", "HYDRIUM_JAX_CACHE")
    files = [os.path.join(REPO, "bench.py"),
             os.path.join(REPO, "__graft_entry__.py")]
    for root, _dirs, names in os.walk(os.path.join(REPO, "hydrium_tpu")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    for path in files:
        with open(path) as f:
            src = f.read()
        for b in banned:
            assert b not in src, (path, b)
