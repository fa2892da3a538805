"""Check the .jxl files `chip_smoke.py --save DIR` wrote on a machine
without libjxl: decode each here with libjxl and hold its PSNR to the
numpy backend's on the same regenerated input, minus 0.05 dB (the bound
of chip_smoke phase 3).  For the 4-card file, also its one-card twin
when the bytes differed.

  python scripts/check_chip_outputs.py DIR

One line per file; exits nonzero when a check fails or no file is
found.  Runs on the CPU."""

import json
import os
import sys
import tempfile

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)


def main(argv=None) -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import chip_smoke as cs

    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    src = argv[0]
    cases = [(name, img, mode) for name, img, mode in cs.e2e_cases()]
    four = os.path.join(src, cs.slug(cs.FOUR_CASE) + ".jxl")
    if os.path.exists(four):
        img = cs.photo(8192, 8192)
        cases.append((cs.FOUR_CASE, img, "api"))
        single = four[:-4] + "_single.jxl"
        if os.path.exists(single):
            cases.append((cs.FOUR_CASE + "_single", img, "api"))
    checked = failed = 0
    with tempfile.TemporaryDirectory(prefix="chip_outputs_") as td:
        for name, img, mode in cases:
            path = os.path.join(src, cs.slug(name) + ".jxl")
            if not os.path.exists(path):
                continue
            with open(path, "rb") as f:
                data = f.read()
            try:
                r = cs.psnr_vs_numpy(name, img, mode, data, td)
                print(f"{name}: ok {json.dumps(r)}", flush=True)
            except cs.PhaseError as e:
                failed += 1
                print(f"{name}: FAILED {e}", flush=True)
            checked += 1
    print(f"{checked} file(s) checked, {failed} failed")
    return 1 if failed or not checked else 0


if __name__ == "__main__":
    sys.exit(main())
