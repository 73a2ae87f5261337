#!/usr/bin/env python3
"""Emit the two generated-data .cpp files that were stripped from the
reference snapshot (util/bluenoise.cpp, util/pmj02tables.cpp) from this
repo's own regenerated tables (pbrt_jax/data/pmj02bn.npz from
tools/gen_pmj02.py, pbrt_jax/data/bluenoise.npz from tools/gen_bluenoise.py).

pmj02bn matches the declared shape exactly (5 x 65536 x 2 u32). The
reference wants 48 blue-noise masks; we generated 8, so the remaining 40
are toroidal shifts/transposes of those — equally valid blue-noise masks
(the tables only shape sample-pattern quality, not estimator bias).

Usage: gen_tables_cpp.py OUT_DIR [DATA_DIR]
"""
import sys
from pathlib import Path

import numpy as np


def emit_array(f, values, per_line=12):
    vals = values.ravel()
    for i in range(0, len(vals), per_line):
        f.write(",".join(str(int(v)) for v in vals[i:i + per_line]))
        f.write(",\n")


def main():
    out = Path(sys.argv[1])
    data = Path(sys.argv[2]) if len(sys.argv) > 2 else \
        Path(__file__).resolve().parent.parent.parent / "pbrt_jax" / "data"

    pmj = np.load(data / "pmj02bn.npz")["samples"]
    assert pmj.shape == (5, 65536, 2) and pmj.dtype == np.uint32
    with open(out / "pmj02tables.cpp", "w") as f:
        f.write('#include <pbrt/util/pmj02tables.h>\n\nnamespace pbrt {\n')
        f.write('PBRT_CONST uint32_t pmj02bnSamples[nPMJ02bnSets]'
                '[nPMJ02bnSamples][2] = {\n')
        emit_array(f, pmj)
        f.write('};\n}  // namespace pbrt\n')

    masks = np.load(data / "bluenoise.npz")["masks"]  # (8, 128, 128) u16
    assert masks.dtype == np.uint16 and masks.shape[1:] == (128, 128)
    rng = np.random.default_rng(0)
    out_masks = []
    k = 0
    while len(out_masks) < 48:
        m = masks[k % masks.shape[0]]
        if k >= masks.shape[0]:
            sx, sy = rng.integers(1, 128, 2)
            m = np.roll(np.roll(m, int(sx), 0), int(sy), 1)
            if (k // masks.shape[0]) % 2 == 1:
                m = m.T
        out_masks.append(m)
        k += 1
    bn = np.stack(out_masks)
    with open(out / "bluenoise.cpp", "w") as f:
        f.write('#include <pbrt/util/bluenoise.h>\n\nnamespace pbrt {\n')
        f.write('PBRT_CONST uint16_t BlueNoiseTextures[NumBlueNoiseTextures]'
                '[BlueNoiseResolution][BlueNoiseResolution] = {\n')
        emit_array(f, bn, per_line=16)
        f.write('};\n}  // namespace pbrt\n')


if __name__ == "__main__":
    main()
