#!/usr/bin/env python3
"""Extract the Hosek-Wilkie sky-model coefficient dataset into an .npz.

This is *data*, not code: the published coefficient tables from
  L. Hosek, A. Wilkie, "An Analytic Model for Full Spectral Sky-Dome
  Radiance" (SIGGRAPH 2012) and the solar-radiance extension (2013),
distributed under a 3-clause BSD license by the authors.  The reference
(pbrt-v4) vendors the same dataset as C arrays
(/root/reference/src/ext/skymodel/ArHosekSkyModelData_Spectral.h); we
re-pack the numbers as a binary .npz that the JAX sky model evaluates.

Layout per wavelength band (11 bands, 320..720nm step 40):
  configs   (11, 2, 10, 6, 9)  albedo x turbidity x elev-ctrl-pt x coeff
  radiances (11, 2, 10, 6)     scalar radiance spline control points
  solar     (11, 10, 45, 4)    turbidity x elevation-piece x poly coeff
  limb      (11, 6)            limb-darkening polynomial

Usage: python tools/extract_skymodel.py  (writes pbrt_jax/data/hosek_spectral.npz)
"""
import re
import numpy as np
from pathlib import Path

SRC = Path("/root/reference/src/ext/skymodel/ArHosekSkyModelData_Spectral.h")
OUT = Path(__file__).resolve().parent.parent / "pbrt_jax" / "data" / "hosek_spectral.npz"

WLS = list(range(320, 721, 40))  # 11 bands


def parse_arrays(text):
    """name -> np.ndarray for every `double NAME[] = { ... };` in the header."""
    out = {}
    for m in re.finditer(r"double\s+(\w+)\[\]\s*=\s*\{(.*?)\}\s*;", text, re.S):
        name, body = m.group(1), m.group(2)
        body = re.sub(r"//[^\n]*", "", body)
        vals = [float(tok) for tok in
                re.findall(r"[-+]?\d+\.?\d*(?:[eE][-+]?\d+)?", body)]
        out[name] = np.asarray(vals, np.float64)
    return out


def main():
    arrays = parse_arrays(SRC.read_text())
    configs = np.stack([arrays[f"dataset{w}"].reshape(2, 10, 6, 9) for w in WLS])
    radiances = np.stack([arrays[f"datasetRad{w}"].reshape(2, 10, 6) for w in WLS])
    solar = np.stack([arrays[f"solarDataset{w}"].reshape(10, 45, 4) for w in WLS])
    limb = np.stack([arrays[f"limbDarkeningDataset{w}"] for w in WLS])
    assert configs.shape == (11, 2, 10, 6, 9), configs.shape
    assert radiances.shape == (11, 2, 10, 6)
    assert solar.shape == (11, 10, 45, 4)
    assert limb.shape == (11, 6)
    np.savez_compressed(OUT, configs=configs, radiances=radiances,
                        solar=solar, limb=limb)
    print(f"wrote {OUT} ({OUT.stat().st_size/1e6:.2f} MB)")


if __name__ == "__main__":
    main()
