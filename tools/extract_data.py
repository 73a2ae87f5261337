#!/usr/bin/env python3
"""Extract standard public numeric datasets from the reference tree into .npz files.

These are *data*, not code: CIE 1931 color-matching functions and standard
illuminants (public CIE datasets), measured metal/glass refractive-index spectra
(public measurement data, e.g. refractiveindex.info), camera sensor response
curves (physlight), and Joe & Kuo Sobol direction numbers (public dataset,
MIT-licensed generator by L. Gruenschloss). The reference (pbrt-v4) embeds the
same public datasets as C arrays; we re-pack them as binary .npz so the JAX
framework can memory-map them as device constants.

Usage: python tools/extract_data.py  (writes into pbrt_jax/data/)
"""
import re
import sys
import numpy as np
from pathlib import Path

REF = Path("/root/reference/src/pbrt")
OUT = Path(__file__).resolve().parent.parent / "pbrt_jax" / "data"


def parse_c_arrays(text: str, decl_re: str) -> dict:
    """Parse `<decl> NAME[...] = { numbers };` blocks into numpy arrays."""
    out = {}
    for m in re.finditer(decl_re + r"\s+(\w+)\s*\[[^\]]*\]\s*=\s*\{", text):
        name = m.group(1)
        start = m.end()
        depth = 1
        i = start
        while depth > 0:
            c = text[i]
            if c == "{":
                depth += 1
            elif c == "}":
                depth -= 1
            i += 1
        body = text[start:i - 1]
        nums = re.findall(r"[-+]?(?:0x[0-9a-fA-F]+|\d+\.?\d*(?:[eE][-+]?\d+)?|\.\d+(?:[eE][-+]?\d+)?)[fuUlL]*", body)
        vals = []
        for n in nums:
            if n.lower().startswith("0x"):
                n = n.rstrip("uUlL")
            else:
                n = n.rstrip("fFuUlL")
            if n.startswith("0x") or n.startswith("0X"):
                vals.append(int(n, 16))
            elif re.fullmatch(r"[-+]?\d+", n):
                vals.append(int(n))
            else:
                vals.append(float(n))
        out[name] = np.asarray(vals)
    return out


def main():
    OUT.mkdir(parents=True, exist_ok=True)

    # --- CIE curves + named spectra (illuminants / metals / glasses / sensors) ---
    spec = (REF / "util/spectrum.cpp").read_text()
    arrays = parse_c_arrays(spec, r"const\s+Float")
    cie = {k: arrays[k].astype(np.float64) for k in ("CIE_lambda", "CIE_X", "CIE_Y", "CIE_Z")}
    np.savez_compressed(OUT / "cie_xyz.npz", **cie)
    print("cie_xyz.npz:", {k: v.shape for k, v in cie.items()})

    named = {}
    for k, v in arrays.items():
        if k.startswith("CIE_Illum") or k.startswith("ACES_Illum") or k.endswith("_eta") or k.endswith("_k") \
           or k.startswith("canon_") or k.startswith("nikon_") or k.startswith("sony_"):
            named[k] = v.astype(np.float64)
    np.savez_compressed(OUT / "named_spectra.npz", **named)
    print("named_spectra.npz: %d arrays" % len(named))

    # --- CIE daylight basis S0/S1/S2 (public CIE 15 data) ---
    day = {"lam": arrays["CIE_S_lambda"], "s0": arrays["CIE_S0"],
           "s1": arrays["CIE_S1"], "s2": arrays["CIE_S2"]}
    np.savez_compressed(OUT / "cie_daylight.npz",
                        **{k: v.astype(np.float64) for k, v in day.items()})
    print("cie_daylight.npz:", {k: v.shape for k, v in day.items()})

    # --- Sobol direction numbers (Joe & Kuo 2008) ---
    sob = (REF / "util/sobolmatrices.cpp").read_text()
    sarrays = parse_c_arrays(sob, r"(?:PBRT_CONST\s+)?uint32_t")
    sm = sarrays["SobolMatrices32"].astype(np.uint32)
    np.savez_compressed(OUT / "sobolmatrices.npz", SobolMatrices32=sm)
    print("sobolmatrices.npz:", sm.shape)


if __name__ == "__main__":
    sys.exit(main())
