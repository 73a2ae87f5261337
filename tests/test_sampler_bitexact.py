"""Bit-exact sampler gates vs the reference binary (VERDICT r3 #7 / the
north star's "bit-exact sampling semantics where feasible").

tests/data/sampler_reference_dump.txt holds float32 bit patterns printed
by tools/refbuild/sampdump.cpp (the reference pbrt-v4 oracle build):
StartPixelSample(p, si, 0) followed by Get1D()/Get2D() calls. Regenerate
with:

    tools/refbuild/build_reference.sh && \
    /tmp/pbrt_ref_build/sampdump > tests/data/sampler_reference_dump.txt

The "zsobol-exact" sampler must be BIT-EXACT (samplers.h:225
ZSobolSampler: base-4 Morton shuffle with 64-bit MixBits digit hashes,
FastOwen scrambling, MurmurHash64A dimension hashes — all emulated on u32
pairs since JAX runs without x64).

Documented divergences (not gated for exactness, asserted distribution-
compatible only):
  * "zsobol" (the fast default): same nested-uniform structure but a
    base-2 Owen shuffle of the index and u32 dimension hashes (~30x fewer
    vector ops per dimension; see samplers.py
    _zsobol_sample_index_fast).
  * "halton": Cranley-Patterson rotation instead of the reference's CRT
    pixel remapping (no 64-bit index arithmetic on the sample path).
  * "independent"/"sobol": different counter hashes / padded dimensions.
"""
import os

import numpy as np
import jax.numpy as jnp
import pytest

from pbrt_jax import samplers as smp

_DUMP = os.path.join(os.path.dirname(__file__), "data",
                     "sampler_reference_dump.txt")


def _load():
    ref = {}
    cur = None
    for line in open(_DUMP):
        t = line.split()
        if t[0] == "sampler":
            cur = t[1]
            ref[cur] = []
        else:
            px, py, si = int(t[0]), int(t[1]), int(t[2])
            vals = np.array([np.frombuffer(bytes.fromhex(h), ">f4")[0]
                             for h in t[3:]], np.float32)
            ref[cur].append((px, py, si, vals))
    return ref


def test_zsobol_exact_is_bit_exact_1d():
    ref = _load()
    s = smp.make_sampler("zsobol-exact", spp=16, full_resolution=(64, 64),
                         seed=0)
    n_exact = n_tot = 0
    for px, py, si, vals in ref["zsobol"]:
        got = np.array(
            [float(smp.sample_1d(s, jnp.asarray([px]), jnp.asarray([py]),
                                 jnp.asarray([si]), d)[0])
             for d in range(len(vals))], np.float32)
        n_exact += int((got == vals).sum())
        n_tot += len(vals)
    assert n_exact == n_tot, f"{n_exact}/{n_tot} bit-exact"


def test_zsobol_exact_is_bit_exact_2d():
    ref = _load()
    s = smp.make_sampler("zsobol-exact", spp=16, full_resolution=(64, 64),
                         seed=0)
    n_exact = n_tot = 0
    for px, py, si, vals in ref["zsobol2d"]:
        pairs = vals.reshape(-1, 2)
        for k, (vx, vy) in enumerate(pairs):
            got = np.asarray(smp.sample_2d(
                s, jnp.asarray([px]), jnp.asarray([py]),
                jnp.asarray([si]), 2 * k))[0]
            n_exact += int(got[0] == vx) + int(got[1] == vy)
            n_tot += 2
    assert n_exact == n_tot, f"{n_exact}/{n_tot} bit-exact"


@pytest.mark.parametrize("name", ["zsobol", "halton", "independent",
                                  "sobol"])
def test_divergent_samplers_still_uniform(name):
    """The documented-divergence samplers must still produce [0,1) values
    with a sane mean over the reference probe grid (distribution-level
    compatibility; exactness intentionally not required)."""
    s = smp.make_sampler(name, spp=16, full_resolution=(64, 64), seed=0)
    ref = _load()[name]
    vals = []
    for px, py, si, _ in ref:
        got = [float(smp.sample_1d(s, jnp.asarray([px]), jnp.asarray([py]),
                                   jnp.asarray([si]), d)[0])
               for d in range(8)]
        vals.extend(got)
    vals = np.asarray(vals)
    assert (vals >= 0).all() and (vals < 1).all()
    assert abs(vals.mean() - 0.5) < 0.08
