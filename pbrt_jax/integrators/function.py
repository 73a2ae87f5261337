"""Function integrator: sampler-convergence measurement
(reference cpu/integrators.h:481 FunctionIntegrator, integrators.cpp:3356-3650).

Numerically integrates a 2D test function whose true integral over [0,1)^2
is 1 with every pixel using an independently-randomized sampler instance,
and reports MSE against 1 as a function of sample count.  Pairs with
``cmd/pspec.py`` as the sampler-quality tooling.

Shape: all pixels evaluate one sample index per step, vectorized
(P, 2) sample arrays; the spp loop is a host loop appending MSE rows.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from .. import samplers as smp

_SQRT_2PI = float(np.sqrt(2.0 * np.pi))


def _step(p):
    return jnp.where(p[..., 0] < 0.5, 2.0, 0.0)


def _diagonal(p):
    return jnp.where(p[..., 0] + p[..., 1] < 1.0, 2.0, 0.0)


def _disk(p):
    d2 = (p[..., 0] - 0.5) ** 2 + (p[..., 1] - 0.5) ** 2
    return jnp.where(d2 < 0.25, 1.0 / (np.pi * 0.25), 0.0)


def _checkerboard(p):
    freq = 10
    pi = jnp.floor(p * freq).astype(jnp.int32)
    return jnp.where((pi[..., 0] & 1) ^ (pi[..., 1] & 1) != 0, 2.0, 0.0)


def _rotated_checkerboard(p):
    ang = np.deg2rad(45.0)
    sa, ca = np.sin(ang), np.cos(ang)
    nrm = 1.00006866455078125
    q = jnp.stack([10.0 + p[..., 0] * ca - p[..., 1] * sa,
                   10.0 + p[..., 0] * sa + p[..., 1] * ca], -1)
    return _checkerboard(q) / nrm


def _gauss1(x, mu=0.5, sigma=0.25):
    return jnp.exp(-((x - mu) ** 2) / (2 * sigma * sigma)) / (sigma * _SQRT_2PI)


def _gaussian_fn():
    import math
    mu, sigma = 0.5, 0.25
    s2 = sigma * math.sqrt(2.0)
    integral = 0.5 * (math.erf((mu - 0.0) / s2) - math.erf((mu - 1.0) / s2))
    nrm = integral * integral

    def f(p):
        return _gauss1(p[..., 0]) * _gauss1(p[..., 1]) / nrm
    return f


FUNCTIONS = {
    "step": _step,
    "diagonal": _diagonal,
    "disk": _disk,
    "checkerboard": _checkerboard,
    "rotatedcheckerboard": _rotated_checkerboard,
    "gaussian": _gaussian_fn(),
}


def _good_spp(n, kind):
    """skipBad rule (integrators.cpp:3487-3508): report only sample counts
    where the sampler's stratification is complete."""
    if kind == "stratified":
        r = int(np.sqrt(n))
        return r * r == n
    if kind in ("sobol", "paddedsobol", "zsobol", "pmj02bn"):
        return (n & (n - 1)) == 0
    if kind == "halton":
        n2 = n3 = 0
        while n % 2 == 0:
            n //= 2
            n2 += 1
        while n % 3 == 0:
            n //= 3
            n3 += 1
        return n == 1 and n2 == n3
    return True


def run(function="step", sampler="zsobol", spp=256, resolution=(32, 32),
        skip_bad=True, seed=0):
    """Returns list of (spp, mse) rows and the final average estimate.

    Every pixel is an independent estimator (distinct sampler randomization
    via its pixel coordinate); MSE is over pixels vs the true integral 1.
    """
    if function not in FUNCTIONS:
        raise ValueError(f"unknown function {function!r}; "
                         f"options: {sorted(FUNCTIONS)}")
    func = FUNCTIONS[function]
    rx, ry = resolution
    params = smp.make_sampler(sampler, spp=spp, seed=seed,
                              full_resolution=(rx, ry))
    px, py = jnp.meshgrid(jnp.arange(rx), jnp.arange(ry))
    px, py = px.reshape(-1), py.reshape(-1)

    @jax.jit
    def one_index(si):
        u = smp.sample_2d(params, px, py, si, 0)
        return func(u)

    sumv = np.zeros(rx * ry, np.float64)
    rows = []
    for si in range(spp):
        sumv += np.asarray(one_index(jnp.int32(si)), np.float64)
        n = si + 1
        if not skip_bad or _good_spp(n, sampler):
            mse = float(np.mean((sumv / n - 1.0) ** 2))
            rows.append((n, mse))
    avg = float(sumv.mean() / spp)
    return rows, avg


def main(argv=None):
    import argparse
    import sys
    ap = argparse.ArgumentParser(
        prog="fnintegrator",
        description="sampler convergence on analytic 2D test functions")
    ap.add_argument("--function", default="step", choices=sorted(FUNCTIONS))
    ap.add_argument("--sampler", default="zsobol")
    ap.add_argument("--spp", type=int, default=256)
    ap.add_argument("--resolution", type=int, default=32)
    ap.add_argument("--outfile", default=None)
    ap.add_argument("--allspp", action="store_true",
                    help="report every sample count (no skipbad)")
    args = ap.parse_args(argv)
    rows, avg = run(args.function, args.sampler, args.spp,
                    (args.resolution, args.resolution),
                    skip_bad=not args.allspp)
    text = "".join(f"{n} {mse:f}\n" for n, mse in rows)
    if args.outfile:
        with open(args.outfile, "w") as f:
            f.write(text)
    else:
        sys.stdout.write(text)
    if avg < 0.999 or avg > 1.001:
        print(f"Average estimate is {avg}, which is suspiciously far from 1.",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
