"""pbrt_jax — a physically based spectral path tracer in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of pbrt-v4.
Design conventions:

- **SoA everywhere**: geometric quantities are arrays with a trailing
  component axis — points/vectors/normals are ``(..., 3)`` float32 arrays,
  spectral quantities are ``(..., 4)`` (4 wavelength samples per path, matching
  the reference's ``NSpectrumSamples = 4``, util/spectrum.h:36).
- **Closed-world tag dispatch**: the reference's ``TaggedPointer`` interfaces
  (util/taggedptr.h) become int32 tag arrays + ``lax.switch``/select-over-all
  evaluation — shapes, lights, materials, textures are flat pools of
  parameters indexed by tag.
- **Wavefront as masked lanes**: the reference's wavefront queues
  (wavefront/workitems.h) become fixed-capacity arrays with active-lane masks;
  path tracing is a ``lax.while_loop`` over bounce depth with all lanes in
  flight.
- **Pure functions**: samplers, BxDFs, cameras are stateless functions of
  (params, pixel, sample_index, dimension); there is no mutable object state
  anywhere on the device side.
- Scene construction/parsing happens on host (numpy / C++ helpers); rendering
  is jit-compiled JAX; on NVIDIA GPUs BVH traversal runs one CUDA kernel
  (ops/bvh_cuda.py) called through jax.ffi.
"""

__version__ = "0.1.0"
