"""Built-in scene models (the renderer's "model zoo"): benchmark and test
scenes mirroring the BASELINE.json config family. Re-exports pbrt_jax.scenes.

- cornell_box        — config 1 (PathIntegrator smoke/benchmark)
- material_showcase  — config 2 class (conductors/dielectric + env light)
- furnace_plane / furnace_sphere — analytic correctness oracles
"""
from ..scenes import (  # noqa: F401
    make_cornell_box as cornell_box,
    make_material_showcase as material_showcase,
    make_furnace_plane as furnace_plane,
    make_furnace_sphere as furnace_sphere,
    make_sphere_mesh,
)
