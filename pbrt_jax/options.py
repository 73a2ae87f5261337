"""Layered render options.

Role model: the reference's ``BasicPBRTOptions`` / ``PBRTOptions`` globals
(options.h:23/37): CLI flags write the global, the scene-file ``Option``
directive writes the SAME global (scene.cpp:492-520), and render code
reads it through ``get_options()`` (the GPU constant-memory mirror,
options.h:62-82, is unnecessary here — jit closes over the values as
compile-time constants).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class PbrtOptions:
    seed: int = 0
    quiet: bool = False
    disable_pixel_jitter: bool = False
    disable_wavelength_jitter: bool = False
    disable_texture_filtering: bool = False
    force_diffuse: bool = False
    wavefront: bool = True
    rendering_space: str = "cameraworld"
    # tool knobs that ride along with the reference's PBRTOptions
    pixel_stats: bool = False
    log_level: str = "warning"

    def apply(self, name: str, value):
        """Set by Option-directive / CLI name (scene.cpp:492 name mapping)."""
        key = {
            "seed": "seed",
            "quiet": "quiet",
            "disablepixeljitter": "disable_pixel_jitter",
            "disablewavelengthjitter": "disable_wavelength_jitter",
            "disabletexturefiltering": "disable_texture_filtering",
            "forcediffuse": "force_diffuse",
            "wavefront": "wavefront",
            "rendercoordsys": "rendering_space",
            "pixelstats": "pixel_stats",
        }.get(name.lower().replace("_", ""))
        if key is None:
            return False
        cur = getattr(self, key)
        if isinstance(cur, bool):
            value = value in (True, "true", '"true"', 1, 1.0)
        elif isinstance(cur, int):
            value = int(float(value))
        else:
            value = str(value).strip('"')
        setattr(self, key, value)
        return True


_OPTIONS = PbrtOptions()


def get_options() -> PbrtOptions:
    return _OPTIONS


def reset_options():
    global _OPTIONS
    _OPTIONS = PbrtOptions()
    return _OPTIONS
