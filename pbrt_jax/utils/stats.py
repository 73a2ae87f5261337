"""Render statistics + per-stage timing (reference util/stats.{h,cpp}
STAT_* registry and gpu/util.cpp KernelStats per-kernel timing table).

Version: host-side counters fed by the render driver, plus a stage
timing harness using block_until_ready around jitted stages. Device-side
per-lane statistics (ray counts by depth, occupancy) come back as small
arrays in the wave payload when `--stats` is on.
"""
from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field


@dataclass
class StatsAccumulator:
    """Registry of render statistics (reference util/stats.h STAT_COUNTER:88,
    STAT_MEMORY_COUNTER:110, STAT_INT_DISTRIBUTION:129, STAT_PERCENT/RATIO:
    154-162). Names use the reference's "Category/Description" convention;
    the report groups by category."""
    counters: dict = field(default_factory=lambda: defaultdict(int))
    memory_counters: dict = field(default_factory=lambda: defaultdict(int))
    distributions: dict = field(default_factory=lambda: defaultdict(list))
    ratios: dict = field(default_factory=lambda: defaultdict(lambda: [0, 0]))
    timings: dict = field(default_factory=lambda: defaultdict(float))
    timing_counts: dict = field(default_factory=lambda: defaultdict(int))

    def count(self, name, n=1):
        self.counters[name] += int(n)

    def memory(self, name, n_bytes):
        """STAT_MEMORY_COUNTER role."""
        self.memory_counters[name] += int(n_bytes)

    def ratio(self, name, num=0, denom=0):
        """STAT_RATIO / STAT_PERCENT role: accumulate numerator/denominator
        pairs, reported as num/denom (pct)."""
        self.ratios[name][0] += int(num)
        self.ratios[name][1] += int(denom)

    def add_time(self, name, seconds):
        self.timings[name] += seconds
        self.timing_counts[name] += 1

    def distribution(self, name, value):
        self.distributions[name].append(float(value))

    def merge(self, other: "StatsAccumulator"):
        """Fold another accumulator in (reference ReportThreadStats merge,
        stats.cpp:48)."""
        for k, v in other.counters.items():
            self.counters[k] += v
        for k, v in other.memory_counters.items():
            self.memory_counters[k] += v
        for k, v in other.distributions.items():
            self.distributions[k].extend(v)
        for k, (n, d) in other.ratios.items():
            self.ratios[k][0] += n
            self.ratios[k][1] += d
        for k, v in other.timings.items():
            self.timings[k] += v
            self.timing_counts[k] += other.timing_counts[k]

    def report(self) -> str:
        """Formatted report (role of reference --stats output)."""
        lines = ["Statistics:"]
        if self.counters:
            lines.append("  Counters")
            for k in sorted(self.counters):
                lines.append(f"    {k:<48} {self.counters[k]:>14,d}")
        if self.memory_counters:
            lines.append("  Memory")
            for k in sorted(self.memory_counters):
                lines.append(f"    {k:<48} {_fmt_bytes(self.memory_counters[k]):>14}")
        if self.ratios:
            lines.append("  Ratios")
            for k in sorted(self.ratios):
                n, d = self.ratios[k]
                pct = 100.0 * n / d if d else 0.0
                lines.append(f"    {k:<48} {n:,d} / {d:,d} ({pct:.2f}%)")
        if self.distributions:
            lines.append("  Distributions")
            for k in sorted(self.distributions):
                v = self.distributions[k]
                lines.append(f"    {k:<48} avg {sum(v)/len(v):10.3f} "
                             f"min {min(v):10.3f} max {max(v):10.3f}")
        if self.timings:
            lines.append("  Stage timings (wall, host-observed)")
            total = sum(self.timings.values())
            for k, t in sorted(self.timings.items(), key=lambda kv: -kv[1]):
                n = self.timing_counts[k]
                lines.append(f"    {k:<40} {t*1e3:10.2f} ms total "
                             f"({t/max(n,1)*1e3:8.3f} ms avg, {n} calls, "
                             f"{100*t/max(total,1e-12):5.1f}%)")
        return "\n".join(lines)


def _fmt_bytes(n):
    for unit, div in (("GiB", 1 << 30), ("MiB", 1 << 20), ("kiB", 1 << 10)):
        if n >= div:
            return f"{n / div:.2f} {unit}"
    return f"{n} B"


GLOBAL_STATS = StatsAccumulator()


class PixelStats:
    """Per-pixel statistic images (reference STAT_PIXEL_COUNTER stats.h:95 +
    --pixelstats images, stats.cpp:115-129)."""

    def __init__(self, width, height):
        import numpy as np
        self.width, self.height = width, height
        self.images = {}
        self._np = np

    def add(self, name, pixel_idx, values):
        np = self._np
        img = self.images.setdefault(
            name, np.zeros(self.width * self.height, np.float64))
        np.add.at(img, np.asarray(pixel_idx), np.asarray(values, np.float64))

    def set_image(self, name, image):
        self.images[name] = self._np.asarray(
            image, self._np.float64).reshape(-1)

    def write(self, prefix):
        """Write one EXR per statistic: <prefix>-<name>.exr."""
        from . import image as pimg
        np = self._np
        paths = []
        for name, img in self.images.items():
            safe = name.replace("/", "_").replace(" ", "_").lower()
            path = f"{prefix}-{safe}.exr"
            pimg.write_exr_channels(
                path, {"Y": img.reshape(self.height, self.width)
                       .astype(np.float32)})
            paths.append(path)
        return paths


class stage_timer:
    """Context manager timing a device stage: blocks on the given output.

    with stage_timer('intersect', stats): r = f(x); stats gets wall time after
    block_until_ready (the analogue of the reference's cudaEvent pairs,
    gpu/util.h:87)."""

    def __init__(self, name, stats: StatsAccumulator = None):
        self.name = name
        self.stats = stats or GLOBAL_STATS

    def __enter__(self):
        self.t0 = time.time()
        return self

    def __exit__(self, *exc):
        import jax
        # caller is responsible for block_until_ready on async results;
        # we record wall time regardless
        self.stats.add_time(self.name, time.time() - self.t0)
        return False
