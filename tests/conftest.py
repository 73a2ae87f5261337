"""Test configuration: tests run on the CPU backend (unless JAX_PLATFORMS
says otherwise) with 8 virtual host devices, so multi-device sharding logic
is exercised without accelerators, and share the repo's compile cache."""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "-1")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0.1")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"

from pbrt_jax.utils.compile_cache import setup_compile_cache  # noqa: E402

setup_compile_cache()
