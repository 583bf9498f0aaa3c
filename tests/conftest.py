"""Test configuration: run JAX on a virtual 8-device CPU mesh.

The suite runs on the CPU (JAX_PLATFORMS=cpu and jax_platforms below);
sharding tests use xla_force_host_platform_device_count per the standard JAX
testing recipe. The GPU path is exercised by chip_smoke.py at the repo root.
"""

import hashlib
import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.setdefault("JAX_ENABLE_X64", "0")
# Persistent compile cache: the descriptor/query graphs take minutes to
# compile on CPU; caching makes repeated test runs fast. Unless
# JAX_COMPILATION_CACHE_DIR says otherwise, the suite keeps its entries in
# a subdirectory of the checkout's cache (utils/compile_cache.py), with
# three hardening measures for crashes observed inside the cache write path
# (SIGSEGV at jax compilation_cache put_executable_and_time):
#
# 1. The subdirectory name is FINGERPRINTED by the host CPU's feature flags:
#    XLA:CPU AOT results compiled for another machine's features (e.g.
#    +amx-fp16 on a host without it) load with a "could lead to execution
#    errors such as SIGILL" warning — executing such code can corrupt the
#    process arbitrarily. A per-machine dir makes cross-machine reuse
#    impossible.
# 2. zstd compression is disabled (pure-python zlib instead), removing the
#    native-code compressor from the write path.
# 3. Cache WRITES are disabled by default (reads stay on): the crash site is
#    the native LoadedExecutable.serialize() call inside
#    put_executable_and_time (jaxlib 0.9.0 CPU backend) — observed three
#    times across full-suite runs, in different test files, always at that
#    line, and never reproducible in isolation. serialize() cannot be
#    guarded from Python (it aborts the process), so the suite simply never
#    calls it. To warm the cache run the suite once with CONT2_CACHE_WRITE=1
#    (accepting the flake risk; rerun on crash); later runs read the cache.


def _machine_tag() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            txt = next((ln for ln in f if ln.startswith("flags")), "")
    except OSError:
        import platform
        txt = platform.processor()
    try:
        from importlib.metadata import version
        txt += version("jaxlib")
    except Exception:
        pass
    return hashlib.sha1(txt.encode()).hexdigest()[:12]


os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1.0")

import jax  # noqa: E402
import jax._src.compilation_cache as _cc  # noqa: E402

_cc.zstandard = None   # fall back to zlib (see module docstring above)
if hasattr(_cc, "zstd"):
    _cc.zstd = None

if os.environ.get("CONT2_CACHE_WRITE", "0") != "1":
    # read-only cache: never enter the flaky native serialize() (point 3
    # above). compiler.py calls this via module attribute, so the patch
    # takes effect for every compile in the process.
    def _no_cache_write(*args, **kwargs):
        return None

    _cc.put_executable_and_time = _no_cache_write

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from contour_context_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache(f"pytest-cpu-{_machine_tag()}")
