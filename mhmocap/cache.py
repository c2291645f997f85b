"""Persistent compile-cache locations.

`enable_compile_cache` is the one place the entry points, `bench.py`,
`chip_smoke.py` and the scripts turn on JAX's persistent compilation
cache: `JAX_COMPILATION_CACHE_DIR` wins when it is set (and then no
other directory is set), otherwise the cache lives at the fixed path
`<repo>/.jax_cache` (a directory that moves never hits).

`cpu_cache_dir` is the tests' CPU cache. XLA:CPU persistent-cache
entries embed AOT machine code specialized to the compiling host's
CPU, but the cache key does not include the CPU: loading an entry
written on another machine can SIGILL/SIGABRT the process. Keying the
directory by a host fingerprint makes every hit host-compatible. The
fingerprint hashes the sorted /proc/cpuinfo flags, the CPU model name
(which drives XLA's target tuning attributes at equal flag sets) and
the jaxlib version (the XLA build that derives them).
"""

import hashlib
import os
import platform

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def enable_compile_cache(min_compile_secs: float = 1.0) -> str:
    """Turn on the persistent compile cache; returns its directory.

    A directory already configured in this process wins: JAX reads
    `JAX_COMPILATION_CACHE_DIR` into its config at import, and a caller
    (the tests' host-fingerprinted CPU cache) may have set one."""
    import jax

    path = jax.config.jax_compilation_cache_dir
    if not path:
        path = os.path.join(REPO, ".jax_cache")
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    return path


def _cpuinfo_fields():
    """(flags, model_name) from /proc/cpuinfo, best-effort."""
    flags, model = "", ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not flags and line.startswith("flags"):
                    flags = " ".join(sorted(line.split(":", 1)[1]
                                            .split()))
                elif not model and line.startswith("model name"):
                    model = line.split(":", 1)[1].strip()
                if flags and model:
                    break
    except OSError:
        pass
    return flags, model


def _jaxlib_version() -> str:
    try:
        import jaxlib
        return getattr(jaxlib, "__version__", "unknown")
    except ImportError:                           # pragma: no cover
        return "no-jaxlib"


def host_cpu_fingerprint(flags: str = None, model: str = None,
                         xla_version: str = None) -> str:
    """8-hex digest of (CPU flags, CPU model name, jaxlib version).

    The keyword arguments exist for tests; production callers use the
    live host values."""
    if flags is None or model is None:
        live_flags, live_model = _cpuinfo_fields()
        flags = live_flags if flags is None else flags
        model = live_model if model is None else model
    if not flags:
        flags = platform.processor() or platform.machine()
    if xla_version is None:
        xla_version = _jaxlib_version()
    digest_input = "\n".join([flags, model, xla_version])
    return hashlib.sha1(digest_input.encode()).hexdigest()[:8]


def cpu_cache_dir(root: str) -> str:
    """Compile-cache directory for CPU (host-fingerprinted)."""
    return os.path.join(root, f".jax_cache_cpu_{host_cpu_fingerprint()}")
