"""Runtime observability and persistence helpers.

The reference has no tracing/profiling/checkpoint subsystems (SURVEY.md
section 5); its only persistent state is in-memory caches keyed by
full-precision reprs.  The device-side equivalents provided here:

* profiling: `jax.profiler` traces (viewable in TensorBoard/XProf) and
  XLA's static cost model (fiat_tpu.ir.cost_analysis);
* "checkpoint/resume" of compiled state: JAX's persistent compilation
  cache, so recompiling an element zoo across processes is a disk hit
  rather than an XLA compile.
"""

import contextlib
import os

import jax

#: the compile cache's home when JAX_COMPILATION_CACHE_DIR is unset: a
#: fixed directory of the checkout (listed in .gitignore), so its path,
#: which is part of every cache key, never moves between runs
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def compilation_cache_dir():
    """JAX_COMPILATION_CACHE_DIR when set, else DEFAULT_CACHE_DIR."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def enable_compilation_cache(min_compile_time_secs=0.5):
    """Persist compiled executables across processes (the rebuild's
    replacement for the reference's in-memory construction caches), in
    ``compilation_cache_dir()``.  Returns that directory."""
    path = compilation_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_time_secs)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path


@contextlib.contextmanager
def profile_trace(logdir):
    """Capture a device profile of the enclosed block into ``logdir``:

        with profile_trace("chiprun_out/profile"):
            tables = tabulator(points)
            jax.block_until_ready(tables)
    """
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


def annotate(name):
    """Named profiler span for the enclosed computation."""
    return jax.profiler.TraceAnnotation(name)
