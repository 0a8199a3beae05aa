"""Device tabulation engines.

``device_tabulator`` is the front door: it fuses a whole element zoo
into one compiled program.  ``f64_engine`` is the one place that decides
how a platform computes f64 tables, moments and point values.
"""

#: The f64 engine of each supported JAX platform.  ``"native"`` runs the
#: expansion recurrence and every contraction in f64; ``"ozaki"`` emulates
#: f64 with two-f32 (df32) pairs and bf16 multiword GEMMs
#: (ops/doublefloat.py, ops/multiword.py), for platforms without f64
#: units.  Both supported platforms have f64 units.  On an H100 the native
#: engine tabulated 6.7x faster than the Ozaki GEMMs, and it alone kept
#: tables, moments and point values within their bounds (PERF.md).
F64_ENGINES = {"cpu": "native", "gpu": "native"}


def f64_engine(platform=None):
    """The f64 engine (``"native"`` or ``"ozaki"``) of ``platform``,
    by default JAX's default backend.  Unsupported platforms raise."""
    if platform is None:
        import jax
        platform = jax.default_backend()
    try:
        return F64_ENGINES[platform]
    except KeyError:
        raise NotImplementedError(
            f"no device engine for JAX platform {platform!r}; supported: "
            f"{sorted(F64_ENGINES)}") from None


def device_tabulator(elements, order=0, f64=True, tile=None):
    """The device engine for a zoo of elements sharing a reference cell.

    Returns a ``BatchedTabulator``: ``tab(points) -> {alpha: tables}`` and
    ``tab.unpack(tables) -> [per-element {alpha: array}]``.

    * ``f64=True`` (default): f64 tables through the platform's engine
      (``f64_engine``); they meet the 1e-10 parity budget.
    * ``f64=False``: the same program in f32.  Every change-of-basis dot
      runs at ``Precision.HIGHEST``, so a GPU does not drop to TF32.
    """
    import jax.numpy as jnp
    from .tabulate import BatchedTabulator
    if f64:
        return BatchedTabulator(elements, order=order, tile=tile,
                                matmul=f64_engine(), dtype=jnp.float64)
    return BatchedTabulator(elements, order=order, tile=tile,
                            matmul="native", dtype=jnp.float32)
