"""Test configuration: run JAX on CPU with 8 virtual devices (sharding
tests) and x64 enabled; expose the reference FIAT (via the recursivenodes
shim) as a parity oracle.  Tests marked ``gpu`` skip on the CPU;
chip_smoke.py runs them on the card, in the process that holds it."""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for p in (os.path.join(_REPO, "shims"), "/root/reference", _REPO):
    if p not in sys.path:
        sys.path.insert(0, p)

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)
