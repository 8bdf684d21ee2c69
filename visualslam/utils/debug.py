"""Debug / sanitizer modes (SURVEY.md §5 "Race detection / sanitizers").

The reference debugged out-of-bounds reads by enlarging padding
(Diff_of_Gauss.cpp:568-571). The JAX-native equivalents collected here:

  - `debug_mode()`: jax_debug_nans + jax_disable_jit — every NaN faults at
    the producing op with a real stack trace;
  - `checked(fn)`: checkify wrapper surfacing NaN/OOB/div checks as errors
    from inside jitted code;
  - Pallas kernels: patch_impl="pallas" on the CPU runs them in the
    Pallas interpreter (ops/pallas.kernel_route; what
    tests/test_pallas_descriptor.py does) as the kernel 'sanitizer'.
"""

from __future__ import annotations

import contextlib

import jax
from jax.experimental import checkify


@contextlib.contextmanager
def debug_mode(disable_jit: bool = True, nan_checks: bool = True):
    """Run a block in op-by-op mode with NaN faulting."""
    ctx = contextlib.ExitStack()
    with ctx:
        if disable_jit:
            ctx.enter_context(jax.disable_jit())
        if nan_checks:
            old = jax.config.jax_debug_nans
            jax.config.update("jax_debug_nans", True)
            ctx.callback(lambda: jax.config.update("jax_debug_nans", old))
        yield


def checked(fn, errors=checkify.float_checks):
    """checkify-wrap fn: returns (err, out); err.throw() raises on NaN/inf
    (and index errors with checkify.index_checks) from inside jit."""
    return checkify.checkify(fn, errors=errors)
