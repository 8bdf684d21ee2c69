"""Pallas kernels, compiled for the GPU through Triton.

`kernel_route` is the one place a stage chooses between its kernel and its
plain XLA form."""

from __future__ import annotations

import jax

IMPLS = ("auto", "pallas", "xla")


def kernel_route(impl: str) -> str | None:
    """Resolve a stage's `impl` option against the default backend.

    Returns "compiled" (the Triton kernel), "interpret" (the same kernel
    run by the Pallas interpreter: a correctness tool for CPU tests) or
    None (the XLA form).

      "auto"    the compiled kernel on a GPU, XLA anywhere else
      "pallas"  the compiled kernel on a GPU, the interpreter on the CPU
      "xla"     always the XLA form

    The interpreter is never chosen on a GPU."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")
    if impl == "xla":
        return None
    backend = jax.default_backend()
    if backend == "gpu":
        return "compiled"
    if impl == "auto":
        return None
    if backend == "cpu":
        return "interpret"
    raise ValueError(f"impl='pallas' needs a GPU or the CPU, not {backend!r}")
