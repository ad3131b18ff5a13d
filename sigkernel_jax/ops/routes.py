"""Single route-resolution point for every differentiable solve.

Two decisions are made here and nowhere else:

- the solver *tier* of an increment-grid solve (:func:`resolve_tier`):
  ``"cuda"``, the wavefront kernel of :mod:`.gpu_wavefront`, or ``"scan"``,
  the portable ``lax.scan`` tier of :mod:`.scan_solver`;
- the estimator *family* of a tile (:func:`resolve_family`): ``"inc"``, the
  increment grid through :func:`.solve.solve`, or, for an explicit
  ``solver="df"``, the paired-f32 increments of :mod:`.df_prep` (``"df"``
  with the f32-grade backward, ``"df_hybrid"`` with the f64-grade one).

Both halves of every ``custom_vjp`` call the same resolver, so forward and
backward agree by construction. :func:`on_gpu` is the one platform
predicate of the library; tests stub it to steer the routes.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

SOLVERS = ("auto", "scan", "cuda")


def on_gpu(device=None) -> bool:
    """Is ``device`` (default: JAX's first device) an NVIDIA GPU?"""
    if device is None:
        device = jax.devices()[0]
    return device.platform == "gpu"


def resolve_tier(solver: str, inc, dyadic_order: int) -> str:
    """``"cuda"`` or ``"scan"`` for base increments ``inc`` (an array or a
    ``ShapeDtypeStruct``: only the static shape and dtype are read).

    ``"auto"`` takes the kernel on a GPU when it supports the dtype and the
    refined grid's diagonals fit one block's shared memory, and the scan
    tier otherwise. ``"cuda"`` forces the kernel and raises where it cannot
    run; ``"scan"`` forces the portable tier.
    """
    from . import gpu_wavefront

    if solver not in SOLVERS:
        raise ValueError(f"unknown solver {solver!r}; expected one of "
                         f"{SOLVERS}")
    if solver == "scan":
        return "scan"
    fits = gpu_wavefront.supported(inc, dyadic_order)
    if solver == "cuda":
        if not on_gpu():
            raise ValueError("solver='cuda' needs a GPU backend; got "
                             f"{jax.devices()[0].platform!r}")
        if not fits:
            raise ValueError(
                "solver='cuda' takes float32/float64 increments whose "
                "refined diagonals fit one block's shared memory; got "
                f"dtype={jnp.dtype(inc.dtype)}, refined rows="
                f"{gpu_wavefront.refined_rows(inc.shape, dyadic_order)}")
        return "cuda"
    return "cuda" if fits and on_gpu() else "scan"


def resolve_family(solver: str, grad_solver: str) -> str:
    """Which differentiable primitive a ``sig_kernel``/``sig_gram`` tile
    uses: ``"df"`` / ``"df_hybrid"`` only for an explicit ``solver="df"``
    (f32-grade or f64-grade backward), ``"inc"`` otherwise."""
    if solver != "df":
        return "inc"
    return "df" if grad_solver == "f32" else "df_hybrid"
