"""Static (state-space) kernels.

Parity with reference sigkernel/static_kernels.py, rebuilt as JAX pytrees so
kernel hyper-parameters are traceable under ``jit``/``grad``. Every kernel
exposes the reference's duck-typed interface
(reference static_kernels.py:17-33):

- ``batch_kernel(X, Y)``: ``(batch, lx, d) x (batch, ly, d) -> (batch, lx, ly)``
- ``Gram_matrix(X, Y)``: ``(bx, lx, d) x (by, ly, d) -> (bx, by, lx, ly)``

Every inner product runs at ``lax.Precision.HIGHEST``: float32 inputs get
full float32 products (no TF32 or bf16 passes, which an accelerator may
otherwise pick for f32 matmuls and which cost ~1e-3 relative on the
distance grid, amplified through the double difference), float64 inputs
float64 ones.

Divergences from the reference (bugs fixed, documented per SURVEY.md S7):

- ``LinearKernel.Gram_matrix`` applies ``scale**2`` (the reference silently
  ignores ``scale`` on the Gram path, static_kernels.py:33).
- ``RBF_SQR_Kernel.__init__`` uses its own arguments (reference references
  undefined globals ``sigma_1``/``sigma_2``, static_kernels.py:120-121).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.tree_util import register_pytree_node_class

_einsum = functools.partial(jnp.einsum, precision=lax.Precision.HIGHEST)


class StaticKernel:
    """Base class; subclasses implement ``batch_kernel`` and ``Gram_matrix``."""

    def batch_kernel(self, X, Y):  # pragma: no cover - interface
        raise NotImplementedError

    def Gram_matrix(self, X, Y):  # pragma: no cover - interface
        raise NotImplementedError

    # snake_case alias
    def gram_matrix(self, X, Y):
        return self.Gram_matrix(X, Y)


def _flatten2(X):
    """Collapse trailing function-space axes: ``(..., L, a, b) -> (..., L, a*b)``.

    Used by the ``*_ID``/``SQR`` functional-data kernels
    (reference static_kernels.py:130-131 etc.). A no-op for 3-D input.
    """
    if X.ndim <= 3:
        return X
    return X.reshape(X.shape[0], X.shape[1], -1)


@register_pytree_node_class
class LinearKernel(StaticKernel):
    """Linear kernel ``k(x, y) = scale^2 <x, y>`` (reference static_kernels.py:11)."""

    def __init__(self, scale=1.0):
        self.scale = scale

    def batch_kernel(self, X, Y):
        s2 = jnp.asarray(self.scale, X.dtype) ** 2
        return s2 * _einsum("bpk,bqk->bpq", X, Y)

    def Gram_matrix(self, X, Y):
        s2 = jnp.asarray(self.scale, X.dtype) ** 2
        return s2 * _einsum("ipk,jqk->ijpq", X, Y)

    def tree_flatten(self):
        return (self.scale,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


@register_pytree_node_class
class RBFKernel(StaticKernel):
    """RBF kernel ``k(x, y) = exp(-|x - y|^2 / sigma)``.

    Note the reference divides by ``sigma`` (not ``sigma^2``); kept for parity
    (reference static_kernels.py:56).
    """

    def __init__(self, sigma):
        self.sigma = sigma

    def _sqdist_batch(self, X, Y):
        Xs = jnp.sum(X ** 2, axis=-1)
        Ys = jnp.sum(Y ** 2, axis=-1)
        d = -2.0 * _einsum("bpk,bqk->bpq", X, Y)
        return d + Xs[:, :, None] + Ys[:, None, :]

    def batch_kernel(self, X, Y):
        return jnp.exp(-self._sqdist_batch(X, Y) / jnp.asarray(self.sigma, X.dtype))

    def Gram_matrix(self, X, Y):
        Xs = jnp.sum(X ** 2, axis=-1)
        Ys = jnp.sum(Y ** 2, axis=-1)
        d = -2.0 * _einsum("ipk,jqk->ijpq", X, Y)
        d = d + Xs[:, None, :, None] + Ys[None, :, None, :]
        return jnp.exp(-d / jnp.asarray(self.sigma, X.dtype))

    def tree_flatten(self):
        return (self.sigma,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


# ---------------------------------------------------------------------------
# Function-space (functional data) kernels: reference static_kernels.py:75-206.
# Inputs are (batch, length_t, length_x, dim) arrays of function values.
# ---------------------------------------------------------------------------

def cos_exp_kernel(x_y, n_freqs=5, sigma=1.0):
    """Cos-exp kernel on a difference matrix (reference static_kernels.py:233-250)."""
    freqs = jnp.arange(n_freqs, dtype=x_y.dtype)
    cos_term = jnp.cos(
        2.0 * jnp.pi * x_y[..., None] * freqs
    ).sum(axis=-1)
    return cos_term * jnp.exp(-(x_y ** 2) / jnp.asarray(sigma, x_y.dtype))


def CEXP(X, n_freqs=20, sigma=3.1622776601683795):  # sqrt(10), ref default
    """Integral-operator lift induced by the cos-exp kernel.

    ``X``: ``(batch, length_t, length_x, dim)`` function values on [0, 1]
    (reference static_kernels.py:209-231).
    """
    length_x = X.shape[2]
    grid = jnp.linspace(0.0, 1.0, length_x, dtype=X.dtype)
    x_y = grid[:, None] - grid[None, :]
    T = cos_exp_kernel(x_y, n_freqs=n_freqs, sigma=sigma)
    # (batch, length_t, dim, length_x) @ (length_x, length_x)
    out = (1.0 / length_x) * jnp.matmul(jnp.swapaxes(X, -1, -2), T,
                                         precision=lax.Precision.HIGHEST)
    return jnp.swapaxes(out, -1, -2)


@register_pytree_node_class
class RBF_CEXP_Kernel(RBFKernel):
    """RBF over the CEXP lift of functional data (reference static_kernels.py:75)."""

    def __init__(self, sigma1, sigma2, n_freqs):
        self.sigma1 = sigma1
        self.n_freqs = n_freqs
        super().__init__(sigma2)

    def _lift(self, X):
        C = CEXP(X, self.n_freqs, self.sigma1)
        return C.reshape(X.shape[0], X.shape[1], -1)

    def batch_kernel(self, X, Y):
        return super().batch_kernel(self._lift(X), self._lift(Y))

    def Gram_matrix(self, X, Y):
        return super().Gram_matrix(self._lift(X), self._lift(Y))

    def tree_flatten(self):
        return (self.sigma1, self.sigma), {"n_freqs": self.n_freqs}

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], children[1], aux["n_freqs"])


@register_pytree_node_class
class RBF_SQR_Kernel(StaticKernel):
    """Product of RBF on values and RBF on squared values
    (reference static_kernels.py:116; constructor bug fixed)."""

    def __init__(self, sigma1, sigma2):
        self.rbf1 = RBFKernel(sigma1)
        self.rbf2 = RBFKernel(sigma2)

    def batch_kernel(self, X, Y):
        X, Y = _flatten2(X), _flatten2(Y)
        return self.rbf1.batch_kernel(X, Y) * self.rbf2.batch_kernel(X ** 2, Y ** 2)

    def Gram_matrix(self, X, Y):
        X, Y = _flatten2(X), _flatten2(Y)
        return self.rbf1.Gram_matrix(X, Y) * self.rbf2.Gram_matrix(X ** 2, Y ** 2)

    def tree_flatten(self):
        return (self.rbf1.sigma, self.rbf2.sigma), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


@register_pytree_node_class
class Linear_ID_Kernel(LinearKernel):
    """Linear kernel on flattened functional data (reference static_kernels.py:147)."""

    def __init__(self):
        super().__init__()

    def batch_kernel(self, X, Y):
        return super().batch_kernel(_flatten2(X), _flatten2(Y))

    def Gram_matrix(self, X, Y):
        return super().Gram_matrix(_flatten2(X), _flatten2(Y))

    def tree_flatten(self):
        return (), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls()


@register_pytree_node_class
class RBF_ID_Kernel(RBFKernel):
    """RBF kernel on flattened functional data (reference static_kernels.py:178)."""

    def batch_kernel(self, X, Y):
        return super().batch_kernel(_flatten2(X), _flatten2(Y))

    def Gram_matrix(self, X, Y):
        return super().Gram_matrix(_flatten2(X), _flatten2(Y))
