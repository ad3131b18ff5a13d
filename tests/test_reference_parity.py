"""Golden parity against the ACTUAL reference implementation.

Loads the reference's pure-torch naive oracles (reference
sigkernel/sigkernel.py:700-807 -- kept upstream "just for testing") by
stubbing out its CUDA/Cython imports, and checks our solvers reproduce them
to 1e-10 relative. This is the strongest parity evidence available without
GPU hardware: the oracle *is* the reference's semantic spec of the solver.

Skipped automatically when /root/reference is not mounted. The reference's
``_naive_solver=True`` branch of these oracles uses a different first-order
variant than its own compiled backends (documented divergence, see
sigkernel_jax/naive.py), so parity is checked on the default higher-order
scheme, which is identical everywhere.
"""
import os
import sys
import types

import numpy as np
import pytest

REF = "/root/reference"

pytestmark = pytest.mark.skipif(
    not os.path.isdir(os.path.join(REF, "sigkernel")),
    reason="reference checkout not available")


@pytest.fixture(scope="module")
def reference():
    """Import the reference package with its accelerator deps stubbed."""
    torch = pytest.importorskip("torch")

    # numba.cuda stub (decorator passthrough; never executed on CPU paths)
    numba = types.ModuleType("numba")
    cuda = types.ModuleType("numba.cuda")
    cuda.jit = lambda *a, **k: (a[0] if a and callable(a[0])
                                else (lambda f: f))
    cuda.as_cuda_array = lambda x: x
    numba.cuda = cuda
    # compiled Cython extension stub (CPU paths we exercise don't reach it)
    cyb = types.ModuleType("cython_backend")
    for name in ("sigkernel_cython", "sigkernel_Gram_cython",
                 "sigkernel_derivatives_Gram_cython"):
        setattr(cyb, name, None)

    saved = {}
    for mod, obj in (("numba", numba), ("numba.cuda", cuda),
                     ("cython_backend", cyb)):
        saved[mod] = sys.modules.get(mod)
        sys.modules[mod] = obj
    sys.path.insert(0, REF)
    try:
        import importlib
        ref = importlib.import_module("sigkernel")
        yield ref, torch
    finally:
        sys.path.remove(REF)
        for mod, obj in saved.items():
            if obj is None:
                sys.modules.pop(mod, None)
            else:
                sys.modules[mod] = obj


def _paths(rng, b, l, d):
    return (rng.normal(size=(b, l, d)).cumsum(axis=1)
            / np.sqrt(l) * 0.5)


@pytest.mark.parametrize("dyadic_order", [0, 1])
def test_kernel_matches_reference_oracle(rng, reference, dyadic_order):
    ref, torch = reference
    import jax.numpy as jnp
    import sigkernel_jax as sk

    X = _paths(rng, 4, 8, 2)
    Y = _paths(rng, 4, 12, 2)
    sigma = 0.5

    want = ref.SigKernel_naive(
        torch.tensor(X), torch.tensor(Y), ref.RBFKernel(sigma),
        dyadic_order=dyadic_order, _naive_solver=False).numpy()

    got = np.asarray(sk.sig_kernel(sk.RBFKernel(sigma), jnp.asarray(X),
                                   jnp.asarray(Y),
                                   dyadic_order=dyadic_order))
    np.testing.assert_allclose(got, want, rtol=1e-10)


def test_gram_matches_reference_oracle(rng, reference):
    ref, torch = reference
    import jax.numpy as jnp
    import sigkernel_jax as sk

    X = _paths(rng, 4, 7, 3)
    Y = _paths(rng, 5, 9, 3)

    want = ref.SigKernelGramMat_naive(
        torch.tensor(X), torch.tensor(Y), ref.LinearKernel(),
        dyadic_order=0, _naive_solver=False).numpy()

    got = np.asarray(sk.sig_gram(sk.LinearKernel(), jnp.asarray(X),
                                 jnp.asarray(Y), dyadic_order=0))
    np.testing.assert_allclose(got, want, rtol=1e-10)


def test_mmd_matches_reference_oracle(rng, reference):
    ref, torch = reference
    import jax.numpy as jnp
    import sigkernel_jax as sk

    X = _paths(rng, 5, 8, 2)
    Y = _paths(rng, 6, 8, 2)
    sigma = 1.0

    mod = ref.SigMMD_naive(ref.RBFKernel(sigma), dyadic_order=0,
                           _naive_solver=False)
    want = float(mod(torch.tensor(X), torch.tensor(Y)))

    got = float(sk.sig_mmd(sk.RBFKernel(sigma), jnp.asarray(X),
                           jnp.asarray(Y), dyadic_order=0))
    np.testing.assert_allclose(got, want, rtol=1e-10)


def test_static_kernels_match_reference(rng, reference):
    ref, torch = reference
    import jax.numpy as jnp
    import sigkernel_jax as sk

    X = _paths(rng, 3, 6, 2)
    Y = _paths(rng, 4, 5, 2)
    want = ref.RBFKernel(0.7).Gram_matrix(
        torch.tensor(X), torch.tensor(Y)).numpy()
    got = np.asarray(sk.RBFKernel(0.7).Gram_matrix(jnp.asarray(X),
                                                   jnp.asarray(Y)))
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_derivatives_solver_matches_reference_mps_backend(rng, reference):
    """The fused triple-solve recurrences vs the reference's vectorised
    backend (reference sigkernel/mps_backend.py:80-129 -- pure torch fancy
    indexing, runs fine on CPU tensors). Identical increment grids are fed
    to both solvers, isolating the recurrence itself."""
    ref, torch = reference
    import jax.numpy as jnp
    from sigkernel_jax.ops import scan_solver

    A, B, M, N = 2, 3, 7, 9
    inc = rng.normal(size=(A, B, M, N)) * 0.1
    inc_d = rng.normal(size=(A, B, M, N)) * 0.1
    inc_dd = rng.normal(size=(A, B, M, N)) * 0.1

    K = torch.zeros((A, B, M + 2, N + 2), dtype=torch.float64)
    Kd = torch.zeros_like(K)
    Kdd = torch.zeros_like(K)
    K[:, :, 0, :] = 1.0
    K[:, :, :, 0] = 1.0
    ref.sigkernel_derivatives_Gram_mps(
        torch.tensor(inc), torch.tensor(inc_d), torch.tensor(inc_dd),
        M, N, K, Kd, Kdd)

    k, d, s = scan_solver.solve_derivatives_final(
        jnp.asarray(inc), jnp.asarray(inc_d), jnp.asarray(inc_dd))

    np.testing.assert_allclose(np.asarray(k), K[:, :, -2, -2].numpy(),
                               rtol=1e-10)
    np.testing.assert_allclose(np.asarray(d), Kd[:, :, -2, -2].numpy(),
                               rtol=1e-10)
    np.testing.assert_allclose(np.asarray(s), Kdd[:, :, -2, -2].numpy(),
                               rtol=1e-10)
