"""Signature-kernel estimators: the public API of the library.

Parity with the reference's ``SigKernel`` class and module functions
(reference sigkernel/sigkernel.py:15-197), rebuilt as pure ``jit``/``grad``-
compatible JAX functions:

- The PDE solve is :func:`sigkernel_jax.ops.solve.solve` (custom_vjp adjoint).
- ``max_batch`` chunking is static-shape tiling via ``lax.map`` (the
  reference recursively halves and ``torch.cat``s, sigkernel.py:31-39,
  102-127, which defeats compile caching; tiling keeps one compiled program).
- ``sym=True`` enforces exact Gram symmetry by averaging with the transpose
  (the wavefront recurrence is exactly transpose-covariant, so this is a
  no-op up to static-kernel round-off).
"""
from __future__ import annotations

import functools as _functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax

from .ops import scan_solver
from .ops.solve import solve, solve_df
from . import kernels as _kernels
from .utils import double_difference, pad_length


# ---------------------------------------------------------------------------
# Chunking helpers (static shapes; replaces reference's recursive halving)
# ---------------------------------------------------------------------------

from .utils import pad_batch as _pad_batch  # shared leading-axis padding


# ---------------------------------------------------------------------------
# Core computations
# ---------------------------------------------------------------------------

_DF_KERNELS = (_kernels.LinearKernel, _kernels.RBFKernel)


def _resolve_family(static_kernel, solver, grad_solver):
    """The tile's differentiable primitive (:func:`.ops.routes.resolve_family`);
    ``solver="df"`` takes the paired-f32 increments, which exist for the
    Linear and RBF static kernels only."""
    from .ops.routes import resolve_family

    fam = resolve_family(solver, grad_solver)
    if fam != "inc" and type(static_kernel) not in _DF_KERNELS:
        raise ValueError(
            "solver='df' supports LinearKernel and RBFKernel exactly; "
            f"got {type(static_kernel).__name__}")
    return fam


def _df_increments(static_kernel, x, y, gram: bool):
    from .ops import df_prep

    if type(static_kernel) is _kernels.LinearKernel:
        return df_prep.linear_increments_df(x, y, static_kernel.scale, gram)
    return df_prep.rbf_increments_df(x, y, static_kernel.sigma, gram)


_GRAD_SOLVERS = ("auto", "f32", "df64")


def _check_grad_solver(grad_solver):
    if grad_solver not in _GRAD_SOLVERS:
        raise ValueError(f"unknown grad_solver {grad_solver!r}; expected one "
                         f"of {_GRAD_SOLVERS}")


@_functools.partial(jax.custom_vjp, nondiff_argnums=(3, 4, 5))
def _df_hybrid(static_kernel, x, y, gram, naive, dyadic_order):
    """df forward value, f64-grade backward (``solver="df"`` with
    ``grad_solver`` ``"auto"``/``"df64"``).

    The forward value comes from the paired-f32 (double-float) increments.
    The backward *recomputes* the increment chain in true f64 and
    differentiates through it with the full-precision adjoint: the
    f32-grade error of the plain df backward is not the adjoint sweep but
    f32 cancellation in the double-difference VJP, so f64-grade gradients
    need the f64 increment chain.
    """
    dd_df = _df_increments(static_kernel, x, y, gram)
    return solve_df(dd_df, naive, dyadic_order)


def _df_hybrid_fwd(static_kernel, x, y, gram, naive, dyadic_order):
    return (_df_hybrid(static_kernel, x, y, gram, naive, dyadic_order),
            (static_kernel, x, y))


def _df_hybrid_bwd(gram, naive, dyadic_order, res, g):
    static_kernel, x, y = res

    def chain(sk_, x_, y_):
        G = (sk_.Gram_matrix(x_, y_) if gram else sk_.batch_kernel(x_, y_))
        return solve(double_difference(G), naive, "auto", dyadic_order)

    _, vjp = jax.vjp(chain, static_kernel, x, y)
    return vjp(g)


_df_hybrid.defvjp(_df_hybrid_fwd, _df_hybrid_bwd)


def _tile_solve(static_kernel, x, y, gram, naive, solver, dyadic_order,
                grad_solver):
    """One tile's differentiable solve, by family."""
    fam = _resolve_family(static_kernel, solver, grad_solver)
    if fam == "df":
        dd_df = _df_increments(static_kernel, x, y, gram)
        return solve_df(dd_df, naive, dyadic_order).astype(x.dtype)
    if fam == "df_hybrid":
        return _df_hybrid(static_kernel, x, y, gram, naive,
                          dyadic_order).astype(x.dtype)
    G = (static_kernel.Gram_matrix(x, y) if gram
         else static_kernel.batch_kernel(x, y))
    return solve(double_difference(G), naive, solver, dyadic_order,
                 grad_solver)


def _vma_of(x):
    """Varying manual axes of ``x`` under ``shard_map`` tracing (empty
    outside shard_map / on concrete arrays)."""
    try:
        return frozenset(getattr(jax.typeof(x), "vma", ()) or ())
    except TypeError:  # python scalar leaf
        return frozenset()


def _match_vma(ct, primal):
    """Give a hand-written bwd cotangent the primal input's varying
    manual axes: ``psum`` away axes the primal does not vary over (the
    transpose of broadcasting an invariant input into varying compute —
    the cross-shard reduction is the mathematically required one) and
    ``pcast``-vary any it does. Trace-time no-op when the types already
    agree, so single-device jaxprs are unchanged."""
    cv, pv = _vma_of(ct), _vma_of(primal)
    extra = tuple(sorted(cv - pv))
    if extra:
        ct = lax.psum(ct, extra)
    missing = tuple(sorted(pv - cv))
    if missing:
        ct = jax.lax.pcast(ct, missing, to="varying")
    return ct


def sig_kernel(static_kernel, X, Y, dyadic_order=0, naive=False,
               solver="auto", max_batch: Optional[int] = 100,
               length_bucket: Optional[int] = None, grad_solver="auto"):
    """Pairwise signature kernel ``k_sig(X^i, Y^i)`` -> shape ``(batch,)``.

    Parity: reference ``SigKernel.compute_kernel`` (sigkernel.py:23-40).
    ``length_bucket``: pad path lengths up to this multiple by repeating the
    final point -- exact (zero increments are no-ops) and cuts recompiles
    across irregular-length datasets. ``solver``: ``"auto"`` (the CUDA
    wavefront kernel on a GPU where it fits, else the scan tier),
    ``"cuda"``, ``"scan"``, or ``"df"`` (paired-f32 increments, Linear and
    RBF kernels). Gradients run in the input dtype; ``grad_solver="f32"``
    opts the ``"df"`` family down to its f32-grade backward.
    """
    _check_grad_solver(grad_solver)
    if length_bucket:
        X = pad_length(X, length_bucket)
        Y = pad_length(Y, length_bucket)

    def tile_fn(xy):
        x, y = xy
        return _tile_solve(static_kernel, x, y, False, naive, solver,
                           dyadic_order, grad_solver)

    batch = X.shape[0]
    if max_batch is None or batch <= max_batch:
        return tile_fn((X, Y))

    Xp, n = _pad_batch(X, max_batch)
    Yp, _ = _pad_batch(Y, max_batch)
    nc = Xp.shape[0] // max_batch
    Xc = Xp.reshape(nc, max_batch, *X.shape[1:])
    Yc = Yp.reshape(nc, max_batch, *Y.shape[1:])
    out = lax.map(tile_fn, (Xc, Yc))
    return out.reshape(-1)[:n]


def _gram_sym_triangle(static_kernel, X, dyadic_order, naive, solver,
                       max_batch, grad_solver="auto"):
    """Symmetric Gram ``G(X, X)``: solve exactly the ``A(A+1)/2`` triangle.

    The wavefront solve is exactly transpose-covariant, so ``K[j, i]``
    equals ``K[i, j]`` and computing both is wasted work -- the same
    exploitation the reference's Cython ``sym`` path does by mirroring
    (reference cython_backend.pyx:74-97). The upper-triangle pairs are
    solved in pair-flat form, chunked ``max_batch**2`` pairs at a time
    under ONE ``lax.map`` body (flat compile time in the chunk count; path
    gathers happen per chunk, so the duplicated path data is bounded by
    the chunk size), then scattered and mirrored. Solve count is
    ``A(A+1)/2`` rounded up to the chunk multiple at ANY ``max_batch``.
    """
    import numpy as np

    A = X.shape[0]
    iu, ju = np.triu_indices(A)          # static, host-side
    P = iu.shape[0]
    chunk = P if max_batch is None else min(max(max_batch, 1) ** 2, P)
    kw = dict(dyadic_order=dyadic_order, naive=naive, solver=solver,
              max_batch=None, grad_solver=grad_solver)

    def pair_tile(idx):
        i, j = idx
        return sig_kernel(static_kernel, X[i], X[j], **kw)

    if P <= chunk:
        vals = pair_tile((jnp.asarray(iu), jnp.asarray(ju)))
    else:
        nc = -(-P // chunk)
        pad = nc * chunk - P
        iu_p = np.concatenate([iu, np.zeros(pad, iu.dtype)])
        ju_p = np.concatenate([ju, np.zeros(pad, ju.dtype)])
        idx = (jnp.asarray(iu_p).reshape(nc, chunk),
               jnp.asarray(ju_p).reshape(nc, chunk))
        vals = lax.map(pair_tile, idx).reshape(-1)[:P]
    K = jnp.zeros((A, A), vals.dtype).at[iu, ju].set(vals)
    return K + K.T - jnp.diag(jnp.diag(K))


def sig_gram(static_kernel, X, Y, dyadic_order=0, sym=False, naive=False,
             solver="auto", max_batch: Optional[int] = 100,
             length_bucket: Optional[int] = None, grad_solver="auto"):
    """Signature-kernel Gram matrix ``k_sig(X^i, Y^j)`` -> ``(bx, by)``.

    Parity: reference ``SigKernel.compute_Gram`` (sigkernel.py:92-128).
    With ``sym=True`` (caller asserts ``Y is X`` semantically, as in the
    reference) only the upper triangle is solved and mirrored.
    ``length_bucket``: exact length padding (see :func:`sig_kernel`).
    """
    _check_grad_solver(grad_solver)
    if length_bucket:
        X = pad_length(X, length_bucket)
        Y = pad_length(Y, length_bucket)
    if sym and X.shape == Y.shape:
        return _gram_sym_triangle(static_kernel, X, dyadic_order, naive,
                                  solver, max_batch, grad_solver)

    def tile_fn(x, y):
        return _tile_solve(static_kernel, x, y, True, naive, solver,
                           dyadic_order, grad_solver)

    bx, by = X.shape[0], Y.shape[0]
    if max_batch is None or (bx <= max_batch and by <= max_batch):
        K = tile_fn(X, Y)
    else:
        Xp, _ = _pad_batch(X, max_batch)
        Yp, _ = _pad_batch(Y, max_batch)
        na = Xp.shape[0] // max_batch
        nb = Yp.shape[0] // max_batch
        Xc = Xp.reshape(na, max_batch, *X.shape[1:])
        Yc = Yp.reshape(nb, max_batch, *Y.shape[1:])

        def row(x):
            return lax.map(lambda y: tile_fn(x, y), Yc)  # (nb, mb, mb)

        K = lax.map(row, Xc)  # (na, nb, mb, mb)
        K = jnp.moveaxis(K, 2, 1).reshape(na * max_batch, nb * max_batch)
        K = K[:bx, :by]

    if sym:
        K = 0.5 * (K + K.T)
    return K


# ---------------------------------------------------------------------------
# Chunked Gram linear combination with eager gradients (bounded memory)
# ---------------------------------------------------------------------------

def _lincomb_pairs(A, B, W, sym):
    """Static pair index lists + per-pair weights for ``sum(W * K)``.

    ``sym`` packs the upper triangle only (``K`` is exactly symmetric, so
    ``S = sum_{i<j} (W_ij + W_ji) K_ij + sum_i W_ii K_ii``) -- the Gram
    solve count drops to ``A(A+1)/2``, the same exploitation as the
    reference's Cython ``sym`` path (reference cython_backend.pyx:74-97).
    """
    import numpy as np

    if sym:
        ii, jj = np.triu_indices(A)
        w = W[ii, jj] + jnp.where(jnp.asarray(ii == jj), 0.0, W[jj, ii])
    else:
        ii, jj = np.divmod(np.arange(A * B), B)
        w = W.reshape(-1)
    return ii, jj, w


def _lincomb_chunks(ii, jj, w, chunk):
    """Pad the pair list to a chunk multiple (zero weights: exact no-ops)."""
    import numpy as np

    P = ii.shape[0]
    nc = -(-P // chunk)
    pad = nc * chunk - P
    ii_p = jnp.asarray(np.concatenate([ii, np.zeros(pad, ii.dtype)]))
    jj_p = jnp.asarray(np.concatenate([jj, np.zeros(pad, jj.dtype)]))
    w_p = jnp.concatenate([w, jnp.zeros((pad,), w.dtype)])
    return (ii_p.reshape(nc, chunk), jj_p.reshape(nc, chunk),
            w_p.reshape(nc, chunk), P)


def _lincomb_tile_kw(dyadic_order, naive, solver, grad_solver):
    return dict(dyadic_order=dyadic_order, naive=naive, solver=solver,
                max_batch=None, grad_solver=grad_solver)


@_functools.partial(jax.custom_vjp, nondiff_argnums=(4, 5, 6, 7, 8, 9))
def _gram_lincomb(static_kernel, X, Y, W, sym, dyadic_order, naive, solver,
                  grad_solver, chunk):
    """Primal: value-only chunked scan (no stacks, no eager grads)."""
    kw = _lincomb_tile_kw(dyadic_order, naive, solver, grad_solver)
    ii, jj, w = _lincomb_pairs(X.shape[0], Y.shape[0], W, sym)
    iic, jjc, wc, P = _lincomb_chunks(ii, jj, w, chunk)
    acc_dtype = jnp.result_type(W.dtype, X.dtype)
    # exact zero DERIVED FROM X: under shard_map the scan carry must have
    # X's varying manual axes or the carry types mismatch (see CLAUDE.md)
    vma0 = jnp.sum(X[:0]).astype(acc_dtype)

    def body(acc, args):
        ic, jc, wci = args
        v = sig_kernel(static_kernel, X[ic], Y[jc], **kw)
        return acc + jnp.sum(wci * v.astype(acc_dtype)), None

    S, _ = lax.scan(body, jnp.zeros((), acc_dtype) + vma0, (iic, jjc, wc))
    return S


def _gram_lincomb_fwd(static_kernel, X, Y, W, sym, dyadic_order, naive,
                      solver, grad_solver, chunk):
    """Eager-gradient forward: each chunk's forward stack is consumed by
    its adjoint INSIDE the scan iteration, so residual memory is one
    chunk's stack regardless of the Gram size -- the bounded-memory
    version of the reference's eager ``prep_backward``
    (reference sigkernel.py:397-399,419-502), which keeps all pair grids.
    """
    kw = _lincomb_tile_kw(dyadic_order, naive, solver, grad_solver)
    ii, jj, w = _lincomb_pairs(X.shape[0], Y.shape[0], W, sym)
    iic, jjc, wc, P = _lincomb_chunks(ii, jj, w, chunk)
    acc_dtype = jnp.result_type(W.dtype, X.dtype)

    # Varying-manual-axes bookkeeping under shard_map with MIXED operand
    # sharding (e.g. X/W row-sharded, Y and the kernel replicated — the
    # sharded_sig_gram_lincomb layout): invariant primals are pre-varied
    # (`pcast`) before the inner vjp so every per-chunk cotangent is the
    # shard-LOCAL contribution (the naive alternative — letting jax.vjp
    # transpose the implicit broadcast — inserts a cross-shard psum in
    # EVERY scan step and the accumulated result double-counts when the
    # bwd reduces again). One psum back to each primal's vma happens in
    # the bwd, driven by the zero-token type witnesses stored in the
    # residuals. Outside shard_map (and under uniform sharding) every
    # expression below reduces to the round-4 code — the traced jaxpr,
    # and therefore the compile-cache key, is unchanged.
    prim_vmas = [_vma_of(X), _vma_of(Y), _vma_of(W)] + [
        _vma_of(l) for l in jax.tree.leaves(static_kernel)]
    mixed = len(set(prim_vmas)) > 1

    # exact zero derived from X: scan carries need X's varying manual
    # axes under shard_map (empty-slice sum is 0 with X's vma type)
    vma0 = jnp.sum(X[:0]).astype(acc_dtype)
    toks = None
    sk_v, X_v, Y_v = static_kernel, X, Y
    if mixed:
        union = frozenset().union(*prim_vmas)
        # zero-valued type witnesses carrying each primal's vma + dtype
        toks = (jax.tree.map(lambda l: jnp.asarray(l) * 0, static_kernel),
                jnp.sum(X[:0]), jnp.sum(Y[:0]), jnp.sum(W[:0]))
        # union-vma zero: the accumulator seed (replaces the X-only vma0)
        vma0 = (vma0 + toks[1].astype(acc_dtype)
                + toks[2].astype(acc_dtype) + toks[3].astype(acc_dtype)
                + sum(jnp.asarray(l).astype(acc_dtype).reshape(-1)[:0].sum()
                      for l in jax.tree.leaves(toks[0])))

        def _vary_up(l):
            miss = tuple(sorted(union - _vma_of(l)))
            return jax.lax.pcast(l, miss, to="varying") if miss else l

        sk_v = jax.tree.map(_vary_up, static_kernel)
        X_v, Y_v = _vary_up(X), _vary_up(Y)

    def tree_zeros(t):
        return jax.tree.map(
            lambda l: (jnp.zeros_like(jnp.asarray(l, acc_dtype))
                       + vma0), t)

    def tree_add(a, b):
        return jax.tree.map(lambda x, y: x + y.astype(x.dtype), a, b)

    def body(carry, args):
        S, gX, gY, gk = carry
        ic, jc, wci = args

        def chunk_loss(sk_, X_, Y_):
            v = sig_kernel(sk_, X_[ic], Y_[jc], **kw)
            return jnp.sum(wci * v.astype(acc_dtype)), v

        s_c, vjpf, v_c = jax.vjp(chunk_loss, sk_v, X_v, Y_v,
                                 has_aux=True)
        # cotangent 1 with s_c's exact type (incl. varying manual axes)
        dk, dX, dY = vjpf(jnp.ones((), s_c.dtype) + vma0.astype(s_c.dtype))
        return (S + s_c, gX + dX.astype(gX.dtype),
                gY + dY.astype(gY.dtype), tree_add(gk, dk)), v_c

    S0 = jnp.zeros((), acc_dtype) + vma0  # traced before gX0: jaxpr
    gX0 = jnp.zeros_like(X)               # (= cache key) must match the
    if mixed:  # zeros_like is invariant; the carry must match dX's vma
        gX0 = gX0 + vma0.astype(X.dtype)  # pre-vma-fix op order exactly
    init = (S0, gX0,
            jnp.zeros_like(Y) + vma0.astype(Y.dtype),
            tree_zeros(static_kernel))
    (S, gX, gY, gk), Kv = lax.scan(body, init, (iic, jjc, wc))

    # reconstruct the Gram for d/dW (cheap: P floats + a scatter)
    vals = Kv.reshape(-1)[:P]
    if sym:
        K = jnp.zeros(W.shape, vals.dtype).at[jnp.asarray(ii),
                                              jnp.asarray(jj)].set(vals)
        K = K + K.T - jnp.diag(jnp.diag(K))
    else:
        K = vals.reshape(W.shape)
    if mixed:
        return S, (gX, gY, gk, K.astype(W.dtype), toks)
    return S, (gX, gY, gk, K.astype(W.dtype))


def _gram_lincomb_bwd(sym, dyadic_order, naive, solver, grad_solver, chunk,
                      res, g):
    if len(res) == 5:  # mixed-vma shard_map trace (see fwd): the
        # accumulators hold shard-LOCAL sums with union vma; one psum
        # per output reduces each to its primal's vma — the correct
        # cross-shard cotangent reduction for replicated operands.
        gX, gY, gk, K, (k_toks, x_tok, y_tok, w_tok) = res
        dk = jax.tree.map(
            lambda l, t: _match_vma(g * l, t).astype(t.dtype), gk, k_toks)
        return (dk, _match_vma(g * gX, x_tok).astype(x_tok.dtype),
                _match_vma(g * gY, y_tok).astype(y_tok.dtype),
                _match_vma(g * K, w_tok).astype(w_tok.dtype))
    gX, gY, gk, K = res
    scale = lambda t: jax.tree.map(lambda l: (g * l).astype(l.dtype), t)
    return (scale(gk), (g * gX).astype(gX.dtype), (g * gY).astype(gY.dtype),
            (g * K).astype(K.dtype))


_gram_lincomb.defvjp(_gram_lincomb_fwd, _gram_lincomb_bwd)


def sig_gram_lincomb(static_kernel, X, Y, W, dyadic_order=0, sym=False,
                     naive=False, solver="auto",
                     length_bucket: Optional[int] = None, grad_solver="auto",
                     pair_chunk: int = 128):
    """Scalar ``sum_ij W_ij k_sig(X_i, Y_j)`` with bounded-memory gradients.

    The Gram matrix never materialises as a differentiation residual: pairs
    are solved ``pair_chunk`` at a time under one ``lax.scan``, and when
    differentiated each chunk's adjoint runs inside its own iteration
    (eager gradients, the reference's ``prep_backward`` trade at bounded
    memory). This is what makes the north-star config -- batch-100 Gram
    (10,000 pairs) + MMD backward, len 1024, dyadic 1 -- run on one card:
    each chunk's backward grids are freed before the next chunk's forward.
    ``sym=True`` (X is Y) solves only the ``A(A+1)/2`` triangle.
    Differentiable in ``X``, ``Y``, ``W``, and the kernel hyperparameters.

    ``pair_chunk`` trades scan length against the per-chunk working set
    (two refined solution grids per pair in the backward).
    """
    _check_grad_solver(grad_solver)
    if length_bucket:
        X = pad_length(X, length_bucket)
        Y = pad_length(Y, length_bucket)
    if sym and X.shape != Y.shape:
        raise ValueError("sym=True requires X and Y of identical shape "
                         "(the caller asserts Y is X)")
    return _gram_lincomb(static_kernel, X, Y, W, sym, dyadic_order, naive,
                         solver, grad_solver, int(pair_chunk))


def sig_kernel_and_derivatives_gram(static_kernel, X, Y, gamma,
                                    dyadic_order=0, eps: Optional[float] = None,
                                    solver="auto",
                                    max_batch: Optional[int] = None):
    """Kernel + first/second directional derivatives along ``gamma``.

    Parity: reference ``k_kgrad`` (sigkernel.py:504-593). With ``eps=None``
    (default) the static-kernel directional derivatives are computed
    *analytically* with nested ``jax.jvp`` instead of the reference's
    ``eps=1e-4`` finite differences; pass a float ``eps`` for FD parity mode.
    Returns three ``(bx, by)`` arrays ``(K, K_diff, K_diffdiff)``.

    ``max_batch`` tiles the (bx, by) pair grid with static shapes (the
    analogue of the reference's recursive quadtree at sigkernel.py:56-88):
    each tile builds only ``max_batch**2`` refined grids x 3 planes at a
    time, so large Grams at high dyadic order don't OOM.
    """
    bx, by = X.shape[0], Y.shape[0]
    if max_batch is not None and (bx > max_batch or by > max_batch):
        Xp, _ = _pad_batch(X, max_batch)
        Gp, _ = _pad_batch(gamma, max_batch)
        Yp, _ = _pad_batch(Y, max_batch)
        na = Xp.shape[0] // max_batch
        nb = Yp.shape[0] // max_batch
        Xc = Xp.reshape(na, max_batch, *X.shape[1:])
        Gc = Gp.reshape(na, max_batch, *gamma.shape[1:])
        Yc = Yp.reshape(nb, max_batch, *Y.shape[1:])

        def tile(x, g, y):
            return sig_kernel_and_derivatives_gram(
                static_kernel, x, y, g, dyadic_order=dyadic_order, eps=eps,
                solver=solver, max_batch=None)

        def row(xg):
            x, g = xg
            return lax.map(lambda y: tile(x, g, y), Yc)  # 3x (nb, mb, mb)

        out = lax.map(row, (Xc, Gc))  # 3x (na, nb, mb, mb)

        def assemble(t):
            t = jnp.moveaxis(t, 2, 1).reshape(na * max_batch, nb * max_batch)
            return t[:bx, :by]

        return tuple(assemble(t) for t in out)

    if solver not in ("auto", "scan", "cuda"):
        raise ValueError(
            f"unknown solver {solver!r} for the derivatives path; expected "
            "'auto', 'scan' or 'cuda' (all run the scan-tier triple "
            "wavefront)")
    f = lambda x: static_kernel.Gram_matrix(x, Y)
    if eps is None:
        G, dG = jax.jvp(f, (X,), (gamma,))
        _, ddG = jax.jvp(lambda x: jax.jvp(f, (x,), (gamma,))[1], (X,), (gamma,))
    else:
        G = f(X)
        G1 = f(X + eps * gamma)
        G2 = f(X + 2.0 * eps * gamma)
        dG = (G1 - G) / eps
        ddG = (G - 2.0 * G1 + G2) / (eps * eps)

    dd = double_difference(G)
    dd_d = double_difference(dG)
    dd_dd = double_difference(ddG)

    from .utils import dyadic_refine

    return scan_solver.solve_derivatives_final(
        dyadic_refine(dd, dyadic_order), dyadic_refine(dd_d, dyadic_order),
        dyadic_refine(dd_dd, dyadic_order))


def k_kgrad(X, Y, gamma, dyadic_order, static_kernel, eps=1e-4):
    """Reference-signature shim for :func:`sig_kernel_and_derivatives_gram`
    (reference sigkernel.py:504, argument order and the reference's
    finite-difference default preserved; pass ``eps=None`` for the exact
    analytic-jvp mode)."""
    return sig_kernel_and_derivatives_gram(
        static_kernel, X, Y, gamma, dyadic_order=dyadic_order, eps=eps)


# ---------------------------------------------------------------------------
# Distances / scoring rules / MMD (reference sigkernel.py:130-197)
# ---------------------------------------------------------------------------

def _offdiag_mean(K: jnp.ndarray) -> jnp.ndarray:
    n = K.shape[0]
    return (jnp.sum(K) - jnp.sum(jnp.diag(K))) / (n * (n - 1.0))


def sig_distance(static_kernel, X, Y, dyadic_order=0, naive=False,
                 solver="auto", max_batch: Optional[int] = 100,
                 grad_solver="auto"):
    """``mean k(X,X) + mean k(Y,Y) - 2 mean k(X,Y)`` over paired batches."""
    kw = dict(dyadic_order=dyadic_order, naive=naive, solver=solver,
              max_batch=max_batch, grad_solver=grad_solver)
    k_xx = sig_kernel(static_kernel, X, X, **kw)
    k_yy = sig_kernel(static_kernel, Y, Y, **kw)
    k_xy = sig_kernel(static_kernel, X, Y, **kw)
    return jnp.mean(k_xx) + jnp.mean(k_yy) - 2.0 * jnp.mean(k_xy)


def _scoring_core(static_kernel, X, Y2, dyadic_order, naive, solver,
                  max_batch, grad_solver, pair_chunk):
    """``offdiag_mean(K_XX) - 2 mean(K_XY2)`` -- the shared body of both
    scoring rules; takes the bounded-memory lincomb path when a batch
    exceeds ``max_batch`` (grads are one chunk's stack at any size)."""
    n, m = X.shape[0], Y2.shape[0]
    if max_batch is not None and (n > max_batch or m > max_batch):
        kw = dict(dyadic_order=dyadic_order, naive=naive, solver=solver,
                  grad_solver=grad_solver, pair_chunk=pair_chunk)
        dt = X.dtype
        s_xx = sig_gram_lincomb(static_kernel, X, X, _offdiag_w(n, dt),
                                sym=True, **kw)
        w_xy = jnp.full((n, m), -2.0 / (n * m), dt)
        return s_xx + sig_gram_lincomb(static_kernel, X, Y2, w_xy, **kw)
    kw = dict(dyadic_order=dyadic_order, naive=naive, solver=solver,
              max_batch=max_batch, grad_solver=grad_solver)
    K_XX = sig_gram(static_kernel, X, X, sym=True, **kw)
    K_XY = sig_gram(static_kernel, X, Y2, sym=False, **kw)
    return _offdiag_mean(K_XX) - 2.0 * jnp.mean(K_XY)


def sig_scoring_rule(static_kernel, X, y, dyadic_order=0, naive=False,
                     solver="auto", max_batch: Optional[int] = 100,
                     grad_solver="auto", pair_chunk: int = 128):
    """Scoring rule ``E[k(X,X)] - 2 E[k(X,y)]`` with unbiased diagonal removal."""
    return _scoring_core(static_kernel, X, y, dyadic_order, naive, solver,
                         max_batch, grad_solver, pair_chunk)


def sig_expected_scoring_rule(static_kernel, X, Y, dyadic_order=0, naive=False,
                              solver="auto", max_batch: Optional[int] = 100,
                              grad_solver="auto", pair_chunk: int = 128):
    """Expected scoring rule ``E_Y[S(X, y)]``."""
    return _scoring_core(static_kernel, X, Y, dyadic_order, naive, solver,
                         max_batch, grad_solver, pair_chunk)


def _offdiag_w(n, dtype):
    """Weights of the unbiased off-diagonal mean as a lincomb matrix."""
    return (1.0 - jnp.eye(n, dtype=dtype)) / (n * (n - 1.0))


def sig_mmd(static_kernel, X, Y, dyadic_order=0, naive=False,
            solver="auto", max_batch: Optional[int] = 100,
            grad_solver="auto", pair_chunk: int = 128):
    """Unbiased signature-kernel MMD^2 between samples ``X`` and ``Y``.

    When either batch exceeds ``max_batch`` the three Gram terms run
    through :func:`sig_gram_lincomb` -- the Grams never materialise as
    differentiation residuals, so ``jax.grad(sig_mmd)`` is one-chunk-of-
    stack memory at ANY batch size (the north-star batch-100 config), and
    the two symmetric terms solve only their triangles.
    """
    n, m = X.shape[0], Y.shape[0]
    if max_batch is not None and (n > max_batch or m > max_batch):
        kw = dict(dyadic_order=dyadic_order, naive=naive, solver=solver,
                  grad_solver=grad_solver, pair_chunk=pair_chunk)
        dt = X.dtype
        s_xx = sig_gram_lincomb(static_kernel, X, X, _offdiag_w(n, dt),
                                sym=True, **kw)
        s_yy = sig_gram_lincomb(static_kernel, Y, Y, _offdiag_w(m, dt),
                                sym=True, **kw)
        w_xy = jnp.full((n, m), -2.0 / (n * m), dt)
        s_xy = sig_gram_lincomb(static_kernel, X, Y, w_xy, **kw)
        return s_xx + s_yy + s_xy
    kw = dict(dyadic_order=dyadic_order, naive=naive, solver=solver,
              max_batch=max_batch, grad_solver=grad_solver)
    K_XX = sig_gram(static_kernel, X, X, sym=True, **kw)
    K_YY = sig_gram(static_kernel, Y, Y, sym=True, **kw)
    K_XY = sig_gram(static_kernel, X, Y, sym=False, **kw)
    return _offdiag_mean(K_XX) + _offdiag_mean(K_YY) - 2.0 * jnp.mean(K_XY)


# ---------------------------------------------------------------------------
# Class wrapper (API parity with reference SigKernel, sigkernel.py:15)
# ---------------------------------------------------------------------------

class SigKernel:
    """Signature kernel ``k_sig(x, y) = <S(f(x)), S(f(y))>``.

    Drop-in analogue of the reference class: holds the static kernel, the
    dyadic refinement order, and the solver scheme. All methods are pure and
    may be called under ``jax.jit`` / ``jax.grad``.
    """

    def __init__(self, static_kernel, dyadic_order, _naive_solver=False,
                 solver="auto", grad_solver="auto"):
        self.static_kernel = static_kernel
        self.dyadic_order = dyadic_order
        self._naive_solver = _naive_solver
        self.solver = solver
        self.grad_solver = grad_solver

    def _kw(self, max_batch):
        return dict(dyadic_order=self.dyadic_order, naive=self._naive_solver,
                    solver=self.solver, max_batch=max_batch,
                    grad_solver=self.grad_solver)

    def compute_kernel(self, X, Y, max_batch=100):
        return sig_kernel(self.static_kernel, X, Y, **self._kw(max_batch))

    def compute_Gram(self, X, Y, sym=False, max_batch=100):
        return sig_gram(self.static_kernel, X, Y, sym=sym, **self._kw(max_batch))

    def compute_kernel_and_derivatives_Gram(self, X, Y, gamma, max_batch=100,
                                            eps=None):
        return sig_kernel_and_derivatives_gram(
            self.static_kernel, X, Y, gamma, dyadic_order=self.dyadic_order,
            eps=eps, solver=self.solver, max_batch=max_batch)

    def compute_distance(self, X, Y, max_batch=100):
        return sig_distance(self.static_kernel, X, Y, **self._kw(max_batch))

    def compute_scoring_rule(self, X, y, max_batch=100):
        return sig_scoring_rule(self.static_kernel, X, y, **self._kw(max_batch))

    def compute_expected_scoring_rule(self, X, Y, max_batch=100):
        return sig_expected_scoring_rule(self.static_kernel, X, Y,
                                         **self._kw(max_batch))

    def compute_mmd(self, X, Y, max_batch=100):
        return sig_mmd(self.static_kernel, X, Y, **self._kw(max_batch))
