"""Path transforms / preprocessing parity tests."""
import numpy as np
import pytest

from sigkernel_jax import transforms as T


def test_addtime():
    X = [np.arange(5.0).reshape(5, 1)]
    out = T.AddTime().fit_transform(X)
    assert out[0].shape == (5, 2)
    np.testing.assert_allclose(out[0][:, 0], np.linspace(0, 1, 5))
    np.testing.assert_allclose(out[0][:, 1], np.arange(5.0))


def test_leadlag_structure():
    x = np.array([1.0, 2.0, 3.0])
    out = T.LeadLag().fit_transform([x])[0]
    # rows: (1,1),(1,2),(2,2),(2,3),(3,3)
    want = np.array([[1, 1], [1, 2], [2, 2], [2, 3], [3, 3]], dtype=float)
    np.testing.assert_array_equal(out, want)


def test_leadlag_multidim():
    x = np.arange(8.0).reshape(4, 2)
    out = T.LeadLag().fit_transform([x])[0]
    assert out.shape == (7, 4)
    np.testing.assert_array_equal(out[0], [0, 1, 0, 1])
    np.testing.assert_array_equal(out[1], [0, 1, 2, 3])


def test_reversion():
    x = np.arange(4.0)
    out = T.Reversion().fit_transform([x])[0]
    np.testing.assert_array_equal(out, x[::-1])


def test_transform_pipeline():
    paths = np.random.default_rng(0).normal(size=(3, 6, 2))
    out = T.transform(paths, at=True, ll=True, scale=0.5)
    # lead-lag doubles dims and gives 2n-1 rows; add-time adds one channel
    assert out.shape == (3, 11, 5)


def test_dyadic_chunks():
    x = np.arange(16.0).reshape(16, 1)
    chunks = T.Dyadic(depth=2).fit_transform([x])[0]
    assert len(chunks) == 4
    # chunks overlap by one point
    for a, b in zip(chunks[:-1], chunks[1:]):
        np.testing.assert_array_equal(a[-1], b[0])


def test_penoff():
    x = np.random.default_rng(1).normal(size=(4, 2))
    out = T.PenOff().fit_transform([x])[0]
    assert out.shape == (6, 3)
    np.testing.assert_array_equal(out[0], np.zeros(3))
    assert out[-1, -1] == 0.0 and out[1, -1] == 1.0


def test_brownian_shape():
    rng = np.random.default_rng(2)
    p = T.brownian(100, 3, rng=rng)
    assert p.shape == (101, 3)
    np.testing.assert_array_equal(p[0], np.zeros(3))


def test_normalize_roundtrip():
    width, depth = 2, 3
    size = sum(width ** (k + 1) for k in range(depth))
    sig = np.ones((1, size))
    out = T.normalize(sig, width, depth)
    # level k block scaled by (k+1)!
    assert out[0][0] == 1.0  # 1! on level 1
    lo = width * (width ** 1 - 1)
    assert out[0][lo] == 2.0  # 2! on level 2
    lo = width * (width ** 2 - 1)
    assert out[0][lo] == 6.0  # 3! on level 3


def test_truncated_sig_kernel_level1_linear():
    """With num_levels=1 the kernel is sigma0 + sigma1 * <X, Y>_flat."""
    rng = np.random.default_rng(3)
    X = rng.normal(size=(3, 5, 2))
    Y = rng.normal(size=(4, 5, 2))
    K = T.truncated_sig_kernel(X, Y, num_levels=1)
    want = 1.0 + np.einsum("apk,bqk->ab", X, Y)
    np.testing.assert_allclose(K, want, rtol=1e-12)


def test_truncated_sig_kernel_symmetry():
    rng = np.random.default_rng(4)
    X = rng.normal(size=(4, 6, 2)) * 0.5
    K = T.truncated_sig_kernel(X, X, num_levels=4)
    np.testing.assert_allclose(K, K.T, rtol=1e-10)
    # PSD-ish: eigenvalues nonnegative up to roundoff
    w = np.linalg.eigvalsh(K)
    assert w.min() > -1e-8


def test_stroke_augment():
    # stroke data: list of strokes, each a list of [x, y] rows
    char = [[[0.0, 0.0], [1.0, 1.0]], [[2.0, 2.0]]]
    out = T.Stroke_Augment().fit_transform([char])[0]
    assert out.shape == (3, 3)
    np.testing.assert_array_equal(out[:, 2], [0.0, 0.0, 1.0])


def test_ink_augment():
    char = [[[0.0, 0.0], [1.0, 1.0]], [[2.0, 2.0]]]
    out = T.Ink_Augment().fit_transform([char])[0]
    assert out.shape == (3, 3)
    # ink counter increments within strokes, not after the last point
    np.testing.assert_array_equal(out[:, 2], [0.0, 1.0, 1.0])


def test_pen_augment():
    char = [[[0.0, 0.0], [1.0, 1.0]], [[2.0, 2.0]]]
    out = T.Pen_Augment().fit_transform([char])[0]
    # pen markers around strokes, first/last trimmed
    assert out.shape[1] == 3
    assert {0.0, 1.0} >= set(np.unique(out[:, 2]))


def test_white_noise_stats():
    rng = np.random.default_rng(5)
    w = T.white(10000, 2, time=1.0, rng=rng)
    assert w.shape == (10000, 2)
    np.testing.assert_allclose(w.std(), np.sqrt(1.0 / 10000), rtol=0.05)


def test_normalize_width3_offsets():
    """Level blocks for width=3: [0:3] level1, [3:12] level2 (the reference's
    offset formula lands level 2 at index 6, corrupting the rescaling)."""
    width, depth = 3, 2
    size = 3 + 9
    sig = np.ones((1, size))
    out = T.normalize(sig, width, depth)[0]
    np.testing.assert_array_equal(out[:3], np.full(3, 1.0))   # 1! * level 1
    np.testing.assert_array_equal(out[3:12], np.full(9, 2.0))  # 2! * level 2


def test_addtime_total_time():
    X = [np.zeros((5, 1))]
    out = T.AddTime(total_time=5.0).fit_transform(X)[0]
    np.testing.assert_allclose(out[:, 0], np.linspace(0, 5, 5))


# ---------------------------------------------------------------------------
# Behavioural parity vs the reference transformers (loaded standalone)
# ---------------------------------------------------------------------------

def _load_reference_transformers():
    import importlib.util
    path = "/root/reference/sigkernel/transformers.py"
    spec = importlib.util.spec_from_file_location("ref_transformers", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref():
    try:
        return _load_reference_transformers()
    except Exception as e:  # pragma: no cover
        pytest.skip(f"reference transformers unavailable: {e}")


@pytest.mark.parametrize("num_levels,order", [(1, -1), (3, -1), (4, 2),
                                              (5, 3), (4, 1)])
def test_truncated_sig_kernel_matches_reference(ref, num_levels, order):
    rng = np.random.default_rng(10)
    X = rng.normal(size=(3, 6, 2)) * 0.5
    Y = rng.normal(size=(4, 5, 2)) * 0.5
    ours = T.truncated_sig_kernel(X, Y, num_levels, sigma=1.0, order=order)
    want = ref.truncated_sig_kernel(X, Y, num_levels, sigma=1.0, order=order)
    np.testing.assert_allclose(ours, want, rtol=1e-10)


def test_truncated_sig_kernel_per_level_sigma_matches_reference(ref):
    rng = np.random.default_rng(11)
    X = rng.normal(size=(2, 5, 3)) * 0.4
    sig = np.linspace(0.5, 2.0, 4)
    ours = T.truncated_sig_kernel(X, X, 3, sigma=sig, order=-1)
    want = ref.truncated_sig_kernel(X, X, 3, sigma=sig, order=-1)
    np.testing.assert_allclose(ours, want, rtol=1e-10)


def test_dyadic_matches_reference(ref):
    rng = np.random.default_rng(12)
    for n, depth in [(16, 2), (13, 2), (9, 3), (40, 1)]:
        x = rng.normal(size=(n, 2))
        ours = T.Dyadic(depth).fit_transform([x])[0]
        want = ref.Dyadic(depth).fit_transform([x])[0]
        assert len(ours) == len(want)
        for a, b in zip(ours, want):
            np.testing.assert_array_equal(a, b)


def test_penoff_matches_reference(ref):
    x = np.random.default_rng(13).normal(size=(6, 2))
    np.testing.assert_array_equal(T.PenOff().fit_transform([x])[0],
                                  ref.PenOff().fit_transform([x])[0])


def test_stroke_ink_pen_augment_match_reference(ref):
    # stroke data as the reference consumes it: lists of [x, y] rows with
    # distinct endpoints (the reference's value-based ink compare)
    chars = [[[[0.0, 0.0], [1.0, 0.5], [2.0, 1.0]],
              [[3.0, 3.0], [4.0, 3.5]],
              [[5.0, 5.0]]]]
    for mine, theirs in [(T.Stroke_Augment, ref.Stroke_Augment),
                         (T.Ink_Augment, ref.Ink_Augment),
                         (T.Pen_Augment, ref.Pen_Augment)]:
        np.testing.assert_array_equal(mine().fit_transform(chars)[0],
                                      theirs().fit_transform(chars)[0])
