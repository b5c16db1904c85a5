"""K2's feasibility table (``repro_torch.kernels.dqn_head.x_min_table``),
on the CPU.

The kernel tests a combo's summed member accuracy ``x`` against
``x_min[m]`` instead of dividing by the member count m. Here that
compare is held against the reference's own: ``x / m >= threshold -
1e-9`` in float32, computed by JAX on the CPU as
``repro/kernels/ref.py``'s constraint head computes it, for every m up
to the kernel's most users and every float32 within 2,000 ulp of
``thr32 * m``. The kernel itself is held on the card by
``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from repro_torch.kernels import dqn_head as K2

THRESHOLDS = [0.5, 72.8, 85.0, 88.9, 89.9, 101.0]
ULPS = 2000


def _around(x: np.float32, n: int) -> np.ndarray:
    """The float32s within ``n`` ulp of ``x``, in order."""
    keys = K2._key(np.asarray([x], np.float32))[0] + np.arange(-n, n + 1)
    return K2._from_key(keys)


@pytest.mark.parametrize("threshold", THRESHOLDS)
def test_x_min_equals_the_reference_comparison(threshold):
    users = K2.MAX_USERS
    x_min = K2.x_min_table(threshold, users)
    assert x_min.dtype == np.float32 and x_min.shape == (users + 1,)
    thr32 = K2.threshold32(threshold)
    for m in range(1, users + 1):
        xs = _around(np.float32(thr32 * np.float32(m)), ULPS)
        want = np.asarray(jnp.asarray(xs) / jnp.float32(m)
                          >= threshold - 1e-9)
        assert want.any() and not want.all()     # the edge lies inside
        np.testing.assert_array_equal(xs >= x_min[m], want)


@pytest.mark.parametrize("threshold", THRESHOLDS)
def test_x_min_is_the_least_passing_float(threshold):
    x_min = K2.x_min_table(threshold, 5)
    thr32 = K2.threshold32(threshold)
    for m in range(1, 6):
        below = np.nextafter(x_min[m], np.float32(-np.inf))
        assert x_min[m] / np.float32(m) >= thr32
        assert not below / np.float32(m) >= thr32


def test_x_min_table_is_cached_and_read_only():
    a = K2.x_min_table(85.0, 5)
    assert a is K2.x_min_table(85.0, 5)
    with pytest.raises(ValueError):
        a[1] = 0.0


def test_float_keys_keep_the_floats_order():
    xs = np.asarray([-np.inf, -3.5, -1e-38, -0.0, 0.0, 1e-45, 1.0, 85.0,
                     3e38, np.inf], np.float32)
    keys = K2._key(xs)
    assert (np.diff(keys) > 0).all()
    np.testing.assert_array_equal(K2._from_key(keys).view(np.uint32),
                                  xs.view(np.uint32))
