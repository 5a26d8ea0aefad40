"""The port's threefry2x32 (``repro_torch.core.prng``) against
``jax.random`` under jax's defaults, on the CPU.

Pass criteria: keys, ``fold_in`` chains, ``split``, ``random_bits``,
``randint`` and ``uniform`` bitwise equal, draw for draw; ``normal``
within ``NORMAL_TOL * max(1, |x|)`` (the port evaluates XLA's float32
erf_inv polynomials, so only ``log1p``/``sqrt`` rounding differs; the
largest gap seen over 2e6 draws is 2.42e-7 of max(1, |x|))."""
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src_torch"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.core import prng  # noqa: E402

NORMAL_TOL = 1e-6
SEEDS = [0, 1, 42, 2 ** 31 - 1, 2 ** 31, 2 ** 40 + 3, -1, -7]


def _key(seed):
    return prng.PRNGKey(seed, device="cpu")


def _eq(port, ref):
    ref = np.asarray(ref)
    port = port.numpy()
    if ref.dtype == np.uint32:
        port = port.astype(np.uint32)
    assert port.shape == ref.shape
    np.testing.assert_array_equal(port, ref)


def test_jax_defaults_are_the_ported_scheme():
    """A jax default change (impl or the partitionable scheme) would
    change every draw; fail loudly here rather than in parity tests."""
    assert jax.config.jax_threefry_partitionable is True
    assert jax.config.jax_default_prng_impl == "threefry2x32"


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey(seed):
    _eq(prng.PRNGKey(seed, device="cpu"), jax.random.PRNGKey(seed))


@pytest.mark.parametrize("seed", [0, 3, 2 ** 33 + 11])
def test_fold_in_chain(seed):
    k, j = _key(seed), jax.random.PRNGKey(seed)
    for d in (0, 1, 7, 19999, 2 ** 31 + 5, 2 ** 32 - 1):
        k, j = prng.fold_in(k, d), jax.random.fold_in(j, d)
        _eq(k, j)


def test_fold_in_vectorised_over_data_and_keys():
    ids = torch.arange(9, dtype=torch.int32)
    got = prng.fold_in(prng.fold_in(_key(4), ids), 3)
    want = jax.vmap(lambda t: jax.random.fold_in(
        jax.random.fold_in(jax.random.PRNGKey(4), t), 3))(jnp.arange(9))
    _eq(got, want)


@pytest.mark.parametrize("num", [2, 3, 7])
def test_split(num):
    k, j = prng.fold_in(_key(5), 11), jax.random.fold_in(
        jax.random.PRNGKey(5), 11)
    _eq(prng.split(k, num), jax.random.split(j, num))
    # and a split of a split (the data generator's pattern)
    _eq(prng.split(prng.split(k, num)[num - 1]),
        jax.random.split(jax.random.split(j, num)[num - 1]))


@pytest.mark.parametrize("shape", [(1,), (5,), (3, 4), (2, 3, 5), (1000,)])
def test_random_bits(shape):
    k, j = prng.fold_in(_key(6), 2), jax.random.fold_in(
        jax.random.PRNGKey(6), 2)
    _eq(prng.random_bits(k, 32, shape), jax.random.bits(j, shape, jnp.uint32))


@pytest.mark.parametrize("lo,hi", [
    (0, 1), (0, 8), (0, 1024), (0, 50), (0, 20000), (-5, 13), (3, 3),
    (9, 2), (0, 65537), (0, 2 ** 31 - 1), (-2 ** 31, 2 ** 31 - 1)])
@pytest.mark.parametrize("seed", [0, 17])
def test_randint(lo, hi, seed):
    """Spans that are and are not powers of two, the sampler's n_local
    (1, 50, 20000), empty spans, and spans whose multiplier wraps."""
    k, j = prng.fold_in(_key(seed), 1), jax.random.fold_in(
        jax.random.PRNGKey(seed), 1)
    got = prng.randint(k, (7, 33), lo, hi)
    assert got.dtype == torch.int32
    _eq(got, jax.random.randint(j, (7, 33), lo, hi, jnp.int32))


def test_randint_batched_keys_as_vmap():
    keys = prng.split(_key(8), 6)
    jkeys = jax.random.split(jax.random.PRNGKey(8), 6)
    _eq(prng.randint(keys, (40,), 0, 50),
        jax.vmap(lambda k: jax.random.randint(k, (40,), 0, 50, jnp.int32))(
            jkeys))


def test_randint_rejects_bounds_outside_int32():
    with pytest.raises(ValueError, match="int32"):
        prng.randint(_key(0), (3,), 0, 2 ** 31)


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-2.5, 3.7), (0.1, 0.2)])
def test_uniform(lo, hi):
    k, j = prng.fold_in(_key(9), 4), jax.random.fold_in(
        jax.random.PRNGKey(9), 4)
    _eq(prng.uniform(k, (50, 40), lo, hi),
        jax.random.uniform(j, (50, 40), minval=lo, maxval=hi))


@pytest.mark.parametrize("seed", [0, 5, 123])
def test_normal_within_bound(seed):
    got = prng.normal(_key(seed), (400, 500)).numpy()
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (400, 500)))
    gap = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert gap.max() <= NORMAL_TOL, gap.max()
    assert (got == want).mean() > 0.9          # most draws are bitwise


@pytest.mark.parametrize("case", range(12))
def test_sweep_shapes_and_seeds(case):
    """A seeded sweep over shapes, seeds and fold_in data: every integer
    draw bitwise, the normal draw within its bound."""
    rng = np.random.default_rng(case)
    seed = int(rng.integers(-2 ** 40, 2 ** 40))
    data = int(rng.integers(0, 2 ** 32))
    shape = tuple(int(s) for s in rng.integers(1, 9, size=rng.integers(1, 4)))
    hi = int(rng.integers(1, 2 ** 31 - 1))
    k = prng.fold_in(_key(seed), data)
    j = jax.random.fold_in(jax.random.PRNGKey(seed), data)
    _eq(prng.random_bits(k, 32, shape), jax.random.bits(j, shape, jnp.uint32))
    _eq(prng.randint(k, shape, 0, hi),
        jax.random.randint(j, shape, 0, hi, jnp.int32))
    _eq(prng.uniform(k, shape), jax.random.uniform(j, shape))
    got = prng.normal(k, shape).numpy()
    want = np.asarray(jax.random.normal(j, shape))
    assert np.all(np.abs(got - want) <= NORMAL_TOL * np.maximum(1, np.abs(want)))


def test_key_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default is legitimate here")
    with pytest.raises(RuntimeError, match="CUDA"):
        prng.PRNGKey(0)
