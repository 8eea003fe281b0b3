"""K0: the port's counter-hash dropout masks against the JAX package.

The attention keep mask must equal ``emdr2_tpu.ops.fid_attention._keep_mask``
bit for bit (it is what the CUDA kernels compute in ``csrc/hashing.cuh``);
the hidden-dropout mask must equal ``murmur_fin`` over the element
coordinates the way ``PackedDropout`` builds it (``layers.py:125-137``) for
the same seed. Exact comparisons: integer arithmetic.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from emdr2_tpu.ops.fid_attention import _keep_mask  # noqa: E402
from emdr2_tpu.ops.hashing import MIX_PRIMES as JAX_PRIMES  # noqa: E402
from emdr2_tpu.ops.hashing import murmur_fin as jax_murmur_fin  # noqa: E402
from emdr2_tpu_torch.ops import hashing  # noqa: E402

torch.set_num_threads(2)


def test_murmur_fin_matches_jax():
    x = np.random.RandomState(0).randint(0, 2 ** 32, size=4096,
                                         dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jax_murmur_fin(jnp.asarray(x)))
    got = hashing.murmur_fin(torch.tensor(x.view(np.int32)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    assert [hashing.murmur_fin_int(int(v)) for v in x[:64]] == \
        want[:64].tolist()
    assert hashing.MIX_PRIMES == JAX_PRIMES


@pytest.mark.parametrize("seed", [0, 1234, 2 ** 32 - 5])
@pytest.mark.parametrize("rate", [0.1, 0.4, 0.9])
def test_keep_mask_bit_equal_to_jax(seed, rate):
    for bh in (0, 7, 4799):
        for j in (0, 1, 49):
            want = _keep_mask(jnp.asarray([seed], jnp.uint32),
                              jnp.uint32(bh), rate, 16, 40,
                              j=jnp.uint32(j))
            got = hashing.keep_mask(seed, torch.tensor(bh), rate, 16, 40, j)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_keep_mask_batches_bh():
    """A [B, nh] bh tensor gives each (b, h) its own mask."""
    bh = torch.arange(6).view(2, 3)
    got = hashing.keep_mask(99, bh, 0.3, 8, 24, 2)
    assert got.shape == (2, 3, 8, 24)
    for b in range(2):
        for h in range(3):
            want = _keep_mask(jnp.asarray([99], jnp.uint32),
                              jnp.uint32(3 * b + h), 0.3, 8, 24,
                              j=jnp.uint32(2))
            np.testing.assert_array_equal(got[b, h].numpy(), np.asarray(want))


def _jax_packed_keep(seed, shape, rate):
    """PackedDropout's keep mask (layers.py:125-137) for a given seed."""
    t = round(rate * 4294967296.0)
    h = jnp.broadcast_to(jnp.uint32(seed), shape)
    for axis in range(len(shape)):
        idx = jnp.asarray(np.indices(shape)[axis].astype(np.uint32))
        h = h ^ (idx * jnp.uint32(JAX_PRIMES[axis % len(JAX_PRIMES)]))
    return np.asarray(jax_murmur_fin(h) >= jnp.uint32(t))


@pytest.mark.parametrize("shape", [(7,), (3, 5, 6), (2, 3, 4, 5)])
@pytest.mark.parametrize("seed", [3, 2 ** 31 + 11])
def test_packed_dropout_mask_and_scale_match_jax(shape, seed):
    rate = 0.1
    x = torch.ones(shape, dtype=torch.bfloat16)
    got = hashing.packed_dropout(x, rate, seed)
    keep = _jax_packed_keep(seed, shape, rate)
    np.testing.assert_array_equal((got != 0).numpy(), keep)
    t = round(rate * 4294967296.0)
    scale = torch.tensor(4294967296.0 / (4294967296 - t),
                         dtype=torch.bfloat16)
    assert (got[got != 0] == scale).all()      # scale rounded to x's dtype


def test_packed_dropout_rate_and_determinism():
    """The kept fraction of 1e6 elements at rate 0.1 lies within 6 standard
    deviations of 0.9 (binomial: sqrt(0.09 / 1e6) = 3e-4); the mask is a
    function of the seed alone."""
    x = torch.ones(100, 100, 100)
    a = hashing.packed_dropout(x, 0.1, 17)
    kept = (a != 0).float().mean().item()
    assert abs(kept - 0.9) < 6 * 3e-4
    assert torch.equal(a, hashing.packed_dropout(x, 0.1, 17))
    assert not torch.equal(a, hashing.packed_dropout(x, 0.1, 18))
    assert hashing.packed_dropout(x, 0.1, None) is x
    assert hashing.packed_dropout(x, 0.0, 17) is x


def test_dropout_seeds_are_pure_functions_of_their_indices():
    a, b = hashing.DropoutSeeds(5), hashing.DropoutSeeds(5)
    assert a.fold(3).site(1) == b.fold(3).site(1)
    sites = {hashing.DropoutSeeds(s).fold(i).site(j)
             for s in (5, 6) for i in range(4) for j in range(5)}
    assert len(sites) == 40                      # no collisions here
    assert hashing.fold(None, 2) is None


def test_keep_mask_rate():
    """Kept fraction of 12 x 512 x 512 attention probabilities at rate 0.1
    within 6 standard deviations of 0.9 (sqrt(0.09 / 3.1e6) = 1.7e-4)."""
    keep = hashing.keep_mask(77, torch.arange(12), 0.1, 512, 512, 3)
    assert abs(keep.float().mean().item() - 0.9) < 6 * 1.7e-4
