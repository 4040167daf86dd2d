"""Public-key encryption (Regev zero-encryption subset-sum): keyless
encryption decrypts and computes correctly; TFHE-rs CompactPublicKey
capability beyond the secret-key-only reference (tlwe.rs:213-228)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rustfhe import tlwe
from rustfhe.context import TFHE
from rustfhe.params import TEST_PARAMS


@pytest.fixture(scope="module")
def ctx():
    return TFHE.new(jax.random.PRNGKey(21), TEST_PARAMS, "matmul")


def test_public_encrypt_decrypts(ctx):
    pk = ctx.make_public_key()
    assert pk.shape == (2 * (TEST_PARAMS.n + 1), TEST_PARAMS.n + 1)
    bits = jnp.asarray(np.random.RandomState(0).randint(0, 2, 64), jnp.uint32)
    # A KEYLESS party encrypts: cloud-only context + explicit PRNG key.
    cloud = ctx.cloud_only()
    cts = cloud.encrypt_public(pk, bits, key=jax.random.PRNGKey(99))
    assert np.array_equal(np.asarray(ctx.decrypt(cts)), np.asarray(bits))


def test_public_encryptions_are_randomized(ctx):
    pk = ctx.make_public_key()
    k = jax.random.PRNGKey(5)
    one = jnp.asarray([1], jnp.uint32)
    c1 = tlwe.encrypt_binary_public(jax.random.fold_in(k, 0), pk, one,
                                    TEST_PARAMS)
    c2 = tlwe.encrypt_binary_public(jax.random.fold_in(k, 1), pk, one,
                                    TEST_PARAMS)
    assert not np.array_equal(np.asarray(c1), np.asarray(c2))
    for c in (c1, c2):
        assert np.array_equal(np.asarray(ctx.decrypt(c)), [1])


def test_gates_on_public_ciphertexts(ctx):
    pk = ctx.make_public_key()
    x_bits = jnp.asarray([0, 1, 0, 1], jnp.uint32)
    y_bits = jnp.asarray([0, 0, 1, 1], jnp.uint32)
    x = ctx.encrypt_public(pk, x_bits)
    y = ctx.encrypt_public(pk, y_bits)
    assert np.array_equal(np.asarray(ctx.decrypt(ctx.nand(x, y))), [1, 1, 1, 0])
    assert np.array_equal(np.asarray(ctx.decrypt(ctx.xor(x, y))), [0, 1, 1, 0])


def test_cloud_only_cannot_make_public_key(ctx):
    with pytest.raises(ValueError, match="cloud-only"):
        ctx.cloud_only().make_public_key()


def test_fheuint_public_encryption(ctx):
    """Keyless typed-integer encryption: a cloud-only party encrypts
    integers under the public key; the key holder decrypts them."""
    from rustfhe.ints import FheUint

    pk = ctx.make_public_key()
    vals = np.array([9, 200, 0], np.uint64)
    a = FheUint.encrypt_public(ctx.cloud_only(), pk, vals, 8,
                               key=jax.random.PRNGKey(31))
    assert np.array_equal(np.asarray(FheUint(ctx, a.bits).decrypt()), vals)


def test_client_server_example_runs():
    """The three-party example (examples/client_server.py) must keep
    working: subprocess run, asserts internally, checks the closing line."""
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parents[1]
    out = subprocess.run(
        [sys.executable, str(root / "examples" / "client_server.py")],
        capture_output=True, text=True, timeout=300, cwd=str(root))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "both decode correctly" in out.stdout
