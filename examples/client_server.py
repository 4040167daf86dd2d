"""Client/server key-exchange flows: public-key + seeded-ciphertext demo.

Three parties, three round-5 capabilities the reference (secret-key only,
no serialization) does not have:

  * ALICE holds the secret key.  She publishes a PUBLIC KEY (Regev
    zero-encryption subset-sum, ``TFHE.make_public_key``) and the cloud
    key, and keeps the secret key private.
  * BOB has no secret material.  He encrypts his input under the public
    key (``encrypt_public``) — randomized, decrypts only for Alice.
  * Alice's own upload travels SEEDED (``encrypt_seeded``): (seed, body),
    ~(n+1)x smaller on the wire, expanded publicly by the server.
  * The SERVER (a cloud-only context: no secret key) expands the seeded
    upload and computes gates over both parties' ciphertexts.
  * Alice decrypts the result.

Every step is asserted.  Runs wherever JAX's default device is
(``JAX_PLATFORMS=cpu`` keeps it on the CPU).  Usage:
python examples/client_server.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import rustfhe as rf  # noqa: E402


def main():
    params = rf.TEST_PARAMS if jax.default_backend() == "cpu" else rf.DEFAULT_PARAMS
    print(f"params: n={params.n}, N={params.N} ({jax.default_backend()})")

    # --- Alice: keygen; publish (public key, cloud key), keep sk. -------
    alice = rf.TFHE.new(jax.random.PRNGKey(2026), params)
    pk = alice.make_public_key()
    server = alice.cloud_only()  # what the server receives: NO secret key
    print(f"public key: {pk.shape[0]} zero-encryptions "
          f"({pk.nbytes / 1e6:.1f} MB); cloud key published")

    # --- Bob (keyless): public-key encryption of his bits. -------------
    bob_bits = jnp.asarray([0, 1, 1, 0], jnp.uint32)
    bob_cts = server.encrypt_public(pk, bob_bits, key=jax.random.PRNGKey(7))
    print("bob encrypted under pk (no secret material)")

    # --- Alice: seeded upload, (n+1)x smaller than full ciphertexts. ---
    alice_bits = jnp.asarray([0, 0, 1, 1], jnp.uint32)
    seed, body = alice.encrypt_seeded(alice_bits)
    full_words = int(np.prod(body.shape)) * (params.n + 1)
    sent_words = int(seed.size + body.size)
    print(f"alice's upload: {sent_words} words seeded vs {full_words} full "
          f"({full_words / sent_words:.0f}x smaller)")

    # --- Server: expand + compute (still keyless). ----------------------
    alice_cts = server.expand_seeded((seed, body))
    out_nand = server.nand(bob_cts, alice_cts)
    out_xor = server.xor(bob_cts, alice_cts)

    # --- Alice: decrypt + verify. ---------------------------------------
    got_nand = np.asarray(alice.decrypt(out_nand))
    got_xor = np.asarray(alice.decrypt(out_xor))
    want_nand = 1 - (np.asarray(bob_bits) & np.asarray(alice_bits))
    want_xor = np.asarray(bob_bits) ^ np.asarray(alice_bits)
    assert np.array_equal(got_nand, want_nand), (got_nand, want_nand)
    assert np.array_equal(got_xor, want_xor), (got_xor, want_xor)
    print(f"server computed NAND={got_nand.tolist()} XOR={got_xor.tolist()} "
          "— both decode correctly; server never saw a secret key")


if __name__ == "__main__":
    main()
