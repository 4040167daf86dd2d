"""High-level TFHE context: the user-facing object API.

The analogue of the reference's ``TFHE`` struct (``hom_nand/src/tfhe.rs:9-12``)
plus its ``Logip`` implementation (``nander/src/lib.rs:40-62``): owns the key
material and exposes encrypt/decrypt and the gate set, batched.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import gates, tlwe

from .keys import CloudKey, SecretKey, gen_keys
from .params import DEFAULT_PARAMS, TFHEParams

U32 = jnp.uint32

class TFHE:
    """Keyed TFHE evaluator.

    >>> ctx = TFHE.new(jax.random.PRNGKey(0), params)
    >>> c = ctx.encrypt(jnp.array([0, 1, 1, 0]))
    >>> out = ctx.nand(c, c)
    >>> bits = ctx.decrypt(out)
    """

    def __init__(self, sk: SecretKey | None, ck: CloudKey, params: TFHEParams, engine_name: str):
        self.sk = sk
        self.ck = ck
        self.params = params
        self.engine_name = engine_name
        self._enc_key = None

    @classmethod
    def new(cls, key, params: TFHEParams = DEFAULT_PARAMS, engine_name="matmul",
            keyfile: str | None = None) -> "TFHE":
        """``engine_name=None`` auto-selects the fastest exact engine for
        the device (on-device probe; see engine.select_fast_engine).
        ``keyfile``: path prefix for the on-disk raw-key cache
        (utils.serialization.cached_keys) — keygen runs once per machine
        instead of once per process; the second run loads in seconds."""
        if engine_name is None:
            from .engine import select_fast_engine

            engine_name = select_fast_engine(params)
        kg, ke = jax.random.split(key)
        if keyfile:
            from .utils.serialization import cached_keys

            sk, ck = cached_keys(keyfile, kg, params, engine_name,
                                 verbose=True)
        else:
            sk, ck = gen_keys(kg, params, engine_name)
        ctx = cls(sk, ck, params, engine_name)
        ctx._enc_key = ke
        return ctx

    # -------------------------- client side --------------------------- #
    def _next_key(self):
        if self._enc_key is None:
            raise ValueError("no encryption key available (cloud-only context)")
        self._enc_key, k = jax.random.split(self._enc_key)
        return k

    def encrypt(self, bits) -> jnp.ndarray:
        """bits: {0,1} array (...,) -> TLWE batch (..., n+1)."""
        if self.sk is None:
            raise ValueError("cloud-only context cannot encrypt")
        return tlwe.encrypt_binary(self._next_key(), self.sk.lv0, jnp.asarray(bits), self.params)

    def decrypt(self, cts) -> jnp.ndarray:
        if self.sk is None:
            raise ValueError("cloud-only context cannot decrypt")
        return tlwe.decrypt_binary(cts, self.sk.lv0)

    def encrypt_seeded(self, bits):
        """Compressed client->server form: ``(seed (2,) uint32, bodies)``,
        ~(n+1)x smaller than ``encrypt`` on the wire; any party (including
        a cloud-only context) expands with ``expand_seeded``.  Seeded and
        direct encryptions under the same PRNG key are bit-identical
        (tlwe.encrypt_binary_seeded)."""
        if self.sk is None:
            raise ValueError("cloud-only context cannot encrypt")
        return tlwe.encrypt_binary_seeded(
            self._next_key(), self.sk.lv0, jnp.asarray(bits), self.params)

    def expand_seeded(self, seeded) -> jnp.ndarray:
        """(seed, bodies) -> full TLWE batch; public, works cloud-only."""
        seed, b = seeded
        return tlwe.expand_seeded(seed, b, self.params.n)

    def make_public_key(self, rows: int | None = None) -> jnp.ndarray:
        """Publishable encryption key (M, n+1): zero-encryptions under the
        secret key.  Keyless parties then encrypt with
        ``encrypt_public`` / ``tlwe.encrypt_binary_public``."""
        if self.sk is None:
            raise ValueError("cloud-only context cannot derive a public key")
        return tlwe.gen_public_key(self._next_key(), self.sk.lv0,
                                   self.params, rows)

    def encrypt_public(self, pk, bits, key=None) -> jnp.ndarray:
        """Encrypt under a PUBLIC key — works on a cloud-only context (no
        secret material; pass an explicit PRNG ``key`` there)."""
        if key is None:
            key = self._next_key()
        return tlwe.encrypt_binary_public(key, pk, jnp.asarray(bits),
                                          self.params)

    def trivial(self, bits) -> jnp.ndarray:
        """Noiseless ciphertexts of constants (AsLogic, tlwe.rs:80-87)."""
        from . import torus

        return tlwe.trivial(torus.binary_to_torus(jnp.asarray(bits)), self.params.n)

    def cloud_only(self) -> "TFHE":
        """Drop the secret key: evaluator-side view."""
        return TFHE(None, self.ck, self.params, self.engine_name)

    # -------------------------- gate set ------------------------------ #
    # Every gate = eager linear pre-combination (gates.precombine) + the
    # SHARED hom_bootstrap program, so all six ops reuse one compiled
    # 635-step scan per batch shape (bit-identical to the per-op hom_*
    # wrappers, which each compile their own program; sharing one compile
    # matters for the REPL/circuit flows that mix ops at one shape).
    def _g(self, fn, *args):
        return fn(self.ck, *args, params=self.params, engine_name=self.engine_name)

    def _gate(self, op, x, y=None):
        return self._g(gates.hom_bootstrap, gates.precombine(op, x, y, params=self.params))

    def nand(self, x, y):
        return self._gate("nand", x, y)

    def and_(self, x, y):
        return self._gate("and", x, y)

    def or_(self, x, y):
        return self._gate("or", x, y)

    def xor(self, x, y):
        return self._gate("xor", x, y)

    def not_(self, x):
        return self._gate("not", x)

    def mux(self, control, in0, in1):
        """(in1 & control) | (in0 & !control): the two independent ANDs run
        as ONE double-width bootstrap batch, then one OR pass (tfhe.rs:27-40
        composition at two bootstrap passes of latency, not three)."""
        pre_a = gates.precombine("and", control, in1, params=self.params)
        pre_b = gates.precombine("andn", control, in0, params=self.params)
        both = self.bootstrap_raw(jnp.stack([pre_a, pre_b]))
        return self._gate("or", both[0], both[1])

    def bootstrap_raw(self, pre):
        """Bootstrap a pre-combined batch (for fused circuit levels)."""
        return self._g(gates.hom_bootstrap, pre)

    # ----------------------- typed integers --------------------------- #
    def encrypt_uint(self, values, width: int):
        """Encrypt unsigned integers -> batched ``FheUint`` (ints.py)."""
        from .ints import FheUint

        return FheUint.encrypt(self, values, width)

    def encrypt_sint(self, values, width: int):
        """Encrypt signed integers -> batched ``FheInt`` (two's complement)."""
        from .ints import FheInt

        return FheInt.encrypt(self, values, width)

    def trivial_uint(self, values, width: int):
        from .ints import FheUint

        return FheUint.trivial(self, values, width)

    def trivial_sint(self, values, width: int):
        from .ints import FheInt

        return FheInt.trivial(self, values, width)

    def int_to_uint(self, cts, space: int, *, unsafe: bool = False):
        """PBS-domain encrypted int -> FheUint bit planes, one bootstrap
        total (ints.from_pbs_int: multi-output PBS with raw ±mu tables).
        Raises when the calibrated (space, t) noise margin is below
        threshold unless ``unsafe=True``."""
        from .ints import from_pbs_int

        return from_pbs_int(self, cts, space, unsafe=unsafe)

    def encrypt_radix(self, values, ndigits: int):
        """Encrypt unsigned integers in RADIX form (radix.RadixUint: 2-bit
        PBS digits; adds cost one bootstrap LEVEL per digit instead of the
        bit-circuit's per-gate-level).  Use params.PBS_PARAMS."""
        from .radix import RadixUint

        return RadixUint.encrypt(self, values, ndigits)

    def trivial_radix(self, values, ndigits: int):
        from .radix import RadixUint

        return RadixUint.trivial(self, values, ndigits)

    def encrypt_radix_signed(self, values, ndigits: int):
        """Signed (two's complement) radix integers (radix.RadixInt)."""
        from .radix import RadixInt

        return RadixInt.encrypt(self, values, ndigits)

    # ------------------ programmable bootstrapping -------------------- #
    def encrypt_int(self, x, space: int):
        """Encrypt ints in [0, space) (padding-bit encoding; pbs.py)."""
        from . import pbs as _pbs

        if self.sk is None:
            raise ValueError("cloud-only context cannot encrypt")
        return _pbs.encrypt_int(self._next_key(), self.sk.lv0, x, space, self.params)

    def decrypt_int(self, cts, space: int):
        from . import pbs as _pbs

        if self.sk is None:
            raise ValueError("cloud-only context cannot decrypt")
        return _pbs.decrypt_int(cts, self.sk.lv0, space)

    def apply_lut(self, cts, table, space: int):
        """Programmable bootstrap: cts of x -> cts of table[x] (pbs.pbs).

        ``table``: (space,) ints, or (..., space) for a different function
        per batch row.  One bootstrap of cost; output noise is reset."""
        from . import pbs as _pbs

        return _pbs.pbs(self.ck, cts, jnp.asarray(table), space=space,
                        params=self.params, engine_name=self.engine_name)

    def apply_luts(self, cts, tables, space: int):
        """Multi-output PBS (pbs.pbs_many): ``tables (..., t, space)`` ->
        ``(..., t, n+1)``, all t lookups from ONE blind rotation."""
        from . import pbs as _pbs

        return _pbs.pbs_many(self.ck, cts, jnp.asarray(tables), space=space,
                             params=self.params, engine_name=self.engine_name)
