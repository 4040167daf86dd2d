"""Multi-host scale-out: the N-host gate-evaluation session.

The reference has no distributed story at all (SURVEY.md §2.6).  Here the
N-host path is standard JAX SPMD: ``jax.distributed.initialize`` forms the
global runtime, the mesh spans all hosts' devices, and the same shard_map
gate programs run unchanged — gate batches partitioned over ``data``;
bootstrapping keys are replicated per device (62 MB at default parameters
in the matmul engine's int8 limb form).

What this module adds over "call jax yourself":

* ``GateSession`` — the whole lifecycle: join the runtime, build the global
  mesh, generate keys DETERMINISTICALLY (every host derives identical key
  material from the shared seed, so no key broadcast is needed — a direct
  payoff of counter-based jax.random keygen, which the reference's
  thread_rng could never do), place them, and expose the six sharded gates.
* host-local input/output plumbing: each host contributes only its own
  slice of the gate batch (``feed``), and reads back only its own outputs
  (``fetch``) — no host ever materializes the global batch.

Every piece is exercised single-process by tests/test_sharding.py (the
process-local path degenerates to the full batch); the multi-process path
adds only ``jax.distributed.initialize``, which has no single-host analogue
to test against.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..keys import CloudKey, gen_keys
from ..params import TFHEParams
from .sharded import shard_cloud_key, sharded_gate_fn


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Join the multi-host runtime.

    Call once per process before any jax computation, with all three
    arguments (nothing on a plain GPU host tells JAX of a cluster);
    single-process runs may skip it entirely.
    """
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_gate_batch_size(per_device_batch: int) -> int:
    """Global batch across every device of every host."""
    return per_device_batch * jax.device_count()


def make_global_mesh(model: int = 1):
    """Mesh over ALL hosts' devices: ('data', 'model')."""
    from .mesh import make_mesh

    return make_mesh(model=model, devices=jax.devices())


class GateSession:
    """Multi-host (or single-host) sharded gate-evaluation session.

    >>> sess = GateSession(jax.random.PRNGKey(0), params)   # every host
    >>> cts  = sess.feed(local_ciphertexts)                 # host-local in
    >>> out  = sess.nand(cts_x, cts_y)
    >>> mine = sess.fetch(out)                              # host-local out
    """

    def __init__(self, key, params: TFHEParams, engine_name="matmul",
                 model: int = 1):
        self.params = params
        self.engine_name = engine_name
        self.mesh = make_global_mesh(model=model)
        # Deterministic keygen: all hosts compute identical key material
        # from the shared seed — replicated placement needs no broadcast.
        self.sk, ck = gen_keys(key, params, engine_name)
        self.ck: CloudKey = shard_cloud_key(ck, self.mesh)
        self._fns = {
            kind: sharded_gate_fn(self.mesh, params, engine_name, kind=kind)
            for kind in ("nand", "and", "or", "xor", "not", "mux")
        }
        self._bootstrap_fns: dict = {}
        # Deterministic per-session encryption key stream (see the
        # client-side convenience block below).
        self._enc_key = jax.random.fold_in(key, 0x454E43)

    # ------------------------- data plumbing -------------------------- #
    def feed(self, host_local_cts) -> jax.Array:
        """Host-local (B_local, n+1) uint32 -> global data-sharded array.

        The global batch is the concatenation of every process's local
        slice in process order; no host materializes it.
        """
        from jax.sharding import NamedSharding, PartitionSpec as P

        sharding = NamedSharding(self.mesh, P("data"))
        arr = np.asarray(host_local_cts)
        return jax.make_array_from_process_local_data(sharding, arr)

    def fetch(self, global_out) -> np.ndarray:
        """Global data-sharded output -> this host's local rows.

        Model-axis replication means several addressable shards cover the
        same batch rows — deduplicate by range before concatenating.  The
        data-sharded axis is DETECTED from the shards (gate outputs shard
        axis 0; bootstrap_raw outputs with leading gate-lane axes shard the
        batch axis -2), so a non-lead batch axis concatenates correctly
        instead of interleaving wrong rows; an output sharded on more than
        one axis fails loudly.
        """
        shards = list(global_out.addressable_shards)
        ndim = np.ndim(global_out)
        varying = [
            ax for ax in range(ndim)
            if len({s.index[ax].start or 0 for s in shards}) > 1
        ]
        if len(varying) > 1:
            raise ValueError(
                f"fetch expects an output sharded on one axis, got shards "
                f"varying on axes {varying} (shape {global_out.shape})"
            )
        ax = varying[0] if varying else 0
        dedup = {}
        for s in shards:
            dedup.setdefault(s.index[ax].start or 0, np.asarray(s.data))
        return np.concatenate([dedup[k] for k in sorted(dedup)], axis=ax)

    # --------------------------- gate set ----------------------------- #
    def _g(self, kind, *cts):
        return self._fns[kind](self.ck.bk, self.ck.ksk, *cts)

    def nand(self, x, y):
        return self._g("nand", x, y)

    def and_(self, x, y):
        return self._g("and", x, y)

    def or_(self, x, y):
        return self._g("or", x, y)

    def xor(self, x, y):
        return self._g("xor", x, y)

    def not_(self, x):
        return self._g("not", x)

    def mux(self, c, in0, in1):
        return self._g("mux", c, in0, in1)

    def bootstrap_raw(self, pre):
        """Bootstrap a pre-combined batch with the LAST axis pair
        (..., batch, n+1) where ``batch`` (the axis before the ciphertext
        axis... here: the trailing lead axis) is data-sharded.

        This is the hook apps/circuits.evaluate_encrypted uses, so the
        level-fused circuit evaluator runs mesh-sharded unchanged: wire
        gathers/scatters act on the replicated wire axis, each level's one
        fused bootstrap shards over ``data``.
        """
        from .sharded import sharded_bootstrap_fn

        ndim = jnp.ndim(pre)
        # shard the LEAD batch axis just before the ciphertext axis; any
        # outer axes (gate lanes) stay replicated.  Batches too small (or
        # uneven) for the data axis — e.g. a 1-2 gate circuit level in
        # unbatched evaluation — fall back to replicated compute rather
        # than tripping shard_map's divisibility check; a single unbatched
        # (n+1,) ciphertext (ndim=1) has no batch axis at all and is
        # likewise computed replicated.
        shard_batch = (
            ndim >= 2 and jnp.shape(pre)[-2] % self.mesh.shape["data"] == 0
        )
        cache_key = (ndim, shard_batch)
        if cache_key not in self._bootstrap_fns:
            self._bootstrap_fns[cache_key] = sharded_bootstrap_fn(
                self.mesh, self.params, self.engine_name,
                ndim=ndim, shard_batch=shard_batch,
            )
        return self._bootstrap_fns[cache_key](self.ck.bk, self.ck.ksk, pre)

    # --------------------- client-side convenience -------------------- #
    # These make GateSession a drop-in for the TFHE context wherever a
    # `ctx` is expected (apps/circuits.evaluate_encrypted, ints.FheUint):
    # every host derives the same deterministic key stream, so single-host
    # sessions work end-to-end; multi-host production clients encrypt under
    # their own key material and use feed/fetch instead.
    def encrypt(self, bits) -> jnp.ndarray:
        """Encrypt {0,1} bits under the session secret key."""
        from .. import tlwe as _tlwe

        self._enc_key, k = jax.random.split(self._enc_key)
        return _tlwe.encrypt_binary(k, self.sk.lv0, jnp.asarray(bits),
                                    self.params)

    def trivial(self, bits) -> jnp.ndarray:
        """Noiseless ciphertexts of constants (AsLogic, tlwe.rs:80-87)."""
        from .. import tlwe as _tlwe, torus as _torus

        return _tlwe.trivial(_torus.binary_to_torus(jnp.asarray(bits)),
                             self.params.n)

    def decrypt(self, cts) -> jnp.ndarray:
        """Decrypt a (fully addressable) ciphertext batch."""
        from .. import tlwe as _tlwe

        return _tlwe.decrypt_binary(jnp.asarray(cts), self.sk.lv0)

    def decrypt_local(self, global_out) -> np.ndarray:
        """Decrypt this host's shard (test/debug convenience)."""
        from .. import tlwe

        return np.asarray(
            tlwe.decrypt_binary(jnp.asarray(self.fetch(global_out)), self.sk.lv0)
        )
