"""Multi-host gate evaluation example.

One process per host; every process runs THIS script with its own
process_id.  The same script also runs single-process (no initialize call
needed), which is how tests/test_sharding.py exercises it.

  # host 0                                     # host k
  python examples/multihost_gates.py \\
      --coordinator=host0:1234 --nprocs=4 --pid=0     ... --pid=k

Key facts the session relies on:
  * keygen is DETERMINISTIC from the shared seed, so every host derives
    identical key material — there is no key broadcast;
  * each host feeds only its local slice of the gate batch and reads back
    only its own outputs (jax.make_array_from_process_local_data);
  * gate batches shard over `data` (pure DP — the throughput axis), the
    key-switch table over `model` with exact psum.
"""

import argparse
import sys

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, ".")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--nprocs", type=int, default=None)
    ap.add_argument("--pid", type=int, default=None)
    ap.add_argument("--batch-per-host", type=int, default=64)
    ap.add_argument("--test-params", action="store_true",
                    help="small parameter set (quick CPU demo)")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (virtual devices via "
                         "XLA_FLAGS=--xla_force_host_platform_device_count=K); "
                         "lets the multi-process path run on one machine")
    args = ap.parse_args()

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from rustfhe import tlwe
    from rustfhe.params import DEFAULT_PARAMS, TEST_PARAMS
    from rustfhe.parallel import multihost

    params = TEST_PARAMS if args.test_params else DEFAULT_PARAMS

    if args.coordinator is not None:
        multihost.initialize(args.coordinator, args.nprocs, args.pid)

    sess = multihost.GateSession(jax.random.PRNGKey(42), params)
    print(f"process {jax.process_index()}/{jax.process_count()}: "
          f"{jax.local_device_count()} local / {jax.device_count()} global devices")

    rs = np.random.RandomState(1000 + jax.process_index())
    bx = rs.randint(0, 2, size=args.batch_per_host).astype(np.uint32)
    by = rs.randint(0, 2, size=args.batch_per_host).astype(np.uint32)
    key = jax.random.fold_in(jax.random.PRNGKey(7), jax.process_index())
    k1, k2 = jax.random.split(key)
    cx = sess.feed(np.asarray(tlwe.encrypt_binary(k1, sess.sk.lv0, jnp.asarray(bx), params)))
    cy = sess.feed(np.asarray(tlwe.encrypt_binary(k2, sess.sk.lv0, jnp.asarray(by), params)))

    out = sess.nand(cx, cy)
    dec = sess.decrypt_local(out)
    expect = 1 - (bx & by)
    ok = np.array_equal(dec, expect)
    print(f"process {jax.process_index()}: {len(dec)} local NANDs, correct={ok}")
    assert ok


if __name__ == "__main__":
    main()
