"""Probe: identity key-switch variants (the B x 24576 x 2544 int8
contraction after every blind rotation).

Variants (all exact; asserted vs the production path before timing):
  current     decompose + fused onehot-in-dot (MatmulEngine.key_switch_digits)
  dot_only    prebuilt one-hot operand, dot alone (materialization floor)
  build_only  decompose + one-hot build, no dot (VPU/IO mass)
  masks3      three (B, N*L) mask dots against per-t KSK slices, summed
  chunked4    contraction split into 4 row chunks (XLA pipelining shape)
  bf16        one-hot dot in bf16/f32-acc (exact: |sum| <= 8192*2^7 < 2^24)

Timing is CHAINED (output feeds the next input), so no call can be skipped.
Usage: python benches/keyswitch_probe.py [B]
"""

import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, ".")

from rustfhe import keys, tlwe  # noqa: E402
from rustfhe.bootstrap import identity_key_switch  # noqa: E402
from rustfhe.decomp import decompose_unsigned  # noqa: E402
from rustfhe.engine import get_engine  # noqa: E402
from rustfhe.params import DEFAULT_PARAMS as P  # noqa: E402

I8, I32, U32 = jnp.int8, jnp.int32, jnp.uint32
B = int(sys.argv[1]) if len(sys.argv) > 1 else 8192
ROUNDS = 8
NSLOT = P.iks_t - 1
Q = P.N * P.iks_l * NSLOT
COLS_MACS = B * Q * (P.n + 1) * 4  # int8 MACs per key switch


def onehot_of(digits):
    d = digits.astype(I32)  # (..., N, L)
    t = jnp.arange(1, P.iks_t, dtype=I32)
    oh = (d[..., None] == t).astype(I8)
    return oh.reshape(oh.shape[:-3] + (Q,))


def chain(name, fn, x0):
    """fn: (B, N+1) uint32 -> (B, n+1) uint32; chained via tiling back up."""
    reps = (P.N + 1 + P.n) // (P.n + 1)

    @jax.jit
    def run(ct):
        def body(i, s):
            out = fn(s)  # (B, n+1)
            nxt = jnp.tile(out, (1, reps))[:, : P.N + 1]
            return (nxt + U32(i)).astype(U32)

        return jax.lax.fori_loop(0, ROUNDS, body, ct)

    try:
        jax.block_until_ready(run(x0))
    except Exception as e:
        print(f"{name:14s} FAILED: {type(e).__name__}: {str(e)[:140]}", flush=True)
        return
    t0 = time.perf_counter()
    y = x0
    for _ in range(3):
        y = (run(y) + U32(1)).astype(U32)
    jax.block_until_ready(y)
    dt = (time.perf_counter() - t0) / (3 * ROUNDS)
    print(
        f"{name:14s} {dt*1e3:9.3f} ms/switch   {COLS_MACS/dt/1e12:6.1f} TMAC/s",
        flush=True,
    )


def main():
    rs = np.random.RandomState(11)
    print(f"# device: {jax.devices()[0]}  B={B}  Q={Q}", flush=True)
    eng = get_engine("matmul")
    kg = jax.random.PRNGKey(9)
    sk, ck = keys.gen_keys(kg, P, engine_name="matmul")
    prepared = ck.ksk  # (Q, (n+1)*K) int8
    K = eng.num_limbs

    ct = jnp.asarray(
        rs.randint(0, 2**32, size=(B, P.N + 1), dtype=np.uint64).astype(np.uint32)
    )

    def recombine(out_i32):
        out = out_i32.reshape(out_i32.shape[:-1] + (P.n + 1, K))
        u = out.astype(U32)
        acc = jnp.zeros(out.shape[:-1], U32)
        for k in range(K):
            acc = acc + (u[..., k] << U32(eng.limb_bits * k))
        return acc

    def current(c):
        return identity_key_switch(c, prepared, P, eng)

    def finish(c, contrib):
        return (tlwe.trivial(tlwe.body(c), P.n) - contrib).astype(U32)

    def masks3(c):
        a = tlwe.mask(c)
        d = decompose_unsigned(a, P).astype(I32).reshape(c.shape[0], P.N * P.iks_l)
        ks3 = prepared.reshape(P.N * P.iks_l, NSLOT, -1)
        contrib = jnp.zeros((c.shape[0], (P.n + 1) * K), I32)
        for t in range(1, P.iks_t):
            m = (d == t).astype(I8)
            contrib = contrib + jnp.dot(m, ks3[:, t - 1], preferred_element_type=I32)
        return finish(c, recombine(contrib))

    def chunked4(c):
        a = tlwe.mask(c)
        oh = onehot_of(decompose_unsigned(a, P))
        step = Q // 4
        contrib = jnp.zeros((c.shape[0], (P.n + 1) * K), I32)
        for j in range(4):
            contrib = contrib + jnp.dot(
                oh[:, j * step : (j + 1) * step],
                prepared[j * step : (j + 1) * step],
                preferred_element_type=I32,
            )
        return finish(c, recombine(contrib))

    def bf16(c):
        a = tlwe.mask(c)
        oh = onehot_of(decompose_unsigned(a, P))
        contrib = jnp.dot(
            oh.astype(jnp.bfloat16),
            prepared.astype(jnp.bfloat16),
            preferred_element_type=jnp.float32,
        ).astype(I32)
        return finish(c, recombine(contrib))

    # exactness of every variant vs the production path (small sample)
    small = ct[:64]
    want = np.asarray(current(small))
    for name, fn in [("masks3", masks3), ("chunked4", chunked4), ("bf16", bf16)]:
        got = np.asarray(fn(small))
        assert np.array_equal(got, want), f"{name} inexact"
    print("# exactness: masks3/chunked4/bf16 all bit-equal to production", flush=True)

    oh_pre = jax.block_until_ready(onehot_of(decompose_unsigned(tlwe.mask(ct), P)))

    def chain_dot_only(name, x0):
        # Isolate the contraction: the onehot rides the fori_loop CARRY and
        # each iteration flips one column from the previous output's parity,
        # so the dot is loop-VARIANT (no hoist/CSE) while the update is an
        # in-place one-column dynamic-update-slice of the carried buffer —
        # no full copy of the ~200 MB operand inside the timed region (a
        # functional .at[].set of the closure constant would force one and
        # inflate the reported floor).
        reps = (P.N + 1 + P.n) // (P.n + 1)

        @jax.jit
        def run(ct0):
            def body(i, state):
                c, oh = state
                contrib = jnp.dot(oh, prepared, preferred_element_type=I32)
                out = finish(c, recombine(contrib))
                parity = (out[:, 0] & U32(1)).astype(I8)
                oh2 = oh.at[:, 0].set(oh[:, 0] ^ parity)
                nxt = jnp.tile(out, (1, reps))[:, : P.N + 1]
                return ((nxt + U32(i)).astype(U32), oh2)

            return jax.lax.fori_loop(0, ROUNDS, body, (ct0, oh_pre))[0]

        jax.block_until_ready(run(x0))
        t0 = time.perf_counter()
        y = x0
        for _ in range(3):
            y = (run(y) + U32(1)).astype(U32)
        jax.block_until_ready(y)
        dt = (time.perf_counter() - t0) / (3 * ROUNDS)
        print(
            f"{name:14s} {dt*1e3:9.3f} ms/switch   {COLS_MACS/dt/1e12:6.1f} TMAC/s",
            flush=True,
        )

    def build_only(c):
        a = tlwe.mask(c)
        oh = onehot_of(decompose_unsigned(a, P))
        # reduce to (B, n+1) cheaply without the big dot; Q/128 = 192 sums
        # tile up to width n+1 (shape plumbing only — the point is that
        # every onehot byte is produced and touched).
        s = jnp.sum(oh.reshape(c.shape[0], -1, 128).astype(I32), axis=-1)
        s = jnp.tile(s, (1, (P.n + 1) // s.shape[1] + 1))[:, : P.n + 1]
        return (tlwe.trivial(tlwe.body(c), P.n) - s.astype(U32)).astype(U32)

    chain("current", current, ct)
    chain_dot_only("dot_only", ct)
    chain("build_only", build_only, ct)
    chain("masks3", masks3, ct)
    chain("chunked4", chunked4, ct)
    chain("bf16", bf16, ct)


if __name__ == "__main__":
    main()
