"""Decode-asserted gate truth tables through one bootstrap batch.

The analogue of the reference's full truth-table bench
(``hom_nand/src/tfhe.rs:147-279``): NAND/AND/OR/XOR truth tables, NOT, and
MUX over all 8 input combinations, as segments of ONE mixed
pre-combination batch through ``gates.hom_bootstrap`` — every gate formula
differs only in its linear pre-combination, so one compiled program per
batch shape checks them all.  ``bench.py`` and ``chip_smoke.py`` run it on
the device before anything is timed.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from . import gates, tlwe

U32 = jnp.uint32

_PLAIN = {
    "nand": lambda x, y: 1 - (x & y),
    "and": lambda x, y: x & y,
    "or": lambda x, y: x | y,
    "xor": lambda x, y: x ^ y,
    "not": lambda x, y: 1 - x,
}


def check_gate_batch(ck, sk_lv0, params, engine_name, batch: int, key,
                     log=print) -> dict:
    """Bootstrap a ``batch``-row mixed batch and assert every decode.

    Seven segments of ``max(64, batch // 8)`` rows (nand, and, or, xor,
    not, and the two first-pass MUX lanes), padded with NAND rows to
    ``batch``; the MUX second pass (OR of the two lanes) is a second
    bootstrap of the same shape.  Returns ``{"segment": seg_w,
    "batch": b0}``; raises AssertionError on any wrong output.
    """
    seg_w = max(64, batch // 8)

    def encrypt(bits, salt):
        return tlwe.encrypt_binary(jax.random.fold_in(key, salt), sk_lv0,
                                   jnp.asarray(bits, U32), params)

    def pre_of(op, cx, cy):
        return gates.precombine(op, cx, cy, params=params)

    def boot(pre):
        return jax.block_until_ready(
            gates.hom_bootstrap(ck, pre, params=params, engine_name=engine_name))

    segs = []  # (op, bits_x, bits_y, pre)
    salt = 0
    for op in ("nand", "and", "or", "xor"):
        bx = np.tile([0, 1, 0, 1], seg_w // 4 + 1)[:seg_w].astype(np.uint32)
        by = np.tile([0, 0, 1, 1], seg_w // 4 + 1)[:seg_w].astype(np.uint32)
        segs.append((op, bx, by, pre_of(op, encrypt(bx, salt), encrypt(by, salt + 1))))
        salt += 2
    bx = np.tile([0, 1], seg_w // 2 + 1)[:seg_w].astype(np.uint32)
    cxn = encrypt(bx, salt)
    salt += 1
    segs.append(("not", bx, bx, pre_of("not", cxn, cxn)))
    combos = np.array([[c, a, b] for c in (0, 1) for a in (0, 1) for b in (0, 1)])
    mx = np.tile(combos, (seg_w // 8 + 1, 1))[:seg_w]
    c_ct, i0_ct, i1_ct = (encrypt(mx[:, i], salt + i) for i in range(3))
    segs.append(("mux_a", mx[:, 0], mx[:, 2], pre_of("and", c_ct, i1_ct)))
    segs.append(("mux_b", mx[:, 0], mx[:, 1], pre_of("andn", c_ct, i0_ct)))

    total = len(segs) * seg_w
    b0 = max(batch, total)
    pre = jnp.concatenate([s[3] for s in segs], axis=0)
    if total < b0:  # pad with NAND rows so the shape is the requested batch
        pad = jnp.tile(segs[0][3], ((b0 - total) // seg_w + 1, 1))[: b0 - total]
        pre = jnp.concatenate([pre, pad])
    out = boot(pre)
    dec = np.asarray(tlwe.decrypt_binary(out, sk_lv0))
    lanes = {}
    for i, (op, bx, by, _) in enumerate(segs):
        lanes[op] = out[i * seg_w:(i + 1) * seg_w]
        if op in _PLAIN:
            bad = int((dec[i * seg_w:(i + 1) * seg_w] != _PLAIN[op](bx, by)).sum())
            assert bad == 0, f"{op}: {bad}/{seg_w} wrong outputs"
            log(f"# correctness[{op}]: {seg_w}/{seg_w} outputs decode correctly")
    pre_or = pre_of("or", lanes["mux_a"], lanes["mux_b"])
    out2 = boot(jnp.tile(pre_or, (b0 // seg_w + 1, 1))[:b0])
    dec2 = np.asarray(tlwe.decrypt_binary(out2[:seg_w], sk_lv0))
    bad = int((dec2 != np.where(mx[:, 0] == 1, mx[:, 2], mx[:, 1])).sum())
    assert bad == 0, f"mux: {bad}/{seg_w} wrong outputs"
    log(f"# correctness[mux]: {seg_w}/{seg_w} outputs decode correctly (all 8 combos)")
    return {"segment": seg_w, "batch": b0}
