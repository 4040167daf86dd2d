"""Parameter-sweep coverage (BASELINE.json config 5): the framework must
work at N=2048 and at varying gadget levels, not just the default set."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rustfhe import gates, keys, tlwe
from rustfhe.params import TFHEParams

U32 = jnp.uint32


@pytest.mark.parametrize(
    "p",
    [
        # N=2048 (nbit 11), tiny n for CPU speed
        TFHEParams(n=8, N=128, alpha_lv0=2.0**-20, alpha_lv1=2.0**-28),
        # different gadget levels: l=2, bgbit=8
        TFHEParams(n=12, N=64, alpha_lv0=2.0**-20, alpha_lv1=2.0**-28, bgbit=8, l=2),
        # iks variations: basebit 4, 4 levels
        TFHEParams(n=12, N=64, alpha_lv0=2.0**-20, alpha_lv1=2.0**-28, iks_basebit=4, iks_l=4),
        # the FAST preset's gadget shape at production noise levels
        TFHEParams(n=64, N=256, bgbit=8, l=2),
    ],
)
def test_nand_truth_table_across_params(p):
    key = jax.random.PRNGKey(13)
    kg, ke = jax.random.split(key)
    sk, ck = keys.gen_keys(kg, p, engine_name="matmul")
    xs = jnp.array([0, 1, 0, 1], U32)
    ys = jnp.array([0, 0, 1, 1], U32)
    k1, k2 = jax.random.split(ke)
    cx = tlwe.encrypt_binary(k1, sk.lv0, xs, p)
    cy = tlwe.encrypt_binary(k2, sk.lv0, ys, p)
    out = gates.hom_nand(ck, cx, cy, params=p, engine_name="matmul")
    dec = list(np.asarray(tlwe.decrypt_binary(out, sk.lv0)))
    assert dec == [1, 1, 1, 0], (p, dec)


def test_default_params_match_reference():
    # SURVEY.md §2.5 compatibility contract.
    from rustfhe.params import DEFAULT_PARAMS as d

    assert d.n == 635
    assert d.N == 1024 and d.nbit == 10
    assert d.bgbit == 6 and d.l == 3
    assert d.iks_basebit == 2 and d.iks_l == 8 and d.iks_t == 4
    assert d.alpha_lv0 == 2.0**-15 and d.alpha_lv1 == 2.0**-25
    assert d.mu == 1 << 29
