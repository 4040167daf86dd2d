"""Transform-domain engine tests: the exact Nussbaumer/incomplete-NTT
external product (engine/transform.py) vs the oracle, and its degree-axis
sharded variant (parallel/degree_sharded.py) on the virtual 8-device mesh
— reduce-scatter collectives between transform stages, bit-exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rustfhe.engine import get_engine
from rustfhe.params import TFHEParams

U32 = jnp.uint32


def _vectors(params, batch, seed):
    rs = np.random.RandomState(seed)
    rows = jnp.asarray(
        rs.randint(0, 2**32, size=(2 * params.l, 2, params.N), dtype=np.uint64).astype(
            np.uint32
        )
    )
    digits = jnp.asarray(
        rs.randint(
            -params.half_bg, params.half_bg, size=(batch, 2 * params.l, params.N)
        ).astype(np.int32)
    )
    return rows, digits


@pytest.mark.parametrize("N", [64, 256])
def test_nuss_engine_exact_vs_oracle(N):
    params = TFHEParams(n=16, N=N)
    rows, digits = _vectors(params, 3, 101)
    oracle = get_engine("oracle")
    want = oracle.external_product_digits(oracle.prepare_trgsw(rows, params), digits, params)
    eng = get_engine("nuss")
    got = eng.external_product_digits(eng.prepare_trgsw(rows, params), digits, params)
    assert np.array_equal(np.asarray(got), np.asarray(want))


def test_nuss_engine_adversarial_probe_vectors():
    # The transform pipeline must survive the same adversarial probe set
    # the fast engines are gated on (limb/carry edges, digit extremes).
    from rustfhe.engine import engine_exact_on_probe, probe_vectors

    params = TFHEParams(n=16, N=64)
    rows, digits = probe_vectors(params)
    rows_j, digits_j = jnp.asarray(rows), jnp.asarray(digits)
    oracle = get_engine("oracle")
    want = oracle.external_product_digits(
        oracle.prepare_trgsw(rows_j, params), digits_j, params
    )
    assert engine_exact_on_probe(get_engine("nuss"), params, rows_j, digits_j, want)


@pytest.mark.parametrize("model", [2, 4, 8])
def test_degree_sharded_bit_exact(model):
    # N sharded over `model` devices: psum_scatter between transform stages
    # must reproduce the unsharded engine bit-for-bit.
    from rustfhe.parallel.degree_sharded import (
        degree_sharded_external_product_fn,
        shard_transform_panels,
    )
    from rustfhe.parallel.mesh import make_mesh

    params = TFHEParams(n=16, N=64)
    rows, digits = _vectors(params, 4, 202)
    eng = get_engine("nuss")
    panels = eng.prepare_trgsw(rows, params)
    want = eng.external_product_digits(panels, digits, params)
    # Guard against engine+sharded sharing a bug: cross-check vs the oracle.
    oracle = get_engine("oracle")
    want_o = oracle.external_product_digits(
        oracle.prepare_trgsw(rows, params), digits, params
    )
    assert np.array_equal(np.asarray(want), np.asarray(want_o))

    mesh = make_mesh(data=8 // model, model=model)
    fn = degree_sharded_external_product_fn(mesh, params, axis="model")
    panels_sh = shard_transform_panels(panels, mesh, axis="model")
    got = fn(panels_sh, digits)
    assert np.array_equal(np.asarray(got), np.asarray(want))


def test_degree_sharded_rank_generality():
    # The shard_map is built per input rank: unbatched (2L, N) digits and a
    # two-lead-axis batch must both work and agree with the unsharded engine.
    from rustfhe.parallel.degree_sharded import (
        degree_sharded_external_product_fn,
        shard_transform_panels,
    )
    from rustfhe.parallel.mesh import make_mesh

    params = TFHEParams(n=16, N=64)
    rows, digits = _vectors(params, 6, 303)  # digits (6, 2L, N)
    eng = get_engine("nuss")
    panels = eng.prepare_trgsw(rows, params)
    want = np.asarray(eng.external_product_digits(panels, digits, params))

    mesh = make_mesh(data=4, model=2)
    fn = degree_sharded_external_product_fn(mesh, params, axis="model")
    panels_sh = shard_transform_panels(panels, mesh, axis="model")
    # unbatched: (2L, N) -> (2, N)
    got0 = np.asarray(fn(panels_sh, digits[0]))
    assert np.array_equal(got0, want[0])
    # two leading axes: (2, 3, 2L, N) -> (2, 3, 2, N)
    d2 = jnp.reshape(digits, (2, 3) + digits.shape[1:])
    got2 = np.asarray(fn(panels_sh, d2))
    assert np.array_equal(got2, want.reshape(2, 3, *want.shape[1:]))
