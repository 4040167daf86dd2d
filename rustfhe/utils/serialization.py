"""Key and ciphertext (de)serialization.

Deliberate new capability over the reference, which has none (SURVEY.md §5:
no serde, keys live only in process memory): secret keys, raw evaluation
keys and ciphertext batches round-trip through ``.npz`` files, enabling
cloud/client key separation and cross-implementation test vectors.

Raw (uint32) key material is stored, not engine-prepared forms, so files
are engine- and limb-layout-independent; the engine preparation is
recomputed on load.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np

from ..engine import get_engine
from ..keys import CloudKey, SecretKey
from ..params import TFHEParams

_PARAM_FIELDS = ("n", "N", "alpha_lv0", "alpha_lv1", "bgbit", "l", "iks_basebit", "iks_l")

MAGIC = "rustfhe"
VERSION = 1


def _params_header(params: TFHEParams) -> np.ndarray:
    meta = {"magic": MAGIC, "version": VERSION,
            "params": {f: getattr(params, f) for f in _PARAM_FIELDS}}
    return np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)


def _is_our_tag(magic) -> bool:
    # Releases under the package's former name wrote MAGIC with a suffix;
    # their files have the same layout, so they still load.
    return isinstance(magic, str) and (magic == MAGIC or magic.startswith(MAGIC + "_"))


def _parse_header(arr: np.ndarray) -> TFHEParams:
    meta = json.loads(bytes(arr.tobytes()).decode())
    if not _is_our_tag(meta.get("magic")):
        raise ValueError("not a rustfhe file")
    if meta.get("version") != VERSION:
        raise ValueError(f"unsupported version {meta.get('version')}")
    return TFHEParams(**meta["params"])


def save_secret_key(path: str, sk: SecretKey, params: TFHEParams) -> None:
    import os

    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    np.savez_compressed(
        path,
        header=_params_header(params),
        lv0=np.asarray(sk.lv0, np.uint32),
        lv1=np.asarray(sk.lv1, np.uint32),
    )
    # SECRET key material: owner-only, regardless of umask.
    real = path if path.endswith(".npz") else path + ".npz"
    os.chmod(real, 0o600)


def load_secret_key(path: str) -> tuple[SecretKey, TFHEParams]:
    with np.load(path) as z:
        params = _parse_header(z["header"])
        sk = SecretKey(lv0=jnp.asarray(z["lv0"]), lv1=jnp.asarray(z["lv1"]))
    return sk, params


def save_cloud_key_raw(path: str, bk_raw, ksk_raw, params: TFHEParams) -> None:
    """Store raw uint32 evaluation keys (engine-independent)."""
    np.savez_compressed(
        path,
        header=_params_header(params),
        bk=np.asarray(bk_raw, np.uint32),
        ksk=np.asarray(ksk_raw, np.uint32),
    )


def load_cloud_key(path: str, engine_name: str = "matmul") -> tuple[CloudKey, TFHEParams]:
    """Load raw evaluation keys and prepare them for ``engine_name``."""
    engine = get_engine(engine_name)
    with np.load(path) as z:
        params = _parse_header(z["header"])
        bk = engine.prepare_trgsw(jnp.asarray(z["bk"]), params)
        ksk = engine.prepare_ksk(jnp.asarray(z["ksk"]), params)
    return CloudKey(bk=bk, ksk=ksk), params


def cached_keys(prefix: str, key, params: TFHEParams,
                engine_name: str = "matmul", verbose: bool = False):
    """(SecretKey, CloudKey) with the raw key material cached on disk.

    First call generates keys and writes ``{prefix}.sk.npz`` +
    ``{prefix}.ck.npz``; later calls (same prefix, same params) load and
    only re-run the cheap engine preparation — so the keygen is paid once
    per machine, not once per run.  The cache is
    param-checked: a prefix holding keys for different parameters is
    regenerated, not misused.  The reference has no serialization at all
    (SURVEY.md §5) — this is that capability's payoff.
    """
    import os
    import time

    from .. import keys as _keys

    sk_path, ck_path = f"{prefix}.sk.npz", f"{prefix}.ck.npz"
    if os.path.exists(sk_path) and os.path.exists(ck_path):
        try:
            t0 = time.time()
            sk, p_sk = load_secret_key(sk_path)
            ck, p_ck = load_cloud_key(ck_path, engine_name)
            if p_sk == params and p_ck == params:
                if verbose:
                    print(f"loaded cached keys from {prefix}.*.npz in "
                          f"{time.time() - t0:.1f}s")
                return sk, ck
            if verbose:
                print(f"key cache {prefix} holds different params; regenerating")
        except Exception as exc:  # corrupt/stale cache: regenerate
            if verbose:
                print(f"key cache {prefix} unreadable ({exc}); regenerating")
    t0 = time.time()
    ks, kc = jax.random.split(key)
    sk = _keys.gen_secret_key(ks, params)
    bk_raw, ksk_raw = _keys.gen_cloud_key_raw(kc, sk, params, engine_name)
    save_secret_key(sk_path, sk, params)
    save_cloud_key_raw(ck_path, bk_raw, ksk_raw, params)
    engine = get_engine(engine_name)
    ck = CloudKey(
        bk=engine.prepare_trgsw(jnp.asarray(bk_raw), params),
        ksk=engine.prepare_ksk(jnp.asarray(ksk_raw), params),
    )
    if verbose:
        print(f"generated + cached keys at {prefix}.*.npz in "
              f"{time.time() - t0:.1f}s")
    return sk, ck


def save_ciphertexts(path: str, cts, params: TFHEParams) -> None:
    np.savez_compressed(path, header=_params_header(params), cts=np.asarray(cts, np.uint32))


def load_ciphertexts(path: str) -> tuple[jnp.ndarray, TFHEParams]:
    with np.load(path) as z:
        params = _parse_header(z["header"])
        cts = jnp.asarray(z["cts"])
    return cts, params


def save_seeded_ciphertexts(path: str, seeded, params: TFHEParams) -> None:
    """Store a seeded TLWE batch (tlwe.encrypt_binary_seeded): the file
    holds (seed (2,) uint32, bodies) — ~(n+1)x smaller than the expanded
    form ``save_ciphertexts`` writes (636x at the production n=635)."""
    seed, b = seeded
    np.savez_compressed(path, header=_params_header(params),
                        seed=np.asarray(seed, np.uint32),
                        body=np.asarray(b, np.uint32))


def load_seeded_ciphertexts(path: str) -> tuple[jnp.ndarray, TFHEParams]:
    """Load + EXPAND a seeded batch to full ``(..., n+1)`` ciphertexts
    (expansion is public — mask re-derivation from the stored seed)."""
    from .. import tlwe

    with np.load(path) as z:
        params = _parse_header(z["header"])
        cts = tlwe.expand_seeded(z["seed"], z["body"], params.n)
    return cts, params
