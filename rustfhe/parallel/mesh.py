"""Device-mesh helpers.

The scale-out design (SURVEY.md §2.6/§5): the reference is single-threaded
and single-process; parallelism here is first-class and mesh-native.

Axes:
  * ``data``  — the gate batch (pure data parallelism: gate bootstrapping is
    embarrassingly parallel across ciphertexts; this is the throughput axis).
  * ``model`` — key-switch table rows (the N*iks_l*T accumulation is sharded
    and reduced with ``psum`` — the collective-demonstrating axis).

``make_mesh`` lays ``jax.devices()`` out in order, with no torus assumption:
the cards of one GPU host reach each other all to all over NVLink.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(data: int | None = None, model: int = 1, devices=None) -> Mesh:
    """Create a (data, model) mesh.  Defaults to all devices on `data`."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if data is None:
        assert n % model == 0, (n, model)
        data = n // model
    assert data * model <= n, (data, model, n)
    dev = np.asarray(devices[: data * model]).reshape(data, model)
    return Mesh(dev, axis_names=("data", "model"))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P("data"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
