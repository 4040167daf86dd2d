"""rustfhe — a JAX TFHE gate-bootstrapping framework.

A from-scratch JAX/XLA re-design of the capabilities of hideki1217/rusTfhe
(TLWE/TRLWE/TRGSW, external product, CMux, blind rotation, sample
extraction, identity key switching, bootstrapped homomorphic gates, and the
`nander` logic-expression evaluator), built batch-first for accelerators:
exact arithmetic mod 2^32, integer-matmul and f64-FFT convolution engines,
one jit region per gate batch, and mesh sharding for scale-out.
"""

from .params import (TFHEParams, DEFAULT_PARAMS, TEST_PARAMS, N2048_PARAMS,
                     PBS_PARAMS, PBS_TEST_PARAMS)
from .keys import SecretKey, CloudKey, gen_keys, gen_secret_key, gen_cloud_key
from .engine import get_engine, register_engine
from . import torus, tlwe, trlwe, trgsw, decomp, poly, bootstrap, gates, pbs
from . import radix
from .context import TFHE
from .ints import FheUint, FheInt
from .radix import RadixUint, RadixInt

__version__ = "0.2.0"

__all__ = [
    "TFHEParams",
    "DEFAULT_PARAMS",
    "TEST_PARAMS",
    "N2048_PARAMS",
    "PBS_PARAMS",
    "PBS_TEST_PARAMS",
    "SecretKey",
    "CloudKey",
    "gen_keys",
    "gen_secret_key",
    "gen_cloud_key",
    "get_engine",
    "register_engine",
    "TFHE",
    "FheUint",
    "FheInt",
    "RadixUint",
    "RadixInt",
    "radix",
    "torus",
    "tlwe",
    "trlwe",
    "trgsw",
    "decomp",
    "poly",
    "bootstrap",
    "gates",
    "pbs",
]
