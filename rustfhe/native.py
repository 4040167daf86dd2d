"""ctypes bindings for the native host library (``native/libnegacyclic.so``).

The native layer mirrors the *role* of the reference's C++/asm spqlios stack
(``utils/src/spqlios/*`` behind the Rust FFI in ``utils/src/spqlios.rs``):
fast host-side negacyclic polynomial arithmetic plus the circuit levelizer
(the native scheduler).  It is host-only; the device path never touches it.

Builds on demand with ``make -C native`` (g++); every entry point has a
pure-numpy fallback so the package works without a toolchain.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_LIB = None
_TRIED = False

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SO = os.path.join(_ROOT, "native", "libnegacyclic.so")


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if not os.path.exists(_SO):
        try:
            subprocess.run(
                ["make", "-C", os.path.join(_ROOT, "native")],
                check=True,
                capture_output=True,
                timeout=120,
            )
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        return None

    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")

    lib.negacyclic_mul_u32_exact.argtypes = [u32p, i32p, u32p, ctypes.c_int64]
    lib.negacyclic_mul_u32_exact.restype = None
    lib.negacyclic_mul_f64_fft.argtypes = [f64p, f64p, f64p, ctypes.c_int64]
    lib.negacyclic_mul_f64_fft.restype = ctypes.c_int
    lib.negacyclic_mul_torus_fft.argtypes = [u32p, i32p, u32p, ctypes.c_int64]
    lib.negacyclic_mul_torus_fft.restype = ctypes.c_int
    lib.levelize_circuit.argtypes = [
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int64,
        i64p,
        i64p,
        i64p,
    ]
    lib.levelize_circuit.restype = ctypes.c_int64
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def negacyclic_mul_u32_exact(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Exact uint32 negacyclic convolution (native, numpy fallback)."""
    a = np.ascontiguousarray(a, np.uint32)
    b = np.ascontiguousarray(b, np.int32)
    lib = _load()
    if lib is None:
        from .poly import negacyclic_mul_i64

        return (negacyclic_mul_i64(a.astype(np.int64), b) % (1 << 32)).astype(np.uint32)
    out = np.empty_like(a)
    lib.negacyclic_mul_u32_exact(a, b, out, a.shape[-1])
    return out


def negacyclic_mul_f64_fft(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """psi-twisted FFT negacyclic product of f64 polys (native, numpy fallback)."""
    a = np.ascontiguousarray(a, np.float64)
    b = np.ascontiguousarray(b, np.float64)
    n = a.shape[-1]
    lib = _load()
    if lib is None:
        psi = np.exp(1j * np.pi * np.arange(n) / n)
        fa = np.fft.fft(a * psi)
        fb = np.fft.fft(b * psi)
        return np.real(np.fft.ifft(fa * fb) * np.conj(psi))
    out = np.empty_like(a)
    rc = lib.negacyclic_mul_f64_fft(a, b, out, n)
    if rc != 0:
        raise ValueError(f"negacyclic_mul_f64_fft failed (n={n})")
    return out


def negacyclic_mul_torus_fft(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Approximate torus x int product via the f64 FFT path (spqlios analogue)."""
    a = np.ascontiguousarray(a, np.uint32)
    b = np.ascontiguousarray(b, np.int32)
    lib = _load()
    if lib is None:
        fa = a.astype(np.int32).astype(np.float64)
        fo = negacyclic_mul_f64_fft(fa, b.astype(np.float64))
        return np.round(fo).astype(np.int64).astype(np.uint32)
    out = np.empty_like(a)
    rc = lib.negacyclic_mul_torus_fft(a, b, out, a.shape[-1])
    if rc != 0:
        raise ValueError("negacyclic_mul_torus_fft failed")
    return out


def levelize(n_gates: int, n_wires: int, n_inputs: int,
             inputs3: np.ndarray, outputs: np.ndarray) -> tuple[np.ndarray, int]:
    """Native circuit levelization; returns (levels (1-based), depth)."""
    inputs3 = np.ascontiguousarray(inputs3, np.int64).reshape(-1)
    outputs = np.ascontiguousarray(outputs, np.int64)
    lib = _load()
    if lib is None:
        wire_level = np.zeros(n_wires, np.int64)
        levels = np.zeros(n_gates, np.int64)
        for g in range(n_gates):
            ws = [w for w in inputs3[3 * g : 3 * g + 3] if w >= 0]
            lv = 1 + (max(wire_level[w] for w in ws) if ws else 0)
            wire_level[outputs[g]] = lv
            levels[g] = lv
        return levels, int(levels.max(initial=0))
    levels = np.zeros(n_gates, np.int64)
    depth = lib.levelize_circuit(n_gates, n_wires, n_inputs, inputs3, outputs, levels)
    if depth < 0:
        raise ValueError("levelize_circuit: wire index out of range")
    return levels, int(depth)
