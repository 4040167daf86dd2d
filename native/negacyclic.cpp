// Host-side native kernels for rustfhe.
//
// The reference keeps its hot negacyclic multiplication in native code (the
// vendored spqlios f64 FFT: utils/src/spqlios/* of the reference).  On the
// device that role is played by the JAX engines; this native library is the
// *host-side* counterpart, written from scratch:
//   * an exact O(N^2) uint32 negacyclic convolution (independent oracle used
//     to cross-check the JAX oracles from outside the JAX stack),
//   * a radix-2 f64 negacyclic FFT multiply (the same capability class as
//     the reference's spqlios path: approximate, fast, host-only), built on
//     the classic psi-twist + cyclic FFT factorization of X^N + 1.
//
// C ABI, consumed from Python via ctypes (no pybind11 in this image).

#include <cmath>
#include <complex>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

using cplx = std::complex<double>;

// Iterative radix-2 Cooley-Tukey, in-place, n a power of two.
void fft_inplace(cplx* a, std::size_t n, bool inverse) {
  // bit-reversal permutation
  for (std::size_t i = 1, j = 0; i < n; ++i) {
    std::size_t bit = n >> 1;
    for (; j & bit; bit >>= 1) j ^= bit;
    j ^= bit;
    if (i < j) std::swap(a[i], a[j]);
  }
  for (std::size_t len = 2; len <= n; len <<= 1) {
    const double ang = (inverse ? 2.0 : -2.0) * M_PI / static_cast<double>(len);
    const cplx wlen(std::cos(ang), std::sin(ang));
    for (std::size_t i = 0; i < n; i += len) {
      cplx w(1.0, 0.0);
      for (std::size_t k = 0; k < len / 2; ++k) {
        const cplx u = a[i + k];
        const cplx v = a[i + k + len / 2] * w;
        a[i + k] = u + v;
        a[i + k + len / 2] = u - v;
        w *= wlen;
      }
    }
  }
  if (inverse) {
    const double inv = 1.0 / static_cast<double>(n);
    for (std::size_t i = 0; i < n; ++i) a[i] *= inv;
  }
}

}  // namespace

extern "C" {

// Exact negacyclic convolution mod 2^32: out = a (*) b over Z[X]/(X^N+1),
// a uint32 torus coefficients, b int32 small coefficients.
void negacyclic_mul_u32_exact(const uint32_t* a, const int32_t* b,
                              uint32_t* out, int64_t n) {
  for (int64_t k = 0; k < n; ++k) {
    uint32_t acc = 0;
    for (int64_t j = 0; j <= k; ++j)
      acc += a[j] * static_cast<uint32_t>(b[k - j]);
    for (int64_t j = k + 1; j < n; ++j)
      acc -= a[j] * static_cast<uint32_t>(b[n + k - j]);
    out[k] = acc;
  }
}

// Approximate negacyclic product of f64 polynomials via the psi-twisted FFT:
// c_k = psi^-k * IFFT( FFT(psi^j a_j) . FFT(psi^j b_j) )_k, psi = e^{i pi/N}.
// Returns 0 on success, -1 if n is not a power of two >= 2.
int negacyclic_mul_f64_fft(const double* a, const double* b, double* out,
                           int64_t n) {
  if (n < 2 || (n & (n - 1)) != 0) return -1;
  std::vector<cplx> fa(n), fb(n);
  const double step = M_PI / static_cast<double>(n);
  for (int64_t j = 0; j < n; ++j) {
    const cplx psi(std::cos(step * j), std::sin(step * j));
    fa[j] = psi * a[j];
    fb[j] = psi * b[j];
  }
  fft_inplace(fa.data(), n, false);
  fft_inplace(fb.data(), n, false);
  for (int64_t j = 0; j < n; ++j) fa[j] *= fb[j];
  fft_inplace(fa.data(), n, true);
  for (int64_t k = 0; k < n; ++k) {
    const cplx unpsi(std::cos(step * k), -std::sin(step * k));
    out[k] = (fa[k] * unpsi).real();
  }
  return 0;
}

// Torus variant mirroring the reference's usage (Torus32 x int -> Torus32
// through the float domain, fft_processor_spqlios.cpp:156-183 semantics):
// inputs are u32 torus values and small ints; output is rounded back mod 2^32.
int negacyclic_mul_torus_fft(const uint32_t* a, const int32_t* b,
                             uint32_t* out, int64_t n) {
  std::vector<double> fa(n), fb(n), fo(n);
  for (int64_t i = 0; i < n; ++i) {
    // centered lift keeps magnitudes ~2^31 -> f64 exact (53-bit mantissa)
    fa[i] = static_cast<double>(static_cast<int32_t>(a[i]));
    fb[i] = static_cast<double>(b[i]);
  }
  const int rc = negacyclic_mul_f64_fft(fa.data(), fb.data(), fo.data(), n);
  if (rc != 0) return rc;
  for (int64_t i = 0; i < n; ++i) {
    out[i] = static_cast<uint32_t>(static_cast<int64_t>(std::llround(fo[i])));
  }
  return 0;
}

// Circuit levelizer: the native scheduler piece.  Gates are given in any
// topological-consistent order; wires [0, n_inputs) are primary inputs.
// inputs: flattened gate inputs (3 per gate, -1 padding); outputs[g] is the
// gate's output wire.  Writes level[g] (1-based) and returns the depth.
int64_t levelize_circuit(int64_t n_gates, int64_t n_wires, int64_t n_inputs,
                         const int64_t* inputs, const int64_t* outputs,
                         int64_t* level_out) {
  std::vector<int64_t> wire_level(n_wires, 0);
  int64_t depth = 0;
  for (int64_t g = 0; g < n_gates; ++g) {
    int64_t lv = 0;
    for (int t = 0; t < 3; ++t) {
      const int64_t w = inputs[3 * g + t];
      if (w < 0) continue;
      if (w >= n_wires) return -1;
      if (wire_level[w] > lv) lv = wire_level[w];
    }
    lv += 1;
    const int64_t ow = outputs[g];
    if (ow < 0 || ow >= n_wires) return -1;
    wire_level[ow] = lv;
    level_out[g] = lv;
    if (lv > depth) depth = lv;
  }
  (void)n_inputs;
  return depth;
}

}  // extern "C"
