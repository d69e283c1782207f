// Host-side native kernels: determinant-space enumeration and ONV
// packing for large sectors.
//
// The reference generates FCI/CI spaces and ONV conversions in its
// C++ extension (get_special_space / tensor_to_onv, cpp_src/tensor/*).
// In this framework the *device* side is JAX/XLA, but host-side space
// generation for big (sorb, noa, nob) sectors (CI spaces, GFMC walker
// pools, checkpoint tooling) is loop-bound in Python — this small C
// library (loaded via ctypes; no pybind11) provides it natively.
//
// Build: g++ -O3 -shared -fPIC onv_tools.cpp -o libonvtools.so

#include <algorithm>
#include <cstdint>

namespace {

struct Rec {
  unsigned long long hi, lo;  // 128-bit interleaved determinant key
  long long ia, ib;           // channel-mask indices
};

// Morton-interleave x with zeros: bit i -> bit 2i (128-bit result).
inline void spread(unsigned long long x, unsigned long long& hi,
                   unsigned long long& lo) {
  lo = 0;
  hi = 0;
  for (int i = 0; i < 32; ++i) lo |= ((x >> i) & 1ull) << (2 * i);
  for (int i = 32; i < 64; ++i) hi |= ((x >> i) & 1ull) << (2 * (i - 32));
}

// Gosper's hack: next bit-permutation with the same popcount.
inline unsigned long long next_comb(unsigned long long v) {
  unsigned long long t = v | (v - 1);
  // -(~t) == t + 1 in two's complement
  return (t + 1) | ((((~t) & (t + 1)) - 1) >> (__builtin_ctzll(v) + 1));
}

}  // namespace

extern "C" {

long long n_choose_k(int n, int k) {
  if (k < 0 || k > n) return 0;
  long long r = 1;
  for (int i = 1; i <= k; ++i) {
    r = r * (n - k + i) / i;
    if (r < 0) return 0;
  }
  return r;
}

// All (noa, nob) determinants over norb spatial orbitals as unpacked
// int8 bits [n_det, 2*norb] (interleaved alpha/beta), ascending by the
// packed little-endian integer value — the exact order of
// utils/fci.fci_bits, so sorted-LUT consumers work unchanged.
// `out` must hold n_det * 2 * norb bytes.  Returns n_det, or -1.
long long fci_space_bits(int norb, int noa, int nob, signed char* out) {
  if (norb <= 0 || norb > 64 || noa < 0 || nob < 0 || noa > norb ||
      nob > norb)
    return -1;
  const long long na = n_choose_k(norb, noa);
  const long long nb = n_choose_k(norb, nob);
  if (na <= 0 || nb <= 0) return -1;
  const long long n = na * nb;
  const int sorb = 2 * norb;

  unsigned long long* amask = new unsigned long long[na];
  unsigned long long* bmask = new unsigned long long[nb];
  unsigned long long v = (noa == 0) ? 0ull : ((1ull << noa) - 1ull);
  for (long long i = 0; i < na; ++i) {
    amask[i] = v;
    if (i + 1 < na) v = next_comb(v);
  }
  v = (nob == 0) ? 0ull : ((1ull << nob) - 1ull);
  for (long long i = 0; i < nb; ++i) {
    bmask[i] = v;
    if (i + 1 < nb) v = next_comb(v);
  }

  Rec* recs = new Rec[n];
  long long idx = 0;
  for (long long ia = 0; ia < na; ++ia) {
    unsigned long long ahi, alo;
    spread(amask[ia], ahi, alo);
    for (long long ib = 0; ib < nb; ++ib) {
      unsigned long long bhi, blo;
      spread(bmask[ib], bhi, blo);
      recs[idx].lo = alo | (blo << 1);
      recs[idx].hi = ahi | (bhi << 1) | ((blo >> 63) & 1ull);
      recs[idx].ia = ia;
      recs[idx].ib = ib;
      ++idx;
    }
  }
  std::sort(recs, recs + n, [](const Rec& a, const Rec& b) {
    return a.hi != b.hi ? a.hi < b.hi : a.lo < b.lo;
  });

  for (long long i = 0; i < n; ++i) {
    const unsigned long long a = amask[recs[i].ia];
    const unsigned long long b = bmask[recs[i].ib];
    signed char* row = out + i * (long long)sorb;
    for (int s = 0; s < norb; ++s) {
      row[2 * s] = (signed char)((a >> s) & 1ull);
      row[2 * s + 1] = (signed char)((b >> s) & 1ull);
    }
  }
  delete[] recs;
  delete[] amask;
  delete[] bmask;
  return n;
}

// Pack unpacked bits [n, sorb] into little-endian uint32 words
// [n, nw] (nw = ceil(sorb/32)) — host-side tensor_to_onv analog.
void pack_bits_u32(const signed char* bits, long long n, int sorb,
                   unsigned int* out) {
  const int nw = (sorb + 31) / 32;
  for (long long i = 0; i < n; ++i) {
    const signed char* row = bits + i * (long long)sorb;
    unsigned int* orow = out + i * (long long)nw;
    for (int w = 0; w < nw; ++w) orow[w] = 0u;
    for (int s = 0; s < sorb; ++s)
      if (row[s]) orow[s / 32] |= (1u << (s % 32));
  }
}

}  // extern "C"
