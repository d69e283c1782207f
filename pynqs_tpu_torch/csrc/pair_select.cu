// Doubles pair selection of the Slater-Condon matrix elements for Hopper
// (sm_90a):  W[b, u, v] = hpair[po[b, u], pv[b, v]].
//
// Replaces two Pallas TPU kernels of pynqs_tpu/ops/pallas_hij.py:
//   * _kernel (pair_select_w, variant "lane"): W as [B, n_u, n_v];
//     entry point pair_select with rowrow = 0;
//   * _kernel_rowrow (variant "rowrow"): the same values with a
//     transposed output [B, n_v, n_u], which the wrapper
//     (pynqs_tpu_torch/ops/pair_select.py) swaps back; rowrow = 1.
// The TPU kernels avoid every data-dependent index: they build one-hots
// from iota compares and select through bf16 matrix products over a
// three-way split of hpair (they return hpair[pv, po], equal to the
// advertised value for the symmetric physical matrix).  A GPU gathers
// directly, so this kernel keeps the advertised indexing for any hpair,
// reads each value as it is and casts nothing: the result is exact in
// f32 and in f64 (one template per element type and index type).  An
// index outside [0, npair) yields NaN instead of a read out of bounds.
//
// What bounds it.  Device-memory bytes: it writes B*n_u*n_v values and
// reads the indices and hpair once; at the flagship's [2048, 435, 45]
// in f32 with int64 indices that is 160.4 MB written and 10.3 MB read
// (2.4 MB of them the 780 x 780 hpair), 0.051 ms at 3.35 TB/s.  What
// holds it above that is the gather's L2 traffic: hpair stays in the
// 50 MB L2, and every value read costs its whole 32-byte sector unless a
// neighbouring read shares it.  Along an hpair row (fixed po, the
// sample's 45 virtual pairs pv) the 45 values fall in about 24 sectors,
// 0.54 per value (687 MB at [2048, 435, 45] for random determinants,
// four times the bytes written): the sample's 45 of the 780 pair
// indices lie far apart.  Along a row of the transpose hT = hpair^T
// (fixed pv, the sample's 435 occupied pairs, 56% of all pair indices)
// the 435 values fall in about 79 of the row's 98 sectors, 0.18 per
// value (232 MB).
//
// What the design does about it (pair_select_band), cause by cause:
//   1. The gather's L2 traffic: both variants read hT[pv, po] =
//      hpair[po, pv] along hT rows, u fastest; the wrapper keeps hT, a
//      transposed copy of hpair, made once per hpair.  (The earlier
//      kernel read hpair along rows in lane, and down columns in rowrow
//      at one sector per value.)
//   2. The layouts: rowrow's output [B, n_v, n_u] runs along u like the
//      reads, so a rowrow item, (sample b, a band of vb virtual pairs),
//      reads whole hT rows and stores straight to one contiguous run of
//      vb * n_u values, coalesced, without a tile.  A lane item (sample
//      b, a band of ub occupied pairs) reads the band's piece of each of
//      the sample's n_v hT rows (three pieces of each row at the
//      flagship's shape, 0.39 sectors per value, 495 MB; bands large
//      enough for whole rows leave too few CTAs per SM to hide the
//      latency) into a shared tile in lane order
//      ([ub][n_v], written at stride n_v, so no bank conflicts where n_v
//      is odd) and stores the tile, one contiguous run of ub * n_v values
//      of the flat output, as 16-byte vectors over the run's 16-byte-
//      aligned interior and scalars at its two edges (a sample's 78,300
//      bytes are no multiple of 16, so runs start anywhere; the tile
//      starts at the run's offset modulo 16 bytes, so its vectors are
//      aligned too).
//   3. The indices: each item loads its n_v (lane) or n_u (rowrow)
//      indices and its band's into shared memory as int32 once, with
//      out-of-range ones as -1: 3 loads per sample in rowrow, not the
//      20 of the earlier kernel's 1024-output blocks.
//   4. The wrapper's fixed cost: the launch shape comes from Python
//      (pair_select_launch_shape, cached); one CTA per item, as a grid
//      that walks the items persistently measured slower.
//
// pair_select_gather is the earlier kernel, kept for timing beside the
// new one (one block per sample and 1024 consecutive outputs, reading
// hpair in the output's order); no path of the port launches it.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int SMEM_MAX = 48 * 1024;  // shared memory a CTA takes without opting in

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
  static constexpr int N = 4;
};
template <>
struct Vec<double> {
  using type = double2;
  static constexpr int N = 2;
};

__host__ __device__ inline int align16(int n) { return (n + 15) / 16 * 16; }

// The band kernel's shared memory: the int32 indices, padded to 16
// bytes (rowrow: the band's virtual pairs and all n_u occupied ones;
// lane: all n_v virtual pairs and the band's occupied ones), then in
// lane the tile of band * n_v values behind a shift of up to V - 1.
__host__ __device__ inline int band_smem(int n_u, int n_v, int band, int itemsize, int rowrow) {
  return rowrow ? align16((n_u + band) * 4)
                : align16((n_v + band) * 4) + (band * n_v + 16 / itemsize - 1) * itemsize;
}

template <typename I>
__device__ __forceinline__ int checked(I p, int npair) {
  return (p >= 0 && p < npair) ? static_cast<int>(p) : -1;
}

template <typename T>
__device__ __forceinline__ T pick(const T* __restrict__ h, int r, int c, int npair) {
  return (r < 0 || c < 0) ? static_cast<T>(NAN)
                          : __ldg(h + static_cast<long long>(r) * npair + c);
}

// One CTA per item.  Lane: item (b, occupied pairs [u0, u0 + rows)),
// band = ub; rowrow: item (b, virtual pairs [v0, v0 + rows)), band = vb.
template <typename T, typename I, bool ROWROW>
__global__ void __launch_bounds__(THREADS)
pair_select_band(const I* __restrict__ po, const I* __restrict__ pv, const T* __restrict__ hT,
                 T* __restrict__ out, int n_u, int n_v, int npair, int band, int bands) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long b = blockIdx.x / bands;
  const int j0 = static_cast<int>(blockIdx.x % bands) * band;
  const long long per = static_cast<long long>(n_u) * n_v;
  int* s_pv = reinterpret_cast<int*>(smem);
  if (ROWROW) {
    const int rows = min(band, n_v - j0);  // out[b, j0 + v, u] = hT[pv[b, j0 + v], po[b, u]]
    int* s_po = s_pv + rows;
    for (int i = threadIdx.x; i < rows; i += THREADS) s_pv[i] = checked(pv[b * n_v + j0 + i], npair);
    for (int i = threadIdx.x; i < n_u; i += THREADS) s_po[i] = checked(po[b * n_u + i], npair);
    __syncthreads();
    T* o = out + b * per + static_cast<long long>(j0) * n_u;
    const int m = rows * n_u;
    for (int l = threadIdx.x; l < m; l += THREADS) {
      const int v = l / n_u;
      o[l] = pick(hT, s_pv[v], s_po[l - v * n_u], npair);
    }
  } else {
    const int rows = min(band, n_u - j0);  // out[b, j0 + u, v] = hT[pv[b, v], po[b, j0 + u]]
    int* s_po = s_pv + n_v;
    for (int i = threadIdx.x; i < n_v; i += THREADS) s_pv[i] = checked(pv[b * n_v + i], npair);
    for (int i = threadIdx.x; i < rows; i += THREADS) s_po[i] = checked(po[b * n_u + j0 + i], npair);
    constexpr int V = Vec<T>::N;
    const long long base = b * per + static_cast<long long>(j0) * n_v;
    const int sh = static_cast<int>(base % V);  // tile[sh + l] holds out[base + l]
    T* tile = reinterpret_cast<T*>(smem + align16((n_v + band) * 4));
    __syncthreads();
    const int m = rows * n_v;
    for (int l = threadIdx.x; l < m; l += THREADS) {  // hT order: u fastest
      const int v = l / rows, u = l - v * rows;
      tile[sh + u * n_v + v] = pick(hT, s_pv[v], s_po[u], npair);
    }
    __syncthreads();
    // out[base, base + m): scalar head up to the first multiple of V,
    // vectors of V values, scalar tail
    const int head = min(m, (V - sh) % V);
    const int nvec = (m - head) / V;
    const int tail0 = head + nvec * V;
    T* o = out + base;
    using VT = typename Vec<T>::type;
    for (int g = threadIdx.x; g < nvec; g += THREADS) {
      const int l = head + g * V;
      *reinterpret_cast<VT*>(o + l) = *reinterpret_cast<const VT*>(tile + sh + l);
    }
    const int t = threadIdx.x;
    if (t < head + (m - tail0)) {  // fewer than 2V edge values
      const int l = t < head ? t : tail0 + (t - head);
      o[l] = tile[sh + l];
    }
  }
}

constexpr int TILE = 4 * THREADS;  // the earlier kernel's outputs per block

template <typename T, typename I, bool ROWROW>
__global__ void __launch_bounds__(THREADS)
pair_select_gather(const I* __restrict__ po, const I* __restrict__ pv,
                   const T* __restrict__ hpair, T* __restrict__ out, int n_u, int n_v,
                   int npair, int tiles) {
  extern __shared__ int s_idx[];  // po[b, :] then pv[b, :]
  const long long b = blockIdx.x / tiles;
  const int tile = blockIdx.x % tiles;
  int* s_po = s_idx;
  int* s_pv = s_idx + n_u;
  for (int i = threadIdx.x; i < n_u; i += THREADS) s_po[i] = checked(po[b * n_u + i], npair);
  for (int i = threadIdx.x; i < n_v; i += THREADS) s_pv[i] = checked(pv[b * n_v + i], npair);
  __syncthreads();
  const int per = n_u * n_v;
  const int f1 = min(per, (tile + 1) * TILE);
  T* o = out + b * per;
  for (int f = tile * TILE + threadIdx.x; f < f1; f += THREADS) {
    int u, v;
    if (ROWROW) {  // out[b, v, u]
      v = f / n_u;
      u = f - v * n_u;
    } else {  // out[b, u, v]
      u = f / n_v;
      v = f - u * n_v;
    }
    o[f] = pick(hpair, s_po[u], s_pv[v], npair);
  }
}

template <typename T, typename I, bool ROWROW>
int launch_band(const void* po, const void* pv, const void* hT, void* out, int B, int n_u,
                int n_v, int npair, int band, cudaStream_t stream) {
  const int smem = band_smem(n_u, n_v, band, sizeof(T), ROWROW);
  const int bands = band < 1 ? 0 : ((ROWROW ? n_v : n_u) + band - 1) / band;
  const long long items = static_cast<long long>(B) * bands;
  if (band < 1 || smem > SMEM_MAX || items > 0x7fffffffLL ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  pair_select_band<T, I, ROWROW><<<static_cast<unsigned>(items), THREADS, smem, stream>>>(
      static_cast<const I*>(po), static_cast<const I*>(pv), static_cast<const T*>(hT),
      static_cast<T*>(out), n_u, n_v, npair, band, bands);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename I, bool ROWROW>
int launch_gather(const void* po, const void* pv, const void* hpair, void* out, int B, int n_u,
                  int n_v, int npair, cudaStream_t stream) {
  const int tiles = (n_u * n_v + TILE - 1) / TILE;
  const int smem = (n_u + n_v) * static_cast<int>(sizeof(int));
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  pair_select_gather<T, I, ROWROW><<<static_cast<unsigned>(static_cast<long long>(B) * tiles),
                                     THREADS, smem, stream>>>(
      static_cast<const I*>(po), static_cast<const I*>(pv), static_cast<const T*>(hpair),
      static_cast<T*>(out), n_u, n_v, npair, tiles);
  return static_cast<int>(cudaGetLastError());
}

// The band kernel, or the earlier one where gather != 0, for one of the
// four (layout, kernel) choices at element type T and index type I; h is
// hT for the band kernel and hpair for the earlier one.
template <typename T, typename I>
int launch(const void* po, const void* pv, const void* h, void* out, int B, int n_u, int n_v,
           int npair, int rowrow, int band, int gather, cudaStream_t s) {
  if (B <= 0 || n_u <= 0 || n_v <= 0) return 0;
  if (gather)
    return rowrow ? launch_gather<T, I, true>(po, pv, h, out, B, n_u, n_v, npair, s)
                  : launch_gather<T, I, false>(po, pv, h, out, B, n_u, n_v, npair, s);
  return rowrow ? launch_band<T, I, true>(po, pv, h, out, B, n_u, n_v, npair, band, s)
                : launch_band<T, I, false>(po, pv, h, out, B, n_u, n_v, npair, band, s);
}

int dispatch(const void* po, const void* pv, const void* h, void* out, int B, int n_u, int n_v,
             int npair, int idx64, int f64, int rowrow, int band, int gather, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f64)
    return idx64 ? launch<double, int64_t>(po, pv, h, out, B, n_u, n_v, npair, rowrow, band,
                                           gather, s)
                 : launch<double, int32_t>(po, pv, h, out, B, n_u, n_v, npair, rowrow, band,
                                           gather, s);
  return idx64 ? launch<float, int64_t>(po, pv, h, out, B, n_u, n_v, npair, rowrow, band, gather,
                                        s)
               : launch<float, int32_t>(po, pv, h, out, B, n_u, n_v, npair, rowrow, band, gather,
                                        s);
}

}  // namespace

// po [B, n_u], pv [B, n_v] (int32 if idx64 == 0, else int64), hT
// [npair, npair] = hpair^T, contiguous (f32 if f64 == 0, else f64), all
// contiguous; out [B, n_u, n_v] (rowrow == 0) or [B, n_v, n_u] (rowrow
// == 1) in hT's type, 16-byte aligned.  band (occupied pairs per lane
// item, virtual pairs per rowrow item) from pair_select_launch_shape:
// the grid is B * ceil(n_u / band) (lane) or B * ceil(n_v / band)
// (rowrow) CTAs, below 2^31, and the shared memory (band_smem) within
// 48 KB.  Returns the launch's CUDA error code.
extern "C" int pair_select(const void* po, const void* pv, const void* hT, void* out, int B,
                           int n_u, int n_v, int npair, int idx64, int f64, int rowrow,
                           int band, void* stream) {
  return dispatch(po, pv, hT, out, B, n_u, n_v, npair, idx64, f64, rowrow, band, 0, stream);
}

// The earlier kernel on hpair itself: one block per (sample, 1024
// outputs); needs B*ceil(n_u*n_v / 1024) < 2^31 and (n_u + n_v)*4 bytes
// of shared memory (<= 48 KB).  For timing only.
extern "C" int pair_select_gather(const void* po, const void* pv, const void* hpair, void* out,
                                  int B, int n_u, int n_v, int npair, int idx64, int f64,
                                  int rowrow, void* stream) {
  return dispatch(po, pv, hpair, out, B, n_u, n_v, npair, idx64, f64, rowrow, 0, 1, stream);
}
