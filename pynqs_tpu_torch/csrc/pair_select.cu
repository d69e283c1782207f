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
// f32 and in f64 (one template per element type and index type).
//
// What bounds it: bytes.  It writes B*n_u*n_v values and reads the
// indices once; at the flagship's [2048, 435, 45] in f32 with int64
// indices that is 160.4 MB written and 10.3 MB read (2.4 MB of them the
// 780 x 780 hpair), so 170.7 MB over 3.35 TB/s is 0.051 ms on an H100.
//
// What the design does about it: one block per (sample b, tile of TILE
// consecutive output elements) loads that sample's po and pv into shared
// memory, and its threads walk the tile's flattened output index, so
// neighbouring threads write neighbouring addresses in either layout.
// The random reads of hpair hit L2: the whole matrix (2.4 MB f32 at
// sorb 40) stays in the 50 MB cache.  An index outside [0, npair) yields
// NaN instead of a read out of bounds.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 4 * THREADS;  // output elements per block

template <typename T, typename I, bool ROWROW>
__global__ void __launch_bounds__(THREADS)
pair_select_kernel(const I* __restrict__ po, const I* __restrict__ pv,
                   const T* __restrict__ hpair, T* __restrict__ out, int n_u,
                   int n_v, int npair, int tiles) {
  extern __shared__ int s_idx[];  // po[b, :] then pv[b, :]
  const long long b = blockIdx.x / tiles;
  const int tile = blockIdx.x % tiles;
  int* s_po = s_idx;
  int* s_pv = s_idx + n_u;
  for (int i = threadIdx.x; i < n_u; i += THREADS) {
    const I p = po[b * n_u + i];
    s_po[i] = (p >= 0 && p < npair) ? static_cast<int>(p) : -1;
  }
  for (int i = threadIdx.x; i < n_v; i += THREADS) {
    const I p = pv[b * n_v + i];
    s_pv[i] = (p >= 0 && p < npair) ? static_cast<int>(p) : -1;
  }
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
    const int r = s_po[u], c = s_pv[v];
    o[f] = (r < 0 || c < 0) ? static_cast<T>(NAN)
                            : hpair[static_cast<long long>(r) * npair + c];
  }
}

template <typename T, typename I>
int launch(const void* po, const void* pv, const void* hpair, void* out, int B,
           int n_u, int n_v, int npair, int rowrow, cudaStream_t stream) {
  const int per = n_u * n_v;
  const int tiles = (per + TILE - 1) / TILE;
  const size_t smem = static_cast<size_t>(n_u + n_v) * sizeof(int);
  const dim3 grid(static_cast<unsigned>(static_cast<long long>(B) * tiles));
  const I* po_ = static_cast<const I*>(po);
  const I* pv_ = static_cast<const I*>(pv);
  const T* h_ = static_cast<const T*>(hpair);
  T* out_ = static_cast<T*>(out);
  if (rowrow)
    pair_select_kernel<T, I, true><<<grid, THREADS, smem, stream>>>(
        po_, pv_, h_, out_, n_u, n_v, npair, tiles);
  else
    pair_select_kernel<T, I, false><<<grid, THREADS, smem, stream>>>(
        po_, pv_, h_, out_, n_u, n_v, npair, tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// po [B, n_u], pv [B, n_v] (int32 if idx64 == 0, else int64), hpair
// [npair, npair] (f32 if f64 == 0, else f64), all contiguous; out
// [B, n_u, n_v] (rowrow == 0) or [B, n_v, n_u] (rowrow == 1) in hpair's
// type.  Needs B*ceil(n_u*n_v / 1024) < 2^31 and (n_u + n_v)*4 bytes
// of shared memory (<= 48 KB).  Returns the launch's CUDA error code.
extern "C" int pair_select(const void* po, const void* pv, const void* hpair,
                           void* out, int B, int n_u, int n_v, int npair,
                           int idx64, int f64, int rowrow, void* stream) {
  if (B <= 0 || n_u <= 0 || n_v <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f64) {
    return idx64 ? launch<double, int64_t>(po, pv, hpair, out, B, n_u, n_v, npair, rowrow, s)
                 : launch<double, int32_t>(po, pv, hpair, out, B, n_u, n_v, npair, rowrow, s);
  }
  return idx64 ? launch<float, int64_t>(po, pv, hpair, out, B, n_u, n_v, npair, rowrow, s)
               : launch<float, int32_t>(po, pv, hpair, out, B, n_u, n_v, npair, rowrow, s);
}
