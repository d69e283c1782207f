// Fused teacher-forced Graph-MPS-RNN forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel pynqs_tpu/ops/fused_rnn.py::_kernel
// (launched from graph_mpsrnn_logpsi_fused).  For N rows of site values
// it returns, per row, (log|psi|, Re and Im of the unit phase product,
// linear phase); the wrapper (pynqs_tpu_torch/ops/fused_rnn.py) turns
// them into (log|psi|, arg psi) and adds the reordering sign and the
// global phase.  Layouts of the operands are those of pack_tables().
//
// What bounds it: arithmetic.  Each row does, per site, the complex
// transition of all 4 values, a [2*mp*d] x [8d] product (about 74 kFLOP
// per site at d = 48, mp = 1), against 1 byte of input and 8 bytes of
// output per row per site at most.  At the flagship shapes (657,408 rows
// x 20 sites) that is about 1 TFLOP against tens of MB.
//
// What the design does about it: one CTA of 8 warps owns a tile of rows
// and walks the sites; every row's hidden state stays on chip (in shared
// memory for chains; a global per-row hidden file for DAGs, which the
// same warp writes and reads back), so device memory sees only the site
// values, the weights and the output.  The transition weights W[t, x]
// stream through shared memory in chunks of KC input rows (from L2,
// where the whole table fits), each reused by all rows of the tile;
// each lane keeps a RPT x OPT register tile of (row, output) sums.
// For each value x the epilogue adds the value's eta-weighted and plain
// square sums and keeps the block only where x is the row's value, so
// the full [8d] z is never stored.  Products are FMAs on the CUDA
// cores in f32 (bf16 mode rounds W and h to bf16 first, so each
// product is exact and only the f32 accumulation rounds); tensor cores
// (wgmma) and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int KC = 32;  // input rows of W staged in shared memory at a time
constexpr float NEG = -1e30f;
constexpr int NSTATE = 8;  // per-row state slots in shared memory

// per-row state slots
enum { S_LOGAMP, S_PRRE, S_PRIM, S_PHLIN, S_USEDA, S_USEDB, S_SSQ, S_SELSQ };

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <bool WBF16>
__device__ __forceinline__ float load_w(const void* W, size_t i) {
  if constexpr (WBF16) {
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(W)[i]);
  } else {
    return __ldg(reinterpret_cast<const float*>(W) + i);
  }
}

// RPT rows per warp, OPT outputs per lane (2d <= 32 * OPT).
template <int RPT, int OPT, bool WBF16>
__global__ void __launch_bounds__(THREADS) fused_rnn_kernel(
    const int8_t* __restrict__ vals, int N, int norb, int d, int mp,
    const int* __restrict__ order, const int* __restrict__ pred,
    const int* __restrict__ npred, const void* __restrict__ W,
    const float* __restrict__ vcat, const float* __restrict__ E,
    const float* __restrict__ PW, const float* __restrict__ SC, int noa,
    int nob, int phase_arg, int norm_mpsrnn, int chain,
    float* __restrict__ hbuf, float* __restrict__ out) {
  constexpr int TR = WARPS * RPT;
  extern __shared__ float smem[];
  const int O = 2 * d;        // outputs per value (re then im)
  const int K = 2 * mp * d;   // transition inputs (pred-major, re then im)
  float* w_s = smem;                  // [KC][O]
  float* u_s = w_s + KC * O;          // [TR][K] transition input per row
  float* st_s = u_s + TR * K;         // [TR][NSTATE]
  float* ws_s = st_s + TR * NSTATE;   // [TR][4] eta-weighted sums

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * TR + warp * RPT;  // this warp's first row
  const int lr0 = warp * RPT;                     // ... its local index

  for (int i = 0; i < RPT; ++i) {
    for (int k = lane; k < K; k += 32) u_s[(lr0 + i) * K + k] = 0.f;
    if (lane < NSTATE)
      st_s[(lr0 + i) * NSTATE + lane] = (lane == S_PRRE) ? 1.f : 0.f;
  }
  __syncwarp();

  for (int t = 0; t < norb; ++t) {
    const int s = order[t];
    int x[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = row0 + i;
      x[i] = r < N ? (int)vals[(size_t)r * norb + s] : 0;
    }
    if (!chain) {
      // gather the predecessors' hiddens of this warp's rows
      const int np = npred[t];
      for (int i = 0; i < RPT; ++i) {
        const int r = row0 + i;
        for (int k = lane; k < K; k += 32) {
          const int j = k / O, o = k - j * O;
          float v = 0.f;
          if (j < np && r < N)
            v = hbuf[((size_t)r * norb + pred[t * mp + j]) * O + o];
          u_s[(lr0 + i) * K + k] = WBF16 ? bf16_round(v) : v;
        }
      }
      __syncwarp();
    }

    float zsel[RPT][OPT];
#pragma unroll
    for (int xv = 0; xv < 4; ++xv) {
      float acc[RPT][OPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < OPT; ++j) acc[i][j] = 0.f;
      const size_t wbase = (size_t)(t * 4 + xv) * K * O;
      for (int k0 = 0; k0 < K; k0 += KC) {
        __syncthreads();
        for (int e = threadIdx.x; e < KC * O; e += THREADS) {
          const int kk = e / O;
          w_s[e] = (k0 + kk < K) ? load_w<WBF16>(W, wbase + (size_t)(k0 + kk) * O + (e - kk * O)) : 0.f;
        }
        __syncthreads();
        const int kmax = min(KC, K - k0);
        for (int kk = 0; kk < kmax; ++kk) {
          float wv[OPT];
#pragma unroll
          for (int j = 0; j < OPT; ++j) {
            const int o = lane + 32 * j;
            wv[j] = o < O ? w_s[kk * O + o] : 0.f;
          }
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            const float uv = u_s[(lr0 + i) * K + k0 + kk];
#pragma unroll
            for (int j = 0; j < OPT; ++j) acc[i][j] = fmaf(uv, wv[j], acc[i][j]);
          }
        }
      }
      // epilogue of value xv: bias, square sums, keep the row's block
      const float* vb = vcat + (size_t)(t * 4 + xv) * O;
      const float* eb = E + (size_t)(t * 4 + xv) * O;
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        float pe = 0.f, ps = 0.f;
#pragma unroll
        for (int j = 0; j < OPT; ++j) {
          const int o = lane + 32 * j;
          if (o < O) {
            const float z = acc[i][j] + vb[o];
            acc[i][j] = z;
            const float z2 = z * z;
            pe = fmaf(eb[o], z2, pe);
            ps += z2;
          }
        }
        pe = warp_sum(pe);
        ps = warp_sum(ps);
        if (lane == 0) {
          ws_s[(lr0 + i) * 4 + xv] = pe;
          st_s[(lr0 + i) * NSTATE + S_SSQ] += ps;
          if (x[i] == xv) st_s[(lr0 + i) * NSTATE + S_SELSQ] = ps;
        }
        if (x[i] == xv) {
#pragma unroll
          for (int j = 0; j < OPT; ++j) zsel[i][j] = acc[i][j];
        }
      }
    }
    __syncwarp();

    // per-row scalars: masked conditional, gauge, hidden, phase
    const int rem = norb - t - 1;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      float* st = st_s + (lr0 + i) * NSTATE;
      const float* wsr = ws_s + (lr0 + i) * 4;
      const int ua = (int)st[S_USEDA], ub = (int)st[S_USEDB];
      const bool occ_a = ua + 1 <= noa, emp_a = noa - ua <= rem;
      const bool occ_b = ub + 1 <= nob, emp_b = nob - ub <= rem;
      const bool m[4] = {emp_a && emp_b, occ_a && emp_b, emp_a && occ_b, occ_a && occ_b};
      float lw[4];
#pragma unroll
      for (int v = 0; v < 4; ++v) lw[v] = m[v] ? logf(fmaxf(wsr[v], 1e-30f)) : NEG;
      const float mx = fmaxf(fmaxf(lw[0], lw[1]), fmaxf(lw[2], lw[3]));
      const float lse = mx + logf(expf(lw[0] - mx) + expf(lw[1] - mx) +
                                  expf(lw[2] - mx) + expf(lw[3] - mx));
      const int xi = x[i];
      const float lwx = xi == 0 ? lw[0] : xi == 1 ? lw[1] : xi == 2 ? lw[2] : lw[3];
      const float nrm = norm_mpsrnn ? rsqrtf(fmaxf(st[S_SSQ] / (float)(4 * d), 1e-30f))
                                    : rsqrtf(fmaxf(st[S_SELSQ], 1e-30f));
      const int r = row0 + i;
      const float* pw0 = PW + (size_t)(t * 4 + (phase_arg ? 0 : xi)) * O;
      const float* pw1 = PW + (size_t)(t * 4 + 1) * O;
      float pa = 0.f, pb = 0.f;
#pragma unroll
      for (int j = 0; j < OPT; ++j) {
        const int o = lane + 32 * j;
        if (o < O) {
          const float h = zsel[i][j] * nrm;
          pa = fmaf(h, pw0[o], pa);
          if (phase_arg) pb = fmaf(h, pw1[o], pb);
          if (chain)
            u_s[(lr0 + i) * K + o] = WBF16 ? bf16_round(h) : h;  // K == O
          else if (r < N)
            hbuf[((size_t)r * norb + s) * O + o] = h;
        }
      }
      pa = warp_sum(pa);
      pb = warp_sum(pb);
      __syncwarp();
      if (lane == 0) {
        st[S_LOGAMP] += 0.5f * (lwx - lse);
        if (phase_arg) {
          const float zr = pa + SC[t * 4 + 0], zi = pb + SC[t * 4 + 1];
          const float m2 = zr * zr + zi * zi;
          const bool ok = m2 > 1e-30f;  // z == 0 contributes phase 0
          const float mag = rsqrtf(fmaxf(m2, 1e-30f));
          const float fr = ok ? zr * mag : 1.f, fi = ok ? zi * mag : 0.f;
          const float pr = st[S_PRRE], pi = st[S_PRIM];
          st[S_PRRE] = pr * fr - pi * fi;
          st[S_PRIM] = pr * fi + pi * fr;
        } else {
          st[S_PHLIN] += pa + SC[t * 4 + xi];
        }
        st[S_USEDA] += (float)(xi & 1);
        st[S_USEDB] += (float)(xi >> 1);
        st[S_SSQ] = 0.f;
      }
    }
    __syncwarp();
  }

  if (lane < 4) {
    const int slot[4] = {S_LOGAMP, S_PRRE, S_PRIM, S_PHLIN};
    for (int i = 0; i < RPT; ++i) {
      const int r = row0 + i;
      if (r < N) out[(size_t)r * 4 + lane] = st_s[(lr0 + i) * NSTATE + slot[lane]];
    }
  }
}

// dynamic shared memory of one CTA: the W chunk, the rows' transition
// inputs, their state slots and their eta-weighted sums
template <int RPT>
size_t smem_bytes(int d, int mp) {
  constexpr int TR = WARPS * RPT;
  return sizeof(float) *
         ((size_t)KC * 2 * d + (size_t)TR * 2 * mp * d + TR * NSTATE + TR * 4);
}

template <int RPT, int OPT, bool WBF16>
cudaError_t launch(const int8_t* vals, int N, int norb, int d, int mp,
                   const int* order, const int* pred, const int* npred,
                   const void* W, const float* vcat, const float* E,
                   const float* PW, const float* SC, int noa, int nob,
                   int phase_arg, int norm_mpsrnn, int chain, float* hbuf,
                   float* out, cudaStream_t stream) {
  constexpr int TR = WARPS * RPT;
  const size_t smem = smem_bytes<RPT>(d, mp);
  auto kern = fused_rnn_kernel<RPT, OPT, WBF16>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int grid = (N + TR - 1) / TR;
  kern<<<grid, THREADS, smem, stream>>>(vals, N, norb, d, mp, order, pred,
                                         npred, W, vcat, E, PW, SC, noa, nob,
                                         phase_arg, norm_mpsrnn, chain, hbuf, out);
  return cudaGetLastError();
}

template <bool WBF16>
cudaError_t dispatch(const int8_t* vals, int N, int norb, int d, int mp,
                     const int* order, const int* pred, const int* npred,
                     const void* W, const float* vcat, const float* E,
                     const float* PW, const float* SC, int noa, int nob,
                     int phase_arg, int norm_mpsrnn, int chain, float* hbuf,
                     float* out, cudaStream_t stream) {
  const int O = 2 * d;
#define PNQ_ARGS vals, N, norb, d, mp, order, pred, npred, W, vcat, E, PW, SC, \
                 noa, nob, phase_arg, norm_mpsrnn, chain, hbuf, out, stream
  if (O <= 32) return launch<8, 1, WBF16>(PNQ_ARGS);
  if (O <= 64) return launch<8, 2, WBF16>(PNQ_ARGS);
  if (O <= 96) return launch<8, 3, WBF16>(PNQ_ARGS);
  if (O <= 128) return launch<8, 4, WBF16>(PNQ_ARGS);
  if (O <= 256) return launch<4, 8, WBF16>(PNQ_ARGS);
#undef PNQ_ARGS
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Launches on ``stream`` and
// returns cudaGetLastError() of the launch (0 = success).
extern "C" int fused_rnn_forward(
    const void* vals, int N, int norb, int d, int mp, const void* order,
    const void* pred, const void* npred, const void* W, int w_bf16,
    const void* vcat, const void* E, const void* PW, const void* SC, int noa,
    int nob, int phase_arg, int norm_mpsrnn, int chain, void* hbuf, void* out,
    void* stream) {
  auto f = w_bf16 ? dispatch<true> : dispatch<false>;
  return (int)f(static_cast<const int8_t*>(vals), N, norb, d, mp,
                static_cast<const int*>(order), static_cast<const int*>(pred),
                static_cast<const int*>(npred), W,
                static_cast<const float*>(vcat), static_cast<const float*>(E),
                static_cast<const float*>(PW), static_cast<const float*>(SC),
                noa, nob, phase_arg, norm_mpsrnn, chain,
                static_cast<float*>(hbuf), static_cast<float*>(out),
                static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory the launch above asks for at (d, mp), in bytes
// (-1 where it launches nothing).
extern "C" long long fused_rnn_smem_bytes(int d, int mp) {
  const int O = 2 * d;
  if (O <= 128) return (long long)smem_bytes<8>(d, mp);
  if (O <= 256) return (long long)smem_bytes<4>(d, mp);
  return -1;
}
