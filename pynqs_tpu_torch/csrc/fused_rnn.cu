// Fused teacher-forced Graph-MPS-RNN forward for Hopper (sm_90a), and
// its two prefix-sharing variants, on the CUDA cores: the prefix passes'
// f32 mode.  The flat forward runs on the tensor cores in
// csrc/fused_rnn_mma.cu in both modes (fused_rnn_forward_mma in bf16,
// fused_rnn_forward_mma_f32 in f32 as three TF32 products), and so do the
// prefix passes in bf16 (fused_rnn_prefix_parent_mma and
// fused_rnn_prefix_child_mma); the wrappers reach this file's flat
// forward (in either mode) and its prefix passes in bf16 only to time and
// check them beside those (fused_rnn._launch_simt,
// fused_rnn._launch_f32_cuda_cores, fused_rnn_prefix._launch_prefix_simt).
//
// Replaces three Pallas TPU kernels:
//   * pynqs_tpu/ops/fused_rnn.py::_kernel (graph_mpsrnn_logpsi_fused),
//     tensor-coupling branch included: entry point fused_rnn_forward;
//   * pynqs_tpu/ops/fused_rnn_prefix.py::_parent_kernel, the chain
//     forward that also writes each site's hidden state and scalar
//     state: entry point fused_rnn_prefix_parent;
//   * pynqs_tpu/ops/fused_rnn_prefix.py::_child_kernel, the chain
//     forward of rows that start at a later site from their parent's
//     state: entry point fused_rnn_prefix_child.
// For N rows of site values each returns, per row, (log|psi|, Re and Im
// of the unit phase product, linear phase); the wrappers
// (pynqs_tpu_torch/ops/fused_rnn.py, fused_rnn_prefix.py) turn them
// into (log|psi|, arg psi) and add the reordering sign and the global
// phase.  Layouts of the operands are those of pack_tables().
//
// What bounds it: arithmetic.  Each row does, per site, the complex
// transition of all 4 values, a [2*mp*d] x [8d] product (about 74 kFLOP
// per site at d = 48, mp = 1; 262 kFLOP at d = 64, mp = 2), against
// 1 byte of input and 8 bytes of output per row per site at most.  At
// the flagship shapes (657,408 rows x 20 sites) that is about 1 TFLOP
// against tens of MB.
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
//
// Tensor coupling (use_tensor, sites with >= 2 predecessors): before the
// transition, each (row, value x, compressed index c) item forms
// u_{j,x,c} = U[t,j,x,c,:] . h_pj for every predecessor j from the
// row's inputs already in shared memory, multiplies them over j, and
// keeps the product (bf16-rounded in bf16 mode) in shared memory; the
// epilogue of value x adds K[t,x] . prod to z before squaring.  It is
// about 9% of the transition's FMAs at d 64, dcut_cmpr 4, mp 2.
//
// Prefix sharing (chains): a child row differs from its parent only from
// its first changed site s0 on, so it equals its parent up to s0 - 1.
// The parent pass writes each row's normalized hidden h_t and its scalar
// state after every site to hh [B, norb, 2d] and sh [B, norb, NSTATE].
// The wrapper sorts the children by s0, so the rows of one CTA start
// close together; the CTA starts at the smallest s0 of its rows, seeds
// each row from its own parent's state at that site - 1 (a per-row
// gather), and rows whose own s0 is later replay their parent's inputs,
// which are theirs too, until they diverge.  Site-steps before the CTA's
// start are skipped.  The tensor-core passes (csrc/fused_rnn_mma.cu) keep
// this design and the hh/sh layout, so both designs' passes take either
// one's history.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int KC = 32;  // input rows of W staged in shared memory at a time
constexpr float NEG = -1e30f;
constexpr int NSTATE = 8;  // per-row state slots in shared memory and in sh

// per-row state slots
enum { S_LOGAMP, S_PRRE, S_PRIM, S_PHLIN, S_USEDA, S_USEDB, S_SSQ, S_SELSQ };

enum { MODE_FLAT = 0, MODE_PARENT = 1, MODE_CHILD = 2 };

struct Args {
  const int8_t* vals;  // [N, norb] site values by site id
  int N, norb, d, mp;
  const int* order;  // [norb] site id at process position t
  const int* pred;   // [norb, mp] predecessor site ids
  const int* npred;  // [norb]
  const void* W;     // [norb, 4, K, O] f32 or bf16
  const float *vcat, *E, *PW, *SC;
  int noa, nob, phase_arg, norm_mpsrnn, chain;
  // tensor coupling: U [norb, mp, 4, dc, d], K [norb, 4, d, dc]
  const float *Ure, *Uim, *Kre, *Kim;
  int dc, use_tensor;
  // prefix sharing (chains): s0 [N] first changed site, parent [N] row
  // of the parent in hh/sh; hh [B, norb, O], sh [B, norb, NSTATE]
  int mode;
  const int *s0, *parent;
  float *hh, *sh;
  float* hbuf;  // DAG hidden file [N, norb, O]
  float* out;   // [N, 4]
};

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

template <bool WBF16>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (WBF16) {
    return bf16_round(v);
  } else {
    return v;
  }
}

// RPT rows per warp, OPT outputs per lane (2d <= 32 * OPT).
template <int RPT, int OPT, bool WBF16>
__global__ void __launch_bounds__(THREADS) fused_rnn_kernel(const Args a) {
  constexpr int TR = WARPS * RPT;
  extern __shared__ float smem[];
  __shared__ int tile_s0;
  const int norb = a.norb, d = a.d, N = a.N;
  const int O = 2 * d;          // outputs per value (re then im)
  const int K = 2 * a.mp * d;   // transition inputs (pred-major, re then im)
  const int DC = a.use_tensor ? a.dc : 0;
  float* w_s = smem;                  // [KC][O]
  float* u_s = w_s + KC * O;          // [TR][K] transition input per row
  float* st_s = u_s + TR * K;         // [TR][NSTATE]
  float* ws_s = st_s + TR * NSTATE;   // [TR][4] eta-weighted sums
  float* pr_s = ws_s + TR * 4;        // [TR][4][2 * DC] tensor products

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * TR + warp * RPT;  // this warp's first row
  const int lr0 = warp * RPT;                     // ... its local index

  // the CTA's first site: 0, or (child rows) the smallest s0 of its rows
  int t_begin = 0;
  if (a.mode == MODE_CHILD) {
    if (threadIdx.x == 0) tile_s0 = norb;
    __syncthreads();
    const int r = blockIdx.x * TR + threadIdx.x;
    if (threadIdx.x < TR && r < N) atomicMin(&tile_s0, a.s0[r]);
    __syncthreads();
    t_begin = tile_s0;
  }

  for (int i = 0; i < RPT; ++i) {
    const int r = row0 + i;
    if (t_begin > 0 && r < N) {
      // seed from the parent's state after site t_begin - 1
      const size_t src = (size_t)a.parent[r] * norb + (t_begin - 1);
      for (int k = lane; k < K; k += 32)  // chain: K == O
        u_s[(lr0 + i) * K + k] = rnd<WBF16>(a.hh[src * O + k]);
      if (lane < NSTATE) st_s[(lr0 + i) * NSTATE + lane] = a.sh[src * NSTATE + lane];
    } else {
      for (int k = lane; k < K; k += 32) u_s[(lr0 + i) * K + k] = 0.f;
      if (lane < NSTATE)
        st_s[(lr0 + i) * NSTATE + lane] = (lane == S_PRRE) ? 1.f : 0.f;
    }
  }
  __syncwarp();

  for (int t = t_begin; t < norb; ++t) {
    const int s = a.order[t];
    const int np = a.npred[t];
    int x[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = row0 + i;
      x[i] = r < N ? (int)a.vals[(size_t)r * norb + s] : 0;
    }
    if (!a.chain) {
      // gather the predecessors' hiddens of this warp's rows
      for (int i = 0; i < RPT; ++i) {
        const int r = row0 + i;
        for (int k = lane; k < K; k += 32) {
          const int j = k / O, o = k - j * O;
          float v = 0.f;
          if (j < np && r < N)
            v = a.hbuf[((size_t)r * norb + a.pred[t * a.mp + j]) * O + o];
          u_s[(lr0 + i) * K + k] = rnd<WBF16>(v);
        }
      }
      __syncwarp();
    }

    // tensor coupling: prod_j (U[t,j,x] h_pj) for every (row, x, c)
    const bool tensor = DC > 0 && np >= 2;
    if (tensor) {
      for (int e = lane; e < RPT * 4 * DC; e += 32) {
        const int i = e / (4 * DC), xc = e - i * 4 * DC;
        const int xv = xc / DC, c = xc - xv * DC;
        const float* hrow = u_s + (lr0 + i) * K;
        float p_re = 1.f, p_im = 0.f;
        for (int j = 0; j < np; ++j) {
          const size_t ub = ((((size_t)t * a.mp + j) * 4 + xv) * DC + c) * d;
          const float* h = hrow + j * O;
          float u_re = 0.f, u_im = 0.f;
          for (int k = 0; k < d; ++k) {
            // start each row at its own offset: no shared-memory bank
            // conflicts between the rows of a warp
            int dd = k + i;
            dd = dd >= d ? dd - d : dd;
            const float ur = rnd<WBF16>(__ldg(a.Ure + ub + dd));
            const float ui = rnd<WBF16>(__ldg(a.Uim + ub + dd));
            const float hr = h[dd], hi = h[d + dd];
            u_re = fmaf(ur, hr, u_re);
            u_re = fmaf(-ui, hi, u_re);
            u_im = fmaf(ur, hi, u_im);
            u_im = fmaf(ui, hr, u_im);
          }
          if (j == 0) {
            p_re = u_re;
            p_im = u_im;
          } else {
            const float q_re = p_re * u_re - p_im * u_im;
            const float q_im = p_re * u_im + p_im * u_re;
            p_re = q_re;
            p_im = q_im;
          }
        }
        float* pr = pr_s + ((lr0 + i) * 4 + xv) * 2 * DC;
        pr[c] = rnd<WBF16>(p_re);
        pr[DC + c] = rnd<WBF16>(p_im);
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
          w_s[e] = (k0 + kk < K) ? load_w<WBF16>(a.W, wbase + (size_t)(k0 + kk) * O + (e - kk * O)) : 0.f;
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
      if (tensor) {
        // z += K[t, xv] . prod:  re = Kr pr_re - Ki pr_im ; im = Kr pr_im + Ki pr_re
#pragma unroll
        for (int j = 0; j < OPT; ++j) {
          const int o = lane + 32 * j;
          if (o < O) {
            const bool im = o >= d;
            const int dd = im ? o - d : o;
            const size_t kb = ((size_t)(t * 4 + xv) * d + dd) * DC;
            for (int c = 0; c < DC; ++c) {
              const float kr = rnd<WBF16>(__ldg(a.Kre + kb + c));
              const float ki = rnd<WBF16>(__ldg(a.Kim + kb + c));
#pragma unroll
              for (int i = 0; i < RPT; ++i) {
                const float* pr = pr_s + ((lr0 + i) * 4 + xv) * 2 * DC;
                const float p_re = pr[c], p_im = pr[DC + c];
                acc[i][j] = im ? fmaf(kr, p_im, fmaf(ki, p_re, acc[i][j]))
                               : fmaf(kr, p_re, fmaf(-ki, p_im, acc[i][j]));
              }
            }
          }
        }
      }
      // epilogue of value xv: bias, square sums, keep the row's block
      const float* vb = a.vcat + (size_t)(t * 4 + xv) * O;
      const float* eb = a.E + (size_t)(t * 4 + xv) * O;
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
      const bool occ_a = ua + 1 <= a.noa, emp_a = a.noa - ua <= rem;
      const bool occ_b = ub + 1 <= a.nob, emp_b = a.nob - ub <= rem;
      const bool m[4] = {emp_a && emp_b, occ_a && emp_b, emp_a && occ_b, occ_a && occ_b};
      float lw[4];
#pragma unroll
      for (int v = 0; v < 4; ++v) lw[v] = m[v] ? logf(fmaxf(wsr[v], 1e-30f)) : NEG;
      const float mx = fmaxf(fmaxf(lw[0], lw[1]), fmaxf(lw[2], lw[3]));
      const float lse = mx + logf(expf(lw[0] - mx) + expf(lw[1] - mx) +
                                  expf(lw[2] - mx) + expf(lw[3] - mx));
      const int xi = x[i];
      const float lwx = xi == 0 ? lw[0] : xi == 1 ? lw[1] : xi == 2 ? lw[2] : lw[3];
      const float nrm = a.norm_mpsrnn ? rsqrtf(fmaxf(st[S_SSQ] / (float)(4 * d), 1e-30f))
                                      : rsqrtf(fmaxf(st[S_SELSQ], 1e-30f));
      const int r = row0 + i;
      const float* pw0 = a.PW + (size_t)(t * 4 + (a.phase_arg ? 0 : xi)) * O;
      const float* pw1 = a.PW + (size_t)(t * 4 + 1) * O;
      float pa = 0.f, pb = 0.f;
#pragma unroll
      for (int j = 0; j < OPT; ++j) {
        const int o = lane + 32 * j;
        if (o < O) {
          const float h = zsel[i][j] * nrm;
          pa = fmaf(h, pw0[o], pa);
          if (a.phase_arg) pb = fmaf(h, pw1[o], pb);
          if (a.chain)
            u_s[(lr0 + i) * K + o] = rnd<WBF16>(h);  // K == O
          else if (r < N)
            a.hbuf[((size_t)r * norb + s) * O + o] = h;
          if (a.mode == MODE_PARENT && r < N) a.hh[((size_t)r * norb + t) * O + o] = h;
        }
      }
      pa = warp_sum(pa);
      pb = warp_sum(pb);
      __syncwarp();
      if (lane == 0) {
        st[S_LOGAMP] += 0.5f * (lwx - lse);
        if (a.phase_arg) {
          const float zr = pa + a.SC[t * 4 + 0], zi = pb + a.SC[t * 4 + 1];
          const float m2 = zr * zr + zi * zi;
          const bool ok = m2 > 1e-30f;  // z == 0 contributes phase 0
          const float mag = rsqrtf(fmaxf(m2, 1e-30f));
          const float fr = ok ? zr * mag : 1.f, fi = ok ? zi * mag : 0.f;
          const float pr = st[S_PRRE], pi = st[S_PRIM];
          st[S_PRRE] = pr * fr - pi * fi;
          st[S_PRIM] = pr * fi + pi * fr;
        } else {
          st[S_PHLIN] += pa + a.SC[t * 4 + xi];
        }
        st[S_USEDA] += (float)(xi & 1);
        st[S_USEDB] += (float)(xi >> 1);
        st[S_SSQ] = 0.f;
      }
      __syncwarp();
      if (a.mode == MODE_PARENT && r < N && lane < NSTATE)
        a.sh[((size_t)r * norb + t) * NSTATE + lane] = st[lane];
    }
    __syncwarp();
  }

  if (lane < 4) {
    const int slot[4] = {S_LOGAMP, S_PRRE, S_PRIM, S_PHLIN};
    for (int i = 0; i < RPT; ++i) {
      const int r = row0 + i;
      if (r < N) a.out[(size_t)r * 4 + lane] = st_s[(lr0 + i) * NSTATE + slot[lane]];
    }
  }
}

// dynamic shared memory of one CTA: the W chunk, the rows' transition
// inputs, their state slots, their eta-weighted sums and (use_tensor)
// their tensor products
template <int RPT>
size_t smem_bytes(int d, int mp, int dc) {
  constexpr int TR = WARPS * RPT;
  return sizeof(float) * ((size_t)KC * 2 * d + (size_t)TR * 2 * mp * d +
                          TR * NSTATE + TR * 4 + (size_t)TR * 4 * 2 * dc);
}

template <int RPT, int OPT, bool WBF16>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int TR = WARPS * RPT;
  const size_t smem = smem_bytes<RPT>(a.d, a.mp, a.use_tensor ? a.dc : 0);
  auto kern = fused_rnn_kernel<RPT, OPT, WBF16>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int grid = (a.N + TR - 1) / TR;
  kern<<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool WBF16>
cudaError_t dispatch(const Args& a, cudaStream_t stream) {
  const int O = 2 * a.d;
  if (O <= 32) return launch<8, 1, WBF16>(a, stream);
  if (O <= 64) return launch<8, 2, WBF16>(a, stream);
  if (O <= 96) return launch<8, 3, WBF16>(a, stream);
  if (O <= 128) return launch<8, 4, WBF16>(a, stream);
  if (O <= 256) return launch<4, 8, WBF16>(a, stream);
  return cudaErrorInvalidValue;
}

Args make_args(const void* vals, int N, int norb, int d, int mp, const void* order,
               const void* pred, const void* npred, const void* W, const void* vcat,
               const void* E, const void* PW, const void* SC, int noa, int nob,
               int phase_arg, int norm_mpsrnn, int chain, void* out) {
  Args a = {};
  a.vals = static_cast<const int8_t*>(vals);
  a.N = N;
  a.norb = norb;
  a.d = d;
  a.mp = mp;
  a.order = static_cast<const int*>(order);
  a.pred = static_cast<const int*>(pred);
  a.npred = static_cast<const int*>(npred);
  a.W = W;
  a.vcat = static_cast<const float*>(vcat);
  a.E = static_cast<const float*>(E);
  a.PW = static_cast<const float*>(PW);
  a.SC = static_cast<const float*>(SC);
  a.noa = noa;
  a.nob = nob;
  a.phase_arg = phase_arg;
  a.norm_mpsrnn = norm_mpsrnn;
  a.chain = chain;
  a.out = static_cast<float*>(out);
  a.mode = MODE_FLAT;
  return a;
}

int run(const Args& a, int w_bf16, void* stream) {
  auto f = w_bf16 ? dispatch<true> : dispatch<false>;
  return (int)f(a, static_cast<cudaStream_t>(stream));
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each launches on ``stream``
// and returns cudaGetLastError() of the launch (0 = success).

// The flat forward (kernel #1); U*/K* are read where use_tensor.
extern "C" int fused_rnn_forward(
    const void* vals, int N, int norb, int d, int mp, const void* order,
    const void* pred, const void* npred, const void* W, int w_bf16,
    const void* vcat, const void* E, const void* PW, const void* SC, int noa,
    int nob, int phase_arg, int norm_mpsrnn, int chain, const void* Ure,
    const void* Uim, const void* Kre, const void* Kim, int dc, int use_tensor,
    void* hbuf, void* out, void* stream) {
  Args a = make_args(vals, N, norb, d, mp, order, pred, npred, W, vcat, E, PW, SC,
                     noa, nob, phase_arg, norm_mpsrnn, chain, out);
  a.Ure = static_cast<const float*>(Ure);
  a.Uim = static_cast<const float*>(Uim);
  a.Kre = static_cast<const float*>(Kre);
  a.Kim = static_cast<const float*>(Kim);
  a.dc = dc;
  a.use_tensor = use_tensor;
  a.hbuf = static_cast<float*>(hbuf);
  return run(a, w_bf16, stream);
}

// The parent pass of the prefix-sharing forward (kernel #2, chains):
// the flat chain forward that also writes hh [N, norb, 2d] and
// sh [N, norb, 8] after every site.
extern "C" int fused_rnn_prefix_parent(
    const void* vals, int N, int norb, int d, const void* order,
    const void* pred, const void* npred, const void* W, int w_bf16,
    const void* vcat, const void* E, const void* PW, const void* SC, int noa,
    int nob, int phase_arg, int norm_mpsrnn, void* hh, void* sh, void* out,
    void* stream) {
  Args a = make_args(vals, N, norb, d, 1, order, pred, npred, W, vcat, E, PW, SC,
                     noa, nob, phase_arg, norm_mpsrnn, 1, out);
  a.mode = MODE_PARENT;
  a.hh = static_cast<float*>(hh);
  a.sh = static_cast<float*>(sh);
  return run(a, w_bf16, stream);
}

// The child pass (kernel #3, chains): row r starts at site s0[r] (rows
// sorted by s0) from the state of parent row parent[r] in hh/sh.
extern "C" int fused_rnn_prefix_child(
    const void* vals, int N, int norb, int d, const void* order,
    const void* pred, const void* npred, const void* W, int w_bf16,
    const void* vcat, const void* E, const void* PW, const void* SC, int noa,
    int nob, int phase_arg, int norm_mpsrnn, const void* s0,
    const void* parent, const void* hh, const void* sh, void* out,
    void* stream) {
  Args a = make_args(vals, N, norb, d, 1, order, pred, npred, W, vcat, E, PW, SC,
                     noa, nob, phase_arg, norm_mpsrnn, 1, out);
  a.mode = MODE_CHILD;
  a.s0 = static_cast<const int*>(s0);
  a.parent = static_cast<const int*>(parent);
  a.hh = const_cast<float*>(static_cast<const float*>(hh));
  a.sh = const_cast<float*>(static_cast<const float*>(sh));
  return run(a, w_bf16, stream);
}

// Dynamic shared memory the launch above asks for at (d, mp, dcut_cmpr;
// 0 without tensor coupling), in bytes (-1 where it launches nothing).
extern "C" long long fused_rnn_smem_bytes(int d, int mp, int dc) {
  const int O = 2 * d;
  if (O <= 128) return (long long)smem_bytes<8>(d, mp, dc);
  if (O <= 256) return (long long)smem_bytes<4>(d, mp, dc);
  return -1;
}
