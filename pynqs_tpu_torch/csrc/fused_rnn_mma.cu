// Fused teacher-forced Graph-MPS-RNN forward on Hopper's tensor cores
// (sm_90a): kernels #1-#3 in bf16 (bf16 operands, f32 sums) and in f32
// (each f32 product as three TF32 products).
//
// Replaces three Pallas TPU kernels, each through its own entry points:
//   * pynqs_tpu/ops/fused_rnn.py::_kernel (graph_mpsrnn_logpsi_fused),
//     chain and DAG, with and without the tensor coupling:
//     fused_rnn_forward_mma (bf16) and fused_rnn_forward_mma_f32 (f32,
//     the TPU kernel's precision=HIGHEST mode, fused_rnn.py:247, 259, 289);
//   * pynqs_tpu/ops/fused_rnn_prefix.py::_parent_kernel, the chain
//     forward that also writes each site's hidden and scalar state:
//     fused_rnn_prefix_parent_mma and fused_rnn_prefix_parent_mma_f32
//     (precision=HIGHEST, fused_rnn_prefix.py:160-164);
//   * pynqs_tpu/ops/fused_rnn_prefix.py::_child_kernel, the chain forward
//     of rows that start at a later site from their parent's state:
//     fused_rnn_prefix_child_mma and fused_rnn_prefix_child_mma_f32.
// All are one walk over the sites, fused_rnn_mma_kernel, selected by a
// compile-time mode (flat, parent, child) and precision (bf16, f32), so
// the flat kernel carries none of the prefix code and the bf16 kernel
// none of the f32 code.  (csrc/fused_rnn.cu keeps the earlier CUDA-core
// kernels, reached only to time and check them beside these.)  For N
// rows of site values each returns, per row, (log|psi|, Re and Im of the
// unit phase product, linear phase); the wrappers
// (pynqs_tpu_torch/ops/fused_rnn.py, fused_rnn_prefix.py) turn them into
// (log|psi|, arg psi).  The bf16 mode
// rounds at the points of graph_mpsrnn_logpsi_fused_plain in bf16 mode:
// W, h, U, the tensor product and K to bf16; vcat, eta, the phase rows
// and all sums in f32; the phase readout from the unrounded h.  The f32
// mode rounds to nothing narrower than f32 but inside its split products.
//
// What bounds it: arithmetic.  Per row and site the complex transition
// of all 4 values is a [2*mp*d] x [8d] product (74 kFLOP at d 48, mp 1;
// 262 kFLOP at d 64, mp 2 with the coupling), against at most 9 bytes of
// input and output per row and site: about 1 TFLOP (chain) and 3.5 TFLOP
// (r5g64) per 657,408-row step forward, 1.0 and 3.5 ms at the card's
// 989 TFLOP/s bf16 peak.  In f32 every product is three TF32 products:
// the bound is 3x the operations over the 495 TFLOP/s TF32 peak, 6x the
// bf16 bound and 0.41x the CUDA cores' f32 bound (the operations over 67
// TFLOP/s).  The weights are read by every CTA, so the second limit is
// L2: every CTA streams all of W once per call (in f32 twice the bytes).
// The prefix passes do the same work per site-step; the parent (2048
// rows at the flagship step) is too small to fill the card and is bound
// by the latency of its 20 sites in sequence, the child (655,360 rows) by
// arithmetic over the site-steps its CTAs run, plus the bytes of the
// parent history (hh, sh) it seeds from (15.7 MB, read from L2).
//
// What the design does about it:
//  * Rows on the M dimension of mma.sync.m16n8k16 (bf16 -> f32): each
//    warp owns 16 rows and walks the sites.  For each site and value x,
//    z_x[16, O] = u[16, K] @ W[t, x][K, O] with O = 2 dp outputs
//    ([re | im], d padded to dp so that O / 16 is whole) and K = 2 dp per
//    predecessor; the f32 accumulators stay in registers.
//  * Epilogue in registers: in the m16n8 C layout a row's outputs sit in
//    one quad of lanes, so each lane sums its own columns and two
//    __shfl_xor_sync finish the eta-weighted and plain square sums; a
//    per-row select keeps the row's own block in registers.  The [4 O] z
//    is never stored.  The per-row scalar work (masks, logsumexp, norm,
//    phase) runs redundantly on the 4 lanes of the row's quad, whose
//    state stays in registers.
//  * The hidden file on chip.  A lane of the C fragments of n-tiles 2k,
//    2k+1 holds exactly the bf16 pairs that the same lane reads as the A
//    fragment of k-step k, so a row's normalized h, rounded to bf16, is
//    stored by each lane into its own 16-byte A fragments: the slot file
//    [slot][k-step][lane] (uint4) is lane-private and needs no barrier.
//    The host (hidden_slots) gives each site a slot live from its own
//    site to its last reader; a chain needs one slot, the r5g64 stand-in
//    graph 7.  The slots sit in shared memory where they fit beside the
//    weight stages (8 warps, else 4 warps per CTA), else in a file in
//    global memory (bf16: half the CUDA-core kernel's f32 file).  A
//    multi-predecessor site reads each predecessor's k-block straight
//    from its slot.
//  * Weights packed once (pack_mma_tables) in bf16, in the order the
//    fragments read them: per k-step and pair of n-tiles, lane l's four
//    B registers are 16 consecutive bytes, so a warp loads a tile with one
//    conflict-free 16-byte shared load per lane and each stage is one
//    straight copy.  The whole table is one stream in consumption order
//    (per site: UW, then per value W_x and KW_x), cut into chunks of at
//    most 24 KB (a host table of offsets), fed through a ring of 3
//    shared-memory stages by cp.async: the next chunks are in flight
//    while the current one's MMAs run, one __syncthreads per chunk.
//  * Accumulation.  The tensor cores add the 16 products of a k-step and
//    the accumulator with their own alignment and truncation, not the
//    round-to-nearest f32 adds of the plain version; kept across all
//    k-steps inside the MMA, the sums drift from the plain version's far
//    enough that the bf16 rounding of h flips more often and compounds
//    over the sites (chip_smoke.py phase 3, r5g64 on an H100: 63 of the
//    65 rows hold_rows allows left the phase tolerance, against 23 for
//    the plain version with f64 sums).  So each k-step's MMA starts from
//    zero and the CUDA cores add it to the f32 sums (24 rows), at the
//    cost of those adds.
//  * Tensor coupling as two more products, as the JAX kernel: uo_j = h_j
//    @ UW_j on the tensor cores, then z_x += pr_x @ KW_x with pr_x the
//    complex product of the uo_j over the predecessors.  The dcp = dcut_cmpr
//    (rounded up to 4, or above 4 to a multiple of 8) c's run in blocks of
//    cb = min(dcp, 8): per block, each predecessor's k-block against the
//    block's 8 cb columns, laid out (x, c, re|im) so that a lane holds re
//    and im of the same c; the complex product over predecessors in
//    registers; then the lane writes the block's product (rounded to bf16
//    in bf16) as its A fragments of KW_x's k-steps into a lane-private
//    coupling slot [x][k-step][lane] beside its hidden slots.  The
//    registers are those of one block at any dcp; the transition reads
//    the coupling slot as its last k-steps (one k16 per block, zero past
//    2 cb, in bf16; 2 cb / 8 k8 per block in f32) as it reads a
//    predecessor's hidden from its slot.
//  * The f32 mode (PREC_F32X3) is the same walk with
//    mma.sync.m16n8k8 in TF32 (10-bit mantissa, f32 sums): the TF32
//    precision Hopper's tensor cores take f32 operands in, at half the
//    bf16 rate.  One TF32 product would not keep f32 agreement, so each
//    operand x is split into a TF32 head and tail, hi = rna(x) and lo =
//    rna(x - hi) (round to nearest, ties away from zero, as
//    cvt.rna.tf32.f32: half an ulp added to the magnitude and the low 13
//    bits cut), and each k8-step is lo_a hi_b + hi_a lo_b + hi_a hi_b (the
//    small terms first) on the tensor cores from a zero accumulator, then
//    added to the f32 sums by one FADD per output as in bf16.  The term
//    left out, lo_a lo_b, is about 2^-22 of the product.  A lane splits its
//    A fragment once per k-step for all n-tiles, and each B pair as it
//    loads it; W streams in f32 (twice the bf16 bytes; a stream split on
//    the host would be 4x).  The hidden file keeps f32 h: with k permuted
//    inside each 8-block at pack time (MMA k = c and c + 4 read W rows 2c
//    and 2c + 1, c = lane & 3), a lane's m16n8 C fragment of n-tile k
//    (rows g and g+8, columns 2c and 2c+1) is exactly its m16n8k8 A
//    fragment of k-step k (columns c and c+4): a0..a3 = c0, c2, c1, c3, so
//    the slot file stays lane-private, [slot][k-step][lane] of float4, at
//    twice the bf16 bytes (the chain's one slot fits in shared memory, the
//    r5g64 graph's 7 go to the global file, 7 x 512 B per row at dp 64
//    against the CUDA-core kernel's 20 x 512 B).  The tensor coupling is
//    the same two products in 3xTF32, its complex product in f32.
//    Epilogue, scalars and phase readout are the bf16 mode's, with h
//    unrounded.
//  * Prefix sharing (chains), in both precisions.  A child differs from
//    its parent only from its first changed site s0 on.  The parent pass
//    is the flat walk that
//    also writes, after each site t, each row's f32 h (unpadded, re half
//    then im half) to hh[r, t] and its state (log|psi|, Re and Im of the
//    phase product, linear phase, alpha and beta counts, 0, 0) to
//    sh[r, t]; each lane writes its own columns.  The wrapper sorts the
//    children by s0.  A child CTA starts at the smallest s0 of its rows;
//    the whole CTA starts there because the weight pipe is shared, and
//    the pipe starts at that site's first chunk (site_chunk, from the
//    host, of the stream in the pass's precision).  Each lane seeds its
//    own A fragments of the slot from hh[parent, t_begin - 1], rounded to
//    bf16 in bf16 and unrounded in f32 (in either, the value the flat
//    walk's slot holds for that row: the parent wrote hh from the same
//    registers the flat walk stores into its slot), and its rows' state
//    from sh; rows whose own
//    s0 is later replay their parent's sites on inputs that are theirs
//    too.  Row i of an MMA's D depends only on row i of A, and the quad
//    sums and scalar work only on the row's own lanes, so each parent and
//    child row equals the flat walk on the same row bit for bit.  The
//    launch shape (warps per CTA, a runtime value in the prefix modes) is
//    chosen by the host from the row count: the parent's 2048 rows run in
//    CTAs of one warp, 128 CTAs, so that they spread over the SMs.
//  * Any dcut (the JAX kernel pads dp to a multiple of 64 above 48).  Up
//    to dp 128 a value's O outputs and the selected value's block stay in
//    registers (NP up to 16).  Above, dp is a multiple of 64 and a value's
//    O = 2 dp outputs are computed in npass = dp / 64 passes of 16 n8
//    tiles (128 outputs, NP 8): each pass has its own accumulators over the
//    same A fragments (the hidden's dp / 8 k16 or dp / 4 k8 steps, read
//    from the slot as before) and its own run of the weight stream (the
//    host packs W and KW pass by pass); the eta-weighted and plain quad
//    sums are carried across the passes, and the selected value's z of
//    each pass goes to a lane-private scratch [pass][n-tile][lane] of
//    float4 beside the hidden slots (8 KB per warp and pass).  Once every
//    pass of every value is done the row is normalized and h written to
//    its slot pass by pass (pass q is k-steps 8q.. in bf16, 16q.. in f32).
//    The pass count is a runtime argument of one instantiation per (mode,
//    precision) (WIDE), whose registers are dp 64's accumulators without
//    its register-held block.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int STAGES = 3;
constexpr int STAGE_U4 = 24576 / 16;  // one stage, in 16-byte units
constexpr float NEG = -1e30f;
constexpr int SMEM_LIMIT = 232448;
constexpr int NSTATE = 8;  // per-row state entries of sh

enum { MODE_FLAT = 0, MODE_PARENT = 1, MODE_CHILD = 2 };
enum { PREC_BF16 = 0, PREC_F32X3 = 1 };

struct Args {
  const int8_t* vals;  // [N, norb] site values by site id
  int N, norb, d, mp;
  const int* order;   // [norb] site id at process position t
  const int* npred;   // [norb]
  const int* slot_w;  // [norb] slot that keeps site t's hidden, or -1
  const int* slot_r;  // [norb, mp] slots of site t's predecessors
  int nslots;
  const uint4* tab;   // packed weight stream, bf16 (or f32 in the f32 mode)
  const int* chunks;  // [nchunks, 2] (offset, length) in 16-byte units
  int nchunks;
  const float *vcat, *E, *PW, *SC;  // [norb, 4, O] x3, [norb, 4]
  int noa, nob, phase_arg, norm_mpsrnn, use_tensor, dcp;
  uint4* gslots;  // global slot file, or null: slots in shared memory
  float* out;     // [N, 4]
  // prefix sharing (chains): site_chunk [norb + 1] first chunk of each
  // position; s0 [N] first changed site and parent [N] row of the
  // parent in hh [B, norb, 2d] and sh [B, norb, NSTATE]
  const int *site_chunk, *s0, *parent;
  float *hh, *sh;
  int npass;  // passes of 128 outputs per value (dp > 128), else 1
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// c += a (16x16 bf16, row) * b (16x8 bf16, col): the k16 product on the
// tensor cores from a zero accumulator, then added to c by the CUDA
// cores in round-to-nearest f32 (see the note on accumulation above)
__device__ __forceinline__ void mma(float (&c)[4], const uint4& a, uint32_t b0, uint32_t b1) {
  float d[4];
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1), "f"(0.f), "f"(0.f), "f"(0.f),
        "f"(0.f));
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += d[e];
}

// x rounded to TF32 (10-bit mantissa) to nearest, ties away from zero,
// as cvt.rna.tf32.f32: half an ulp added to the magnitude, the low 13
// bits cut (a carry into the exponent is the right rounding)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo + O(2^-22 x), both TF32: hi = rna(x), lo = rna(x - hi)
__device__ __forceinline__ void split_tf32(uint32_t x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(__uint_as_float(x));
  lo = tf32_rna(__fsub_rn(__uint_as_float(x), __uint_as_float(hi)));
}

__device__ __forceinline__ void split_a(const uint4& a, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split_tf32(a.x, hi[0], lo[0]);
  split_tf32(a.y, hi[1], lo[1]);
  split_tf32(a.z, hi[2], lo[2]);
  split_tf32(a.w, hi[3], lo[3]);
}

// d += a (16x8 TF32, row) * b (8x8 TF32, col) on the tensor cores
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a * b for one k8-step in f32 (the f32 mode): a split by the
// caller, b's f32 pair (b0, b1) here, then lo_a hi_b + hi_a lo_b + hi_a
// hi_b on the tensor cores from a zero accumulator, added to c in
// round-to-nearest f32 as the bf16 mode's mma
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t b0, uint32_t b1) {
  uint32_t h0, l0, h1, l1;
  split_tf32(b0, h0, l0);
  split_tf32(b1, h1, l1);
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(d, al, h0, h1);
  mma_tf32(d, ah, l0, l1);
  mma_tf32(d, ah, h0, h1);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += d[e];
}

// the f32 mode's A fragment (a0..a3 = c0, c2, c1, c3) of one n-tile's C
// fragment c[4] (rows g, g+8; columns 2c, 2c+1)
__device__ __forceinline__ uint4 c_to_a(const float (&c)[4]) {
  return make_uint4(__float_as_uint(c[0]), __float_as_uint(c[2]), __float_as_uint(c[1]),
                    __float_as_uint(c[3]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// The ring of weight stages.  Every thread of the CTA takes part; the
// chunks are consumed in the order the host packed them.
struct Pipe {
  uint4* stage;
  const uint4* tab;
  const int* chunks;
  int nchunks, next, cur;

  __device__ __forceinline__ void fetch(int nthreads) {
    if (next < nchunks) {
      const int off = chunks[2 * next], n = chunks[2 * next + 1];
      uint4* dst = stage + (next % STAGES) * STAGE_U4;
      for (int i = threadIdx.x; i < n; i += nthreads) cp_async16(dst + i, tab + off + i);
    }
    cp_async_commit();  // an empty group keeps the count
    ++next;
  }
  // wait for the next chunk; the stage read before it is free again
  __device__ __forceinline__ const uint4* acquire(int nthreads) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    fetch(nthreads);
    return stage + (cur++ % STAGES) * STAGE_U4;
  }
};

// Walk a segment of nks k-steps of ksz 16-byte units each, chunk by chunk
// (at most STAGE_U4 / ksz k-steps per chunk, as the host cut them).
template <class F>
__device__ __forceinline__ void walk(Pipe& p, int nthreads, int nks, int ksz, F&& body) {
  const int maxks = STAGE_U4 / ksz;
  for (int k0 = 0; k0 < nks; k0 += maxks) {
    const uint4* buf = p.acquire(nthreads);
    const int n = min(maxks, nks - k0);
    for (int i = 0; i < n; ++i) body(k0 + i, buf + i * ksz);
  }
}

// A hidden, this lane's C fragments h[n-tile][4] (rows g, g+8; columns
// 2c, 2c+1), into its slot as the A fragments the same lane reads at the
// sites that take it as a predecessor: f32 unrounded (k-step n is n-tile
// n), or rounded to bf16 (k16-step k is n-tiles 2k, 2k+1).
template <int NP, bool F32>
__device__ __forceinline__ void store_hidden(uint4* slot, int lane, const float (&h)[2 * NP][4]) {
  if constexpr (F32) {
#pragma unroll
    for (int n = 0; n < 2 * NP; ++n) slot[n * 32 + lane] = c_to_a(h[n]);
  } else {
#pragma unroll
    for (int k = 0; k < NP; ++k)
      slot[k * 32 + lane] =
          make_uint4(pack_bf16(h[2 * k][0], h[2 * k][1]), pack_bf16(h[2 * k][2], h[2 * k][3]),
                     pack_bf16(h[2 * k + 1][0], h[2 * k + 1][1]),
                     pack_bf16(h[2 * k + 1][2], h[2 * k + 1][3]));
  }
}

// The k-steps of one value's KW_x, which the coupling slot holds per
// value: one k16 per block of 8 c's (bf16), dcp / 4 k8 (f32); none
// without the tensor coupling.
__host__ __device__ inline int coupling_ksteps(int use_tensor, int dcp, int prec) {
  return !use_tensor ? 0 : prec == PREC_F32X3 ? dcp / 4 : (dcp + 7) / 8;
}

// A lane's column col of a value's O outputs in an unpadded hidden row
// [re (d) | im (d)]: its index there, or -1 for the padding past d.
template <int NP>
__device__ __forceinline__ int hidden_index(int col, int d) {
  const int half = col >= 8 * NP, e = col - half * 8 * NP;
  return e < d ? half * d + e : -1;
}

// The same for a column of the whole O = 2 dp outputs at a runtime dp
// (the passes of a wide value).
__device__ __forceinline__ int hidden_index_dp(int col, int d, int dp) {
  const int half = col >= dp, e = col - half * dp;
  return e < d ? half * d + e : -1;
}

// NP = O / 16 pairs of n-tiles; WARPS warps of 16 rows per CTA (0: as
// many as the launch gives, a runtime value); MODE: the flat forward,
// the prefix parent or the prefix child pass (chains only); PREC: bf16,
// or f32 as three TF32 products; WIDE: NP (8) is one pass's, and each
// value's outputs take a.npass passes (dp > 128).
template <int NP, int WARPS, int MODE, int PREC, bool WIDE = false>
__global__ void __launch_bounds__(WARPS ? WARPS * 32 : 256) fused_rnn_mma_kernel(const Args a) {
  constexpr bool F32 = PREC == PREC_F32X3;
  constexpr int NT = 2 * NP;  // n8 tiles of one value's outputs (WIDE: of one pass)
  constexpr int O = 16 * NP;
  constexpr int KSP = F32 ? NT : NP;  // k-steps of O hidden entries: k16 (bf16) or k8 (f32)
  const int npass = WIDE ? a.npass : 1;
  const int KS = WIDE ? KSP * npass : KSP;  // k-steps of one hidden
  const int OF = WIDE ? O * npass : O;      // one value's outputs, 2 dp
  const int nwarps = WARPS ? WARPS : (int)(blockDim.x >> 5);
  const int THREADS = nwarps * 32;
  extern __shared__ __align__(16) uint4 smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, cq = lane & 3;
  const int rg = (blockIdx.x * nwarps + warp) * 16 + g, rh = rg + 8;  // this lane's rows
  const int norb = a.norb, N = a.N, mp = a.mp;
  const size_t slot_u4 = (size_t)KS * 32;  // one slot of one warp
  // the coupling: blocks of cb c's; ntu n-tiles of one (pred, value, block)
  // of UW (1 or 2); nkw k-steps of KW_x
  const int cb = min(a.dcp, 8), ntu = cb / 4, uw_ksz = cb * 16;
  const int nkw = coupling_ksteps(a.use_tensor, a.dcp, PREC);
  // one warp's file: its hidden slots, then its coupling slot
  // [x][k-step][lane], then (WIDE) the selected z [pass][n-tile][lane]
  const size_t warp_u4 =
      a.nslots * slot_u4 + (size_t)4 * nkw * 32 + (WIDE ? (size_t)npass * NT * 32 : 0);
  uint4* slots = a.gslots ? a.gslots + ((size_t)blockIdx.x * nwarps + warp) * warp_u4
                          : smem + STAGES * STAGE_U4 + (size_t)warp * warp_u4;
  uint4* cslot = slots + a.nslots * slot_u4;
  float4* zscr = reinterpret_cast<float4*>(cslot + 4 * nkw * 32) + lane;

  // the CTA's first position: 0, or (child) the smallest s0 of its rows;
  // the whole CTA starts there, and the weight stream at its first chunk
  int t_begin = 0;
  if constexpr (MODE == MODE_CHILD) {
    __shared__ int tile_s0;
    if (threadIdx.x == 0) tile_s0 = norb;
    __syncthreads();
    const int r = blockIdx.x * nwarps * 16 + threadIdx.x;
    if (threadIdx.x < nwarps * 16 && r < N) atomicMin(&tile_s0, min(max(a.s0[r], 0), norb));
    __syncthreads();
    t_begin = tile_s0;
  }
  const int c0 = MODE == MODE_CHILD ? a.site_chunk[t_begin] : 0;
  Pipe pipe{smem, a.tab, a.chunks, a.nchunks, c0, c0};
  for (int s = 0; s < STAGES - 1; ++s) pipe.fetch(THREADS);

  // per-row state, the same in the 4 lanes of the row's quad
  float la[2] = {0.f, 0.f}, ppr[2] = {1.f, 1.f}, ppi[2] = {0.f, 0.f}, pl[2] = {0.f, 0.f};
  int ua[2] = {0, 0}, ub[2] = {0, 0};

  if constexpr (MODE == MODE_CHILD) {
    if (t_begin > 0) {
      // seed each row from its parent after position t_begin - 1: the
      // state from sh, and the slot that site's hidden went to (the next
      // site reads it) from hh, rounded to bf16 (f32: unrounded) into
      // this lane's own A fragments.  Rows past N start from zero and are
      // not written.
      const int rows[2] = {rg, rh};
      size_t src[2] = {0, 0};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (rows[r] < N) {
          src[r] = (size_t)a.parent[rows[r]] * norb + (t_begin - 1);
          const float* st = a.sh + src[r] * NSTATE;
          la[r] = st[0];
          ppr[r] = st[1];
          ppi[r] = st[2];
          pl[r] = st[3];
          ua[r] = (int)st[4];
          ub[r] = (int)st[5];
        }
      }
      const int sw = a.slot_w[t_begin - 1];
      if (sw >= 0) {
        const int d2 = 2 * a.d;
        for (int pass = 0; pass < npass; ++pass) {  // WIDE: k-steps pass KSP..
          float h[NT][4];  // this lane's C fragments: [n-tile][row][column pair]
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int col = n * 8 + 2 * cq + j;
              const int hi = WIDE ? hidden_index_dp(pass * O + col, a.d, OF / 2)
                                  : hidden_index<NP>(col, a.d);
#pragma unroll
              for (int r = 0; r < 2; ++r)
                h[n][2 * r + j] = (hi >= 0 && rows[r] < N) ? a.hh[src[r] * d2 + hi] : 0.f;
            }
          store_hidden<NP, F32>(slots + sw * slot_u4 + pass * KSP * 32, lane, h);
        }
      }
    }
  }

  for (int t = t_begin; t < norb; ++t) {
    const int s = a.order[t];
    const int np = a.npred[t];
    const int xr[2] = {rg < N ? (int)a.vals[(size_t)rg * norb + s] : 0,
                       rh < N ? (int)a.vals[(size_t)rh * norb + s] : 0};
    const bool tensor = MODE == MODE_FLAT && a.use_tensor && np >= 2;
    const int* sr = a.slot_r + t * mp;

    // ---- tensor coupling: pr_x = prod_j (h_j @ UW_j)_x into the coupling slot ----
    if (tensor) {
      float pr[4][2][4], uo[4][2][4];
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) uo[x][i][e] = pr[x][i][e] = 0.f;
      // per block of cb c's, each predecessor's k-steps
      for (int b = 0; b < a.dcp / cb; ++b) {
        walk(pipe, THREADS, np * KS, uw_ksz, [&](int ks, const uint4* tile) {
          const int j = ks / KS, kl = ks - j * KS;
          const uint4 A = slots[(sr[j] * KS + kl) * 32 + lane];
          // n-pair p covers tiles 2p, 2p+1; tile x * ntu + i is value x's
          // i-th tile of the block's (c, re|im) columns
          if constexpr (F32) {
            uint32_t ah[4], al[4];
            split_a(A, ah, al);
#pragma unroll
            for (int p = 0; p < 4; ++p) {
              if (p < 2 * ntu) {
                const uint4 B = tile[p * 32 + lane];
                if (ntu == 1) {
                  mma3(uo[(2 * p) & 3][0], ah, al, B.x, B.y);
                  mma3(uo[(2 * p + 1) & 3][0], ah, al, B.z, B.w);
                } else {
                  mma3(uo[p][0], ah, al, B.x, B.y);
                  mma3(uo[p][1], ah, al, B.z, B.w);
                }
              }
            }
          } else {
#pragma unroll
            for (int p = 0; p < 4; ++p) {
              if (p < 2 * ntu) {
                const uint4 B = tile[p * 32 + lane];
                if (ntu == 1) {
                  mma(uo[(2 * p) & 3][0], A, B.x, B.y);
                  mma(uo[(2 * p + 1) & 3][0], A, B.z, B.w);
                } else {
                  mma(uo[p][0], A, B.x, B.y);
                  mma(uo[p][1], A, B.z, B.w);
                }
              }
            }
          }
          if (kl == KS - 1) {  // predecessor j done: fold it into the product
#pragma unroll
            for (int x = 0; x < 4; ++x)
#pragma unroll
              for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int e = 0; e < 4; e += 2) {
                  const float ur = uo[x][i][e], ui = uo[x][i][e + 1];
                  if (j == 0) {
                    pr[x][i][e] = ur;
                    pr[x][i][e + 1] = ui;
                  } else {  // as the plain version: products, then the sum
                    const float qr = __fsub_rn(__fmul_rn(pr[x][i][e], ur),
                                               __fmul_rn(pr[x][i][e + 1], ui));
                    const float qi = __fadd_rn(__fmul_rn(pr[x][i][e], ui),
                                               __fmul_rn(pr[x][i][e + 1], ur));
                    pr[x][i][e] = qr;
                    pr[x][i][e + 1] = qi;
                  }
                  uo[x][i][e] = 0.f;
                  uo[x][i][e + 1] = 0.f;
                }
          }
        });
        // block b done: columns (c, re|im) of tile i are k = 8 i + (2c +
        // re|im) of KW_x's k-step b (bf16), or of its k8-step b ntu + i as
        // the hidden's (f32)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          if constexpr (F32) {
            cslot[(x * nkw + b * ntu) * 32 + lane] = c_to_a(pr[x][0]);
            if (ntu == 2) cslot[(x * nkw + b * ntu + 1) * 32 + lane] = c_to_a(pr[x][1]);
          } else {
            uint4 v = make_uint4(pack_bf16(pr[x][0][0], pr[x][0][1]),
                                 pack_bf16(pr[x][0][2], pr[x][0][3]), 0u, 0u);
            if (ntu == 2) {
              v.z = pack_bf16(pr[x][1][0], pr[x][1][1]);
              v.w = pack_bf16(pr[x][1][2], pr[x][1][3]);
            }
            cslot[(x * nkw + b) * 32 + lane] = v;
          }
        }
      }
    }

    // ---- the transition of each value, its epilogue in registers ----
    float zsel[NT][4];
    float ws[2][4], ssq[2] = {0.f, 0.f}, selsq[2] = {0.f, 0.f};
    // the predecessors' k-steps, then (coupled) the nkw of KW_x
    const int nks = np * KS + (tensor ? nkw : 0);
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      if constexpr (WIDE) ws[0][x] = ws[1][x] = 0.f;
      for (int pass = 0; pass < npass; ++pass) {  // WIDE: outputs pass O..
        float acc[NT][4];
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
        walk(pipe, THREADS, nks, NP * 32, [&](int ks, const uint4* tile) {
          uint4 A;
          // (the bf16 prefix passes drop the coupling's test at compile time;
          // in f32 that made ptxas schedule the prefix walk a third slower
          // on an H100, so the f32 passes keep it: a measured choice)
          if ((MODE != MODE_FLAT && !F32) || ks < np * KS) {
            const int j = ks / KS, kl = ks - j * KS;
            A = slots[(sr[j] * KS + kl) * 32 + lane];
          } else {  // the last k-steps of a coupled site: pr_x @ KW_x
            A = cslot[(x * nkw + ks - np * KS) * 32 + lane];
          }
          if constexpr (F32) {
            uint32_t ah[4], al[4];
            split_a(A, ah, al);
#pragma unroll
            for (int p = 0; p < NP; ++p) {
              const uint4 B = tile[p * 32 + lane];
              mma3(acc[2 * p], ah, al, B.x, B.y);
              mma3(acc[2 * p + 1], ah, al, B.z, B.w);
            }
          } else {
#pragma unroll
            for (int p = 0; p < NP; ++p) {
              const uint4 B = tile[p * 32 + lane];
              mma(acc[2 * p], A, B.x, B.y);
              mma(acc[2 * p + 1], A, B.z, B.w);
            }
          }
        });
        // bias, square sums, keep the row's block
        const float* vb = a.vcat + (size_t)(t * 4 + x) * OF + pass * O;
        const float* eb = a.E + (size_t)(t * 4 + x) * OF + pass * O;
        float pe0 = 0.f, ps0 = 0.f, pe1 = 0.f, ps1 = 0.f;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int col = n * 8 + 2 * cq;
          const float2 v = __ldg(reinterpret_cast<const float2*>(vb + col));
          const float2 w = __ldg(reinterpret_cast<const float2*>(eb + col));
          acc[n][0] += v.x;
          acc[n][1] += v.y;
          acc[n][2] += v.x;
          acc[n][3] += v.y;
          const float q0 = acc[n][0] * acc[n][0], q1 = acc[n][1] * acc[n][1];
          const float q2 = acc[n][2] * acc[n][2], q3 = acc[n][3] * acc[n][3];
          pe0 = fmaf(w.x, q0, fmaf(w.y, q1, pe0));
          pe1 = fmaf(w.x, q2, fmaf(w.y, q3, pe1));
          ps0 += q0 + q1;
          ps1 += q2 + q3;
        }
        pe0 = quad_sum(pe0);
        ps0 = quad_sum(ps0);
        pe1 = quad_sum(pe1);
        ps1 = quad_sum(ps1);
        if constexpr (WIDE) {  // sums carried across the passes, the block to scratch
          ws[0][x] += pe0;
          ws[1][x] += pe1;
          ssq[0] += ps0;
          ssq[1] += ps1;
          if (xr[0] == x) selsq[0] += ps0;
          if (xr[1] == x) selsq[1] += ps1;
          float4* zq = zscr + pass * NT * 32;
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            float2* zp = reinterpret_cast<float2*>(zq + n * 32);
            if (xr[0] == x) zp[0] = make_float2(acc[n][0], acc[n][1]);
            if (xr[1] == x) zp[1] = make_float2(acc[n][2], acc[n][3]);
          }
        } else {
          ws[0][x] = pe0;
          ws[1][x] = pe1;
          ssq[0] += ps0;
          ssq[1] += ps1;
          if (xr[0] == x) selsq[0] = ps0;
          if (xr[1] == x) selsq[1] = ps1;
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            if (xr[0] == x) {
              zsel[n][0] = acc[n][0];
              zsel[n][1] = acc[n][1];
            }
            if (xr[1] == x) {
              zsel[n][2] = acc[n][2];
              zsel[n][3] = acc[n][3];
            }
          }
        }
      }
    }

    // ---- per-row scalars: masked conditional, gauge, hidden, phase ----
    const int rem = norb - t - 1;
    float nrm[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool occ_a = ua[r] + 1 <= a.noa, emp_a = a.noa - ua[r] <= rem;
      const bool occ_b = ub[r] + 1 <= a.nob, emp_b = a.nob - ub[r] <= rem;
      const bool m[4] = {emp_a && emp_b, occ_a && emp_b, emp_a && occ_b, occ_a && occ_b};
      float lw[4];
#pragma unroll
      for (int v = 0; v < 4; ++v) lw[v] = m[v] ? logf(fmaxf(ws[r][v], 1e-30f)) : NEG;
      const float mx = fmaxf(fmaxf(lw[0], lw[1]), fmaxf(lw[2], lw[3]));
      const float lse = mx + logf(expf(lw[0] - mx) + expf(lw[1] - mx) + expf(lw[2] - mx) +
                                  expf(lw[3] - mx));
      const int xi = xr[r];
      const float lwx = xi == 0 ? lw[0] : xi == 1 ? lw[1] : xi == 2 ? lw[2] : lw[3];
      la[r] += 0.5f * (lwx - lse);
      // the trap: the mpsrnn gauge divides by 4 d with the model's d
      nrm[r] = a.norm_mpsrnn ? rsqrtf(fmaxf(ssq[r] / (float)(4 * a.d), 1e-30f))
                             : rsqrtf(fmaxf(selsq[r], 1e-30f));
    }
    float pa[2] = {0.f, 0.f}, pb[2] = {0.f, 0.f};
    const int sw = a.slot_w[t];
    for (int pass = 0; pass < npass; ++pass) {  // WIDE: the pass's block from the scratch
      const float* pw0[2] = {a.PW + (size_t)(t * 4 + (a.phase_arg ? 0 : xr[0])) * OF + pass * O,
                             a.PW + (size_t)(t * 4 + (a.phase_arg ? 0 : xr[1])) * OF + pass * O};
      const float* pw1 = a.PW + (size_t)(t * 4 + 1) * OF + pass * O;
      if constexpr (WIDE) {
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const float4 v = zscr[(pass * NT + n) * 32];
          zsel[n][0] = v.x;
          zsel[n][1] = v.y;
          zsel[n][2] = v.z;
          zsel[n][3] = v.w;
        }
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int col = n * 8 + 2 * cq;
        const float h0 = zsel[n][0] * nrm[0], h1 = zsel[n][1] * nrm[0];
        const float h2 = zsel[n][2] * nrm[1], h3 = zsel[n][3] * nrm[1];
        const float2 p0 = __ldg(reinterpret_cast<const float2*>(pw0[0] + col));
        const float2 p1 = __ldg(reinterpret_cast<const float2*>(pw0[1] + col));
        pa[0] = fmaf(h0, p0.x, fmaf(h1, p0.y, pa[0]));
        pa[1] = fmaf(h2, p1.x, fmaf(h3, p1.y, pa[1]));
        if (a.phase_arg) {
          const float2 q = __ldg(reinterpret_cast<const float2*>(pw1 + col));
          pb[0] = fmaf(h0, q.x, fmaf(h1, q.y, pb[0]));
          pb[1] = fmaf(h2, q.x, fmaf(h3, q.y, pb[1]));
        }
        zsel[n][0] = h0;
        zsel[n][1] = h1;
        zsel[n][2] = h2;
        zsel[n][3] = h3;
      }
      // the hidden into its slot, for the sites that take it as a
      // predecessor
      if (sw >= 0) store_hidden<NP, F32>(slots + sw * slot_u4 + pass * KSP * 32, lane, zsel);
      if constexpr (MODE == MODE_PARENT) {  // the f32 hidden, unpadded, into hh
        const int rows[2] = {rg, rh};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (rows[r] < N) {
            float* dst = a.hh + ((size_t)rows[r] * norb + t) * (2 * a.d);
#pragma unroll
            for (int n = 0; n < NT; ++n)
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                const int col = n * 8 + 2 * cq + j;
                const int hi = WIDE ? hidden_index_dp(pass * O + col, a.d, OF / 2)
                                    : hidden_index<NP>(col, a.d);
                if (hi >= 0) dst[hi] = zsel[n][2 * r + j];
              }
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      pa[r] = quad_sum(pa[r]);
      pb[r] = quad_sum(pb[r]);
      const int xi = xr[r];
      if (a.phase_arg) {
        const float zr = pa[r] + a.SC[t * 4 + 0], zi = pb[r] + a.SC[t * 4 + 1];
        const float m2 = zr * zr + zi * zi;
        const bool ok = m2 > 1e-30f;  // z == 0 contributes phase 0
        const float mag = rsqrtf(fmaxf(m2, 1e-30f));
        const float fr = ok ? zr * mag : 1.f, fi = ok ? zi * mag : 0.f;
        const float qr = ppr[r] * fr - ppi[r] * fi;
        const float qi = ppr[r] * fi + ppi[r] * fr;
        ppr[r] = qr;
        ppi[r] = qi;
      } else {
        pl[r] += pa[r] + a.SC[t * 4 + xi];
      }
      ua[r] += xi & 1;
      ub[r] += xi >> 1;
    }
    if constexpr (MODE == MODE_PARENT) {  // the state after position t into sh
      const int rows[2] = {rg, rh};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (rows[r] < N) {
          const float2 v = cq == 0   ? make_float2(la[r], ppr[r])
                           : cq == 1 ? make_float2(ppi[r], pl[r])
                           : cq == 2 ? make_float2((float)ua[r], (float)ub[r])
                                     : make_float2(0.f, 0.f);
          *reinterpret_cast<float2*>(a.sh + ((size_t)rows[r] * norb + t) * NSTATE + 2 * cq) = v;
        }
      }
    }
  }
  cp_async_wait<0>();

  if (cq == 0) {
    const int rows[2] = {rg, rh};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (rows[r] < N) {
        float* o = a.out + (size_t)rows[r] * 4;
        o[0] = la[r];
        o[1] = ppr[r];
        o[2] = ppi[r];
        o[3] = pl[r];
      }
    }
  }
}

// Whether a launch shape is one the kernel takes: warps of 16 rows per
// CTA (4 or 8 for the flat forward, 4 above dp 128; 1, 2, 4 or 8 for the
// prefix passes), the slots in shared memory (slots_shared) or in global
// memory, and smem bytes of dynamic shared memory that hold the stages
// and the slots (each warp's nslots hidden slots of dp / 8 x 512 bytes,
// twice that in f32, its coupling slot of ncs k-steps and, in npass > 1
// passes, its scratch of npass x 16 n-tiles).  The host
// (pynqs_tpu_torch/ops/fused_rnn.py::mma_launch_shape) chooses the shape.
bool shape_ok(int mode, int prec, int dp, int npass, int nslots, int ncs, int warps,
              int slots_shared, int smem) {
  const bool w_ok = mode == MODE_FLAT ? (warps == 4 || (warps == 8 && npass == 1))
                                      : (warps == 1 || warps == 2 || warps == 4 || warps == 8);
  const long slot = (long)dp / 8 * 512 * (prec == PREC_F32X3 ? 2 : 1);  // one slot of one warp
  const long file = (long)nslots * slot + (long)ncs * 512 +
                    (npass > 1 ? (long)npass * 16 * 512 : 0);  // one warp's slots
  const long need = (long)STAGES * STAGE_U4 * 16 + (slots_shared ? warps * file : 0);
  return w_ok && nslots >= 1 && smem >= need && smem <= SMEM_LIMIT;
}

template <int NP, int WARPS, int MODE, int PREC, bool WIDE>
cudaError_t launch(const Args& a, int warps, int smem, cudaStream_t stream) {
  auto kern = fused_rnn_mma_kernel<NP, WARPS, MODE, PREC, WIDE>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int rows = warps * 16;
  kern<<<(a.N + rows - 1) / rows, warps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

// the flat forward's warp count is a template argument (4 above dp 128),
// the prefix passes' a runtime value
template <int NP, int MODE, int PREC, bool WIDE = false>
cudaError_t launch_np(const Args& a, int warps, int smem, cudaStream_t stream) {
  if constexpr (MODE == MODE_FLAT && WIDE)
    return launch<NP, 4, MODE, PREC, WIDE>(a, warps, smem, stream);
  else if constexpr (MODE == MODE_FLAT)
    return warps == 8 ? launch<NP, 8, MODE, PREC, WIDE>(a, warps, smem, stream)
                      : launch<NP, 4, MODE, PREC, WIDE>(a, warps, smem, stream);
  else
    return launch<NP, 0, MODE, PREC, WIDE>(a, warps, smem, stream);
}

// dp 16, 32, 48, 64, 96 or 128 in registers, or a multiple of 64 above
// 128 in dp / 64 passes of 128 outputs
template <int MODE, int PREC>
int run(const Args& args, int dp, int warps, int slots_shared, int smem, void* stream) {
  const bool wide = dp > 128;
  if (wide ? dp % 64 != 0
           : (dp != 16 && dp != 32 && dp != 48 && dp != 64 && dp != 96 && dp != 128))
    return (int)cudaErrorInvalidValue;
  Args a = args;
  a.npass = wide ? dp / 64 : 1;
  if (a.use_tensor && a.dcp != 4 && (a.dcp <= 0 || a.dcp % 8 != 0))
    return (int)cudaErrorInvalidValue;
  const int ncs = 4 * coupling_ksteps(a.use_tensor, a.dcp, PREC);
  if (!shape_ok(MODE, PREC, dp, a.npass, a.nslots, ncs, warps, slots_shared, smem))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (wide) return (int)launch_np<8, MODE, PREC, true>(a, warps, smem, s);
  switch (dp / 8) {
    case 2: e = launch_np<2, MODE, PREC>(a, warps, smem, s); break;
    case 4: e = launch_np<4, MODE, PREC>(a, warps, smem, s); break;
    case 6: e = launch_np<6, MODE, PREC>(a, warps, smem, s); break;
    case 8: e = launch_np<8, MODE, PREC>(a, warps, smem, s); break;
    case 12: e = launch_np<12, MODE, PREC>(a, warps, smem, s); break;
    default: e = launch_np<16, MODE, PREC>(a, warps, smem, s); break;
  }
  return (int)e;
}

// The arguments every entry point shares; a chain without the tensor
// coupling unless the flat entry point says otherwise.
Args make_args(const void* vals, int N, int norb, int d, const void* order, const void* npred,
               const void* slot_w, const void* slot_r, int nslots, const void* tab,
               const void* chunks, int nchunks, const void* vcat, const void* E,
               const void* PW, const void* SC, int noa, int nob, int phase_arg,
               int norm_mpsrnn, int slots_shared, void* gslots, void* out) {
  Args a = {};
  a.vals = static_cast<const int8_t*>(vals);
  a.N = N;
  a.norb = norb;
  a.d = d;
  a.mp = 1;
  a.order = static_cast<const int*>(order);
  a.npred = static_cast<const int*>(npred);
  a.slot_w = static_cast<const int*>(slot_w);
  a.slot_r = static_cast<const int*>(slot_r);
  a.nslots = nslots;
  a.tab = static_cast<const uint4*>(tab);
  a.chunks = static_cast<const int*>(chunks);
  a.nchunks = nchunks;
  a.vcat = static_cast<const float*>(vcat);
  a.E = static_cast<const float*>(E);
  a.PW = static_cast<const float*>(PW);
  a.SC = static_cast<const float*>(SC);
  a.noa = noa;
  a.nob = nob;
  a.phase_arg = phase_arg;
  a.norm_mpsrnn = norm_mpsrnn;
  a.use_tensor = 0;
  a.dcp = 4;
  a.gslots = slots_shared ? nullptr : static_cast<uint4*>(gslots);
  a.out = static_cast<float*>(out);
  return a;
}

// The launch arguments every entry point shares, and their names.
#define FORWARD_PARAMS                                                                      \
  const void *vals, int N, int norb, int d, int dp, const void *order, const void *npred,   \
      const void *slot_w, const void *slot_r, int nslots, const void *tab,                  \
      const void *chunks, int nchunks, const void *vcat, const void *E, const void *PW,     \
      const void *SC, int noa, int nob, int phase_arg, int norm_mpsrnn
#define FORWARD_ARGS                                                                        \
  vals, N, norb, d, dp, order, npred, slot_w, slot_r, nslots, tab, chunks, nchunks, vcat, \
      E, PW, SC, noa, nob, phase_arg, norm_mpsrnn

template <int PREC>
int forward(FORWARD_PARAMS, int mp, int use_tensor, int dcp, int warps, int slots_shared, int smem,
            void* gslots, void* out, void* stream) {
  Args a = make_args(vals, N, norb, d, order, npred, slot_w, slot_r, nslots, tab, chunks,
                     nchunks, vcat, E, PW, SC, noa, nob, phase_arg, norm_mpsrnn, slots_shared,
                     gslots, out);
  a.mp = mp;
  a.use_tensor = use_tensor;
  a.dcp = use_tensor ? dcp : 4;
  return run<MODE_FLAT, PREC>(a, dp, warps, slots_shared, smem, stream);
}

template <int PREC>
int prefix_parent(FORWARD_PARAMS, int warps, int slots_shared, int smem, void* gslots, void* hh,
                  void* sh, void* out, void* stream) {
  Args a = make_args(vals, N, norb, d, order, npred, slot_w, slot_r, nslots, tab, chunks,
                     nchunks, vcat, E, PW, SC, noa, nob, phase_arg, norm_mpsrnn, slots_shared,
                     gslots, out);
  a.hh = static_cast<float*>(hh);
  a.sh = static_cast<float*>(sh);
  return run<MODE_PARENT, PREC>(a, dp, warps, slots_shared, smem, stream);
}

template <int PREC>
int prefix_child(FORWARD_PARAMS, int warps, int slots_shared, int smem, void* gslots,
                 const void* site_chunk, const void* s0, const void* parent, const void* hh,
                 const void* sh, void* out, void* stream) {
  Args a = make_args(vals, N, norb, d, order, npred, slot_w, slot_r, nslots, tab, chunks,
                     nchunks, vcat, E, PW, SC, noa, nob, phase_arg, norm_mpsrnn, slots_shared,
                     gslots, out);
  a.site_chunk = static_cast<const int*>(site_chunk);
  a.s0 = static_cast<const int*>(s0);
  a.parent = static_cast<const int*>(parent);
  a.hh = const_cast<float*>(static_cast<const float*>(hh));
  a.sh = const_cast<float*>(static_cast<const float*>(sh));
  return run<MODE_CHILD, PREC>(a, dp, warps, slots_shared, smem, stream);
}

}  // namespace

// Plain C entry points (loaded with ctypes), each in bf16 and, as three
// TF32 products per product, in f32 (``_f32``).  Operands as
// pynqs_tpu_torch/ops/fused_rnn.py::pack_mma_tables lays them out in the
// entry point's precision; the launch shape (warps, slots_shared, smem)
// as mma_launch_shape gives it; gslots is the global slot file where
// slots_shared is 0 (grid * warps * (nslots * dp / 8 * 512 bytes, twice
// that in f32, + the coupling slot's 4 * nkw * 512)), else ignored.  Each
// launches on ``stream`` and returns cudaGetLastError() of the launch, or
// cudaErrorInvalidValue for a width or shape the kernel does not take
// (dp as mma_width gives it: 16, 32, 48, 64, 96, 128 or a multiple of 64
// above; dcp, the padded dcut_cmpr, must be 4 or a multiple of 8).
// The flat forward (kernel #1): a DAG of up to mp predecessors per site,
// with the tensor coupling where use_tensor.
extern "C" int fused_rnn_forward_mma(FORWARD_PARAMS, int mp, int use_tensor, int dcp, int warps,
                                     int slots_shared, int smem, void* gslots, void* out,
                                     void* stream) {
  return forward<PREC_BF16>(FORWARD_ARGS, mp, use_tensor, dcp, warps, slots_shared, smem,
                            gslots, out, stream);
}
extern "C" int fused_rnn_forward_mma_f32(FORWARD_PARAMS, int mp, int use_tensor, int dcp,
                                         int warps, int slots_shared, int smem, void* gslots,
                                         void* out, void* stream) {
  return forward<PREC_F32X3>(FORWARD_ARGS, mp, use_tensor, dcp, warps, slots_shared, smem,
                             gslots, out, stream);
}

// The parent pass of the prefix-sharing forward (kernel #2, chains): the
// flat walk that also writes hh [N, norb, 2d] and sh [N, norb, 8] f32
// after every position.
extern "C" int fused_rnn_prefix_parent_mma(FORWARD_PARAMS, int warps, int slots_shared, int smem,
                                           void* gslots, void* hh, void* sh, void* out,
                                           void* stream) {
  return prefix_parent<PREC_BF16>(FORWARD_ARGS, warps, slots_shared, smem, gslots, hh, sh, out,
                                  stream);
}
extern "C" int fused_rnn_prefix_parent_mma_f32(FORWARD_PARAMS, int warps, int slots_shared,
                                               int smem, void* gslots, void* hh, void* sh,
                                               void* out, void* stream) {
  return prefix_parent<PREC_F32X3>(FORWARD_ARGS, warps, slots_shared, smem, gslots, hh, sh, out,
                                   stream);
}

// The child pass (kernel #3, chains): row r starts at position s0[r]
// (rows sorted by s0 for the savings; any order is correct) from the
// state of parent row parent[r] in hh/sh; site_chunk [norb + 1] is each
// position's first chunk of the weight stream.
extern "C" int fused_rnn_prefix_child_mma(FORWARD_PARAMS, int warps, int slots_shared, int smem,
                                          void* gslots, const void* site_chunk, const void* s0,
                                          const void* parent, const void* hh, const void* sh,
                                          void* out, void* stream) {
  return prefix_child<PREC_BF16>(FORWARD_ARGS, warps, slots_shared, smem, gslots, site_chunk, s0,
                                 parent, hh, sh, out, stream);
}
extern "C" int fused_rnn_prefix_child_mma_f32(FORWARD_PARAMS, int warps, int slots_shared,
                                              int smem, void* gslots, const void* site_chunk,
                                              const void* s0, const void* parent, const void* hh,
                                              const void* sh, void* out, void* stream) {
  return prefix_child<PREC_F32X3>(FORWARD_ARGS, warps, slots_shared, smem, gslots, site_chunk,
                                  s0, parent, hh, sh, out, stream);
}
