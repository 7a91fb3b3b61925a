// DLL/PLL lag-bank correlation for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `lag_bank_pallas` of the JAX package
// (amaranth_twstft_tpu/ops/lagbank.py:73-124, body `_kernel` :41-70): for
// G channels x P codes,
//
//   re[g,p,l] = sum_n obs[g,0,p,n] * W_g[n,l]      im: the same with obs[g,1]
//   power     = scale * (re^2 + im^2)             (0.5 in the JAX contract)
//   phase     = atan2(-im, re) / 2pi              (rxcomplex.cpp:1070 sign)
//
// W_g[n,l] = w[g*w_g + w_off + n*w_n + l*w_l] covers both of the port's
// inputs: the explicit (K, NL) lag matrix of `lag_bank_correlate`
// (w_n = NL, w_l = 1) and the banked tracker's shifted windows of the
// circular replica extension, W_g[n,l] = wav_ext[g, 2*nlag - l + n]
// (w_n = 1, w_l = -1), which needs no (NL, K) copy per channel.  The TPU
// could not lower atan2, so it took the phase outside its kernel; here
// the epilogue is fused.
//
// Window form (the tracker's main path): tensor cores.
//   Per channel the work is one product D[l, r] = sum_n W[l, n] X[r, n]:
//   l over the lags (4 m16 tiles, 64 lags), r over the 2P obs rows (6 n8
//   tiles, 48 rows per block), n over K.  `mma.sync.m16n8k8` with tf32
//   operands and fp32 accumulators, each operand split in registers into
//   big = tf32(x) and small = tf32(x - big) and accumulated as
//   small*big + big*small + big*big (3xTF32): fp32-class error, where one
//   tf32 pass (10-bit mantissas) would break the 1e-4 power tolerance
//   (PARITY deviation 12).  torch's own TF32 stays off.
//   - A fragments are Toeplitz: W[l, n] = window[n - l], so each thread
//     builds its 16 A values from the chunk's replica window (staged once
//     per block) and slides them along in registers, two new values per
//     k8 step.  No (K, NL) lag matrix exists anywhere.
//   - obs tiles (48 rows x 128 samples) arrive by `cp.async.bulk` (one
//     1-D bulk copy per row, completion on an mbarrier) into a 3-stage
//     ring in their natural [row][sample] layout, padded to a row stride
//     of 132 floats so the B-fragment loads (k = lane%4, n = lane/4) are
//     free of bank conflicts.  One producer warp keeps the copies in
//     flight; four consumer warps (2 K-halves x 2 row-halves) wait on the
//     stage's full barrier and release it on its empty barrier.
//   - The tensor core adds with truncation, so a chain of products over a
//     whole chunk would lose the low bits of the running sum (~1e-5 of
//     the row maximum at production).  Each stage's chain restarts from
//     zero and is then added to an IEEE fp32 sum per lane in shared
//     memory: ~1e-6 against float64, below the fp32 cuBLAS product's
//     error at the production shape.
//   - split-K over blocks of kb samples; the K-half sums are added in a
//     fixed order, and the second pass sums the chunks in a fixed order
//     and applies the epilogue: no atomics, so two launches give the same
//     bits.
//   Bound on the card: at the production group (G, P, K, NL) =
//   (8, 24, 200 000, 57) the kernel must read 3.07e8 B of obs once
//   (0.092 ms at 3.35 TB/s) and do 3 x 8.75e9 tf32 FLOP (0.053 ms at the
//   495 TFLOP/s dense TF32 peak of `wgmma`).  `mma.sync` reaches only part
//   of that peak, and with the lags padded to 64 the products alone take
//   longer than the copies alone (PERF.md), so the kernel is bounded by
//   the `mma.sync` rate first and bulk-copy throughput next; `wgmma` is
//   the step after this one.  The bulk copies need 16-byte-aligned rows:
//   the launcher refuses other layouts and the Python wrapper pads obs
//   with zeros to a K that is a multiple of 4.
//
// Explicit (K, NL) form (the host receiver's `lag_bank_correlate`): the
// same compensated 3xTF32 `mma.sync` products, with BOTH operands
// streamed, since the lag matrix is an input like obs.
//   The product is skinny and long: at the host shape, M = 2P = 48 obs
//   rows, N = NL = 57 lags, K = 200 000 samples, 13 FLOP per byte.  Its
//   floor is reading obs (38.4 MB) and the matrix (45.6 MB) once, 0.0251
//   ms at 3.35 TB/s; 3 x 1.094e9 tf32 FLOP take 0.0066 ms at 495
//   TFLOP/s (fp32 FFMA, 0.0163 ms at 67 TFLOP/s, would sit too close to
//   the floor to hide behind the copies).  So the design keeps bytes in
//   flight:
//   - split-K over chunks of `kb` samples that the Python wrapper picks
//     (ops/lagbank.explicit_chunk) so that the grid is two blocks per SM
//     for the whole launch: 264 chunks of 760 at the host shape;
//   - a ring of kXS-sample stages, as deep (up to four) as two resident
//     blocks per SM allow (explicit_ring), filled by one producer warp
//     with `cp.async.bulk`: one 1-D copy per obs row and ONE copy of the
//     stage's kXS contiguous matrix rows (a TMA tensor map cannot take
//     the matrix: its 228-byte row pitch is not a multiple of 16); with
//     four stages of 27 KB, up to three are in flight per block;
//   - A fragments (lags x samples) straight from the [n][w_n] stage (the
//     odd pitch of 57 leaves few bank conflicts), B fragments from the
//     obs rows as in the window form; lags past NL in the last m16 tile
//     read neighbouring floats, and their rows of the result are dropped;
//   - each stage's chain is added to an IEEE fp32 sum per lane, in
//     registers; the K-halves and the chunks are summed in a fixed order
//     (the second pass), so two launches give the same bits;
//   - the K tail is masked in the kernel: the last rows of the matrix go
//     by a bulk copy of whole 16-byte units and at most three plain
//     loads, so the receiver's cached matrix is never copied per call.
//   The launcher refuses every layout but the window form's and this
//   row-major one (w_l = 1, w_n >= NL).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Args {
  const float* obs;
  int64_t obs_g, obs_c, obs_p;  // element strides; stride along n is 1
  const float* w;
  int64_t w_g, w_n, w_l, w_off, w_len;
  int P, K, NL;
  int kb;       // samples per block
  int nchunk;   // ceil(K / kb)
  float* part;  // (G, nchunk, 2, P, NL) partial sums
};

// ---------------------------------------------------------------------
// Window form: 3xTF32 mma.sync fed by a cp.async.bulk ring
// ---------------------------------------------------------------------
constexpr int kBK = 128;                 // samples per ring stage
constexpr int kStages = 3;               // ring depth
constexpr int kRows = 48;                // obs rows (re/im x code) per block
constexpr int kRowStride = kBK + 4;      // conflict-free B-fragment loads
constexpr int kLags = 64;                // lags per block: 4 m16 tiles
constexpr int kMT = kLags / 16;
constexpr int kRowGroups = 2;            // consumer warps along the rows
constexpr int kKSplit = 2;               // consumer warps along each stage's K
constexpr int kNT = kRows / (8 * kRowGroups);  // n8 tiles per consumer warp
constexpr int kConsumerWarps = kRowGroups * kKSplit;
constexpr int kWinThreads = 32 * (kConsumerWarps + 1);
constexpr int kKPart = kBK / kKSplit;    // samples per consumer warp and stage
constexpr int kStageFloats = kRows * kRowStride;
constexpr int kVals = kMT * kNT * 4;     // accumulators per lane
static_assert(kRowGroups * kNT * 8 == kRows, "row groups of whole n8 tiles");

struct WinArgs {
  const float* obs;
  int64_t obs_g, obs_c, obs_p;  // element strides; stride along n is 1
  const float* w;
  int64_t w_g, w_off, w_len;    // W_g[n, l] = w[g*w_g + w_off + n - l]
  int P, K, NL;
  int kb;       // samples per block (multiple of kBK)
  int nchunk;   // ceil(K / kb)
  int rblocks;  // ceil(2P / kRows)
  float* part;  // (G, nchunk, 2, P, NL) partial sums
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// 1-D bulk copy global -> shared; completion counted on `bar` in bytes
__device__ __forceinline__ void bulk_g2s(float* dst, const float* src,
                                         uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// x = big + small, both tf32 rounded to nearest (ties away, as
// cvt.rna.tf32.f32) by integer arithmetic on the bits, with the low 13
// bits cleared as the tensor core reads them; `small` is taken from the
// rounded `big`.  Finite inputs only.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = (__float_as_uint(x - __uint_as_float(big)) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// One consumer warp's part of one ring stage: kKPart / 8 k8 steps.
//   st: this lane's B element of the stage, row (row group + n/4), sample tq
//   wv: s_w + (chunk sample of the part's first k8 step) + 63 + tq - gq
//   lim: valid samples in this part (MASK: zero the rest of B)
// A fragment of m-tile i at k8 step jj (fragment rows are lags):
//   a0 = A[gq][tq] = window[j0 + tq - (16i + gq)], so with
//   v[q] = wv[8 jj + 4 - 4q]: a0 = v[4i+1], a1 = v[4i+3], a2 = v[4i],
//   a3 = v[4i+2]; from one k8 step to the next v[q] <- v[q-2].
template <bool MASK>
__device__ __forceinline__ void consume_part(float (&acc)[kMT][kNT][4],
                                             const float* __restrict__ st,
                                             const float* __restrict__ wv,
                                             int tq, int lim) {
  uint32_t vb[4 * kMT], vs[4 * kMT];
#pragma unroll
  for (int q = 0; q < 4 * kMT; ++q) split_tf32(wv[4 - 4 * q], vb[q], vs[q]);
#pragma unroll
  for (int jj = 0; jj < kKPart / 8; ++jj) {
    if (jj > 0) {
#pragma unroll
      for (int q = 4 * kMT - 1; q >= 2; --q) {
        vb[q] = vb[q - 2];
        vs[q] = vs[q - 2];
      }
      split_tf32(wv[8 * jj + 4], vb[0], vs[0]);
      split_tf32(wv[8 * jj], vb[1], vs[1]);
    }
    uint32_t bb[kNT][2], bs[kNT][2];
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      float x0 = st[n * 8 * kRowStride + 8 * jj];
      float x1 = st[n * 8 * kRowStride + 8 * jj + 4];
      if (MASK) {
        x0 = (8 * jj + tq < lim) ? x0 : 0.f;
        x1 = (8 * jj + tq + 4 < lim) ? x1 : 0.f;
      }
      split_tf32(x0, bb[n][0], bs[n][0]);
      split_tf32(x1, bb[n][1], bs[n][1]);
    }
    // the small cross terms first, then big*big; kMT * kNT independent
    // accumulators between two products into the same one
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int n = 0; n < kNT; ++n)
        mma_tf32(acc[i][n], vs[4 * i + 1], vs[4 * i + 3], vs[4 * i],
                 vs[4 * i + 2], bb[n][0], bb[n][1]);
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int n = 0; n < kNT; ++n)
        mma_tf32(acc[i][n], vb[4 * i + 1], vb[4 * i + 3], vb[4 * i],
                 vb[4 * i + 2], bs[n][0], bs[n][1]);
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int n = 0; n < kNT; ++n)
        mma_tf32(acc[i][n], vb[4 * i + 1], vb[4 * i + 3], vb[4 * i],
                 vb[4 * i + 2], bb[n][0], bb[n][1]);
  }
}

// One block per (K-chunk, channel, row block x lag block).
__global__ void __launch_bounds__(kWinThreads, 2)
    lagbank_window_kernel(const WinArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* empty = full + kStages;
  float* ring = reinterpret_cast<float*>(full + 2 * kStages);
  float* s_w = ring + kStages * kStageFloats;
  float* tot = s_w + a.kb + kLags;  // [consumer warp][value][lane]

  const int chunk = blockIdx.x;
  const int g = blockIdx.y;
  const int r0 = (blockIdx.z % a.rblocks) * kRows;
  const int lb = (blockIdx.z / a.rblocks) * kLags;
  const int rows = min(kRows, 2 * a.P - r0);
  const int64_t k_begin = (int64_t)chunk * a.kb;
  const int len = (int)min((int64_t)a.kb, (int64_t)a.K - k_begin);
  const int nsteps = (len + kBK - 1) / kBK;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int kw = warp % kKSplit;  // K part of each stage
  const int nw = warp / kKSplit;  // row group of the block
  const int gq = lane >> 2;
  const int tq = lane & 3;

  if (warp == kConsumerWarps) {
    // -- producer: one bulk copy per obs row and stage -----------------
    const float* obs_g = a.obs + (int64_t)g * a.obs_g;
    for (int step = 0; step < nsteps; ++step) {
      const int s = step % kStages;
      if (step >= kStages) mbar_wait(&empty[s], (step / kStages - 1) & 1);
      const int n0 = step * kBK;
      const uint32_t row_bytes = 4u * (uint32_t)min(kBK, len - n0);
      if (lane == 0) mbar_arrive_expect_tx(&full[s], row_bytes * rows);
      __syncwarp();
      float* dst = ring + s * kStageFloats;
      for (int r = lane; r < rows; r += 32) {
        const int rr = r0 + r;
        const int c = rr / a.P;
        const int p = rr - c * a.P;
        bulk_g2s(dst + r * kRowStride,
                 obs_g + c * a.obs_c + p * a.obs_p + k_begin + n0, row_bytes,
                 &full[s]);
      }
    }
  } else {
    // -- consumers --------------------------------------------------------
    // the chunk's replica window, staged while the first copies fly:
    // s_w[i] = W(k_begin + i - (kLags-1), lb)
    //        = w[w_off + k_begin - lb - (kLags-1) + i], zero outside the row
    const float* wg = a.w + (int64_t)g * a.w_g;
    const int64_t base = a.w_off + k_begin - lb - (kLags - 1);
    const int nwin = nsteps * kBK + kLags - 1;
    for (int i = threadIdx.x; i < nwin; i += 32 * kConsumerWarps) {
      const int64_t idx = base + i;
      s_w[i] = (idx >= 0 && idx < a.w_len) ? wg[idx] : 0.f;
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kConsumerWarps) : "memory");
    // The tensor core adds with truncation, so a long chain of products
    // into one accumulator loses the low bits of the running sum: after
    // each stage the chain is added to this lane's IEEE fp32 sum in
    // shared memory and restarts from zero.
    float* mine = tot + warp * kVals * 32 + lane;
    for (int v = 0; v < kVals; ++v) mine[v * 32] = 0.f;
    float acc[kMT][kNT][4];
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;
    const int jbeg = kw * kKPart;
    for (int step = 0; step < nsteps; ++step) {
      const int s = step % kStages;
      mbar_wait(&full[s], (step / kStages) & 1);
      const int lim = min(kBK, len - step * kBK) - jbeg;
      const float* st = ring + s * kStageFloats +
                        (nw * kNT * 8 + gq) * kRowStride + jbeg + tq;
      const float* wv = s_w + step * kBK + jbeg + (kLags - 1) + tq - gq;
      if (lim >= kKPart) {
        consume_part<false>(acc, st, wv, tq, lim);
      } else if (lim > 0) {
        consume_part<true>(acc, st, wv, tq, lim);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int n = 0; n < kNT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            mine[((i * kNT + n) * 4 + e) * 32] += acc[i][n][e];
            acc[i][n][e] = 0.f;
          }
    }
  }
  __syncthreads();

  // -- K part 0 of each row group adds the K parts' sums in order and
  //    stores the block's partial
  if (warp < kConsumerWarps && kw == 0) {
    const int two_p = 2 * a.P;
    float* out = a.part + ((int64_t)g * a.nchunk + chunk) * two_p * a.NL;
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float v = 0.f;
          for (int k = 0; k < kKSplit; ++k)
            v += tot[((nw * kKSplit + k) * kVals + (i * kNT + n) * 4 + e) * 32 +
                     lane];
          // D fragment: row (lag) gq (+8 for e >= 2), column (obs row)
          // 2 tq + (e & 1)
          const int l = lb + 16 * i + gq + (e >> 1) * 8;
          const int r = r0 + nw * kNT * 8 + n * 8 + 2 * tq + (e & 1);
          if (l < a.NL && r < two_p) out[(int64_t)r * a.NL + l] = v;
        }
  }
}

// ---------------------------------------------------------------------
// Explicit (K, NL) form: 3xTF32 mma.sync fed by a cp.async.bulk ring of
// both operands
// ---------------------------------------------------------------------
constexpr int kXS = 64;                // samples (matrix rows) per ring stage
constexpr int kXPart = kXS / kKSplit;  // samples per consumer warp and stage
constexpr int kXRowStride = kXS + 4;   // conflict-free B-fragment loads
constexpr int kXObsFloats = kRows * kXRowStride;
constexpr int kXMaxRing = 4;
static_assert(kXPart % 8 == 0, "whole k8 steps per consumer warp");
static_assert(kKSplit == 2, "one K part hands its sums to the other");
static_assert(kRowGroups * kVals * 32 <= 2 * kXObsFloats,
              "the K parts' exchange fits in two obs stages");

struct XArgs {
  const float* obs;
  int64_t obs_g, obs_c, obs_p;  // element strides; stride along n is 1
  const float* w;               // W_g[n, l] = w[g*w_g + n*w_n + l]
  int64_t w_g, w_n;
  int P, K, NL;
  int kb;       // samples per block (a multiple of 4)
  int nchunk;   // ceil(K / kb)
  int rblocks;  // ceil(2P / kRows)
  int ring;     // ring stages, 2..kXMaxRing
  float* part;  // (G, nchunk, 2, P, NL) partial sums
};

// One consumer warp's part of one explicit-form stage: kXPart / 8 k8 steps.
//   st: this lane's B element of the stage, row (row group + n/4), sample tq
//   wt: this lane's A element, stage row (part's first sample + tq), lag gq
//       of the block's first m16 tile
//   wn: the stage's row pitch (the matrix's)
//   lim: valid samples in this part (MASK: zero the rest of A and B, whose
//        shared memory holds whatever an earlier stage left there)
// A fragment of m-tile i at k8 step jj (fragment rows are lags):
//   a0 = W[8jj + tq][16i + gq], a1 = W[8jj + tq][16i + gq + 8],
//   a2 = W[8jj + tq + 4][16i + gq], a3 = W[8jj + tq + 4][16i + gq + 8].
template <bool MASK>
__device__ __forceinline__ void consume_explicit(float (&acc)[kMT][kNT][4],
                                                 const float* __restrict__ st,
                                                 const float* __restrict__ wt,
                                                 int wn, int tq, int lim) {
#pragma unroll
  for (int jj = 0; jj < kXPart / 8; ++jj) {
    const float* w0 = wt + 8 * jj * wn;
    const float* w1 = w0 + 4 * wn;
    const bool ok0 = !MASK || 8 * jj + tq < lim;
    const bool ok1 = !MASK || 8 * jj + tq + 4 < lim;
    uint32_t ab[kMT][4], as[kMT][4];
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
      split_tf32(ok0 ? w0[16 * i] : 0.f, ab[i][0], as[i][0]);
      split_tf32(ok0 ? w0[16 * i + 8] : 0.f, ab[i][1], as[i][1]);
      split_tf32(ok1 ? w1[16 * i] : 0.f, ab[i][2], as[i][2]);
      split_tf32(ok1 ? w1[16 * i + 8] : 0.f, ab[i][3], as[i][3]);
    }
    uint32_t bb[kNT][2], bs[kNT][2];
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      const float x0 = st[n * 8 * kXRowStride + 8 * jj];
      const float x1 = st[n * 8 * kXRowStride + 8 * jj + 4];
      split_tf32(ok0 ? x0 : 0.f, bb[n][0], bs[n][0]);
      split_tf32(ok1 ? x1 : 0.f, bb[n][1], bs[n][1]);
    }
    // the small cross terms first, then big*big
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int n = 0; n < kNT; ++n)
        mma_tf32(acc[i][n], as[i][0], as[i][1], as[i][2], as[i][3], bb[n][0],
                 bb[n][1]);
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int n = 0; n < kNT; ++n)
        mma_tf32(acc[i][n], ab[i][0], ab[i][1], ab[i][2], ab[i][3], bs[n][0],
                 bs[n][1]);
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int n = 0; n < kNT; ++n)
        mma_tf32(acc[i][n], ab[i][0], ab[i][1], ab[i][2], ab[i][3], bb[n][0],
                 bb[n][1]);
  }
}

// One block per (K-chunk, channel, row block x lag block); shared memory
// holds the barriers, the ring's matrix stages, then its obs stages.
__global__ void __launch_bounds__(kWinThreads, 2)
    lagbank_explicit_kernel(const XArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* empty = full + a.ring;
  const int wn = (int)a.w_n;
  const int w_stage = kXS * wn;  // floats of one stage's matrix rows
  float* w_ring = reinterpret_cast<float*>(empty + a.ring);
  float* x_ring = w_ring + a.ring * w_stage;

  const int chunk = blockIdx.x;
  const int g = blockIdx.y;
  const int r0 = (blockIdx.z % a.rblocks) * kRows;
  const int lb = (blockIdx.z / a.rblocks) * kLags;
  const int rows = min(kRows, 2 * a.P - r0);
  const int64_t k_begin = (int64_t)chunk * a.kb;
  const int len = (int)min((int64_t)a.kb, (int64_t)a.K - k_begin);
  const int nsteps = (len + kXS - 1) / kXS;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < a.ring; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int kw = warp % kKSplit;  // K part of each stage
  const int nw = warp / kKSplit;  // row group of the block
  const int gq = lane >> 2;
  const int tq = lane & 3;
  float sum[kMT][kNT][4];  // this lane's IEEE fp32 sums

  if (warp == kConsumerWarps) {
    // -- producer: per stage one bulk copy of the matrix rows, one per obs row
    const float* obs_g = a.obs + (int64_t)g * a.obs_g + k_begin;
    const float* w_g = a.w + (int64_t)g * a.w_g + k_begin * a.w_n;
    for (int step = 0; step < nsteps; ++step) {
      const int s = step % a.ring;
      if (step >= a.ring) mbar_wait(&empty[s], (step / a.ring - 1) & 1);
      const int n0 = step * kXS;
      const int lim = min(kXS, len - n0);
      // obs rows in whole float4s: each row holds K rounded up to 4
      const uint32_t x_bytes = 16u * (uint32_t)((lim + 3) / 4);
      // the stage's matrix rows end at lag NL - 1 of its last row; the
      // bulk copy takes whole 16-byte units, plain loads the rest
      const uint32_t w_floats = (uint32_t)((lim - 1) * wn + a.NL);
      const uint32_t w_bulk = (4u * w_floats) & ~15u;
      const float* wsrc = w_g + (int64_t)n0 * a.w_n;
      float* wdst = w_ring + s * w_stage;
      if (lane == 0) {
        for (uint32_t i = w_bulk / 4; i < w_floats; ++i) wdst[i] = wsrc[i];
        mbar_arrive_expect_tx(&full[s], x_bytes * rows + w_bulk);
      }
      __syncwarp();
      if (lane == 0 && w_bulk > 0) {
        bulk_g2s(wdst, wsrc, w_bulk, &full[s]);
      }
      float* xdst = x_ring + s * kXObsFloats;
      for (int r = lane; r < rows; r += 32) {
        const int rr = r0 + r;
        const int c = rr / a.P;
        const int p = rr - c * a.P;
        bulk_g2s(xdst + r * kXRowStride, obs_g + c * a.obs_c + p * a.obs_p + n0,
                 x_bytes, &full[s]);
      }
    }
  } else {
    // -- consumers --------------------------------------------------------
    float acc[kMT][kNT][4];
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][n][e] = sum[i][n][e] = 0.f;
    const int jbeg = kw * kXPart;
    for (int step = 0; step < nsteps; ++step) {
      const int s = step % a.ring;
      mbar_wait(&full[s], (step / a.ring) & 1);
      const int lim = min(kXS, len - step * kXS) - jbeg;
      const float* st = x_ring + s * kXObsFloats +
                        (nw * kNT * 8 + gq) * kXRowStride + jbeg + tq;
      const float* wt = w_ring + s * w_stage + (jbeg + tq) * wn + lb + gq;
      if (lim >= kXPart) {
        consume_explicit<false>(acc, st, wt, wn, tq, lim);
      } else if (lim > 0) {
        consume_explicit<true>(acc, st, wt, wn, tq, lim);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
      // the tensor core adds with truncation: one stage's chain, then the
      // IEEE fp32 sum
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int n = 0; n < kNT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sum[i][n][e] += acc[i][n][e];
            acc[i][n][e] = 0.f;
          }
    }
  }
  __syncthreads();

  // -- K part 1 of each row group hands its sums to K part 0 through the
  //    obs ring (every copy has landed and been read); part 0 adds them in
  //    order and stores the block's partial
  float* xch = x_ring + nw * kVals * 32 + lane;
  if (warp < kConsumerWarps && kw == 1) {
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) xch[((i * kNT + n) * 4 + e) * 32] = sum[i][n][e];
  }
  __syncthreads();
  if (warp < kConsumerWarps && kw == 0) {
    const int two_p = 2 * a.P;
    float* out = a.part + ((int64_t)g * a.nchunk + chunk) * two_p * a.NL;
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v = sum[i][n][e] + xch[((i * kNT + n) * 4 + e) * 32];
          // D fragment: row (lag) gq (+8 for e >= 2), column (obs row)
          // 2 tq + (e & 1)
          const int l = lb + 16 * i + gq + (e >> 1) * 8;
          const int r = r0 + nw * kNT * 8 + n * 8 + 2 * tq + (e & 1);
          if (l < a.NL && r < two_p) out[(int64_t)r * a.NL + l] = v;
        }
  }
}

// ---------------------------------------------------------------------
// Second pass: sum the K-chunks in order, fused power / phase epilogue
// ---------------------------------------------------------------------
constexpr int kFinOut = 32;    // outputs per finalize block (one per lane)
constexpr int kFinGroups = 8;  // chunk groups per output, one per warp

// Warp w sums chunks w, w + 8, ... of 32 neighbouring outputs (coalesced
// rows of `part`); warp 0 then adds the 8 group sums in order.
__global__ void __launch_bounds__(kFinOut * kFinGroups)
    lagbank_finalize_kernel(const float* __restrict__ part, int G, int nchunk,
                            int P, int NL, float scale,
                            float* __restrict__ power,
                            float* __restrict__ phase,
                            float* __restrict__ re_out,
                            float* __restrict__ im_out) {
  __shared__ float s_re[kFinGroups][kFinOut];
  __shared__ float s_im[kFinGroups][kFinOut];
  const int64_t pl = (int64_t)P * NL;
  const int o = threadIdx.x % kFinOut;
  const int cg = threadIdx.x / kFinOut;
  const int64_t idx = (int64_t)blockIdx.x * kFinOut + o;
  const bool valid = idx < (int64_t)G * pl;
  float re = 0.f;
  float im = 0.f;
  if (valid) {
    const float* base = part + (idx / pl) * nchunk * 2 * pl + idx % pl;
    for (int c = cg; c < nchunk; c += kFinGroups) {
      re += base[(int64_t)(2 * c) * pl];
      im += base[(int64_t)(2 * c + 1) * pl];
    }
  }
  s_re[cg][o] = re;
  s_im[cg][o] = im;
  __syncthreads();
  if (cg != 0 || !valid) return;
#pragma unroll
  for (int k = 1; k < kFinGroups; ++k) {
    re += s_re[k][o];
    im += s_im[k][o];
  }
  // unfused products: the same roundings as the plain version
  power[idx] = __fmul_rn(scale, __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im)));
  phase[idx] = atan2f(-im, re) / 6.28318530717958647692f;
  re_out[idx] = re;
  im_out[idx] = im;
}

constexpr int kMaxDevices = 64;

// Lets `kernel` take `smem` bytes of dynamic shared memory on the current
// device, calling cudaFuncSetAttribute only when a launch needs more than
// it has allowed there so far (`allowed`, bytes per device): a call per
// launch would cost more host time than a short launch's kernels take.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem, int (&allowed)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && (size_t)allowed[dev] >= smem) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && dev < kMaxDevices) allowed[dev] = (int)smem;
  return err;
}

// The explicit form's shared memory: the ring's barriers, matrix stages
// and obs stages
size_t explicit_smem(int ring, int64_t w_n) {
  return 2 * (size_t)ring * sizeof(uint64_t) +
         (size_t)ring * ((size_t)kXS * w_n + kXObsFloats) * sizeof(float);
}

// The explicit form's ring: the deepest (at most kXMaxRing stages) that
// keeps two blocks resident per SM (228 KB of shared memory, 1 KB of it
// reserved per block), else two stages in one block's 227 KB; 0 when
// even that does not fit the matrix's row pitch `w_n`.
int explicit_ring(int64_t w_n) {
  for (int ring = kXMaxRing; ring > 2; --ring)
    if (2 * (explicit_smem(ring, w_n) + 1024) <= 228 * 1024) return ring;
  return explicit_smem(2, w_n) <= 227 * 1024 ? 2 : 0;
}

int launch_explicit(const Args& a, int G, cudaStream_t s) {
  // bulk copies move 16-byte-aligned runs of whole float4s: obs rows and
  // the matrix's stages (rows from a multiple of 4, so any row pitch)
  const float* w = a.w + a.w_off;
  const bool aligned = reinterpret_cast<uintptr_t>(a.obs) % 16 == 0 &&
                       a.obs_g % 4 == 0 && a.obs_c % 4 == 0 &&
                       a.obs_p % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                       a.w_g % 4 == 0 && a.kb % 4 == 0;
  // every read within the channel's [0, w_len)
  const bool inside = a.w_off >= 0 && a.w_n >= a.NL &&
                      a.w_off + (int64_t)(a.K - 1) * a.w_n + a.NL <= a.w_len;
  const int ring = explicit_ring(a.w_n);
  if (!aligned || !inside || ring == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = explicit_smem(ring, a.w_n);
  XArgs x;
  x.obs = a.obs;
  x.obs_g = a.obs_g;
  x.obs_c = a.obs_c;
  x.obs_p = a.obs_p;
  x.w = w;
  x.w_g = a.w_g;
  x.w_n = a.w_n;
  x.P = a.P;
  x.K = a.K;
  x.NL = a.NL;
  x.kb = a.kb;
  x.nchunk = a.nchunk;
  x.rblocks = (2 * a.P + kRows - 1) / kRows;
  x.ring = ring;
  x.part = a.part;
  const int lblocks = (a.NL + kLags - 1) / kLags;
  if ((int64_t)x.rblocks * lblocks > 65535)
    return (int)cudaErrorInvalidValue;
  static int allowed[kMaxDevices] = {};
  const cudaError_t err = allow_smem(lagbank_explicit_kernel, smem, allowed);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.nchunk, G, x.rblocks * lblocks);
  lagbank_explicit_kernel<<<grid, kWinThreads, smem, s>>>(x);
  return (int)cudaGetLastError();
}

int launch_window(const Args& a, int G, cudaStream_t s) {
  // bulk copies move 16-byte-aligned rows of whole float4s
  const bool aligned = reinterpret_cast<uintptr_t>(a.obs) % 16 == 0 &&
                       a.obs_g % 4 == 0 && a.obs_c % 4 == 0 &&
                       a.obs_p % 4 == 0 && a.K % 4 == 0;
  if (!aligned || a.kb % kBK != 0) return (int)cudaErrorInvalidValue;
  WinArgs w;
  w.obs = a.obs;
  w.obs_g = a.obs_g;
  w.obs_c = a.obs_c;
  w.obs_p = a.obs_p;
  w.w = a.w;
  w.w_g = a.w_g;
  w.w_off = a.w_off;
  w.w_len = a.w_len;
  w.P = a.P;
  w.K = a.K;
  w.NL = a.NL;
  w.kb = a.kb;
  w.nchunk = a.nchunk;
  w.rblocks = (2 * a.P + kRows - 1) / kRows;
  w.part = a.part;
  const int lblocks = (a.NL + kLags - 1) / kLags;
  const size_t smem =
      2 * kStages * sizeof(uint64_t) +
      ((size_t)kStages * kStageFloats + a.kb + kLags +
       kConsumerWarps * kVals * 32) *
          sizeof(float);
  if (smem > 227 * 1024 || (int64_t)w.rblocks * lblocks > 65535)
    return (int)cudaErrorInvalidValue;
  static int allowed[kMaxDevices] = {};
  const cudaError_t err = allow_smem(lagbank_window_kernel, smem, allowed);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.nchunk, G, w.rblocks * lblocks);
  lagbank_window_kernel<<<grid, kWinThreads, smem, s>>>(w);
  return (int)cudaGetLastError();
}

// Makes `device` current for the launches and gives the caller's current
// device back at the end of the scope.
struct DeviceGuard {
  int prev = 0;
  bool switched = false;
  cudaError_t err = cudaSuccess;
  explicit DeviceGuard(int device) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != device) {
      err = cudaSetDevice(device);
      switched = err == cudaSuccess;
    }
  }
  ~DeviceGuard() {
    if (switched) cudaSetDevice(prev);
  }
};

}  // namespace

// Plain C entry point (bound with ctypes).  All pointers are device
// pointers; `part` is caller-allocated scratch of G*nchunk*2*P*NL floats
// with nchunk = ceil(K / kb).  Two layouts of W, every other refused:
// - the window layout (w_n = 1, w_l = -1) takes the window kernel and
//   needs 16-byte-aligned obs rows (obs pointer aligned, strides and K
//   multiples of 4);
// - the row-major layout (w_l = 1, w_n >= NL) takes the explicit kernel,
//   over chunks of kb samples (a multiple of 4, which
//   ops/lagbank.explicit_chunk picks) with the ring of explicit_ring(w_n);
//   it needs 16-byte-aligned obs (pointer aligned, strides multiples of
//   4, each row holding K rounded up to 4 floats) and W (w + w_off
//   aligned, w_g a multiple of 4), every read of W within a channel's
//   [0, w_len), and a pitch w_n for which a two-stage ring fits a block.
// Launches on `stream` of CUDA device `device` (made current for the
// launches, the caller's current device restored), does not synchronise,
// and returns the cudaError_t of the launches (0 = success).
extern "C" int lagbank_launch(const float* obs, long long obs_g,
                              long long obs_c, long long obs_p,
                              const float* w, long long w_g, long long w_n,
                              long long w_l, long long w_off, long long w_len,
                              int G, int P, int K, int NL, int kb,
                              float scale, float* part, float* power,
                              float* phase, float* re, float* im,
                              int device, void* stream) {
  if (G <= 0 || P <= 0 || K <= 0 || NL <= 0 || kb <= 0 || G > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const DeviceGuard on(device);
  if (on.err != cudaSuccess) return (int)on.err;
  Args a = {};
  a.obs = obs;
  a.obs_g = obs_g;
  a.obs_c = obs_c;
  a.obs_p = obs_p;
  a.w = w;
  a.w_g = w_g;
  a.w_n = w_n;
  a.w_l = w_l;
  a.w_off = w_off;
  a.w_len = w_len;
  a.P = P;
  a.K = K;
  a.NL = NL;
  a.kb = kb;
  a.nchunk = (K + kb - 1) / kb;
  a.part = part;

  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = (int)cudaErrorInvalidValue;
  if (w_n == 1 && w_l == -1) {
    err = launch_window(a, G, s);
  } else if (w_l == 1) {
    err = launch_explicit(a, G, s);
  }
  if (err != 0) return err;

  const int64_t total = (int64_t)G * P * NL;
  const unsigned fin_blocks = (unsigned)((total + kFinOut - 1) / kFinOut);
  lagbank_finalize_kernel<<<fin_blocks, kFinOut * kFinGroups, 0, s>>>(
      part, G, a.nchunk, P, NL, scale, power, phase, re, im);
  return (int)cudaGetLastError();
}
