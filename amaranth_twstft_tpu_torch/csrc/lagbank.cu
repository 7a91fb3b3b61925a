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
//   TFLOP/s.  Past 64 lags the matrix grows (322 MB at NL 403) and the
//   floor with it.  So the design keeps bytes in flight and does the obs
//   side once per span of lags:
//   - split-K over chunks of `kb` samples that the Python wrapper picks
//     (ops/lagbank.explicit_chunk) independently of NL, so that a lag's
//     sum has the same K order at every NL: 264 chunks of 760 at the host
//     shape;
//   - a block covers a chunk and a SPAN of lags in m16 tiles: up to 4
//     tiles with two lag warps (two blocks per SM), else up to 8 tiles
//     with four lag warps (one block per SM), balanced spans past 128
//     lags (NL 403: four spans of 7, 7, 7 and 5 tiles).  Each lag warp
//     holds two m16 tiles x all six n8 obs-row tiles (48 rows) and is
//     doubled over the two K halves of a stage, so each matrix value is
//     split into tf32 parts once per block and each obs value once per
//     warp for all its lag tiles; a warp past the span's lags idles (NL 65
//     runs 6 tiles of products, not 8); a chunk's spans are neighbours in
//     the launch, so its obs rows come from L2 after the first span reads
//     them;
//   - a ring of kXS-sample stages, as deep as the blocks per SM allow (up
//     to three at two blocks per SM, four at one: explicit_ring), filled
//     with `cp.async.bulk` by WL producer warps (a warp issued one copy
//     per ~40 ns whatever its size on an NVIDIA H100 80GB HBM3 at 700 W,
//     so one warp could not keep up with 112 copies a stage): one 1-D copy
//     per obs row, and the stage's matrix rows in one of two layouts (a
//     TMA tensor map cannot take the matrix: its 228-byte row pitch is not
//     a multiple of 16):
//     * whole rows: ONE copy of the stage's kXS contiguous rows, pitch
//       w_n, while one span holds every lag (NL <= 128) and its ring is as
//       deep as the windows';
//     * windows: one copy per row of the span's lags (512 bytes at 128
//       lags), from the 16-byte unit that holds its first lag, into a pitch
//       of x_pitch floats (the window's first lag lands at column
//       (n * w_n) % 4 of stage row n, the same for rows 4 apart), so the
//       stage does not grow with NL or w_n: any NL and pitch run;
//   - A fragments (lags x samples) straight from the stage, B fragments
//     from the obs rows as in the window form; lags past NL in the last
//     m16 tile read neighbouring floats, and their rows are dropped;
//   - each stage's chain is added to an IEEE fp32 sum per lane, in
//     registers, and the two K halves in a fixed order;
//   - ONE launch per call, whose last blocks sum the partials: every
//     block takes a ticket when it starts (an atomic counter in the
//     caller's workspace) and its role from it.  The first tickets are
//     the producers, one per (chunk x span, channel, row block), which
//     write their partial sums to the workspace and count their arrival;
//     the last `reducers` tickets (as many as the card holds at once, so
//     they start as the producers finish) wait for every arrival, then sum
//     each output's partials in a fixed order (24 interleaved chunk
//     groups, each in chunk order, then the groups in order) and apply
//     the epilogue.  A reducer waits only for blocks with lower tickets,
//     which have started and never wait, so the wait ends however few
//     blocks the card runs at once (another stream's kernels, other
//     processes).  The last reducer to finish sets the counters back to
//     zero, so the stream's next launch (or a CUDA graph's replay) starts
//     from zero with no host state.  The sum is spread over the reducers:
//     one block per output tile, summing alone, would read all its chunks'
//     partials (5.7 MB at NL 403).  No atomics touch the sums, so two
//     launches give the same bits;
//   - the K tail is masked in the kernel: the last rows of the matrix go
//     by bulk copies of whole 16-byte units and at most three plain loads
//     each, so the receiver's cached matrix is never copied per call.
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
  int kb;        // samples per block
  int nchunk;    // ceil(K / kb)
  float scale;   // of the power
  float* part;   // (G, nchunk, 2, P, NL) partial sums
  unsigned* ctr;  // the explicit form's counters, zero between launches
  float* out;    // power, phase, re, im, each (G, P, NL)
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
// Explicit (K, NL) form: 3xTF32 mma.sync over a span of lags, fed by a
// cp.async.bulk ring of both operands; the chunks' partials are summed in
// the same launch by the last blocks to start
// ---------------------------------------------------------------------
constexpr int kXS = 64;                 // samples (matrix rows) per ring stage
constexpr int kXHalf = kXS / 2;         // samples per K half and stage
constexpr int kXRowStride = kXS + 4;    // conflict-free B-fragment loads
constexpr int kXObsFloats = kRows * kXRowStride;
constexpr int kXMaxRing = 4;
constexpr int kXTiles = 2;              // m16 lag tiles per consumer warp
constexpr int kXNT = kRows / 8;         // n8 obs-row tiles per consumer warp
constexpr int kXVals = kXTiles * kXNT * 4;  // accumulators per lane
constexpr int kXHeader = 64;            // workspace floats before the partials
constexpr int kXGroups = 24;            // interleaved chunk groups of the sum
constexpr int kXTeam = 6;               // warps per reduction team
constexpr int kXBatch = 12;             // a reducing lane's loads in flight
static_assert(kXHalf % 8 == 0, "whole k8 steps per K half");
static_assert(kXTeam * 4 == kXGroups, "a team's lanes hold the groups of 8 outputs");

// With WL lag warps a block holds a span of x_span(WL) lags (WL x 2 m16
// tiles) and runs 2*WL consumer warps (two K halves) and WL producer
// warps; a window stage row has x_pitch(WL) floats (the span, up to 3
// floats before its first lag, 8 mod 32 for conflict-free A-fragment
// loads).
__host__ __device__ constexpr int x_span(int wl) { return 16 * kXTiles * wl; }
__host__ __device__ constexpr int x_pitch(int wl) { return x_span(wl) + 8; }
__host__ __device__ constexpr int x_threads(int wl) { return 32 * 3 * wl; }
static_assert(x_threads(2) % (32 * kXTeam) == 0 && x_threads(4) % (32 * kXTeam) == 0,
              "whole reduction teams");

struct XArgs {
  const float* obs;
  int64_t obs_g, obs_c, obs_p;  // element strides; stride along n is 1
  const float* w;               // W_g[n, l] = w[g*w_g + n*w_n + l]
  int64_t w_g, w_n;
  int64_t w_lim;                // floats of each channel readable from w
  int P, K, NL;
  int kb;          // samples per block (a multiple of 4)
  int nchunk;      // ceil(K / kb)
  int ring;        // ring stages, 2..kXMaxRing
  int span_tiles;  // m16 lag tiles per span
  int nspan;       // spans of lags
  int G;           // channels
  int nblocks;     // producer blocks: nchunk * nspan * G * row blocks
  int reducers;    // blocks after them that sum the partials
  float scale;
  float* part;     // (G, nchunk, 2, P, NL) partial sums
  unsigned* ctr;   // [0] tickets taken, [1] producers arrived, [2] reducers
                   // done; zero before and after each launch
  float* out;      // power, phase, re, im, each (G, P, NL)
};

// One consumer warp's K half of one explicit-form stage: kXHalf / 8 k8
// steps over its kXTiles m16 lag tiles and all kXNT n8 obs-row tiles.
//   st: this lane's B element of the stage, obs row gq, sample tq
//   wt: this lane's A element, stage row (half's first sample + tq), lag
//       gq of the warp's first m16 tile
//   wn: the stage's row pitch
//   lim: valid samples in this half (MASK: zero the rest of A and B, whose
//        shared memory holds whatever an earlier stage left there)
// A fragment of m-tile i at k8 step jj (fragment rows are lags):
//   a0 = W[8jj + tq][16i + gq], a1 = W[8jj + tq][16i + gq + 8],
//   a2 = W[8jj + tq + 4][16i + gq], a3 = W[8jj + tq + 4][16i + gq + 8].
// Each obs value is split once per warp for all its lag tiles, each
// matrix value once per block (the warps hold different lags).
template <bool MASK>
__device__ __forceinline__ void consume_span(float (&acc)[kXTiles][kXNT][4],
                                             const float* __restrict__ st,
                                             const float* __restrict__ wt,
                                             int wn, int tq, int lim) {
#pragma unroll
  for (int jj = 0; jj < kXHalf / 8; ++jj) {
    const bool ok0 = !MASK || 8 * jj + tq < lim;
    const bool ok1 = !MASK || 8 * jj + tq + 4 < lim;
    uint32_t bb[kXNT][2], bs[kXNT][2];
#pragma unroll
    for (int n = 0; n < kXNT; ++n) {
      const float x0 = st[n * 8 * kXRowStride + 8 * jj];
      const float x1 = st[n * 8 * kXRowStride + 8 * jj + 4];
      split_tf32(ok0 ? x0 : 0.f, bb[n][0], bs[n][0]);
      split_tf32(ok1 ? x1 : 0.f, bb[n][1], bs[n][1]);
    }
    const float* w0 = wt + 8 * jj * wn;
    const float* w1 = w0 + 4 * wn;
    uint32_t ab[kXTiles][4], as[kXTiles][4];
#pragma unroll
    for (int i = 0; i < kXTiles; ++i) {
      split_tf32(ok0 ? w0[16 * i] : 0.f, ab[i][0], as[i][0]);
      split_tf32(ok0 ? w0[16 * i + 8] : 0.f, ab[i][1], as[i][1]);
      split_tf32(ok1 ? w1[16 * i] : 0.f, ab[i][2], as[i][2]);
      split_tf32(ok1 ? w1[16 * i + 8] : 0.f, ab[i][3], as[i][3]);
    }
    // the small cross terms first, then big*big
#pragma unroll
    for (int i = 0; i < kXTiles; ++i)
#pragma unroll
      for (int n = 0; n < kXNT; ++n)
        mma_tf32(acc[i][n], as[i][0], as[i][1], as[i][2], as[i][3], bb[n][0],
                 bb[n][1]);
#pragma unroll
    for (int i = 0; i < kXTiles; ++i)
#pragma unroll
      for (int n = 0; n < kXNT; ++n)
        mma_tf32(acc[i][n], ab[i][0], ab[i][1], ab[i][2], ab[i][3], bs[n][0],
                 bs[n][1]);
#pragma unroll
    for (int i = 0; i < kXTiles; ++i)
#pragma unroll
      for (int n = 0; n < kXNT; ++n)
        mma_tf32(acc[i][n], ab[i][0], ab[i][1], ab[i][2], ab[i][3], bb[n][0],
                 bb[n][1]);
  }
}

__device__ __forceinline__ void consume_half(float (&acc)[kXTiles][kXNT][4],
                                             const float* st, const float* wt,
                                             int wn, int tq, int lim) {
  if (lim >= kXHalf) {
    consume_span<false>(acc, st, wt, wn, tq, lim);
  } else if (lim > 0) {
    consume_span<true>(acc, st, wt, wn, tq, lim);
  }
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void red_release_add(unsigned* p, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void team_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The epilogue of one output from its summed re and im: unfused products,
// the same roundings as the plain version.
__device__ __forceinline__ void store_output(float* __restrict__ out, int64_t plane,
                                             int64_t idx, float scale, float re,
                                             float im) {
  out[idx] = __fmul_rn(scale, __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im)));
  out[plane + idx] = atan2f(-im, re) / 6.28318530717958647692f;
  out[2 * plane + idx] = re;
  out[3 * plane + idx] = im;
}

// Reducer `reducer` of the launch's a.reducers sums the partials of the
// outputs' tiles of 8 (tile t for t = reducer*teams + team + m*reducers*teams)
// and applies the epilogue.  The order is fixed: chunk c goes to group
// c % kXGroups, each group is summed in chunk order, then the groups in
// order.  A team of kXTeam warps takes a tile: lane (o8 = lane % 8,
// q = lane / 8) of the team's warp w sums group 4w + q of output o8, with
// kXBatch chunks' loads in flight at once (all 11 of re and of im at the
// host shape's 264 chunks).  `red`: shared memory for 2 * kXGroups * 8
// floats per team.
template <int WL>
__device__ __forceinline__ void explicit_reduce(const XArgs& a, int reducer, float* red) {
  constexpr int kTeams = x_threads(WL) / 32 / kXTeam;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int team = warp / kXTeam;
  if (team >= kTeams) return;
  const int cg = 4 * (warp % kXTeam) + (lane >> 3);
  const int o8 = lane & 7;
  const int64_t pl = (int64_t)a.P * a.NL;
  const int64_t total = (int64_t)a.G * pl;
  const int64_t chunk_floats = 2 * pl;
  float* tr = red + team * 2 * kXGroups * 8;
  const int64_t ntiles = (total + 7) / 8;
  for (int64_t t = (int64_t)reducer * kTeams + team; t < ntiles;
       t += (int64_t)a.reducers * kTeams) {
    const int64_t o = 8 * t + o8;
    float re = 0.f;
    float im = 0.f;
    if (o < total) {
      const int64_t gi = o / pl;
      const float* base = a.part + gi * a.nchunk * chunk_floats + (o - gi * pl);
      // kXBatch chunks' loads in flight at once, then their sums in order
      for (int c0 = cg; c0 < a.nchunk; c0 += kXBatch * kXGroups) {
        float vr[kXBatch], vi[kXBatch];
#pragma unroll
        for (int j = 0; j < kXBatch; ++j) {
          const int c = c0 + j * kXGroups;
          vr[j] = c < a.nchunk ? __ldcg(base + c * chunk_floats) : 0.f;
          vi[j] = c < a.nchunk ? __ldcg(base + c * chunk_floats + pl) : 0.f;
        }
#pragma unroll
        for (int j = 0; j < kXBatch; ++j) {
          if (c0 + j * kXGroups < a.nchunk) {
            re += vr[j];
            im += vi[j];
          }
        }
      }
    }
    tr[cg * 8 + o8] = re;
    tr[(kXGroups + cg) * 8 + o8] = im;
    team_sync(1 + team, 32 * kXTeam);
    if (cg == 0 && o < total) {
#pragma unroll
      for (int k = 1; k < kXGroups; ++k) {
        re += tr[k * 8 + o8];
        im += tr[(kXGroups + k) * 8 + o8];
      }
      store_output(a.out, total, o, a.scale, re, im);
    }
    team_sync(1 + team, 32 * kXTeam);
  }
}

// Floats of one explicit-form stage's matrix rows: whole rows of pitch
// w_n, or the span's windows (WIN) at pitch x_pitch(wl).
__host__ __device__ constexpr int64_t explicit_w_stage(bool win, int wl, int64_t w_n) {
  return (int64_t)kXS * (win ? x_pitch(wl) : w_n);
}

// A reducer of the explicit form (ticket a.nblocks + `reducer`): waits
// until every producer has counted its arrival (each has a lower ticket,
// so it has started, and it never waits), sums its share of the outputs,
// and the last reducer to finish sets the counters back to zero.
template <int WL>
__device__ __forceinline__ void explicit_reducer(const XArgs& a, int reducer, float* red) {
  if (threadIdx.x == 0) {
    while (ld_acquire(&a.ctr[1]) < (unsigned)a.nblocks) __nanosleep(32);
  }
  __syncthreads();
  explicit_reduce<WL>(a, reducer, red);
  if (threadIdx.x == 0 && atomicAdd(&a.ctr[2], 1u) == (unsigned)a.reducers - 1) {
    // every block has taken its ticket and every producer has arrived
    a.ctr[0] = 0;
    a.ctr[1] = 0;
    a.ctr[2] = 0;
  }
}

// Tickets 0 .. nblocks-1: one producer per (K-chunk x span, channel, row
// block), in that order; then the reducers.  Shared memory holds the
// barriers, the ring's matrix stages, then its obs stages.
template <int WL, bool WIN>
__global__ void __launch_bounds__(x_threads(WL), WL <= 2 ? 2 : 1)
    lagbank_explicit_kernel(const XArgs a) {
  constexpr int kConsumers = 2 * WL;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ unsigned s_ticket;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* empty = full + a.ring;
  const int wn = (int)a.w_n;
  const int w_stage = (int)explicit_w_stage(WIN, WL, a.w_n);
  float* w_ring = reinterpret_cast<float*>(empty + a.ring);
  float* x_ring = w_ring + a.ring * w_stage;

  if (threadIdx.x == 0) {
    // the block's place in the order of starts
    s_ticket = atomicAdd(&a.ctr[0], 1u);
    for (int s = 0; s < a.ring; ++s) {
      mbar_init(&full[s], WL);  // one arrival per producer warp
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const unsigned ticket = s_ticket;
  if (ticket >= (unsigned)a.nblocks) {
    explicit_reducer<WL>(a, (int)(ticket - a.nblocks), w_ring);
    return;
  }

  // a chunk's spans are neighbours in the order of tickets, so the
  // chunk's obs rows come from L2 after the first of them reads them
  const int nx = a.nchunk * a.nspan;
  const int bx = (int)(ticket % nx);
  const int chunk = bx / a.nspan;
  const int lag0 = 16 * a.span_tiles * (bx % a.nspan);
  const int span_lags = min(16 * a.span_tiles, a.NL - lag0);
  const int g = (int)(ticket / nx) % a.G;
  const int r0 = (int)(ticket / nx / a.G) * kRows;
  const int rows = min(kRows, 2 * a.P - r0);
  const int64_t k_begin = (int64_t)chunk * a.kb;
  const int len = (int)min((int64_t)a.kb, (int64_t)a.K - k_begin);
  const int nsteps = (len + kXS - 1) / kXS;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const int kw = warp & 1;   // K half of each stage
  const int lw = warp >> 1;  // lag warp: m16 tiles kXTiles*lw.. of the span
  const int gq = lane >> 2;
  const int tq = lane & 3;
  // this warp's tiles that hold lags of the span: 0, 1 or kXTiles
  const int nt = max(0, min(kXTiles, (span_lags + 15) / 16 - kXTiles * lw));
  float sum[kXTiles][kXNT][4] = {};  // this lane's IEEE fp32 sums

  if (warp >= kConsumers) {
    // -- producers: WL warps share each stage's copies.  Item q of a stage
    //    (below kXS: a matrix row of the span's window, or in the whole-row
    //    layout item 0, the stage's rows; from kXS: obs row q - kXS) goes to
    //    lane q % 32 of producer warp (q / 32) % WL: one warp issued a bulk
    //    copy per ~40 ns whatever its size (NVIDIA H100 80GB HBM3, 700 W,
    //    tools/gpu_lagbank_probe.py), so the copies of a stage are spread
    //    over the warps.  Each warp arrives on the stage's full barrier
    //    once, with its own bytes.
    constexpr int kPasses = (kXS + kRows + 32 * WL - 1) / (32 * WL);
    const int pw = warp - kConsumers;
    const float* obs_g = a.obs + (int64_t)g * a.obs_g + k_begin;
    const float* w_g = a.w + (int64_t)g * a.w_g + k_begin * a.w_n;
    for (int step = 0; step < nsteps; ++step) {
      const int s = step % a.ring;
      if (step >= a.ring) mbar_wait(&empty[s], (step / a.ring - 1) & 1);
      const int n0 = step * kXS;
      const int lim = min(kXS, len - n0);
      // obs rows in whole float4s: each row holds K rounded up to 4
      const uint32_t x_bytes = 16u * (uint32_t)((lim + 3) / 4);
      const float* wsrc = w_g + (int64_t)n0 * a.w_n;
      float* wdst = w_ring + s * w_stage;
      float* xdst = x_ring + s * kXObsFloats;
      // row 0's lag lag0, from the channel's start (WIN)
      const int64_t first = (k_begin + n0) * a.w_n + lag0;
      const float* src[kPasses];
      float* dst[kPasses];
      uint32_t bytes[kPasses];
      uint32_t total = 0;
#pragma unroll
      for (int m = 0; m < kPasses; ++m) {
        const int q = lane + 32 * (pw + WL * m);
        bytes[m] = 0;
        src[m] = nullptr;
        dst[m] = nullptr;
        if (q < kXS && WIN) {
          // row q's lags [lag0, lag0 + span_lags) from the 16-byte unit
          // holding lag lag0: a bulk copy of the whole units inside the
          // channel's readable floats, plain loads for the rest (only at
          // the matrix's end)
          if (q < lim) {
            const int64_t qq = (int64_t)q * a.w_n + (first & 3);  // from the unit
            const int64_t q0 = qq & ~(int64_t)3;
            const int64_t end = qq + span_lags;
            const int64_t fit = (a.w_lim - (first & ~(int64_t)3) - q0) / 4;
            const uint32_t units = (uint32_t)min((end - q0 + 3) / 4, fit);
            float* drow = wdst + q * x_pitch(WL);
            const float* srow = wsrc + (int64_t)q * a.w_n + lag0 - (qq - q0);
            for (int64_t i = 4 * (int64_t)units; i < end - q0; ++i) drow[i] = srow[i];
            src[m] = srow;
            dst[m] = drow;
            bytes[m] = 16u * units;
          }
        } else if (q == 0) {
          // one span holds every lag: the stage's matrix rows end at lag
          // NL - 1 of its last row; the bulk copy takes whole 16-byte
          // units, plain loads the rest
          const uint32_t w_floats = (uint32_t)((lim - 1) * wn + a.NL);
          bytes[m] = (4u * w_floats) & ~15u;
          for (uint32_t i = bytes[m] / 4; i < w_floats; ++i) wdst[i] = wsrc[i];
          src[m] = wsrc;
          dst[m] = wdst;
        } else if (q >= kXS && q - kXS < rows) {
          const int rr = r0 + q - kXS;
          const int c = rr / a.P;
          const int p = rr - c * a.P;
          src[m] = obs_g + c * a.obs_c + p * a.obs_p + n0;
          dst[m] = xdst + (q - kXS) * kXRowStride;
          bytes[m] = x_bytes;
        }
        total += bytes[m];
      }
      total = __reduce_add_sync(0xffffffffu, total);
      __threadfence_block();  // the plain stores before the arrival
      __syncwarp();
      if (lane == 0) mbar_arrive_expect_tx(&full[s], total);
      __syncwarp();
#pragma unroll
      for (int m = 0; m < kPasses; ++m)
        if (bytes[m] > 0) bulk_g2s(dst[m], src[m], bytes[m], &full[s]);
    }
  } else {
    // -- consumers --------------------------------------------------------
    float acc[kXTiles][kXNT][4];
#pragma unroll
    for (int i = 0; i < kXTiles; ++i)
#pragma unroll
      for (int n = 0; n < kXNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;
    const int jbeg = kw * kXHalf;
    // this lane's stage rows are jbeg + tq + 4m; in the window layout
    // their lag lag0 lies at column ((k_begin + row) * w_n + lag0) % 4,
    // which is (tq * w_n) % 4 since k_begin, jbeg and lag0 are multiples of 4
    const int pitch = WIN ? x_pitch(WL) : wn;
    const int col0 = (WIN ? (int)(((int64_t)tq * a.w_n) & 3) : lag0) + 16 * kXTiles * lw;
    for (int step = 0; step < nsteps; ++step) {
      const int s = step % a.ring;
      mbar_wait(&full[s], (step / a.ring) & 1);
      const int lim = min(kXS, len - step * kXS) - jbeg;
      const float* st = x_ring + s * kXObsFloats + gq * kXRowStride + jbeg + tq;
      const float* wt = w_ring + s * w_stage + (jbeg + tq) * pitch + col0 + gq;
      // a warp with one tile of the span's lags runs both: the second's
      // lags are past the span and dropped, and the block's stage takes
      // as long as its two-tile warps anyway (a separate one-tile path
      // made nvcc drop the second tile of the two-tile warps)
      if (nt > 0) consume_half(acc, st, wt, pitch, tq, lim);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
      // the tensor core adds with truncation: one stage's chain, then the
      // IEEE fp32 sum
#pragma unroll
      for (int i = 0; i < kXTiles; ++i)
#pragma unroll
        for (int n = 0; n < kXNT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sum[i][n][e] += acc[i][n][e];
            acc[i][n][e] = 0.f;
          }
    }
  }
  __syncthreads();

  // -- K half 1 of each lag warp hands its sums to K half 0 through the
  //    ring (every copy has landed and been read); half 0 adds them in
  //    order and stores the block's partial
  float* xch = w_ring + lw * kXVals * 32 + lane;
  if (warp < kConsumers && kw == 1 && nt > 0) {
#pragma unroll
    for (int i = 0; i < kXTiles; ++i)
#pragma unroll
      for (int n = 0; n < kXNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) xch[((i * kXNT + n) * 4 + e) * 32] = sum[i][n][e];
  }
  __syncthreads();
  if (warp < kConsumers && kw == 0 && nt > 0) {
    const int two_p = 2 * a.P;
    float* out = a.part + ((int64_t)g * a.nchunk + chunk) * two_p * a.NL;
#pragma unroll
    for (int i = 0; i < kXTiles; ++i)
#pragma unroll
      for (int n = 0; n < kXNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v = sum[i][n][e] + xch[((i * kXNT + n) * 4 + e) * 32];
          // D fragment: row (lag) gq (+8 for e >= 2), column (obs row)
          // 2 tq + (e & 1)
          const int l = lag0 + 16 * (kXTiles * lw + i) + gq + (e >> 1) * 8;
          const int r = r0 + n * 8 + 2 * tq + (e & 1);
          if (i < nt && l < a.NL && r < two_p) __stcg(out + (int64_t)r * a.NL + l, v);
        }
    __threadfence();
  }

  // -- the block's partial is out: count its arrival for the reducers
  __syncthreads();
  if (threadIdx.x == 0) red_release_add(&a.ctr[1], 1u);
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
// (whole rows of pitch w_n, or WIN's span windows) and obs stages
size_t explicit_smem(int ring, bool win, int wl, int64_t w_n) {
  return 2 * (size_t)ring * sizeof(uint64_t) +
         (size_t)ring * ((size_t)explicit_w_stage(win, wl, w_n) + kXObsFloats) *
             sizeof(float);
}

// The explicit form's ring: the deepest (at most three stages with two lag
// warps, kXMaxRing with four) that keeps the layout's blocks resident per
// SM (two with two lag warps, one with four; 228 KB of shared memory,
// 1 KB of it reserved per block), else two stages in one block's 227 KB;
// 0 when even that does not fit.  Two blocks per SM ran faster on three
// stages than on four (the host shape at NL 57 on an NVIDIA H100 80GB
// HBM3 at 700 W: tools/gpu_lagbank_probe.py, `explicit_ring4`).
int explicit_ring(bool win, int wl, int64_t w_n) {
  const size_t per_sm = wl <= 2 ? 2 : 1;
  for (int ring = wl <= 2 ? 3 : kXMaxRing; ring >= 2; --ring)
    if (per_sm * (explicit_smem(ring, win, wl, w_n) + 1024) <= 228 * 1024) return ring;
  return explicit_smem(2, win, wl, w_n) <= 227 * 1024 ? 2 : 0;
}

// Blocks of `kernel` the current device holds at once with `smem` bytes
// of dynamic shared memory each (its SMs x blocks per SM), cached per
// device for the last shared-memory size asked.
template <class Kernel>
cudaError_t resident_blocks(Kernel kernel, int threads, size_t smem, int& blocks,
                            int (&cached)[kMaxDevices][2]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && cached[dev][0] == (int)smem && cached[dev][1] > 0) {
    blocks = cached[dev][1];
    return cudaSuccess;
  }
  int per_sm = 0;
  int sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  blocks = per_sm * sms;
  if (blocks <= 0) return cudaErrorInvalidConfiguration;
  if (dev < kMaxDevices) {
    cached[dev][0] = (int)smem;
    cached[dev][1] = blocks;
  }
  return cudaSuccess;
}

template <int WL, bool WIN>
cudaError_t launch_explicit_as(XArgs& x, size_t smem, cudaStream_t s) {
  static int allowed[kMaxDevices] = {};
  static int resident[kMaxDevices][2] = {};
  cudaError_t err = allow_smem(lagbank_explicit_kernel<WL, WIN>, smem, allowed);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = resident_blocks(lagbank_explicit_kernel<WL, WIN>, x_threads(WL), smem, blocks,
                        resident);
  if (err != cudaSuccess) return err;
  // as many reducers as the card holds at once, and no more than the
  // output tiles need
  constexpr int teams = x_threads(WL) / 32 / kXTeam;
  const int64_t tiles = ((int64_t)x.G * x.P * x.NL + 7) / 8;
  const int64_t wanted = (tiles + teams - 1) / teams;
  x.reducers = (int)(wanted < blocks ? wanted : blocks);
  lagbank_explicit_kernel<WL, WIN><<<x.nblocks + x.reducers, x_threads(WL), smem, s>>>(x);
  return cudaGetLastError();
}

int launch_explicit(const Args& a, int G, cudaStream_t s) {
  // bulk copies move 16-byte-aligned runs of whole float4s: obs rows and
  // the matrix's stages (whole rows from a multiple of 4, windows from
  // the 16-byte unit of their first lag, so any row pitch)
  const float* w = a.w + a.w_off;
  const bool aligned = reinterpret_cast<uintptr_t>(a.obs) % 16 == 0 &&
                       a.obs_g % 4 == 0 && a.obs_c % 4 == 0 &&
                       a.obs_p % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                       a.w_g % 4 == 0 && a.kb % 4 == 0;
  // every read within the channel's [0, w_len)
  const bool inside = a.w_off >= 0 && a.w_n >= a.NL &&
                      a.w_off + (int64_t)(a.K - 1) * a.w_n + a.NL <= a.w_len;
  if (!aligned || !inside) return (int)cudaErrorInvalidValue;
  // the lags in m16 tiles: up to 4 take one span of two lag warps (two
  // blocks per SM); more take spans of up to 8 tiles of four lag warps,
  // balanced (NL 403: four spans of 7, 7, 7 and 5 tiles)
  const int tiles = (a.NL + 15) / 16;
  const int wl = tiles <= 2 * kXTiles ? 2 : 4;
  const int nspan = (tiles + kXTiles * wl - 1) / (kXTiles * wl);
  const int span_tiles = (tiles + nspan - 1) / nspan;
  // whole rows while one span holds every lag and their ring is as deep
  // as the windows', else the spans' windows
  const int ring_win = explicit_ring(true, wl, a.w_n);
  const int ring_whole = nspan == 1 ? explicit_ring(false, wl, a.w_n) : 0;
  const bool win = ring_whole < ring_win;
  const int ring = win ? ring_win : ring_whole;
  const size_t smem = explicit_smem(ring, win, wl, a.w_n);
  const int rblocks = (2 * a.P + kRows - 1) / kRows;
  // the producers' tickets and the reducers' (at most the card's blocks)
  const int64_t nblocks = (int64_t)a.nchunk * nspan * G * rblocks;
  if (nblocks > 0x7fffffff - (1 << 16)) return (int)cudaErrorInvalidValue;
  XArgs x;
  x.obs = a.obs;
  x.obs_g = a.obs_g;
  x.obs_c = a.obs_c;
  x.obs_p = a.obs_p;
  x.w = w;
  x.w_g = a.w_g;
  x.w_n = a.w_n;
  x.w_lim = a.w_len - a.w_off;
  x.P = a.P;
  x.K = a.K;
  x.NL = a.NL;
  x.kb = a.kb;
  x.nchunk = a.nchunk;
  x.ring = ring;
  x.span_tiles = span_tiles;
  x.nspan = nspan;
  x.G = G;
  x.nblocks = (int)nblocks;
  x.reducers = 0;
  x.scale = a.scale;
  x.part = a.part;
  x.ctr = a.ctr;
  x.out = a.out;
  cudaError_t err;
  if (wl == 2) {
    err = win ? launch_explicit_as<2, true>(x, smem, s) : launch_explicit_as<2, false>(x, smem, s);
  } else {
    err = win ? launch_explicit_as<4, true>(x, smem, s) : launch_explicit_as<4, false>(x, smem, s);
  }
  return (int)err;
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

// The geometry of a launch, bound with ctypes as a structure (the Python
// wrapper keeps one per shape, so a call converts few arguments).
struct LagbankGeometry {
  long long obs_g, obs_c, obs_p;          // obs element strides (g, re/im, code)
  long long w_g, w_n, w_l, w_off, w_len;  // W_g[n, l] = w[g*w_g + w_off + n*w_n + l*w_l]
  int G, P, K, NL;
  int kb;       // samples of K per block
  float scale;  // of the power
};

// Plain C entry point (bound with ctypes).  `work` is the caller's device
// workspace of `work_floats` floats: kXHeader for the explicit form's
// counters (zero when it is allocated; each launch leaves them zero),
// then the chunks' partial sums, G * ceil(K / kb) * 2P * NL.  Launches on
// one stream may share it, since they run in order.  `out` is the
// (4, G, P, NL) power, phase, re and im on the device.  Two layouts of W,
// every other refused:
// - the window layout (w_n = 1, w_l = -1) takes the window kernel and its
//   second pass, and needs 16-byte-aligned obs rows (obs pointer aligned,
//   strides and K multiples of 4);
// - the row-major layout (w_l = 1, w_n >= NL) takes the explicit kernel,
//   ONE launch, over chunks of kb samples (a multiple of 4, which
//   ops/lagbank.explicit_chunk picks); it needs 16-byte-aligned obs
//   (pointer aligned, strides multiples of 4, each row holding K rounded
//   up to 4 floats) and W (w + w_off aligned, w_g a multiple of 4), and
//   every read of W within a channel's [0, w_len); any NL and pitch
//   w_n >= NL.
// Launches on `stream` of CUDA device `device` (made current for the
// launches, the caller's current device restored), does not synchronise,
// and returns the cudaError_t of the launches (0 = success).
extern "C" int lagbank_launch(const LagbankGeometry* geo, const float* obs,
                              const float* w, float* work,
                              long long work_floats, float* out,
                              int device, void* stream) {
  const int G = geo->G, P = geo->P, K = geo->K, NL = geo->NL, kb = geo->kb;
  if (G <= 0 || P <= 0 || K <= 0 || NL <= 0 || kb <= 0 || G > 65535 ||
      work_floats < kXHeader + (long long)G * ((K + kb - 1) / kb) * 2 * P * NL ||
      reinterpret_cast<uintptr_t>(work) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const DeviceGuard on(device);
  if (on.err != cudaSuccess) return (int)on.err;
  Args a = {};
  a.obs = obs;
  a.obs_g = geo->obs_g;
  a.obs_c = geo->obs_c;
  a.obs_p = geo->obs_p;
  a.w = w;
  a.w_g = geo->w_g;
  a.w_n = geo->w_n;
  a.w_l = geo->w_l;
  a.w_off = geo->w_off;
  a.w_len = geo->w_len;
  a.P = P;
  a.K = K;
  a.NL = NL;
  a.kb = kb;
  a.nchunk = (K + kb - 1) / kb;
  a.scale = geo->scale;
  a.ctr = reinterpret_cast<unsigned*>(work);
  a.part = work + kXHeader;
  a.out = out;

  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.w_l == 1) return launch_explicit(a, G, s);
  if (a.w_n != 1 || a.w_l != -1) return (int)cudaErrorInvalidValue;
  const int err = launch_window(a, G, s);
  if (err != 0) return err;
  const int64_t total = (int64_t)G * P * NL;
  const unsigned fin_blocks = (unsigned)((total + kFinOut - 1) / kFinOut);
  lagbank_finalize_kernel<<<fin_blocks, kFinOut * kFinGroups, 0, s>>>(
      a.part, G, a.nchunk, P, NL, a.scale, out, out + total, out + 2 * total,
      out + 3 * total);
  return (int)cudaGetLastError();
}
