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
// Explicit (K, NL) form (off the main path): IEEE fp32 FFMA, one block per
// (K-chunk[, tile group]) staging kKT samples of obs and of the lag matrix
// in shared memory, a kPT x kLT register tile of (re, im) per thread,
// n-slices summed in a fixed order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------
// Explicit (K, NL) form: fp32 FFMA
// ---------------------------------------------------------------------
constexpr int kThreads = 256;
constexpr int kPT = 4;    // codes per thread
constexpr int kLT = 8;    // lags per thread
constexpr int kKT = 128;  // samples staged per step

struct Args {
  const float* obs;
  int64_t obs_g, obs_c, obs_p;  // element strides; stride along n is 1
  const float* w;
  int64_t w_g, w_n, w_l, w_off, w_len;
  int P, K, NL;
  int kb;       // samples per block (multiple of kKT)
  int nchunk;   // ceil(K / kb)
  int tiles_p;  // ceil(P / kPT)
  int tiles_l;  // ceil(NL / kLT)
  int tb;       // tiles per block
  int ns;       // n-slices per block
  float* part;  // (G, nchunk, 2, P, NL) partial sums
};

__global__ void __launch_bounds__(kThreads)
    lagbank_explicit_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int PP = a.tiles_p * kPT;   // padded codes
  const int NLP = a.tiles_l * kLT;  // padded lags
  // obs staged as [c][j][p] so a thread's kPT codes are one float4
  float* s_obs = smem;
  float* s_w = smem + 2 * kKT * PP;

  const int g = blockIdx.y;
  const int chunk = blockIdx.x;
  const int tid = threadIdx.x;
  const int lt = tid % a.tb;
  const int slice = tid / a.tb;
  const int tile = blockIdx.z * a.tb + lt;
  const bool active = slice < a.ns && tile < a.tiles_p * a.tiles_l;
  const int p0 = (tile / a.tiles_l) * kPT;
  const int l0 = (tile % a.tiles_l) * kLT;
  // this slice's contiguous run of staged samples
  const int run = (kKT + a.ns - 1) / a.ns;
  const int j_lo = min(slice * run, kKT);
  const int j_hi = min(j_lo + run, kKT);

  float acc_re[kPT][kLT];
  float acc_im[kPT][kLT];
#pragma unroll
  for (int i = 0; i < kPT; ++i) {
#pragma unroll
    for (int q = 0; q < kLT; ++q) {
      acc_re[i][q] = 0.f;
      acc_im[i][q] = 0.f;
    }
  }

  const float* obs_g = a.obs + (int64_t)g * a.obs_g;
  const float* w_g = a.w + (int64_t)g * a.w_g;
  const int64_t k_begin = (int64_t)chunk * a.kb;
  const int64_t k_stop = k_begin + a.kb;
  const int64_t k_end = k_stop < a.K ? k_stop : (int64_t)a.K;

  for (int64_t n0 = k_begin; n0 < k_end; n0 += kKT) {
    // -- stage obs (zero past K and for padded codes) -----------------
    for (int i = tid; i < 2 * PP * kKT; i += kThreads) {
      const int col = i % kKT;
      const int row = i / kKT;  // c * PP + p
      const int c = row / PP;
      const int p = row % PP;
      const int64_t n = n0 + col;
      float v = 0.f;
      if (p < a.P && n < k_end) v = obs_g[c * a.obs_c + p * a.obs_p + n];
      s_obs[(c * kKT + col) * PP + p] = v;
    }
    // -- stage the lag matrix -----------------------------------------
    for (int i = tid; i < kKT * NLP; i += kThreads) {
      const int j = i / NLP;
      const int l = i % NLP;
      const int64_t n = n0 + j;
      float v = 0.f;
      if (l < a.NL && n < k_end) {
        const int64_t idx = a.w_off + n * a.w_n + (int64_t)l * a.w_l;
        if (idx >= 0 && idx < a.w_len) v = w_g[idx];
      }
      s_w[i] = v;
    }
    __syncthreads();

    if (active && j_lo < j_hi) {
      for (int j = j_lo; j < j_hi; ++j) {
        const float4 lo = *reinterpret_cast<const float4*>(&s_w[j * NLP + l0]);
        const float4 hi =
            *reinterpret_cast<const float4*>(&s_w[j * NLP + l0 + 4]);
        const float wv[kLT] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
        const float4 o_re =
            *reinterpret_cast<const float4*>(&s_obs[j * PP + p0]);
        const float4 o_im =
            *reinterpret_cast<const float4*>(&s_obs[(kKT + j) * PP + p0]);
        const float ore[kPT] = {o_re.x, o_re.y, o_re.z, o_re.w};
        const float oim[kPT] = {o_im.x, o_im.y, o_im.z, o_im.w};
#pragma unroll
        for (int i = 0; i < kPT; ++i) {
#pragma unroll
          for (int q = 0; q < kLT; ++q) {
            acc_re[i][q] = fmaf(ore[i], wv[q], acc_re[i][q]);
            acc_im[i][q] = fmaf(oim[i], wv[q], acc_im[i][q]);
          }
        }
      }
    }
    __syncthreads();
  }

  // -- sum the n-slices into slice 0, in slice order -------------------
  float* red = smem;  // tb x (2 kPT kLT), laid out [value][tile]
  for (int s = 1; s < a.ns; ++s) {
    if (active && slice == s) {
#pragma unroll
      for (int i = 0; i < kPT; ++i) {
#pragma unroll
        for (int q = 0; q < kLT; ++q) {
          red[((0 * kPT + i) * kLT + q) * a.tb + lt] = acc_re[i][q];
          red[((1 * kPT + i) * kLT + q) * a.tb + lt] = acc_im[i][q];
        }
      }
    }
    __syncthreads();
    if (active && slice == 0) {
#pragma unroll
      for (int i = 0; i < kPT; ++i) {
#pragma unroll
        for (int q = 0; q < kLT; ++q) {
          acc_re[i][q] += red[((0 * kPT + i) * kLT + q) * a.tb + lt];
          acc_im[i][q] += red[((1 * kPT + i) * kLT + q) * a.tb + lt];
        }
      }
    }
    __syncthreads();
  }

  if (active && slice == 0) {
    const int64_t pl = (int64_t)a.P * a.NL;
    float* out = a.part + ((int64_t)g * a.nchunk + chunk) * 2 * pl;
#pragma unroll
    for (int i = 0; i < kPT; ++i) {
      const int p = p0 + i;
      if (p >= a.P) continue;
#pragma unroll
      for (int q = 0; q < kLT; ++q) {
        const int l = l0 + q;
        if (l >= a.NL) continue;
        out[(int64_t)p * a.NL + l] = acc_re[i][q];
        out[pl + (int64_t)p * a.NL + l] = acc_im[i][q];
      }
    }
  }
}

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

int launch_explicit(const Args& a0, int G, cudaStream_t s) {
  Args a = a0;
  a.tiles_p = (a.P + kPT - 1) / kPT;
  a.tiles_l = (a.NL + kLT - 1) / kLT;
  const int tiles = a.tiles_p * a.tiles_l;
  a.tb = tiles < kThreads ? tiles : kThreads;
  a.ns = kThreads / a.tb;
  const size_t PP = (size_t)a.tiles_p * kPT;
  const size_t NLP = (size_t)a.tiles_l * kLT;
  const size_t stage = (2 * kKT * PP + kKT * NLP) * sizeof(float);
  const size_t red =
      a.ns > 1 ? (size_t)a.tb * 2 * kPT * kLT * sizeof(float) : 0;
  const size_t smem = stage > red ? stage : red;
  if (a.kb % kKT != 0 || smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      lagbank_explicit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.nchunk, G, (tiles + a.tb - 1) / a.tb);
  lagbank_explicit_kernel<<<grid, kThreads, smem, s>>>(a);
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
  cudaError_t err = cudaFuncSetAttribute(
      lagbank_window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.nchunk, G, w.rblocks * lblocks);
  lagbank_window_kernel<<<grid, kWinThreads, smem, s>>>(w);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  All pointers are device
// pointers; `part` is caller-allocated scratch of G*nchunk*2*P*NL floats
// with nchunk = ceil(K / kb).  The window layout (w_n = 1, w_l = -1) takes
// the tensor-core kernel and needs 16-byte-aligned obs rows (obs pointer
// aligned, strides and K multiples of 4); any other layout takes the FFMA
// kernel.  Launches on `stream`, does not synchronise, and returns the
// cudaError_t of the launches (0 = success).
extern "C" int lagbank_launch(const float* obs, long long obs_g,
                              long long obs_c, long long obs_p,
                              const float* w, long long w_g, long long w_n,
                              long long w_l, long long w_off, long long w_len,
                              int G, int P, int K, int NL, int kb, float scale,
                              float* part, float* power, float* phase,
                              float* re, float* im, void* stream) {
  if (G <= 0 || P <= 0 || K <= 0 || NL <= 0 || kb <= 0 || G > 65535) {
    return (int)cudaErrorInvalidValue;
  }
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
  const bool window = (w_n == 1 && w_l == -1);
  const int err = window ? launch_window(a, G, s) : launch_explicit(a, G, s);
  if (err != 0) return err;

  const int64_t total = (int64_t)G * P * NL;
  const unsigned fin_blocks = (unsigned)((total + kFinOut - 1) / kFinOut);
  lagbank_finalize_kernel<<<fin_blocks, kFinOut * kFinGroups, 0, s>>>(
      part, G, a.nchunk, P, NL, scale, power, phase, re, im);
  return (int)cudaGetLastError();
}
