// DLL/PLL lag-bank correlation for Hopper (sm_90a), IEEE fp32.
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
// Bound on the card: at production geometry (K = 200 000 samples per code,
// P = 24 codes, NL = 57 lags, 120 channels per tracked second) the
// contraction is 1.3e11 fp32 FLOP against 4.6 GB of obs, i.e. ~28 FLOP
// per byte read, above the H100's ~20 FLOP/byte fp32 ridge: the kernel is
// bounded by fp32 FMA throughput (no tensor cores: TF32 would round the
// products to 10 mantissa bits, PARITY deviation 12).
//
// Design (simple and deterministic first):
//  - one block per (channel, K-chunk of kb samples[, tile group]); the
//    block stages kKT samples of all P codes' obs and the matching replica
//    samples in shared memory and reuses them for every (code, lag) pair:
//    in window form that is the kKT + NLP - 1 window of wav_ext, shared by
//    all codes;
//  - each thread keeps a kPT x kLT register tile of (re, im) accumulators;
//    the block's n-slices split the staged samples into contiguous runs,
//    so in window form each thread slides its kLT replica values along
//    in registers (one shared load per sample instead of kLT);
//  - slices are summed in shared memory in a fixed order, and a second
//    pass sums the K-chunks in a fixed order and applies the epilogue —
//    no atomics, so every run gives the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

template <bool WINDOW>
__global__ void __launch_bounds__(kThreads)
    lagbank_partial_kernel(const Args a) {
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
    // -- stage the replica --------------------------------------------
    if (WINDOW) {
      // s_w[i] = w[w_off + n0 - (NLP-1) + i]; W(n0+j, l) = s_w[j+NLP-1-l]
      const int64_t base = a.w_off + n0 - (NLP - 1);
      for (int i = tid; i < kKT + NLP - 1; i += kThreads) {
        const int64_t idx = base + i;
        s_w[i] = (idx >= 0 && idx < a.w_len) ? w_g[idx] : 0.f;
      }
    } else {
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
    }
    __syncthreads();

    if (active && j_lo < j_hi) {
      float wv[kLT];
      if (WINDOW) {
#pragma unroll
        for (int q = 0; q < kLT; ++q) wv[q] = s_w[j_lo + NLP - 1 - l0 - q];
      }
      for (int j = j_lo; j < j_hi; ++j) {
        if (WINDOW) {
          if (j > j_lo) {
            // slide the window one sample: W(j, l0+q) = W(j-1, l0+q-1)
#pragma unroll
            for (int q = kLT - 1; q > 0; --q) wv[q] = wv[q - 1];
            wv[0] = s_w[j + NLP - 1 - l0];
          }
        } else {
          const float4 lo = *reinterpret_cast<const float4*>(&s_w[j * NLP + l0]);
          const float4 hi =
              *reinterpret_cast<const float4*>(&s_w[j * NLP + l0 + 4]);
          wv[0] = lo.x; wv[1] = lo.y; wv[2] = lo.z; wv[3] = lo.w;
          wv[4] = hi.x; wv[5] = hi.y; wv[6] = hi.z; wv[7] = hi.w;
        }
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

__global__ void lagbank_finalize_kernel(const float* __restrict__ part,
                                        int G, int nchunk, int P, int NL,
                                        float scale, float* __restrict__ power,
                                        float* __restrict__ phase,
                                        float* __restrict__ re_out,
                                        float* __restrict__ im_out) {
  const int64_t pl = (int64_t)P * NL;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)G * pl) return;
  const int64_t g = idx / pl;
  const float* base = part + g * nchunk * 2 * pl + idx % pl;
  float re = 0.f;
  float im = 0.f;
  for (int c = 0; c < nchunk; ++c) {
    re += base[(int64_t)(2 * c) * pl];
    im += base[(int64_t)(2 * c + 1) * pl];
  }
  // unfused products: the same roundings as the plain version
  power[idx] = __fmul_rn(scale, __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im)));
  phase[idx] = atan2f(-im, re) / 6.28318530717958647692f;
  re_out[idx] = re;
  im_out[idx] = im;
}

}  // namespace

// Plain C entry point (bound with ctypes).  All pointers are device
// pointers; `part` is caller-allocated scratch of G*nchunk*2*P*NL floats
// with nchunk = ceil(K / kb).  Launches on `stream`, does not synchronise,
// and returns the cudaError_t of the launches (0 = success).
extern "C" int lagbank_launch(const float* obs, long long obs_g,
                              long long obs_c, long long obs_p,
                              const float* w, long long w_g, long long w_n,
                              long long w_l, long long w_off, long long w_len,
                              int G, int P, int K, int NL, int kb, float scale,
                              float* part, float* power, float* phase,
                              float* re, float* im, void* stream) {
  if (G <= 0 || P <= 0 || K <= 0 || NL <= 0 || kb <= 0 || kb % kKT != 0 ||
      G > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  Args a;
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
  a.tiles_p = (P + kPT - 1) / kPT;
  a.tiles_l = (NL + kLT - 1) / kLT;
  const int tiles = a.tiles_p * a.tiles_l;
  a.tb = tiles < kThreads ? tiles : kThreads;
  a.ns = kThreads / a.tb;
  a.part = part;

  const bool window = (w_n == 1 && w_l == -1);
  const size_t PP = (size_t)a.tiles_p * kPT;
  const size_t NLP = (size_t)a.tiles_l * kLT;
  const size_t stage =
      (2 * kKT * PP + (window ? kKT + NLP - 1 : kKT * NLP)) * sizeof(float);
  const size_t red =
      a.ns > 1 ? (size_t)a.tb * 2 * kPT * kLT * sizeof(float) : 0;
  const size_t smem = stage > red ? stage : red;
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;

  void (*kern)(const Args) = window ? lagbank_partial_kernel<true>
                                    : lagbank_partial_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(a.nchunk, G, (tiles + a.tb - 1) / a.tb);
  kern<<<grid, kThreads, smem, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int64_t total = (int64_t)G * P * NL;
  const int fin_threads = 256;
  const unsigned fin_blocks = (unsigned)((total + fin_threads - 1) / fin_threads);
  lagbank_finalize_kernel<<<fin_blocks, fin_threads, 0, s>>>(
      part, G, a.nchunk, P, NL, scale, power, phase, re, im);
  return (int)cudaGetLastError();
}
