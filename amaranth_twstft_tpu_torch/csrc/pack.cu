// The banked receiver's pack of a second, on the card (sm_90a).
//
// Replaces no Pallas kernel: the JAX package packs each second on the host
// (amaranth_twstft_tpu/models/tracker.py, BankedReceiver._pack_second),
// and so did the port until this kernel.  The host shipped float16 rows;
// now it ships the read's samples as float32 re/im (the same bytes: half
// the rows at twice the width, since no SIC row is built) and this kernel
// does, in one pass over the uploaded rows x (R, S, 2):
//
//   out[r, n, c] = __float2half_rn(x[r, n, c])      (astype(np.float16)'s
//                                                   round to nearest even)
//   stats[r]     = sum_{n < nsum} (x[r,n,0]^2 + x[r,n,1]^2) / nsum
//                                                   (float64: the noise power)
//   stats[R]     = max |x|                          (auto's range check)
//
// Bound on the card: bytes.  At the receiver's shape (R, S) = (2, 5 200 000)
// it reads 83.2 MB and writes 41.6 MB, 124.8 MB at 3.35 TB/s = 0.037 ms;
// its arithmetic (one float64 multiply-add and one conversion a value) is far
// below any compute peak.  So:
//   - each thread loads 16 bytes (four floats, two samples) at a time,
//     neighbouring threads on neighbouring 16-byte units, eight loads issued
//     before any is used, and stores its four halves as one 8-byte unit;
//   - the grid is (chunks of kChunk floats, rows): 2 540 blocks of 256
//     threads at the receiver's shape, about 19 per SM, so all 132 SMs
//     stream;
//   - squares are taken and summed in float64 (exact products of float32
//     values), per thread in a fixed order, per block by a fixed shared-
//     memory tree, into one partial per block; the second kernel sums each
//     row's partials in a fixed order.  No float atomics: two launches give
//     the same bits.  The peak is a maximum of |x|'s bit patterns (an order-
//     free integer maximum; a NaN sorts above inf, as np.max propagates it);
//   - a row of 2S floats starts 16-byte aligned only where R*2S is a
//     multiple of 4: each block takes the floats up to its first aligned
//     unit and past its last one singly.
// The grid depends on the shape alone, so the bits do not depend on the card.

#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kLoads = 8;                              // 16-byte loads a thread a block
constexpr long long kChunk = 4LL * kThreads * kLoads;  // floats of a row a block covers
constexpr int kFinThreads = 1024;

struct Acc {
  double sum = 0.0;
  unsigned peak = 0;  // bits of the largest |x|
};

__device__ __forceinline__ void take(Acc& a, float v, bool summed) {
  if (summed) a.sum += (double)v * (double)v;
  a.peak = max(a.peak, __float_as_uint(v) & 0x7fffffffu);
}

template <int N>
__device__ __forceinline__ void block_reduce(double& sum, unsigned& peak,
                                             double* ssum, unsigned* speak) {
  const int t = threadIdx.x;
  ssum[t] = sum;
  speak[t] = peak;
  __syncthreads();
#pragma unroll
  for (int h = N / 2; h > 0; h /= 2) {
    if (t < h) {
      ssum[t] += ssum[t + h];
      speak[t] = max(speak[t], speak[t + h]);
    }
    __syncthreads();
  }
  sum = ssum[0];
  peak = speak[0];
}

// One block: floats [c0, c1) of row blockIdx.y.
__global__ void __launch_bounds__(kThreads)
    pack_rows_kernel(const float* __restrict__ x, long long row_floats,
                     long long sum_floats, __half* __restrict__ out,
                     double* __restrict__ part_sum, unsigned* __restrict__ part_peak) {
  __shared__ double ssum[kThreads];
  __shared__ unsigned speak[kThreads];
  const long long row = blockIdx.y;
  const long long base = row * row_floats;  // the row's first float in x
  const long long c0 = (long long)blockIdx.x * kChunk;
  const long long c1 = min(c0 + kChunk, row_floats);
  // the block's 16-byte units: [a0, a1), a0 the first float past c0 whose
  // address is a multiple of 16 bytes
  const long long a0 = min(c1, c0 + ((4 - (base + c0) % 4) % 4));
  const long long a1 = a0 + (c1 - a0) / 4 * 4;
  const float* xr = x + base;
  __half* orow = out ? out + base : nullptr;
  Acc acc;

  // the unaligned floats at either end (at most three each), singly
  const long long head = c0 + threadIdx.x, tail = a1 + threadIdx.x;
  if (head < a0) {
    const float h = xr[head];
    take(acc, h, head < sum_floats);
    if (orow) orow[head] = __float2half_rn(h);
  }
  if (tail < c1) {
    const float h = xr[tail];
    take(acc, h, tail < sum_floats);
    if (orow) orow[tail] = __float2half_rn(h);
  }

  float4 v[kLoads];
#pragma unroll
  for (int k = 0; k < kLoads; ++k) {
    const long long j = a0 + 4LL * (threadIdx.x + k * kThreads);
    v[k] = j < a1 ? *reinterpret_cast<const float4*>(xr + j) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int k = 0; k < kLoads; ++k) {
    const long long j = a0 + 4LL * (threadIdx.x + k * kThreads);
    if (j < a1) {
      take(acc, v[k].x, j < sum_floats);
      take(acc, v[k].y, j + 1 < sum_floats);
      take(acc, v[k].z, j + 2 < sum_floats);
      take(acc, v[k].w, j + 3 < sum_floats);
      if (orow) {
        const __half2 lo = __floats2half2_rn(v[k].x, v[k].y);
        const __half2 hi = __floats2half2_rn(v[k].z, v[k].w);
        uint2 u;
        u.x = *reinterpret_cast<const unsigned*>(&lo);
        u.y = *reinterpret_cast<const unsigned*>(&hi);
        *reinterpret_cast<uint2*>(orow + j) = u;
      }
    }
  }

  block_reduce<kThreads>(acc.sum, acc.peak, ssum, speak);
  if (threadIdx.x == 0) {
    const long long p = row * gridDim.x + blockIdx.x;
    part_sum[p] = acc.sum;
    part_peak[p] = acc.peak;
  }
}

// One block: each row's partials summed in a fixed order, over nsum, then
// the peak over every partial.
__global__ void __launch_bounds__(kFinThreads)
    pack_rows_finalize_kernel(const double* __restrict__ part_sum,
                              const unsigned* __restrict__ part_peak, int rows,
                              int nblk, long long nsum, double* __restrict__ stats) {
  __shared__ double ssum[kFinThreads];
  __shared__ unsigned speak[kFinThreads];
  unsigned peak = 0;
  for (int r = 0; r < rows; ++r) {
    double s = 0.0;
    for (int b = threadIdx.x; b < nblk; b += kFinThreads) {
      s += part_sum[(long long)r * nblk + b];
      peak = max(peak, part_peak[(long long)r * nblk + b]);
    }
    unsigned unused = 0;
    block_reduce<kFinThreads>(s, unused, ssum, speak);
    if (threadIdx.x == 0) stats[r] = s / (double)nsum;
    __syncthreads();
  }
  double unused = 0.0;
  block_reduce<kFinThreads>(unused, peak, ssum, speak);
  if (threadIdx.x == 0) stats[rows] = (double)__uint_as_float(peak);
}

long long blocks_per_row(long long row_floats) { return (row_floats + kChunk - 1) / kChunk; }

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

// Bytes of the workspace a launch over `rows` rows of `row_floats` floats
// needs: a float64 and a 32-bit partial per block.
extern "C" long long pack_rows_workspace_bytes(int rows, long long row_floats) {
  return (long long)rows * blocks_per_row(row_floats) * (sizeof(double) + sizeof(unsigned));
}

// x: (rows, row_floats) float32, 16-byte aligned; out: the same shape in
// float16, 8-byte aligned, or null (no rounding); stats: rows + 1 float64;
// work: pack_rows_workspace_bytes, 8-byte aligned.  Launches both kernels on
// `stream`; returns the launch's cudaError.
extern "C" int pack_rows_launch(const float* x, int rows, long long row_floats,
                                long long nsum, __half* out, void* work,
                                long long work_bytes, double* stats, int device,
                                void* stream) {
  const long long nblk = blocks_per_row(row_floats);
  if (rows <= 0 || rows > 65535 || row_floats <= 0 || row_floats % 2 != 0 || nsum <= 0 ||
      2 * nsum > row_floats || nblk > 0x7fffffff ||
      work_bytes < pack_rows_workspace_bytes(rows, row_floats) ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 8 != 0 ||
      reinterpret_cast<uintptr_t>(work) % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const DeviceGuard on(device);
  if (on.err != cudaSuccess) return (int)on.err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  double* part_sum = static_cast<double*>(work);
  unsigned* part_peak = reinterpret_cast<unsigned*>(part_sum + rows * nblk);
  pack_rows_kernel<<<dim3((unsigned)nblk, (unsigned)rows), kThreads, 0, s>>>(
      x, row_floats, 2 * nsum, out, part_sum, part_peak);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  pack_rows_finalize_kernel<<<1, kFinThreads, 0, s>>>(part_sum, part_peak, rows, (int)nblk,
                                                      nsum, stats);
  return (int)cudaGetLastError();
}
