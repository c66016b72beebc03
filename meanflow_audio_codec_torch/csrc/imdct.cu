// Inverse MDCT with overlap-add fused, f32, for sm_90a.
//
// Replaces: meanflow_audio_codec_tpu/ops/imdct_pallas.py::_imdct_pallas_kernel.
//
// Computes out[r, s] = scale * sum_f sum_k X[r, f, k] * WBT[k, s - f*hop] over
// the frames f with 0 <= s - f*hop < 2W, where WBT is the [W, 2W] transpose
// of the windowed cosine basis and scale = 2/W (times hop/W to normalize).
// The output has (nf-1)*hop + 2W samples per row.
//
// Bound on an H100 at the codec shape (8 rows, nf=127, W=512, hop=256):
// 2*8*127*512*1024 = 1.07 GFLOP of f32 FMA against 2.1 MB of coefficients +
// 2.1 MB of basis + 1.1 MB of signal. At 67 TFLOP/s f32 and 3.35 TB/s that is
// 16 us of arithmetic against 1.6 us of memory: the bound is the f32 FMA rate.
// TF32 would miss the transform's rtol 1e-4 / atol 1e-3 contract.
//
// Design: output sample s lies in chunk c = s / hop, and the frames that
// reach chunk c are c-kf+1 .. c, kf = ceil(2W/hop). One block owns CB
// consecutive chunks of one row, a disjoint stretch of the output, so the
// overlap-add needs no atomics and the result is the same bits on every run.
// The block loads the CB+kf-1 coefficient frames that reach its chunks into
// shared memory once. Thread t computes sample t of each of its CB chunks:
// for basis slice j (n = j*hop + t) chunk c uses frame c-j, so one basis
// value read from global memory (coalesced, L2-resident) feeds CB FMAs, and
// the frame values are broadcast reads. No tensor cores; speed is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunksPerBlock = 8;  // CB

__global__ void __launch_bounds__(kThreads)
imdct_kernel(const float* __restrict__ X, const float* __restrict__ wbt,
             float* __restrict__ out, int nf, int W, int hop,
             long long out_len, float scale) {
  constexpr int CB = kChunksPerBlock;
  extern __shared__ float xs[];  // [CB + kf - 1][W]
  const int two_w = 2 * W;
  const int kf = (two_w + hop - 1) / hop;
  const int nloc = CB + kf - 1;
  const long long row = blockIdx.x;
  const long long c0 = static_cast<long long>(blockIdx.y) * CB;
  const long long fbase = c0 - (kf - 1);  // frame held at local index 0

  const float* xr = X + row * nf * W;
  for (int i = threadIdx.x; i < nloc * W; i += kThreads) {
    const long long f = fbase + i / W;
    xs[i] = (f >= 0 && f < nf) ? xr[f * W + i % W] : 0.f;
  }
  __syncthreads();

  float* outr = out + row * out_len;
  for (int t = threadIdx.x; t < hop; t += kThreads) {
    float acc[CB];
#pragma unroll
    for (int cb = 0; cb < CB; ++cb) acc[cb] = 0.f;
    for (int j = 0; j < kf; ++j) {
      const int n = j * hop + t;
      if (n >= two_w) break;  // last slice is partial when hop does not divide 2W
      // chunk c0+cb takes frame c0+cb-j, held at local index cb-j+kf-1
      const float* xj = xs + (kf - 1 - j) * W;
      const float* bj = wbt + n;
      for (int k = 0; k < W; ++k) {
        const float b = __ldg(bj + static_cast<long long>(k) * two_w);
#pragma unroll
        for (int cb = 0; cb < CB; ++cb)
          acc[cb] = fmaf(xj[cb * W + k], b, acc[cb]);
      }
    }
#pragma unroll
    for (int cb = 0; cb < CB; ++cb) {
      const long long s = (c0 + cb) * hop + t;
      if (s < out_len) outr[s] = acc[cb] * scale;
    }
  }
}

}  // namespace

extern "C" {

// Shared memory of one block exceeds the device's limit (too many frames).
constexpr int kErrSharedMemory = -1;

// X [rows, nf, W] f32, wbt [W, 2W] f32, out [rows, out_len] f32 with
// out_len = (nf-1)*hop + 2W, all contiguous on the current device; launches
// on `stream`. Returns the CUDA error code, or kErrSharedMemory when the
// block's coefficient frames do not fit.
int imdct_forward(const float* X, const float* wbt, float* out, long long rows,
                  int nf, int W, int hop, float scale, void* stream) {
  const long long out_len = static_cast<long long>(nf - 1) * hop + 2 * W;
  const int kf = (2 * W + hop - 1) / hop;
  const size_t smem =
      sizeof(float) * static_cast<size_t>(kChunksPerBlock + kf - 1) * W;
  int device = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > static_cast<size_t>(limit)) return kErrSharedMemory;
  err = cudaFuncSetAttribute(imdct_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long chunks = (out_len + hop - 1) / hop;
  const dim3 grid(static_cast<unsigned>(rows),
                  static_cast<unsigned>((chunks + kChunksPerBlock - 1) /
                                        kChunksPerBlock));
  imdct_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      X, wbt, out, nf, W, hop, out_len, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
