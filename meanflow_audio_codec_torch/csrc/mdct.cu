// Forward MDCT with framing and windowing fused, f32, for sm_90a.
//
// Replaces: meanflow_audio_codec_tpu/ops/mdct_pallas.py::_mdct_pallas_kernel.
//
// Computes out[r, f, k] = sum_{n < 2W} x[r, f*hop + n] * WB[n, k], where WB
// is the [2W, W] windowed cosine basis and samples past the end of a row
// read as zero (the zero padding of the plain version).
//
// Bound on an H100 at the codec shape (8 rows of 32768 samples, W=512,
// hop=256, nf=127): 2*8*127*1024*512 = 1.07 GFLOP of f32 FMA against
// 1.0 MB of signal + 2.1 MB of basis + 2.1 MB of coefficients. At 67 TFLOP/s
// f32 and 3.35 TB/s that is 16 us of arithmetic against 1.6 us of memory:
// the bound is the f32 FMA rate. TF32 tensor cores are not an option: the
// transform's contract is rtol 1e-4 / atol 1e-3, which TF32 misses.
//
// Design: one block per (row, tile of FT frames, tile of 64 coefficients).
// The block loads the signal span its frames cover, (FT-1)*hop + 2W samples,
// into shared memory once (the TPU kernel's "read the signal once"; a gather
// would read each sample 2W/hop times), then streams 32-row chunks of the
// basis tile through shared memory. Each thread keeps a register tile of
// FPT frames x 2 coefficients, so one basis value feeds FPT FMAs and one
// span value (a broadcast read: a warp shares its frames) feeds 2. Nothing
// here uses tensor cores; making it fast (a 3xTF32 or tiled register-blocked
// variant) is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kCoeffsPerThread = 2;
constexpr int kCoeffTile = 32 * kCoeffsPerThread;  // 64 coefficients
constexpr int kChunk = 32;                         // basis rows per stage

constexpr int kFramesPerThread = 4;                // FPT
constexpr int kFrameTile = kWarps * kFramesPerThread;  // FT = 32 frames

// A warp owns frames warp, warp+8, ... of the tile.
__global__ void __launch_bounds__(kThreads)
mdct_kernel(const float* __restrict__ x, const float* __restrict__ wb,
            float* __restrict__ out, long long T, int nf, int W, int hop) {
  constexpr int FPT = kFramesPerThread;
  constexpr int FT = kFrameTile;
  extern __shared__ float smem[];
  const int two_w = 2 * W;
  const int span_len = (FT - 1) * hop + two_w;
  float* span = smem;             // [span_len]
  float* bs = smem + span_len;    // [kChunk][kCoeffTile]

  const long long row = blockIdx.x;
  const int f0 = blockIdx.y * FT;
  const int k0 = blockIdx.z * kCoeffTile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  const float* xr = x + row * T;
  const long long start = static_cast<long long>(f0) * hop;
  for (int i = threadIdx.x; i < span_len; i += kThreads) {
    const long long s = start + i;
    span[i] = s < T ? xr[s] : 0.f;
  }

  float acc[FPT][kCoeffsPerThread];
#pragma unroll
  for (int j = 0; j < FPT; ++j)
#pragma unroll
    for (int c = 0; c < kCoeffsPerThread; ++c) acc[j][c] = 0.f;

  for (int n0 = 0; n0 < two_w; n0 += kChunk) {
    __syncthreads();  // span written / previous basis chunk consumed
    for (int i = threadIdx.x; i < kChunk * kCoeffTile; i += kThreads) {
      const int n = n0 + i / kCoeffTile;
      const int k = k0 + i % kCoeffTile;
      bs[i] = (n < two_w && k < W) ? wb[static_cast<long long>(n) * W + k] : 0.f;
    }
    __syncthreads();
    const int rows = min(kChunk, two_w - n0);
    const float* sp = span + warp * hop + n0;
    for (int r = 0; r < rows; ++r) {
      float b[kCoeffsPerThread];
#pragma unroll
      for (int c = 0; c < kCoeffsPerThread; ++c)
        b[c] = bs[r * kCoeffTile + lane + 32 * c];
#pragma unroll
      for (int j = 0; j < FPT; ++j) {
        const float v = sp[j * kWarps * hop + r];
#pragma unroll
        for (int c = 0; c < kCoeffsPerThread; ++c)
          acc[j][c] = fmaf(v, b[c], acc[j][c]);
      }
    }
  }

#pragma unroll
  for (int j = 0; j < FPT; ++j) {
    const int f = f0 + warp + kWarps * j;
    if (f >= nf) continue;
    float* o = out + (row * nf + f) * W;
#pragma unroll
    for (int c = 0; c < kCoeffsPerThread; ++c) {
      const int k = k0 + lane + 32 * c;
      if (k < W) o[k] = acc[j][c];
    }
  }
}

}  // namespace

extern "C" {

// Shared memory of one block exceeds the device's limit (span too long).
constexpr int kErrSharedMemory = -1;

// x [rows, T] f32, wb [2W, W] f32, out [rows, nf, W] f32, all contiguous on
// the current device; launches on `stream`. Returns the CUDA error code, or
// kErrSharedMemory when the block's span and basis chunk do not fit.
int mdct_forward(const float* x, const float* wb, float* out, long long rows,
                 long long T, int nf, int W, int hop, void* stream) {
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(kFrameTile - 1) * hop + 2 * W + kChunk * kCoeffTile);
  int device = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > static_cast<size_t>(limit)) return kErrSharedMemory;
  err = cudaFuncSetAttribute(mdct_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(rows), (nf + kFrameTile - 1) / kFrameTile,
                  (W + kCoeffTile - 1) / kCoeffTile);
  mdct_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, wb, out, T, nf, W, hop);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
