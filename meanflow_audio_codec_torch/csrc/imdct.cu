// Inverse MDCT with overlap-add fused, f32, for sm_90a.
//
// Replaces: meanflow_audio_codec_tpu/ops/imdct_pallas.py::_imdct_pallas_kernel.
//
// Computes out[r, s] = scale * sum_f sum_k X[r, f, k] * WBT[k, s - f*hop] over
// the frames f with 0 <= s - f*hop < 2W, where WBT is the [W, 2W] transpose
// of the windowed cosine basis and scale = 2/W (times hop/W to normalize).
// The output has (nf-1)*hop + 2W samples per row.
//
// Bound on an H100 (SXM, 700 W) at the codec shape (8 rows, nf=127, W=512,
// hop=256): 2*8*127*512*1024 = 1.07 GFLOP of f32 FMA against 2.1 MB of
// coefficients + 2.1 MB of basis + 1.1 MB of signal. At 67 TFLOP/s f32 and
// 3.35 TB/s that is 16 us of arithmetic against 1.6 us of memory: the bound
// is the f32 FMA rate. TF32 would miss the transform's rtol 1e-4 / atol 1e-3
// contract, so this is plain FMA on the CUDA cores.
//
// Design: one GEMM with the overlap-add folded into K. Output sample s of
// row r lies in chunk c = s / hop at t = s % hop, and
//   out[r, c*hop + t] = scale * sum_{j < kf} sum_k X[r, c-j, k] * WBT[k, j*hop + t]
// with kf = ceil(2W/hop), dropping j*hop + t >= 2W and frames outside
// [0, nf). Number the chunks of all rows g = r*chunks + c, chunks =
// nf + kf - 1, and read "frame" u = g - j as X[u / chunks, u % chunks] when
// u % chunks < nf and as zeros otherwise: the frames a chunk takes from
// before its row's start (c - j < 0) land on the previous row's tail, past
// its nf frames, so they are zeros too. The product is then one GEMM of
// M = rows*chunks chunks x N = hop samples x K = kf*W whose A operand is a
// banded view of X, run by the tile core of tile_core.cuh: each block owns
// a disjoint 32-chunk x 64-sample tile (no atomics, the same bits on every
// run), stages 32 coefficients x 4 slices at a time with cp.async (the 35
// frames the 4 slices reach, staged once and read as shifted views), keeps
// a 4 x 8 register tile per thread and splits each stage's coefficients
// over 8 groups of 64 threads. Shared memory is 113 KB whatever W, hop and
// nf are. At the codec shape the grid is 33 x 4 = 132 blocks, one per SM;
// the 10 s clip (2 rows x 1721 frames) takes 108 x 4 = 432.
//
// The earlier kernel read its frame operand from shared memory once per
// FMA and streamed the basis from L2 into one sample per thread, 136 blocks
// of 8 warps. Here each shared-memory load feeds 5.3 FMAs. The FMAs share
// the issue slots with the copies' integer work, so the frames a thread's
// copies read are found once per slice block, not per copy (an integer
// division each); chip_smoke.py prints the main loop's instruction mix.

#include <cuda_runtime.h>

#include "tile_core.cuh"

namespace {

using namespace tile_core;

// kVW = 4: W and hop are multiples of 4 and X, WBT are 16-byte aligned, so
// every staged group of 4 floats is one aligned 16-byte copy; else 1.
template <int kVW>
__global__ void __launch_bounds__(kThreads, 1)
imdct_kernel(const float* __restrict__ X, const float* __restrict__ wbt,
             float* __restrict__ out, int nf, int W, int hop, int kf,
             int chunks, int total_chunks, long long out_len, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  using Cp = Copies<kVW>;
  const int g0 = blockIdx.x * kBM;  // first chunk (all rows numbered)
  const int n0 = blockIdx.y * kBN;  // first sample within the chunk
  const int two_w = 2 * W;
  const int k_steps = (W + kBK - 1) / kBK;
  const int j_blocks = (kf + kJB - 1) / kJB;
  const Thread t;

  // Stages run slice block by slice block (j0 = 0, kJB, ...), coefficient
  // step by step (k0 = 0, kBK, ...) within each. The frames the thread's A
  // copies read change only with j0: A row `row` is frame u = g0 - j0 -
  // (kJB-1) + row (slice j0 + jj of tile chunk cl reads it at row cl +
  // kJB-1-jj), found here once per slice block.
  const float* frame[Cp::kAItems];
  auto find_frames = [&](int j0) {
#pragma unroll
    for (int r = 0; r < Cp::kAItems; ++r) {
      const int row = Cp::a_row(r);
      const int u = g0 - j0 - (kJB - 1) + row;
      frame[r] = nullptr;
      if (row < kARows && u >= 0 && u < total_chunks) {
        const int rr = u / chunks, f = u - rr * chunks;
        if (f < nf) frame[r] = X + (static_cast<long long>(rr) * nf + f) * W;
      }
    }
  };
  int k0 = 0, j0 = 0;  // the next stage to issue
  find_frames(0);
  auto issue = [&](float* As, float* Bs) {
    stage_a<kVW>(As, X, [&](int r, int, int k) -> const float* {
      return frame[r] != nullptr && k0 + k < W ? frame[r] + k0 + k : nullptr;
    });
    stage_b<kVW>(Bs, wbt, [&](int jj, int k, int n) -> const float* {
      const int col = (j0 + jj) * hop + n0 + n;
      if (k0 + k >= W || n0 + n >= hop || col >= two_w) return nullptr;
      return wbt + static_cast<long long>(k0 + k) * two_w + col;
    });
    k0 += kBK;
    if (k0 >= W) {
      k0 = 0;
      j0 += kJB;
      find_frames(j0);
    }
  };

  float acc[kTM][kTN];
  run_stages<true>(smem, k_steps * j_blocks, t, acc, issue);
  reduce_store(smem, t, acc, [&](int cl, int n, float v) {
    const int g = g0 + cl;
    if (g >= total_chunks || n0 + n >= hop) return;
    const int r = g / chunks, c = g - r * chunks;
    const long long s = static_cast<long long>(c) * hop + n0 + n;
    if (s < out_len) out[r * out_len + s] = v * scale;
  });
}

}  // namespace

extern "C" {

// X [rows, nf, W] f32, wbt [W, 2W] f32, out [rows, out_len] f32 with
// out_len = (nf-1)*hop + 2W, all contiguous on the current device; hop <= W
// and rows * (nf + ceil(2W/hop) - 1) below 2**31. Launches on `stream` and
// returns the CUDA error code.
int imdct_forward(const float* X, const float* wbt, float* out, long long rows,
                  int nf, int W, int hop, float scale, void* stream) {
  const long long out_len = static_cast<long long>(nf - 1) * hop + 2 * W;
  const int kf = (2 * W + hop - 1) / hop;
  const int chunks = nf + kf - 1;
  const int total = static_cast<int>(rows * chunks);
  const dim3 grid(static_cast<unsigned>((total + kBM - 1) / kBM),
                  static_cast<unsigned>((hop + kBN - 1) / kBN));
  const auto s = static_cast<cudaStream_t>(stream);
  const bool vec = W % 4 == 0 && hop % 4 == 0 &&
                   reinterpret_cast<unsigned long long>(X) % 16 == 0 &&
                   reinterpret_cast<unsigned long long>(wbt) % 16 == 0;
  const auto kernel = vec ? &imdct_kernel<4> : &imdct_kernel<1>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, kSmemBytes, s>>>(X, wbt, out, nf, W, hop, kf,
                                            chunks, total, out_len, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
