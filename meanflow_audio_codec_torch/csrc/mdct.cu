// Forward MDCT with framing and windowing fused, f32, for sm_90a.
//
// Replaces: meanflow_audio_codec_tpu/ops/mdct_pallas.py::_mdct_pallas_kernel.
//
// Computes out[r, f, k] = sum_{n < 2W} x[r, f*hop + n] * WB[n, k], where WB
// is the [2W, W] windowed cosine basis and samples at or past the row's end
// T read as zero (the zero padding of the plain version); nf = 1 when T < W,
// else (T - W)/hop + 1.
//
// Bound on an H100 (SXM, 700 W) at the codec shape (8 rows of 32768 samples,
// W=512, hop=256, nf=127): 2*8*127*1024*512 = 1.07 GFLOP of f32 FMA against
// 1.0 MB of signal + 2.1 MB of basis + 2.1 MB of coefficients. At 67 TFLOP/s
// f32 and 3.35 TB/s that is 16 us of arithmetic against 1.6 us of memory:
// the bound is the f32 FMA rate. TF32 would miss the transform's rtol 1e-4 /
// atol 1e-3 contract, so this is plain FMA on the CUDA cores.
//
// Design: one GEMM with the framing folded into K. Cut each row into
// hop-sized chunks; with kf = ceil(2W/hop),
//   out[r, f, k] = sum_{j < kf} sum_{t < hop} x[r, (f+j)*hop + t] * WB[j*hop + t, k]
// dropping j*hop + t >= 2W. Number the frame slots of all rows g = r*chunks
// + f, chunks = nf + kf - 1, and let slot g read chunk u = g + j as
// x[u / chunks, (u % chunks)*hop + t]. For f < nf, f + j <= chunks - 1, so a
// stored slot reads only its own row; the kf - 1 slots f >= nf of each row
// are computed and not stored. The product is then one GEMM of M =
// rows*chunks slots x N = W coefficients x K = kf*hop whose A operand is a
// banded view of the signal, run by the tile core of tile_core.cuh (the
// IMDCT's): each block owns a disjoint 32-slot x 64-coefficient tile (no
// atomics, the same bits on every run), stages 32 samples x 4 slices at a
// time with cp.async three deep (the 35 chunks the 4 slices reach, staged
// once and read as shifted views), keeps a 4 x 8 register tile per thread
// and splits each stage's samples over 8 groups of 64 threads. Shared memory
// is 113 KB whatever W, hop and T are. At the codec shape the grid is 33 x 8
// = 264 blocks, two waves of one block per SM.
//
// Staging a frame tile's whole signal span, as the TPU kernel does, would
// take (frames-1)*hop + 2W floats of shared memory per block; staging 35
// chunk rows x 32 samples per stage keeps it fixed. Each shared-memory load
// feeds 5.3 FMAs and the copies run two stages ahead. What bounds the loop
// is issue: the FMAs share the issue slots with the copies' integer work,
// so, as in the IMDCT, the chunks a thread's A copies read are found once
// per slice block (an integer division each), not per copy; chip_smoke.py
// prints the main loop's instruction mix.

#include <cuda_runtime.h>

#include "tile_core.cuh"

namespace {

using namespace tile_core;

// kVW = 4: T, W and hop are multiples of 4 and x, wb are 16-byte aligned, so
// every staged group of 4 floats is one aligned 16-byte copy that straddles
// neither T nor a chunk's end; else 1.
template <int kVW>
__global__ void __launch_bounds__(kThreads, 1)
mdct_kernel(const float* __restrict__ x, const float* __restrict__ wb,
            float* __restrict__ out, long long T, int nf, int W, int hop,
            int kf, int chunks, int total_slots) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  using Cp = Copies<kVW>;
  const int g0 = blockIdx.x * kBM;  // first frame slot (all rows numbered)
  const int n0 = blockIdx.y * kBN;  // first coefficient
  const int two_w = 2 * W;
  const int t_steps = (hop + kBK - 1) / kBK;
  const int j_blocks = (kf + kJB - 1) / kJB;
  const Thread t;

  // Stages run slice block by slice block (j0 = 0, kJB, ...), sample step by
  // step (t0 = 0, kBK, ...) within each. The chunks the thread's A copies
  // read change only with j0: A row `row` is chunk u = g0 + j0 + row (slice
  // j0 + jj of tile slot cl reads it at row cl + jj), found here once per
  // slice block with the count of its samples that lie before T.
  const float* chunk[Cp::kAItems];
  int valid[Cp::kAItems];
  auto find_chunks = [&](int j0) {
#pragma unroll
    for (int r = 0; r < Cp::kAItems; ++r) {
      const int row = Cp::a_row(r);
      const int u = g0 + j0 + row;
      chunk[r] = x;
      valid[r] = 0;
      if (row < kARows && u < total_slots) {
        const int rr = u / chunks;
        const long long s = static_cast<long long>(u - rr * chunks) * hop;
        if (s < T) {
          chunk[r] = x + rr * T + s;
          valid[r] = T - s < hop ? static_cast<int>(T - s) : hop;
        }
      }
    }
  };
  int t0 = 0, j0 = 0;  // the next stage to issue
  find_chunks(0);
  auto issue = [&](float* As, float* Bs) {
    stage_a<kVW>(As, x, [&](int r, int, int k) -> const float* {
      return t0 + k < valid[r] ? chunk[r] + t0 + k : nullptr;
    });
    stage_b<kVW>(Bs, wb, [&](int jj, int k, int n) -> const float* {
      const int row = (j0 + jj) * hop + t0 + k;
      if (t0 + k >= hop || row >= two_w || n0 + n >= W) return nullptr;
      return wb + static_cast<long long>(row) * W + n0 + n;
    });
    t0 += kBK;
    if (t0 >= hop) {
      t0 = 0;
      j0 += kJB;
      find_chunks(j0);
    }
  };

  float acc[kTM][kTN];
  run_stages<false>(smem, t_steps * j_blocks, t, acc, issue);
  reduce_store(smem, t, acc, [&](int cl, int n, float v) {
    const int g = g0 + cl;
    if (g >= total_slots || n0 + n >= W) return;
    const int r = g / chunks, f = g - r * chunks;
    if (f < nf) out[(static_cast<long long>(r) * nf + f) * W + n0 + n] = v;
  });
}

}  // namespace

extern "C" {

// x [rows, T] f32, wb [2W, W] f32, out [rows, nf, W] f32, all contiguous on
// the current device; hop <= W and rows * (nf + ceil(2W/hop) - 1) below
// 2**31. Launches on `stream` and returns the CUDA error code.
int mdct_forward(const float* x, const float* wb, float* out, long long rows,
                 long long T, int nf, int W, int hop, void* stream) {
  const int kf = (2 * W + hop - 1) / hop;
  const int chunks = nf + kf - 1;
  const int total = static_cast<int>(rows * chunks);
  const dim3 grid(static_cast<unsigned>((total + kBM - 1) / kBM),
                  static_cast<unsigned>((W + kBN - 1) / kBN));
  const auto s = static_cast<cudaStream_t>(stream);
  const bool vec = T % 4 == 0 && W % 4 == 0 && hop % 4 == 0 &&
                   reinterpret_cast<unsigned long long>(x) % 16 == 0 &&
                   reinterpret_cast<unsigned long long>(wb) % 16 == 0;
  const auto kernel = vec ? &mdct_kernel<4> : &mdct_kernel<1>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, kSmemBytes, s>>>(x, wb, out, T, nf, W, hop, kf,
                                            chunks, total);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
