// The ConvNeXt stage's three normalisation segments, f32 or bf16, for sm_90a.
//
// Replaces, in meanflow_audio_codec_tpu/ops/stage_pallas.py:
//   ln_film_forward  <- _ln_film_pallas   (LayerNorm over C + FiLM, emits mu, r)
//   ln_norm_forward  <- _ln_norm_pallas   (LayerNorm over C, emits mu, r)
//   gelu_grn_forward <- _gelu_grn_pallas  (tanh-GELU + ConvNeXt-V2 GRN, emits gx)
//
// Bound on an H100: bytes. At the frontier-v2 train shape (N = 2032 rows of
// P = 64 positions, C = 256, bf16) the LayerNorm kernels read 66.6 MB and
// write 66.6 MB plus 1 MB of statistics, about 40 us at 3.35 TB/s, against a
// few FLOPs per byte; the GELU+GRN kernel (C = 512) moves twice that. So the
// design goal is the Pallas kernels' own: read each input once from device
// memory, keep the statistics on chip, write each output once.
//
// LayerNorm: one warp per row of C values (N*P rows). Lanes read consecutive
// channels, 16 bytes at a time where C and the pointers allow it, and sum in
// f32 with warp shuffles. The variance is two-pass (mean, then the mean of
// squared deviations), as the plain version computes it. The row is read
// three times by its own warp (sum, deviations, normalise); the second and
// third reads hit L1, so device memory sees it once. FiLM's scale/shift row
// is row / P.
//
// GELU+GRN: one block per batch row n, threads walking the channels (16-byte
// loads where possible), so a warp reads a contiguous stretch at each
// position. Each thread sums g^2 over the P positions of its channels,
// writes gx, and a block reduction gives mean_C gx. A second pass recomputes
// g from x (the 64 KB slice of row n is read again, from L2 where it is still
// there) and writes y. N = 2032 blocks fill the 132 SMs, so there is no
// cross-block reduction. Holding the slice in shared memory instead of
// re-reading it is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kLnEps = 1e-6f;
constexpr float kGrnSqEps = 1e-12f;
constexpr float kGrnMeanEps = 1e-6f;
constexpr float kGeluA = 0.7978845608028654f;  // sqrt(2 / pi)
constexpr float kGeluK = 0.044715f;

constexpr int kLnWarps = 8;         // rows per LayerNorm block
constexpr int kGrnMaxThreads = 256;

// V consecutive values of T moved as one aligned load or store.
template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype/to do
}

template <typename T, int V>
__device__ __forceinline__ void load(const T* p, float (&out)[V]) {
  const Vec<T, V> vec = *reinterpret_cast<const Vec<T, V>*>(p);
#pragma unroll
  for (int i = 0; i < V; ++i) out[i] = to_f32(vec.v[i]);
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const float (&in)[V]) {
  Vec<T, V> vec;
#pragma unroll
  for (int i = 0; i < V; ++i) vec.v[i] = from_f32<T>(in[i]);
  *reinterpret_cast<Vec<T, V>*>(p) = vec;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  return v;
}

__device__ __forceinline__ float gelu(float x) {
  const float u = kGeluA * (x + kGeluK * x * x * x);
  return 0.5f * x * (1.f + tanhf(u));
}

// y = (x - mean) * rsqrt(var + eps) over each row of C, then, with kFilm,
// (1 + scale[row / P]) * y + shift[row / P]. C % V == 0.
template <typename T, int V, bool kFilm>
__global__ void __launch_bounds__(32 * kLnWarps)
ln_kernel(const T* __restrict__ x, const T* __restrict__ scale,
          const T* __restrict__ shift, T* __restrict__ y,
          float* __restrict__ mu_out, float* __restrict__ r_out,
          long long rows, int P, int C) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kLnWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // a whole warp leaves together
  const int lane = threadIdx.x & 31;
  const T* xr = x + row * C;
  const float count = static_cast<float>(C);

  float sum = 0.f;
  for (int c = lane * V; c < C; c += 32 * V) {
    float v[V];
    load<T, V>(xr + c, v);
#pragma unroll
    for (int i = 0; i < V; ++i) sum += v[i];
  }
  const float mean = warp_sum(sum) / count;

  float sq = 0.f;
  for (int c = lane * V; c < C; c += 32 * V) {
    float v[V];
    load<T, V>(xr + c, v);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float d = v[i] - mean;
      sq += d * d;
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / count + kLnEps);

  T* yr = y + row * C;
  const long long n = row / P;
  for (int c = lane * V; c < C; c += 32 * V) {
    float v[V], out[V];
    load<T, V>(xr + c, v);
    if constexpr (kFilm) {
      float s[V], b[V];
      load<T, V>(scale + n * C + c, s);
      load<T, V>(shift + n * C + c, b);
#pragma unroll
      for (int i = 0; i < V; ++i)
        out[i] = (1.f + s[i]) * ((v[i] - mean) * rstd) + b[i];
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) out[i] = (v[i] - mean) * rstd;
    }
    store<T, V>(yr + c, out);
  }
  if (lane == 0) {
    mu_out[row] = mean;
    r_out[row] = rstd;
  }
}

// Block n: g = gelu(x[n]) over [P, C]; gx[c] = sqrt(sum_p g^2 + eps);
// y = g * (gamma + gx / (mean_c gx + eps)) + beta. C % V == 0.
template <typename T, int V>
__global__ void __launch_bounds__(kGrnMaxThreads)
gelu_grn_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                const float* __restrict__ beta, T* __restrict__ y,
                float* __restrict__ gx_out, int P, int C) {
  __shared__ float warp_part[kGrnMaxThreads / 32];
  const long long n = blockIdx.x;
  const T* xn = x + n * P * C;
  T* yn = y + n * P * C;
  float* gxn = gx_out + n * C;
  const int step = blockDim.x * V;

  float part = 0.f;
  for (int c = threadIdx.x * V; c < C; c += step) {
    float acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.f;
#pragma unroll 4
    for (int p = 0; p < P; ++p) {
      float v[V];
      load<T, V>(xn + static_cast<long long>(p) * C + c, v);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float g = gelu(v[i]);
        acc[i] += g * g;
      }
    }
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float gx = sqrtf(acc[i] + kGrnSqEps);
      gxn[c + i] = gx;  // read back below by this same thread
      part += gx;
    }
  }

  part = warp_sum(part);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_part[warp] = part;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < (blockDim.x + 31) / 32; ++w) total += warp_part[w];
  const float m = total / static_cast<float>(C) + kGrnMeanEps;

  for (int c = threadIdx.x * V; c < C; c += step) {
    float scale[V], bias[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      scale[i] = gamma[c + i] + gxn[c + i] / m;
      bias[i] = beta[c + i];
    }
#pragma unroll 4
    for (int p = 0; p < P; ++p) {
      const long long at = static_cast<long long>(p) * C + c;
      float v[V], out[V];
      load<T, V>(xn + at, v);
#pragma unroll
      for (int i = 0; i < V; ++i) out[i] = gelu(v[i]) * scale[i] + bias[i];
      store<T, V>(yn + at, out);
    }
  }
}

bool aligned16(const void* a, const void* b = nullptr,
               const void* c = nullptr, const void* d = nullptr) {
  const auto bits = reinterpret_cast<std::uintptr_t>(a) |
                    reinterpret_cast<std::uintptr_t>(b) |
                    reinterpret_cast<std::uintptr_t>(c) |
                    reinterpret_cast<std::uintptr_t>(d);
  return bits % 16 == 0;
}

// dtype codes, as ops/stage_cuda.py passes them
constexpr int kF32 = 0;
constexpr int kBF16 = 1;
// errors other than CUDA's own
constexpr int kErrGrid = -1;   // more rows than a launch grid holds
constexpr int kErrDtype = -2;  // unknown dtype code
constexpr long long kMaxGrid = 0x7fffffffLL;

template <typename T, bool kFilm>
int launch_ln(const void* x, const void* scale, const void* shift, void* y,
              float* mu, float* r, long long rows, int P, int C,
              cudaStream_t stream) {
  const long long blocks = (rows + kLnWarps - 1) / kLnWarps;
  if (blocks > kMaxGrid) return kErrGrid;
  constexpr int kV = 16 / sizeof(T);
  const auto* xt = static_cast<const T*>(x);
  const auto* st = static_cast<const T*>(scale);
  const auto* bt = static_cast<const T*>(shift);
  auto* yt = static_cast<T*>(y);
  const bool vec = C % kV == 0 && aligned16(x, y, scale, shift);
  if (vec)
    ln_kernel<T, kV, kFilm><<<static_cast<unsigned>(blocks), 32 * kLnWarps, 0,
                              stream>>>(xt, st, bt, yt, mu, r, rows, P, C);
  else
    ln_kernel<T, 1, kFilm><<<static_cast<unsigned>(blocks), 32 * kLnWarps, 0,
                             stream>>>(xt, st, bt, yt, mu, r, rows, P, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x [rows / P, P, C] in `dtype`, scale and shift [rows / P, C] in `dtype`,
// y like x, mu and r [rows] f32; all contiguous on the current device.
int ln_film_forward(const void* x, const void* scale, const void* shift,
                    void* y, float* mu, float* r, long long rows, int P, int C,
                    int dtype, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch_ln<float, true>(x, scale, shift, y, mu, r, rows, P, C, s);
  if (dtype == kBF16)
    return launch_ln<__nv_bfloat16, true>(x, scale, shift, y, mu, r, rows, P,
                                          C, s);
  return kErrDtype;
}

// x [rows, C] in `dtype`, y like x, mu and r [rows] f32.
int ln_norm_forward(const void* x, void* y, float* mu, float* r,
                    long long rows, int C, int dtype, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch_ln<float, false>(x, nullptr, nullptr, y, mu, r, rows, 1, C,
                                   s);
  if (dtype == kBF16)
    return launch_ln<__nv_bfloat16, false>(x, nullptr, nullptr, y, mu, r, rows,
                                           1, C, s);
  return kErrDtype;
}

// x [N, P, C] in `dtype`, gamma and beta [C] f32, y like x, gx [N, C] f32.
int gelu_grn_forward(const void* x, const float* gamma, const float* beta,
                     void* y, float* gx, long long N, int P, int C, int dtype,
                     void* stream) {
  if (N > kMaxGrid) return kErrGrid;
  const auto s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>(N);
  const bool vec = aligned16(x, y);
  auto threads = [C](int v) {
    const int vectors = (C + v - 1) / v;
    return vectors >= kGrnMaxThreads ? kGrnMaxThreads : (vectors + 31) / 32 * 32;
  };
  if (dtype == kF32) {
    const auto* xt = static_cast<const float*>(x);
    auto* yt = static_cast<float*>(y);
    if (vec && C % 4 == 0)
      gelu_grn_kernel<float, 4><<<blocks, threads(4), 0, s>>>(xt, gamma, beta,
                                                             yt, gx, P, C);
    else
      gelu_grn_kernel<float, 1><<<blocks, threads(1), 0, s>>>(xt, gamma, beta,
                                                             yt, gx, P, C);
  } else if (dtype == kBF16) {
    const auto* xt = static_cast<const __nv_bfloat16*>(x);
    auto* yt = static_cast<__nv_bfloat16*>(y);
    if (vec && C % 8 == 0)
      gelu_grn_kernel<__nv_bfloat16, 8><<<blocks, threads(8), 0, s>>>(
          xt, gamma, beta, yt, gx, P, C);
    else
      gelu_grn_kernel<__nv_bfloat16, 1><<<blocks, threads(1), 0, s>>>(
          xt, gamma, beta, yt, gx, P, C);
  } else {
    return kErrDtype;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
