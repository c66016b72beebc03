// Shared f32 tile core for the MDCT-family GEMMs, for sm_90a.
//
// Both transforms are one GEMM whose A operand is a banded (Toeplitz) view
// of a sequence of rows: with hop-sized chunks, slice j of the basis meets
// row u -/+ j of the sequence. For the IMDCT the rows are coefficient
// frames and output chunk c takes frame c - j (overlap-add folded into K);
// for the MDCT they are signal chunks and frame f takes chunk f + j.
//
// A block owns a disjoint kBM x kBN output tile and walks K in stages of
// kBK coefficients (IMDCT) or samples (MDCT) x kJB slices; "coefficients"
// below stands for either. Each stage holds in shared memory
//   A: the kBM + kJB - 1 sequence rows its slices reach, x kBK   (row-major,
//      pitch kAPitch: 16-byte rows whose neighbours start 36 words apart,
//      so the 4 row addresses a warp reads at once fall in 4 banks)
//   B: kJB x kBK x kBN basis values
// and the kJB slices read A as views shifted by one row each, so one staged
// A row feeds kJB slices. Stages are copied with cp.async (zero-filled where
// a caller's source function returns nullptr) kStages deep, so the next
// stages' loads overlap this stage's FMAs. Each thread's share of the copies
// is fixed (Copies), so a caller works out once per slice block what its
// copies read and spends a few integer operations per copy and stage.
//
// The block's 512 threads form kGroups = 8 groups of 64 that split each
// stage's kBK coefficients (intra-block split-K: eight times the threads on
// one tile, no atomics). In a group, thread (cg, sg) keeps a kTM x kTN
// register tile: chunks cg + 8m (m < kTM) and samples 4sg + [0, 4),
// 32 + 4sg + [0, 4). Per coefficient and slice it loads kTM A values and two
// float4 of B from shared memory for kTM * kTN = 32 FMAs. At the end the
// groups' partial tiles are summed through shared memory in a fixed order:
// the result is the same bits on every run.
//
// An 8 x 8 register tile (one warp per group) would load less per FMA, but
// it spills at the 128 registers a 512-thread block may have.

#pragma once

#include <cuda_runtime.h>

namespace tile_core {

constexpr int kThreads = 512;
constexpr int kGroups = 8;                 // split of each stage's kBK
constexpr int kBM = 32;                    // output rows (chunks) per block
constexpr int kBN = 64;                    // output columns (samples) per block
constexpr int kBK = 32;                    // coefficients per stage
constexpr int kJB = 4;                     // basis slices per stage
constexpr int kTM = 4;                     // register tile: rows
constexpr int kTN = 8;                     // register tile: columns
constexpr int kKQ = kBK / kGroups;         // coefficients per group per stage
constexpr int kARows = kBM + kJB - 1;
constexpr int kAPitch = kBK + 4;
constexpr int kAFloats = kARows * kAPitch;
constexpr int kBFloats = kJB * kBK * kBN;
constexpr int kStageFloats = kAFloats + kBFloats;
constexpr int kStages = 3;
constexpr int kSmemBytes = sizeof(float) * kStages * kStageFloats;

static_assert(kGroups * 64 == kThreads, "a group is 8 x 8 threads");
static_assert(kBM == 8 * kTM && kBN == 8 * kTN, "8 x 8 threads per group");
static_assert(kGroups * kBM * kBN <= kStages * kStageFloats,
              "the split-K partials reuse the stage buffers");
static_assert(kAPitch % 4 == 0 && kAFloats % 4 == 0, "16-byte A rows");

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy kVW floats from p, or zero-fill them when p is nullptr: 4 when every
// source group is 16 bytes aligned, else 1. `base` is any valid global
// address (a zero-fill reads nothing from it).
template <int kVW>
__device__ __forceinline__ void copy(float* dst, const float* base,
                                     const float* p) {
  if constexpr (kVW == 4)
    cp_async16(dst, p ? p : base, p != nullptr);
  else
    cp_async4(dst, p ? p : base, p != nullptr);
}

// The copies of one stage are split over the threads in a fixed pattern:
// a thread's r-th A copy is item tid + r*kThreads of the kARows x kBK/kVW
// groups, row-major, and likewise for B's kJB*kBK x kBN/kVW groups. So a
// caller can work out once what a thread's items need (a_row below) and
// keep it in registers across stages.
template <int kVW>
struct Copies {
  static constexpr int kAPerRow = kBK / kVW;
  static constexpr int kAItems =
      (kARows * kAPerRow + kThreads - 1) / kThreads;
  static constexpr int kBPerRow = kBN / kVW;
  static constexpr int kBItems = kJB * kBK * kBPerRow / kThreads;
  static_assert(kJB * kBK * kBPerRow % kThreads == 0, "whole B items");
  // row of the thread's r-th A copy (>= kARows: none)
  __device__ static int a_row(int r) {
    return (static_cast<int>(threadIdx.x) + r * kThreads) / kAPerRow;
  }
};

// Stage A: a_src(r, row, k) for the thread's copies r, row < kARows,
// k < kBK in steps of kVW.
template <int kVW, typename ASrc>
__device__ __forceinline__ void stage_a(float* As, const float* base,
                                        ASrc a_src) {
  using C = Copies<kVW>;
#pragma unroll
  for (int r = 0; r < C::kAItems; ++r) {
    const int i = static_cast<int>(threadIdx.x) + r * kThreads;
    if (i >= kARows * C::kAPerRow) break;
    const int row = i / C::kAPerRow, k = (i % C::kAPerRow) * kVW;
    copy<kVW>(As + row * kAPitch + k, base, a_src(r, row, k));
  }
}

// Stage B: b_src(jj, k, n) for jj < kJB, k < kBK, n < kBN in steps of kVW.
template <int kVW, typename BSrc>
__device__ __forceinline__ void stage_b(float* Bs, const float* base,
                                        BSrc b_src) {
  using C = Copies<kVW>;
#pragma unroll
  for (int r = 0; r < C::kBItems; ++r) {
    const int i = static_cast<int>(threadIdx.x) + r * kThreads;
    const int n = (i % C::kBPerRow) * kVW, jk = i / C::kBPerRow;
    copy<kVW>(Bs + jk * kBN + n, base, b_src(jk / kBK, jk % kBK, n));
  }
}

struct Thread {
  int q, cg, sg;  // group, chunk lane (rows cg + 8m), sample lane
  __device__ Thread()
      : q(threadIdx.x / 64), cg((threadIdx.x % 64) / 8), sg(threadIdx.x % 8) {}
};

// acc += the stage's product. Slice jj reads A row cl + kJB-1-jj (kDown, the
// IMDCT: chunk c takes frame c - j) or cl + jj (the MDCT: frame f takes
// chunk f + j) for tile row cl.
template <bool kDown>
__device__ __forceinline__ void accumulate(const float* As, const float* Bs,
                                           const Thread& t,
                                           float (&acc)[kTM][kTN]) {
#pragma unroll
  for (int kk = 0; kk < kKQ; ++kk) {
    const int k = t.q * kKQ + kk;
#pragma unroll
    for (int jj = 0; jj < kJB; ++jj) {
      const int shift = kDown ? kJB - 1 - jj : jj;
      float a[kTM];
#pragma unroll
      for (int m = 0; m < kTM; ++m)
        a[m] = As[(t.cg + 8 * m + shift) * kAPitch + k];
      const float* brow = Bs + (jj * kBK + k) * kBN;
      const float4 b0 = *reinterpret_cast<const float4*>(brow + 4 * t.sg);
      const float4 b1 =
          *reinterpret_cast<const float4*>(brow + 32 + 4 * t.sg);
      const float b[kTN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int m = 0; m < kTM; ++m)
#pragma unroll
        for (int e = 0; e < kTN; ++e) acc[m][e] = fmaf(a[m], b[e], acc[m][e]);
    }
  }
}

// Runs `steps` stages through a kStages-deep cp.async ring: issue(As, Bs)
// stages the next stage (it is called once per stage, in order, and must
// copy through stage_a / stage_b only), then every group accumulates its
// share. On return all copies have landed and every thread has passed a
// barrier, so `smem` may be reused.
template <bool kDown, typename Issue>
__device__ __forceinline__ void run_stages(float* smem, int steps,
                                           const Thread& t,
                                           float (&acc)[kTM][kTN],
                                           Issue issue) {
#pragma unroll
  for (int m = 0; m < kTM; ++m)
#pragma unroll
    for (int e = 0; e < kTN; ++e) acc[m][e] = 0.f;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) {
      float* As = smem + s * kStageFloats;
      issue(As, As + kAFloats);
    }
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage `step` landed; stage step-1 fully consumed
    const int next = step + kStages - 1;
    if (next < steps) {
      float* As = smem + (next % kStages) * kStageFloats;
      issue(As, As + kAFloats);
    }
    cp_async_commit();
    const float* As = smem + (step % kStages) * kStageFloats;
    accumulate<kDown>(As, As + kAFloats, t, acc);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// Sums the groups' partial tiles in group order and calls store(row, col,
// value) for each of the kBM x kBN tile positions, consecutive threads on
// consecutive columns.
template <typename Store>
__device__ __forceinline__ void reduce_store(float* smem, const Thread& t,
                                             const float (&acc)[kTM][kTN],
                                             Store store) {
#pragma unroll
  for (int m = 0; m < kTM; ++m) {
    float* dst = smem + (t.q * kBM + t.cg + 8 * m) * kBN;
    *reinterpret_cast<float4*>(dst + 4 * t.sg) =
        make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
    *reinterpret_cast<float4*>(dst + 32 + 4 * t.sg) =
        make_float4(acc[m][4], acc[m][5], acc[m][6], acc[m][7]);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kBM * kBN; e += kThreads) {
    float v = smem[e];
#pragma unroll
    for (int q = 1; q < kGroups; ++q) v += smem[q * kBM * kBN + e];
    store(e / kBN, e % kBN, v);
  }
}

}  // namespace tile_core
