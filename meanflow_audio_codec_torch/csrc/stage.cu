// The ConvNeXt stage's three normalisation segments, f32 or bf16, for sm_90a.
//
// Replaces, in meanflow_audio_codec_tpu/ops/stage_pallas.py:
//   ln_film_forward  <- _ln_film_pallas   (LayerNorm over C + FiLM, emits mu, r)
//   ln_norm_forward  <- _ln_norm_pallas   (LayerNorm over C, emits mu, r)
//   gelu_grn_single_read_forward, gelu_grn_two_pass_forward
//                    <- _gelu_grn_pallas  (tanh-GELU + ConvNeXt-V2 GRN, emits gx)
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
// GELU+GRN, three kernels chosen by shape alone (ops/stage_cuda.py):
//
// single read (gelu_grn_single_read_forward), whenever a thread of a
// 512-thread block can hold its share of the [P, C] slice in 64 registers
// (the train shape [2032, 64, 512] in bf16 and f32). The two-pass kernel
// below reads x twice from device memory (at the train shape its 2032
// blocks' 133 MB working set outgrows the 50 MB L2, so the second read comes
// from HBM: ~400 MB moved against the 270 MB the function needs) and
// evaluates tanh-GELU twice per element. This kernel is persistent: one
// 512-thread block per SM (its g registers fill half the register file)
// walks the batch rows. Each row's slice comes into a shared-memory ring by
// TMA bulk copies, two rows ahead in bf16 (three 64 KB slots; one 128 KB
// slot in f32), so the next rows load while this one computes; the threads
// read it once, evaluate GELU once and keep g in registers, sum g^2 per
// channel over their positions (position groups folded through shared
// memory in group order), take mean_C gx with a block reduction, and write
// y from the g they hold. HBM sees x read once and y, gx written once.
//
// With tanhf kept (tanh.approx.f32 would miss the f32 checks), GELU+GRN is
// about as much issue-bound as byte-bound on an H100: the main loop issues
// ~36 instructions per element (chip_smoke.py prints its mix), and 16 warps
// per SM, all passing the same barriers, hide only part of the latency.
//
// cluster (gelu_grn_cluster_forward), for the slices too large for one
// block's registers (ConvNeXt widths >= 512, where the expand layer gives
// C = 1024 at 64 positions; long P): the same single-read kernel spread over
// a thread-block cluster of k = 2, 4 or 8 blocks, the smallest k whose
// channel chunk fits. Block r of the cluster owns the chunk [P, r C/k,
// (r+1) C/k) of each row and does for it what the single read does for a
// whole slice: ring, one GELU, g in registers, the per-channel sums (gx
// needs nothing from the other blocks). The one quantity shared across the
// cluster is mean_C gx: each block pushes its partial sum of gx into a slot
// of every block's shared memory (st.async through distributed shared
// memory, counted in bytes on that block's mbarrier), and every block adds
// the k slots in rank order, so all blocks get the same mean, bit for bit,
// run after run. The slots are double-buffered by row parity: a block
// pushes into a slot again only after the next row's pushes from every
// block have reached it, and each block makes those after it has read the
// slot. So the row loop needs no cluster barrier, which costs more than
// the pushes (one stands at the start and one at the end). Loads: a chunk
// is P strided runs of C/k values; a 3D tensor map (x as [N][P][C],
// cuTensorMapEncodeTiled reached through cudaGetDriverEntryPoint, made for
// each launch) brings it as a few boxes of at most 256 positions by 256
// channels, all issued by one thread (one 1D bulk copy per position would
// keep the issuing warp busy too long: 64 copies a row at the conv_mfu
// shape). A k is taken only where a chunk's run is a multiple of 128 bytes
// (a box's shared-memory alignment) and x is 16-byte aligned. The clusters
// are persistent: the grid is as many clusters as
// cudaOccupancyMaxActiveClusters allows (at most one a batch row), each
// walking rows cluster_id, cluster_id + clusters, ... HBM sees x read once,
// as in the single read, where the two-pass kernel reads it twice and
// evaluates GELU twice.
//
// two pass (gelu_grn_two_pass_forward), for what no cluster of <= 8 blocks
// takes (very long P, P = 0, unaligned x, chunk runs that are no multiple
// of 128 bytes): one block per batch row n, threads walking the channels
// (16-byte loads where possible). Each thread sums g^2 over the P positions
// of its channels, writes gx, and a block reduction gives mean_C gx. A
// second pass recomputes g from x (the slice is read again, from L2 where
// it is still there) and writes y.

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap (the driver is reached by entry point)
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr float kLnEps = 1e-6f;
constexpr float kGrnSqEps = 1e-12f;
constexpr float kGrnMeanEps = 1e-6f;
constexpr float kGeluA = 0.7978845608028654f;  // sqrt(2 / pi)
constexpr float kGeluK = 0.044715f;

constexpr int kLnWarps = 8;         // rows per LayerNorm block
constexpr int kGrnMaxThreads = 256;  // two-pass GELU+GRN block
constexpr int kGrnHeld = 64;         // g values a single-read thread holds
constexpr int kGrnSingleThreads = 512;
constexpr unsigned kGrnBulkBytes = 16384;  // one TMA bulk copy
constexpr int kGrnMaxSplit = 8;  // blocks a cluster spreads a row over (portable)
constexpr int kGrnBoxMax = 256;  // a TMA box's extent in each dimension
constexpr int kGrnBoxAlign = 128;  // bytes: a TMA box's shared-memory address

// Slices in the single-read kernel's shared-memory ring: three 64 KB bf16
// slices at the train shape (one read, two loading), one 128 KB f32 slice.
template <typename T>
__host__ __device__ constexpr int grn_buffers() {
  return sizeof(T) == 2 ? 3 : 1;
}

// Floats the ring takes, rounded up to 16 bytes so what follows is aligned.
__host__ __device__ constexpr long long ring_floats(long long bytes) {
  return (bytes + 15) / 16 * 4;
}

// The TMA boxes that bring a cluster block's chunk [P, CK] of a row into
// shared memory: boxes of bw channels by bp positions, bw the widest
// multiple of kGrnBoxAlign bytes that divides CK and is at most kGrnBoxMax
// values (CK * sizeof(T) is a multiple of kGrnBoxAlign), bp = P split evenly
// into at most kGrnBoxMax positions. The chunk lies in shared memory as CK /
// bw columns of [rows][bw], rows = bp * ceil(P / bp) >= P (a last box that
// runs past P is filled with zeros), so every box starts 128-byte aligned.
struct GrnBoxes {
  int bw, bp, rows;
};

// The cluster kernel's tensor map; the single-read kernel takes none, so
// its launch stays as it was before the cluster kernel.
struct NoMap {};
template <bool kCluster>
using GrnMap = std::conditional_t<kCluster, CUtensorMap, NoMap>;

template <typename T>
__host__ __device__ inline GrnBoxes grn_boxes(int P, int CK) {
  constexpr int unit = kGrnBoxAlign / static_cast<int>(sizeof(T));
  int per = kGrnBoxMax / unit;  // units a box may take
  while ((CK / unit) % per != 0) --per;
  const int along = (P + kGrnBoxMax - 1) / kGrnBoxMax;
  const int bp = (P + along - 1) / along;
  return {per * unit, bp, bp * ((P + bp - 1) / bp)};
}

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

// 0.5 x (1 + tanh(a (x + k x^3))), evaluated as h + h tanh(x (a + a k x^2))
// with h = 0.5 x: two fewer operations, the same function within f32
// rounding.
__device__ __forceinline__ float gelu(float x) {
  const float u = x * fmaf(kGeluA * kGeluK, x * x, kGeluA);
  const float h = 0.5f * x;
  return fmaf(h, tanhf(u), h);
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

// Bulk copies by the Tensor Memory Accelerator into shared memory, their
// completion counted in bytes on an mbarrier.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(std::uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)));
}

__device__ __forceinline__ void mbar_expect_bytes(std::uint64_t* bar,
                                                  unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(std::uint64_t* bar,
                                          unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 3D tensor map (channel, position, row) into shared memory.
__device__ __forceinline__ void box_load(void* dst, const CUtensorMap* map,
                                         int c, int p, int n,
                                         std::uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<std::uint64_t>(map)), "r"(c), "r"(p), "r"(n),
      "r"(smem_addr(bar))
      : "memory");
}

// v into the float at `slot` of block `rank` of the cluster, its arrival
// counted (4 bytes) on that block's mbarrier at `bar`; slot and bar are
// this block's shared addresses of the same variables.
__device__ __forceinline__ void push_to_rank(float* slot, std::uint64_t* bar,
                                             unsigned rank, float v) {
  unsigned remote_slot, remote_bar;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote_slot)
               : "r"(smem_addr(slot)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote_bar)
               : "r"(smem_addr(bar)), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" ::"r"(remote_slot),
      "r"(__float_as_uint(v)), "r"(remote_bar)
      : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, std::uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Persistent: block b takes batch rows b, b + gridDim.x, ... For each row n:
// g = gelu(x[n]) over [P, C]; gx[c] = sqrt(sum_p g^2 + eps); y = g * (gamma
// + gx / (mean_c gx + eps)) + beta. The slice x[n] arrives in a shared-memory
// ring of kBuffers slices (with V > 1 by bulk copies that thread 0 issues to
// the TMA, each slot's arrival on its mbarrier; else by plain copies), loaded
// while earlier rows are computed. Thread (cv, pg) takes channels [cv*V,
// cv*V + V) at positions pg + i*PG, i < kGrnHeld / V, and keeps their g in
// registers from the GELU to the store. C % V == 0; the first (C/V)*PG
// threads are active, the rest only join the reductions.
//
// kCluster: launched in clusters of `split` blocks (V > 1). Cluster q takes
// rows q, q + clusters, ...; its block of rank r reads and writes only the
// channels [r*CK, r*CK + CK), CK = C / split, as if they were the whole
// slice: the chunk arrives as the boxes of grn_boxes through the tensor map
// `map` (x as [N][P][C]), and each block pushes its partial sum of gx into
// every block's shared memory (st.async, counted on that block's mbarrier).
template <typename T, int V, bool kCluster>
__global__ void __launch_bounds__(kGrnSingleThreads, 1)
gelu_grn_single_read_kernel(const T* __restrict__ x,
                            const float* __restrict__ gamma,
                            const float* __restrict__ beta, T* __restrict__ y,
                            float* __restrict__ gx_out, long long N, int P,
                            int C, int PG, int split,
                            const __grid_constant__ GrnMap<kCluster> map) {
  namespace cg = cooperative_groups;
  constexpr int NV = kGrnHeld / V;
  constexpr int kBuffers = grn_buffers<T>();
  extern __shared__ float4 grn_smem4[];
  // the channels this block owns: the whole row, or its rank's chunk
  const int CK = kCluster ? C / split : C;
  const unsigned rank = kCluster ? cg::this_cluster().block_rank() : 0;
  const int c0 = static_cast<int>(rank) * CK;
  const GrnBoxes box =
      kCluster ? grn_boxes<T>(P, CK) : GrnBoxes{CK, P, P};
  const long long first = kCluster ? blockIdx.x / split : blockIdx.x;
  const long long stride = kCluster ? gridDim.x / split : gridDim.x;
  const long long slice = static_cast<long long>(P) * C;  // a row of x
  // what a ring slot holds: [P][C], or the chunk's columns [rows][bw]
  const long long chunk = static_cast<long long>(box.rows) * CK;
  char* base = reinterpret_cast<char*>(grn_smem4);
  if constexpr (kCluster)  // TMA boxes land on 128-byte boundaries
    base += (kGrnBoxAlign - smem_addr(base) % kGrnBoxAlign) % kGrnBoxAlign;
  T* ring = reinterpret_cast<T*>(base);  // [kBuffers][chunk]
  float* part = reinterpret_cast<float*>(base) +  // [PG][CK]
                ring_floats(kBuffers * chunk * sizeof(T));
  float* gxs = part + PG * CK;                // [CK]
  float* warp_part = gxs + CK;                // [32]
  float* sums = warp_part + 32;  // kCluster: [2][split] partials by rank
  const int CV = CK / V;
  const bool active = threadIdx.x < CV * PG;
  const int c = (threadIdx.x % CV) * V;
  const int pg = threadIdx.x / CV;
  // this thread's channels in a slot, and the step from one position to
  // the next
  const int col = kCluster ? (c / box.bw) * box.rows * box.bw + c % box.bw
                           : c;
  const int pstep = kCluster ? box.bw : CK;

  __shared__ std::uint64_t full[kBuffers];  // slot b holds its next slice
  __shared__ std::uint64_t pushed[2];  // kCluster: a row's partials arrived
  if (threadIdx.x == 0) {
    for (int b = 0; b < kBuffers; ++b) mbar_init(&full[b]);
    if constexpr (kCluster) {
      mbar_init(&pushed[0]);
      mbar_init(&pushed[1]);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // no block pushes a partial before every block's mbarriers exist
  if constexpr (kCluster) cg::this_cluster().sync();
  auto issue = [&](long long n, int buf) {
    if (n >= N) return;
    T* dst = ring + buf * chunk;
    if constexpr (kCluster) {
      if (threadIdx.x == 0) {
        mbar_expect_bytes(&full[buf],
                          static_cast<unsigned>(chunk * sizeof(T)));
        for (int bc = 0; bc < CK; bc += box.bw)
          for (int bp = 0; bp < P; bp += box.bp)
            box_load(dst + (bc / box.bw) * box.rows * box.bw + bp * box.bw,
                     &map, c0 + bc, bp, static_cast<int>(n), &full[buf]);
      }
      return;
    }
    const T* src = x + n * slice;
    if constexpr (V > 1) {  // slice * sizeof(T) is a multiple of 16
      if (threadIdx.x == 0) {
        const unsigned bytes = static_cast<unsigned>(slice * sizeof(T));
        mbar_expect_bytes(&full[buf], bytes);
        for (unsigned at = 0; at < bytes; at += kGrnBulkBytes)
          bulk_load(reinterpret_cast<char*>(dst) + at,
                    reinterpret_cast<const char*>(src) + at,
                    bytes - at < kGrnBulkBytes ? bytes - at : kGrnBulkBytes,
                    &full[buf]);
      }
    } else {
      for (long long i = threadIdx.x; i < slice; i += blockDim.x)
        dst[i] = src[i];
    }
  };
  // with a ring of kBuffers > 1 slots, the load of row n + (kBuffers-1)
  // steps is issued before row n is computed, into the slot row n-1 freed;
  // with one slot, after row n has been read
  constexpr int kAhead = kBuffers > 1 ? kBuffers - 1 : 1;
  for (int b = 0; b < kAhead; ++b) issue(first + b * stride, b);

  int buf = 0;
  unsigned parity = 0;  // bit b: the phase of slot b's next arrival
  unsigned row = 0;     // rows this block has taken (kCluster: the slot)
  for (long long n = first; n < N; n += stride, ++row) {
    if constexpr (kBuffers > 1)
      issue(n + kAhead * stride, buf == 0 ? kBuffers - 1 : buf - 1);
    if constexpr (V > 1) {
      mbar_wait(&full[buf], (parity >> buf) & 1u);
      parity ^= 1u << buf;
    }
    __syncthreads();  // slice n has landed; last row's reductions are done
    float g[NV][V];
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.f;
    const T* xs = ring + buf * chunk;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int p = pg + i * PG;
      if (active && p < P) {
        load<T, V>(xs + static_cast<long long>(p) * pstep + col, g[i]);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) g[i][v] = 0.f;  // gelu(0) = 0 adds nothing
      }
#pragma unroll
      for (int v = 0; v < V; ++v) {
        g[i][v] = gelu(g[i][v]);
        acc[v] += g[i][v] * g[i][v];
      }
    }
    if (active) {
#pragma unroll
      for (int v = 0; v < V; ++v) part[pg * CK + c + v] = acc[v];
    }
    __syncthreads();  // the ring slot is read
    if constexpr (kBuffers == 1) issue(n + stride, 0);
    buf = buf + 1 == kBuffers ? 0 : buf + 1;

    float local = 0.f;
    for (int ch = threadIdx.x; ch < CK; ch += blockDim.x) {
      float total = 0.f;
      for (int q = 0; q < PG; ++q) total += part[q * CK + ch];
      const float gx = sqrtf(total + kGrnSqEps);
      gxs[ch] = gx;
      local += gx;
      gx_out[n * C + c0 + ch] = gx;
    }
    local = warp_sum(local);
    if ((threadIdx.x & 31) == 0) warp_part[threadIdx.x >> 5] = local;
    __syncthreads();
    float total = 0.f;
    for (int w = 0; w < static_cast<int>(blockDim.x) / 32; ++w)
      total += warp_part[w];
    if constexpr (kCluster) {
      // row n's partials, one a block, pushed into every block's slots and
      // added in rank order by every block. The slots alternate with the
      // row: a block pushes into slot (row & 1) again only after the pushes
      // of row + 1 have reached it, which every block makes after it has
      // read its row-slot partials.
      const unsigned s = row & 1u;
      float* slots = sums + s * split;
      if (threadIdx.x == 0) {
        mbar_expect_bytes(&pushed[s], 4u * split);
        for (int r = 0; r < split; ++r)
          push_to_rank(slots + rank, &pushed[s], r, total);
      }
      mbar_wait(&pushed[s], (row >> 1) & 1u);
      total = 0.f;
      for (int r = 0; r < split; ++r) total += slots[r];
    }
    const float m = total / static_cast<float>(C) + kGrnMeanEps;
    if (!active) continue;
    float scale[V], bias[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      scale[v] = gamma[c0 + c + v] + gxs[c + v] / m;
      bias[v] = beta[c0 + c + v];
    }
    T* yn = y + n * slice + c0;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int p = pg + i * PG;
      if (p >= P) break;
      float out[V];
#pragma unroll
      for (int v = 0; v < V; ++v) out[v] = g[i][v] * scale[v] + bias[v];
      store<T, V>(yn + static_cast<long long>(p) * C + c, out);
    }
  }
  // no block leaves while a push may still be on its way to it
  if constexpr (kCluster) cg::this_cluster().sync();
}

// Block n: g = gelu(x[n]) over [P, C]; gx[c] = sqrt(sum_p g^2 + eps);
// y = g * (gamma + gx / (mean_c gx + eps)) + beta. C % V == 0.
template <typename T, int V>
__global__ void __launch_bounds__(kGrnMaxThreads)
gelu_grn_two_pass_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
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
constexpr int kErrShape = -3;  // grn_plan gives the shape to another kernel
constexpr int kErrCluster = -4;  // no cluster of the plan's size fits an SM set
constexpr int kErrTensorMap = -5;  // the driver refused the TMA tensor map
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

// The single-read kernel's position groups PG and block size for this
// shape and vector width V; false when some thread would hold more than
// kGrnHeld values of the [P, C] slice.
bool single_read_plan(int P, int C, int V, int* PG, int* threads) {
  if (P < 1 || C % V != 0 || C / V > kGrnSingleThreads) return false;
  const int vectors = C / V;
  const int pg = kGrnSingleThreads / vectors < P ? kGrnSingleThreads / vectors
                                                 : P;
  if ((P + pg - 1) / pg * V > kGrnHeld) return false;
  *PG = pg;
  *threads = (vectors * pg + 31) / 32 * 32;
  return true;
}

// The blocks `split` a row is spread over: the smallest of 1, 2, 4, 8 whose
// chunk of C / split channels fits single_read_plan (which then gives PG
// and the block size for the chunk); 1 is the single-read kernel alone, more
// a cluster, which needs 16-byte vectors (V * bytes == 16) and chunk rows of
// a whole number of kGrnBoxAlign bytes, where its TMA boxes land (C /
// split * bytes a multiple of 128). False when none fits (the two-pass
// kernel's shapes). ops/stage_cuda.py::gelu_grn_split mirrors it.
bool grn_plan(int P, int C, int V, int bytes, int* split, int* PG,
              int* threads) {
  for (int k = 1; k <= kGrnMaxSplit; k *= 2) {
    if (k > 1 && (V * bytes != 16 || C % (k * (kGrnBoxAlign / bytes)) != 0))
      return false;
    if (single_read_plan(P, C / k, V, PG, threads)) {
      *split = k;
      return true;
    }
  }
  return false;
}

// cuTensorMapEncodeTiled, reached through the runtime (no link to the
// driver library).
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static const auto encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      fn = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }();
  return encode;
}

// The single-read kernel alone (kCluster false: the plan's split is 1) or in
// clusters of the plan's split > 1 blocks; kErrShape when the plan differs.
template <typename T, bool kCluster>
int launch_grn_single_read(const void* x, const float* gamma,
                           const float* beta, void* y, float* gx, long long N,
                           int P, int C, cudaStream_t stream) {
  constexpr int kV = 16 / sizeof(T);
  const int v = C % kV == 0 && aligned16(x, y) ? kV : 1;
  int split = 0, pg = 0, threads = 0;
  if (!grn_plan(P, C, v, sizeof(T), &split, &pg, &threads) ||
      (split > 1) != kCluster)
    return kErrShape;
  const int ck = C / split;
  const GrnBoxes box =
      kCluster ? grn_boxes<T>(P, ck) : GrnBoxes{ck, P, P};
  // ring [kBuffers][rows][ck], part [pg][ck], gxs [ck], warp_part [32]
  // and, for a cluster, sums [2][split] and the ring's alignment: at most
  // 192 + 16 + 16 KB (rows*ck <= 512 * kGrnHeld when P <= kGrnBoxMax; past
  // it ck < 128 and the padding rows below 16 KB, gxs under 1 KB; pg*ck and
  // ck <= 512 * V floats)
  const int smem = static_cast<int>(
      sizeof(float) *
      (ring_floats(grn_buffers<T>() * sizeof(T) *
                   static_cast<size_t>(box.rows) * ck) +
       static_cast<size_t>(pg) * ck + ck + 32 +
       (kCluster ? 2 * kGrnMaxSplit + kGrnBoxAlign / sizeof(float) : 0)));
  auto kernel = &gelu_grn_single_read_kernel<T, kV, kCluster>;
  if constexpr (!kCluster) {
    if (v != kV) kernel = &gelu_grn_single_read_kernel<T, 1, false>;
  }
  const auto* xt = static_cast<const T*>(x);
  auto* yt = static_cast<T*>(y);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int device = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if constexpr (kCluster) {
    // persistent clusters: as many as can be resident at once, at most one
    // a row; none resident is a refusal, raised by the wrapper. The tensor
    // map's row coordinate is an int.
    if (N > kMaxGrid) return kErrGrid;
    cudaLaunchAttribute attribute[1];
    attribute[0].id = cudaLaunchAttributeClusterDimension;
    attribute[0].val.clusterDim.x = split;
    attribute[0].val.clusterDim.y = 1;
    attribute[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(static_cast<unsigned>(sms / split * split));
    config.blockDim = dim3(threads);
    config.dynamicSmemBytes = smem;
    config.stream = stream;
    config.attrs = attribute;
    config.numAttrs = 1;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (clusters < 1) return kErrCluster;
    config.gridDim = dim3(static_cast<unsigned>(
        (N < clusters ? N : clusters) * split));
    // x as [N][P][C], read a box of [bp][bw] at a time
    const auto encode = tensor_map_encoder();
    if (encode == nullptr) return kErrTensorMap;
    CUtensorMap map;
    cuuint64_t extent[3] = {static_cast<cuuint64_t>(C),
                            static_cast<cuuint64_t>(P),
                            static_cast<cuuint64_t>(N)};
    cuuint64_t pitch[2] = {static_cast<cuuint64_t>(C) * sizeof(T),
                           static_cast<cuuint64_t>(P) * C * sizeof(T)};
    cuuint32_t box_extent[3] = {static_cast<cuuint32_t>(box.bw),
                                static_cast<cuuint32_t>(box.bp), 1};
    cuuint32_t unit_step[3] = {1, 1, 1};
    if (encode(&map,
               sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                              : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
               3, const_cast<void*>(x), extent, pitch, box_extent, unit_step,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return kErrTensorMap;
    err = cudaLaunchKernelEx(&config, kernel, xt, gamma, beta, yt, gx, N, P,
                             C, pg, split, map);
    if (err != cudaSuccess) return static_cast<int>(err);
  } else {
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    // one persistent block per resident slot, each looping over rows
    const long long slots =
        static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
    const unsigned blocks = static_cast<unsigned>(N < slots ? N : slots);
    kernel<<<blocks, threads, smem, stream>>>(xt, gamma, beta, yt, gx, N, P, C,
                                              pg, 1, NoMap{});
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_grn_two_pass(const void* x, const float* gamma, const float* beta,
                        void* y, float* gx, long long N, int P, int C,
                        cudaStream_t stream) {
  if (N > kMaxGrid) return kErrGrid;
  constexpr int kV = 16 / sizeof(T);
  const int v = C % kV == 0 && aligned16(x, y) ? kV : 1;
  const int vectors = (C + v - 1) / v;
  const int threads = vectors >= kGrnMaxThreads ? kGrnMaxThreads
                                                : (vectors + 31) / 32 * 32;
  const unsigned blocks = static_cast<unsigned>(N);
  const auto* xt = static_cast<const T*>(x);
  auto* yt = static_cast<T*>(y);
  if (v == kV)
    gelu_grn_two_pass_kernel<T, kV><<<blocks, threads, 0, stream>>>(
        xt, gamma, beta, yt, gx, P, C);
  else
    gelu_grn_two_pass_kernel<T, 1><<<blocks, threads, 0, stream>>>(
        xt, gamma, beta, yt, gx, P, C);
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

// x [N, P, C] in `dtype`, gamma and beta [C] f32, y like x, gx [N, C] f32;
// all contiguous on the current device. Returns kErrShape when grn_plan does
// not give this kernel the shape (the wrapper decides by shape alone, as
// grn_plan does, and calls gelu_grn_cluster_forward or
// gelu_grn_two_pass_forward instead).
int gelu_grn_single_read_forward(const void* x, const float* gamma,
                                 const float* beta, void* y, float* gx,
                                 long long N, int P, int C, int dtype,
                                 void* stream) {
  if (dtype == kF32)
    return launch_grn_single_read<float, false>(
        x, gamma, beta, y, gx, N, P, C, static_cast<cudaStream_t>(stream));
  if (dtype == kBF16)
    return launch_grn_single_read<__nv_bfloat16, false>(
        x, gamma, beta, y, gx, N, P, C, static_cast<cudaStream_t>(stream));
  return kErrDtype;
}

// The same function where one block's registers do not hold a slice: the
// single-read kernel in clusters of 2, 4 or 8 blocks a row. kErrShape unless
// grn_plan spreads the row over more than one block.
int gelu_grn_cluster_forward(const void* x, const float* gamma,
                             const float* beta, void* y, float* gx,
                             long long N, int P, int C, int dtype,
                             void* stream) {
  if (dtype == kF32)
    return launch_grn_single_read<float, true>(
        x, gamma, beta, y, gx, N, P, C, static_cast<cudaStream_t>(stream));
  if (dtype == kBF16)
    return launch_grn_single_read<__nv_bfloat16, true>(
        x, gamma, beta, y, gx, N, P, C, static_cast<cudaStream_t>(stream));
  return kErrDtype;
}

// The same function for any shape, reading x twice.
int gelu_grn_two_pass_forward(const void* x, const float* gamma,
                              const float* beta, void* y, float* gx,
                              long long N, int P, int C, int dtype,
                              void* stream) {
  if (dtype == kF32)
    return launch_grn_two_pass<float>(x, gamma, beta, y, gx, N, P, C,
                                      static_cast<cudaStream_t>(stream));
  if (dtype == kBF16)
    return launch_grn_two_pass<__nv_bfloat16>(
        x, gamma, beta, y, gx, N, P, C, static_cast<cudaStream_t>(stream));
  return kErrDtype;
}

}  // extern "C"
