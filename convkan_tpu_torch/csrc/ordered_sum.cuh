// ordered_sum — the ordered reduction of per-split partial sums for Hopper
// (sm_90a), shared by the weight-gradient paths of both backward sources:
//   out[i] = sum over s of partial[s][i],  partial (S, N) float32,
// added in a fixed order, so two runs give bit-identical results (no
// atomics).  kan_conv2d_bwd.cu (kan_conv2d_bwd_dw_reduce) and
// wav_conv2d_bwd.cu (wav_conv2d_bwd_reduce) include it.  It completes the
// batch sum that the Pallas backward kernels wide_kan_conv.py bwd_kernel
// and fused_wav_conv.py _bwd_kernel accumulate across their sequential
// ("arbitrary") grid, which blocks on the card, running in no order,
// cannot do.
//
// What bounds it on the H100: bytes.  It reads (S+1)*N*4 bytes and adds
// S*N floats, so it runs at the memory rate (3.35 TB/s) at best, and the
// launch floor (a few us) on the small partials.  The split count S comes
// from the weight kernels and is largest where N is smallest (S = 512 at
// N = 528), so one thread per output walking all splits leaves most SMs
// idle and each thread waiting on a chain of hundreds of loads.  The
// design (the launch config comes from reduce_launch_config in
// kernels/kan_conv2d.py, which also holds the plain version in the same
// order):
//   * Columns: a thread owns VW = 4 consecutive outputs (float4 loads,
//     when N % 4 == 0 and both pointers are 16-byte aligned) or VW = 1;
//     the T threads of a row cover T*VW contiguous columns, so every load
//     is coalesced (a warp reads one or two runs of at least 16*VW).
//   * Splits spread out where N is small: S is cut into Gw*Gc contiguous
//     leaves.  A block of 128 threads is Gw rows of T = 128/Gw threads
//     (Gw <= 8, a power of two); row w of cluster rank r sums leaf
//     r*Gw + w of the block's T*VW columns.  Gc <= 8 blocks (a power of
//     two) of a thread-block cluster along y take the further leaves,
//     only where the leaves would still be long (a cluster's barriers
//     cost about 1 us).
//   * A thread sums its leaf in split order, issuing kUnroll independent
//     loads ahead of the adds (the adds stay in order).
//   * The combine order is fixed: within a block the leaf sums are added in
//     row order through shared memory; across the cluster rank 0 adds
//     the ranks' block sums in rank order through distributed shared
//     memory and writes out once.  One launch.
// Leaf l of L = Gw*Gc covers splits [l*S/L, (l+1)*S/L) (integer division).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace ordered_sum {

namespace cg = cooperative_groups;

constexpr int kThreads = 128;  // threads of a block: Gw rows x 128/Gw
constexpr int kUnroll = 8;     // loads in flight per thread
constexpr int kMaxRows = 8;    // rows of a block (T >= 16)
constexpr int kMaxRanks = 8;   // blocks of a cluster (portable size)
constexpr int kMaxSplits = 1 << 24;  // (leaf + 1) * S fits in an int

template <int VW>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
};
template <>
struct Vec<4> {
  using T = float4;
};

__device__ __forceinline__ float add(float a, float b) { return a + b; }
__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// Block (x, rank): columns [x*T*VW, (x+1)*T*VW) of out, leaves rank*Gw ..
// rank*Gw + Gw - 1; thread tid is row tid / T, vector x*T + tid % T.
// 128-thread blocks balance the narrow grids over the SMs better than
// 256 (the launch sweep of tools/ordered_sum_ab.py).
template <int VW>
__global__ void __launch_bounds__(kThreads)
    ordered_sum_kernel(const float* __restrict__ partial,
                       float* __restrict__ out, int S, int N, int Gw,
                       int Gc) {
  using V = typename Vec<VW>::T;
  __shared__ V red[kThreads];  // [Gw][T]: the rows' leaf sums
  // Gw and Gc are powers of two: shifts, no integer divides (a 64-bit
  // divide per thread cost about 1 us on the narrow partials)
  const int rowShift = __ffs(Gw) - 1;
  const int leafShift = rowShift + __ffs(Gc) - 1;
  const int T = kThreads >> rowShift;
  const int tid = threadIdx.x;
  const int row = tid >> (__ffs(T) - 1);
  const int t = tid & (T - 1);
  const int rank = blockIdx.y;
  const int nv = N / VW;  // vectors of a split
  const int v = blockIdx.x * T + t;
  const bool live = v < nv;
  const int leaf = (rank << rowShift) + row;
  const int lo = (leaf * S) >> leafShift;
  const int hi = ((leaf + 1) * S) >> leafShift;

  V acc{};
  if (live) {
    const V* p = reinterpret_cast<const V*>(partial) + v;
    acc = __ldg(p + (size_t)lo * nv);
    for (int s = lo + 1; s < hi; s += kUnroll) {
      V u[kUnroll];  // every load of the batch issued before its adds
#pragma unroll
      for (int j = 0; j < kUnroll; ++j)
        if (s + j < hi) u[j] = __ldg(p + (size_t)(s + j) * nv);
#pragma unroll
      for (int j = 0; j < kUnroll; ++j)
        if (s + j < hi) acc = add(acc, u[j]);
    }
  }

  if (Gw > 1) {  // rows 1..Gw-1 hand their leaf sums to row 0
    if (row > 0) red[tid] = acc;
    __syncthreads();
    if (row == 0) {
      for (int w = 1; w < Gw; ++w) acc = add(acc, red[w * T + t]);
    }
  }
  V* outv = reinterpret_cast<V*>(out);
  if (Gc == 1) {
    if (row == 0 && live) outv[v] = acc;
    return;
  }

  // the cluster: every rank's block sum into its slot 0..T-1 (row 0 alone
  // touches those), then rank 0 adds them in rank order
  if (row == 0) red[t] = acc;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (rank == 0 && row == 0 && live) {
    V u[kMaxRanks];
#pragma unroll
    for (int r = 1; r < kMaxRanks; ++r)
      if (r < Gc) u[r] = *cluster.map_shared_rank(red + t, r);
#pragma unroll
    for (int r = 1; r < kMaxRanks; ++r)
      if (r < Gc) acc = add(acc, u[r]);
    outv[v] = acc;
  }
  cluster.sync();  // no block leaves while rank 0 reads its shared memory
}

template <int VW>
cudaError_t launch_vw(const float* partial, float* out, int S, int N, int Gw,
                      int Gc, cudaStream_t stream) {
  auto kernel = ordered_sum_kernel<VW>;
  const int T = kThreads / Gw;
  const int nv = N / VW;
  const dim3 grid((nv + T - 1) / T, Gc);
  if (Gc == 1) {
    kernel<<<grid, kThreads, 0, stream>>>(partial, out, S, N, Gw, Gc);
    return cudaGetLastError();
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = Gc;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, partial, out, S, N, Gw, Gc);
}

// out[i] = sum over s of partial[s][i] for i < N in the order above, with
// VW, Gw and Gc from reduce_launch_config.  cudaErrorInvalidValue for a
// config the kernel does not take: VW not 1 or 4 (4 needs N % 4 == 0 and
// 16-byte aligned pointers), Gw or Gc not a power of two up to kMaxRows
// and kMaxRanks, more leaves than splits, or S above kMaxSplits.
inline cudaError_t launch(const void* partial, void* out, int S, int N,
                          int VW, int Gw, int Gc, cudaStream_t stream) {
  const bool rows_ok = Gw >= 1 && Gw <= kMaxRows && (Gw & (Gw - 1)) == 0;
  const bool ranks_ok = Gc >= 1 && Gc <= kMaxRanks && (Gc & (Gc - 1)) == 0;
  const bool vec_ok =
      VW == 1 || (VW == 4 && N % 4 == 0 &&
                  reinterpret_cast<size_t>(partial) % 16 == 0 &&
                  reinterpret_cast<size_t>(out) % 16 == 0);
  if (S <= 0 || S > kMaxSplits || N <= 0 || !rows_ok || !ranks_ok ||
      !vec_ok || Gw * Gc > S)
    return cudaErrorInvalidValue;
  const float* p = static_cast<const float*>(partial);
  float* o = static_cast<float*>(out);
  return VW == 4 ? launch_vw<4>(p, o, S, N, Gw, Gc, stream)
                 : launch_vw<1>(p, o, S, N, Gw, Gc, stream);
}

}  // namespace ordered_sum
