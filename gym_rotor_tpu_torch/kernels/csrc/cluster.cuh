// Thread-block clusters on Hopper (sm_90a): the hardware cluster barrier in
// its split form, an asynchronous store into a peer block's shared memory
// that signals the peer's mbarrier, a load from a peer's shared memory, a
// warp's butterfly sum, and a launch with a cluster shape and dynamic
// shared memory.  Shared by K6 (flat_adamw.cu) and K13 (ppo_loss.cu), whose
// cross-block sums go through distributed shared memory instead of a second
// launch, and by K7's run-time kernel (spectral.cu), a cluster a matrix.
//
// Protocol of the kernels that use it: a block that will receive initialises
// its mbarrier for the bytes it expects, then every thread of every block
// calls arrive_relaxed() first thing and wait() before the first store into
// a peer (so every block of the cluster is running and every mbarrier is
// initialised); a sender stores into the peer with store_async(), one
// message that also signals the peer's mbarrier; a receiver waits on its
// own mbarrier (acquire) and reads.  A block exits once it has read what
// it waits for: every store into its shared memory has then landed.  (The
// alternative, plain remote stores and then the hardware cluster barrier
// for every thread, is a second barrier phase on the critical path.)
#pragma once

#include <cuda_runtime.h>

namespace cluster {

constexpr int kMaxSize = 16;   // Hopper's largest cluster (non-portable > 8)

__device__ __forceinline__ unsigned rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// the number of blocks in this block's cluster
__device__ __forceinline__ unsigned size() {
  unsigned n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(n));
  return n;
}

__device__ __forceinline__ void arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

// arrive with release semantics: this thread's writes to shared memory are
// visible to every block of the cluster once its wait() returns
__device__ __forceinline__ void arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Block `peer`'s address of the shared variable at this block's `local`.
__device__ __forceinline__ unsigned peer_addr(unsigned local, unsigned peer) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote) : "r"(local), "r"(peer));
  return remote;
}

// The float at block `peer`'s copy of this block's shared `p`.
__device__ __forceinline__ float load_peer(const float* p, unsigned peer) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];"
               : "=f"(v) : "r"(peer_addr(smem_addr(p), peer)) : "memory");
  return v;
}

// A shared-memory barrier (mbarrier) whose first phase completes once
// `bytes` bytes of store_async() have landed in this block; visible to the
// cluster's blocks after the next cluster barrier.  (One arrival, this
// thread's, carries the byte count.)
__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned bytes) {
  const unsigned a = smem_addr(bar);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(a) : "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(a), "r"(bytes) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Block `peer`'s copy of the shared float at this block's `p` is set to v
// by one asynchronous message, which counts its 4 bytes on peer's copy of
// *bar when it lands.
__device__ __forceinline__ void store_async(float* p, unsigned long long* bar,
                                            unsigned peer, float v) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, "
      "[%2];"
      :: "r"(peer_addr(smem_addr(p), peer)), "f"(v),
         "r"(peer_addr(smem_addr(bar), peer)) : "memory");
}

// Waits until this block's *bar completes its first phase (acquire at
// cluster scope: the stores it counted are visible).
__device__ __forceinline__ void mbar_wait(unsigned long long* bar) {
  const unsigned a = smem_addr(bar);
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(a) : "memory");
  } while (!done);
}

// The sums of v[j] over the warp's 32 lanes by v += v[lane ^ h], h = 16
// .. 1, the W sums level by level so their shuffles overlap; every lane
// ends with the same bits.  Call it from every lane of a warp, outside any
// branch the compiler cannot see is uniform: a shuffle there compiles to a
// slow collective sequence.
template <int W>
__device__ __forceinline__ void warp_sums(float (&v)[W]) {
#pragma unroll
  for (int h = 16; h > 0; h >>= 1) {
#pragma unroll
    for (int j = 0; j < W; ++j) v[j] += __shfl_xor_sync(0xffffffffu, v[j], h);
  }
}

// The sums of a[j * stride + i] over i < n (n <= 32) in every lane: lane l
// holds a[j * stride + l] (zero from n on), then warp_sums.
template <int W>
__device__ __forceinline__ void lanes_sums(const float* a, int stride, int n,
                                           float (&out)[W]) {
  const int l = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < W; ++j) out[j] = l < n ? a[j * stride + l] : 0.0f;
  warp_sums<W>(out);
}

// Kernel's `blocks` blocks of `threads` in clusters of `size` (a divisor of
// blocks) with `smem` bytes of dynamic shared memory each; sizes past 8 are
// allowed once per kernel and device, and past 48 KB of shared memory the
// kernel's limit is raised per device to the largest size asked.  Returns
// the launch's error: a shape the card refuses is reported, never replaced.
template <auto Kernel>
cudaError_t allow(int size, size_t smem) {
  constexpr int kMaxDevices = 32;
  static unsigned allowed = 0;                 // one bit a device
  static size_t smem_set[kMaxDevices] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (size > 8 && !((allowed >> dev) & 1u)) {
    e = cudaFuncSetAttribute(Kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return cudaGetLastError(), e;
    allowed |= 1u << dev;
  }
  if (smem > 48 * 1024 && smem > smem_set[dev]) {
    e = cudaFuncSetAttribute(
        Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return cudaGetLastError(), e;
    smem_set[dev] = smem;
  }
  return cudaSuccess;
}

inline cudaLaunchConfig_t config(int blocks, int threads, int size,
                                 size_t smem, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = size;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <auto Kernel, typename... Args>
cudaError_t launch(int blocks, int threads, int size, size_t smem,
                   cudaStream_t stream, Args... args) {
  cudaError_t e = allow<Kernel>(size, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      config(blocks, threads, size, smem, stream, attr);
  e = cudaLaunchKernelEx(&cfg, Kernel, args...);
  // the launch's error, read (and cleared) here so that no later call
  // reports it
  const cudaError_t last = cudaGetLastError();
  return e != cudaSuccess ? e : last;
}

// How many clusters of `size` blocks of `threads` with `smem` bytes each
// the card runs at once (cudaOccupancyMaxActiveClusters), or the error as
// a negative number.
template <auto Kernel>
int max_active(int threads, int size, size_t smem) {
  cudaError_t e = allow<Kernel>(size, smem);
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(size, threads, size, smem, 0, attr);
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, Kernel, &cfg);
  return e != cudaSuccess ? -(int)e : n;
}

}  // namespace cluster
