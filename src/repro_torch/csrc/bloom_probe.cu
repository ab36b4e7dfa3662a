// Fused multi-table Bloom probe, written by hand for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/bloom/bloom.py::bloom_probe_multi_kernel
// (body _probe_multi_kernel), the Pallas TPU kernel behind every
// LSMEngine.get_batch: one probe of a key batch against the Bloom filter
// of every live table.
//
// Computes: out[t][n] = 1 iff every hash lane i < k_t of key n hits a set
// bit of filter row t, where
//   h1 = hash(key, 0x9E3779B9), h2 = hash(key, 0x85EBCA6B) | 1,
//   pos_i = (h1 + i * h2) mod n_bits_t      (uint32 wraparound before the
//                                            mod, as in the reference)
// and (n_bits_t, k_t) is row t of `meta`.  Lanes past k_t pass, so rows
// of different geometry share one launch.
//
// What bounds it on an H100: bytes.  Each (table, key) pair costs a few
// dozen integer operations against k gathered filter words; the least
// traffic is every filter row, every key and every output byte once,
// T*W*4 + N*4 + T*N bytes at 3.35 TB/s.  What would keep it from that
// bound is the random gather: read straight from device memory, every
// probed bit costs a 32-byte sector.
//
// What the design does about it: the grid is (key chunk, table).  A
// block stages its table's row in shared memory when the row fits (up to
// 227 KB: a 131,072-key table at 1% FPR is 157 KB), so the gathers hit
// shared memory and the row leaves device memory (or L2) once per block;
// the block then walks a strided slice of the key batch, so that load is
// amortised over N / gridDim.x keys.  A row too wide for shared memory
// is gathered from global memory through the read-only path and L2.
// Keys are read coalesced, each key is hashed once for all its lanes, and
// a lane that misses ends the key's probe (the AND is already 0).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t hash_u32(uint32_t x, uint32_t seed) {
  x ^= seed;
  x = (x ^ (x >> 16)) * 0x45D9F3Bu;
  x = (x ^ (x >> 16)) * 0x45D9F3Bu;
  return x ^ (x >> 16);
}

__global__ void bloom_probe_multi_kernel(const uint32_t* __restrict__ filts,
                                         int64_t width,
                                         const uint32_t* __restrict__ meta,
                                         const uint32_t* __restrict__ keys,
                                         int64_t n_keys, int smem_words,
                                         uint8_t* __restrict__ out) {
  extern __shared__ uint32_t row_smem[];
  const int64_t t = blockIdx.y;
  const uint32_t n_bits = meta[2 * t];
  const uint32_t k = meta[2 * t + 1];
  const uint32_t row_words = (n_bits + 31u) / 32u;
  const uint32_t* row = filts + t * width;
  // uniform across the block: the barrier below is reached by all or none
  const bool staged = row_words <= static_cast<uint32_t>(smem_words);
  if (staged) {
    for (uint32_t w = threadIdx.x; w < row_words; w += blockDim.x) {
      row_smem[w] = row[w];
    }
    __syncthreads();
  }
  uint8_t* out_row = out + t * n_keys;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t n = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       n < n_keys; n += stride) {
    const uint32_t key = keys[n];
    const uint32_t h1 = hash_u32(key, 0x9E3779B9u);
    const uint32_t h2 = hash_u32(key, 0x85EBCA6Bu) | 1u;
    uint32_t hit = 1u;
    for (uint32_t i = 0; i < k && hit; ++i) {
      const uint32_t pos = (h1 + i * h2) % n_bits;
      const uint32_t word = staged ? row_smem[pos >> 5] : __ldg(row + (pos >> 5));
      hit = (word >> (pos & 31u)) & 1u;
    }
    out_row[n] = static_cast<uint8_t>(hit);
  }
}

}  // namespace

// filts (tables, width) uint32, meta (tables, 2) uint32 rows of
// (n_bits, k), keys (n_keys,) uint32 -> out (tables, n_keys) uint8.
// `smem_words` is the shared-memory row capacity of this launch (0 when no
// row is staged); `chunks` is the number of key chunks, gridDim.x.
// Returns cudaGetLastError() after the launch.
extern "C" int bloom_probe_multi(const void* filts, int64_t tables,
                                 int64_t width, const void* meta,
                                 const void* keys, int64_t n_keys,
                                 int smem_words, int chunks, int threads,
                                 void* out, void* stream) {
  if (tables == 0 || n_keys == 0) return 0;
  const size_t smem = static_cast<size_t>(smem_words) * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bloom_probe_multi_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>(chunks), static_cast<unsigned>(tables));
  bloom_probe_multi_kernel<<<grid, threads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(filts), width,
      static_cast<const uint32_t*>(meta), static_cast<const uint32_t*>(keys),
      n_keys, smem_words, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
