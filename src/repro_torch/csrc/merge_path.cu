// Age-carrying merge-path merge of two sorted runs, written by hand for
// Hopper (sm_90a).
//
// Replaces: src/repro/kernels/merge/merge.py::merge_path_merge_age (body
// _merge_age_kernel), the Pallas TPU kernel behind every step of the
// k-way newest-wins tournament (merge_dedup_kway and
// merge_dedup_kway_window): every streaming merge window and every
// multi-run range scan of LSMEngine.
//
// Computes: output block b is elements [b*block, (b+1)*block) of the
// merge of runs A and B ordered by (unsigned key, age).  The caller
// guarantees every age in A is smaller than every age in B, so the order
// is total over real entries and ties on the key go to A.  parts[b] =
// (ia, ib) is the exact co-rank of diagonal b*block (ops.merge_partitions).
// Each run carries a sentinel tail of at least one block (key 0xFFFFFFFF,
// value 0, age INT32_MAX), as the Pallas kernel's operands did, so the
// block-long windows A[ia, ia+block) and B[ib, ib+block) are always in
// bounds and every output past the real entries is a sentinel.
//
// What bounds it on an H100: bytes.  Per output entry it does one binary
// search of log2(block) steps in shared memory — a few dozen operations —
// against 12 bytes read (key, value, age) and 12 bytes written; the least
// traffic is (n_a + n_b) * 12 bytes in plus g*block * 12 out, plus parts,
// at 3.35 TB/s.
//
// What the design does about it: one CTA per output block and one thread
// per output element.  The CTA reads its co-rank from parts, loads the two
// block-long windows of keys and ages into shared memory with coalesced
// loads, and each thread finds the split of its own diagonal by a binary
// search over the two windows (merge path), then emits the smaller head.
// The value is gathered only for the element emitted, so values are read
// once.  Loading whole windows reads the keys and ages of up to 2*block
// entries per block where block would do (2/3 of the input bytes are keys
// and ages): the price of the Pallas operand contract, and the first
// thing a later PR can cut by loading only the exact windows between
// parts[b] and parts[b+1].
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// (key, age) order with ties to A: A's entry comes first when its key is
// smaller, or equal with an age no larger.
__device__ __forceinline__ bool a_first(uint32_t ka, int32_t aa, uint32_t kb,
                                        int32_t ab) {
  return ka < kb || (ka == kb && aa <= ab);
}

__global__ void merge_age_kernel(const uint32_t* __restrict__ ka,
                                 const int32_t* __restrict__ va,
                                 const int32_t* __restrict__ aa,
                                 const uint32_t* __restrict__ kb,
                                 const int32_t* __restrict__ vb,
                                 const int32_t* __restrict__ ab,
                                 const int32_t* __restrict__ parts,
                                 uint32_t* __restrict__ ko,
                                 int32_t* __restrict__ vo,
                                 int32_t* __restrict__ ao) {
  extern __shared__ uint32_t smem[];
  const int block = blockDim.x;
  uint32_t* s_ka = smem;
  int32_t* s_aa = reinterpret_cast<int32_t*>(smem + block);
  uint32_t* s_kb = smem + 2 * block;
  int32_t* s_ab = reinterpret_cast<int32_t*>(smem + 3 * block);

  const int64_t b = blockIdx.x;
  const int64_t ia = parts[2 * b];
  const int64_t ib = parts[2 * b + 1];
  const int d = threadIdx.x;
  s_ka[d] = ka[ia + d];
  s_aa[d] = aa[ia + d];
  s_kb[d] = kb[ib + d];
  s_ab[d] = ab[ib + d];
  __syncthreads();

  // merge path: the number i of A entries among the first d outputs is the
  // first i in [0, d] whose A[i] does not precede B[d-1-i]
  int lo = 0, hi = d;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const int j = d - 1 - mid;
    if (a_first(s_ka[mid], s_aa[mid], s_kb[j], s_ab[j])) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const int i = lo;
  const int j = d - lo;  // i, j <= d < block: inside both windows
  const int64_t o = b * block + d;
  if (a_first(s_ka[i], s_aa[i], s_kb[j], s_ab[j])) {
    ko[o] = s_ka[i];
    ao[o] = s_aa[i];
    vo[o] = va[ia + i];
  } else {
    ko[o] = s_kb[j];
    ao[o] = s_ab[j];
    vo[o] = vb[ib + j];
  }
}

}  // namespace

// Runs A and B (keys uint32, values and ages int32, sentinel-tailed),
// parts (g+1, 2) int32 -> ko, vo, ao of g*block entries each.  1 <= block
// <= 1024 threads.  Returns cudaGetLastError() after the launch.
extern "C" int merge_path_merge_age(const void* ka, const void* va,
                                    const void* aa, const void* kb,
                                    const void* vb, const void* ab,
                                    const void* parts, int64_t g, int block,
                                    void* ko, void* vo, void* ao,
                                    void* stream) {
  if (g == 0) return 0;
  const size_t smem = 4 * static_cast<size_t>(block) * sizeof(uint32_t);
  merge_age_kernel<<<static_cast<unsigned>(g), block, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(ka), static_cast<const int32_t*>(va),
      static_cast<const int32_t*>(aa), static_cast<const uint32_t*>(kb),
      static_cast<const int32_t*>(vb), static_cast<const int32_t*>(ab),
      static_cast<const int32_t*>(parts), static_cast<uint32_t*>(ko),
      static_cast<int32_t*>(vo), static_cast<int32_t*>(ao));
  return static_cast<int>(cudaGetLastError());
}
