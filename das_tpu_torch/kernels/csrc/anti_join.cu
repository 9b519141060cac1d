// Kernel 4: anti join (the negation membership filter) as a hash-set probe.
//
// Replaces das_tpu/kernels/join.py anti_join_impl (_anti_kernel_body).
// keep[i] = left_valid[i] && mix_l[i] is not in {mix_r[j]}, where an
// invalid right row contributes the right sentinel 2^63-2 (the reference
// sorts the right keys sentinels included and searches them).  There is no
// exact column check, as in the reference, so the mix agrees with
// ops/join.py bit for bit.  Membership needs a set, not an order: nothing
// is sorted, and each key is mixed inside the kernel that reads its row,
// so no key array goes to device memory.
//
// Regimes, a pure function of n_right (the capacity-padded right rows),
// picked here and reported to the wrapper by name:
//
//   shared  n_right <= AJ_SHARED_MAX_RIGHT (8,192).  ONE launch.  Each
//           block builds its own open-addressing set of the right keys in
//           dynamic shared memory — 2^bits >= 2 * n_right slots of int64,
//           at most 16,384 x 8 B = 131,072 B of the 232,448 B a block may
//           have (load factor <= 1/2) — then probes its grid-stride share
//           of the left rows.  The invalid right rows insert the sentinel
//           once (a block-wide OR).  The 48 KB default is lifted once per
//           device, at the first call there.
//   global  n_right > 8,192.  A set of 2^bits >= 2 * n_right int64 slots in
//           device memory (the wrapper's scratch, das_anti_join_scratch
//           bytes), filled with atomicCAS on the 64-bit word: an init
//           launch, a build launch and a probe launch.
//
// The empty slot is 2^63-1, the left sentinel, which no right row inserts
// as a sentinel; a valid right key equal to it sets a flag instead (the
// last word of the set), and a valid left key equal to it reads the flag.
//
// Bound at the main-path shapes (tens to hundreds of rows a side, ~20 KB):
// launch latency.  The byte bound is nanoseconds; the shared regime is one
// launch with no scratch tensor, the ~29 launches of the sort design gone.
// ptxas (-Xptxas -v, sm_90a, CUDA 12.8): aj_shared_kernel 29 registers,
// aj_build_kernel and aj_probe_kernel 27, aj_init_kernel 12; no spills, no
// stack.
#include "common.cuh"

#define AJ_THREADS 512
#define AJ_SHARED_MAX_RIGHT 8192
#define AJ_SHARED_MAX_BITS 14
#define AJ_EMPTY ((int64_t)0x7FFFFFFFFFFFFFFFll)
#define AJ_SENTINEL_R ((int64_t)0x7FFFFFFFFFFFFFFEll)

__device__ __forceinline__ uint64_t aj_slot(int64_t key, int bits) {
  return ((uint64_t)key * 0x9E3779B97F4A7C15ull) >> (64 - bits);
}

// inserts key into the 2^bits-slot set (linear probing); *flag = 1 for the
// one key the empty marker cannot hold
__device__ __forceinline__ void aj_insert(int64_t* set, int bits, int64_t key, int64_t* flag) {
  if (key == AJ_EMPTY) {
    *flag = 1;
    return;
  }
  const uint64_t mask = (1ull << bits) - 1;
  for (uint64_t h = aj_slot(key, bits);; h = (h + 1) & mask) {
    const unsigned long long old = atomicCAS(reinterpret_cast<unsigned long long*>(set + h),
                                             (unsigned long long)AJ_EMPTY,
                                             (unsigned long long)key);
    if ((int64_t)old == AJ_EMPTY || (int64_t)old == key) return;
  }
}

__device__ __forceinline__ bool aj_member(const int64_t* set, int bits, int64_t key,
                                          int64_t flag) {
  if (key == AJ_EMPTY) return flag != 0;
  const uint64_t mask = (1ull << bits) - 1;
  for (uint64_t h = aj_slot(key, bits);; h = (h + 1) & mask) {
    const int64_t s = set[h];
    if (s == key) return true;
    if (s == AJ_EMPTY) return false;
  }
}

// every right row of this block's share into the set; the sentinel once
// if any row of the share is invalid
__device__ __forceinline__ void aj_build(const int32_t* rv, const uint8_t* rm, int64_t n_right,
                                         int kr, const DasCols& rcols, int64_t* set, int bits,
                                         int64_t* flag, int64_t first, int64_t stride) {
  int invalid = 0;
  for (int64_t j = first; j < n_right; j += stride) {
    if (rm[j]) aj_insert(set, bits, das_mix_row(rv + j * kr, rcols), flag);
    else invalid = 1;
  }
  if (__syncthreads_or(invalid) && threadIdx.x == 0) aj_insert(set, bits, AJ_SENTINEL_R, flag);
}

__device__ __forceinline__ void aj_probe(const int32_t* lv, const uint8_t* lm, int64_t n_left,
                                         int kl, const DasCols& lcols, const int64_t* set,
                                         int bits, int64_t flag, uint8_t* keep) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n_left;
       i += (int64_t)gridDim.x * blockDim.x) {
    keep[i] = (lm[i] && !aj_member(set, bits, das_mix_row(lv + i * kl, lcols), flag)) ? 1 : 0;
  }
}

__global__ void __launch_bounds__(AJ_THREADS)
aj_shared_kernel(const int32_t* lv, const uint8_t* lm, int64_t n_left, int kl,
                 const __grid_constant__ DasCols lcols, const int32_t* rv, const uint8_t* rm,
                 int64_t n_right, int kr, const __grid_constant__ DasCols rcols, int bits,
                 uint8_t* keep) {
  extern __shared__ int64_t aj_set[];
  __shared__ int64_t flag;
  const int64_t slots = 1ll << bits;
  for (int64_t h = threadIdx.x; h < slots; h += blockDim.x) aj_set[h] = AJ_EMPTY;
  if (threadIdx.x == 0) flag = 0;
  __syncthreads();
  aj_build(rv, rm, n_right, kr, rcols, aj_set, bits, &flag, threadIdx.x, blockDim.x);
  __syncthreads();
  aj_probe(lv, lm, n_left, kl, lcols, aj_set, bits, flag, keep);
}

// the set's last word (index 2^bits) is the flag
__global__ void aj_init_kernel(int64_t* set, int64_t slots) {
  for (int64_t h = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; h <= slots;
       h += (int64_t)gridDim.x * blockDim.x) {
    set[h] = h == slots ? 0 : AJ_EMPTY;
  }
}

__global__ void __launch_bounds__(AJ_THREADS)
aj_build_kernel(const int32_t* rv, const uint8_t* rm, int64_t n_right, int kr, DasCols rcols,
                int64_t* set, int bits) {
  aj_build(rv, rm, n_right, kr, rcols, set, bits, set + (1ll << bits),
           blockIdx.x * (int64_t)blockDim.x + threadIdx.x, (int64_t)gridDim.x * blockDim.x);
}

__global__ void __launch_bounds__(AJ_THREADS)
aj_probe_kernel(const int32_t* lv, const uint8_t* lm, int64_t n_left, int kl, DasCols lcols,
                const int64_t* set, int bits, uint8_t* keep) {
  aj_probe(lv, lm, n_left, kl, lcols, set, bits, set[1ll << bits], keep);
}

static unsigned aj_blocks(int64_t n) {
  int64_t b = (n + AJ_THREADS - 1) / AJ_THREADS;
  return (unsigned)(b < 1 ? 1 : (b > 132 ? 132 : b));
}

// bytes of the scratch buffer das_anti_join needs: 0 in regime shared,
// the set of 2^bits slots and its flag word in regime global
extern "C" int64_t das_anti_join_scratch(int64_t n_right) {
  if (n_right <= AJ_SHARED_MAX_RIGHT) return 0;
  return (int64_t)sizeof(int64_t) * ((1ll << das_set_bits(n_right)) + 1);
}

// keep[i] for the n_left left rows.  `set` holds das_anti_join_scratch(n_right)
// bytes (null when that is 0).  *launches = kernels launched, *regime = the
// regime's name.
extern "C" int das_anti_join(const void* lv, const void* lm, int64_t n_left, int kl,
                             const void* rv, const void* rm, int64_t n_right, int kr,
                             const int* pair_l, const int* pair_r, int n_pairs, void* set,
                             void* keep, int* launches, const char** regime, void* stream) {
  *launches = 0;
  const bool shared = n_right <= AJ_SHARED_MAX_RIGHT;
  *regime = shared ? "shared" : "global";
  if (n_pairs > DAS_MAXC) return (int)cudaErrorInvalidValue;
  if (n_left <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const int bits = das_set_bits(n_right);
  const DasCols lcols = das_cols(pair_l, n_pairs), rcols = das_cols(pair_r, n_pairs);
  if (shared) {
    static bool attr_done[DAS_MAX_DEVICES];
    cudaError_t err = das_smem_attr((const void*)aj_shared_kernel,
                                    (int)(sizeof(int64_t) << AJ_SHARED_MAX_BITS), attr_done);
    if (err != cudaSuccess) return (int)err;
    aj_shared_kernel<<<aj_blocks(n_left), AJ_THREADS, sizeof(int64_t) << bits, st>>>(
        (const int32_t*)lv, (const uint8_t*)lm, n_left, kl, lcols, (const int32_t*)rv,
        (const uint8_t*)rm, n_right, kr, rcols, bits, (uint8_t*)keep);
    *launches = 1;
  } else {
    const int64_t slots = 1ll << bits;
    aj_init_kernel<<<das_blocks(slots + 1), DAS_THREADS, 0, st>>>((int64_t*)set, slots);
    aj_build_kernel<<<das_blocks(n_right), AJ_THREADS, 0, st>>>(
        (const int32_t*)rv, (const uint8_t*)rm, n_right, kr, rcols, (int64_t*)set, bits);
    aj_probe_kernel<<<das_blocks(n_left), AJ_THREADS, 0, st>>>(
        (const int32_t*)lv, (const uint8_t*)lm, n_left, kl, lcols, (const int64_t*)set, bits,
        (uint8_t*)keep);
    *launches = 3;
  }
  return (int)cudaGetLastError();
}
