// Neighbour-equality mask of the merge plane's winner-select, for Hopper.
//
// Replaces paimon_tpu/ops/pallas_kernels.py `_eq_next_fn` (both its plain
// and its offset-value-code variant); the semantics are those of
// `_eq_next_xla` there.  Over rows already in sorted order:
//
//   eq[i] = AND_l(lane_l[i] == lane_l[i+1]) && invalid[i] == invalid[i+1]
//   eq[n-1] = 0
//
// With offset-value codes, a pair that was consecutive in its input run
// (perm[i+1] == perm[i] + 1) and whose code is known
// (ovc_off[i+1] != 0xFFFFFFFF) takes eq = ovc_off[i+1] >= num_key_lanes
// instead of the lane compare; the invalid guard applies either way.
//
// Bound: memory.  The function reads each input word once and writes one
// byte per row: n * (4L + 4) bytes in (+ 8n with codes) and n bytes out.
// At L = 2 and n = 2^27 that is about 1.75 GB, about 0.52 ms at the
// H100's 3.35 TB/s.  Design: one thread per row over a grid-stride loop;
// lanes arrive as one [L, n] array so neighbouring threads read
// neighbouring words, and row i+1 is read directly (no rolled copy is
// materialized); the tail is masked here, so any n works.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kOvcSentinel = 0xFFFFFFFFu;
constexpr int kThreads = 256;

template <bool kWithOvc>
__global__ void eq_next_kernel(const uint32_t* __restrict__ lanes,
                               int num_lanes, int64_t n,
                               const uint32_t* __restrict__ invalid,
                               const uint32_t* __restrict__ ovc_off,
                               const int32_t* __restrict__ perm,
                               uint32_t num_key_lanes,
                               uint8_t* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    if (i == n - 1) {
      out[i] = 0;
      continue;
    }
    bool eq = true;
    bool decided = false;
    if (kWithOvc) {
      const uint32_t off = ovc_off[i + 1];
      if (perm[i + 1] == perm[i] + 1 && off != kOvcSentinel) {
        eq = off >= num_key_lanes;
        decided = true;
      }
    }
    if (!decided) {
      for (int l = 0; l < num_lanes; ++l) {
        const uint32_t* lane = lanes + static_cast<int64_t>(l) * n;
        eq = eq && (lane[i] == lane[i + 1]);
      }
    }
    out[i] = (eq && invalid[i] == invalid[i + 1]) ? 1 : 0;
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() after the launch.
// `ovc_off` and `perm` are both null (plain variant) or both set.
extern "C" int paimon_eq_next_mask(const void* lanes, int num_lanes,
                                   long long n, const void* invalid,
                                   const void* ovc_off, const void* perm,
                                   int num_key_lanes, void* out,
                                   void* stream) {
  if (n <= 0) return 0;
  const int64_t want = (n + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < (1 << 20) ? want : (1 << 20));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* l = static_cast<const uint32_t*>(lanes);
  const auto* inv = static_cast<const uint32_t*>(invalid);
  auto* o = static_cast<uint8_t*>(out);
  if (ovc_off != nullptr) {
    eq_next_kernel<true><<<blocks, kThreads, 0, s>>>(
        l, num_lanes, n, inv, static_cast<const uint32_t*>(ovc_off),
        static_cast<const int32_t*>(perm),
        static_cast<uint32_t>(num_key_lanes), o);
  } else {
    eq_next_kernel<false><<<blocks, kThreads, 0, s>>>(
        l, num_lanes, n, inv, nullptr, nullptr,
        static_cast<uint32_t>(num_key_lanes), o);
  }
  return static_cast<int>(cudaGetLastError());
}
