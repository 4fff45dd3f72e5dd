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
// Batched merges (many buckets in one launch) lay B lanes of seg_len
// rows end to end: eq[i] = 0 wherever i % seg_len == seg_len - 1, so no
// segment continues across a lane boundary, whatever the keys or codes
// there say.  seg_len >= n (one lane) leaves the function as above.
//
// Bound: memory.  The function reads each input word once and writes one
// byte per row: n * (4L + 4) bytes in (+ 8n with codes, less the lane
// words of pairs the codes decide) and n bytes out.  At L = 2 and
// n = 2^27 that is about 1.75 GB, about 0.52 ms at the H100's 3.35 TB/s.
//
// Design.  A streaming compare needs enough bytes in flight to cover the
// memory latency (about 20 KB an SM on this card), and no tensor cores.
// - Each thread takes R = 4 consecutive rows and reads each array with
//   one 16-byte load.  A warp takes 32 * R rows; its threads' loads are
//   all issued before any compare (bitwise AND, no short-circuit chain).
// - Row i + R, the halo, comes from the next thread by a warp shuffle;
//   the warp's last thread loads that one word itself.
// - One 4-byte store writes the thread's 4 result bytes.
// - Lanes are read in passes of up to kLanes (<= 4) lanes.  Before each
//   pass the warp votes: when no pair in it is still open (decided by
//   the codes, or by an unequal earlier lane) the pass is skipped, and a
//   thread loads a lane's words only when one of the pairs that touch
//   its rows is open.  So with codes, runs whose neighbours come from
//   the same run read perm, ovc_off and invalid but no lanes.
// - The grid is sized from the SM count and the kernel's occupancy; a
//   warp walks warp tiles in a grid-stride loop.  Below one full wave
//   the block shrinks (to 64 threads) so small n spreads over more SMs.
// - Any n is exact: when n % 4 != 0 or a pointer is not 16-byte
//   aligned, the same kernel runs with R = 1 (scalar loads, one byte
//   stored a row).
// - A lane boundary closes its pair before the first lane pass, so the
//   boundary pair reads no lane words and the warp vote skips passes
//   as for any decided pair; the modulo runs once a thread and tile,
//   and only when there is more than one lane.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kOvcSentinel = 0xFFFFFFFFu;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxThreads = 256;
constexpr int kMinThreads = 64;
constexpr int kMaxDevices = 64;

// w[0..R-1] = p[row..row+R-1] where `need`, else 0.
template <int R>
__device__ __forceinline__ void load_rows(const uint32_t* __restrict__ p,
                                          int64_t row, bool need,
                                          uint32_t (&w)[R + 1]) {
  if constexpr (R == 4) {
    uint4 v = make_uint4(0, 0, 0, 0);
    if (need) v = __ldg(reinterpret_cast<const uint4*>(p + row));
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) w[r] = need ? __ldg(p + row + r) : 0u;
  }
}

// w[R] = the word of row + R: the next thread's w[0], or for the warp's
// last thread `halo` (which it loaded itself).
template <int R>
__device__ __forceinline__ void take_halo(uint32_t (&w)[R + 1],
                                          uint32_t halo, bool last) {
  const uint32_t down = __shfl_down_sync(kFull, w[0], 1);
  w[R] = last ? halo : down;
}

template <int R, int kLanes, bool kWithOvc>
__global__ void __launch_bounds__(kMaxThreads)
eq_next_kernel(const uint32_t* __restrict__ lanes, int num_lanes, int64_t n,
               const uint32_t* __restrict__ invalid,
               const uint32_t* __restrict__ ovc_off,
               const uint32_t* __restrict__ perm, uint32_t num_key_lanes,
               int64_t seg_len, uint8_t* __restrict__ out) {
  const int lane_id = static_cast<int>(threadIdx.x & 31u);
  const bool last = lane_id == 31;
  constexpr int64_t kWarpRows = 32 * R;
  const int64_t tiles = (n + kWarpRows - 1) / kWarpRows;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (blockDim.x / 32);
  // the tile index is uniform over the warp, so every thread of it runs
  // every shuffle and vote below
  for (int64_t tile = static_cast<int64_t>(blockIdx.x) * (blockDim.x / 32) +
                      threadIdx.x / 32;
       tile < tiles; tile += warps) {
    const int64_t row = tile * kWarpRows + lane_id * R;
    // R == 4 only when n % 4 == 0, so a thread's rows are all in or all out
    const bool in = row < n;
    const bool halo_in = row + R < n;
    // cut[r]: pair (row + r, row + r + 1) straddles a lane boundary
    bool cut[R];
#pragma unroll
    for (int r = 0; r < R; ++r) cut[r] = false;
    if (seg_len < n) {
      const uint32_t seg = static_cast<uint32_t>(seg_len);
      const uint32_t m = static_cast<uint32_t>(row % seg_len);
#pragma unroll
      for (int r = 0; r < R; ++r)
        cut[r] = (m + static_cast<uint32_t>(r) + 1u) % seg == 0u;
    }

    // eq[r]: pair (row + r, row + r + 1) exists and its key is equal so
    // far; open[r]: its lanes still have to be compared
    bool eq[R], open[R];
    uint32_t inv[R + 1];
    load_rows<R>(invalid, row, in, inv);
    const uint32_t inv_halo = (last && halo_in) ? __ldg(invalid + row + R)
                                                : 0u;
    if constexpr (kWithOvc) {
      uint32_t pm[R + 1], off[R + 1];
      load_rows<R>(perm, row, in, pm);
      load_rows<R>(ovc_off, row, in, off);
      const bool lh = last && halo_in;
      take_halo<R>(pm, lh ? __ldg(perm + row + R) : 0u, last);
      take_halo<R>(off, lh ? __ldg(ovc_off + row + R) : 0u, last);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const bool pair = ((r + 1 < R) ? in : halo_in) && !cut[r];
        const bool decided = pm[r + 1] == pm[r] + 1u &&
                             off[r + 1] != kOvcSentinel;
        eq[r] = pair && (!decided || off[r + 1] >= num_key_lanes);
        open[r] = pair && !decided;
      }
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        eq[r] = ((r + 1 < R) ? in : halo_in) && !cut[r];
        open[r] = eq[r];
      }
    }

    for (int l0 = 0; l0 < num_lanes; l0 += kLanes) {
      bool any_open = false;
#pragma unroll
      for (int r = 0; r < R; ++r) any_open = any_open || open[r];
      // row `row` is also the second row of the previous thread's last
      // pair; lane 0's predecessor is the previous tile's last thread,
      // which loads its halo itself
      const bool prev_open =
          __shfl_up_sync(kFull, open[R - 1] ? 1 : 0, 1) && lane_id != 0;
      const bool need = any_open || prev_open;
      if (!__any_sync(kFull, need)) break;
      uint32_t w[kLanes][R + 1];
      uint32_t halo[kLanes];
#pragma unroll
      for (int j = 0; j < kLanes; ++j) {
        const bool lane_in = l0 + j < num_lanes;
        const uint32_t* p = lanes + static_cast<int64_t>(l0 + j) * n;
        load_rows<R>(p, row, need && lane_in, w[j]);
        halo[j] = (last && open[R - 1] && lane_in) ? __ldg(p + row + R) : 0u;
      }
#pragma unroll
      for (int j = 0; j < kLanes; ++j) take_halo<R>(w[j], halo[j], last);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        bool same = true;
#pragma unroll
        for (int j = 0; j < kLanes; ++j)
          same &= (l0 + j >= num_lanes) | (w[j][r] == w[j][r + 1]);
        eq[r] = open[r] ? same : eq[r];
        open[r] = open[r] & same;
      }
    }

    // after the lane passes, so their loads issue while invalid's is
    // still in flight
    take_halo<R>(inv, inv_halo, last);
    if (in) {
      if constexpr (R == 4) {
        uint32_t packed = 0;
#pragma unroll
        for (int r = 0; r < R; ++r)
          packed |= static_cast<uint32_t>(eq[r] & (inv[r] == inv[r + 1]))
                    << (8 * r);
        *reinterpret_cast<uint32_t*>(out + row) = packed;
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r)
          out[row + r] = static_cast<uint8_t>(eq[r] & (inv[r] == inv[r + 1]));
      }
    }
  }
}

struct Args {
  const uint32_t* lanes;
  int num_lanes;
  int64_t n;
  const uint32_t* invalid;
  const uint32_t* ovc_off;
  const uint32_t* perm;
  uint32_t num_key_lanes;
  int64_t seg_len;
  uint8_t* out;
};

int sm_count() {
  static std::atomic<int> cache[kMaxDevices];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return 132;
  int sms = cache[dev].load(std::memory_order_relaxed);
  if (sms == 0) {
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || sms <= 0)
      sms = 132;
    cache[dev].store(sms, std::memory_order_relaxed);
  }
  return sms;
}

template <int R, int kLanes, bool kWithOvc>
void launch(const Args& a, cudaStream_t s) {
  auto* kernel = eq_next_kernel<R, kLanes, kWithOvc>;
  // resident warps an SM holds of this instance at full block size
  static const int warps_per_sm = [kernel] {
    int blocks = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      kMaxThreads, 0) !=
            cudaSuccess || blocks <= 0)
      blocks = 1;
    return blocks * (kMaxThreads / 32);
  }();
  const int sms = sm_count();
  const int64_t tiles = (a.n + 32 * R - 1) / (32 * R);
  int threads = kMaxThreads;
  while (threads > kMinThreads && tiles < static_cast<int64_t>(sms) *
                                              (threads / 32))
    threads /= 2;
  const int64_t per_block = threads / 32;
  const int64_t wanted = (tiles + per_block - 1) / per_block;
  const int64_t resident =
      static_cast<int64_t>(sms) * warps_per_sm / per_block;
  const int blocks = static_cast<int>(wanted < resident ? wanted : resident);
  kernel<<<blocks, threads, 0, s>>>(a.lanes, a.num_lanes, a.n, a.invalid,
                                     a.ovc_off, a.perm, a.num_key_lanes,
                                     a.seg_len, a.out);
}

template <int R, bool kWithOvc>
void dispatch_lanes(const Args& a, cudaStream_t s) {
  switch (a.num_lanes) {
    case 1: launch<R, 1, kWithOvc>(a, s); break;
    case 2: launch<R, 2, kWithOvc>(a, s); break;
    case 3: launch<R, 3, kWithOvc>(a, s); break;
    default: launch<R, 4, kWithOvc>(a, s); break;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() after the launch.
// `ovc_off` and `perm` are both null (plain variant) or both set.
// `seg_len` (1 <= seg_len < 2^31, or >= n for one lane) is the rows of
// each batched lane; n must be a multiple of it when it is below n.
extern "C" int paimon_eq_next_mask(const void* lanes, int num_lanes,
                                   long long n, const void* invalid,
                                   const void* ovc_off, const void* perm,
                                   int num_key_lanes, long long seg_len,
                                   void* out, void* stream) {
  if (n <= 0) return 0;
  if (num_lanes < 1 || seg_len < 1 ||
      (seg_len < n && seg_len >= (1LL << 31)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const uint32_t*>(lanes), num_lanes,
               static_cast<int64_t>(n), static_cast<const uint32_t*>(invalid),
               static_cast<const uint32_t*>(ovc_off),
               static_cast<const uint32_t*>(perm),
               static_cast<uint32_t>(num_key_lanes),
               static_cast<int64_t>(seg_len), static_cast<uint8_t*>(out)};
  const bool with_ovc = ovc_off != nullptr;
  const bool vec = n % 4 == 0 && aligned16(lanes) && aligned16(invalid) &&
                   (!with_ovc || (aligned16(ovc_off) && aligned16(perm))) &&
                   (reinterpret_cast<uintptr_t>(out) & 3u) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    with_ovc ? dispatch_lanes<4, true>(a, s) : dispatch_lanes<4, false>(a, s);
  } else {
    with_ovc ? dispatch_lanes<1, true>(a, s) : dispatch_lanes<1, false>(a, s);
  }
  return static_cast<int>(cudaGetLastError());
}
