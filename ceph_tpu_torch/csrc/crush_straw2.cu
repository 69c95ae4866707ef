// The whole straw2 TAKE / CHOOSE[LEAF]_FIRSTN / EMIT rule over PG lanes:
// xs (N,) int32 -> leaves (numrep, N) int32 and bad (N,) int32.
//
// Replaces ceph_tpu/crush/pallas_mapper.py::_run_kernel, the TPU kernel
// behind CRUSH placement. The TPU kernel fetches bucket rows with one-hot
// MXU matmuls over byte planes and approximates the draw in f32 (a
// uniform draw with a tie matmul, a weight-class draw, a two-phase
// continuous draw), flagging lanes inside its f32 margin. Those are the
// TPU's workarounds for slow gathers and no 64-bit integers; none is
// carried over. Here:
//
// - One thread per PG lane. It loops over the candidates r in
//   [0, n_cand) and, for each, over the levels from the root down.
// - Bucket rows are real gathers from CSR tables (row start and size,
//   slot item id, slot next row, slot weight) read through the read-only
//   cache; at 10,240 OSDs they are ~170 KB and sit in L2.
// - The draw is mapper.c's bucket_straw2_choose, exactly: per slot
//   ln = crush_ln(hash3(x, id, r) & 0xFFFF) - 2^48, draw = ln / w as an
//   int64 division truncated toward zero, S64_MIN when w == 0, ties to
//   the first slot. crush_ln's tables (RH, LH: 129 x 8 B; LL: 256 x 8 B)
//   live in shared memory. Native uint32/uint64 arithmetic makes the
//   draw exact, so only candidate exhaustion flags a lane.
// - Slots resolve by scanning the shared candidate table: slot s takes
//   the first candidate c in [s, s + tries) that passed is_out and whose
//   item and leaf collide with no earlier slot; a slot with none marks
//   the lane bad, and the caller recomputes it with the rule VM.
//
// What bounds it on an H100: integer operations. Per lane it evaluates
// n_cand x (sum of the slots on its path) draws, each an rjenkins hash3
// (~184 32-bit ops), crush_ln and a 64-bit division; it reads 4 bytes and
// writes 4 * (numrep + 1). The design keeps every operand in registers,
// shared memory or L2 so the integer pipes are the only limit. Not yet
// done (later work): skipping the division on uniform-weight buckets,
// and spreading a lane's candidates over a warp.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxCand = 16;          // ceph_tpu_torch.crush.kernels.MAX_CAND
constexpr int kItemNone = 0x7FFFFFFF;
constexpr int kWeightOne = 0x10000;
constexpr uint32_t kSeed = 1315423911u;

__device__ __forceinline__ void mix(uint32_t& a, uint32_t& b, uint32_t& c) {
  a -= b; a -= c; a ^= (c >> 13);
  b -= c; b -= a; b ^= (a << 8);
  c -= a; c -= b; c ^= (b >> 13);
  a -= b; a -= c; a ^= (c >> 12);
  b -= c; b -= a; b ^= (a << 16);
  c -= a; c -= b; c ^= (b >> 5);
  a -= b; a -= c; a ^= (c >> 3);
  b -= c; b -= a; b ^= (a << 10);
  c -= a; c -= b; c ^= (b >> 15);
}

__device__ __forceinline__ uint32_t hash2(uint32_t a, uint32_t b) {
  uint32_t h = kSeed ^ a ^ b, x = 231232, y = 1232;
  mix(a, b, h);
  mix(x, a, h);
  mix(b, y, h);
  return h;
}

__device__ __forceinline__ uint32_t hash3(uint32_t a, uint32_t b,
                                          uint32_t c) {
  uint32_t h = kSeed ^ a ^ b ^ c, x = 231232, y = 1232;
  mix(a, b, h);
  mix(c, x, h);
  mix(y, a, h);
  mix(b, x, h);
  mix(y, c, h);
  return h;
}

struct LnTables {
  unsigned long long rh[129];
  unsigned long long lh[129];
  unsigned long long ll[256];
};

// mapper.c crush_ln: 2^44 * log2(xin + 1) for xin in [0, 0xffff].
__device__ __forceinline__ long long crush_ln(uint32_t xin,
                                              const LnTables& t) {
  uint32_t x = xin + 1;
  int iexpon = 15;
  if (!(x & 0x18000)) {
    const int bits = __clz(x & 0x1FFFF) - 16;
    x <<= bits;
    iexpon = 15 - bits;
  }
  const uint32_t j = (x >> 8) - 128;          // (index1 - 256) / 2
  const unsigned long long xl64 =
      (static_cast<unsigned long long>(x) * t.rh[j]) >> 48;
  const unsigned long long lh = t.lh[j] + t.ll[xl64 & 0xFF];
  return (static_cast<long long>(iexpon) << 44) +
         static_cast<long long>(lh >> 4);
}

// Index (into the slot arrays) of the winning slot of one straw2 row.
__device__ __forceinline__ int straw2_choose(
    int start, int size, uint32_t x, uint32_t r,
    const int* __restrict__ slot_id, const long long* __restrict__ slot_w,
    const LnTables& t) {
  int best = start;
  long long best_draw = 0;
  for (int s = start; s < start + size; ++s) {
    const long long w = __ldg(slot_w + s);
    long long draw;
    if (w) {
      const uint32_t u =
          hash3(x, static_cast<uint32_t>(__ldg(slot_id + s)), r) & 0xFFFF;
      draw = (crush_ln(u, t) - (1LL << 48)) / w;
    } else {
      draw = INT64_MIN;
    }
    if (s == start || draw > best_draw) {
      best = s;
      best_draw = draw;
    }
  }
  return best;
}

__global__ void __launch_bounds__(kThreads)
crush_straw2_kernel(const int* __restrict__ xs, int n,
                    const int* __restrict__ row_start,
                    const int* __restrict__ row_size,
                    const int* __restrict__ slot_id,
                    const int* __restrict__ slot_next,
                    const long long* __restrict__ slot_w,
                    const int* __restrict__ devw, int n_dev,
                    const unsigned long long* __restrict__ ln_tables,
                    int n_levels, int l_main, int vary_r,
                    int numrep, int n_cand, int tries,
                    int* __restrict__ leaves, int* __restrict__ bad) {
  __shared__ LnTables tab;
  for (int i = threadIdx.x; i < 129; i += blockDim.x) {
    tab.rh[i] = ln_tables[i];
    tab.lh[i] = ln_tables[129 + i];
  }
  for (int i = threadIdx.x; i < 256; i += blockDim.x)
    tab.ll[i] = ln_tables[258 + i];
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const uint32_t x = static_cast<uint32_t>(xs[lane]);

  int item[kMaxCand], leaf[kMaxCand];
  bool ok[kMaxCand];
  for (int c = 0; c < n_cand; ++c) {
    const uint32_t r_main = c;
    const uint32_t r_leaf = vary_r ? (c >> (vary_r - 1)) : 0;
    int row = 0, it = kItemNone;
    for (int l = 0; l < n_levels; ++l) {
      const int win = straw2_choose(__ldg(row_start + row),
                                    __ldg(row_size + row), x,
                                    l < l_main ? r_main : r_leaf,
                                    slot_id, slot_w, tab);
      if (l == l_main - 1) it = __ldg(slot_id + win);
      row = __ldg(slot_next + win);
    }
    leaf[c] = row;
    item[c] = l_main == n_levels ? row : it;
    // mapper.c is_out: out of range, zero weight, or a reweight draw
    bool out = row >= n_dev;
    if (!out) {
      const int w = __ldg(devw + row);
      if (w < kWeightOne)
        out = w == 0 || static_cast<int>(hash2(x, row) & 0xFFFF) >= w;
    }
    ok[c] = !out;
  }

  int ci[kMaxCand], cl[kMaxCand];
  bool lane_bad = false;
  for (int s = 0; s < numrep; ++s) {
    ci[s] = cl[s] = kItemNone;
    const int end = min(n_cand, s + tries);
    for (int c = s; c < end; ++c) {
      if (!ok[c]) continue;
      bool collide = false;
      for (int p = 0; p < s; ++p)
        collide |= item[c] == ci[p] || leaf[c] == cl[p];
      if (!collide) {
        ci[s] = item[c];
        cl[s] = leaf[c];
        break;
      }
    }
    lane_bad |= ci[s] == kItemNone;
    leaves[static_cast<long long>(s) * n + lane] = cl[s];
  }
  bad[lane] = lane_bad;
}

}  // namespace

extern "C" int crush_straw2_launch(
    const int* xs, int n, const int* row_start, const int* row_size,
    const int* slot_id, const int* slot_next, const long long* slot_w,
    const int* devw, int n_dev, const unsigned long long* ln_tables,
    int n_levels, int l_main, int vary_r, int numrep, int n_cand, int tries,
    int* leaves, int* bad, void* stream) {
  if (n <= 0) return 0;
  if (n_cand > kMaxCand || numrep < 1 || numrep > n_cand || n_levels < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + kThreads - 1) / kThreads;
  crush_straw2_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      xs, n, row_start, row_size, slot_id, slot_next, slot_w, devw, n_dev,
      ln_tables, n_levels, l_main, vary_r, numrep, n_cand, tries, leaves,
      bad);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* crush_straw2_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
