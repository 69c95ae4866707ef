// GF(2^8) matrix product over byte stripes, for any (8m, 8k) GF(2)
// bitmatrix: data (B, k, C) uint8 -> out (B, m, C) uint8.
//
// Replaces ceph_tpu/gf/pallas_kernels.py::encode_batch_planned, the TPU
// kernel behind Reed-Solomon encode and every cached decode pattern.
// The TPU kernel unpacks bit planes and multiplies them on the MXU; its
// tricks (mod-2 absorb, block-diagonal operand, bf16 pack matmul) exist
// for a systolic array and are not carried over.
//
// What bounds it on an H100: device-memory bytes. The least traffic is
// reading B*k*C bytes and writing B*m*C bytes. Per input byte the k = 8
// kernel issues two shared-memory lookups, two PRMTs, one 3-input XOR and
// half a logic op for the nibble masks, which keeps the shared-memory pipe
// (~0.07 ms at the flagship's 256 MiB) and the issue slots under the time
// of the memory traffic (0.110 ms); the design is about overlapping them:
//
// - GF(2)-linearity: M(v) = M(v & 0x0f) ^ M(v & 0xf0). For each input row
//   i there are two 16-entry tables (low and high nibble), the ISA-L
//   PSHUFB form. An entry is a 32-bit word that packs the products for
//   four output rows, one per byte, so two 32-bit shared loads serve
//   four output rows. blockIdx.y picks the group of four output rows.
// - A 16-entry table of words spans 16 distinct banks, so the lookups of
//   a warp never conflict (threads that hit the same word are broadcast).
// - The table words come from a plan built once per coding matrix on the
//   host (ceph_tpu_torch/gf/kernels.py::make_plan, layout tab[g][i][h][n]).
//   A block copies its group's k*32 words into shared memory with 16-byte
//   loads (in the k = 8 kernel after its first data loads, so the
//   prologue is one round trip that overlaps the data's). Without a plan
//   (a null table pointer) the block derives the words from the bitmatrix
//   itself, a chain of popc steps that costs ~1 us at the small shapes.
// - Lookup addresses: (w << 2) & 0x3c3c3c3c holds each byte's low nibble
//   times four, (w >> 2) & 0x3c3c3c3c its high nibble times four; one
//   PRMT takes a byte out as a byte offset into the table. In the k = 8
//   kernel the table is static and 256-byte aligned, so that PRMT also
//   writes the byte into the table's shared address, and the row's offset
//   rides in the load's immediate: no add per lookup.
// - Each thread owns 16 consecutive bytes of one stripe: one 16-byte load
//   per input row (neighbouring threads on neighbouring addresses) and one
//   16-byte store per output row. A ragged C (not a multiple of 16, or a
//   pointer not 16-byte aligned) takes the byte-wise path, masked at the
//   row's end, so every C >= 1 is served.
// - At k = 8 (every shape of the erasure-code paths) the row loop is
//   unrolled and the grid-stride loop double-buffers in registers: a
//   thread issues the loads of its next item before the lookups of the
//   current one, so its own loads are in flight while it computes.
// - All offsets are 64-bit: B*k*C passes 2^31 at the flagship sizes. The
//   grid-stride loop steps (stripe, column) without a division.
// - The launch geometry (SM count, blocks per SM of each kernel) is
//   worked out once per device; a launch makes no runtime query.

#include <atomic>
#include <cstdint>
#include <mutex>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kGroup = 4;    // output rows packed into one table word
constexpr int kFixedK = 8;   // the k of the unrolled, double-buffered loop
constexpr int kMaxDevices = 64;
// blocks per SM the k = kFixedK kernel is compiled for: caps it at 128
// registers a thread, room for two sets of item loads
constexpr int kMinBlocks = 4;

// 16-byte words of a group's table (k*32 words) and the raw path's
// scratch (kGroup*8*k bytes, rounded up).
__host__ __device__ constexpr int table_words4(int k) {
  return 8 * k + (kGroup * 8 * k + 15) / 16;
}

// Derives the group's table words from the bitmatrix into tab[k][2][16];
// packed (kGroup*8*k bytes) is scratch.
__device__ __forceinline__ void build_tables(
    const uint8_t* __restrict__ bm, int k, int m, int g,
    uint32_t* tab, uint8_t* packed) {
  const int k8 = 8 * k;
  // packed[r][i]: bit b' is bm[8*(4g) + r, 8i + b'], for the 32 bitmatrix
  // rows of this group (rows past 8m are zero).
  for (int e = threadIdx.x; e < kGroup * 8 * k; e += blockDim.x) {
    const int r = e / k, i = e % k;
    const int row = 8 * kGroup * g + r;
    uint32_t byte = 0;
    if (row < 8 * m) {
      const uint8_t* src = bm + static_cast<int64_t>(row) * k8 + 8 * i;
      for (int b = 0; b < 8; ++b) byte |= (src[b] & 1u) << b;
    }
    packed[e] = static_cast<uint8_t>(byte);
  }
  __syncthreads();
  // tab[i][h][n]: byte j is output row 4g+j's image of the nibble n in
  // position h (0 low, 1 high) of input row i.
  for (int e = threadIdx.x; e < k * 32; e += blockDim.x) {
    const int i = e / 32, h = (e / 16) % 2, n = e % 16;
    const uint32_t x = static_cast<uint32_t>(n) << (4 * h);
    uint32_t word = 0;
    for (int j = 0; j < kGroup; ++j) {
      uint32_t y = 0;
      for (int b = 0; b < 8; ++b)
        y |= (__popc(packed[(8 * j + b) * k + i] & x) & 1u) << b;
      word |= y << (8 * j);
    }
    tab[e] = word;
  }
  __syncthreads();
}

// The group's table words into shared memory: copied from the plan when
// there is one, else derived from the bitmatrix. Ends in a barrier.
__device__ __forceinline__ void tables(
    const uint32_t* __restrict__ plan, const uint8_t* __restrict__ bm,
    int k, int m, int g, uint32_t* tab) {
  if (plan != nullptr) {
    const uint4* src = reinterpret_cast<const uint4*>(plan) +
                       static_cast<int64_t>(g) * 8 * k;
    uint4* dst = reinterpret_cast<uint4*>(tab);
    for (int e = threadIdx.x; e < 8 * k; e += blockDim.x) dst[e] = src[e];
    __syncthreads();
  } else {
    build_tables(bm, k, m, g, tab,
                 reinterpret_cast<uint8_t*>(tab + 32 * k));
  }
}

__device__ __forceinline__ uint32_t lds(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// acc[s] ^= the table images of byte s of w, for the input row whose 16
// low-nibble words, then 16 high-nibble words, sit at shared address
// base + off. kAligned: base's low byte is 0, so one PRMT both takes the
// byte out and puts it into base, and a constant off goes into the load's
// immediate: 2 PRMT, 2 LDS and one 3-input XOR per byte.
template <bool kAligned>
__device__ __forceinline__ void lookup4(uint32_t base, uint32_t off,
                                        uint32_t w, uint32_t* acc) {
  const uint32_t lo = (w << 2) & 0x3c3c3c3cu;
  const uint32_t hi = (w >> 2) & 0x3c3c3c3cu;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    uint32_t a, b;
    if (kAligned) {
      a = __byte_perm(lo, base, 0x7650 + s);
      b = __byte_perm(hi, base, 0x7650 + s);
    } else {
      a = base + __byte_perm(lo, 0, 0x4440 + s);
      b = base + __byte_perm(hi, 0, 0x4440 + s);
    }
    acc[s] ^= lds(a + off) ^ lds(b + off + 64);
  }
}

// Output row j's four bytes out of the packed words a0..a3.
__device__ __forceinline__ uint32_t row_word(uint32_t a0, uint32_t a1,
                                             uint32_t a2, uint32_t a3,
                                             int j) {
  const uint32_t sel = j | ((j + 4) << 4);
  return __byte_perm(__byte_perm(a0, a1, sel), __byte_perm(a2, a3, sel),
                     0x5410);
}

// Writes the item's 16 packed words as up to four output rows: one
// 16-byte store per row, or byte-wise up to the row's end.
template <bool kVec>
__device__ __forceinline__ void store_item(const uint32_t (&acc)[16],
                                           uint8_t* dst, int64_t C,
                                           int rows, int64_t left) {
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
    if (j >= rows) break;
    uint32_t o[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      o[q] = row_word(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2],
                      acc[4 * q + 3], j);
    if (kVec) {
      *reinterpret_cast<uint4*>(dst + j * C) =
          make_uint4(o[0], o[1], o[2], o[3]);
    } else {
      for (int p = 0; p < 16 && p < left; ++p)
        dst[j * C + p] = static_cast<uint8_t>(o[p / 4] >> (8 * (p % 4)));
    }
  }
}

// The item at thread index it: stripe b and 16-byte column v; and the
// grid stride in the same form, so the loop steps without a division.
struct Cursor {
  int64_t b, v, sb, sv, nvec;
  __device__ Cursor(int64_t nvec_) : nvec(nvec_) {
    const int64_t it = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    b = it / nvec;
    v = it - b * nvec;
    sb = stride / nvec;
    sv = stride - sb * nvec;
  }
  __device__ __forceinline__ void next() {
    b += sb;
    v += sv;
    if (v >= nvec) { v -= nvec; ++b; }
  }
};

// Any k, any C: one item at a time, rows in a runtime loop.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
gf_encode_kernel(const uint32_t* __restrict__ plan,
                 const uint8_t* __restrict__ bm,
                 const uint8_t* __restrict__ data,
                 uint8_t* __restrict__ out,
                 int B, int k, int m, int64_t C) {
  extern __shared__ uint4 smem[];
  uint32_t* tab = reinterpret_cast<uint32_t*>(smem);
  const uint32_t base = shared_addr(smem);
  const int g = blockIdx.y;
  tables(plan, bm, k, m, g, tab);
  const int rows = min(kGroup, m - kGroup * g);
  Cursor cur((C + 15) / 16);
  for (; cur.b < B; cur.next()) {
    const int64_t col = cur.v * 16;
    const int64_t left = C - col;   // bytes of this row from col on
    const uint8_t* src = data + cur.b * k * C + col;
    uint32_t acc[16];
#pragma unroll
    for (int p = 0; p < 16; ++p) acc[p] = 0;
#pragma unroll 4
    for (int i = 0; i < k; ++i) {
      uint32_t w[4];
      if (kVec) {
        const uint4 v = *reinterpret_cast<const uint4*>(src + i * C);
        w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          uint32_t word = 0;
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const int p = 4 * q + s;
            if (p < left) word |= static_cast<uint32_t>(src[i * C + p])
                                  << (8 * s);
          }
          w[q] = word;
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
        lookup4<false>(base + 128 * i, 0, w[q], acc + 4 * q);
    }
    store_item<kVec>(acc, out + (cur.b * m + kGroup * g) * C + col, C,
                     rows, left);
  }
}

template <int KC>
__device__ __forceinline__ void fetch(const uint8_t* __restrict__ data,
                                      const Cursor& cur, int64_t C,
                                      uint4 (&x)[KC]) {
  const uint8_t* src = data + cur.b * KC * C + cur.v * 16;
#pragma unroll
  for (int i = 0; i < KC; ++i)
    x[i] = *reinterpret_cast<const uint4*>(src + i * C);
}

// base: the shared address of the tables, 256-byte aligned.
template <int KC>
__device__ __forceinline__ void encode_store(uint32_t base,
                                             const uint4 (&x)[KC],
                                             const Cursor& cur,
                                             uint8_t* __restrict__ out,
                                             int m, int g, int rows,
                                             int64_t C) {
  uint32_t acc[16];
#pragma unroll
  for (int p = 0; p < 16; ++p) acc[p] = 0;
#pragma unroll
  for (int i = 0; i < KC; ++i) {
    lookup4<true>(base, 128 * i, x[i].x, acc);
    lookup4<true>(base, 128 * i, x[i].y, acc + 4);
    lookup4<true>(base, 128 * i, x[i].z, acc + 8);
    lookup4<true>(base, 128 * i, x[i].w, acc + 12);
  }
  store_item<true>(acc, out + (cur.b * m + kGroup * g) * C + cur.v * 16, C,
                   rows, 16);
}

// k = KC, 16-byte aligned rows, C % 16 == 0: the rows unrolled, the next
// item's loads issued before the current item's lookups (two register
// buffers, swapped by unrolling the loop twice).
template <int KC>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
gf_encode_kernel_k(const uint32_t* __restrict__ plan,
                   const uint8_t* __restrict__ bm,
                   const uint8_t* __restrict__ data,
                   uint8_t* __restrict__ out,
                   int B, int m, int64_t C) {
  __shared__ __align__(256) uint4 tab4[table_words4(KC)];
  uint32_t* tab = reinterpret_cast<uint32_t*>(tab4);
  const uint32_t base = shared_addr(tab4);
  const int g = blockIdx.y;
  const int rows = min(kGroup, m - kGroup * g);
  Cursor cur(C / 16);
  uint4 x0[KC], x1[KC];
  if (cur.b < B) fetch<KC>(data, cur, C, x0);
  tables(plan, bm, KC, m, g, tab);
  while (cur.b < B) {
    Cursor nxt = cur;
    nxt.next();
    if (nxt.b < B) fetch<KC>(data, nxt, C, x1);
    encode_store<KC>(base, x0, cur, out, m, g, rows, C);
    cur = nxt;
    if (cur.b >= B) break;
    nxt.next();
    if (nxt.b < B) fetch<KC>(data, nxt, C, x0);
    encode_store<KC>(base, x1, cur, out, m, g, rows, C);
    cur = nxt;
  }
}

size_t table_bytes(int k) {
  return 16 * static_cast<size_t>(table_words4(k));
}

enum Variant { kFixed, kVecAny, kBytewise, kVariants };

const void* kernel_of(int v) {
  switch (v) {
    case kFixed: return reinterpret_cast<const void*>(
        gf_encode_kernel_k<kFixedK>);
    case kVecAny: return reinterpret_cast<const void*>(
        gf_encode_kernel<true>);
    default: return reinterpret_cast<const void*>(gf_encode_kernel<false>);
  }
}

// Per device, worked out at its first launch: the SM count and, for each
// kernel, the blocks an SM holds by registers and threads, the shared
// memory an SM has for blocks, and the dynamic shared memory each kernel
// is allowed (raised, under a lock, only when a launch needs more).
struct Geometry {
  cudaError_t err;
  int sms, smem_per_sm, smem_reserved;
  int per_sm[kVariants];
  size_t smem_static[kVariants];
  std::atomic<size_t> smem_allowed[kVariants];
};

Geometry g_geometry[kMaxDevices];
std::once_flag g_once[kMaxDevices];
std::mutex g_attr_lock;

Geometry& geometry(int device) {
  Geometry& geo = g_geometry[device];
  std::call_once(g_once[device], [&geo, device] {
    cudaError_t err = cudaDeviceGetAttribute(
        &geo.sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &geo.smem_per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor,
          device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &geo.smem_reserved, cudaDevAttrReservedSharedMemoryPerBlock,
          device);
    for (int v = 0; v < kVariants && err == cudaSuccess; ++v) {
      cudaFuncAttributes attr;
      err = cudaFuncGetAttributes(&attr, kernel_of(v));
      if (err != cudaSuccess) break;
      // without an opt-in, static and dynamic shared memory share 48 KiB
      geo.smem_static[v] = attr.sharedSizeBytes;
      geo.smem_allowed[v] = 48 * 1024 - attr.sharedSizeBytes;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &geo.per_sm[v], kernel_of(v), kThreads, 0);
    }
    geo.err = err;
  });
  return geo;
}

cudaError_t allow_smem(Geometry& geo, int v, size_t shmem) {
  if (shmem <= geo.smem_allowed[v]) return cudaSuccess;
  std::lock_guard<std::mutex> hold(g_attr_lock);
  if (shmem <= geo.smem_allowed[v]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel_of(v), cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(shmem));
  if (err == cudaSuccess) geo.smem_allowed[v] = shmem;
  return err;
}

}  // namespace

// Launches on `stream` and returns the launch's cudaError_t (0 on
// success). `tab` is a plan's table words (make_plan), or null to derive
// them from `bm` in each block. `device` is the current device. The
// caller owns every buffer; nothing is allocated here.
extern "C" int gf_encode_launch(const void* bm, const void* tab,
                                const void* data, void* out,
                                int B, int k, int m, long long C,
                                int device, void* stream) {
  if (B < 1 || k < 1 || m < 1 || C < 1 || device < 0 ||
      device >= kMaxDevices)
    return cudaErrorInvalidValue;
  Geometry& geo = geometry(device);
  if (geo.err != cudaSuccess) return geo.err;
  const bool vec = C % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(data) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int v = vec ? (k == kFixedK ? kFixed : kVecAny) : kBytewise;
  // dynamic shared memory: the tables, except in the k = kFixedK kernel,
  // whose tables are static
  const size_t shmem = v == kFixed ? 0 : table_bytes(k);
  const cudaError_t err = allow_smem(geo, v, shmem);
  if (err != cudaSuccess) return err;
  const long long by_smem = geo.smem_per_sm / static_cast<long long>(
      geo.smem_static[v] + shmem + geo.smem_reserved);
  long long per_sm = geo.per_sm[v] < by_smem ? geo.per_sm[v] : by_smem;
  if (per_sm < 1) per_sm = 1;
  const long long items = static_cast<long long>(B) * ((C + 15) / 16);
  const long long want = (items + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(geo.sms) * per_sm;
  const dim3 grid(static_cast<unsigned>(want < cap ? want : cap),
                  static_cast<unsigned>((m + kGroup - 1) / kGroup));
  const auto* tp = static_cast<const uint32_t*>(tab);
  const auto* bp = static_cast<const uint8_t*>(bm);
  const auto* dp = static_cast<const uint8_t*>(data);
  auto* op = static_cast<uint8_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (v) {
    case kFixed:
      gf_encode_kernel_k<kFixedK><<<grid, kThreads, shmem, st>>>(
          tp, bp, dp, op, B, m, C);
      break;
    case kVecAny:
      gf_encode_kernel<true><<<grid, kThreads, shmem, st>>>(
          tp, bp, dp, op, B, k, m, C);
      break;
    default:
      gf_encode_kernel<false><<<grid, kThreads, shmem, st>>>(
          tp, bp, dp, op, B, k, m, C);
  }
  return cudaGetLastError();
}

extern "C" const char* gf_encode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
