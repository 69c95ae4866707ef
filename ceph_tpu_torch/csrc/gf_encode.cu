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
// reading B*k*C bytes and writing B*m*C bytes; the arithmetic is a few
// integer operations per byte. So the design keeps HBM traffic at that
// minimum (each input byte is read once, each output byte written once)
// and keeps the per-byte work in shared-memory table lookups:
//
// - GF(2)-linearity: M(v) = M(v & 0x0f) ^ M(v & 0xf0). For each input row
//   i the block builds two 16-entry tables (low and high nibble), the
//   ISA-L PSHUFB form. An entry is a 32-bit word that packs the products
//   for four output rows, one per byte, so two 32-bit shared loads serve
//   four output rows. blockIdx.y picks the group of four output rows.
// - A 16-entry table of words spans 16 distinct banks, so the lookups of
//   a warp never conflict (threads that hit the same word are broadcast).
// - Each thread owns 16 consecutive bytes of one stripe: one 16-byte load
//   per input row (neighbouring threads on neighbouring addresses) and one
//   16-byte store per output row. A ragged C (not a multiple of 16, or a
//   pointer not 16-byte aligned) takes the byte-wise path, masked at the
//   row's end, so every C >= 1 is served.
// - All offsets are 64-bit: B*k*C passes 2^31 at the flagship sizes.
// - A grid-stride loop over (stripe, 16-byte column) items lets each
//   block build its tables once for many items.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 4;   // output rows packed into one table word

// Shared layout: tab[k][2][16] words, then packed[kGroup*8][k] bytes.
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

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
gf_encode_kernel(const uint8_t* __restrict__ bm,
                 const uint8_t* __restrict__ data,
                 uint8_t* __restrict__ out,
                 int B, int k, int m, int64_t C) {
  extern __shared__ uint32_t smem[];
  uint32_t* tab = smem;
  uint8_t* packed = reinterpret_cast<uint8_t*>(smem + 32 * k);
  const int g = blockIdx.y;
  build_tables(bm, k, m, g, tab, packed);
  const int rows = min(kGroup, m - kGroup * g);

  const int64_t nvec = (C + 15) / 16;
  const int64_t items = static_cast<int64_t>(B) * nvec;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t it = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
       it < items; it += stride) {
    const int64_t b = it / nvec;
    const int64_t col = (it % nvec) * 16;
    const int64_t left = C - col;   // bytes of this row from col on
    const uint8_t* src = data + b * k * C + col;
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
      const uint32_t* lo = tab + 32 * i;
      const uint32_t* hi = lo + 16;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const uint32_t v = (w[q] >> (8 * s)) & 0xffu;
          acc[4 * q + s] ^= lo[v & 15u] ^ hi[v >> 4];
        }
      }
    }
    uint8_t* dst = out + (b * m + kGroup * g) * C + col;
    for (int j = 0; j < rows; ++j) {
      uint32_t o[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        o[q] = 0;
#pragma unroll
        for (int s = 0; s < 4; ++s)
          o[q] |= ((acc[4 * q + s] >> (8 * j)) & 0xffu) << (8 * s);
      }
      if (kVec) {
        *reinterpret_cast<uint4*>(dst + j * C) =
            make_uint4(o[0], o[1], o[2], o[3]);
      } else {
        for (int p = 0; p < 16 && p < left; ++p)
          dst[j * C + p] = static_cast<uint8_t>(o[p / 4] >> (8 * (p % 4)));
      }
    }
  }
}

}  // namespace

// Launches on `stream` and returns the launch's cudaError_t (0 on
// success). The caller owns every buffer; nothing is allocated here.
extern "C" int gf_encode_launch(const void* bm, const void* data, void* out,
                                int B, int k, int m, long long C,
                                void* stream) {
  if (B < 1 || k < 1 || m < 1 || C < 1) return cudaErrorInvalidValue;
  const bool vec = C % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(data) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const size_t shmem = 32 * sizeof(uint32_t) * k + kGroup * 8 * k;
  auto kernel = vec ? gf_encode_kernel<true> : gf_encode_kernel<false>;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess && shmem > 48 * 1024)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(shmem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, shmem);
  if (err != cudaSuccess) return err;
  const long long items = static_cast<long long>(B) * ((C + 15) / 16);
  const long long want = (items + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const dim3 grid(static_cast<unsigned>(want < cap ? want : cap),
                  static_cast<unsigned>((m + kGroup - 1) / kGroup));
  kernel<<<grid, kThreads, shmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bm), static_cast<const uint8_t*>(data),
      static_cast<uint8_t*>(out), B, k, m, C);
  return cudaGetLastError();
}

extern "C" const char* gf_encode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
