// Design probe for the GF(2^8) kernel (gf256.cu), on no path of the port.
// Run by tpudfs_torch/gpu/probe_gf256.py, which times these beside gf256.cu
// on the card. Same arguments and layout as tpudfs_gf256_matmul:
// in (cols, W) uint32, coef (rows, cols, 8) bit-planes, out (rows, W).
//
// - select_xor: the bit-plane select-XOR of gf256.cu's first version (8
//   AND-XORs per input row, bit and output row), but with the number of
//   rows a template parameter, so no row beyond `rows` is issued. It tells
//   "rows computed for nothing" apart from "the wrong algorithm".
// - loads_stores, loads_all: no arithmetic; cols rows read and rows rows
//   written in gf256.cu's order (4 words a thread, input row c + 1 loaded
//   while row c is used), or with every input row (up to 8) loaded before
//   any is used. The floor the memory sets at this access pattern.
// - nibble<G, PAIRS, OR>: gf256.cu's nibble tables for 1..8 rows (G = 1 or
//   2 row groups). OR: addresses built as ((x >> s) & mask) | base, as
//   gf256.cu does, else C++ indexing (an address add per nibble). PAIRS
//   (G = 2): the two groups' entries interleaved, so one 64-bit lookup
//   (LDS.64) serves both.
// Every kernel strides over the words; `rounds` sets the grid: 0 as many
// blocks as the card holds at once, k > 0 enough blocks for k words of 4 a
// thread.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kByteLsb = 0x01010101u;

__device__ __forceinline__ void load4(const uint32_t* p, uint32_t* x) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}

__device__ __forceinline__ void store4(uint32_t* p, const uint32_t* x) {
  *reinterpret_cast<uint4*>(p) = make_uint4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ void transpose4(uint32_t a, uint32_t b, uint32_t c,
                                           uint32_t d, uint32_t* row) {
  const uint32_t ab01 = __byte_perm(a, b, 0x5140);
  const uint32_t ab23 = __byte_perm(a, b, 0x7362);
  const uint32_t cd01 = __byte_perm(c, d, 0x5140);
  const uint32_t cd23 = __byte_perm(c, d, 0x7362);
  row[0] = __byte_perm(ab01, cd01, 0x5410);
  row[1] = __byte_perm(ab01, cd01, 0x7632);
  row[2] = __byte_perm(ab23, cd23, 0x5410);
  row[3] = __byte_perm(ab23, cd23, 0x7632);
}

template <int ROWS>
__global__ void __launch_bounds__(kThreads)
select_xor(const uint32_t* __restrict__ in, long long W, int cols,
           const uint32_t* __restrict__ coef, uint32_t* __restrict__ out) {
  extern __shared__ uint32_t s_coef[];  // [ROWS][cols][8], bytes replicated
  for (int t = threadIdx.x; t < ROWS * cols * 8; t += blockDim.x) {
    s_coef[t] = (coef[t] & 0xFFu) * kByteLsb;
  }
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long v = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       v < W / 4; v += stride) {
    const long long w0 = v * 4;
    uint32_t acc[ROWS][4];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][e] = 0;
    for (int c = 0; c < cols; ++c) {
      uint32_t x[4];
      load4(in + c * W + w0, x);
      const uint32_t* plane = s_coef + c * 8;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t mask[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) mask[e] = ((x[e] >> j) & kByteLsb) * 0xFFu;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const uint32_t k = plane[r * cols * 8 + j];
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[r][e] ^= mask[e] & k;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) store4(out + r * W + w0, acc[r]);
  }
}

__global__ void __launch_bounds__(kThreads)
loads_stores(const uint32_t* __restrict__ in, long long W, int rows, int cols,
             uint32_t* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long v = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       v < W / 4; v += stride) {
    const long long w0 = v * 4;
    uint32_t acc[4] = {0, 0, 0, 0};
    uint32_t next[4];
    if (cols > 0) load4(in + w0, next);
#pragma unroll 1
    for (int c = 0; c < cols; ++c) {
      uint32_t x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] = next[e];
      if (c + 1 < cols) load4(in + (c + 1) * W + w0, next);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[e] ^= x[e];
    }
#pragma unroll 1
    for (int r = 0; r < rows; ++r) {
      uint32_t y[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) y[e] = acc[e] ^ r;
      store4(out + r * W + w0, y);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
loads_all(const uint32_t* __restrict__ in, long long W, int rows, int cols,
          uint32_t* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long v = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       v < W / 4; v += stride) {
    const long long w0 = v * 4;
    uint32_t x[8][4];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      if (c < cols) load4(in + c * W + w0, x[c]);
    }
    uint32_t acc[4] = {0, 0, 0, 0};
#pragma unroll
    for (int c = 0; c < 8; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[e] ^= c < cols ? x[c][e] : 0u;
    }
#pragma unroll 1
    for (int r = 0; r < rows; ++r) {
      uint32_t y[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) y[e] = acc[e] ^ r;
      store4(out + r * W + w0, y);
    }
  }
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ uint2 lds64(uint32_t addr) {
  uint2 v;
  asm volatile("ld.shared.v2.b32 {%0, %1}, [%2];"
               : "=r"(v.x), "=r"(v.y) : "r"(addr));
  return v;
}

// Nibble (x >> kBit) & 15 scaled by 1 << kScale, OR-ed into an aligned base.
template <int kBit, int kScale>
__device__ __forceinline__ uint32_t nib_addr(uint32_t x, uint32_t base) {
  const uint32_t y = kBit >= kScale ? x >> (kBit - kScale) : x << (kScale - kBit);
  return (y & (15u << kScale)) | base;
}

// !PAIRS: tables [col][group][half][16] of words; PAIRS (G == 2):
// [col][half][16] of (group 0, group 1) word pairs.
template <int G, bool PAIRS, bool OR>
__global__ void __launch_bounds__(kThreads)
nibble(const uint32_t* __restrict__ in, long long W, int rows, int cols,
       const uint32_t* __restrict__ coef, uint32_t* __restrict__ out) {
  extern __shared__ __align__(256) uint32_t s_tab[];
  const int nwords = cols * G * 32;
  for (int t = threadIdx.x; t < nwords; t += blockDim.x) {
    int n, h, g, c;
    if (PAIRS) {
      g = t & 1; n = (t >> 1) & 15; h = (t >> 5) & 1; c = t >> 6;
    } else {
      n = t & 15; h = (t >> 4) & 1; g = (t >> 5) % G; c = (t >> 5) / G;
    }
    uint32_t entry = 0;
    for (int r = 0; r < 4 && 4 * g + r < rows; ++r) {
      const uint32_t* b = coef + ((4 * g + r) * cols + c) * 8 + 4 * h;
      uint32_t v = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) v ^= (n >> j & 1) ? b[j] : 0u;
      entry |= (v & 0xFFu) << (8 * r);
    }
    s_tab[t] = entry;
  }
  __syncthreads();
  const uint32_t s_base = static_cast<uint32_t>(__cvta_generic_to_shared(s_tab));
  constexpr int kScale = PAIRS ? 3 : 2;     // entry size 8 or 4 bytes
  constexpr uint32_t kHalf = 16u << kScale;  // hi table after lo
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long v = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       v < W / 4; v += stride) {
    const long long w0 = v * 4;
    uint32_t acc[G][4][4];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[g][p][e] = 0;
    uint32_t next[4];
    if (cols > 0) load4(in + w0, next);
#pragma unroll 1
    for (int c = 0; c < cols; ++c) {
      uint32_t x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] = next[e];
      if (c + 1 < cols) load4(in + (c + 1) * W + w0, next);
      const uint32_t base = s_base + c * G * 128;
      const uint32_t* tab = s_tab + c * G * 32;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          if (OR) {
            uint32_t lo, hi;
            switch (p) {
              case 0: lo = nib_addr<0, kScale>(x[e], base);
                      hi = nib_addr<4, kScale>(x[e], base + kHalf); break;
              case 1: lo = nib_addr<8, kScale>(x[e], base);
                      hi = nib_addr<12, kScale>(x[e], base + kHalf); break;
              case 2: lo = nib_addr<16, kScale>(x[e], base);
                      hi = nib_addr<20, kScale>(x[e], base + kHalf); break;
              default: lo = nib_addr<24, kScale>(x[e], base);
                       hi = nib_addr<28, kScale>(x[e], base + kHalf); break;
            }
            if (PAIRS) {
              const uint2 a = lds64(lo), b = lds64(hi);
              acc[0][p][e] ^= a.x ^ b.x;
              acc[G - 1][p][e] ^= a.y ^ b.y;
            } else {
#pragma unroll
              for (int g = 0; g < G; ++g) {
                acc[g][p][e] ^= lds32(lo + g * 128) ^ lds32(hi + g * 128);
              }
            }
          } else {
            const uint32_t lo = (x[e] >> (8 * p)) & 15u;
            const uint32_t hi = (x[e] >> (8 * p + 4)) & 15u;
            if (PAIRS) {
              const uint2* pairs = reinterpret_cast<const uint2*>(tab);
              const uint2 a = pairs[lo], b = pairs[16 + hi];
              acc[0][p][e] ^= a.x ^ b.x;
              acc[G - 1][p][e] ^= a.y ^ b.y;
            } else {
#pragma unroll
              for (int g = 0; g < G; ++g) {
                acc[g][p][e] ^= tab[g * 32 + lo] ^ tab[g * 32 + 16 + hi];
              }
            }
          }
        }
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      uint32_t row[4][4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        uint32_t t[4];
        transpose4(acc[g][0][e], acc[g][1][e], acc[g][2][e], acc[g][3][e], t);
#pragma unroll
        for (int r = 0; r < 4; ++r) row[r][e] = t[r];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (4 * g + r < rows) store4(out + (4 * g + r) * W + w0, row[r]);
      }
    }
  }
}

template <typename K>
long long grid_for(K kernel, long long nvec, size_t smem, int rounds,
                   int fixed_per_sm = 0) {
  int dev = 0, sms = 132, per_sm = fixed_per_sm;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (per_sm == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  }
  const long long per_block = static_cast<long long>(kThreads) *
                              (rounds > 0 ? rounds : 1);
  long long blocks = (nvec + per_block - 1) / per_block;
  const long long cap = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  if (rounds == 0 && blocks > cap) blocks = cap;
  return blocks < 1 ? 1 : blocks;
}

template <int G, bool PAIRS, bool OR>
cudaError_t launch_nibble(const uint32_t* in, long long W, int rows, int cols,
                          const uint32_t* coef, uint32_t* out, int rounds,
                          cudaStream_t s) {
  const auto kernel = nibble<G, PAIRS, OR>;
  const size_t smem = static_cast<size_t>(cols) * G * 32 * sizeof(uint32_t);
  const long long g = grid_for(kernel, W / 4, smem, rounds);
  nibble<G, PAIRS, OR><<<static_cast<unsigned>(g), kThreads, smem, s>>>(
      in, W, rows, cols, coef, out);
  return cudaGetLastError();
}

template <int ROWS>
cudaError_t launch_select_xor(const uint32_t* in, long long W, int cols,
                              const uint32_t* coef, uint32_t* out, int rounds,
                              cudaStream_t s) {
  const size_t smem = static_cast<size_t>(ROWS) * cols * 8 * sizeof(uint32_t);
  // At rounds 0 the first version's grid: 8 blocks of 256 a SM at most.
  const long long g = grid_for(select_xor<ROWS>, W / 4, smem, rounds,
                               rounds ? 0 : 8);
  select_xor<ROWS><<<static_cast<unsigned>(g), kThreads, smem, s>>>(
      in, W, cols, coef, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// variant 0: select_xor (1 <= rows <= 8); 1: loads_stores; 2: loads_all
// (cols <= 8); nibble tables for 1 <= rows <= 8: 3 C++ indexing, 4 C++
// indexing with pairs (5 <= rows), 5 OR-ed addresses with pairs
// (5 <= rows), 6 OR-ed addresses (gf256.cu's arithmetic). rounds: the grid
// (see above). W % 4 == 0 and 16-byte aligned pointers. Returns a CUDA error
// code (0 = launched).
int tpudfs_gf256_probe(const void* in, long long W, int rows, int cols,
                       const void* coef, int variant, int rounds, void* out,
                       void* stream) {
  const auto* src = static_cast<const uint32_t*>(in);
  const auto* cf = static_cast<const uint32_t*>(coef);
  auto* dst = static_cast<uint32_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (W % 4 != 0 || reinterpret_cast<uintptr_t>(in) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0 || rows < 1 || rows > 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool two = rows > 4;
  switch (variant) {
    case 0:
      switch (rows) {
        case 1: return launch_select_xor<1>(src, W, cols, cf, dst, rounds, s);
        case 2: return launch_select_xor<2>(src, W, cols, cf, dst, rounds, s);
        case 3: return launch_select_xor<3>(src, W, cols, cf, dst, rounds, s);
        case 4: return launch_select_xor<4>(src, W, cols, cf, dst, rounds, s);
        case 5: return launch_select_xor<5>(src, W, cols, cf, dst, rounds, s);
        case 6: return launch_select_xor<6>(src, W, cols, cf, dst, rounds, s);
        case 7: return launch_select_xor<7>(src, W, cols, cf, dst, rounds, s);
        default: return launch_select_xor<8>(src, W, cols, cf, dst, rounds, s);
      }
    case 1: {
      const long long g = grid_for(loads_stores, W / 4, 0, rounds);
      loads_stores<<<static_cast<unsigned>(g), kThreads, 0, s>>>(src, W, rows,
                                                                 cols, dst);
      return static_cast<int>(cudaGetLastError());
    }
    case 2: {
      if (cols > 8) return static_cast<int>(cudaErrorInvalidValue);
      const long long g = grid_for(loads_all, W / 4, 0, rounds);
      loads_all<<<static_cast<unsigned>(g), kThreads, 0, s>>>(src, W, rows,
                                                              cols, dst);
      return static_cast<int>(cudaGetLastError());
    }
    case 3:
      return two ? launch_nibble<2, false, false>(src, W, rows, cols, cf, dst, rounds, s)
                 : launch_nibble<1, false, false>(src, W, rows, cols, cf, dst, rounds, s);
    case 4:
      if (!two) return static_cast<int>(cudaErrorInvalidValue);
      return launch_nibble<2, true, false>(src, W, rows, cols, cf, dst, rounds, s);
    case 5:
      if (!two) return static_cast<int>(cudaErrorInvalidValue);
      return launch_nibble<2, true, true>(src, W, rows, cols, cf, dst, rounds, s);
    case 6:
      return two ? launch_nibble<2, false, true>(src, W, rows, cols, cf, dst, rounds, s)
                 : launch_nibble<1, false, true>(src, W, rows, cols, cf, dst, rounds, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* tpudfs_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
