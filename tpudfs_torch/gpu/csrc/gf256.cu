// GF(2^8) matrix product on uint32-packed bytes, Hopper (sm_90a):
//   out[r][w] = XOR_c mat[r][c] * in[c][w]   over GF(2^8), poly 0x11D.
//
// Replaces the TPU kernel tpudfs/tpu/rs_pallas.py:108-123
// (_gf_pallas_fn.<locals>.run, body _parity_rows at :67). One kernel serves
// RS encode (the generator's parity rows) and degraded-read decode (an
// erasure pattern's inverse): the matrix arrives at run time as its
// (rows, cols, 8) bit-planes bits[r][c][j] = mat[r][c] * 2^j, so one build
// serves every matrix (the TPU compiled one kernel per matrix).
//
// What bounds it on this card: bytes. Every input byte is read once and
// every output byte written once; for RS(6,3) decode of a 64 MiB block that
// is 6 x 11.2 MB each way, 40 us at 3.35 TB/s (encode: 6 rows in, 3 out,
// 30 us). The reference's bit-plane select-XOR needs rows * cols * 8
// AND-XORs per word on the integer pipes, which set the time instead
// (about 2.8x the byte bound for RS(6,3)).
//
// Design:
// - Multiplication by a constant is linear over GF(2), so
//     mat[r][c] * x = T_lo[x & 15] ^ T_hi[x >> 4]
//   for two 16-entry tables per input row: one shared-memory lookup per
//   nibble replaces four select-XORs. Each 32-bit entry packs four output
//   rows, byte r for row 4g + r of row group g:
//     T[c][g][h][n] byte r = XOR of bits[4g+r][c][4h+j] over set bits j of n.
//   The prologue derives the tables from the bit-planes into shared memory,
//   so the bit-planes still drive the result.
// - A 16-word table spans 16 distinct banks, so a warp's lookups into one
//   table are conflict-free with no copy per lane (lanes that pick the same
//   entry share a broadcast). Per input word and row group a thread does 8
//   lookups, XOR-ed into its accumulators in pairs (one LOP3 each).
// - The lookups' issue comes close to the bytes' time (RS(6,3) decode: 64
//   LDS per 4 words and input row, about 36 us for a 64 MiB block at
//   1.75 GHz), so every instruction beside them counts: each table is
//   64-byte aligned, so a nibble's address is one shift and one LOP3,
//   ((x >> s) & 0x3C) | base, with the group's offset in the load's
//   immediate. C++ indexing cost one more add per nibble: 1% of decode and
//   9% of encode time (timed beside this kernel with CUDA events, H100
//   80GB HBM3 at 700 W).
// - A lookup gives four rows of one byte position; a 4x4 byte transpose
//   (8 __byte_perm per group) turns four of them into four row words.
// - The number of row groups G (1..4) is a template parameter, dispatched on
//   ceil(rows / 4), so no row beyond the last group of 4 is computed. Above
//   16 rows the kernel walks the groups 4 at a time and reads the input
//   again for each.
// - Four words a thread (16-byte loads and stores) when W % 4 == 0 and both
//   pointers are 16-byte aligned, else one; input row c + 1 is loaded while
//   row c is looked up. One pass of the grid covers W, blocks of 256 threads
//   scheduled as SMs free up (a grid of as many blocks as the card holds,
//   striding over W, measured no faster and costs an occupancy query a call).
//
// Shared memory: cols * ceil(rows / 4) tables of 32 words (groups rounded up
// to a multiple of 4 above 16 rows). The wrapper admits rows * cols * 8 <=
// 12288 (MAX_COEFS in rs_cuda.py: 48 KiB of bit-planes, what the first
// version staged); rounding rows up to 4 at most quadruples that, to
// 192 KiB, which the entry opts into above 48 KiB.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGroups = 4;      // row groups of 4 held in registers
constexpr int kTableWords = 32;    // per (col, group): 2 nibbles x 16 entries
constexpr uint32_t kTableBytes = kTableWords * 4;
constexpr int kMaxCoefs = 48 * 1024 / 4;
constexpr size_t kDefaultSmem = 48 * 1024;

template <int VEC>
struct Vec;
template <>
struct Vec<1> {
  static __device__ __forceinline__ void load(const uint32_t* p, uint32_t* x) {
    x[0] = *p;
  }
  static __device__ __forceinline__ void store(uint32_t* p, const uint32_t* x) {
    *p = x[0];
  }
};
template <>
struct Vec<4> {
  static __device__ __forceinline__ void load(const uint32_t* p, uint32_t* x) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  }
  // __stwb: a plain store that stays one 16-byte STG (the compiler split a
  // plain uint4 store into four here).
  static __device__ __forceinline__ void store(uint32_t* p, const uint32_t* x) {
    __stwb(reinterpret_cast<uint4*>(p), make_uint4(x[0], x[1], x[2], x[3]));
  }
};

__device__ __forceinline__ uint32_t lds(uint32_t shared_addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];" : "=r"(v) : "r"(shared_addr));
  return v;
}

// a..d hold byte position 0..3 of four rows (byte r = row r); row[r] gets
// row r's four bytes in position order.
__device__ __forceinline__ void transpose4(uint32_t a, uint32_t b, uint32_t c,
                                           uint32_t d, uint32_t* row) {
  const uint32_t ab01 = __byte_perm(a, b, 0x5140);  // a0 b0 a1 b1
  const uint32_t ab23 = __byte_perm(a, b, 0x7362);  // a2 b2 a3 b3
  const uint32_t cd01 = __byte_perm(c, d, 0x5140);
  const uint32_t cd23 = __byte_perm(c, d, 0x7362);
  row[0] = __byte_perm(ab01, cd01, 0x5410);  // a0 b0 c0 d0
  row[1] = __byte_perm(ab01, cd01, 0x7632);
  row[2] = __byte_perm(ab23, cd23, 0x5410);
  row[3] = __byte_perm(ab23, cd23, 0x7632);
}

__host__ __device__ __forceinline__ int table_groups(int rows, int g) {
  const int groups = (rows + 3) / 4;
  return (groups + g - 1) / g * g;
}

template <int G, int VEC>
__global__ void __launch_bounds__(kThreads)
gf256_nibble_kernel(const uint32_t* __restrict__ in, long long W, int rows,
                    int cols, const uint32_t* __restrict__ coef,
                    uint32_t* __restrict__ out) {
  extern __shared__ __align__(128) uint32_t s_tab[];  // [col][group][half][16]
  const int ngroups = table_groups(rows, G);
  const int nwords = cols * ngroups * kTableWords;
  for (int t = threadIdx.x; t < nwords; t += blockDim.x) {
    const int n = t & 15;
    const int h = (t >> 4) & 1;
    const int g = (t >> 5) % ngroups;
    const int c = (t >> 5) / ngroups;
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

  const long long w0 =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * VEC;
  if (w0 >= W) return;
  for (int g0 = 0; g0 < ngroups; g0 += G) {
    // acc[g][p][e]: byte position p of word e, byte r = row 4(g0+g) + r.
    uint32_t acc[G][4][VEC];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[g][p][e] = 0;
    uint32_t next[VEC];
    if (cols > 0) Vec<VEC>::load(in + w0, next);
#pragma unroll 1
    for (int c = 0; c < cols; ++c) {
      uint32_t x[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) x[e] = next[e];
      if (c + 1 < cols) Vec<VEC>::load(in + (c + 1) * W + w0, next);
      const uint32_t base = s_base + (c * ngroups + g0) * kTableBytes;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          // Byte offsets 4n of the low and high nibble n of byte p.
          const uint32_t lo = ((p == 0 ? x[e] << 2 : x[e] >> (8 * p - 2)) &
                               0x3Cu) | base;
          const uint32_t hi = ((x[e] >> (8 * p + 2)) & 0x3Cu) | (base + 64);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            acc[g][p][e] ^= lds(lo + g * kTableBytes) ^
                            lds(hi + g * kTableBytes);
          }
        }
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      uint32_t row[4][VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        uint32_t t[4];
        transpose4(acc[g][0][e], acc[g][1][e], acc[g][2][e], acc[g][3][e], t);
#pragma unroll
        for (int r = 0; r < 4; ++r) row[r][e] = t[r];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int orow = 4 * (g0 + g) + r;
        if (orow < rows) Vec<VEC>::store(out + orow * W + w0, row[r]);
      }
    }
  }
}

template <int G, int VEC>
cudaError_t launch(const uint32_t* in, long long W, int rows, int cols,
                   const uint32_t* coef, uint32_t* out, cudaStream_t s) {
  const size_t smem = static_cast<size_t>(cols) * table_groups(rows, G) *
                      kTableWords * sizeof(uint32_t);
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        gf256_nibble_kernel<G, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const long long blocks = (W / VEC + kThreads - 1) / kThreads;
  gf256_nibble_kernel<G, VEC><<<static_cast<unsigned>(blocks), kThreads, smem,
                                s>>>(in, W, rows, cols, coef, out);
  return cudaGetLastError();
}

template <int VEC>
cudaError_t dispatch(const uint32_t* in, long long W, int rows, int cols,
                     const uint32_t* coef, uint32_t* out, cudaStream_t s) {
  switch ((rows + 3) / 4) {
    case 1: return launch<1, VEC>(in, W, rows, cols, coef, out, s);
    case 2: return launch<2, VEC>(in, W, rows, cols, coef, out, s);
    case 3: return launch<3, VEC>(in, W, rows, cols, coef, out, s);
    default: return launch<kMaxGroups, VEC>(in, W, rows, cols, coef, out, s);
  }
}

}  // namespace

extern "C" {

// in: (cols, W) uint32; coef: (rows, cols, 8) uint32 holding the byte
// constants mat[r][c] * 2^j; out: (rows, W) uint32. rows * cols * 8 must be
// at most 12288 (MAX_COEFS). Launches on `stream` and returns a CUDA error
// code (0 = launched).
int tpudfs_gf256_matmul(const void* in, long long W, int rows, int cols,
                        const void* coef, void* out, void* stream) {
  if (rows < 0 || cols < 0 || W < 0 ||
      static_cast<long long>(rows) * cols * 8 > kMaxCoefs) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0 || W == 0) return 0;
  const auto* src = static_cast<const uint32_t*>(in);
  const auto* cf = static_cast<const uint32_t*>(coef);
  auto* dst = static_cast<uint32_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool vec4 = (W % 4 == 0) &&
                    (reinterpret_cast<uintptr_t>(in) % 16 == 0) &&
                    (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  return static_cast<int>(vec4 ? dispatch<4>(src, W, rows, cols, cf, dst, s)
                               : dispatch<1>(src, W, rows, cols, cf, dst, s));
}

const char* tpudfs_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
