// GF(2^8) matrix product on uint32-packed bytes, Hopper (sm_90a):
//   out[r][w] = XOR_c mat[r][c] * in[c][w]   over GF(2^8), poly 0x11D.
//
// Replaces the TPU kernel tpudfs/tpu/rs_pallas.py::_gf_pallas_fn.<locals>.run
// (body _parity_rows). Multiplication by a constant is linear over GF(2):
// c * x = XOR_{j<8} [bit j of x] * (c * 2^j), so each output byte is an XOR
// of masked constants; the same bit-plane select-XOR as the reference, so
// the result is bit-exact with it. One kernel serves RS encode (the parity
// rows of the generator) and degraded-read decode (an erasure pattern's
// inverse).
//
// What bounds it on this card: every input byte is read once and every
// output byte written once (for RS(6,3) decode of a 64 MiB block, 64 MiB
// each way, about 40 us at 3.35 TB/s); the rows*cols*8 select-XORs per word
// run on the integer pipes and set the time of this simple version.
//
// Design:
// - The (rows, cols, 8) coefficient bit-planes are a RUNTIME argument,
//   staged into shared memory with each byte replicated into all four byte
//   lanes. One build serves every matrix (the TPU compiled once per
//   matrix); reads of a plane are warp-wide broadcasts.
// - One thread per output word column, four words at a time (uint4 loads
//   and stores) when W is a multiple of 4, else one; the ragged edge of W
//   is masked by the grid-stride bound.
// - For each input row and bit j, the byte mask (bit j of every byte,
//   spread to 0xFF) is built once and applied to every output row of the
//   group, so input rows are loaded once per row group of up to 8.
//   (bits * 0xFF spreads each byte's bit to 0xFF with no carry across
//   bytes: the reference's three shift-OR doublings in one multiply.)

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int kRowGroup = 8;
constexpr uint32_t kByteLsb = 0x01010101u;

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
  static __device__ __forceinline__ void store(uint32_t* p, const uint32_t* x) {
    *reinterpret_cast<uint4*>(p) = make_uint4(x[0], x[1], x[2], x[3]);
  }
};

template <int VEC>
__global__ void __launch_bounds__(kThreads)
gf256_matmul_kernel(const uint32_t* __restrict__ in, long long W, int rows,
                    int cols, const uint32_t* __restrict__ coef,
                    uint32_t* __restrict__ out) {
  extern __shared__ uint32_t s_coef[];  // [rows][cols][8], bytes replicated
  const int ncoef = rows * cols * 8;
  for (int t = threadIdx.x; t < ncoef; t += blockDim.x) {
    s_coef[t] = (coef[t] & 0xFFu) * kByteLsb;
  }
  __syncthreads();

  const long long nvec = W / VEC;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long v = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       v < nvec; v += stride) {
    const long long w0 = v * VEC;
    for (int r0 = 0; r0 < rows; r0 += kRowGroup) {
      const int nr = rows - r0 < kRowGroup ? rows - r0 : kRowGroup;
      uint32_t acc[kRowGroup][VEC];
#pragma unroll
      for (int r = 0; r < kRowGroup; ++r)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[r][e] = 0;
      for (int c = 0; c < cols; ++c) {
        uint32_t x[VEC];
        Vec<VEC>::load(in + c * W + w0, x);
        const uint32_t* plane = s_coef + (r0 * cols + c) * 8;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          uint32_t mask[VEC];
#pragma unroll
          for (int e = 0; e < VEC; ++e) mask[e] = ((x[e] >> j) & kByteLsb) * 0xFFu;
#pragma unroll
          for (int r = 0; r < kRowGroup; ++r) {
            if (r < nr) {
              const uint32_t k = plane[r * cols * 8 + j];
#pragma unroll
              for (int e = 0; e < VEC; ++e) acc[r][e] ^= mask[e] & k;
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRowGroup; ++r) {
        if (r < nr) Vec<VEC>::store(out + (r0 + r) * W + w0, acc[r]);
      }
    }
  }
}

}  // namespace

extern "C" {

// in: (cols, W) uint32; coef: (rows, cols, 8) uint32 holding the byte
// constants mat[r][c] * 2^j; out: (rows, W) uint32. rows * cols * 8 * 4
// bytes must fit in 48 KiB of shared memory. Launches on `stream` and
// returns cudaGetLastError() (0 = launched).
int tpudfs_gf256_matmul(const void* in, long long W, int rows, int cols,
                        const void* coef, void* out, void* stream) {
  int dev = 0;
  int sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const bool vec4 = (W % 4 == 0) &&
                    (reinterpret_cast<uintptr_t>(in) % 16 == 0) &&
                    (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const long long nvec = vec4 ? W / 4 : W;
  long long blocks = (nvec + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sms) * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  const size_t smem = static_cast<size_t>(rows) * cols * 8 * sizeof(uint32_t);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* src = static_cast<const uint32_t*>(in);
  const auto* cf = static_cast<const uint32_t*>(coef);
  auto* dst = static_cast<uint32_t*>(out);
  if (vec4) {
    gf256_matmul_kernel<4><<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
        src, W, rows, cols, cf, dst);
  } else {
    gf256_matmul_kernel<1><<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
        src, W, rows, cols, cf, dst);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* tpudfs_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
