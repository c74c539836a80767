// Design probe for the CRC32C kernel (crc32c.cu), on no path of the port:
// the textbook slice-by-8 CRC32C with one lane per 512-byte chunk, which
// crc32c.cu's positional nibble tables were chosen over. Run by
// tpudfs_torch/gpu/probe_crc32c.py, which times both on the card.
//
// Two variants of the loads, the same arithmetic (8 byte tables, 8 KiB, in
// shared memory; the lanes' table indices are data-dependent, so a warp's
// lookup is served in as many passes as the busiest bank needs):
// - direct: each lane reads its own chunk from device memory, 16 bytes a
//   step, 512 bytes apart across the warp;
// - staged: each warp first copies its 32 chunks (16 KiB) into shared
//   memory with coalesced loads, rows padded by 16 bytes so that the lanes'
//   16-byte reads fall in distinct banks, then computes from there.
// And the memory side alone: stream_chunks reads the chunks as a warp per
// chunk with no table lookup, in crc32c.cu's order (a tile of 32 chunks per
// warp, 4 chunks loaded ahead) and in others; dynamic_smem_base reports
// where dynamic shared memory starts.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kDirectThreads = 256;
constexpr int kStagedThreads = 128;  // 4 warps x 16.5 KiB of staged chunks
constexpr int kRow = 132;            // staged words per chunk (128 + pad)

__device__ __forceinline__ uint32_t step8(const uint32_t* t, uint32_t crc,
                                          uint32_t lo, uint32_t hi) {
  crc ^= lo;
  return t[7 * 256 + (crc & 0xff)] ^ t[6 * 256 + ((crc >> 8) & 0xff)] ^
         t[5 * 256 + ((crc >> 16) & 0xff)] ^ t[4 * 256 + (crc >> 24)] ^
         t[3 * 256 + (hi & 0xff)] ^ t[2 * 256 + ((hi >> 8) & 0xff)] ^
         t[256 + ((hi >> 16) & 0xff)] ^ t[hi >> 24];
}

__device__ __forceinline__ void load_tables(uint32_t* s, const uint32_t* g) {
  for (int i = threadIdx.x; i < 8 * 256; i += blockDim.x) s[i] = g[i];
  __syncthreads();
}

__global__ void __launch_bounds__(kDirectThreads)
slice8_direct(const uint4* words, long long nchunks, const uint32_t* tables,
              uint32_t* out) {
  __shared__ uint32_t t[8 * 256];
  load_tables(t, tables);
  const long long n = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long c = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       c < nchunks; c += n) {
    const uint4* p = words + c * 32;
    uint32_t crc = 0xffffffffu;
#pragma unroll 4
    for (int q = 0; q < 32; ++q) {
      const uint4 v = p[q];
      crc = step8(t, crc, v.x, v.y);
      crc = step8(t, crc, v.z, v.w);
    }
    out[c] = ~crc;
  }
}

__global__ void __launch_bounds__(kStagedThreads)
slice8_staged(const uint4* words, long long nchunks, const uint32_t* tables,
              uint32_t* out) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* t = smem;
  load_tables(t, tables);
  const int lane = threadIdx.x & 31;
  uint32_t* rows = smem + 8 * 256 + (threadIdx.x >> 5) * 32 * kRow;
  const long long nw = static_cast<long long>(gridDim.x) * (blockDim.x / 32);
  for (long long w = static_cast<long long>(blockIdx.x) * (blockDim.x / 32) +
                     (threadIdx.x >> 5);
       w * 32 < nchunks; w += nw) {
    const long long c0 = w * 32;
    const int nk = nchunks - c0 < 32 ? static_cast<int>(nchunks - c0) : 32;
    for (int r = 0; r < nk; ++r) {
      *reinterpret_cast<uint4*>(rows + r * kRow + 4 * lane) =
          words[(c0 + r) * 32 + lane];
    }
    __syncwarp();
    if (lane < nk) {
      const uint32_t* p = rows + lane * kRow;
      uint32_t crc = 0xffffffffu;
#pragma unroll 4
      for (int q = 0; q < 32; ++q) {
        const uint4 v = *reinterpret_cast<const uint4*>(p + 4 * q);
        crc = step8(t, crc, v.x, v.y);
        crc = step8(t, crc, v.z, v.w);
      }
      out[c0 + lane] = ~crc;
    }
    __syncwarp();
  }
}

// Loads only: the XOR of chunks src[k * step], k < nk (this lane's 16
// bytes), kAhead chunks loaded ahead; lane k % 32 keeps chunk k's.
template <int kAhead>
__device__ __forceinline__ uint32_t stream_run(const uint4* src, long long step,
                                               int nk, int lane) {
  uint32_t mine = 0;
  uint4 nxt[kAhead];
#pragma unroll
  for (int u = 0; u < kAhead; ++u)
    nxt[u] = u < nk ? src[u * step] : make_uint4(0, 0, 0, 0);
  for (int k = 0; k < nk; k += kAhead) {
    uint4 cur[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      cur[u] = nxt[u];
      nxt[u] = k + kAhead + u < nk ? src[(k + kAhead + u) * step]
                                   : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      uint32_t x = cur[u].x ^ cur[u].y ^ cur[u].z ^ cur[u].w;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) x ^= __shfl_xor_sync(~0u, x, off);
      if (k + u < nk && lane == ((k + u) & 31)) mine ^= x;
    }
  }
  return mine;
}

// A warp per chunk, 2 blocks of 512 threads per SM. kTiles: each warp walks
// tiles of 32 consecutive chunks (crc32c.cu's order); else warp w reads
// chunks w, w + W, w + 2W, ... (W warps in all).
template <int kAhead, bool kTiles, bool kDown = false>
__global__ void __launch_bounds__(512, 2)
stream_chunks(const uint4* words, long long nchunks, uint32_t* out) {
  const int lane = threadIdx.x & 31;
  const long long nw = static_cast<long long>(gridDim.x) * 16;
  const long long w0 = blockIdx.x * 16LL + (threadIdx.x >> 5);
  if (kTiles) {
    for (long long c0 = w0 * 32; c0 < nchunks; c0 += nw * 32) {
      const int nk = nchunks - c0 < 32 ? static_cast<int>(nchunks - c0) : 32;
      // kDown: the tile's chunks from its last to its first.
      const uint32_t x = stream_run<kAhead>(
          words + (kDown ? c0 + nk - 1 : c0) * 32 + lane, kDown ? -32 : 32, nk,
          lane);
      if (lane < nk) out[c0 + lane] = x;
    }
  } else if (w0 < nchunks) {
    const int nk = static_cast<int>((nchunks - w0 + nw - 1) / nw);
    const uint32_t x = stream_run<kAhead>(words + w0 * 32 + lane, nw * 32, nk,
                                          lane);
    if (w0 * 32 + lane < nchunks) out[w0 * 32 + lane] = x;
  }
}

// The shared-space address of the dynamic shared memory.
__global__ void dynamic_smem_base(uint32_t* out) {
  extern __shared__ uint32_t smem[];
  smem[threadIdx.x] = 0;
  if (threadIdx.x == 0) out[0] = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
}

int sm_count() {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

}  // namespace

extern "C" {

// words: (nchunks, 128) uint32; tables: (8, 256) uint32 slice-by-8 tables;
// out: (nchunks,) uint32 CRC32C. variant: 0 direct,
// 1 staged; loads only (out is not a CRC): 2 tiles with 4 ahead, 3 tiles
// with 8 ahead, 4 striding with 4 ahead, 5 striding with 8 ahead, 6 tiles
// with 4 ahead read from each tile's last chunk down (the fused order); 9 writes
// the dynamic shared memory's base address to out[0].
// Returns a CUDA error code (0 = launched).
int tpudfs_crc32c_slice8_probe(const void* words, long long nchunks,
                               const void* tables, int variant, void* out,
                               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint4* w = static_cast<const uint4*>(words);
  const uint32_t* t = static_cast<const uint32_t*>(tables);
  uint32_t* o = static_cast<uint32_t*>(out);
  if (variant >= 2 && variant <= 6) {
    long long blocks = (nchunks + 511) / 512;
    if (blocks > sm_count() * 2LL) blocks = sm_count() * 2LL;
    if (blocks < 1) blocks = 1;
    const unsigned g = static_cast<unsigned>(blocks);
    if (variant == 2) stream_chunks<4, true><<<g, 512, 0, s>>>(w, nchunks, o);
    if (variant == 3) stream_chunks<8, true><<<g, 512, 0, s>>>(w, nchunks, o);
    if (variant == 4) stream_chunks<4, false><<<g, 512, 0, s>>>(w, nchunks, o);
    if (variant == 5) stream_chunks<8, false><<<g, 512, 0, s>>>(w, nchunks, o);
    if (variant == 6) stream_chunks<4, true, true><<<g, 512, 0, s>>>(w, nchunks, o);
    return static_cast<int>(cudaGetLastError());
  }
  if (variant == 9) {
    dynamic_smem_base<<<1, 32, 1024, s>>>(o);
    return static_cast<int>(cudaGetLastError());
  }
  if (variant == 0) {
    long long blocks = (nchunks + kDirectThreads - 1) / kDirectThreads;
    if (blocks > sm_count() * 8LL) blocks = sm_count() * 8LL;
    if (blocks < 1) blocks = 1;
    slice8_direct<<<static_cast<unsigned>(blocks), kDirectThreads, 0, s>>>(
        w, nchunks, t, o);
    return static_cast<int>(cudaGetLastError());
  }
  const int smem = 4 * (8 * 256 + (kStagedThreads / 32) * 32 * kRow);
  cudaError_t err = cudaFuncSetAttribute(
      slice8_staged, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long blocks = (nchunks + kStagedThreads - 1) / kStagedThreads;
  if (blocks > sm_count() * 3LL) blocks = sm_count() * 3LL;
  if (blocks < 1) blocks = 1;
  slice8_staged<<<static_cast<unsigned>(blocks), kStagedThreads, smem, s>>>(
      w, nchunks, t, o);
  return static_cast<int>(cudaGetLastError());
}

const char* tpudfs_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
