// CRC32C on Hopper (sm_90a): per-512-byte-chunk CRCs, and the whole-block
// CRC of equal-length blocks fused into the same launch.
//
// Replaces the TPU kernel tpudfs/tpu/crc32c_pallas.py::_crc_pallas and, in
// crc32c_blocks, the XLA combine-fold that block_crc_device and
// batch_block_crc_device run after it. CRC is linear over GF(2):
//
//   crc(chunk) = ~(INV ^ XOR_{w<128, b<32} [bit b of word w] * WCONTRIB[b][w])
//   crc(block) = XOR_{i<n} M^(n-1-i) crc(chunk i)
//
// where M advances a CRC register across 512 zero bytes.
//
// What bounds it on this card: the data is read once (64 MiB per block,
// about 20 us at 3.35 TB/s). The TPU's bit-plane form (32 select-XORs per
// word) made the integer pipes and shared-memory reads, not HBM, set the
// time, at about 6x the byte bound on an H100. Here a table lookup covers
// a nibble, so a chunk costs 1,024 lookups free of bank conflicts (32 a
// lane) instead of 4,096 select-XORs, and the kernel runs within about
// 1.2x of its loads alone, which take about 1.25x the byte bound at this
// access pattern (both timed with CUDA events on an H100 80GB HBM3 at
// 700 W, the loads by a kernel that computes no CRC).
//
// Design:
// - One warp per chunk: lane l loads words 4l..4l+3 as one uint4, so a
//   warp's load is one coalesced 512-byte transaction. A warp walks a tile
//   of 32 chunks and loads the next 4 chunks while it computes the current 4.
// - Positional nibble tables in shared memory (64 KiB), built by each
//   thread block from WCONTRIB in its prologue:
//     tab[i][j][v][l] = XOR_{bit b of v} WCONTRIB[4j+b][4l+i]
//   Lane l reads only column l, so any nibble values hit 32 distinct banks.
//   Even and odd nibbles are laid out with value strides of 128 and 2048
//   bytes, so one shift serves two lookups (see word_xor).
//   The lanes' partial XORs meet in a __shfl_xor_sync butterfly.
// - A warp's first loads are issued before the prologue builds the tables,
//   and the next tile's first loads before the current tile's epilogue.
// - The fused whole-block CRC: tiles are counted from the block's end, so
//   lane k of tile t keeps the CRC of the chunk at distance d = 32t + k
//   from the end. Lane k applies M^k (per-lane nibble tables, conflict
//   free), a butterfly XORs the 32 lanes, and M^(32t) is composed from the
//   operators M^(32*2^q) for the set bits q of t (8 lanes look up one
//   nibble each, three shuffles combine them). Lane 0 XORs the tile's word
//   into the block's output with atomicXor on an output zeroed before the
//   launch: XOR is order-free, so the result is exact and deterministic.
//   No per-chunk CRC reaches device memory and nothing is folded after the
//   kernel.
// - The operators' columns come either from the (cpb, 32) combine-fold
//   table (row cpb-1-d holds M^d; only the needed rows are read) or from a
//   compact array (rows 0..31: M^0..M^31; row 32+q: M^(32*2^q)).
//   Every table is derived in the prologue from the arrays the caller
//   passes, so a caller's WCONTRIB, INV or fold table drives the result.
// - A grid of at most 2 thread blocks of 512 threads per SM (shared memory
//   allows two), each warp striding over tiles.
// The TPU's 256-chunk tiling and sequential grid are not carried over.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;  // 16 warps
constexpr int kWarps = kThreads / 32;
constexpr int kCtasPerSm = 2;
constexpr int kGroup = 4;                     // chunks loaded ahead per warp
constexpr int kChunkTab = 4 * 8 * 16 * 32;    // words: [i][j][v][lane]
constexpr int kOddBase = kChunkTab / 2;       // words: the odd nibbles' half
constexpr int kLaneTab = 8 * 16 * 32;         // words: [j][v][lane]
constexpr int kAdvTab = 8 * 16;               // words per operator: [j][v]
constexpr int kCompactRows = 32 + 27;         // M^0..M^31, M^(32*2^q) q<27
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;

struct Args {
  const uint4* words;
  long long cpb;     // chunks per block (fused); all chunks otherwise
  long long tpb;     // tiles per block
  long long ntiles;  // tiles in all
  const uint32_t* wcontrib;  // (32, 128)
  const uint32_t* ops;       // fold table (cpb, 32) or compact (59, 32)
  int from_fold;
  int nadv;                  // advance operators needed: bit length of tpb-1
  uint32_t final_xor;        // INV ^ 0xFFFFFFFF
  uint32_t* out;
};

// out[v * stride] = XOR of c[b] over the set bits b of v, for v < 16.
__device__ __forceinline__ void nibble_entries(const uint32_t* c, int cstride,
                                               uint32_t* out, int stride) {
  const uint32_t c0 = c[0], c1 = c[cstride], c2 = c[2 * cstride],
                 c3 = c[3 * cstride];
#pragma unroll
  for (int v = 0; v < 16; ++v) {
    uint32_t e = 0;
    if (v & 1) e ^= c0;
    if (v & 2) e ^= c1;
    if (v & 4) e ^= c2;
    if (v & 8) e ^= c3;
    out[v * stride] = e;
  }
}

// Word i of lane l's four: XOR over its nibbles j of tab[i][j][nibble][l].
// The even nibbles j = 2p lie at word (i*4 + p)*512 + v*32 + l, the odd
// ones j = 2p+1 at kOddBase + v*512 + (i*4 + p)*32 + l. One shift of x by
// 8p - 7 puts nibble 2p at bits 7..10 (v * 128 bytes, the even stride) and
// nibble 2p+1 at bits 11..14 (v * 2048 bytes, the odd stride): two lookups
// share a shift, and OR-ing in the lane's byte offset (bits 2..6) finishes
// each address.
template <int I>
__device__ __forceinline__ uint32_t word_xor(const unsigned char* tab,
                                             uint32_t lane4, uint32_t x) {
  uint32_t acc = 0;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const uint32_t y = p == 0 ? x << 7 : x >> (8 * p - 7);
    const int k = I * 4 + p;
    acc ^= *reinterpret_cast<const uint32_t*>(tab + (k << 11) +
                                              ((y & 0x780u) | lane4)) ^
           *reinterpret_cast<const uint32_t*>(tab + kOddBase * 4 + (k << 7) +
                                              ((y & 0x7800u) | lane4));
  }
  return acc;
}

__device__ __forceinline__ uint32_t chunk_partial(const unsigned char* tab,
                                                  uint32_t lane4, uint4 v) {
  return word_xor<0>(tab, lane4, v.x) ^ word_xor<1>(tab, lane4, v.y) ^
         word_xor<2>(tab, lane4, v.z) ^ word_xor<3>(tab, lane4, v.w);
}

// Lane l's M^l applied to x: XOR over the nibbles j of x of the lane
// table's entry at word (j*16 + nibble)*32 + l.
__device__ __forceinline__ uint32_t lane_op(const unsigned char* ltab,
                                            uint32_t lane4, uint32_t x) {
  uint32_t acc = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint32_t nib = j >= 2 ? (x >> (4 * j - 7)) & 0x780u
                                : (x << (7 - 4 * j)) & 0x780u;
    acc ^= *reinterpret_cast<const uint32_t*>(ltab + (j << 11) + (nib | lane4));
  }
  return acc;
}

__device__ __forceinline__ uint32_t warp_xor(uint32_t v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v ^= __shfl_xor_sync(kFull, v, off);
  return v;
}

// Warp-uniform x -> op(x) with op's nibble table tab[j][v]: lane l looks up
// nibble l % 8 and each group of 8 lanes XORs its eight entries.
__device__ __forceinline__ uint32_t apply_op(const uint32_t* tab, int lane,
                                             uint32_t x) {
  const int j = lane & 7;
  uint32_t e = tab[j * 16 + ((x >> (4 * j)) & 15u)];
  e ^= __shfl_xor_sync(kFull, e, 1);
  e ^= __shfl_xor_sync(kFull, e, 2);
  e ^= __shfl_xor_sync(kFull, e, 4);
  return e;
}

// Columns of M^dist: the fold table's row cpb-1-dist, or compact row `row`.
__device__ __forceinline__ const uint32_t* op_columns(const Args& a,
                                                      long long dist, int row) {
  return a.from_fold ? a.ops + (a.cpb - 1 - dist) * 32 : a.ops + row * 32;
}

// One warp's tile: chunk k is src[k * stride] (this lane's 16 bytes).
struct Tile {
  const uint4* src;
  long long stride;
  long long blk;   // block (fused)
  long long t;     // tile index within the block
  long long first; // row of chunk 0
  int nk;          // chunks in the tile
};

template <bool kFused>
__device__ __forceinline__ Tile tile_at(const Args& a, long long tile,
                                        int lane) {
  Tile tl;
  tl.blk = kFused ? tile / a.tpb : 0;
  tl.t = tile - tl.blk * a.tpb;
  // Fused: tiles count from the block's end, chunk k at distance 32t + k.
  tl.first = kFused ? tl.blk * a.cpb + a.cpb - 1 - 32 * tl.t : 32 * tile;
  tl.stride = kFused ? -32 : 32;
  const long long left = a.cpb - 32 * tl.t;
  tl.nk = left < 32 ? static_cast<int>(left) : 32;
  tl.src = a.words + tl.first * 32 + lane;
  return tl;
}

__device__ __forceinline__ void load_group(uint4 (&dst)[kGroup], const Tile& tl,
                                           int k0) {
#pragma unroll
  for (int u = 0; u < kGroup; ++u) {
    dst[u] = k0 + u < tl.nk ? tl.src[(k0 + u) * tl.stride]
                            : make_uint4(0, 0, 0, 0);
  }
}

template <bool kFused>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
crc32c_kernel(const Args a) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* s_chunk = smem;
  uint32_t* s_lane = smem + kChunkTab;
  uint32_t* s_adv = s_lane + kLaneTab;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const long long nwarps = static_cast<long long>(gridDim.x) * kWarps;
  long long tile = static_cast<long long>(blockIdx.x) * kWarps + (tid >> 5);

  // The first loads fly while the tables are built.
  Tile tl{};
  uint4 nxt[kGroup];
  if (tile < a.ntiles) {
    tl = tile_at<kFused>(a, tile, lane);
    load_group(nxt, tl, 0);
  }

  for (int g = tid; g < 4 * 8 * 32; g += kThreads) {
    const int l = g & 31, i = g >> 8, j = (g >> 5) & 7;
    const int k = i * 4 + (j >> 1);
    nibble_entries(a.wcontrib + (4 * j) * 128 + 4 * l + i, 128,
                   (j & 1) ? s_chunk + kOddBase + k * 32 + l
                           : s_chunk + k * 512 + l,
                   (j & 1) ? 512 : 32);
  }
  if (kFused) {
    for (int g = tid; g < 8 * 32; g += kThreads) {
      const int l = g & 31, j = g >> 5;
      if (l < a.cpb) {
        nibble_entries(op_columns(a, l, l) + 4 * j, 1,
                       s_lane + j * 16 * 32 + l, 32);
      } else {  // no chunk lies at this distance
        for (int v = 0; v < 16; ++v) s_lane[(j * 16 + v) * 32 + l] = 0;
      }
    }
    for (int g = tid; g < a.nadv * 8; g += kThreads) {
      const int q = g >> 3, j = g & 7;
      nibble_entries(op_columns(a, 32LL << q, 32 + q) + 4 * j, 1,
                     s_adv + q * kAdvTab + j * 16, 1);
    }
  }
  __syncthreads();

  const unsigned char* tab = reinterpret_cast<const unsigned char*>(s_chunk);
  const unsigned char* ltab = reinterpret_cast<const unsigned char*>(s_lane);
  const uint32_t lane4 = static_cast<uint32_t>(lane) * 4;
  while (tile < a.ntiles) {
    uint32_t mine = 0;  // lane k: the CRC of the tile's chunk k
    for (int k = 0; k < tl.nk; k += kGroup) {
      uint4 cur[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) cur[u] = nxt[u];
      if (k + kGroup < tl.nk) load_group(nxt, tl, k + kGroup);
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const uint32_t crc = warp_xor(chunk_partial(tab, lane4, cur[u]));
        if (lane == k + u && k + u < tl.nk) mine = crc ^ a.final_xor;
      }
    }
    const Tile done = tl;
    tile += nwarps;
    if (tile < a.ntiles) {
      tl = tile_at<kFused>(a, tile, lane);
      load_group(nxt, tl, 0);
    }

    if (!kFused) {
      if (lane < done.nk) a.out[done.first + lane] = mine;
      continue;
    }
    // Lane k holds the CRC of the chunk at distance 32t + k: apply M^k,
    // XOR the lanes, then advance the tile's word by M^(32t).
    uint32_t word = warp_xor(lane_op(ltab, lane4, mine));
    for (int q = 0; (done.t >> q) != 0; ++q) {
      if ((done.t >> q) & 1) word = apply_op(s_adv + q * kAdvTab, lane, word);
    }
    if (lane == 0) atomicXor(a.out + done.blk, word);
  }
}

// The SM count and the shared memory each kernel was allowed, per device,
// queried or set once (the host's share of a launch is most of a small
// block's verify).
std::atomic<int> g_sms[kMaxDevices];

template <bool kFused>
int launch(const Args& a, cudaStream_t stream) {
  static std::atomic<int> allowed[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  int sms = g_sms[dev].load();
  if (sms == 0) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    g_sms[dev].store(sms);
  }
  const int smem = 4 * (kChunkTab + (kFused ? kLaneTab + a.nadv * kAdvTab : 0));
  if (allowed[dev].load() < smem) {
    err = cudaFuncSetAttribute(crc32c_kernel<kFused>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed[dev].store(smem);
  }
  long long blocks = (a.ntiles + kWarps - 1) / kWarps;
  const long long cap = static_cast<long long>(sms) * kCtasPerSm;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  crc32c_kernel<kFused><<<static_cast<unsigned>(blocks), kThreads, smem,
                          stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int bit_length(long long x) {
  int n = 0;
  while (x > 0) {
    ++n;
    x >>= 1;
  }
  return n;
}

}  // namespace

extern "C" {

// words: (nchunks, 128) uint32, 16-byte aligned; wcontrib: (32, 128) uint32;
// out: (nchunks,) uint32. final_xor = inv_contrib ^ 0xFFFFFFFF. Launches on
// `stream` and returns a CUDA error code (0 = launched).
int tpudfs_crc32c_chunks(const void* words, long long nchunks,
                         const void* wcontrib, unsigned int final_xor,
                         void* out, void* stream) {
  Args a{};
  a.words = static_cast<const uint4*>(words);
  a.cpb = nchunks;
  a.ntiles = (nchunks + 31) / 32;
  a.tpb = a.ntiles;
  a.wcontrib = static_cast<const uint32_t*>(wcontrib);
  a.final_xor = final_xor;
  a.out = static_cast<uint32_t*>(out);
  return launch<false>(a, static_cast<cudaStream_t>(stream));
}

// Whole-block CRC32C of `nblocks` blocks of `cpb` chunks each, laid out
// contiguously in words (nblocks * cpb, 128) -> out (nblocks,) uint32.
// ops: the (cpb, 32) combine-fold table when from_fold is 1, else the
// compact (59, 32) operator array. Zeroes `out` on `stream`, then launches
// once; returns a CUDA error code (0 = launched).
int tpudfs_crc32c_blocks(const void* words, long long nblocks, long long cpb,
                         const void* wcontrib, unsigned int final_xor,
                         const void* ops, int from_fold, void* out,
                         void* stream) {
  Args a{};
  a.words = static_cast<const uint4*>(words);
  a.cpb = cpb;
  a.tpb = (cpb + 31) / 32;
  a.ntiles = nblocks * a.tpb;
  a.wcontrib = static_cast<const uint32_t*>(wcontrib);
  a.ops = static_cast<const uint32_t*>(ops);
  a.from_fold = from_fold;
  a.nadv = bit_length(a.tpb - 1);
  a.final_xor = final_xor;
  a.out = static_cast<uint32_t*>(out);
  if (!from_fold && a.nadv > kCompactRows - 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      cudaMemsetAsync(out, 0, static_cast<size_t>(nblocks) * 4, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch<true>(a, s);
}

const char* tpudfs_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
