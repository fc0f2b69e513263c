// merge4.cu — fused four-direction 2048 slide+merge for a batch of boards,
// designed for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tpu2048/ops/pallas_merge.py::merge_left_all_dirs
// together with what its wrapper pallas_merge.all_moves does around it (the
// per-direction cell gathers, the scatter back, the legality compare): one
// launch takes (N,4,4) int32 exponent boards and writes every MoveSet field,
//   out_boards  (4,N,4,4) int32  moved (pre-spawn) board per direction
//   scores      (4,N)     int32  merge points, sum of 2^new_exp (int32 wrap;
//                                a term with new_exp >= 32 is 0)
//   max_created (4,N)     int32  largest exponent created (0 if no merge)
//   legal       (4,N)     uint8  1 iff the move changes the board
// with directions 0=UP 1=DOWN 2=LEFT 3=RIGHT, bit-identical to
// tpu2048/env/engine.py::all_moves for every board of exponents >= 0.
//
// Bound. Per board the function reads 64 B and writes 4 x (64+4+4+1) = 292 B,
// 356 B in all: 27 ns for N=256 and 111 us for N=1,048,576 at the H100 SXM's
// 3.35 TB/s. At serving sizes (N <= 4,096) the launch bounds it (a launch
// of an empty-ish kernel takes about 2 us of device time); at large N the
// bytes do. The tensor cores have nothing to offer a compare-and-select
// merge: all the work is on the integer pipes.
//
// Lane layout (both designs). 16 lanes per board, two boards per warp. Lane
// k loads cell k (coalesced 4-byte loads; each board is read once for all
// four directions), then plays the role (direction d = k/4, line l = k%4):
// it gathers its line's four cells from its board's lanes with __shfl_sync,
// compacts them (the prefix count of the Pallas body, pallas_merge.py:80-98,
// as three right-to-left shifts over holes), resolves the three pair cases
// of a compacted line in closed form, and compares with its input for
// legality. Score (sum) and max_created (max) are reduced over the
// direction's four lanes with two __shfl_xor_sync steps, legality (OR) with
// one __ballot_sync. A LEFT/RIGHT lane holds a row and stores it as one
// 16-byte vector; an UP/DOWN lane holds a column and stores its four cells
// as 4-byte words.
//
// Two designs, one entry point (merge4_launch picks by N):
//  * small N (N < kStreamMinBoards = 32,768): one 128-thread block per 8
//    boards, no loop, loads from and stores to global memory directly. N=256
//    spreads over 32 SMs.
//  * large N: a persistent grid (blocks per SM from the occupancy API, the
//    SM count read once per device) walks tiles of 64 boards, or of 128 from
//    kWideTileMinBoards = 262,144, with a grid stride. Thread 0 stages each
//    tile's input (contiguous, tile x 64 B) into shared memory with TMA's
//    1-D bulk copy (cp.async.bulk ... mbarrier::complete_tx::bytes) in a
//    ring of kStages stages under mbarriers, so later tiles' loads are in
//    flight while this one is merged. The moved boards are gathered in
//    shared memory (two stages) and written by TMA bulk stores, one
//    contiguous tile x 64 B stretch per direction; the scores, max_created
//    and legality go through shared memory too and out as block-wide
//    coalesced stores. The ragged last tile copies only its boards.
// Both thresholds are the crossings measured on an NVIDIA H100 80GB HBM3 at
// 700 W (scripts/torch_profile.py, every design forced at each N; PERF.md):
// below 32,768 the small design is faster, from 32,768 the streaming one;
// 64-board tiles (4 blocks per SM) win up to 131,072 boards, 128-board tiles
// (2 blocks per SM) from 524,288, and the two tie at 262,144. Writing the
// boards through shared memory and bulk stores, not straight from the lanes,
// took N=1,048,576 from about 0.19 to 0.14 ms (79% of the byte bound).
//
// Integer work (static SASS, cuobjdump): the first port's kernel (one thread
// per board and direction, bubble compactions) has 1,464 instructions for
// its four directions, 1,376 of them integer (ALU and IMAD), and a board
// costs about that much. Here the small-N kernel has 176 per lane, 127
// integer, about 2,000 per board over 16 lanes; the streaming kernel about
// 110 integer per lane and board, about 1,750 per board. The closed-form
// merge of a line is cheaper (12 instructions of compaction against 54), but
// the 16 lanes repeat the gathers, reductions and addressing the old threads
// shared, so the count per board went up; at 79% of the byte bound it does
// not bound the kernel.
//
// Built by tpu2048_torch/ops/_build.py with nvcc into a shared library with a
// plain C interface, loaded with ctypes. Its launches go to the stream the
// caller passes, so torch.cuda.graph captures them.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <mutex>

namespace {

constexpr int kLanesPerBoard = 16;
constexpr int kSmallThreads = 128;
constexpr int kStreamThreads = 256;
constexpr int kStages = 4;                     // ring of staged input tiles
constexpr int kBoardInts = 16;
// Dynamic shared memory of the streaming kernel for tiles of `tile` boards:
// kStages input tiles, two stages of four directions' moved boards, and the
// three per-board fields of the four directions.
constexpr int stream_smem(int tile) {
  return (kStages + 2 * 4) * tile * kBoardInts * 4 + 4 * tile * (4 + 4 + 1);
}
constexpr int kMaxBlocksPerSm = 4;
constexpr int64_t kStreamMinBoards = 32768;     // from here the streaming design
constexpr int64_t kWideTileMinBoards = 262144;  // from here its 128-board tiles
constexpr int kMaxDevices = 64;

struct Outputs {
  int* boards;       // (4, N, 16)
  int* scores;       // (4, N)
  int* max_created;  // (4, N)
  uint8_t* legal;    // (4, N)
  int64_t n;
};

// 2^e for 0 <= e < 32, else 0: PTX's shl clamps the shift at the width,
// which is what the JAX engine and the plain version give.
__device__ __forceinline__ uint32_t score_term(int e) {
  uint32_t r;
  asm("shl.b32 %0, 1, %1;" : "=r"(r) : "r"(e));
  return r;
}

__device__ __forceinline__ int inc(int x) {
  return static_cast<int>(static_cast<uint32_t>(x) + 1u);
}

// Per-lane constants of the lane layout, computed once per thread.
struct Lane {
  int src[4];          // warp lane holding slot s of this lane's line
  int d, l;            // direction and line of this lane
  int shift;           // first lane of this lane's direction within the warp
};

__device__ __forceinline__ Lane make_lane() {
  Lane ln;
  const int lane = threadIdx.x & 31;
  const int k = lane & 15;
  const int base = lane & 16;  // first lane of this lane's board
  ln.d = k >> 2;
  ln.l = k & 3;
  ln.shift = lane & ~3;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int pos = (ln.d & 1) ? 3 - s : s;  // DOWN and RIGHT start at the far end
    ln.src[s] = base + (ln.d < 2 ? pos * 4 + ln.l : ln.l * 4 + pos);
  }
  return ln;
}

// What a lane knows after the merge: its line, moved (slot order), and its
// direction's score, max_created and legality.
struct LineResult {
  int w0, w1, w2, w3;
  uint32_t score;
  int maxc;
  bool legal;
};

// Merge the board whose cell `x` this lane holds; all 32 lanes of the warp
// take part (lanes past the end of the batch hold zeros).
__device__ __forceinline__ LineResult merge_line(const Lane& ln, int x) {
  const unsigned all = 0xffffffffu;
  const int v0 = __shfl_sync(all, x, ln.src[0]);
  const int v1 = __shfl_sync(all, x, ln.src[1]);
  const int v2 = __shfl_sync(all, x, ln.src[2]);
  const int v3 = __shfl_sync(all, x, ln.src[3]);

  // Compaction, right to left: each step shifts the already compacted
  // suffix one slot left over a hole (3 compares, 9 selects). The prefix
  // count of the Pallas body, in the form that is cheapest here.
  int c0 = v0, c1 = v1, c2 = v2, c3 = v3;
  if (c2 == 0) { c2 = c3; c3 = 0; }
  if (c1 == 0) { c1 = c2; c2 = c3; c3 = 0; }
  if (c0 == 0) { c0 = c1; c1 = c2; c2 = c3; c3 = 0; }

  // The pair cases of a compacted line, left priority, a tile merges once:
  // (c0,c1) merges; else (c1,c2); (c2,c3) unless (c1,c2) merged.
  const bool m01 = c1 != 0 && c0 == c1;
  const bool m12 = !m01 && c2 != 0 && c1 == c2;
  const bool m23 = !m12 && c3 != 0 && c2 == c3;
  const int n0 = inc(c0), n1 = inc(c1), n2 = inc(c2);
  LineResult r;
  r.w0 = m01 ? n0 : c0;
  r.w1 = m01 ? (m23 ? n2 : c2) : (m12 ? n1 : c1);
  r.w2 = m01 ? (m23 ? 0 : c3) : (m12 ? c3 : (m23 ? n2 : c2));
  r.w3 = (m01 || m12 || m23) ? 0 : c3;
  uint32_t score = (m01 ? score_term(n0) : (m12 ? score_term(n1) : 0u)) +
                   (m23 ? score_term(n2) : 0u);
  int maxc = max(m01 ? n0 : (m12 ? n1 : 0), m23 ? n2 : 0);
  // The move changed the line iff something merged or the compaction moved
  // a tile; with equal first three slots the fourth is equal too.
  const bool changed = m01 || m12 || m23 || c0 != v0 || c1 != v1 || c2 != v2;

  // Reduce over the direction's four lanes.
#pragma unroll
  for (int m = 1; m <= 2; m <<= 1) {
    score += __shfl_xor_sync(all, score, m);
    maxc = max(maxc, __shfl_xor_sync(all, maxc, m));
  }
  r.score = score;
  r.maxc = maxc;
  r.legal = (__ballot_sync(all, changed) >> ln.shift) & 0xfu;
  return r;
}

// Store this lane's line into `dst`, the 16 cells of its direction's moved
// board (in global or shared memory).
__device__ __forceinline__ void store_line(const Lane& ln, const LineResult& r, int* dst) {
  if (ln.d >= 2) {  // LEFT/RIGHT: this lane holds row l
    const int4 row = ln.d == 2 ? make_int4(r.w0, r.w1, r.w2, r.w3)
                               : make_int4(r.w3, r.w2, r.w1, r.w0);
    reinterpret_cast<int4*>(dst)[ln.l] = row;
  } else {  // UP/DOWN: this lane holds column l
    const bool up = ln.d == 0;
    dst[ln.l] = up ? r.w0 : r.w3;
    dst[4 + ln.l] = up ? r.w1 : r.w2;
    dst[8 + ln.l] = up ? r.w2 : r.w1;
    dst[12 + ln.l] = up ? r.w3 : r.w0;
  }
}

// Small N: one board per 16 lanes, no loop; lane 0 of each direction stores
// its score, max_created and legality.
__global__ void __launch_bounds__(kSmallThreads)
merge4_small(const int* __restrict__ boards, Outputs o) {
  const Lane ln = make_lane();
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kSmallThreads + threadIdx.x;
  const int64_t i = t / kLanesPerBoard;
  const bool valid = i < o.n;
  const LineResult r = merge_line(ln, valid ? boards[t] : 0);
  if (!valid) return;
  const int64_t j = ln.d * o.n + i;  // row-major index into the (4, N) outputs
  store_line(ln, r, o.boards + j * kBoardInts);
  if (ln.l == 0) {
    o.scores[j] = static_cast<int>(r.score);
    o.max_created[j] = r.maxc;
    o.legal[j] = r.legal;
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Wait for the phase of `bar` with this parity to complete. A copy that never
// lands (which would be a fault of this kernel) traps after some seconds of
// spinning, so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  uint32_t spins = 0;
  do {
    if (++spins == (1u << 30)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// Thread 0: stage `boards` input boards starting at `src` into `dst`.
__device__ __forceinline__ void stage_tile(int* dst, const int* src, int boards,
                                           uint32_t bar) {
  const uint32_t bytes = static_cast<uint32_t>(boards) * kBoardInts * 4;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// Large N: persistent blocks walk tiles with a grid stride. Input tiles are
// staged by TMA bulk copies, kStages ahead. The moved boards of a tile are
// gathered in shared memory (two stages) and written by TMA bulk stores, one
// contiguous tile x 64 B stretch per direction. The 4-byte and 1-byte fields
// are gathered in shared memory too and written by the whole block,
// consecutive threads on consecutive boards.
template <int kTileBoards>
__global__ void __launch_bounds__(kStreamThreads)
merge4_stream(const int* __restrict__ boards, Outputs o) {
  // [kStages][tile in] [2][4][tile out] [4][tile] scores, max_created, legal
  extern __shared__ __align__(128) int smem[];
  __shared__ __align__(8) uint64_t full[kStages];
  constexpr int kTileInts = kTileBoards * kBoardInts;
  int* const outs = smem + kStages * kTileInts;
  int* const f_scores = outs + 2 * 4 * kTileInts;
  int* const f_maxc = f_scores + 4 * kTileBoards;
  uint8_t* const f_legal = reinterpret_cast<uint8_t*>(f_maxc + 4 * kTileBoards);
  const int64_t num_tiles = (o.n + kTileBoards - 1) / kTileBoards;
  const auto tile_boards = [&](int64_t t) {
    const int64_t left = o.n - t * kTileBoards;
    return left < kTileBoards ? static_cast<int>(left) : kTileBoards;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   :: "r"(smem_addr(&full[s])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < kStages; ++s) {
      const int64_t t = blockIdx.x + static_cast<int64_t>(s) * gridDim.x;
      if (t < num_tiles)
        stage_tile(smem + s * kTileInts, boards + t * kTileInts, tile_boards(t),
                   smem_addr(&full[s]));
    }
  }
  __syncthreads();

  const Lane ln = make_lane();
  const int board_in_pass = threadIdx.x / kLanesPerBoard;
  const int cell = threadIdx.x % kLanesPerBoard;
  constexpr int kBoardsPerPass = kStreamThreads / kLanesPerBoard;
  int k = 0;
  for (int64_t t = blockIdx.x; t < num_tiles; t += gridDim.x, ++k) {
    const int stage = k % kStages;
    int* const tile = smem + stage * kTileInts;
    int* const out = outs + (k & 1) * 4 * kTileInts;
    // The bulk stores of tile k-2 must be done reading this out stage (and
    // every thread done with the fields of tile k-1).
    if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
    __syncthreads();
    mbar_wait(smem_addr(&full[stage]), (k / kStages) & 1);
    const int count = tile_boards(t);
#pragma unroll
    for (int pass = 0; pass < kTileBoards / kBoardsPerPass; ++pass) {
      const int b = pass * kBoardsPerPass + board_in_pass;
      const bool valid = b < count;
      const LineResult r = merge_line(ln, valid ? tile[b * kBoardInts + cell] : 0);
      if (valid) {
        store_line(ln, r, out + (ln.d * kTileBoards + b) * kBoardInts);
        if (ln.l == 0) {
          f_scores[ln.d * kTileBoards + b] = static_cast<int>(r.score);
          f_maxc[ln.d * kTileBoards + b] = r.maxc;
          f_legal[ln.d * kTileBoards + b] = r.legal;
        }
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // this input stage is read, the out stage written
    if (threadIdx.x == 0) {
      for (int d = 0; d < 4; ++d)
        asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
                     :: "l"(o.boards + (d * o.n + t * kTileBoards) * kBoardInts),
                        "r"(smem_addr(out + d * kTileInts)),
                        "r"(static_cast<uint32_t>(count) * kBoardInts * 4)
                     : "memory");
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      const int64_t next = t + static_cast<int64_t>(kStages) * gridDim.x;
      if (next < num_tiles)
        stage_tile(tile, boards + next * kTileInts, tile_boards(next),
                   smem_addr(&full[stage]));
    }
    for (int f = threadIdx.x; f < 4 * kTileBoards; f += kStreamThreads) {
      const int d = f / kTileBoards, b = f % kTileBoards;
      if (b < count) {
        const int64_t j = d * o.n + t * kTileBoards + b;
        o.scores[j] = f_scores[f];
        o.max_created[j] = f_maxc[f];
        o.legal[j] = f_legal[f];
      }
    }
  }
  if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Per device: how many blocks of each persistent kernel fill the card (the
// SM count times the blocks that fit on an SM, at most kMaxBlocksPerSm),
// found once; 0 until then.
struct DeviceState {
  int64_t blocks64 = 0, blocks128 = 0;
};
DeviceState g_devices[kMaxDevices];
std::mutex g_init_lock;

// Allow the persistent kernel on tiles of kTile boards its shared memory
// (above the 48 KB default), and count the blocks that fill the card.
template <int kTile>
cudaError_t persistent_blocks(int64_t* blocks, int sms) {
  auto* const fn = &merge4_stream<kTile>;
  cudaError_t e;
  int per_sm = 0;
  if ((e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                stream_smem(kTile))) ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kStreamThreads,
                                                         stream_smem(kTile))))
    return e;
  *blocks = static_cast<int64_t>(sms) * std::max(1, std::min(per_sm, kMaxBlocksPerSm));
  return cudaSuccess;
}

cudaError_t device_state(DeviceState* out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> guard(g_init_lock);
  DeviceState& st = g_devices[dev];
  if (st.blocks64 == 0) {
    DeviceState fresh;
    int sms = 0;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) ||
        (e = persistent_blocks<64>(&fresh.blocks64, sms)) ||
        (e = persistent_blocks<128>(&fresh.blocks128, sms)))
      return e;
    st = fresh;
  }
  *out = st;
  return cudaSuccess;
}

}  // namespace

// Launch on `stream` (a cudaStream_t) without synchronising. Pointers are
// device pointers to contiguous buffers, `boards` and `out_boards` 16-byte
// aligned. `path`: 0 picks by N, 1 forces the small-N kernel, 2 the
// streaming kernel on 64-board tiles, 3 on 128-board tiles (for
// measurement). Returns cudaGetLastError() as an int: 0 when the launch was
// taken.
extern "C" int merge4_launch(const void* boards, void* out_boards, void* scores,
                             void* max_created, void* legal, int64_t n,
                             void* stream, int path) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  DeviceState st;
  if (cudaError_t e = device_state(&st)) return static_cast<int>(e);
  const Outputs o{static_cast<int*>(out_boards), static_cast<int*>(scores),
                  static_cast<int*>(max_created), static_cast<uint8_t*>(legal), n};
  const int* in = static_cast<const int*>(boards);
  const auto s = static_cast<cudaStream_t>(stream);
  if (path == 0) path = n < kStreamMinBoards ? 1 : n < kWideTileMinBoards ? 2 : 3;
  if (path == 1) {
    const int64_t blocks = (n * kLanesPerBoard + kSmallThreads - 1) / kSmallThreads;
    if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    merge4_small<<<static_cast<unsigned>(blocks), kSmallThreads, 0, s>>>(in, o);
  } else if (path == 2) {
    const int64_t blocks = std::min<int64_t>((n + 63) / 64, st.blocks64);
    merge4_stream<64><<<static_cast<unsigned>(blocks), kStreamThreads, stream_smem(64), s>>>(in, o);
  } else {
    const int64_t blocks = std::min<int64_t>((n + 127) / 128, st.blocks128);
    merge4_stream<128><<<static_cast<unsigned>(blocks), kStreamThreads, stream_smem(128), s>>>(in, o);
  }
  return static_cast<int>(cudaGetLastError());
}

// The N at which merge4_launch moves to the streaming design, and to its
// 128-board tiles.
extern "C" void merge4_path_thresholds(int64_t* stream_min, int64_t* wide_tile_min) {
  *stream_min = kStreamMinBoards;
  *wide_tile_min = kWideTileMinBoards;
}

extern "C" const char* merge4_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
