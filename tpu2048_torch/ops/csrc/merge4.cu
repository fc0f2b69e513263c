// merge4.cu — fused four-direction 2048 slide+merge for a batch of boards.
//
// Replaces the Pallas TPU kernel tpu2048/ops/pallas_merge.py::merge_left_all_dirs
// together with what its wrapper pallas_merge.all_moves does around it (the
// per-direction cell gathers, the scatter back, the legality compare): one
// launch takes (N,4,4) int32 exponent boards and writes every MoveSet field,
//   out_boards  (4,N,4,4) int32  moved (pre-spawn) board per direction
//   scores      (4,N)     int32  merge points, sum of 2^new_exp
//   max_created (4,N)     int32  largest exponent created (0 if no merge)
//   legal       (4,N)     uint8  1 iff the move changes the board
// with directions 0=UP 1=DOWN 2=LEFT 3=RIGHT, bit-identical to
// tpu2048/env/engine.py::all_moves.
//
// Bound: bytes. Per board the function reads 64 B and writes
// 4 x (64 + 4 + 4 + 1) = 292 B, 356 B in all: at the H100 SXM's 3.35 TB/s that
// is 27 ns for N=256 (a served batch, an eval step) and 7 us for N=65,536.
// The integer work (some twenty compares and selects per line) is far below
// the card's integer rate, and at serving sizes the launch itself dominates.
//
// Design: one thread per (board, direction). blockIdx.y is the direction, so
// the direction's cell order is a template argument and every cell index is a
// compile-time constant: the 16 cells stay in registers. A thread loads its
// board as four 16-byte vectors, runs the four line merges of
// engine.merge_lines_left (compact, left-priority merge in which a tile merges
// at most once, compact), compares the result with the input for legality, and
// stores the moved board as four 16-byte vectors. The TPU kernel's cell-major
// (16,N) layout and roll/select sweeps served the TPU's (8,128) tiles and are
// not carried over.
//
// Built by tpu2048_torch/ops/_build.py with nvcc into a shared library with a
// plain C interface (merge4_launch), loaded with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// Flat cell (row * 4 + col) of slot `s` of line `l` when moving in direction
// D; slot 0 is the cell the line's tiles slide toward.
template <int D>
__device__ __forceinline__ int cell(int l, int s) {
  return D == 0   ? s * 4 + l            // UP: columns, top first
         : D == 1 ? (3 - s) * 4 + l      // DOWN: columns, bottom first
         : D == 2 ? l * 4 + s            // LEFT: rows, left first
                  : l * 4 + (3 - s);     // RIGHT: rows, right first
}

// Slide the nonzero tiles of a line to its front, keeping their order: the
// three bubble passes of engine.merge_lines_left's compress.
__device__ __forceinline__ void compact(int& a, int& b, int& c, int& d) {
#pragma unroll
  for (int pass = 0; pass < 3; ++pass) {
    if (a == 0) { a = b; b = 0; }
    if (b == 0) { b = c; c = 0; }
    if (c == 0) { c = d; d = 0; }
  }
}

// Merge a pair of neighbours; zeroing the right one keeps a new tile from
// merging again in the same move.
__device__ __forceinline__ void merge_pair(int& x, int& y, int& score,
                                           int& max_created) {
  if (x != 0 && x == y) {
    x += 1;
    y = 0;
    score += static_cast<int>(1u << x);
    max_created = max(max_created, x);
  }
}

template <int D>
__device__ __forceinline__ void move_one(const int4* __restrict__ boards,
                                         int4* __restrict__ out_boards,
                                         int* __restrict__ scores,
                                         int* __restrict__ max_created,
                                         uint8_t* __restrict__ legal,
                                         int64_t n, int64_t i) {
  int b[16];
  const int4* src = boards + i * 4;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int4 v = src[q];
    b[4 * q] = v.x; b[4 * q + 1] = v.y; b[4 * q + 2] = v.z; b[4 * q + 3] = v.w;
  }

  int o[16];
  int score = 0, maxc = 0;
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    int v0 = b[cell<D>(l, 0)], v1 = b[cell<D>(l, 1)];
    int v2 = b[cell<D>(l, 2)], v3 = b[cell<D>(l, 3)];
    compact(v0, v1, v2, v3);
    merge_pair(v0, v1, score, maxc);
    merge_pair(v1, v2, score, maxc);
    merge_pair(v2, v3, score, maxc);
    compact(v0, v1, v2, v3);
    o[cell<D>(l, 0)] = v0; o[cell<D>(l, 1)] = v1;
    o[cell<D>(l, 2)] = v2; o[cell<D>(l, 3)] = v3;
  }

  bool changed = false;
#pragma unroll
  for (int k = 0; k < 16; ++k) changed |= (o[k] != b[k]);

  const int64_t j = D * n + i;  // row-major index into the (4, N) outputs
  int4* dst = out_boards + j * 4;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    dst[q] = make_int4(o[4 * q], o[4 * q + 1], o[4 * q + 2], o[4 * q + 3]);
  scores[j] = score;
  max_created[j] = maxc;
  legal[j] = changed ? 1 : 0;
}

__global__ void __launch_bounds__(kThreads)
merge4_kernel(const int4* __restrict__ boards, int4* __restrict__ out_boards,
              int* __restrict__ scores, int* __restrict__ max_created,
              uint8_t* __restrict__ legal, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  switch (blockIdx.y) {
    case 0: move_one<0>(boards, out_boards, scores, max_created, legal, n, i); break;
    case 1: move_one<1>(boards, out_boards, scores, max_created, legal, n, i); break;
    case 2: move_one<2>(boards, out_boards, scores, max_created, legal, n, i); break;
    default: move_one<3>(boards, out_boards, scores, max_created, legal, n, i); break;
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t) without synchronising. Pointers are
// device pointers to contiguous buffers, `boards` and `out_boards` 16-byte
// aligned. Returns cudaGetLastError() as an int: 0 when the launch was taken.
extern "C" int merge4_launch(const void* boards, void* out_boards, void* scores,
                             void* max_created, void* legal, int64_t n,
                             void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks), 4);
  merge4_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(boards), static_cast<int4*>(out_boards),
      static_cast<int*>(scores), static_cast<int*>(max_created),
      static_cast<uint8_t*>(legal), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* merge4_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
