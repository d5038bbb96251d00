// Blocked 2-D transpose for Hopper (sm_90a): (R, C) -> (C, R).
//
// Replaces the Pallas kernels of sventt_tpu/ops/transpose.py:
//   K9a transpose_pallas: one u32 plane, (br, bc) tiles;
//   K9b _transpose_pallas_pair: both u32 limb planes of a u64 in one kernel.
// The port holds a u64 as one 8-byte word, so K9b is this kernel at 8
// bytes and K9a at 4 (template T).  The plain PyTorch version is
// sventt_tpu_torch/ops/transpose.py::transpose_pallas_plain.
//
// The TPU's (256, 256) tile of u32 planes (512 KB a block at 8 bytes) is
// not a CUDA tile: the caller's (br, bc) only has to divide the shape, and
// this kernel takes its own TILE x TILE shared-memory tile, padded by one
// element so that the column reads hit distinct banks.  A block of TILE x
// ROWS threads reads its tile along rows (each warp one contiguous row
// segment) and writes it along the output's rows, so both global passes
// are coalesced; the ragged edge is masked.
// Bound on the H100: the bytes, each element read and written once
// (2 * sizeof(T) per element) at 3.35 TB/s.  16-byte accesses a thread and
// TMA tile copies are later work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TILE = 32;
constexpr int ROWS = 8;

template <typename T>
__global__ void __launch_bounds__(TILE * ROWS)
    transpose_kernel(const T *__restrict__ x, T *__restrict__ out, long long R,
                     long long C, long long tiles_c) {
  __shared__ T tile[TILE][TILE + 1];
  const long long r0 = (long long)(blockIdx.x / tiles_c) * TILE;
  const long long c0 = (long long)(blockIdx.x % tiles_c) * TILE;
  for (int i = threadIdx.y; i < TILE; i += ROWS) {
    const long long r = r0 + i, c = c0 + threadIdx.x;
    if (r < R && c < C) tile[i][threadIdx.x] = x[r * C + c];
  }
  __syncthreads();
  for (int i = threadIdx.y; i < TILE; i += ROWS) {
    const long long c = c0 + i, r = r0 + threadIdx.x;
    if (c < C && r < R) out[c * R + r] = tile[threadIdx.x][i];
  }
}

}  // namespace

extern "C" int sventt_transpose(const void *x, void *out, long long R, long long C,
                                int elem_bytes, void *stream) {
  if (R <= 0 || C <= 0 || (elem_bytes != 4 && elem_bytes != 8))
    return (int)cudaErrorInvalidValue;
  const long long tiles_c = (C + TILE - 1) / TILE;
  const long long blocks = (R + TILE - 1) / TILE * tiles_c;
  if (blocks > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  const dim3 block(TILE, ROWS);
  cudaStream_t st = (cudaStream_t)stream;
  if (elem_bytes == 8)
    transpose_kernel<unsigned long long><<<(unsigned)blocks, block, 0, st>>>(
        (const unsigned long long *)x, (unsigned long long *)out, R, C, tiles_c);
  else
    transpose_kernel<unsigned int><<<(unsigned)blocks, block, 0, st>>>(
        (const unsigned int *)x, (unsigned int *)out, R, C, tiles_c);
  return (int)cudaGetLastError();
}
