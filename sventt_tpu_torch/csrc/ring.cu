// K10: the all-to-all of slabs over a mesh, for Hopper (sm_90a).
//
// Replaces the Pallas remote-DMA ring of sventt_tpu/parallel/ring.py
// (_canonical_all_to_all, body _ring_kernel).  Contract (canonical): shard
// d's input holds D slabs of (R, C) words, slab j bound for shard j; shard
// d's output holds D slabs, out_d[o] = in_o[d].  The port keeps one int64
// word a u64, so one slab copy moves what the TPU kernel moved as a (hi,
// lo) pair of u32 planes.  The plain PyTorch version is
// sventt_tpu_torch/parallel/ring.py::canonical_all_to_all_plain.
//
// Design for this card, not after the TPU's DMA schedule:
// * Pull.  One launch per destination DEVICE, on that device's stream,
//   covering every destination shard the device holds (a whole mesh of
//   logical shards on one card is one launch).  A block copies one tile of
//   one slab: it reads the source shard's memory -- the card's own or a
//   peer's over NVLink, once peer access is on -- and writes its own.
// * The pointers go in by value (RingArgs, at most MAX_D shards): no
//   host-to-device copy a call.
// * Rotated order.  Grid z is the ring step s; destination d reads source
//   (d + s) mod D, its own slab at s = 0.  Blocks start in x, y, z order,
//   so at any moment the destinations in flight read distinct sources, the
//   schedule of ring.py's rotation ring.
// * Strides.  A slab is R rows of C contiguous words, at a slab and a row
//   stride of its own on each side.  So the two layouts that map
//   lax.all_to_all(tiled=True) onto the canonical one (ring.py:155-177: a
//   column split read through a transpose, a row concat written through
//   one) are folded into the copy: no reshaping pass before or after it.
// * 16-byte loads and stores where C and every stride are even and every
//   base is 16-byte aligned; 8-byte ones otherwise.  Each thread keeps
//   UNROLL loads in flight before it stores.
// Bound on the H100: the bytes, each word read once and written once, 16
// bytes a word at 3.35 TB/s; across cards (D-1)/D of them cross NVLink at
// 450 GB/s each way per card.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int MAX_D = 64;
constexpr int THREADS = 256;
constexpr int UNROLL = 4;
constexpr unsigned TILE = THREADS * UNROLL;  // units a block

struct RingArgs {
  const void *src[MAX_D];  // source shard o, by mesh index
  void *dst[MAX_D];        // destination shard, by local index (grid y)
  int dest[MAX_D];         // mesh index of each local destination
};

struct Strides {  // in units of T
  long long src_slab, src_row, dst_slab, dst_row;
};

template <typename T, bool CONTIG>
__global__ void __launch_bounds__(THREADS)
    ring_kernel(const RingArgs args, const Strides st, int D, unsigned C, unsigned total) {
  const int k = blockIdx.y;
  const int d = args.dest[k];
  const int o = (d + (int)blockIdx.z) % D;
  const T *src = (const T *)args.src[o] + d * st.src_slab;
  T *dst = (T *)args.dst[k] + o * st.dst_slab;
  const unsigned base = blockIdx.x * TILE + threadIdx.x;
  T v[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const unsigned i = base + u * THREADS;
    if (i < total) {
      if (CONTIG) {
        v[u] = src[i];
      } else {
        const unsigned r = i / C, c = i - r * C;
        v[u] = src[r * st.src_row + c];
      }
    }
  }
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const unsigned i = base + u * THREADS;
    if (i < total) {
      if (CONTIG) {
        dst[i] = v[u];
      } else {
        const unsigned r = i / C, c = i - r * C;
        dst[r * st.dst_row + c] = v[u];
      }
    }
  }
}

template <typename T>
cudaError_t launch(const RingArgs &args, Strides st, int n_dest, int D, long long R,
                   long long C, cudaStream_t stream) {
  const long long total = R * C;
  if (total >= 0x7fffffffll) return cudaErrorInvalidValue;
  const long long tiles = (total + TILE - 1) / TILE;
  const dim3 grid((unsigned)tiles, (unsigned)n_dest, (unsigned)D);
  const bool contig = st.src_row == C && st.dst_row == C;
  if (contig)
    ring_kernel<T, true><<<grid, THREADS, 0, stream>>>(args, st, D, (unsigned)C,
                                                       (unsigned)total);
  else
    ring_kernel<T, false><<<grid, THREADS, 0, stream>>>(args, st, D, (unsigned)C,
                                                        (unsigned)total);
  return cudaGetLastError();
}

}  // namespace

// Copy out_k[o] = in_o[dest[k]] for the n_dest destination shards of one
// device: src[o] for every o < D, dst[k] / dest[k] for k < n_dest, slabs of
// R x C int64 words at the given strides (in words).  Launches on `stream`
// of `device`; returns cudaGetLastError() of the launch.
extern "C" int sventt_ring_all_to_all(const void *const *src, void *const *dst,
                                      const int *dest, int n_dest, int D, long long R,
                                      long long C, long long src_slab, long long src_row,
                                      long long dst_slab, long long dst_row, int device,
                                      void *stream) {
  if (D < 1 || D > MAX_D || n_dest < 1 || n_dest > D || R <= 0 || C <= 0)
    return (int)cudaErrorInvalidValue;
  RingArgs args = {};
  bool aligned = true;
  for (int o = 0; o < D; ++o) {
    args.src[o] = src[o];
    aligned = aligned && ((uintptr_t)src[o] % 16 == 0);
  }
  for (int k = 0; k < n_dest; ++k) {
    if (dest[k] < 0 || dest[k] >= D) return (int)cudaErrorInvalidValue;
    args.dst[k] = dst[k];
    args.dest[k] = dest[k];
    aligned = aligned && ((uintptr_t)dst[k] % 16 == 0);
  }
  int prev = -1;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess) return (int)err;
  const bool wide = aligned && C % 2 == 0 && src_slab % 2 == 0 && src_row % 2 == 0 &&
                    dst_slab % 2 == 0 && dst_row % 2 == 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (wide)
    err = launch<longlong2>(args, {src_slab / 2, src_row / 2, dst_slab / 2, dst_row / 2},
                            n_dest, D, R, C / 2, st);
  else
    err = launch<long long>(args, {src_slab, src_row, dst_slab, dst_row}, n_dest, D, R, C,
                            st);
  if (prev != device) cudaSetDevice(prev);
  return (int)err;
}

// Let `device` read `peer`'s memory.  0 on success or when it was on
// already (torch's own peer copies may have turned it on; that error is
// cleared), cudaErrorPeerAccessUnsupported when the pair cannot, else the
// CUDA error.
extern "C" int sventt_enable_peer_access(int device, int peer) {
  int can = 0;
  cudaError_t err = cudaDeviceCanAccessPeer(&can, device, peer);
  if (err != cudaSuccess) return (int)err;
  if (!can) return (int)cudaErrorPeerAccessUnsupported;
  int prev = -1;
  if ((err = cudaGetDevice(&prev)) != cudaSuccess) return (int)err;
  if ((err = cudaSetDevice(device)) != cudaSuccess) return (int)err;
  err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();
    err = cudaSuccess;
  }
  cudaSetDevice(prev);
  return (int)err;
}
