// Sparse correlative score volume for NVIDIA Hopper, sm_90a.
//
// Replaces no TPU kernel: the JAX package computes the volume with XLA's
// convolution (laser_slam_tpu/ops/correlative.py, correlative_score_volume),
// and the port's plain version does the same with a grouped conv2d. It was
// added because that convolution, PyTorch's generic depthwise kernel on the
// card, multiplies a dense G x G count raster of each rotated cloud with the
// zero-padded likelihood grid at every shift, though the raster holds at most
// N of its G^2 cells (181 of 65,536 in the keyframe odometry's pass 2).
//
// The function, for row b (one cloud and its grid), rotation k and shift
// (a, c) of the T x T window (T = 2 * n_steps + 1), over the C planes of
// the grid (C = 1, or 2 with the overlap normaliser's cover plane):
//   out[p][b][k][a][c] = sum over the occupied raster cells (iy, ix), in
//       ascending row-major order, of count(iy, ix) * plane[p][b][iy + a - n][ix + c - n],
//       a term off the plane taken as 0,
// accumulated in float32 with one fused multiply-add a term. Cells come in as
// ids iy * G + ix of the rotated points, [B, K, N] int32, a negative id for a
// point dropped for every shift (its unshifted cell off the raster).
// The dense convolution adds count * input over the raster row-major, with a
// multiply-add a term into a float32 accumulator; its zero counts and zero
// padding add exact zeros. So the ascending cell order gives its volume bit for
// bit, and with it argmax's first-on-ties choice.
//
// What bounds it on this card: neither FLOPs nor bytes at these sizes (pass 2:
// ~1e9 multiply-adds, 33.5 MB of grids that stay in L2, 19.5 MB written), but
// the instructions a term takes: a load, a bounds test, a multiply-add. The design:
//   one block per (row, rotation): its N ids are sorted in shared memory
//     (bitonic, padded to a power of two with the largest key, which also
//     takes the dropped points to the end), and run-length encoded into the
//     unique cells with their counts by an ordered ballot compaction;
//   one thread per shift: consecutive threads take consecutive x-shifts, so
//     the loads of one cell hit neighbouring addresses, and every thread walks
//     the same cell list (a shared-memory broadcast) in the same order;
//   the 72 rotation blocks of a row are adjacent in the launch and read the
//     same grid, from L1 and L2.
// No fast math; every multiply-add is an explicit fmaf.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxPoints = 4096;      // points a (row, rotation); ids sorted in shared memory
constexpr int kMaxThreads = 1024;
constexpr unsigned kNone = 0xFFFFFFFFu;   // sort key of a dropped point (and of the padding)

struct __align__(16) Cell {   // a unique raster cell of the block's cloud (one 16-byte load)
  int y0;              // iy - n: the plane row at shift a = 0
  int x0;              // ix - n: the plane column at shift c = 0
  int off;             // y0 * G + x0
  float count;         // points in the cell
};

__device__ __forceinline__ int next_pow2(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

// C: the planes a row, 1 or 2, summed in one walk of the cells.
template <int C>
__global__ void __launch_bounds__(kMaxThreads)
corr_volume_kernel(const float* __restrict__ planes, const int* __restrict__ ids,
                   float* __restrict__ out, int batch, int k_rot, int n, int g, int n_steps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int p = next_pow2(n > 0 ? n : 1);
  Cell* cells = reinterpret_cast<Cell*>(smem);                       // [p]
  unsigned* keys = reinterpret_cast<unsigned*>(cells + p);           // [p]
  int* pos = reinterpret_cast<int*>(keys + p);                       // [p + 1]
  __shared__ int warp_sum[32];
  __shared__ int n_valid;

  const int row = blockIdx.x;                 // b * k_rot + k
  const int b = row / k_rot;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;

  // -- the block's ids, sorted ascending (dropped points and padding last) --
  const int* row_ids = ids + static_cast<int64_t>(row) * n;
  for (int i = tid; i < p; i += blockDim.x) {
    const int v = i < n ? row_ids[i] : -1;
    keys[i] = v < 0 ? kNone : static_cast<unsigned>(v);
  }
  if (tid == 0) n_valid = 0;
  __syncthreads();
  for (int size = 2; size <= p; size <<= 1) {
    for (int j = size >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < p; i += blockDim.x) {
        const int l = i ^ j;
        if (l > i) {
          const unsigned x = keys[i], y = keys[l];
          if ((x > y) == ((i & size) == 0)) {
            keys[i] = y;
            keys[l] = x;
          }
        }
      }
      __syncthreads();
    }
  }

  // -- run-length: the first position of each unique cell, in order --
  int n_unique = 0;                           // the same in every thread
  for (int base = 0; base < p; base += blockDim.x) {
    const int i = base + tid;
    bool head = false;
    if (i < p) {
      const unsigned key = keys[i];
      head = key != kNone && (i == 0 || keys[i - 1] != key);
      if (key != kNone && (i + 1 == p || keys[i + 1] == kNone)) n_valid = i + 1;
    }
    const unsigned mask = __ballot_sync(0xFFFFFFFFu, head);
    if (lane == 0) warp_sum[warp] = __popc(mask);
    __syncthreads();
    if (warp == 0) {
      int v = lane < n_warps ? warp_sum[lane] : 0;
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(0xFFFFFFFFu, v, o);
        if (lane >= o) v += t;
      }
      if (lane < n_warps) warp_sum[lane] = v;   // inclusive prefix over the warps
    }
    __syncthreads();
    if (head) {
      const int before = (warp > 0 ? warp_sum[warp - 1] : 0) +
                         __popc(mask & ((1u << lane) - 1u));
      pos[n_unique + before] = i;
    }
    n_unique += warp_sum[n_warps - 1];
    __syncthreads();
  }
  if (tid == 0) pos[n_unique] = n_valid;
  __syncthreads();
  for (int u = tid; u < n_unique; u += blockDim.x) {
    const int first = pos[u];
    const int cell = static_cast<int>(keys[first]);
    const int iy = cell / g;
    Cell c;
    c.y0 = iy - n_steps;
    c.x0 = cell - iy * g - n_steps;
    c.off = c.y0 * g + c.x0;
    c.count = static_cast<float>(pos[u + 1] - first);
    cells[u] = c;
  }
  __syncthreads();

  // -- one thread per shift: the sum over the cells in ascending order --
  const int t = 2 * n_steps + 1;
  const int64_t plane_size = static_cast<int64_t>(g) * g;
  const int64_t vol_size = static_cast<int64_t>(batch) * k_rot * t * t;
  const float* plane0 = planes + b * plane_size;
  const int64_t plane_stride = static_cast<int64_t>(batch) * plane_size;
  float* out0 = out + static_cast<int64_t>(row) * t * t;
  for (int o = tid; o < t * t; o += blockDim.x) {
    const int a = o / t;
    const int c = o - a * t;
    const int shift = a * g + c;
    float v[C];
#pragma unroll
    for (int q = 0; q < C; ++q) v[q] = 0.0f;
    for (int u = 0; u < n_unique; ++u) {
      const Cell cell = cells[u];
      if (static_cast<unsigned>(cell.y0 + a) < static_cast<unsigned>(g) &&
          static_cast<unsigned>(cell.x0 + c) < static_cast<unsigned>(g)) {
#pragma unroll
        for (int q = 0; q < C; ++q) {
          v[q] = fmaf(cell.count, __ldg(plane0 + q * plane_stride + cell.off + shift), v[q]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < C; ++q) out0[q * vol_size + o] = v[q];
  }
}

size_t shared_bytes(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return static_cast<size_t>(p) * (sizeof(Cell) + sizeof(unsigned) + sizeof(int)) + sizeof(int);
}

}  // namespace

extern "C" {

// Launches one block per (row, rotation) on `stream`: planes [n_planes,
// batch, g, g] float32, ids [batch, k_rot, n] int32, out [n_planes, batch,
// k_rot, t, t] float32 with t = 2 * n_steps + 1, all contiguous. Returns the
// CUDA error code of the launch (0 on success); does not synchronise.
int corr_volume_launch(const float* planes, const int* ids, float* out, int n_planes,
                       int batch, int k_rot, int n, int g, int n_steps, int device,
                       void* stream) {
  const int64_t t = 2 * static_cast<int64_t>(n_steps) + 1;
  if (n_planes < 1 || n_planes > 2 || batch < 0 || k_rot < 0 || n < 0 ||
      n > kMaxPoints || g < 1 || static_cast<int64_t>(g) * g > INT32_MAX ||
      n_steps < 0 || t * t > INT32_MAX ||
      static_cast<int64_t>(batch) * k_rot > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t st = cudaSetDevice(device);
  if (st != cudaSuccess) return static_cast<int>(st);
  if (batch == 0 || k_rot == 0) return 0;
  auto kernel = n_planes == 2 ? corr_volume_kernel<2> : corr_volume_kernel<1>;
  const size_t smem = shared_bytes(n);
  if (smem > 48 * 1024) {   // above the default ceiling of dynamic shared memory
    st = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
    if (st != cudaSuccess) return static_cast<int>(st);
  }
  int threads = static_cast<int>(((t * t + 31) / 32) * 32);
  if (threads > kMaxThreads) threads = kMaxThreads;
  kernel<<<batch * k_rot, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      planes, ids, out, batch, k_rot, n, g, n_steps);
  return static_cast<int>(cudaGetLastError());
}

const char* corr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
