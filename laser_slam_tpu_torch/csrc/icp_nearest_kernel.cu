// Point-ICP nearest-two search for NVIDIA Hopper, sm_90a.
//
// Replaces no TPU kernel: the JAX package's search in match_icp_points
// (laser_slam_tpu/ops/icp_points.py) is XLA, and the port's plain version
// (ops/icp_points._nearest_two_plain) is the same [B, N, M] distance matrix in
// PyTorch. On the card that block is about eleven memory-bound passes over
// B x N x M float32 (subtracts, squares, the add, the mask's select, two
// argmins, a gather, isfinite and a scatter), in chunks of particles that fit
// 2 GiB, though each observed point needs only its two best candidates.
//
// The function, for observed point n of batch b at (qx, qy) and reference
// point k at (rx, ry) with mask ok_k:
//   d_k = ok_k ? (qx - rx) * (qx - rx) + (qy - ry) * (qy - ry) : +inf;
//   j = the first index of the least d_k (torch.argmin: a NaN comes before
//   every number, equal values keep the lower index), nn_ok = isfinite(d_j);
//   j2 = the same over d with d_j set to +inf, so 0 where no candidate but j
//   is below +inf, as torch.argmin gives over a row of +inf.
// Each operation is the float32 operation that PyTorch's CUDA kernels perform
// for the plain block, rounded once, with no contraction (__fsub_rn,
// __fmul_rn, __fadd_rn): the subtracts, the two squares and their add are four
// separate kernels there. So j, j2 and nn_ok equal the plain block's bit for
// bit. A thread walks the candidates in index order and keeps the best two in
// registers, replacing one only for a value strictly before it, which is
// torch.argmin's tie rule; the second best of that walk is the argmin of the
// row with the best set to +inf.
//
// What bounds it on this card: not bytes (a particle's simulated cloud is
// 3.3 KB at 361 points, read once into shared memory; the whole search reads a
// few MB an iteration) but the instructions each pair issues: two subtracts,
// two squares, the add, the compare with the second best and its branch, about
// 8 a pair, 5.3e8 pairs an ICP iteration at the localization cell's shape. The
// design:
//   one block a (batch, tile of observed points); the batch's reference points
//     are staged into shared memory, tiles of kTile points for larger clouds,
//     a masked point as (+inf, +inf) beside its mask byte, the batch stride
//     taken as given (a cloud expanded with stride 0 is read, not copied);
//   one thread two observed points (kPerThread), the candidates read as float4
//     (two points a load, the same address across the warp: a broadcast), so a
//     load serves four pairs;
//   for a finite observed point against a tile of finite reference points no
//     distance is NaN, and a masked point's (+inf, +inf) gives +inf, which is
//     the plain block's select: the loop tests d < second best and updates the
//     two only then. A thread with a point that is not finite, or a tile with a
//     valid point that is not finite, takes the exact loop instead: the mask
//     byte and the NaN order of torch.argmin.
// No fast math.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kPerThread = 2;       // observed points a thread
constexpr int kMaxThreads = 256;    // threads a block
constexpr int kTile = 4096;         // reference points staged at a time (even)

// The plain block's squared distance, each operation rounded once.
__device__ __forceinline__ float dist2(float qx, float qy, float rx, float ry) {
  const float dx = __fsub_rn(qx, rx), dy = __fsub_rn(qy, ry);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

// torch.argmin's order: a NaN before every number, else the smaller value.
__device__ __forceinline__ bool before(float d, float b) {
  return isnan(d) ? !isnan(b) : d < b;
}

// Offers candidate k at d to the best two (b1, i1) and (b2, i2), b1 first.
__device__ __forceinline__ void offer_exact(float d, int k, float& b1, int& i1, float& b2,
                                            int& i2) {
  if (before(d, b1)) {
    b2 = b1; i2 = i1; b1 = d; i1 = k;
  } else if (before(d, b2)) {
    b2 = d; i2 = k;
  }
}

// The same where no value is NaN.
__device__ __forceinline__ void offer(float d, int k, float& b1, int& i1, float& b2, int& i2) {
  if (d < b2) {
    if (d < b1) {
      b2 = b1; i2 = i1; b1 = d; i1 = k;
    } else {
      b2 = d; i2 = k;
    }
  }
}

__global__ void __launch_bounds__(kMaxThreads)
nearest_two_kernel(const float* __restrict__ q, const float* __restrict__ ref,
                   const uint8_t* __restrict__ valid, int64_t* __restrict__ j,
                   int64_t* __restrict__ j2, uint8_t* __restrict__ nn_ok, int n, int m, int tile,
                   int64_t ref_sb, int64_t ref_sp, int64_t ref_sc, int64_t valid_sb,
                   int64_t valid_sp) {
  extern __shared__ float4 smem[];
  float2* pts = reinterpret_cast<float2*>(smem);                        // [tile]
  uint8_t* ok = reinterpret_cast<uint8_t*>(pts + tile);                 // [tile]
  const int64_t b = blockIdx.x;
  const int first = blockIdx.y * blockDim.x * kPerThread + threadIdx.x;

  float qx[kPerThread], qy[kPerThread], b1[kPerThread], b2[kPerThread];
  int i1[kPerThread], i2[kPerThread];
  bool active = false, finite = true;
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    const int idx = first + u * blockDim.x;
    const bool in = idx < n;
    const int64_t at = 2 * (b * n + (in ? idx : 0));
    qx[u] = in ? q[at] : 0.0f;
    qy[u] = in ? q[at + 1] : 0.0f;
    active = active || in;
    finite = finite && isfinite(qx[u]) && isfinite(qy[u]);
    b1[u] = b2[u] = INFINITY;
    i1[u] = i2[u] = 0;
  }

  const float* rb = ref + b * ref_sb;
  const uint8_t* vb = valid + b * valid_sb;
  for (int t0 = 0; t0 < m; t0 += tile) {
    const int len = min(tile, m - t0);
    const int even = (len + 1) & ~1;      // a pad point of +inf after an odd tile
    __syncthreads();                      // every thread is done with the last tile
    int bad = 0;
    for (int k = threadIdx.x; k < even; k += blockDim.x) {
      const int64_t g = t0 + k;
      const bool v = k < len && vb[g * valid_sp] != 0;
      float x = INFINITY, y = INFINITY;
      if (v) {
        x = rb[g * ref_sp];
        y = rb[g * ref_sp + ref_sc];
        bad |= !(isfinite(x) && isfinite(y));
      }
      pts[k] = make_float2(x, y);
      ok[k] = v;
    }
    bad = __syncthreads_or(bad);
    if (!active) continue;
    if (finite && !bad) {
      const float4* p4 = reinterpret_cast<const float4*>(pts);
#pragma unroll 4
      for (int k = 0; k < even; k += 2) {
        const float4 r = p4[k >> 1];
#pragma unroll
        for (int u = 0; u < kPerThread; ++u) {
          offer(dist2(qx[u], qy[u], r.x, r.y), t0 + k, b1[u], i1[u], b2[u], i2[u]);
          offer(dist2(qx[u], qy[u], r.z, r.w), t0 + k + 1, b1[u], i1[u], b2[u], i2[u]);
        }
      }
    } else {
      for (int k = 0; k < len; ++k) {
        const float2 r = pts[k];
        const bool v = ok[k] != 0;
#pragma unroll
        for (int u = 0; u < kPerThread; ++u) {
          const float d = v ? dist2(qx[u], qy[u], r.x, r.y) : INFINITY;
          offer_exact(d, t0 + k, b1[u], i1[u], b2[u], i2[u]);
        }
      }
    }
  }

#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    const int idx = first + u * blockDim.x;
    if (idx < n) {
      const int64_t at = b * n + idx;
      j[at] = i1[u];
      j2[at] = i2[u];
      nn_ok[at] = isfinite(b1[u]);
    }
  }
}

}  // namespace

extern "C" {

// Launches the search on `stream`: q [batch, n, 2] float32 contiguous; ref
// [batch, m, 2] float32 and valid [batch, m] bytes (0 or 1) at the strides
// given in elements (a batch stride may be 0); j, j2 [batch, n] int64 and
// nn_ok [batch, n] bytes, contiguous. Returns the CUDA error code of the
// launch (0 on success); does not synchronise.
int nearest_two_launch(const float* q, const float* ref, const uint8_t* valid, int64_t* j,
                       int64_t* j2, uint8_t* nn_ok, int batch, int n, int m, int64_t ref_sb,
                       int64_t ref_sp, int64_t ref_sc, int64_t valid_sb, int64_t valid_sp,
                       int device, void* stream) {
  if (batch < 0 || n < 0 || m < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t st = cudaSetDevice(device);
  if (st != cudaSuccess) return static_cast<int>(st);
  if (batch == 0 || n == 0) return 0;
  const int per_thread_points = (n + kPerThread - 1) / kPerThread;
  const int threads = min(kMaxThreads, (per_thread_points + 31) / 32 * 32);
  const int tiles = (n + threads * kPerThread - 1) / (threads * kPerThread);
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int tile = min(kTile, (m + 1) & ~1);
  const size_t shared = static_cast<size_t>(tile) * (sizeof(float2) + 1);
  const dim3 grid(batch, tiles);
  nearest_two_kernel<<<grid, threads, shared, static_cast<cudaStream_t>(stream)>>>(
      q, ref, valid, j, j2, nn_ok, n, m, tile, ref_sb, ref_sp, ref_sc, valid_sb, valid_sp);
  return static_cast<int>(cudaGetLastError());
}

const char* nearest_two_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
