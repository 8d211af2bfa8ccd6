// Beam-model ray march for NVIDIA Hopper, sm_90a.
//
// Replaces no TPU kernel: the JAX package's simulate_scan
// (laser_slam_tpu/localization/raycast.py) is XLA, a dense [..., N, S] ladder
// of range samples reduced by one argmax, and the port's plain version
// (localization/raycast._simulate_scan_ladder) is the same ladder in PyTorch.
// On the card that ladder is about twenty memory-bound passes over P x N x S
// samples (S = max_range / resolution: 2500 at 2 cm and 50 m), in chunks of
// particles that fit 2 GiB, though a ray needs only its samples up to its first
// occupied cell.
//
// The function, for pose p at (px, py) and beam n whose angle has cosine c and
// sine s (computed by PyTorch, as the ladder computes them):
//   sample k (0 <= k < n_samples) lies at range rs_k = (k + 1) * res, at
//   x_k = px + rs_k * c, y_k = py + rs_k * s, in the cell
//   (floor((x_k - origin_x) * inv_res), floor((y_k - origin_y) * inv_res));
//   out[p][n] = rs_k of the first sample whose cell is on the map and
//   occupied, max_range where there is none.
// Each operation is the float32 operation that PyTorch's CUDA kernels perform
// for the ladder, rounded once, with no contraction (__fmul_rn, __fadd_rn):
// ATen subtracts a Python scalar as a float32 subtraction and divides by one as
// a multiplication by its float32 reciprocal (inv_res). floor and the cast to
// an integer are one rounding-down conversion, which saturates where the
// ladder's int64 would be out of range on the same side. So the ranges equal
// the ladder's bit for bit. The occupancy map is the ladder's own test,
// probability > threshold, made by PyTorch once a call (bool, one byte a cell).
//
// What bounds it on this card: not bytes (the map, 31 MB at 2 cm, stays in the
// 50 MB L2; the cloud, the angles and the ranges are a few MB) and not float32
// operations, but the instructions each sample issues (about 20, integer and
// float32: its range, two coordinates, two cells, four bounds tests, the flat
// index, the gather and its test) and the latency of its gather from L1 or L2.
// The design:
//   one warp a ray, 32 consecutive samples a step: the 32 gathers of a step
//     are independent of each other, __ballot_sync and __ffs give the first
//     occupied sample, and the warp stops at the step that holds it, so the
//     walk costs the ray's samples up to its hit, rounded up to 32;
//   a warp also stops once every sample of a step is off the map and the last
//     one is leaving it: under round-to-nearest x_k, y_k and their cells are
//     monotone in k, so a ray that has left the map never comes back;
//   the 8 warps of a block take one beam of 8 neighbouring poses: their rays
//     lie close together (a resampled cloud spreads a few cm) and read the
//     same cells, from L1;
//   the map is read as PyTorch's bytes: a map packed to one bit a cell
//     (3.9 MB) was slower on an H100 at the beam cell's shape (0.73 against
//     0.59 ms),
//     its extra shift, mask and pack pass costing more than its denser lines
//     saved.
// No fast math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;          // warps a block: one beam of kWarps poses
constexpr unsigned kAll = 0xFFFFFFFFu;

__global__ void __launch_bounds__(kWarps * 32)
ray_march_kernel(const uint8_t* __restrict__ occupied, const float* __restrict__ pose,
                 const float* __restrict__ cos_a, const float* __restrict__ sin_a,
                 float* __restrict__ out, int n_poses, int n_beams, int width, int height,
                 float origin_x, float origin_y, float inv_res, float res, int n_samples,
                 float max_range) {
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (p >= n_poses) return;        // the whole warp
  const int64_t ray = static_cast<int64_t>(p) * n_beams + blockIdx.y;
  const float px = __ldg(pose + 3 * static_cast<int64_t>(p));
  const float py = __ldg(pose + 3 * static_cast<int64_t>(p) + 1);
  const float c = __ldg(cos_a + ray), s = __ldg(sin_a + ray);

  float range = max_range;
  float k1 = static_cast<float>(lane + 1);        // k + 1 of this lane's sample, exact
  for (int base = 0; base < n_samples; base += 32) {
    const float rs = __fmul_rn(k1, res);
    const float x = __fadd_rn(px, __fmul_rn(rs, c));
    const float y = __fadd_rn(py, __fmul_rn(rs, s));
    const int ix = __float2int_rd(__fmul_rn(__fsub_rn(x, origin_x), inv_res));
    const int iy = __float2int_rd(__fmul_rn(__fsub_rn(y, origin_y), inv_res));
    const bool on_map = static_cast<unsigned>(ix) < static_cast<unsigned>(width) &&
                        static_cast<unsigned>(iy) < static_cast<unsigned>(height) &&
                        base + lane < n_samples;
    const bool hit = on_map && __ldg(occupied + iy * width + ix) != 0;
    const unsigned hits = __ballot_sync(kAll, hit);
    if (hits != 0) {
      // (first + 1) * res, which is rs of the first occupied lane
      range = __fmul_rn(static_cast<float>(base + __ffs(hits)), res);
      break;
    }
    if (__ballot_sync(kAll, on_map) == 0) {
      // Every sample of the step is off the map: stop if the last one leaves it.
      const int lx = __shfl_sync(kAll, ix, 31), ly = __shfl_sync(kAll, iy, 31);
      if ((lx < 0 && c <= 0.0f) || (lx >= width && c >= 0.0f) ||
          (ly < 0 && s <= 0.0f) || (ly >= height && s >= 0.0f)) {
        break;
      }
    }
    k1 = __fadd_rn(k1, 32.0f);
  }
  if (lane == 0) out[ray] = range;
}

}  // namespace

extern "C" {

// Launches one warp a ray on `stream`: occupied [height, width] (bytes, 0 or
// 1), pose [n_poses, 3], cos_a and sin_a [n_poses, n_beams], out [n_poses,
// n_beams], float32, all contiguous. Returns the CUDA error code of the launch
// (0 on success); does not synchronise.
int ray_march_launch(const uint8_t* occupied, int height, int width, const float* pose,
                     const float* cos_a, const float* sin_a, float* out, int n_poses,
                     int n_beams, float origin_x, float origin_y, float inv_res, float res,
                     int n_samples, float max_range, int device, void* stream) {
  if (height < 1 || width < 1 || static_cast<int64_t>(height) * width > INT32_MAX ||
      n_poses < 0 || n_beams < 0 || n_beams > 65535 || n_samples < 0 ||
      n_samples >= (1 << 24)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t st = cudaSetDevice(device);
  if (st != cudaSuccess) return static_cast<int>(st);
  if (n_poses == 0 || n_beams == 0) return 0;
  const dim3 grid((n_poses + kWarps - 1) / kWarps, n_beams);
  ray_march_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      occupied, pose, cos_a, sin_a, out, n_poses, n_beams, width, height, origin_x, origin_y,
      inv_res, res, n_samples, max_range);
  return static_cast<int>(cudaGetLastError());
}

const char* ray_march_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
