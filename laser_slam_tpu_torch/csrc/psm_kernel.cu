// Fused PSM scan matcher (kernel K1) for NVIDIA Hopper, sm_90a.
//
// Replaces the TPU kernel laser_slam_tpu/ops/pallas/psm_kernel.py
// (match_psm_pallas -> pl.pallas_call -> _kernel -> _one_pair) and computes
// the function of the plain laser_slam_tpu_torch/ops/psm.match_psm: a whole
// polar scan match per pair, at most MAX_ITER/2 = 15 solver iterations of
//   projection of cur into ref's bearing grid (O(N^2) pair x bin min, first
//   argmin wins, its facing decides occlusion) -> orientation search over
//   2W+1 bin shifts with parabolic refinement -> re-projection -> Cauchy-
//   weighted 2x2 translation solve,
// stopping after 3 consecutive small steps or on failure.
//
// What bounds it on the card: per-pair latency. One pair is a chain of up to
// 15 dependent iterations, each a few small reductions over a few KB of data;
// neither HBM bandwidth nor the FLOP rate is anywhere near its limit. The
// odometry chain launches two pairs per step, so the chain's latency is the
// step's cost; a whole-log batch (thousands of pairs) fills the SMs with
// independent blocks.
//
// Design: one block per pair, one thread per beam/bin (blockDim = N rounded up
// to a warp: 192 / 384 / 544 for the LMS211 / LMS511 / LMS151 presets). Every
// array of the pair and the scalar solver state live in shared memory; the
// block leaves the loop as soon as its own pair converged or failed (the
// plain batched version runs every pair as long as the slowest one).
//   projection: thread j owns bin j and scans all pairs, keeping the min and
//               the first argmin (reads of pair i are warp broadcasts);
//   orientation: thread k < 2W+1 sums shift k; thread 0 takes the first
//               argmin and the parabola;
//   translation: warp-shuffle block reductions of the six sums, the count and
//               the |dr| sum; thread 0 solves the 2x2 system.
// TPU artifacts of the Pallas kernel are not carried over: its polynomial
// atan2 (atan2f here), its any-occluder-at-min rule, 8-pair programs and lane
// padding.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxBeams = 544;            // 541 beams rounded up to a warp
constexpr int kMaxWarps = kMaxBeams / 32;
constexpr int kMaxShifts = 2 * 100 + 1;   // 2W+1 for W <= 100
constexpr int kSums = 8;                  // translation reduction width
constexpr float kEmpty = 100.0f;          // project.EMPTY_RANGE
constexpr float kLargeErr = 100.0f;       // psm.LARGE_ERR
constexpr float kMaxError = 1.0f;         // psm.MAX_ERROR
constexpr float kStopCond = 0.4f;         // psm.STOP_COND
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;

struct Shared {
  // per beam / bin
  float ref_r[kMaxBeams];
  float cur_r[kMaxBeams];
  float phi[kMaxBeams];
  float rr[kMaxBeams];
  float new_r[kMaxBeams];
  // per pair (i-1, i)
  float lo[kMaxBeams];
  float hi[kMaxBeams];
  float p0[kMaxBeams];
  float r0[kMaxBeams];
  float drr[kMaxBeams];
  float dph[kMaxBeams];
  uint8_t ref_bad[kMaxBeams];
  uint8_t pair_ok[kMaxBeams];
  uint8_t new_bad[kMaxBeams];
  uint8_t pvalid[kMaxBeams];
  uint8_t occl[kMaxBeams];
  // orientation errors and reduction scratch
  float err[kMaxShifts];
  float red[kSums][kMaxWarps];
  // scalar solver state (written by thread 0 between barriers)
  float ax, ay, ath;   // pose estimate
  float cx, cy, cth;   // last corrections
  float C, avg;
  int small, fail, done;
};

__device__ __forceinline__ int small_step(int cnt, float dx, float dy, float dth) {
  float m = 100.0f * (fabsf(dx) + fabsf(dy)) + fabsf(dth);
  return m < kStopCond ? cnt + 1 : 0;
}

// Projects the current scan posed at (ax, ay, ath) onto the reference
// bearings: fills new_r / new_bad for bins 0..n-1. Ends on a barrier.
__device__ void project(Shared& s, int n, int tid, float fi_j, float ax,
                        float ay, float ath) {
  if (tid < n) {
    float ang = ath + fi_j;
    float r = s.cur_r[tid];
    float x = r * cosf(ang) + ax;
    float y = r * sinf(ang) + ay;
    float phi = atan2f(y, x);
    if (x < 0.0f && y < 0.0f) phi += kTwoPi;   // third-quadrant lift
    s.phi[tid] = phi;
    s.rr[tid] = sqrtf(x * x + y * y);
  }
  __syncthreads();
  if (tid < n) {
    int im1 = tid == 0 ? n - 1 : tid - 1;
    float phi = s.phi[tid], phi0 = s.phi[im1];
    float rr = s.rr[tid], rr0 = s.rr[im1];
    float dphi = phi - phi0;
    s.pvalid[tid] = s.pair_ok[tid] && fabsf(dphi) < kPi;
    s.occl[tid] = phi <= phi0;
    s.lo[tid] = fminf(phi0, phi);
    s.hi[tid] = fmaxf(phi0, phi);
    s.p0[tid] = phi0;
    s.r0[tid] = rr0;
    s.drr[tid] = rr - rr0;
    s.dph[tid] = fabsf(dphi) < 1e-9f ? 1e-9f : dphi;
  }
  __syncthreads();
  if (tid < n) {
    // argmin over the full masked column (uncovered pairs read kEmpty),
    // first index on ties — the dense projection's winner rule.
    float best = INFINITY;
    int win = 0;
    bool any = false;
    for (int i = 0; i < n; ++i) {
      float v = kEmpty;
      if (s.pvalid[i] && fi_j >= s.lo[i] && fi_j <= s.hi[i]) {
        float t = (fi_j - s.p0[i]) / s.dph[i];
        v = s.r0[i] + s.drr[i] * t;
        any = true;
      }
      if (v < best) {
        best = v;
        win = i;
      }
    }
    s.new_r[tid] = any ? best : kEmpty;
    s.new_bad[tid] = !any || s.occl[win];
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kMaxBeams)
psm_match_kernel(const float* __restrict__ ref_r, const uint8_t* __restrict__ ref_bad,
                 const float* __restrict__ cur_r, const uint8_t* __restrict__ pair_ok,
                 const float* __restrict__ fi, const float* __restrict__ init,
                 float* __restrict__ pose, float* __restrict__ err,
                 uint8_t* __restrict__ fail, int n, int window, float dfi,
                 float min_range, float max_range, float weighting,
                 float min_valid, int max_iters, int change_weight_it) {
  __shared__ Shared s;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int n_shift = 2 * window + 1;
  const size_t row = static_cast<size_t>(b) * n;

  float fi_j = 0.0f, co_j = 0.0f, si_j = 0.0f;
  if (tid < n) {
    s.ref_r[tid] = ref_r[row + tid];
    s.ref_bad[tid] = ref_bad[row + tid];
    s.cur_r[tid] = cur_r[row + tid];
    s.pair_ok[tid] = pair_ok[row + tid];
    fi_j = fi[tid];
    co_j = cosf(fi_j);
    si_j = sinf(fi_j);
  }
  if (tid == 0) {
    s.ax = init[3 * b];
    s.ay = init[3 * b + 1];
    s.ath = init[3 * b + 2];
    s.cx = s.cy = s.cth = 1e6f;
    s.C = weighting;
    s.avg = kLargeErr;
    s.small = 0;
    s.fail = 0;
    s.done = 0;
  }
  __syncthreads();

  for (int it = 0; it < max_iters; ++it) {
    if (s.done) break;   // uniform: written by thread 0 before a barrier

    // -- orientation half-step --
    project(s, n, tid, fi_j, s.ax, s.ay, s.ath);
    if (tid < n_shift) {
      const int di = tid - window;
      const int j0 = di < 0 ? -di : 0;
      const int j1 = di > 0 ? n - di : n;
      float e = 0.0f;
      int cnt = 0;
      for (int j = j0; j < j1; ++j) {
        if (!s.new_bad[j] && !s.ref_bad[j + di]) {
          e += fabsf(s.new_r[j] - s.ref_r[j + di]);
          ++cnt;
        }
      }
      s.err[tid] = cnt > 0 ? e / static_cast<float>(cnt) : kLargeErr;
    }
    __syncthreads();
    if (tid == 0) {
      int imin = 0;
      float emin = s.err[0];
      for (int k = 1; k < n_shift; ++k) {
        if (s.err[k] < emin) {
          emin = s.err[k];
          imin = k;
        }
      }
      float dth = static_cast<float>(imin - window) * dfi;
      float em1 = s.err[imin > 0 ? imin - 1 : 0];
      float ep1 = s.err[imin < n_shift - 1 ? imin + 1 : n_shift - 1];
      float curv = em1 + ep1 - 2.0f * emin;
      bool ok = imin >= 1 && imin < n_shift - 1 && fabsf(curv) > 1e-4f &&
                em1 > emin && ep1 > emin;
      float d = ok ? (em1 - ep1) / curv / 2.0f : 0.0f;
      dth = dth + (fabsf(d) < 1.0f ? d : 0.0f) * dfi;

      s.small = small_step(s.small, s.cx, s.cy, s.cth);
      s.small = small_step(s.small, s.cx, s.cy, dth);
      s.ath = s.ath + dth;
      s.cth = dth;
      s.fail = emin >= kLargeErr;
      if (it == change_weight_it) s.C = s.C / 50.0f;
    }
    __syncthreads();

    // -- translation half-step --
    project(s, n, tid, fi_j, s.ax, s.ay, s.ath);
    float v[kSums] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (tid < n) {
      const float C = s.C;
      const float nr = s.new_r[tid];
      const float dr = s.ref_r[tid] - nr;
      const bool valid = !s.ref_bad[tid] && !s.new_bad[tid] && nr < max_range &&
                         nr > min_range && fabsf(dr) < kMaxError;
      const float w = valid ? C / (dr * dr + C) : 0.0f;
      v[0] = w * co_j * dr;
      v[1] = w * si_j * dr;
      v[2] = w * co_j * co_j;
      v[3] = w * co_j * si_j;
      v[4] = w * si_j * si_j;
      v[5] = valid ? 1.0f : 0.0f;
      v[6] = fabsf(dr);
    }
    for (int q = 0; q < kSums; ++q) {
      float x = v[q];
      for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
      if (lane == 0) s.red[q][warp] = x;
    }
    __syncthreads();
    if (tid == 0) {
      float sum[kSums];
      for (int q = 0; q < kSums; ++q) {
        float acc = 0.0f;
        for (int w = 0; w < nwarps; ++w) acc += s.red[q][w];
        sum[q] = acc;
      }
      const float hw1 = sum[0], hw2 = sum[1], h11 = sum[2], h12 = sum[3], h22 = sum[4];
      const float cnt = sum[5];
      float det = h11 * h22 - h12 * h12;
      const bool fail_t = cnt < min_valid || det < 1e-3f;
      if (fail_t) det = 1.0f;
      float dx = (h22 * hw1 - h12 * hw2) / det;
      float dy = (-h12 * hw1 + h11 * hw2) / det;
      const float avg = sum[6] / fmaxf(cnt, 1.0f);
      const bool failed = s.fail || fail_t;
      if (failed) {
        dx = 0.0f;
        dy = 0.0f;
      } else {
        s.avg = avg;
      }
      s.ax += dx;
      s.ay += dy;
      s.cx = dx;
      s.cy = dy;
      s.fail = failed;
      s.done = failed || s.small >= 3;
    }
    __syncthreads();
  }

  if (tid == 0) {
    pose[3 * b] = s.ax;
    pose[3 * b + 1] = s.ay;
    pose[3 * b + 2] = s.ath;
    err[b] = s.avg;
    fail[b] = static_cast<uint8_t>(s.fail);
  }
}

}  // namespace

extern "C" {

// Launches one block per pair on `stream`. Inputs are row-major [batch, n]
// (bools as bytes), fi is [n], init and pose are [batch, 3]. Returns the
// CUDA error code of the launch (0 on success); does not synchronise.
int psm_match_launch(const float* ref_r, const uint8_t* ref_bad, const float* cur_r,
                     const uint8_t* pair_ok, const float* fi, const float* init,
                     float* pose, float* err, uint8_t* fail, int batch, int n,
                     int window, float dfi, float min_range, float max_range,
                     float weighting, int min_valid_points, int max_iters,
                     int change_weight_it, int device, void* stream) {
  const int threads = ((n + 31) / 32) * 32;
  if (n < 2 || n > kMaxBeams || window < 0 || 2 * window + 1 > kMaxShifts ||
      2 * window + 1 > threads || batch < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t st = cudaSetDevice(device);
  if (st != cudaSuccess) return static_cast<int>(st);
  if (batch == 0) return 0;
  psm_match_kernel<<<batch, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      ref_r, ref_bad, cur_r, pair_ok, fi, init, pose, err, fail, n, window, dfi,
      min_range, max_range, weighting, static_cast<float>(min_valid_points),
      max_iters, change_weight_it);
  return static_cast<int>(cudaGetLastError());
}

const char* psm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
