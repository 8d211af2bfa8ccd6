// Fused PSM scan matcher (kernel K1) for NVIDIA Hopper, sm_90a.
//
// Replaces the TPU kernel laser_slam_tpu/ops/pallas/psm_kernel.py
// (match_psm_pallas -> pl.pallas_call -> _kernel -> _one_pair) and computes
// the function of the plain laser_slam_tpu_torch/ops/psm.match_psm: a whole
// polar scan match per pair, at most MAX_ITER/2 = 15 solver iterations of
//   projection of cur into ref's bearing grid (minimum interpolated range per
//   bin, first pair on ties, its facing decides occlusion) -> orientation
//   search over 2W+1 bin shifts with parabolic refinement -> re-projection ->
//   Cauchy-weighted 2x2 translation solve,
// stopping after 3 consecutive small steps or on failure; then, optionally,
// the error index of psm.error_index at the final pose as an epilogue.
//
// Two entries share one set of device functions:
//   psm_match_kernel  one block per pair, any batch (the whole-log batch);
//   psm_chain_kernel  pass 1 of the keyframe odometry for a whole log in one
//                     launch: the step's two matches run side by side in a
//                     cluster of two blocks, the carry never leaves the card.
//
// What bounds it on the card: latency. One pair is a chain of up to 15
// dependent iterations over a few KB; neither HBM bandwidth nor the FLOP rate
// is near its limit, and the keyframe chain is T-1 such matches in sequence.
// So the design shortens the serial depth of an iteration and takes the host
// out of the chain:
//   projection   a scatter: the thread of pair i writes only the few bins its
//                span covers, with a 64-bit atomicMin on (range, pair index)
//                in shared memory. The work is O(n x span), not O(n^2), and
//                the result is the dense projection's, bit for bit;
//   orientation  the (2W+1) x n sum is spread over the whole block, a thread per
//                (shift, chunk of bins), over two arrays in which a bad bin is
//                a NaN (two independent loads and no branch per term; a warp
//                per shift with lanes striding over the bins and a branch on
//                two byte masks took over half of an iteration's cycles);
//                every warp then adds the chunks' sums and takes the first
//                argmin by a shuffle reduction on (error, index);
//   solver state in registers, identical in every thread: the 2x2 solve, the
//                stop test and the pose update run redundantly, so there is
//                no single-thread section and 7 block barriers per iteration;
//                the block's seven sums take 9 shuffles a warp, not 35;
//   chain        scans stay in four rotating shared-memory slots (keyframe,
//                previous, current, next), the next scan is loaded into
//                registers while the present step iterates, and the two blocks
//                of a cluster trade their results (pose, fail, error index)
//                through distributed shared memory, one cluster barrier per
//                step.
// A cluster of two blocks was taken over one block with a half per pair: two
// halves of 544 threads (541 beams) exceed the 1024 threads of a block, and
// inside a block of its own each match keeps plain __syncthreads and leaves its
// iteration loop as soon as its own pair is done.
//
// No fast math: atan2f, sinf, cosf, IEEE division and square root, because
// identical fail flags with the plain matcher depend on it. Multiply-adds are
// left to the compiler's default contraction (-fmad=true): on 2671 consecutive
// pairs of the synthetic log the poses then lie within 4.8e-7 of the plain
// matcher's on the card, and within 1.0e-6 with contraction off (probe.py,
// `flags -- -fmad=false`); neither rounding is the plain version's bit for
// bit, since its sums run in another order.
// TPU artifacts of the Pallas kernel are not carried over: its polynomial
// atan2 (atan2f here), its any-occluder-at-min rule, 8-pair programs and lane
// padding.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxBeams = 544;            // 541 beams rounded up to a warp
constexpr int kMaxWarps = kMaxBeams / 32;
constexpr int kMaxShifts = 2 * 100 + 1;   // 2W+1 for W <= 100
constexpr int kMaxChunks = 5;             // orientation search: chunks of bins
constexpr int kSums = 8;                  // block reduction width (7 sums used)
constexpr int kSlots = 4;                 // keyframe, previous, current, next
constexpr int kXch = 8;                   // floats a block hands its partner
constexpr float kEmpty = 100.0f;          // project.EMPTY_RANGE
constexpr float kLargeErr = 100.0f;       // psm.LARGE_ERR
constexpr float kMaxError = 1.0f;         // psm.MAX_ERROR
constexpr float kStopCond = 0.4f;         // psm.STOP_COND
constexpr float kNoOverlap = 1e6f;        // error_index where no beam agrees
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr float kBinMargin = 0.0625f;     // scatter: slack of the candidate bins
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  int n, window;
  float dfi, min_range, max_range, weighting, min_valid;
  int max_iters, change_weight_it;
};

// One preprocessed scan in shared memory.
struct ScanSlot {
  float r[kMaxBeams];
  uint8_t bad[kMaxBeams];
  uint8_t ok[kMaxBeams];     // pair (i-1, i) usable for interpolation
};

// Scratch of one match.
struct Work {
  unsigned long long key[kMaxBeams];   // per bin: (ordered range bits, pair)
  float fi[kMaxBeams];
  float phi[kMaxBeams];
  float rr[kMaxBeams];
  float new_m[kMaxBeams];              // projected range, NaN where bad
  float ref_m[kMaxBeams];              // reference range, NaN where bad
  uint8_t occl[kMaxBeams];
  uint8_t cover[kMaxBeams];
  float part_e[kMaxChunks][kMaxShifts];   // orientation: sums per chunk
  int part_n[kMaxChunks][kMaxShifts];
  float err[kMaxShifts];
  float red[kSums][kMaxWarps];
};

// The calling thread's place in the block and its bin's constants.
struct Thread {
  int tid, lane, warp, nwarps;
  float fi_j, co_j, si_j;
  float inv_dfi;
};

// Result of one match, identical in every thread of the block.
struct MatchOut {
  float x, y, th, avg;
  int fail, iters;
  float ex, ey;
  int en;
};

// Maps a float to 32 bits that order as the float does (negatives included;
// -0 counts as +0), so that an unsigned minimum over (bits << 32 | pair)
// is the least range and, on ties, the first pair.
__device__ __forceinline__ unsigned long long pack_key(float v, int pair) {
  v += 0.0f;
  uint32_t b = __float_as_uint(v);
  b = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return (static_cast<unsigned long long>(b) << 32) | static_cast<uint32_t>(pair);
}

__device__ __forceinline__ float key_value(unsigned long long k) {
  uint32_t b = static_cast<uint32_t>(k >> 32);
  b = (b & 0x80000000u) ? (b & 0x7fffffffu) : ~b;
  return __uint_as_float(b);
}

__device__ __forceinline__ float quiet_nan() { return __int_as_float(0x7fc00000); }

// se2.normalize_angle: remainder(a + pi, 2 pi) - pi, the remainder taking the
// divisor's sign.
__device__ __forceinline__ float wrap_angle(float a) {
  float m = fmodf(a + kPi, kTwoPi);
  if (m != 0.0f && m < 0.0f) m += kTwoPi;
  return m - kPi;
}

__device__ __forceinline__ int small_step(int cnt, float dx, float dy, float dth) {
  float m = 100.0f * (fabsf(dx) + fabsf(dy)) + fabsf(dth);
  return m < kStopCond ? cnt + 1 : 0;
}

// Projects the scan (cur_r, cur_ok) posed at (ax, ay, ath) onto the reference
// bearings; returns the calling thread's own bin (tid < n) in new_r / new_bad.
// With `publish` every bin is also written to w.new_m (NaN where bad) and the
// function ends on a barrier. The result is project.scan_project's: pair 0 is
// never valid, so a bin that no pair covers, and one whose covering pairs all
// reach kEmpty, keep the initial key (kEmpty, pair 0).
__device__ void project(Work& w, const Params& p, const Thread& t,
                        const float* cur_r, const uint8_t* cur_ok, float ax,
                        float ay, float ath, bool publish, float& new_r,
                        bool& new_bad) {
  const int n = p.n, tid = t.tid;
  if (tid < n) {
    float ang = ath + t.fi_j;
    float r = cur_r[tid];
    float x = r * cosf(ang) + ax;
    float y = r * sinf(ang) + ay;
    float phi = atan2f(y, x);
    if (x < 0.0f && y < 0.0f) phi += kTwoPi;   // third-quadrant lift
    w.phi[tid] = phi;
    w.rr[tid] = sqrtf(x * x + y * y);
    w.key[tid] = pack_key(kEmpty, 0);
    w.cover[tid] = 0;
  }
  __syncthreads();
  if (tid < n) {
    const int im1 = tid == 0 ? n - 1 : tid - 1;
    const float phi = w.phi[tid], phi0 = w.phi[im1];
    const float rr0 = w.rr[im1];
    const float dphi = phi - phi0;
    w.occl[tid] = phi <= phi0;
    if (tid > 0 && cur_ok[tid] && fabsf(dphi) < kPi) {
      const float lo = fminf(phi0, phi), hi = fmaxf(phi0, phi);
      const float drr = w.rr[tid] - rr0;
      const float dph = fabsf(dphi) < 1e-9f ? 1e-9f : dphi;
      // Candidate bins from the grid's step, kBinMargin of a bin wider on each
      // side; the comparison against the bearings themselves decides. (The
      // bearings lie within 1e-4 of a bin of their ideal grid and these two
      // quotients round by less than 1e-3 of a bin at 541 beams.)
      const float fi0 = w.fi[0];
      const float flo = ceilf((lo - fi0) * t.inv_dfi - kBinMargin);
      const float fhi = floorf((hi - fi0) * t.inv_dfi + kBinMargin);
      const int jlo = static_cast<int>(fmaxf(flo, 0.0f));
      const int jhi = static_cast<int>(fminf(fhi, static_cast<float>(n - 1)));
      for (int j = jlo; j <= jhi; ++j) {
        const float f = w.fi[j];
        if (f >= lo && f <= hi) {
          const float u = (f - phi0) / dph;
          const float v = rr0 + drr * u;
          w.cover[j] = 1;
          if (v == v) atomicMin(&w.key[j], pack_key(v, tid));
        }
      }
    }
  }
  __syncthreads();
  new_r = kEmpty;
  new_bad = true;
  if (tid < n) {
    const unsigned long long k = w.key[tid];
    const int win = static_cast<int>(static_cast<uint32_t>(k));
    new_r = key_value(k);
    new_bad = !w.cover[tid] || w.occl[win];
    if (publish) w.new_m[tid] = new_bad ? quiet_nan() : new_r;
  }
  if (publish) __syncthreads();
}

// Sums the eight values v[0..8) over the warp with 9 shuffles instead of 40:
// at each of the first three butterfly steps a lane keeps half of its values
// and hands the other half to its partner. Returns the warp's sum of value
// q = (lane >> 2) & 7 (bits 4, 3, 2 of the lane pick it, most significant
// first); the additions are those of a plain xor butterfly, pair for pair.
__device__ __forceinline__ float warp_sums8(const float (&v)[kSums], int lane) {
  const bool hi16 = lane & 16, hi8 = lane & 8, hi4 = lane & 4;
  float a[4], b[2];
  for (int i = 0; i < 4; ++i) {
    a[i] = (hi16 ? v[i + 4] : v[i]) + __shfl_xor_sync(kFull, hi16 ? v[i] : v[i + 4], 16);
  }
  for (int i = 0; i < 2; ++i) {
    b[i] = (hi8 ? a[i + 2] : a[i]) + __shfl_xor_sync(kFull, hi8 ? a[i] : a[i + 2], 8);
  }
  float c = (hi4 ? b[1] : b[0]) + __shfl_xor_sync(kFull, hi4 ? b[0] : b[1], 4);
  c += __shfl_xor_sync(kFull, c, 2);
  c += __shfl_xor_sync(kFull, c, 1);
  return c;
}

// Sums v[0..8) over the block; every thread gets the same sums (the warps'
// partial sums are added in warp order by each thread).
__device__ __forceinline__ void block_sums(Work& w, const Thread& t, float (&v)[kSums]) {
  const float x = warp_sums8(v, t.lane);
  if ((t.lane & 3) == 0) w.red[(t.lane >> 2) & 7][t.warp] = x;
  __syncthreads();
  for (int q = 0; q < kSums; ++q) {
    float acc = 0.0f;
    for (int k = 0; k < t.nwarps; ++k) acc += w.red[q][k];
    v[q] = acc;
  }
}

// One whole match of (cur_r, cur_ok) against (ref_r, ref_bad) from the pose
// (ax, ay, ath), then the error index against (eref_r, eref_bad) when eref_r
// is not null. All scan pointers are shared memory that the block can already
// see. Every thread returns the same result.
__device__ MatchOut match_pair(Work& w, const Params& p, const Thread& t,
                               const float* ref_r, const uint8_t* ref_bad,
                               const float* cur_r, const uint8_t* cur_ok,
                               const float* eref_r, const uint8_t* eref_bad,
                               float ax, float ay, float ath) {
  const int n = p.n, tid = t.tid, window = p.window;
  const int n_shift = 2 * window + 1;
  const int chunks = min(kMaxChunks, static_cast<int>(blockDim.x) / n_shift);
  const int chunk_len = (n + chunks - 1) / chunks;
  if (tid < n) w.ref_m[tid] = ref_bad[tid] ? quiet_nan() : ref_r[tid];
  float cx = 1e6f, cy = 1e6f, cth = 1e6f;   // last corrections
  float C = p.weighting, avg = kLargeErr;
  int small = 0, iters = 0;
  bool fail = false, done = false;

  for (int it = 0; it < p.max_iters && !done; ++it) {
    ++iters;
    float nr;
    bool nbad;

    // -- orientation half-step --
    project(w, p, t, cur_r, cur_ok, ax, ay, ath, true, nr, nbad);
    if (tid < chunks * n_shift) {
      const int k = tid % n_shift, c = tid / n_shift;
      const int di = k - window;
      const int j0 = max(di < 0 ? -di : 0, c * chunk_len);
      const int j1 = min(di > 0 ? n - di : n, (c + 1) * chunk_len);
      float e = 0.0f;
      int cnt = 0;
#pragma unroll 4
      for (int j = j0; j < j1; ++j) {
        const float d = w.new_m[j] - w.ref_m[j + di];   // NaN where either is bad
        const bool ok = d == d;
        e += ok ? fabsf(d) : 0.0f;
        cnt += ok;
      }
      w.part_e[c][k] = e;
      w.part_n[c][k] = cnt;
    }
    __syncthreads();
    // Every warp alike: the shifts' mean errors (each warp writes the same
    // values to w.err, and reads back only what its own lanes wrote), then
    // their first argmin.
    float emin = INFINITY;
    int imin = n_shift;
    for (int k = t.lane; k < n_shift; k += 32) {
      float e = 0.0f;
      int cnt = 0;
      for (int c = 0; c < chunks; ++c) {
        e += w.part_e[c][k];
        cnt += w.part_n[c][k];
      }
      e = cnt > 0 ? e / static_cast<float>(cnt) : kLargeErr;
      w.err[k] = e;
      if (e < emin) {
        emin = e;
        imin = k;
      }
    }
    __syncwarp();
    for (int off = 16; off > 0; off >>= 1) {
      const float oe = __shfl_xor_sync(kFull, emin, off);
      const int oi = __shfl_xor_sync(kFull, imin, off);
      if (oe < emin || (oe == emin && oi < imin)) {
        emin = oe;
        imin = oi;
      }
    }
    if (imin >= n_shift) {   // no finite error at all
      imin = 0;
      emin = w.err[0];
    }
    float dth = static_cast<float>(imin - window) * p.dfi;
    {
      const float em1 = w.err[imin > 0 ? imin - 1 : 0];
      const float ep1 = w.err[imin < n_shift - 1 ? imin + 1 : n_shift - 1];
      const float curv = em1 + ep1 - 2.0f * emin;
      const bool ok = imin >= 1 && imin < n_shift - 1 && fabsf(curv) > 1e-4f &&
                      em1 > emin && ep1 > emin;
      const float d = ok ? (em1 - ep1) / curv / 2.0f : 0.0f;
      dth = dth + (fabsf(d) < 1.0f ? d : 0.0f) * p.dfi;
    }
    small = small_step(small, cx, cy, cth);
    small = small_step(small, cx, cy, dth);
    ath = ath + dth;
    cth = dth;
    fail = emin >= kLargeErr;
    if (it == p.change_weight_it) C = C / 50.0f;

    // -- translation half-step --
    project(w, p, t, cur_r, cur_ok, ax, ay, ath, false, nr, nbad);
    float v[kSums] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (tid < n) {
      const float dr = ref_r[tid] - nr;
      const bool valid = !ref_bad[tid] && !nbad && nr < p.max_range &&
                         nr > p.min_range && fabsf(dr) < kMaxError;
      const float wgt = valid ? C / (dr * dr + C) : 0.0f;
      v[0] = wgt * t.co_j * dr;
      v[1] = wgt * t.si_j * dr;
      v[2] = wgt * t.co_j * t.co_j;
      v[3] = wgt * t.co_j * t.si_j;
      v[4] = wgt * t.si_j * t.si_j;
      v[5] = valid ? 1.0f : 0.0f;
      v[6] = fabsf(dr);
    }
    block_sums(w, t, v);
    {
      const float hw1 = v[0], hw2 = v[1], h11 = v[2], h12 = v[3], h22 = v[4];
      const float cnt = v[5];
      float det = h11 * h22 - h12 * h12;
      const bool fail_t = cnt < p.min_valid || det < 1e-3f;
      if (fail_t) det = 1.0f;
      float dx = (h22 * hw1 - h12 * hw2) / det;
      float dy = (-h12 * hw1 + h11 * hw2) / det;
      fail = fail || fail_t;
      if (fail) {
        dx = 0.0f;
        dy = 0.0f;
      } else {
        avg = v[6] / fmaxf(cnt, 1.0f);
      }
      ax += dx;
      ay += dy;
      cx = dx;
      cy = dy;
      done = fail || small >= 3;
    }
  }

  MatchOut out;
  out.x = ax;
  out.y = ay;
  out.th = wrap_angle(ath);
  out.avg = avg;
  out.fail = fail ? 1 : 0;
  out.iters = iters;
  out.ex = out.ey = kNoOverlap;
  out.en = 0;
  if (eref_r != nullptr) {
    // psm.error_index at the wrapped final pose.
    float nr;
    bool nbad;
    project(w, p, t, cur_r, cur_ok, ax, ay, out.th, false, nr, nbad);
    float s[kSums] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (tid < n) {
      const float delta = fabsf(nr - eref_r[tid]);
      if (!nbad && !eref_bad[tid] && delta < 1.0f) {
        const float dc = delta * t.co_j, ds = delta * t.si_j;
        s[0] = dc * dc;
        s[1] = ds * ds;
        s[2] = 1.0f;
      }
    }
    block_sums(w, t, s);
    if (s[2] > 0.0f) {
      out.ex = s[0] / s[2];
      out.ey = s[1] / s[2];
      out.en = static_cast<int>(s[2]);
    }
  }
  return out;
}

__device__ __forceinline__ Thread make_thread(Work& w, const float* fi, int n, float dfi) {
  Thread t;
  t.tid = threadIdx.x;
  t.lane = t.tid & 31;
  t.warp = t.tid >> 5;
  t.nwarps = blockDim.x >> 5;
  t.fi_j = t.co_j = t.si_j = 0.0f;
  t.inv_dfi = 1.0f / dfi;
  if (t.tid < n) {
    t.fi_j = fi[t.tid];
    t.co_j = cosf(t.fi_j);
    t.si_j = sinf(t.fi_j);
    w.fi[t.tid] = t.fi_j;
  }
  return t;
}

// Batch entry: block b matches pair b. eref_r / eref_bad / err_x / err_y /
// err_n may all be null (no error index).
__global__ void __launch_bounds__(kMaxBeams)
psm_match_kernel(const float* __restrict__ ref_r, const uint8_t* __restrict__ ref_bad,
                 const float* __restrict__ cur_r, const uint8_t* __restrict__ pair_ok,
                 const float* __restrict__ eref_r, const uint8_t* __restrict__ eref_bad,
                 const float* __restrict__ fi, const float* __restrict__ init,
                 float* __restrict__ pose, float* __restrict__ err,
                 uint8_t* __restrict__ fail, int* __restrict__ iters,
                 float* __restrict__ err_x, float* __restrict__ err_y,
                 int* __restrict__ err_n, Params p) {
  __shared__ Work w;
  __shared__ ScanSlot sref, scur, seref;
  const int b = blockIdx.x;
  const size_t row = static_cast<size_t>(b) * p.n;
  const Thread t = make_thread(w, fi, p.n, p.dfi);
  const bool with_index = eref_r != nullptr;
  if (t.tid < p.n) {
    sref.r[t.tid] = ref_r[row + t.tid];
    sref.bad[t.tid] = ref_bad[row + t.tid];
    scur.r[t.tid] = cur_r[row + t.tid];
    scur.ok[t.tid] = pair_ok[row + t.tid];
    if (with_index) {
      seref.r[t.tid] = eref_r[row + t.tid];
      seref.bad[t.tid] = eref_bad[row + t.tid];
    }
  }
  __syncthreads();
  const MatchOut m = match_pair(w, p, t, sref.r, sref.bad, scur.r, scur.ok,
                                with_index ? seref.r : nullptr, seref.bad,
                                init[3 * b], init[3 * b + 1], init[3 * b + 2]);
  if (t.tid == 0) {
    pose[3 * b] = m.x;
    pose[3 * b + 1] = m.y;
    pose[3 * b + 2] = m.th;
    err[b] = m.avg;
    fail[b] = static_cast<uint8_t>(m.fail);
    iters[b] = m.iters;
    if (with_index) {
      err_x[b] = m.ex;
      err_y[b] = m.ey;
      err_n[b] = m.en;
    }
  }
}

__device__ __forceinline__ void compose(const float (&a)[3], const float (&b)[3],
                                        float (&out)[3]) {
  const float c = cosf(a[2]), s = sinf(a[2]);
  out[0] = a[0] + c * b[0] - s * b[1];
  out[1] = a[1] + s * b[0] + c * b[1];
  out[2] = wrap_angle(a[2] + b[2]);
}

// Chain entry: pass 1 of odometry.odometry_keyframe (odometry._step for scans
// 1..T-1) in one launch of one cluster. Block 0 matches the current scan
// against the keyframe from the carried prior, block 1 against the previous
// scan from zero; both take their error index against the previous scan. Each
// block then reads the partner's result through distributed shared memory and
// both update identical copies of the carry (slot numbers and three poses) in
// registers. Every thread of both blocks reaches the one cluster barrier of
// every step: a pair that is done early leaves only its iteration loop.
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kMaxBeams)
psm_chain_kernel(const float* __restrict__ ranges, const uint8_t* __restrict__ bad,
                 const uint8_t* __restrict__ pair_ok, const float* __restrict__ fi,
                 float* __restrict__ poses, uint8_t* __restrict__ switched,
                 uint8_t* __restrict__ discarded, uint8_t* __restrict__ deep,
                 int* __restrict__ iters, int n_scans, Params p,
                 float switch_thresh, float weak_thresh) {
  __shared__ Work w;
  __shared__ ScanSlot slot[kSlots];
  __shared__ float xch[2][kXch];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const float* peer_xch = cluster.map_shared_rank(&xch[0][0], rank ^ 1u);
  const int n = p.n;
  const Thread t = make_thread(w, fi, n, p.dfi);
  const int tid = t.tid;

  if (tid < n) {
    for (int k = 0; k < 2 && k < n_scans; ++k) {
      const size_t at = static_cast<size_t>(k) * n + tid;
      slot[k].r[tid] = ranges[at];
      slot[k].bad[tid] = bad[at];
      slot[k].ok[tid] = pair_ok[at];
    }
  }
  // The partner's shared memory must exist before anyone reads it, and the
  // slots must be visible to the block.
  cluster.sync();

  int ref_s = 0, last_s = 0, cur_s = 1, next_s = 2;
  float ref_g[3] = {0.f, 0.f, 0.f}, last_g[3] = {0.f, 0.f, 0.f};
  float prior[3] = {0.f, 0.f, 0.f};

  for (int i = 1; i < n_scans; ++i) {
    // The next scan travels to registers while this step iterates.
    const bool more = i + 1 < n_scans && tid < n;
    float nxt_r = 0.0f;
    uint8_t nxt_bad = 0, nxt_ok = 0;
    if (more) {
      const size_t at = static_cast<size_t>(i + 1) * n + tid;
      nxt_r = ranges[at];
      nxt_bad = bad[at];
      nxt_ok = pair_ok[at];
    }

    const ScanSlot& ref = slot[rank == 0 ? ref_s : last_s];
    const ScanSlot& last = slot[last_s];
    const ScanSlot& cur = slot[cur_s];
    const MatchOut m = match_pair(
        w, p, t, ref.r, ref.bad, cur.r, cur.ok, last.r, last.bad,
        rank == 0 ? prior[0] : 0.0f, rank == 0 ? prior[1] : 0.0f,
        rank == 0 ? prior[2] : 0.0f);

    if (more) {
      slot[next_s].r[tid] = nxt_r;
      slot[next_s].bad[tid] = nxt_bad;
      slot[next_s].ok[tid] = nxt_ok;
    }
    // Double-buffered: the partner reads buffer i&1 after this step's
    // barrier, and it is written again only after the next step's.
    float* mine = xch[i & 1];
    if (tid == 0) {
      mine[0] = m.x;
      mine[1] = m.y;
      mine[2] = m.th;
      mine[3] = static_cast<float>(m.fail);
      mine[4] = m.ex;
      mine[5] = m.ey;
      mine[6] = static_cast<float>(m.iters);
    }
    cluster.sync();
    const float* peer = peer_xch + (i & 1) * kXch;
    const float* r0 = rank == 0 ? mine : peer;   // keyframe match
    const float* r1 = rank == 0 ? peer : mine;   // previous-scan match
    const float pose0[3] = {r0[0], r0[1], r0[2]};
    const float pose1[3] = {r1[0], r1[1], r1[2]};
    const bool fail0 = r0[3] != 0.0f, fail1 = r1[3] != 0.0f;
    const float err0 = sqrtf(r0[4] + r0[5]), err1 = sqrtf(r1[4] + r1[5]);
    const int it0 = static_cast<int>(r0[6]), it1 = static_cast<int>(r1[6]);

    // odometry._step, select for select.
    const bool need_switch = fail0 || err0 > switch_thresh;
    const bool bad2 = fail1 || err1 > weak_thresh;
    const bool disc = need_switch && fail1;
    const bool weak = need_switch && bad2;
    const bool keep = !disc;
    float rel[3], base[3], gpose[3], out_pose[3];
    for (int q = 0; q < 3; ++q) {
      rel[q] = need_switch ? pose1[q] : pose0[q];
      base[q] = need_switch ? last_g[q] : ref_g[q];
    }
    compose(base, rel, gpose);
    for (int q = 0; q < 3; ++q) {
      out_pose[q] = keep ? gpose[q] : last_g[q];
      if (keep) {
        ref_g[q] = base[q];
        last_g[q] = gpose[q];
        prior[q] = rel[q];
      }
    }
    if (keep) {
      if (need_switch) ref_s = last_s;
      last_s = cur_s;
    }
    // The next scan becomes the current one; the slot after it is one that
    // holds neither the keyframe, the previous nor the current scan.
    cur_s = next_s;
    for (int s = 0; s < kSlots; ++s) {
      if (s != ref_s && s != last_s && s != cur_s) next_s = s;
    }

    if (rank == 0 && tid == 0) {
      const size_t o = static_cast<size_t>(i - 1);
      poses[3 * o] = out_pose[0];
      poses[3 * o + 1] = out_pose[1];
      poses[3 * o + 2] = out_pose[2];
      switched[o] = need_switch && keep;
      discarded[o] = disc;
      deep[o] = weak || disc;
      iters[2 * o] = it0;
      iters[2 * o + 1] = it1;
    }
  }
  // No block may leave while its partner can still read its shared memory.
  cluster.sync();
}

Params make_params(int n, int window, float dfi, float min_range, float max_range,
                   float weighting, int min_valid_points, int max_iters,
                   int change_weight_it) {
  Params p;
  p.n = n;
  p.window = window;
  p.dfi = dfi;
  p.min_range = min_range;
  p.max_range = max_range;
  p.weighting = weighting;
  p.min_valid = static_cast<float>(min_valid_points);
  p.max_iters = max_iters;
  p.change_weight_it = change_weight_it;
  return p;
}

bool shape_ok(int n, int window) {
  return n >= 2 && n <= kMaxBeams && window >= 0 && 2 * window + 1 <= kMaxShifts &&
         2 * window + 1 <= ((n + 31) / 32) * 32 && window < n;
}

}  // namespace

extern "C" {

// Launches one block per pair on `stream`. Inputs are row-major [batch, n]
// (bools as bytes), fi is [n], init and pose are [batch, 3], iters [batch].
// eref_r, eref_bad, err_x, err_y, err_n are either all given ([batch, n] and
// [batch]) or all null. Returns the CUDA error code of the launch (0 on
// success); does not synchronise.
int psm_match_launch(const float* ref_r, const uint8_t* ref_bad, const float* cur_r,
                     const uint8_t* pair_ok, const float* eref_r,
                     const uint8_t* eref_bad, const float* fi, const float* init,
                     float* pose, float* err, uint8_t* fail, int* iters, float* err_x,
                     float* err_y, int* err_n, int batch, int n, int window,
                     float dfi, float min_range, float max_range, float weighting,
                     int min_valid_points, int max_iters, int change_weight_it,
                     int device, void* stream) {
  const bool with_index = eref_r != nullptr;
  if (!shape_ok(n, window) || batch < 0 ||
      with_index != (eref_bad != nullptr) || with_index != (err_x != nullptr) ||
      with_index != (err_y != nullptr) || with_index != (err_n != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t st = cudaSetDevice(device);
  if (st != cudaSuccess) return static_cast<int>(st);
  if (batch == 0) return 0;
  const int threads = ((n + 31) / 32) * 32;
  psm_match_kernel<<<batch, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      ref_r, ref_bad, cur_r, pair_ok, eref_r, eref_bad, fi, init, pose, err, fail,
      iters, err_x, err_y, err_n,
      make_params(n, window, dfi, min_range, max_range, weighting, min_valid_points,
                  max_iters, change_weight_it));
  return static_cast<int>(cudaGetLastError());
}

// Launches the keyframe chain over a [n_scans, n] log (ranges, bad, pair_ok;
// bools as bytes) as one cluster of two blocks on `stream`. Outputs have
// n_scans - 1 rows: poses [., 3], the three flags [.], iters [., 2]. Returns
// the CUDA error code of the launch; does not synchronise.
int psm_chain_launch(const float* ranges, const uint8_t* bad, const uint8_t* pair_ok,
                     const float* fi, float* poses, uint8_t* switched,
                     uint8_t* discarded, uint8_t* deep, int* iters, int n_scans,
                     int n, int window, float dfi, float min_range, float max_range,
                     float weighting, int min_valid_points, int max_iters,
                     int change_weight_it, float switch_thresh, float weak_thresh,
                     int device, void* stream) {
  if (!shape_ok(n, window) || n_scans < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t st = cudaSetDevice(device);
  if (st != cudaSuccess) return static_cast<int>(st);
  if (n_scans == 1) return 0;
  const int threads = ((n + 31) / 32) * 32;
  psm_chain_kernel<<<2, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      ranges, bad, pair_ok, fi, poses, switched, discarded, deep, iters, n_scans,
      make_params(n, window, dfi, min_range, max_range, weighting, min_valid_points,
                  max_iters, change_weight_it),
      switch_thresh, weak_thresh);
  return static_cast<int>(cudaGetLastError());
}

const char* psm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
