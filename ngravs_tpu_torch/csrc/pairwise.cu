// K1a: the fused walk's pair-force kernel for Hopper (sm_90a).
//
// Replaces ngravs_tpu/ops/pairwise_pallas.py:make_pairwise_kernel in its
// single-law (all-Newton wiring), non-periodic, no-TreePM form, with the
// potential on or off.  It computes what the Pallas kernel computes: for
// every target of block b, the sum over the first n_src[b] rows of the
// block's packed source list of the Newton law with Gadget's cubic-spline
// softening, h = max(target fsoft, source soft).  Padding rows (gid -1) and
// self pairs are masked by a select; node rows (gid -2) count.  Outputs are
// the acceleration (G = 1), the optional potential and the valid-pair count.
//
// Layout: targets are 7 columns of n_blocks * group entries (x, y, z, mass,
// grav i32, fsoft, gid i32).  Sources are [n_blocks, 8, s_cap] f32 with rows
// x, y, z, mass, soft, count, grav, gid; rows 6/7 hold int32 bit patterns
// and are only ever reinterpreted (__float_as_int), never converted.
//
// Design: one thread block per target block, one thread per target (its
// position and accumulators in registers).  The block stages [8, TILE]
// source tiles in shared memory and loops over ceil(n_src[b] / TILE) tiles
// only; that loop bound replaces the Pallas early exit and DMA clamp.
// Accumulation is in f32, in source order.
//
// What bounds it: FP32 ALU work.  Each pair costs about 25 flops plus a
// square root and a division (two with the potential), with no tensor-core
// work and 32 bytes of shared-memory reads that every thread of the block
// shares.  With 64 threads a block and the walk's 128 blocks a launch, a
// launch fills well under one block per SM on 132 SMs at the occupancy the
// card allows, so the card is under-occupied.  More blocks per launch, or a
// split of each block's sources across warps, is the fix for a later change.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 256;
constexpr int MAX_GROUP = 256;

__device__ __forceinline__ float safe_inv(float x) {
  return x > 0.0f ? 1.0f / x : 0.0f;
}

template <bool WANT_POT>
__global__ void __launch_bounds__(MAX_GROUP)
pairwise_newton_kernel(const float* __restrict__ tx,
                       const float* __restrict__ ty,
                       const float* __restrict__ tz,
                       const float* __restrict__ tfsoft,
                       const int* __restrict__ tgid,
                       const float* __restrict__ spacked,
                       const int* __restrict__ n_src,
                       int group, int s_cap,
                       float* __restrict__ acc,
                       float* __restrict__ pot,
                       int* __restrict__ nia) {
  __shared__ float s_x[TILE], s_y[TILE], s_z[TILE], s_m[TILE], s_h[TILE];
  __shared__ int s_gid[TILE];

  const int b = blockIdx.x;
  const long t = static_cast<long>(b) * group + threadIdx.x;
  const float x = tx[t], y = ty[t], z = tz[t], hf = tfsoft[t];
  const int gid = tgid[t];
  const bool tvalid = gid >= 0;

  float ax = 0.0f, ay = 0.0f, az = 0.0f, pp = 0.0f;
  int nv = 0;

  const int ns = n_src[b];
  const float* src = spacked + static_cast<long>(b) * 8 * s_cap;
  for (int base = 0; base < ns; base += TILE) {
    const int cnt = min(TILE, ns - base);
    __syncthreads();
    for (int k = threadIdx.x; k < cnt; k += blockDim.x) {
      const int c = base + k;
      s_x[k] = src[0 * s_cap + c];
      s_y[k] = src[1 * s_cap + c];
      s_z[k] = src[2 * s_cap + c];
      s_m[k] = src[3 * s_cap + c];
      s_h[k] = src[4 * s_cap + c];
      s_gid[k] = __float_as_int(src[7 * s_cap + c]);
    }
    __syncthreads();
    for (int k = 0; k < cnt; ++k) {
      const int sgid = s_gid[k];
      const bool valid = tvalid && sgid != -1 && sgid != gid;
      const float dx = s_x[k] - x;
      const float dy = s_y[k] - y;
      const float dz = s_z[k] - z;
      const float r2 = dx * dx + dy * dy + dz * dz;
      const float r = sqrtf(r2);
      const float h = fmaxf(hf, s_h[k]);
      const float sm = s_m[k];
      float fac, p = 0.0f;
      if (r >= h) {
        // law / r: sm / r^2 * 1/r; potential -sm / r
        fac = sm * safe_inv(r2) * safe_inv(r);
        if (WANT_POT) p = -(sm * safe_inv(r));
      } else {
        // Gadget's cubic spline (reference ngravs.c:420-474)
        const float h_inv = safe_inv(h);
        const float u = r * h_inv;
        const float h_inv3 = h_inv * h_inv * h_inv;
        if (u < 0.5f) {
          fac = sm * h_inv3 * (10.666666666667f + u * u * (32.0f * u - 38.4f));
          if (WANT_POT)
            p = sm * h_inv *
                (-2.8f + u * u * (5.333333333333f + u * u * (6.4f * u - 9.6f)));
        } else {
          const float u_inv3 = safe_inv(u * u * u);
          fac = sm * h_inv3 *
                (21.333333333333f - 48.0f * u + 38.4f * u * u -
                 10.666666666667f * u * u * u - 0.066666666667f * u_inv3);
          if (WANT_POT)
            p = sm * h_inv *
                (-3.2f + 0.066666666667f * safe_inv(u) +
                 u * u * (10.666666666667f +
                          u * (-16.0f + u * (9.6f - 2.133333333333f * u))));
        }
      }
      // a select, not a multiply: an invalid pair's factor may be inf/NaN
      if (valid) {
        ax += fac * dx;
        ay += fac * dy;
        az += fac * dz;
        if (WANT_POT) pp += p;
        nv += 1;
      }
    }
  }
  acc[3 * t + 0] = ax;
  acc[3 * t + 1] = ay;
  acc[3 * t + 2] = az;
  if (WANT_POT) pot[t] = pp;
  nia[t] = nv;
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success).  `pot` may be null
// when want_pot is 0.  Launches on `stream` and does not synchronise.
extern "C" int ngravs_pairwise_newton(
    const float* tx, const float* ty, const float* tz, const float* tfsoft,
    const int* tgid, const float* spacked, const int* n_src, int n_blocks,
    int group, int s_cap, int want_pot, float* acc, float* pot, int* nia,
    void* stream) {
  if (n_blocks <= 0) return 0;
  if (group <= 0 || group > MAX_GROUP) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (want_pot) {
    pairwise_newton_kernel<true><<<n_blocks, group, 0, s>>>(
        tx, ty, tz, tfsoft, tgid, spacked, n_src, group, s_cap, acc, pot, nia);
  } else {
    pairwise_newton_kernel<false><<<n_blocks, group, 0, s>>>(
        tx, ty, tz, tfsoft, tgid, spacked, n_src, group, s_cap, acc, pot, nia);
  }
  return static_cast<int>(cudaGetLastError());
}
