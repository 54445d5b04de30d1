// K1: the fused walk's pair-force kernel for Hopper (sm_90a).
//
// Replaces ngravs_tpu/ops/pairwise_pallas.py:make_pairwise_kernel (its
// pl.pallas_call at :205), all of it: one law or a multi-law ngravs wiring
// (K1b, with the accumulator count row), the periodic minimum image (K1c)
// and the TreePM closed-form short-range truncation (K1d), with the
// potential on or off.  It computes what the Pallas kernel computes: for
// every target of block b, the sum over the first n_src[b] rows of the
// block's packed source list of the law wired to (target gravity, source
// gravity), with Gadget's cubic-spline softening below h = max(target
// fsoft, source soft) and law / r above it.  Padding rows (gid -1) and self
// pairs are masked by a select; node rows (gid -2) count.  Outputs are the
// acceleration (G = 1), the optional potential and the valid-pair count.
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
// Accumulation is in f32, per tile and then across tiles.  The five
// features are template flags <WANT_POT, PERIODIC, TREEPM, MULTI_LAW,
// USE_COUNT>, so each run pays only for what its configuration uses; the
// all-false instance is K1a (one Newton law).  The TPU kernel ORs one
// mask per law group over every pair; here the wiring becomes a small
// table (law index per gravity slot; kind and up to four parameters per
// law), staged in shared memory, and each pair looks its law up and runs
// that law only.  The TreePM truncation uses the Abramowitz-Stegun erfc
// of the JAX package and expf.
//
// What bounds it: FP32 ALU work.  Each pair costs about 25 flops plus a
// square root and a division in the Newton case, a few exponentials more
// under TreePM or Yukawa, with no tensor-core work and 32 to 40 bytes of
// shared-memory reads that every thread of the block shares.  With 64
// threads a block and the walk's 128 blocks a launch, the card is
// under-occupied, and a warp whose targets belong to different gravities
// diverges on the law switch.  More blocks per launch, a split of each
// block's sources across warps, and targets sorted by gravity inside a
// block are the fixes for a later change.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 256;
constexpr int MAX_GROUP = 256;
constexpr int MAX_NG = 8;      // gravity cap of the law table
constexpr int MAX_LAWS = 16;   // distinct laws of one wiring

// law kinds (ngravs_tpu_torch/ops/pairwise.py:_law_entry)
constexpr int KIND_NONE = 0;
constexpr int KIND_NEWTON = 1;
constexpr int KIND_NEGNEWTON = 2;
constexpr int KIND_YUKAWA = 3;     // par: m, 2a, b, a sqrt(pi)
constexpr int KIND_COLOYUK = 4;    // par: as Yukawa
constexpr int KIND_BAMBAM = 5;     // par: 4 pi eps
constexpr int KIND_SOURCEBAM = 6;  // par: 4 pi eps
constexpr int KIND_TARGETBAM = 7;  // par: 4 pi eps

constexpr int F_POT = 1, F_PERIODIC = 2, F_TREEPM = 4, F_MULTI = 8,
              F_COUNT = 16;

constexpr float SQRT_PI = 1.7724538509055159f;
constexpr float PI_F = 3.14159265358979323846f;

}  // namespace

// The wiring as the kernel reads it; mirrored by a ctypes Structure.
struct NgravsLawTable {
  int n_gravs;
  int n_laws;
  int slot[MAX_NG * MAX_NG];   // law of (target gravity, source gravity)
  int kind[MAX_LAWS];
  float par[MAX_LAWS * 4];
};

namespace {

__device__ __forceinline__ float safe_inv(float x) {
  return x > 0.0f ? 1.0f / x : 0.0f;
}

// Abramowitz-Stegun 7.1.26 without the Gaussian: e^{x^2} erfc(x), x >= 0
__device__ __forceinline__ float erfcx_pos(float x) {
  const float t = 1.0f / (1.0f + 0.3275911f * x);
  return t * (0.254829592f +
              t * (-0.284496736f +
                   t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
}

__device__ __forceinline__ float erfc_any(float x) {
  const float ax = fabsf(x);
  const float e = erfcx_pos(ax) * expf(-ax * ax);
  return x >= 0.0f ? e : 2.0f - e;
}

// Gadget's cubic spline (reference ngravs.c:420-474)
__device__ __forceinline__ float plummer_spline(float sm, float h, float r) {
  const float h_inv = safe_inv(h);
  const float u = r * h_inv;
  const float h_inv3 = h_inv * h_inv * h_inv;
  if (u < 0.5f)
    return sm * h_inv3 * (10.666666666667f + u * u * (32.0f * u - 38.4f));
  const float u_inv3 = safe_inv(u * u * u);
  return sm * h_inv3 *
         (21.333333333333f - 48.0f * u + 38.4f * u * u -
          10.666666666667f * u * u * u - 0.066666666667f * u_inv3);
}

__device__ __forceinline__ float plummer_spline_pot(float sm, float h,
                                                    float r) {
  const float h_inv = safe_inv(h);
  const float u = r * h_inv;
  if (u < 0.5f)
    return sm * h_inv *
           (-2.8f + u * u * (5.333333333333f + u * u * (6.4f * u - 9.6f)));
  return sm * h_inv *
         (-3.2f + 0.066666666667f * safe_inv(u) +
          u * u * (10.666666666667f +
                   u * (-16.0f + u * (9.6f - 2.133333333333f * u))));
}

// BAM cores (reference ngravs.c:495-760), Taylor form below r eta = 0.1
__device__ __forceinline__ float bam_force(float rho, float eta, float r) {
  const float reta = r * eta;
  const float reta2 = reta * reta;
  const float eta3 = eta * eta * eta;
  if (reta < 0.1f)
    return rho * eta3 *
           (2.0f * r / 3.0f - 4.0f * reta2 * r / 5.0f +
            6.0f * reta2 * reta2 * r / 7.0f);
  return rho * eta3 *
         (atanf(reta) * safe_inv(reta2) * safe_inv(eta) -
          safe_inv(reta * eta * (1.0f + reta2)));
}

__device__ __forceinline__ float bam_spline(float rho, float eta, float r) {
  const float reta = r * eta;
  const float reta2 = reta * reta;
  const float eta3 = eta * eta * eta;
  if (reta < 0.1f)
    return rho * eta3 *
           (2.0f / 3.0f - 4.0f * reta2 / 5.0f + 6.0f * reta2 * reta2 / 7.0f);
  return rho * eta3 *
         (atanf(reta) * safe_inv(reta2 * reta) -
          safe_inv(reta2 * (1.0f + reta2)));
}

__device__ __forceinline__ float bam_pot(float rho, float eta, float r) {
  const float reta = r * eta;
  const float reta2 = reta * reta;
  const float reta4 = reta2 * reta2;
  if (reta < 0.1f)
    return rho * eta *
           (1.0f - reta2 / 3.0f + reta4 / 5.0f - reta2 * reta4 / 7.0f);
  return rho * atanf(reta) * safe_inv(r);
}

__device__ __forceinline__ float bam_eta(int kind, float c, float tm,
                                         float sm, float n) {
  if (kind == KIND_BAMBAM) return c / (tm + sm / n);
  if (kind == KIND_SOURCEBAM) return c * n / sm;
  return c / tm;  // KIND_TARGETBAM
}

// Yukawa TreePM ratios sf (force) and sp (potential) of u = r / (2a)
__device__ __forceinline__ float yukawa_sf(const float* par, float u) {
  const float m = par[0], b = par[2];
  const float r = fmaxf(par[1] * u, 1e-37f);
  const float eub = expf(-u * u - b * b);
  const float A = expf(-m * r) * erfc_any(u - b);
  const float B = erfcx_pos(u + b) * eub;
  const float f_sr = (A + B) / (2.0f * r * r) - (m / (2.0f * r)) * (B - A) +
                     eub / (par[3] * r);
  const float f_full = expf(-m * r) * (m / r + 1.0f / (r * r));
  return f_sr / fmaxf(f_full, 1e-37f);
}

__device__ __forceinline__ float yukawa_sp(const float* par, float u) {
  const float b = par[2];
  const float d = u - b;
  return 0.5f * (erfc_any(d) + erfcx_pos(u + b) * expf(-(d * d)));
}

__device__ __forceinline__ float newton_sp(float u) {
  return erfcx_pos(u) * expf(-u * u);
}

__device__ __forceinline__ float newton_sf(float u) {
  return newton_sp(u) + 2.0f * u / SQRT_PI * expf(-u * u);
}

// One pair of one law: force factor (acc += fac * d) and the signed
// potential term, with the softening switch and, under TreePM, the
// closed-form truncation (forcetree.c:1958-2027).
template <bool WANT_POT, bool TREEPM>
__device__ __forceinline__ void law_pair(int kind, const float* par, float tm,
                                         float sm, float r2, float r, float h,
                                         float n, float inv2a, float& fac,
                                         float& pot) {
  fac = 0.0f;
  pot = 0.0f;
  float u = 0.0f;
  if (TREEPM) {
    u = r * inv2a;
    if (!(u < 3.0f)) return;
  }
  if (r >= h) {
    float accel, potential;
    float sf = 1.0f, sp = 1.0f;
    switch (kind) {
      case KIND_NEWTON:
        accel = sm * safe_inv(r2);
        potential = sm * safe_inv(r);
        if (TREEPM) { sf = newton_sf(u); sp = newton_sp(u); }
        break;
      case KIND_NEGNEWTON:
        accel = -sm * safe_inv(r2);
        potential = -sm * safe_inv(r);
        break;
      case KIND_YUKAWA: {
        const float m = par[0];
        const float e = expf(-r * m);
        accel = sm * e * (m * safe_inv(r) + safe_inv(r2));
        potential = sm * e * safe_inv(r);
        if (TREEPM) { sf = yukawa_sf(par, u); sp = yukawa_sp(par, u); }
        break;
      }
      case KIND_COLOYUK: {
        const float m = par[0];
        const float e = expf(-r * m);
        accel = sm * e * (m * safe_inv(r) + safe_inv(r2)) + sm * safe_inv(r2);
        potential = sm * e * safe_inv(r) + sm * safe_inv(r);
        if (TREEPM) {
          const float rr = fmaxf(par[1] * u, 1e-37f);
          const float ey = expf(-m * rr);
          const float fn = 1.0f / (rr * rr);
          const float fy = ey * (m / rr + 1.0f / (rr * rr));
          sf = (fn * newton_sf(u) + fy * yukawa_sf(par, u)) / (fn + fy);
          const float pn = 1.0f / rr;
          const float py = ey / rr;
          sp = (pn * newton_sp(u) + py * yukawa_sp(par, u)) / (pn + py);
        }
        break;
      }
      case KIND_BAMBAM:
      case KIND_SOURCEBAM:
      case KIND_TARGETBAM: {
        const float rho = 2.0f * tm * sm / PI_F;
        const float eta = bam_eta(kind, par[0], tm, sm, n);
        accel = bam_force(rho, eta, r);
        potential = bam_pot(rho, eta, r);
        break;
      }
      case KIND_NONE:
      default:
        return;
    }
    if (TREEPM) {
      fac = accel * sf / fmaxf(r, 1e-37f);
      if (WANT_POT) pot = -potential * sp;
    } else {
      fac = accel * safe_inv(r);
      if (WANT_POT) pot = -potential;
    }
  } else {
    switch (kind) {
      case KIND_NEWTON:
      case KIND_YUKAWA:
      case KIND_COLOYUK:
        fac = plummer_spline(sm, h, r);
        if (WANT_POT) pot = plummer_spline_pot(sm, h, r);
        break;
      case KIND_NEGNEWTON:
        fac = -plummer_spline(sm, h, r);
        if (WANT_POT) pot = -plummer_spline_pot(sm, h, r);
        break;
      case KIND_BAMBAM:
      case KIND_SOURCEBAM:
      case KIND_TARGETBAM: {
        const float rho = 2.0f * tm * sm / PI_F;
        const float eta = bam_eta(kind, par[0], tm, sm, n);
        fac = bam_spline(rho, eta, r);
        if (WANT_POT) pot = bam_pot(rho, eta, r);
        break;
      }
      case KIND_NONE:
      default:
        break;
    }
  }
}

template <bool WANT_POT, bool PERIODIC, bool TREEPM, bool MULTI_LAW,
          bool USE_COUNT>
__global__ void __launch_bounds__(MAX_GROUP)
pairwise_kernel(const float* __restrict__ tx, const float* __restrict__ ty,
                const float* __restrict__ tz, const float* __restrict__ tmass,
                const int* __restrict__ tgrav,
                const float* __restrict__ tfsoft,
                const int* __restrict__ tgid,
                const float* __restrict__ spacked,
                const int* __restrict__ n_src, int group, int s_cap,
                const NgravsLawTable table, float box, float inv_box,
                float inv2a, float* __restrict__ acc,
                float* __restrict__ pot, int* __restrict__ nia) {
  __shared__ float s_x[TILE], s_y[TILE], s_z[TILE], s_m[TILE], s_h[TILE];
  __shared__ int s_gid[TILE];
  __shared__ float s_n[USE_COUNT ? TILE : 1];
  __shared__ int s_g[MULTI_LAW ? TILE : 1];
  __shared__ int s_slot[MULTI_LAW ? MAX_NG * MAX_NG : 1];
  __shared__ int s_kind[MULTI_LAW ? MAX_LAWS : 1];
  __shared__ float s_par[MULTI_LAW ? MAX_LAWS * 4 : 1];

  const int b = blockIdx.x;
  const long t = static_cast<long>(b) * group + threadIdx.x;
  const float x = tx[t], y = ty[t], z = tz[t], hf = tfsoft[t];
  const int gid = tgid[t];
  const bool tvalid = gid >= 0;
  const int ng = MULTI_LAW ? table.n_gravs : 1;
  float tm = 0.0f;
  int trow = 0;
  if (MULTI_LAW) {
    tm = tmass[t];
    trow = min(max(tgrav[t], 0), ng - 1) * ng;
    for (int k = threadIdx.x; k < MAX_NG * MAX_NG; k += blockDim.x)
      s_slot[k] = table.slot[k];
    for (int k = threadIdx.x; k < MAX_LAWS; k += blockDim.x)
      s_kind[k] = table.kind[k];
    for (int k = threadIdx.x; k < MAX_LAWS * 4; k += blockDim.x)
      s_par[k] = table.par[k];
  }

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
      if (USE_COUNT) s_n[k] = src[5 * s_cap + c];
      if (MULTI_LAW)
        s_g[k] = min(max(__float_as_int(src[6 * s_cap + c]), 0), ng - 1);
      s_gid[k] = __float_as_int(src[7 * s_cap + c]);
    }
    __syncthreads();
    // two-level sums: a tile's terms first, then the tile into the total
    // (as the TPU kernel adds each source chunk's sum), so that small terms
    // are not rounded away against a large running sum
    float tx_ = 0.0f, ty_ = 0.0f, tz_ = 0.0f, tp_ = 0.0f;
    for (int k = 0; k < cnt; ++k) {
      const int sgid = s_gid[k];
      const bool valid = tvalid && sgid != -1 && sgid != gid;
      float dx = s_x[k] - x;
      float dy = s_y[k] - y;
      float dz = s_z[k] - z;
      if (PERIODIC) {
        // minimum image, rounding half to even like jnp.round
        dx = dx - box * rintf(dx * inv_box);
        dy = dy - box * rintf(dy * inv_box);
        dz = dz - box * rintf(dz * inv_box);
      }
      const float r2 = dx * dx + dy * dy + dz * dz;
      const float r = sqrtf(r2);
      const float h = fmaxf(hf, s_h[k]);
      const float sm = s_m[k];
      float fac, p = 0.0f;
      if (!MULTI_LAW && !TREEPM) {
        if (r >= h) {
          // law / r: sm / r^2 * 1/r; potential -sm / r
          fac = sm * safe_inv(r2) * safe_inv(r);
          if (WANT_POT) p = -(sm * safe_inv(r));
        } else {
          fac = plummer_spline(sm, h, r);
          if (WANT_POT) p = plummer_spline_pot(sm, h, r);
        }
      } else {
        int kind = KIND_NEWTON;
        const float* par = s_par;
        if (MULTI_LAW) {
          const int li = s_slot[trow + s_g[k]];
          kind = s_kind[li];
          par = s_par + 4 * li;
        }
        law_pair<WANT_POT, TREEPM>(kind, par, tm, sm, r2, r, h,
                                   USE_COUNT ? s_n[k] : 1.0f, inv2a, fac, p);
      }
      // a select, not a multiply: an invalid pair's factor may be inf/NaN
      if (valid) {
        tx_ += fac * dx;
        ty_ += fac * dy;
        tz_ += fac * dz;
        if (WANT_POT) tp_ += p;
        nv += 1;
      }
    }
    ax += tx_;
    ay += ty_;
    az += tz_;
    if (WANT_POT) pp += tp_;
  }
  acc[3 * t + 0] = ax;
  acc[3 * t + 1] = ay;
  acc[3 * t + 2] = az;
  if (WANT_POT) pot[t] = pp;
  nia[t] = nv;
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success).  `flags` ORs
// F_POT, F_PERIODIC, F_TREEPM, F_MULTI and F_COUNT (F_COUNT only with
// F_MULTI); `table` may be null without F_MULTI and `pot` without F_POT.
// Launches on `stream` and does not synchronise.
extern "C" int ngravs_pairwise(
    const float* tx, const float* ty, const float* tz, const float* tmass,
    const int* tgrav, const float* tfsoft, const int* tgid,
    const float* spacked, const int* n_src, int n_blocks, int group,
    int s_cap, int flags, const NgravsLawTable* table, float box,
    float inv_box, float inv2a, float* acc, float* pot, int* nia,
    void* stream) {
  if (n_blocks <= 0) return 0;
  if (group <= 0 || group > MAX_GROUP)
    return static_cast<int>(cudaErrorInvalidValue);
  NgravsLawTable tab = {};
  if (flags & F_MULTI) {
    if (table == nullptr || table->n_gravs < 1 || table->n_gravs > MAX_NG ||
        table->n_laws < 1 || table->n_laws > MAX_LAWS)
      return static_cast<int>(cudaErrorInvalidValue);
    tab = *table;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NGRAVS_ARGS                                                         \
  tx, ty, tz, tmass, tgrav, tfsoft, tgid, spacked, n_src, group, s_cap, tab, \
      box, inv_box, inv2a, acc, pot, nia
#define NGRAVS_CASE(F)                                                   \
  case F:                                                                \
    pairwise_kernel<((F)&F_POT) != 0, ((F)&F_PERIODIC) != 0,             \
                    ((F)&F_TREEPM) != 0, ((F)&F_MULTI) != 0,             \
                    ((F)&F_COUNT) != 0><<<n_blocks, group, 0, s>>>(      \
        NGRAVS_ARGS);                                                    \
    break;
  switch (flags) {
    NGRAVS_CASE(0) NGRAVS_CASE(1) NGRAVS_CASE(2) NGRAVS_CASE(3)
    NGRAVS_CASE(4) NGRAVS_CASE(5) NGRAVS_CASE(6) NGRAVS_CASE(7)
    NGRAVS_CASE(8) NGRAVS_CASE(9) NGRAVS_CASE(10) NGRAVS_CASE(11)
    NGRAVS_CASE(12) NGRAVS_CASE(13) NGRAVS_CASE(14) NGRAVS_CASE(15)
    NGRAVS_CASE(24) NGRAVS_CASE(25) NGRAVS_CASE(26) NGRAVS_CASE(27)
    NGRAVS_CASE(28) NGRAVS_CASE(29) NGRAVS_CASE(30) NGRAVS_CASE(31)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef NGRAVS_CASE
#undef NGRAVS_ARGS
  return static_cast<int>(cudaGetLastError());
}
