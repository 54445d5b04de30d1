// K2: the SPH pair passes for Hopper (sm_90a): the density sums of one
// smoothing-length iteration and the hydro pair force.
//
// Replaces no Pallas kernel.  The JAX package computes both passes as jnp
// over dense [blocks, G, S] arrays (ngravs_tpu/ops/sph.py density_pass and
// hydro_pass), which XLA fuses; eager PyTorch materialises each of those
// arrays, two dozen (density) to four dozen (hydro) float32 temporaries a
// pair slot, in chunks of blocks and hundreds of launches a chunk.  These
// kernels compute what the port's plain twins compute
// (ops/sph.py:_density_blocks and _hydro_blocks), operation for operation
// in float32: the same products, sums, IEEE divisions and square roots in
// the same order (built with -fmad=false, so nothing is contracted into a
// fused multiply-add), the minimum image as d - box * rint(d / box), the
// cubic spline with both branches and its u < 1 cut.  A pair's term is then
// the twin's bit for bit; only the order of the sums over candidates
// differs.
//
// Layout.  Per-particle arrays are in the tree's sorted order: positions and
// velocities [N, 3], scalars [N].  Targets are [n_blocks, group] sorted
// indices (-1 padding); candidates [n_blocks, s_cap] sorted indices (-1
// padding), of which only the first n_cand[b] (at most s_cap) are read.
// The box is three per-axis lengths, 0 for an open axis.  Outputs are raw
// sums, [n_blocks, group, 7] for density (rho, sum W, the dhsml sum, div v,
// rot v x y z) and [n_blocks, group, 5] for hydro (acceleration x y z, the
// entropy rate, the largest signal velocity); the wrapper finishes them.
// Padding targets get zeros.
//
// Design.
//  - One CTA a target block: `lanes` threads a target (G x lanes at most
//    256 threads, whole warps), thread (t, l) at t * lanes + l, so a
//    target's lanes sit in one warp.  The CTA loops over its own n_cand[b]
//    candidates only, in tiles of TILE staged in shared memory: each thread
//    gathers a candidate's fields through `cand` (and, for hydro, computes
//    what depends on the candidate alone: P / rho^2 f, the Balsara factor,
//    h^2), then lane l of every target takes candidates l, l + lanes, ...
//    of the tile.  A warp reads `lanes` neighbouring words a load: no bank
//    conflict.
//  - Most candidates lie outside the kernel (on the 2 x 64^3 gas box, 5.7%
//    of density's candidate slots are within h, 1.6% of hydro's within h_i
//    or h_j).  A pair costs its coordinate differences and r^2
//    and, for density, a compare against (1.0001 h)^2, below which alone u =
//    r / h can be < 1; the minimum image divides only where |d| reaches
//    0.49 box (below it the rounded quotient is 0 and d is unchanged).  Both
//    tests skip only pairs whose term the twin zeroes.
//  - Sums stay in registers: per lane in candidate order, then across the
//    lanes by xor shuffles in a fixed pattern.  No atomics: two launches on
//    the same inputs give the same bits.
//  - Nothing [n_blocks, G, S]-sized is written: one launch a density
//    iteration and one a hydro pass, with no chunking.
//
// What bounds it: instruction issue.  A pair outside the kernel is ~20
// instructions (three differences, the minimum image's compares, r^2, its
// test); a pair inside adds a square root, one (density) or two to three
// (hydro) IEEE divisions and the spline.  The candidates' fields are read
// from device memory once a block (28 bytes density, 56 hydro, a
// candidate) and from shared memory once a target lane.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 6:
// the 2 x 64^3 gas box's 4,096 blocks of 64 targets, S = 4,096, every gas
// particle a target): density 0.559-0.606 ms a pass against its twin's
// 320-326 ms, hydro 1.874-1.930 ms against 576 ms; 4.9-5.5% of the bound
// of the operations the pairs need over the card's FP32 peak.

#include <cuda_runtime.h>

#include <cstddef>

// The C interface's argument blocks: the spline's coefficients (the
// `Kernel` tuple of ops/sph.py but its norm, which only the wrapper uses)
// and the hydro pass's comoving factors and viscosity constants.
extern "C" {
struct NgravsSphSpline {
  float c1, c2, c3, c4, c5, c6, zfac;
  int ndims;
};

struct NgravsHydroFactors {
  float fac_mu, hubble_a2, visc, vsic;   // visc = 0.25 VC, vsic = 0.5 fvf
  int use_limiter;
};
}

namespace {

constexpr int MAX_GROUP = 256;
constexpr int MAX_THREADS = 256;
constexpr int MAX_LANES = 8;
constexpr int TILE = 256;   // candidates staged a round

using SphSpline = NgravsSphSpline;
using HydroFactors = NgravsHydroFactors;

struct DensityArgs {
  const float* pos;
  const float* mass;
  const float* vel;
  const int* tgt;
  const float* hsml_t;
  const float* vel_t;
  const int* cand;
  const int* n_cand;
  int group, s_cap;
  SphSpline k;
  float box[3];
  float* out;
};

struct HydroArgs {
  const float* pos;
  const float* mass;
  const float* hsml;
  const float* rho;
  const float* pres;
  const float* fdh;
  const float* vel;
  const float* csnd;
  const float* divv;
  const float* curl;
  const float* dt;
  const int* tgt;
  const int* cand;
  const int* n_cand;
  int group, s_cap;
  SphSpline k;
  float box[3];
  HydroFactors f;
  float* out;
};

// d - box * round-half-even(d / box), as torch.round(d / box); an open
// axis (box 0) and |d| < 0.49 box leave d as it is.
__device__ __forceinline__ float min_image(float d, float box, float halfbox) {
  if (box > 0.0f && !(fabsf(d) < halfbox))
    d = d - box * rintf(__fdiv_rn(d, box));
  return d;
}

// ops/sph.py _hinv_pow: hinv^3 (3D) or hinv^2 / boxSize_Z (TWODIMS)
__device__ __forceinline__ float hinv3_of(float hinv, const SphSpline& k) {
  return k.ndims == 3 ? hinv * hinv * hinv : hinv * hinv * k.zfac;
}

// ops/sph.py kernel_wk_dwk at u < 1 (the caller tests u < 1)
__device__ __forceinline__ void spline(float u, float hinv3, float hinv4,
                                       const SphSpline& k, float& wk,
                                       float& dwk) {
  if (u < 0.5f) {
    wk = hinv3 * (k.c1 + k.c2 * (u - 1.0f) * u * u);
    dwk = hinv4 * u * (k.c3 * u - k.c4);
  } else {
    const float omu = 1.0f - u;
    wk = hinv3 * k.c5 * omu * omu * omu;
    dwk = hinv4 * k.c6 * omu * omu;
  }
}

__device__ __forceinline__ float spline_dwk(float u, float hinv,
                                            const SphSpline& k) {
  if (!(u < 1.0f)) return 0.0f;
  const float hinv4 = hinv3_of(hinv, k) * hinv;
  if (u < 0.5f) return hinv4 * u * (k.c3 * u - k.c4);
  const float omu = 1.0f - u;
  return hinv4 * k.c6 * omu * omu;
}

template <int LANES>
__device__ __forceinline__ float lane_sum(float v) {
#pragma unroll
  for (int o = 1; o < LANES; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int LANES>
__device__ __forceinline__ float lane_max(float v) {
#pragma unroll
  for (int o = 1; o < LANES; o <<= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int LANES>
__global__ void __launch_bounds__(MAX_THREADS)
    sph_density_kernel(const DensityArgs a) {
  __shared__ float sx[TILE], sy[TILE], sz[TILE], sm[TILE];
  __shared__ float svx[TILE], svy[TILE], svz[TILE];
  __shared__ int sidx[TILE];
  const int b = blockIdx.x;
  const int t = threadIdx.x / LANES, lane = threadIdx.x % LANES;
  const int gi = t < a.group ? a.tgt[b * a.group + t] : -1;
  const SphSpline& k = a.k;
  const float halfbox[3] = {0.49f * a.box[0], 0.49f * a.box[1],
                         0.49f * a.box[2]};
  float tx = 0.0f, ty = 0.0f, tz = 0.0f, vx = 0.0f, vy = 0.0f, vz = 0.0f;
  float hinv = 0.0f, hinv3 = 0.0f, hinv4 = 0.0f, hcut2 = 0.0f;
  if (gi >= 0) {
    const int r = b * a.group + t;
    tx = a.pos[3 * gi];
    ty = a.pos[3 * gi + 1];
    tz = a.pos[3 * gi + 2];
    vx = a.vel_t[3 * r];
    vy = a.vel_t[3 * r + 1];
    vz = a.vel_t[3 * r + 2];
    const float h = fmaxf(a.hsml_t[r], 1e-30f);
    hinv = __frcp_rn(h);
    hinv3 = hinv3_of(hinv, k);
    hinv4 = hinv3 * hinv;
    const float hc = 1.0001f * h;
    hcut2 = hc * hc;
  }
  const float ndims = static_cast<float>(k.ndims);
  float rho = 0.0f, wsum = 0.0f, dh = 0.0f, div = 0.0f;
  float rot0 = 0.0f, rot1 = 0.0f, rot2 = 0.0f;
  const int nc = min(max(a.n_cand[b], 0), a.s_cap);
  const int* row = a.cand + static_cast<size_t>(b) * a.s_cap;
  for (int base = 0; base < nc; base += TILE) {
    const int n = min(TILE, nc - base);
    __syncthreads();
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const int c = row[base + j];
      sidx[j] = c;
      if (c >= 0) {
        sx[j] = a.pos[3 * c];
        sy[j] = a.pos[3 * c + 1];
        sz[j] = a.pos[3 * c + 2];
        sm[j] = a.mass[c];
        svx[j] = a.vel[3 * c];
        svy[j] = a.vel[3 * c + 1];
        svz[j] = a.vel[3 * c + 2];
      }
    }
    __syncthreads();
    if (gi < 0) continue;
    for (int j = lane; j < n; j += LANES) {
      if (sidx[j] < 0) continue;
      const float dx = min_image(tx - sx[j], a.box[0], halfbox[0]);
      const float dy = min_image(ty - sy[j], a.box[1], halfbox[1]);
      const float dz = min_image(tz - sz[j], a.box[2], halfbox[2]);
      const float r2 = dx * dx + dy * dy + dz * dz;
      if (!(r2 < hcut2) && r2 > 0.0f) continue;   // u >= 1 surely
      const float r = sqrtf(r2);
      const float u = r * hinv;
      if (!(u < 1.0f)) continue;
      float wk, dwk;
      spline(u, hinv3, hinv4, k, wk, dwk);
      const float m = sm[j];
      rho += m * wk;
      wsum += wk;
      dh += -m * (ndims * hinv * wk + u * dwk);
      const float fac = r > 0.0f ? __fdiv_rn(m * dwk, fmaxf(r, 1e-30f)) : 0.0f;
      const float dvx = vx - svx[j], dvy = vy - svy[j], dvz = vz - svz[j];
      const float vdotr = dx * dvx + dy * dvy + dz * dvz;
      div += fac * vdotr;
      rot0 += fac * (dz * dvy - dy * dvz);
      rot1 += fac * (dx * dvz - dz * dvx);
      rot2 += fac * (dy * dvx - dx * dvy);
    }
  }
  rho = lane_sum<LANES>(rho);
  wsum = lane_sum<LANES>(wsum);
  dh = lane_sum<LANES>(dh);
  div = lane_sum<LANES>(div);
  rot0 = lane_sum<LANES>(rot0);
  rot1 = lane_sum<LANES>(rot1);
  rot2 = lane_sum<LANES>(rot2);
  if (t < a.group && lane == 0) {
    float* o = a.out + static_cast<size_t>(b * a.group + t) * 7;
    o[0] = rho;
    o[1] = wsum;
    o[2] = dh;
    o[3] = -div;
    o[4] = rot0;
    o[5] = rot1;
    o[6] = rot2;
  }
}

// P / rho^2 f and the Balsara factor of one particle (hydra.c:380-382), as
// ops/sph.py _hydro_blocks computes them
__device__ __forceinline__ float balsara(const HydroArgs& a, int i, float cs,
                                         float h) {
  const float ad = fabsf(a.divv[i]);
  return __fdiv_rn(ad, ad + a.curl[i] +
                           __fdiv_rn(__fdiv_rn(0.0001f * cs, a.f.fac_mu),
                                     fmaxf(h, 1e-30f)));
}

__device__ __forceinline__ float p_over_rho2(const HydroArgs& a, int i) {
  const float rc = fmaxf(a.rho[i], 1e-37f);
  return __fdiv_rn(a.pres[i], rc * rc);
}

template <int LANES>
__global__ void __launch_bounds__(MAX_THREADS)
    sph_hydro_kernel(const HydroArgs a) {
  __shared__ float sx[TILE], sy[TILE], sz[TILE], sm[TILE], sh2[TILE];
  __shared__ float shinv[TILE], srho[TILE], spf[TILE], scs[TILE];
  __shared__ float svx[TILE], svy[TILE], svz[TILE], sf2[TILE], sdt[TILE];
  __shared__ int sidx[TILE];
  const int b = blockIdx.x;
  const int t = threadIdx.x / LANES, lane = threadIdx.x % LANES;
  const int gi = t < a.group ? a.tgt[b * a.group + t] : -1;
  const SphSpline& k = a.k;
  const HydroFactors& f = a.f;
  const float halfbox[3] = {0.49f * a.box[0], 0.49f * a.box[1],
                         0.49f * a.box[2]};
  float tx = 0.0f, ty = 0.0f, tz = 0.0f, vx = 0.0f, vy = 0.0f, vz = 0.0f;
  float h2 = 0.0f, hinv = 0.0f, rho_i = 0.0f, p_i = 0.0f, cs_i = 0.0f;
  float f1 = 0.0f, dt_i = 0.0f, m_i = 0.0f;
  if (gi >= 0) {
    tx = a.pos[3 * gi];
    ty = a.pos[3 * gi + 1];
    tz = a.pos[3 * gi + 2];
    vx = a.vel[3 * gi];
    vy = a.vel[3 * gi + 1];
    vz = a.vel[3 * gi + 2];
    const float h = a.hsml[gi];
    h2 = h * h;
    hinv = __frcp_rn(fmaxf(h, 1e-30f));
    rho_i = a.rho[gi];
    p_i = p_over_rho2(a, gi) * a.fdh[gi];
    cs_i = a.csnd[gi];
    f1 = balsara(a, gi, cs_i, h);
    dt_i = a.dt[gi];
    m_i = a.mass[gi];
  }
  float ax = 0.0f, ay = 0.0f, az = 0.0f, dtent = 0.0f, maxsig = 0.0f;
  const int nc = min(max(a.n_cand[b], 0), a.s_cap);
  const int* row = a.cand + static_cast<size_t>(b) * a.s_cap;
  for (int base = 0; base < nc; base += TILE) {
    const int n = min(TILE, nc - base);
    __syncthreads();
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const int c = row[base + j];
      sidx[j] = c;
      if (c >= 0) {
        sx[j] = a.pos[3 * c];
        sy[j] = a.pos[3 * c + 1];
        sz[j] = a.pos[3 * c + 2];
        sm[j] = a.mass[c];
        const float h = a.hsml[c];
        sh2[j] = h * h;
        shinv[j] = __frcp_rn(fmaxf(h, 1e-30f));
        srho[j] = a.rho[c];
        spf[j] = p_over_rho2(a, c) * a.fdh[c];
        const float cs = a.csnd[c];
        scs[j] = cs;
        svx[j] = a.vel[3 * c];
        svy[j] = a.vel[3 * c + 1];
        svz[j] = a.vel[3 * c + 2];
        sf2[j] = balsara(a, c, cs, h);
        sdt[j] = a.dt[c];
      }
    }
    __syncthreads();
    if (gi < 0) continue;
    for (int j = lane; j < n; j += LANES) {
      const int c = sidx[j];
      if (c < 0 || c == gi) continue;
      const float dx = min_image(tx - sx[j], a.box[0], halfbox[0]);
      const float dy = min_image(ty - sy[j], a.box[1], halfbox[1]);
      const float dz = min_image(tz - sz[j], a.box[2], halfbox[2]);
      const float r2 = dx * dx + dy * dy + dz * dz;
      const bool in_i = r2 < h2, in_j = r2 < sh2[j];
      if (!(in_i || in_j)) continue;
      const float r = sqrtf(r2);
      const float dvx = vx - svx[j], dvy = vy - svy[j], dvz = vz - svz[j];
      const float vdotr = dx * dvx + dy * dvy + dz * dvz;
      const float vdotr2 = vdotr + f.hubble_a2 * r2;
      const float dwk_i = in_i ? spline_dwk(r * hinv, hinv, k) : 0.0f;
      const float hinv_j = shinv[j];
      const float dwk_j = in_j ? spline_dwk(r * hinv_j, hinv_j, k) : 0.0f;
      const float cs_sum = cs_i + scs[j];
      const float r_safe = fmaxf(r, 1e-30f);
      const float mu = __fdiv_rn(f.fac_mu * vdotr2, r_safe);
      const float vsig = cs_sum - 3.0f * mu;
      const bool approaching = vdotr2 < 0.0f;
      maxsig = fmaxf(maxsig, cs_sum);
      if (approaching) maxsig = fmaxf(maxsig, vsig);
      const float rho_ij = 0.5f * (rho_i + srho[j]);
      float visc = __fdiv_rn(f.visc * vsig * (-mu), fmaxf(rho_ij, 1e-37f)) *
                   (f1 + sf2[j]);
      const float dwk_sum = dwk_i + dwk_j;
      if (f.use_limiter) {
        // viscosity limiter (hydra.c:513-519)
        const float dt_pair = fmaxf(dt_i, sdt[j]);
        if (dt_pair > 0.0f && dwk_sum < 0.0f) {
          const float m_sum = 0.5f * (m_i + sm[j]);
          const float limiter = __fdiv_rn(f.vsic * vdotr2,
                                          m_sum * dwk_sum * r_safe * dt_pair);
          visc = fminf(visc, limiter);
        }
      }
      if (!approaching) visc = 0.0f;
      const float m_j = sm[j];
      const float hfc_visc = __fdiv_rn(0.5f * m_j * visc * dwk_sum, r_safe);
      const float hfc = hfc_visc + __fdiv_rn(m_j * (p_i * dwk_i +
                                                    spf[j] * dwk_j),
                                             r_safe);
      ax += hfc * dx;
      ay += hfc * dy;
      az += hfc * dz;
      dtent += 0.5f * hfc_visc * vdotr2;
    }
  }
  ax = lane_sum<LANES>(ax);
  ay = lane_sum<LANES>(ay);
  az = lane_sum<LANES>(az);
  dtent = lane_sum<LANES>(dtent);
  maxsig = lane_max<LANES>(maxsig);
  if (t < a.group && lane == 0) {
    float* o = a.out + static_cast<size_t>(b * a.group + t) * 5;
    o[0] = -ax;
    o[1] = -ay;
    o[2] = -az;
    o[3] = dtent;
    o[4] = maxsig;
  }
}

bool shape_ok(int n_blocks, int group, int s_cap, int lanes) {
  return n_blocks > 0 && group > 0 && group <= MAX_GROUP && s_cap > 0 &&
         lanes > 0 && lanes <= MAX_LANES && (lanes & (lanes - 1)) == 0 &&
         group * lanes <= MAX_THREADS;
}

// one CTA a target block, group x lanes threads rounded up to whole warps
#define NGRAVS_SPH_LAUNCH(KERNEL, ARGS, N_BLOCKS, LANES, STREAM)            \
  do {                                                                     \
    const dim3 grid(N_BLOCKS);                                             \
    const dim3 block(((ARGS).group * (LANES) + 31) / 32 * 32);             \
    switch (LANES) {                                                       \
      case 1: KERNEL<1><<<grid, block, 0, STREAM>>>(ARGS); break;          \
      case 2: KERNEL<2><<<grid, block, 0, STREAM>>>(ARGS); break;          \
      case 4: KERNEL<4><<<grid, block, 0, STREAM>>>(ARGS); break;          \
      default: KERNEL<8><<<grid, block, 0, STREAM>>>(ARGS); break;         \
    }                                                                      \
  } while (0)

}  // namespace

extern "C" {

// Density sums (raw) for n_blocks blocks of `group` targets: out [n_blocks,
// group, 7].  Returns a cudaError_t; cudaErrorInvalidValue for a shape the
// kernel does not take (group over 256, lanes not 1/2/4/8, group x lanes
// over 256 threads).
int ngravs_sph_density(const float* pos, const float* mass, const float* vel,
                       const int* tgt, const float* hsml_t,
                       const float* vel_t, const int* cand, const int* n_cand,
                       int n_blocks, int group, int s_cap, int lanes,
                       const NgravsSphSpline* spline, float bx, float by,
                       float bz, float* out, void* stream) {
  if (n_blocks == 0) return 0;
  if (!shape_ok(n_blocks, group, s_cap, lanes) || spline == nullptr ||
      (spline->ndims != 2 && spline->ndims != 3))
    return static_cast<int>(cudaErrorInvalidValue);
  const DensityArgs args = {
      pos, mass, vel, tgt, hsml_t, vel_t, cand, n_cand, group, s_cap,
      *spline, {bx, by, bz}, out};
  NGRAVS_SPH_LAUNCH(sph_density_kernel, args, n_blocks, lanes,
                    static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// Hydro pair sums for n_blocks blocks of `group` targets: out [n_blocks,
// group, 5] (acceleration, entropy rate before its finishing factors,
// largest signal velocity).  Returns as ngravs_sph_density.
int ngravs_sph_hydro(const float* pos, const float* mass, const float* hsml,
                     const float* rho, const float* pres, const float* fdh,
                     const float* vel, const float* csnd, const float* divv,
                     const float* curl, const float* dt, const int* tgt,
                     const int* cand, const int* n_cand, int n_blocks,
                     int group, int s_cap, int lanes,
                     const NgravsSphSpline* spline, float bx, float by,
                     float bz, const NgravsHydroFactors* factors, float* out,
                     void* stream) {
  if (n_blocks == 0) return 0;
  if (!shape_ok(n_blocks, group, s_cap, lanes) || spline == nullptr ||
      factors == nullptr || (spline->ndims != 2 && spline->ndims != 3))
    return static_cast<int>(cudaErrorInvalidValue);
  const HydroArgs args = {
      pos, mass, hsml, rho, pres, fdh, vel, csnd, divv, curl, dt, tgt, cand,
      n_cand, group, s_cap, *spline, {bx, by, bz}, *factors, out};
  NGRAVS_SPH_LAUNCH(sph_hydro_kernel, args, n_blocks, lanes,
                    static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
