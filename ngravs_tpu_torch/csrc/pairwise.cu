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
// pairs are masked by a select; node rows (gid -2) count, and so does a
// pair whose gravities match no slot of a multi-law wiring, which takes no
// law.  Outputs are the acceleration (G = 1), the optional potential and
// the valid-pair count.
//
// Layout: targets are 7 columns of n_blocks * group entries (x, y, z, mass,
// grav i32, fsoft, gid i32).  Sources are [n_blocks, 8, s_cap] f32 with rows
// x, y, z, mass, soft, count, grav, gid; rows 6/7 hold int32 bit patterns
// and are only ever reinterpreted (__float_as_int), never converted.  The
// five features are template flags <WANT_POT, PERIODIC, TREEPM, MULTI_LAW,
// USE_COUNT>; the all-false instance is K1a (one Newton law).  Under
// MULTI_LAW the wiring is a small table (a law index per gravity slot; a
// kind and four parameters per law) staged in shared memory, and each pair
// runs its own law only.
//
// Design.  The walk launches B = 128 blocks of G = 64 targets with ragged
// n_src (1 to S rows).  A launch's shape (P, C, TILE, STAGES) comes from
// ops/pairwise.py:launch_plan.
//  - Sources split across lanes: a CTA holds G targets x P lanes (at most
//    512 threads, rounded up to whole warps), and thread (t, p) sums target t over the rows p, p + P,
//    ... of each tile.  A warp is 32 targets of one lane, so its threads
//    read one shared-memory row at a time, as a broadcast.  A 128-block
//    launch keeps 8x to 16x the warps of one thread per target resident.
//  - A cluster of C CTAs per target block, each on a contiguous part of the
//    block's live rows (n_src[b] cut C ways on multiples of 4): the heaviest
//    block no longer runs on one SM alone.  Rank 0 adds the other ranks'
//    sums from distributed shared memory after a cluster barrier.
//  - A ring of STAGES source tiles in dynamic shared memory, filled by 1-D
//    bulk copies (cp.async.bulk, one per row, completing on the stage's
//    "full" mbarrier); warp 0 refills a stage once every warp has released
//    it on its "empty" mbarrier, so copies overlap the arithmetic.
//  - Multi-law instances sort the block's targets by gravity (a stable
//    counting sort in shared memory) before assigning them to threads: a
//    warp then holds one target gravity but at the boundaries, and, reading
//    one source row, runs one law (no divergence on the law switch).
//  - Sums in a fixed order: per lane a tile's terms, then the tile into the
//    lane's total; then the lanes in order; then the ranks in order.  No
//    atomics, so every launch gives the same bits.
//
// Tensor cores are not used: the work per pair is a nonlinear function of
// a coordinate difference, not a product, and the GEMM form r^2 = |t|^2 +
// |s|^2 - 2 t.s cancels catastrophically in f32 at a box's scale
// (coordinates near 5e4 against softenings near 26), before TF32's 10-bit
// mantissa even enters.
//
// What bounds it, once the card is full: instruction issue on the FP32 and
// SFU pipes.  Each pair runs a sqrt and two IEEE divisions (and under
// TreePM or Yukawa exponentials and the A&S erfc) as dependent chains,
// besides 6 to 8 shared-memory loads and the select; the source rows are
// read once from device memory, far below its rate.  Which pipe saturates
// first has not been measured (no hardware counters on the test machine).
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (k1_ab.py, in turns with
// the first design of one thread per target on the same inputs): the
// TreePM box path's largest launch (multi-law, periodic, TreePM; 128
// blocks, S = 8192, 20.0M pairs) 0.329 ms against 1.989 ms; the open
// GalaxyCollision path's largest launch (one Newton law; S = 32768, 18.5M
// pairs) 0.324 ms against 3.009 ms; the synthetic instances at S = 4096
// 0.15 to 0.33 ms against 1.02 to 3.17 ms.  That is 2 to 5% of the bound
// of the operations the pairs need over the card's FP32 peak.  Rounding
// r^2 once an operation, where nvcc had contracted it into fused
// multiply-adds, cost 0 to 6% on the TreePM instances' largest launches
// and nothing on K1a (tools/port_studies/overflow_launches.py --ab, in
// turns against the contracted source).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_GROUP = 256;
// A CTA has at most 512 threads (a group of 256 takes 2 lanes), so that two
// CTAs share an SM at 64 registers a thread.  The TreePM multi-law
// instances with the potential spill at 64: they get one CTA an SM and up
// to 128 registers (pairwise_kernel's __launch_bounds__).
constexpr int MAX_THREADS = 512;
constexpr int MAX_LANES = 16;
constexpr int MAX_STAGES = 4;
constexpr int MAX_CLUSTER = 8;
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

// A launch's shape (ops/pairwise.py:launch_plan); mirrored by a ctypes
// Structure.
struct NgravsPlan {
  int lanes;    // P: threads per target
  int cluster;  // C: CTAs per target block
  int tile;     // source rows per ring stage, a multiple of 4
  int stages;   // ring depth
  int smem;     // dynamic shared-memory bytes, as smem_bytes gives them
};

namespace {

// Dynamic shared memory: the ring [stages][rows][tile] f32, the lane sums
// [lanes][5][group] (acc x, y, z, pot f32 and the pair count i32), and the
// full and empty barriers [2 * stages] u64.  ops/pairwise.py:launch_plan
// computes the same.
int smem_bytes(int rows, int tile, int stages, int lanes, int group) {
  return 4 * stages * rows * tile + 4 * 5 * lanes * group + 16 * stages;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// spin until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// one 1-D bulk copy (TMA) of `bytes` (a multiple of 16) into this CTA's
// shared memory, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

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

struct KernelArgs {
  const float* tx;
  const float* ty;
  const float* tz;
  const float* tmass;
  const int* tgrav;
  const float* tfsoft;
  const int* tgid;
  const float* spacked;
  const int* n_src;
  int group;
  int s_cap;
  NgravsLawTable table;
  NgravsPlan plan;
  float box;
  float inv_box;
  float inv2a;
  float* acc;
  float* pot;
  int* nia;
};

// ring rows: x, y, z, mass, soft, gid, then count (USE_COUNT), then grav
// (MULTI_LAW); their rows in the packed source list
constexpr int R_GID = 5;
template <bool MULTI_LAW, bool USE_COUNT>
__device__ __forceinline__ int packed_row(int r) {
  if (r < R_GID) return r;
  if (r == R_GID) return 7;
  return (USE_COUNT && r == R_GID + 1) ? 5 : 6;
}

// Issue the copies of tile j of rows [beg, end) into its ring stage: each
// ring row rounded up to 4 floats (inside the row: s_cap and the cuts are
// multiples of 4), completing on the stage's full barrier (bars + 8 s).
// The block's source pointer is recomputed here so that it holds no
// register across the consumers' loop.
template <bool MULTI_LAW, bool USE_COUNT>
__device__ __forceinline__ void issue_tile(const KernelArgs& a, float* ring,
                                           uint32_t bars, int beg, int end,
                                           int j) {
  constexpr int ROWS = 6 + (USE_COUNT ? 1 : 0) + (MULTI_LAW ? 1 : 0);
  const int TILE = a.plan.tile, s = j % a.plan.stages;
  const int base = beg + j * TILE;
  const uint32_t bytes =
      static_cast<uint32_t>(((min(TILE, end - base) + 3) & ~3) * 4);
  const float* src = a.spacked +
                     static_cast<long>(blockIdx.x / a.plan.cluster) * 8 *
                         a.s_cap + base;
  float* st = ring + s * ROWS * TILE;
  mbar_expect_tx(bars + 8 * s, bytes * ROWS);
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
    bulk_copy(st + r * TILE,
              src + static_cast<long>(packed_row<MULTI_LAW, USE_COUNT>(r)) *
                        a.s_cap,
              bytes, bars + 8 * s);
}

template <bool WANT_POT, bool PERIODIC, bool TREEPM, bool MULTI_LAW,
          bool USE_COUNT>
__global__ void __launch_bounds__(MAX_THREADS,
                                  (WANT_POT && TREEPM && MULTI_LAW) ? 1 : 2)
pairwise_kernel(const __grid_constant__ KernelArgs a) {
  constexpr int ROWS = 6 + (USE_COUNT ? 1 : 0) + (MULTI_LAW ? 1 : 0);
  constexpr int R_COUNT = R_GID + 1;
  constexpr int R_GRAV = R_GID + (USE_COUNT ? 2 : 1);
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int s_slot[MULTI_LAW ? MAX_NG * MAX_NG : 1];
  __shared__ int s_kind[MULTI_LAW ? MAX_LAWS : 1];
  __shared__ float s_par[MULTI_LAW ? MAX_LAWS * 4 : 1];
  __shared__ int s_tg[MULTI_LAW ? MAX_GROUP : 1];
  __shared__ int s_perm[MULTI_LAW ? MAX_GROUP : 1];

  const int group = a.group, s_cap = a.s_cap;
  const int P = a.plan.lanes, C = a.plan.cluster;
  const int TILE = a.plan.tile, STAGES = a.plan.stages;
  float* ring = reinterpret_cast<float*>(smem);
  float* red = ring + STAGES * ROWS * TILE;
  // full barriers at bars + 8 s, empty ones at bars + 8 (STAGES + s)
  const uint32_t bars = smem_addr(red + 5 * P * group);

  const int tid = threadIdx.x;
  const int slot = tid % group, lane = tid / group;
  // the CTA is rounded up to whole warps: a thread past G x P lanes takes
  // part in the barriers only
  const bool spare = lane >= P;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / C;
  const int ng = MULTI_LAW ? a.table.n_gravs : 1;
  const int n_laws = MULTI_LAW ? a.table.n_laws : 1;

  // this rank's part of the block's live rows, cut on multiples of 4
  const int ns = min(max(a.n_src[b], 0), s_cap);
  const int part = ((ns + C - 1) / C + 3) & ~3;
  const int beg = min(rank * part, ns), end = min(beg + part, ns);
  const long t0 = static_cast<long>(b) * group;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (STAGES + s), blockDim.x / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (MULTI_LAW) {
    for (int k = tid; k < MAX_NG * MAX_NG; k += blockDim.x)
      s_slot[k] = a.table.slot[k];
    for (int k = tid; k < MAX_LAWS; k += blockDim.x)
      s_kind[k] = a.table.kind[k];
    for (int k = tid; k < MAX_LAWS * 4; k += blockDim.x)
      s_par[k] = a.table.par[k];
    if (tid < group) s_tg[tid] = min(max(a.tgrav[t0 + tid], 0), ng - 1);
  }
  __syncthreads();
  if (tid == 0)
    for (int j = 0; j < min(STAGES, (end - beg + TILE - 1) / TILE); ++j)
      issue_tile<MULTI_LAW, USE_COUNT>(a, ring, bars, beg, end, j);

  // the target of this thread's slot: under MULTI_LAW the block's targets
  // in a stable order by gravity, so that a warp holds one gravity
  int t = slot;
  if (MULTI_LAW) {
    if (tid < group) {
      const int g = s_tg[tid];
      int pos = 0;
      for (int k = 0; k < group; ++k) {
        const int gk = s_tg[k];
        pos += (gk < g || (gk == g && k < tid)) ? 1 : 0;
      }
      s_perm[pos] = tid;
    }
    __syncthreads();
    t = s_perm[slot];
  }
  const long ti = t0 + t;
  const float x = a.tx[ti], y = a.ty[ti], z = a.tz[ti], hf = a.tfsoft[ti];
  const int gid = a.tgid[ti];
  // a padding target (gid -1) has no valid pair: its lane skips the rows
  const int k0 = gid >= 0 && !spare ? lane : TILE;
  // the target's row of the law table; -1 for a gravity the wiring has no
  // slot for, whose pairs take no law (the clamp above only orders threads)
  float tm = 0.0f;
  int trow = -1;
  if (MULTI_LAW) {
    tm = a.tmass[ti];
    const int tg = a.tgrav[ti];
    trow = tg >= 0 && tg < ng ? tg * ng : -1;
  }

  float ax = 0.0f, ay = 0.0f, az = 0.0f, pp = 0.0f;
  int nv = 0;
  int s = 0;
  uint32_t parity = 0;
  for (int j = 0; beg + j * TILE < end; ++j) {
    const int cnt = min(TILE, end - beg - j * TILE);
    const float* st = ring + s * ROWS * TILE;
    mbar_wait(bars + 8 * s, parity);
    // two-level sums: a tile's terms first, then the tile into the total
    // (as the TPU kernel adds each source chunk's sum), so that small terms
    // are not rounded away against a large running sum
    float tx_ = 0.0f, ty_ = 0.0f, tz_ = 0.0f, tp_ = 0.0f;
    for (int k = k0; k < cnt; k += P) {
      const int sgid = __float_as_int(st[R_GID * TILE + k]);
      const bool valid = sgid != -1 && sgid != gid;
      float dx = st[k] - x;
      float dy = st[TILE + k] - y;
      float dz = st[2 * TILE + k] - z;
      if (PERIODIC) {
        // minimum image, rounding half to even like jnp.round; box times
        // a small integer is exact, so a fused multiply-add here changes
        // no bit
        dx = dx - a.box * rintf(dx * a.inv_box);
        dy = dy - a.box * rintf(dy * a.inv_box);
        dz = dz - a.box * rintf(dz * a.inv_box);
      }
      // r^2 rounded once an operation, as the Pallas source and the twin
      // write it: the _rn intrinsics are never contracted into a fused
      // multiply-add.  The TreePM cut at u = 3 is a jump, and a contraction
      // moves r^2 by an ulp, enough to put a pair on the cut's other side
      // (13d's overflowing attempts met such pairs)
      const float r2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      const float r = sqrtf(r2);
      const float h = fmaxf(hf, st[4 * TILE + k]);
      const float sm = st[3 * TILE + k];
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
          // as the Pallas kernel's masks: one law takes every pair; among
          // several, a pair whose (target, source) gravity matches no slot
          // takes none, and still counts
          const int sg = __float_as_int(st[R_GRAV * TILE + k]);
          const int li = n_laws == 1 ? 0
                         : (trow >= 0 && sg >= 0 && sg < ng ? s_slot[trow + sg]
                                                            : -1);
          kind = li >= 0 ? s_kind[li] : KIND_NONE;
          par = s_par + 4 * max(li, 0);
        }
        law_pair<WANT_POT, TREEPM>(
            kind, par, tm, sm, r2, r, h,
            USE_COUNT ? st[R_COUNT * TILE + k] : 1.0f, a.inv2a, fac, p);
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
    // release the stage; warp 0 refills it with tile j + STAGES once every
    // warp has
    __syncwarp();
    if ((tid & 31) == 0) mbar_arrive(bars + 8 * (STAGES + s));
    if (tid < 32 && beg + (j + STAGES) * TILE < end) {
      mbar_wait(bars + 8 * (STAGES + s), parity);
      if (tid == 0)
        issue_tile<MULTI_LAW, USE_COUNT>(a, ring, bars, beg, end,
                                         j + STAGES);
      __syncwarp();
    }
    if (++s == STAGES) {
      s = 0;
      parity ^= 1;
    }
  }

  // the lanes' sums in lane order, into lane 0's entries
  const int o = lane * 5 * group + slot;
  int* redi = reinterpret_cast<int*>(red);
  if (!spare) {
    red[o] = ax;
    red[o + group] = ay;
    red[o + 2 * group] = az;
    red[o + 3 * group] = pp;
    redi[o + 4 * group] = nv;
  }
  __syncthreads();
  if (lane == 0) {
    for (int q = 1; q < P; ++q) {
      const int oq = q * 5 * group + slot;
      ax += red[oq];
      ay += red[oq + group];
      az += red[oq + 2 * group];
      pp += red[oq + 3 * group];
      nv += redi[oq + 4 * group];
    }
    red[slot] = ax;
    red[slot + group] = ay;
    red[slot + 2 * group] = az;
    red[slot + 3 * group] = pp;
    redi[slot + 4 * group] = nv;
  }
  // the ranks' sums in rank order, by rank 0 from distributed shared memory
  if (C > 1) {
    cluster.sync();
    if (rank == 0 && lane == 0) {
      for (int q = 1; q < C; ++q) {
        const float* rq = cluster.map_shared_rank(red, q);
        ax += rq[slot];
        ay += rq[slot + group];
        az += rq[slot + 2 * group];
        pp += rq[slot + 3 * group];
        nv += reinterpret_cast<const int*>(rq)[slot + 4 * group];
      }
    }
    cluster.sync();  // no rank leaves while rank 0 reads its shared memory
  }
  if (rank == 0 && lane == 0) {
    a.acc[3 * ti + 0] = ax;
    a.acc[3 * ti + 1] = ay;
    a.acc[3 * ti + 2] = az;
    if (WANT_POT) a.pot[ti] = pp;
    a.nia[ti] = nv;
  }
}

template <bool WANT_POT, bool PERIODIC, bool TREEPM, bool MULTI_LAW,
          bool USE_COUNT>
cudaError_t launch(const KernelArgs& args, int n_blocks, cudaStream_t stream) {
  const NgravsPlan& pl = args.plan;
  auto kern =
      pairwise_kernel<WANT_POT, PERIODIC, TREEPM, MULTI_LAW, USE_COUNT>;
  if (pl.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = pl.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_blocks * pl.cluster);
  cfg.blockDim = dim3((args.group * pl.lanes + 31) / 32 * 32);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, args);
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success).  `flags` ORs
// F_POT, F_PERIODIC, F_TREEPM, F_MULTI and F_COUNT (F_COUNT only with
// F_MULTI); `table` may be null without F_MULTI and `pot` without F_POT.
// `group` must be a multiple of 8 up to 256, `s_cap` a multiple of 4 and
// `spacked` 16-byte aligned; `plan` is ops/pairwise.py:launch_plan's.
// Launches on `stream` and does not synchronise.
extern "C" int ngravs_pairwise(
    const float* tx, const float* ty, const float* tz, const float* tmass,
    const int* tgrav, const float* tfsoft, const int* tgid,
    const float* spacked, const int* n_src, int n_blocks, int group,
    int s_cap, int flags, const NgravsLawTable* table,
    const NgravsPlan* plan, float box, float inv_box, float inv2a,
    float* acc, float* pot, int* nia, void* stream) {
  if (n_blocks <= 0) return 0;
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (group <= 0 || group > MAX_GROUP || group % 8 || s_cap % 4 ||
      plan == nullptr || reinterpret_cast<uintptr_t>(spacked) % 16)
    return invalid;
  const NgravsPlan pl = *plan;
  const int rows = 6 + ((flags & F_MULTI) ? 1 : 0) + ((flags & F_COUNT) ? 1 : 0);
  if (pl.lanes < 1 || pl.lanes > MAX_LANES ||
      group * pl.lanes > MAX_THREADS || pl.cluster < 1 ||
      pl.cluster > MAX_CLUSTER || (pl.cluster & (pl.cluster - 1)) ||
      pl.tile <= 0 || pl.tile % 4 || pl.stages < 2 ||
      pl.stages > MAX_STAGES ||
      pl.smem != smem_bytes(rows, pl.tile, pl.stages, pl.lanes, group))
    return invalid;
  KernelArgs args = {tx, ty, tz, tmass, tgrav, tfsoft, tgid, spacked, n_src,
                     group, s_cap, {}, pl, box, inv_box, inv2a, acc, pot,
                     nia};
  if (flags & F_MULTI) {
    if (table == nullptr || table->n_gravs < 1 || table->n_gravs > MAX_NG ||
        table->n_laws < 1 || table->n_laws > MAX_LAWS)
      return invalid;
    args.table = *table;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
#define NGRAVS_CASE(F)                                                    \
  case F:                                                                 \
    e = launch<((F)&F_POT) != 0, ((F)&F_PERIODIC) != 0,                   \
               ((F)&F_TREEPM) != 0, ((F)&F_MULTI) != 0,                   \
               ((F)&F_COUNT) != 0>(args, n_blocks, s);                    \
    break;
  switch (flags) {
    NGRAVS_CASE(0) NGRAVS_CASE(1) NGRAVS_CASE(2) NGRAVS_CASE(3)
    NGRAVS_CASE(4) NGRAVS_CASE(5) NGRAVS_CASE(6) NGRAVS_CASE(7)
    NGRAVS_CASE(8) NGRAVS_CASE(9) NGRAVS_CASE(10) NGRAVS_CASE(11)
    NGRAVS_CASE(12) NGRAVS_CASE(13) NGRAVS_CASE(14) NGRAVS_CASE(15)
    NGRAVS_CASE(24) NGRAVS_CASE(25) NGRAVS_CASE(26) NGRAVS_CASE(27)
    NGRAVS_CASE(28) NGRAVS_CASE(29) NGRAVS_CASE(30) NGRAVS_CASE(31)
    default:
      return invalid;
  }
#undef NGRAVS_CASE
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
