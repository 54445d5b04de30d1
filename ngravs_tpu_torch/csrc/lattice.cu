// K3: the periodic pure-tree walk's lattice (Ewald) correction for Hopper
// (sm_90a).
//
// Replaces no Pallas kernel.  The JAX package computes the pass as jnp over
// the walk's packed [blocks, 8, S] buffer (ngravs_tpu/ops/walk.py:969-1008),
// which XLA fuses; eager PyTorch materialises some sixty float32
// temporaries a pair slot, in chunks of blocks and hundreds of launches a
// chunk.  This kernel computes what the port's plain twin computes
// (ops/walk.py lattice_pass_torch, ops/lattice.py lattice_correction),
// operation for operation in float32 (built with -fmad=false, so nothing is
// contracted into a fused multiply-add): the displacement source - target,
// the minimum image d - box * rint(d * (1 / box)), the octant fold |d| with
// the sign +1 where d < 0 and -1 elsewhere, the table cell
// i = clamp(int(|d| fac_intp), 0, EN - 1) and its fraction, the eight
// corner weights and their sum in the twin's (di, dj, dk) order, the sign
// and the source mass.  A pair's term is then the twin's bit for bit; the
// sums over the sources differ from the twin's float32 sums by their
// rounding (K3 adds the terms in float64).
//
// Layout.  Targets are columns [n_blocks * group] (x, y, z f32; gravity and
// gid int32, gid -1 padding).  Sources are the walk's packed buffer
// [n_blocks, 8, s_cap] (rows x, y, z, mass, softening, count, gravity, gid;
// the last two int32 bit patterns, gid -1 a masked row, -2 a node), of
// which only the first n_src[b] (at most s_cap) are read.  The tables are
// the lattice tables themselves, [n_gravs^2, EN+1, EN+1, EN+1] float4
// (fx, fy, fz, psi), pairs flattened target gravity * n_gravs + source
// gravity.  Outputs: acc [n_blocks * group, 3] and, with the potential,
// pot [n_blocks * group]; padding targets get zeros.
//
// Design.
//  - One CTA a target block: `lanes` threads a target (group x lanes at
//    most 256 threads, whole warps), thread (t, l) at t * lanes + l.  The
//    CTA loops over its own n_src[b] rows only, in tiles of TILE staged in
//    shared memory; lane l of every target takes rows l, l + lanes, ... of
//    the tile.  A valid pair is the pair sums' (K1's): a row with gid -1,
//    a target's own row and padding targets are dropped.
//  - The corners are read from the tables as they are (17.6 MB at EN 64
//    and two gravities, inside the 50 MB L2), eight float4 loads a pair,
//    two of them adjacent.  The twin's corner table (one 128-byte row a
//    cell, ops/lattice.py corner_table) is eight times larger, 141 MB, and
//    would send the gathers to device memory.  The targets of a block lie
//    close together, so the targets of one warp that take the same row in
//    one iteration read the same or neighbouring cells.
//  - Sums stay in registers, in float64: per lane in row order, then
//    across the lanes by xor shuffles in a fixed pattern.  A target sums
//    thousands of terms of one sign in the potential (the lattice's
//    constant part), where a float32 running sum drifts by 1e-5 of the
//    sum of |terms| (2 x 64^3); float64 keeps it at the twin's rounding.
//    No atomics: two launches on the same inputs give the same bits.
//  - Nothing [n_blocks, G, S]-sized is written: one launch a walk batch.
//    The kernel reads n_src on the card, so the host needs no read of the
//    batch's longest list.
//
// What bounds it: the gathers.  A pair is ~100 float32 operations, four
// float64 adds and 128 bytes of table read through L2.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int MAX_GROUP = 256;
constexpr int MAX_THREADS = 256;
constexpr int MAX_LANES = 8;
constexpr int TILE = 512;   // source rows staged a round
// rows of the packed source buffer (ops/pairwise.py)
constexpr int FX = 0, FY = 1, FZ = 2, FMASS = 3, IGRAV = 6, IGID = 7;

struct LatticeArgs {
  const float* tx;
  const float* ty;
  const float* tz;
  const int* tgrav;
  const int* tgid;
  const float* src;
  const int* n_src;
  const float4* tables;
  int group, s_cap, n_gravs, en;
  float fac_intp, box, inv_box;
  float* acc;
  float* pot;
};

template <int LANES>
__device__ __forceinline__ double lane_sum(double v) {
#pragma unroll
  for (int o = 1; o < LANES; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the minimum image as the twin computes it: d - box * round-half-even(d *
// (1 / box)), every operation rounded on its own
__device__ __forceinline__ float min_image(float d, float box, float inv_box) {
  return d - box * rintf(d * inv_box);
}

// the table cell of one folded axis and its fraction (ops/lattice.py
// lattice_correction's `cell`)
__device__ __forceinline__ int cell_of(float a, float fac_intp, int en,
                                       float& frac) {
  const float u = a * fac_intp;
  const int i = min(max(static_cast<int>(u), 0), en - 1);
  frac = u - static_cast<float>(i);
  return i;
}

template <int LANES, bool WANT_POT>
__global__ void __launch_bounds__(MAX_THREADS)
    lattice_kernel(const LatticeArgs a) {
  __shared__ float sx[TILE], sy[TILE], sz[TILE], sm[TILE];
  __shared__ int sg[TILE], sid[TILE];
  const int b = blockIdx.x;
  const int t = threadIdx.x / LANES, lane = threadIdx.x % LANES;
  const int r = b * a.group + t;
  const int gi = t < a.group ? a.tgid[r] : -1;
  float px = 0.0f, py = 0.0f, pz = 0.0f;
  int pair0 = 0;
  if (gi >= 0) {
    px = a.tx[r];
    py = a.ty[r];
    pz = a.tz[r];
    pair0 = a.tgrav[r] * a.n_gravs;
  }
  const int e1 = a.en + 1;
  const int sj = e1, si = e1 * e1;   // strides of j and i in float4s
  double fx = 0.0, fy = 0.0, fz = 0.0, fp = 0.0;
  const int ns = min(max(a.n_src[b], 0), a.s_cap);
  const float* rows = a.src + static_cast<size_t>(b) * 8 * a.s_cap;
  for (int base = 0; base < ns; base += TILE) {
    const int n = min(TILE, ns - base);
    __syncthreads();
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const int s = base + j;
      sx[j] = rows[FX * a.s_cap + s];
      sy[j] = rows[FY * a.s_cap + s];
      sz[j] = rows[FZ * a.s_cap + s];
      sm[j] = rows[FMASS * a.s_cap + s];
      sg[j] = __float_as_int(rows[IGRAV * a.s_cap + s]);
      sid[j] = __float_as_int(rows[IGID * a.s_cap + s]);
    }
    __syncthreads();
    if (gi < 0) continue;
    for (int j = lane; j < n; j += LANES) {
      const int id = sid[j];
      if (id == -1 || id == gi) continue;
      const float dx = min_image(sx[j] - px, a.box, a.inv_box);
      const float dy = min_image(sy[j] - py, a.box, a.inv_box);
      const float dz = min_image(sz[j] - pz, a.box, a.inv_box);
      float u, v, w;
      const int i = cell_of(fabsf(dx), a.fac_intp, a.en, u);
      const int jj = cell_of(fabsf(dy), a.fac_intp, a.en, v);
      const int k = cell_of(fabsf(dz), a.fac_intp, a.en, w);
      const float4* c = a.tables +
          ((static_cast<size_t>(pair0 + sg[j]) * e1 + i) * e1 + jj) * e1 + k;
      const float4 c0 = __ldg(c), c1 = __ldg(c + 1);
      const float4 c2 = __ldg(c + sj), c3 = __ldg(c + sj + 1);
      const float4 c4 = __ldg(c + si), c5 = __ldg(c + si + 1);
      const float4 c6 = __ldg(c + si + sj), c7 = __ldg(c + si + sj + 1);
      const float ou = 1.0f - u, ov = 1.0f - v, ow = 1.0f - w;
      const float uu = ou * ov, uv = ou * v, vu = u * ov, vv = u * v;
      const float w0 = uu * ow, w1 = uu * w, w2 = uv * ow, w3 = uv * w;
      const float w4 = vu * ow, w5 = vu * w, w6 = vv * ow, w7 = vv * w;
#define NGRAVS_TRILINEAR(F)                                                 \
  (w0 * c0.F + w1 * c1.F + w2 * c2.F + w3 * c3.F + w4 * c4.F + w5 * c5.F + \
   w6 * c6.F + w7 * c7.F)
      // each term in float32, as the twin's; the sums in float64
      const float m = sm[j];
      fx += m * ((dx < 0.0f ? 1.0f : -1.0f) * NGRAVS_TRILINEAR(x));
      fy += m * ((dy < 0.0f ? 1.0f : -1.0f) * NGRAVS_TRILINEAR(y));
      fz += m * ((dz < 0.0f ? 1.0f : -1.0f) * NGRAVS_TRILINEAR(z));
      if (WANT_POT) fp += m * NGRAVS_TRILINEAR(w);
#undef NGRAVS_TRILINEAR
    }
  }
  fx = lane_sum<LANES>(fx);
  fy = lane_sum<LANES>(fy);
  fz = lane_sum<LANES>(fz);
  if (WANT_POT) fp = lane_sum<LANES>(fp);
  if (t < a.group && lane == 0) {
    a.acc[3 * static_cast<size_t>(r)] = static_cast<float>(fx);
    a.acc[3 * static_cast<size_t>(r) + 1] = static_cast<float>(fy);
    a.acc[3 * static_cast<size_t>(r) + 2] = static_cast<float>(fz);
    if (WANT_POT) a.pot[r] = static_cast<float>(fp);
  }
}

template <bool WANT_POT>
void launch(const LatticeArgs& a, int n_blocks, int lanes,
            cudaStream_t stream) {
  const dim3 grid(n_blocks);
  const dim3 block((a.group * lanes + 31) / 32 * 32);
  switch (lanes) {
    case 1: lattice_kernel<1, WANT_POT><<<grid, block, 0, stream>>>(a); break;
    case 2: lattice_kernel<2, WANT_POT><<<grid, block, 0, stream>>>(a); break;
    case 4: lattice_kernel<4, WANT_POT><<<grid, block, 0, stream>>>(a); break;
    default: lattice_kernel<8, WANT_POT><<<grid, block, 0, stream>>>(a); break;
  }
}

}  // namespace

extern "C" {

// The lattice correction's sums for n_blocks blocks of `group` targets:
// acc [n_blocks * group, 3] and, when pot is not null, pot [n_blocks *
// group].  Returns a cudaError_t; cudaErrorInvalidValue for a shape the
// kernel does not take (group over 256, lanes not 1/2/4/8, group x lanes
// over 256 threads, EN under 1, no gravity, no box).
int ngravs_lattice(const float* tx, const float* ty, const float* tz,
                   const int* tgrav, const int* tgid, const float* src,
                   const int* n_src, const float* tables, int n_blocks,
                   int group, int s_cap, int lanes, int n_gravs, int en,
                   float fac_intp, float box, float inv_box, float* acc,
                   float* pot, void* stream) {
  if (n_blocks == 0) return 0;
  if (n_blocks < 0 || group <= 0 || group > MAX_GROUP || s_cap <= 0 ||
      lanes <= 0 || lanes > MAX_LANES || (lanes & (lanes - 1)) != 0 ||
      group * lanes > MAX_THREADS || n_gravs <= 0 || en < 1 || !(box > 0.0f))
    return static_cast<int>(cudaErrorInvalidValue);
  const LatticeArgs args = {tx, ty, tz, tgrav, tgid, src, n_src,
                            reinterpret_cast<const float4*>(tables), group,
                            s_cap, n_gravs, en, fac_intp, box, inv_box, acc,
                            pot};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pot != nullptr)
    launch<true>(args, n_blocks, lanes, s);
  else
    launch<false>(args, n_blocks, lanes, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
