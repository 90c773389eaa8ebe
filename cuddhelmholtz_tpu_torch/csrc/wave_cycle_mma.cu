// WaveHoltz cycle of the DDH preconditioner with the subdomain stiffness
// applied on the tensor cores (mma.sync, TF32 in three split passes), for
// NVIDIA Hopper (sm_90a).
//
// Replaces cuddhelmholtz_tpu/ops/pallas/wave_cycle.py::_wave_kernel (launched
// by wave_cycle_pallas) in its stiffness layouts
//   (a) shared: one S for every subdomain row (s_group_size = 0);
//   (b) grouped: one S per run of s_group_size rows (a multiple of kRows),
//       run g against S[g].
// Layout (c), one S per row, stays on csrc/wave_cycle_sparse.cu's per-row
// instance: a block here needs kRows rows that share one S.
// It computes what the Pallas kernel computes: wh_maxit WaveHoltz
// fixed-point iterations, each restarting from (p, q) = (u, v) and
// (u, v) = K0 (u, v), of nt staggered-leapfrog steps
//
//     [zp ; zh] = [p ; p - dt/2 q] @ S
//     dq  = (zp - Ha q + cs0 F + sn0 G) mi,   q_half = q + dt/2 dq
//     p2  = p - dt q_half
//     dq2 = (zh - Ha q_half + cs1 F + sn1 G) mi,   q2 = q + dt dq2
//     u  += K_t p2,   v += K_t q2
//
// with (cs0, sn0, cs1, sn1, K_t) the step's row of `tables`.  Padded slots
// and padded rows carry Ha = mi = 0 and F = G = 0, so they stay exactly zero.
//
// The TPU kernel runs [p ; p_half] @ S on the MXU as a 3-pass bf16 split
// (S1 = bf16(S), S2 = bf16(S - S1), likewise P; P1 S1 + P1 S2 + P2 S1 in
// fp32).  This kernel is its counterpart on Hopper's tensor cores, in
// TF32, which keeps more bits: each operand x is split into hi, x rounded
// to TF32 to nearest with ties away from zero (cvt.rna.tf32.f32's rounding,
// written as two integer operations: bit-identical for finite x, and
// cheaper than the instruction here), and lo = x - hi (exact), of which the
// mma reads the top 19 bits.  a_hi b_hi, a_hi b_lo and a_lo b_hi go to
// three fp32 accumulators, added at the end of the step (never one TF32
// pass: its 2^-11 error stalls the lambda-GMRES).  The dropped terms (lo lo
// and the two cut lo) stay below 2^-19 of |a| |b|; the wrapper's
// tf32_split models the parts for the tests.
//
// What bounded csrc/wave_cycle_sparse.cu (plain FFMA): every FMA reads one
// float of p or p_half from shared memory that no other FMA of the thread
// uses, and an SM serves one 32-lane wavefront a clock against four warp
// FMA instructions, so it cannot pass about a fifth of the FP32 FMA rate.
// Here an operand fragment is read once for a whole 16 x 8 x 8 product:
//
//   * a block owns kRows = 8 subdomain rows that share one S; their stacked
//     [p ; p_half] is the M = 16 of mma.sync.m16n8k8 (rows 0-7 p, 8-15
//     p_half), read from shared memory as the A fragment, two buffers and
//     one barrier a step.  The buffers are stored in fragment order (k-tile,
//     lane, {p, p_half} at k0 + t and k0 + t + 4), so a lane reads its A
//     fragment with one 16-byte load, the warp in four wavefronts;
//   * S enters as its non-zero 8 (k) x 8 (i) tiles only (the wrapper's
//     tile_form: 168 of 484 at pad 176, 4.7 MACs per non-zero), staged in
//     shared memory once per launch in B-fragment order (one 8-byte load a
//     lane, two wavefronts a tile) with a 2-byte k-tile offset each;
//   * warp w owns up to SLOTS output-column tiles (the form's (warp, slot)
//     table, dealt by falling pair count); for each it walks the tile's
//     non-zero k-tiles, kUnroll pairs in flight: one A and one B load, their
//     splits, three mma into three accumulators (three independent chains);
//   * in the accumulator layout a thread holds rows g and g + 8 of columns
//     2t, 2t + 1, so zp and zh of one (row, column) land in one thread: the
//     leapfrog update is thread-local and q, u, v, p, F, G, Ha, mi of the
//     thread's 2 columns x SLOTS stay in registers for the whole launch
//     (one read of F, G, Ha, mi and one write of u, v);
//   * SLOTS is a template parameter: the instance with the fewest slots
//     whose warp cap covers pad / 8 tiles runs (24 warps x 1 slot up to pad
//     192, 20 x 2 to 320, 16 x 3 to 384, 16 x 4 to 512), the caps keeping a
//     block's registers on one SM (__launch_bounds__);
//   * no atomics and a fixed order of sums: repeats are bitwise.
//
// What bounds it now (an H100 at 700 W, examples/k1_study.py: each build
// timed in turns with the default one and the FFMA kernel): the three
// passes and the step's latency, not the tensor rate.  At the flagship's
// 1,024 rows a step takes 1.6 us (6.28 ms / 4,000 steps).  The same source
// built with one pass on the raw floats (WC_MMA_ABLATION 3, results wrong)
// takes 62-65 % of the time at every shape measured, so the split costs
// 35-38 %: 30-33 % the two extra mma passes (one pass on the hi parts,
// ablation 2, keeps the splits), 2-6 % the split instructions.  Without
// any mma (ablation 4) 76-80 % of the time stays: the loads, their
// latency and the per-step barrier.  One pass alone would beat the FFMA
// kernel 1.3-1.9x, the three passes 0.8-1.2x.  hi cut toward zero in place
// of rounded (ablation 1) saves 8-10 %, but its rounding is biased and
// the cycle's error grows 20x (3.5e-5 against 1.8e-6 of the FFMA kernel's
// output at the flagship): not taken.  Tried on the card and
// removed: cvt.rna.tf32.f32 itself (the integer form is cheaper), S's tiles
// in registers (22 warps leave 80 registers a thread: spills), two output
// tiles a warp with half the warps, and the k-tiles as a bit mask in place
// of the staged offsets (the loop no longer pipelines its loads).  Not
// built: output columns on M with S's 16 x 8 tiles as the A operand in
// registers (6.1 MACs per non-zero against 4.7, and the same register
// limit), and wgmma, whose 64-row M tile needs 32 rows a block (32 blocks
// for the flagship's 1,024 rows on 132 SMs).  The wrapper's default
// (mma_preferred) runs this kernel where it measured faster: S's tiles
// dense (>= 9 per output tile) at pad <= 192, at any row count.

#include <cuda_runtime.h>

#include <cstdint>

// Measurement builds only (examples/k1_study.py; the wrapper loads the default
// build, 0): 1 hi cut toward zero in place of rounded, three passes; 2 one
// pass on the hi parts; 3 one pass on the raw floats, no split; 4 the splits
// without the mma.  1-3 lose precision and 4 computes nothing the cycle
// needs: they time what each part of the product costs.
#ifndef WC_MMA_ABLATION
#define WC_MMA_ABLATION 0
#endif

namespace {

constexpr int kRows = 8;  // subdomain rows per block: [p ; p_half] is M = 16
constexpr int kTile = 8;  // S tiles: 8 (k) x 8 (i), the K and N of m16n8k8

// the warp cap of each instance (MMA_INSTANCES in the wrapper)
template <int SLOTS>
struct Cap;
template <>
struct Cap<1> {
  static constexpr int warps = 24;
};
template <>
struct Cap<2> {
  static constexpr int warps = 20;
};
template <>
struct Cap<3> {
  static constexpr int warps = 16;
};
template <>
struct Cap<4> {
  static constexpr int warps = 16;
};
constexpr int kMaxPad = kTile * 4 * 16;
constexpr int kUnroll = 8;  // pairs in flight a warp

// (slots, warps) at pad, as the wrapper's mma_layout; slots 0 above kMaxPad
void layout(int pad, int* slots, int* warps) {
  const int n = (pad + kTile - 1) / kTile;
  const int caps[4] = {Cap<1>::warps, Cap<2>::warps, Cap<3>::warps, Cap<4>::warps};
  for (int s = 1; s <= 4; ++s) {
    if (n <= s * caps[s - 1]) {
      *slots = s;
      *warps = (n + s - 1) / s;
      return;
    }
  }
  *slots = 0;
  *warps = 0;
}

// TF32 parts of x: hi rounded to nearest, ties away from zero (the rounding
// of cvt.rna.tf32.f32, here as two integer operations, bit-identical for
// finite x), lo = x - hi exactly; the mma reads lo's top 19 bits (TF32
// toward zero).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
#if WC_MMA_ABLATION == 1
  hi = __float_as_uint(x) & 0xffffe000u;
#else
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
#endif
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a b on a 16 x 8 x 8 TF32 tile, fp32 accumulation
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One (A fragment, tile) pair of the three passes: a_hi b_hi into big,
// a_hi b_lo into s1, a_lo b_hi into s2 (three independent mma chains).
__device__ __forceinline__ void product(const float4 a, const float2 b, float (&big)[4],
                                        float (&s1)[4], float (&s2)[4]) {
#if WC_MMA_ABLATION == 3
  const uint32_t ar[4] = {__float_as_uint(a.x), __float_as_uint(a.y), __float_as_uint(a.z),
                          __float_as_uint(a.w)};
  mma(big, ar, __float_as_uint(b.x), __float_as_uint(b.y));
#else
  uint32_t ah[4], al[4], bh0, bl0, bh1, bl1;
  split(a.x, ah[0], al[0]);
  split(a.y, ah[1], al[1]);
  split(a.z, ah[2], al[2]);
  split(a.w, ah[3], al[3]);
  split(b.x, bh0, bl0);
  split(b.y, bh1, bl1);
#if WC_MMA_ABLATION == 2
  mma(big, ah, bh0, bh1);
#elif WC_MMA_ABLATION == 4
#pragma unroll
  for (int r = 0; r < 4; ++r)
    big[r] = __uint_as_float(__float_as_uint(big[r]) ^ ah[r] ^ al[r] ^ bh0 ^ bl0 ^ bh1 ^ bl1);
#else
  mma(big, ah, bh0, bh1);
  mma(s1, ah, bl0, bl1);
  mma(s2, al, bh0, bh1);
#endif
#endif
}

// Where (p, p_half) of row g, column 8 tile + cc sits in a fragment-ordered
// buffer: float4 (tile, lane 4 g + cc % 4), its x, y (cc < 4) or z, w.
__device__ __forceinline__ int frag_at(int tile, int g, int cc) {
  return ((tile * 32 + 4 * g + (cc & 3)) << 2) + ((cc >> 2) << 1);
}

template <int SLOTS>
__global__ void __launch_bounds__(32 * Cap<SLOTS>::warps, 1)
wave_cycle_mma_kernel(const float* __restrict__ val, const short* __restrict__ kt,
                      const int* __restrict__ ptr, const short* __restrict__ col, int pairs,
                      const float* __restrict__ F, const float* __restrict__ G,
                      const float* __restrict__ Ha, const float* __restrict__ mi,
                      const float* __restrict__ tables, float* __restrict__ u_out,
                      float* __restrict__ v_out, int ndom, int pad, int nt, int wh_maxit,
                      int s_group_size, float dt, float K0) {
  extern __shared__ float4 smem4[];
  const int n_k = pad / kTile;
  const int buffer = n_k * 32;  // float4 per [p ; p_half] buffer
  float* sP = reinterpret_cast<float*>(smem4);                 // [2][n_k][32] float4
  float2* sB = reinterpret_cast<float2*>(smem4 + 2 * buffer);  // [pairs][32] float2
  short* sK = reinterpret_cast<short*>(sB + static_cast<size_t>(pairs) * 32);  // [pairs]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nslot = (blockDim.x >> 5) * SLOTS;
  const int row0 = blockIdx.x * kRows;
  // layout (b): this block's rows all lie in run row0 / s_group_size
  const int group = s_group_size > 0 ? row0 / s_group_size : 0;

  // Stage this S's tiles and their k-tiles (as the float4 offsets of the A
  // fragments) in shared memory.
  const int* gptr = ptr + static_cast<size_t>(group) * (nslot + 1);
  const int count = gptr[nslot];
  if (count > pairs) __trap();  // the form's pairs must hold every group's tiles
  const float2* gB = reinterpret_cast<const float2*>(val) + static_cast<size_t>(group) * pairs * 32;
  for (int j = threadIdx.x; j < count * 32; j += blockDim.x) sB[j] = gB[j];
  const short* gK = kt + static_cast<size_t>(group) * pairs;
  for (int j = threadIdx.x; j < count; j += blockDim.x) sK[j] = static_cast<short>(32 * gK[j]);

  // This warp's slots: output-column tile and pair range.
  int tile[SLOTS], beg[SLOTS], end[SLOTS];
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const int q = warp * SLOTS + s;
    tile[s] = col[static_cast<size_t>(group) * nslot + q];
    beg[s] = gptr[q];
    end[s] = gptr[q + 1];
  }

  // Thread (g, t) holds row row0 + g at columns 8 tile + 2 t + c, c = 0, 1.
  const int row = row0 + g;
  float f[SLOTS][2], gg[SLOTS][2], ha[SLOTS][2], m[SLOTS][2];
  float p[SLOTS][2], q[SLOTS][2], u[SLOTS][2], v[SLOTS][2];
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const bool ok = tile[s] >= 0 && row < ndom;
    const size_t i = static_cast<size_t>(row) * pad + kTile * tile[s] + 2 * t;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      f[s][c] = ok ? F[i + c] : 0.f;
      gg[s][c] = ok ? G[i + c] : 0.f;
      ha[s][c] = ok ? Ha[i + c] : 0.f;
      m[s][c] = ok ? mi[i + c] : 0.f;
      u[s][c] = 0.f;
      v[s][c] = 0.f;
    }
  }
  const float half_dt = 0.5f * dt;
  int cur = 0;  // the buffer this step reads

  for (int it = 0; it < wh_maxit; ++it) {
    float* Pw = sP + cur * 4 * buffer;
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        p[s][c] = u[s][c];
        q[s][c] = v[s][c];
        u[s][c] = K0 * u[s][c];
        v[s][c] = K0 * v[s][c];
        if (tile[s] >= 0)
          *reinterpret_cast<float2*>(Pw + frag_at(tile[s], g, 2 * t + c)) =
              make_float2(p[s][c], p[s][c] - half_dt * q[s][c]);
      }
    }
    __syncthreads();  // rows and S visible; every read of the last step is done

    for (int step = 0; step < nt; ++step) {
      const float4* P = reinterpret_cast<const float4*>(sP + cur * 4 * buffer);
      const float* trow = tables + 5 * step;
      const float cs0 = __ldg(trow + 0), sn0 = __ldg(trow + 1);
      const float cs1 = __ldg(trow + 2), sn1 = __ldg(trow + 3);
      const float weight = __ldg(trow + 4);
      cur ^= 1;
      float* Pn = sP + cur * 4 * buffer;
#pragma unroll
      for (int s = 0; s < SLOTS; ++s) {
        if (tile[s] < 0) continue;  // uniform over the warp
        float big[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};
        float s2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll kUnroll
        for (int j = beg[s]; j < end[s]; ++j)
          product(P[sK[j] + lane], sB[j * 32 + lane], big, s1, s2);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float zp = big[c] + (s1[c] + s2[c]);
          const float zh = big[2 + c] + (s1[2 + c] + s2[2 + c]);
          const float dq = (zp - ha[s][c] * q[s][c] + cs0 * f[s][c] + sn0 * gg[s][c]) * m[s][c];
          const float q_half = q[s][c] + half_dt * dq;
          const float p2 = p[s][c] - dt * q_half;
          const float dq2 = (zh - ha[s][c] * q_half + cs1 * f[s][c] + sn1 * gg[s][c]) * m[s][c];
          const float q2 = q[s][c] + dt * dq2;
          p[s][c] = p2;
          q[s][c] = q2;
          u[s][c] += weight * p2;
          v[s][c] += weight * q2;
          *reinterpret_cast<float2*>(Pn + frag_at(tile[s], g, 2 * t + c)) =
              make_float2(p2, p2 - half_dt * q2);
        }
      }
      // the new rows are visible, and every read of the buffer the next
      // step writes is done
      __syncthreads();
    }
  }

#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    if (tile[s] >= 0 && row < ndom) {
      const size_t i = static_cast<size_t>(row) * pad + kTile * tile[s] + 2 * t;
      *reinterpret_cast<float2*>(u_out + i) = make_float2(u[s][0], u[s][1]);
      *reinterpret_cast<float2*>(v_out + i) = make_float2(v[s][0], v[s][1]);
    }
  }
}

template <int SLOTS>
cudaError_t prepare(long long smem) {
  return cudaFuncSetAttribute(wave_cycle_mma_kernel<SLOTS>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int SLOTS>
int launch_slots(const float* val, const short* kt, const int* ptr, const short* col, int pairs,
                 const float* F, const float* G, const float* Ha, const float* mi,
                 const float* tables, float* u, float* v, int ndom, int pad, int nt,
                 int wh_maxit, int s_group_size, float dt, float K0, int warps, long long smem,
                 cudaStream_t stream) {
  cudaError_t err = prepare<SLOTS>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (ndom + kRows - 1) / kRows;
  wave_cycle_mma_kernel<SLOTS><<<blocks, 32 * warps, static_cast<size_t>(smem), stream>>>(
      val, kt, ptr, col, pairs, F, G, Ha, mi, tables, u, v, ndom, pad, nt, wh_maxit,
      s_group_size, dt, K0);
  return static_cast<int>(cudaGetLastError());
}

template <int SLOTS>
cudaError_t occupancy(int warps, long long smem, int* blocks, int* regs) {
  cudaError_t err = prepare<SLOTS>(smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, wave_cycle_mma_kernel<SLOTS>);
  if (err != cudaSuccess) return err;
  *regs = attr.numRegs;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, wave_cycle_mma_kernel<SLOTS>,
                                                       32 * warps, static_cast<size_t>(smem));
}

}  // namespace

extern "C" {

int wave_cycle_mma_rows_per_block() { return kRows; }

int wave_cycle_mma_max_pad() { return kMaxPad; }

// The instance at pad: output-column tiles a warp owns (0: none takes pad)
// and warps a block.
int wave_cycle_mma_slots(int pad) {
  int slots, warps;
  layout(pad, &slots, &warps);
  return slots;
}

int wave_cycle_mma_warps(int pad) {
  int slots, warps;
  layout(pad, &slots, &warps);
  return warps;
}

// Dynamic shared memory one block needs: the two fragment-ordered
// [p ; p_half] buffers (2 x 2 kRows pad floats) and one S's `pairs` tiles
// (64 floats and a 2-byte k-tile offset each).
long long wave_cycle_mma_shared_memory_bytes(int pad, int pairs) {
  return 4LL * 2 * 2 * kRows * pad + (4LL * kTile * kTile + 2) * pairs;
}

const char* wave_cycle_mma_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launch one cycle on `stream`.  All pointers are device arrays, contiguous:
// the tile form val float32 (ngroups, pairs, 64), kt int16 (ngroups, pairs),
// ptr int32 (ngroups, warps * slots + 1), col int16 (ngroups, warps *
// slots) for the instance at pad (wave_cycle_mma_slots, _warps), with
// ngroups = 1 for s_group_size = 0, else ndom / s_group_size and
// s_group_size a multiple of kRows (the wrapper checks both); F, G, Ha, mi,
// u, v float32 (ndom, pad), pad a multiple of 8 up to kMaxPad; tables
// float32 (nt, 5).  Returns a cudaError_t; 0 means the launch was accepted.
int wave_cycle_mma_launch(const float* val, const short* kt, const int* ptr, const short* col,
                          int pairs, const float* F, const float* G, const float* Ha,
                          const float* mi, const float* tables, float* u, float* v, int ndom,
                          int pad, int nt, int wh_maxit, int s_group_size, float dt, float K0,
                          int device, void* stream) {
  int slots, warps;
  layout(pad, &slots, &warps);
  if (slots == 0 || pad % kTile || pairs < 1 || s_group_size < 0 || (s_group_size % kRows) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long smem = wave_cycle_mma_shared_memory_bytes(pad, pairs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (slots) {
    case 1:
      return launch_slots<1>(val, kt, ptr, col, pairs, F, G, Ha, mi, tables, u, v, ndom, pad,
                             nt, wh_maxit, s_group_size, dt, K0, warps, smem, s);
    case 2:
      return launch_slots<2>(val, kt, ptr, col, pairs, F, G, Ha, mi, tables, u, v, ndom, pad,
                             nt, wh_maxit, s_group_size, dt, K0, warps, smem, s);
    case 3:
      return launch_slots<3>(val, kt, ptr, col, pairs, F, G, Ha, mi, tables, u, v, ndom, pad,
                             nt, wh_maxit, s_group_size, dt, K0, warps, smem, s);
    default:
      return launch_slots<4>(val, kt, ptr, col, pairs, F, G, Ha, mi, tables, u, v, ndom, pad,
                             nt, wh_maxit, s_group_size, dt, K0, warps, smem, s);
  }
}

// Blocks of the instance at pad that fit on one SM of `device` with `pairs`
// tiles staged (registers, threads and shared memory), or -1 on error; its
// registers a thread in *regs.
int wave_cycle_mma_blocks_per_sm(int pad, int pairs, int device, int* regs) {
  int slots, warps;
  layout(pad, &slots, &warps);
  if (slots == 0 || pairs < 1 || cudaSetDevice(device) != cudaSuccess) return -1;
  const long long smem = wave_cycle_mma_shared_memory_bytes(pad, pairs);
  int blocks = 0;
  cudaError_t err;
  switch (slots) {
    case 1: err = occupancy<1>(warps, smem, &blocks, regs); break;
    case 2: err = occupancy<2>(warps, smem, &blocks, regs); break;
    case 3: err = occupancy<3>(warps, smem, &blocks, regs); break;
    default: err = occupancy<4>(warps, smem, &blocks, regs); break;
  }
  return err == cudaSuccess ? blocks : -1;
}

}  // extern "C"
