// WaveHoltz cycle of the DDH preconditioner with the stiffness streamed
// through shared memory, for NVIDIA Hopper (sm_90a).
//
// Replaces cuddhelmholtz_tpu/ops/pallas/wave_cycle.py::_wave_kernel (launched
// by wave_cycle_pallas) at the pads where one subdomain stiffness S does not
// fit in a block's shared memory next to the row state (pad above 224 on an
// H100: S alone is 1.6 MB at pad 632, against 227 KB per block).  The
// Pallas kernel keeps S in VMEM up to pad 640; csrc/wave_cycle.cu, the
// resident variant, keeps it in shared memory up to pad 224.  Layouts:
//   (a) shared: one (pad, pad) S for every subdomain row (s_group_size = 0);
//   (b) grouped: an (ngroups, pad, pad) stack, rows in contiguous runs of
//       s_group_size (a multiple of kRows), run g against S[g].
// It computes what the Pallas kernel computes, with the resident variant's
// arithmetic: wh_maxit WaveHoltz fixed-point iterations, each restarting
// from (p, q) = (u, v) and (u, v) = K0 (u, v), of nt staggered-leapfrog steps
//
//     [zp ; zh] = [p ; p - dt/2 q] @ S
//     dq  = (zp - Ha q + cs0 F + sn0 G) mi,   q_half = q + dt/2 dq
//     p2  = p - dt q_half
//     dq2 = (zh - Ha q_half + cs1 F + sn1 G) mi,   q2 = q + dt dq2
//     u  += K_t p2,   v += K_t q2
//
// Padded slots and padded rows carry Ha = mi = 0 and F = G = 0, so they stay
// exactly zero.
//
// Design:
//   * each block owns kRows = 8 subdomain rows that share one S and keeps
//     their stacked [p ; p_half] rows in shared memory (16 pad floats);
//   * every step streams S in panels of kPanel = 8 k-rows through a ring of
//     kStages = 3 shared-memory slots filled with cp.async two panels ahead;
//     the panel sequence repeats every step, so the loads run on across step
//     and iteration boundaries and one __syncthreads per panel suffices;
//   * pad / 2 threads in two groups: thread (g, j) owns columns
//     [4j, 4j + 4) and accumulates the 8 products of group g's rows (g = 0:
//     the p rows, g = 1: the p_half rows) in registers, one float4 of S and
//     8 broadcast float4 of the rows per 128 FFMA; group 0 then updates rows
//     [0, 4), group 1 rows [4, 8), handing the other group's sums over
//     through shared memory;
//   * q of the owned rows stays in registers; F, G, Ha, mi are read from
//     device memory (L2) every step and u, v accumulate in the output arrays,
//     which keeps the kernel under 128 registers for up to 512 threads;
//   * plain fp32 FFMA: exact fp32 products, no TF32 and no split passes.
//
// What bounds it: every S element read from L2 feeds 2 kRows = 16 stacked
// rows, 8 FLOP per byte.  At the 67 TFLOP/s FP32 peak that needs 8.4 TB/s
// from L2, above what the H100's L2 delivers, so L2 bandwidth and latency
// bound the kernel before the FMA rate does.  The dense product also does
// 14-45 times the work the non-zeros of S need (at most 31 per column at
// pad 632): csrc/wave_cycle_sparse.cu applies those, and runs by default
// wherever they fit in shared memory; this kernel runs when forced.
// Shared memory: 4 (16 + 8 + 24) pad bytes, 121 KB at pad 632; pad <= 1024.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 8;          // subdomain rows per block
constexpr int kHalf = kRows / 2;  // rows whose update each thread group owns
constexpr int kPanel = 8;         // k-rows of S per streamed panel
constexpr int kStages = 3;        // panels in the shared-memory ring
constexpr int kMaxThreads = 512;  // threads per block == pad / 2

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 x) { *reinterpret_cast<float4*>(p) = x; }

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ void fma4(float4& acc, float a, float4 s) {
  acc.x = fmaf(a, s.x, acc.x);
  acc.y = fmaf(a, s.y, acc.y);
  acc.z = fmaf(a, s.z, acc.z);
  acc.w = fmaf(a, s.w, acc.w);
}

struct StepCoef {
  float cs0, sn0, cs1, sn1, kt, dt, half_dt;
};

// One leapfrog step of one slot; p, q advance, u, v accumulate the filter.
__device__ __forceinline__ void leapfrog(const StepCoef& k, float zp, float zh, float f, float g,
                                         float ha, float m, float& p, float& q, float& u,
                                         float& v) {
  const float dq = (zp - ha * q + k.cs0 * f + k.sn0 * g) * m;
  const float q_half = q + k.half_dt * dq;
  const float p2 = p - k.dt * q_half;
  const float dq2 = (zh - ha * q_half + k.cs1 * f + k.sn1 * g) * m;
  const float q2 = q + k.dt * dq2;
  p = p2;
  q = q2;
  u += k.kt * p2;
  v += k.kt * q2;
}

__global__ void __launch_bounds__(kMaxThreads, 1)
wave_cycle_streamed_kernel(const float* __restrict__ S, const float* __restrict__ F,
                           const float* __restrict__ G, const float* __restrict__ Ha,
                           const float* __restrict__ mi, const float* __restrict__ tables,
                           float* __restrict__ u_out, float* __restrict__ v_out, int ndom,
                           int pad, int nt, int wh_maxit, int s_group_size, float dt,
                           float K0) {
  extern __shared__ float4 smem4[];
  float* sP = reinterpret_cast<float*>(smem4);  // [2 kRows][pad]: p rows, then p_half
  float* sX = sP + 2 * kRows * pad;             // [2 groups][kHalf][pad] handed-over sums
  float* ring = sX + 2 * kHalf * pad;           // [kStages][kPanel][pad] S panels
  const int nq = pad / 4;
  const int grp = threadIdx.x >= nq;  // 0: products of the p rows, 1: of the p_half rows
  const int c = 4 * (threadIdx.x - grp * nq);  // first of this thread's four columns
  const int row0 = blockIdx.x * kRows;
  const int own = grp * kHalf;  // first of the rows this thread updates

  // layout (b): this block's rows all lie in run row0 / s_group_size
  const size_t group = s_group_size > 0 ? static_cast<size_t>(row0) / s_group_size : 0;
  const float* Sg = S + group * pad * pad;
  const int npan = pad / kPanel;
  const int panel = kPanel * pad;  // floats per panel
  int next = 0, next_slot = 0;     // the next panel to load and its ring slot
  auto prefetch = [&]() {
    float* dst = ring + next_slot * panel;
    const float* src = Sg + static_cast<size_t>(next) * panel;
    for (int i = 4 * threadIdx.x; i < panel; i += 4 * blockDim.x) cp_async16(dst + i, src + i);
    cp_async_commit();
    next = next + 1 == npan ? 0 : next + 1;
    next_slot = next_slot + 1 == kStages ? 0 : next_slot + 1;
  };
  for (int s = 0; s < kStages - 1; ++s) prefetch();

  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  bool ok[kHalf];
  size_t at[kHalf];  // offset of this thread's four slots of owned row r
  float4 q[kHalf];
#pragma unroll
  for (int r = 0; r < kHalf; ++r) {
    ok[r] = row0 + own + r < ndom;
    at[r] = static_cast<size_t>(row0 + own + r) * pad + c;
    q[r] = zero;
    if (ok[r]) {
      st4(u_out + at[r], zero);
      st4(v_out + at[r], zero);
    }
  }
  StepCoef k;
  k.dt = dt;
  k.half_dt = 0.5f * dt;
  const float* Pg = sP + grp * kRows * pad;  // the 8 stacked rows this group multiplies
  float* Xout = sX + grp * kHalf * pad;      // sums for the other group
  const float* Xin = sX + (1 - grp) * kHalf * pad;
  int slot = 0;  // ring slot of the panel being multiplied

  for (int it = 0; it < wh_maxit; ++it) {
#pragma unroll
    for (int r = 0; r < kHalf; ++r) {
      float4 p = zero;
      if (ok[r]) {
        p = ld4(u_out + at[r]);
        q[r] = ld4(v_out + at[r]);
        st4(u_out + at[r], make_float4(K0 * p.x, K0 * p.y, K0 * p.z, K0 * p.w));
        st4(v_out + at[r], make_float4(K0 * q[r].x, K0 * q[r].y, K0 * q[r].z, K0 * q[r].w));
      }
      st4(sP + (own + r) * pad + c, p);
      st4(sP + (kRows + own + r) * pad + c,
          make_float4(p.x - k.half_dt * q[r].x, p.y - k.half_dt * q[r].y,
                      p.z - k.half_dt * q[r].z, p.w - k.half_dt * q[r].w));
    }

    for (int t = 0; t < nt; ++t) {
      float4 acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = zero;
      for (int pi = 0; pi < npan; ++pi) {
        cp_async_wait<kStages - 2>();
        // panel pi has landed for every thread, the rows written by the last
        // update are visible, and the slot refilled next is no longer read
        __syncthreads();
        prefetch();
        const float* Sp = ring + slot * panel + c;
        const float* Pk = Pg + pi * kPanel;
#pragma unroll
        for (int kk = 0; kk < kPanel; kk += 4) {
          const float4 s0 = ld4(Sp + (kk + 0) * pad);
          const float4 s1 = ld4(Sp + (kk + 1) * pad);
          const float4 s2 = ld4(Sp + (kk + 2) * pad);
          const float4 s3 = ld4(Sp + (kk + 3) * pad);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const float4 a = ld4(Pk + r * pad + kk);
            fma4(acc[r], a.x, s0);
            fma4(acc[r], a.y, s1);
            fma4(acc[r], a.z, s2);
            fma4(acc[r], a.w, s3);
          }
        }
        slot = slot + 1 == kStages ? 0 : slot + 1;
      }

      // group 0 hands over zp of rows [kHalf, kRows), group 1 zh of rows
      // [0, kHalf) (compile-time register indices)
#pragma unroll
      for (int r = 0; r < kHalf; ++r) st4(Xout + r * pad + c, grp ? acc[r] : acc[kHalf + r]);
      __syncthreads();  // handed-over sums visible; every read of sP is done

      const float* row = tables + 5 * t;
      k.cs0 = __ldg(row + 0);
      k.sn0 = __ldg(row + 1);
      k.cs1 = __ldg(row + 2);
      k.sn1 = __ldg(row + 3);
      k.kt = __ldg(row + 4);
#pragma unroll
      for (int r = 0; r < kHalf; ++r) {
        const float4 mine = grp ? acc[kHalf + r] : acc[r];
        const float4 other = ld4(Xin + r * pad + c);
        const float4 zp = grp ? other : mine;
        const float4 zh = grp ? mine : other;
        float* Prow = sP + (own + r) * pad + c;
        float4 p = ld4(Prow);
        float4 f = zero, g = zero, ha = zero, m = zero, u = zero, v = zero;
        if (ok[r]) {
          f = ldg4(F + at[r]);
          g = ldg4(G + at[r]);
          ha = ldg4(Ha + at[r]);
          m = ldg4(mi + at[r]);
          u = ld4(u_out + at[r]);
          v = ld4(v_out + at[r]);
        }
        leapfrog(k, zp.x, zh.x, f.x, g.x, ha.x, m.x, p.x, q[r].x, u.x, v.x);
        leapfrog(k, zp.y, zh.y, f.y, g.y, ha.y, m.y, p.y, q[r].y, u.y, v.y);
        leapfrog(k, zp.z, zh.z, f.z, g.z, ha.z, m.z, p.z, q[r].z, u.z, v.z);
        leapfrog(k, zp.w, zh.w, f.w, g.w, ha.w, m.w, p.w, q[r].w, u.w, v.w);
        st4(Prow, p);
        st4(Prow + kRows * pad,
            make_float4(p.x - k.half_dt * q[r].x, p.y - k.half_dt * q[r].y,
                        p.z - k.half_dt * q[r].z, p.w - k.half_dt * q[r].w));
        if (ok[r]) {
          st4(u_out + at[r], u);
          st4(v_out + at[r], v);
        }
      }
    }
  }
  cp_async_wait<0>();  // the last prefetches land before the block exits
}

}  // namespace

extern "C" {

int wave_cycle_streamed_rows_per_block() { return kRows; }

int wave_cycle_streamed_max_pad() { return 2 * kMaxThreads; }

// Dynamic shared memory one block needs: the stacked rows, the handed-over
// sums and the ring of S panels.
long long wave_cycle_streamed_shared_memory_bytes(int pad) {
  return 4LL * (2 * kRows + 2 * kHalf + kStages * kPanel) * pad;
}

const char* wave_cycle_streamed_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launch one cycle on `stream`.  All pointers are device float32,
// contiguous and 16-byte aligned: S (pad, pad) with s_group_size = 0, or
// (ndom / s_group_size, pad, pad) with s_group_size a multiple of kRows
// dividing ndom (the wrapper checks both); F, G, Ha, mi, u, v (ndom, pad);
// tables (nt, 5).  pad is a multiple of kPanel and at most 2 kMaxThreads.
// Returns a cudaError_t; 0 means the launch was accepted.
int wave_cycle_streamed_launch(const float* S, const float* F, const float* G, const float* Ha,
                               const float* mi, const float* tables, float* u, float* v,
                               int ndom, int pad, int nt, int wh_maxit, int s_group_size,
                               float dt, float K0, int device, void* stream) {
  if (pad < kPanel || pad % kPanel || pad > 2 * kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long smem = wave_cycle_streamed_shared_memory_bytes(pad);
  err = cudaFuncSetAttribute(wave_cycle_streamed_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (ndom + kRows - 1) / kRows;
  wave_cycle_streamed_kernel<<<blocks, pad / 2, static_cast<size_t>(smem),
                               static_cast<cudaStream_t>(stream)>>>(
      S, F, G, Ha, mi, tables, u, v, ndom, pad, nt, wh_maxit, s_group_size, dt, K0);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
