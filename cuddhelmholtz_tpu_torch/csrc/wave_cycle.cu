// WaveHoltz cycle of the DDH preconditioner, shared-stiffness layout, for
// NVIDIA Hopper (sm_90a).
//
// Replaces cuddhelmholtz_tpu/ops/pallas/wave_cycle.py::_wave_kernel (launched
// by wave_cycle_pallas) for one (pad, pad) stiffness S shared by every
// subdomain row.  It computes what the Pallas kernel computes: wh_maxit
// WaveHoltz fixed-point iterations, each restarting from (p, q) = (u, v) and
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
// What bounds it: at the flagship configuration (1,024 subdomains, 169 real
// DOFs padded to 176, nt = 800, wh_maxit = 5) one cycle is 4,000 steps of two
// (rows, 176) x (176, 176) products, about 5e11 FLOP.  Every step depends on
// the one before, so nothing can leave the SM between steps: the limit is
// FP32 FMA throughput and the shared-memory reads of S and of the stacked
// rows that feed it, with too few warps per SM to hide their latency.
//
// What the design does about that:
//   * one launch runs the whole wh_maxit x nt loop; state never goes back to
//     device memory (one read of F, G, Ha, mi and one write of u, v);
//   * each block owns kRows = 8 subdomain rows (128 blocks for 1,024 rows on
//     132 SMs) and stages S once into dynamic shared memory (124 KB at
//     pad 176; one block per SM);
//   * 2 pad threads per block (11 warps at pad 176): thread (g, c) sums the
//     half k range g of column c for all 16 stacked rows, reading four S
//     values (consecutive threads, consecutive banks) and 16 float4
//     broadcasts per 64 FMAs; the two halves meet through shared memory and
//     group g updates rows [4g, 4g + 4), keeping their p, q, u, v, F, G, Ha,
//     mi in registers.  Splitting k doubled the warps per SM and cut a cycle
//     from 27.7 to 23.0 ms against one thread per column (NVIDIA H100 80GB
//     HBM3 at its 700 W limit; PERF.md);
//   * plain fp32 FFMA: exact fp32 products, no TF32 and no split passes.
// Known limits, left for later work: S must fit in shared memory (pad up to
// about 220), and the kernel runs at about a third of the FP32 FMA peak.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 8;          // subdomain rows per block
constexpr int kHalf = kRows / 2;  // rows whose update each k-group owns
constexpr int kMaxThreads = 512;  // threads per block == 2 * pad

// Two thread groups per block: group g sums the k range
// [g pad/2, (g+1) pad/2) for all rows, hands the other group's rows over
// through shared memory and updates rows [g kHalf, (g+1) kHalf).
__global__ void __launch_bounds__(kMaxThreads, 1)
wave_cycle_kernel(const float* __restrict__ S, const float* __restrict__ F,
                  const float* __restrict__ G, const float* __restrict__ Ha,
                  const float* __restrict__ mi, const float* __restrict__ tables,
                  float* __restrict__ u_out, float* __restrict__ v_out, int ndom,
                  int pad, int nt, int wh_maxit, float dt, float K0) {
  extern __shared__ float4 smem4[];
  float* sS = reinterpret_cast<float*>(smem4);  // (pad, pad)
  float* sP = sS + pad * pad;                   // [2 kRows][pad]: p rows, then p_half
  float* sX = sP + 2 * kRows * pad;             // [2 groups][2 kHalf][pad] partials
  const int grp = threadIdx.x >= pad;
  const int c = threadIdx.x - grp * pad;
  const int kbeg = grp * (pad / 2), kend = kbeg + pad / 2;
  const int d0 = blockIdx.x * kRows + grp * kHalf;  // first owned row

  const float4* S4 = reinterpret_cast<const float4*>(S);
  for (int i = threadIdx.x; i < pad * pad / 4; i += blockDim.x) smem4[i] = S4[i];

  float f[kHalf], g[kHalf], ha[kHalf], m[kHalf];
  float p[kHalf], q[kHalf], u[kHalf], v[kHalf];
#pragma unroll
  for (int r = 0; r < kHalf; ++r) {
    const bool ok = d0 + r < ndom;
    const size_t i = static_cast<size_t>(d0 + r) * pad + c;
    f[r] = ok ? F[i] : 0.f;
    g[r] = ok ? G[i] : 0.f;
    ha[r] = ok ? Ha[i] : 0.f;
    m[r] = ok ? mi[i] : 0.f;
    u[r] = 0.f;
    v[r] = 0.f;
  }
  const float half_dt = 0.5f * dt;
  float* Pown = sP + grp * kHalf * pad;                 // this group's p rows
  float* Hown = sP + (kRows + grp * kHalf) * pad;       // and p_half rows
  float* Xout = sX + grp * 2 * kHalf * pad;             // partials for the other group
  const float* Xin = sX + (1 - grp) * 2 * kHalf * pad;  // partials from it

  for (int it = 0; it < wh_maxit; ++it) {
#pragma unroll
    for (int r = 0; r < kHalf; ++r) {
      p[r] = u[r];
      q[r] = v[r];
      u[r] = K0 * u[r];
      v[r] = K0 * v[r];
      Pown[r * pad + c] = p[r];
      Hown[r * pad + c] = p[r] - half_dt * q[r];
    }
    __syncthreads();

    for (int t = 0; t < nt; ++t) {
      float zp[kRows], zh[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        zp[r] = 0.f;
        zh[r] = 0.f;
      }
#pragma unroll 2
      for (int k = kbeg; k < kend; k += 4) {
        const float s0 = sS[(k + 0) * pad + c];
        const float s1 = sS[(k + 1) * pad + c];
        const float s2 = sS[(k + 2) * pad + c];
        const float s3 = sS[(k + 3) * pad + c];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float4 a = *reinterpret_cast<const float4*>(sP + r * pad + k);
          const float4 b = *reinterpret_cast<const float4*>(sP + (kRows + r) * pad + k);
          zp[r] = fmaf(a.x, s0, zp[r]);
          zp[r] = fmaf(a.y, s1, zp[r]);
          zp[r] = fmaf(a.z, s2, zp[r]);
          zp[r] = fmaf(a.w, s3, zp[r]);
          zh[r] = fmaf(b.x, s0, zh[r]);
          zh[r] = fmaf(b.y, s1, zh[r]);
          zh[r] = fmaf(b.z, s2, zh[r]);
          zh[r] = fmaf(b.w, s3, zh[r]);
        }
      }
      // hand the other group's rows over (compile-time register indices)
#pragma unroll
      for (int r = 0; r < kHalf; ++r) {
        Xout[r * pad + c] = grp ? zp[r] : zp[kHalf + r];
        Xout[(kHalf + r) * pad + c] = grp ? zh[r] : zh[kHalf + r];
      }
      __syncthreads();  // partials visible; every read of sP is done

      const float* row = tables + 5 * t;
      const float cs0 = __ldg(row + 0), sn0 = __ldg(row + 1);
      const float cs1 = __ldg(row + 2), sn1 = __ldg(row + 3);
      const float kt = __ldg(row + 4);
#pragma unroll
      for (int r = 0; r < kHalf; ++r) {
        const float ap = (grp ? zp[kHalf + r] : zp[r]) + Xin[r * pad + c];
        const float ah = (grp ? zh[kHalf + r] : zh[r]) + Xin[(kHalf + r) * pad + c];
        const float dq = (ap - ha[r] * q[r] + cs0 * f[r] + sn0 * g[r]) * m[r];
        const float q_half = q[r] + half_dt * dq;
        const float p2 = p[r] - dt * q_half;
        const float dq2 = (ah - ha[r] * q_half + cs1 * f[r] + sn1 * g[r]) * m[r];
        const float q2 = q[r] + dt * dq2;
        p[r] = p2;
        q[r] = q2;
        u[r] += kt * p2;
        v[r] += kt * q2;
        Pown[r * pad + c] = p2;
        Hown[r * pad + c] = p2 - half_dt * q2;
      }
      __syncthreads();  // new rows visible; every read of sX is done
    }
  }

#pragma unroll
  for (int r = 0; r < kHalf; ++r) {
    if (d0 + r < ndom) {
      const size_t i = static_cast<size_t>(d0 + r) * pad + c;
      u_out[i] = u[r];
      v_out[i] = v[r];
    }
  }
}

}  // namespace

extern "C" {

int wave_cycle_rows_per_block() { return kRows; }

int wave_cycle_max_threads() { return kMaxThreads; }

// Dynamic shared memory one block needs: S, the stacked rows and the
// partial sums handed between the two k-groups.
long long wave_cycle_shared_memory_bytes(int pad) {
  return 4LL * (static_cast<long long>(pad) * pad + 2LL * 2 * kRows * pad);
}

// Opt-in shared-memory limit per block of `device`, or -1 on error.
int wave_cycle_max_shared_memory(int device) {
  int bytes = 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
      cudaSuccess)
    return -1;
  return bytes;
}

const char* wave_cycle_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launch one cycle on `stream`.  All pointers are device float32, contiguous:
// S (pad, pad); F, G, Ha, mi, u, v (ndom, pad); tables (nt, 5).  Returns a
// cudaError_t; 0 means the launch was accepted.
int wave_cycle_launch(const float* S, const float* F, const float* G, const float* Ha,
                      const float* mi, const float* tables, float* u, float* v, int ndom,
                      int pad, int nt, int wh_maxit, float dt, float K0, int device,
                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long smem = wave_cycle_shared_memory_bytes(pad);
  err = cudaFuncSetAttribute(wave_cycle_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (ndom + kRows - 1) / kRows;
  wave_cycle_kernel<<<blocks, 2 * pad, static_cast<size_t>(smem),
                      static_cast<cudaStream_t>(stream)>>>(S, F, G, Ha, mi, tables, u, v,
                                                          ndom, pad, nt, wh_maxit, dt, K0);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
