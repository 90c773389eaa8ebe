// WaveHoltz cycle of the DDH preconditioner with the subdomain stiffness
// applied from its non-zeros in shared memory, for NVIDIA Hopper (sm_90a).
//
// Replaces cuddhelmholtz_tpu/ops/pallas/wave_cycle.py::_wave_kernel (launched
// by wave_cycle_pallas) in its stiffness layouts:
//   (a) shared: one S for every subdomain row (s_group_size = 0);
//   (b) grouped: one S per run of s_group_size rows (a multiple of kRows),
//       run g against S[g];
//   (c) per row: row r against S[r], in an instance of one row per block
//       (wave_cycle_sparse_per_row_launch).  The JAX solver tiles each row
//       x8 onto (b), because the TPU's 8-row sublane tile makes the replicas
//       free; here they would be 8x the FMAs and shared-memory reads, so no
//       row is computed twice.  (The dense kernels, forced only, still take
//       (c) through the wrapper's x8 tiling: their blocks need runs of 8.)
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
// S enters through its exact non-zeros, stored by output column (CSC of S,
// since out[:, i] = sum_k P[:, k] S[k, i]): int32 column offsets `ptr`
// (pad + 1 per group), int16 row indices `idx` and float32 values `val`, and
// an int16 slot -> column map `order` that sorts the columns by falling nnz,
// so the 32 columns of a warp run loops of nearly one length.  The subdomain
// stiffness couples a DOF only to the DOFs of its elements' grid lines: 7 to
// 61 non-zeros per column against pad = 168 to 632 dense entries, 8-64x
// less work than the dense kernels (csrc/wave_cycle.cu,
// csrc/wave_cycle_streamed.cu), which stay as forced variants.
//
// What bounds it: each FMA reads one float from shared memory (p or p_half
// of one row at the entry's k, used by no other FMA of the thread), and an
// SM serves one 32-lane 4-byte read (a wavefront) per clock against four
// warp FMA instructions: shared-memory bandwidth bounds the kernel at a
// quarter of the FP32 FMA rate on the sparse work (5/4 reads per FMA with
// the entry's k and S[k, i]), lower where two lanes of a warp read one bank
// at different k, and at small row counts the latency of each step's
// dependent loads and barrier.
//
// Design:
//   * one launch runs the whole wh_maxit x nt loop; state never goes back to
//     device memory (one read of F, G, Ha, mi and one write of u, v);
//   * a block owns kRows = 4 subdomain rows that share one S and keeps their
//     stacked [p ; p_half] in two shared-memory buffers (read one, write the
//     other, so one barrier per step suffices);
//   * it stages that S's entries in shared memory once, slot-interleaved:
//     entry j of a warp's lane l at 32 j + l of the warp's region, so the
//     lanes' loads of (k, S[k, i]) take one wavefront each; a warp's region
//     is 32 x its longest column, `stride` >= the largest sum of those over
//     the groups (64 pad + 6 stride bytes per block: 26 KB at the flagship,
//     102 KB at pad 632);
//   * it then reorders each warp's entries within their columns
//     (order_for_banks) so the lanes of one round read p[r][k] from distinct
//     banks where they can, once per block, a small part of its run;
//   * thread t owns column order[t] of all kRows rows: q, u, v, F, G, Ha, mi
//     and p of its slots stay in registers; for each non-zero (k, S[k, i])
//     of its column it does 2 kRows FMAs against p[r][k] and p_half[r][k];
//   * kRows = 4 divides every run length the paths use (8, 120, 192) and
//     gives 256 blocks for the flagship's 1,024 rows, two per SM;
//   * the rows per block are a template parameter R: kRows for layouts (a)
//     and (b), 1 for layout (c), where each block reads its own row's S.
//     With one row the (k, S[k, i]) loads are shared by 2 FMAs, not 2
//     kRows, but the row state is 16 pad bytes, not 64 pad, and the
//     instance asks for at most 48 registers a thread (two 640-thread
//     blocks' worth), so the blocks the staged S leaves room for fit on an
//     SM (four at L4's pad 320);
//   * at most 640 threads (pad <= 640) leave 96 registers a thread for the
//     j loop to keep its loads in flight (a 1,024-thread bound caps them at
//     64, and ran slower on the card);
//   * plain fp32 FFMA: exact fp32 products, no TF32 and no split passes.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 4;          // subdomain rows per block
constexpr int kMaxThreads = 640;  // one thread per column: pad <= 640
constexpr unsigned kFull = 0xffffffffu;

// Reorder the staged entries of one warp's columns (entry e of lane l at
// wI[32 e + l], n entries for this lane, `longest` for the warp) so that in
// each round j the 32 lanes read p[r][k] from distinct shared-memory banks
// (k mod 32) where they can.  Greedy, lane after lane: lane l takes, of its
// entries left (positions j .. n_l - 1), the first one whose bank no lane
// has used this round or used for the same k (a broadcast), else one of the
// least used bank, and swaps it into position j.  Thread b keeps the state
// of bank b; the candidates are spread over the warp and reduced with
// redux.sync.  The products are the same sums in another order.
__device__ void order_for_banks(short* wI, float* wV, int n, int longest, int lane) {
  for (int j = 0; j < longest; ++j) {
    int word = -1, used = 0;  // bank `lane` this round: its first k, distinct k taken
    for (int l = 0; l < 32; ++l) {
      const int nl = __shfl_sync(kFull, n, l);
      if (j >= nl) continue;  // uniform over the warp
      unsigned best_cost = 0xffffffffu, best_e = 0xffffffffu;
      for (int e0 = j; e0 < nl; e0 += 32) {
        const int e = e0 + lane;
        const int k = e < nl ? wI[32 * e + l] : 0;
        const int w_b = __shfl_sync(kFull, word, k & 31);
        const int u_b = __shfl_sync(kFull, used, k & 31);
        const unsigned cost = e < nl ? (w_b == k ? 0u : static_cast<unsigned>(u_b)) : 0xffffffffu;
        if (cost < best_cost) {
          best_cost = cost;
          best_e = e;
        }
      }
      const unsigned low = __reduce_min_sync(kFull, best_cost);
      const int e = static_cast<int>(__reduce_min_sync(kFull, best_cost == low ? best_e : 0xffffffffu));
      const int k = wI[32 * e + l];
      if (lane == (k & 31)) {
        if (word < 0) {
          word = k;
          used = 1;
        } else if (word != k) {
          ++used;
        }
      }
      __syncwarp();
      if (lane == 0 && e != j) {
        const short ki = wI[32 * e + l];
        wI[32 * e + l] = wI[32 * j + l];
        wI[32 * j + l] = ki;
        const float vi = wV[32 * e + l];
        wV[32 * e + l] = wV[32 * j + l];
        wV[32 * j + l] = vi;
      }
      __syncwarp();
    }
  }
}

// R rows per block: kRows (layouts (a), (b)) or 1 (layout (c), one S per row).
template <int R>
__global__ void __launch_bounds__(kMaxThreads, R == 1 ? 2 : 1)
wave_cycle_sparse_kernel(const int* __restrict__ ptr, const short* __restrict__ idx,
                         const float* __restrict__ val, const short* __restrict__ order,
                         int stride, const float* __restrict__ F, const float* __restrict__ G,
                         const float* __restrict__ Ha, const float* __restrict__ mi,
                         const float* __restrict__ tables, float* __restrict__ u_out,
                         float* __restrict__ v_out, int ndom, int pad, int nt, int wh_maxit,
                         int s_group_size, float dt, float K0) {
  extern __shared__ float4 smem4[];
  __shared__ int warp_len[kMaxThreads / 32];
  float* sP = reinterpret_cast<float*>(smem4);  // [2 buffers][2 R][pad]: p rows, p_half rows
  float* sV = sP + 4 * R * pad;                 // [stride] values, slot-interleaved
  short* sI = reinterpret_cast<short*>(sV + stride);  // [stride] row indices, likewise
  const int row0 = blockIdx.x * R;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // layouts (b), (c): this block's rows all lie in run row0 / s_group_size
  // (s_group_size = 1 in the per-row instance: row r against S[r])
  const int group = s_group_size > 0 ? row0 / s_group_size : 0;
  const bool active = threadIdx.x < pad;
  const int c = active ? order[static_cast<size_t>(group) * pad + threadIdx.x] : 0;
  const int* cp = ptr + static_cast<size_t>(group) * (pad + 1) + c;
  const int beg = active ? cp[0] : 0;
  const int n = active ? cp[1] - beg : 0;

  // Stage this S's entries slot-interleaved (entry j of the warp's lane l
  // at warp_base + 32 j + l), so the lanes' loads of (k, S[k, i]) fall in
  // consecutive words: each warp takes 32 x its longest column.
  const int longest = __reduce_max_sync(0xffffffffu, n);
  if (lane == 0) warp_len[warp] = longest;
  __syncthreads();
  int base = 0, total = 0;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) {
    if (w == warp) base = total;
    total += 32 * warp_len[w];
  }
  if (total > stride) __trap();  // the form's stride must hold every warp's slots
  const size_t at_nz = static_cast<size_t>(group) * stride + beg;
  for (int j = 0; j < n; ++j) {
    sV[base + 32 * j + lane] = val[at_nz + j];
    sI[base + 32 * j + lane] = idx[at_nz + j];
  }
  __syncwarp();
  order_for_banks(sI + base, sV + base, n, longest, lane);
  const float* myV = sV + base + lane;
  const short* myI = sI + base + lane;

  float f[R], g[R], ha[R], m[R];
  float p[R], q[R], u[R], v[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const bool ok = active && row0 + r < ndom;
    const size_t i = static_cast<size_t>(row0 + r) * pad + c;
    f[r] = ok ? F[i] : 0.f;
    g[r] = ok ? G[i] : 0.f;
    ha[r] = ok ? Ha[i] : 0.f;
    m[r] = ok ? mi[i] : 0.f;
    u[r] = 0.f;
    v[r] = 0.f;
  }
  const float half_dt = 0.5f * dt;
  const int buffer = 2 * R * pad;  // floats per [p ; p_half] buffer
  int cur = 0;                     // the buffer this step reads

  for (int it = 0; it < wh_maxit; ++it) {
    float* Pw = sP + cur * buffer;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      p[r] = u[r];
      q[r] = v[r];
      u[r] = K0 * u[r];
      v[r] = K0 * v[r];
      if (active) {
        Pw[r * pad + c] = p[r];
        Pw[(R + r) * pad + c] = p[r] - half_dt * q[r];
      }
    }
    __syncthreads();  // rows and S visible; every read of the last step is done

    for (int t = 0; t < nt; ++t) {
      const float* P = sP + cur * buffer;
      float zp[R], zh[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        zp[r] = 0.f;
        zh[r] = 0.f;
      }
      for (int j = 0; j < n; ++j) {
        const int k = myI[32 * j];
        const float s = myV[32 * j];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          zp[r] = fmaf(P[r * pad + k], s, zp[r]);
          zh[r] = fmaf(P[(R + r) * pad + k], s, zh[r]);
        }
      }

      const float* row = tables + 5 * t;
      const float cs0 = __ldg(row + 0), sn0 = __ldg(row + 1);
      const float cs1 = __ldg(row + 2), sn1 = __ldg(row + 3);
      const float kt = __ldg(row + 4);
      cur ^= 1;
      float* Pn = sP + cur * buffer;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float dq = (zp[r] - ha[r] * q[r] + cs0 * f[r] + sn0 * g[r]) * m[r];
        const float q_half = q[r] + half_dt * dq;
        const float p2 = p[r] - dt * q_half;
        const float dq2 = (zh[r] - ha[r] * q_half + cs1 * f[r] + sn1 * g[r]) * m[r];
        const float q2 = q[r] + dt * dq2;
        p[r] = p2;
        q[r] = q2;
        u[r] += kt * p2;
        v[r] += kt * q2;
        if (active) {
          Pn[r * pad + c] = p2;
          Pn[(R + r) * pad + c] = p2 - half_dt * q2;
        }
      }
      // the new rows are visible, and every read of the buffer the next
      // step writes is done
      __syncthreads();
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (active && row0 + r < ndom) {
      const size_t i = static_cast<size_t>(row0 + r) * pad + c;
      u_out[i] = u[r];
      v_out[i] = v[r];
    }
  }
}

}  // namespace

extern "C" {

int wave_cycle_sparse_rows_per_block() { return kRows; }

int wave_cycle_sparse_max_pad() { return kMaxThreads; }

// Dynamic shared memory one block of `rows` rows (kRows or 1) needs: the
// two [p ; p_half] buffers and one S's values and row indices.
long long wave_cycle_sparse_shared_memory_bytes(int rows, int pad, int stride) {
  return 4LL * 4 * rows * pad + 6LL * stride;
}

const char* wave_cycle_sparse_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

namespace {

template <int R>
cudaError_t set_shared_memory(int pad, int stride, long long* smem) {
  *smem = wave_cycle_sparse_shared_memory_bytes(R, pad, stride);
  return cudaFuncSetAttribute(wave_cycle_sparse_kernel<R>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*smem));
}

template <int R>
int launch(const int* ptr, const short* idx, const float* val, const short* order, int stride,
           const float* F, const float* G, const float* Ha, const float* mi,
           const float* tables, float* u, float* v, int ndom, int pad, int nt, int wh_maxit,
           int s_group_size, float dt, float K0, int device, void* stream) {
  if (pad < 1 || pad > kMaxThreads || stride < 1 || (s_group_size % R) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long smem = 0;
  err = set_shared_memory<R>(pad, stride, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (ndom + R - 1) / R;
  const int threads = (pad + 31) / 32 * 32;
  wave_cycle_sparse_kernel<R><<<blocks, threads, static_cast<size_t>(smem),
                                static_cast<cudaStream_t>(stream)>>>(
      ptr, idx, val, order, stride, F, G, Ha, mi, tables, u, v, ndom, pad, nt, wh_maxit,
      s_group_size, dt, K0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch one cycle on `stream`.  All pointers are device arrays, contiguous:
// the sparse form ptr int32 (ngroups, pad + 1), idx int16 and val float32
// (ngroups, stride), order int16 (ngroups, pad), stride at least every
// group's staged length (32 x the sum over its warps of the warp's longest
// column; a block traps otherwise), with ngroups = 1 for
// s_group_size = 0, else ndom / s_group_size and s_group_size a multiple of
// kRows (the wrapper checks both); F, G, Ha, mi, u, v float32 (ndom, pad);
// tables float32 (nt, 5).  Returns a cudaError_t; 0 means the launch was
// accepted.
int wave_cycle_sparse_launch(const int* ptr, const short* idx, const float* val,
                             const short* order, int stride, const float* F, const float* G,
                             const float* Ha, const float* mi, const float* tables, float* u,
                             float* v, int ndom, int pad, int nt, int wh_maxit, int s_group_size,
                             float dt, float K0, int device, void* stream) {
  return launch<kRows>(ptr, idx, val, order, stride, F, G, Ha, mi, tables, u, v, ndom, pad, nt,
                       wh_maxit, s_group_size, dt, K0, device, stream);
}

// Layout (c): as wave_cycle_sparse_launch with one S per row (ngroups =
// ndom, row r against group r), one row per block.
int wave_cycle_sparse_per_row_launch(const int* ptr, const short* idx, const float* val,
                                     const short* order, int stride, const float* F,
                                     const float* G, const float* Ha, const float* mi,
                                     const float* tables, float* u, float* v, int ndom, int pad,
                                     int nt, int wh_maxit, float dt, float K0, int device,
                                     void* stream) {
  return launch<1>(ptr, idx, val, order, stride, F, G, Ha, mi, tables, u, v, ndom, pad, nt,
                   wh_maxit, 1, dt, K0, device, stream);
}

// Blocks of `rows` rows (kRows or 1) that fit on one SM of `device` at this
// pad and stride (registers, threads and shared memory), or -1 on error.
int wave_cycle_sparse_blocks_per_sm(int rows, int pad, int stride, int device) {
  if ((rows != kRows && rows != 1) || pad < 1 || pad > kMaxThreads || stride < 1) return -1;
  if (cudaSetDevice(device) != cudaSuccess) return -1;
  long long smem = 0;
  int blocks = 0;
  const int threads = (pad + 31) / 32 * 32;
  cudaError_t err;
  if (rows == 1) {
    err = set_shared_memory<1>(pad, stride, &smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, wave_cycle_sparse_kernel<1>,
                                                          threads, static_cast<size_t>(smem));
  } else {
    err = set_shared_memory<kRows>(pad, stride, &smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, wave_cycle_sparse_kernel<kRows>, threads, static_cast<size_t>(smem));
  }
  return err == cudaSuccess ? blocks : -1;
}

// Registers a thread of the instance of `rows` rows (kRows or 1), or -1.
int wave_cycle_sparse_registers(int rows, int device) {
  if ((rows != kRows && rows != 1) || cudaSetDevice(device) != cudaSuccess) return -1;
  cudaFuncAttributes attr;
  const cudaError_t err = rows == 1
                              ? cudaFuncGetAttributes(&attr, wave_cycle_sparse_kernel<1>)
                              : cudaFuncGetAttributes(&attr, wave_cycle_sparse_kernel<kRows>);
  return err == cudaSuccess ? attr.numRegs : -1;
}

}  // extern "C"
