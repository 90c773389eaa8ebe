// WaveHoltz cycle of the DDH preconditioner with the subdomain stiffness
// applied from its element factors, line by line, for NVIDIA Hopper
// (sm_90a).
//
// Replaces cuddhelmholtz_tpu/ops/pallas/wave_cycle.py::_wave_kernel (launched
// by wave_cycle_pallas) in its stiffness layouts (a) shared (s_group_size =
// 0: one set of factors for every subdomain row) and (b) grouped (one set
// per run of s_group_size rows, a multiple of the block's rows).  It
// computes what csrc/wave_cycle_sparse.cu computes: wh_maxit WaveHoltz
// fixed-point iterations, each restarting from (p, q) = (u, v) and (u, v) =
// K0 (u, v), of nt staggered-leapfrog steps
//
//     [zp ; zh] = [p ; p - dt/2 q] @ S
//     dq  = (zp - Ha q + cs0 F + sn0 G) mi,   q_half = q + dt/2 dq
//     p2  = p - dt q_half
//     dq2 = (zh - Ha q_half + cs1 F + sn1 G) mi,   q2 = q + dt dq2
//     u  += K_t p2,   v += K_t q2
//
// with (cs0, sn0, cs1, sn1, K_t) the step's row of `tables`, in one launch,
// the state never going back to device memory, in plain fp32 FFMA.
//
// S is never formed.  Upstream's stiffness<NB> device function
// (source/DDH.cpp:60-109, called by ddh_action) applies each element's
// stiffness from the 1-D derivative matrix D and the element's collocated
// geometric factors A, B, C: with ux = d/dxi and uy = d/deta of the
// element's nodal values,
//
//     out[l][k] = sum_q D[q][k] (A ux + B uy)[l][q] + sum_q D[q][l] (B ux + C uy)[q][k].
//
// On axis-aligned rectangles B = 0, and the element operator is a sum of
// line operators: D^T diag(A[l][:]) D along each of its nb rows and
// D^T diag(C[:][k]) D along each of its columns.  Those of one grid line
// add up: where two elements share an edge their rows (or columns) on it
// are one line of nodes, and consecutive elements' segments of a grid line
// meet at one node.  The form (ops/cuda/wave_cycle.py::factored_form)
// builds, from D and the factors, each grid line of a subdomain as L
// segments of nb nodes with the summed symmetric nb x nb matrix of each
// (10 floats at nb = 4), x lines first, then y lines.  Every node lies on
// one x line and one y line, so S p is the x-line products plus the y-line
// products, each written once a node: no sum over elements, no atomics, a
// fixed order (repeats are bitwise).  A line of L segments costs L nb^2
// FMAs, and the lines together the non-zeros of S.
//
// What bounds it on this card: shared memory and the instructions around
// it.  The sparse kernel reads one float of p from shared memory per FMA,
// and (k, S[k, i]) besides: 5/4 four-byte reads per FMA against an SM's
// one 32-lane wavefront a clock (four warp FMA instructions a clock), a
// quarter of the FFMA rate at best.  Here a line's 3L + 1 values of p are
// read once and used by up to 2 nb FMAs each, its matrices stay in
// registers, and each node's two products are written once and read back
// once: per row and step about 3 reads and 3 writes a node, against 5/2
// reads per non-zero.  What is left is those accesses' wavefronts, the
// two barriers of a step, and at few rows an SM their latency.
//
// Design:
//   * a block owns R rows (the most of 8, 4, 2, 1 whose 2 R nlines line
//     items fit its kThreads threads and whose R rs positions they hold,
//     pairs_for(L) each; rows_for) that share one set of lines, and keeps
//     their stacked [p ; p_half] rows in shared memory (R rs floats each,
//     one buffer: each step's reads of p end at a barrier before any
//     thread writes it again) and two planes of line products (x lines,
//     y lines) for each;
//   * phase 1 of a step: thread i < 2 R nlines takes line i % nlines of
//     row (i / nlines) % R in vector i / (nlines R) (p or p_half), reads
//     its 3L + 1 values, applies its segments (the node two segments share
//     adds the first's product, then the second's) and writes each node's
//     product into the line's plane;
//   * phase 2, after a barrier: thread t updates the positions (row r,
//     position s) = divmod(t + kThreads m, rs), m < pairs_for(L), whose
//     slot state (q, u, v, F, G, Ha, mi, p) stays in its registers: x plane
//     plus y plane, the leapfrog update, p and p_half written back;
//   * positions, not slots, index the rows in shared memory: the form
//     places each slot at a position chosen so that the 32 lanes of a
//     phase-1 warp reading or writing one node of their lines fall in
//     distinct banks where they can, and consecutive positions are
//     consecutive words, so phase 2's reads and writes are conflict-free;
//   * registers: a line's 10 L matrix floats, its 3L + 1 positions and
//     values, the state of its pairs: at L = 4 the 128 that four blocks an
//     SM allow (16 warps; ptxas spills 16 bytes), at L = 8 255 (two
//     blocks); the flagship's 1,024 rows are 512 blocks of 2 rows;
//   * plain fp32 FFMA: no TF32 and no split passes.

#include <cuda_runtime.h>

namespace {

constexpr int kNb = 4;        // nodes of a segment: degree 3
constexpr int kSym = 10;      // entries of a symmetric kNb x kNb matrix
constexpr int kThreads = 128;  // threads a block

// (row, position) pairs a thread updates for lines of L segments
__host__ __device__ constexpr int pairs_for(int L) { return L <= 4 ? 3 : 5; }

// Registers a thread may use: the blocks of an SM that its pairs need
__host__ __device__ constexpr int blocks_for(int L) { return L <= 4 ? 4 : 2; }

// Rows a block owns for `nlines` lines of L segments a row and a row stride
// of `rs` positions: the most of 8, 4, 2, 1 whose 2 R nlines line items fit
// the block's threads and whose R rs positions they hold; 0 when none does.
__host__ __device__ constexpr int rows_for(int nlines, int rs, int L) {
  for (int r = 8; r >= 1; r /= 2)
    if (2 * r * nlines <= kThreads && r * rs <= pairs_for(L) * kThreads) return r;
  return 0;
}

// entry (a, b) of a symmetric kNb x kNb matrix stored as its upper triangle
__host__ __device__ constexpr int sym(int a, int b) {
  return a <= b ? a * kNb - a * (a - 1) / 2 + (b - a) : b * kNb - b * (b - 1) / 2 + (a - b);
}

template <int R, int L>
__global__ void __launch_bounds__(kThreads, blocks_for(L))
wave_cycle_kernel_factored(const float* __restrict__ mats, const short* __restrict__ lines,
                           const short* __restrict__ order, int nlines, int nlx, int rs,
                           const float* __restrict__ F, const float* __restrict__ G,
                           const float* __restrict__ Ha, const float* __restrict__ mi,
                           const float* __restrict__ tables, float* __restrict__ u_out,
                           float* __restrict__ v_out, int ndom, int pad, int nt, int wh_maxit,
                           int s_group_size, float dt, float K0) {
  constexpr int kNodes = 3 * L + 1;    // nodes of a line
  constexpr int kPairs = pairs_for(L);
  extern __shared__ float smem[];
  const int vec = R * rs;  // floats between the p and p_half rows
  float* sP = smem;        // [2][R][rs]: p rows, then p_half rows
  float* sZ = smem + 2 * vec;  // [2 planes: x, y][2][R][rs]: line products
  const int row0 = blockIdx.x * R;
  const int group = s_group_size > 0 ? row0 / s_group_size : 0;
  const int tid = threadIdx.x;

  // positions no line writes read 0 in both planes
  for (int i = tid; i < 4 * vec; i += kThreads) sZ[i] = 0.f;

  // ---- phase-1 item: line ln of row lr in vector lv; its matrices
  const int ln = tid % nlines, lr = (tid / nlines) % R, lv = tid / (nlines * R);
  const bool live = lv < 2;
  float km[L][kSym];
  int at[kNodes];  // the line's node positions
  {
    const size_t line = static_cast<size_t>(group) * nlines + (live ? ln : 0);
#pragma unroll
    for (int s = 0; s < L; ++s)
#pragma unroll
      for (int j = 0; j < kSym; ++j) km[s][j] = live ? mats[(line * L + s) * kSym + j] : 0.f;
#pragma unroll
    for (int n = 0; n < kNodes; ++n) at[n] = live ? lines[line * kNodes + n] : 0;
  }
  const float* Pin = sP + (lv * R + lr) * rs;
  float* Zout = sZ + (((ln >= nlx) * 2 + lv) * R + lr) * rs;

  // ---- phase-2 pairs: pair tid + kThreads j is (row, position) = divmod(., rs)
  const int npairs = R * rs;
  float f[kPairs], g[kPairs], ha[kPairs], m[kPairs];
  float p[kPairs], q[kPairs], u[kPairs], v[kPairs];
#pragma unroll
  for (int j = 0; j < kPairs; ++j) {
    const int pair = tid + kThreads * j;
    const int r = pair / rs, s = pair - r * rs;
    const int c = pair < npairs ? order[static_cast<size_t>(group) * rs + s] : -1;
    const bool ok = c >= 0 && row0 + r < ndom;
    const size_t i = static_cast<size_t>(row0 + r) * pad + c;
    f[j] = ok ? F[i] : 0.f;
    g[j] = ok ? G[i] : 0.f;
    ha[j] = ok ? Ha[i] : 0.f;
    m[j] = ok ? mi[i] : 0.f;
    u[j] = 0.f;
    v[j] = 0.f;
  }
  const float half_dt = 0.5f * dt;

  for (int it = 0; it < wh_maxit; ++it) {
#pragma unroll
    for (int j = 0; j < kPairs; ++j) {
      p[j] = u[j];
      q[j] = v[j];
      u[j] = K0 * u[j];
      v[j] = K0 * v[j];
      const int o = tid + kThreads * j;
      if (o < npairs) {
        sP[o] = p[j];
        sP[vec + o] = p[j] - half_dt * q[j];
      }
    }
    __syncthreads();  // the rows (and the zeroed planes) are visible

    for (int t = 0; t < nt; ++t) {
      const float* row = tables + 5 * t;  // read ahead of the barrier below
      const float cs0 = __ldg(row + 0), sn0 = __ldg(row + 1);
      const float cs1 = __ldg(row + 2), sn1 = __ldg(row + 3);
      const float kt = __ldg(row + 4);

      // phase 1: each line's products into its plane
      if (live) {
        float x[kNodes];
#pragma unroll
        for (int n = 0; n < kNodes; ++n) x[n] = Pin[at[n]];
        float o = 0.f;  // the product at the node a segment shares with the last
#pragma unroll
        for (int s = 0; s < L; ++s) {
#pragma unroll
          for (int a = 0; a < kNb; ++a) {
            float z = a == 0 ? o : 0.f;
#pragma unroll
            for (int b = 0; b < kNb; ++b) z = fmaf(km[s][sym(a, b)], x[3 * s + b], z);
            if (a < kNb - 1) {
              Zout[at[3 * s + a]] = z;
            } else {
              o = z;
            }
          }
        }
        Zout[at[3 * L]] = o;
      }
      __syncthreads();  // every product is written, every read of p is done

      // phase 2: x plane plus y plane (every pair's reads first, so that
      // they are in flight together), then the step
      float zp[kPairs], zh[kPairs];
#pragma unroll
      for (int j = 0; j < kPairs; ++j) {
        const int o = min(tid + kThreads * j, npairs - 1);
        zp[j] = sZ[o] + sZ[2 * vec + o];
        zh[j] = sZ[vec + o] + sZ[3 * vec + o];
      }
#pragma unroll
      for (int j = 0; j < kPairs; ++j) {
        const float dq = (zp[j] - ha[j] * q[j] + cs0 * f[j] + sn0 * g[j]) * m[j];
        const float q_half = q[j] + half_dt * dq;
        const float p2 = p[j] - dt * q_half;
        const float dq2 = (zh[j] - ha[j] * q_half + cs1 * f[j] + sn1 * g[j]) * m[j];
        const float q2 = q[j] + dt * dq2;
        p[j] = p2;
        q[j] = q2;
        u[j] += kt * p2;
        v[j] += kt * q2;
        const int o = tid + kThreads * j;
        if (o < npairs) {
          sP[o] = p2;
          sP[vec + o] = p2 - half_dt * q2;
        }
      }
      __syncthreads();  // the new rows are visible
    }
  }

#pragma unroll
  for (int j = 0; j < kPairs; ++j) {
    const int pair = tid + kThreads * j;
    const int r = pair / rs, s = pair - r * rs;
    const int c = pair < npairs ? order[static_cast<size_t>(group) * rs + s] : -1;
    if (c >= 0 && row0 + r < ndom) {
      const size_t i = static_cast<size_t>(row0 + r) * pad + c;
      u_out[i] = u[j];
      v_out[i] = v[j];
    }
  }
}

long long shared_memory_bytes(int rows, int rs) { return 4LL * 6 * rows * rs; }

// The instance for (rows, L), or nullptr.
const void* kernel_of(int rows, int L) {
#define WC_FACTORED_CASE(R, LL) \
  if (rows == R && L == LL) return reinterpret_cast<const void*>(wave_cycle_kernel_factored<R, LL>)
  WC_FACTORED_CASE(8, 4);
  WC_FACTORED_CASE(4, 4);
  WC_FACTORED_CASE(2, 4);
  WC_FACTORED_CASE(1, 4);
  WC_FACTORED_CASE(8, 8);
  WC_FACTORED_CASE(4, 8);
  WC_FACTORED_CASE(2, 8);
  WC_FACTORED_CASE(1, 8);
#undef WC_FACTORED_CASE
  return nullptr;
}

}  // namespace

extern "C" {

int wave_cycle_factored_rows_per_block(int nlines, int rs, int L) {
  return L == 4 || L == 8 ? rows_for(nlines, rs, L) : 0;
}

int wave_cycle_factored_threads() { return kThreads; }

int wave_cycle_factored_pairs(int L) { return pairs_for(L); }

// Dynamic shared memory one block of `rows` rows needs: its [p ; p_half]
// rows and the two planes of line products for both, rs floats a row each.
long long wave_cycle_factored_shared_memory_bytes(int rows, int rs) {
  return shared_memory_bytes(rows, rs);
}

const char* wave_cycle_factored_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launch one cycle on `stream`.  All pointers are device arrays, contiguous:
// per group, mats float32 (ngroups, nlines, L, 10) (each segment's
// symmetric matrix, upper triangle by rows), lines int16 (ngroups, nlines,
// 3 L + 1) (each line's node positions; its first nlx lines run along x)
// and order int16 (ngroups, rs) (the slot at each position, -1 none), with
// ngroups = 1 for s_group_size = 0, else ndom / s_group_size and
// s_group_size a multiple of the block's rows; L is 4 or 8; F, G, Ha, mi,
// u, v float32 (ndom, pad); tables float32 (nt, 5).  Returns a
// cudaError_t; 0 means the launch was accepted.
int wave_cycle_factored_launch(const float* mats, const short* lines, const short* order,
                               int nlines, int nlx, int L, int rs, const float* F,
                               const float* G, const float* Ha, const float* mi,
                               const float* tables, float* u, float* v, int ndom, int pad, int nt,
                               int wh_maxit, int s_group_size, float dt, float K0, int device,
                               void* stream) {
  const int rows = wave_cycle_factored_rows_per_block(nlines, rs, L);
  const void* kernel = kernel_of(rows, L);
  if (kernel == nullptr || rs < pad || nlx < 0 || nlx > nlines || (s_group_size % rows) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long smem = shared_memory_bytes(rows, rs);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (ndom + rows - 1) / rows;
  void* args[] = {&mats, &lines, &order, &nlines, &nlx, &rs, &F, &G, &Ha, &mi, &tables,
                  &u, &v, &ndom, &pad, &nt, &wh_maxit, &s_group_size, &dt, &K0};
  err = cudaLaunchKernel(kernel, dim3(blocks), dim3(kThreads), args, static_cast<size_t>(smem),
                         static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

// Blocks that fit on one SM of `device` for this form's shape (registers,
// threads and shared memory), or -1 on error.
int wave_cycle_factored_blocks_per_sm(int nlines, int rs, int L, int device) {
  const int rows = wave_cycle_factored_rows_per_block(nlines, rs, L);
  const void* kernel = kernel_of(rows, L);
  if (kernel == nullptr || cudaSetDevice(device) != cudaSuccess) return -1;
  const long long smem = shared_memory_bytes(rows, rs);
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess)
    return -1;
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, kernel, kThreads, static_cast<size_t>(smem));
  return err == cudaSuccess ? blocks : -1;
}

// Registers a thread of the instance of `rows` rows and L segments a line, or -1.
int wave_cycle_factored_registers(int rows, int L, int device) {
  const void* kernel = kernel_of(rows, L);
  if (kernel == nullptr || cudaSetDevice(device) != cudaSuccess) return -1;
  cudaFuncAttributes attr;
  return cudaFuncGetAttributes(&attr, kernel) == cudaSuccess ? attr.numRegs : -1;
}

}  // extern "C"
