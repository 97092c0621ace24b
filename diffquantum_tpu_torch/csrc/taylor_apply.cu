// K7 on Hopper (sm_90a): the truncated-Taylor apply exp(z H) psi of the
// dense propagator for a batch of states, and its exact reverse-mode
// adjoint (the cotangents of psi and of H).
//
// Replaces the TPU kernel of diffquantum_tpu/ops/pallas_kernels.py:
//   K7 _taylor_apply_kernel (pallas_kernels.py:40, pallas_call :109),
//   behind taylor_apply_fused (:86).
// The JAX package's dense 'apply' backend computes the same recurrence in
// XLA (ops/expm.py:137 cexpm_apply_taylor); the port's 'apply' backend
// launches this kernel once per time step. The Python wrapper and the
// plain PyTorch versions are diffquantum_tpu_torch/ops/taylor_apply.py.
//
// What it computes. H [d, d] and psi [B, d] as f32 re/im planes, d <= 1024,
// w = z / substeps. Per substep, with t_0 = x:
//   t_k = (w / k) H t_{k-1},  x <- t_0 + t_1 + ... + t_order,
// substeps times, in IEEE fp32. The backward takes the cotangent g of the
// output (real planes; as a complex vector g = g_re + i g_im) and returns
//   gpsi = p(A)^dagger ... applied substep by substep, and
//   gH   = sum over substeps and terms of conj(w/k) gbar_k t_{k-1}^dagger,
// where gbar_order = lambda, gbar_{k-1} = lambda + conj(w/k) H^dagger gbar_k,
// lambda the cotangent of the substep's output and gbar_0 that of its
// input. This is the real-plane convention dL = Re sum conj(G) dX: the
// re/im planes of G are the gradients of the re/im planes of X.
//
// What bounds it on this card. Each launch does 8 B d^2 fp32 operations
// per term, order x substeps terms (at the 10-qubit dense MaxCut step,
// d = 1024, order 8, 8 substeps: 64 terms, ~537 MFLOP per state, ~8 us at
// 67 TFLOP/s) and must move H once (8 MB at d = 1024) plus psi in and
// out: bound by operations. The terms form one dependent chain: every
// term needs the whole previous term.
//
// What the design does about it. The work of a term is split by rows of H
// over a cooperative grid: one block of 8 warps per 8 rows (128 blocks at
// d = 1024, one per SM), each warp one row. A block loads its row slice of
// H into shared memory once per launch (64 KB at d = 1024), so H is read
// from device memory once per step. The terms are [B, d] vectors in global
// memory (L2-resident at these sizes), read through shared-memory tiles of
// 8 states and bypassing L1 (__ldcg: another SM wrote them); each warp
// reduces its row's dot products with shuffles, and lane t of the warp
// owns state t of the tile, so each output element has one owner thread
// for the whole launch and the running sum x stays in the output buffer
// without races. A grid-wide barrier (an atomic arrival counter and a
// generation word, valid because the cooperative launch makes every block
// co-resident) separates the terms: order x substeps barriers a launch.
// The backward keeps its row slices of H and of H^dagger (the conjugated
// columns) in shared memory (128 KB at d = 1024) and its row slice of gH
// in registers (32 complex values a lane), first recomputes and stores
// every term of the launch in global scratch [substeps, order, B, d], then
// runs the reverse recurrence above, adding its rows of gH with no atomics
// and writing them once. Small d (2, 4, 16 in the control paths) runs on
// one block. The TPU kernel's Gauss three-product form was a choice for
// the MXU and is not carried over. Fewer barriers (several terms per
// block at small d, clusters) and tensor-core products are left for later
// work.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps;   // rows of H per block, one per warp
constexpr int kTile = 8;        // states per shared-memory tile
constexpr int kMaxD = 1024;
constexpr int kChunks = kMaxD / 32;  // columns j = lane + 32 m a lane owns

// Grid-wide barrier: bar[0] counts arrivals, bar[1] is the generation.
// Both start at 0 (the wrapper zeroes them) and bar[0] returns to 0 after
// every barrier. Valid only when every block is resident (cooperative
// launch).
__device__ void grid_sync(unsigned int* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* gen = bar + 1;
    const unsigned int g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

// Rows row0 .. row0 + kRows - 1 of H (or of H^dagger: conjugated columns)
// into shared memory; rows past d are zero.
__device__ void load_rows(float* sr, float* si, const float* h_re,
                          const float* h_im, int row0, int d, bool dagger) {
  for (int idx = threadIdx.x; idx < kRows * d; idx += kThreads) {
    if (dagger) {
      const int j = idx / kRows, r = idx % kRows, i = row0 + r;
      const bool in = i < d;
      sr[r * d + j] = in ? h_re[(size_t)j * d + i] : 0.f;
      si[r * d + j] = in ? -h_im[(size_t)j * d + i] : 0.f;
    } else {
      const int r = idx / d, j = idx % d, i = row0 + r;
      const bool in = i < d;
      sr[idx] = in ? h_re[(size_t)i * d + j] : 0.f;
      si[idx] = in ? h_im[(size_t)i * d + j] : 0.f;
    }
  }
}

// Loads states b0 .. b0 + nb - 1 of a [B, d] vector pair into the tile.
__device__ void load_tile(float* tr, float* ti, const float* src_re,
                          const float* src_im, int b0, int nb, int d) {
  __syncthreads();  // the previous tile is consumed
  const size_t off = (size_t)b0 * d;
  for (int idx = threadIdx.x; idx < nb * d; idx += kThreads) {
    tr[idx] = __ldcg(src_re + off + idx);
    ti[idx] = __ldcg(src_im + off + idx);
  }
  __syncthreads();
}

// y[b, row] = sum_j M[row, j] src[b, j] for this warp's row and every
// state b; calls emit(b, y_re, y_im) once per (b, row), from lane b % kTile.
template <class Emit>
__device__ __forceinline__ void row_products(
    const float* mr, const float* mi, const float* src_re,
    const float* src_im, float* tr, float* ti, int d, int B, int row,
    Emit emit) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int b0 = 0; b0 < B; b0 += kTile) {
    const int nb = min(kTile, B - b0);
    load_tile(tr, ti, src_re, src_im, b0, nb, d);
    if (row >= d) continue;
    float ar[kTile], ai[kTile];
#pragma unroll
    for (int t = 0; t < kTile; ++t) ar[t] = ai[t] = 0.f;
    for (int j = lane; j < d; j += 32) {
      const float hr = mr[warp * d + j], hi = mi[warp * d + j];
#pragma unroll
      for (int t = 0; t < kTile; ++t) {
        if (t < nb) {
          const float xr = tr[t * d + j], xi = ti[t * d + j];
          ar[t] = fmaf(hr, xr, fmaf(-hi, xi, ar[t]));
          ai[t] = fmaf(hr, xi, fmaf(hi, xr, ai[t]));
        }
      }
    }
#pragma unroll
    for (int t = 0; t < kTile; ++t) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        ar[t] += __shfl_xor_sync(0xffffffffu, ar[t], off);
        ai[t] += __shfl_xor_sync(0xffffffffu, ai[t], off);
      }
    }
#pragma unroll
    for (int t = 0; t < kTile; ++t)
      if (lane == t && t < nb) emit(b0 + t, ar[t], ai[t]);
  }
}

__device__ __forceinline__ int other_buffer(int a, int b) {
  for (int c = 0; c < 3; ++c)
    if (c != a && c != b) return c;
  return 0;
}

// Forward. buf: scratch [2 buffers][2 planes][B][d] for the published
// terms; out holds the running sum x (each element owned by one thread).
__global__ void __launch_bounds__(kThreads, 1) taylor_forward(
    const float* h_re, const float* h_im, const float* p_re,
    const float* p_im, const float* zs, float* o_re, float* o_im,
    float* buf, unsigned int* bar, int d, int B, int order, int substeps) {
  extern __shared__ float smem[];
  float* hr = smem;
  float* hi = hr + kRows * d;
  float* tr = hi + kRows * d;
  float* ti = tr + kTile * d;
  const int row0 = blockIdx.x * kRows;
  const int row = row0 + (threadIdx.x >> 5);
  load_rows(hr, hi, h_re, h_im, row0, d, false);
  const float wr = zs[0], wi = zs[1];
  const size_t plane = (size_t)B * d;
  const float* s_re = p_re;
  const float* s_im = p_im;
  int s_idx = -1;
  for (int s = 0; s < substeps; ++s) {
    for (int k = 1; k <= order; ++k) {
      const bool last = k == order;
      const bool done = last && s == substeps - 1;
      const bool first = s == 0 && k == 1;
      const int d_idx = other_buffer(s_idx, 2);
      float* d_re = buf + (size_t)d_idx * 2 * plane;
      float* d_im = d_re + plane;
      const float cr = wr / (float)k, ci = wi / (float)k;
      row_products(hr, hi, s_re, s_im, tr, ti, d, B, row,
                   [&](int b, float yr, float yi) {
        const size_t o = (size_t)b * d + row;
        const float t_re = cr * yr - ci * yi, t_im = cr * yi + ci * yr;
        const float a_re = (first ? p_re[o] : o_re[o]) + t_re;
        const float a_im = (first ? p_im[o] : o_im[o]) + t_im;
        o_re[o] = a_re;
        o_im[o] = a_im;
        if (!done) {
          __stcg(d_re + o, last ? a_re : t_re);
          __stcg(d_im + o, last ? a_im : t_im);
        }
      });
      if (!done) {
        grid_sync(bar);
        s_re = d_re;
        s_im = d_im;
        s_idx = d_idx;
      }
    }
  }
}

// Backward. terms: scratch [substeps][order][2][B][d] (slot (s, 0) holds
// the substep's input x_s, psi for s = 0 is read from p); gbuf: scratch
// [3][2][B][d] for gbar and lambda; gp doubles as the forward's running
// sum until the reverse pass writes it.
__global__ void __launch_bounds__(kThreads, 1) taylor_backward(
    const float* h_re, const float* h_im, const float* p_re,
    const float* p_im, const float* g_re, const float* g_im,
    const float* zs, float* gh_re, float* gh_im, float* gp_re,
    float* gp_im, float* terms, float* gbuf, unsigned int* bar, int d,
    int B, int order, int substeps) {
  extern __shared__ float smem[];
  float* hr = smem;
  float* hi = hr + kRows * d;
  float* dr = hi + kRows * d;
  float* di = dr + kRows * d;
  float* tr = di + kRows * d;
  float* ti = tr + kTile * d;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kRows;
  const int row = row0 + warp;
  load_rows(hr, hi, h_re, h_im, row0, d, false);
  load_rows(dr, di, h_re, h_im, row0, d, true);
  const float wr = zs[0], wi = zs[1];
  const size_t plane = (size_t)B * d;
  auto slot = [&](int s, int k) {
    return terms + ((size_t)s * order + k) * 2 * plane;
  };
  auto term_re = [&](int s, int k) -> const float* {
    return (s == 0 && k == 0) ? p_re : slot(s, k);
  };
  auto term_im = [&](int s, int k) -> const float* {
    return (s == 0 && k == 0) ? p_im : slot(s, k) + plane;
  };

  // 1. the forward again, storing every term t_{s,k}, k < order, and
  //    every substep input x_s
  for (int s = 0; s < substeps; ++s) {
    const int kmax = s == substeps - 1 ? order - 1 : order;
    for (int k = 1; k <= kmax; ++k) {
      const bool last = k == order;
      const bool first = s == 0 && k == 1;
      float* t_re = last ? slot(s + 1, 0) : slot(s, k);
      float* t_im = t_re + plane;
      const float cr = wr / (float)k, ci = wi / (float)k;
      row_products(hr, hi, term_re(s, k - 1), term_im(s, k - 1), tr, ti, d,
                   B, row, [&](int b, float yr, float yi) {
        const size_t o = (size_t)b * d + row;
        const float y_re = cr * yr - ci * yi, y_im = cr * yi + ci * yr;
        const float a_re = (first ? p_re[o] : gp_re[o]) + y_re;
        const float a_im = (first ? p_im[o] : gp_im[o]) + y_im;
        gp_re[o] = a_re;
        gp_im[o] = a_im;
        __stcg(t_re + o, last ? a_re : y_re);
        __stcg(t_im + o, last ? a_im : y_im);
      });
      grid_sync(bar);
    }
  }

  // 2. the reverse recurrence, substep by substep from the last
  float ghr[kChunks], ghi[kChunks];
#pragma unroll
  for (int m = 0; m < kChunks; ++m) ghr[m] = ghi[m] = 0.f;
  const float* l_re = g_re;
  const float* l_im = g_im;
  int l_idx = -1;
  for (int s = substeps - 1; s >= 0; --s) {
    const float* s_re = l_re;  // gbar_order = lambda
    const float* s_im = l_im;
    int s_idx = l_idx;
    for (int k = order; k >= 1; --k) {
      const float cr = wr / (float)k, ci = -wi / (float)k;  // conj(w / k)
      // gH[row, j] += conj(w/k) sum_b gbar_k[b, row] conj(t_{k-1}[b, j])
      const float* p_re_k = term_re(s, k - 1);
      const float* p_im_k = term_im(s, k - 1);
      for (int b0 = 0; b0 < B; b0 += kTile) {
        const int nb = min(kTile, B - b0);
        load_tile(tr, ti, p_re_k, p_im_k, b0, nb, d);
        if (row >= d) continue;
        for (int t = 0; t < nb; ++t) {
          const size_t o = (size_t)(b0 + t) * d + row;
          const float gr = __ldcg(s_re + o), gi = __ldcg(s_im + o);
          const float qr = cr * gr - ci * gi, qi = cr * gi + ci * gr;
#pragma unroll
          for (int m = 0; m < kChunks; ++m) {
            const int j = lane + 32 * m;
            if (j < d) {
              const float xr = tr[t * d + j], xi = ti[t * d + j];
              ghr[m] = fmaf(qr, xr, fmaf(qi, xi, ghr[m]));
              ghi[m] = fmaf(qi, xr, fmaf(-qr, xi, ghi[m]));
            }
          }
        }
      }
      // gbar_{k-1} = lambda + conj(w/k) H^dagger gbar_k
      const bool fin = s == 0 && k == 1;
      const int d_idx = other_buffer(s_idx, l_idx);
      float* d_re = gbuf + (size_t)d_idx * 2 * plane;
      float* d_im = d_re + plane;
      row_products(dr, di, s_re, s_im, tr, ti, d, B, row,
                   [&](int b, float yr, float yi) {
        const size_t o = (size_t)b * d + row;
        const float v_re = __ldcg(l_re + o) + cr * yr - ci * yi;
        const float v_im = __ldcg(l_im + o) + cr * yi + ci * yr;
        if (fin) {
          gp_re[o] = v_re;
          gp_im[o] = v_im;
        } else {
          __stcg(d_re + o, v_re);
          __stcg(d_im + o, v_im);
        }
      });
      if (!fin) {
        grid_sync(bar);
        s_re = d_re;
        s_im = d_im;
        s_idx = d_idx;
      }
    }
    l_re = s_re;  // gbar_0: the cotangent of this substep's input
    l_im = s_im;
    l_idx = s_idx;
  }
  if (row < d) {
#pragma unroll
    for (int m = 0; m < kChunks; ++m) {
      const int j = lane + 32 * m;
      if (j < d) {
        gh_re[(size_t)row * d + j] = ghr[m];
        gh_im[(size_t)row * d + j] = ghi[m];
      }
    }
  }
}

bool bad_shape(int d, int B, int order, int substeps) {
  return d < 1 || d > kMaxD || B < 1 || order < 1 || substeps < 1;
}

int launch_cooperative(const void* fn, int d, size_t smem, void** args,
                       cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = (d + kRows - 1) / kRows;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                    smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm * sms < grid) return (int)cudaErrorCooperativeLaunchTooLarge;
  e = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(kThreads), args,
                                  smem, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// H [d, d], psi [B, d] (f32 planes), zs = (z_re, z_im) / substeps on the
// device; writes out [B, d]. buf: [2][2][B][d] floats; bar: 2 zeroed
// uints.
int dq_k7_forward(const float* h_re, const float* h_im, const float* p_re,
                  const float* p_im, const float* zs, float* o_re,
                  float* o_im, float* buf, unsigned int* bar, int d, int B,
                  int order, int substeps, void* stream) {
  if (bad_shape(d, B, order, substeps)) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(2 * kRows + 2 * kTile) * d * sizeof(float);
  void* args[] = {&h_re, &h_im, &p_re, &p_im, &zs, &o_re, &o_im,
                  &buf, &bar, &d, &B, &order, &substeps};
  return launch_cooperative((const void*)taylor_forward, d, smem, args,
                            static_cast<cudaStream_t>(stream));
}

// From the step's input psi and the output's cotangent g, writes gh
// [d, d] and gp [B, d]. terms: [substeps][order][2][B][d] floats; gbuf:
// [3][2][B][d] floats; bar: 2 zeroed uints.
int dq_k7_backward(const float* h_re, const float* h_im, const float* p_re,
                   const float* p_im, const float* g_re, const float* g_im,
                   const float* zs, float* gh_re, float* gh_im, float* gp_re,
                   float* gp_im, float* terms, float* gbuf,
                   unsigned int* bar, int d, int B, int order, int substeps,
                   void* stream) {
  if (bad_shape(d, B, order, substeps)) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(4 * kRows + 2 * kTile) * d * sizeof(float);
  void* args[] = {&h_re, &h_im, &p_re, &p_im, &g_re, &g_im, &zs,
                  &gh_re, &gh_im, &gp_re, &gp_im, &terms, &gbuf, &bar,
                  &d, &B, &order, &substeps};
  return launch_cooperative((const void*)taylor_backward, d, smem, args,
                            static_cast<cudaStream_t>(stream));
}

const char* dq_k7_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
