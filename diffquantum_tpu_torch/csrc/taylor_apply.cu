// K7 on Hopper (sm_90a): the truncated-Taylor apply exp(z H) psi of the
// dense propagator for a batch of states, and its exact reverse-mode
// adjoint (the cotangents of psi and of H).
//
// Replaces the TPU kernel of diffquantum_tpu/ops/pallas_kernels.py:
//   K7 _taylor_apply_kernel (pallas_kernels.py:40, pallas_call :109),
//   behind taylor_apply_fused (:86).
// The JAX package's dense 'apply' backend computes the same recurrence in
// XLA (ops/expm.py:137 cexpm_apply_taylor); the port's 'apply' backend
// launches this kernel once per time step. The Python wrapper, the launch
// plan (k7_plan) and the plain PyTorch versions are
// diffquantum_tpu_torch/ops/taylor_apply.py.
//
// What it computes. H [d, d] and psi [B, d] as f32 re/im planes, d <= 1024,
// w = z / substeps. Per substep, with t_0 = x:
//   t_k = (w / k) H t_{k-1},  x <- t_0 + t_1 + ... + t_order,
// substeps times, in IEEE fp32 (FFMA on the CUDA cores). The backward takes
// the cotangent g of the output (real planes; as a complex vector
// g = g_re + i g_im) and returns
//   gpsi = p(A)^dagger ... applied substep by substep, and
//   gH   = sum over substeps and terms of conj(w/k) gbar_k t_{k-1}^dagger,
// where gbar_order = lambda, gbar_{k-1} = lambda + conj(w/k) H^dagger gbar_k,
// lambda the cotangent of the substep's output and gbar_0 that of its
// input. This is the real-plane convention dL = Re sum conj(G) dX: the
// re/im planes of G are the gradients of the re/im planes of X. Both
// kernels keep the scaled terms s_k = (w/(k+1)) t_k (and w x for a
// substep's input), so a term is one product t_{k+1} = H s_k, and the
// backward's rank-B update of gH is gbar_k s_{k-1}^dagger with no scale.
//
// What bounds it on this card. A launch does 8 B d^2 fp32 operations per
// term, order x substeps dependent terms (d = 1024, order 8, 8 substeps:
// 64 terms, ~537 MFLOP per state, ~8 us at 67 TFLOP/s) and must move H
// once (8 MB at d = 1024) plus psi in and out: bound by operations. Every
// term needs the whole previous term, so a term is a synchronisation of
// all the threads that hold H.
//
// What the design does about it. Two launch configurations; the wrapper's
// plan (k7_plan) picks one and passes its geometry in, so this file holds
// no heuristic.
// * Block-resident (d <= 64: the control paths' d = 2, 4, 16 and the
//   unaligned d = 48). An ordinary launch; a block takes a group of
//   states and keeps H (padded to an odd row stride: no bank conflicts
//   for rows or columns, so H^dagger is H read the other way), the terms,
//   the running sum and, in the backward, the cotangents and gH in shared
//   memory. Terms are separated by __syncthreads only. The backward keeps
//   every recomputed term in shared memory when they fit (else in global
//   scratch, staged back per term); when several blocks split the states
//   each writes a partial gH and a second launch sums them in block order
//   (deterministic).
// * Row-split (64 < d <= 1024: the 10q step at d = 1024, the 8q seeds at
//   d = 256). A cooperative grid of ceil(d/8) blocks (128 at d = 1024,
//   one per SM), each holding its 8 rows of H (and, backward, of H^dagger)
//   in shared memory for the whole launch, so H is read from device memory
//   once per launch. Register-tiled products: a lane holds 4 rows x ST
//   states of a product over its 4 columns, so one 16-byte read of a term
//   feeds 4 rows and one read of H feeds ST states; the column split is
//   reduced within the warp by shuffles (reduce-scatter) and across warps
//   in shared memory, in a fixed order. The terms ([B, d] vectors in
//   global memory, L2-resident at these sizes) stream through two
//   shared-memory stages by cp.async (L2 only: other SMs wrote them), so
//   the next chunk of states and columns loads while the current one is
//   multiplied; a pass of 1-2 states takes a whole term as one chunk. A
//   grid barrier per term (cooperative_groups' grid sync, measured the
//   fastest of three, below), with no barrier word of its own. The
//   backward recomputes and stores every term of the launch in global
//   scratch, then runs the reverse recurrence: a product with H^dagger
//   and the rank-B update of the block's rows of gH (kept in registers),
//   whose cotangent rows are staged in shared memory with the term chunk;
//   the update needs no other block's rows, so it runs between the grid
//   barrier's arrival and its wait.
// What still bounds it (PERF.md, K7): at B = 1 the latency chain of a
// term (barrier, L2 load, reduction, ~4 us); at B >= 40 every block
// streams the whole term from L2 (41 MB a term at B = 40) and the
// products are shared-memory bound (one 16-byte read per 16 FMAs).
// The TPU kernel's Gauss three-product form was a choice for the MXU and
// is not carried over. Tensor-core products (a 'fast' precision), d past
// 1024 and a group of Hamiltonians per launch are left for later work.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include <utility>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxD = 1024;
constexpr int kMaxThreads = 1024;
constexpr int kMaxSmem = 232448;
// row-split configuration
constexpr int kRows = 8;        // rows of H per block
constexpr int kMaxWarps = 16;   // 32 columns per warp and step
constexpr int kMaxSteps = 2;    // kMaxD / (32 * kMaxWarps): a lane's column steps
constexpr int kHPad = 16;       // floats of padding per shared H row
constexpr unsigned kFull = 0xffffffffu;

// Column steps a lane may take in one chunk: two for passes of 2 states
// (ST = 1: a whole term is one chunk), one otherwise (registers).
template <int ST>
__host__ __device__ constexpr int chunk_steps() {
  return ST == 1 ? kMaxSteps : 1;
}

// ---------------------------------------------------------------------------
// grid barrier and asynchronous copies
// ---------------------------------------------------------------------------

// Grid-wide barrier between Taylor terms: cooperative_groups' grid sync
// (valid under the cooperative launch, which makes every block resident).
// On an NVIDIA H100 80GB HBM3 at 700 W, 128 blocks of 512 threads:
// 1.43 us per barrier, against 1.87 us for an arrival by an acquire-release
// atomic and a wait by acquire loads, and 2.23 us for the fenced spin with
// back-off this kernel had before (scripts/grid_barrier_bench.py).
__device__ __forceinline__ void grid_sync() { cg::this_grid().sync(); }

// 16 bytes global -> shared through L2 only; bytes < 16 zero-fills the
// rest (0: all zeros, nothing read).
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(s), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// Two shared-memory stages over `items` staged loads: issue(item, buffer)
// starts an item's copies, compute(item, buffer) runs once they have
// landed, while the next item loads into the other stage. (Deeper rings
// measured no faster: the chunks are not load-latency bound.)
template <class Issue, class Compute>
__device__ __forceinline__ void pipeline(int items, Issue issue,
                                         Compute compute) {
  issue(0, 0);
  cp_async_commit();
  for (int it = 0; it < items; ++it) {
    if (it + 1 < items) issue(it + 1, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    compute(it, it & 1);
    __syncthreads();  // the buffer is consumed before it is issued again
  }
}

__device__ __forceinline__ int other_buffer(int a, int b) {
  for (int c = 0; c < 3; ++c)
    if (c != a && c != b) return c;
  return 0;
}

// ---------------------------------------------------------------------------
// block-resident configuration (d <= 64)
// ---------------------------------------------------------------------------

// H into shared memory at row stride hs (odd): row i of H at hr + i * hs;
// H^dagger[i][j] = conj(hr[j * hs + i]).
__device__ void load_h_block(float* hr, float* hi, const float* h_re,
                             const float* h_im, int d, int hs) {
  for (int idx = threadIdx.x; idx < d * d; idx += blockDim.x) {
    const int i = idx / d, j = idx - i * d;
    hr[i * hs + j] = h_re[idx];
    hi[i * hs + j] = h_im[idx];
  }
}

// y = (H src)[b, i] (dagger: (H^dagger src)[b, i]) for src [nb, d] in shared
// memory.
__device__ __forceinline__ void block_row(const float* hr, const float* hi,
                                          const float* sr, const float* si,
                                          int b, int i, int d, int hs,
                                          bool dagger, float& yr, float& yi) {
  float ar = 0.f, ai = 0.f;
  const float* xr = sr + b * d;
  const float* xi = si + b * d;
  if (!dagger) {
    const float* mr = hr + i * hs;
    const float* mi = hi + i * hs;
#pragma unroll 4
    for (int j = 0; j < d; ++j) {
      ar = fmaf(mr[j], xr[j], fmaf(-mi[j], xi[j], ar));
      ai = fmaf(mr[j], xi[j], fmaf(mi[j], xr[j], ai));
    }
  } else {
#pragma unroll 4
    for (int j = 0; j < d; ++j) {
      const float mr = hr[j * hs + i], mi = -hi[j * hs + i];
      ar = fmaf(mr, xr[j], fmaf(-mi, xi[j], ar));
      ai = fmaf(mr, xi[j], fmaf(mi, xr[j], ai));
    }
  }
  yr = ar;
  yi = ai;
}

// Forward: block blockIdx.x takes states [b0, b0 + states). Shared: H
// [d][hs] x2, the scaled term cur and nxt [states][d] x2, the running sum x
// [states][d] x2.
__global__ void __launch_bounds__(kMaxThreads) block_forward(
    const float* h_re, const float* h_im, const float* p_re,
    const float* p_im, const float* zs, float* o_re, float* o_im, int d,
    int B, int order, int substeps, int states) {
  extern __shared__ __align__(16) float smem[];
  const int hs = d | 1;
  const int plane = states * d;
  float* hr = smem;
  float* hi = hr + d * hs;
  float* cr_ = hi + d * hs;   // cur re, im; nxt re, im; x re, im
  float* xr = cr_ + 4 * plane;
  float* xi = xr + plane;
  const int b0 = blockIdx.x * states;
  const int n = min(states, B - b0) * d;
  const size_t off = (size_t)b0 * d;
  const float wr = zs[0], wi = zs[1];
  load_h_block(hr, hi, h_re, h_im, d, hs);
  for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
    const float a = p_re[off + idx], c = p_im[off + idx];
    xr[idx] = a;
    xi[idx] = c;
    cr_[idx] = wr * a - wi * c;
    cr_[plane + idx] = wr * c + wi * a;
  }
  __syncthreads();
  int cur = 0;
  for (int s = 0; s < substeps; ++s) {
    for (int k = 1; k <= order; ++k) {
      const bool last = k == order, done = last && s == substeps - 1;
      const float sr = last ? wr : wr / (float)(k + 1);
      const float si = last ? wi : wi / (float)(k + 1);
      const float* tr = cr_ + cur * 2 * plane;
      float* nr = cr_ + (1 - cur) * 2 * plane;
      for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
        const int b = idx / d, i = idx - b * d;
        float yr, yi;
        block_row(hr, hi, tr, tr + plane, b, i, d, hs, false, yr, yi);
        const float ar = xr[idx] + yr, ai = xi[idx] + yi;
        xr[idx] = ar;
        xi[idx] = ai;
        if (!done) {
          const float vr = last ? ar : yr, vi = last ? ai : yi;
          nr[idx] = sr * vr - si * vi;
          nr[plane + idx] = sr * vi + si * vr;
        }
      }
      __syncthreads();
      cur = 1 - cur;
    }
  }
  for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
    o_re[off + idx] = xr[idx];
    o_im[off + idx] = xi[idx];
  }
}

// Backward. Shared: H [d][hs] x2, gH [d][d] x2, the running sum x, three
// cotangent buffers and the terms: every slot (s, k) [states][d] x2 when
// terms_in_smem, else two staging buffers, the slots then living in the
// global scratch terms [substeps][order][2][B][d]. gH goes to gh (one
// block) or to part [grid][2][d][d] for block_reduce.
__global__ void __launch_bounds__(kMaxThreads) block_backward(
    const float* h_re, const float* h_im, const float* p_re,
    const float* p_im, const float* g_re, const float* g_im,
    const float* zs, float* gh_re, float* gh_im, float* gp_re,
    float* gp_im, float* terms, float* part, int d, int B, int order,
    int substeps, int states, int terms_in_smem) {
  extern __shared__ __align__(16) float smem[];
  const int hs = d | 1;
  const int plane = states * d;
  float* hr = smem;
  float* hi = hr + d * hs;
  float* ghr = hi + d * hs;
  float* ghi = ghr + d * d;
  float* xr = ghi + d * d;
  float* xi = xr + plane;
  float* gb = xi + plane;           // 3 cotangent buffers [2][states][d]
  float* ts = gb + 6 * plane;       // slots, or 2 staging buffers
  const int b0 = blockIdx.x * states;
  const int nb = min(states, B - b0);
  const int n = nb * d;
  const size_t off = (size_t)b0 * d;
  const size_t gplane = (size_t)B * d;
  const float wr = zs[0], wi = zs[1];
  // slot (s, k) re plane in shared memory (terms_in_smem) or global
  auto gslot = [&](int s, int k) {
    return terms + ((size_t)s * order + k) * 2 * gplane + off;
  };
  auto sslot = [&](int s, int k) {
    return ts + ((size_t)s * order + k) * 2 * plane;
  };
  load_h_block(hr, hi, h_re, h_im, d, hs);
  for (int idx = threadIdx.x; idx < d * d; idx += blockDim.x)
    ghr[idx] = ghi[idx] = 0.f;
  for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
    const float a = p_re[off + idx], c = p_im[off + idx];
    xr[idx] = a;
    xi[idx] = c;
    float* t0 = terms_in_smem ? sslot(0, 0) : ts;
    t0[idx] = wr * a - wi * c;
    t0[plane + idx] = wr * c + wi * a;
    if (!terms_in_smem) {
      gslot(0, 0)[idx] = t0[idx];
      gslot(0, 0)[gplane + idx] = t0[plane + idx];
    }
    gb[idx] = g_re[off + idx];   // lambda: buffer 0
    gb[plane + idx] = g_im[off + idx];
  }
  __syncthreads();

  // 1. the forward again, storing every scaled term s_{s,k}, k < order,
  //    and every substep input w x_s
  int cur = 0;
  for (int s = 0; s < substeps; ++s) {
    const int kmax = s == substeps - 1 ? order - 1 : order;
    for (int k = 1; k <= kmax; ++k) {
      const bool last = k == order;
      const float sr = last ? wr : wr / (float)(k + 1);
      const float si = last ? wi : wi / (float)(k + 1);
      const float* src = terms_in_smem ? sslot(s, k - 1) : ts + cur * 2 * plane;
      float* dst = terms_in_smem ? (last ? sslot(s + 1, 0) : sslot(s, k))
                                 : ts + (1 - cur) * 2 * plane;
      float* gdst = last ? gslot(s + 1, 0) : gslot(s, k);
      for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
        const int b = idx / d, i = idx - b * d;
        float yr, yi;
        block_row(hr, hi, src, src + plane, b, i, d, hs, false, yr, yi);
        const float ar = xr[idx] + yr, ai = xi[idx] + yi;
        xr[idx] = ar;
        xi[idx] = ai;
        const float vr = last ? ar : yr, vi = last ? ai : yi;
        const float tr = sr * vr - si * vi, ti = sr * vi + si * vr;
        dst[idx] = tr;
        dst[plane + idx] = ti;
        if (!terms_in_smem) {
          gdst[idx] = tr;
          gdst[gplane + idx] = ti;
        }
      }
      __syncthreads();
      cur = 1 - cur;
    }
  }

  // 2. the reverse recurrence, substep by substep from the last
  int l_idx = 0;
  for (int s = substeps - 1; s >= 0; --s) {
    int s_idx = l_idx;
    for (int k = order; k >= 1; --k) {
      const float cr = wr / (float)k, ci = -wi / (float)k;  // conj(w / k)
      const float* tk;  // s_{s,k-1} [nb][d] x2 in shared memory
      if (terms_in_smem) {
        tk = sslot(s, k - 1);
      } else {
        const float* gsrc = gslot(s, k - 1);
        for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
          ts[idx] = gsrc[idx];
          ts[plane + idx] = gsrc[gplane + idx];
        }
        __syncthreads();
        tk = ts;
      }
      const float* gk = gb + s_idx * 2 * plane;
      const float* lam = gb + l_idx * 2 * plane;
      const bool fin = s == 0 && k == 1;
      const int d_idx = other_buffer(s_idx, l_idx);
      float* gn = gb + d_idx * 2 * plane;
      // gH[i][j] += sum_b gbar_k[b][i] conj(s_{k-1}[b][j])
      for (int e = threadIdx.x; e < d * d; e += blockDim.x) {
        const int i = e / d, j = e - i * d;
        float ar = ghr[e], ai = ghi[e];
        for (int b = 0; b < nb; ++b) {
          const float qr = gk[b * d + i], qi = gk[plane + b * d + i];
          const float tr = tk[b * d + j], ti = tk[plane + b * d + j];
          ar = fmaf(qr, tr, fmaf(qi, ti, ar));
          ai = fmaf(qi, tr, fmaf(-qr, ti, ai));
        }
        ghr[e] = ar;
        ghi[e] = ai;
      }
      // gbar_{k-1} = lambda + conj(w/k) H^dagger gbar_k
      for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
        const int b = idx / d, i = idx - b * d;
        float yr, yi;
        block_row(hr, hi, gk, gk + plane, b, i, d, hs, true, yr, yi);
        const float vr = lam[idx] + cr * yr - ci * yi;
        const float vi = lam[plane + idx] + cr * yi + ci * yr;
        if (fin) {
          gp_re[off + idx] = vr;
          gp_im[off + idx] = vi;
        } else {
          gn[idx] = vr;
          gn[plane + idx] = vi;
        }
      }
      __syncthreads();
      s_idx = d_idx;
    }
    l_idx = s_idx;  // gbar_0: the cotangent of this substep's input
  }
  float* out_re = gridDim.x == 1 ? gh_re : part + (size_t)blockIdx.x * 2 * d * d;
  float* out_im = gridDim.x == 1 ? gh_im : out_re + d * d;
  for (int e = threadIdx.x; e < d * d; e += blockDim.x) {
    out_re[e] = ghr[e];
    out_im[e] = ghi[e];
  }
}

// gh = sum over blocks of part [blocks][2][d][d], in block order.
__global__ void block_reduce(const float* part, float* gh_re, float* gh_im,
                             int d, int blocks) {
  const int dd = d * d;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < 2 * dd;
       e += gridDim.x * blockDim.x) {
    const int pl = e / dd, i = e - pl * dd;
    float a = 0.f;
    for (int b = 0; b < blocks; ++b) a += part[((size_t)b * 2 + pl) * dd + i];
    (pl == 0 ? gh_re : gh_im)[i] = a;
  }
}

// ---------------------------------------------------------------------------
// row-split configuration (64 < d <= 1024)
// ---------------------------------------------------------------------------

// The launch's geometry: d, B, dp (row stride of the term scratch, d
// rounded up to 4 so that 16-byte copies stay aligned), chunk = steps x 32
// x warps columns staged at a time (a lane takes 4 columns of each 32 x
// warps), chunks per pass, hs (shared H row stride) and the block's first
// row.
struct Geo {
  int d, B, dp, chunk, chunks, steps, hs, row0;
};

// Rows row0 .. row0 + 7 of H (or of H^dagger: conjugated columns) into
// shared memory at stride hs; entries past d are zero.
__device__ void load_rows(float* sr, float* si, const float* h_re,
                          const float* h_im, const Geo& g, bool dagger) {
  const int n = kRows * g.hs;
  for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
    int r, j;
    if (dagger) {
      j = idx / kRows;
      r = idx - j * kRows;
    } else {
      r = idx / g.hs;
      j = idx - r * g.hs;
    }
    if (j >= g.hs) continue;
    const int i = g.row0 + r;
    float a = 0.f, b = 0.f;
    if (i < g.d && j < g.d) {
      if (dagger) {
        a = h_re[(size_t)j * g.d + i];
        b = -h_im[(size_t)j * g.d + i];
      } else {
        a = h_re[(size_t)i * g.d + j];
        b = h_im[(size_t)i * g.d + j];
      }
    }
    sr[r * g.hs + j] = a;
    si[r * g.hs + j] = b;
  }
}

// Starts copying chunk c of states [p S, p S + S) of a [B][dp] plane pair
// into the stage st (re [S][chunk], then im); past B or d zero-filled.
template <int S>
__device__ __forceinline__ void issue_chunk(float* st, const float* src_re,
                                            const float* src_im, int p,
                                            int c, const Geo& g) {
  const int vecs = g.chunk >> 2;
  const int sz = S * g.chunk;
  for (int v = threadIdx.x; v < S * vecs; v += blockDim.x) {
    const int sl = v / vecs, jv = v - sl * vecs;
    const int b = p * S + sl, j = c * g.chunk + 4 * jv;
    int bytes = 0;
    size_t off = 0;
    if (b < g.B && j < g.d) {
      bytes = min(16, 4 * (g.d - j));
      off = (size_t)b * g.dp + j;
    }
    cp_async16(st + sl * g.chunk + 4 * jv, src_re + off, bytes);
    cp_async16(st + sz + sl * g.chunk + 4 * jv, src_im + off, bytes);
  }
}

// Starts copying the block's 8 rows of states [p S, p S + S) of a [B][dp]
// plane pair into q (re [S][8], then im).
template <int S>
__device__ __forceinline__ void issue_rows(float* q, const float* src_re,
                                           const float* src_im, int p,
                                           const Geo& g) {
  const int v = threadIdx.x;
  if (v < 4 * S) {
    const int pl = v / (2 * S), rest = v - pl * 2 * S;
    const int sl = rest >> 1, h = rest & 1;
    const int b = p * S + sl, i = g.row0 + 4 * h;
    int bytes = 0;
    size_t off = 0;
    if (b < g.B && i < g.d) {
      bytes = min(16, 4 * (g.d - i));
      off = (size_t)b * g.dp + i;
    }
    cp_async16(q + pl * S * kRows + sl * kRows + 4 * h,
               (pl ? src_im : src_re) + off, bytes);
  }
}

// The lane's share of a product over one column step of a staged chunk:
// rows 4 rg .. 4 rg + 3 of the block, states sg ST .. sg ST + ST - 1 of the
// pass, columns col .. col + 3 of the chunk (hcol in the shared rows).
template <int ST>
__device__ __forceinline__ void product_step(float (&ar)[4][ST],
                                             float (&ai)[4][ST],
                                             const float* mr, const float* mi,
                                             const float* st, int sz,
                                             int chunk, int hs, int col,
                                             int hcol, int rg, int sg) {
  float4 tr[ST], ti[ST];
#pragma unroll
  for (int p = 0; p < ST; ++p) {
    const int o = (sg * ST + p) * chunk + col;
    tr[p] = *reinterpret_cast<const float4*>(st + o);
    ti[p] = *reinterpret_cast<const float4*>(st + sz + o);
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int o = (4 * rg + q) * hs + hcol;
    const float4 a = *reinterpret_cast<const float4*>(mr + o);
    const float4 b = *reinterpret_cast<const float4*>(mi + o);
#pragma unroll
    for (int p = 0; p < ST; ++p) {
      float r = ar[q][p], i = ai[q][p];
      r = fmaf(a.x, tr[p].x, fmaf(-b.x, ti[p].x, r));
      i = fmaf(a.x, ti[p].x, fmaf(b.x, tr[p].x, i));
      r = fmaf(a.y, tr[p].y, fmaf(-b.y, ti[p].y, r));
      i = fmaf(a.y, ti[p].y, fmaf(b.y, tr[p].y, i));
      r = fmaf(a.z, tr[p].z, fmaf(-b.z, ti[p].z, r));
      i = fmaf(a.z, ti[p].z, fmaf(b.z, tr[p].z, i));
      r = fmaf(a.w, tr[p].w, fmaf(-b.w, ti[p].w, r));
      i = fmaf(a.w, ti[p].w, fmaf(b.w, tr[p].w, i));
      ar[q][p] = r;
      ai[q][p] = i;
    }
  }
}

// Sums the pass's products over the column split: within the warp by a
// reduce-scatter over the 8 column lanes, then the warps' partials into
// red [warps][8][S][2] (the lanes of a warp write neighbouring words).
// After the __syncthreads that follows, pass_sum gives thread t < 8 S the
// product for row t % 8 and state t / 8, summed over the warps in order.
template <int ST>
__device__ __forceinline__ void reduce_pass(const float (&ar)[4][ST],
                                            const float (&ai)[4][ST],
                                            float* red, int w, int rg,
                                            int sg, int jl) {
  constexpr int N = 8 * ST;  // index (q ST + p) 2 + (0 re, 1 im)
  constexpr int S = 2 * ST;
  float v[N];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int p = 0; p < ST; ++p) {
      v[(q * ST + p) * 2] = ar[q][p];
      v[(q * ST + p) * 2 + 1] = ai[q][p];
    }
  const bool h4 = jl & 4, h2 = jl & 2, h1 = jl & 1;
#pragma unroll
  for (int x = 0; x < N / 2; ++x) {
    const float send = h4 ? v[x] : v[x + N / 2];
    const float keep = h4 ? v[x + N / 2] : v[x];
    v[x] = keep + __shfl_xor_sync(kFull, send, 4);
  }
#pragma unroll
  for (int x = 0; x < N / 4; ++x) {
    const float send = h2 ? v[x] : v[x + N / 4];
    const float keep = h2 ? v[x + N / 4] : v[x];
    v[x] = keep + __shfl_xor_sync(kFull, send, 2);
  }
#pragma unroll
  for (int x = 0; x < N / 8; ++x) {
    const float send = h1 ? v[x] : v[x + N / 8];
    const float keep = h1 ? v[x + N / 8] : v[x];
    v[x] = keep + __shfl_xor_sync(kFull, send, 1);
  }
  const int base = (h4 ? N / 2 : 0) + (h2 ? N / 4 : 0) + (h1 ? N / 8 : 0);
#pragma unroll
  for (int x = 0; x < N / 8; ++x) {
    const int e = base + x, c = e & 1, qp = e >> 1;
    const int q = qp / ST, p = qp - q * ST;
    red[w * (16 * S) + ((4 * rg + q) * S + sg * ST + p) * 2 + c] = v[x];
  }
}

template <int S>
__device__ __forceinline__ void pass_sum(const float* red, int warps, int t,
                                         float& yr, float& yi) {
  const float2* pr =
      reinterpret_cast<const float2*>(red) + (t & 7) * S + (t >> 3);
  float2 a = pr[0];
#pragma unroll 4
  for (int w = 1; w < warps; ++w) {
    const float2 x = pr[w * 8 * S];
    a.x += x.x;
    a.y += x.y;
  }
  yr = a.x;
  yi = a.y;
}

// One product y = M src over every state, M the block's shared rows mr/mi,
// src a [B][dp] plane pair in global memory, streamed chunk by chunk
// through the two stages. begin(p) runs at the start of
// pass p (states [p S, p S + S)), emit(p, yr, yi) on thread t < 8 S with
// the product for row row0 + t % 8 and state p S + t / 8.
template <int ST, class Begin, class Emit>
__device__ __forceinline__ void rows_product(const float* mr, const float* mi,
                                             const float* src_re,
                                             const float* src_im,
                                             float* stage, float* red,
                                             const Geo& g,
                                             Begin begin, Emit emit) {
  constexpr int S = 2 * ST;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int rg = lane >> 4, sg = (lane >> 3) & 1, jl = lane & 7;
  const int col = w * 32 + 4 * jl;
  const int warps = blockDim.x >> 5;
  const int sz = S * g.chunk;
  const int items = (g.B + S - 1) / S * g.chunks;
  float ar[4][ST], ai[4][ST];
  pipeline(
      items,
      [&](int it, int buf) {
        const int p = it / g.chunks;
        issue_chunk<S>(stage + buf * 2 * sz, src_re, src_im, p,
                       it - p * g.chunks, g);
      },
      [&](int it, int buf) {
        const int p = it / g.chunks, c = it - p * g.chunks;
        if (c == 0) {
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int x = 0; x < ST; ++x) ar[q][x] = ai[q][x] = 0.f;
          begin(p);
        }
#pragma unroll
        for (int m = 0; m < chunk_steps<ST>(); ++m) {
          const int cm = col + m * (int)blockDim.x;
          if (chunk_steps<ST>() == 1 || m < g.steps)
            product_step<ST>(ar, ai, mr, mi, stage + buf * 2 * sz, sz,
                             g.chunk, g.hs, cm, c * g.chunk + cm, rg, sg);
        }
        if (c == g.chunks - 1) {
          reduce_pass<ST>(ar, ai, red, w, rg, sg, jl);
          __syncthreads();
          if (tid < 8 * S) {
            float yr, yi;
            pass_sum<S>(red, warps, tid, yr, yi);
            emit(p, yr, yi);
          }
        }
      });
}

// The lane's share of gH += gbar s^dagger over one staged chunk: rows 4 rg ..
// 4 rg + 3, columns col2, col2 + 1 of the chunk; q the pass's cotangent
// rows [S][8] x2, st its term chunk [S][chunk] x2.
template <int S>
__device__ __forceinline__ void update_step(float (&hr)[4][2],
                                            float (&hi)[4][2], const float* q,
                                            const float* st, int sz,
                                            int chunk, int col2, int rg) {
#pragma unroll 2
  for (int sl = 0; sl < S; ++sl) {
    const float2 tr = *reinterpret_cast<const float2*>(st + sl * chunk + col2);
    const float2 ti =
        *reinterpret_cast<const float2*>(st + sz + sl * chunk + col2);
    const float4 gr =
        *reinterpret_cast<const float4*>(q + sl * kRows + 4 * rg);
    const float4 gi =
        *reinterpret_cast<const float4*>(q + S * kRows + sl * kRows + 4 * rg);
    const float qr[4] = {gr.x, gr.y, gr.z, gr.w};
    const float qi[4] = {gi.x, gi.y, gi.z, gi.w};
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      hr[x][0] = fmaf(qr[x], tr.x, fmaf(qi[x], ti.x, hr[x][0]));
      hi[x][0] = fmaf(qi[x], tr.x, fmaf(-qr[x], ti.x, hi[x][0]));
      hr[x][1] = fmaf(qr[x], tr.y, fmaf(qi[x], ti.y, hr[x][1]));
      hi[x][1] = fmaf(qi[x], tr.y, fmaf(-qr[x], ti.y, hi[x][1]));
    }
  }
}

// Forward. buf: scratch [2 buffers][2 planes][B][dp] for the scaled terms;
// out holds the running sum x (each element owned by one thread).
template <int ST>
__global__ void __launch_bounds__(kMaxWarps * 32, 1) rows_forward(
    const float* h_re, const float* h_im, const float* p_re,
    const float* p_im, const float* zs, float* o_re, float* o_im,
    float* buf, int d, int B, int order, int substeps, int chunks,
    int steps, int dp) {
  constexpr int S = 2 * ST;
  extern __shared__ __align__(16) float smem[];
  const int chunk = steps * blockDim.x;
  const Geo g{d, B, dp, chunk, chunks, steps, chunks * chunk + kHPad,
              (int)blockIdx.x * kRows};
  float* hr = smem;
  float* hi = hr + kRows * g.hs;
  float* stage = hi + kRows * g.hs;   // [2][2][S][chunk]
  float* red = stage + 4 * S * chunk;  // [warps][8][S][2]
  load_rows(hr, hi, h_re, h_im, g, false);
  const float wr = zs[0], wi = zs[1];
  const size_t plane = (size_t)B * dp;
  // buffer 0 <- w psi on the block's rows
  for (int idx = threadIdx.x; idx < kRows * B; idx += blockDim.x) {
    const int b = idx / kRows, i = g.row0 + idx - b * kRows;
    if (i < d) {
      const float a = p_re[(size_t)b * d + i], c = p_im[(size_t)b * d + i];
      __stcg(buf + (size_t)b * dp + i, wr * a - wi * c);
      __stcg(buf + plane + (size_t)b * dp + i, wr * c + wi * a);
    }
  }
  grid_sync();
  const int tid = threadIdx.x;
  const int i = g.row0 + (tid & 7);
  int cur = 0;
  for (int s = 0; s < substeps; ++s) {
    for (int k = 1; k <= order; ++k) {
      const bool last = k == order, done = last && s == substeps - 1;
      const bool first = s == 0 && k == 1;
      const float sr = last ? wr : wr / (float)(k + 1);
      const float si = last ? wi : wi / (float)(k + 1);
      const float* src = buf + (size_t)cur * 2 * plane;
      float* dst = buf + (size_t)(1 - cur) * 2 * plane;
      float xr = 0.f, xi = 0.f;
      rows_product<ST>(
          hr, hi, src, src + plane, stage, red, g,
          [&](int p) {
            const int b = p * S + (tid >> 3);
            if (tid < 8 * S && b < B && i < d) {
              const size_t o = (size_t)b * d + i;
              xr = first ? p_re[o] : o_re[o];
              xi = first ? p_im[o] : o_im[o];
            }
          },
          [&](int p, float yr, float yi) {
            const int b = p * S + (tid >> 3);
            if (b >= B || i >= d) return;
            const size_t o = (size_t)b * d + i;
            const float ar = xr + yr, ai = xi + yi;
            o_re[o] = ar;
            o_im[o] = ai;
            if (!done) {
              const float vr = last ? ar : yr, vi = last ? ai : yi;
              __stcg(dst + (size_t)b * dp + i, sr * vr - si * vi);
              __stcg(dst + plane + (size_t)b * dp + i, sr * vi + si * vr);
            }
          });
      if (!done) {
        grid_sync();
        cur = 1 - cur;
      }
    }
  }
}

// Backward. terms: scratch [substeps][order][2][B][dp] of the scaled terms
// (slot (s, 0) holds w x_s); gbuf: scratch [3][2][B][dp] for gbar and
// lambda; gp doubles as the forward's running sum until the reverse pass
// writes it.
template <int ST>
__global__ void __launch_bounds__(kMaxWarps * 32, 1) rows_backward(
    const float* h_re, const float* h_im, const float* p_re,
    const float* p_im, const float* g_re, const float* g_im,
    const float* zs, float* gh_re, float* gh_im, float* gp_re,
    float* gp_im, float* terms, float* gbuf, int d, int B, int order,
    int substeps, int chunks, int steps, int dp) {
  constexpr int S = 2 * ST;
  extern __shared__ __align__(16) float smem[];
  const int chunk = steps * blockDim.x;
  const Geo g{d, B, dp, chunk, chunks, steps, chunks * chunk + kHPad,
              (int)blockIdx.x * kRows};
  float* hr = smem;
  float* hi = hr + kRows * g.hs;
  float* dr = hi + kRows * g.hs;
  float* di = dr + kRows * g.hs;
  float* stage = di + kRows * g.hs;   // [2][2][S][chunk]
  float* qs = stage + 4 * S * chunk;   // [2][2][S][8]
  float* red = qs + 4 * S * kRows;     // [warps][8][S][2]
  load_rows(hr, hi, h_re, h_im, g, false);
  load_rows(dr, di, h_re, h_im, g, true);
  const float wr = zs[0], wi = zs[1];
  const size_t plane = (size_t)B * dp;
  auto slot = [&](int s, int k) {
    return terms + ((size_t)s * order + k) * 2 * plane;
  };
  // slot (0, 0) <- w psi and gbuf 0 <- g on the block's rows
  for (int idx = threadIdx.x; idx < kRows * B; idx += blockDim.x) {
    const int b = idx / kRows, i = g.row0 + idx - b * kRows;
    if (i < d) {
      const size_t o = (size_t)b * d + i, t = (size_t)b * dp + i;
      const float a = p_re[o], c = p_im[o];
      __stcg(slot(0, 0) + t, wr * a - wi * c);
      __stcg(slot(0, 0) + plane + t, wr * c + wi * a);
      __stcg(gbuf + t, g_re[o]);
      __stcg(gbuf + plane + t, g_im[o]);
    }
  }
  grid_sync();
  const int tid = threadIdx.x;
  const int i = g.row0 + (tid & 7);

  // 1. the forward again, storing every scaled term
  for (int s = 0; s < substeps; ++s) {
    const int kmax = s == substeps - 1 ? order - 1 : order;
    for (int k = 1; k <= kmax; ++k) {
      const bool last = k == order, first = s == 0 && k == 1;
      const float sr = last ? wr : wr / (float)(k + 1);
      const float si = last ? wi : wi / (float)(k + 1);
      const float* src = slot(s, k - 1);
      float* dst = last ? slot(s + 1, 0) : slot(s, k);
      float xr = 0.f, xi = 0.f;
      rows_product<ST>(
          hr, hi, src, src + plane, stage, red, g,
          [&](int p) {
            const int b = p * S + (tid >> 3);
            if (tid < 8 * S && b < B && i < d) {
              const size_t o = (size_t)b * d + i;
              xr = first ? p_re[o] : gp_re[o];
              xi = first ? p_im[o] : gp_im[o];
            }
          },
          [&](int p, float yr, float yi) {
            const int b = p * S + (tid >> 3);
            if (b >= B || i >= d) return;
            const size_t o = (size_t)b * d + i;
            const float ar = xr + yr, ai = xi + yi;
            gp_re[o] = ar;
            gp_im[o] = ai;
            const float vr = last ? ar : yr, vi = last ? ai : yi;
            __stcg(dst + (size_t)b * dp + i, sr * vr - si * vi);
            __stcg(dst + plane + (size_t)b * dp + i, sr * vi + si * vr);
          });
      grid_sync();
    }
  }

  // 2. the reverse recurrence, substep by substep from the last
  const int w = tid >> 5, lane = tid & 31;
  const int rg = lane >> 4, sg = (lane >> 3) & 1, jl = lane & 7;
  const int col2 = w * 32 + 4 * jl + 2 * sg;
  const int sz = S * chunk;
  const int passes = (B + S - 1) / S;
  float ghr[kMaxSteps][4][2], ghi[kMaxSteps][4][2];
#pragma unroll
  for (int c = 0; c < kMaxSteps; ++c)
#pragma unroll
    for (int x = 0; x < 4; ++x) ghr[c][x][0] = ghr[c][x][1] = ghi[c][x][0] =
        ghi[c][x][1] = 0.f;
  int l_idx = 0;
  for (int s = substeps - 1; s >= 0; --s) {
    int s_idx = l_idx;
    for (int k = order; k >= 1; --k) {
      const float cr = wr / (float)k, ci = -wi / (float)k;  // conj(w / k)
      const float* gk = gbuf + (size_t)s_idx * 2 * plane;
      const float* lam = gbuf + (size_t)l_idx * 2 * plane;
      const float* tk = slot(s, k - 1);
      // gbar_{k-1} = lambda + conj(w/k) H^dagger gbar_k
      const bool fin = s == 0 && k == 1;
      const int d_idx = other_buffer(s_idx, l_idx);
      float* dn = gbuf + (size_t)d_idx * 2 * plane;
      float lr = 0.f, li = 0.f;
      rows_product<ST>(
          dr, di, gk, gk + plane, stage, red, g,
          [&](int p) {
            const int b = p * S + (tid >> 3);
            if (tid < 8 * S && b < B && i < d) {
              const size_t t = (size_t)b * dp + i;
              lr = __ldcg(lam + t);
              li = __ldcg(lam + plane + t);
            }
          },
          [&](int p, float yr, float yi) {
            const int b = p * S + (tid >> 3);
            if (b >= B || i >= d) return;
            const float vr = lr + cr * yr - ci * yi;
            const float vi = li + cr * yi + ci * yr;
            if (fin) {
              gp_re[(size_t)b * d + i] = vr;
              gp_im[(size_t)b * d + i] = vi;
            } else {
              __stcg(dn + (size_t)b * dp + i, vr);
              __stcg(dn + plane + (size_t)b * dp + i, vi);
            }
          });
      // gH[rows][j] += sum_b gbar_k[b][rows] conj(s_{k-1}[b][j]): the term
      // chunks with the pass's cotangent rows, through the same stages
      auto update = [&]() {
      pipeline(
          passes * chunks,
          [&](int it, int buf) {
            const int p = it / chunks;
            issue_chunk<S>(stage + buf * 2 * sz, tk, tk + plane, p,
                           it - p * chunks, g);
            issue_rows<S>(qs + buf * 2 * S * kRows, gk, gk + plane, p, g);
          },
          [&](int it, int buf) {
            const float* st = stage + buf * 2 * sz;
            const float* q = qs + buf * 2 * S * kRows;
            const int c = it % chunks;
#pragma unroll
            for (int m = 0; m < chunk_steps<ST>(); ++m) {
              const int cm = col2 + m * (int)blockDim.x;
              if (chunk_steps<ST>() > 1 && m >= steps) continue;
              if (c * steps + m == 0)  // the lane's column step, in order
                update_step<S>(ghr[0], ghi[0], q, st, sz, chunk, cm, rg);
              else
                update_step<S>(ghr[1], ghi[1], q, st, sz, chunk, cm, rg);
            }
          });
      };
      // the update needs only the block's own rows of gbar_k and the stored
      // terms: it runs between the grid barrier's arrival and its wait
      if (fin) {
        update();
      } else {
        auto token = cg::this_grid().barrier_arrive();
        update();
        cg::this_grid().barrier_wait(std::move(token));
        s_idx = d_idx;
      }
    }
    l_idx = s_idx;  // gbar_0: the cotangent of this substep's input
  }
#pragma unroll
  for (int c = 0; c < kMaxSteps; ++c) {  // the lane's column steps
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int r = g.row0 + 4 * rg + x;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = c * (int)blockDim.x + col2 + e;
        if (c < chunks * steps && r < d && j < d) {
          gh_re[(size_t)r * d + j] = ghr[c][x][e];
          gh_im[(size_t)r * d + j] = ghi[c][x][e];
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

enum Config { kBlock = 0, kRowSplit = 1 };
constexpr int kBadPlan = -1;  // the shape or the plan's geometry is refused

bool bad_shape(int d, int B, int order, int substeps) {
  return d < 1 || d > kMaxD || B < 1 || order < 1 || substeps < 1;
}

// The plan's geometry, checked (not chosen) here.
bool bad_plan(int config, int d, int B, int threads, int states, int grid,
              int smem, int chunks, int steps, int stride) {
  if (threads < 32 || threads > kMaxThreads || threads % 32 || smem < 0 ||
      smem > kMaxSmem || states < 1)
    return true;
  if (config == kBlock)
    return (long long)states * grid < B || (long long)states * (grid - 1) >= B;
  if (config == kRowSplit)
    return threads > kMaxWarps * 32 || grid != (d + kRows - 1) / kRows ||
           chunks < 1 || steps < 1 || chunks * steps > kMaxSteps ||
           (steps > 1 && states != 2) ||
           chunks * steps * threads < d ||
           stride < d || stride % 4 || (states != 2 && states != 8) ||
           threads < 8 * states;
  return true;
}

// The kernel's shared-memory ceiling raised to the card's limit once per
// (kernel, device), so that every plan's size launches; the co-residency
// limit once per (kernel, device, shared memory, threads).
struct Prepared {
  const void* fn;
  int dev, smem, threads, max_blocks;
};
Prepared g_prepared[64];
int g_n_prepared = 0;

int prepare(const void* fn, int smem, int threads, int* max_blocks) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  bool raised = false;
  for (int n = 0; n < g_n_prepared; ++n) {
    const Prepared& p = g_prepared[n];
    if (p.fn != fn || p.dev != dev) continue;
    raised = true;
    if (p.smem == smem && p.threads == threads) {
      *max_blocks = p.max_blocks;
      return 0;
    }
  }
  if (!raised) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
    if (e != cudaSuccess) return (int)e;
  }
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads,
                                                    smem);
  if (e != cudaSuccess) return (int)e;
  *max_blocks = per_sm * sms;
  if (g_n_prepared < 64)
    g_prepared[g_n_prepared++] = Prepared{fn, dev, smem, threads, per_sm * sms};
  return 0;
}

int launch(const void* fn, int grid, int threads, int smem, void** args,
           cudaStream_t st, bool cooperative) {
  // an error another library left in this thread's last-error slot is not
  // this launch's: clear it, so that the check below reports ours alone
  (void)cudaGetLastError();
  int max_blocks = 0;
  int e = prepare(fn, smem, threads, &max_blocks);
  if (e) return e;
  cudaError_t r;
  if (cooperative) {
    if (max_blocks < grid) return (int)cudaErrorCooperativeLaunchTooLarge;
    r = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(threads), args,
                                    (size_t)smem, st);
  } else {
    r = cudaLaunchKernel(fn, dim3(grid), dim3(threads), args, (size_t)smem,
                         st);
  }
  if (r != cudaSuccess) return (int)r;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// H [d, d], psi [B, d] (f32 planes), zs = (z_re, z_im) / substeps on the
// device; writes out [B, d]. The plan (ops/taylor_apply.py::k7_plan):
// config (0 block-resident, 1 row-split), threads, states (per block, or
// per pass), grid, smem bytes, chunks (per pass), steps (column steps of a
// lane per chunk), stride (the term scratch's row stride). Row-split only: buf
// [2][2][B][stride] floats.
int dq_k7_forward(const float* h_re, const float* h_im, const float* p_re,
                  const float* p_im, const float* zs, float* o_re,
                  float* o_im, float* buf, int d, int B, int order,
                  int substeps, int config, int threads, int states,
                  int grid, int smem, int chunks, int steps, int stride,
                  void* stream) {
  if (bad_shape(d, B, order, substeps) ||
      bad_plan(config, d, B, threads, states, grid, smem, chunks, steps,
               stride))
    return kBadPlan;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (config == kBlock) {
    void* args[] = {&h_re, &h_im, &p_re, &p_im, &zs, &o_re, &o_im,
                    &d, &B, &order, &substeps, &states};
    return launch((const void*)block_forward, grid, threads, smem, args, st,
                  false);
  }
  void* args[] = {&h_re, &h_im, &p_re, &p_im, &zs, &o_re, &o_im,
                  &buf, &d, &B, &order, &substeps, &chunks, &steps,
                  &stride};
  const void* fn = states == 2 ? (const void*)rows_forward<1>
                               : (const void*)rows_forward<4>;
  return launch(fn, grid, threads, smem, args, st, true);
}

// From the step's input psi and the output's cotangent g, writes gh
// [d, d] and gp [B, d]. Row-split: terms [substeps][order][2][B][stride]
// floats, gbuf [3][2][B][stride] floats. Block-resident: terms
// [substeps][order][2][B][d] floats unless terms_in_smem; gbuf
// [grid][2][d][d] floats when grid > 1.
int dq_k7_backward(const float* h_re, const float* h_im, const float* p_re,
                   const float* p_im, const float* g_re, const float* g_im,
                   const float* zs, float* gh_re, float* gh_im, float* gp_re,
                   float* gp_im, float* terms, float* gbuf, int d, int B,
                   int order, int substeps, int config, int threads,
                   int states, int grid, int smem, int chunks, int steps,
                   int stride, int terms_in_smem, void* stream) {
  if (bad_shape(d, B, order, substeps) ||
      bad_plan(config, d, B, threads, states, grid, smem, chunks, steps,
               stride))
    return kBadPlan;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (config == kBlock) {
    void* args[] = {&h_re, &h_im, &p_re, &p_im, &g_re, &g_im, &zs,
                    &gh_re, &gh_im, &gp_re, &gp_im, &terms, &gbuf, &d,
                    &B, &order, &substeps, &states, &terms_in_smem};
    int e = launch((const void*)block_backward, grid, threads, smem, args,
                   st, false);
    if (e || grid == 1) return e;
    const int n = 2 * d * d, rthreads = 256;
    block_reduce<<<(n + rthreads - 1) / rthreads, rthreads, 0, st>>>(
        gbuf, gh_re, gh_im, d, grid);
    return (int)cudaGetLastError();
  }
  void* args[] = {&h_re, &h_im, &p_re, &p_im, &g_re, &g_im, &zs,
                  &gh_re, &gh_im, &gp_re, &gp_im, &terms, &gbuf, &d, &B,
                  &order, &substeps, &chunks, &steps, &stride};
  const void* fn = states == 2 ? (const void*)rows_backward<1>
                               : (const void*)rows_backward<4>;
  return launch(fn, grid, threads, smem, args, st, true);
}

const char* dq_k7_error_string(int code) {
  if (code == kBadPlan) return "shape or launch plan refused";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
