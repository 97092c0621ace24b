// K1 and K2 on Hopper (sm_90a): the whole streamed Strang chain for one
// state (K1) or for a batch of states with per-member angles (K2), and
// the exact O(1)-memory adjoint of each.
//
// Replaces the TPU kernels of diffquantum_tpu/ops/fused_product.py:
//   K1 _make_forward_kernel    (fused_product.py:307, pallas_call :537)
//   K1 _make_backward_kernel   (fused_product.py:376, pallas_call :595)
//   K2 _make_forward_kernel_b  (fused_product.py:672, pallas_call :909)
//   K2 _make_backward_kernel_b (fused_product.py:733, pallas_call :965)
// behind fused_product_evolve / fused_product_evolve_batched and their
// custom VJPs. The Python wrappers and the plain PyTorch versions are
// diffquantum_tpu_torch/ops/fused_product.py.
//
// What it computes. Forward: T+1 merged phase stages with the ordered op
// plan of one Strang step between them,
//   psi_T = P(a_T) R_{T-1} P(a_{T-1}) ... R_0 P(a_0) psi_0,
//   a_0 = th_0, a_k = th_{k-1} + th_k, a_T = th_{T-1}   (merged rows),
// where P(a) multiplies by e^{-i a} elementwise and R_t applies the plan's
// ops in order: X (c x - i s G x), Y (c x + s K x) or hop (an X-type
// rotation on the {01,10} subspace of two bits). G is the gather at
// i ^ mask; qubit q has mask 1 << (n-1-q). Backward: runs the chain in
// reverse from (psi_T, lambda_T), rebuilding each earlier state by the
// inverse op (G^2 = I, K^2 = -I), and writes d theta_half [T, d] (the
// merged-row cotangents already summed back onto the half-step rows),
// d theta_x [T, n_ops] and dpsi_0. K2 does the same for each of B
// members, with the layouts of the JAX contract: psi [B, d], theta_half
// [T, G, d], theta_x [T, Gx, n_ops], d theta_half [T, B, d], d theta_x
// [T, B, n_ops]. G and Gx divide B: consecutive runs of B/G members read
// one phase row (G = B is the per-member contract; G < B lets the
// Monte-Carlo estimator's 2 n_Hs branches of one sample share their rows
// without a [T, B, d] table, which would be 1.5 GB at B = 3072, 12q).
//
// What bounds it on this card. Every op mixes amplitudes across the whole
// state, so the T * (n_ops + 1) passes form one dependent chain. At the
// main path's shape (12 qubits, T = 30, 12 ops) one forward call must move
// about 0.55 MB (the theta table plus psi in and out), about 0.16 us at
// 3.35 TB/s, and do about 10 MFLOP, about 0.15 us at 67 TFLOP/s fp32: the
// card's rates allow well under a microsecond. What it takes instead is
// the latency of ~400 dependent passes, each a round of shared-memory
// loads and stores plus a block barrier. The chain is latency-bound, per
// member: K2's members are independent chains.
//
// What the design does about it. One thread block per state carries the
// whole chain: the sequential TPU grid becomes a loop inside the block,
// with __syncthreads() between passes, and the state never leaves the SM.
// The planes live in shared memory while they fit (forward 2 planes = 8*d
// bytes, up to 14 qubits; backward 4 planes = 16*d bytes, up to 13
// qubits; dynamic shared memory above 48 KB); past that they stay in
// global memory, where a 17-qubit state (1 MiB per plane pair) remains
// L2-resident. Each op updates its amplitude pairs in place, so no second
// buffer is needed. Rotation angles are turned into (cos, sin) once per
// stage by the first threads, during the phase pass that precedes them.
// Each d theta_x entry is a fixed-order block reduction (warp shuffles,
// then one warp over the per-warp partials), never an atomic. K2 is the
// same block code with one block per member (grid dimension B): block b
// offsets every pointer by its member's strides, so K1 is K2 at B = 1 and
// both launch through dq_forward / dq_backward.
// At B >= 132 the grid fills the H100's SMs; past that the members run in
// waves. Cross-block cooperative designs and cp.async prefetch of the
// theta rows are left for later work.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxOps = 128;
constexpr int kFwdSmemMaxQubits = 14;
constexpr int kBwdSmemMaxQubits = 13;

enum OpKind : int { kX = 0, kY = 1, kHop = 2 };

// The op plan of one Strang step, plus the (cos, sin) of the current
// stage's angles.
struct OpTable {
  int slot[kMaxOps];
  int kind[kMaxOps];
  unsigned ma[kMaxOps];
  unsigned mb[kMaxOps];
  float c[kMaxOps];
  float s[kMaxOps];
};

// Where member b = blockIdx.x finds its rows. Theta rows are shared by
// runs of B/groups consecutive members; state and gradient rows are the
// member's own.
struct Member {
  size_t th_off, th_rs;   // theta_half: member offset, step stride
  size_t tx_off, tx_rs;   // theta_x
  size_t st_off;          // psi / outputs / scratch: b * d
  size_t gth_rs, gtx_off, gtx_rs;  // d theta_half [T, B, d], d theta_x
};

__device__ __forceinline__ Member member_of(int B, int th_groups,
                                            int tx_groups, size_t d,
                                            int n_ops) {
  const size_t b = blockIdx.x;
  Member m;
  m.th_off = (b / (size_t)(B / th_groups)) * d;
  m.th_rs = (size_t)th_groups * d;
  m.tx_off = (b / (size_t)(B / tx_groups)) * n_ops;
  m.tx_rs = (size_t)tx_groups * n_ops;
  m.st_off = b * d;
  m.gth_rs = (size_t)B * d;
  m.gtx_off = b * n_ops;
  m.gtx_rs = (size_t)B * n_ops;
  return m;
}

__device__ __forceinline__ unsigned insert_zero(unsigned p, unsigned m) {
  // insert a 0 bit at the position of the single-bit mask m
  return ((p & ~(m - 1u)) << 1) | (p & (m - 1u));
}

// Amplitude pair (i, j) number p of op o. X/Y: i has the flipped bit 0.
// Hop: i has (qi, qj) bits (0, 1), j has (1, 0).
__device__ __forceinline__ void pair_of(int kind, unsigned ma, unsigned mb,
                                        unsigned p, unsigned& i,
                                        unsigned& j) {
  if (kind == kHop) {
    const unsigned lo = ma < mb ? ma : mb;
    const unsigned hi = ma < mb ? mb : ma;
    const unsigned base = insert_zero(insert_zero(p, lo), hi);
    i = base | mb;
    j = base | ma;
  } else {
    i = insert_zero(p, ma);
    j = i | ma;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// merged phase angle a_k[i] from the half-step rows (row stride rs;
// bitwise equal to the host-side merge_phase_rows)
__device__ __forceinline__ float merged_angle(const float* __restrict__ th,
                                              int k, int T, size_t rs,
                                              unsigned i) {
  if (k == 0) return __ldg(th + i);
  if (k == T) return __ldg(th + (size_t)(k - 1) * rs + i);
  return __ldg(th + (size_t)(k - 1) * rs + i) + __ldg(th + (size_t)k * rs + i);
}

__device__ __forceinline__ void load_plan(OpTable& tab,
                                          const int* __restrict__ ops,
                                          int n_ops) {
  for (int o = threadIdx.x; o < n_ops; o += kThreads) {
    tab.slot[o] = ops[4 * o];
    tab.kind[o] = ops[4 * o + 1];
    tab.ma[o] = (unsigned)ops[4 * o + 2];
    tab.mb[o] = (unsigned)ops[4 * o + 3];
  }
}

// (cos, sin) of step k's rotation angles (row stride rs); thread o
// handles op o, the same thread that loaded the op's row.
__device__ __forceinline__ void load_angles(OpTable& tab,
                                            const float* __restrict__ tx,
                                            int k, size_t rs, int n_ops) {
  for (int o = threadIdx.x; o < n_ops; o += kThreads)
    sincosf(__ldg(tx + (size_t)k * rs + tab.slot[o]), &tab.s[o], &tab.c[o]);
}

template <bool kSmem>
__global__ void __launch_bounds__(kThreads, 1)
forward_kernel(const float* __restrict__ th, const float* __restrict__ tx,
               const float* __restrict__ p_re,
               const float* __restrict__ p_im, const int* __restrict__ ops,
               float* o_re, float* o_im, int n, int T, int n_ops, int B,
               int th_groups, int tx_groups) {
  extern __shared__ float dyn[];
  __shared__ OpTable tab;
  const unsigned d = 1u << n;
  const unsigned tid = threadIdx.x;
  const Member m = member_of(B, th_groups, tx_groups, d, n_ops);
  th += m.th_off;
  tx += m.tx_off;
  p_re += m.st_off;
  p_im += m.st_off;
  o_re += m.st_off;
  o_im += m.st_off;
  float* re = kSmem ? dyn : o_re;
  float* im = kSmem ? dyn + d : o_im;

  for (unsigned i = tid; i < d; i += kThreads) {
    re[i] = p_re[i];
    im[i] = p_im[i];
  }
  load_plan(tab, ops, n_ops);

  for (int k = 0; k <= T; ++k) {
    // the previous stage's rotations ended at a barrier, so its (cos, sin)
    // slots are free; they are read after this phase pass's barrier
    if (k < T) load_angles(tab, tx, k, m.tx_rs, n_ops);
    for (unsigned i = tid; i < d; i += kThreads) {
      float s, c;
      sincosf(merged_angle(th, k, T, m.th_rs, i), &s, &c);
      const float xr = re[i], xi = im[i];
      re[i] = c * xr + s * xi;
      im[i] = c * xi - s * xr;
    }
    __syncthreads();
    if (k == T) break;
    for (int o = 0; o < n_ops; ++o) {
      const int kind = tab.kind[o];
      const unsigned ma = tab.ma[o], mb = tab.mb[o];
      const float c = tab.c[o], s = tab.s[o];
      const unsigned n_pairs = kind == kHop ? d >> 2 : d >> 1;
      for (unsigned p = tid; p < n_pairs; p += kThreads) {
        unsigned i, j;
        pair_of(kind, ma, mb, p, i, j);
        const float ar = re[i], ai = im[i], br = re[j], bi = im[j];
        if (kind == kY) {
          re[i] = c * ar - s * br;
          im[i] = c * ai - s * bi;
          re[j] = c * br + s * ar;
          im[j] = c * bi + s * ai;
        } else {
          re[i] = c * ar + s * bi;
          im[i] = c * ai - s * br;
          re[j] = c * br + s * ai;
          im[j] = c * bi - s * ar;
        }
      }
      __syncthreads();
    }
  }
  if (kSmem) {
    for (unsigned i = tid; i < d; i += kThreads) {
      o_re[i] = re[i];
      o_im[i] = im[i];
    }
  }
}

template <bool kSmem>
__global__ void __launch_bounds__(kThreads, 1)
backward_kernel(const float* __restrict__ th, const float* __restrict__ tx,
                const float* __restrict__ pT_re,
                const float* __restrict__ pT_im,
                const float* __restrict__ lT_re,
                const float* __restrict__ lT_im,
                const int* __restrict__ ops, float* g_th, float* g_tx,
                float* gp_re, float* gp_im, float* y_re_g, float* y_im_g,
                int n, int T, int n_ops, int B, int th_groups,
                int tx_groups) {
  extern __shared__ float dyn[];
  __shared__ OpTable tab;
  __shared__ float red[2][kWarps];
  const unsigned d = 1u << n;
  const unsigned tid = threadIdx.x;
  const unsigned lane = tid & 31u, warp = tid >> 5;
  const Member m = member_of(B, th_groups, tx_groups, d, n_ops);
  th += m.th_off;
  tx += m.tx_off;
  pT_re += m.st_off;
  pT_im += m.st_off;
  lT_re += m.st_off;
  lT_im += m.st_off;
  gp_re += m.st_off;
  gp_im += m.st_off;
  g_th += m.st_off;
  g_tx += m.gtx_off;
  // y: the state being rebuilt; l: its cotangent (ends as dpsi_0)
  float* yr = kSmem ? dyn : y_re_g + m.st_off;
  float* yi = kSmem ? dyn + d : y_im_g + m.st_off;
  float* lr = kSmem ? dyn + 2 * d : gp_re;
  float* li = kSmem ? dyn + 3 * d : gp_im;

  for (unsigned i = tid; i < d; i += kThreads) {
    yr[i] = pT_re[i];
    yi[i] = pT_im[i];
    lr[i] = lT_re[i];
    li[i] = lT_im[i];
  }
  load_plan(tab, ops, n_ops);
  __syncthreads();

  int buf = 0;
  for (int k = T; k >= 0; --k) {
    // undo stage k's rotations (stage T has none), last op first
    for (int o = (k < T ? n_ops : 0) - 1; o >= 0; --o) {
      const int kind = tab.kind[o];
      const unsigned ma = tab.ma[o], mb = tab.mb[o];
      const float c = tab.c[o], s = tab.s[o];
      const unsigned n_pairs = kind == kHop ? d >> 2 : d >> 1;
      float g = 0.f;
      for (unsigned p = tid; p < n_pairs; p += kThreads) {
        unsigned i, j;
        pair_of(kind, ma, mb, p, i, j);
        const float yar = yr[i], yai = yi[i], ybr = yr[j], ybi = yi[j];
        const float lar = lr[i], lai = li[i], lbr = lr[j], lbi = li[j];
        float xar, xai, xbr, xbi, nar, nai, nbr, nbi;
        if (kind == kY) {
          // x = c y - s K y; lam_x = c lam - s K lam; dy/dth = -s x + c K x
          xar = c * yar + s * ybr;
          xbr = c * ybr - s * yar;
          xai = c * yai + s * ybi;
          xbi = c * ybi - s * yai;
          g += lar * (-s * xar - c * xbr) + lbr * (-s * xbr + c * xar)
             + lai * (-s * xai - c * xbi) + lbi * (-s * xbi + c * xai);
          nar = c * lar + s * lbr;
          nbr = c * lbr - s * lar;
          nai = c * lai + s * lbi;
          nbi = c * lbi - s * lai;
        } else {
          // x = c y + i s G y; lam_x = c lam + i s G lam;
          // dy/dth = -s x - i c G x
          xar = c * yar - s * ybi;
          xai = c * yai + s * ybr;
          xbr = c * ybr - s * yai;
          xbi = c * ybi + s * yar;
          g += lar * (-s * xar + c * xbi) + lai * (-s * xai - c * xbr)
             + lbr * (-s * xbr + c * xai) + lbi * (-s * xbi - c * xar);
          nar = c * lar - s * lbi;
          nai = c * lai + s * lbr;
          nbr = c * lbr - s * lai;
          nbi = c * lbi + s * lar;
        }
        yr[i] = xar; yi[i] = xai; yr[j] = xbr; yi[j] = xbi;
        lr[i] = nar; li[i] = nai; lr[j] = nbr; li[j] = nbi;
      }
      g = warp_sum(g);
      if (lane == 0) red[buf][warp] = g;
      __syncthreads();
      // warp 0 folds the per-warp partials while the others move on; the
      // next op writes the other buffer, and the one after that is two
      // barriers away
      if (warp == 0) {
        const float v = warp_sum(red[buf][lane]);
        if (lane == 0) g_tx[(size_t)k * m.gtx_rs + tab.slot[o]] = v;
      }
      buf ^= 1;
    }
    // step k-1's angles, read after this pass's barrier
    if (k > 0) load_angles(tab, tx, k - 1, m.tx_rs, n_ops);
    // undo the merged phase a_k; its cotangent row feeds half-step rows
    // k-1 and k (row k already holds stage k+1's share, written by this
    // same thread)
    for (unsigned i = tid; i < d; i += kThreads) {
      float s, c;
      sincosf(merged_angle(th, k, T, m.th_rs, i), &s, &c);
      const float y0 = yr[i], y1 = yi[i], l0 = lr[i], l1 = li[i];
      const float g = l0 * y1 - l1 * y0;
      if (k < T) g_th[(size_t)k * m.gth_rs + i] += g;
      if (k > 0) g_th[(size_t)(k - 1) * m.gth_rs + i] = g;
      yr[i] = c * y0 - s * y1;
      yi[i] = s * y0 + c * y1;
      lr[i] = c * l0 - s * l1;
      li[i] = s * l0 + c * l1;
    }
    __syncthreads();
  }
  if (kSmem) {
    for (unsigned i = tid; i < d; i += kThreads) {
      gp_re[i] = lr[i];
      gp_im[i] = li[i];
    }
  }
}

bool bad_shape(int n_qubits, int n_steps, int n_ops, int B, int th_groups,
               int tx_groups) {
  return n_qubits < 2 || n_qubits > 24 || n_steps < 1 || n_ops < 0 ||
         n_ops > kMaxOps || B < 1 || th_groups < 1 || tx_groups < 1 ||
         B % th_groups != 0 || B % tx_groups != 0;
}

}  // namespace

extern "C" {

// B states [B, d] (K1: B = 1); theta_half [T, th_groups, d], theta_x
// [T, tx_groups, n_ops], each group serving B / groups consecutive
// members. Writes the final states [B, d].
int dq_forward(const float* th, const float* tx, const float* p_re,
               const float* p_im, const int* ops, float* o_re, float* o_im,
               int n_qubits, int n_steps, int n_ops, int B, int th_groups,
               int tx_groups, void* stream) {
  if (bad_shape(n_qubits, n_steps, n_ops, B, th_groups, tx_groups))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t d = size_t(1) << n_qubits;
  if (n_qubits <= kFwdSmemMaxQubits) {
    const size_t bytes = 2 * d * sizeof(float);
    cudaError_t e = cudaFuncSetAttribute(
        forward_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
    forward_kernel<true><<<B, kThreads, bytes, st>>>(
        th, tx, p_re, p_im, ops, o_re, o_im, n_qubits, n_steps, n_ops, B,
        th_groups, tx_groups);
  } else {
    forward_kernel<false><<<B, kThreads, 0, st>>>(
        th, tx, p_re, p_im, ops, o_re, o_im, n_qubits, n_steps, n_ops, B,
        th_groups, tx_groups);
  }
  return (int)cudaGetLastError();
}

// Same layouts; from the final states and their cotangents writes dpsi_0
// [B, d], d theta_half [T, B, d] and d theta_x [T, B, n_ops] per member.
// y_re/y_im: scratch planes [B, d], needed above kBwdSmemMaxQubits (may
// be null below it).
int dq_backward(const float* th, const float* tx, const float* pT_re,
                const float* pT_im, const float* l_re, const float* l_im,
                const int* ops, float* g_th, float* g_tx, float* gp_re,
                float* gp_im, float* y_re, float* y_im, int n_qubits,
                int n_steps, int n_ops, int B, int th_groups, int tx_groups,
                void* stream) {
  if (bad_shape(n_qubits, n_steps, n_ops, B, th_groups, tx_groups))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t d = size_t(1) << n_qubits;
  if (n_qubits <= kBwdSmemMaxQubits) {
    const size_t bytes = 4 * d * sizeof(float);
    cudaError_t e = cudaFuncSetAttribute(
        backward_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
    backward_kernel<true><<<B, kThreads, bytes, st>>>(
        th, tx, pT_re, pT_im, l_re, l_im, ops, g_th, g_tx, gp_re, gp_im,
        nullptr, nullptr, n_qubits, n_steps, n_ops, B, th_groups,
        tx_groups);
  } else {
    if (y_re == nullptr || y_im == nullptr)
      return (int)cudaErrorInvalidValue;
    backward_kernel<false><<<B, kThreads, 0, st>>>(
        th, tx, pT_re, pT_im, l_re, l_im, ops, g_th, g_tx, gp_re, gp_im,
        y_re, y_im, n_qubits, n_steps, n_ops, B, th_groups, tx_groups);
  }
  return (int)cudaGetLastError();
}

const char* dq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
