// K3, K5 and K6 on Hopper (sm_90a): the packed-phase Strang chain over a
// state in global memory, and its exact O(1)-memory adjoint.
//
// Replaces the TPU kernels
//   K3 _make_forward_kernel_pk   (diffquantum_tpu/ops/fused_product.py:1285,
//                                 pallas_call :1572)
//   K3 _make_backward_kernel_pk  (fused_product.py:1364, pallas_call :1638)
//   K5 _make_mega_fwd            (diffquantum_tpu/ops/fused_chunked.py:695,
//                                 pallas_call :932 single, :1117 batched)
//   K5 _make_mega_bwd            (fused_chunked.py:766, :980, :1166)
//   K6 _make_mega_hop_fwd        (diffquantum_tpu/ops/fused_mega_hop.py:612,
//                                 pallas_call :921 single, :1052 batched)
//   K6 _make_mega_hop_bwd        (fused_mega_hop.py:685, :964, :1096)
// behind fused_product_evolve_packed, chunked_evolve_mega(_batched) and
// chunked_evolve_mega_hop(_batched). K3 and K5 compute one function; on
// the TPU they differ only in how the state meets VMEM. K6 is another
// integrator (a palindromic A/B schedule: each step's ops at half angle
// forward, then reversed), which these kernels run as op rows that carry
// a scale: a row rotates by scale * theta_x[slot], a slot may have several
// rows, and its gradient is the sum of its rows' scaled partials. The
// Python wrappers and the plain PyTorch versions are
// diffquantum_tpu_torch/ops/fused_product.py (_packed_forward_cuda,
// _packed_backward_cuda, _packed_core), ops/fused_chunked.py and
// ops/fused_mega_hop.py.
//
// What it computes. States [B, d], d = 2^n, re/im planes. T+1 stages; stage
// s multiplies amplitude j by e^{-i theta_s(j)},
//   theta_s(j) = m_s h0th[j] + off_s + sum_k a_sk (1 - 2 bit_k(j)),
// from the merged row [a_s0 .. a_s,n_diag-1, off_s, m_s] of member b and
// the sign bit-planes (bit k%30 of plane k//30), then, for s < T, applies
// step s's ordered op rows: X (c x - i s G x), Y (c x + s K x) or hop (an
// X-type rotation on the {01,10} pairs of two bits), each by the angle
// scale * theta_x[s, b, slot] (scale 1 for K3/K5, 1/2 or 1 for K6). The
// backward runs the
// stages in reverse from (psi_T, lambda_T), rebuilding each earlier state
// by the inverse op (G^2 = I, K^2 = -I), and reduces the cotangents to
// d theta_x [T, B, n_x] (per slot, the sum of its rows' partials times
// their scales) and the merged rows' [T+1, B, n_diag+1]:
// S0 - 2 S_k for slot k and S0 for the offset slot, where
// S0 = sum_j g_j, S_k = sum_j g_j bit_k(j), g = lam_re y_im - lam_im y_re.
//
// What bounds it on this card. From 18 qubits up the state (2-128 MB per
// member, twice that with lambda) lives in global memory: an 18-qubit
// state fits the H100's 50 MB L2, a 24-qubit one does not. The function
// itself needs ~12 fp32 operations per amplitude pair per op and ~10 plus
// 2 per diagonal term per amplitude per stage, which bounds it by
// operations (chip_smoke.py::packed_bound, at the H100 SXM data sheet's
// 67 TFLOP/s and 3.35 TB/s); but each pass of this design reads and
// writes the whole state, ~20 GB per 30-step forward at 24 qubits, so
// there the card's memory bandwidth sets the time. At 18 qubits the
// ~2T+1 dependent launches, each a few microseconds of work, set it.
//
// What the design does about it. Each stage is a few passes, each one
// launch spread over the whole card (grid: blocks x B members), with the
// pass's amplitudes staged in shared memory:
//  - a tile pass: block bi holds 2^k consecutive amplitudes (the low k
//    bits, qubits n-k..n-1). It computes each amplitude's phase from the
//    sign planes and the member's row in shared memory, then applies the
//    step's ops on those bits with a barrier between ops, and writes back;
//  - a strided pass: block bi holds all 2^(n-k) rows (the high bits) of
//    2^lc consecutive low-bit columns, each row read as one 2^lc-float
//    segment, and applies the step's ops on the high bits;
//  - a cross pass: an op with one bit on each side (a hop across the tile
//    boundary), applied pair by pair straight from global memory.
// The host groups one step's ordered ops into these passes, moving an op
// only past ops on disjoint bits (ops/fused_product.py::_pass_plan), so
// the ring MaxCut's X drives take one tile and one strided pass per step,
// as K5's passes A and B do, and the chain is ~2T+1 launches. The
// backward mirrors each pass in reverse, carrying lambda beside y. Each
// block writes its partial sums (one per op, and S_k and S0 for the tile
// pass) to a [T+1, B, ...] buffer; a last launch sums them in a fixed
// order (no atomics), so the gradients are deterministic: per slot, its
// locations in plan order. Offsets are size_t: B*d passes 2^31 at 24
// qubits from B = 128 up. K6's hops cross the tile/strided split more
// often than K5's X drives, so its steps take more passes (15 per stage
// for the 20-qubit molecule drive set, 32 at 24 qubits), each bound like
// K5's.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kMaxOps = 128;
constexpr int kOpCols = 5;  // slot, kind, mask a, mask b, scale in halves
constexpr int kMaxDiag = 120;
constexpr int kPlaneBits = 30;
constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kCrossThreads = 256;
constexpr size_t kMaxDataBytes = 128 * 1024;

enum OpKind : int { kX = 0, kY = 1, kHop = 2 };
enum PassKind : int { kTile = 0, kStrided = 1, kCross = 2 };

// one row of the host's pass table
struct Pass {
  int kind, op_begin, op_count, blocks, part_off, part_width;
};

// what every pass launch reads
struct Chain {
  const float* udm;    // [T+1, B, n_diag + 2] merged stage rows
  const float* tx;     // [T, B, n_x] rotation angles
  const float* h0th;   // [d] drift half-angles
  const int* planes;   // [P, d] sign bit-planes
  int n, k, T, B, n_diag, P, n_x;
};

// a pass's op table, its rows' scales and the (cos, sin) of their angles
// for this member
struct OpTable {
  int slot[kMaxOps];
  int kind[kMaxOps];
  unsigned ma[kMaxOps];
  unsigned mb[kMaxOps];
  float scale[kMaxOps];
  float c[kMaxOps];
  float s[kMaxOps];
};

__device__ __forceinline__ float row_scale(const int* op) {
  return 0.5f * (float)op[4];
}

// a stage's merged row, and off + sum_k a_k
struct StageRow {
  float a[kMaxDiag + 2];
  float base;
};

__device__ __forceinline__ unsigned insert_zero(unsigned p, unsigned m) {
  return ((p & ~(m - 1u)) << 1) | (p & (m - 1u));
}

// Amplitude pair (i, j) number p of an op. X/Y: i has the bit 0. Hop: i has
// the (ma, mb) bits (0, 1), j has (1, 0).
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

// global amplitude index of local slot l of block bi: columns are the low
// lc bits of l, rows the bits above them, each row 2^k amplitudes apart
// (a tile pass has lc = k and one row)
__device__ __forceinline__ size_t amp_index(unsigned bi, unsigned l, int k,
                                            int lc) {
  return ((size_t)bi << lc) + (l & ((1u << lc) - 1u)) +
         ((size_t)(l >> lc) << k);
}

// The pass's ops and angles, and with a phase the stage row; ends with a
// barrier.
__device__ void load_pass(OpTable& tab, StageRow& row, const Chain& ch,
                          const int* __restrict__ ops, int n_ops, int stage,
                          bool phase) {
  const unsigned b = blockIdx.y;
  const float* tx = ch.tx + ((size_t)stage * ch.B + b) * ch.n_x;
  for (int o = threadIdx.x; o < n_ops; o += blockDim.x) {
    const int* op = ops + kOpCols * o;
    tab.slot[o] = op[0];
    tab.kind[o] = op[1];
    tab.ma[o] = (unsigned)op[2];
    tab.mb[o] = (unsigned)op[3];
    tab.scale[o] = row_scale(op);
    sincosf(tab.scale[o] * __ldg(tx + tab.slot[o]), &tab.s[o], &tab.c[o]);
  }
  if (phase) {
    const float* u = ch.udm + ((size_t)stage * ch.B + b) * (ch.n_diag + 2);
    for (int i = threadIdx.x; i < ch.n_diag + 2; i += blockDim.x)
      row.a[i] = __ldg(u + i);
  }
  __syncthreads();
  if (phase && threadIdx.x == 0) {
    float base = row.a[ch.n_diag];
    for (int i = 0; i < ch.n_diag; ++i) base += row.a[i];
    row.base = base;
  }
  __syncthreads();
}

// theta_s(j) = m h0th[j] + (off + sum_k a_k) - 2 sum_{k: bit set} a_k
__device__ __forceinline__ float stage_angle(const StageRow& row,
                                             const Chain& ch, size_t j) {
  const size_t d = (size_t)1 << ch.n;
  float t = 0.f;
  for (int p = 0; p * kPlaneBits < ch.n_diag; ++p) {
    const int nb = min(kPlaneBits, ch.n_diag - p * kPlaneBits);
    unsigned w = (unsigned)__ldg(ch.planes + (size_t)p * d + j) &
                 ((1u << nb) - 1u);
    while (w) {
      t += row.a[p * kPlaneBits + __ffs(w) - 1];
      w &= w - 1u;
    }
  }
  return row.a[ch.n_diag + 1] * __ldg(ch.h0th + j) + row.base - 2.f * t;
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// A tile or strided pass: gather 2^l_bits amplitudes of member blockIdx.y,
// apply the stage phase (tile pass) and the ops, scatter back.
__global__ void __launch_bounds__(kMaxThreads)
pass_forward(float* re, float* im, Chain ch, const int* __restrict__ ops,
             int n_ops, int stage, int lc, int l_bits, int phase) {
  extern __shared__ float dyn[];
  __shared__ OpTable tab;
  __shared__ StageRow row;
  const size_t d = (size_t)1 << ch.n;
  const unsigned L = 1u << l_bits, bi = blockIdx.x, tid = threadIdx.x;
  re += blockIdx.y * d;
  im += blockIdx.y * d;
  float* sr = dyn;
  float* si = dyn + L;
  load_pass(tab, row, ch, ops, n_ops, stage, phase != 0);

  for (unsigned l = tid; l < L; l += blockDim.x) {
    const size_t j = amp_index(bi, l, ch.k, lc);
    float xr = re[j], xi = im[j];
    if (phase) {
      float s, c;
      sincosf(stage_angle(row, ch, j), &s, &c);
      const float r = c * xr + s * xi;
      xi = c * xi - s * xr;
      xr = r;
    }
    sr[l] = xr;
    si[l] = xi;
  }
  __syncthreads();
  for (int o = 0; o < n_ops; ++o) {
    const int kind = tab.kind[o];
    const unsigned ma = tab.ma[o], mb = tab.mb[o];
    const float c = tab.c[o], s = tab.s[o];
    const unsigned n_pairs = kind == kHop ? L >> 2 : L >> 1;
    for (unsigned p = tid; p < n_pairs; p += blockDim.x) {
      unsigned i, j;
      pair_of(kind, ma, mb, p, i, j);
      const float ar = sr[i], ai = si[i], br = sr[j], bi_ = si[j];
      if (kind == kY) {
        sr[i] = c * ar - s * br;
        si[i] = c * ai - s * bi_;
        sr[j] = c * br + s * ar;
        si[j] = c * bi_ + s * ai;
      } else {
        sr[i] = c * ar + s * bi_;
        si[i] = c * ai - s * br;
        sr[j] = c * br + s * ai;
        si[j] = c * bi_ - s * ar;
      }
    }
    __syncthreads();
  }
  for (unsigned l = tid; l < L; l += blockDim.x) {
    const size_t j = amp_index(bi, l, ch.k, lc);
    re[j] = sr[l];
    im[j] = si[l];
  }
}

// A cross pass: one op with its global masks, pair by pair from global
// memory (grid-stride over the pairs of member blockIdx.y).
__global__ void __launch_bounds__(kCrossThreads)
cross_forward(float* re, float* im, Chain ch, const int* __restrict__ op,
              int stage) {
  const size_t d = (size_t)1 << ch.n;
  re += blockIdx.y * d;
  im += blockIdx.y * d;
  const int kind = op[1];
  const unsigned ma = (unsigned)op[2], mb = (unsigned)op[3];
  float s, c;
  sincosf(row_scale(op) *
              __ldg(ch.tx + ((size_t)stage * ch.B + blockIdx.y) * ch.n_x +
                    op[0]),
          &s, &c);
  const unsigned n_pairs = (unsigned)(kind == kHop ? d >> 2 : d >> 1);
  for (unsigned p = blockIdx.x * blockDim.x + threadIdx.x; p < n_pairs;
       p += gridDim.x * blockDim.x) {
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
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// Undo one op on pair (i, j) of y and lambda; returns this pair's share of
// d theta = Re<lambda, dR/dtheta x>.
__device__ __forceinline__ float undo_pair(int kind, float c, float s,
                                           float* yr, float* yi, float* lr,
                                           float* li, unsigned i,
                                           unsigned j) {
  const float yar = yr[i], yai = yi[i], ybr = yr[j], ybi = yi[j];
  const float lar = lr[i], lai = li[i], lbr = lr[j], lbi = li[j];
  float xar, xai, xbr, xbi, nar, nai, nbr, nbi, g;
  if (kind == kY) {
    // x = c y - s K y; lam_x = c lam - s K lam; dy/dth = -s x + c K x
    xar = c * yar + s * ybr;
    xbr = c * ybr - s * yar;
    xai = c * yai + s * ybi;
    xbi = c * ybi - s * yai;
    g = lar * (-s * xar - c * xbr) + lbr * (-s * xbr + c * xar) +
        lai * (-s * xai - c * xbi) + lbi * (-s * xbi + c * xai);
    nar = c * lar + s * lbr;
    nbr = c * lbr - s * lar;
    nai = c * lai + s * lbi;
    nbi = c * lbi - s * lai;
  } else {
    // x = c y + i s G y; lam_x = c lam + i s G lam; dy/dth = -s x - i c G x
    xar = c * yar - s * ybi;
    xai = c * yai + s * ybr;
    xbr = c * ybr - s * yai;
    xbi = c * ybi + s * yar;
    g = lar * (-s * xar + c * xbi) + lai * (-s * xai - c * xbr) +
        lbr * (-s * xbr + c * xai) + lbi * (-s * xbi - c * xar);
    nar = c * lar - s * lbi;
    nai = c * lai + s * lbr;
    nbr = c * lbr - s * lai;
    nbi = c * lbi + s * lar;
  }
  yr[i] = xar; yi[i] = xai; yr[j] = xbr; yi[j] = xbi;
  lr[i] = nar; li[i] = nai; lr[j] = nbr; li[j] = nbi;
  return g;
}

// A tile or strided pass in reverse: gather y and lambda, undo the ops
// last first, then (tile pass) take the phase's partial sums and undo the
// phase, scatter back. Block partials go to
// part[((stage*B + b)*stride + part_off + bi*width + col]: one column per
// op (d angle times the row's scale), then S_0..S_{n_diag-1} and S0 from
// column diag_col.
__global__ void __launch_bounds__(kMaxThreads)
pass_backward(float* y_re, float* y_im, float* l_re, float* l_im, Chain ch,
              const int* __restrict__ ops, int n_ops, int stage, int lc,
              int l_bits, int phase, float* part, int stride, int part_off,
              int width, int diag_col) {
  extern __shared__ float dyn[];
  __shared__ OpTable tab;
  __shared__ StageRow row;
  __shared__ float wpart[kMaxOps + kMaxDiag + 1][kMaxWarps];
  const size_t d = (size_t)1 << ch.n;
  const unsigned L = 1u << l_bits, bi = blockIdx.x, tid = threadIdx.x;
  const unsigned lane = tid & 31u, warp = tid >> 5;
  const unsigned n_warps = blockDim.x >> 5;
  const size_t mo = blockIdx.y * d;
  y_re += mo; y_im += mo; l_re += mo; l_im += mo;
  float* yr = dyn;
  float* yi = dyn + L;
  float* lr = dyn + 2 * L;
  float* li = dyn + 3 * L;
  load_pass(tab, row, ch, ops, n_ops, stage, phase != 0);

  for (unsigned l = tid; l < L; l += blockDim.x) {
    const size_t j = amp_index(bi, l, ch.k, lc);
    yr[l] = y_re[j]; yi[l] = y_im[j];
    lr[l] = l_re[j]; li[l] = l_im[j];
  }
  __syncthreads();
  for (int o = n_ops - 1; o >= 0; --o) {
    const int kind = tab.kind[o];
    const unsigned ma = tab.ma[o], mb = tab.mb[o];
    const float c = tab.c[o], s = tab.s[o];
    const unsigned n_pairs = kind == kHop ? L >> 2 : L >> 1;
    float g = 0.f;
    for (unsigned p = tid; p < n_pairs; p += blockDim.x) {
      unsigned i, j;
      pair_of(kind, ma, mb, p, i, j);
      g += undo_pair(kind, c, s, yr, yi, lr, li, i, j);
    }
    g = warp_sum(g);
    if (lane == 0) wpart[o][warp] = g * tab.scale[o];
    __syncthreads();
  }
  if (phase) {
    // S_k, 30 sign bits (one plane) at a time; each thread reads only
    // the slots it also updates below, so no barrier is needed between
    for (int p = 0; p * kPlaneBits < ch.n_diag; ++p) {
      float acc[kPlaneBits];
#pragma unroll
      for (int q = 0; q < kPlaneBits; ++q) acc[q] = 0.f;
      for (unsigned l = tid; l < L; l += blockDim.x) {
        const size_t j = amp_index(bi, l, ch.k, lc);
        const float g = lr[l] * yi[l] - li[l] * yr[l];
        const unsigned w = (unsigned)__ldg(ch.planes + (size_t)p * d + j);
#pragma unroll
        for (int q = 0; q < kPlaneBits; ++q)
          acc[q] += ((w >> q) & 1u) ? g : 0.f;
      }
#pragma unroll
      for (int q = 0; q < kPlaneBits; ++q) {
        const float v = warp_sum(acc[q]);
        if (lane == 0 && p * kPlaneBits + q < ch.n_diag)
          wpart[kMaxOps + p * kPlaneBits + q][warp] = v;
      }
    }
    // S0, and undo the phase: x = e^{+i theta} y, lam_x = e^{+i theta} lam
    float s0 = 0.f;
    for (unsigned l = tid; l < L; l += blockDim.x) {
      const size_t j = amp_index(bi, l, ch.k, lc);
      const float y0 = yr[l], y1 = yi[l], l0 = lr[l], l1 = li[l];
      s0 += l0 * y1 - l1 * y0;
      float s, c;
      sincosf(stage_angle(row, ch, j), &s, &c);
      y_re[j] = c * y0 - s * y1;
      y_im[j] = s * y0 + c * y1;
      l_re[j] = c * l0 - s * l1;
      l_im[j] = s * l0 + c * l1;
    }
    s0 = warp_sum(s0);
    if (lane == 0) wpart[kMaxOps + ch.n_diag][warp] = s0;
  } else {
    for (unsigned l = tid; l < L; l += blockDim.x) {
      const size_t j = amp_index(bi, l, ch.k, lc);
      y_re[j] = yr[l]; y_im[j] = yi[l];
      l_re[j] = lr[l]; l_im[j] = li[l];
    }
  }
  __syncthreads();
  float* out = part + ((size_t)stage * ch.B + blockIdx.y) * stride +
               part_off + (size_t)bi * width;
  const int n_diag_cols = phase ? ch.n_diag + 1 : 0;
  for (int t = tid; t < n_ops + n_diag_cols; t += blockDim.x) {
    const int src = t < n_ops ? t : kMaxOps + (t - n_ops);
    float v = 0.f;
    for (unsigned w = 0; w < n_warps; ++w) v += wpart[src][w];
    out[t < n_ops ? t : diag_col + (t - n_ops)] = v;
  }
}

// A cross pass in reverse: one op from global memory, one partial per
// block (times the row's scale) at part[... + part_off + bi].
__global__ void __launch_bounds__(kCrossThreads)
cross_backward(float* y_re, float* y_im, float* l_re, float* l_im, Chain ch,
               const int* __restrict__ op, int stage, float* part,
               int stride, int part_off) {
  __shared__ float wpart[kCrossThreads / 32];
  const size_t d = (size_t)1 << ch.n;
  const size_t mo = blockIdx.y * d;
  y_re += mo; y_im += mo; l_re += mo; l_im += mo;
  const int kind = op[1];
  const unsigned ma = (unsigned)op[2], mb = (unsigned)op[3];
  const float scale = row_scale(op);
  float s, c;
  sincosf(scale *
              __ldg(ch.tx + ((size_t)stage * ch.B + blockIdx.y) * ch.n_x +
                    op[0]),
          &s, &c);
  const unsigned n_pairs = (unsigned)(kind == kHop ? d >> 2 : d >> 1);
  float g = 0.f;
  for (unsigned p = blockIdx.x * blockDim.x + threadIdx.x; p < n_pairs;
       p += gridDim.x * blockDim.x) {
    unsigned i, j;
    pair_of(kind, ma, mb, p, i, j);
    g += undo_pair(kind, c, s, y_re, y_im, l_re, l_im, i, j);
  }
  g = warp_sum(g);
  if ((threadIdx.x & 31u) == 0) wpart[threadIdx.x >> 5] = g;
  __syncthreads();
  if (threadIdx.x == 0) {
    float v = 0.f;
    for (int w = 0; w < kCrossThreads / 32; ++w) v += wpart[w];
    part[((size_t)stage * ch.B + blockIdx.y) * stride + part_off +
         blockIdx.x] = v * scale;
  }
}

// One warp per output: sums columns of block partials in a fixed order.
// Outputs: d theta_x [T, B, n_x], slot j summing the columns of its
// locations slots[n_x + 1 + 4 l ..] = (offset, blocks, width, column) for
// l in [slots[j], slots[j + 1]), in that order; then the merged rows'
// [T+1, B, n_diag+1] from the tile pass (offset 0, tile_blocks,
// tile_width, diag_col).
__global__ void reduce_partials(const float* __restrict__ part, int stride,
                                const int* __restrict__ slots, int T, int B,
                                int n_x, int n_diag, int tile_blocks,
                                int tile_width, int diag_col, float* gud,
                                float* gtx) {
  const size_t w = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const unsigned lane = threadIdx.x & 31u;
  const size_t n_tx = (size_t)T * B * n_x;
  const size_t n_ud = (size_t)(T + 1) * B * (n_diag + 1);
  if (w < n_tx) {
    const size_t sb = w / n_x;  // stage * B + member
    const int j = (int)(w % n_x);
    const int* loc = slots + n_x + 1;
    float v = 0.f;
    for (int l = slots[j]; l < slots[j + 1]; ++l) {
      const float* col = part + sb * stride + loc[4 * l] + loc[4 * l + 3];
      const int blocks = loc[4 * l + 1], width = loc[4 * l + 2];
      for (int i = lane; i < blocks; i += 32) v += col[(size_t)i * width];
    }
    v = warp_sum(v);
    if (lane == 0) gtx[w] = v;
  } else if (w < n_tx + n_ud) {
    const size_t u = w - n_tx;
    const size_t sb = u / (n_diag + 1);
    const int q = (int)(u % (n_diag + 1));
    const float* base = part + sb * stride + diag_col;
    float s0 = 0.f, sq = 0.f;
    for (int i = lane; i < tile_blocks; i += 32) {
      s0 += base[(size_t)i * tile_width + n_diag];
      if (q < n_diag) sq += base[(size_t)i * tile_width + q];
    }
    s0 = warp_sum(s0);
    sq = warp_sum(sq);
    if (lane == 0) gud[u] = q < n_diag ? s0 - 2.f * sq : s0;
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

int threads_for(unsigned l_bits) {
  const unsigned half = (1u << l_bits) >> 1;
  return half >= kMaxThreads ? kMaxThreads : (half < 32 ? 32 : (int)half);
}

// local size (log2) of a tile or strided pass, -1 if the row is wrong
int pass_l_bits(const Pass& ps, int n, int k, int lc) {
  if (ps.kind == kTile)
    return ps.blocks == (1 << (n - k)) ? k : -1;
  if (ps.kind == kStrided)
    return ps.blocks == (1 << (k - lc)) ? n - k + lc : -1;
  return -1;
}

bool bad_chain(const Pass* passes, int n_pass, int n, int k, int lc, int T,
               int B, int n_diag, int P, int n_x, int planes) {
  if (n < 2 || n > 24 || k < 1 || k > n || lc < 0 || lc > k || T < 1 ||
      B < 1 || B > 65535 || n_diag < 0 || n_diag > kMaxDiag || P < 1 ||
      P * kPlaneBits < n_diag || n_x < 0 || n_pass < 1 ||
      passes[0].kind != kTile)
    return true;
  for (int i = 0; i < n_pass; ++i) {
    const Pass& ps = passes[i];
    if (ps.op_count < 0 || ps.op_count > kMaxOps || ps.blocks < 1)
      return true;
    if (ps.kind == kCross) {
      if (ps.op_count != 1) return true;
      continue;
    }
    const int lb = pass_l_bits(ps, n, k, lc);
    if (lb < 0 || ((size_t)planes * sizeof(float) << lb) > kMaxDataBytes)
      return true;
  }
  return false;
}

}  // namespace

extern "C" {

// Forward chain over B states [B, d], updated in place in (re, im), which
// hold psi_0 on entry and psi_T on return. passes: host table [n_pass, 6]
// (kind, first op row, op count, blocks, partial offset, partial width);
// ops: device op rows [n_ops, 5] (slot, kind, local mask a, local mask b,
// scale in halves); tx: [T, B, n_x], n_x angle slots.
int dq_pk_forward(float* re, float* im, const float* udm, const float* tx,
                  const float* h0th, const int* planes, const int* ops,
                  const int* passes, int n_pass, int n, int k, int lc, int T,
                  int B, int n_diag, int P, int n_x, void* stream) {
  const Pass* ps = reinterpret_cast<const Pass*>(passes);
  if (bad_chain(ps, n_pass, n, k, lc, T, B, n_diag, P, n_x, 2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaFuncSetAttribute(
      pass_forward, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kMaxDataBytes);
  if (e != cudaSuccess) return (int)e;
  const Chain ch{udm, tx, h0th, planes, n, k, T, B, n_diag, P, n_x};
  for (int s = 0; s <= T; ++s) {
    for (int i = 0; i < n_pass; ++i) {
      if (s == T && i > 0) break;  // the last stage is its phase alone
      const Pass& p = ps[i];
      const int* op = ops + kOpCols * p.op_begin;
      if (p.kind == kCross) {
        cross_forward<<<dim3(p.blocks, B), kCrossThreads, 0, st>>>(
            re, im, ch, op, s);
      } else {
        const int lb = pass_l_bits(p, n, k, lc);
        const size_t smem = (size_t)2 * sizeof(float) << lb;
        pass_forward<<<dim3(p.blocks, B), threads_for(lb), smem, st>>>(
            re, im, ch, op, s < T ? p.op_count : 0, s,
            p.kind == kTile ? k : lc, lb, i == 0);
      }
      e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
  }
  return 0;
}

// Adjoint chain: (y, l) hold (psi_T, lambda_T) on entry and (psi_0,
// dpsi_0) on return. part: scratch [T+1, B, stride] floats of block
// partials; slots: device int table, n_x + 1 offsets into the locations
// that follow, each (offset, blocks, width, column) of one row of the
// slot (see reduce_partials). Writes gud [T+1, B, n_diag+1] (merged-row
// cotangents) and gtx [T, B, n_x].
int dq_pk_backward(float* y_re, float* y_im, float* l_re, float* l_im,
                   const float* udm, const float* tx, const float* h0th,
                   const int* planes, const int* ops, const int* passes,
                   float* part, const int* slots, float* gud, float* gtx,
                   int n_pass, int stride, int n, int k, int lc, int T,
                   int B, int n_diag, int P, int n_x, void* stream) {
  const Pass* ps = reinterpret_cast<const Pass*>(passes);
  if (bad_chain(ps, n_pass, n, k, lc, T, B, n_diag, P, n_x, 4) ||
      stride < 1 || ps[0].part_off != 0 ||
      ps[0].part_width != ps[0].op_count + n_diag + 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaFuncSetAttribute(
      pass_backward, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kMaxDataBytes);
  if (e != cudaSuccess) return (int)e;
  const Chain ch{udm, tx, h0th, planes, n, k, T, B, n_diag, P, n_x};
  for (int s = T; s >= 0; --s) {
    for (int i = n_pass - 1; i >= 0; --i) {
      if (s == T && i > 0) continue;  // the last stage is its phase alone
      const Pass& p = ps[i];
      const int* op = ops + kOpCols * p.op_begin;
      if (p.kind == kCross) {
        cross_backward<<<dim3(p.blocks, B), kCrossThreads, 0, st>>>(
            y_re, y_im, l_re, l_im, ch, op, s, part, stride, p.part_off);
      } else {
        const int lb = pass_l_bits(p, n, k, lc);
        const size_t smem = (size_t)4 * sizeof(float) << lb;
        pass_backward<<<dim3(p.blocks, B), threads_for(lb), smem, st>>>(
            y_re, y_im, l_re, l_im, ch, op, s < T ? p.op_count : 0, s,
            p.kind == kTile ? k : lc, lb, i == 0, part, stride, p.part_off,
            p.part_width, p.op_count);
      }
      e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
  }
  const size_t warps = (size_t)T * B * n_x + (size_t)(T + 1) * B * (n_diag + 1);
  const int threads = 256;
  reduce_partials<<<(unsigned)((warps * 32 + threads - 1) / threads), threads,
                    0, st>>>(part, stride, slots, T, B, n_x, n_diag,
                             ps[0].blocks, ps[0].part_width,
                             ps[0].op_count, gud, gtx);
  return (int)cudaGetLastError();
}

const char* dq_pk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
