// K3, K4, K5 and K6 on Hopper (sm_90a): the packed-phase Strang chain over
// a state in global memory, and its exact O(1)-memory adjoint.
//
// Replaces the TPU kernels
//   K3 _make_forward_kernel_pk   (diffquantum_tpu/ops/fused_product.py:1285,
//                                 pallas_call :1572)
//   K3 _make_backward_kernel_pk  (fused_product.py:1364, pallas_call :1638)
//   K4 _make_passA_fwd/_passB_fwd, _make_passA_bwd/_passB_bwd
//                                (diffquantum_tpu/ops/fused_chunked.py:202,
//                                 :216, :327, :356; pallas_call :401-:484)
//   K5 _make_mega_fwd            (fused_chunked.py:695, pallas_call :932
//                                 single, :1117 batched)
//   K5 _make_mega_bwd            (fused_chunked.py:766, :980, :1166)
//   K6 _make_mega_hop_fwd        (diffquantum_tpu/ops/fused_mega_hop.py:612,
//                                 pallas_call :921 single, :1052 batched)
//   K6 _make_mega_hop_bwd        (fused_mega_hop.py:685, :964, :1096)
// behind fused_product_evolve_packed, chunked_evolve,
// chunked_evolve_mega(_batched) and chunked_evolve_mega_hop(_batched). K3,
// K4 and K5 compute one function; on the TPU they differ only in how the
// state meets VMEM. K6 is another integrator (a palindromic A/B schedule:
// each step's ops at half angle forward, then reversed), which these
// kernels run as op rows that carry a scale: a row rotates by scale *
// theta_x[slot], a slot may have several rows, and its gradient is the sum
// of its rows' scaled partials. The Python wrappers, the launch plan
// (pk_plan) and the plain PyTorch versions are
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
// scale * theta_x[s, b, slot] (scale 1 for K3/K4/K5, 1/2 or 1 for K6). The
// backward runs the stages in reverse from (psi_T, lambda_T), rebuilding
// each earlier state by the inverse op (G^2 = I, K^2 = -I), and reduces
// the cotangents to d theta_x [T, B, n_x] (per slot, the sum of its rows'
// partials times their scales) and the merged rows' [T+1, B, n_diag+1]:
// S0 - 2 S_k for slot k and S0 for the offset slot, where
// S0 = sum_j g_j, S_k = sum_j g_j bit_k(j), g = lam_re y_im - lam_im y_re.
//
// What bounds it on this card. From 18 qubits up the state (1-128 MB per
// member and plane pair) lives in global memory: an 18-20 qubit state
// fits the H100's 50 MB L2, a 24-qubit one does not. A step is a few
// passes, each reading and writing the whole state (16 bytes an amplitude
// forward, 32 backward, plus the 4-byte sign plane once per stage), so at
// 24 qubits HBM bandwidth sets the floor: ~4.8 ms for a 30-step forward
// and ~9.6 ms backward at 3.35 TB/s over two passes a step. Below ~20
// qubits the passes are short, and fixed costs per block (tables,
// barriers) and the ~2T+1 dependent launches set the time.
//
// What the design does about it. Each pass is one launch; its geometry
// (tile, middle and strided bits, columns, register bits, threads, ring
// stages, blocks) comes from the host's plan
// (ops/fused_product.py::pk_plan), which this file checks and never
// chooses.
//  - Tiles. A tile pass holds 2^k consecutive amplitudes (the low k bits)
//    and applies the stage phase and the step's ops on those bits; a
//    strided pass holds rows on the high bits (>= k2) of 2^lc consecutive
//    low-bit columns; where a tile of all the high bits would not fit a
//    block twice over (24 qubits), a middle pass takes the bits k..k2-1
//    the same way, so a step is three passes of small tiles instead of
//    two of large ones; a cross pass applies one op with bits on two
//    sides pair by pair straight from global memory.
//  - Persistent blocks and a ring. A pass launches `blocks` blocks per
//    member (a few per SM), each walking its share of the member's tiles
//    through a ring of `stages` shared-memory buffers: every thread
//    issues 16-byte cp.async copies for a whole tile at once (the sign
//    planes beside the state in a tile pass), so the next tile loads
//    while this one's ops run and the last one's stores drain. A pass
//    whose ops take one round runs direct (stages 0): its threads load
//    their amplitudes from global memory, apply the round and store them,
//    with no shared memory and no barrier.
//  - The forward's staged passes on a warp-specialised TMA ring
//    (pass_ring; the backward keeps the ring above). In that ring every
//    thread copied, waited on its copies and passed a block barrier each
//    tile, so inside a block loads, rounds and stores never overlapped,
//    and a 20q pass at B = 80 moved 1.1 TB/s. Here one producer thread
//    keeps tensor-map (TMA) loads of the next tiles in flight into a ring
//    of `stages` buffers, each with a full and a done mbarrier; the
//    consumer warps run the rounds with a named barrier among themselves
//    only; when they are done with a tile the producer stores it by TMA
//    and reuses the buffer once the store has read it, so no consumer
//    waits on device memory. Blocks are persistent over the pass's member
//    x tile pairs: about two an SM, each a contiguous member-major share,
//    rebuilding its tables only when its member changes. A tile pass's
//    tile is 2^k consecutive words of each plane, loaded through a
//    [rows, 32 words] view with the TMA's 128-byte swizzle, which is swz
//    below; a middle or strided tile is 2^rb rows of 2^lc words at a
//    2^k1-word stride, one 2-D box of a [rows, 2^k1] view, unswizzled
//    (rows of 32-256 bytes, under the swizzle's 128-byte span, and their
//    rounds' lanes mostly run along the rows' words anyway).
//  - Ops in registers. The host groups a pass's ordered ops into rounds of
//    r bits (an op row's sixth column is its round's mask). In a round
//    every thread gathers the 2^r amplitudes of one group (one fixed value
//    of the other bits) from shared memory into registers, applies all the
//    round's ops there, and scatters them back: one barrier per round, not
//    per op. Shared memory is swizzled in 16-byte units so that gathers
//    across lanes fall on different banks.
//  - Phases from tables. A stage's phase factor is e^{-i base} times, per
//    sign plane, four unit phases looked up by the bytes of the plane word
//    (tables of e^{2i sum of a_k over the byte's set bits}, built once per
//    block): four complex products an amplitude instead of an angle sum
//    and a sincos. The drift term is computed only when the host says the
//    drift is nonzero.
//  - Deterministic sums. The backward reduces each op's partial per warp
//    and tile, and S_k and S0 by a warp transpose-sum (31 shuffles for 32
//    sums), accumulating per warp across the block's tiles in a fixed
//    order; each block writes one partial per column to [T+1, B, stride],
//    and a last launch sums them in a fixed order (no atomics). Offsets
//    are size_t: B*d passes 2^31 at 24 qubits from B = 128 up.

#include <cuda.h>  // CUtensorMap and its encoder's types (no driver link)
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kMaxOps = 128;
constexpr int kOpCols = 6;    // slot, kind, mask a, mask b, scale in halves,
                              // round mask
constexpr int kPassCols = 10;  // see Pass
constexpr int kMaxDiag = 120;
constexpr int kPlaneBits = 30;
constexpr int kMaxSignPlanes = 4;
constexpr int kLutEntries = 4 * 256;  // a sign plane's four byte tables
constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxRBits = 5;      // forward; the backward takes <= 4
constexpr int kMaxStages = 4;
constexpr int kMaxRing = 4;         // stages of the forward's TMA ring
constexpr int kRingConsumers = 256; // its consumer threads, at most
constexpr int kRingThreads = kRingConsumers + 32;  // and the producer warp
constexpr unsigned kRingAlign = 1024;  // the 128-byte swizzle's period
constexpr int kCrossThreads = 256;
// static shared memory of the two pass kernels, mirrored by
// ops/fused_product.py::PK_STATIC_BYTES (the plan's budget)
constexpr size_t kFwdStatic = 5 * 1024;
constexpr size_t kBwdStatic = 21 * 1024;

enum OpKind : int { kX = 0, kY = 1, kHop = 2 };
enum PassKind : int { kTile = 0, kStrided = 1, kCross = 2, kMid = 3 };

// one row of the host's pass table
struct Pass {
  int kind, op_begin, op_count, blocks, part_off, part_width;
  int rbits, threads, stages;  // tile/middle/strided: the plan's geometry
  int ring;  // 1: the forward's TMA ring, `blocks` over member x tile
};
static_assert(sizeof(Pass) == kPassCols * sizeof(int), "pass row");

// what every pass launch reads
struct Chain {
  const float* udm;    // [T+1, B, n_diag + 2] merged stage rows
  const float* tx;     // [T, B, n_x] rotation angles
  const float* h0th;   // [d] drift half-angles (read only if drift)
  const int* planes;   // [P, d] sign bit-planes
  int n, k, k2, lc, T, B, n_diag, P, n_x, drift;
};

// one tile, middle or strided pass launch
struct PassArgs {
  float* pl[4];       // state planes: y re, im (and backward lambda re, im)
  const int* ops;     // this pass's op rows
  float* part;        // backward: block partials
  int n_ops, stage, kind, lb, phase, signs, stages, tiles;
  int lcp, k1, rb;    // columns, the rows' first bit, row bits
  int stride, part_off, width, diag_col;
};

// a pass's op rows and the (cos, sin) of their angles for this member
struct OpTable {
  int kind[kMaxOps];
  unsigned ma[kMaxOps];
  unsigned mb[kMaxOps];
  unsigned round[kMaxOps];
  float scale[kMaxOps];
  float c[kMaxOps];
  float s[kMaxOps];
};

// a stage's row and its base phase e^{-i base}, base = off + sum_k a_k
// (the unit-phase tables, kLutEntries float2 per sign plane, sit at the
// head of the dynamic shared memory, before the ring)
struct PhaseTable {
  float a[kMaxDiag + 2];
  float c0, s0;
};

struct FwdShared {
  OpTable tab;
  PhaseTable ph;
};

struct BwdShared {
  OpTable tab;
  PhaseTable ph;
  float wop[kMaxOps][kMaxWarps];             // per-warp op partials
  float wsk[kMaxSignPlanes * 32][kMaxWarps];  // per-warp S_k (and S0)
};
static_assert(sizeof(FwdShared) <= kFwdStatic, "forward static smem");
static_assert(sizeof(BwdShared) <= kBwdStatic, "backward static smem");

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

// 32 sums at once: lane l ends with the warp's sum of v[l] (31 shuffles).
template <int S>
__device__ __forceinline__ void transpose_step(float (&v)[32], unsigned lane) {
  const bool up = (lane & (unsigned)S) != 0;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const float send = up ? v[i] : v[i + S];
    const float keep = up ? v[i + S] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, S);
  }
  if constexpr (S > 1) transpose_step<S / 2>(v, lane);
}

__device__ __forceinline__ float warp_transpose_sum(float (&v)[32]) {
  transpose_step<16>(v, threadIdx.x & 31u);
  return v[0];
}

// 16-byte units of shared memory swizzled by the 128-byte line: lanes
// that gather at strides of 16-128 bytes fall on different banks, and a
// 4-, 8- or 16-byte unit stays contiguous and aligned
__device__ __forceinline__ unsigned swz(unsigned l) {
  return l ^ (((l >> 5) & 7u) << 2);
}

// Global amplitude index of local slot l of tile t: the low lcp bits of l
// are columns (global bits 0..lcp-1), the rest rows (rb bits from global
// bit k1); the tile index fills the other bits, low part first. A tile
// pass has lcp = k1 = k and rb = 0.
__device__ __forceinline__ size_t amp_index(const PassArgs& a, unsigned t,
                                            unsigned l) {
  const unsigned tl = a.k1 - a.lcp;  // tile bits below the rows
  return (size_t)(l & ((1u << a.lcp) - 1u)) |
         ((size_t)(t & ((1u << tl) - 1u)) << a.lcp) |
         ((size_t)(l >> a.lcp) << a.k1) |
         ((size_t)(t >> tl) << (a.k1 + a.rb));
}

__device__ __forceinline__ void cp_async(float* dst, const void* src,
                                         int words) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if (words == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
                 "l"(src)
                 : "memory");
  else if (words == 2)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(s),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s),
                 "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most `pending` copy groups of this thread are in flight
__device__ __forceinline__ void cp_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;" ::: "memory"); break;
  }
}

// words of the contiguous units a pass copies: 4 (16 bytes) unless the
// rows are shorter
__device__ __forceinline__ int unit_words(const PassArgs& a) {
  const int run = a.kind == kTile ? a.lb : a.lcp;
  return run >= 2 ? 4 : 1 << run;
}

// Start the copies of tile t into buffer buf: the state planes, then (a
// tile pass with its phase) the sign planes, each 2^lb words.
__device__ void issue_tile(float* buf, const PassArgs& a, const Chain& ch,
                           unsigned t, int nq, size_t mo) {
  const size_t d = (size_t)1 << ch.n;
  const unsigned L = 1u << a.lb;
  const int w = unit_words(a);
  for (unsigned u = threadIdx.x; u < L / w; u += blockDim.x) {
    const unsigned l = u * w;
    const size_t j = amp_index(a, t, l);
    const unsigned sl = swz(l);
    for (int q = 0; q < nq; ++q)
      cp_async(buf + q * L + sl, a.pl[q] + mo + j, w);
    for (int p = 0; p < a.signs; ++p)
      cp_async(buf + (nq + p) * L + sl, ch.planes + p * d + j, w);
  }
}

// Write buffer buf's state planes back to tile t.
__device__ void store_tile(const float* buf, const PassArgs& a, unsigned t,
                           int nq, size_t mo) {
  const unsigned L = 1u << a.lb;
  const int w = unit_words(a);
  for (unsigned u = threadIdx.x; u < L / w; u += blockDim.x) {
    const unsigned l = u * w;
    const size_t j = amp_index(a, t, l);
    const unsigned sl = swz(l);
    for (int q = 0; q < nq; ++q) {
      float* g = a.pl[q] + mo + j;
      const float* s = buf + q * L + sl;
      if (w == 4)
        *reinterpret_cast<float4*>(g) = *reinterpret_cast<const float4*>(s);
      else if (w == 2)
        *reinterpret_cast<float2*>(g) = *reinterpret_cast<const float2*>(s);
      else
        *g = *s;
    }
  }
}

// The threads that build a block's tables and the barrier they pass: the
// whole block, or the TMA ring's consumers alone (named barrier 1).
struct BlockSync {
  __device__ __forceinline__ void operator()() const { __syncthreads(); }
};
struct ConsumerSync {
  unsigned n;  // consumer threads, a multiple of 32
  __device__ __forceinline__ void operator()() const {
    asm volatile("bar.sync 1, %0;" ::"r"(n) : "memory");
  }
};

// The pass's op rows and their angles for member b, and with a phase the
// stage row, its base phase and its unit-phase tables (lut: entry v of
// byte table q of plane p, at p * kLutEntries + q * 256 + v, is
// e^{+i phi}, phi = 2 sum of a_k over the set bits of v, k = 30 p + 8 q +
// bit), built by threads tid < nthr. Ends with sync().
template <class Sync>
__device__ void load_tables_for(OpTable& tab, PhaseTable& ph, float2* lut,
                                const Chain& ch, const PassArgs& a,
                                unsigned b, unsigned tid, unsigned nthr,
                                Sync sync) {
  const float* tx = ch.tx + ((size_t)a.stage * ch.B + b) * ch.n_x;
  for (int o = tid; o < a.n_ops; o += nthr) {
    const int* op = a.ops + kOpCols * o;
    tab.kind[o] = op[1];
    tab.ma[o] = (unsigned)op[2];
    tab.mb[o] = (unsigned)op[3];
    tab.scale[o] = 0.5f * (float)op[4];
    tab.round[o] = (unsigned)op[5];
    sincosf(tab.scale[o] * __ldg(tx + op[0]), &tab.s[o], &tab.c[o]);
  }
  if (!a.phase) {
    sync();
    return;
  }
  const float* u = ch.udm + ((size_t)a.stage * ch.B + b) * (ch.n_diag + 2);
  for (int i = tid; i < ch.n_diag + 2; i += nthr) ph.a[i] = __ldg(u + i);
  sync();
  if (tid < 32) {  // base = off + sum_k a_k, lane order fixed
    float v = 0.f;
    for (int i = tid; i < ch.n_diag; i += 32) v += ph.a[i];
    v = warp_sum(v);
    if (tid == 0) {
      float s, c;
      sincosf(ph.a[ch.n_diag] + v, &s, &c);
      ph.c0 = c;
      ph.s0 = -s;
    }
  }
  for (int e = tid; e < a.signs * kLutEntries; e += nthr) {
    const int tbl = e >> 8;  // plane tbl / 4, byte tbl % 4
    const int k0 = (tbl >> 2) * kPlaneBits + (tbl & 3) * 8;
    const int nb = max(0, min(min(8, kPlaneBits - (tbl & 3) * 8),
                              ch.n_diag - k0));
    unsigned v = (unsigned)(e & 255);
    if (v >> nb) continue;  // bits past n_diag are 0: never looked up
    float phi = 0.f;
    while (v) {
      phi += ph.a[k0 + __ffs(v) - 1];
      v &= v - 1u;
    }
    float s, c;
    sincosf(2.f * phi, &s, &c);
    lut[e] = make_float2(c, s);
  }
  sync();
}

// load_tables_for member blockIdx.y by the whole block
__device__ void load_tables(OpTable& tab, PhaseTable& ph, float2* lut,
                            const Chain& ch, const PassArgs& a) {
  load_tables_for(tab, ph, lut, ch, a, blockIdx.y, threadIdx.x, blockDim.x,
                  BlockSync{});
}

// ---------------------------------------------------------------------------
// ops on a thread's 2^R amplitudes in registers; A and B are the ranks of
// the op's bits among its round's R bits
// ---------------------------------------------------------------------------

__device__ __forceinline__ void rot_pair(bool y, float c, float s, float& ar,
                                         float& ai, float& br, float& bi) {
  const float xr = ar, xi = ai, zr = br, zi = bi;
  if (y) {
    ar = c * xr - s * zr;
    ai = c * xi - s * zi;
    br = c * zr + s * xr;
    bi = c * zi + s * xi;
  } else {
    ar = c * xr + s * zi;
    ai = c * xi - s * zr;
    br = c * zr + s * xi;
    bi = c * zi - s * xr;
  }
}

// Undo one op on the pair (a, b) of y and lambda; returns the pair's share
// of d theta = Re<lambda, dR/dtheta x>, read off the op's output y:
// dR/dtheta x = K y (Y: R = c + s K) or -i G y (X, hop: R = c - i s G).
__device__ __forceinline__ float undo_pair(bool y, float c, float s,
                                           float& yar, float& yai,
                                           float& ybr, float& ybi,
                                           float& lar, float& lai,
                                           float& lbr, float& lbi) {
  float xar, xai, xbr, xbi, nar, nai, nbr, nbi, g;
  if (y) {
    // x = c y - s K y; lam_x = c lam - s K lam
    g = (lbr * yar - lar * ybr) + (lbi * yai - lai * ybi);
    xar = c * yar + s * ybr;
    xbr = c * ybr - s * yar;
    xai = c * yai + s * ybi;
    xbi = c * ybi - s * yai;
    nar = c * lar + s * lbr;
    nbr = c * lbr - s * lar;
    nai = c * lai + s * lbi;
    nbi = c * lbi - s * lai;
  } else {
    // x = c y + i s G y; lam_x = c lam + i s G lam
    g = (lar * ybi - lai * ybr) + (lbr * yai - lbi * yar);
    xar = c * yar - s * ybi;
    xai = c * yai + s * ybr;
    xbr = c * ybr - s * yai;
    xbi = c * ybi + s * yar;
    nar = c * lar - s * lbi;
    nai = c * lai + s * lbr;
    nbr = c * lbr - s * lai;
    nbi = c * lbi + s * lar;
  }
  yar = xar; yai = xai; ybr = xbr; ybi = xbi;
  lar = nar; lai = nai; lbr = nbr; lbi = nbi;
  return g;
}

// Amplitudes of a thread in a round: v[q][i], plane q, group slot i.
template <int R, int Q>
struct Regs {
  float v[Q][1 << R];
};

// the pair (i, j) of register slots an op pairs: X/Y on rank A (i has
// bit A clear), hop on ranks (A, B) (i: bit A clear, bit B set)
template <int R, int A, int B>
__device__ __forceinline__ constexpr bool first_of_pair(int i) {
  constexpr int b = B < 0 ? 0 : B;
  return B < 0 ? !((i >> A) & 1) : (!((i >> A) & 1) && ((i >> b) & 1));
}

template <int R, int A, int B>
__device__ __forceinline__ constexpr int partner(int i) {
  constexpr int b = B < 0 ? 0 : B;
  return B < 0 ? (i | (1 << A)) : (i ^ (1 << A) ^ (1 << b));
}

template <int R, int A, int B>
__device__ __forceinline__ void fwd_op(Regs<R, 2>& x, bool y, float c,
                                       float s) {
#pragma unroll
  for (int i = 0; i < (1 << R); ++i) {
    if (!first_of_pair<R, A, B>(i)) continue;
    const int j = partner<R, A, B>(i);
    rot_pair(y, c, s, x.v[0][i], x.v[1][i], x.v[0][j], x.v[1][j]);
  }
}

template <int R, int A, int B>
__device__ __forceinline__ float bwd_op(Regs<R, 4>& x, bool y, float c,
                                        float s) {
  float g = 0.f;
#pragma unroll
  for (int i = 0; i < (1 << R); ++i) {
    if (!first_of_pair<R, A, B>(i)) continue;
    const int j = partner<R, A, B>(i);
    g += undo_pair(y, c, s, x.v[0][i], x.v[1][i], x.v[0][j], x.v[1][j],
                   x.v[2][i], x.v[3][i], x.v[2][j], x.v[3][j]);
  }
  return g;
}

// Dispatch a backward op to its compile-time ranks (a: rank of mask a; b:
// rank of mask b for a hop, -1 otherwise); returns its partial.
template <int R, int Q, int A = 0, int B = -1>
__device__ __forceinline__ float apply_op(Regs<R, Q>& x, int a, int b,
                                          bool y, float c, float s) {
  if constexpr (A >= R) {
    return 0.f;
  } else if constexpr (B >= R) {
    return apply_op<R, Q, A + 1, -1>(x, a, b, y, c, s);
  } else {
    if (a == A && b == B && A != B) {
      if constexpr (A != B) return bwd_op<R, A, B>(x, y, c, s);
    }
    return apply_op<R, Q, A, B + 1>(x, a, b, y, c, s);
  }
}

// rank of bit m among the set bits of mask M
__device__ __forceinline__ int rank_in(unsigned M, unsigned m) {
  return __popc(M & (m - 1u));
}

template <int R, int Q>
__device__ __forceinline__ float apply_row(Regs<R, Q>& x, const OpTable& tab,
                                           int o, unsigned M) {
  const int kind = tab.kind[o];
  const int a = rank_in(M, tab.ma[o]);
  const int b = kind == kHop ? rank_in(M, tab.mb[o]) : -1;
  return apply_op<R, Q>(x, a, b, kind == kY, tab.c[o], tab.s[o]);
}

// A forward op row on a thread's amplitudes (fwd_op's products),
// dispatched by kind first, so that an X or a Y row issues only its own
// products rather than both under predicates, then an X/Y row by its rank
// alone and a hop by its two.
template <int R, bool Y, int A = 0>
__device__ __forceinline__ void fwd_rank(Regs<R, 2>& x, int a, float c,
                                         float s) {
  if constexpr (A < R) {
    if (a == A)
      fwd_op<R, A, -1>(x, Y, c, s);
    else
      fwd_rank<R, Y, A + 1>(x, a, c, s);
  }
}

template <int R, int A = 0, int B = 0>
__device__ __forceinline__ void fwd_hop(Regs<R, 2>& x, int a, int b, float c,
                                        float s) {
  if constexpr (A < R) {
    if constexpr (B >= R) {
      fwd_hop<R, A + 1, 0>(x, a, b, c, s);
    } else {
      if constexpr (A != B) {
        if (a == A && b == B) {
          fwd_op<R, A, B>(x, false, c, s);
          return;
        }
      }
      fwd_hop<R, A, B + 1>(x, a, b, c, s);
    }
  }
}

template <int R>
__device__ __forceinline__ void apply_row_fwd(Regs<R, 2>& x,
                                              const OpTable& tab, int o,
                                              unsigned M) {
  const int kind = tab.kind[o];
  const int a = rank_in(M, tab.ma[o]);
  const float c = tab.c[o], s = tab.s[o];
  if (kind == kHop)
    fwd_hop<R>(x, a, rank_in(M, tab.mb[o]), c, s);
  else if (kind == kY)
    fwd_rank<R, true>(x, a, c, s);
  else
    fwd_rank<R, false>(x, a, c, s);
}

// A round's group for thread tid: base (tid's bits spread over the bits
// outside M) and the masks of M's bits, ascending; and both swizzled
// (swz is linear over XOR, so slot i's address is one XOR per bit).
template <int R>
struct Group {
  unsigned base, sbase;
  unsigned bit[R], sbit[R];
  __device__ __forceinline__ Group(unsigned M, unsigned tid) {
    unsigned m = M;
    base = tid;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      bit[r] = m & (0u - m);
      m &= m - 1u;
      base = insert_zero(base, bit[r]);
      sbit[r] = swz(bit[r]);
    }
    sbase = swz(base);
  }
  // the same group in an unswizzled tile when !swizzled (the TMA ring's
  // middle and strided tiles)
  __device__ __forceinline__ Group(unsigned M, unsigned tid, bool swizzled)
      : Group(M, tid) {
    if (swizzled) return;
    sbase = base;
#pragma unroll
    for (int r = 0; r < R; ++r) sbit[r] = bit[r];
  }
  // local index of register slot i
  __device__ __forceinline__ unsigned at(int i) const {
    unsigned l = base;
#pragma unroll
    for (int r = 0; r < R; ++r)
      if ((i >> r) & 1) l |= bit[r];
    return l;
  }
  // its swizzled shared-memory slot, swz(at(i))
  __device__ __forceinline__ unsigned slot(int i) const {
    unsigned l = sbase;
#pragma unroll
    for (int r = 0; r < R; ++r)
      if ((i >> r) & 1) l ^= sbit[r];
    return l;
  }
};

// the mask of a round with no op (a phase alone): the top R bits
__device__ __forceinline__ unsigned phase_mask(int lb, int R) {
  return ((1u << R) - 1u) << (lb - R);
}


// Where a round's amplitudes come from and go to: the tile staged in
// shared memory, or (a direct pass) global memory.
struct Site {
  float* buf;        // staged tile: plane q at buf + q * L
  const PassArgs* a;
  const Chain* ch;
  size_t mo;         // member offset
  unsigned L, t;     // tile size and index
};

template <int R, int Q>
__device__ __forceinline__ void gather(Regs<R, Q>& x, const Group<R>& g,
                                       const Site& s, bool global) {
#pragma unroll
  for (int i = 0; i < (1 << R); ++i) {
    if (global) {
      const size_t j = s.mo + amp_index(*s.a, s.t, g.at(i));
#pragma unroll
      for (int q = 0; q < Q; ++q) x.v[q][i] = s.a->pl[q][j];
    } else {
      const unsigned sl = g.slot(i);
#pragma unroll
      for (int q = 0; q < Q; ++q) x.v[q][i] = s.buf[q * s.L + sl];
    }
  }
}

template <int R, int Q>
__device__ __forceinline__ void scatter(const Regs<R, Q>& x,
                                        const Group<R>& g, const Site& s,
                                        bool global) {
#pragma unroll
  for (int i = 0; i < (1 << R); ++i) {
    if (global) {
      const size_t j = s.mo + amp_index(*s.a, s.t, g.at(i));
#pragma unroll
      for (int q = 0; q < Q; ++q) s.a->pl[q][j] = x.v[q][i];
    } else {
      const unsigned sl = g.slot(i);
#pragma unroll
      for (int q = 0; q < Q; ++q) s.buf[q * s.L + sl] = x.v[q][i];
    }
  }
}

// sign-plane word p of register slot i: staged beside the tile's Q state
// planes, or read from global memory
template <int R, int Q>
__device__ __forceinline__ unsigned sign_word(const Group<R>& g,
                                              const Site& s, bool global,
                                              int p, int i) {
  if (global)
    return (unsigned)__ldg(s.ch->planes + ((size_t)p << s.ch->n) +
                           amp_index(*s.a, s.t, g.at(i)));
  return __float_as_uint(s.buf[(Q + p) * s.L + g.slot(i)]);
}

// e^{-i theta_s} of register slot i: the base phase times the unit
// phases of its plane words' bytes (a byte past n_diag is 0, whose
// entry is exactly 1), and the drift's e^{-i m h0th[j]} with a drift
template <int R, int Q>
__device__ __forceinline__ float2 slot_phase(const PhaseTable& ph,
                                             const float2* lut,
                                             const Group<R>& g,
                                             const Site& s, bool global,
                                             int i) {
  float zr = ph.c0, zi = ph.s0;
  for (int p = 0; p < s.a->signs; ++p) {
    const unsigned w = sign_word<R, Q>(g, s, global, p, i);
    const float2* lp = lut + p * kLutEntries;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 e = lp[q * 256 + ((w >> (8 * q)) & 255u)];
      const float r = zr * e.x - zi * e.y;
      zi = zr * e.y + zi * e.x;
      zr = r;
    }
  }
  if (s.ch->drift) {
    float sn, cs;
    sincosf(ph.a[s.ch->n_diag + 1] *
                __ldg(s.ch->h0th + amp_index(*s.a, s.t, g.at(i))),
            &sn, &cs);
    const float r = zr * cs + zi * sn;
    zi = zi * cs - zr * sn;
    zr = r;
  }
  return make_float2(zr, zi);
}

// The ring of a staged pass: before tile `it`, start the copies of the
// tile S-1 ahead and wait for tile it's; the caller's barrier after its
// stores frees its buffer. A direct pass (stages 0) copies nothing.
template <int Q>
__device__ __forceinline__ void ring_prologue(float* dyn, unsigned words,
                                              const PassArgs& a,
                                              const Chain& ch, size_t mo) {
  for (int p = 0; p < a.stages - 1; ++p) {
    const unsigned t = blockIdx.x + p * gridDim.x;
    if (t < (unsigned)a.tiles) issue_tile(dyn + p * words, a, ch, t, Q, mo);
    cp_commit();
  }
}

template <int Q>
__device__ __forceinline__ float* ring_next(float* dyn, unsigned words,
                                            const PassArgs& a,
                                            const Chain& ch, size_t mo,
                                            int it) {
  const int S = a.stages;
  if (S == 0) return dyn;
  const unsigned tn = blockIdx.x + (it + S - 1) * gridDim.x;
  if (tn < (unsigned)a.tiles)
    issue_tile(dyn + ((it + S - 1) % S) * words, a, ch, tn, Q, mo);
  cp_commit();
  cp_wait(S - 1);
  __syncthreads();
  return dyn + (it % S) * words;
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// A tile, middle or strided pass: blocks walk tiles of member blockIdx.y.
// Staged (stages >= 1): each tile arrives by cp.async in a ring of stages,
// each round gathers and scatters shared memory, and the tile leaves by
// 16-byte stores. Direct (stages 0, a pass of one round): the round
// gathers from and scatters to global memory. Per round, a thread
// applies the stage phase (tile pass, first round) and the round's ops to
// its 2^R amplitudes.
template <int R>
__global__ void __launch_bounds__(kMaxThreads, R <= 4 ? 2 : 1)
pass_forward(PassArgs a, Chain ch) {
  extern __shared__ __align__(16) float dyn_all[];
  __shared__ FwdShared sh;
  float2* lut = reinterpret_cast<float2*>(dyn_all);
  float* dyn = dyn_all + 2 * a.signs * kLutEntries;
  load_tables(sh.tab, sh.ph, lut, ch, a);
  const unsigned L = 1u << a.lb, tid = threadIdx.x;
  const unsigned words = (2u + (unsigned)a.signs) << a.lb;
  const size_t mo = (size_t)blockIdx.y << ch.n;
  const bool act = tid < (L >> R);
  const bool direct = a.stages == 0;
  ring_prologue<2>(dyn, words, a, ch, mo);
  for (int it = 0;; ++it) {
    const unsigned t = blockIdx.x + it * gridDim.x;
    if (t >= (unsigned)a.tiles) break;
    const Site site{ring_next<2>(dyn, words, a, ch, mo, it), &a, &ch, mo, L,
                    t};
    int o = 0;
    do {
      const unsigned M = a.n_ops ? sh.tab.round[o] : phase_mask(a.lb, R);
      int e = o;
      while (e < a.n_ops && sh.tab.round[e] == M) ++e;
      if (act) {
        const Group<R> g(M, tid);
        Regs<R, 2> x;
        gather<R, 2>(x, g, site, direct);
        if (o == 0 && a.phase) {
#pragma unroll
          for (int i = 0; i < (1 << R); ++i) {
            const float2 z = slot_phase<R, 2>(sh.ph, lut, g, site, direct, i);
            const float xr = x.v[0][i], xi = x.v[1][i];
            x.v[0][i] = z.x * xr - z.y * xi;
            x.v[1][i] = z.x * xi + z.y * xr;
          }
        }
        for (int q = o; q < e; ++q) apply_row_fwd<R>(x, sh.tab, q, M);
        scatter<R, 2>(x, g, site, direct);
      }
      if (!direct) __syncthreads();
      o = e;
    } while (o < a.n_ops);
    if (!direct) {
      store_tile(site.buf, a, t, 2, mo);
      __syncthreads();
    }
  }
}

// ---------------------------------------------------------------------------
// the forward's TMA ring: mbarriers, bulk tensor copies, the kernel
// ---------------------------------------------------------------------------

// a pass's tensor maps: the state planes (re, im) and, for a tile pass,
// the sign planes
struct RingMaps {
  CUtensorMap pl[2];
  CUtensorMap signs;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// wait until the mbarrier's phase of this parity has completed (a wait
// of 2^30 tries, seconds, means a copy that never lands: trap rather than
// hang the card)
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  for (unsigned tries = 0;; ++tries) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 30)) __trap();
  }
}

// box (c0, c1) of a 2-D tensor map into shared memory, counted on bar
__device__ __forceinline__ void tma_load(unsigned dst, const CUtensorMap* map,
                                         int c0, int c1, unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(c0), "r"(c1),
      "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          unsigned src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}],"
      " [%1];" ::"l"(reinterpret_cast<unsigned long long>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}

// Pair w's box in its pass's views: a tile pass's tile is 2^lb / 32 rows
// of a [B d / 32, 32] view; a middle or strided tile 2^rb rows of 2^lcp
// words in a [B d / 2^k1, 2^k1] view (amp_index's map, member b's rows
// first).
__device__ __forceinline__ void ring_box(const PassArgs& a, const Chain& ch,
                                         unsigned w, int& c0, int& c1,
                                         unsigned& t) {
  const unsigned tbits = (unsigned)(ch.n - a.lb);
  const unsigned b = w >> tbits;
  t = w & ((1u << tbits) - 1u);
  if (a.kind == kTile) {
    c0 = 0;
    c1 = (int)((b << (ch.n - 5)) + (t << (a.lb - 5)));
  } else {
    const unsigned tl = a.k1 - a.lcp;
    c0 = (int)((t & ((1u << tl) - 1u)) << a.lcp);
    c1 = (int)((b << (ch.n - a.k1)) + ((t >> tl) << a.rb));
  }
}

// The producer: for pair j of the block's share, once the consumers are
// done with pair j - S in buffer j % S, store it and, when that store has
// read the buffer, load pair j there (the tile pass's sign planes beside
// it); then drain the stores.
__device__ void ring_produce(const PassArgs& a, const Chain& ch,
                             const RingMaps& maps, unsigned ring,
                             unsigned words, unsigned full, unsigned done,
                             unsigned w0, unsigned n_items) {
  const unsigned S = (unsigned)a.stages, L4 = 4u << a.lb;
  for (unsigned j = 0; j < n_items + S; ++j) {
    const unsigned s = j % S, buf = ring + 4u * s * words;
    int c0, c1;
    unsigned t;
    if (j >= S) {
      mbar_wait(done + 8u * s, ((j - S) / S) & 1u);
      ring_box(a, ch, w0 + j - S, c0, c1, t);
      tma_store(&maps.pl[0], buf, c0, c1);
      tma_store(&maps.pl[1], buf + L4, c0, c1);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
    if (j >= n_items) continue;
    if (j >= S) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    mbar_expect(full + 8u * s, 4u * words);
    ring_box(a, ch, w0 + j, c0, c1, t);
    tma_load(buf, &maps.pl[0], c0, c1, full + 8u * s);
    tma_load(buf + L4, &maps.pl[1], c0, c1, full + 8u * s);
    for (int p = 0; p < a.signs; ++p)
      tma_load(buf + (2u + p) * L4, &maps.signs, 0,
               (int)(((unsigned)p << (ch.n - 5)) + (t << (a.lb - 5))),
               full + 8u * s);
  }
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// A staged tile, middle or strided forward pass on the TMA ring: the
// block's threads below C = blockDim.x - 32 are consumers, the last warp
// the producer (one lane issues every copy). The consumers walk the same
// pairs: per pair, the tables when its member changes, a wait on its
// buffer's full barrier, then the rounds as pass_forward's (a named
// barrier after each, the last one after fencing the buffer for the TMA
// store), and an arrival on its done barrier.
template <int R>
__global__ void __launch_bounds__(kRingThreads, R <= 4 ? 2 : 1)
pass_ring(PassArgs a, Chain ch, const __grid_constant__ RingMaps maps) {
  extern __shared__ __align__(16) float dyn_all[];
  __shared__ FwdShared sh;
  __shared__ __align__(8) unsigned long long bars[2 * kMaxRing];
  float2* lut = reinterpret_cast<float2*>(dyn_all);
  const unsigned tid = threadIdx.x, C = blockDim.x - 32u;
  const unsigned L = 1u << a.lb, S = (unsigned)a.stages;
  const unsigned words = (2u + (unsigned)a.signs) << a.lb;
  // the ring: past the phase tables, at the swizzle's period
  const unsigned base = smem_addr(dyn_all);
  const unsigned ring =
      (base + 8u * a.signs * kLutEntries + kRingAlign - 1u) & ~(kRingAlign - 1u);
  float* buf0 = dyn_all + (ring - base) / 4u;
  const unsigned full = smem_addr(bars), done = full + 8u * kMaxRing;
  // the block's contiguous share of the B x tiles pairs, member-major
  const unsigned long long W = (unsigned long long)ch.B * a.tiles;
  const unsigned w0 = (unsigned)(W * blockIdx.x / gridDim.x);
  const unsigned n_items =
      (unsigned)(W * (blockIdx.x + 1) / gridDim.x) - w0;
  if (tid == 0) {
    for (unsigned s = 0; s < S; ++s) {
      mbar_init(full + 8u * s, 1);
      mbar_init(done + 8u * s, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid >= C) {
    if (tid == C)
      ring_produce(a, ch, maps, ring, words, full, done, w0, n_items);
    return;
  }
  const ConsumerSync sync{C};
  const bool act = tid < (L >> R);
  const bool swizzled = a.kind == kTile;
  const unsigned tbits = (unsigned)(ch.n - a.lb);
  unsigned member = ~0u;
  for (unsigned j = 0; j < n_items; ++j) {
    const unsigned b = (w0 + j) >> tbits;
    const unsigned t = (w0 + j) & ((1u << tbits) - 1u);
    if (b != member) {
      load_tables_for(sh.tab, sh.ph, lut, ch, a, b, tid, C, sync);
      member = b;
    }
    const unsigned s = j % S;
    mbar_wait(full + 8u * s, (j / S) & 1u);
    const Site site{buf0 + s * words, &a, &ch, (size_t)b << ch.n, L, t};
    int o = 0;
    do {
      const unsigned M = a.n_ops ? sh.tab.round[o] : phase_mask(a.lb, R);
      int e = o;
      while (e < a.n_ops && sh.tab.round[e] == M) ++e;
      if (act) {
        const Group<R> g(M, tid, swizzled);
        Regs<R, 2> x;
        gather<R, 2>(x, g, site, false);
        if (o == 0 && a.phase) {
#pragma unroll
          for (int i = 0; i < (1 << R); ++i) {
            const float2 z = slot_phase<R, 2>(sh.ph, lut, g, site, false, i);
            const float xr = x.v[0][i], xi = x.v[1][i];
            x.v[0][i] = z.x * xr - z.y * xi;
            x.v[1][i] = z.x * xi + z.y * xr;
          }
        }
        for (int q = o; q < e; ++q) apply_row_fwd<R>(x, sh.tab, q, M);
        scatter<R, 2>(x, g, site, false);
      }
      // the tile's last writes, seen by the TMA store's async proxy
      if (e >= a.n_ops) asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      sync();
      o = e;
    } while (o < a.n_ops);
    if (tid == 0) mbar_arrive(done + 8u * s);
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
  sincosf(0.5f * (float)op[4] *
              __ldg(ch.tx + ((size_t)stage * ch.B + blockIdx.y) * ch.n_x +
                    op[0]),
          &s, &c);
  const unsigned n_pairs = (unsigned)(kind == kHop ? d >> 2 : d >> 1);
  for (unsigned p = blockIdx.x * blockDim.x + threadIdx.x; p < n_pairs;
       p += gridDim.x * blockDim.x) {
    unsigned i, j;
    pair_of(kind, ma, mb, p, i, j);
    rot_pair(kind == kY, c, s, re[i], im[i], re[j], im[j]);
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// A tile, middle or strided pass in reverse, staged or direct as the
// forward: per tile, rounds last first undo their ops last first (each
// op's partial summed per warp into wop), and the round of the first op
// (tile pass) then takes g = dL/d angle, undoes the phase and sums S_k
// and S0 (warp transpose-sums into per-lane registers). Block partials go
// to part[((stage*B + b)*stride + part_off + blockIdx.x*width + col]: one
// column per op (d angle times the row's scale), then S_0..S_{n_diag-1}
// and S0 from column diag_col.
template <int R>
__global__ void __launch_bounds__(kMaxThreads, 1)
pass_backward(PassArgs a, Chain ch) {
  extern __shared__ __align__(16) float dyn_all[];
  __shared__ BwdShared sh;
  float2* lut = reinterpret_cast<float2*>(dyn_all);
  float* dyn = dyn_all + 2 * a.signs * kLutEntries;
  const unsigned tid = threadIdx.x, lane = tid & 31u, warp = tid >> 5;
  const unsigned n_warps = blockDim.x >> 5;
  for (unsigned e = tid; e < (unsigned)a.n_ops * kMaxWarps; e += blockDim.x)
    sh.wop[e / kMaxWarps][e % kMaxWarps] = 0.f;
  load_tables(sh.tab, sh.ph, lut, ch, a);
  const unsigned L = 1u << a.lb;
  const unsigned words = (4u + (unsigned)a.signs) << a.lb;
  const size_t mo = (size_t)blockIdx.y << ch.n;
  const bool act = tid < (L >> R);
  const bool direct = a.stages == 0;
  const int n_acc = a.signs > 0 ? a.signs : 1;  // S0 rides plane 0's sums
  float sk[kMaxSignPlanes] = {0.f, 0.f, 0.f, 0.f};
  ring_prologue<4>(dyn, words, a, ch, mo);
  for (int it = 0;; ++it) {
    const unsigned t = blockIdx.x + it * gridDim.x;
    if (t >= (unsigned)a.tiles) break;
    const Site site{ring_next<4>(dyn, words, a, ch, mo, it), &a, &ch, mo, L,
                    t};
    int e = a.n_ops;
    bool last;
    do {
      const unsigned M = a.n_ops ? sh.tab.round[e - 1] : phase_mask(a.lb, R);
      int o = e;
      while (o > 0 && sh.tab.round[o - 1] == M) --o;
      last = o == 0;
      const Group<R> g(M, tid);
      Regs<R, 4> x;
      if (act) gather<R, 4>(x, g, site, direct);
      for (int q = e - 1; q >= o; --q) {
        float gq = act ? apply_row<R, 4>(x, sh.tab, q, M) : 0.f;
        gq = warp_sum(gq);
        if (lane == 0) sh.wop[q][warp] += gq * sh.tab.scale[q];
      }
      const bool phase = last && a.phase;
      float gj[1 << R];
      if (phase && act) {
        // g = dL/d angle (unchanged by the phase), then undo the phase:
        // x = e^{+i theta} y, lam_x = e^{+i theta} lam
#pragma unroll
        for (int i = 0; i < (1 << R); ++i) {
          const float y0 = x.v[0][i], y1 = x.v[1][i];
          const float l0 = x.v[2][i], l1 = x.v[3][i];
          gj[i] = l0 * y1 - l1 * y0;
          const float2 z = slot_phase<R, 4>(sh.ph, lut, g, site, direct, i);
          x.v[0][i] = z.x * y0 + z.y * y1;
          x.v[1][i] = z.x * y1 - z.y * y0;
          x.v[2][i] = z.x * l0 + z.y * l1;
          x.v[3][i] = z.x * l1 - z.y * l0;
        }
      }
      if (act) scatter<R, 4>(x, g, site, direct);
      if (phase) {
        // S_k of plane p's 30 bits in slots 0..29 and S0 in plane 0's
        // slot 30, summed over the warp at once (bits past n_diag are 0
        // in the planes, and their sums are never read)
#pragma unroll
        for (int p = 0; p < kMaxSignPlanes; ++p) {
          if (p < n_acc) {
            float v[32];
#pragma unroll
            for (int q = 0; q < 32; ++q) v[q] = 0.f;
            if (act) {
#pragma unroll
              for (int i = 0; i < (1 << R); ++i) {
                const unsigned w =
                    p < a.signs ? sign_word<R, 4>(g, site, direct, p, i)
                                : 0u;
#pragma unroll
                for (int q = 0; q < kPlaneBits; ++q)
                  if ((w >> q) & 1u) v[q] += gj[i];
                if (p == 0) v[30] += gj[i];
              }
            }
            sk[p] += warp_transpose_sum(v);
          }
        }
      }
      if (!direct) __syncthreads();
      e = o;
    } while (!last);
    if (!direct) {
      store_tile(site.buf, a, t, 4, mo);
      __syncthreads();
    }
  }
  __syncthreads();
  if (a.phase) {
#pragma unroll
    for (int p = 0; p < kMaxSignPlanes; ++p)
      if (p < n_acc) sh.wsk[p * 32 + lane][warp] = sk[p];
  }
  __syncthreads();
  float* out = a.part + ((size_t)a.stage * ch.B + blockIdx.y) * a.stride +
               a.part_off + (size_t)blockIdx.x * a.width;
  const int n_diag_cols = a.phase ? ch.n_diag + 1 : 0;
  for (int c = tid; c < a.n_ops + n_diag_cols; c += blockDim.x) {
    float v = 0.f;
    if (c < a.n_ops) {
      for (unsigned w = 0; w < n_warps; ++w) v += sh.wop[c][w];
      out[c] = v;
    } else {
      const int kk = c - a.n_ops;  // S_kk, or S0 at kk = n_diag
      const int row = kk < ch.n_diag
                          ? (kk / kPlaneBits) * 32 + kk % kPlaneBits
                          : 30;
      for (unsigned w = 0; w < n_warps; ++w) v += sh.wsk[row][w];
      out[a.diag_col + kk] = v;
    }
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
  const float scale = 0.5f * (float)op[4];
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
    g += undo_pair(kind == kY, c, s, y_re[i], y_im[i], y_re[j], y_im[j],
                   l_re[i], l_im[i], l_re[j], l_im[j]);
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

typedef void (*PassFn)(PassArgs, Chain);

// the kernels by register bits: forward 2-5, backward 2-4 (32 amplitudes
// of y and lambda would not fit a thread's registers)
PassFn pass_fn(bool bwd, int r) {
  if (bwd) {
    switch (r) {
      case 2: return pass_backward<2>;
      case 3: return pass_backward<3>;
      case 4: return pass_backward<4>;
      default: return nullptr;
    }
  }
  switch (r) {
    case 2: return pass_forward<2>;
    case 3: return pass_forward<3>;
    case 4: return pass_forward<4>;
    case 5: return pass_forward<5>;
    default: return nullptr;
  }
}

typedef void (*RingFn)(PassArgs, Chain, RingMaps);

// the TMA ring by register bits: 3-5 (a ring's tiles are 2^8 words or
// more, whose plan takes r >= 3)
RingFn ring_fn(int r) {
  switch (r) {
    case 3: return pass_ring<3>;
    case 4: return pass_ring<4>;
    case 5: return pass_ring<5>;
    default: return nullptr;
  }
}

// Each pass kernel's dynamic shared-memory ceiling, raised once per
// (kernel, device) to what the card leaves beside its static tables.
struct Raised {
  const void* fn;
  int dev;
  size_t limit;
};
Raised g_raised[64];
int g_n_raised = 0;

int dyn_limit(const void* fn, size_t* limit) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  for (int i = 0; i < g_n_raised; ++i)
    if (g_raised[i].fn == fn && g_raised[i].dev == dev) {
      *limit = g_raised[i].limit;
      return 0;
    }
  int optin = 0;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, fn);
  if (e != cudaSuccess) return (int)e;
  const size_t lim = (size_t)optin - fa.sharedSizeBytes;
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)lim);
  if (e != cudaSuccess) return (int)e;
  if (g_n_raised < 64) g_raised[g_n_raised++] = Raised{fn, dev, lim};
  *limit = lim;
  return 0;
}

// A tile, middle or strided pass's local bits and its index map: columns
// (lcp), the rows' first global bit (k1) and row bits (rb).
struct Shape {
  int lb, lcp, k1, rb;
};

Shape pass_shape(int kind, int n, int k, int k2, int lc) {
  if (kind == kTile) return Shape{k, k, k, 0};
  if (kind == kMid) return Shape{k2 - k + lc, lc, k, k2 - k};
  return Shape{n - k2 + lc, lc, k2, n - k2};
}

int signs_staged(int n_diag) {
  return (n_diag + kPlaneBits - 1) / kPlaneBits;
}

// dynamic shared-memory bytes of a pass: its unit-phase tables (a tile
// pass with its phase) and its ring (none when direct)
size_t pass_smem(int kind, int lb, int nq, int signs, int stages) {
  const int s = kind == kTile ? signs : 0;
  return (size_t)s * kLutEntries * sizeof(float2) +
         ((size_t)stages * (nq + s) << lb) * sizeof(float);
}

// the TMA ring's: its phase tables, the alignment of its buffers to the
// swizzle's period, and its buffers
size_t ring_smem(int kind, int lb, int signs, int stages) {
  return pass_smem(kind, lb, 2, signs, stages) + kRingAlign;
}

// Whether a pass fits the TMA ring's boxes: a tile pass 2^lb / 32 rows of
// 128 bytes (2^lb words a plane, each plane's buffer on the swizzle's
// period); a middle or strided pass rows of 16-1024 bytes, at most 256
// rows, buffers of 128 bytes or more; box coordinates within int.
bool ring_fits(int kind, const Shape& sh, int n, int B) {
  if (((size_t)B << n) >> 5 >= ((size_t)1 << 31)) return false;
  if (kind == kTile) return sh.lb >= 8 && sh.lb <= 13;
  return sh.lcp >= 2 && sh.lcp <= 8 && sh.rb <= 8 && sh.lb >= 5;
}

// cuTensorMapEncodeTiled, through the runtime's driver entry point
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 2-D map of 4-byte words: rows of `cols` words, `rows` of them, boxes
// of box_rows x box_cols; swizzled in 128 bytes or not. The L2 fetches
// 256-byte lines for a tile pass's contiguous tiles and 128-byte lines for
// a middle or strided tile's short rows: the next tile reads the line's
// other half, while 256 bytes would fetch twice what is read.
int encode_map(CUtensorMap* m, const void* base, size_t cols, size_t rows,
               int box_cols, int box_rows, bool swizzled, bool ints) {
  const EncodeTiled f = encode_tiled();
  if (f == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * 4};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r = f(
      m, ints ? CU_TENSOR_MAP_DATA_TYPE_INT32 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      2, const_cast<void*>(base), dims, strides, box, steps,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      swizzled ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
      swizzled ? CU_TENSOR_MAP_L2_PROMOTION_L2_256B
               : CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The maps of a ring pass of kind `kind` over the state planes (re, im)
// [B, d] and the sign planes [P, d].
int ring_maps(RingMaps* m, int kind, float* re, float* im, const int* planes,
              int n, int k, int k2, int lc, int B, int P) {
  const Shape sh = pass_shape(kind, n, k, k2, lc);
  const size_t all = (size_t)B << n;
  float* pl[2] = {re, im};
  for (int q = 0; q < 2; ++q) {
    const int e =
        kind == kTile
            ? encode_map(&m->pl[q], pl[q], 32, all >> 5, 32, 1 << (sh.lb - 5),
                         true, false)
            : encode_map(&m->pl[q], pl[q], (size_t)1 << sh.k1, all >> sh.k1,
                         1 << sh.lcp, 1 << sh.rb, false, false);
    if (e != 0) return e;
  }
  if (kind != kTile) return 0;
  return encode_map(&m->signs, planes, 32, ((size_t)P << n) >> 5, 32,
                    1 << (sh.lb - 5), true, true);
}

// The geometry the host's plan gives each pass, checked: splits, local
// bits, register bits, threads, stages and blocks within the kernels' and
// the card's limits. (The op rows' round masks, each op's bits inside its
// round's R bits and a direct pass's single round, are the plan's:
// ops/fused_product.py::_pass_layout, tested on the CPU.)
bool bad_chain(const Pass* passes, int n_pass, int n, int k, int k2, int lc,
               int T, int B, int n_diag, int P, int n_x, bool bwd) {
  if (n < 2 || n > 24 || k < 1 || k > k2 || k2 > n || lc < 0 || lc > k ||
      T < 1 || B < 1 || B > 65535 || n_diag < 0 || n_diag > kMaxDiag ||
      P < 1 || P * kPlaneBits < n_diag || n_x < 0 || n_pass < 1 ||
      passes[0].kind != kTile)
    return true;
  const int nq = bwd ? 4 : 2;
  for (int i = 0; i < n_pass; ++i) {
    const Pass& ps = passes[i];
    if (ps.op_count < 0 || ps.op_count > kMaxOps || ps.blocks < 1 ||
        ps.ring < 0 || ps.ring > 1)
      return true;
    if (ps.kind == kCross) {
      if (ps.op_count != 1 || ps.ring) return true;
      continue;
    }
    if ((ps.kind != kTile && ps.kind != kMid && ps.kind != kStrided) ||
        (ps.kind == kMid && k2 == k) || (ps.kind == kStrided && k2 == n))
      return true;
    const Shape sh = pass_shape(ps.kind, n, k, k2, lc);
    const int r = ps.rbits;
    if (r < 2 || r > (bwd ? 4 : kMaxRBits) || r > sh.lb) return true;
    if (ps.threads < 32 || ps.threads > kMaxThreads || ps.threads % 32 ||
        ps.threads < (1 << (sh.lb - r)))
      return true;
    size_t limit = 0;
    if (ps.ring) {
      // the TMA ring: forward, staged, at most 256 consumers, a grid of
      // at most B x tiles blocks
      if (bwd || ring_fn(r) == nullptr || ps.stages < 1 ||
          ps.stages > kMaxRing || ps.threads > kRingConsumers ||
          (size_t)ps.blocks > ((size_t)B << (n - sh.lb)) ||
          !ring_fits(ps.kind, sh, n, B))
        return true;
      if (dyn_limit(reinterpret_cast<const void*>(ring_fn(r)), &limit) != 0)
        return true;
      if (ring_smem(ps.kind, sh.lb, signs_staged(n_diag), ps.stages) > limit)
        return true;
      continue;
    }
    if (ps.stages < 0 || ps.stages > kMaxStages ||
        ps.blocks > (1 << (n - sh.lb)))
      return true;
    if (dyn_limit(reinterpret_cast<const void*>(pass_fn(bwd, r)), &limit) !=
        0)
      return true;
    if (pass_smem(ps.kind, sh.lb, nq, signs_staged(n_diag), ps.stages) >
        limit)
      return true;
  }
  return false;
}

// Launch one tile, middle or strided pass at stage s (a ring pass with
// its kind's maps).
cudaError_t launch_pass(const Pass& p, PassArgs a, const Chain& ch, int s,
                        int nq, bool bwd, cudaStream_t st,
                        const RingMaps* maps = nullptr) {
  const Shape sh = pass_shape(p.kind, ch.n, ch.k, ch.k2, ch.lc);
  a.kind = p.kind;
  a.lb = sh.lb;
  a.lcp = sh.lcp;
  a.k1 = sh.k1;
  a.rb = sh.rb;
  a.tiles = 1 << (ch.n - sh.lb);
  a.stage = s;
  a.stages = p.stages;
  a.part_off = p.part_off;
  a.width = p.part_width;
  a.diag_col = p.op_count;
  if (p.ring) {
    ring_fn(p.rbits)<<<p.blocks, p.threads + 32,
                       ring_smem(p.kind, sh.lb, a.signs, a.stages), st>>>(
        a, ch, *maps);
    return cudaGetLastError();
  }
  const size_t smem = pass_smem(p.kind, sh.lb, nq, a.signs, a.stages);
  const PassFn fn = pass_fn(bwd, p.rbits);
  fn<<<dim3(p.blocks, ch.B), p.threads, smem, st>>>(a, ch);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Forward chain over B states [B, d], updated in place in (re, im), which
// hold psi_0 on entry and psi_T on return. passes: host table [n_pass, 10]
// (kind, first op row, op count, blocks per member (the TMA ring: blocks
// over all member x tile pairs), partial offset, partial width, register
// bits, threads (the ring's consumers), ring stages (0: direct), 1 for the
// TMA ring); ops:
// device op rows [n_ops, 6] (slot, kind, local mask a, local mask b,
// scale in halves, round mask); the splits k <= k2 <= n and columns lc
// (pk_plan); tx: [T, B, n_x], n_x angle slots; drift: 0 when h0th is zero
// (then never read).
int dq_pk_forward(float* re, float* im, const float* udm, const float* tx,
                  const float* h0th, const int* planes, const int* ops,
                  const int* passes, int n_pass, int n, int k, int k2,
                  int lc, int T, int B, int n_diag, int P, int n_x,
                  int drift, void* stream) {
  const Pass* ps = reinterpret_cast<const Pass*>(passes);
  (void)cudaGetLastError();  // report this call's errors alone
  if (bad_chain(ps, n_pass, n, k, k2, lc, T, B, n_diag, P, n_x, false))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Chain ch{udm, tx, h0th, planes, n, k, k2, lc, T, B, n_diag, P, n_x,
                 drift};
  // one set of tensor maps per pass kind on the ring, for the whole chain
  RingMaps maps[4];
  bool mapped[4] = {false, false, false, false};
  for (int i = 0; i < n_pass; ++i) {
    if (!ps[i].ring || mapped[ps[i].kind]) continue;
    const int me = ring_maps(&maps[ps[i].kind], ps[i].kind, re, im, planes,
                             n, k, k2, lc, B, P);
    if (me != 0) return me;
    mapped[ps[i].kind] = true;
  }
  cudaError_t e = cudaSuccess;
  for (int s = 0; s <= T; ++s) {
    for (int i = 0; i < n_pass; ++i) {
      if (s == T && i > 0) break;  // the last stage is its phase alone
      const Pass& p = ps[i];
      const int* op = ops + kOpCols * p.op_begin;
      if (p.kind == kCross) {
        cross_forward<<<dim3(p.blocks, B), kCrossThreads, 0, st>>>(
            re, im, ch, op, s);
        e = cudaGetLastError();
      } else {
        PassArgs a{};
        a.pl[0] = re;
        a.pl[1] = im;
        a.ops = op;
        a.n_ops = s < T ? p.op_count : 0;
        a.phase = i == 0;
        a.signs = i == 0 ? signs_staged(n_diag) : 0;
        e = launch_pass(p, a, ch, s, 2, false, st, &maps[p.kind]);
      }
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
                   int n_pass, int stride, int n, int k, int k2, int lc,
                   int T, int B, int n_diag, int P, int n_x, int drift,
                   void* stream) {
  const Pass* ps = reinterpret_cast<const Pass*>(passes);
  (void)cudaGetLastError();  // report this call's errors alone
  if (bad_chain(ps, n_pass, n, k, k2, lc, T, B, n_diag, P, n_x, true) ||
      stride < 1 || ps[0].part_off != 0 ||
      ps[0].part_width != ps[0].op_count + n_diag + 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Chain ch{udm, tx, h0th, planes, n, k, k2, lc, T, B, n_diag, P, n_x,
                 drift};
  cudaError_t e = cudaSuccess;
  for (int s = T; s >= 0; --s) {
    for (int i = n_pass - 1; i >= 0; --i) {
      if (s == T && i > 0) continue;  // the last stage is its phase alone
      const Pass& p = ps[i];
      const int* op = ops + kOpCols * p.op_begin;
      if (p.kind == kCross) {
        cross_backward<<<dim3(p.blocks, B), kCrossThreads, 0, st>>>(
            y_re, y_im, l_re, l_im, ch, op, s, part, stride, p.part_off);
        e = cudaGetLastError();
      } else {
        PassArgs a{};
        a.pl[0] = y_re;
        a.pl[1] = y_im;
        a.pl[2] = l_re;
        a.pl[3] = l_im;
        a.ops = op;
        a.part = part;
        a.stride = stride;
        a.n_ops = s < T ? p.op_count : 0;
        a.phase = i == 0;
        a.signs = i == 0 ? signs_staged(n_diag) : 0;
        e = launch_pass(p, a, ch, s, 4, true, st);
      }
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
