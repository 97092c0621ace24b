// K1 and K2 on Hopper (sm_90a): the whole streamed Strang chain for one
// state (K1) or for a batch of states with per-member or grouped angle
// rows (K2), and the exact O(1)-memory adjoint of each.
//
// Replaces the TPU kernels of diffquantum_tpu/ops/fused_product.py:
//   K1 _make_forward_kernel    (fused_product.py:307, pallas_call :537)
//   K1 _make_backward_kernel   (fused_product.py:376, pallas_call :595)
//   K2 _make_forward_kernel_b  (fused_product.py:672, pallas_call :909)
//   K2 _make_backward_kernel_b (fused_product.py:733, pallas_call :965)
// behind fused_product_evolve / fused_product_evolve_batched /
// fused_rot_block and their custom VJPs. The Python wrappers, the launch
// plan (fp_plan) and the plain PyTorch versions are
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
// inverse op (G^2 = I, K^2 = -I), and writes d theta_half [T, B, d] (the
// merged-row cotangents summed back onto the half-step rows), d theta_x
// [T, B, n_ops] and dpsi_0 [B, d]. Layouts of the JAX contract: psi
// [B, d], theta_half [T, G, d], theta_x [T, Gx, n_ops], G and Gx dividing
// B: consecutive runs of B/G members read one row (the Monte-Carlo
// estimator's branches of one sample share their rows). K1 is B = 1.
//
// What bounds it on this card. Every op mixes amplitudes across the
// state, so the T * (n_ops + 1) stages form one dependent chain per
// member. At the main path's shape (12 qubits, T = 30, 12 ops) a forward
// moves ~0.55 MB and does ~10 MFLOP: the card's rates allow well under a
// microsecond, one SM's fp32 rate ~20 us forward and ~51 us backward.
// What limits a chain is the issue rate of the SM(s) that hold it and the
// latency of whatever synchronises its threads; K2's members are
// independent chains, so K2 is bound by the SMs' issue rate once enough
// members are resident.
//
// What the design does about it (the geometry is the host's plan,
// ops/fused_product.py::fp_plan, which this file checks and never
// chooses).
//  - Registers hold the state. Each thread holds 2^R amplitudes of every
//    plane (forward psi; backward y and lambda) for the whole chain, R = 3
//    while the members leave SMs free (more warps to hide latency), 4 once
//    they fill the card (fewer instructions an amplitude). An amplitude
//    index splits into lane bits (always index bits 0..4), R register
//    bits, warp bits and, past one block, block bits.
//  - Rounds. The host groups a step's ordered ops into rounds whose bits
//    all sit in the round's register and lane bits. An op on register
//    bits runs in registers with no synchronisation; an op on a lane bit
//    (or a hop with one or both bits on lanes) by __shfl_xor_sync, also
//    with no barrier. Only a change of layout between rounds costs an
//    exchange: every thread writes its amplitudes to a buffer in the new
//    layout's order, one barrier, and reads its new ones (the 12-qubit
//    ring: three exchanges a step at R = 3, two at R = 4, against 13
//    barriers a step before). An op's dispatch code (its kind and
//    register ranks) is found by a binary search of uniform branches.
//  - Exchanges. One block a member (mode 'block', up to 13 qubits forward
//    and 12 backward): the buffer is the block's shared memory in index
//    order (lanes on consecutive words: no bank conflicts), re and im as
//    float2, double-buffered where two fit (one barrier an exchange), the
//    backward's four planes in two passes where one buffer of four does
//    not fit. Past that a cooperative grid (mode 'grid', 256-thread blocks,
//    R = 3): the state goes through a double buffer in global memory (L2)
//    behind one grid barrier an exchange. Every block of a launch must be
//    resident, so a batch whose blocks are not goes in equal chunks of
//    members, one launch each. (A thread-block cluster a member,
//    exchanging through DSMEM, measured slower: at 16 and 17 qubits, and
//    at 14 qubits B = 64 over a forward and backward pair.)
//  - Phase rows and angles. The phase stage runs in the last round's
//    layout, elementwise. Each thread copies the theta row values it will
//    need (cp.async, its own slots of a two-row ring in shared memory) a
//    stage ahead, and each row once; each lane copies the next step's
//    angles the same way, and a warp turns them into (cos, sin) itself.
//    Only the thread that copies a slot reads it: no barrier. sincosf,
//    not __sincosf.
//  - d theta_x. Each thread sums its share of an op's partial over its
//    amplitudes, the warp sums it by shuffles, lane 0 stores it to a
//    [B, T, n_ops, warps] scratch; after the chain one fixed-order sum
//    over the warps per (step, op). No atomics: the backward is
//    bit-identical from run to run.
//  - Several K2 members an SM: a member's block is 2^(n-R) threads (256
//    at 12 qubits, R = 4) with launch bounds that cap a forward thread at
//    80 registers (64 at R = 3) and a backward one at 128, so 3 forward
//    or 2 backward members of 12 qubits are resident on an SM.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int kLaneBits = 5;
constexpr int kLocLane = 8;        // an op location: rank 0..R-1 or 8 + lane bit
constexpr int kMaxOps = 128;
constexpr int kMaxRounds = 128;
constexpr int kGridThreads = 256;  // mode 'grid': 2 blocks an SM at 128
constexpr int kGridBlocksSM = 2;   //   registers a thread
constexpr int kPlanError = 1000;   // 1001-1009: a plan the kernels refuse
constexpr int kMinQubits = 10, kMaxQubits = 17;
constexpr size_t kStaticBytes = 6144;  // FP_STATIC_BYTES
constexpr size_t kSmemBlock = 232448;

// Launch bounds by direction and register bits R (2^R amplitudes of each
// plane a thread): the largest block a plan may use, and the bound that
// sets a thread's registers (65536 / bound: forward R = 3 64, R = 4 80;
// backward 128), mirrored by FP_MAX_THREADS and FP_REGS.
__host__ __device__ constexpr int max_threads(bool bwd, int R) {
  return !bwd && R == 3 ? 1024 : 512;
}
__host__ __device__ constexpr int bound_threads(bool bwd, int R) {
  return bwd ? 512 : R == 3 ? 1024 : 768;
}

enum OpKind : int { kX = 0, kY = 1, kHop = 2 };
enum Mode : int { kBlock = 0, kGrid = 1 };

// one round of a step: its op rows [begin, begin + count), the index bits
// it holds in registers and the bits that index blocks
struct RoundRow {
  int begin, count;
  unsigned reg, blk;
};

struct Params {
  const float* th;    // theta_half [T, G, d]
  const float* tx;    // theta_x [T, Gx, n_ops]
  const float* in0;   // forward: psi re, im; backward: psi_T re, im,
  const float* in1;   //   lambda_T re, im  ([B, d] each)
  const float* in2;
  const float* in3;
  float* out0;        // forward: psi_T; backward: dpsi_0 ([B, d])
  float* out1;
  const int4* ops;    // (slot, kind, location a, location b) per op row
  float* g_th;        // backward: d theta_half [T, B, d]
  float* g_tx;        // backward: d theta_x [T, B, n_ops]
  float* part;        // backward: warp partials [B, T, n_ops, warps]
  float* xbuf;        // mode 'grid': [members a launch, 2, planes, d]
  int n, T, n_ops, n_rounds, B, th_groups, tx_groups, bufs, blocks;
  int member0;        // this launch's first member
  int xplanes;        // planes an exchange pass moves (backward: 2 or 4)
  RoundRow rounds[kMaxRounds];
};

struct Shared {
  int4 ops[kMaxOps];            // (slot, dispatch code, lane mask, 0)
  RoundRow rounds[kMaxRounds];
  unsigned rm[kMaxRounds][4];   // a round's register bit masks, ascending
};
static_assert(sizeof(Shared) <= kStaticBytes, "static shared memory");

// ---------------------------------------------------------------------------
// layouts: where a thread's register slot i sits in the state
// ---------------------------------------------------------------------------

// deposit the low bits of v at the set bits of mask, ascending
__device__ __forceinline__ unsigned pdep(unsigned v, unsigned mask) {
  unsigned r = 0;
  for (unsigned b = 1; mask; b <<= 1) {
    const unsigned low = mask & (0u - mask);
    if (v & b) r |= low;
    mask ^= low;
  }
  return r;
}

// gather the bits of v at the set bits of mask into the low bits
__device__ __forceinline__ unsigned pext(unsigned v, unsigned mask) {
  unsigned r = 0;
  for (unsigned b = 1; mask; b <<= 1) {
    const unsigned low = mask & (0u - mask);
    if (v & low) r |= b;
    mask ^= low;
  }
  return r;
}

// v with the bits of mask taken out (the bits above each shifted down)
__device__ __forceinline__ unsigned squeeze(unsigned v, unsigned mask) {
  while (mask) {
    const unsigned hi = 1u << (31 - __clz(mask));
    v = ((v >> 1) & ~(hi - 1u)) | (v & (hi - 1u));
    mask ^= hi;
  }
  return v;
}

template <int R>
struct Layout {
  unsigned base;      // lane | warp bits | block bits of this thread
  unsigned m[R];      // register bit r's mask (ascending)
  // the index of register slot i (i is a constant after unrolling)
  __device__ __forceinline__ unsigned at(int i) const {
    unsigned j = base;
#pragma unroll
    for (int r = 0; r < R; ++r)
      if ((i >> r) & 1) j |= m[r];
    return j;
  }
};

// the layout of round r for this thread, from the block's tables (wbase:
// a warp's warp and block bits in each round)
template <int R>
__device__ __forceinline__ Layout<R> layout_of(const Shared& sh,
                                               const unsigned* wbase, int r) {
  Layout<R> L;
  L.base = (threadIdx.x & 31u) | wbase[r * (blockDim.x >> 5) +
                                       (threadIdx.x >> 5)];
#pragma unroll
  for (int i = 0; i < R; ++i) L.m[i] = sh.rm[r][i];
  return L;
}

// ---------------------------------------------------------------------------
// ops on register bits: both amplitudes of a pair in this thread
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
// of d theta = Re<lambda, dR/dtheta x>, read off the op's output y.
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

// X/Y on register rank A (B < 0): slot i has bit A clear; hop on ranks
// (A, B): slot i has bit A clear and bit B set
template <int A, int B>
__device__ __forceinline__ constexpr bool first_of_pair(int i) {
  constexpr int b = B < 0 ? 0 : B;
  return B < 0 ? !((i >> A) & 1) : (!((i >> A) & 1) && ((i >> b) & 1));
}

template <int A, int B>
__device__ __forceinline__ constexpr int partner(int i) {
  constexpr int b = B < 0 ? 0 : B;
  return B < 0 ? (i | (1 << A)) : (i ^ (1 << A) ^ (1 << b));
}

// An op on register ranks (A, B) (B < 0 for X/Y): Q = 2 applies it, Q = 4
// undoes it and returns the thread's partial.
template <int R, int Q, int A, int B>
__device__ __forceinline__ float reg_op(float (&x)[Q][1 << R], bool y,
                                        float c, float s) {
  float g = 0.f;
#pragma unroll
  for (int i = 0; i < (1 << R); ++i) {
    if (!first_of_pair<A, B>(i)) continue;
    const int j = partner<A, B>(i);
    if constexpr (Q == 2)
      rot_pair(y, c, s, x[0][i], x[1][i], x[0][j], x[1][j]);
    else
      g += undo_pair(y, c, s, x[0][i], x[1][i], x[0][j], x[1][j], x[2][i],
                     x[3][i], x[2][j], x[3][j]);
  }
  return g;
}

// ---------------------------------------------------------------------------
// ops with a bit on lanes: the partner amplitude is in lane ^ lm
// ---------------------------------------------------------------------------

__device__ __forceinline__ float shfl(float v, unsigned lm) {
  return __shfl_xor_sync(0xffffffffu, v, (int)lm);
}

// One amplitude's update from its partner (pr, pi): X or an active hop,
// y = c x - i s p; Y, y = c x + sg s p (sg = +1 where the op's bit is 1).
__device__ __forceinline__ void fwd_amp(bool ytype, bool active, float sg,
                                        float c, float s, float& xr,
                                        float& xi, float pr, float pi) {
  if (ytype) {
    xr = c * xr + sg * s * pr;
    xi = c * xi + sg * s * pi;
  } else if (active) {
    const float r = c * xr + s * pi;
    xi = c * xi - s * pr;
    xr = r;
  }
}

// Undo one amplitude (y, l) from its partner's (py, pl); returns its share
// of the partial (the pair's sum over its two sides is undo_pair's).
__device__ __forceinline__ float bwd_amp(bool ytype, bool active, float sg,
                                         float c, float s, float& yr,
                                         float& yi, float& lr, float& li,
                                         float pyr, float pyi, float plr,
                                         float pli) {
  if (ytype) {
    // x = c y - sg s p; lam_x = c lam - sg s lam_p
    const float g = sg * (lr * pyr + li * pyi);
    yr = c * yr - sg * s * pyr;
    yi = c * yi - sg * s * pyi;
    lr = c * lr - sg * s * plr;
    li = c * li - sg * s * pli;
    return g;
  }
  if (!active) return 0.f;
  // x = c y + i s p; lam_x = c lam + i s lam_p
  const float g = lr * pyi - li * pyr;
  const float xr = c * yr - s * pyi;
  yi = c * yi + s * pyr;
  yr = xr;
  const float nr = c * lr - s * pli;
  li = c * li + s * plr;
  lr = nr;
  return g;
}

// X or Y on lane mask lm, or a hop on two lane bits lm: the partner is the
// same slot of lane ^ lm.
template <int R, int Q>
__device__ __forceinline__ float lane_op(float (&x)[Q][1 << R], int kind,
                                         unsigned lm, unsigned lane, float c,
                                         float s) {
  const bool ytype = kind == kY;
  const bool active = kind != kHop || __popc(lane & lm) == 1;
  const float sg = (lane & lm) ? 1.f : -1.f;
  float g = 0.f;
#pragma unroll
  for (int i = 0; i < (1 << R); ++i) {
    if constexpr (Q == 2) {
      const float pr = shfl(x[0][i], lm), pi = shfl(x[1][i], lm);
      fwd_amp(ytype, active, sg, c, s, x[0][i], x[1][i], pr, pi);
    } else {
      const float pyr = shfl(x[0][i], lm), pyi = shfl(x[1][i], lm);
      const float plr = shfl(x[2][i], lm), pli = shfl(x[3][i], lm);
      g += bwd_amp(ytype, active, sg, c, s, x[0][i], x[1][i], x[2][i],
                   x[3][i], pyr, pyi, plr, pli);
    }
  }
  return g;
}

// A hop with one bit on register rank A and one on lane mask lm: slot i's
// partner is slot i ^ 2^A of lane ^ lm; the pair is active where the two
// bits differ.
template <int R, int Q, int A>
__device__ __forceinline__ float mixed_hop(float (&x)[Q][1 << R], unsigned lm,
                                           unsigned lane, float c, float s) {
  const int lb = (lane & lm) ? 1 : 0;
  float g = 0.f;
#pragma unroll
  for (int i = 0; i < (1 << R); ++i) {
    if ((i >> A) & 1) continue;
    const int j = i | (1 << A);
    // slot i is active where the lane bit is 1, slot j where it is 0
    if constexpr (Q == 2) {
      const float pir = shfl(x[0][j], lm), pii = shfl(x[1][j], lm);
      const float pjr = shfl(x[0][i], lm), pji = shfl(x[1][i], lm);
      fwd_amp(false, lb == 1, 1.f, c, s, x[0][i], x[1][i], pir, pii);
      fwd_amp(false, lb == 0, 1.f, c, s, x[0][j], x[1][j], pjr, pji);
    } else {
      const float piyr = shfl(x[0][j], lm), piyi = shfl(x[1][j], lm);
      const float pilr = shfl(x[2][j], lm), pili = shfl(x[3][j], lm);
      const float pjyr = shfl(x[0][i], lm), pjyi = shfl(x[1][i], lm);
      const float pjlr = shfl(x[2][i], lm), pjli = shfl(x[3][i], lm);
      g += bwd_amp(false, lb == 1, 1.f, c, s, x[0][i], x[1][i], x[2][i],
                   x[3][i], piyr, piyi, pilr, pili);
      g += bwd_amp(false, lb == 0, 1.f, c, s, x[0][j], x[1][j], x[2][j],
                   x[3][j], pjyr, pjyi, pjlr, pjli);
    }
  }
  return g;
}

// Dispatch codes of an op, computed once per block from its row (kind,
// location a, location b): X on register rank A is A, Y is R + A, a hop on
// ranks (A, B) 2R + A R + B; then an op on lanes: X, Y, a hop on two lane
// bits, and R codes of a hop with one bit on register rank A.
template <int R>
struct Codes {
  static constexpr int kLaneX = 2 * R + R * R;
  static constexpr int kLaneY = kLaneX + 1;
  static constexpr int kLaneHop = kLaneX + 2;
  static constexpr int kMixedHop = kLaneX + 3;
  static constexpr int kCount = kMixedHop + R;
};

// (code, lane mask) of op row (kind, a, b)
template <int R>
__device__ __forceinline__ int2 op_code(int kind, int a, int b) {
  const bool la = a >= kLocLane, lb = b >= kLocLane;
  if (!la && !lb) {
    if (kind == kX) return make_int2(a, 0);
    if (kind == kY) return make_int2(R + a, 0);
    return make_int2(2 * R + a * R + b, 0);
  }
  if (kind != kHop)
    return make_int2(kind == kX ? Codes<R>::kLaneX : Codes<R>::kLaneY,
                     1 << (a - kLocLane));
  if (la && lb)
    return make_int2(Codes<R>::kLaneHop,
                     (1 << (a - kLocLane)) | (1 << (b - kLocLane)));
  return make_int2(Codes<R>::kMixedHop + (la ? b : a),
                   1 << ((la ? a : b) - kLocLane));
}

template <int R, int Q, int CODE>
__device__ __forceinline__ float op_case(float (&x)[Q][1 << R], unsigned lm,
                                         unsigned lane, float c, float s) {
  using C = Codes<R>;
  if constexpr (CODE < R) {
    return reg_op<R, Q, CODE, -1>(x, false, c, s);
  } else if constexpr (CODE < 2 * R) {
    return reg_op<R, Q, CODE - R, -1>(x, true, c, s);
  } else if constexpr (CODE < C::kLaneX) {
    constexpr int A = (CODE - 2 * R) / R, B = (CODE - 2 * R) % R;
    if constexpr (A == B)
      return 0.f;  // no such op
    else
      return reg_op<R, Q, A, B>(x, false, c, s);
  } else if constexpr (CODE == C::kLaneX) {
    return lane_op<R, Q>(x, kX, lm, lane, c, s);
  } else if constexpr (CODE == C::kLaneY) {
    return lane_op<R, Q>(x, kY, lm, lane, c, s);
  } else if constexpr (CODE == C::kLaneHop) {
    return lane_op<R, Q>(x, kHop, lm, lane, c, s);
  } else {
    return mixed_hop<R, Q, CODE - C::kMixedHop>(x, lm, lane, c, s);
  }
}

// Apply (Q = 2) or undo (Q = 4) an op by its code (a binary search over
// the codes, a few uniform branches); returns the thread's partial of
// d theta (Q = 4).
template <int R, int Q, int LO = 0, int HI = Codes<R>::kCount>
__device__ __forceinline__ float run_op(float (&x)[Q][1 << R], int code,
                                        unsigned lm, unsigned lane, float c,
                                        float s) {
  if constexpr (HI - LO == 1) {
    return op_case<R, Q, LO>(x, lm, lane, c, s);
  } else {
    constexpr int MID = (LO + HI) / 2;
    if (code < MID) return run_op<R, Q, LO, MID>(x, code, lm, lane, c, s);
    return run_op<R, Q, MID, HI>(x, code, lm, lane, c, s);
  }
}

// ---------------------------------------------------------------------------
// exchanges: from one round's layout to the next
// ---------------------------------------------------------------------------

// One pass of an exchange over planes Q0..QN-1 (the backward's four planes
// go in one pass or, where shared memory holds two, in two), each pair of
// planes (re, im) as float2 words.
template <int R, int MODE, int Q, int Q0, int QN>
__device__ __forceinline__ void exchange_pass(float (&x)[Q][1 << R],
                                              const Layout<R>& from,
                                              const Layout<R>& to, float* buf,
                                              const Params& p, int& xc) {
  const unsigned d = 1u << p.n;
  if constexpr (MODE == kBlock) {
    // the state in index order; lanes hold consecutive words: no bank
    // conflicts
    float2* b = reinterpret_cast<float2*>(
        buf + (p.bufs == 2 ? (size_t)(xc & 1) * (QN - Q0) * d : 0));
    if (p.bufs == 1) __syncthreads();
#pragma unroll
    for (int i = 0; i < (1 << R); ++i) {
      const unsigned j = from.at(i);
#pragma unroll
      for (int q = Q0; q < QN; q += 2)
        b[(q - Q0) / 2 * d + j] = make_float2(x[q][i], x[q + 1][i]);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < (1 << R); ++i) {
      const unsigned j = to.at(i);
#pragma unroll
      for (int q = Q0; q < QN; q += 2) {
        const float2 v = b[(q - Q0) / 2 * d + j];
        x[q][i] = v.x;
        x[q + 1][i] = v.y;
      }
    }
  } else {
    // two global buffers a member: an exchange's writes can not meet the
    // reads of the one before, which the barrier between them ends
    const unsigned m = blockIdx.x / (unsigned)p.blocks;
    float2* b = reinterpret_cast<float2*>(p.xbuf) +
                ((size_t)m * 2 + (xc & 1)) * (Q / 2) * d;
#pragma unroll
    for (int i = 0; i < (1 << R); ++i) {
      const unsigned j = from.at(i);
#pragma unroll
      for (int q = Q0; q < QN; q += 2)
        __stcg(b + (size_t)(q / 2) * d + j, make_float2(x[q][i], x[q + 1][i]));
    }
    cg::this_grid().sync();
#pragma unroll
    for (int i = 0; i < (1 << R); ++i) {
      const unsigned j = to.at(i);
#pragma unroll
      for (int q = Q0; q < QN; q += 2) {
        const float2 v = __ldcg(b + (size_t)(q / 2) * d + j);
        x[q][i] = v.x;
        x[q + 1][i] = v.y;
      }
    }
  }
  ++xc;
}

template <int R, int MODE, int Q>
__device__ __forceinline__ void exchange(float (&x)[Q][1 << R],
                                         const Shared& sh,
                                         const unsigned* wbase, int rf,
                                         int rt, float* buf, const Params& p,
                                         int& xc) {
  const Layout<R> from = layout_of<R>(sh, wbase, rf);
  const Layout<R> to = layout_of<R>(sh, wbase, rt);
  if constexpr (MODE == kGrid || Q == 2) {
    exchange_pass<R, MODE, Q, 0, Q>(x, from, to, buf, p, xc);
  } else if (p.xplanes == 4) {
    exchange_pass<R, MODE, Q, 0, 4>(x, from, to, buf, p, xc);
  } else {
    exchange_pass<R, MODE, Q, 0, 2>(x, from, to, buf, p, xc);
    exchange_pass<R, MODE, Q, 2, 4>(x, from, to, buf, p, xc);
  }
}

// ---------------------------------------------------------------------------
// phase rows and angles: a ring of thread-private shared-memory slots
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most `pending` (0 or 1) of this thread's groups are in
// flight
__device__ __forceinline__ void cp_wait(int pending) {
  if (pending == 0)
    asm volatile("cp.async.wait_group 0;" ::: "memory");
  else
    asm volatile("cp.async.wait_group 1;" ::: "memory");
}

__device__ __forceinline__ unsigned member_of(const Params& p) {
  return (unsigned)p.member0 + blockIdx.x / (unsigned)p.blocks;
}

// Where the member reads its rows: theta rows are shared by runs of
// B / groups consecutive members.
__device__ __forceinline__ const float* th_row(const Params& p, int k) {
  return p.th + (((size_t)k * p.th_groups +
                  member_of(p) / (unsigned)(p.B / p.th_groups)) << p.n);
}
__device__ __forceinline__ const float* tx_row(const Params& p, int k) {
  return p.tx + ((size_t)k * p.tx_groups +
                 member_of(p) / (unsigned)(p.B / p.tx_groups)) * p.n_ops;
}

// The dynamic shared memory of a block: the exchange buffer, each warp's
// (cos, sin) table, the ring of phase rows (two rows: slot i of thread t
// of row r at ((r % 2) 2^R + i) threads + t), the backward's held phase
// cotangents (i threads + t), each warp's staged angles (n_ops), and the
// warps' base indices of each round ([n_rounds][warps]). Every slot of the
// ring, the held rows and the staged angles is read only by the thread
// that wrote it: no barrier.
template <int R, int MODE, int Q>
struct Smem {
  float2* cst;
  float* ring;
  float* held;
  float* staged;
  unsigned* wbase;
  __device__ __forceinline__ Smem(float* dyn, const Params& p) {
    const size_t exch =
        MODE == kGrid ? 0 : (size_t)p.xplanes *
                                (((size_t)1 << p.n) / p.blocks) * p.bufs;
    const unsigned warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
    float* tables = dyn + exch;
    cst = reinterpret_cast<float2*>(tables) + warp * p.n_ops;
    float* rest = tables + 2 * warps * p.n_ops;
    ring = rest + threadIdx.x;
    rest += (2 * blockDim.x) << R;
    held = rest + threadIdx.x;
    if (Q == 4) rest += blockDim.x << R;
    staged = rest + warp * p.n_ops;
    wbase = reinterpret_cast<unsigned*>(rest + warps * p.n_ops);
  }
  __device__ __forceinline__ float* row_slot(int r, int i) const {
    return ring + (size_t)(((r & 1) << R) + i) * blockDim.x;
  }
};

// start copying row r's values at this thread's indices into its ring
// slots and, with k >= 0, step k's angles into the warp's staging
template <int R, int MODE, int Q>
__device__ __forceinline__ void issue_rows(const Smem<R, MODE, Q>& sm,
                                           const Params& p, const Shared& sh,
                                           const Layout<R>& P, int r,
                                           int k) {
  if (r >= 0 && r < p.T) {
    const float* th = th_row(p, r);
#pragma unroll
    for (int i = 0; i < (1 << R); ++i) cp_async4(sm.row_slot(r, i), th + P.at(i));
  }
  if (k >= 0 && k < p.T) {
    const float* tx = tx_row(p, k);
    for (int o = threadIdx.x & 31; o < p.n_ops; o += 32)
      cp_async4(sm.staged + o, tx + sh.ops[o].x);
  }
  cp_commit();
}

// merged phase angle a_k of register slot i, from the ring (bitwise equal
// to the host-side merge_phase_rows)
template <int R, int MODE, int Q>
__device__ __forceinline__ float merged_angle(const Smem<R, MODE, Q>& sm,
                                              int k, int T, int i) {
  if (k == 0) return *sm.row_slot(0, i);
  if (k == T) return *sm.row_slot(k - 1, i);
  return *sm.row_slot(k - 1, i) + *sm.row_slot(k, i);
}

// the warp's (cos, sin) table of a step, from its staged angles
template <int R, int MODE, int Q>
__device__ __forceinline__ void warp_angles(const Smem<R, MODE, Q>& sm,
                                            const Params& p) {
  __syncwarp();
  for (int o = threadIdx.x & 31; o < p.n_ops; o += 32) {
    float s, c;
    sincosf(sm.staged[o], &s, &c);
    sm.cst[o] = make_float2(c, s);
  }
  __syncwarp();
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The op rows as (slot, code, lane mask), the rounds, their register bit
// masks and each warp's base index in each round, in shared memory.
template <int R>
__device__ __forceinline__ void load_tables(const Params& p, Shared& sh,
                                            unsigned* wbase) {
  for (int o = threadIdx.x; o < p.n_ops; o += blockDim.x) {
    const int4 op = p.ops[o];
    const int2 code = op_code<R>(op.y, op.z, op.w);
    sh.ops[o] = make_int4(op.x, code.x, code.y, 0);
  }
  const unsigned warps = blockDim.x >> 5;
  const unsigned rank = blockIdx.x % (unsigned)p.blocks;
  const unsigned high = ((1u << p.n) - 1u) & ~((1u << kLaneBits) - 1u);
  for (int r = threadIdx.x; r < p.n_rounds; r += blockDim.x) {
    sh.rounds[r] = p.rounds[r];
    unsigned m = p.rounds[r].reg;
    for (int i = 0; i < R; ++i) {
      sh.rm[r][i] = m & (0u - m);
      m &= m - 1u;
    }
  }
  for (unsigned e = threadIdx.x; e < p.n_rounds * warps; e += blockDim.x) {
    const RoundRow rd = p.rounds[e / warps];
    wbase[e] = pdep(e % warps, high & ~rd.reg & ~rd.blk) | pdep(rank, rd.blk);
  }
  __syncthreads();
}

template <int R, int Q>
__device__ __forceinline__ float apply(float (&x)[Q][1 << R],
                                       const Shared& sh, const float2* cst,
                                       int o) {
  const int4 op = sh.ops[o];
  const float2 cs = cst[o];
  return run_op<R, Q>(x, op.y, (unsigned)op.z, threadIdx.x & 31u, cs.x,
                      cs.y);
}

template <int R, int MODE>
__global__ void __launch_bounds__(
    MODE == kGrid ? kGridThreads : bound_threads(false, R),
    MODE == kGrid ? kGridBlocksSM : 1)
forward_kernel(const __grid_constant__ Params p) {
  extern __shared__ float4 dyn4[];
  float* dyn = reinterpret_cast<float*>(dyn4);
  __shared__ Shared sh;
  const Smem<R, MODE, 2> sm(dyn, p);
  load_tables<R>(p, sh, sm.wbase);
  const unsigned d = 1u << p.n;
  const size_t mo = (size_t)member_of(p) * d;
  const int last = p.n_rounds - 1;
  const Layout<R> P = layout_of<R>(sh, sm.wbase, last);

  issue_rows(sm, p, sh, P, 0, 0);
  float x[2][1 << R];
#pragma unroll
  for (int i = 0; i < (1 << R); ++i) {
    const unsigned j = P.at(i);
    x[0][i] = p.in0[mo + j];
    x[1][i] = p.in1[mo + j];
  }
  int xc = 0;
  for (int k = 0;; ++k) {
    cp_wait(0);  // row k and step k's angles
#pragma unroll
    for (int i = 0; i < (1 << R); ++i) {
      float s, c;
      sincosf(merged_angle(sm, k, p.T, i), &s, &c);
      const float xr = x[0][i], xi = x[1][i];
      x[0][i] = c * xr + s * xi;
      x[1][i] = c * xi - s * xr;
    }
    if (k == p.T) break;
    warp_angles(sm, p);
    // row k-1's slots and the staged angles are free: the next ones load
    // during this step
    issue_rows(sm, p, sh, P, k + 1, k + 1);
    int cur = last;
    for (int r = 0; r < p.n_rounds; ++r) {
      if (sh.rounds[r].reg != sh.rounds[cur].reg ||
          sh.rounds[r].blk != sh.rounds[cur].blk) {
        exchange<R, MODE, 2>(x, sh, sm.wbase, cur, r, dyn, p, xc);
        cur = r;
      }
      const int end = sh.rounds[r].begin + sh.rounds[r].count;
      for (int o = sh.rounds[r].begin; o < end; ++o) apply<R, 2>(x, sh, sm.cst, o);
    }
  }
#pragma unroll
  for (int i = 0; i < (1 << R); ++i) {
    const unsigned j = P.at(i);
    p.out0[mo + j] = x[0][i];
    p.out1[mo + j] = x[1][i];
  }
}

template <int R, int MODE>
__global__ void __launch_bounds__(
    MODE == kGrid ? kGridThreads : bound_threads(true, R),
    MODE == kGrid ? kGridBlocksSM : 1)
backward_kernel(const __grid_constant__ Params p) {
  extern __shared__ float4 dyn4[];
  float* dyn = reinterpret_cast<float*>(dyn4);
  __shared__ Shared sh;
  const Smem<R, MODE, 4> sm(dyn, p);
  load_tables<R>(p, sh, sm.wbase);
  const unsigned d = 1u << p.n;
  const unsigned m = member_of(p);
  const size_t mo = (size_t)m * d;
  const unsigned warps = blockDim.x >> 5;
  const unsigned W = (unsigned)p.blocks * warps;  // a member's warps
  const int last = p.n_rounds - 1;
  const Layout<R> P = layout_of<R>(sh, sm.wbase, last);

  issue_rows(sm, p, sh, P, p.T - 1, p.T - 1);
  // y: the state being rebuilt (x[0], x[1]); its cotangent lambda (x[2],
  // x[3])
  float x[4][1 << R];
#pragma unroll
  for (int i = 0; i < (1 << R); ++i) {
    const unsigned j = P.at(i);
    x[0][i] = p.in0[mo + j];
    x[1][i] = p.in1[mo + j];
    x[2][i] = p.in2[mo + j];
    x[3][i] = p.in3[mo + j];
  }
  int xc = 0;
  for (int k = p.T; k >= 0; --k) {
    if (k < p.T) {
      // undo step k's rounds, last op first
      cp_wait(0);  // step k's angles (and row k-1)
      warp_angles(sm, p);
      issue_rows(sm, p, sh, P, -1, k - 1);
      float* part = p.part + ((size_t)m * p.T + k) * p.n_ops * W +
                    (blockIdx.x % (unsigned)p.blocks) * warps +
                    (threadIdx.x >> 5);
      int cur = last;
      for (int r = last; r >= 0; --r) {
        if (sh.rounds[r].reg != sh.rounds[cur].reg ||
            sh.rounds[r].blk != sh.rounds[cur].blk) {
          exchange<R, MODE, 4>(x, sh, sm.wbase, cur, r, dyn, p, xc);
          cur = r;
        }
        for (int o = sh.rounds[r].begin + sh.rounds[r].count - 1;
             o >= sh.rounds[r].begin; --o) {
          const float g = warp_sum(apply<R, 4>(x, sh, sm.cst, o));
          if ((threadIdx.x & 31u) == 0) __stcg(part + (size_t)o * W, g);
        }
      }
      if (cur != last)
        exchange<R, MODE, 4>(x, sh, sm.wbase, cur, last, dyn, p, xc);
    }
    // undo the merged phase a_k; its cotangent feeds half-step rows k-1
    // and k (row k: this stage's and stage k+1's, held)
    cp_wait(k < p.T ? 1 : 0);  // rows k-1 and k
    float* gth = p.g_th + ((size_t)k * p.B + m) * d;
#pragma unroll
    for (int i = 0; i < (1 << R); ++i) {
      const unsigned j = P.at(i);
      float s, c;
      sincosf(merged_angle(sm, k, p.T, i), &s, &c);
      const float y0 = x[0][i], y1 = x[1][i], l0 = x[2][i], l1 = x[3][i];
      const float g = l0 * y1 - l1 * y0;
      float* h = sm.held + (size_t)i * blockDim.x;
      if (k < p.T) gth[j] = g + *h;
      *h = g;
      x[0][i] = c * y0 - s * y1;
      x[1][i] = s * y0 + c * y1;
      x[2][i] = c * l0 - s * l1;
      x[3][i] = s * l0 + c * l1;
    }
    // row k's slots are free (stages k and k+1 have read it)
    issue_rows(sm, p, sh, P, k - 2, -1);
  }
#pragma unroll
  for (int i = 0; i < (1 << R); ++i) {
    const unsigned j = P.at(i);
    p.out0[mo + j] = x[2][i];
    p.out1[mo + j] = x[3][i];
  }
  cp_wait(0);

  // d theta_x: the member's warp partials summed in a fixed order
  if constexpr (MODE == kBlock)
    __syncthreads();
  else
    cg::this_grid().sync();
  const unsigned items = (unsigned)p.T * (unsigned)p.n_ops;
  for (unsigned it = (blockIdx.x % (unsigned)p.blocks) * blockDim.x +
                     threadIdx.x;
       it < items; it += (unsigned)p.blocks * blockDim.x) {
    const unsigned k = it / (unsigned)p.n_ops, o = it % (unsigned)p.n_ops;
    const float* src = p.part + (((size_t)m * p.T + k) * p.n_ops + o) * W;
    float v = 0.f;
    for (unsigned w = 0; w < W; ++w) v += __ldcg(src + w);
    p.g_tx[((size_t)k * p.B + m) * p.n_ops + sh.ops[o].x] = v;
  }
}

// ---------------------------------------------------------------------------
// the host side: check the plan, launch
// ---------------------------------------------------------------------------

int ilog2(unsigned v) { return 31 - __builtin_clz(v); }

bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

// The host table fp_plan wrote (ops/fused_product.py::_fp_launch): a
// header, then the op rows and the rounds, four ints each.
enum Head : int {
  hN, hT, hOps, hRounds, hB, hThGroups, hTxGroups, hRbits, hMode, hThreads,
  hBlocks, hBufs, hXplanes, hSmem, hChunk, kHead
};

// The geometry fp_plan chose, checked against what the kernels take; the
// rounds copied into the launch parameters.
int check_plan(Params& p, const int* host, bool backward) {
  p.n = host[hN];
  p.T = host[hT];
  p.n_ops = host[hOps];
  p.n_rounds = host[hRounds];
  p.B = host[hB];
  p.th_groups = host[hThGroups];
  p.tx_groups = host[hTxGroups];
  p.bufs = host[hBufs];
  p.blocks = host[hBlocks];
  p.xplanes = host[hXplanes];
  const int rbits = host[hRbits], mode = host[hMode], threads = host[hThreads],
            smem = host[hSmem], chunk = host[hChunk];
  const int* ops_host = host + kHead;
  const int* rounds_host = ops_host + 4 * (p.n_ops > 0 ? p.n_ops : 0);
  // an exchange pass's planes: all of them, or the backward's two by two
  const int planes = backward ? 4 : 2;
  if (p.n < kMinQubits || p.n > kMaxQubits || p.T < 1 || p.n_ops < 0 ||
      p.n_ops > kMaxOps || p.n_rounds < 1 || p.n_rounds > kMaxRounds ||
      p.B < 1 || p.th_groups < 1 || p.tx_groups < 1 ||
      p.B % p.th_groups != 0 || p.B % p.tx_groups != 0)
    return kPlanError + 1;
  const unsigned d = 1u << p.n;
  if (rbits < 3 || rbits > 4 || mode < kBlock || mode > kGrid ||
      !pow2(threads) || threads < 32 ||
      threads > (mode == kGrid ? kGridThreads
                               : max_threads(backward, rbits)) ||
      !pow2(p.blocks) || ((size_t)threads * p.blocks << rbits) != d)
    return kPlanError + 2;
  if ((mode == kBlock && (p.blocks != 1 || chunk != p.B)) ||
      (mode == kGrid &&
       (threads != kGridThreads || rbits != 3 || chunk < 1 || chunk > p.B)))
    return kPlanError + 3;
  if (p.bufs < 1 || p.bufs > 2 || (p.bufs == 2 && mode != kBlock) ||
      !(p.xplanes == planes || (backward && p.xplanes == 2 && mode != kGrid)))
    return kPlanError + 4;
  // exchange buffer, (cos, sin) tables, ring of two rows, held
  // cotangents, staged angles, warp bases
  const size_t want =
      (mode == kGrid ? 0 : (size_t)p.xplanes * 4 * (d / p.blocks) * p.bufs) +
      (size_t)(threads / 32) * (p.n_ops * 12 + p.n_rounds * 4) +
      ((size_t)(backward ? 12 : 8) * threads << rbits);
  if ((size_t)smem != want || want + kStaticBytes > kSmemBlock)
    return kPlanError + 5;
  const unsigned high = (d - 1u) & ~((1u << kLaneBits) - 1u);
  const int cbits = ilog2((unsigned)p.blocks);
  int next = 0;
  for (int r = 0; r < p.n_rounds; ++r) {
    RoundRow& rd = p.rounds[r];
    rd.begin = rounds_host[4 * r];
    rd.count = rounds_host[4 * r + 1];
    rd.reg = (unsigned)rounds_host[4 * r + 2];
    rd.blk = (unsigned)rounds_host[4 * r + 3];
    if (rd.begin != next || rd.count < 0 || (rd.reg & ~high) ||
        (rd.blk & ~high) || (rd.reg & rd.blk) ||
        __builtin_popcount(rd.reg) != rbits ||
        __builtin_popcount(rd.blk) != cbits)
      return kPlanError + 6;
    next += rd.count;
  }
  if (next != p.n_ops) return kPlanError + 6;
  for (int o = 0; o < p.n_ops; ++o) {
    const int kind = ops_host[4 * o + 1], a = ops_host[4 * o + 2],
              b = ops_host[4 * o + 3];
    auto loc = [rbits](int v) {
      return (v >= 0 && v < rbits) ||
             (v >= kLocLane && v < kLocLane + kLaneBits);
    };
    if (kind < kX || kind > kHop || !loc(a) || (kind == kHop) != (b >= 0) ||
        (b >= 0 && (!loc(b) || a == b)))
      return kPlanError + 7;
  }
  return 0;
}

// The largest dynamic shared memory each kernel was opened to on each
// device: cudaFuncSetAttribute once a kernel, device and larger size, not
// each launch.
int open_smem(const void* kernel, int smem) {
  struct Opened {
    const void* kernel;
    int dev, smem;
  };
  static Opened opened[256];
  static int count = 0;
  static std::mutex lock;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  std::lock_guard<std::mutex> hold(lock);
  Opened* o = nullptr;
  for (int i = 0; i < count && !o; ++i)
    if (opened[i].kernel == kernel && opened[i].dev == dev) o = &opened[i];
  if (o && o->smem >= smem) return 0;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e != cudaSuccess) return (int)e;
  if (!o && count < 256) o = &opened[count++];
  if (o) *o = Opened{kernel, dev, smem};
  return 0;
}

// One launch per chunk of members: one for mode 'block', as many as
// the plan's chunks for mode 'grid' (each a cooperative launch).
template <typename Kernel>
int launch(Kernel kernel, Params p, int mode, int threads, int smem,
           int chunk, cudaStream_t st) {
  const int e = open_smem(reinterpret_cast<const void*>(kernel), smem);
  if (e) return e;
  const int B = p.B;
  for (p.member0 = 0; p.member0 < B; p.member0 += chunk) {
    const int members = B - p.member0 < chunk ? B - p.member0 : chunk;
    const dim3 grid((unsigned)(members * p.blocks)), block((unsigned)threads);
    if (mode == kBlock) {
      kernel<<<grid, block, (size_t)smem, st>>>(p);
    } else {
      void* args[] = {&p};
      const cudaError_t c = cudaLaunchCooperativeKernel(
          reinterpret_cast<void*>(kernel), grid, block, args, (size_t)smem,
          st);
      if (c != cudaSuccess) return (int)c;
    }
  }
  return (int)cudaGetLastError();
}

template <bool BWD>
int launch_plan(const Params& p, const int* host, cudaStream_t st) {
  const int mode = host[hMode], threads = host[hThreads], smem = host[hSmem],
            chunk = host[hChunk];
  if (mode == kGrid)
    return BWD ? launch(backward_kernel<3, kGrid>, p, mode, threads, smem,
                        chunk, st)
               : launch(forward_kernel<3, kGrid>, p, mode, threads, smem,
                        chunk, st);
  if (host[hRbits] == 3)
    return BWD ? launch(backward_kernel<3, kBlock>, p, mode, threads, smem,
                        chunk, st)
               : launch(forward_kernel<3, kBlock>, p, mode, threads, smem,
                        chunk, st);
  return BWD ? launch(backward_kernel<4, kBlock>, p, mode, threads, smem,
                      chunk, st)
             : launch(forward_kernel<4, kBlock>, p, mode, threads, smem,
                      chunk, st);
}

}  // namespace

extern "C" {

// B states [B, d] (K1: B = 1); theta_half [T, th_groups, d], theta_x
// [T, tx_groups, n_ops], each group serving B / groups consecutive
// members. ops: the plan's op rows [n_ops, 4] on the device; host: the
// plan's host table (checked; see Head); xbuf: mode 'grid' scratch
// [members a launch, 2, 2, d] (else null). Writes psi_T [B, d]. Returns a
// CUDA error code, or 1001-1008 for a plan the kernels refuse.
int dq_forward(const float* th, const float* tx, const float* p_re,
               const float* p_im, const int* ops_dev, const int* host,
               float* o_re, float* o_im, float* xbuf, void* stream) {
  Params p = {};
  p.th = th;
  p.tx = tx;
  p.in0 = p_re;
  p.in1 = p_im;
  p.out0 = o_re;
  p.out1 = o_im;
  p.ops = reinterpret_cast<const int4*>(ops_dev);
  p.xbuf = xbuf;
  const int bad = check_plan(p, host, false);
  if (bad) return bad;
  if (host[hMode] == kGrid && xbuf == nullptr) return kPlanError + 8;
  return launch_plan<false>(p, host, static_cast<cudaStream_t>(stream));
}

// Same layouts; from the final states and their cotangents writes dpsi_0
// [B, d], d theta_half [T, B, d] and d theta_x [T, B, n_ops] per member.
// part: scratch [B, T, n_ops, warps a member]; xbuf: mode 'grid' scratch
// [members a launch, 2, 4, d].
int dq_backward(const float* th, const float* tx, const float* pT_re,
                const float* pT_im, const float* l_re, const float* l_im,
                const int* ops_dev, const int* host, float* g_th, float* g_tx,
                float* gp_re, float* gp_im, float* part, float* xbuf,
                void* stream) {
  Params p = {};
  p.th = th;
  p.tx = tx;
  p.in0 = pT_re;
  p.in1 = pT_im;
  p.in2 = l_re;
  p.in3 = l_im;
  p.out0 = gp_re;
  p.out1 = gp_im;
  p.ops = reinterpret_cast<const int4*>(ops_dev);
  p.g_th = g_th;
  p.g_tx = g_tx;
  p.part = part;
  p.xbuf = xbuf;
  const int bad = check_plan(p, host, true);
  if (bad) return bad;
  if ((host[hMode] == kGrid && xbuf == nullptr) ||
      (p.n_ops > 0 && part == nullptr))
    return kPlanError + 8;
  return launch_plan<true>(p, host, static_cast<cudaStream_t>(stream));
}

const char* dq_error_string(int code) {
  static const char* const plan[] = {
      "",
      "bad shapes (qubits, steps, ops, rounds, members or groups)",
      "register bits, threads or blocks do not hold the state",
      "blocks do not fit the mode",
      "bad exchange buffers or planes a pass",
      "dynamic shared memory differs from the plan's or exceeds a block's",
      "bad round table",
      "bad op table",
      "missing scratch"};
  if (code > kPlanError && code <= kPlanError + 8)
    return plan[code - kPlanError];
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
