"""Time a grid-wide barrier on the card, three ways, at K7's row-split
grid (128 blocks of 512 threads, one per SM, cooperative launch).

    python3 scripts/grid_barrier_bench.py [--blocks 128] [--iters 20000]

- ``acqrel``: arrival by ``atom.acq_rel.gpu``, wait by
  ``ld.acquire.gpu``, the last arrival resets the count and bumps the
  generation with ``red.release.gpu``;
- ``cg``: ``cooperative_groups::this_grid().sync()``, the one K7 uses
  (``csrc/taylor_apply.cu::grid_sync``: it measured the fastest);
- ``fence``: the barrier K7 had before (a ``volatile`` generation spin
  with ``__nanosleep(32)`` and two ``__threadfence``s).

Each kernel runs ``iters`` barriers, with every block storing one word
before and loading its neighbour's after each (what a Taylor term
publishes and reads). Builds its own CUDA source with nvcc into
``build/`` and prints one JSON line of microseconds per barrier. Needs
a CUDA card.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SOURCE = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ void sync_acqrel(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned gen, old;
    asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(gen)
                 : "l"(bar + 1) : "memory");
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;"
                 : "=r"(old) : "l"(bar), "r"(1u) : "memory");
    if (old == gridDim.x - 1) {
      asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" :: "l"(bar),
                   "r"(0u) : "memory");
      asm volatile("red.release.gpu.global.add.u32 [%0], %1;"
                   :: "l"(bar + 1), "r"(1u) : "memory");
    } else {
      while (ld_acquire(bar + 1) == gen) {
      }
    }
  }
  __syncthreads();
}
__device__ void sync_fence(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = bar + 1;
    const unsigned g = *gen;
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
template <int KIND>
__global__ void bench(unsigned* bar, float* words, int iters) {
  float acc = 0.f;
  for (int n = 0; n < iters; ++n) {
    if (threadIdx.x == 0) __stcg(words + blockIdx.x, (float)n);
    if (KIND == 0) sync_acqrel(bar);
    else if (KIND == 1) cg::this_grid().sync();
    else sync_fence(bar);
    acc += __ldcg(words + (blockIdx.x + 1) % gridDim.x);
  }
  if (threadIdx.x == 0 && acc < 0.f) words[0] = acc;
}
extern "C" int run(int kind, unsigned* bar, float* words, int blocks,
                   int threads, int iters, void* stream) {
  void* args[] = {&bar, &words, &iters};
  const void* fn = kind == 0 ? (const void*)bench<0>
                 : kind == 1 ? (const void*)bench<1> : (const void*)bench<2>;
  cudaError_t e = cudaLaunchCooperativeKernel(
      fn, dim3(blocks), dim3(threads), args, 0, (cudaStream_t)stream);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}
"""


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--blocks", type=int, default=128)
    ap.add_argument("--threads", type=int, default=512)
    ap.add_argument("--iters", type=int, default=20000)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("grid_barrier_bench: no CUDA device is available")
    from diffquantum_tpu_torch.ops import _build
    out = os.path.join(ROOT, "build")
    os.makedirs(out, exist_ok=True)
    src, lib = os.path.join(out, "grid_barrier_bench.cu"), \
        os.path.join(out, "libgrid_barrier_bench.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS[:-2], "-o", lib,
                    src], check=True)
    so = ctypes.CDLL(lib)
    so.run.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p] + \
        [ctypes.c_int] * 3 + [ctypes.c_void_p]
    bar = torch.zeros(2, dtype=torch.int32, device="cuda")
    words = torch.zeros(args.blocks, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    res = {}
    for rep in range(2):
        for name, kind in (("acqrel", 0), ("cg", 1), ("fence", 2)):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            so.run(kind, bar.data_ptr(), words.data_ptr(), args.blocks,
                   args.threads, 100, stream)
            start.record()
            code = so.run(kind, bar.data_ptr(), words.data_ptr(),
                          args.blocks, args.threads, args.iters, stream)
            stop.record()
            stop.synchronize()
            if code:
                sys.exit(f"grid_barrier_bench: {name} launch failed ({code})")
            res[f"{name}_us"] = start.elapsed_time(stop) * 1e3 / args.iters
        print(json.dumps({"blocks": args.blocks, "threads": args.threads,
                          "iters": args.iters, "rep": rep, **res}),
              flush=True)


if __name__ == "__main__":
    main()
