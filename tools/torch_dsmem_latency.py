#!/usr/bin/env python3
"""Measure the latency of one hop between two CTAs of a thread-block
cluster on the card, for each way O4's cluster route
(``mxnet_tpu_torch/csrc/box_nms.cu``) could pass its walk from CTA to
CTA.

    python3 tools/torch_dsmem_latency.py

Needs an NVIDIA card and nvcc.  A ping-pong of 20,000 round trips between
CTA 0 and CTA 1 of one cluster (the cluster's other CTAs idle), one
thread a CTA unless named, timed with ``clock64`` in CTA 0; one hop is
half a round trip, in cycles and in ns at the SM clock ``nvidia-smi``
reads under the load.  The ways:

- ``cluster barrier``: every thread of the cluster arrives and waits
  (``barrier.cluster``), once a hop, for cluster sizes 2 and 8 (256
  threads a CTA);
- ``mbarrier try_wait``: the sender arrives on the receiver's mbarrier
  (``mbarrier.arrive.release.cluster.shared::cluster``) and the receiver
  waits with ``mbarrier.try_wait.parity.acquire.cluster``;
- ``mbarrier test_wait``: the same, the receiver spinning on
  ``mbarrier.test_wait``;
- ``flag``: the sender stores a counter into the receiver's shared memory
  (``st.release.cluster.shared::cluster``) and the receiver spins on it
  (``ld.acquire.cluster.shared::cta``);
- ``flag after 4 x 20 B``: the same after writing four 20-byte rows (a
  float4 and a float each) into the receiver's shared memory first.
"""
import ctypes
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

ROUNDS = 20000
SOURCE = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>
namespace cg = cooperative_groups;

__device__ __forceinline__ uint32_t sa(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ uint32_t remote(const void* p, int cta) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r)
               : "r"(sa(p)), "r"(cta));
  return r;
}
__device__ __forceinline__ void arrive_remote(uint64_t* bar, int cta) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];"
               :: "r"(remote(bar, cta)) : "memory");
}
__device__ __forceinline__ void wait_try(uint64_t* bar, int parity) {
  asm volatile("{\n.reg .pred p;\nW%=:\n"
               "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, "
               "[%0], %1;\n@!p bra W%=;\n}" :: "r"(sa(bar)), "r"(parity)
               : "memory");
}
__device__ __forceinline__ void wait_test(uint64_t* bar, int parity) {
  asm volatile("{\n.reg .pred p;\nW%=:\n"
               "mbarrier.test_wait.parity.acquire.cluster.shared::cta.b64 p, "
               "[%0], %1;\n@!p bra W%=;\n}" :: "r"(sa(bar)), "r"(parity)
               : "memory");
}
__device__ __forceinline__ void flag_store(int* flag, int cta, int v) {
  asm volatile("st.release.cluster.shared::cluster.u32 [%0], %1;"
               :: "r"(remote(flag, cta)), "r"(v) : "memory");
}
__device__ __forceinline__ void flag_wait(int* flag, int v) {
  int got;
  do {
    asm volatile("ld.acquire.cluster.shared::cta.u32 %0, [%1];"
                 : "=r"(got) : "r"(sa(flag)) : "memory");
  } while (got != v);
}

// mode 0: cluster barrier; 1: mbarrier try_wait; 2: test_wait; 3: flag;
// 4: flag after four 20-byte rows
__global__ void pingpong(int mode, int rounds, long long* cycles) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  __shared__ __align__(8) uint64_t bar;
  __shared__ int flag;
  __shared__ __align__(16) float4 rows[4];
  __shared__ float areas[4];
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(sa(&bar)));
    flag = 0;
  }
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  cluster.sync();
  long long t0 = clock64();
  if (mode == 0) {
    for (int i = 0; i < 2 * rounds; ++i) cluster.sync();
  } else if (threadIdx.x == 0 && rank < 2) {
    const int other = 1 - rank;
    for (int i = 0; i < rounds; ++i) {
      if (rank == 0) {
        if (mode == 4) {
          float4* r = cluster.map_shared_rank(rows, other);
          float* a = cluster.map_shared_rank(areas, other);
          for (int k = 0; k < 4; ++k) {
            r[k] = make_float4(i, k, 0.f, 1.f);
            a[k] = (float)k;
          }
        }
        if (mode == 1 || mode == 2) arrive_remote(&bar, other);
        else flag_store(&flag, other, i + 1);
        if (mode == 1) wait_try(&bar, i & 1);
        else if (mode == 2) wait_test(&bar, i & 1);
        else flag_wait(&flag, i + 1);
      } else {
        if (mode == 1) wait_try(&bar, i & 1);
        else if (mode == 2) wait_test(&bar, i & 1);
        else flag_wait(&flag, i + 1);
        if (mode == 1 || mode == 2) arrive_remote(&bar, other);
        else flag_store(&flag, other, i + 1);
      }
    }
  }
  if (threadIdx.x == 0 && rank == 0) *cycles = clock64() - t0;
  cluster.sync();
}

extern "C" int run(int mode, int cluster, int threads, int rounds,
                   long long* cycles) {
  long long* d = nullptr;
  cudaMalloc(&d, sizeof(long long));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, pingpong, mode, rounds, d);
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  if (e == cudaSuccess)
    e = cudaMemcpy(cycles, d, sizeof(long long), cudaMemcpyDeviceToHost);
  cudaFree(d);
  return (int)e;
}
"""
WAYS = [("cluster barrier, 2 CTAs", 0, 2, 256),
        ("cluster barrier, 8 CTAs", 0, 8, 256),
        ("mbarrier try_wait", 1, 2, 32),
        ("mbarrier test_wait", 2, 2, 32),
        ("flag", 3, 2, 32),
        ("flag after 4 x 20 B", 4, 2, 32),
        ("flag, 8-CTA cluster", 3, 8, 32)]


def sm_clock_mhz():
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True).stdout.strip()
    try:
        return float(out.splitlines()[0])
    except (ValueError, IndexError):
        return float("nan")


def main():
    import torch

    import chip_smoke
    from mxnet_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 2
    print("card: %s" % chip_smoke.nvidia_smi_line(), flush=True)
    tmp = tempfile.mkdtemp(dir=os.path.join(REPO, "build"))
    cu, lib = os.path.join(tmp, "dsmem.cu"), os.path.join(tmp, "dsmem.so")
    with open(cu, "w") as f:
        f.write(SOURCE)
    subprocess.run([os.path.join(_build.cuda_home(), "bin", "nvcc"),
                    *_build.NVCC_FLAGS, "-o", lib, cu], check=True)
    so = ctypes.CDLL(lib)
    so.run.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_longlong)]
    torch.cuda.init()
    for name, mode, cluster, threads in WAYS:
        cycles = ctypes.c_longlong(0)
        so.run(mode, cluster, threads, 100, ctypes.byref(cycles))   # warm-up
        err = so.run(mode, cluster, threads, ROUNDS, ctypes.byref(cycles))
        mhz = sm_clock_mhz()
        if err:
            print("%-26s failed: CUDA error %d" % (name, err))
            continue
        hop = cycles.value / (2 * ROUNDS)
        print("%-26s %8.1f cycles a hop, %7.1f ns at %.0f MHz"
              % (name, hop, 1e3 * hop / mhz, mhz), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
