#!/usr/bin/env python3
"""What a CUDA user object retained by a graph costs each replay.

``csrc/column_reduce_sm90.cuh`` can hand a captured launch's ticket range
to a user object of the graph, so the range comes back when the graph is
destroyed. This script builds a small library of its own (a kernel that
spins for a given number of clock cycles on 132 blocks), captures graphs
of 1, 20 and 200 such launches with and without one retained user object
(a destructor that does nothing), and replays each back to back: the
device time a replay (CUDA events around the replays) and the host time
a ``cudaGraphLaunch``, the median of 6 rounds in alternating order. Run
from the root of a checkout, on the machine with the card:

    python3 scripts/graph_user_object_cost.py

The library is built into ``build/graph_cost/``.
"""
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

SOURCE = r"""
#include <chrono>
#include <cuda_runtime.h>

__global__ void spin(long long cycles, int* sink) {
  const long long t0 = clock64();
  while (clock64() - t0 < cycles) {}
  if (threadIdx.x == 0 && blockIdx.x == 0) atomicAdd(sink, 1);
}

static void CUDART_CB nothing(void*) {}

extern "C" int replay(int kernels, int replays, int user_object,
                      long long cycles, float* dev_ms, double* host_us) {
  cudaStream_t s;
  int* sink;
  cudaGraph_t g;
  cudaGraphExec_t e;
  cudaEvent_t a, b;
  if (cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking) ||
      cudaMalloc(&sink, 4) ||
      cudaStreamBeginCapture(s, cudaStreamCaptureModeThreadLocal))
    return 1;
  for (int i = 0; i < kernels; ++i) spin<<<132, 128, 0, s>>>(cycles, sink);
  if (cudaStreamEndCapture(s, &g)) return 2;
  if (user_object) {
    cudaUserObject_t o;
    if (cudaUserObjectCreate(&o, nullptr, nothing, 1,
                             cudaUserObjectNoDestructorSync) ||
        cudaGraphRetainUserObject(g, o, 1, cudaGraphUserObjectMove))
      return 3;
  }
  if (cudaGraphInstantiate(&e, g, 0)) return 4;
  for (int i = 0; i < 3; ++i) cudaGraphLaunch(e, s);
  cudaStreamSynchronize(s);
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaEventRecord(a, s);
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < replays; ++i) cudaGraphLaunch(e, s);
  const auto t1 = std::chrono::steady_clock::now();
  cudaEventRecord(b, s);
  cudaStreamSynchronize(s);
  cudaEventElapsedTime(dev_ms, a, b);
  *host_us = std::chrono::duration<double, std::micro>(t1 - t0).count();
  cudaGraphExecDestroy(e);
  cudaGraphDestroy(g);
  cudaEventDestroy(a);
  cudaEventDestroy(b);
  cudaFree(sink);
  cudaStreamDestroy(s);
  return (int)cudaGetLastError();
}
"""

#: (launches a graph, replays timed) and the spin of each launch in cycles
#: (0: an empty kernel; 18000: about 10 us at 1.755 GHz)
SHAPES = ((1, 200), (20, 3), (20, 100), (200, 20))
SPINS = (0, 18000)


def build() -> ctypes.CDLL:
    out = Path.cwd() / "build" / "graph_cost"
    out.mkdir(parents=True, exist_ok=True)
    (out / "replay.cu").write_text(SOURCE)
    so = out / "replay.so"
    subprocess.check_call(["/usr/local/cuda/bin/nvcc", "-O2", "-arch=sm_90a",
                           "-shared", "-Xcompiler", "-fPIC", "-o", str(so),
                           str(out / "replay.cu")])
    lib = ctypes.CDLL(str(so))
    lib.replay.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_longlong, ctypes.POINTER(ctypes.c_float),
                           ctypes.POINTER(ctypes.c_double)]
    return lib


def main() -> None:
    lib = build()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    for cycles in SPINS:
        for kernels, replays in SHAPES:
            dev, host = {0: [], 1: []}, {0: [], 1: []}
            for rnd in range(6):
                for uo in ((0, 1) if rnd % 2 == 0 else (1, 0)):
                    d, h = ctypes.c_float(), ctypes.c_double()
                    rc = lib.replay(kernels, replays, uo, cycles,
                                    ctypes.byref(d), ctypes.byref(h))
                    if rc:
                        sys.exit(f"graph_user_object_cost: error {rc}")
                    dev[uo].append(d.value * 1e3 / replays)
                    host[uo].append(h.value / replays)
            d0, d1 = (statistics.median(dev[k]) for k in (0, 1))
            h0, h1 = (statistics.median(host[k]) for k in (0, 1))
            print(f"[uobj] spin {cycles} cycles, {kernels} launches a graph, "
                  f"{replays} replays: device us a replay {d0:.3f} without, "
                  f"{d1:.3f} with a user object ({d1 - d0:+.3f} us, "
                  f"{100 * (d1 / d0 - 1):+.2f} %); host us a launch "
                  f"{h0:.3f} / {h1:.3f}; rounds without "
                  f"{[round(x, 3) for x in dev[0]]}, with "
                  f"{[round(x, 3) for x in dev[1]]}", flush=True)


if __name__ == "__main__":
    main()
