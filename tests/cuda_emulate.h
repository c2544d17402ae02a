// CPU stand-ins for the CUDA names a kernel source uses, so the same .cu
// file compiles with g++ and runs on the host: one std::thread per CUDA
// thread, __syncthreads() as a barrier, __shared__ arrays as statics of the
// kernel function, blocks one after another. Slow, and only for tiny
// grids: it checks a kernel's indexing and arithmetic where no card is.
//
//   g++ -std=c++20 -O1 -pthread -shared -fPIC -DGCM_EMULATE \
//       -include tests/cuda_emulate.h -x c++ kernel.cu -o libemu.so
#pragma once

#include <algorithm>
#include <barrier>
#include <cmath>
#include <functional>
#include <memory>
#include <thread>
#include <vector>

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3() = default;
  dim3(unsigned x_, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};

inline thread_local dim3 threadIdx;
inline dim3 blockIdx, blockDim, gridDim;
inline std::barrier<>* emu_barrier = nullptr;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static

inline void __syncthreads() { emu_barrier->arrive_and_wait(); }

inline void emu_launch(dim3 grid, unsigned nthreads,
                       const std::function<void()>& body) {
  gridDim = grid;
  blockDim = dim3(nthreads);
  std::barrier<> bar((std::ptrdiff_t)nthreads);
  emu_barrier = &bar;
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        blockIdx = dim3(bx, by, bz);
        std::vector<std::thread> ts;
        ts.reserve(nthreads);
        for (unsigned t = 0; t < nthreads; ++t)
          ts.emplace_back([t, &body] {
            threadIdx = dim3(t);
            body();
          });
        for (auto& th : ts) th.join();
      }
  emu_barrier = nullptr;
}
