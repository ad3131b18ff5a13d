// Anti-diagonal wavefront solver of the signature-kernel Goursat PDE for
// NVIDIA Hopper (sm_90a), called from JAX through the XLA FFI.
//
// One thread block solves one path pair. The three live anti-diagonals
// (indexed by the grid row i) sit in shared memory; thread t owns rows
// 1 + t + r * blockDim.x for r < RPT, so the row count is bounded by shared
// memory only (3 * (MM + 1) * sizeof(T) bytes), not by the thread count.
// Dyadic refinement happens on the fly: refined cell (i, j) reads the base
// increment inc[(i - 1) >> d, (j - 1) >> d] scaled by 4^-d (exact), so no
// refined grid ever reaches device memory. The increment of the next
// diagonal is loaded before the barrier, overlapping its latency with it.
//
// Update schemes and their operation order follow ops/scan_solver.py
// (_update_naive, _update_order2), the portable reference; built without
// multiply-add contraction (-fmad=false), the kernel agrees with it bit
// for bit.
//
// mode 0: final corner K[MM, NN] per pair -> out (B,)
// mode 1: full solution grid            -> out (B, MM + 1, NN + 1)
// mode 2: grid of inc and, flipped back, the grid of the reversed
//         increments (the adjoint sweep) -> out (B, 2, MM + 1, NN + 1)
//
// All leading dimensions of the (..., Mb, Nb) input are batch.

#include <cuda_runtime.h>

#include <cstdint>
#include <string>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kMaxSharedBytes = 232448;  // Hopper's per-block opt-in limit

template <typename T, bool NAIVE>
__device__ __forceinline__ T scheme(T k00, T k01, T k10, T u) {
  if (NAIVE) {
    return (k01 + k10) * (T(1) + T(0.5) * u) - k00;
  }
  const T u2 = u * u * T(1.0 / 12.0);
  return (k01 + k10) * (T(1) + T(0.5) * u + u2) - k00 * (T(1) - u2);
}

// One 32-byte sector as two 16-byte stores: a full sector per store pair
// keeps the grid write free of partial-sector read-modify-writes.
__device__ __forceinline__ void store_sector(double* dst, const double* b) {
  reinterpret_cast<double2*>(dst)[0] = make_double2(b[0], b[1]);
  reinterpret_cast<double2*>(dst)[1] = make_double2(b[2], b[3]);
}

__device__ __forceinline__ void store_sector(float* dst, const float* b) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(b[0], b[1], b[2], b[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(b[4], b[5], b[6], b[7]);
}

template <typename T, bool NAIVE, int RPT>
__global__ void __launch_bounds__(1024)
wavefront_kernel(const T* __restrict__ inc, T* __restrict__ out, int Mb,
                 int Nb, int d, int mode) {
  extern __shared__ unsigned char smem_raw[];
  T* const diag = reinterpret_cast<T*>(smem_raw);
  const int MM = Mb << d;
  const int NN = Nb << d;
  const int R = MM + 1;
  const int W = NN + 1;
  const int P = MM + NN;

  int pair = blockIdx.x;
  bool rev = false;
  if (mode == 2) {
    pair = blockIdx.x >> 1;
    rev = blockIdx.x & 1;
  }
  const T* const x = inc + static_cast<size_t>(pair) * Mb * Nb;
  const size_t gbase = static_cast<size_t>(blockIdx.x) * R * W;
  T* const grid = out + gbase;
  const T scale = T(1) / T(1 << (2 * d));
  // grid cells of one row are staged per 32-byte sector of `out`
  constexpr int V = 32 / sizeof(T);
  const bool vec_ok = (reinterpret_cast<uintptr_t>(out) & 31) == 0;

  for (int k = threadIdx.x; k < 3 * R; k += blockDim.x) diag[k] = T(1);
  if (mode != 0) {
    // boundary K[0, :] = K[:, 0] = 1 (row MM and column NN once flipped)
    const int row0 = rev ? MM : 0;
    const int col0 = rev ? NN : 0;
    for (int k = threadIdx.x; k < W; k += blockDim.x)
      grid[static_cast<size_t>(row0) * W + k] = T(1);
    for (int k = threadIdx.x; k < R; k += blockDim.x)
      grid[static_cast<size_t>(k) * W + col0] = T(1);
  }
  __syncthreads();

  T* vm2 = diag;
  T* vm1 = diag + R;
  T* cur = diag + 2 * R;

  auto load = [&](int p, int i) -> T {
    if (p > P || i < max(1, p - NN) || i > min(MM, p - 1)) return T(0);
    int r = (i - 1) >> d;
    int c = (p - i - 1) >> d;
    if (rev) {
      r = Mb - 1 - r;
      c = Nb - 1 - c;
    }
    return x[static_cast<size_t>(r) * Nb + c] * scale;
  };

  T u[RPT];
  T buf[RPT][V];
  unsigned mask[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    u[r] = load(2, 1 + threadIdx.x + r * blockDim.x);
    mask[r] = 0;
  }

  for (int p = 2; p <= P; ++p) {
    const int lo = max(1, p - NN);
    const int hi = min(MM, p - 1);
    T un[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) un[r] = load(p + 1, 1 + threadIdx.x + r * blockDim.x);
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int i = 1 + threadIdx.x + r * blockDim.x;
      if (i >= lo && i <= hi) {
        const T v = scheme<T, NAIVE>(vm2[i - 1], vm1[i - 1], vm1[i], u[r]);
        cur[i] = v;
        const int j = p - i;
        if (mode == 0) {
          if (p == P) out[pair] = v;
        } else {
          // a thread keeps one row: its cells arrive one column per
          // diagonal, so they are gathered in registers and written a
          // sector at a time (rows of the flipped grid run backwards)
          const size_t e = gbase + (rev ? static_cast<size_t>(MM - i) * W + (NN - j)
                                        : static_cast<size_t>(i) * W + j);
          const int slot = static_cast<int>(e & (V - 1));
#pragma unroll
          for (int k = 0; k < V; ++k)
            if (k == slot) buf[r][k] = v;
          mask[r] |= 1u << slot;
          if (j == NN || slot == (rev ? 0 : V - 1)) {
            T* const dst = out + (e - slot);
            if (mask[r] == (1u << V) - 1 && vec_ok) {
              store_sector(dst, buf[r]);
            } else {
#pragma unroll
              for (int k = 0; k < V; ++k)
                if (mask[r] & (1u << k)) dst[k] = buf[r][k];
            }
            mask[r] = 0;
          }
        }
      }
      u[r] = un[r];
    }
    __syncthreads();
    T* const t = vm2;
    vm2 = vm1;
    vm1 = cur;
    cur = t;
  }
}

template <typename T, bool NAIVE, int RPT>
cudaError_t launch_rpt(cudaStream_t stream, const void* inc, void* out,
                       int blocks, int threads, int Mb, int Nb, int d,
                       int mode, size_t smem) {
  auto kernel = wavefront_kernel<T, NAIVE, RPT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<blocks, threads, smem, stream>>>(static_cast<const T*>(inc),
                                            static_cast<T*>(out), Mb, Nb, d,
                                            mode);
  return cudaGetLastError();
}

template <typename T, bool NAIVE>
cudaError_t launch(cudaStream_t stream, const void* inc, void* out,
                   int blocks, int MM, int Mb, int Nb, int d, int mode,
                   int max_threads) {
  const size_t smem = 3 * static_cast<size_t>(MM + 1) * sizeof(T);
  // the fewest rows per thread that keeps the block within max_threads
  int rpt = 1;
  while (rpt < 32 && (MM + rpt - 1) / rpt > max_threads) rpt *= 2;
  int threads = (MM + rpt - 1) / rpt;
  threads = ((threads + 31) / 32) * 32;
#define SIG_LAUNCH(N)                                                     \
  case N:                                                                 \
    return launch_rpt<T, NAIVE, N>(stream, inc, out, blocks, threads, Mb, \
                                   Nb, d, mode, smem);
  switch (rpt) {
    SIG_LAUNCH(1)
    SIG_LAUNCH(2)
    SIG_LAUNCH(4)
    SIG_LAUNCH(8)
    SIG_LAUNCH(16)
    SIG_LAUNCH(32)
  }
#undef SIG_LAUNCH
  return cudaErrorInvalidValue;
}

ffi::Error WavefrontImpl(cudaStream_t stream, ffi::AnyBuffer inc,
                         ffi::Result<ffi::AnyBuffer> out,
                         int32_t dyadic_order, int32_t naive, int32_t mode,
                         int32_t max_threads) {
  const auto dims = inc.dimensions();
  if (dims.size() < 2) {
    return ffi::Error::InvalidArgument("increments must be (..., Mb, Nb)");
  }
  int64_t B = 1;
  for (size_t k = 0; k + 2 < dims.size(); ++k) B *= dims[k];
  const int64_t Mb = dims[dims.size() - 2];
  const int64_t Nb = dims[dims.size() - 1];
  if (mode < 0 || mode > 2 || dyadic_order < 0 || dyadic_order > 8 ||
      max_threads < 32 || max_threads > 1024) {
    return ffi::Error::InvalidArgument("bad wavefront attributes");
  }
  const int64_t MM = Mb << dyadic_order;
  const int64_t NN = Nb << dyadic_order;
  if (B == 0 || MM == 0 || NN == 0) return ffi::Error::Success();
  const auto dtype = inc.element_type();
  const size_t width = dtype == ffi::DataType::F64 ? 8 : 4;
  if (3 * static_cast<size_t>(MM + 1) * width > kMaxSharedBytes ||
      MM > (1 << 30) || NN > (1 << 30) || MM > 32 * max_threads) {
    return ffi::Error::InvalidArgument(
        "refined grid exceeds one block's shared memory");
  }
  const int64_t blocks = mode == 2 ? 2 * B : B;
  if (blocks > 0x7fffffff) {
    return ffi::Error::InvalidArgument("too many pairs for one launch");
  }
  cudaError_t err;
  const void* src = inc.untyped_data();
  void* dst = out->untyped_data();
  const int args[] = {static_cast<int>(blocks), static_cast<int>(MM),
                      static_cast<int>(Mb), static_cast<int>(Nb)};
  if (dtype == ffi::DataType::F64) {
    err = naive ? launch<double, true>(stream, src, dst, args[0], args[1],
                                       args[2], args[3], dyadic_order, mode,
                                       max_threads)
                : launch<double, false>(stream, src, dst, args[0], args[1],
                                        args[2], args[3], dyadic_order, mode,
                                        max_threads);
  } else if (dtype == ffi::DataType::F32) {
    err = naive ? launch<float, true>(stream, src, dst, args[0], args[1],
                                      args[2], args[3], dyadic_order, mode,
                                      max_threads)
                : launch<float, false>(stream, src, dst, args[0], args[1],
                                       args[2], args[3], dyadic_order, mode,
                                       max_threads);
  } else {
    return ffi::Error::InvalidArgument("increments must be float32 or float64");
  }
  if (err != cudaSuccess) {
    return ffi::Error::Internal(std::string("wavefront launch failed: ") +
                                cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(SigWavefront, WavefrontImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::AnyBuffer>()
                                  .Ret<ffi::AnyBuffer>()
                                  .Attr<int32_t>("dyadic_order")
                                  .Attr<int32_t>("naive")
                                  .Attr<int32_t>("mode")
                                  .Attr<int32_t>("max_threads"));
