// Multilevel ROIAlign backward for Hopper (sm_90a).
//
// Replaces the TPU kernel K2 of the JAX package,
// jtsm_tpu/ops/pallas/roi_align_kernel.py: _make_resident_bwd_kernel,
// launched by _pallas_call_resident_bwd, the backward of
// roi_align_multilevel_pallas. It computes what the plain version
// jtsm_tpu_torch/ops/roi_align.py::roi_align_multilevel_backward_plain
// computes, the transpose of the forward (K1, roi_align_fwd.cu) and so the
// exact semantics of jax.linear_transpose of the JAX package's
// ops/roi_align.py::roi_align_multilevel: each ROI's (P, P, C) cotangent,
// divided by the ROI's sample count, spreads onto the four taps of each live
// sample with the forward's bilinear weights and is summed into the gradient
// of the (B, H, W, C) map of the ROI's level. One launch serves every ROI of
// every level and image. None of the TPU layout devices (the 40-pixel
// window, the level bump, row and column buckets, the VMEM budget, SMEM
// chunking, the fixed ratio 2) carry over.
//
// What bounds it: memory. Per live sample and channel it does 4 multiplies
// and 4 additions into the gradient against a cotangent read once per bin
// and the gradient cells the samples touch, read and written once; at the
// training shapes those bytes at 3.35 TB/s take longer than the arithmetic
// at 67 TFLOP/s. The design, the simple one first: one thread block per
// (ROI, bin), one thread per channel, as in K1, so a warp reads 32
// neighbouring channels of the cotangent and adds into 32 neighbouring
// channels of one gradient cell (channels-last, 128 contiguous bytes). Many
// bins, ROIs and levels tap the same cell, so every addition is an atomicAdd
// into a float32 accumulator of the whole pyramid that the launch zeroes
// first; the additions meet in the L2. For bfloat16 features the sum stays
// in float32 and is cast to bfloat16 once, by a second kernel of the same
// call. Shared-memory accumulation of a ROI's window, a deterministic
// per-image reduction and vector atomics are later work.
//
// Numerics: positions, fractions, dead samples and the count come from
// roi_align_geometry.cuh, as in K1; each tap receives (cotangent / count) *
// (wy_term * wx_term), the plain version's operations in its order, built
// with -fmad=false. Only the order of the atomic sums differs from the plain
// version's index_add_, and it changes from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "roi_align_geometry.cuh"

namespace {

using jtsm::Pyramid;
using jtsm::RoiGeometry;

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__global__ void roi_align_bwd_kernel(Pyramid acc, const T* __restrict__ grad,
                                     const float* __restrict__ boxes,
                                     const int* __restrict__ batch_idx,
                                     const int* __restrict__ levels, int pooled_h,
                                     int pooled_w, int sampling_ratio, int max_ratio,
                                     int aligned) {
  const int bins = pooled_h * pooled_w;
  const int r = blockIdx.x / bins;
  const int bin = blockIdx.x - r * bins;
  const int py = bin / pooled_w;
  const int px = bin - py * pooled_w;

  const RoiGeometry g = jtsm::roi_geometry(acc, boxes, batch_idx, levels, r, pooled_h,
                                           pooled_w, sampling_ratio, max_ratio, aligned);
  const int w = g.w;
  const int c_total = acc.channels;
  float* dfeat = static_cast<float*>(acc.data[g.lvl]) + (size_t)g.b * g.h * w * c_total;

  const T* grad_bin = grad + ((size_t)r * bins + bin) * c_total;
  for (int c = threadIdx.x; c < c_total; c += blockDim.x) {
    const float gc = load(grad_bin + c) / g.count;
    float* dc = dfeat + c;
    for (int iy = 0; iy < g.ry; ++iy) {
      const float y = jtsm::sample_pos(g.y0, py, iy, g.ry, g.bin_h);
      int ylo, yhi;
      float wy;
      if (!jtsm::axis_tap(y, g.h, &ylo, &yhi, &wy)) continue;
      for (int ix = 0; ix < g.rx; ++ix) {
        const float x = jtsm::sample_pos(g.x0, px, ix, g.rx, g.bin_w);
        int xlo, xhi;
        float wx;
        if (!jtsm::axis_tap(x, w, &xlo, &xhi, &wx)) continue;
        atomicAdd(dc + ((size_t)ylo * w + xlo) * c_total, gc * ((1.0f - wy) * (1.0f - wx)));
        atomicAdd(dc + ((size_t)ylo * w + xhi) * c_total, gc * ((1.0f - wy) * wx));
        atomicAdd(dc + ((size_t)yhi * w + xlo) * c_total, gc * (wy * (1.0f - wx)));
        atomicAdd(dc + ((size_t)yhi * w + xhi) * c_total, gc * (wy * wx));
      }
    }
  }
}

__global__ void cast_to_bf16_kernel(const float* __restrict__ in,
                                    __nv_bfloat16* __restrict__ out, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride)
    out[i] = __float2bfloat16(in[i]);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (the cotangent and the gradient; boxes
// are float32, batch indices and levels int32, all on the device). grad is
// (num_rois, pooled_h, pooled_w, channels). heights, widths and scales are
// host arrays of num_levels entries. accum is a float32 device buffer of
// sum over levels of batch * height * width * channels elements, the levels'
// gradients one after the other, each (B, H, W, C): the call zeroes it and
// sums into it. For float32 it is the result; for bfloat16 the call casts it
// into out, a buffer of as many bfloat16 elements (unused for float32).
// Launches on `stream` and returns the CUDA error code (0 on success).
extern "C" int jtsm_roi_align_bwd(int dtype, const void* grad, const int* heights,
                                  const int* widths, const float* scales, int num_levels,
                                  int batch, int channels, const void* boxes,
                                  const void* batch_idx, const void* levels, int num_rois,
                                  int pooled_h, int pooled_w, int sampling_ratio,
                                  int max_ratio, int aligned, void* accum, void* out,
                                  void* stream) {
  if (num_levels < 1 || num_levels > jtsm::kMaxLevels || batch < 1 || channels < 1 ||
      num_rois < 1 || pooled_h < 1 || pooled_w < 1 || max_ratio < 1 ||
      (long long)num_rois * pooled_h * pooled_w > 0x7fffffffLL || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  void* level_data[jtsm::kMaxLevels];
  long long total = 0;
  for (int i = 0; i < num_levels; ++i) {
    level_data[i] = static_cast<float*>(accum) + total;
    total += (long long)batch * heights[i] * widths[i] * channels;
  }
  Pyramid acc;
  jtsm::fill_pyramid(&acc, level_data, heights, widths, scales, num_levels, batch, channels);

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(accum, 0, (size_t)total * sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(num_rois * pooled_h * pooled_w);
  const int threads = jtsm::threads_for(channels);
  const float* bx = static_cast<const float*>(boxes);
  const int* bi = static_cast<const int*>(batch_idx);
  const int* lv = static_cast<const int*>(levels);
  if (dtype == 0) {
    roi_align_bwd_kernel<float><<<grid, threads, 0, s>>>(
        acc, static_cast<const float*>(grad), bx, bi, lv, pooled_h, pooled_w, sampling_ratio,
        max_ratio, aligned);
  } else {
    roi_align_bwd_kernel<__nv_bfloat16><<<grid, threads, 0, s>>>(
        acc, static_cast<const __nv_bfloat16*>(grad), bx, bi, lv, pooled_h, pooled_w,
        sampling_ratio, max_ratio, aligned);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (dtype == 1) {
    const long long blocks = (total + 255) / 256;
    cast_to_bf16_kernel<<<(unsigned)(blocks < 65535 * 16 ? blocks : 65535 * 16), 256, 0, s>>>(
        static_cast<const float*>(accum), static_cast<__nv_bfloat16*>(out), total);
    err = cudaGetLastError();
  }
  return (int)err;
}
