// Multilevel ROIAlign forward for Hopper (sm_90a).
//
// Replaces the TPU kernel K1 of the JAX package,
// jtsm_tpu/ops/pallas/roi_align_kernel.py: the resident-pyramid kernel
// (_make_resident_kernel, launched by _pallas_call_resident) and the
// windowed-DMA kernel (_make_kernel, launched by _pallas_call), both reached
// from roi_align_multilevel_pallas. It computes what the plain version
// jtsm_tpu_torch/ops/roi_align.py::roi_align_multilevel_plain computes, the
// exact semantics of the JAX package's ops/roi_align.py::roi_align_multilevel:
// ROIAlign (v2 with aligned=1), per-ROI adaptive sample grid capped at
// max_ratio when sampling_ratio == 0, and its boundary rules. One launch
// serves every ROI of every level and image: each ROI carries its own level
// and batch index. None of the TPU layout devices (the 40-pixel window, row
// and column buckets, the level bump, the VMEM budget, the fixed ratio 2)
// carry over.
//
// What bounds it: memory. A bin averages up to 16 bilinear samples of 4 taps
// each, about 10 flops a tap and channel, against 4 bytes read per tap and
// channel in f32; at the flagship shapes the pyramid read once and the
// pooled output written once take longer at 3.35 TB/s than the arithmetic at
// 67 TFLOP/s. The design: one thread block per (ROI, bin), one thread per
// channel, so a warp reads 32 neighbouring channels of one feature cell
// (channels-last maps: 128 contiguous bytes in f32) and writes 32
// neighbouring channels of the output; the sample loop and the f32 sum stay
// in registers. Taps shared by neighbouring bins and ROIs are left to the
// L1 and the 50 MB L2. Staging the ROI's window in shared memory and vector
// loads are later work.
//
// Numerics: positions, fractions and weights come from roi_align_geometry.cuh,
// which K2 shares, with the same float operations in the same order as the
// plain version, and the file is built with -fmad=false so that nvcc does not
// contract them into fused multiply-adds; only the order of the sum over
// samples differs.

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
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void roi_align_fwd_kernel(Pyramid pyr, const float* __restrict__ boxes,
                                     const int* __restrict__ batch_idx,
                                     const int* __restrict__ levels, int pooled_h,
                                     int pooled_w, int sampling_ratio, int max_ratio,
                                     int aligned, T* __restrict__ out) {
  const int bins = pooled_h * pooled_w;
  const int r = blockIdx.x / bins;
  const int bin = blockIdx.x - r * bins;
  const int py = bin / pooled_w;
  const int px = bin - py * pooled_w;

  const RoiGeometry g = jtsm::roi_geometry(pyr, boxes, batch_idx, levels, r, pooled_h,
                                           pooled_w, sampling_ratio, max_ratio, aligned);
  const int w = g.w;
  const int c_total = pyr.channels;
  const T* feat = static_cast<const T*>(pyr.data[g.lvl]) + (size_t)g.b * g.h * w * c_total;

  T* out_bin = out + ((size_t)r * bins + bin) * c_total;
  for (int c = threadIdx.x; c < c_total; c += blockDim.x) {
    const T* fc = feat + c;
    float acc = 0.0f;
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
        const float v00 = load(fc + ((size_t)ylo * w + xlo) * c_total);
        const float v01 = load(fc + ((size_t)ylo * w + xhi) * c_total);
        const float v10 = load(fc + ((size_t)yhi * w + xlo) * c_total);
        const float v11 = load(fc + ((size_t)yhi * w + xhi) * c_total);
        acc += v00 * (1.0f - wy) * (1.0f - wx) + v01 * (1.0f - wy) * wx +
               v10 * wy * (1.0f - wx) + v11 * wy * wx;
      }
    }
    store(out_bin + c, acc / g.count);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (features and output; boxes are float32,
// batch indices and levels int32, all on the device). level_data, heights,
// widths and scales are host arrays of num_levels entries. out is
// (num_rois, pooled_h, pooled_w, channels) in the features' dtype. Launches on
// `stream` and returns the CUDA error code of the launch (0 on success).
extern "C" int jtsm_roi_align_fwd(int dtype, void* const* level_data,
                                  const int* heights, const int* widths,
                                  const float* scales, int num_levels, int batch,
                                  int channels, const void* boxes,
                                  const void* batch_idx, const void* levels,
                                  int num_rois, int pooled_h, int pooled_w,
                                  int sampling_ratio, int max_ratio, int aligned,
                                  void* out, void* stream) {
  if (num_levels < 1 || num_levels > jtsm::kMaxLevels || batch < 1 || channels < 1 ||
      num_rois < 1 || pooled_h < 1 || pooled_w < 1 || max_ratio < 1 ||
      (long long)num_rois * pooled_h * pooled_w > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Pyramid pyr;
  jtsm::fill_pyramid(&pyr, level_data, heights, widths, scales, num_levels, batch, channels);

  const dim3 grid(num_rois * pooled_h * pooled_w);
  const int threads = jtsm::threads_for(channels);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bx = static_cast<const float*>(boxes);
  const int* bi = static_cast<const int*>(batch_idx);
  const int* lv = static_cast<const int*>(levels);
  if (dtype == 0) {
    roi_align_fwd_kernel<float><<<grid, threads, 0, s>>>(
        pyr, bx, bi, lv, pooled_h, pooled_w, sampling_ratio, max_ratio, aligned,
        static_cast<float*>(out));
  } else if (dtype == 1) {
    roi_align_fwd_kernel<__nv_bfloat16><<<grid, threads, 0, s>>>(
        pyr, bx, bi, lv, pooled_h, pooled_w, sampling_ratio, max_ratio, aligned,
        static_cast<__nv_bfloat16*>(out));
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
