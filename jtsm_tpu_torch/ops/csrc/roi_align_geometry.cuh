// Sample geometry of the multilevel ROIAlign, shared by the forward kernel
// (roi_align_fwd.cu, K1) and the backward kernel (roi_align_bwd.cu, K2), so
// that the backward spreads each cotangent onto exactly the taps, with
// exactly the weights, that the forward read.
//
// Semantics: jtsm_tpu_torch/ops/roi_align.py::_level_geometry and
// _axis_samples, the plain versions' geometry: ROIAlign (v2 with aligned=1),
// the per-ROI adaptive grid ceil(bin) capped at max_ratio when
// sampling_ratio == 0, a sample outside [-1, size] counting as zero, a
// coordinate below 0 snapping to 0 and one at or past the last cell taking
// the last cell with fraction 1. The float operations are those of the plain
// version in its order; the sources that include this header are built with
// -fmad=false so that nvcc does not contract them into fused multiply-adds.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace jtsm {

constexpr int kMaxLevels = 5;

// The levels of one pyramid: per level a channels-last (B, H, W, C) map,
// read by the forward (features) or accumulated into by the backward
// (float32 gradients).
struct Pyramid {
  void* data[kMaxLevels];
  int height[kMaxLevels];
  int width[kMaxLevels];
  float scale[kMaxLevels];
  int num_levels;
  int batch;
  int channels;
};

// One ROI on its level: the level and image (clamped into range, so no input
// makes a kernel touch memory outside the maps), the map's size, the scaled
// box origin, the bin size, the sample grid and its divisor.
struct RoiGeometry {
  int lvl;
  int b;
  int h;
  int w;
  float x0;
  float y0;
  float bin_w;
  float bin_h;
  int ry;
  int rx;
  float count;
};

__device__ __forceinline__ RoiGeometry roi_geometry(const Pyramid& pyr, const float* boxes,
                                                    const int* batch_idx, const int* levels,
                                                    int r, int pooled_h, int pooled_w,
                                                    int sampling_ratio, int max_ratio,
                                                    int aligned) {
  RoiGeometry g;
  g.lvl = min(max(levels[r], 0), pyr.num_levels - 1);
  g.b = min(max(batch_idx[r], 0), pyr.batch - 1);
  g.h = pyr.height[g.lvl];
  g.w = pyr.width[g.lvl];
  const float sc = pyr.scale[g.lvl];
  const float offset = aligned ? 0.5f : 0.0f;
  g.x0 = boxes[4 * r + 0] * sc - offset;
  g.y0 = boxes[4 * r + 1] * sc - offset;
  const float x1 = boxes[4 * r + 2] * sc - offset;
  const float y1 = boxes[4 * r + 3] * sc - offset;
  float roi_w = x1 - g.x0;
  float roi_h = y1 - g.y0;
  if (!aligned) {
    roi_w = fmaxf(roi_w, 1.0f);
    roi_h = fmaxf(roi_h, 1.0f);
  }
  g.bin_w = roi_w / (float)pooled_w;
  g.bin_h = roi_h / (float)pooled_h;
  g.ry = sampling_ratio;
  g.rx = sampling_ratio;
  if (sampling_ratio <= 0) {
    g.ry = (int)fminf(fmaxf(ceilf(g.bin_h), 1.0f), (float)max_ratio);
    g.rx = (int)fminf(fmaxf(ceilf(g.bin_w), 1.0f), (float)max_ratio);
  }
  g.count = (float)(g.ry * g.rx);
  return g;
}

// Position of sample k of bin `bin` along one axis.
__device__ __forceinline__ float sample_pos(float origin, int bin, int k, int ratio,
                                            float bin_size) {
  return origin + ((float)bin + ((float)k + 0.5f) / (float)ratio) * bin_size;
}

// One sample coordinate along one axis, with the plain version's boundary
// rules. Returns false when the sample counts as zero.
__device__ __forceinline__ bool axis_tap(float pos, int size, int* lo, int* hi, float* frac) {
  if (pos < -1.0f || pos > (float)size) return false;
  pos = fmaxf(pos, 0.0f);
  float f = floorf(pos);
  int l = (int)f;
  float fr = pos - f;
  if (l >= size - 1) {
    l = size - 2;
    fr = 1.0f;
  }
  l = max(min(l, size - 2), 0);
  *lo = l;
  *hi = min(l + 1, size - 1);  // a map of one row or column has no l + 1
  *frac = fr;
  return true;
}

// One sample's taps along one axis; lo < 0 marks a sample that counts as
// zero (its hi is then 0, so an address made from it stays inside the map).
struct Tap {
  int lo;
  int hi;
  float frac;
};

__device__ __forceinline__ Tap make_tap(float origin, int bin, int k, int ratio, float bin_size,
                                        int size) {
  Tap t;
  if (!axis_tap(sample_pos(origin, bin, k, ratio, bin_size), size, &t.lo, &t.hi, &t.frac)) {
    t.lo = -1;
    t.hi = 0;
    t.frac = 0.0f;
  }
  return t;
}

// Fills the pyramid's shapes from the host arrays of the C interface.
inline void fill_pyramid(Pyramid* pyr, void* const* level_data, const int* heights,
                         const int* widths, const float* scales, int num_levels, int batch,
                         int channels) {
  for (int i = 0; i < kMaxLevels; ++i) {
    const bool used = i < num_levels;
    pyr->data[i] = used ? level_data[i] : nullptr;
    pyr->height[i] = used ? heights[i] : 0;
    pyr->width[i] = used ? widths[i] : 0;
    pyr->scale[i] = used ? scales[i] : 0.0f;
  }
  pyr->num_levels = num_levels;
  pyr->batch = batch;
  pyr->channels = channels;
}

// True when `p` lies on a multiple of `bytes`.
inline bool aligned_to(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// The largest grid of samples per bin and axis a launch can meet: the fixed
// sampling ratio, or the adaptive grid's cap.
__host__ __device__ inline int max_samples(int sampling_ratio, int max_ratio) {
  return sampling_ratio > 0 ? sampling_ratio : max_ratio;
}

// Launches `kernel` with `smem` bytes of dynamic shared memory, first
// raising the kernel's limit when it asks for more than the default 48 KB.
template <typename Kernel, typename... Args>
inline cudaError_t launch(Kernel kernel, dim3 grid, int threads, size_t smem, cudaStream_t s,
                          Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem, s>>>(args...);
  return cudaGetLastError();
}

}  // namespace jtsm
