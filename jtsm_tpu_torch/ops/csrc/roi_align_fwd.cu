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
// 67 TFLOP/s. What keeps such a kernel from that bound is load latency:
// a thread that walks its samples one after the other with one 4-byte load
// per tap, in a block per bin that works out the ROI's geometry anew, has
// little in flight. The design:
// - one block per (ROI, 16 bins, channel tile): 16 groups of 16 threads,
//   each group one bin, so the ROI's geometry and its sample taps are worked
//   out once per block, one sample a thread, into shared memory;
// - 16-byte loads: each thread holds 4 float32 or 8 bfloat16 channels of
//   every tap (channels-last maps, so a group reads 256 contiguous bytes of
//   a cell) and writes its 16 output bytes once;
// - the f32 sum stays in registers;
// - taps shared by neighbouring bins and ROIs are left to the L1 and the
//   50 MB L2 (the ROI's window is not staged in shared memory: reads from
//   there cost the SM the same bandwidth as L1 hits).
// A channel count that is not a multiple of the vector width, or a level
// whose address is not 16-byte aligned, takes the same kernel with one
// channel a thread (4- or 2-byte loads); the result is the same.
//
// What holds it above its bound (PERF.md): every tap is read again by each
// sample that touches it, from the L1 and the L2, and a thread does as many
// loads, conversions and multiply-adds per channel in bfloat16 as in
// float32, so bfloat16, half the bytes, takes about 0.7x the float32 time.
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
using jtsm::Tap;

constexpr int kThreads = 256;
constexpr int kLanes = 16;                  // threads over the channels of one bin
constexpr int kGroups = kThreads / kLanes;  // bins of one block

// VEC channels of one cell as float32, and back.
template <typename T, int VEC>
struct Vec;

template <>
struct Vec<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* v) {
    uint4 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = q;
  }
};

template <>
struct Vec<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float* v) { v[0] = __ldg(p); }
  static __device__ __forceinline__ void store(float* p, const float* v) { *p = v[0]; }
};

template <>
struct Vec<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
    v[0] = __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* v) {
    *p = __float2bfloat16(v[0]);
  }
};

// grid: (num_rois * bin_blocks, channel tiles of kLanes * VEC); dynamic
// shared memory: (pooled_h + pooled_w) * max_samples Taps.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    roi_align_fwd_kernel(Pyramid pyr, const float* __restrict__ boxes,
                         const int* __restrict__ batch_idx, const int* __restrict__ levels,
                         int pooled_h, int pooled_w, int sampling_ratio, int max_ratio,
                         int aligned, int bin_blocks, T* __restrict__ out) {
  extern __shared__ Tap taps[];
  const int bins = pooled_h * pooled_w;
  const int r = blockIdx.x / bin_blocks;
  const int bin = (blockIdx.x - r * bin_blocks) * kGroups + threadIdx.x / kLanes;

  const RoiGeometry g = jtsm::roi_geometry(pyr, boxes, batch_idx, levels, r, pooled_h,
                                           pooled_w, sampling_ratio, max_ratio, aligned);
  // the ROI's sample taps, one sample a thread: rows (bin-major), then columns
  const int ny = pooled_h * g.ry;
  const int nx = pooled_w * g.rx;
  Tap* ty = taps;
  Tap* tx = taps + ny;
  for (int t = threadIdx.x; t < ny + nx; t += kThreads) {
    if (t < ny) {
      ty[t] = jtsm::make_tap(g.y0, t / g.ry, t % g.ry, g.ry, g.bin_h, g.h);
    } else {
      const int u = t - ny;
      tx[u] = jtsm::make_tap(g.x0, u / g.rx, u % g.rx, g.rx, g.bin_w, g.w);
    }
  }
  __syncthreads();

  const int c_total = pyr.channels;
  const int c = (blockIdx.y * kLanes + threadIdx.x % kLanes) * VEC;
  if (bin >= bins || c >= c_total) return;
  const int py = bin / pooled_w;
  const int px = bin - py * pooled_w;
  const size_t row = (size_t)g.w * c_total;
  const T* feat = static_cast<const T*>(pyr.data[g.lvl]) + (size_t)g.b * g.h * row + c;
  const Tap* bx = tx + px * g.rx;

  float acc[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc[v] = 0.0f;
  for (int iy = 0; iy < g.ry; ++iy) {
    const Tap ay = ty[py * g.ry + iy];
    if (ay.lo < 0) continue;
    const float wy = ay.frac;
    const T* r0 = feat + (size_t)ay.lo * row;
    const T* r1 = feat + (size_t)ay.hi * row;
    for (int ix = 0; ix < g.rx; ++ix) {
      const Tap ax = bx[ix];
      if (ax.lo < 0) continue;
      const float wx = ax.frac;
      float v00[VEC], v01[VEC], v10[VEC], v11[VEC];
      Vec<T, VEC>::load(r0 + (size_t)ax.lo * c_total, v00);
      Vec<T, VEC>::load(r0 + (size_t)ax.hi * c_total, v01);
      Vec<T, VEC>::load(r1 + (size_t)ax.lo * c_total, v10);
      Vec<T, VEC>::load(r1 + (size_t)ax.hi * c_total, v11);
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        acc[v] += v00[v] * (1.0f - wy) * (1.0f - wx) + v01[v] * (1.0f - wy) * wx +
                  v10[v] * wy * (1.0f - wx) + v11[v] * wy * wx;
    }
  }
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc[v] = acc[v] / g.count;
  Vec<T, VEC>::store(out + ((size_t)r * bins + bin) * c_total + c, acc);
}

template <typename T, int VEC>
int launch_fwd(const Pyramid& pyr, const float* boxes, const int* batch_idx, const int* levels,
               int num_rois, int pooled_h, int pooled_w, int sampling_ratio, int max_ratio,
               int aligned, void* out, cudaStream_t s) {
  const int bin_blocks = (pooled_h * pooled_w + kGroups - 1) / kGroups;
  if ((long long)num_rois * bin_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int per_block = kLanes * VEC;
  const dim3 grid(num_rois * bin_blocks, (pyr.channels + per_block - 1) / per_block);
  const size_t smem = (size_t)(pooled_h + pooled_w) *
                      jtsm::max_samples(sampling_ratio, max_ratio) * sizeof(Tap);
  return (int)jtsm::launch(roi_align_fwd_kernel<T, VEC>, grid, kThreads, smem, s, pyr, boxes,
                           batch_idx, levels, pooled_h, pooled_w, sampling_ratio, max_ratio,
                           aligned, bin_blocks, static_cast<T*>(out));
}

// 16-byte vectors need the channel count a multiple of the vector width and
// every level and the output on 16-byte boundaries.
bool vectors_fit(void* const* level_data, int num_levels, const void* out, int channels,
                 int vec) {
  if (channels % vec != 0 || !jtsm::aligned_to(out, 16)) return false;
  for (int i = 0; i < num_levels; ++i)
    if (!jtsm::aligned_to(level_data[i], 16)) return false;
  return true;
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

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bx = static_cast<const float*>(boxes);
  const int* bi = static_cast<const int*>(batch_idx);
  const int* lv = static_cast<const int*>(levels);
  if (dtype == 0) {
    return vectors_fit(level_data, num_levels, out, channels, 4)
               ? launch_fwd<float, 4>(pyr, bx, bi, lv, num_rois, pooled_h, pooled_w,
                                      sampling_ratio, max_ratio, aligned, out, s)
               : launch_fwd<float, 1>(pyr, bx, bi, lv, num_rois, pooled_h, pooled_w,
                                      sampling_ratio, max_ratio, aligned, out, s);
  }
  if (dtype == 1) {
    return vectors_fit(level_data, num_levels, out, channels, 8)
               ? launch_fwd<__nv_bfloat16, 8>(pyr, bx, bi, lv, num_rois, pooled_h, pooled_w,
                                              sampling_ratio, max_ratio, aligned, out, s)
               : launch_fwd<__nv_bfloat16, 1>(pyr, bx, bi, lv, num_rois, pooled_h, pooled_w,
                                              sampling_ratio, max_ratio, aligned, out, s);
  }
  return (int)cudaErrorInvalidValue;
}
