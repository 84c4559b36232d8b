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
// What bounds it: memory. The cotangent and the per-ROI inputs are read once
// and the float32 gradient pyramid written once; at the training shapes
// those bytes at 3.35 TB/s take longer than the arithmetic at 67 TFLOP/s.
// Spreading each sample's four taps with scalar float atomics, as a block
// per (ROI, bin) would, costs four 4-byte global atomics per live sample
// and channel, most of them onto cells that other bins of the same ROI
// also hit.
//
// The design: one block per (ROI, 64-channel tile). Bilinear sampling is
// separable, and a sample is live when its row and its column are, so a
// ROI's gradient on cell (y, x) is
//     sum_py Ay[y][py] * sum_px Ax[x][px] * cotangent[py][px] / count,
// where Ay[y][py] sums the row weights (1 - fy or fy) of bin py's live
// samples that tap row y, and Ax likewise for the columns. Two threads of
// the block build the two tables in shared memory, walking the samples in
// order: the rows (columns) the samples tap, each once, with the range of
// bins that tap it and the summed weights. Every cell of the ROI's window
// is then owned by one group of 16 threads, which sums its value in
// registers, 4 channels a thread, from the
// cotangent (the ROI's few kilobytes of it stay in the L1), and adds it to
// the pyramid once with a 16-byte vector reduction (atomicAdd on float4,
// red.global.add.v4.f32 on sm_90): no shared-memory atomics, and one
// global reduction per window cell and channel vector instead of four
// scalar atomics per sample, tap and channel. Only different ROIs meet on
// a cell, in the L2. The window's size does not matter: the tables hold at
// most 2 entries per sample, whatever the ROI's extent.
//
// What holds it above its bound (PERF.md, dev/torch_kernel_variants.py):
// the zeroing of the pyramid, the launch of a block per ROI and channel
// tile with its tables, and the window loop, whose reductions write every
// window cell of every ROI into the L2 (ROIs of the upper levels overlap
// several times over). Building the tables with every thread (taps one a
// thread, then an integer walk), summing a column's cotangent once for all
// its cells, or four cells' sums together, measured no faster.
//
// The accumulator is float32 and zeroed by the call (cudaMemsetAsync), part
// of the gradient written once. For bfloat16 the sums stay float32 and a
// second kernel of the same call casts the pyramid once (16-byte reads,
// 8-byte writes): a cell's last addition is known only when every block has
// finished, so the rounding cannot move into the first kernel.
//
// A channel count that is not a multiple of 4, or a cotangent whose address
// does not fit the vector loads, takes the same kernel with one channel a
// thread and scalar reductions; the result is the same.
//
// Numerics: positions, fractions, dead samples and the count come from
// roi_align_geometry.cuh, as in K1, built with -fmad=false. The sum is the
// plain version's, associated per row and column: the same terms, grouped
// and rounded in another order, and the order of the reductions changes
// from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "roi_align_geometry.cuh"

namespace {

using jtsm::Pyramid;
using jtsm::RoiGeometry;

constexpr int kThreads = 256;
constexpr int kLanes = 16;                  // threads over the channels of one cell
constexpr int kGroups = kThreads / kLanes;  // cells of one block at a time
constexpr int kVec = 4;                     // channels a thread on the vector path

// The taps of one ROI along one axis, in shared memory: entry m is map row
// (column) cell[m], tapped by bins first[m]..last[m] with the summed weights
// weight[m * pooled + p].
struct AxisTable {
  int* cell;
  int* first;
  int* last;
  float* weight;
};

// Words of shared memory of one table of `pooled` bins and up to
// `max_ratio` samples a bin (2 entries at most per sample).
__host__ __device__ inline int table_words(int pooled, int max_ratio) {
  const int entries = 2 * pooled * max_ratio;
  return entries * (pooled + 3);
}

__device__ AxisTable carve_table(float* smem, int pooled, int max_ratio) {
  const int entries = 2 * pooled * max_ratio;
  AxisTable t;
  t.weight = smem;
  t.cell = reinterpret_cast<int*>(t.weight + entries * pooled);
  t.first = t.cell + entries;
  t.last = t.first + entries;
  return t;
}

__device__ __forceinline__ int add_tap(AxisTable t, int n, int cell, int p, float w,
                                       int pooled) {
  // the samples are walked with their positions non-decreasing, so a tapped
  // cell is new or one of the last two entries
  int m = -1;
  if (n > 0 && t.cell[n - 1] == cell) {
    m = n - 1;
  } else if (n > 1 && t.cell[n - 2] == cell) {
    m = n - 2;
  }
  if (m < 0) {
    m = n++;
    t.cell[m] = cell;
    t.first[m] = p;
    t.last[m] = p;
  } else {
    t.first[m] = min(t.first[m], p);
    t.last[m] = max(t.last[m], p);
  }
  t.weight[m * pooled + p] += w;
  return n;
}

// Builds one axis's table (weights zeroed beforehand) and returns its entry
// count, at most 2 * pooled * ratio. A box of negative extent has its
// positions falling along the samples, so they are walked backwards; any
// order stays correct (a cell found twice gets two entries, whose
// reductions add up), the walk only keeps the table short.
__device__ int build_axis(AxisTable t, float origin, float bin_size, int ratio, int size,
                          int pooled) {
  const int samples = pooled * ratio;
  int n = 0;
  for (int q = 0; q < samples; ++q) {
    const int s = bin_size < 0.0f ? samples - 1 - q : q;
    const int p = s / ratio;
    int lo, hi;
    float fr;
    if (!jtsm::axis_tap(jtsm::sample_pos(origin, p, s - p * ratio, ratio, bin_size), size, &lo,
                        &hi, &fr))
      continue;
    n = add_tap(t, n, lo, p, 1.0f - fr, pooled);
    n = add_tap(t, n, hi, p, fr, pooled);
  }
  return n;
}

template <typename T, int VEC>
struct Grad;

template <>
struct Grad<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
};

template <>
struct Grad<__nv_bfloat16, 4> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
    const float2 a = __bfloat1622float2(h[0]);
    const float2 b = __bfloat1622float2(h[1]);
    v[0] = a.x;
    v[1] = a.y;
    v[2] = b.x;
    v[3] = b.y;
  }
};

template <>
struct Grad<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float* v) { v[0] = __ldg(p); }
};

template <>
struct Grad<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
    v[0] = __bfloat162float(*p);
  }
};

// Adds VEC channels into the pyramid; the result is unused, so the
// compiler issues reductions (RED), 16 bytes at once for 4 channels.
template <int VEC>
__device__ __forceinline__ void reduce_add(float* p, const float* v);

template <>
__device__ __forceinline__ void reduce_add<4>(float* p, const float* v) {
  atomicAdd(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}

template <>
__device__ __forceinline__ void reduce_add<1>(float* p, const float* v) {
  atomicAdd(p, v[0]);
}

// grid: (num_rois, channel tiles of kLanes * VEC); dynamic shared memory:
// the row table, then the column table.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    roi_align_bwd_kernel(Pyramid acc, const T* __restrict__ grad,
                         const float* __restrict__ boxes, const int* __restrict__ batch_idx,
                         const int* __restrict__ levels, int pooled_h, int pooled_w,
                         int sampling_ratio, int max_ratio, int aligned) {
  extern __shared__ float smem[];
  __shared__ int n_rows, n_cols;
  const int r = blockIdx.x;
  const RoiGeometry g = jtsm::roi_geometry(acc, boxes, batch_idx, levels, r, pooled_h,
                                           pooled_w, sampling_ratio, max_ratio, aligned);
  const int s_max = jtsm::max_samples(sampling_ratio, max_ratio);
  const AxisTable rows = carve_table(smem, pooled_h, s_max);
  const AxisTable cols = carve_table(smem + table_words(pooled_h, s_max), pooled_w, s_max);
  const int weights_y = 2 * pooled_h * s_max * pooled_h;
  const int weights_x = 2 * pooled_w * s_max * pooled_w;
  for (int i = threadIdx.x; i < weights_y + weights_x; i += kThreads) {
    if (i < weights_y) {
      rows.weight[i] = 0.0f;
    } else {
      cols.weight[i - weights_y] = 0.0f;
    }
  }
  __syncthreads();
  // one thread (of its own warp) per axis walks the samples
  if (threadIdx.x == 0) n_rows = build_axis(rows, g.y0, g.bin_h, g.ry, g.h, pooled_h);
  if (threadIdx.x == 32) n_cols = build_axis(cols, g.x0, g.bin_w, g.rx, g.w, pooled_w);
  __syncthreads();

  // the window: each group of kLanes threads owns a cell (j, k) at a
  // time, sums sum_py wy[j][py] * sum_px wx[k][px] * cotangent[py][px] /
  // count over the bins that tap its row and column, and adds it to the
  // pyramid with one reduction
  const int c_total = acc.channels;
  const int c = (blockIdx.y * kLanes + threadIdx.x % kLanes) * VEC;
  if (c >= c_total) return;
  const int ny_cells = n_rows;
  const int nx_cells = n_cols;
  const T* gr = grad + (size_t)r * pooled_h * pooled_w * c_total + c;
  float* dst = static_cast<float*>(acc.data[g.lvl]) + (size_t)g.b * g.h * g.w * c_total + c;
  for (int q = threadIdx.x / kLanes; q < ny_cells * nx_cells; q += kGroups) {
    const int j = q / nx_cells;
    const int k = q - j * nx_cells;
    const int px0 = cols.first[k];
    const int px1 = cols.last[k];
    const float* wx = cols.weight + k * pooled_w;
    float sum[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) sum[v] = 0.0f;
    for (int py = rows.first[j]; py <= rows.last[j]; ++py) {
      const float wy = rows.weight[j * pooled_h + py];
      float part[VEC];
#pragma unroll
      for (int v = 0; v < VEC; ++v) part[v] = 0.0f;
      for (int px = px0; px <= px1; ++px) {
        float gv[VEC];
        Grad<T, VEC>::load(gr + ((size_t)py * pooled_w + px) * c_total, gv);
#pragma unroll
        for (int v = 0; v < VEC; ++v) part[v] += wx[px] * gv[v];
      }
#pragma unroll
      for (int v = 0; v < VEC; ++v) sum[v] += wy * part[v];
    }
#pragma unroll
    for (int v = 0; v < VEC; ++v) sum[v] = sum[v] / g.count;
    reduce_add<VEC>(dst + ((size_t)rows.cell[j] * g.w + cols.cell[k]) * c_total, sum);
  }
}

// Casts n float32 values to bfloat16: 4 a thread and step (in 16-byte
// aligned, out 8-byte aligned), the tail one by one.
__global__ void cast_to_bf16_kernel(const float* __restrict__ in,
                                    __nv_bfloat16* __restrict__ out, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n4 = n / 4;
  for (long long i = first; i < n4; i += stride) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(in) + i);
    uint2 q;
    *reinterpret_cast<__nv_bfloat162*>(&q.x) = __floats2bfloat162_rn(v.x, v.y);
    *reinterpret_cast<__nv_bfloat162*>(&q.y) = __floats2bfloat162_rn(v.z, v.w);
    reinterpret_cast<uint2*>(out)[i] = q;
  }
  for (long long i = 4 * n4 + first; i < n; i += stride) out[i] = __float2bfloat16(in[i]);
}

template <typename T, int VEC>
int launch_bwd(const Pyramid& acc, const void* grad, const float* boxes, const int* batch_idx,
               const int* levels, int num_rois, int pooled_h, int pooled_w,
               int sampling_ratio, int max_ratio, int aligned, cudaStream_t s) {
  const int per_block = kLanes * VEC;
  const dim3 grid(num_rois, (acc.channels + per_block - 1) / per_block);
  const int s_max = jtsm::max_samples(sampling_ratio, max_ratio);
  const size_t smem =
      (size_t)(table_words(pooled_h, s_max) + table_words(pooled_w, s_max)) * sizeof(float);
  return (int)jtsm::launch(roi_align_bwd_kernel<T, VEC>, grid, kThreads, smem, s, acc,
                           static_cast<const T*>(grad), boxes, batch_idx, levels, pooled_h,
                           pooled_w, sampling_ratio, max_ratio, aligned);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (the cotangent and the gradient; boxes
// are float32, batch indices and levels int32, all on the device). grad is
// (num_rois, pooled_h, pooled_w, channels). heights, widths and scales are
// host arrays of num_levels entries. accum is a float32 device buffer of
// sum over levels of batch * height * width * channels elements, the levels'
// gradients one after the other, each (B, H, W, C), 16-byte aligned: the
// call zeroes it and sums into it. For float32 it is the result; for
// bfloat16 the call casts it into out, an 8-byte aligned buffer of as many
// bfloat16 elements (unused for float32). Launches on `stream` and returns
// the CUDA error code (0 on success).
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
  if (!jtsm::aligned_to(accum, 16) || (dtype == 1 && !jtsm::aligned_to(out, 8)))
    return (int)cudaErrorMisalignedAddress;
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
  const float* bx = static_cast<const float*>(boxes);
  const int* bi = static_cast<const int*>(batch_idx);
  const int* lv = static_cast<const int*>(levels);
  // 4-channel vectors need the channel count a multiple of 4 (so every
  // cell of the accumulator lies on 16 bytes) and the cotangent aligned to
  // the vector's bytes
  const bool vec = channels % kVec == 0 && jtsm::aligned_to(grad, kVec * (dtype == 0 ? 4 : 2));
  int rc;
  if (dtype == 0) {
    rc = vec ? launch_bwd<float, kVec>(acc, grad, bx, bi, lv, num_rois, pooled_h, pooled_w,
                                       sampling_ratio, max_ratio, aligned, s)
             : launch_bwd<float, 1>(acc, grad, bx, bi, lv, num_rois, pooled_h, pooled_w,
                                    sampling_ratio, max_ratio, aligned, s);
  } else {
    rc = vec ? launch_bwd<__nv_bfloat16, kVec>(acc, grad, bx, bi, lv, num_rois, pooled_h,
                                               pooled_w, sampling_ratio, max_ratio, aligned, s)
             : launch_bwd<__nv_bfloat16, 1>(acc, grad, bx, bi, lv, num_rois, pooled_h, pooled_w,
                                            sampling_ratio, max_ratio, aligned, s);
  }
  if (rc != 0 || dtype == 0) return rc;
  const long long blocks = (total / 4 + 255) / 256 + 1;
  cast_to_bf16_kernel<<<(unsigned)(blocks < 65535 * 16 ? blocks : 65535 * 16), 256, 0, s>>>(
      static_cast<const float*>(accum), static_cast<__nv_bfloat16*>(out), total);
  return (int)cudaGetLastError();
}
