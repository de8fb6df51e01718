// K4 — separable box filter (normalized window mean or plain window sum)
// over a stack of planes, with BORDER_REFLECT or BORDER_REFLECT_101 borders.
//
// Replaces reflectance_filtering_tpu/ops/box_pallas.py::_plane_kernel and
// its two-pass twins ::_w_pass_kernel / ::_h_pass_kernel (box_filter_pallas),
// and ::_fused_kernel (box_filter_fused), which computes the same function
// tiled for the TPU's VMEM.
//
// What it computes: x f32 [B, H, W] -> out[b, y, x] = scale * sum over
// |dy|, |dx| <= r of x[b, border(y + dy), border(x + dx)], with scale =
// 1 / (2r + 1)^2 when normalized and 1 otherwise.
//
// What bounds it on an H100: device memory.  A call reads and writes each
// plane twice (column pass to a float32 scratch plane, row pass to the
// output): 16 bytes per pixel against 2(2r + 1) adds, so at r = 45 it is
// near the line between the two.  The TPU kernel's doubling chain existed
// to keep every partial bounded by w * max|x|; here the column pass slides
// a float64 sum that restarts every 32-128 rows and the row pass sums its
// window afresh from shared memory, also in float64, so the result is the
// float32 rounding of a nearly exact sum (see box_common.cuh for the
// layout of both passes; the column pass's segment, rf::col_seg, is shared
// with K5 and K9).
#include "box_common.cuh"

namespace {

// Row pass: out[p, y, x] = scale * sum over |dx| <= r of in[p, y,
// border(x + dx)].  Grid (ceil(w / kRowTile), h, planes), kRowTile threads.
__global__ void __launch_bounds__(rf::kRowTile)
box_row_kernel(const float* __restrict__ in, float* __restrict__ out, int h,
               int w, int radius, bool r101, double scale) {
  extern __shared__ float s[];
  const int x0 = blockIdx.x * rf::kRowTile;
  const size_t row = blockIdx.z * static_cast<size_t>(h) * w +
                     static_cast<size_t>(blockIdx.y) * w;
  rf::stage_rows(in + row, 0, 1, w, x0, radius, r101, s,
                 rf::kRowTile + 2 * radius);
  __syncthreads();
  const int x = x0 + threadIdx.x;
  if (x >= w) return;
  const float* v = s + threadIdx.x;
  double acc = 0.0;
  for (int k = 0; k <= 2 * radius; ++k) acc += static_cast<double>(v[k]);
  out[row + x] = static_cast<float>(acc * scale);
}

}  // namespace

// x, out, tmp [b, h, w] f32 (device; tmp is scratch for the column sums).
// Returns the cudaError_t of the shared-memory attribute call or of the
// launches.  The wrapper keeps b and h within the grid's 65,535.
extern "C" int rf_box_filter(const float* x, float* out, float* tmp, int b,
                             int h, int w, int radius, int reflect101,
                             int normalize, cudaStream_t stream) {
  const bool r101 = reflect101 != 0;
  const int smem =
      (rf::kRowTile + 2 * radius) * static_cast<int>(sizeof(float));
  cudaError_t err = rf::smem_limit(box_row_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int seg = rf::col_seg(b, h, w);
  const dim3 col_grid((w + rf::kColThreads - 1) / rf::kColThreads,
                      (h + seg - 1) / seg, b);
  rf::col_sum_kernel<<<col_grid, rf::kColThreads, 0, stream>>>(
      x, tmp, h, w, radius, r101, seg);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const double wd = 2.0 * radius + 1.0;
  const dim3 row_grid((w + rf::kRowTile - 1) / rf::kRowTile, h, b);
  box_row_kernel<<<row_grid, rf::kRowTile, smem, stream>>>(
      tmp, out, h, w, radius, r101, normalize ? 1.0 / (wd * wd) : 1.0);
  return static_cast<int>(cudaGetLastError());
}
