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
// output): 16 bytes per pixel against 2 float64 adds per output and pass
// when each window slides.  The TPU kernel's doubling chain existed to
// keep every partial bounded by w * max|x|; here the column pass slides a
// float64 sum that restarts at each segment of a column, its rows streamed
// through shared memory (rf::col_sum_kernel over rf::col_stream, shared
// with K5 and K9; its shape rf::col_launch), and the row pass gives a warp
// to each row: it converts the row to float64 once, turns it into prefix
// sums in shared memory and takes each output as the difference of two
// of them (rf::warp_prefix and rf::window_sum, box_common.cuh, the row
// scheme of K5's fused kernels), 2 adds an output where its first port
// summed the 2r + 1 taps afresh, each converted.  Every term stays a
// window or border-period sum, so the result is the float32 rounding of a
// nearly exact sum.  Rows too wide for a block's shared memory (w past
// ~29,000) keep their prefixes in a device-memory scratch instead.
#include "box_common.cuh"

namespace {

constexpr int kRowWarps = 8;  // rows a row block takes, at most (a warp each)

// Doubles of a row pass's buffer for one row of w: its prefixes P(0 .. w).
__host__ __device__ __forceinline__ long long row_buffer(int w) { return w + 1LL; }

// Rows a row block takes (a warp each): kRowWarps where their buffers fit
// the device's shared memory, fewer where a wide row's do not; 0 where
// not even one row's does, and the rows' buffers then live in a scratch
// of device memory (ops/box_kernel.py::row_warps mirrors it).
inline int row_warps(int w) {
  const long long limit =
      rf::device_attr<cudaDevAttrMaxSharedMemoryPerBlockOptin>(227 * 1024);
  const long long fit = limit / (row_buffer(w) * static_cast<long long>(sizeof(double)));
  return static_cast<int>(fit < kRowWarps ? fit : kRowWarps);
}

// Row pass: out[p, y, x] = scale * sum over |dx| <= r of in[p, y,
// border(x + dx)].  A warp per row (`rows` = planes x h of them, from
// blockIdx.x warps_per_block on): it converts the row to float64 once
// (into its buffer at 1 .. w), turns it into its prefixes in place
// (rf::warp_prefix) and writes each output as the difference of two
// prefixes (rf::window_sum), 2 adds and a scale a value.  kGlobal: the
// buffers are `scratch` in device memory, row by row (rows too wide for a
// block's shared memory).
template <bool kGlobal>
__global__ void __launch_bounds__(32 * kRowWarps)
box_row_kernel(const float* __restrict__ in, float* __restrict__ out, double* scratch,
               long long rows, int w, int radius, bool r101, double scale) {
  extern __shared__ double s[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (row >= rows) return;  // a whole warp
  double* buf = kGlobal ? scratch + row * row_buffer(w) : s + warp * row_buffer(w);
  const float* src = in + row * w;
  for (int x = lane; x < w; x += 32) buf[x + 1] = static_cast<double>(src[x]);
  __syncwarp();
  rf::warp_prefix(buf + 1, buf, w, rf::row_seg(w), lane);
  __syncwarp();
  float* dst = out + row * w;
  for (int x = lane; x < w; x += 32) {
    const rf::PrefixAt lo = rf::prefix_at(x - radius, w, r101);
    const rf::PrefixAt hi = rf::prefix_at(x + radius + 1, w, r101);
    dst[x] = static_cast<float>(rf::window_sum(buf, w, r101, lo, hi) * scale);
  }
}

// The fused form, for rows up to kFusedWidest: a block per (plane, band of
// `band` output rows), a thread per column, K5's fused scheme with one
// plane.  Iteration i of the band: (a) each thread slides its column's
// float64 window to row i (the entering value added, the leaving one
// subtracted, both loaded an iteration ahead) and stores it (col, double
// buffered); (b) warp 0 turns row i - 1's column sums into prefixes (pre,
// double buffered; rf::prefix_pair); (c) each thread writes row i - 2's
// output from two prefixes.  No scratch plane: a call reads the input
// about (band + 2r + 1) / band times (mostly from L2) and writes the
// output once.
constexpr int kFusedWidest = 512;

__host__ __device__ __forceinline__ int fused_threads(int w) {
  const int t = (w + 31) / 32 * 32;
  return t < 64 ? 64 : t;
}

// Shared memory of a fused block: col and pre for rows of w, two of each.
__host__ __device__ __forceinline__ int fused_smem(int w) {
  return 2 * (2 * w + 1) * static_cast<int>(sizeof(double));
}

// Output rows per fused block: the tallest of 64, 32 and 16 rows whose
// grid (planes x ceil(h / band)) gives every SM two blocks, else 8: a
// block's rows are a chain of barriers, so more blocks in flight hide
// them, while a shorter band sums the (2r + 1)-row first window more
// often; on [32, 256, 256] at r = 45, 16 rows measured fastest of 8-64
// (scripts/measure_box_guided.py).  ops/box_kernel.py::fused_band mirrors
// it.
inline int fused_band(int planes, int h) {
  const long long sms = rf::device_attr<cudaDevAttrMultiProcessorCount>(132);
  for (int band = 64; band > 8; band /= 2)
    if (static_cast<long long>(planes) * ((h + band - 1) / band) >= 2 * sms) return band;
  return 8;
}

template <int kSeg>
__global__ void __launch_bounds__(kFusedWidest)
box_fused_kernel(const float* __restrict__ in, float* __restrict__ out, int h, int w,
                 int radius, bool r101, int band, double scale) {
  extern __shared__ double s[];
  double* col = s;          // [2][w]
  double* pre = s + 2 * w;  // [2][w + 1]
  const int x = threadIdx.x, lane = x & 31;
  const bool own = x < w;
  const int y0 = blockIdx.x * band;
  const int rows = min(band, h - y0);
  const size_t plane = static_cast<size_t>(h) * w;
  const float* src = in + blockIdx.y * plane + x;
  float* dst = out + blockIdx.y * plane + x;
  const int seg = rf::row_seg(w);
  double acc = 0.0;
  float enter = 0.0f, leave = 0.0f;
  if (own) {
#pragma unroll 4
    for (int t = y0 - radius; t <= y0 + radius; ++t)
      acc += static_cast<double>(
          src[static_cast<size_t>(rf::border_in(t, h, r101)) * w]);
    col[x] = acc;
    if (rows > 1) {
      enter = src[static_cast<size_t>(rf::border_in(y0 + 1 + radius, h, r101)) * w];
      leave = src[static_cast<size_t>(rf::border_in(y0 - radius, h, r101)) * w];
    }
  }
  __syncthreads();
  for (int i = 1; i <= rows + 1; ++i) {
    if (own && i < rows) {
      acc += static_cast<double>(enter);
      acc -= static_cast<double>(leave);
      col[(i & 1) * w + x] = acc;
      if (i + 1 < rows) {
        enter =
            src[static_cast<size_t>(rf::border_in(y0 + i + 1 + radius, h, r101)) * w];
        leave = src[static_cast<size_t>(rf::border_in(y0 + i - radius, h, r101)) * w];
      }
    }
    if (x < 32 && i - 1 < rows) {
      const double* c = col + ((i - 1) & 1) * w;
      double* p = pre + ((i - 1) & 1) * (w + 1);
      rf::prefix_pair<kSeg>(c, p, c, p, false, w, seg, lane);
    }
    if (own && i >= 2) {
      const rf::PrefixAt lo = rf::prefix_at(x - radius, w, r101);
      const rf::PrefixAt hi = rf::prefix_at(x + radius + 1, w, r101);
      dst[static_cast<size_t>(y0 + i - 2) * w] = static_cast<float>(
          rf::window_sum(pre + (i & 1) * (w + 1), w, r101, lo, hi) * scale);
    }
    __syncthreads();
  }
}

template <int kSeg>
cudaError_t box_fused(const float* x, float* out, int b, int h, int w, int radius, bool r101,
                      double scale, int band, cudaStream_t stream) {
  if (band <= 0) band = fused_band(b, h);
  box_fused_kernel<kSeg><<<dim3((h + band - 1) / band, b), fused_threads(w), fused_smem(w),
                           stream>>>(x, out, h, w, radius, r101, band, scale);
  return cudaGetLastError();
}

}  // namespace

// x, out [b, h, w] f32 (device); tmp [b, h, w] f32, scratch for the two
// passes' column sums, and scratch, b h (w + 1) doubles of device memory
// where a row's prefixes do not fit a block's shared memory (row_warps 0;
// else unread, may be null); neither is read by the fused form.  mode: 0
// the form by shape (fused where w <= kFusedWidest), 1 the two passes, 2
// the fused form (cudaErrorInvalidValue past kFusedWidest); band: the
// fused blocks' output rows, 0 for fused_band's.  Returns the cudaError_t
// of the shared-memory attribute call or of the launches.  The wrapper
// keeps b and h within the grid's 65,535.
extern "C" int rf_box_filter(const float* x, float* out, float* tmp, double* scratch, int b,
                             int h, int w, int radius, int reflect101, int normalize,
                             int mode, int band, cudaStream_t stream) {
  const bool r101 = reflect101 != 0;
  const double wd = 2.0 * radius + 1.0;
  const double scale = normalize ? 1.0 / (wd * wd) : 1.0;
  if (mode == 2 && w > kFusedWidest) return static_cast<int>(cudaErrorInvalidValue);
  if (mode == 2 || (mode == 0 && w <= kFusedWidest)) {
    const cudaError_t err =
        rf::row_seg(w) <= 9 ? box_fused<9>(x, out, b, h, w, radius, r101, scale, band, stream)
                            : box_fused<17>(x, out, b, h, w, radius, r101, scale, band, stream);
    return static_cast<int>(err);
  }
  const int warps = row_warps(w);
  const int smem = static_cast<int>(warps * row_buffer(w) * sizeof(double));
  cudaError_t err = warps > 0 ? rf::smem_limit(box_row_kernel<false>, smem) : cudaSuccess;
  if (err != cudaSuccess) return static_cast<int>(err);
  if (warps == 0 && scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  err = rf::launch_cols<rf::col_sum_kernel>(1, b, h, w, radius, 0, stream, x, tmp, h, w,
                                            radius, r101);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(b) * h;
  const int per_block = warps > 0 ? warps : kRowWarps;
  const unsigned blocks = static_cast<unsigned>((rows + per_block - 1) / per_block);
  if (warps > 0)
    box_row_kernel<false><<<blocks, 32 * per_block, smem, stream>>>(tmp, out, nullptr, rows, w,
                                                                     radius, r101, scale);
  else
    box_row_kernel<true><<<blocks, 32 * per_block, 0, stream>>>(tmp, out, scratch, rows, w,
                                                                 radius, r101, scale);
  return static_cast<int>(cudaGetLastError());
}
